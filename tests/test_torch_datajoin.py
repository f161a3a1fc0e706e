"""The port's reduce-side join (tpumr_torch.contrib.datajoin) against the
JAX package's (tpumr.contrib.datajoin) on the same tagged sources.

Each test names the test of tests/test_datajoin.py it mirrors and runs the
join through both packages' LocalJobRunner, the port with
tpumr_torch.device=cpu: the same part file byte for byte and the same
DataJoin counters. The user classes subclass each package's own bases.
"""

import numpy as np
import pytest

from tpumr.contrib import datajoin as jax_dj
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr_torch.contrib import datajoin as dj
from tpumr_torch.mapred.local_runner import run_job

GROUP = "tpumr.DataJoin"


class _Orders:
    def input_tag(self, conf):
        return "orders"

    def extract_key(self, key, value):
        return str(value).split(",")[0]

    def extract_value(self, key, value):
        return str(value).split(",", 1)[1]


class _Users(_Orders):
    def input_tag(self, conf):
        return "users"


class _InnerJoin:
    required_tags = ("orders", "users")

    def combine(self, key, tags, values, output, reporter):
        by_tag = dict(zip(tags, values))
        if by_tag["orders"].endswith("drop-me"):
            return None
        return f"{by_tag['users']}|{by_tag['orders']}"


class _Join:
    def combine(self, key, tags, values, output, reporter):
        return "|".join(values)


# the mappers are named in the conf, so they live at module level
class OrderMapper(_Orders, dj.DataJoinMapper):
    pass


class UserMapper(_Users, dj.DataJoinMapper):
    pass


class InnerJoin(_InnerJoin, dj.DataJoinReducer):
    pass


class Join(_Join, dj.DataJoinReducer):
    pass


class JaxOrderMapper(_Orders, jax_dj.DataJoinMapper):
    pass


class JaxUserMapper(_Users, jax_dj.DataJoinMapper):
    pass


class JaxInnerJoin(_InnerJoin, jax_dj.DataJoinReducer):
    pass


class JaxJoin(_Join, jax_dj.DataJoinReducer):
    pass


PKGS = {"jax": (jax_dj, {"OrderMapper": JaxOrderMapper,
                         "UserMapper": JaxUserMapper,
                         "InnerJoin": JaxInnerJoin, "Join": JaxJoin},
                jax_run_job),
        "port": (dj, {"OrderMapper": OrderMapper, "UserMapper": UserMapper,
                      "InnerJoin": InnerJoin, "Join": Join}, run_job)}


def _write_sources(d, orders: bytes, users: bytes):
    (d / "orders").mkdir()
    (d / "users").mkdir()
    (d / "orders" / "part-0").write_bytes(orders)
    (d / "users" / "part-0").write_bytes(users)


def _join(tmp_path, reducer, extra=None, sources=("orders", "users")):
    """The join in both packages: {pkg: (part file, result)}."""
    out = {}
    for pkg, (m, c, runner) in PKGS.items():
        mappers = {"orders": c["OrderMapper"], "users": c["UserMapper"]}
        conf = m.make_datajoin_conf(
            [(s, f"file://{tmp_path}/{s}", mappers[s]) for s in sources],
            c[reducer], f"file://{tmp_path}/out-{pkg}")
        conf.set_num_reduce_tasks(1)
        if pkg == "port":
            conf.set("tpumr_torch.device", "cpu")
        for k, v in (extra or {}).items():
            conf.set(k, v)
        result = runner(conf)
        assert result.successful
        out[pkg] = ((tmp_path / f"out-{pkg}" / "part-00000").read_bytes(),
                    result)
    assert out["port"][0] == out["jax"][0]
    for name in ("TUPLES_JOINED", "KEYS_UNMATCHED", "VALUES_TRUNCATED"):
        assert out["port"][1].counters.value(GROUP, name) == \
            out["jax"][1].counters.value(GROUP, name)
    return out["port"]


def test_inner_join_cross_product_and_filter(tmp_path):
    """tests/test_datajoin.py::test_inner_join_cross_product_and_filter."""
    _write_sources(tmp_path,
                   b"u1,order-a\nu1,order-b\nu2,order-c\n"
                   b"u3,order-d\nu2,drop-me\n",
                   b"u1,alice\nu2,bob\nu9,nobody\n")
    part, result = _join(tmp_path, "InnerJoin")
    assert sorted(part.decode().splitlines()) == [
        "u1\talice|order-a", "u1\talice|order-b", "u2\tbob|order-c"]
    assert result.counters.value(GROUP, "TUPLES_JOINED") == 3
    assert result.counters.value(GROUP, "KEYS_UNMATCHED") == 2


def test_seeded_inner_join_against_an_oracle(tmp_path):
    """The chip run's join at a small size: seeded orders and users, the
    inner join against a Python oracle."""
    rng = np.random.default_rng(7)
    orders = [(f"u{u}", f"o{i}") for i, u in
              enumerate(rng.integers(0, 300, 2000))]
    users = [(f"u{u}", f"name{u}") for u in
             rng.choice(400, 250, replace=False)]
    _write_sources(tmp_path,
                   "".join(f"{u},{o}\n" for u, o in orders).encode(),
                   "".join(f"{u},{n}\n" for u, n in users).encode())
    part, _ = _join(tmp_path, "InnerJoin",
                    {"datajoin.maxNumOfValuesPerGroup": 1000})
    names = dict(users)
    want = sorted(f"{u}\t{names[u]}|{o}" for u, o in orders if u in names)
    assert sorted(part.decode().splitlines()) == want


def test_group_truncation_bounds_cross_product(tmp_path):
    """tests/test_datajoin.py::test_group_truncation_bounds_cross_product."""
    _write_sources(tmp_path, b"".join(b"u1,o%d\n" % i for i in range(10)),
                   b"u1,alice\n")
    part, result = _join(tmp_path, "Join",
                         {"datajoin.maxNumOfValuesPerGroup": 4})
    assert len(part.splitlines()) == 4
    assert result.counters.value(GROUP, "VALUES_TRUNCATED") == 6


@pytest.mark.parametrize("other", ["users_extra", "users"])
def test_unregistered_or_sibling_source_fails_loudly(tmp_path, other):
    """tests/test_datajoin.py::test_sibling_directory_does_not_match_prefix
    and ::test_unregistered_source_fails_loudly: a split under no
    registered source (a sibling directory whose name extends a source's)
    fails the job in both packages."""
    _write_sources(tmp_path, b"u1,o\n", b"u1,alice\n")
    (tmp_path / "users_extra").mkdir()
    (tmp_path / "users_extra" / "part-0").write_bytes(b"u1,mallory\n")
    registered = ("users",) if other == "users_extra" else ("orders",)
    for pkg, (m, c, runner) in PKGS.items():
        mappers = {"orders": c["OrderMapper"], "users": c["UserMapper"]}
        conf = m.make_datajoin_conf(
            [(s, f"file://{tmp_path}/{s}", mappers[s]) for s in registered],
            c["InnerJoin"], f"file://{tmp_path}/out-{other}-{pkg}")
        conf.set_input_paths(*(f"file://{tmp_path}/{s}"
                               for s in registered + (other,)))
        conf.set_num_reduce_tasks(1)
        conf.set("tpumr_torch.device", "cpu")
        with pytest.raises(ValueError, match="no datajoin mapper"):
            runner(conf)


def test_make_datajoin_conf_refuses_other_mappers():
    """make_datajoin_conf takes DataJoinMapper subclasses only."""
    with pytest.raises(TypeError, match="not a DataJoinMapper"):
        dj.make_datajoin_conf([("x", "file:///x", object)],
                              PKGS["port"][1]["Join"], "file:///out")
    tv = dj.TaggedValue("orders", "o1")
    assert (tv.tag, tv.value) == ("orders", "o1")
