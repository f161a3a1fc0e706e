"""The port's database tier (tpumr_torch.mapred.lib_db: DBSplit,
DBInputFormat, DBOutputFormat, the DB-API module of tpumr.db.module)
against the JAX package's (tpumr.mapred.lib_db) on the same sqlite
databases.

Each test names the test of tests/test_lib_db.py it mirrors. Splits and
records are compared with the JAX package's; a whole sqlite-to-sqlite job
runs through both packages' LocalJobRunner (the port with
tpumr_torch.device=cpu), each into a database of its own, and the rows
written must be equal, in the order they were inserted.
"""

import sqlite3

import pytest

from tpumr.mapred import lib_db as jax_db
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr_torch.mapred import lib_db as db
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import run_job

PKGS = {"jax": (jax_db, JaxJobConf, jax_run_job),
        "port": (db, JobConf, run_job)}


def _make_db(path, rows=100):
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE clicks (id INTEGER, page TEXT, n INTEGER)")
    conn.executemany("INSERT INTO clicks VALUES (?, ?, ?)",
                     [(i, f"page{i % 3}", i % 7) for i in range(rows)])
    conn.execute("CREATE TABLE totals (page TEXT, total INTEGER)")
    conn.commit()
    conn.close()
    return path


@pytest.fixture()
def dbs(tmp_path):
    return {pkg: _make_db(tmp_path / f"{pkg}.db") for pkg in PKGS}


def _conf(conf_cls, path, order="id", **kw):
    conf = conf_cls()
    conf.set("tpumr.db.connect", str(path))
    conf.set("tpumr.db.input.table", "clicks")
    if order:
        conf.set("tpumr.db.input.order.by", order)
    for k, v in kw.items():
        conf.set(k, v)
    return conf


def _read_all(pkg, path, n_splits, **kw):
    mod, conf_cls, _ = PKGS[pkg]
    conf = _conf(conf_cls, path, **kw)
    fmt = mod.DBInputFormat()
    splits = fmt.get_splits(conf, n_splits)
    return ([(s.start, s.row_count) for s in splits],
            [r for s in splits for r in fmt.get_record_reader(s, conf)])


@pytest.mark.parametrize("n_splits", [1, 3, 4])
def test_splits_partition_the_ordered_table(dbs, n_splits):
    """TestSplitsAndReader::test_splits_partition_the_ordered_table: the
    same windows and records as the JAX package's."""
    got = {pkg: _read_all(pkg, dbs[pkg], n_splits) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert [r[0] for _, r in got["port"][1]] == list(range(100))


@pytest.mark.parametrize("kw", [
    {"tpumr.db.input.query":
     "SELECT page, n FROM clicks WHERE n > 5 ORDER BY id"},
    {"order": "id DESC"},
    {"order": "page, id"},
    {"tpumr.db.input.fields": "id,page"}], ids=["query", "desc", "compound",
                                               "fields"])
def test_custom_query_fields_and_order(dbs, kw):
    """TestSplitsAndReader::test_custom_query_and_fields and
    TestReviewRegressions::test_order_by_direction_and_compound."""
    kw = dict(kw)
    order = kw.pop("order", "id")
    got = {pkg: _read_all(pkg, dbs[pkg], 2, order=order, **kw)
           for pkg in PKGS}
    assert got["port"] == got["jax"] and got["port"][1]


def test_split_wire_roundtrip():
    """TestSplitsAndReader::test_split_wire_roundtrip."""
    from tpumr_torch.mapred.split import InputSplit
    back = InputSplit.from_dict(db.DBSplit(25, 50).to_dict())
    assert isinstance(back, db.DBSplit)
    assert (back.start, back.row_count, back.length) == (25, 50, 50)
    assert back.describe() == "rows 25+50"


@pytest.mark.parametrize("bad", [
    ("tpumr.db.input.table", "clicks; DROP TABLE clicks", "identifier"),
    ("tpumr.db.input.order.by", "id; DROP TABLE clicks", "ORDER BY"),
    ("tpumr.db.input.order.by", "id SIDEWAYS", "direction")],
    ids=["table", "order", "direction"])
def test_bad_identifiers_are_loud(dbs, bad):
    """TestSplitsAndReader::test_bad_identifier_is_loud."""
    conf = _conf(JobConf, dbs["port"])
    conf.set(bad[0], bad[1])
    with pytest.raises(ValueError, match=bad[2]):
        db.DBInputFormat().get_splits(conf, 2)


def test_unordered_multisplit_refused(dbs):
    """TestSplitsAndReader::test_unordered_multisplit_refused."""
    conf = _conf(JobConf, dbs["port"], order=None)
    with pytest.raises(ValueError, match="UNORDERED"):
        db.DBInputFormat().get_splits(conf, 4)
    assert len(db.DBInputFormat().get_splits(conf, 1)) == 1


class Sum:
    def configure(self, conf):
        pass

    def reduce(self, key, values, output, reporter):
        output.collect(key, sum(values))

    def close(self):
        pass


class PageMapper:
    def configure(self, conf):
        pass

    def map(self, key, row, output, reporter):
        _id, page, n = row
        output.collect(page, n)

    def close(self):
        pass


class FailingReducer(Sum):
    def reduce(self, key, values, output, reporter):
        output.collect(key, sum(values))
        raise RuntimeError("boom after emitting")


def _db_job(pkg, path, tmp_path, reducer):
    mod, conf_cls, _ = PKGS[pkg]
    conf = _conf(conf_cls, path)
    if pkg == "port":
        conf.set("tpumr_torch.device", "cpu")
    conf.set_job_name("db2db")
    conf.set_input_format(mod.DBInputFormat)
    conf.set_output_format(mod.DBOutputFormat)
    conf.set("tpumr.db.output.table", "totals")
    conf.set("tpumr.db.output.fields", "page,total")
    conf.set("mapred.map.tasks", 4)
    conf.set_class("mapred.mapper.class", PageMapper)
    conf.set_class("mapred.reducer.class", reducer)
    conf.set_num_reduce_tasks(1)
    conf.set_output_path(f"file://{tmp_path}/scratch-{pkg}")
    return conf


def test_sqlite_to_sqlite_mr_job(dbs, tmp_path):
    """TestEndToEndJob::test_sqlite_to_sqlite_mr_job: the same rows, in
    the same order, in both packages' output tables."""
    rows = {}
    for pkg, (_mod, _conf_cls, runner) in PKGS.items():
        assert runner(_db_job(pkg, dbs[pkg], tmp_path, Sum)).successful
        conn = sqlite3.connect(dbs[pkg])
        rows[pkg] = conn.execute("SELECT page, total FROM totals "
                                 "ORDER BY rowid").fetchall()
        conn.close()
    expect = {}
    for i in range(100):
        expect[f"page{i % 3}"] = expect.get(f"page{i % 3}", 0) + i % 7
    assert rows["port"] == rows["jax"] and dict(rows["port"]) == expect


def test_failed_task_commits_nothing(dbs, tmp_path):
    """TestReviewRegressions::test_failed_task_commits_nothing."""
    with pytest.raises(Exception, match="boom"):
        run_job(_db_job("port", dbs["port"], tmp_path, FailingReducer))
    conn = sqlite3.connect(dbs["port"])
    assert conn.execute("SELECT COUNT(*) FROM totals").fetchone()[0] == 0
    conn.close()


def test_output_specs_and_connect_fail_fast(dbs):
    """TestEndToEndJob::test_output_specs_fail_fast and
    test_db_connect_requires_target."""
    conf = _conf(JobConf, dbs["port"])
    conf.set("tpumr.db.output.table", "missing_table")
    with pytest.raises(Exception, match="missing_table|no such"):
        db.DBOutputFormat().check_output_specs(conf)
    with pytest.raises(ValueError, match="db.connect"):
        db.db_connect(JobConf())


def test_row_width_validated_and_placeholder(dbs):
    """TestReviewRegressions::test_row_width_validated_at_write, and the
    placeholder of each paramstyle."""
    conf = _conf(JobConf, dbs["port"])
    w = db._DBRecordWriter(conf, "totals", ["page", "total"])
    with pytest.raises(ValueError, match="row width"):
        w.write(("a", 1, 2), None)
    w.abort()
    assert db.db_placeholder(conf) == jax_db.db_placeholder(conf) == "?"


def test_reader_closes_on_early_abandon(dbs):
    """TestReviewRegressions::test_reader_closes_on_early_abandon."""
    conf = _conf(JobConf, dbs["port"])
    fmt = db.DBInputFormat()
    (split,) = fmt.get_splits(conf, 1)
    reader = fmt.get_record_reader(split, conf)
    it = iter(reader)
    next(it)
    it.close()
    with pytest.raises(Exception):
        reader.cursor.fetchone()
