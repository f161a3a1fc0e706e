"""``${var}`` expansion of the port's Configuration
(tpumr_torch.core.configuration.Configuration.get and _substitute) against
the JAX package's (tpumr/core/configuration.py:112-133).

Mirrors tests/test_configuration.py::test_variable_expansion: the same keys
set on both packages' configurations must read back the same, a variable
from another key first and from the environment after, an unresolvable
one left as written, and the typed getters reading the expanded value.
"""

import pytest

from tpumr.core.configuration import Configuration as JaxConfiguration
from tpumr_torch.core.configuration import Configuration

ENV = "TPUMR_X_HOME"


def _both(pairs):
    """The same keys set on a JAX and a port configuration."""
    jax = JaxConfiguration(load_defaults=False)
    port = Configuration()
    for k, v in pairs:
        jax.set(k, v)
        port.set(k, v)
    return jax, port


def test_variable_expansion(monkeypatch):
    """ROADMAP §3 fault 1's input: /data/jobs and /h/y."""
    monkeypatch.setenv(ENV, "/h")
    jax, port = _both([("base.dir", "/data"),
                       ("job.dir", "${base.dir}/jobs"),
                       ("e", "${" + ENV + "}/y")])
    assert port.get("job.dir") == jax.get("job.dir") == "/data/jobs"
    assert port.get("e") == jax.get("e") == "/h/y"


@pytest.mark.parametrize("value", [
    "${base.dir}/jobs/${job.id}",          # two keys, one set after
    "${undefined.key}/x",                  # left as written
    "${base.dir}${base.dir}",              # twice in one value
    "${nested}",                           # a key whose value expands
    "$base.dir and ${ }",                  # not variables
    "${self.ref}",                         # refers to itself
])
def test_expansion_matches_jax(monkeypatch, value):
    monkeypatch.delenv("undefined.key", raising=False)
    jax, port = _both([("base.dir", "/data"), ("v", value),
                       ("nested", "${base.dir}/n"),
                       ("self.ref", "${self.ref}"),
                       ("job.id", "job_001")])
    assert port.get("v") == jax.get("v")


def test_key_wins_over_environment(monkeypatch):
    monkeypatch.setenv("base.dir", "/from/env")
    jax, port = _both([("base.dir", "/from/key"), ("p", "${base.dir}")])
    assert port.get("p") == jax.get("p") == "/from/key"


def test_typed_getters_see_the_expanded_value(monkeypatch):
    monkeypatch.setenv("TPUMR_X_N", "42")
    jax, port = _both([("n", "${TPUMR_X_N}"), ("f", "${n}.5"),
                       ("b", "${flag}"), ("flag", "true"),
                       ("lst", "${base}, b"), ("base", "a")])
    for c in (jax, port):
        assert c.get_int("n") == 42
        assert c.get_float("f") == 42.5
        assert c.get_boolean("b") is True
        assert c.get_strings("lst") == ["a", "b"]


def test_resource_layers_and_defaults_expand():
    """A value in a resource layer names a key of another layer or of the
    defaults."""
    port = Configuration(defaults={"root": "/r"})
    port.add_resource({"dir": "${root}/d"})
    port.set("file", "${dir}/f")
    assert port.get("file") == "/r/d/f"
    assert port.get("missing", "${root}") == "${root}"   # defaults as given
