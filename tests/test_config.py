"""Flag parser and config object (cmcd_tpu/config.py): the reference's
`--config.*` surface without absl or ml_collections."""

import pytest

from cmcd_tpu.config import ConfigDict, get_config, parse_flags


def test_int_field_both_forms():
    assert parse_flags(["--config.N=300"]).N == 300
    config = parse_flags(["--config.N", "300", "--config.nbridges", "16"])
    assert (config.N, config.nbridges) == (300, 16)
    assert isinstance(config.N, int)


def test_float_field_takes_ints_and_exponents():
    config = parse_flags(["--config.lr=1e-3", "--config.init_eps", "1"])
    assert config.lr == pytest.approx(1e-3)
    assert config.init_eps == 1.0 and isinstance(config.init_eps, float)


def test_string_field():
    config = parse_flags(["--config.model", "funnel", "--config.boundmode=MCD_CAIS_sn"])
    assert (config.model, config.boundmode) == ("funnel", "MCD_CAIS_sn")


@pytest.mark.parametrize("flag,value", [
    ("--config.pretrain_mfvi=False", False),
    ("--config.pretrain_mfvi=false", False),
    ("--config.pretrain_mfvi=0", False),
    ("--config.grad_clipping=True", True),
    ("--config.grad_clipping", True),
])
def test_bool_equals_forms(flag, value):
    name = flag.split("=")[0][len("--config."):]
    assert getattr(parse_flags([flag]), name) is value


def test_noconfig_sets_false_and_takes_no_value():
    config = parse_flags(["--noconfig.pretrain_mfvi", "--config.N", "8"])
    assert config.pretrain_mfvi is False
    assert config.N == 8


def test_list_field():
    config = parse_flags(["--config.fully_connected_units=[128, 128, 32]"])
    assert config.fully_connected_units == [128, 128, 32]
    assert parse_flags(["--config.fully_connected_units", "(7,)"]).fully_connected_units == [7]


def test_nested_log_field():
    config = parse_flags(["--config.log.jsonl=/tmp/m.jsonl", "--config.log.every", "5"])
    assert config.log.jsonl == "/tmp/m.jsonl"
    assert config.log.every == 5


@pytest.mark.parametrize("argv", [
    ["--config.no_such_field=1"],
    ["--config.log.nope=1"],
    ["--config.log=3"],
    ["--model=funnel"],
    ["funnel"],
    ["--noconfig.N"],
])
def test_unknown_flag_is_an_error(argv):
    with pytest.raises(ValueError):
        parse_flags(argv)


@pytest.mark.parametrize("argv", [
    ["--config.N=1.5"],
    ["--config.N=many"],
    ["--config.lr=fast"],
    ["--config.pretrain_mfvi=maybe"],
    ["--config.fully_connected_units=[a, b]"],
    ["--config.N"],
])
def test_bad_value_is_an_error(argv):
    with pytest.raises(ValueError):
        parse_flags(argv)


def test_parse_leaves_defaults_and_fresh_configs_alone():
    parse_flags(["--config.N=7"])
    fresh = get_config()
    assert fresh.N == 5 and fresh.model == "lorenz"
    assert "log" in fresh and isinstance(fresh.log, ConfigDict)


def test_config_dict_attribute_access_and_printing():
    config = ConfigDict({"a": 1, "sub": ConfigDict({"b": "x"})})
    config.c = [1, 2]
    assert (config.a, config.sub.b, config.c) == (1, "x", [1, 2])
    assert "c" in config and "missing" not in config
    assert not hasattr(config, "missing")
    text = str(config)
    assert "a: 1" in text and "  b: 'x'" in text


def test_main_rejects_unknown_flag():
    from cmcd_tpu.main import main

    with pytest.raises(SystemExit, match="unknown config field"):
        main(["--config.not_a_field=1"])


def _changed(value):
    """A value of the same type as `value` that differs from it."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 3
    if isinstance(value, float):
        return value * 2 + 0.5
    if isinstance(value, list):
        return value + [7]
    return value + "_x"


def _fields(config, prefix=""):
    for k, v in sorted(config.items()):
        if isinstance(v, ConfigDict):
            yield from _fields(v, prefix + k + ".")
        else:
            yield prefix + k


@pytest.mark.parametrize("name", list(_fields(get_config())))
def test_every_field_takes_a_value_of_its_type(name):
    """Every flag of the reference surface parses from text into a value of
    its default's type."""
    node = get_config()
    *parents, leaf = name.split(".")
    for p in parents:
        node = getattr(node, p)
    want = _changed(getattr(node, leaf))
    text = repr(want) if isinstance(want, list) else str(want)
    config = parse_flags([f"--config.{name}={text}"])
    for p in parents:
        config = getattr(config, p)
    got = getattr(config, leaf)
    assert got == want and type(got) is type(want)
