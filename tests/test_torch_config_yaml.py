"""The port's Config and YAML subset against the JAX package's Config and PyYAML (CPU).

Every YAML file of ``configs/`` and ``configs/archive/`` reads equal to
``yaml.safe_load`` (types included); the port's ``Config`` has the JAX
``Config``'s fields and defaults, raises its ``from_yaml`` errors, and
reads a ``config.yaml`` that either framework's ``save_yaml`` wrote to the
same config.
"""

import dataclasses
from pathlib import Path

import pytest
import yaml

from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.utils import yaml_subset

ROOT = Path(__file__).resolve().parent.parent
YAMLS = sorted((ROOT / "configs").glob("*.yaml")) + sorted((ROOT / "configs" / "archive").glob(
    "*.yaml"))
TEACHER = "configs/teachers/DATwConstantnCv1_shared_s8-16-8.best.ckpt"


def _typed(v):
    """``v`` with each scalar paired with its type (1 == 1.0 == True in Python)."""
    if isinstance(v, dict):
        return {k: _typed(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_typed(x) for x in v]
    return (type(v).__name__, v)


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: str(p.relative_to(ROOT)))
def test_repository_yaml_reads_as_pyyaml_reads_it(path):
    assert _typed(yaml_subset.load(path)) == _typed(yaml.safe_load(path.read_text()))


def test_config_fields_and_defaults_equal_jax():
    ours = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(Config)]
    ref = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(JaxConfig)]
    assert ours == ref
    a, b = Config(), JaxConfig()
    assert _typed(a.to_dict()) == _typed(b.to_dict())
    assert Config(exp_name="run").log_dir == JaxConfig(exp_name="run").log_dir == "exps/run"
    assert Config(val_datasets="vimeo90k").val_datasets == ("vimeo90k",)


@pytest.mark.parametrize("text, overrides, error", [
    ("nf: 16\nnot_a_field: 1\n", {}, "unknown config keys"),
    ("nf: 16\n", {"also_not_a_field": 2}, "unknown config keys"),
    ("teacher_overrides:\n  dat_samples: [8, 16, 8]\n", {}, "teacher_ckpt is not"),
])
def test_from_yaml_raises_what_jax_raises(tmp_path, text, overrides, error):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=error):
        JaxConfig.from_yaml(path, **overrides)
    with pytest.raises(ValueError, match=error):
        Config.from_yaml(path, **overrides)
    with pytest.raises(FileNotFoundError):
        Config.from_yaml(tmp_path / "missing.yaml")


@pytest.mark.parametrize("name", ["DAT_fast.yaml", "DAT_fast_distill.yaml",
                                  "archive/MADAT.yaml", "archive/IFRNet.yaml"])
def test_config_yaml_crosses_both_ways(tmp_path, name):
    path = ROOT / "configs" / name
    kw = dict(exp_name="x", teacher_ckpt=TEACHER) if "distill" in name else dict(exp_name="x")
    jax_cfg, port_cfg = JaxConfig.from_yaml(path, **kw), Config.from_yaml(path, **kw)
    assert _typed(port_cfg.to_dict()) == _typed(jax_cfg.to_dict())
    jax_cfg.save_yaml(tmp_path / "jax.yaml")
    port_cfg.save_yaml(tmp_path / "port.yaml")
    # What JAX writes (yaml.safe_dump) the port writes byte for byte.
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    # (Both read the tuples they wrote as lists.)
    assert (_typed(Config.from_yaml(tmp_path / "jax.yaml").to_dict())
            == _typed(port_cfg.to_dict()))
    assert (_typed(JaxConfig.from_yaml(tmp_path / "port.yaml").to_dict())
            == _typed(jax_cfg.to_dict()))


@pytest.mark.parametrize("text", [
    "a: &x 1\n", "a: !!str 1\n", "a: |\n  text\n", "a: {b: 1}\n", "a:\n  - b: 1\n",
    "a: 0x1f\n", "a: 017\n", "a: 2001-12-14\n", "a: 1:30\n", "a:\n- - 1\n", "a: b\n  c\n",
    "a: 'open\n", "a: [1, 2\n", "---\na: 1\n",
])
def test_outside_the_subset_raises_naming_the_line(text):
    with pytest.raises(yaml_subset.YamlSubsetError, match=r"f\.yaml, line \d"):
        yaml_subset.loads(text, "f.yaml")


@pytest.mark.parametrize("text", [
    "a: 1.0e-5\nb: 1e-5\nc: .5\nd: -.inf\ne: +3\nf: 1_000\ng: 0\nh: -0.0\n",
    "a: yes\nb: Off\nc: ~\nd:\ne: NULL\nf: 'it''s'\ng: \"q\\\"\"\nh: a b c\ni: -x\n",
    "a: [[1, 2], [], [x, 'y, z']]  # c\nb: []\nc: {}\n# only a comment\n",
    "k:\n  - 1\n  - [2, 3]\nm:\n  n:\n  - true\n  o: 0.0002\np: last\n",
])
def test_scalars_and_structures_read_as_pyyaml_reads_them(text):
    assert _typed(yaml_subset.loads(text)) == _typed(yaml.safe_load(text))


def test_set_values_and_dump_round_trip():
    assert yaml_subset.parse_value("[8, 16, 8]") == [8, 16, 8]
    assert yaml_subset.parse_value("exps/teacher/checkpoints/best_vimeo90k") == \
        "exps/teacher/checkpoints/best_vimeo90k"
    assert yaml_subset.parse_value("1.0e-4") == 1e-4
    data = {"a": "", "b": "123", "c": "yes", "d": 1e-5, "e": 1e20, "f": "a: b", "g": [True, None],
            "h": {"i": [1.5, "x y"]}, "j": float("inf"), "k": "-x", "l": [], "m": {}}
    text = yaml_subset.dumps(data)
    assert yaml.safe_load(text) == data == yaml_subset.loads(text)
