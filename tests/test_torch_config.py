"""The port's own configuration module against the JAX package's.

The port keeps a copy of `utils/config.py` and imports nothing of the JAX
package; `convert.config_from_reference` carries a config across as the
plain dict `dataclasses.asdict` gives. Everything here is exact: configs
are ints, floats, bools, strings and tuples of them.
"""

import dataclasses

import numpy as np
import pytest

from pli_slam_tpu.utils import config as jconfig
from pli_slam_tpu_torch.utils import config as tconfig
from pli_slam_tpu_torch.utils import convert

PRESETS = ["euroc_stereo", "euroc_stereo_inertial", "tiny_test", "default"]

YAML = """%YAML:1.0
Camera.fx: 435.2
Camera.fy: 435.3
Camera.cx: 367.4
Camera.cy: 252.2
Camera.bf: 47.9
Camera.width: 640
Camera.height: 400
Camera.fps: 30.0
ORBextractor.nFeatures: 800   # a comment
ORBextractor.nLevels: 5
ORBextractor.scaleFactor: 1.3
ORBextractor.iniThFAST: 18
ORBextractor.minThFAST: 6
has_lines: 0
IMU.Frequency: 400.0
IMU.NoiseGyro: 1.0e-4
Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0, -1.0, 0.0, 0.1,
          1.0, 0.0, 0.0, -0.2,
          0.0, 0.0, 1.0, 0.3,
          0.0, 0.0, 0.0, 1.0]
"""

RECT = "".join(
    f"{side}.{name}: !!opencv-matrix\n   rows: {r}\n   cols: {c}\n   dt: d\n   data: [{', '.join(str(v) for v in data)}]\n"
    for side, shift in (("LEFT", 0.0), ("RIGHT", -47.9))
    for name, (r, c), data in (
        ("K", (3, 3), [458.6, 0.0, 367.2, 0.0, 457.3, 248.4, 0.0, 0.0, 1.0]),
        ("D", (1, 5), [-0.28, 0.07, 0.0002, 1.8e-05, 0.0]),
        ("R", (3, 3), [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]),
        ("P", (3, 4), [435.2, 0.0, 367.4, shift, 0.0, 435.2, 252.2, 0.0, 0.0, 0.0, 1.0, 0.0]),
    ))


def _preset(mod, name):
    return mod.SlamConfig() if name == "default" else getattr(mod.SlamConfig, name)()


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equals_reference_field_by_field(name):
    jd = dataclasses.asdict(_preset(jconfig, name))
    td = dataclasses.asdict(_preset(tconfig, name))
    assert td == jd
    # the same classes, fields, order and types on both sides
    for cls in ("OrbConfig", "LineConfig", "MatchConfig", "TrackingConfig", "OptimizerConfig", "ImuConfig",
                "MapConfig", "LoopConfig", "SlamConfig"):
        jf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(jconfig, cls))]
        tf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(tconfig, cls))]
        assert [x[:2] for x in tf] == [x[:2] for x in jf], cls
        if cls != "SlamConfig":  # its defaults are dataclasses of the two packages: compared through asdict above
            assert tf == jf, cls


@pytest.mark.parametrize("name", PRESETS)
def test_config_from_reference_round_trips(name):
    jcfg = _preset(jconfig, name)
    jcfg = jcfg.replace(imu=dataclasses.replace(jcfg.imu, Tbc=tuple(float(i) for i in range(16))))
    tcfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    assert isinstance(tcfg, tconfig.SlamConfig) and isinstance(tcfg.orb, tconfig.OrbConfig)
    assert isinstance(tcfg.imu, tconfig.ImuConfig) and tcfg.imu.Tbc == jcfg.imu.Tbc
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert convert.config_from_reference(dataclasses.asdict(tcfg)) == tcfg
    assert tcfg.replace(fps=10.0).fps == 10.0 and tconfig.SlamConfig.replace is not jconfig.SlamConfig.replace


@pytest.mark.parametrize("where", ["top", "nested"])
@pytest.mark.parametrize("fault", ["unknown", "missing"])
def test_config_from_reference_raises_on_a_field_mismatch(where, fault):
    d = dataclasses.asdict(jconfig.SlamConfig.tiny_test())
    target = d if where == "top" else d["map"]
    if fault == "unknown":
        target["no_such_field"] = 1
    else:
        del target["fps" if where == "top" else "max_points"]
    with pytest.raises(ValueError, match="no_such_field|fps|max_points"):
        convert.config_from_reference(d)


def test_load_yaml_agrees(tmp_path):
    path = tmp_path / "cam.yaml"
    path.write_text(YAML)
    jcfg, tcfg = jconfig.load_yaml(str(path)), tconfig.load_yaml(str(path))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.width == 640 and tcfg.orb.n_features == 800 and not tcfg.use_lines and tcfg.imu.Tbc[3] == 0.1
    assert tconfig.parse_yaml_flat(str(path)) == jconfig.parse_yaml_flat(str(path))
    assert tconfig.parse_yaml_matrices(str(path)) == jconfig.parse_yaml_matrices(str(path))


@pytest.mark.parametrize("rectified", [False, True])
def test_load_yaml_full_agrees(tmp_path, rectified):
    path = tmp_path / "cam.yaml"
    path.write_text(YAML + (RECT if rectified else ""))
    jcfg, jcam, jrect = jconfig.load_yaml_full(str(path))
    tcfg, tcam, trect = tconfig.load_yaml_full(str(path))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for f in ("fx", "fy", "cx", "cy", "bf"):
        assert np.float32(getattr(tcam, f)) == np.float32(np.asarray(getattr(jcam, f))), f
    assert (tcam.width, tcam.height, tcam.model) == (int(jcam.width), int(jcam.height), int(jcam.model))
    if not rectified:
        assert jrect is None and trect is None
        return
    # the port hands on the eight blocks a rectifier is built from
    assert np.float32(tcam.bf) == np.float32(47.9) and jrect is not None
    assert sorted(trect) == sorted(f"{s}.{n}" for s in ("LEFT", "RIGHT") for n in "KDRP")
    mats = jconfig.parse_yaml_matrices(str(path))
    for name, m in trect.items():
        (r, c), data = mats[name]
        want = np.asarray(data, np.float64)
        np.testing.assert_array_equal(m, want if name.endswith(".D") else want.reshape(r, c))
