"""`ops.consts.device_const` builds its constant as a plain tensor also when
its first call comes inside a function transform: the inertial solvers'
first call of `solve.inertial.gravity_rotation` comes inside
`ops.autodiff.jacfwd`'s jvp. A constant cached as the transform's wrapper has
no storage, so a later fake trace's check of the cached constants
(test_torch_graph_step._fake_trace reads their data pointers) failed in
whichever test ran after it in the same process."""

import torch
from torch.func import jvp

from pli_slam_tpu_torch.ops import consts

torch.set_num_threads(1)


def test_constant_first_built_inside_jvp_is_a_plain_tensor():
    key = ("test_consts_inside_jvp", torch.float32)
    consts._cache.pop((key, "cpu", None), None)
    built = {}

    def f(x):
        built["c"] = consts.device_const(key, "cpu", lambda: torch.tensor([0.0, 0.0, -1.0]))
        return x * built["c"]

    out, tangent = jvp(f, (torch.ones(3),), (torch.ones(3),))
    c = consts.device_const(key, "cpu", lambda: torch.zeros(3))
    assert c is built["c"] and type(c) is torch.Tensor
    assert c.data_ptr() != 0 and torch.equal(c, torch.tensor([0.0, 0.0, -1.0]))
    assert torch.equal(out, c) and torch.equal(tangent, c)
    consts._cache.pop((key, "cpu", None))
