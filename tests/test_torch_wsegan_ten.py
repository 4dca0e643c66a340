"""The port's WSEGAN step against the JAX one over ten steps, and one bf16 step (the
helpers, config and tolerances of test_torch_wsegan_step.py)."""
import torch

from test_torch_wsegan_step import (TRAJ_TOL, _rel, _state_errs, jax_run, port_engine,
                                    port_step)


def test_ten_steps_match_jax(tmp_path):
    """Ten steps of the script's flags with a masked row and 'additive' rows now and then:
    the losses within 1e-3 of the JAX ones at every step."""
    masks = [[1, 1, 1, 0] if i % 3 == 2 else [1, 1, 1, 1] for i in range(10)]
    amasks = [[0, 1, 0, 0] if i % 2 else [0, 0, 0, 0] for i in range(10)]
    start, end, ref = jax_run({}, 10, masks, amasks, tmp_path)
    seg = port_engine(*start)
    for i, want in enumerate(ref):
        got, _ = port_step(seg, i, want, masks[i], amasks[i])
        for k in got:
            assert _rel(got[k], want[k]) <= TRAJ_TOL, (i, k, got[k], want[k])
    errs = _state_errs(seg, end)
    bad = {k: e for k, e in errs.items() if not e <= TRAJ_TOL}
    assert not bad, bad


def test_bf16_step_keeps_fp32_masters_and_buffers(tmp_path):
    """One bf16 step against the JAX bf16 step: losses within 5e-2 (bf16 convs summed in
    other orders), gradients and every master parameter, u and v in fp32."""
    kw = dict(compute_dtype="bfloat16")
    start, _, ref = jax_run(kw, 1, [[1, 1, 1, 0]], [[0, 1, 0, 0]], tmp_path)
    seg = port_engine(*start, **kw)
    got, genh = port_step(seg, 0, ref[0], [1, 1, 1, 0], [0, 1, 0, 0])
    for k in got:
        assert _rel(got[k], ref[0][k]) <= 5e-2, (k, got[k], ref[0][k])
    assert genh.dtype == torch.float32
    for m in (seg.G, seg.D):
        assert all(p.dtype == p.grad.dtype == torch.float32 for p in m.parameters())
        assert all(b.dtype == torch.float32 for b in m.buffers())
    assert all(b.dtype == torch.float32 for b in seg._g().buffers())
