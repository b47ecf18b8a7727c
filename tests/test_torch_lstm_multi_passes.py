"""The multi-direction LSTM kernels' arithmetic, modelled on the CPU, and
their launch plan.

Every direction of csrc/lstm_multi_fwd.cu and lstm_multi_bwd.cu runs the
passes of csrc/lstm_fwd.cu and lstm_bwd.cu (csrc/lstm_passes.cuh), so the
models of those passes (`_lstm_fwd_model` of test_torch_serial_passes.py;
the gate pass and the per-gate dh_prev of test_torch_lstm_bwd.py's
`_kernel_model`), applied per direction at the tower pair's H = 35, 35, 74,
74 with reverse F, T, F, T and ragged masks, are held against the plain
versions (`lstm_multi_recurrence[_bwd]_reference`) and against the JAX
package's `lstm_scan_multi` and `jax.vjp` of it (the Pallas kernels in
interpret mode, every direction padded to 128 lanes and the reverse ones
time-flipped).  T = 5, and T = 12, which wraps the forward's 8-step input
ring.  f32 on every side, 1e-5 + 1e-5 |ref|: they differ only in the order
of their sums (the port sums dW_hh in f64).

The launch plan (`lstm_multi.geometry`) is pure Python: held here against
the checks the kernels' host code makes (csrc/lstm_multi.cuh make_groups).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.ops.pallas import lstm_multi as jlm
from mmda_tpu_torch.ops.kernels import lstm_multi as tlm
from test_torch_lstm_bwd import _kernel_model as _lstm_bwd_model
from test_torch_serial_passes import _lstm_fwd_model

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
HS = (35, 35, 74, 74)              # visual and acoustic towers, forward and reverse
REVERSE = (False, True, False, True)
HP = jlm.HP
B = 3


def _directions(T, seed):
    """Per direction: x_proj, w_hh_t, mask (a tower's two directions share
    its lengths, 1 and T among them), incoming gradients dys and dh_fin."""
    rng = np.random.default_rng(seed)
    dirs = []
    for d, H in enumerate(HS):
        if d % 2 == 0:
            lengths = rng.integers(1, T + 1, size=B)
            lengths[0], lengths[-1] = 1, T
            mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
        dirs.append(dict(x_proj=rng.normal(size=(T, B, 4 * H)).astype(np.float32),
                         w_hh_t=(rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32),
                         mask=mask, dys=rng.normal(size=(T, B, H)).astype(np.float32),
                         dh_fin=rng.normal(size=(B, H)).astype(np.float32)))
    return dirs


def _pad(a, H, gates=True):
    """(..., 4H) gate blocks, or (..., H) lanes, zero-padded to HP lanes each."""
    if gates:
        a = a.reshape(*a.shape[:-1], 4, H)
    a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, HP - H)])
    return a.reshape(*a.shape[:-2], 4 * HP) if gates else a


def _flip(a, reverse):
    return np.ascontiguousarray(a[::-1]) if reverse else a


def _jax(dirs):
    """ys, h_fin, dx_proj and dw_hh_t per direction from `lstm_scan_multi`
    and its jax.vjp, cut back to each direction's H and time order."""
    x = np.stack([_flip(_pad(d["x_proj"], H), r) for d, H, r in zip(dirs, HS, REVERSE)])
    w = np.stack([_pad(np.pad(d["w_hh_t"], ((0, HP - H), (0, 0))), H) for d, H in zip(dirs, HS)])
    m = np.stack([_flip(d["mask"], r)[..., None] for d, r in zip(dirs, REVERSE)])
    (ys, h_fin), vjp = jax.vjp(lambda a, b: jlm.lstm_scan_multi(a, b, jnp.asarray(m)),
                               jnp.asarray(x), jnp.asarray(w))
    dys = np.stack([_flip(_pad(d["dys"], H, False), r) for d, H, r in zip(dirs, HS, REVERSE)])
    dh = np.stack([_pad(d["dh_fin"], H, False) for d, H in zip(dirs, HS)])
    dx, dw = vjp((jnp.asarray(dys), jnp.asarray(dh)))
    out = {"ys": [], "h_fin": [], "dx_proj": [], "dw_hh_t": []}
    for d, (H, r) in enumerate(zip(HS, REVERSE)):
        out["ys"].append(_flip(np.asarray(ys[d])[..., :H], r))
        out["h_fin"].append(np.asarray(h_fin[d])[:, :H])
        dx_d = np.asarray(dx[d]).reshape(*dx.shape[1:3], 4, HP)[..., :H]
        out["dx_proj"].append(_flip(dx_d.reshape(*dx.shape[1:3], 4 * H), r))
        out["dw_hh_t"].append(np.asarray(dw[d]).reshape(HP, 4, HP)[:H, :, :H].reshape(H, 4 * H))
    return out


@pytest.fixture(scope="module", params=[5, 12])
def case(request):
    """The model of the card's passes, the plain versions and the JAX
    package on the same four directions, at T = 5 and T = 12."""
    T = request.param
    dirs = _directions(T, seed=T)
    t = [{k: torch.from_numpy(v) for k, v in d.items()} for d in dirs]
    fwd = [_lstm_fwd_model(d["x_proj"], d["w_hh_t"], d["mask"], r) for d, r in zip(t, REVERSE)]
    bwd = [_lstm_bwd_model(d["x_proj"], d["w_hh_t"], d["mask"], f[0], f[1], d["dys"],
                           d["dh_fin"], None, r) for d, f, r in zip(t, fwd, REVERSE)]
    args = ([d["x_proj"] for d in t], [d["w_hh_t"] for d in t], [d["mask"] for d in t],
            list(REVERSE))
    plain = tlm.lstm_multi_recurrence_reference(*args, need_cs=True)
    plain_bwd = tlm.lstm_multi_recurrence_bwd_reference(
        *args, plain[0], plain[1], [d["dys"] for d in t], [d["dh_fin"] for d in t])
    return {"T": T, "model": {"ys": [f[0] for f in fwd], "cs": [f[1] for f in fwd],
                              "h_fin": [f[2] for f in fwd], "dx_proj": [b[0] for b in bwd],
                              "dw_hh_t": [b[1] for b in bwd]},
            "plain": {"ys": plain[0], "cs": plain[1], "h_fin": plain[2],
                      "dx_proj": plain_bwd[0], "dw_hh_t": plain_bwd[1]},
            "jax": _jax(dirs)}


def _hold(case, names):
    for name in names:
        for d in range(len(HS)):
            got = case["model"][name][d].numpy()
            np.testing.assert_allclose(got, case["plain"][name][d].numpy(),
                                       err_msg=f"{name}[{d}] vs plain", **TOL)
            if name in case["jax"]:
                np.testing.assert_allclose(got, case["jax"][name][d],
                                           err_msg=f"{name}[{d}] vs JAX", **TOL)


def test_multi_fwd_model_matches_plain_version_and_pallas(case):
    """The forward as every direction of lstm_multi_fwd.cu computes it
    (strided accumulators over k, then x_proj, the quad's cell update):
    ys, cs, h_fin against the plain version, ys and h_fin against the JAX
    kernel."""
    _hold(case, ("ys", "cs", "h_fin"))


def test_multi_bwd_model_matches_plain_version_and_pallas(case):
    """The backward as every direction of lstm_multi_bwd.cu computes it (the
    gates in a pass of their own, dh_prev as four per-gate parts, dW_hh in
    f64): dx_proj and dw_hh_t against the plain version and jax.vjp of the
    JAX kernel."""
    _hold(case, ("dx_proj", "dw_hh_t"))


# ------------------------------------------------------------- launch plan


def test_group_threads_cover_a_row_in_whole_warps():
    """A quad a hidden unit up to H = 80 (the weights in registers); above,
    the fewest units a quad that keep a row within MULTI_THREADS."""
    assert tlm.group_threads(35) == (1, 160)
    assert tlm.group_threads(74) == (1, 320)
    assert tlm.group_threads(80) == (1, 320)
    assert tlm.group_threads(81) == (1, 352)
    assert tlm.group_threads(300) == (3, 416)
    assert tlm.group_threads(480) == (4, 480)
    with pytest.raises(ValueError):
        tlm.group_threads(481)


def test_geometry_keeps_the_tower_pair_in_one_wave():
    """(rows, units, first block, first thread, threads) per direction.  At
    B = 64 a block a row of each direction is 256 blocks for 132 SMs: each
    visual row goes beside an acoustic one (160 + 320 threads, 128 blocks).
    At B = 32 the 128 one-row blocks fit as they are."""
    assert tlm.geometry(HS, 64, 132) == ((1, 1, 0, 320, 160), (1, 1, 64, 320, 160),
                                         (1, 1, 0, 0, 320), (1, 1, 64, 0, 320))
    assert tlm.geometry(HS, 32, 132) == ((1, 1, 64, 0, 160), (1, 1, 96, 0, 160),
                                         (1, 1, 0, 0, 320), (1, 1, 32, 0, 320))


@pytest.mark.parametrize("hs,B", [(HS, 64), (HS, 32), (HS, 512), ((33, 3, 9), 5),
                                  ((300, 74), 16), ((35, 74, 300, 35), 40),
                                  ((1, 44, 45, 80, 81, 256, 300, 480), 100)])
def test_geometry_plans_a_launch_the_kernels_take(hs, B):
    """Every plan passes the kernels' own checks: one row a group, enough
    whole warps for 4 ceil(H / units) threads within MULTI_THREADS, one unit
    a quad where the weights sit in registers, and groups that share blocks
    on threads apart; every direction's B rows have a block; and a block a
    row of each direction where that fits on the SMs."""
    n_sm = 132
    plan = tlm.geometry(hs, B, n_sm)
    assert len(plan) == len(hs)
    for (rows, units, block0, thread0, threads), H in zip(plan, hs):
        assert rows == 1 and block0 >= 0 and (units == 1 or H > 80)
        assert threads >= 4 * -(-H // units) and threads % 32 == 0 and thread0 % 32 == 0
        assert thread0 + threads <= tlm.MULTI_THREADS
    for d, a in enumerate(plan):
        for b in plan[d + 1:]:
            if a[2] < b[2] + B and b[2] < a[2] + B:          # blocks shared
                assert a[3] + a[4] <= b[3] or b[3] + b[4] <= a[3]
    blocks = max(block0 for _, _, block0, _, _ in plan) + B
    if len(hs) * B <= n_sm:
        assert blocks == len(hs) * B and all(g[3] == 0 for g in plan)
    else:
        assert blocks <= len(hs) * B


def test_dw_splits_fill_the_card_the_directions_share():
    """Each direction's dW_hh reduction, lstm_bwd.cu's 32 x 64 tiles, as if
    it had 2 x 132 / 4 SMs: about eight blocks an SM in all, two rounds of
    what an SM holds at once."""
    splits = tlm.dw_splits(48, 64, HS, 132)
    assert splits == [44, 44, 18, 18]           # 2 x 3 and 3 x 5 tiles on 66 SMs each
    tiles = {35: 2 * 3, 74: 3 * 5}
    assert sum(s * tiles[H] for s, H in zip(splits, HS)) >= 8 * 132
    assert tlm.dw_splits(512, 32, HS, 132) == [44, 44, 18, 18]
    assert tlm.dw_splits(1, 4, (4, 4), 132) == [1, 1]       # no row adds
