"""Gradient accumulation (grad_accum_steps = k > 1) in the port against the
JAX package's optax.MultiSteps, on the CPU: the optimizer over every rule
and schedule of test_torch_train's OPT_CASES for k = 2 and 3 (parameters,
the running mean and the update count after every mini-step, 1e-6, the
same f32 formulas); the exponential schedule decaying once every k epochs
because it counts updates; the JAX package's
test_grad_accum_matches_big_batch rebuilt on the port; and an accumulating
step run through `StepGraphs` (the body a training graph captures, two
kinds of mini-step) bit-equal to eager steps.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.train import state as jstate

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.data.loader import ArrayLoader, to_device
from mmda_tpu_torch.data.synthetic import SyntheticSpec, make_split
from mmda_tpu_torch.models import init_misa
from mmda_tpu_torch.train.state import Optimizer
from mmda_tpu_torch.train.step import loss_and_grads, make_train_graph, train_step
from test_torch_train import OPT_CASES

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL6 = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("case", OPT_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_accumulating_optimizer_matches_optax_multisteps(case, k):
    """3k mini-steps with gradients beyond the clip against
    make_optimizer(cfg, frozen) with grad_accum_steps=k (MultiSteps around
    the masked chain): after each one the parameters, the running mean and
    the update count agree; between updates the parameters do not move."""
    kw = {"clip": 0.5, "learning_rate": 1e-2, "grad_accum_steps": k, **case}
    jcfg, cfg = JConfig(**kw), Config(device="cpu", **kw)
    rng = np.random.default_rng(k)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32),
              "z_frozen": rng.normal(size=(2, 2)).astype(np.float32)}
    frozen = {"a": False, "b": False, "z_frozen": True}
    spe = 2
    tx = jstate.make_optimizer(jcfg, frozen, steps_per_epoch=spe)
    update = jax.jit(tx.update)               # as the JAX training step runs it
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jp)
    tp = {n: _t(v.copy()) for n, v in params.items()}
    opt = Optimizer(cfg, [tp["a"], tp["b"]], steps_per_epoch=spe)
    for step in range(3 * k):
        if case.get("lr_schedule") == "plateau" and step == k:
            state = jstate.set_learning_rate(state, 3e-3)
            opt.set_learning_rate(3e-3)
        grads = {n: (2 * rng.normal(size=v.shape)).astype(np.float32)
                 for n, v in params.items()}
        before = {n: tp[n].clone() for n in ("a", "b")}
        updates, state = update({n: jnp.asarray(v) for n, v in grads.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        opt.step([_t(grads["a"]), _t(grads["b"])])
        for i, n in enumerate(("a", "b")):
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), err_msg=n, **TOL6)
            np.testing.assert_allclose(opt.acc[i].numpy(), np.asarray(state.acc_grads[n]),
                                       err_msg=f"acc {n}", **TOL6)
            if (step + 1) % k:
                assert torch.equal(tp[n], before[n]), (step, n)
        assert int(state.mini_step) == opt.mini_step
        assert int(state.gradient_step) == opt.count == (step + 1) // k
    assert np.array_equal(np.asarray(jp["z_frozen"]), params["z_frozen"])


@pytest.mark.parametrize("k", [2, 3])
def test_exponential_decay_is_counted_in_updates(k):
    """steps_per_epoch counts mini-steps, the schedule counts updates: the
    rate of update n is lr * rate ** (n // steps_per_epoch), so with k > 1
    it decays once every k epochs; SGD makes each update -lr * the mean
    gradient, so the JAX package's updates show the same rates."""
    kw = dict(optimizer="SGD", learning_rate=0.1, lr_schedule="exponential",
              lr_decay_rate=0.5, min_lr=1e-6, clip=10.0, grad_accum_steps=k)
    spe, epochs = 2, 3 * k
    tx = jstate.make_optimizer(JConfig(**kw), steps_per_epoch=spe)
    p = torch.zeros(1)
    opt = Optimizer(Config(device="cpu", **kw), [p], steps_per_epoch=spe)
    state = tx.init(jnp.zeros(1))
    port_rates, jax_rates = [], []
    for step in range(epochs * spe):
        before = p.clone()
        opt.step([torch.ones(1)])
        updates, state = tx.update(jnp.ones(1), state)
        if (step + 1) % k == 0:
            port_rates.append(float(before - p))
            jax_rates.append(-float(updates[0]))
    want = [0.1 * 0.5 ** (n // spe) for n in range(len(port_rates))]
    np.testing.assert_allclose(port_rates, want, rtol=1e-6)
    np.testing.assert_allclose(jax_rates, want, rtol=1e-6)
    # epochs of mini-steps between halvings: steps_per_epoch updates of k each
    assert len(port_rates) == epochs * spe // k


SIZES = dict(visual_size=5, acoustic_size=6, vocab_size=64)


def _cfg(**kw):
    base = dict(device="cpu", hidden_size=16, embedding_size=8, compute_dtype="float32",
                use_bert=False, batch_size=8, learning_rate=1e-2, **SIZES)
    return Config(**{**base, **kw})


def _split(n, seed=0):
    return make_split(SyntheticSpec(num_examples=n, max_len=8, seed=seed,
                                    bert_vocab_size=64, **SIZES))


def test_grad_accum_matches_big_batch():
    """The JAX package's test of the same name on the port: 2 mini-batches
    of 8 with grad_accum_steps=2 against 1 batch of 16, from the same
    parameters, forward deterministic.  No update after the first
    mini-batch; after the second the update points the big batch's way
    (CMD and the difference loss couple a batch's rows, so the mean of the
    mini-batch gradients is not the big batch's)."""
    data = _split(16)
    model16 = init_misa(_cfg(batch_size=16), seed=0).eval()
    model8 = init_misa(_cfg(), seed=0).eval()
    start = model16.classifier.weight.detach().clone()

    def step(model, opt, arrays, n):
        batch = next(iter(ArrayLoader(arrays, n, shuffle=False)))
        _, grads = loss_and_grads(model, batch, model.cfg, opt.params)
        opt.step(grads)

    opt16 = Optimizer(_cfg(batch_size=16), list(model16.parameters()))
    step(model16, opt16, data, 16)
    opt8 = Optimizer(_cfg(grad_accum_steps=2), list(model8.parameters()))
    step(model8, opt8, {k: v[:8] for k, v in data.items()}, 8)
    assert torch.equal(model8.classifier.weight, start)
    step(model8, opt8, {k: v[8:] for k, v in data.items()}, 8)
    a = (model16.classifier.weight - start).detach().numpy()
    b = (model8.classifier.weight - start).detach().numpy()
    cos = np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.7, cos
    assert opt8.count == 1 and opt8.mini_step == 0


def test_accumulating_steps_through_step_graphs_equal_eager():
    """Four mini-steps (k = 2) with dropout on: eager `train_step`s against
    `make_train_graph` (on the CPU the captured body over static buffers),
    from one state and generator seed: the losses, grad_norm, parameters,
    moments and accumulators bit for bit; the graph object keys its runs by
    the optimizer's two kinds of mini-step."""
    cfg = _cfg(grad_accum_steps=2, dropout=0.3, ema_decay=0.9)
    hosts = list(ArrayLoader(_split(32, seed=1), 8, shuffle=False).host_batches())

    def run(captured):
        model = init_misa(cfg, seed=2)
        opt = Optimizer(cfg, list(model.parameters()))
        ema = [p.detach().clone() for p in model.parameters()]
        gen = torch.Generator().manual_seed(5)
        graph = make_train_graph(model, opt, cfg, "cpu", gen, ema) if captured else None
        out = []
        for h in hosts:
            if captured:
                losses = {k: v.clone() for k, v in graph(h).items()}
            else:
                losses = train_step(model, opt, to_device(h, torch.device("cpu")), cfg, gen, ema)
            out.append(losses)
        tensors = [*model.parameters(), *opt.mu, *opt.nu, *opt.acc, *ema]
        return out, [t.detach().clone() for t in tensors], opt

    eager, eager_t, eager_opt = run(False)
    graph, graph_t, graph_opt = run(True)
    for a, b in zip(eager, graph):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(a, b) for a, b in zip(eager_t, graph_t))
    assert eager_opt.count == graph_opt.count == 2
