"""The port's training slice against the reference on the CPU, in float32
on ``reduced()`` configs with the reference's weights carried across by
``convert``: the losses and their gradients for every family ``build``
takes, ``make_train_step`` over three steps (microbatch 1 and 2), AdamW's
global-norm clipping, the cosine schedule and the synthetic bigram data.

Sequences are 128 tokens (96 encoder frames), past the reduced configs'
``attn_chunk`` of 64, so every attention layer takes the blocked branch
(``flash_vjp``: the plain blocked forward and the hand-written backward on
the CPU); the configs keep ``remat``, so the port's forward runs under
``torch.utils.checkpoint``.  Bars: the loss 2e-5; each gradient leaf and
each parameter after the steps 2e-5 of the leaf's largest magnitude (both
packages sum float32 products in other orders).

The batch is 4 x 128 tokens.  At 2 x 128 (step 0 of the data) jamba's
layer-6 ``dt_bias`` gradient, the smallest SSD leaf (largest magnitude
5.4e-5, a sum that cancels), is 2.36e-5 of its magnitude from the
reference's: the port's own code run in float64 puts the port's float32
value 1.07e-5 from it and the reference's 1.28e-5, on opposite sides, so
the bar there is below float32's resolution of that leaf in either package
(ROADMAP Queue 3, standing entries).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JSyntheticLMData  # noqa: E402
from repro.training import optimizer as joptimizer  # noqa: E402
from repro.training import schedule as jschedule  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    encdec_params_from_numpy,
    encdec_params_to_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models.common import Params  # noqa: E402
from repro_torch.training import optimizer, schedule  # noqa: E402
from repro_torch.training.state import TrainState  # noqa: E402
from repro_torch.training.step import make_train_step  # noqa: E402

TOL = 2e-5
FAMILIES = ["qwen3-4b", "olmoe-1b-7b", "mamba2-1.3b", "jamba-v0.1-52b", "whisper-tiny"]
B, S, FRAMES = 4, 128, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one CPU thread here: these small ops gain nothing from more
    (the file takes the same time alone), while other test files run beside
    it on the same cores, where a pool of spinning threads per process
    slowed it 7-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(name, **changes):
    extra = {"enc_frames": FRAMES} if name == "whisper-tiny" else {}
    return (dataclasses.replace(jconfigs.get_arch(name).reduced(), **extra, **changes),
            dataclasses.replace(configs.get_arch(name).reduced(), **extra, **changes))


def _carried(cfg_j, cfg):
    """The reference's weights (key 0) in both packages, and the port's
    inverse of ``convert``."""
    params_j, _ = jmodels.build(cfg_j).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params_j)
    if cfg.is_encdec:
        return params_j, encdec_params_from_numpy(tree, cfg, "cpu"), encdec_params_to_numpy
    return params_j, lm_params_from_numpy(tree, cfg, "cpu"), lm_params_to_numpy


def _batch(cfg, step):
    enc = (cfg.enc_frames, cfg.d_model) if cfg.is_encdec else None
    return JSyntheticLMData(cfg.vocab, seed=0).batch(step, B, S, enc=enc)


def _leaves_close(tag, got: dict, want, tol=TOL):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        g, w = np.asarray(flat_g[path], np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (tag, path)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, f"{tag} {jax.tree_util.keystr(path)}: {err:.3e} > {tol}"


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_gradients_match_the_reference(name):
    cfg_j, cfg = _cfgs(name)
    api_j, api = jmodels.build(cfg_j), models.build(cfg)
    params_j, params, to_numpy = _carried(cfg_j, cfg)
    batch = _batch(cfg, 0)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: api_j.loss(p, **b), has_aux=True))(
            params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    params.requires_grad_(True)
    loss, metrics = api.loss(params, **{k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= TOL
    assert set(metrics) == set(metrics_j)
    for key in metrics:
        assert abs(float(metrics[key]) - float(metrics_j[key])) <= TOL, key
    _leaves_close(f"{name} grad", to_numpy(params, cfg, grad=True), grads_j)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_steps_match_the_reference(microbatch):
    """Three steps of ``make_train_step`` at its defaults (lr 3e-4, 100
    warmup steps: the card's full-width run) from the same weights and
    batches: each step's loss and grad norm, then every parameter.  At lr
    1e-3 with one warmup step AdamW amplifies noise-level gradients (m / sqrt
    v is +-1 whichever side of zero they fall): there the reference's own
    parameters move by up to 4.4e-4 of the embedding's magnitude under a
    1-ulp change of the embedding, and the port sits 6.1e-4 from it (ROADMAP
    Queue 3, standing entries); ``test_adamw_update_matches_the_reference``
    holds the optimizer at that rate on shared gradients."""
    cfg_j, cfg = _cfgs("qwen3-4b", microbatch=microbatch)
    api_j, api = jmodels.build(cfg_j), models.build(cfg)
    params_j, params, to_numpy = _carried(cfg_j, cfg)
    step_j = jax.jit(jstep.make_train_step(cfg_j, api_j))
    state_j = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params_j,
                               opt=joptimizer.adamw_init(params_j, cfg_j.opt_dtype))
    params.requires_grad_(True)
    state = TrainState(0, params, optimizer.adamw_init(params, cfg.opt_dtype))
    step = make_train_step(cfg, api)
    for i in range(3):
        batch = _batch(cfg, i)
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "xent"):
            assert abs(float(m[key]) - float(m_j[key])) <= TOL * max(1.0, abs(float(m_j[key]))), (
                i, key, float(m[key]), float(m_j[key]))
    assert state.step == int(state_j.step) == 3
    _leaves_close("params", to_numpy(state.params, cfg), state_j.params)


def test_adamw_update_matches_the_reference():
    """Three AdamW steps at lr 1e-3 on the same gradients (numpy-seeded,
    some leaves past the clipping norm, one with elements near zero):
    parameters and both moments, float32 moments and bfloat16 ones."""
    rng = np.random.default_rng(11)
    shapes = {"a": (16, 8), "b": (8,), "c": (4, 4, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    for moment_dtype, mdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        params_j = {k: jnp.asarray(v) for k, v in p0.items()}
        opt_j = joptimizer.adamw_init(params_j, moment_dtype)
        params = Params({k: torch.tensor(v) for k, v in p0.items()})
        opt = optimizer.adamw_init(params, mdt)
        for i in range(3):
            g = {k: (rng.normal(size=s) * (1e-7 if k == "b" else 0.5)).astype(np.float32)
                 for k, s in shapes.items()}
            params_j, opt_j, gn_j = joptimizer.adamw_update(
                {k: jnp.asarray(v) for k, v in g.items()}, opt_j, params_j,
                step=jnp.asarray(i, jnp.int32), lr=1e-3)
            grads = [torch.tensor(g[name]) for name, _ in params.named_parameters()]
            _, opt, gn = optimizer.adamw_update(grads, opt, params, step=i, lr=1e-3)
            assert abs(float(gn) - float(gn_j)) <= 1e-6 * float(gn_j)
        for name, p in params.named_parameters():
            for got, want in ((p, params_j[name]), (opt.m[name], opt_j.m[name]),
                              (opt.v[name], opt_j.v[name])):
                got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
                assert np.abs(got - want).max() <= TOL * np.abs(want).max(), (moment_dtype, name)


def test_clip_by_global_norm_matches_the_reference():
    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((7, 5), (11,), (3, 4, 2))]
    for max_norm in (0.5, 1e3):  # clipped, and left as it is
        got, gn = optimizer.clip_by_global_norm([torch.tensor(a) for a in leaves], max_norm)
        want, gn_j = joptimizer.clip_by_global_norm([jnp.asarray(a) for a in leaves], max_norm)
        assert abs(float(gn) - float(gn_j)) <= 1e-6 * float(gn_j)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_cosine_schedule_matches_the_reference():
    lr, lr_j = schedule.cosine_schedule(3e-4, 100, 10_000), jschedule.cosine_schedule(
        3e-4, 100, 10_000)
    for step in (0, 1, 50, 98, 99, 100, 101, 5_000, 9_999, 10_000, 12_000):
        got, want = float(lr(step)), float(lr_j(step))
        assert abs(got - want) <= 2**-23 * want, (step, got, want)


@pytest.mark.parametrize("seed,step,dp_rank,enc", [(0, 0, 0, None), (0, 7, 3, None),
                                                     (5, 2, 1, (12, 8))])
def test_synthetic_data_is_the_references_bits(seed, step, dp_rank, enc):
    got = SyntheticLMData(1_000, seed=seed).batch(step, 3, 17, dp_rank, enc)
    want = JSyntheticLMData(1_000, seed=seed).batch(step, 3, 17, dp_rank, enc)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert SyntheticLMData(1_000).bigram_entropy() == JSyntheticLMData(1_000).bigram_entropy()


def test_loss_decreases():
    """The reference's own bar on learning (tests/test_training.py:
    test_loss_decreases) through the port's train step on its own seeded
    weights: reduced qwen3-4b, lr 5e-3, 3 warmup steps of 80, 30 steps of
    8 x 64 tokens, the loss down by more than 0.5."""
    from repro_torch.training.step import init_train_state

    cfg = configs.get_arch("qwen3-4b").reduced()
    api = models.build(cfg)
    state = init_train_state(cfg, api, torch.Generator().manual_seed(0), "cpu")
    data = SyntheticLMData(cfg.vocab, seed=0)
    step = make_train_step(cfg, api, lr=5e-3, warmup=3, total_steps=80)
    losses = []
    for i in range(30):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in data.batch(i, 8, 64).items()})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, f"no learning: {losses[0]} -> {losses[-1]}"
