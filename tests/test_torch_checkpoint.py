"""The port's checkpointing (``repro_torch.training.checkpoint``) on the CPU,
against the JAX reference's ``repro.training.checkpoint``.

The twins of the reference's round-trip, keep-trim and latest-step tests on
a port train state (each leaf the same bits); a failure mid-write leaves no
temporary directory and the previous checkpoint readable; and one
checkpoint directory serves both packages, for reduced qwen3-4b and reduced
whisper-tiny: the reference's ``save`` of its state after two of its jitted
steps, read back by the port's ``restore``, is ``convert`` of that state
bit for bit, and the port's ``save`` of its state, read back by the
reference's ``restore``, is the port's leaves in the reference's layout bit
for bit, under the same keys, shapes and dtypes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JSyntheticLMData  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import encdec_params_to_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.models.common import Params  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.step import init_train_state, make_train_step  # noqa: E402

B, S = 2, 32  # the train steps' batch


def _cfgs(arch):
    return jconfigs.get_arch(arch).reduced(), configs.get_arch(arch).reduced()


def _port_state(cfg, steps=0):
    """The port's own weights (``torch.Generator`` seed 0) after ``steps``
    steps of ``make_train_step``."""
    api = models.build(cfg)
    state = init_train_state(cfg, api, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, api)
    enc = (cfg.enc_frames, cfg.d_model) if cfg.is_encdec else None
    for i in range(steps):
        batch = JSyntheticLMData(cfg.vocab, seed=0).batch(i, B, S, enc=enc)
        state, _ = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    return state


def _ref_state(cfg_j, steps=0):
    api_j = jmodels.build(cfg_j)
    state, _ = jstep.init_train_state(cfg_j, api_j, jax.random.key(0))
    step = jax.jit(jstep.make_train_step(cfg_j, api_j))
    enc = (cfg_j.enc_frames, cfg_j.d_model) if cfg_j.is_encdec else None
    for i in range(steps):
        batch = JSyntheticLMData(cfg_j.vocab, seed=0).batch(i, B, S, enc=enc)
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state


def _same_leaves(a: Params, b: Params):
    for (name, p), (name_b, q) in zip(a.named_parameters(), b.named_parameters(), strict=True):
        assert name == name_b
        assert p.dtype == q.dtype and p.device == q.device and p.requires_grad == q.requires_grad
        assert torch.equal(p, q), name


def _same_tree(got: dict, want):
    """A nested dict of numpy arrays against a reference pytree, bit for bit."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(jax.tree_util.tree_leaves(got)) == len(flat)
    for path, w in flat:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))


def test_checkpoint_roundtrip(tmp_path):
    """The reference's ``test_checkpoint_roundtrip`` on a port train state
    after one step (moments non-zero): the step, every parameter and
    moment the same bits, dtype, device and gradient flag."""
    cfg = configs.get_arch("qwen3-4b").reduced()
    state = _port_state(cfg, steps=1)
    path = str(tmp_path / "ckpt")
    ckpt.save(path, 7, state, cfg=cfg)
    assert ckpt.latest_step(path) == 7
    like = _port_state(cfg)
    restored = ckpt.restore(path, 7, like, cfg=cfg)
    assert restored.step == state.step == 1
    for a, b in ((restored.params, state.params), (restored.opt.m, state.opt.m),
                 (restored.opt.v, state.opt.v)):
        _same_leaves(a, b)
    # a bare model and a plain dict of tensors, a bfloat16 leaf among them
    ckpt.save(path, 8, state.params, cfg=cfg)
    _same_leaves(ckpt.restore(path, 8, like.params, cfg=cfg), state.params)
    d = {"x": torch.arange(6.0).reshape(2, 3), "half": torch.randn(5).to(torch.bfloat16),
         "n": {"i": torch.arange(4, dtype=torch.int32)}}
    ckpt.save(path, 9, d)
    back = ckpt.restore(path, 9, d)
    for key in ("x", "half"):
        assert back[key].dtype == d[key].dtype and torch.equal(back[key], d[key])
    assert torch.equal(back["n"]["i"], d["n"]["i"]) and back["n"]["i"].dtype == torch.int32


def test_checkpoint_keep_trims(tmp_path):
    path = str(tmp_path / "ckpt3")
    assert ckpt.latest_step(path) is None
    for s in range(5):
        ckpt.save(path, s, {"x": torch.ones(3) * s}, keep=2)
    assert ckpt.latest_step(path) == 4
    kept = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    assert torch.equal(ckpt.restore(path, 3, {"x": torch.zeros(3)})["x"], torch.full((3,), 3.0))


def test_failed_write_leaves_the_latest_checkpoint(tmp_path, monkeypatch):
    """An exception mid-write (after part of the archive is on disk) leaves
    no ``.tmp_`` directory, and the previous latest step readable."""
    path = str(tmp_path / "ckpt")
    ckpt.save(path, 1, {"x": torch.ones(3)})
    savez = np.savez

    def failing(file, **arrays):
        savez(file, **dict(list(arrays.items())[:1]))
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", failing)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(path, 2, {"x": torch.zeros(3), "y": torch.zeros(2)})
    monkeypatch.undo()
    assert sorted(os.listdir(path)) == ["step_00000001"]
    assert ckpt.latest_step(path) == 1
    assert torch.equal(ckpt.restore(path, 1, {"x": torch.zeros(3)})["x"], torch.ones(3))


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-tiny"])
def test_checkpoints_cross_between_packages(tmp_path, arch):
    cfg_j, cfg = _cfgs(arch)
    to_numpy = encdec_params_to_numpy if cfg.is_encdec else lm_params_to_numpy
    # the reference's checkpoint, restored by the port
    state_j = _ref_state(cfg_j, steps=2)
    jckpt.save(str(tmp_path / "ref"), 2, state_j)
    like = _port_state(cfg)
    got = ckpt.restore(str(tmp_path / "ref"), 2, like, cfg=cfg)
    assert got.step == 2
    for mine, theirs, mold in ((got.params, state_j.params, like.params),
                               (got.opt.m, state_j.opt.m, like.opt.m),
                               (got.opt.v, state_j.opt.v, like.opt.v)):
        _same_tree(to_numpy(mine, cfg), theirs)
        for p, q in zip(mine.parameters(), mold.parameters(), strict=True):
            assert p.dtype == q.dtype and p.requires_grad == q.requires_grad
    # the port's checkpoint, restored by the reference
    state = _port_state(cfg, steps=2)
    ckpt.save(str(tmp_path / "port"), 2, state, cfg=cfg)
    back = jckpt.restore(str(tmp_path / "port"), 2, _ref_state(cfg_j))
    assert int(back.step) == 2 and back.step.dtype == jnp.int32
    for theirs, mine in ((back.params, state.params), (back.opt.m, state.opt.m),
                         (back.opt.v, state.opt.v)):
        _same_tree(to_numpy(mine, cfg), theirs)
    # the same keys, shapes and dtypes in both manifests
    manifests = [json.load(open(tmp_path / d / "step_00000002" / "manifest.json"))
                 for d in ("ref", "port")]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    assert manifests[0]["step"] == manifests[1]["step"] == 2
    assert ".step" in manifests[1]["leaves"] and ".opt/.m/final_norm" in manifests[1]["leaves"]


def test_restore_refusals(tmp_path):
    """``shardings=`` (restore onto a mesh) places a train state's or a
    model's weights, not a plain dict's; a state's missing leaves raise as
    the reference's do; a model's stacks need its config."""
    cfg = configs.get_arch("qwen3-4b").reduced()
    state = _port_state(cfg)
    path = str(tmp_path / "ckpt")
    ckpt.save(path, 1, {"x": torch.ones(2)})
    with pytest.raises(TypeError, match="shardings= places"):
        ckpt.restore(path, 1, {"x": torch.ones(2)}, shardings={"x": None})
    with pytest.raises(ValueError, match="checkpoint missing leaves"):
        ckpt.restore(path, 1, state, cfg=cfg)
    with pytest.raises(ValueError, match="cfg="):
        ckpt.save(path, 2, state)
