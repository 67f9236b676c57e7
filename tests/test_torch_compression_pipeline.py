"""The port's int8 gradient compression (``repro_torch.training.compression``)
and GPipe forward (``repro_torch.training.pipeline``) on the CPU, against
the JAX reference's ``repro.training.compression`` and
``repro.training.pipeline``.

In process: ``quantize_dequantize`` on numpy-seeded inputs (float32 and a
bfloat16 gradient) and ``make_compressor``'s ``apply`` over reduced models'
gradient lists give the reference's bits (both run op by op: under
``jax.jit`` XLA contracts the error's ``target - q * scale`` into a fused
multiply-add, one rounding away); the reference's 50-step error-feedback
test runs through the port.

Four gloo ranks (four processes over one ``FileStore``, started with the
module) beside one reference process on a forced 4-device CPU mesh, each
running all its cases in one start: ``compressed_psum`` of per-rank
numpy-seeded gradients against the reference's under ``shard_map`` (the
same bits on every rank), and ``pipeline_forward`` on the reference test's
tanh stack (``tests/test_pipeline.py``: L 8, d 16, M 6, mb 2) within 1e-5
of the reference's output (the reference's own bar against sequential) and
the same bits as the port's own sequential stack.  Every group times out
after 60 s and every process is joined with a timeout, so a hung
collective fails the test.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.training import compression as jcompression  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    encdec_params_from_numpy,
    encdec_params_to_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.models.common import Params  # noqa: E402
from repro_torch.training import compression  # noqa: E402

RANKS = 4
JOIN_S = 240  # a rank or the reference subprocess past this fails the test
PIPE_TOL = 1e-5  # the reference's own bar of its pipeline against sequential
ROOT = Path(__file__).resolve().parent.parent

# per-rank gradients of the compressed_psum cases, drawn by either package:
# (name, shape, dtype, rank whose values are scaled up so that its scale is
# the shared one)
_CASES = """
import numpy as np

PSUM_CASES = [("vector", (1000,), "float32", None), ("matrix", (37, 11), "float32", 2),
              ("bfloat16", (513,), "bfloat16", 1), ("zeros", (8,), "float32", None)]
L, D, M, MB = 8, 16, 6, 2


def grads(rank, shape, big):
    g = np.random.default_rng(100 + rank).normal(size=shape).astype(np.float32)
    if shape == (8,):
        g[:] = 0.0
    return g * np.float32(100.0 if rank == big else 1.0)


def pipeline_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    batch = rng.normal(size=(M, MB, D)).astype(np.float32)
    return ws, batch
"""

_RANK_SCRIPT = """
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from repro_torch.training.compression import compressed_psum
from repro_torch.training.pipeline import pipeline_forward
""" + _CASES + """
res = {}
for name, shape, dtype, big in PSUM_CASES:
    g = torch.as_tensor(grads(rank, shape, big)).to(getattr(torch, dtype))
    res["psum/" + name] = compressed_psum(g).float().numpy()

ws, batch = pipeline_inputs()
ws, batch = torch.as_tensor(ws), torch.as_tensor(batch)
per = L // world


def stage_fn(sp, x):
    for w in sp:
        x = torch.tanh(x @ w)
    return x


res["pipe/out"] = pipeline_forward(None, stage_fn, M)(ws[rank * per:(rank + 1) * per], batch).numpy()
res["pipe/sequential"] = torch.stack([stage_fn(ws, batch[m]) for m in range(M)]).numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""

_REF_SCRIPT = """
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.training.compression import compressed_psum
from repro.training.pipeline import pipeline_forward
""" + _CASES + """
mesh = jax.make_mesh((4,), ("d",))
res = {}
for name, shape, dtype, big in PSUM_CASES:
    g = jnp.stack([jnp.asarray(grads(r, shape, big)).astype(getattr(jnp, dtype))
                   for r in range(4)])
    f = shard_map(lambda x: compressed_psum(x[0], "d")[None], mesh=mesh, in_specs=P("d"),
                  out_specs=P("d"), check_rep=False)
    res["psum/" + name] = np.asarray(jax.jit(f)(g).astype(jnp.float32))


def stage_fn(sp, x):
    def body(x, w):
        return jnp.tanh(x @ w), None
    return jax.lax.scan(body, x, sp)[0]


ws, batch = pipeline_inputs()
with mesh:
    out = jax.jit(pipeline_forward(mesh, "d", stage_fn, M))(
        jnp.asarray(ws).reshape(4, L // 4, D, D), jnp.asarray(batch))
res["pipe/out"] = np.asarray(out)
np.savez(sys.argv[1], **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


@pytest.fixture(scope="module", autouse=True)
def _four_rank_procs(tmp_path_factory):
    """Four gloo ranks of the port and the reference on a forced 4-device
    mesh, started with the module so that they run beside its in-process
    tests; :func:`four_ranks` joins them.  Whatever is left is killed when
    the module ends."""
    tmp = tmp_path_factory.mktemp("ranks")
    procs = [("reference", subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "ref.npz")], env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))]
    for rank in range(RANKS):
        procs.append((f"rank {rank}", subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT, str(rank), str(RANKS), str(tmp / "store"),
             str(tmp)], env=_env(OMP_NUM_THREADS="1"),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
    yield tmp, procs
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def four_ranks(_four_rank_procs):
    """(per-rank results, reference results) of the five processes."""
    tmp, procs = _four_rank_procs
    errors = []
    for name, p in procs:
        try:
            _, err = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            pytest.fail(f"{name} did not finish in {JOIN_S} s (a hung collective?)")
        if p.returncode != 0:
            errors.append(f"{name} exited {p.returncode}: {err[-2000:]}")
    assert not errors, "\n".join(errors)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]
    return ranks, dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("case", ["vector", "matrix", "bfloat16", "zeros"])
def test_compressed_psum_four_ranks_match_reference(four_ranks, case):
    """Every rank the reference's bits: the shared scale from the largest
    rank (``matrix``, ``bfloat16``: one rank 100x the others), a bfloat16
    gradient, and all-zero gradients (the 1e-12 floor of the scale)."""
    ranks, ref = four_ranks
    key = f"psum/{case}"
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key], ref[key][r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[key], ranks[0][key], err_msg=f"rank {r}")


def test_pipeline_forward_four_ranks(four_ranks):
    """The GPipe forward on every rank: within 1e-5 of the reference's, the
    bits of the port's own sequential stack, the same on every rank."""
    ranks, ref = four_ranks
    want = ref["pipe/out"]
    assert want.shape == (6, 2, 16)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["pipe/out"], got["pipe/sequential"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["pipe/out"], ranks[0]["pipe/out"], err_msg=f"rank {r}")
        err = float(np.abs(got["pipe/out"] - want).max())
        assert err < PIPE_TOL, f"rank {r}: pipeline vs the reference's {err:.3e}"


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_matches_reference(dtype):
    rng = np.random.default_rng(5)
    for n, spread in ((1000, 1.0), (4097, 1e-3), (7, 1e-20)):
        g = (rng.normal(size=n) * spread).astype(np.float32)
        err = (rng.normal(size=n) * spread * 1e-2).astype(np.float32)
        g_hat_j, err_j = jcompression.quantize_dequantize(
            jnp.asarray(g).astype(getattr(jnp, dtype)), jnp.asarray(err))
        g_hat, new_err = compression.quantize_dequantize(
            torch.as_tensor(g).to(getattr(torch, dtype)), torch.as_tensor(err))
        assert g_hat.dtype == getattr(torch, dtype) and new_err.dtype == torch.float32
        np.testing.assert_array_equal(g_hat.float().numpy(),
                                      np.asarray(g_hat_j.astype(jnp.float32)), err_msg=str(n))
        np.testing.assert_array_equal(new_err.numpy(), np.asarray(err_j), err_msg=str(n))


def test_quantize_dequantize_error_feedback():
    """The reference's ``test_quantize_dequantize_error_feedback`` through
    the port: one shot within a quantum, and the mean of 50 fed-back steps
    within 2e-3 of the gradient."""
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=1000).astype(np.float32))
    g1, _ = compression.quantize_dequantize(g, torch.zeros(1000))
    assert float((g1 - g).abs().max()) <= float(g.abs().max()) / 127 + 1e-6
    total, e = torch.zeros(1000), torch.zeros(1000)
    for _ in range(50):
        gh, e = compression.quantize_dequantize(g, e)
        total = total + gh
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=2e-3)


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-v0.1-52b", "whisper-tiny"])
def test_make_compressor_matches_reference_apply(arch):
    """``apply`` over a reduced model's gradient list (numpy-seeded
    gradients in the reference's params tree, each row of a leaf, so each
    layer of a stacked leaf, at its own magnitude; carried across by
    ``convert``) and a numpy-seeded error: each of the reference's leaves
    the same bits, a stacked leaf's layers on one scale (qwen3-4b stacks 2
    layers, jamba's 8-layer unit 8 positions of one layer each, whisper 2
    encoder and 2 decoder layers); twice, the second time on the first's
    error."""
    cfg_j = jconfigs.get_arch(arch).reduced()
    cfg = configs.get_arch(arch).reduced()
    params_j, _ = jmodels.build(cfg_j).init(jax.random.key(0))
    rng = np.random.default_rng(9)

    def draw(p, scale):
        rows = rng.uniform(0.1, 10.0, size=p.shape[:1] + (1,) * (p.ndim - 1))
        return jnp.asarray((rng.normal(size=p.shape) * rows * scale).astype(np.float32))

    grads_j = jax.tree.map(lambda p: draw(p, 1e-3), params_j)
    err_j = jax.tree.map(lambda p: draw(p, 1e-5), params_j)
    from_numpy, to_numpy = ((encdec_params_from_numpy, encdec_params_to_numpy) if cfg.is_encdec
                            else (lm_params_from_numpy, lm_params_to_numpy))

    def port(tree):
        return from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu")

    init_err, apply = compression.make_compressor(cfg)
    template = port(grads_j)
    zeros = init_err(template)
    assert [z.shape for z in zeros] == [p.shape for p in template.parameters()]
    grads, err = list(template.parameters()), list(port(err_j).parameters())
    _, apply_j = jcompression.make_compressor()
    for _ in range(2):
        g_hat_j, err_j = apply_j(grads_j, err_j)
        g_hat, err = apply(grads, err)
        for got, want in ((g_hat, g_hat_j), (err, err_j)):
            out = port(want)
            for p, t in zip(out.parameters(), got, strict=True):
                p.data = t
            got_tree = to_numpy(out, cfg)
            for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
                g = got_tree
                for key in path:
                    g = g[key.key]
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))


def test_make_compressor_scales_each_unstacked_tensor():
    """A tree without the reference's stacks: each tensor is its own leaf,
    ``quantize_dequantize``'s bits tensor by tensor."""
    rng = np.random.default_rng(1)
    tree = Params({"a": torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32)),
                   "b": torch.as_tensor(rng.normal(size=5).astype(np.float32) * 1e3)})
    init_err, apply = compression.make_compressor(configs.get_arch("qwen3-4b").reduced())
    err = init_err(tree)
    grads = list(tree.parameters())
    g_hat, new_err = apply(grads, err)
    for g, e, h, ne in zip(grads, err, g_hat, new_err, strict=True):
        want_h, want_e = compression.quantize_dequantize(g, e)
        assert torch.equal(h, want_h) and torch.equal(ne, want_e)


def test_make_compressor_apply_needs_init_err():
    """``apply`` before ``init_err`` raises (it has no leaves to scale by),
    and so does a gradient list of another length than the weights'."""
    cfg = configs.get_arch("qwen3-4b").reduced()
    init_err, apply = compression.make_compressor(cfg)
    g = [torch.ones(3)]
    with pytest.raises(RuntimeError, match="init_err"):
        apply(g, g)
    err = init_err(Params({"a": torch.ones(3), "b": torch.ones(2)}))
    with pytest.raises(ValueError, match="2 weights"):
        apply(g, err[:1])
