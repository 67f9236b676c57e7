"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, against
the JAX reference's placements.

The reference's own test of its dry run (``tests/test_sharding_analysis.py``)
no longer collects under the installed JAX.  Here ``dryrun_cell`` traces,
at one rank of a ``"fake"`` group of 256 (or 512) ranks that it builds and
tears down itself, the reference test's cell (whisper-tiny ``decode_32k`` on
the pod mesh, by the CLI in a subprocess and in process) and a train cell
(qwen3-4b ``train_4k`` at its published widths, cut to 2 layers): each
record ``OK`` with the mesh's ranks, nothing allocated but ``meta``
tensors, every weight's (and moment's, cache's, batch tensor's) shard on
this rank the bytes of the reference's ``resolve_spec`` shard of that leaf
(the reference's spec trees captured through ``jax.eval_shape``, its
resolver called with a stand-in of the mesh), and ``argument_bytes`` their
sum.  The reference's SKIP set is the port's.  A cell that raises is a
``FAIL`` record and the CLI exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.analysis.roofline import param_counts as jparam_counts  # noqa: E402
from repro.sharding import logical as jlogical  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.sharding import default_rules, is_distributed  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
POD = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 16, "model": 16})
TRAIN_LAYERS = 2  # the train cell's depth: qwen3-4b's published widths, 2 of its 36 layers
CLI_TIMEOUT_S = 240


def _shard_bytes(spec, shape, itemsize: int) -> int:
    """Bytes of one rank's shard of a leaf the reference's spec places."""
    n = 1
    for d, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n *= d // math.prod(POD.shape[a] for a in axes)
    return n * itemsize


def _ref_leaf_bytes(cfg, serving: bool) -> list[int]:
    """Per layer, each weight's shard bytes on one rank as the reference
    places it (a stacked leaf [units, ...] counted once per unit)."""
    api = jmodels.build(cfg)
    box = {}

    def init(key):
        params, box["specs"] = api.init(key)
        return params

    shapes = jax.eval_shape(init, jax.random.key(0))
    rules = jlogical.default_rules(POD, serving=serving)
    out = []

    def walk(specs, tree):
        for k, names in specs.items():
            if isinstance(names, dict):
                walk(names, tree[k])
                continue
            leaf = tree[k]
            one = _shard_bytes(jlogical.resolve_spec(names, leaf.shape, rules), leaf.shape,
                               leaf.dtype.itemsize)
            units = leaf.shape[0] if names[:1] == ("unit",) else 1
            out.extend([one // units] * units)

    walk(box["specs"], shapes)
    return sorted(out)


def _ref_batch_bytes(cfg, shape, serving: bool) -> list[int]:
    """Each batch tensor's (train, prefill) or each cache leaf's and the
    decode tokens' shard bytes on one rank, the reference's placements."""
    rules = jlogical.default_rules(POD, serving=serving)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind != "decode":
        from repro.data.pipeline import make_batch_specs

        return sorted(_shard_bytes(jlogical.resolve_spec(("batch",) + (None,) * (len(v.shape) - 1),
                                                         v.shape, rules), v.shape, 4)
                      for v in make_batch_specs(cfg, shape).values())
    api = jmodels.build(cfg)
    caches = jax.eval_shape(lambda: api.init_decode_cache(B, S))
    out = [_shard_bytes(jlogical.resolve_spec(("batch", None), (B, 1), rules), (B, 1), 4)]
    for leaf in jax.tree.leaves(caches):
        units = leaf.shape[0]
        names = dryrun.cache_spec_names(tuple(leaf.shape[1:]))
        one = _shard_bytes(jlogical.resolve_spec((None, *names), leaf.shape, rules), leaf.shape,
                           leaf.dtype.itemsize)
        out.extend([one // units] * units)
    return sorted(out)


def _local(t) -> torch.Tensor:
    return t.to_local() if is_distributed(t) else t


@pytest.fixture
def fake_pod():
    """A ``"fake"`` group of 256 ranks and the pod mesh on it, torn down after."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    yield make_production_mesh(device="cpu")
    dist.destroy_process_group()


CELLS = [("whisper-tiny", "decode_32k", None),
         ("qwen3-4b", "train_4k", {"n_layers": TRAIN_LAYERS})]


@pytest.mark.parametrize("arch, shape, overrides", CELLS, ids=[c[1] for c in CELLS])
def test_placements_are_the_references(fake_pod, arch, shape, overrides):
    """Every argument of the cell a meta DTensor whose shard on this rank has
    the bytes of the reference's placement of that leaf: the weights (at
    serving rules for decode), both moments (train), the batch or the
    caches and tokens."""
    cfg = dataclasses.replace(configs.get_arch(arch), **(overrides or {}))
    jcfg = dataclasses.replace(jconfigs.get_arch(arch), **(overrides or {}))
    spec = configs.SHAPES[shape]
    serving = spec.kind == "decode"
    _, args = dryrun.cell_args(cfg, spec, default_rules(fake_pod, serving=serving))
    if spec.kind == "train":
        state, batch = args
        trees = [state.params, state.opt.m, state.opt.v]
        rest = list(batch.values())
    else:
        params, caches, tokens, _ = args
        trees = [params]
        rest = [tokens] + [t for c in caches for t in c]
    want = _ref_leaf_bytes(jcfg, serving)
    for tree in trees:
        locals_ = [_local(p) for p in tree.parameters()]
        assert all(is_distributed(p) for p in tree.parameters())
        assert all(t.device.type == "meta" for t in locals_)
        assert sorted(t.numel() * t.element_size() for t in locals_) == want
    assert all(is_distributed(t) and _local(t).device.type == "meta" for t in rest)
    assert sorted(_local(t).numel() * _local(t).element_size() for t in rest) == _ref_batch_bytes(
        jcfg, jconfigs.SHAPES[shape], serving)
    assert dryrun.argument_bytes(*args) == len(trees) * sum(want) + sum(
        _ref_batch_bytes(jcfg, jconfigs.SHAPES[shape], serving))


# and two cells that once failed: a GQA decode whose 8 kv heads do not
# divide the model axis, and whisper's training, whose 6 heads do not
CELL_IDS = ["decode_32k", "train_4k", "gqa_decode", "whisper_train"]


@pytest.mark.parametrize("arch, shape, overrides", CELLS + [
    ("qwen3-4b", "decode_32k", None), ("whisper-tiny", "train_4k", None)], ids=CELL_IDS)
def test_dryrun_cell(arch, shape, overrides):
    """An OK record with the pod's 256 ranks, argument bytes as placed,
    nothing but meta tensors of one or more dims, the roofline's bottleneck
    one of its terms, and the group torn down; the cut train cell traces
    the flash kernel's op with lse once per layer, microbatch and pass."""
    rec = dryrun.dryrun_cell(arch, shape, "pod", overrides)
    assert not dist.is_initialized()
    assert rec["status"] == "OK" and rec["n_devices"] == 256
    assert rec["devices"] == ["meta"]
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
    assert set(rec["collectives"]) <= {"total", "all-reduce", "all-gather", "reduce-scatter",
                                       "all-to-all", "collective-permute"}
    assert rec["collectives"]["total"]["count"] > 0
    cfg = configs.get_arch(arch)
    if configs.SHAPES[shape].kind == "train" and overrides:
        passes = 2 if cfg.remat else 1
        assert rec["flash_attention_calls"] == {
            "flash_attention_lse": TRAIN_LAYERS * max(cfg.microbatch, 1) * passes}
        assert rec["memory"]["output_bytes"] < 1024  # the state is updated in place
    want = jparam_counts(dataclasses.replace(jconfigs.get_arch(arch), **(overrides or {})))
    assert (rec["params_total"], rec["params_active"]) == (want["total"], want["active"])


def test_skip_set_is_the_references():
    """A cell the reference's config marks not runnable is a SKIP record
    (built before any group); the runnable sets agree on every cell."""
    for arch in configs.list_archs():
        for shape in configs.SHAPES:
            runnable = jconfigs.get_arch(arch).runnable(shape)
            assert configs.get_arch(arch).runnable(shape) == runnable
            if not runnable:
                rec = dryrun.dryrun_cell(arch, shape, "pod")
                assert rec["status"] == "SKIP" and not dist.is_initialized(), rec


def test_multipod_cell():
    """The 2 x 16 x 16 mesh: 512 ranks."""
    rec = dryrun.dryrun_cell("whisper-tiny", "decode_32k", "multipod")
    assert rec["status"] == "OK" and rec["n_devices"] == 512


def test_cli(tmp_path, monkeypatch):
    """The reference test's cell through ``python -m`` (importing the module
    starts no group and sets no environment); a cell that raises is a FAIL
    record and ``main`` returns 1."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    probe = subprocess.run([sys.executable, "-c",
                            "import os, torch.distributed as d; before = dict(os.environ); "
                            "import repro_torch.launch.dryrun; "
                            "print(d.is_initialized(), dict(os.environ) == before)"],
                           capture_output=True, text=True, env=env, timeout=CLI_TIMEOUT_S)
    assert probe.stdout.split() == ["False", "True"], probe.stderr[-2000:]
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "whisper-tiny", "--shape", "decode_32k", "--mesh", "pod", "--out",
                          str(tmp_path)], capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=CLI_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rec = json.loads((tmp_path / "whisper-tiny__decode_32k__pod.json").read_text())
    assert rec["status"] == "OK" and rec["n_devices"] == 256
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert "[OK] whisper-tiny__decode_32k__pod" in out.stdout

    def broken(*args, **kwargs):
        raise ValueError("a broken cell")

    monkeypatch.setattr(dryrun, "dryrun_cell", broken)
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k", "--out",
                        str(tmp_path / "fail")]) == 1
    rec = json.loads((tmp_path / "fail" / "qwen3-4b__train_4k__pod.json").read_text())
    assert rec["status"] == "FAIL" and rec["error"] == "ValueError: a broken cell"
