"""The port's cost analysis (``repro_torch.analysis``) and
``data.pipeline.make_batch_specs`` on the CPU, against the JAX reference's
``repro.analysis`` and ``repro.data.pipeline``.

- ``make_batch_specs``, ``param_counts`` and ``model_flops`` give the
  reference's shapes, dtypes and numbers on every (arch, shape) of the
  registry; ``roofline_terms`` the reference's terms scaled by the ratio of
  the two cards' constants.
- The op counter (``analysis.flops``) on the reference test's ground
  truths: ``x @ x`` at 256^2 and a 10-step loop of it, 2 * 256^3 and ten
  times that, as ``analyze_hlo`` counts them.
- Its matrix-product FLOPs against the reference's on the compiled HLO of
  the same calls (reduced qwen3-4b's train step, prefill and decode step,
  reduced whisper-tiny's prefill; 2 x 64 tokens, so that attention takes
  the plain path in both).  The reference's ``by_op`` adds each
  computation's ops once, not times its loop's trip count (its ``flops``
  total does multiply), so the reference side is the dot FLOPs of its HLO
  walked with the trip counts (``_parse_module``, ``_dot_flops``,
  ``_while_trips``).  Bar, from the gaps measured first: equal, after one
  term.  The train step's global gradient norm takes ``torch.dot`` of each
  flattened gradient with itself in the port, 2 FLOPs an element under the
  rule, where the reference squares and reduces (no dot): the port counts
  2 * (the parameters) more.  (The first measurement also put reduced
  whisper's prefill 13% over: the cross-attention projected q, k and v of
  both the decoder's stream and the memory and used half of them, which
  XLA's dead-code pass drops; the port now projects only what it uses.)
- ``collective_stats``: the reference test's hand-written HLO text, and the
  port's records of two small sharded products on a ``"fake"`` group of 4
  against the reference's on the compiled HLO of the same products on a
  forced 4-device CPU mesh (a subprocess): a contraction sharded over the
  ranks with a replicated result (an all-reduce of it) and a product whose
  weight is sharded on the contraction beside a row-sharded activation (an
  all-gather of the weight).
- The flash-attention custom ops: the fake implementation's shapes and
  dtypes on ``meta`` tensors, ``torch.library.opcheck``, and on the CPU the
  plain version's bits; the counter's FLOPs of one call its kernel's count.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.analysis import flops as jflops  # noqa: E402
from repro.analysis import hlo as jhlo  # noqa: E402
from repro.analysis import roofline as jroofline  # noqa: E402
from repro.data.pipeline import make_batch_specs as jmake_batch_specs  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import hlo, roofline  # noqa: E402
from repro_torch.analysis.flops import CostCounter, analyze  # noqa: E402
from repro_torch.data.pipeline import make_batch_specs  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flops as flash_flops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.training.step import (  # noqa: E402
    init_train_state,
    make_serve_steps,
    make_train_step,
)

ARCHS = configs.list_archs()
SHAPES = list(configs.SHAPES)
ROOT = Path(__file__).resolve().parent.parent
B, S = 2, 64  # the dot comparison's batch: S = the reduced configs' attn_chunk
JAX_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}
REF_TIMEOUT_S = 120

_REF_COLLECTIVES = """
import json
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.analysis.hlo import collective_stats
mesh = Mesh(jax.devices()[:4], ("x",))
sh = lambda *s: NamedSharding(mesh, P(*s))
x, w = jax.ShapeDtypeStruct((8, 16), jnp.float32), jax.ShapeDtypeStruct((16, 12), jnp.float32)
cases = {
    "contraction": ((sh(None, "x"), sh("x", None)), sh()),
    "gathered": ((sh("x", None), sh("x", None)), sh("x", None)),
}
out = {}
for name, (ins, res) in cases.items():
    fn = jax.jit(lambda a, b: a @ b, in_shardings=ins, out_shardings=res)
    out[name] = collective_stats(fn.lower(x, w).compile().as_text())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_collectives():
    """The reference's collective stats of the two products, from a JAX
    process on a forced 4-device CPU mesh (started with the module)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_COLLECTIVES], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_specs_and_counts_match_the_reference(arch, shape):
    """Shapes and dtypes of the batch stand-ins (meta tensors), and the
    analytic parameter counts and model FLOPs, the reference's."""
    cfg, jcfg = configs.get_arch(arch), jconfigs.get_arch(arch)
    got, want = make_batch_specs(cfg, configs.SHAPES[shape]), jmake_batch_specs(
        jcfg, jconfigs.SHAPES[shape])
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert t.dtype == JAX_DTYPES[want[k].dtype.type]
    small = make_batch_specs(cfg, configs.SHAPES[shape], batch=3)
    assert all(t.shape[0] == 3 for t in small.values())
    assert roofline.param_counts(cfg) == jroofline.param_counts(jcfg)
    assert roofline.model_flops(cfg, configs.SHAPES[shape]) == jroofline.model_flops(
        jcfg, jconfigs.SHAPES[shape])


@pytest.mark.parametrize("inputs", [
    (256, 1.493e15, 1.366e16, 8.012e11),  # a train cell's per-rank counts
    (256, 5.111e8, 3.948e9, 1.644e9),  # a decode cell's
    (512, 3.0e12, 1.0e9, 1.0e6),
])
def test_roofline_terms_are_the_references_on_the_h100(inputs):
    """The reference's three terms scaled by the ratio of its TPU v5e
    constants to the H100's; the same model FLOPs and useful ratio; the
    bottleneck the largest of the port's terms."""
    n, flops, nbytes, coll = inputs
    cfg, jcfg = configs.get_arch("qwen3-4b"), jconfigs.get_arch("qwen3-4b")
    kw = dict(n_devices=n, hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=coll)
    got = roofline.roofline_terms(cfg, configs.SHAPES["train_4k"], **kw)
    want = jroofline.roofline_terms(jcfg, jconfigs.SHAPES["train_4k"], **kw)
    hw, jhw = roofline.HW, jroofline.HW
    assert got.compute_s == pytest.approx(want.compute_s * jhw["peak_flops"] / hw["peak_flops"],
                                          rel=1e-12)
    assert got.memory_s == pytest.approx(want.memory_s * jhw["hbm_bw"] / hw["hbm_bw"], rel=1e-12)
    assert got.collective_s == pytest.approx(want.collective_s * jhw["ici_bw"] / hw["link_bw"],
                                             rel=1e-12)
    terms = {"compute": got.compute_s, "memory": got.memory_s, "collective": got.collective_s}
    assert got.bottleneck == max(terms, key=terms.get)
    assert (got.model_flops, got.useful_ratio) == (want.model_flops, want.useful_ratio)
    assert hw == {"peak_flops": 989.4e12, "hbm_bw": 3.35e12, "link_bw": 450e9}
    wall = 2.0
    assert roofline.model_flops_utilization(cfg, configs.SHAPES["train_4k"], wall,
                                            n_devices=n) == pytest.approx(
        want.model_flops / wall / (989.4e12 * n), rel=1e-12)


def test_walker_ground_truths():
    """The reference test's: ``x @ x`` at 256^2 and ten steps of it in a
    loop, 2 * 256^3 and ten times that, exactly, on CPU tensors and on meta
    tensors alike; the reference's walker within its own test's 2% on its
    compiled HLO."""
    want = 2 * 256**3

    def scanned(x):
        c = x
        for _ in range(10):
            c = c @ x
        return c

    def jscanned(x):
        return jax.lax.scan(lambda c, _: (c @ x, None), x, None, length=10)[0]

    a = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    ref_one = jflops.analyze_hlo(jax.jit(lambda x: x @ x).lower(a).compile().as_text()).flops
    ref_ten = jflops.analyze_hlo(jax.jit(jscanned).lower(a).compile().as_text()).flops
    # the reference's bar (2%): its loop counter's adds and compares count too
    assert abs(ref_one - want) / want < 0.02 and abs(ref_ten - 10 * want) / (10 * want) < 0.02
    for device in ("cpu", "meta"):
        x = torch.ones(256, 256, device=device)
        _, one = analyze(lambda: x @ x)
        _, ten = analyze(scanned, x)
        assert (one.flops, one.by_op, one.calls) == (want, {"dot": want}, {"mm": 1})
        assert (ten.flops, ten.calls) == (10 * want, {"mm": 10})
        assert one.hbm_bytes == 3 * 256 * 256 * 4  # two operands read, the result written
        assert one.devices == (device,)


def _ref_dot_flops(text: str) -> float:
    """The reference's dot FLOPs of a compiled module, each loop body's
    times its trip count (its ``by_op`` adds each body once)."""
    comps = jflops._parse_module(text)
    entry = [n for n in comps if n.startswith("main")][-1]
    memo: dict[str, float] = {}

    def walk(name):
        if name not in memo:
            total = 0.0
            comp = comps.get(name)
            for ins in comp.instrs if comp else ():
                if ins.op == "dot":
                    total += jflops._dot_flops(comp, ins)
                elif ins.op == "while":
                    mb, mc = jflops._BODY.search(ins.tail), jflops._COND.search(ins.tail)
                    total += jflops._while_trips(comps, ins, mc) * (walk(mb.group(1))
                                                                    + walk(mc.group(1)))
                elif ins.op in ("fusion", "call"):
                    m = jflops._CALLS.search(ins.tail)
                    total += walk(m.group(1)) if m else 0.0
            memo[name] = total
        return memo[name]

    return walk(entry)


def _ref_text(cfg, kind: str) -> str:
    api = jmodels.build(cfg)
    state = jax.eval_shape(lambda: jstep.init_train_state(cfg, api, jax.random.key(0))[0])
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    batch = {"tokens": tok}
    if cfg.is_encdec:
        batch["enc_input"] = jax.ShapeDtypeStruct((B, cfg.enc_frames, cfg.d_model), jnp.float32)
    if kind == "train":
        fn, args = jstep.make_train_step(cfg, api), (state, {**batch, "targets": tok})
    elif kind == "prefill":
        fn, args = jstep.make_serve_steps(cfg, api)[0], (state.params, batch)
    else:
        fn = jstep.make_serve_steps(cfg, api)[1]
        args = (state.params, jax.eval_shape(lambda: api.init_decode_cache(B, S)),
                jax.ShapeDtypeStruct((B, 1), jnp.int32), jax.ShapeDtypeStruct((), jnp.int32))
    return jax.jit(fn).lower(*args).compile().as_text()


def _port_cost(cfg, kind: str):
    api = build(cfg)
    tok = torch.zeros((B, S), dtype=torch.int32, device="meta")
    batch = {"tokens": tok}
    if cfg.is_encdec:
        batch["enc_input"] = torch.zeros((B, cfg.enc_frames, cfg.d_model), device="meta")
    if kind == "train":
        state = init_train_state(cfg, api, torch.Generator(), "meta")
        n_params = sum(p.numel() for p in state.params.parameters())
        return analyze(make_train_step(cfg, api), state, {**batch, "targets": tok})[1], n_params
    params = api.init(torch.Generator(), "meta")
    prefill, decode = make_serve_steps(cfg, api)
    with torch.no_grad():
        if kind == "prefill":
            return analyze(prefill, params, batch)[1], 0
        caches = api.init_decode_cache(B, S, device="meta")
        tokens = torch.zeros((B, 1), dtype=torch.int32, device="meta")
        return analyze(decode, params, caches, tokens, S - 1)[1], 0


@pytest.mark.parametrize("arch, kind", [("qwen3-4b", "train"), ("qwen3-4b", "prefill"),
                                        ("qwen3-4b", "decode"), ("whisper-tiny", "prefill")])
def test_dot_flops_match_the_references_hlo(arch, kind):
    """The counter's matrix-product FLOPs of a reduced model's call on meta
    tensors against the reference walker's on its compiled HLO (the bar and
    the one explained term are in the module's doc)."""
    text = _ref_text(jconfigs.get_arch(arch).reduced(), kind)
    want = _ref_dot_flops(text)
    cost, n_params = _port_cost(configs.get_arch(arch).reduced(), kind)
    assert cost.by_op["dot"] - 2 * n_params == want
    assert "flash_attention" not in cost.by_op and cost.devices == ("meta",)
    # the reference's by_op counts each loop body once: below its trip-counted dots
    assert jflops.analyze_hlo(text).by_op["dot"] < want


def test_collective_stats_of_hlo_text():
    """The reference test's hand-written HLO: an async pair counts once, at
    its start; the port's stats of it are the reference's."""
    fake = """
  %ag = f32[16,1024]{1,0} all-gather(%x), replica_groups=...
  %ar.1 = bf16[8,8]{1,0} all-reduce-start(%y), to_apply=%add
  %ar.2 = bf16[8,8]{1,0} all-reduce-done(%ar.1)
"""
    got = hlo.collective_stats(fake)
    assert got == jhlo.collective_stats(fake)
    assert got["all-gather"] == {"count": 1, "bytes": 16 * 1024 * 4}
    assert got["all-reduce"]["count"] == 1 and got["total"]["count"] == 2
    assert hlo.count_ops(fake, "all-gather") == jhlo.count_ops(fake, "all-gather") == 1
    assert hlo.shape_bytes("bf16[8,128]") == jhlo.shape_bytes("bf16[8,128]") == 8 * 128 * 2
    assert hlo.shape_bytes("f32[2,2]{1,0} pred[4]") == 16 + 4
    assert hlo.shape_literal(torch.empty(16, 1024, dtype=torch.bfloat16)) == "bf16[16,1024]"


def test_collective_stats_match_the_reference_on_sharded_products(ref_collectives):
    """Per kind, the count and bytes of one rank's collectives: the port's
    records of DTensor products on a fake group of 4 against the
    reference's stats of the compiled products on 4 CPU devices."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
        x, w = torch.empty(8, 16, device="meta"), torch.empty(16, 12, device="meta")
        cases = {"contraction": ([Shard(1)], [Shard(0)], [Replicate()], "all-reduce"),
                 "gathered": ([Shard(0)], [Shard(0)], [Shard(0)], "all-gather")}
        got = {}
        for name, (px, pw, pout, kind) in cases.items():
            a = distribute_tensor(x, mesh, px, src_data_rank=None)
            b = distribute_tensor(w, mesh, pw, src_data_rank=None)
            with CostCounter() as counter:
                (a @ b).redistribute(mesh, pout)
            got[name] = hlo.collective_stats(counter.cost().collectives)
            assert hlo.count_ops(counter.cost().collectives, kind) == 1
    finally:
        dist.destroy_process_group()
    out, err = ref_collectives.communicate(timeout=REF_TIMEOUT_S)
    assert ref_collectives.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    assert got == want
    assert want["contraction"]["all-reduce"] == {"count": 1, "bytes": 8 * 12 * 4}
    assert want["gathered"]["all-gather"] == {"count": 1, "bytes": 16 * 12 * 4}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_custom_op(causal):
    """The custom ops' fake implementations give the kernel's shapes and
    dtypes on meta tensors; ``opcheck`` passes; on the CPU each returns the
    plain version's bits; the counter sees one op and counts the kernel's
    FLOPs (4 B H dh per visible pair: 4 B H dh Sq (Sq + 1) / 2 causal at
    Sq = Sk, row 10's count)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    for op in (torch.ops.repro_torch.flash_attention.default,
               torch.ops.repro_torch.flash_attention_lse.default):
        torch.library.opcheck(op, (q, k, v, causal))
    out = flash_attention(q, k, v, causal=causal)
    assert torch.equal(out, attention_ref(q, k, v, causal=causal))
    out2, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want, want_lse = attention_ref(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out2, want) and torch.equal(lse, want_lse)
    qm, km = q.to("meta"), k.to("meta")
    (om, lm), cost = analyze(lambda: flash_attention(qm, km, km, causal=causal, return_lse=True))
    assert (om.shape, om.dtype, lm.shape, lm.dtype) == (q.shape, q.dtype, (2, 4, 64), torch.float32)
    pairs = 64 * 65 // 2 if causal else 64 * 64
    assert cost.by_op == {"flash_attention": 4 * 2 * 4 * 32 * pairs}
    assert cost.calls == {"flash_attention_lse": 1}
    row10 = 4 * 4 * 32 * 128 * 2048 * 2049 // 2  # PERF.md row 10's count
    assert flash_flops((4, 2048, 32, 128), (4, 2048, 8, 128), True) == row10
    assert flash_flops((1, 8, 1, 32), (1, 4, 1, 32), True) == 4 * 32 * (4 * 5 // 2)  # Sq > Sk
