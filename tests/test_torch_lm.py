"""The port's serving path (configs, models, serve steps, launcher) against
the reference on ``reduced()`` configs in float32 (qwen3-4b, chatglm3-6b,
and stablelm-12b at its own head dim 160), with the reference's weights
carried across by ``convert.lm_params_from_numpy``.

Bars: norms and rotary 1e-6; ``lm_prefill`` logits and KV caches 2e-5 on
both attention branches (S = 32 <= attn_chunk = 64: plain; S = 192: the
blocked branch, through the flash kernel's plain version with
``flash_vjp=True`` and the plain blocked scan without), about 5x the
reference's own gap between its blocked and plain paths (3.7e-6 on logits
of scale 2.9); greedy decode tokens equal.
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
from repro.launch import serve as jserve  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common, mlp  # noqa: E402

TOL = 2e-5


# stablelm-12b reduced, but at its own head dim 160 (the reduced configs
# take 32): the width the Hopper flash kernel's 64-byte swizzle path serves
STABLELM_DH160 = "stablelm-12b-dh160"


def _reduced(package, name):
    if name == STABLELM_DH160:
        return dataclasses.replace(package.get_arch("stablelm-12b").reduced(), d_head=160)
    return package.get_arch(name).reduced()


@pytest.fixture(scope="module", params=["qwen3-4b", "chatglm3-6b", STABLELM_DH160])
def carried(request):
    """(reference cfg, port cfg, reference params, port params): the
    reference's ``init_lm`` weights (key 0) in both packages."""
    cfg_j = _reduced(jconfigs, request.param)
    cfg = _reduced(configs, request.param)
    params_j, _ = jmodels.build(cfg_j).init(jax.random.key(0))
    return cfg_j, cfg, params_j, lm_params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def test_reduced_configs_match_the_reference():
    for name in configs.list_archs():
        a, b = jconfigs.get_arch(name).reduced(), configs.get_arch(name).reduced()
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if f.name.endswith("dtype"):
                assert str(va.dtype if hasattr(va, "dtype") else np.dtype(va)) == str(vb).split(".")[-1]
            else:
                assert va == vb, (name, f.name)
        assert (a.head_dim, a.unit_size, a.n_units) == (b.head_dim, b.unit_size, b.n_units)


@pytest.mark.parametrize("rope_frac", [1.0, 0.5])
def test_rms_norm_and_rope_match(rope_frac):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 17, 4, 32)).astype(np.float32)
    g = rng.normal(size=32).astype(np.float32)
    pos = np.tile(np.arange(17) + 5, (2, 1))
    np.testing.assert_allclose(
        common.rms_norm(torch.as_tensor(x), torch.as_tensor(g)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        rtol=0, atol=1e-6,
    )
    inv_j, rot_j = jcommon.rope_freqs(32, rope_frac, 1e6)
    inv, rot = common.rope_freqs(32, rope_frac, 1e6)
    assert rot == rot_j
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        common.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), inv, rot).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), inv_j, rot_j)),
        rtol=0, atol=1e-6,
    )


@pytest.mark.parametrize("mlp_kind", ["swiglu", "gelu"])
def test_mlp_matches(mlp_kind):
    cfg = dataclasses.replace(configs.get_arch("qwen3-4b").reduced(), mlp_kind=mlp_kind)
    cfg_j = dataclasses.replace(jconfigs.get_arch("qwen3-4b").reduced(), mlp_kind=mlp_kind)
    p_j, _ = jmlp.init_mlp(jax.random.key(4), cfg_j)
    p = {k: torch.as_tensor(np.array(v)) for k, v in p_j.items()}
    x = np.random.default_rng(2).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        mlp.mlp_apply(p, cfg, torch.as_tensor(x)).numpy(),
        np.asarray(jmlp.mlp_apply(p_j, cfg_j, jnp.asarray(x))),
        rtol=0, atol=TOL,
    )


@pytest.mark.parametrize("flash_vjp", [True, False])
@pytest.mark.parametrize("S", [32, 192])
def test_prefill_logits_and_caches_match(carried, S, flash_vjp):
    cfg_j, cfg, params_j, params = carried
    cfg_j = dataclasses.replace(cfg_j, flash_vjp=flash_vjp)
    cfg = dataclasses.replace(cfg, flash_vjp=flash_vjp)
    assert (S > cfg.attn_chunk) == (S == 192)
    toks = _tokens(cfg, 2, S)
    prefill_j = jmodels.build(cfg_j).prefill
    if cfg.head_dim == 160:
        # Under jax.jit, XLA folds one rotary inverse frequency of head dim
        # 160 (theta 1e4) one ulp off the value the reference computes
        # eagerly, which moves the reference's own layer-0 K cache by up to
        # 3.8e-5 at positions up to 191 (jit vs eager on the CPU), more than
        # TOL.  The port computes the frequencies as the eager reference does,
        # so it is held to the reference run without jit.
        with jax.disable_jit():
            logits_j, caches_j = prefill_j(params_j, jnp.asarray(toks, jnp.int32))
    else:
        logits_j, caches_j = jax.jit(prefill_j)(params_j, jnp.asarray(toks, jnp.int32))
    logits, caches = models.build(cfg).prefill(params, torch.as_tensor(toks))
    assert logits.shape == (2, 1, cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=0, atol=TOL)
    assert len(caches) == cfg.n_layers
    for layer, cache in enumerate(caches):
        k_j, v_j = caches_j["b0"]  # unit size 1: unit u is layer u
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(k_j[layer]), rtol=0, atol=TOL)
        np.testing.assert_allclose(cache.v.numpy(), np.asarray(v_j[layer]), rtol=0, atol=TOL)


def test_greedy_decode_matches(carried):
    """8 prompt tokens decoded one by one, then 8 greedy tokens: the same
    tokens, logits within the bar at every step."""
    cfg_j, cfg, params_j, params = carried
    B, P, G = 2, 8, 8
    prompt = _tokens(cfg, B, P, seed=3)
    api_j, api = jmodels.build(cfg_j), models.build(cfg)
    step_j = jax.jit(api_j.decode_step)
    caches_j = api_j.init_decode_cache(B, P + G)
    caches = api.init_decode_cache(B, P + G, "cpu")
    tok_j, tok = jnp.asarray(prompt[:, :1], jnp.int32), torch.as_tensor(prompt[:, :1])
    got, want = [], []
    for i in range(P + G - 1):
        logits_j, caches_j = step_j(params_j, caches_j, tok_j, jnp.asarray(i, jnp.int32))
        logits, caches = api.decode_step(params, caches, tok, i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=0, atol=TOL)
        if i + 1 < P:
            tok_j, tok = jnp.asarray(prompt[:, i + 1 : i + 2], jnp.int32), torch.as_tensor(prompt[:, i + 1 : i + 2])
        else:
            tok_j, tok = jnp.argmax(logits_j, -1).astype(jnp.int32), torch.argmax(logits, -1)
            want.append(np.asarray(tok_j)[:, 0])
            got.append(tok.numpy()[:, 0])
    assert len(got) == G
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))


def test_decode_matches_prefill_consistency():
    """The reference's own consistency test on the port: decoding a prefix
    token by token gives the prefill's last-position logits."""
    cfg = configs.get_arch("qwen3-4b").reduced()
    api = models.build(cfg)
    params = api.init(torch.Generator().manual_seed(3), "cpu")
    toks = torch.as_tensor(_tokens(cfg, 1, 8))
    full, _ = api.prefill(params, toks)
    caches = api.init_decode_cache(1, 8, "cpu")
    for i in range(8):
        logits, caches = api.decode_step(params, caches, toks[:, i : i + 1], i)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2, atol=2e-2)


def bf16_decode_vs_prefill(S=192) -> dict:
    """Relative Frobenius gap and share of logits outside rtol = atol = 2e-2
    between token-by-token decode and prefill, reduced qwen3-4b in bf16
    compute, S > attn_chunk, on the reference and on the port (same weights)."""
    cfg_j = dataclasses.replace(jconfigs.get_arch("qwen3-4b").reduced(), compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(configs.get_arch("qwen3-4b").reduced(), compute_dtype=torch.bfloat16)
    api_j, api = jmodels.build(cfg_j), models.build(cfg)
    params_j, _ = api_j.init(jax.random.key(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    toks = _tokens(cfg, 1, S, seed=2)
    full_j, _ = jax.jit(api_j.prefill)(params_j, jnp.asarray(toks, jnp.int32))
    full, _ = api.prefill(params, torch.as_tensor(toks))
    step_j = jax.jit(api_j.decode_step)
    caches_j, caches = api_j.init_decode_cache(1, S), api.init_decode_cache(1, S, "cpu")
    for i in range(S):
        last_j, caches_j = step_j(params_j, caches_j, jnp.asarray(toks[:, i : i + 1], jnp.int32),
                                  jnp.asarray(i, jnp.int32))
        last, caches = api.decode_step(params, caches, torch.as_tensor(toks[:, i : i + 1]), i)
    out = {}
    for name, a, b in (("reference", np.asarray(last_j, np.float32), np.asarray(full_j, np.float32)),
                       ("port", last.numpy(), full.numpy())):
        d = np.abs(a - b)
        out[name] = {"max_abs": float(d.max()),
                     "rel": float(np.linalg.norm(a - b) / np.linalg.norm(b)),
                     "outside_2e-2": float(np.mean(d > 2e-2 + 2e-2 * np.abs(b)))}
    return out


def test_bf16_decode_vs_prefill_gap_is_the_references():
    """In bf16 compute decode and prefill differ by bf16 rounding (decode
    rounds its logits and weights to bf16): the reference's own gap misses
    its float32 bar rtol = atol = 2e-2, so the port is held to 2^-5 in
    relative Frobenius norm, the bar chip_smoke.py phase 8 holds on the card."""
    gaps = bf16_decode_vs_prefill()
    assert gaps["port"]["rel"] <= 2.0**-5
    assert gaps["reference"]["rel"] <= 2.0**-5


def test_launcher_returns_the_reference_tokens(capsys, monkeypatch):
    argv = ["--reduced", "--requests", "3", "--prompt-len", "12", "--gen", "6", "--cap", "450"]
    # the port's own weights (torch.Generator seed 0): the report and the shape
    assert serve.main(argv + ["--device", "cpu"]).shape == (3, 6)
    out = capsys.readouterr().out
    assert "device=cpu" in out and "capped at 450 W" in out
    # the reference's weights (jax.random.key(0), as its launcher draws them)
    # served by the port's launcher: the reference launcher's greedy tokens
    want = jserve.main(argv)
    cfg = configs.get_arch("qwen3-4b").reduced()
    params_j, _ = jmodels.build(jconfigs.get_arch("qwen3-4b").reduced()).init(jax.random.key(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    build = serve.build
    monkeypatch.setattr(
        serve, "build", lambda c: build(c)._replace(init=lambda generator, device=None: params)
    )
    np.testing.assert_array_equal(serve.main(argv + ["--device", "cpu"]), want)


@pytest.mark.parametrize(
    "arch", ["whisper-tiny", "olmoe-1b-7b", "mamba2-1.3b", "jamba-v0.1-52b", "grok-1-314b"]
)
def test_unported_families_raise(arch):
    """Every family builds, serves and now trains: the training loss, which
    raised until the training slice (tests/test_torch_train.py holds it to
    the reference), gives a finite float32 loss and a gradient of every
    weight on the family's own seeded weights."""
    cfg = configs.get_arch(arch).reduced()
    api = models.build(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    assert len(params["dec" if cfg.is_encdec else "layers"]) == cfg.n_layers
    params.requires_grad_(True)
    rng = np.random.default_rng(0)
    toks, targets = (torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16))) for _ in range(2))
    extra = ([torch.as_tensor(rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32))]
             if cfg.is_encdec else [])
    loss, metrics = api.loss(params, toks, targets, *extra)
    loss.backward()
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert float(metrics["xent"]) > 0
    assert all(p.grad is not None for p in params.parameters())


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])


def dh160_layer0_k_gaps(S=192) -> dict:
    """Largest |d| of layer 0's K cache, reduced stablelm-12b at head dim
    160 in float32 on the CPU: the reference under jax.jit against the
    reference run eagerly, and the port against the eager run."""
    cfg_j, cfg = _reduced(jconfigs, STABLELM_DH160), _reduced(configs, STABLELM_DH160)
    params_j, _ = jmodels.build(cfg_j).init(jax.random.key(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    toks = _tokens(cfg, 2, S)
    prefill_j = jmodels.build(cfg_j).prefill
    _, jitted = jax.jit(prefill_j)(params_j, jnp.asarray(toks, jnp.int32))
    with jax.disable_jit():
        _, eager = prefill_j(params_j, jnp.asarray(toks, jnp.int32))
    _, caches = models.build(cfg).prefill(params, torch.as_tensor(toks))
    k_jit, k_eager = (np.asarray(c["b0"][0][0]) for c in (jitted, eager))
    return {"reference jit vs eager": float(np.abs(k_jit - k_eager).max()),
            "port vs eager reference": float(np.abs(caches[0].k.numpy() - k_eager).max())}


if __name__ == "__main__":
    # the numbers PERF.md quotes for bf16 decode vs prefill (CPU, both packages)
    for who, row in bf16_decode_vs_prefill().items():
        print(who, row)
    # and for the reference's own jit-vs-eager gap at head dim 160
    print("stablelm-12b reduced, head dim 160, layer 0 K cache", dh160_layer0_k_gaps())
