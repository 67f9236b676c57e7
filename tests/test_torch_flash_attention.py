"""The port's flash attention (its plain version, which ``ops`` runs for a
CPU tensor) against the reference's Pallas kernel in interpret mode and its
``attention_ref``, on the sweep of ``tests/test_kernels.py`` and at the
reference's own tolerances (2e-3 in float32, 3e-2 in bfloat16), plus causal
rows that see no key (Sq > Sk), which return the mean of V in all three,
at every head dim the port builds (32, 64, 128 and 160).
The CUDA kernel itself is held to this plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 8).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, Sq, Sk, H, KV, dh):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(B, Sq, H, dh)).astype(np.float32),
        rng.normal(size=(B, Sk, KV, dh)).astype(np.float32),
        rng.normal(size=(B, Sk, KV, dh)).astype(np.float32),
    )


def _both(arrays, dtype):
    """The same values as jax and torch arrays of ``dtype``."""
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    tx = [torch.as_tensor(a).to(TORCH[dtype]) for a in arrays]
    return jx, tx


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize(
    "B,Sq,Sk,H,KV,dh",
    [
        (1, 128, 128, 2, 2, 64),
        (2, 256, 256, 4, 2, 64),  # GQA
        (1, 128, 256, 2, 1, 128),  # Sq < Sk + MQA
        (1, 128, 64, 4, 2, 64),  # Sq > Sk: causal rows 0..63 see no key
        (1, 128, 128, 2, 1, 160),  # stablelm-12b's head dim, MQA
        (1, 128, 64, 4, 2, 160),  # head dim 160, Sq > Sk
        (1, 128, 192, 4, 2, 32),  # the reduced configs' head dim, Sq < Sk
    ],
)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_the_reference(B, Sq, Sk, H, KV, dh, causal, dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(B * Sq + H + Sk, B, Sq, Sk, H, KV, dh), dtype)
    reset_launch_counts()
    got = _f32(flash_attention(q, k, v, causal=causal))
    counts = launch_counts()  # the CPU runs the plain version: no kernel variant launched
    assert [counts[f"flash_attention_{kind}"] for kind in ("wgmma", "mma", "f32")] == [0, 0, 0]
    tol = TOL[dtype]
    pallas = _f32(pallas_flash(jq, jk, jv, causal=causal, bq=64, bk=64))
    ref = _f32(jax_attention_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_that_see_no_key_return_the_mean_of_v(dtype):
    B, Sq, Sk, H, KV, dh = 2, 128, 64, 4, 2, 64
    arrays = _inputs(7, B, Sq, Sk, H, KV, dh)
    (jq, jk, jv), (q, k, v) = _both(arrays, dtype)
    got = _f32(flash_attention(q, k, v, causal=True))
    v32 = _f32(v)
    mean_v = np.repeat(v32.mean(axis=1), H // KV, axis=1)  # [B, H, dh]
    tol = TOL[dtype]
    blind = Sq - Sk  # causal row i sees keys j <= i + Sk - Sq
    np.testing.assert_allclose(
        got[:, :blind], np.broadcast_to(mean_v[:, None], got[:, :blind].shape), rtol=tol, atol=tol
    )
    pallas = _f32(pallas_flash(jq, jk, jv, causal=True, bq=64, bk=64))
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


def test_plain_version_is_exact_where_only_the_order_differs():
    """Float32 on the same values: the port's plain version and the
    reference's agree far inside the flash tolerance (only summation
    order and the softmax implementation differ)."""
    arrays = _inputs(3, 2, 96, 160, 4, 2, 32)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    got = attention_ref(q, k, v, causal=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_attention_ref(jq, jk, jv)), rtol=0, atol=2e-6)


def _variant_inputs(case):
    """(q, k, v) on the CPU for one layout the wrapper must classify."""
    bf16 = torch.bfloat16
    B, S, H, KV = 2, 48, 8, 2

    def qkv(dh, dtype=bf16):
        return (
            torch.zeros(B, S, H, dh, dtype=dtype),
            torch.zeros(B, S, KV, dh, dtype=dtype),
            torch.zeros(B, S, KV, dh, dtype=dtype),
        )

    if case == "packed projection":  # views of one [B, S, H + 2 KV, dh] tensor
        packed = torch.zeros(B, S, H + 2 * KV, 128, dtype=bf16)
        return packed[:, :, :H], packed[:, :, H : H + KV], packed[:, :, H + KV :]
    if case == "one batch of a larger tensor":
        return tuple(t[1:] for t in qkv(128))
    if case == "unaligned sequence stride":  # 65 columns: 130-byte rows
        q, k, v = qkv(65)
        return q[..., :64], k[..., :64], v[..., :64]
    if case == "unaligned base":
        flat = torch.zeros(B * S * H * 64 + 1, dtype=bf16)
        q = flat[1:].view(B, S, H, 64)
        return q, q[:, :, :KV], q[:, :, :KV]
    if case == "strided head dim":
        q, k, v = qkv(128)
        return q[..., ::2], k[..., ::2], v[..., ::2]
    if case == "heads outside sequence":  # [B, H, S, dh] seen as [B, S, H, dh]
        return tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in qkv(128))
    if case == "no keys":
        q, k, v = qkv(128)
        return q, k[:, :0], v[:, :0]
    dtype, dh = case
    return qkv(dh, dtype)


@pytest.mark.parametrize(
    "case,want",
    [
        ((torch.bfloat16, 128), "wgmma"),
        ((torch.bfloat16, 64), "wgmma"),
        ((torch.bfloat16, 32), "wgmma"),
        ((torch.bfloat16, 160), "wgmma"),
        ((torch.float32, 128), "f32"),
        ((torch.float32, 64), "f32"),
        ((torch.float32, 160), "f32"),
        ((torch.float32, 32), "f32"),
        ("packed projection", "wgmma"),
        ("one batch of a larger tensor", "wgmma"),
        ("unaligned sequence stride", "mma"),
        ("unaligned base", "mma"),
        ("strided head dim", "mma"),
        ("heads outside sequence", "mma"),
        ("no keys", "mma"),
    ],
)
def test_kernel_variant_is_chosen_from_dtype_head_dim_and_strides(case, want):
    """The wrapper picks the Hopper kernel (TMA + wgmma) for bfloat16 at
    every built head dim (32, 64, 128, 160) whose q, k and v tensor maps can
    read in place (head dim contiguous, 16-byte strides and base, dimensions
    nested as (head, sequence, batch)); other bfloat16 inputs go to the
    mma.sync kernel and float32 to the float32 one.  Decided from the inputs
    alone, with no card and no launch."""
    from repro_torch.kernels.flash_attention import kernel as fk

    assert fk.variant(*_variant_inputs(case)) == want
