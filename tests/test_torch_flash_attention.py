"""Parity of the port's attention (``repro_torch.kernels.flash_attention``)
with the reference, on the CPU.

On the CPU the port's ``flash_attention(impl="auto")`` runs its plain
version; on the same numpy inputs it is held against

* the reference's oracle ``attention_ref``, in every case;
* the reference's Pallas kernel in interpret mode
  (``flash_attention(impl="pallas_interpret")``), where T == S;
* the reference's ``chunked_attention``, where T < S.  Not the Pallas
  kernel: it places query row r of block i at key position i·bq + r and so
  ignores the S − T offset that ``attention_ref`` and ``chunked_attention``
  apply (the port follows those two).

``decode_attention`` is held against the reference's, with a scalar and a
(B,) ``cur_len``.

Tolerances (shared with ``test_torch_gpu.py``, which holds the CUDA kernel
against the same plain version on the card):

* f32 inputs: rtol 1e-5, atol 1e-5 — both sides compute in f32 and differ
  only in summation order.
* bf16 inputs: rtol 2⁻⁷, atol 1e-3 — both sides sum the exact products of
  the bf16 inputs in f32, in other orders, and round the output to bf16, so
  they may differ by one bf16 ulp.  The decode path rounds p to bf16 on
  both sides before its second product (as the reference's einsum does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.flash_attention import ref as j_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from tests.test_torch_gpu import FLASH_CASES, FLASH_TOL, _check_flash, _flash_inputs

DTYPES = [pytest.param(torch.float32, id="f32"), pytest.param(torch.bfloat16, id="bf16")]
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _both(arrays, dtype):
    """The same numpy arrays as torch tensors and jnp arrays of ``dtype``."""
    tt = [torch.from_numpy(a).to(dtype) for a in arrays]
    jj = [jnp.asarray(a).astype(_JNP[dtype]) for a in arrays]
    return tt, jj


def _to_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,S,H,KV,dh", FLASH_CASES)
def test_flash_plain_matches_jax_attention_ref(B, T, S, H, KV, dh, dtype):
    (q, k, v), (jq, jk, jv) = _both(_flash_inputs(B, T, S, H, KV, dh, seed=T * 31 + KV * 7 + dh), dtype)
    got = fa_ops.flash_attention(q, k, v)
    want = j_ref.attention_ref(jq, jk, jv, causal=True)
    _check_flash(got, _to_torch(want).to(dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,S,H,KV,dh", [c for c in FLASH_CASES if c.values[1] == c.values[2]])
def test_flash_plain_matches_jax_pallas_interpret(B, T, S, H, KV, dh, dtype):
    (q, k, v), (jq, jk, jv) = _both(_flash_inputs(B, T, S, H, KV, dh, seed=T * 13 + KV + dh), dtype)
    got = fa_ops.flash_attention(q, k, v)
    want = j_fa.flash_attention(jq, jk, jv, causal=True, impl="pallas_interpret")
    _check_flash(got, _to_torch(want).to(dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,S,H,KV,dh", [c for c in FLASH_CASES if c.values[1] < c.values[2]])
def test_flash_plain_matches_jax_chunked_when_T_below_S(B, T, S, H, KV, dh, dtype):
    (q, k, v), (jq, jk, jv) = _both(_flash_inputs(B, T, S, H, KV, dh, seed=S * 5 + KV + dh), dtype)
    got = fa_ops.flash_attention(q, k, v)
    want = j_fa.chunked_attention(jq, jk, jv, causal=True)
    _check_flash(got, _to_torch(want).to(dtype), dtype)
    # The last query row sees every key: its output differs from row 0's.
    assert not torch.allclose(got[:, -1].float(), got[:, 0].float())


def test_flash_impls_and_refusals():
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(1, 8, 8, 4, 2, 16, seed=0))
    assert dispatch.impl_names("flash_attention") == ("cuda", "torch_chunked", "torch_ref")
    before = dispatch.launch_counts()["flash_attention"]
    fa_ops.flash_attention(q, k, v)  # the plain version on the CPU: no launch
    windowed = fa_ops.flash_attention(q, k, v, window=4)  # the chunked attention, on every device
    assert dispatch.launch_counts()["flash_attention"] == before
    torch.testing.assert_close(windowed, fa_ops.chunked_attention(q, k, v, window=4), rtol=0, atol=0)
    assert not torch.allclose(windowed, fa_ops.flash_attention(q, k, v))  # the window binds at T = 8
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa_ops.flash_attention(q, k, v, impl="cuda")
    for impl in ("cuda", "torch_ref"):  # neither has a window: refused, never rerouted
        with pytest.raises(ValueError, match="has no sliding window"):
            fa_ops.flash_attention(q, k, v, window=4, impl=impl)
    with pytest.raises(ValueError, match="do not match"):
        fa_ops.flash_attention(q[..., :3, :], k, v)
    with pytest.raises(ValueError, match="one CUDA device"):  # the wrapper never falls back
        fa_kernel.flash_attention_cuda(q, k, v, causal=True, scale=0.25)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-cur_len", "per-row-cur_len"])
def test_decode_attention_matches_jax(dtype, per_row):
    B, S, H, KV, dh = 3, 24, 8, 2, 64
    rng = np.random.default_rng(5 + per_row)
    arrays = [
        rng.normal(size=(B, 1, H, dh)).astype(np.float32),
        rng.normal(size=(B, S, KV, dh)).astype(np.float32),
        rng.normal(size=(B, S, KV, dh)).astype(np.float32),
    ]
    (q, kc, vc), (jq, jk, jv) = _both(arrays, dtype)
    cur = np.array([5, 17, 24], np.int32) if per_row else np.int32(11)
    got = fa_ops.decode_attention(q, kc, vc, torch.from_numpy(np.asarray(cur)))
    want = j_fa.decode_attention(jq, jk, jv, jnp.asarray(cur))
    assert got.dtype == dtype and got.shape == (B, 1, H, dh)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), _to_torch(want), **tol)


def test_reference_pallas_kernel_ignores_the_offset_when_T_below_S():
    """The fault that makes ``chunked_attention`` the T < S oracle above:
    the reference's Pallas kernel places query row t at key position t, not
    t + S − T (its ``kv_len`` is unused), while ``attention_ref`` and
    ``chunked_attention`` agree.  At T == S all three agree."""
    q, k, v = (jnp.asarray(a) for a in _flash_inputs(1, 16, 32, 4, 2, 16, seed=0))
    ref = j_ref.attention_ref(q, k, v)
    pallas_gap = float(jnp.abs(j_fa.flash_attention(q, k, v, impl="pallas_interpret") - ref).max())
    chunked_gap = float(jnp.abs(j_fa.chunked_attention(q, k, v) - ref).max())
    assert pallas_gap > 1.0 and chunked_gap < 1e-6, (pallas_gap, chunked_gap)
    q, k, v = (jnp.asarray(a) for a in _flash_inputs(1, 32, 32, 4, 2, 16, seed=0))
    assert float(jnp.abs(j_fa.flash_attention(q, k, v, impl="pallas_interpret")
                         - j_ref.attention_ref(q, k, v)).max()) < 1e-6
