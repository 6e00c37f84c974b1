"""DeepSeek-V2's blocks in the port (``models.mla``, the held share and the
per-sequence balance loss of ``models.moe``, ``mla_mlp``/``mla_moe``)
against the benchmark's plain reference, ``perfbench/configs/
deepseek-v2-lite-ep8.py``, loaded by path, on seeded weights at small
sizes, in float32 (the reference package has no latent attention to hold
the port to).  Also the attention route for v heads narrower than the q/k
heads (192 / 128) against autograd of the plain attention."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs import deepseek_v2_lite
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

REF_PATH = Path(__file__).resolve().parents[1] / "perfbench" / "configs" / "deepseek-v2-lite-ep8.py"


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("deepseek_v2_lite_ep8_reference", REF_PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_cfg(**moe):
    cfg = deepseek_v2_lite.smoke_config()
    return dataclasses.replace(cfg, compute_dtype="float32", moe=dataclasses.replace(cfg.moe, **moe))


def ref_cfg(pc) -> dict:
    """The reference's keys of the port's configuration ``pc``."""
    m, a = pc.moe, pc.mla
    return {"hidden_size": pc.d_model, "vocab_size": pc.vocab, "num_attention_heads": pc.n_heads,
            "qk_nope_head_dim": a.qk_nope_head_dim, "qk_rope_head_dim": a.qk_rope_head_dim,
            "v_head_dim": a.v_head_dim, "kv_lora_rank": a.kv_lora_rank, "intermediate_size": pc.d_ff,
            "moe_intermediate_size": m.d_expert, "n_shared_experts": m.num_shared,
            "experts_held": list(M.held(m)), "published": {"n_routed_experts": m.num_experts},
            "init": {"embed_std": 0.02}, "num_hidden_layers": pc.n_layers, "first_k_dense_replace": len(pc.lead),
            "rms_norm_eps": pc.rms_eps, "rope_theta": pc.rope_theta,
            "rope_scaling": {"factor": a.rope_factor, "original_max_position_embeddings": a.rope_original_max,
                             "beta_fast": a.rope_beta_fast, "beta_slow": a.rope_beta_slow, "mscale": a.rope_mscale,
                             "mscale_all_dim": a.rope_mscale_all_dim},
            "num_experts_per_tok": m.top_k, "capacity_factor": m.capacity_factor,
            "aux_loss_alpha": m.router_aux_weight}


_PORT = {"wq": "attn.wq", "wkv_a": "attn.wkv_a", "kv_norm": "attn.kv_norm", "wkv_b": "attn.wkv_b", "wo": "attn.wo",
         "gate": "mlp.gate", "up": "mlp.up", "down": "mlp.down", "router": "moe.router", "w_gate": "moe.w_gate",
         "w_up": "moe.w_up", "w_down": "moe.w_down", "shared_gate": "moe.shared.gate",
         "shared_up": "moe.shared.up", "shared_down": "moe.shared.down"}


def port_name(name: str) -> str:
    if name == "head":
        return "lm_head"
    if not name.startswith("layers."):
        return name
    _, i, key = name.split(".", 2)
    return f"blocks.{i}.{_PORT[key] if key in _PORT else key}"


def model_and_weights(ref, pc, seed=0):
    w = ref.make_weights(ref_cfg(pc), seed, torch.device("cpu"))
    model = T.model_from_state_dict(pc, {port_name(k): v.clone() for k, v in w.items()})
    return model, w


# ------------------------------------------------------------------ rope


def test_yarn_frequencies_and_scale_are_the_closed_form(ref):
    """DeepSeek-V2's published YaRN settings: the 32 frequencies of a 64-wide
    rope part over θ = 10⁴, factor 40 over 4096 positions, β 32 and 1; and
    the softmax scale 192^−½ · (0.1·0.707·ln 40 + 1)²."""
    dim, theta, factor = 64, 1e4, 40.0
    corr = [dim * math.log(4096 / (r * 2 * math.pi)) / (2 * math.log(theta)) for r in (32.0, 1.0)]
    low, high = max(math.floor(corr[0]), 0), min(math.ceil(corr[1]), dim - 1)
    assert (low, high) == (10, 23)
    want = []
    for i in range(dim // 2):
        base = theta ** (-2.0 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(base * (1.0 - ramp) + base / factor * ramp)
    want = torch.tensor(want, dtype=torch.float64)
    got = L.yarn_freqs(dim, theta, factor, 4096, 32.0, 1.0).double()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    cfg = deepseek_v2_lite.config()
    torch.testing.assert_close(MLA.mla_rope_freqs(cfg).double(), want, rtol=1e-6, atol=0)
    full = {**ref_cfg(cfg), "rope_theta": 1e4}
    torch.testing.assert_close(ref.yarn_inv_freq(full, "cpu").double(), want, rtol=1e-6, atol=0)
    scale = 192 ** -0.5 * (0.1 * 0.707 * math.log(40.0) + 1.0) ** 2
    assert MLA.mla_scale(cfg) == pytest.approx(scale, rel=1e-15)
    assert ref.softmax_scale(full) == pytest.approx(scale, rel=1e-15)
    assert L.yarn_mscale(1.0, 0.707) == 1.0


# ------------------------------------------------------------------ MLA


def test_mla_layer_is_the_reference(ref):
    pc = port_cfg()
    model, w = model_and_weights(ref, pc, seed=1)
    h = torch.randn((2, 24, pc.d_model), generator=torch.Generator().manual_seed(2))
    positions = torch.arange(24, dtype=torch.int32)
    got = MLA.mla_apply(model.blocks[1].attn, h, pc, positions=positions)
    want = ref._mla(w, "layers.1.", h, ref_cfg(pc), "f32", ())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # each planted fault moves the layer's output
    for fault in ("latent_norm_skipped", "mscale_left_out"):
        assert (ref._mla(w, "layers.1.", h, ref_cfg(pc), "f32", (fault,)) - want).abs().max() > 1e-3


def test_mla_blocks_do_not_serve_and_keep_their_norms_in_f32():
    pc = deepseek_v2_lite.smoke_config()
    model = T.init_params(pc, generator=torch.Generator().manual_seed(0))
    tokens = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    for call in (lambda: T.prefill(model, tokens, pc, T.ModelContext()),
                 lambda: T.init_cache(pc, 1, 8, device="cpu"),
                 lambda: T.decode_step(model, [{}] * pc.n_layers, tokens["tokens"][:, :1], 0, pc, T.ModelContext())):
        with pytest.raises(ValueError, match="do not serve yet"):
            call()
    cast = T.cast_params(model, pc)
    assert cast.blocks[1].attn["kv_norm"].dtype == torch.float32 and cast.blocks[1].attn["wq"].dtype == torch.bfloat16
    assert cast.blocks[1].moe.router.dtype == torch.float32


# ------------------------------------------------------------------ MoE


def test_seq_balance_is_the_per_sequence_formula(ref):
    """DeepSeek-V2's expert-level loss per sequence: the mean over
    sequences of Σ_e (E/(k·T))·count_e·mean score_e."""
    m = port_cfg().moe
    E, k, B, T_ = m.num_experts, m.top_k, 3, 10
    g = torch.Generator().manual_seed(3)
    scores = torch.softmax(torch.randn((B * T_, E), generator=g), dim=-1)
    idx = M._topk(scores, k)[1]
    picked = torch.zeros_like(scores).scatter_(1, idx, 1.0)
    want = 0.0
    for b in range(B):
        rows = range(b * T_, (b + 1) * T_)
        for e in range(E):
            count = sum(int(e in idx[t].tolist()) for t in rows)
            want += E / (k * T_) * count * float(scores[list(rows), e].mean())
    got = M._seq_balance(picked, scores, B, m)
    assert float(got) == pytest.approx(want / B, rel=1e-6)
    # the port's router, its loss and the reference's for one layer's input
    pc = port_cfg()
    model, w = model_and_weights(ref, pc, seed=4)
    x = torch.randn((B, T_, pc.d_model), generator=g)
    with torch.no_grad():
        _, aux = M._routing(model.blocks[1].moe.router, x.reshape(-1, pc.d_model), pc.moe, seqs=B)
        _, balance = ref._moe(w, "layers.1.", x, ref_cfg(pc), "f32", ref.Selections(), ())
    assert float(aux) == pytest.approx(float(balance), rel=1e-5)


@pytest.mark.parametrize("shares", [2, 8])
def test_shares_add_up_to_the_uncut_layer(ref, shares):
    """A layer cut into ``shares`` chips' shares of its 8 routed experts:
    each share's output (its experts' part plus the shared experts), summed
    over the shares with the shared experts counted once, is the uncut
    layer's, the port's and the reference's."""
    whole = port_cfg()
    model, w = model_and_weights(ref, whole, seed=5)
    x = torch.randn((2, 16, whole.d_model), generator=torch.Generator().manual_seed(6))
    moe = model.blocks[1].moe
    want, _ = M.moe_apply(moe, x, whole)
    want_ref, _ = ref._moe(w, "layers.1.", x, ref_cfg(whole), "f32", ref.Selections(), ())
    torch.testing.assert_close(want, want_ref, rtol=1e-5, atol=1e-5)
    shared = L.mlp_apply(moe.shared, x, act=whole.mlp_act, compute_dtype=torch.float32)
    E = whole.moe.num_experts
    per = E // shares
    total = -(shares - 1) * shared
    for r in range(shares):
        lo, hi = r * per, (r + 1) * per
        cut = port_cfg(experts_held=(lo, hi))
        part = M.MoE(cut, dtype=torch.float32, device="meta", generator=None)
        part.load_state_dict({"router": moe.router, "w_gate": moe.w_gate[lo:hi], "w_up": moe.w_up[lo:hi],
                              "w_down": moe.w_down[lo:hi], **{f"shared.{k}": v for k, v in moe.shared.items()}},
                             assign=True)
        out, _ = M.moe_apply(part, x, cut)
        total = total + out
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total, want_ref, rtol=1e-5, atol=1e-5)


def test_tiny_model_loss_and_gradients_under_replayed_routing(ref):
    """The whole model, a dense layer and two MoE layers holding 4 of 8
    experts, over one group's 3 rows (the last a padding slot of zeros,
    which takes no part): the real rows' cross entropy, the balance loss
    and every leaf's f32 gradient of Σ CE + α·balance, the reference over
    the real rows alone replaying the port's routing."""
    pc = port_cfg(experts_held=(2, 6))
    model, w = model_and_weights(ref, pc, seed=7)
    tokens = torch.randint(0, pc.vocab, (3, 20), generator=torch.Generator().manual_seed(8))
    tokens[2] = 0
    batch = {"tokens": tokens, "rows_valid": torch.tensor([1.0, 1.0, 0.0])}
    with M.recorded_routing() as log:
        per_row, _, aux = T.group_losses(model, batch, pc, T.ModelContext(), 3)
    loss = per_row[:2].sum() + pc.moe.router_aux_weight * aux
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))

    theta = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    select = ref.Selections(replay=log)
    ce, balance = ref.group_forward(theta, tokens[:2], ref_cfg(pc), select=select)
    want_loss = ce.sum() + pc.moe.router_aux_weight * balance
    want = dict(zip(theta, torch.autograd.grad(want_loss, list(theta.values()))))
    assert not select.queue and select.made > 0 and select.differ == 0
    torch.testing.assert_close(per_row[:2], ce, rtol=1e-5, atol=1e-6)
    assert float(aux.detach()) == pytest.approx(float(balance.detach()), rel=1e-5)
    assert len(want) == len(grads)
    for k, g in want.items():
        # sums over many tokens (the embedding's rows): atol at 1e-6 of the leaf's scale
        torch.testing.assert_close(grads[port_name(k)], g, rtol=1e-4, atol=1e-6 * float(g.abs().max()), msg=k)


@pytest.mark.parametrize("balance", ["seq", "switch"])
def test_padding_rows_take_no_part(ref, balance):
    """Under ``padding_routes=False`` a layer over 3 real rows and 2 padding
    rows gives the real rows what it gives them alone: their output, the
    balance loss, the capacity (of the real tokens, at a factor that
    makes it bind) and the counters; with padding routing (the
    reference's rule) the padding rows move the loss."""
    from repro_torch.obs import default_counters

    pc = port_cfg(experts_held=(2, 6), padding_routes=False, balance=balance, capacity_factor=0.5)
    model, _ = model_and_weights(ref, pc, seed=11)
    moe = model.blocks[1].moe
    x = torch.randn((3, 16, pc.d_model), generator=torch.Generator().manual_seed(12))
    padded = torch.cat([x, torch.zeros((2, 16, pc.d_model))])
    rows_valid = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0])
    default_counters().clear()
    with torch.no_grad():
        want, want_aux = M.moe_apply(moe, x, pc)
        alone = default_counters().read()
        default_counters().clear()
        got, aux = M.moe_apply(moe, padded, pc, rows_valid=rows_valid)
        assert default_counters().read() == alone and alone["moe.dropped"] > 0
        torch.testing.assert_close(got[:3], want, rtol=0, atol=1e-6)
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
        routing = dataclasses.replace(pc, moe=dataclasses.replace(pc.moe, padding_routes=True))
        _, routed_aux = M.moe_apply(moe, padded, routing, rows_valid=rows_valid)
    assert float(routed_aux) != pytest.approx(float(want_aux), rel=1e-3)


def test_a_held_share_outside_the_experts_raises():
    assert M.held(port_cfg().moe) == (0, 8) and M.held(port_cfg(experts_held=(2, 6)).moe) == (2, 6)
    with pytest.raises(ValueError, match="experts_held"):
        M.held(dataclasses.replace(port_cfg().moe, experts_held=(4, 12)))


# ------------------------------------------------------------------ attention route


@pytest.mark.parametrize("heads, kv", [(2, 2), (4, 2)])
def test_attention_with_narrower_v_heads_is_autograd_of_the_plain_attention(heads, kv):
    """q/k heads of 192 and v heads of 128 (MLA's): the plain route inside
    ``FlashAttentionFn`` under ``auto``, its output and its recomputing
    backward against autograd of ``attention_ref``, GQA included."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn((2, 16, heads, 192), generator=g, requires_grad=True)
    k = torch.randn((2, 16, kv, 192), generator=g, requires_grad=True)
    v = torch.randn((2, 16, kv, 128), generator=g, requires_grad=True)
    do = torch.randn((2, 16, heads, 128), generator=g)
    scale = 0.07
    got = fa.flash_attention(q, k, v, causal=True, scale=scale)
    assert got.grad_fn.name().endswith("FlashAttentionFnBackward")
    got_grads = torch.autograd.grad(got, (q, k, v), do)
    want = fa_ref.attention_ref(q, k, v, causal=True, scale=scale)
    want_grads = torch.autograd.grad(want, (q, k, v), do)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(got_grads, want_grads):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dq, dk, dv = fa_ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(), got.detach(), do, scale)
    assert dv.shape == v.shape
    torch.testing.assert_close(dv, want_grads[2], rtol=1e-5, atol=1e-5)


def test_attention_with_narrower_v_heads_refuses_the_kernel():
    q, k, v = torch.zeros((1, 4, 2, 192)), torch.zeros((1, 4, 2, 192)), torch.zeros((1, 4, 2, 128))
    with pytest.raises(ValueError, match="takes one head width"):
        fa.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="expected q"):
        fa.flash_attention(q, k, torch.zeros((1, 4, 1, 128)))
    assert fa.flash_attention(q, k, v, impl="torch_ref").shape == (1, 4, 2, 128)
