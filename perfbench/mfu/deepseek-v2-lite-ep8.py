"""The model operations one training sequence needs on this chip's share.

6 operations a parameter a token (2 in the forward, 4 in the backward) for
every weight a token's products use: each layer's latent attention (W_q,
W_kva, W_kvb, W_o), the dense layer's SwiGLU, each MoE layer's router, its
shared experts and the held experts a token reaches on average (top-k ×
held / routed of them, each three d × moe_intermediate_size matrices),
and the head over the vocabulary's slice (the embedding's lookup is no
product; the norm scales are elementwise); plus causal attention, 6·H·(q/k
width + v width) operations (q·kᵀ and p·v, forward and backward) a
(query, key) pair a layer, T·(T + 1)/2 pairs a sequence.  The redundant
groups' copies of a shard, the padding slot, the capacity's unused slots
and recomputation are not counted.
"""


def flops_per_sequence(cfg: dict) -> float:
    d, V, H, T = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"], cfg["seq_len"]
    nope, rope, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    L, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    fe, E = cfg["moe_intermediate_size"], cfg["published"]["n_routed_experts"]
    lo, hi = cfg["experts_held"]
    attn = d * H * (nope + rope) + d * (r + rope) + r * H * (nope + dv) + H * dv * d
    expert = 3 * d * fe
    moe = d * E + cfg["n_shared_experts"] * expert + cfg["num_experts_per_tok"] * (hi - lo) / E * expert
    weights = L * attn + dense * 3 * d * cfg["intermediate_size"] + (L - dense) * moe + d * V
    attention = 6.0 * H * (nope + rope + dv) * L * T * (T + 1) / 2.0
    return 6.0 * weights * T + attention
