"""The model operations one training sequence needs.

6 operations a parameter a token (2 in the forward, 4 in the backward) for
every weight a token's products use: each layer's q, k, v, o, gate, up and
down projections and the tied embedding as the head (the embedding's
lookup is no product; the norm scales are elementwise); plus causal
attention, 12·H·dh operations (q·kᵀ and p·v, forward and backward) a
(query, key) pair a layer, T·(T + 1)/2 pairs a sequence.  The redundant
groups' copies of a shard and recomputation are not counted.
"""


def flops_per_sequence(cfg: dict) -> float:
    d, V, H, KV, dh, f, L, T = (cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"],
                                cfg["num_key_value_heads"], cfg["head_dim"], cfg["intermediate_size"],
                                cfg["num_hidden_layers"], cfg["seq_len"])
    layer = d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * f
    weights = L * layer + V * d
    attention = 12.0 * H * dh * L * T * (T + 1) / 2.0
    return 6.0 * weights * T + attention
