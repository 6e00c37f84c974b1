"""Plain reference of ``qwen3-1.7b-fr4``: Qwen3's decoder, its loss under
Lemma 3's recovery weights, and AdamW, in float32 (TF32 off).

It imports torch and numpy only.  It follows the published architecture
(Qwen/Qwen3-1.7B's ``config.json`` and the Qwen3 report): a token
embedding; per layer a pre-norm GQA attention with RMSNorm on each query
and key head (``q_norm``, ``k_norm``), rotary embeddings on the split
halves of each head (θ = ``rope_theta``), causal softmax over ``1/√dh``
scaled scores, then a pre-norm SwiGLU MLP; a final RMSNorm; the logits by
the tied embedding.  RMSNorm is ``x / √(mean x² + eps) · scale``.  The loss
of a step is Σ_j a_j·CE_j / n over the n data shards, CE_j being the mean
next-token cross entropy of shard j's sequences and a_j its recovered weight: 1 for a shard
that some alive group holds (fractional repetition recovers it exactly) and
0 for one that none holds.  AdamW clips the global norm, then updates
every parameter with decoupled weight decay and a linear warm-up into a
cosine schedule, as the configuration states.

:func:`make_weights` draws the weights and :func:`make_tokens` the
training data from the seed on the device; the benchmark hands the same to
the program.  The control computes the
same with every product's inputs rounded to float8 (e4m3, a scale a tensor),
the precision below the configuration's bfloat16 compute
(``precision="fp8"``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

TOKEN_STREAM = 2**40


def shapes(cfg: dict) -> list[tuple[str, tuple, object]]:
    """(name, shape, init) of every parameter, in the order they are drawn:
    init is a standard deviation, or ``1.0`` for a norm scale (ones)."""
    d, V, H, KV, dh, f = (cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"],
                          cfg["num_key_value_heads"], cfg["head_dim"], cfg["intermediate_size"])
    out = [("embed", (V, d), cfg["init"]["embed_std"])]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "attn_norm", (d,), None), (p + "wq", (d, H * dh), d ** -0.5), (p + "wk", (d, KV * dh), d ** -0.5),
            (p + "wv", (d, KV * dh), d ** -0.5), (p + "wo", (H * dh, d), (H * dh) ** -0.5),
            (p + "q_norm", (dh,), None), (p + "k_norm", (dh,), None), (p + "mlp_norm", (d,), None),
            (p + "gate", (d, f), d ** -0.5), (p + "up", (d, f), d ** -0.5), (p + "down", (f, d), f ** -0.5),
        ]
    out.append(("final_norm", (d,), None))
    return out


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every weight, float32, drawn in one call from a generator on
    ``device``: views of one buffer, each scaled to its init."""
    spec = shapes(cfg)
    total = sum(math.prod(s) for _, s, _ in spec)
    g = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, std in spec:
        n = math.prod(shape)
        t = buf[at: at + n].view(shape)
        if std is None:
            t.fill_(1.0)
        else:
            t.mul_(std)
        out[name] = t
        at += n
    return out


def make_tokens(cfg: dict, seed: int, device) -> np.ndarray:
    """(resident_steps, shards, microbatch, seq_len) int32 host array: each
    resident step's sequences of each data shard, token ids uniform over
    the whole vocabulary, drawn in one call from a generator on
    ``device`` (a stream apart from the weights')."""
    g = torch.Generator(device=device).manual_seed(int(seed) + TOKEN_STREAM)
    shape = (cfg["resident_steps"], cfg["shards"], cfg["microbatch"], cfg["seq_len"])
    return torch.randint(0, cfg["vocab_size"], shape, generator=g, device=device).to(torch.int32).cpu().numpy()


# ---------------------------------------------------------------- precision


def _q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, back in f32."""
    s = torch.clamp_min(x.detach().abs().amax().float(), 1e-30) / 448.0
    return (x.float() / s).to(torch.float8_e4m3fn).float() * s


class _MM8(torch.autograd.Function):
    """a @ b with both inputs rounded to float8, in the forward and in the
    backward's two products alike."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def _mm(a, b, precision: str):
    return _MM8.apply(a, b) if precision == "fp8" else a @ b


# ---------------------------------------------------------------- model


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x (B, T, heads, dh): the split-halves rotation of position t."""
    T, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sequence_ce(w: dict, tokens: torch.Tensor, cfg: dict, precision: str = "f32") -> torch.Tensor:
    """(B,) each sequence's mean next-token cross entropy."""
    B, T = tokens.shape
    H, KV, dh, eps = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"], cfg["rms_norm_eps"]
    theta = float(cfg["rope_theta"])
    mm = lambda a, b: _mm(a, b, precision)  # noqa: E731
    x = w["embed"][tokens]
    causal = torch.ones((T, T), dtype=torch.bool, device=tokens.device).tril()
    for i in range(cfg["num_hidden_layers"]):
        p = lambda k: w[f"layers.{i}.{k}"]  # noqa: E731
        h = _rms(x, p("attn_norm"), eps)
        q = _rope(_rms(mm(h, p("wq")).view(B, T, H, dh), p("q_norm"), eps), theta)
        k = _rope(_rms(mm(h, p("wk")).view(B, T, KV, dh), p("k_norm"), eps), theta)
        v = mm(h, p("wv")).view(B, T, KV, dh)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * dh ** -0.5        # (B, H, T, T)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = mm(a, v.transpose(1, 2)).transpose(1, 2).reshape(B, T, H * dh)
        x = x + mm(o, p("wo"))
        h = _rms(x, p("mlp_norm"), eps)
        x = x + mm(torch.nn.functional.silu(mm(h, p("gate"))) * mm(h, p("up")), p("down"))
    logits = mm(_rms(x, w["final_norm"], eps), w["embed"].T)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0].mean(dim=1)


def covered_weights(groups_of_shard: list[list[int]], alive) -> np.ndarray:
    """(n,) a_j: 1 where some alive group holds shard j, else 0."""
    alive = np.asarray(alive, dtype=bool)
    return np.array([1.0 if any(alive[g] for g in gs) else 0.0 for gs in groups_of_shard])


def fr_groups(cfg: dict) -> list[list[int]]:
    """Fractional repetition: the groups split into ``redundancy`` replica
    sets of G/ell groups; in each set the shards are cut into contiguous
    blocks, one a group.  The groups that hold each shard."""
    G, n, ell = cfg["groups"], cfg["shards"], cfg["redundancy"]
    per = G // ell
    return [[rep * per + (j * per) // n for rep in range(ell)] for j in range(n)]


# ---------------------------------------------------------------- training


def _lr(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1.0 - opt["min_lr_ratio"]) * cos)


def train(cfg: dict, weights: dict, batches: list, masks: list, *, updates: int, precision: str = "f32",
          half_batch: bool = False) -> dict:
    """Follow the program's steps from the same weights: each step's batch
    is (n·mb, T) tokens, shard-major, and its alive mask.  Each step's loss
    and gradient are summed over the shards, one shard's forward and
    backward at a time.  The first ``updates`` steps are taken whole; the
    steps after them only read their loss, from the weights the updates
    left.  Returns {"loss": [...], "grad_norms": {leaf: ‖clipped g‖ of step
    1}, "change_norms": {leaf: ‖θ_after − θ_0‖}}, the norms in float64.
    ``half_batch`` is a planted fault: each step's loss over the first half
    of the shards, their mean taken over that half."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        opt = cfg["optimizer"]
        names = list(weights)
        theta = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
        m = {k: torch.zeros_like(v) for k, v in weights.items()}
        v2 = {k: torch.zeros_like(v) for k, v in weights.items()}
        groups = fr_groups(cfg)
        n, mb = cfg["shards"], cfg["microbatch"]
        kept = n // 2 if half_batch else n
        out = {"loss": [], "grad_norms": {}, "change_norms": {}}
        for t, (tokens, alive) in enumerate(zip(batches, masks), start=1):
            a = covered_weights(groups, alive)
            if t > updates:
                with torch.no_grad():
                    out["loss"].append(sum(
                        float(a[j] * torch.sum(sequence_ce(theta, tokens[j * mb: (j + 1) * mb].long(), cfg,
                                                           precision)) / (kept * mb))
                        for j in range(kept) if a[j] != 0.0))
                continue
            loss = 0.0
            grads = [torch.zeros_like(weights[k]) for k in names]
            for j in range(kept):
                if a[j] == 0.0:
                    continue
                ce = sequence_ce(theta, tokens[j * mb: (j + 1) * mb].long(), cfg, precision)
                part = a[j] * torch.sum(ce) / (kept * mb)
                for acc, g in zip(grads, torch.autograd.grad(part, [theta[k] for k in names])):
                    acc += g
                loss += float(part.detach())
            out["loss"].append(loss)
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                clip = torch.clamp_max(opt["grad_clip"] / torch.clamp_min(gnorm, 1e-9), 1.0)
                lr = _lr(opt, t)
                b1t, b2t = 1.0 - opt["b1"] ** t, 1.0 - opt["b2"] ** t
                for k, g in zip(names, grads):
                    g = g * clip
                    if t == 1:
                        out["grad_norms"][k] = float(torch.linalg.vector_norm(g.double()))
                    m[k].mul_(opt["b1"]).add_((1.0 - opt["b1"]) * g)
                    v2[k].mul_(opt["b2"]).add_((1.0 - opt["b2"]) * g * g)
                    delta = (m[k] / b1t) / (torch.sqrt(v2[k] / b2t) + opt["eps"]) + opt["weight_decay"] * theta[k]
                    theta[k].sub_(lr * delta)
            del grads
        with torch.no_grad():
            for k in names:
                out["change_norms"][k] = float(torch.linalg.vector_norm((theta[k] - weights[k]).double()))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def leaf_gap(got: dict, want: dict, grad_norms: dict) -> float:
    """The worst leaf's |‖got‖ − ‖want‖| over the larger of ‖want‖ and the
    median leaf's ‖want‖.  Leaves whose reference gradient is under a
    thousandth of the median leaf's (nought to rounding) are left out."""
    med_g = float(np.median(list(grad_norms.values())))
    keep = [k for k in want if grad_norms[k] >= 1e-3 * med_g]
    med = float(np.median([want[k] for k in keep]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keep)


def compare(program: dict, ref: dict) -> dict:
    """The numbers compared for the followed steps."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], ref["loss"], strict=True))
    return {
        "loss_gap": loss,
        "grad_gap": leaf_gap(program["grad_norms"], ref["grad_norms"], ref["grad_norms"]),
        "update_gap": leaf_gap(program["change_norms"], ref["change_norms"], ref["grad_norms"]),
    }
