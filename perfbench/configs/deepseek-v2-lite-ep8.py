"""Plain reference of ``deepseek-v2-lite-ep8``: DeepSeek-V2-Lite's decoder as
one chip of an 8-way expert-parallel group holds it, its loss under Lemma
3's recovery weights, and AdamW, in float32 (TF32 off).

It imports torch and numpy only, and loads ``qwen3-1.7b-fr4.py`` beside it
by path for what the two share: the float8 products of the control, the
RMSNorm, the learning-rate schedule, fractional repetition's groups, the
token draw and the per-leaf comparison.  It follows the published
architecture (deepseek-ai/DeepSeek-V2-Lite's ``config.json`` and
arXiv:2405.04434), at the share and depth the configuration states:

* a token embedding over the vocabulary's slice; per layer a pre-norm
  multi-head latent attention (MLA) and a pre-norm feed-forward; a final
  RMSNorm and an untied head over the slice.
* MLA, without the query's low-rank path: q = h·W_q, per head 128 + 64
  (``qk_nope_head_dim`` + ``qk_rope_head_dim``); [c, k_r] = h·W_kva with
  the 512-wide latent c and one 64-wide key k_r shared by the heads;
  c ← RMSNorm(c); [k_nope, v] = c·W_kvb, 128 + 128 a head; the rotary
  embedding on q's rope part and on k_r, with YaRN's frequencies
  (``rope_scaling``: factor 40 over 4096 positions, β_fast 32, β_slow 1;
  mscale = mscale_all_dim, so the rotation keeps unit norm); each head's
  key [k_nope, k_r]; causal softmax at 192^−½ · (0.1·mscale_all_dim·ln 40 +
  1)²; o·W_o.  The rotary embedding pairs dimension i of the rope part
  with dimension i + 32 (split halves); the published code pairs 2i with
  2i + 1, the same rotation after a fixed permutation of the rope columns
  of W_q and W_kva, which seeded weights do not tell apart.
* layers below ``first_k_dense_replace`` a SwiGLU MLP of
  ``intermediate_size``; the others a MoE: softmax over the router's
  ``published.n_routed_experts`` outputs, the greedy top
  ``num_experts_per_tok`` of each token (the larger score first, the lower
  expert among equal ones), no renormalisation, ``routed_scaling_factor``
  1; this chip's experts ``experts_held`` = [lo, hi) alone, each keeping
  the top C = int(N·k·capacity_factor / E) of the N tokens of one group's
  forward by its combine weight (the port's dropping rule; DeepSeek-V2
  bounds each device's tokens instead) and adding its SwiGLU output times
  that weight into their rows; the absent experts' part left out; the
  shared experts (SwiGLU of width ``n_shared_experts`` ×
  ``moe_intermediate_size``) on every token.  The balance loss
  (``seq_aux``) of a layer is the mean over a forward's sequences of
  Σ_e f_e·P_e, f_e = E/(k·T)·(the sequence's tokens routed to e), P_e the
  mean score of e over the sequence; α (``aux_loss_alpha``) a layer,
  summed over the layers.

Data parallelism: each group's forward is its own, over the rows of the
shards it holds (the program's padding slot of zero tokens after them takes
no part: it routes nowhere, takes no capacity and adds no loss, so the
reference leaves it out).  Replicas of a block of
shards compute the same rows, so the step's loss is Σ_blocks a·(Σ over
the block's shards of the shard's mean next-token cross entropy + (its
shard count)·α·Σ_layers balance) / n, a = 1 for a block some alive group
holds and 0 for one none holds.  AdamW clips the global norm, then
updates every parameter with decoupled weight decay and a linear warm-up
into a cosine schedule.

Routing: every selection (each token's experts, each held expert's kept
tokens) may follow a recorded one (:class:`Selections`), so that the
reference trains along the program's routing decisions and is held to one
band; it then counts the selections its own scores would have made
differently.  The program selects over its padding rows too and at the
capacity of all its rows; what it keeps past the real rows and the real
tokens' capacity carries weight 0, and the reference reads the leading
part of each recorded selection.  :func:`make_weights` draws the weights and ``make_tokens``
the training data from the seed on the device, ids over the vocabulary's
slice.  ``precision="fp8"`` rounds every product's inputs to float8 (the
control); ``faults`` plants a fault: ``"shared_skipped"``,
``"latent_norm_skipped"``, ``"mscale_left_out"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint


def _beside(name: str) -> dict:
    """The names that the reference file ``name`` beside this one defines
    (run by path: file names hold dots and dashes)."""
    path = __file__.rsplit("/", 1)[0] + "/" + name
    names = {"__name__": "perfbench_ref_" + name.replace(".", "_").replace("-", "_"), "__file__": path}
    with open(path, encoding="utf-8") as f:
        exec(compile(f.read(), path, "exec"), names)
    return names


_QWEN = _beside("qwen3-1.7b-fr4.py")
make_tokens, fr_groups, leaf_gap = _QWEN["make_tokens"], _QWEN["fr_groups"], _QWEN["leaf_gap"]
_mm, _rms, _lr = _QWEN["_mm"], _QWEN["_rms"], _QWEN["_lr"]
FAULTS = ("shared_skipped", "latent_norm_skipped", "mscale_left_out")


def _dense(cfg: dict, i: int) -> bool:
    return i < cfg["first_k_dense_replace"]


def shapes(cfg: dict) -> list[tuple[str, tuple, object]]:
    """(name, shape, init) of every parameter, in the order they are drawn:
    init is a standard deviation, or None for a norm scale (ones)."""
    d, V, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    nope, rope, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    f, fe, ns = cfg["intermediate_size"], cfg["moe_intermediate_size"], cfg["n_shared_experts"]
    lo, hi = cfg["experts_held"]
    E = cfg["published"]["n_routed_experts"]
    out = [("embed", (V, d), cfg["init"]["embed_std"])]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (d,), None), (p + "wq", (d, H * (nope + rope)), d ** -0.5),
                (p + "wkv_a", (d, r + rope), d ** -0.5), (p + "kv_norm", (r,), None),
                (p + "wkv_b", (r, H * (nope + dv)), r ** -0.5), (p + "wo", (H * dv, d), (H * dv) ** -0.5),
                (p + "mlp_norm", (d,), None)]
        if _dense(cfg, i):
            out += [(p + "gate", (d, f), d ** -0.5), (p + "up", (d, f), d ** -0.5), (p + "down", (f, d), f ** -0.5)]
        else:
            out += [(p + "router", (d, E), d ** -0.5), (p + "w_gate", (hi - lo, d, fe), d ** -0.5),
                    (p + "w_up", (hi - lo, d, fe), d ** -0.5), (p + "w_down", (hi - lo, fe, d), fe ** -0.5),
                    (p + "shared_gate", (d, fe * ns), d ** -0.5), (p + "shared_up", (d, fe * ns), d ** -0.5),
                    (p + "shared_down", (fe * ns, d), (fe * ns) ** -0.5)]
    out += [("final_norm", (d,), None), ("head", (d, V), d ** -0.5)]
    return out


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every weight, float32, drawn in one call from a generator on
    ``device``: views of one buffer, each scaled to its init."""
    spec = shapes(cfg)
    g = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(sum(math.prod(s) for _, s, _ in spec), generator=g, device=device, dtype=torch.float32)
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


# ---------------------------------------------------------------- routing


class Selections:
    """The top-k selections of one group's forward, in the order it makes
    them: each MoE layer's tokens' experts, then its held experts' kept
    tokens, kept in ``log``.  Given ``replay`` (the program's recorded
    indices, in that order), each selection takes the recorded indices,
    reads their values from this run's scores, and counts how many of them
    this run's own scores would not have selected (``differ`` of
    ``made``).  A replayed selection may be larger than this run's in
    each dimension (the program's, over its padding rows too): its leading
    rows and columns are taken."""

    def __init__(self, replay=None):
        self.queue = None if replay is None else list(replay)
        self.log = []
        self.differ = 0
        self.made = 0

    def __call__(self, x, k: int):
        own = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
        self.made += own.numel()
        if self.queue is None:
            self.log.append(own)
            return x.gather(-1, own), own
        idx = self.queue.pop(0).to(x.device)
        if idx.dim() != own.dim() or any(a < b for a, b in zip(idx.shape, own.shape)):
            raise RuntimeError(f"replayed selection {tuple(idx.shape)} where this run selects {tuple(own.shape)}")
        idx = idx[: own.shape[0], : own.shape[1]]
        inside = torch.zeros_like(x).scatter_(-1, own, 1.0).gather(-1, idx)
        self.differ += int(own.numel() - inside.sum())
        self.log.append(idx)
        return x.gather(-1, idx), idx


# ---------------------------------------------------------------- model


def yarn_inv_freq(cfg: dict, device) -> torch.Tensor:
    """YaRN's inverse frequencies, closed form in float64, as float32."""
    rs, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], float(cfg["rope_theta"])

    def turns_dim(rot):
        return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(turns_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(turns_dim(rs["beta_slow"])), dim - 1)
    i = np.arange(dim // 2, dtype=np.float64)
    ramp = np.clip((i - low) / max(high - low, 1e-3), 0.0, 1.0)
    extra = base ** (-2.0 * i / dim)
    inv = extra / rs["factor"] * ramp + extra * (1.0 - ramp)
    return torch.tensor(inv, dtype=torch.float32, device=device)


def softmax_scale(cfg: dict, faults=()) -> float:
    rs = cfg["rope_scaling"]
    mscale = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * (
        1.0 if "mscale_left_out" in faults else mscale ** 2)


def _rope(x, inv):
    """x (R, T, heads, dim): dimension i rotated with i + dim/2 at angle t·inv_i."""
    T, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, scale: float, precision: str):
    """Causal softmax attention, one sequence at a time: q, k (R, T, H,
    dqk), v (R, T, H, dv) → (R, T, H, dv)."""
    T = q.shape[1]
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    outs = []
    for r in range(q.shape[0]):
        s = _mm(q[r].transpose(0, 1), k[r].permute(1, 2, 0), precision) * scale  # (H, T, T)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        outs.append(_mm(a, v[r].transpose(0, 1), precision).transpose(0, 1))
    return torch.stack(outs)


def _mla(w, p: str, h, cfg: dict, precision: str, faults):
    R, T, _ = h.shape
    H, nope, rope, dv = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    mm = lambda a, b: _mm(a, b, precision)  # noqa: E731
    q = mm(h, w[p + "wq"]).view(R, T, H, nope + rope)
    c, k_r = mm(h, w[p + "wkv_a"]).split([cfg["kv_lora_rank"], rope], dim=-1)
    if "latent_norm_skipped" not in faults:
        c = _rms(c, w[p + "kv_norm"], cfg["rms_norm_eps"])
    kv = mm(c, w[p + "wkv_b"]).view(R, T, H, nope + dv)
    inv = yarn_inv_freq(cfg, h.device)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], inv)], dim=-1)
    k_r = _rope(k_r[:, :, None, :], inv).expand(R, T, H, rope)
    k = torch.cat([kv[..., :nope], k_r], dim=-1)
    o = _attend(q, k, kv[..., nope:], softmax_scale(cfg, faults), precision)
    return mm(o.reshape(R, T, H * dv), w[p + "wo"])


def _swiglu(x, gate, up, down, precision):
    return _mm(F.silu(_mm(x, gate, precision)) * _mm(x, up, precision), down, precision)


def _moe(w, p: str, h, cfg: dict, precision: str, select, faults):
    """(the layer's output (R, T, d), its balance loss)."""
    R, T, d = h.shape
    N = R * T
    E, K = cfg["published"]["n_routed_experts"], cfg["num_experts_per_tok"]
    lo, hi = cfg["experts_held"]
    x = h.reshape(N, d)
    scores = torch.softmax(_mm(x, w[p + "router"], precision), dim=-1)  # (N, E)
    vals, idx = select(scores, K)
    picked = torch.zeros_like(scores).scatter_(1, idx, 1.0)
    f = picked.view(R, T, E).sum(1) * (E / (K * T))
    balance = torch.mean(torch.sum(f * scores.view(R, T, E).mean(1), dim=-1))
    cols = torch.zeros_like(scores).scatter_(1, idx, vals)[:, lo:hi]
    cap = min(max(1, int(N * K * cfg["capacity_factor"] / E)), N)
    kept_w, kept = select(cols.T, cap)  # (held, C)
    out_e = _swiglu(x[kept], w[p + "w_gate"], w[p + "w_up"], w[p + "w_down"], precision)  # (held, C, d)
    out = torch.zeros_like(x).index_add(0, kept.reshape(-1), (out_e * kept_w[..., None]).reshape(-1, d))
    if "shared_skipped" not in faults:
        out = out + _recomputed(_swiglu, x, w[p + "shared_gate"], w[p + "shared_up"], w[p + "shared_down"],
                                precision)
    return out.view(R, T, d), balance


def _recomputed(fn, *args):
    """fn(*args), its intermediates recomputed in the backward instead of
    kept: the attention layers and the feed-forwards over every token, so
    that the reference's float32 activations fit beside its state."""
    return checkpoint.checkpoint(fn, *args, use_reentrant=False)


def group_forward(w: dict, tokens: torch.Tensor, cfg: dict, *, precision: str = "f32", select=None, faults=()):
    """One group's forward over its rows tokens (R, T): (each row's mean
    next-token cross entropy (R,), the layers' balance losses summed)."""
    select = select or Selections()
    eps = cfg["rms_norm_eps"]
    x = w["embed"][tokens]
    balance = torch.zeros((), device=tokens.device)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        x = x + _recomputed(_mla, w, p, _rms(x, w[p + "attn_norm"], eps), cfg, precision, faults)
        h = _rms(x, w[p + "mlp_norm"], eps)
        if _dense(cfg, i):
            x = x + _recomputed(_swiglu, h, w[p + "gate"], w[p + "up"], w[p + "down"], precision)
        else:
            out, b = _moe(w, p, h, cfg, precision, select, faults)
            x, balance = x + out, balance + b
    logits = _mm(_rms(x, w["final_norm"], eps), w["head"], precision)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0].mean(dim=1), balance


# ---------------------------------------------------------------- training


def group_shards(cfg: dict) -> list[list[int]]:
    """The shards each group holds, in its slots' order."""
    holders = fr_groups(cfg)
    return [[j for j in range(cfg["shards"]) if g in holders[j]] for g in range(cfg["groups"])]


def _blocks(cfg: dict, alive) -> list[tuple[int, list[int]]]:
    """(the group that computes it, its shards) for each block of shards
    that some alive group holds: the first alive holder."""
    out, seen = [], set()
    for g, shards in enumerate(group_shards(cfg)):
        if alive[g] and tuple(shards) not in seen:
            seen.add(tuple(shards))
            out.append((g, shards))
    return out


def step_loss(theta: dict, tokens: torch.Tensor, alive, routing, cfg: dict, *, precision: str, faults,
              counts: list, made: dict) -> torch.Tensor:
    """The step's loss from its (shards, mb, T) tokens and alive mask;
    ``routing`` the program's selections by group (or None: its own);
    ``counts`` gains each group forward's (differing, made) selections and
    ``made`` each group's selections."""
    mb, T = tokens.shape[1], tokens.shape[2]
    alpha = cfg["aux_loss_alpha"]
    loss = torch.zeros((), device=tokens.device)
    for g, shards in _blocks(cfg, alive):
        rows = tokens[shards].reshape(-1, T)
        select = Selections(None if routing is None else routing[g])
        made[g] = select.log
        ce, balance = group_forward(theta, rows, cfg, precision=precision, select=select, faults=faults)
        if select.queue:
            raise RuntimeError(f"{len(select.queue)} replayed selections left unused")
        counts.append((select.differ, select.made))
        loss = loss + torch.sum(ce.view(len(shards), mb).mean(1)) + len(shards) * alpha * balance
    return loss / cfg["shards"]


def train(cfg: dict, draw, batches: list, masks: list, routing: list, *, updates: int,
          precision: str = "f32", faults=()) -> dict:
    """Follow the program's steps from the same weights, ``draw()`` (drawn
    again at the end, for the changes, rather than kept): each step's
    (shards, mb, T) tokens, alive mask and the program's selections of
    each group (``routing[t][g]``; ``routing[t]`` None to route on its
    own).  The first ``updates`` steps are taken whole; the steps after
    them only read their loss.  Returns {"loss": [...], "grad_norms":
    {leaf: ‖clipped g‖ of step 1}, "change_norms": {leaf: ‖θ_after − θ_0‖},
    "route_diff_share": the share of the selections that its own scores
    would have made otherwise, "routing": the selections it followed, as
    ``routing``}, the norms in float64."""
    unknown = set(faults) - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        opt = cfg["optimizer"]
        theta = {k: v.clone().requires_grad_(True) for k, v in draw().items()}
        names = list(theta)
        m = {k: torch.zeros_like(v) for k, v in theta.items()}
        v2 = {k: torch.zeros_like(v) for k, v in theta.items()}
        out, counts = {"loss": [], "grad_norms": {}, "change_norms": {}, "routing": []}, []
        for t, (tokens, alive, routes) in enumerate(zip(batches, masks, routing), start=1):
            out["routing"].append({})
            kw = dict(precision=precision, faults=faults, counts=counts, made=out["routing"][-1])
            if t > updates:
                with torch.no_grad():
                    out["loss"].append(float(step_loss(theta, tokens, alive, routes, cfg, **kw)))
                continue
            loss = step_loss(theta, tokens, alive, routes, cfg, **kw)
            grads = [torch.zeros_like(theta[k]) if g is None else g for k, g in
                     zip(names, torch.autograd.grad(loss, [theta[k] for k in names], allow_unused=True))]
            out["loss"].append(float(loss.detach()))
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
            del grads, loss
        del m, v2
        with torch.no_grad():
            weights = draw()
            for k in names:
                out["change_norms"][k] = float(torch.linalg.vector_norm((theta[k] - weights[k]).double()))
        out["route_diff_share"] = sum(c[0] for c in counts) / max(1, sum(c[1] for c in counts))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def compare(program: dict, ref: dict) -> dict:
    """The numbers compared for the followed steps."""
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(program["loss"], ref["loss"], strict=True)),
        "grad_gap": leaf_gap(program["grad_norms"], ref["grad_norms"], ref["grad_norms"]),
        "update_gap": leaf_gap(program["change_norms"], ref["change_norms"], ref["grad_norms"]),
        "route_diff_share": ref["route_diff_share"],
    }
