"""Plain reference of TrOCR (Li et al., AAAI 2023, arXiv:2109.10282), in
float32 torch operations, as ``microsoft/trocr-base-handwritten``'s
``config.json`` describes it.

The encoder (ViT): a stride-``patch_size`` convolution with bias over the
normalised image, a CLS token and learned positions, pre-LN layers of
multi-head attention (q, k, v without bias, scores over √head_dim) and an
exact-GELU MLP, and a final LayerNorm (ε ``layer_norm_eps``). The decoder
(TrOCR): token embeddings (not scaled) plus learned positions at an offset
of 2, ``layernorm_embedding``, post-LN layers of causal self-attention,
cross-attention over every encoder token (its k, v projected from the
encoder's width) and an exact-GELU MLP (q scaled by head_dim^−½, every
projection with bias, LayerNorm ε 1e-5), and an output projection tied to
the token embedding.

It works on a dict of weights named as the port's ``TrOCRModel.state_dict()``
(Hugging Face's ``VisionEncoderDecoderModel``) names them, imports nothing
of the port, and runs with TF32 off (the caller's ``plain_float32``). It
keeps no cache and batches nothing across lines: the decoder runs whole
sequences under a causal mask, and ``beam_search`` runs it again over each
beam's whole prefix at every step, each beam with its own copy of its
line's encoder output.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .trba import path_confidence, path_log_prob  # noqa: F401  (the same rules)

W = Dict[str, torch.Tensor]
ENC, DEC = "encoder.encoder.layer", "decoder.model.decoder"
POSITION_OFFSET = 2  # BART's learned positions start at row 2
DEC_LN_EPS = 1e-5  # torch's LayerNorm default, which the TrOCR decoder keeps
SPECIALS = 4  # RoBERTa's <s>, <pad>, </s>, <unk>


def layout(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of every weight of the configuration."""
    e, d = cfg["encoder"], cfg["decoder"]
    he, hd, p, ch = e["hidden_size"], d["d_model"], e["patch_size"], e["num_channels"]
    n_patch = (e["image_size"] // p) ** 2
    out: Dict[str, Tuple[int, ...]] = {
        "encoder.embeddings.cls_token": (1, 1, he),
        "encoder.embeddings.position_embeddings": (1, n_patch + 1, he),
        "encoder.embeddings.patch_embeddings.projection.weight": (he, ch, p, p),
        "encoder.embeddings.patch_embeddings.projection.bias": (he,),
        "encoder.layernorm.weight": (he,), "encoder.layernorm.bias": (he,),
        f"{DEC}.embed_tokens.weight": (d["vocab_size"], hd),
        f"{DEC}.embed_positions.weight": (d["max_position_embeddings"] + POSITION_OFFSET, hd),
        f"{DEC}.layernorm_embedding.weight": (hd,), f"{DEC}.layernorm_embedding.bias": (hd,),
    }

    def linear(name, cin, cout, bias=True):
        out[f"{name}.weight"] = (cout, cin)
        if bias:
            out[f"{name}.bias"] = (cout,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    for i in range(e["num_hidden_layers"]):
        p_ = f"{ENC}.{i}"
        norm(f"{p_}.layernorm_before", he)
        for m in ("query", "key", "value"):
            linear(f"{p_}.attention.attention.{m}", he, he, bias=e["qkv_bias"])
        linear(f"{p_}.attention.output.dense", he, he)
        norm(f"{p_}.layernorm_after", he)
        linear(f"{p_}.intermediate.dense", he, e["intermediate_size"])
        linear(f"{p_}.output.dense", e["intermediate_size"], he)
    for i in range(d["decoder_layers"]):
        p_ = f"{DEC}.layers.{i}"
        for att, kv_in in (("self_attn", hd), ("encoder_attn", d["cross_attention_hidden_size"])):
            linear(f"{p_}.{att}.q_proj", hd, hd)
            linear(f"{p_}.{att}.k_proj", kv_in, hd)
            linear(f"{p_}.{att}.v_proj", kv_in, hd)
            linear(f"{p_}.{att}.out_proj", hd, hd)
            norm(f"{p_}.{att}_layer_norm", hd)
        linear(f"{p_}.fc1", hd, d["decoder_ffn_dim"])
        linear(f"{p_}.fc2", d["decoder_ffn_dim"], hd)
        norm(f"{p_}.final_layer_norm", hd)
    return out


def _linear(w: W, name: str, x):
    return F.linear(x, w[f"{name}.weight"], w.get(f"{name}.bias"))


def _norm(w: W, name: str, x, eps: float):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)


def _mha(q, k, v, heads: int, mask=None):
    """Multi-head attention of projected (B, Tq, D) queries, (B, Tk, D) keys
    and values; the queries already scaled."""
    b, tq, dm = q.shape
    split = lambda x: x.reshape(b, x.shape[1], heads, dm // heads).transpose(1, 2)
    s = split(q) @ split(k).transpose(-1, -2)
    if mask is not None:
        s = s + mask
    return (torch.softmax(s, -1) @ split(v)).transpose(1, 2).reshape(b, tq, dm)


def encode(w: W, cfg: Dict, images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 line images at the input's size → (B, 1 + patches, hidden)."""
    e = cfg["encoder"]
    heads, eps = e["num_attention_heads"], e["layer_norm_eps"]
    x = ((images_u8.float() / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)
    p = F.conv2d(x, w["encoder.embeddings.patch_embeddings.projection.weight"],
                 w["encoder.embeddings.patch_embeddings.projection.bias"], stride=e["patch_size"])
    p = p.flatten(2).transpose(1, 2)
    cls = w["encoder.embeddings.cls_token"].expand(p.shape[0], -1, -1)
    h = torch.cat([cls, p], 1) + w["encoder.embeddings.position_embeddings"]
    dh = e["hidden_size"] // heads
    for i in range(e["num_hidden_layers"]):
        p_ = f"{ENC}.{i}"
        y = _norm(w, f"{p_}.layernorm_before", h, eps)
        a = f"{p_}.attention.attention"
        q, k, v = (_linear(w, f"{a}.{m}", y) for m in ("query", "key", "value"))
        h = h + _linear(w, f"{p_}.attention.output.dense", _mha(q / math.sqrt(dh), k, v, heads))
        y = _norm(w, f"{p_}.layernorm_after", h, eps)
        h = h + _linear(w, f"{p_}.output.dense", F.gelu(_linear(w, f"{p_}.intermediate.dense", y)))
    return _norm(w, "encoder.layernorm", h, eps)


def decoder_logits(w: W, cfg: Dict, enc: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The decoder's logits (B, T, V) over whole sequences ``ids`` (B, T)
    (the start token first), under a causal mask, each row attending to
    its own encoder output ``enc`` (B, S, E)."""
    d = cfg["decoder"]
    heads = d["decoder_attention_heads"]
    t = ids.shape[1]
    scale = (d["d_model"] // heads) ** -0.5
    pos = torch.arange(t, device=ids.device) + POSITION_OFFSET
    h = w[f"{DEC}.embed_tokens.weight"][ids.long()] + w[f"{DEC}.embed_positions.weight"][pos]
    h = _norm(w, f"{DEC}.layernorm_embedding", h, DEC_LN_EPS)
    mask = torch.triu(torch.full((t, t), float("-inf"), device=ids.device), 1)
    for i in range(d["decoder_layers"]):
        p_ = f"{DEC}.layers.{i}"
        for att, kv, m in (("self_attn", None, mask), ("encoder_attn", enc, None)):
            src = h if kv is None else kv
            o = _mha(_linear(w, f"{p_}.{att}.q_proj", h) * scale, _linear(w, f"{p_}.{att}.k_proj", src),
                     _linear(w, f"{p_}.{att}.v_proj", src), heads, m)
            h = _norm(w, f"{p_}.{att}_layer_norm", h + _linear(w, f"{p_}.{att}.out_proj", o), DEC_LN_EPS)
        y = _linear(w, f"{p_}.fc2", F.gelu(_linear(w, f"{p_}.fc1", h)))
        h = _norm(w, f"{p_}.final_layer_norm", h + y, DEC_LN_EPS)
    return h @ w[f"{DEC}.embed_tokens.weight"].T


def forced_log_probs(w: W, cfg: Dict, enc: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-softmax of the temperature-scaled logits (B, steps, V) along
    ``tokens`` (B, steps): step 0 reads the start token, step t the token of
    step t − 1."""
    start = torch.full_like(tokens[:, :1], cfg["decoder"]["decoder_start_token_id"])
    ids = torch.cat([start, tokens[:, :-1]], 1).long()
    return torch.log_softmax(decoder_logits(w, cfg, enc, ids) / cfg["temperature"], -1)


def beam_search(w: W, cfg: Dict, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The configuration's beam search (``beam_size``, ``alpha``,
    ``temperature``, ``max_length`` steps) → (each line's best score (B,),
    its tokens (B, steps)). A beam's score is the sum of its tokens'
    log-probabilities at the temperature; a beam that has emitted EOS
    continues only with EOS, at log-probability 0. Each step runs the
    decoder over every beam's whole prefix and keeps the ``beam_size`` best
    of beams × tokens by score over the GNMT length penalty
    ((5 + t + 1) / 6)^α, ties to the lowest index."""
    d = cfg["decoder"]
    b, k, v, eos = enc.shape[0], cfg["beam_size"], d["vocab_size"], d["eos_token_id"]
    rows = torch.arange(b, device=enc.device)[:, None]
    enc_k = enc.repeat_interleave(k, 0)  # each beam holds its line's encoder output
    prefix = torch.full((b * k, 1), d["decoder_start_token_id"], dtype=torch.long, device=enc.device)
    scores = torch.full((b, k), float("-inf"), device=enc.device)
    scores[:, 0] = 0.0
    done = torch.zeros(b, k, dtype=torch.bool, device=enc.device)
    only_eos = torch.full((v,), float("-inf"), device=enc.device)
    only_eos[eos] = 0.0
    for t in range(cfg["max_length"]):
        last = decoder_logits(w, cfg, enc_k, prefix)[:, -1]
        lp = torch.log_softmax(last / cfg["temperature"], -1).reshape(b, k, v)
        lp = torch.where(done[..., None], only_eos, lp)
        penalty = ((5.0 + t + 1) / 6.0) ** cfg["alpha"]
        cand = (scores[..., None] + lp).reshape(b, k * v) / penalty
        top, idx = torch.sort(cand, dim=1, descending=True, stable=True)
        parent, tok = idx[:, :k] // v, idx[:, :k] % v
        scores = top[:, :k] * penalty
        pick = (rows * k + parent).reshape(-1)
        prefix = torch.cat([prefix[pick], tok.reshape(-1, 1)], 1)
        done = done.gather(1, parent) | (tok == eos)
    best, beam = scores.max(1)
    return best, prefix.reshape(b, k, -1)[rows[:, 0], beam, 1:]


def stand_in_text(ids: List[int], eos_id: int) -> str:
    """Token ids → text through the stand-in vocabulary: stop at EOS, skip
    the four special ids; id i ≥ 4 is the base-95 digits of i − 4 over
    printable ASCII (chr 32-126), least significant first."""
    out = []
    for t in ids:
        t = int(t)
        if t == eos_id:
            break
        if t < SPECIALS:
            continue
        n = t - SPECIALS
        while True:
            out.append(chr(32 + n % 95))
            n //= 95
            if not n:
                break
    return "".join(out)
