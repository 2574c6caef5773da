"""TrOCR (Li et al., AAAI 2023, arXiv:2109.10282): a ViT encoder over a
line image and a transformer decoder over BPE tokens, with its parameters
named as Hugging Face's ``VisionEncoderDecoderModel`` names them, so that
the published checkpoint loads by name.

Encoder (``"model_type": "vit"``): a stride-``patch`` patch convolution with
bias, a CLS token and learned positions, then pre-LN layers
``x += Attn(LN(x))``, ``x += FC2(GELU(FC1(LN(x))))`` (q, k, v without bias,
the output projection with it, exact GELU, LayerNorm ε 1e-12) and a final
LayerNorm; every token is kept.

Decoder (``"model_type": "trocr"``): unscaled token embeddings plus learned
positions at BART's offset of 2, ``layernorm_embedding``, then post-LN layers
``h = LN(h + SelfAttn_causal(h))``, ``h = LN(h + CrossAttn(h, enc))``,
``h = LN(h + FC2(GELU(FC1(h))))`` (q scaled by head_dim^−½, every projection
with bias, the cross-attention's k and v projected from the encoder's
width, LayerNorm ε 1e-5) and an output projection without bias tied to the
token embedding (``decoder.output_projection.weight`` of a checkpoint is the
same tensor and is not a parameter of its own here).

The decoder runs in two forms: ``forward``, teacher-forced over whole
sequences under a causal mask (the training shape), and the cached step of
``greedy`` and ``beam``: each call projects the encoder's output to every
layer's cross-attention keys and values once (``cross_kv``), and each step
appends one row to every layer's self-attention keys and values. The
self-attention cache is preallocated to ``max_len`` positions, positions
outermost, (steps, layers, 2, rows, d_model), so that the positions written
so far are one contiguous block; after each beam step one ``index_select``
of that block into a second buffer reorders every layer's rows by their
parent beams, and the buffers swap. A line's k beams share its
cross-attention keys and values: their k query rows attend to the line's
keys together, (B, heads, k, head_dim) against (B, heads, T, head_dim), so
the cache is held once a line. The beam bookkeeping is ``models/beam.py``,
shared with TRBA's decoder.

Profiler regions (``utils/profiling.annotate``): ``trocr.encode`` around the
encoder, ``trocr.decode`` around a decode, and inside it ``trocr.cross_kv``
and one ``trocr.step`` a step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate
from .beam import Beam


@dataclass(frozen=True)
class TrOCRConfig:
    """The widths of ``microsoft/trocr-base-handwritten``'s ``config.json``."""

    image_size: int = 384
    patch_size: int = 16
    num_channels: int = 3
    enc_hidden: int = 768
    enc_layers: int = 12
    enc_heads: int = 12
    enc_mlp: int = 3072
    enc_ln_eps: float = 1e-12
    d_model: int = 1024
    dec_layers: int = 12
    dec_heads: int = 16
    dec_ffn: int = 4096
    dec_ln_eps: float = 1e-5
    vocab_size: int = 50265
    max_position_embeddings: int = 512
    position_offset: int = 2
    decoder_start_token_id: int = 2
    bos_token_id: int = 0
    pad_token_id: int = 1
    eos_token_id: int = 2

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_hf(cls, config: dict) -> "TrOCRConfig":
        """From a ``vision-encoder-decoder`` ``config.json`` (its ``encoder``
        and ``decoder`` groups); raises on a variant this model does not
        build."""
        e, d = config["encoder"], config["decoder"]
        built = (("encoder", "qkv_bias", False), ("encoder", "hidden_act", "gelu"),
                 ("decoder", "activation_function", "gelu"), ("decoder", "scale_embedding", False),
                 ("decoder", "layernorm_embedding", True),
                 ("decoder", "use_learned_position_embeddings", True),
                 ("decoder", "cross_attention_hidden_size", e["hidden_size"]))
        for group, key, want in built:
            got = config[group].get(key, want)
            if got != want:
                raise ValueError(f"TrOCR: {group} {key}={got!r} is not built (only {want!r})")
        return cls(
            image_size=e["image_size"], patch_size=e["patch_size"], num_channels=e["num_channels"],
            enc_hidden=e["hidden_size"], enc_layers=e["num_hidden_layers"],
            enc_heads=e["num_attention_heads"], enc_mlp=e["intermediate_size"],
            enc_ln_eps=e["layer_norm_eps"], d_model=d["d_model"], dec_layers=d["decoder_layers"],
            dec_heads=d["decoder_attention_heads"], dec_ffn=d["decoder_ffn_dim"],
            vocab_size=d["vocab_size"], max_position_embeddings=d["max_position_embeddings"],
            decoder_start_token_id=config.get("decoder_start_token_id", d["decoder_start_token_id"]),
            bos_token_id=d["bos_token_id"], pad_token_id=d["pad_token_id"], eos_token_id=d["eos_token_id"],
        )


def _node(**children: nn.Module) -> nn.Module:
    """A module that only names its children (Hugging Face's nesting)."""
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def _vit_layer(c: TrOCRConfig) -> nn.Module:
    d = c.enc_hidden
    return _node(
        layernorm_before=nn.LayerNorm(d, eps=c.enc_ln_eps),
        attention=_node(
            attention=_node(query=nn.Linear(d, d, bias=False), key=nn.Linear(d, d, bias=False),
                            value=nn.Linear(d, d, bias=False)),
            output=_node(dense=nn.Linear(d, d)),
        ),
        layernorm_after=nn.LayerNorm(d, eps=c.enc_ln_eps),
        intermediate=_node(dense=nn.Linear(d, c.enc_mlp)),
        output=_node(dense=nn.Linear(c.enc_mlp, d)),
    )


def _attention(d: int, kv_in: int) -> nn.Module:
    return _node(q_proj=nn.Linear(d, d), k_proj=nn.Linear(kv_in, d), v_proj=nn.Linear(kv_in, d),
                 out_proj=nn.Linear(d, d))


def _decoder_layer(c: TrOCRConfig) -> nn.Module:
    d = c.d_model
    return _node(
        self_attn=_attention(d, d), self_attn_layer_norm=nn.LayerNorm(d, eps=c.dec_ln_eps),
        encoder_attn=_attention(d, c.enc_hidden),
        encoder_attn_layer_norm=nn.LayerNorm(d, eps=c.dec_ln_eps),
        fc1=nn.Linear(d, c.dec_ffn), fc2=nn.Linear(c.dec_ffn, d),
        final_layer_norm=nn.LayerNorm(d, eps=c.dec_ln_eps),
    )


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., T, n·dh) → (..., n, T, dh)."""
    return x.unflatten(-1, (n, -1)).transpose(-3, -2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(..., n, T, dh) → (..., T, n·dh)."""
    return x.transpose(-3, -2).flatten(-2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ + mask) v over the last two dims; q already scaled."""
    s = q @ k.transpose(-1, -2)
    if mask is not None:
        s = s + mask
    return torch.softmax(s, dim=-1) @ v


class TrOCRModel(nn.Module):
    def __init__(self, config: TrOCRConfig = TrOCRConfig()):
        super().__init__()
        c = self.config = config
        embeddings = _node(
            patch_embeddings=_node(projection=nn.Conv2d(c.num_channels, c.enc_hidden, c.patch_size,
                                                        stride=c.patch_size)),
        )
        embeddings.cls_token = nn.Parameter(torch.zeros(1, 1, c.enc_hidden))
        embeddings.position_embeddings = nn.Parameter(torch.zeros(1, c.num_patches + 1, c.enc_hidden))
        self.encoder = _node(
            embeddings=embeddings,
            encoder=_node(layer=nn.ModuleList(_vit_layer(c) for _ in range(c.enc_layers))),
            layernorm=nn.LayerNorm(c.enc_hidden, eps=c.enc_ln_eps),
        )
        self.decoder = _node(model=_node(decoder=_node(
            embed_tokens=nn.Embedding(c.vocab_size, c.d_model),
            embed_positions=nn.Embedding(c.max_position_embeddings + c.position_offset, c.d_model),
            layernorm_embedding=nn.LayerNorm(c.d_model, eps=c.dec_ln_eps),
            layers=nn.ModuleList(_decoder_layer(c) for _ in range(c.dec_layers)),
        )))

    @property
    def _dec(self) -> nn.Module:
        return self.decoder.model.decoder

    # ---- encoder ----

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) normalized → (B, 1 + patches, enc_hidden)."""
        c, e = self.config, self.encoder.embeddings
        p = e.patch_embeddings.projection(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        h = torch.cat([e.cls_token.expand(p.shape[0], -1, -1), p], 1) + e.position_embeddings
        scale = 1.0 / math.sqrt(c.enc_hidden // c.enc_heads)
        for layer in self.encoder.encoder.layer:
            a = layer.attention.attention
            y = layer.layernorm_before(h)
            o = _attend(_heads(a.query(y), c.enc_heads) * scale, _heads(a.key(y), c.enc_heads),
                        _heads(a.value(y), c.enc_heads))
            h = h + layer.attention.output.dense(_merge(o))
            h = h + layer.output.dense(F.gelu(layer.intermediate.dense(layer.layernorm_after(h))))
        return self.encoder.layernorm(h)

    # ---- decoder ----

    def _embed(self, ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        dec = self._dec
        return dec.layernorm_embedding(
            dec.embed_tokens(ids) + dec.embed_positions(positions + self.config.position_offset))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self._dec.embed_tokens.weight.t()

    @staticmethod
    def _ffn(layer: nn.Module, h: torch.Tensor) -> torch.Tensor:
        return layer.final_layer_norm(h + layer.fc2(F.gelu(layer.fc1(h))))

    def forward(self, enc: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (B, T, V) of the decoder fed ``ids`` (B, T)
        (the start token first), under a causal mask."""
        c = self.config
        t = ids.shape[1]
        n = c.dec_heads
        scale = (c.d_model // n) ** -0.5
        h = self._embed(ids, torch.arange(t, device=ids.device))
        mask = torch.full((t, t), float("-inf"), device=ids.device).triu(1)
        for layer in self._dec.layers:
            sa, ca = layer.self_attn, layer.encoder_attn
            o = _attend(_heads(sa.q_proj(h) * scale, n), _heads(sa.k_proj(h), n), _heads(sa.v_proj(h), n),
                        mask)
            h = layer.self_attn_layer_norm(h + sa.out_proj(_merge(o)))
            o = _attend(_heads(ca.q_proj(h) * scale, n), _heads(ca.k_proj(enc), n), _heads(ca.v_proj(enc), n))
            h = layer.encoder_attn_layer_norm(h + ca.out_proj(_merge(o)))
            h = self._ffn(layer, h)
        return self._logits(h)

    def cross_kv(self, enc: torch.Tensor) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """Every layer's cross-attention (keys, values), each (B, heads, T,
        head_dim), from the encoder's output (B, T, enc_hidden)."""
        n = self.config.dec_heads
        with annotate("trocr.cross_kv"):
            return tuple((_heads(layer.encoder_attn.k_proj(enc), n).contiguous(),
                          _heads(layer.encoder_attn.v_proj(enc), n).contiguous())
                         for layer in self._dec.layers)

    def new_cache(self, rows: int, steps: int, like: torch.Tensor) -> torch.Tensor:
        """An empty self-attention cache (steps, layers, 2, rows, d_model)."""
        c = self.config
        return like.new_empty(steps, c.dec_layers, 2, rows, c.d_model)

    def step(self, ids: torch.Tensor, t: int, cache: torch.Tensor, cross, k: int) -> torch.Tensor:
        """One cached decode step at position ``t`` of ``ids`` (B·k,): each
        layer's new keys and values go to ``cache[t]``, and each row attends
        to positions 0..t of its own; the k rows of a line attend to the
        line's ``cross`` keys and values together → logits (B·k, V)."""
        c = self.config
        n, r = c.dec_heads, ids.shape[0]
        b = r // k
        scale = (c.d_model // n) ** -0.5
        h = self._embed(ids, torch.full_like(ids, t))
        for i, layer in enumerate(self._dec.layers):
            sa, ca = layer.self_attn, layer.encoder_attn
            cache[t, i, 0] = sa.k_proj(h)
            cache[t, i, 1] = sa.v_proj(h)
            keys = cache[:t + 1, i, 0].unflatten(-1, (n, -1)).permute(1, 2, 0, 3)  # (R, n, t+1, dh)
            values = cache[:t + 1, i, 1].unflatten(-1, (n, -1)).permute(1, 2, 0, 3)
            q = (sa.q_proj(h) * scale).unflatten(-1, (n, 1, -1))  # (R, n, 1, dh)
            h = layer.self_attn_layer_norm(h + sa.out_proj(_attend(q, keys, values).flatten(1)))
            q = (ca.q_proj(h) * scale).reshape(b, k, n, -1).transpose(1, 2)  # (B, n, k, dh)
            o = _attend(q, *cross[i]).transpose(1, 2).reshape(r, -1)
            h = layer.encoder_attn_layer_norm(h + ca.out_proj(o))
            h = self._ffn(layer, h)
        return self._logits(h)

    def greedy(self, enc: torch.Tensor, max_len: int = 32):
        """enc (B, T, E), in the model's dtype → (logits (B, max_len, V),
        tokens (B, max_len))."""
        with annotate("trocr.decode"):
            b = enc.shape[0]
            cross = self.cross_kv(enc)
            cache = self.new_cache(b, max_len, enc)
            tok = torch.full((b,), self.config.decoder_start_token_id, dtype=torch.int64, device=enc.device)
            all_logits, preds = [], []
            for t in range(max_len):
                with annotate("trocr.step"):
                    logits = self.step(tok, t, cache, cross, 1).float()
                    tok = torch.argmax(logits, dim=-1)
                all_logits.append(logits)
                preds.append(tok)
            return torch.stack(all_logits, 1), torch.stack(preds, 1)

    def beam(self, enc: torch.Tensor, max_len: int = 32, beam_size: int = 4, alpha: float = 0.9,
             temperature: float = 1.0):
        """Batched beam search → (the chosen beams' temperature-scaled logits
        (B, max_len, V), tokens (B, max_len)), ``models/beam.py``'s rules."""
        with annotate("trocr.decode"):
            b, k = enc.shape[0], beam_size
            c = self.config
            cross = self.cross_kv(enc)
            cache, spare = self.new_cache(b * k, max_len, enc), self.new_cache(b * k, max_len, enc)
            beam = Beam(b, k, c.vocab_size, c.decoder_start_token_id, c.eos_token_id, enc.device)
            for t in range(max_len):
                with annotate("trocr.step"):
                    logits = self.step(beam.tok.reshape(b * k), t, cache, cross, k).float()
                    parent = beam.advance(logits, t, alpha, temperature)
                    rows = (beam.rows * k + parent).reshape(-1)
                    torch.index_select(cache[:t + 1], 3, rows, out=spare[:t + 1])
                    cache, spare = spare, cache
            return beam.backtrace()
