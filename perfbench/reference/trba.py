"""Plain reference of the TRBA recognizer, in float32 torch operations.

Written from the architecture (olegiy/manuscript-ocr v0.1.8's TRBA as the
port documents it): SEResNet31 with eval-mode BatchNorm and squeeze-excite
blocks, the mean over height, two bidirectional LSTMs with output
projections, and the additive-attention LSTM decoder with
temperature-scaled logits. It works on a dict of weights
named as the port's ``TRBAModel.state_dict()`` names them, imports nothing
of the port, and runs with TF32 off (the caller's ``plain_float32``).

The decoder runs teacher-forced along given tokens, which gives the logits
that a beam search computed along the path it chose; ``beam_search`` runs
the configuration's beam search itself, which gives the best path's score
that the chosen path is held against.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..counts import SERESNET31_PLANS, SERESNET31_STEM

W = Dict[str, torch.Tensor]


def layout(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of every weight of the configuration."""
    plan, out_ch = cfg["cnn_stage_plan"], cfg["cnn_out_channels"]
    hid, vocab = cfg["hidden_size"], cfg["num_classes"]
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, *k)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (c,)

    s1, s2 = SERESNET31_STEM.get(plan, (64, 128))
    conv("cnn.stem_conv1", 3, s1, (3, 3)); bn("cnn.stem_bn1", s1)
    conv("cnn.stem_conv2", s1, s2, (3, 3)); bn("cnn.stem_bn2", s2)
    cin = s2
    for stage, (planes, blocks, stride) in enumerate(SERESNET31_PLANS[plan], 1):
        for b in range(blocks):
            p = f"cnn.layer{stage}_{b}"
            conv(f"{p}.conv1", cin, planes, (3, 3)); bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, (3, 3)); bn(f"{p}.bn2", planes)
            out[f"{p}.se.fc1.weight"] = (planes // 16, planes)
            out[f"{p}.se.fc2.weight"] = (planes, planes // 16)
            if b == 0 and (stride != 1 or cin != planes):
                conv(f"{p}.down_conv", cin, planes, (1, 1)); bn(f"{p}.down_bn", planes)
            cin = planes
    conv("cnn.out_conv1", cin, out_ch, (2, 2)); bn("cnn.out_bn1", out_ch)
    conv("cnn.out_conv2", out_ch, out_ch, (2, 2)); bn("cnn.out_bn2", out_ch)
    for name, i in (("enc_rnn1", out_ch), ("enc_rnn2", hid)):
        for d in ("fwd", "bwd"):
            out[f"{name}.{d}_kernel_ih"] = (i, 4 * hid)
            out[f"{name}.{d}_kernel_hh"] = (hid, 4 * hid)
            out[f"{name}.{d}_bias"] = (4 * hid,)
        out[f"{name}.proj.weight"] = (hid, 2 * hid)
        out[f"{name}.proj.bias"] = (hid,)
    d = "decoder"
    out.update({
        f"{d}.i2h_kernel": (hid, hid), f"{d}.h2h_kernel": (hid, hid), f"{d}.h2h_bias": (hid,),
        f"{d}.score_kernel": (hid, 1), f"{d}.lstm_kernel_ih": (hid + vocab, 4 * hid),
        f"{d}.lstm_kernel_hh": (hid, 4 * hid), f"{d}.lstm_bias": (4 * hid,),
        f"{d}.gen_kernel": (hid, vocab), f"{d}.gen_bias": (vocab,),
    })
    return out


def _bn(w: W, name: str, x):
    return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"],
                        w[f"{name}.weight"], w[f"{name}.bias"], False, 0.0, 1e-5)


def _block(w: W, p: str, x, stride: int, down: bool):
    out = F.relu(_bn(w, f"{p}.bn1", F.conv2d(x, w[f"{p}.conv1.weight"], stride=stride, padding=1)))
    out = _bn(w, f"{p}.bn2", F.conv2d(out, w[f"{p}.conv2.weight"], padding=1))
    se = torch.sigmoid(F.relu(out.mean(dim=(2, 3)) @ w[f"{p}.se.fc1.weight"].T)
                       @ w[f"{p}.se.fc2.weight"].T)
    out = out * se[:, :, None, None]
    idt = _bn(w, f"{p}.down_bn", F.conv2d(x, w[f"{p}.down_conv.weight"], stride=stride)) if down else x
    return F.relu(out + idt)


def _lstm(x, k_ih, k_hh, bias, reverse: bool):
    b, t, _ = x.shape
    hid = k_hh.shape[0]
    xp = x @ k_ih + bias
    h = x.new_zeros(b, hid)
    c = x.new_zeros(b, hid)
    out = [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        z = xp[:, s] + h @ k_hh
        i, f, g, o = z.split(hid, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[s] = h
    return torch.stack(out, 1)


def _bilstm(w: W, name: str, x):
    fwd = _lstm(x, w[f"{name}.fwd_kernel_ih"], w[f"{name}.fwd_kernel_hh"], w[f"{name}.fwd_bias"], False)
    bwd = _lstm(x, w[f"{name}.bwd_kernel_ih"], w[f"{name}.bwd_kernel_hh"], w[f"{name}.bwd_bias"], True)
    return torch.cat([fwd, bwd], -1) @ w[f"{name}.proj.weight"].T + w[f"{name}.proj.bias"]


def encode(w: W, cfg: Dict, strips_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 strips → encoder memory (B, T, hidden)."""
    x = (strips_u8.float() / 255.0 - 0.5) / 0.5
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_bn(w, "cnn.stem_bn1", F.conv2d(x, w["cnn.stem_conv1.weight"], padding=1)))
    x = F.relu(_bn(w, "cnn.stem_bn2", F.conv2d(x, w["cnn.stem_conv2.weight"], padding=1)))
    x = F.max_pool2d(x, 2, 2)
    cin = x.shape[1]
    for stage, (planes, blocks, stride) in enumerate(SERESNET31_PLANS[cfg["cnn_stage_plan"]], 1):
        for b in range(blocks):
            st = stride if b == 0 else 1
            x = _block(w, f"cnn.layer{stage}_{b}", x, st, b == 0 and (st != 1 or cin != planes))
            cin = planes
    x = F.relu(_bn(w, "cnn.out_bn1", F.conv2d(x, w["cnn.out_conv1.weight"], stride=(2, 1), padding=(0, 1))))
    x = F.relu(_bn(w, "cnn.out_bn2", F.conv2d(x, w["cnn.out_conv2.weight"])))
    f = x.mean(dim=2).transpose(1, 2)  # (B, T, C)
    return _bilstm(w, "enc_rnn2", _bilstm(w, "enc_rnn1", f))


def _step(w: W, enc, proj_enc, h, c, tok):
    """One attention + LSTM step over rows that each have their own memory."""
    d = "decoder"
    hid = h.shape[1]
    e_dim = enc.shape[2]
    proj_h = h @ w[f"{d}.h2h_kernel"] + w[f"{d}.h2h_bias"]
    e = torch.tanh(proj_enc + proj_h[:, None, :]) @ w[f"{d}.score_kernel"]
    alpha = torch.softmax(e, dim=1)
    ctx = (alpha * enc).sum(1)
    k_ih = w[f"{d}.lstm_kernel_ih"]
    z = ctx @ k_ih[:e_dim] + k_ih[e_dim + tok] + h @ w[f"{d}.lstm_kernel_hh"] + w[f"{d}.lstm_bias"]
    i, f, g, o = z.split(hid, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _logits(w: W, h):
    return h @ w["decoder.gen_kernel"] + w["decoder.gen_bias"]


def forced_log_probs(w: W, cfg: Dict, enc: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-softmax of the temperature-scaled logits (B, steps, V) along
    ``tokens`` (B, steps): step 0 reads SOS, step t the token of step t − 1."""
    b, steps = tokens.shape
    hid = cfg["hidden_size"]
    proj_enc = enc @ w["decoder.i2h_kernel"]
    h = enc.new_zeros(b, hid)
    c = enc.new_zeros(b, hid)
    tok = torch.full((b,), cfg["sos_id"], dtype=torch.long, device=enc.device)
    out = []
    for t in range(steps):
        h, c = _step(w, enc, proj_enc, h, c, tok)
        out.append(torch.log_softmax(_logits(w, h) / cfg["temperature"], -1))
        tok = tokens[:, t].long()
    return torch.stack(out, 1)


def beam_search(w: W, cfg: Dict, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The configuration's beam search (``beam_size``, ``alpha``,
    ``temperature``, ``max_length`` steps) → (each row's best score (B,),
    its tokens (B, steps)). A beam's score is the sum of its tokens'
    log-probabilities at the temperature; a beam that has emitted EOS
    continues only with EOS, at log-probability 0. Each step keeps the
    ``beam_size`` best of beams × tokens by score over the GNMT length
    penalty ((5 + t + 1) / 6)^α, ties to the lowest index."""
    b, k, v = enc.shape[0], cfg["beam_size"], cfg["num_classes"]
    hid, eos = cfg["hidden_size"], cfg["eos_id"]
    rows = torch.arange(b, device=enc.device)[:, None]
    enc_k = enc.repeat_interleave(k, 0)  # each beam reads its word's memory
    proj_enc = enc_k @ w["decoder.i2h_kernel"]
    h = enc.new_zeros(b * k, hid)
    c = enc.new_zeros(b * k, hid)
    tok = torch.full((b, k), cfg["sos_id"], dtype=torch.long, device=enc.device)
    scores = torch.full((b, k), float("-inf"), device=enc.device)
    scores[:, 0] = 0.0
    done = torch.zeros(b, k, dtype=torch.bool, device=enc.device)
    only_eos = torch.full((v,), float("-inf"), device=enc.device)
    only_eos[eos] = 0.0
    history = []
    for t in range(cfg["max_length"]):
        h, c = _step(w, enc_k, proj_enc, h, c, tok.reshape(-1))
        lp = torch.log_softmax(_logits(w, h) / cfg["temperature"], -1).reshape(b, k, v)
        lp = torch.where(done[..., None], only_eos, lp)
        penalty = ((5.0 + t + 1) / 6.0) ** cfg["alpha"]
        cand = (scores[..., None] + lp).reshape(b, k * v) / penalty
        top, idx = torch.sort(cand, dim=1, descending=True, stable=True)
        parent, tok = idx[:, :k] // v, idx[:, :k] % v
        scores = top[:, :k] * penalty
        pick = (rows * k + parent).reshape(-1)
        h, c = h[pick], c[pick]
        done = done.gather(1, parent) | (tok == eos)
        history.append((tok, parent))
    best, beam = scores.max(1)
    out = []
    for tok_t, parent_t in reversed(history):
        out.append(tok_t[rows[:, 0], beam])
        beam = parent_t[rows[:, 0], beam]
    return best, torch.stack(out[::-1], 1)


def path_log_prob(lp: torch.Tensor, tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Each row's score as the beam search counts it: the sum of its tokens'
    log-probabilities up to and including the first EOS."""
    steps = tokens.shape[1]
    tok_lp = lp.gather(-1, tokens.long()[..., None])[..., 0]
    is_eos = tokens == eos_id
    first = torch.where(is_eos.any(1), is_eos.int().argmax(1) + 1, torch.full_like(tokens[:, 0], steps))
    mask = torch.arange(steps, device=tokens.device)[None] < first[:, None]
    return (tok_lp * mask).sum(1)


def path_confidence(lp: torch.Tensor, tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Each row's confidence: the mean probability of its tokens up to and
    including the first EOS."""
    steps = tokens.shape[1]
    tok_lp = lp.gather(-1, tokens.long()[..., None])[..., 0]
    is_eos = tokens == eos_id
    first = torch.where(is_eos.any(1), is_eos.int().argmax(1) + 1, torch.full_like(tokens[:, 0], steps))
    mask = torch.arange(steps, device=tokens.device)[None] < first[:, None]
    conf = (tok_lp.exp() * mask).sum(1) / first.clamp_min(1)
    return conf.clamp(0.0, 1.0)


def decode_text(ids, itos, pad_id: int, eos_id: int) -> str:
    """Token ids → text: stop at EOS, skip PAD."""
    out = []
    for t in ids:
        t = int(t)
        if t == eos_id:
            break
        if t != pad_id:
            out.append(itos[t])
    return "".join(out)
