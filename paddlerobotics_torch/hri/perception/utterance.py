"""Utterance encoder: BERT/ERNIE-style text transformer, WordPiece
tokenizer and bag-of-words baseline (port of the JAX package's
``hri/perception/utterance.py``).

Produces the 768-d utterance embeddings of the multimodal action table
(collect_act_emb.py:42-54).

- ``ErnieEncoder``: word, position and sentence embeddings, LayerNorm
  (eps 1e-12), then per layer q/k/v projections with bias, masked
  multi-head attention, the output projection, post-LN, the FFN (relu, or
  flax's tanh-form gelu for ``hidden_act="gelu"``), post-LN; the pooler is
  ``tanh(Dense(h[:, 0]))``. The attention goes through
  ``ops.attention.flash_attention`` (the CUDA kernel on the card, its plain
  version on the CPU) with the key-padding mask broadcast to (B, T, S); the
  kernel applies the ``hd^-0.5`` scale after the q·k product, where flax
  scales q before it, which differs by rounding only. A row whose keys are
  all masked gives zeros there where flax averages uniformly; with the
  tokenizer's ids every row keeps its ``[CLS]`` key.
- Submodules carry flax's scope names (``word_emb``, ``LayerNorm_i``,
  ``attn_i.query`` …, ``Dense_i``, ``pooler``); ``convert.ernie_from_flax``
  reshapes flax's ``DenseGeneral`` q/k/v/out kernels onto them.
- The Paddle ``save_params`` codec (``parse_paddle_var``,
  ``load_paddle_params_dir``, ``_encode_paddle_var``) is an own numpy copy;
  ``import_ernie_params`` / ``export_ernie_params`` map the reference
  graph's names onto this module.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.ops import attention
from paddlerobotics_torch.utils.init import flax_default_

LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_len: int = 512
    type_vocab_size: int = 2
    # ERNIE v1 ships hidden_act="relu" in its config json (consumed at
    # ernie_v1.py:57,121); gelu kept selectable for BERT-style configs.
    hidden_act: str = "relu"


class ErnieSelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with bias: ``query``, ``key``,
    ``value`` and ``out`` as (H, H) Linear layers."""

    def __init__(self, hidden: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, nn.Linear(hidden, hidden, device=device))

    def project(self, h: torch.Tensor):
        """h (B,T,H) → q, k, v (B,heads,T,hd), views of the projections."""
        B, T, D = h.shape
        nh = self.num_heads

        def heads(t):
            return t.reshape(B, T, nh, D // nh).transpose(1, 2)

        return heads(self.query(h)), heads(self.key(h)), heads(self.value(h))

    def forward(self, h: torch.Tensor, mask: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
        """h (B,T,H); mask (B,T,S) float 0/1 → (B,T,H)."""
        B, T, D = h.shape
        q, k, v = self.project(h)
        if use_kernel:
            o = attention.flash_attention(q, k, v, mask)
        else:
            o = attention.masked_attention(q, k, v, mask)[0]
        return self.out(o.transpose(1, 2).reshape(B, T, D))


class ErnieEncoder(nn.Module):
    """BERT-style encoder; ``forward`` returns (sequence_output, pooled CLS).
    On the card unless ``device`` says otherwise; ``generator`` draws
    flax-default weights (embeddings normal with std hidden^-1/2)."""

    def __init__(self, cfg: ErnieConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_emb = nn.Embedding(cfg.vocab_size, H, device=device)
        self.pos_emb = nn.Embedding(cfg.max_len, H, device=device)
        self.sent_emb = nn.Embedding(cfg.type_vocab_size, H, device=device)
        for i in range(2 * cfg.num_layers + 1):
            setattr(self, f"LayerNorm_{i}", nn.LayerNorm(H, eps=LN_EPS,
                                                         device=device))
        for i in range(cfg.num_layers):
            setattr(self, f"attn_{i}", ErnieSelfAttention(
                H, cfg.num_heads, device=device))
            setattr(self, f"Dense_{2 * i}", nn.Linear(H, cfg.ffn_size,
                                                      device=device))
            setattr(self, f"Dense_{2 * i + 1}", nn.Linear(cfg.ffn_size, H,
                                                          device=device))
        self.pooler = nn.Linear(H, H, device=device)
        if generator is not None:
            flax_default_(self, generator)
            with torch.no_grad():
                for emb in (self.word_emb, self.pos_emb, self.sent_emb):
                    emb.weight.copy_(torch.randn(
                        emb.weight.shape, generator=generator,
                        device=generator.device) / math.sqrt(H))

    def _act(self, x):
        if self.cfg.hidden_act == "gelu":
            return F.gelu(x, approximate="tanh")
        return torch.relu(x)

    def embed(self, token_ids: torch.Tensor,
              sent_ids: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None):
        """The first layer's input (B,T,H) and the attention mask (B,T,T),
        the key-padding mask broadcast over the queries (a stride-0 view)."""
        B, T = token_ids.shape
        if mask is None:
            mask = (token_ids > 0).to(torch.float32)
        if sent_ids is None:
            sent_ids = torch.zeros_like(token_ids)
        pos_ids = torch.arange(T, device=token_ids.device)[None, :]
        h = (self.word_emb(token_ids) + self.pos_emb(pos_ids)
             + self.sent_emb(sent_ids))
        return (self.LayerNorm_0(h),
                mask.to(torch.float32)[:, None, :].expand(B, T, T))

    def forward(self, token_ids: torch.Tensor,
                sent_ids: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                use_kernel: bool = True):
        """token_ids (B,T) int; mask (B,T) key-padding mask (default
        ``token_ids > 0``) → (h (B,T,H), pooled (B,H)). ``use_kernel``
        False takes the materialized attention (for training: the kernel
        has no backward)."""
        h, mask3 = self.embed(token_ids, sent_ids, mask)
        for i in range(self.cfg.num_layers):
            a = getattr(self, f"attn_{i}")(h, mask3, use_kernel)
            h = getattr(self, f"LayerNorm_{2 * i + 1}")(h + a)
            f = getattr(self, f"Dense_{2 * i}")(h)
            f = getattr(self, f"Dense_{2 * i + 1}")(self._act(f))
            h = getattr(self, f"LayerNorm_{2 * i + 2}")(h + f)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return h, pooled


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece (tokenizer.py:287 semantics)."""

    def __init__(self, vocab: dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk = unk_token
        self.max_chars = max_chars_per_word

    def tokenize_word(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            out.append(cur)
            start = end
        return out

    def encode(self, text: str, max_len: int = 64) -> np.ndarray:
        # CJK-aware split: each CJK char is its own word
        words: List[str] = []
        buf = ""
        for ch in text.lower():
            if "一" <= ch <= "鿿":
                if buf:
                    words.append(buf)
                    buf = ""
                words.append(ch)
            elif ch.isspace():
                if buf:
                    words.append(buf)
                    buf = ""
            else:
                buf += ch
        if buf:
            words.append(buf)
        toks = ["[CLS]"]
        for w in words:
            toks.extend(self.tokenize_word(w))
        toks.append("[SEP]")
        ids = [self.vocab.get(t, self.vocab.get(self.unk, 0))
               for t in toks][:max_len]
        ids = ids + [0] * (max_len - len(ids))
        return np.asarray(ids, np.int32)


class BoWEncoder(nn.Module):
    """Bag-of-words baseline (bow.py:19): mean of the word embeddings of
    the non-padding tokens. On the card unless ``device`` says otherwise."""

    def __init__(self, vocab_size: int, dim: int = 768, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.Embed_0 = nn.Embedding(vocab_size, dim, device=device)
        if generator is not None:
            with torch.no_grad():
                self.Embed_0.weight.copy_(torch.randn(
                    (vocab_size, dim), generator=generator,
                    device=generator.device) / math.sqrt(dim))

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        emb = self.Embed_0(token_ids)
        mask = (token_ids > 0).to(torch.float32)[..., None]
        return torch.sum(emb * mask, dim=-2) / torch.clamp(
            torch.sum(mask, dim=-2), min=1.0)


class UtteranceEncoder:
    """Eval wrapper (utterance/eval.py:11): text → 768-d embedding, on the
    card unless ``device`` says otherwise."""

    def __init__(self, vocab: dict[str, int] | None = None,
                 cfg: ErnieConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or ErnieConfig()
        vocab = vocab or {"[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
        self.tokenizer = WordPieceTokenizer(vocab)
        self.model: Optional[ErnieEncoder] = None

    def init(self, generator: torch.Generator) -> ErnieEncoder:
        """Seeded weights from ``generator`` (on the encoder's device)."""
        self.model = ErnieEncoder(self.cfg, device=self.device,
                                  generator=generator)
        return self.model

    def token_ids(self, texts: List[str], max_len: int = 64) -> torch.Tensor:
        return torch.as_tensor(np.stack([
            self.tokenizer.encode(t, max_len) for t in texts]),
            dtype=torch.int64, device=self.device)

    @torch.no_grad()
    def encode(self, texts: List[str], max_len: int = 64) -> torch.Tensor:
        """(len(texts), hidden) pooled embeddings, on the encoder's device."""
        _, pooled = self.model(self.token_ids(texts, max_len))
        return pooled


# --- pretrained-weight import (ERNIE save_params dir) ------------------------

_PADDLE_FP32 = 5  # paddle framework.proto VarType.Type.FP32


def parse_paddle_var(data: bytes) -> np.ndarray:
    """Decode one fluid `save_params` variable file (LoDTensor binary:
    uint32 version | uint64 lod-level count + levels | uint32 tensor
    version | int32 desc size | TensorDesc proto {data_type=1 varint,
    dims=2 int64} | raw row-major data). Raises loudly on anything but
    FP32."""
    pos = 0

    def u32():
        nonlocal pos
        v = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        return v

    def u64():
        nonlocal pos
        v = int.from_bytes(data[pos:pos + 8], "little")
        pos += 8
        return v

    if u32() != 0:
        raise ValueError("unsupported LoDTensor version")
    for _ in range(u64()):                  # skip LoD levels
        pos += u64()
    if u32() != 0:
        raise ValueError("unsupported tensor version")
    desc_size = u32()
    desc = data[pos:pos + desc_size]
    pos += desc_size

    dtype, dims = None, []
    dpos = 0

    def varint():
        nonlocal dpos
        v, shift = 0, 0
        while True:
            b = desc[dpos]
            dpos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    while dpos < len(desc):
        tag = desc[dpos]
        dpos += 1
        field, wire = tag >> 3, tag & 7
        if wire == 0:                        # varint
            v = varint()
            if field == 1:
                dtype = v
            elif field == 2:
                dims.append(v)
        elif wire == 2:                      # packed dims
            n = desc[dpos]
            dpos += 1
            end = dpos + n
            while dpos < end:
                v = varint()
                if field == 2:
                    dims.append(v)
        else:
            raise ValueError(f"unexpected wire type {wire} in TensorDesc")
    if dtype != _PADDLE_FP32:
        raise ValueError(f"unsupported paddle dtype {dtype}")
    n = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(data, np.float32, count=n, offset=pos).copy()
    return arr.reshape(dims)


def load_paddle_params_dir(path: str) -> dict:
    """`fluid.io.save_params` directory (one binary file per variable,
    filename = variable name — the layout init_pretraining_params
    consumes) → ordered {name: ndarray}."""
    out = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if os.path.isfile(full):
            with open(full, "rb") as f:
                out[name] = parse_paddle_var(f.read())
    return out


def _encode_paddle_var(arr: np.ndarray) -> bytes:
    """Inverse of `parse_paddle_var` (round-trip fixtures)."""
    arr = np.ascontiguousarray(arr, np.float32)
    desc = bytes([0x08, _PADDLE_FP32])                     # data_type
    for d in arr.shape:
        dim = bytearray([0x10])                            # field 2 varint
        v = int(d)
        while True:
            b = v & 0x7F
            v >>= 7
            dim.append(b | 0x80 if v else b)
            if not v:
                break
        desc += bytes(dim)
    return ((0).to_bytes(4, "little") + (0).to_bytes(8, "little") +
            (0).to_bytes(4, "little") +
            len(desc).to_bytes(4, "little") + desc + arr.tobytes())


def _paddle_names(cfg: ErnieConfig):
    """(paddle name, module parameter name, transposed) for every weight of
    the reference graph (ernie_v1.py:77-141, transformer.py:53-293): paddle
    fc weights are (in, out), Linear weights (out, in)."""
    out = [("word_embedding", "word_emb.weight", False),
           ("pos_embedding", "pos_emb.weight", False),
           ("sent_embedding", "sent_emb.weight", False),
           ("pre_encoder_layer_norm_scale", "LayerNorm_0.weight", False),
           ("pre_encoder_layer_norm_bias", "LayerNorm_0.bias", False),
           ("pooled_fc.w_0", "pooler.weight", True),
           ("pooled_fc.b_0", "pooler.bias", False)]
    for i in range(cfg.num_layers):
        att = f"encoder_layer_{i}_multi_head_att"
        for proj, mod in (("query", "query"), ("key", "key"),
                          ("value", "value"), ("output", "out")):
            out += [(f"{att}_{proj}_fc.w_0", f"attn_{i}.{mod}.weight", True),
                    (f"{att}_{proj}_fc.b_0", f"attn_{i}.{mod}.bias", False)]
        for tag, idx in (("post_att", 2 * i + 1), ("post_ffn", 2 * i + 2)):
            out += [(f"encoder_layer_{i}_{tag}_layer_norm_scale",
                     f"LayerNorm_{idx}.weight", False),
                    (f"encoder_layer_{i}_{tag}_layer_norm_bias",
                     f"LayerNorm_{idx}.bias", False)]
        for fc, idx in (("fc_0", 2 * i), ("fc_1", 2 * i + 1)):
            out += [(f"encoder_layer_{i}_ffn_{fc}.w_0",
                     f"Dense_{idx}.weight", True),
                    (f"encoder_layer_{i}_ffn_{fc}.b_0",
                     f"Dense_{idx}.bias", False)]
    return out


def import_ernie_params(named, cfg: ErnieConfig,
                        device=None) -> ErnieEncoder:
    """Pretrained ERNIE v1 params → the port's ``ErnieEncoder``, on the card
    unless ``device`` says otherwise.

    `named`: {paddle_param_name: ndarray} from `load_paddle_params_dir`.
    Names follow the reference graph exactly: word/pos/sent_embedding and
    the pre_encoder layer norm, encoder_layer_{i}_multi_head_att_{query,
    key,value,output}_fc.{w,b}_0, the _post_att/_post_ffn layer norms,
    _ffn_fc_{0,1}, and pooled_fc."""
    model = ErnieEncoder(cfg, device=device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for pname, mname, transposed in _paddle_names(cfg):
            if pname not in named:
                raise KeyError(f"missing param {pname!r}; have e.g. "
                               f"{list(named)[:4]}")
            a = np.asarray(named[pname], np.float32)
            a = a.T if transposed else a
            t = params[mname]
            if tuple(t.shape) != a.shape:
                raise ValueError(f"{pname}: shape {a.shape}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.as_tensor(np.ascontiguousarray(a)))
    return model


def export_ernie_params(model: ErnieEncoder) -> dict:
    """Inverse of `import_ernie_params` (the port's module → paddle-named
    numpy arrays)."""
    params = dict(model.named_parameters())
    out = {}
    for pname, mname, transposed in _paddle_names(model.cfg):
        a = params[mname].detach().cpu().numpy()
        out[pname] = np.ascontiguousarray(a.T if transposed else a)
    return out
