"""A GPT-style decoder in pure-function form for the generative engine
(counterpart of ``mxnet_tpu/serving/decode/model.py``).

The model is a spec plus pure functions over a flat ``{name: tensor}``
dict with the JAX package's names and shapes, so hot swap is "same
spec, new dict" and weights carry across by name
(:func:`~.convert.params_from_numpy`):

- :meth:`TinyGPT.full_logits` -- the full causal forward (pre-LN
  blocks, tanh-GELU MLP, learned positions, tied unembedding); the
  oracle :meth:`TinyGPT.reference_decode` loops over it.
- :meth:`TinyGPT.prefill_kv` -- the same forward, also returning every
  layer's per-position K/V for the engine to write into cache blocks.
- :meth:`TinyGPT.decode_logits` -- one token per slot: project q/k/v,
  write the new K/V into the paged cache IN PLACE, attend over the
  cache through ``kernels.paged_attention``.

Everything accumulates in fp32 and decodes greedily.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...base import MXNetError
from ...context import resolve_device

__all__ = ["TinyGPT", "tiny_gpt"]

_NEG_INF = -1e30


class TinyGPT:
    """Decoder-only transformer spec: geometry + pure functions.
    Parameters live outside the object, in the dict that
    :meth:`init_params` returns."""

    def __init__(self, vocab_size=128, units=32, num_layers=2,
                 num_heads=2, max_seq=64, ffn_mult=4):
        if units % num_heads:
            raise MXNetError("TinyGPT: units %d not divisible by heads "
                             "%d" % (units, num_heads))
        self.vocab_size = int(vocab_size)
        self.units = int(units)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = self.units // self.num_heads
        self.max_seq = int(max_seq)
        self.ffn = int(ffn_mult) * self.units
        self.scale = 1.0 / math.sqrt(self.head_dim)

    # -- params ---------------------------------------------------------
    def init_params(self, seed=0, device=None, dtype=torch.float32):
        """Flat name->tensor dict (embedding tied to the unembedding),
        drawn from a ``torch.Generator`` seeded with ``seed`` on the
        CPU, then moved to ``device`` (CUDA unless ``"cpu"``)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        u, f = self.units, self.ffn

        def nrm(shape, scale):
            return torch.randn(shape, generator=gen) * scale

        def ones(n):
            return torch.ones(n)

        def zeros(n):
            return torch.zeros(n)

        p = {"embed": nrm((self.vocab_size, u), 0.08),
             "pos_embed": nrm((self.max_seq, u), 0.02)}
        for i in range(self.num_layers):
            pre = "h%d_" % i
            p[pre + "ln1_g"] = ones(u)
            p[pre + "ln1_b"] = zeros(u)
            p[pre + "wqkv"] = nrm((u, 3 * u), 0.08)
            p[pre + "wo"] = nrm((u, u), 0.08)
            p[pre + "ln2_g"] = ones(u)
            p[pre + "ln2_b"] = zeros(u)
            p[pre + "w1"] = nrm((u, f), 0.08)
            p[pre + "b1"] = zeros(f)
            p[pre + "w2"] = nrm((f, u), 0.08)
            p[pre + "b2"] = zeros(u)
        p["lnf_g"] = ones(u)
        p["lnf_b"] = zeros(u)
        return {k: v.to(device=dev, dtype=dtype) for k, v in p.items()}

    # -- shared pieces --------------------------------------------------
    def _ln(self, x, g, b):
        # biased variance, eps 1e-5: the JAX package's _ln
        return F.layer_norm(x, (self.units,), g, b, eps=1e-5)

    def _mlp(self, p, pre, x):
        h = F.gelu(x @ p[pre + "w1"] + p[pre + "b1"], approximate="tanh")
        return h @ p[pre + "w2"] + p[pre + "b2"]

    def _split_heads(self, t):
        # (..., units) -> (..., heads, head_dim)
        return t.reshape(t.shape[:-1] + (self.num_heads, self.head_dim))

    # -- full causal forward (reference + prefill) ----------------------
    def _forward(self, params, tokens, collect_kv):
        b, t = tokens.shape
        tokens = tokens.long()
        x = params["embed"][tokens] + params["pos_embed"][:t][None]
        causal = torch.ones((t, t), dtype=torch.bool,
                            device=x.device).tril()
        kvs = []
        for i in range(self.num_layers):
            pre = "h%d_" % i
            h = self._ln(x, params[pre + "ln1_g"], params[pre + "ln1_b"])
            q, k, v = (h @ params[pre + "wqkv"]).chunk(3, dim=-1)
            q = self._split_heads(q)               # (b, t, H, D)
            k = self._split_heads(k)
            v = self._split_heads(v)
            if collect_kv:
                kvs.append((k, v))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
            s = s.masked_fill(~causal, _NEG_INF)
            w = torch.exp(s - s.amax(dim=-1, keepdim=True))
            w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
            att = torch.einsum("bhqk,bkhd->bqhd", w, v)
            x = x + att.reshape(b, t, self.units) @ params[pre + "wo"]
            h2 = self._ln(x, params[pre + "ln2_g"], params[pre + "ln2_b"])
            x = x + self._mlp(params, pre, h2)
        x = self._ln(x, params["lnf_g"], params["lnf_b"])
        logits = x @ params["embed"].T             # tied unembedding
        return (logits, kvs) if collect_kv else logits

    def full_logits(self, params, tokens):
        """Reference causal forward: tokens (b, t) int -> logits
        (b, t, vocab)."""
        return self._forward(params, tokens, collect_kv=False)

    def prefill_kv(self, params, tokens):
        """tokens (1, t) -> (logits (1, t, vocab), keys, values) with
        keys/values stacked per layer: (layers, t, heads, head_dim)."""
        logits, kvs = self._forward(params, tokens, collect_kv=True)
        ks = torch.stack([k[0] for k, _v in kvs])  # (L, t, H, D)
        vs = torch.stack([v[0] for _k, v in kvs])
        return logits, ks, vs

    # -- decode step over the paged cache -------------------------------
    def decode_logits(self, params, kv_keys, kv_values, token_ids,
                      positions, block_tables, block_size):
        """One decode step for a slot batch.

        token_ids (s,) int; positions (s,) int (where each new token is
        written, = its context length - 1); kv slabs (layers,
        num_blocks, block_size, heads, head_dim); block_tables (s,
        max_blocks) int32.  Returns (next_token (s,) int64, logits
        (s, vocab), kv_keys, kv_values).  The slabs are updated in
        place (the JAX package returns new ones) and returned as they
        are, so one pair of slabs serves every step.
        """
        from ...kernels.paged_attention import paged_attention
        s = token_ids.shape[0]
        positions = positions.long()
        blk = block_tables.gather(1, (positions // block_size)[:, None])
        blk = blk[:, 0].long()                      # (s,)
        off = positions % block_size
        ctx = (positions + 1).to(torch.int32).reshape(s, 1)
        x = params["embed"][token_ids.long()] + params["pos_embed"][positions]
        for i in range(self.num_layers):
            pre = "h%d_" % i
            h = self._ln(x, params[pre + "ln1_g"], params[pre + "ln1_b"])
            q, k, v = (h @ params[pre + "wqkv"]).chunk(3, dim=-1)
            q = self._split_heads(q).contiguous()   # (s, H, D)
            # the new token's K/V go to their cache position; padded
            # slots carry all-scratch tables, so theirs land in the
            # scratch block
            kv_keys[i, blk, off] = self._split_heads(k).to(kv_keys.dtype)
            kv_values[i, blk, off] = self._split_heads(v).to(
                kv_values.dtype)
            att = paged_attention(q, kv_keys[i], kv_values[i],
                                  block_tables, ctx, scale=self.scale)
            att = att.reshape(s, self.units).to(x.dtype)
            x = x + att @ params[pre + "wo"]
            h2 = self._ln(x, params[pre + "ln2_g"], params[pre + "ln2_b"])
            x = x + self._mlp(params, pre, h2)
        x = self._ln(x, params["lnf_g"], params["lnf_b"])
        logits = x @ params["embed"].T
        return logits.argmax(dim=-1), logits, kv_keys, kv_values

    # -- single-shot oracle ---------------------------------------------
    def reference_decode(self, params, prompt, max_new_tokens,
                         eos_id=None):
        """Greedy decode with one FULL forward per token and no cache:
        the oracle the engine's tokens are held against."""
        dev = params["embed"].device
        tokens = [int(t) for t in prompt]
        out = []
        for _ in range(int(max_new_tokens)):
            logits = self.full_logits(
                params, torch.tensor([tokens], device=dev))
            nxt = int(logits[0, -1].argmax())
            out.append(nxt)
            tokens.append(nxt)
            if eos_id is not None and nxt == eos_id:
                break
        return out

    def __repr__(self):
        return ("TinyGPT(vocab=%d, units=%d, layers=%d, heads=%d, "
                "max_seq=%d)" % (self.vocab_size, self.units,
                                 self.num_layers, self.num_heads,
                                 self.max_seq))


def tiny_gpt(vocab_size=128, units=32, num_layers=2, num_heads=2,
             max_seq=64):
    """A GPT-style decoder of the given widths (GPT-2 small is
    ``tiny_gpt(50257, 768, 12, 12, 1024)``)."""
    return TinyGPT(vocab_size=vocab_size, units=units,
                   num_layers=num_layers, num_heads=num_heads,
                   max_seq=max_seq)
