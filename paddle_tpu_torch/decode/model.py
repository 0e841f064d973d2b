"""Decoder-only transformer LM for the decode plane (PyTorch).

The port of ``paddle_tpu/decode/model.py``.  One ``nn.Module`` holds the
weights as ``nn.Parameter``s; three methods share its layer math:

- :meth:`TransformerLM.full_logits` — ``tokens [B, T] → logits
  [B, T, V]``, plain causal attention over the whole prefix (the
  re-forward baseline and the parity anchor).
- :meth:`TransformerLM.prefill` — padded prompt ``[1, Tb]`` → first
  sampled token + last-position logits, with every real position's K/V
  written into the request's cache blocks (padded positions go to the
  reserved trash block 0).
- :meth:`TransformerLM.decode_step` — the continuous-batching hot
  dispatch: ``[S]`` last tokens at ``[S]`` positions, K/V appended to
  the cache, attention through
  :func:`paddle_tpu_torch.kernels.attention.decode_attention` (the CUDA
  kernel on the card), next token sampled on the device.

The cache pools are updated IN PLACE — the port's stand-in for the
reference's donated state — so prefill and decode_step return only
``(token(s), logits)``.  The layer math (post-LN residuals, sinusoidal
positions, sqrt(D) embed scale) and the sampler (counter-hash
Gumbel-max under ``TOPK_MAX``) are the reference's, operation for
operation, so the same weights give the same tokens.

Persistence: :func:`save_lm` / :func:`load_lm` read and write the
reference's model dir (``decode_config.json`` + ``params.npz``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..kernels._hash import finalize, mul32, u32
from ..kernels.attention import decode_attention
from ..kernels.quant import QMAX, SCALE_EPS, kv_head_amax, kv_quantize
from ..platform import get_device

_LN_EPS = 1e-5
NEG_INF = -1e30
# top-k ceiling of the sampling epilogue: per-slot k varies at runtime
# under it (a fixed shape, as in the reference)
TOPK_MAX = 64

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Geometry of a decoder-only TransformerLM."""

    vocab: int
    d_model: int = 64
    n_head: int = 4
    d_ffn: int = 128
    n_layer: int = 2
    max_seq_len: int = 128
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LMConfig":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


def _pos_table(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal positions (models/transformer.py `_pos_encoding_table`)."""
    pos = np.arange(max_len)[:, None].astype("float64")
    dim = np.arange(d_model // 2)[None, :].astype("float64")
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    table = np.zeros((max_len, d_model))
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table.astype("float32")


_LAYER_PARAMS = ("wq", "wk", "wv", "wo", "ln1.g", "ln1.b",
                 "fc1", "fc2", "ln2.g", "ln2.b")


def _param_names(cfg: LMConfig) -> List[str]:
    names = ["emb"]
    for i in range(cfg.n_layer):
        names += [f"l{i}.{n}" for n in _LAYER_PARAMS]
    names.append("out_proj")
    return names


def _frozen(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class _Layer(nn.Module):
    """One decoder layer's weights (``l{i}.*`` in the reference's
    names: ``ln1.g`` is ``ln1_g`` here, module attributes take no
    dots)."""

    def __init__(self, d: int, f: int):
        super().__init__()
        for n in ("wq", "wk", "wv", "wo"):
            setattr(self, n, _frozen((d, d)))
        self.ln1_g, self.ln1_b = _frozen((d,)), _frozen((d,))
        self.fc1, self.fc2 = _frozen((d, f)), _frozen((f, d))
        self.ln2_g, self.ln2_b = _frozen((d,)), _frozen((d,))


class TransformerLM(nn.Module):
    """One decoder-only LM: its weights plus the three functions
    (module doc).  Built on ``device`` (``cuda:0`` by default; the CPU
    only when asked for)."""

    def __init__(self, config: LMConfig, device: Device = None):
        super().__init__()
        self.config = config
        self.device = get_device(device)
        D, F, V = config.d_model, config.d_ffn, config.vocab
        self.emb = _frozen((V, D))
        self.layers = nn.ModuleList(_Layer(D, F)
                                    for _ in range(config.n_layer))
        self.out_proj = _frozen((D, V))
        self.register_buffer(
            "pos", torch.from_numpy(_pos_table(config.max_seq_len, D)),
            persistent=False)
        self.to(self.device)

    # -- parameters --------------------------------------------------------
    def init_params(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """The reference's seeded init (same numpy draws, so the same
        weights); loads them and returns the name → array dict."""
        cfg = self.config
        rng = np.random.RandomState(seed)
        D, F, V = cfg.d_model, cfg.d_ffn, cfg.vocab

        def mat(m, n, scale=None):
            s = scale if scale is not None else (1.0 / np.sqrt(m))
            return (rng.randn(m, n) * s).astype("float32")

        p = {"emb": mat(V, D, scale=D ** -0.5), "out_proj": mat(D, V)}
        for i in range(cfg.n_layer):
            p[f"l{i}.wq"] = mat(D, D)
            p[f"l{i}.wk"] = mat(D, D)
            p[f"l{i}.wv"] = mat(D, D)
            p[f"l{i}.wo"] = mat(D, D)
            p[f"l{i}.ln1.g"] = np.ones((D,), "float32")
            p[f"l{i}.ln1.b"] = np.zeros((D,), "float32")
            p[f"l{i}.fc1"] = mat(D, F)
            p[f"l{i}.fc2"] = mat(F, D)
            p[f"l{i}.ln2.g"] = np.ones((D,), "float32")
            p[f"l{i}.ln2.b"] = np.zeros((D,), "float32")
        self.load_numpy(p)
        return p

    def _param(self, name: str) -> nn.Parameter:
        if name in ("emb", "out_proj"):
            return getattr(self, name)
        layer, rest = name.split(".", 1)
        return getattr(self.layers[int(layer[1:])], rest.replace(".", "_"))

    def load_numpy(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a reference-named weight dict (``_param_names``) into
        the module; missing names or wrong shapes raise."""
        for name in _param_names(self.config):
            if name not in params:
                raise KeyError(f"missing param {name!r}")
            dst = self._param(name)
            src = torch.as_tensor(np.asarray(params[name], np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"param {name!r}: shape "
                                 f"{tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(src)

    def numpy_params(self) -> Dict[str, np.ndarray]:
        """The weights as a reference-named numpy dict."""
        return {n: self._param(n).detach().cpu().numpy()
                for n in _param_names(self.config)}

    # -- shared layer math -------------------------------------------------
    @staticmethod
    def _ln(x, g, b):
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + _LN_EPS) * g + b

    def _qkv(self, layer: _Layer, h):
        """h [..., D] → q, k, v [..., H, Dh]."""
        cfg = self.config
        shape = h.shape[:-1] + (cfg.n_head, cfg.head_dim)
        return ((h @ layer.wq).reshape(shape), (h @ layer.wk).reshape(shape),
                (h @ layer.wv).reshape(shape))

    def _post_attn(self, layer: _Layer, h, ctx):
        """Residual + FFN half of one layer; ctx [..., H, Dh]."""
        ctx = ctx.reshape(ctx.shape[:-2] + (self.config.d_model,))
        h = self._ln(h + ctx @ layer.wo, layer.ln1_g, layer.ln1_b)
        f = torch.relu(h @ layer.fc1) @ layer.fc2
        return self._ln(h + f, layer.ln2_g, layer.ln2_b)

    def _embed(self, tokens, positions):
        return (self.emb[tokens.long()] * (self.config.d_model ** 0.5)
                + self.pos[positions])

    def _dense_attn(self, q, k, v, mask):
        """q/k/v [B, T, H, Dh], mask [B, Tq, Tk] bool → ctx [B, T, H, Dh]."""
        sc = float(1.0 / np.sqrt(self.config.head_dim))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sc
        s = s.masked_fill(~mask[:, None], NEG_INF)
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)

    # -- full forward (baseline / parity anchor) ---------------------------
    def full_logits(self, tokens, lengths=None):
        """tokens [B, T] → logits [B, T, V]; positions ≥ length masked
        out of attention when ``lengths`` [B] is given."""
        tokens = torch.as_tensor(tokens, device=self.device)
        B, T = tokens.shape
        h = self._embed(tokens, slice(0, T))
        qi = torch.arange(T, device=self.device)
        mask = (qi[:, None] >= qi[None, :])[None].expand(B, T, T)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=self.device)
            mask = mask & (qi[None, None, :] < lengths[:, None, None])
        for layer in self.layers:
            q, k, v = self._qkv(layer, h)
            h = self._post_attn(layer, h, self._dense_attn(q, k, v, mask))
        return h @ self.out_proj

    # -- cache writes (in place) -------------------------------------------
    @staticmethod
    def _scatter_kv(cache, layer, blocks, offsets, rows):
        """rows [N, H, Dh] into cache[layer] at (block, offset) pairs."""
        cache[layer].index_put_((blocks, offsets), rows)

    @staticmethod
    def _scatter_kv_q(cache, scales, layer, blocks, offsets, rows, slot,
                      valid, block_table):
        """Quantized bulk scatter (prefill): rows [T, H, Dh] land as int8
        codes with one fresh abs-max scale per (destination block,
        head).  ``slot`` [T] is each row's index into ``block_table``
        (clamped for pad lanes), ``valid`` [T] masks real prompt lanes.
        A block's scale is the max over the valid rows bound for it;
        untouched table entries keep their scale.  Prefill only writes
        fresh blocks, so no stored code needs rescaling."""
        MB = block_table.shape[0]
        ha = kv_head_amax(rows) * valid[:, None].float()       # [T, H]
        onehot = ((slot[:, None] == torch.arange(
            MB, device=slot.device)[None, :]) & valid[:, None])  # [T, MB]
        blk_amax = torch.where(onehot[:, :, None], ha[:, None, :],
                               torch.zeros((), device=rows.device)
                               ).amax(dim=0)                   # [MB, H]
        touched = onehot.any(dim=0)                            # [MB]
        old = scales[layer][block_table]                       # [MB, H]
        new = torch.where(touched[:, None],
                          torch.clamp_min(blk_amax, SCALE_EPS), old)
        # unwritten table entries all name trash block 0 and all write
        # back its own old scale, so the duplicate indices agree
        scales[layer].index_put_((block_table,), new)
        cache[layer].index_put_((blocks, offsets),
                                kv_quantize(rows, new[slot]))

    @staticmethod
    def _append_kv_q(cache, scales, layer, blocks, offsets, rows):
        """Quantized single-row append (decode step): rows [S, H, Dh],
        one per slot, each into its OWN block.  When a new row grows a
        (block, head)'s abs-max, the block's stored codes are
        requantized to the grown scale first (``round(q * old/new)``),
        then the row is written, in that order.

        Idle slots all write into trash block 0 at offset 0.  Duplicate
        indices in ``index_put_`` leave an unspecified winner on CUDA;
        that is harmless only because block 0 is never read unmasked
        (an idle slot's own output is discarded)."""
        S = rows.shape[0]
        ha = kv_head_amax(rows)                               # [S, H]
        old = scales[layer][blocks]                           # [S, H]
        new = torch.maximum(old, ha)
        blk = cache[layer][blocks]                            # [S, bs, H, Dh]
        ratio = torch.where(new > 0.0,
                            old / torch.clamp_min(new, SCALE_EPS),
                            torch.ones((), device=rows.device))
        blk = torch.clamp(torch.round(blk.float() * ratio[:, None, :, None]),
                          -QMAX, QMAX).to(torch.int8)
        blk[torch.arange(S, device=blk.device), offsets] = \
            kv_quantize(rows, new)
        cache[layer].index_put_((blocks,), blk)
        scales[layer].index_put_((blocks,), new)

    # -- prefill -----------------------------------------------------------
    def prefill(self, kc, vc, tokens, length, block_table, seed,
                temperature, top_k, ks=None, vs=None):
        """tokens [1, Tb] (bucket-padded), length [] int, block_table
        [MB] int → (next_token [] int32, logits [V]); the cache pools
        ``kc``/``vc`` (and the int8 scale pools ``ks``/``vs``) are
        written in place.

        One causal forward over the padded prompt; every real
        position's K/V lands in the request's blocks, pad positions in
        trash block 0 (masked by ``length`` either way).  Attention runs
        on the fresh f32 K/V of this dispatch, so the first token is
        exact whatever the cache stores."""
        cfg = self.config
        dev = tokens.device
        Tb = tokens.shape[1]
        bs = kc.shape[2]
        MB = block_table.shape[0]
        bt = block_table.long()
        pos_idx = torch.arange(Tb, device=dev)
        valid = pos_idx < length
        slot = torch.clamp_max(pos_idx // bs, MB - 1)
        blocks = torch.where(valid, bt[slot], torch.zeros_like(slot))
        offsets = pos_idx % bs
        mask = ((pos_idx[:, None] >= pos_idx[None, :])
                & (pos_idx[None, :] < length))[None]
        h = self._embed(tokens, slice(0, Tb))
        for i, layer in enumerate(self.layers):
            q, k, v = self._qkv(layer, h)          # [1, Tb, H, Dh]
            if ks is None:
                self._scatter_kv(kc, i, blocks, offsets, k[0])
                self._scatter_kv(vc, i, blocks, offsets, v[0])
            else:
                self._scatter_kv_q(kc, ks, i, blocks, offsets, k[0], slot,
                                   valid, bt)
                self._scatter_kv_q(vc, vs, i, blocks, offsets, v[0], slot,
                                   valid, bt)
            h = self._post_attn(layer, h, self._dense_attn(q, k, v, mask))
        last = h[0, torch.clamp_min(length.long() - 1, 0)]
        logits = last @ self.out_proj
        tok = _sample(logits[None], seed.reshape(1),
                      torch.zeros(1, dtype=torch.int64, device=dev),
                      temperature.reshape(1), top_k.reshape(1))[0]
        return tok, logits

    # -- decode step (the continuous-batching hot dispatch) ----------------
    def decode_step(self, kc, vc, tokens, positions, block_tables, seeds,
                    steps, temperature, top_k, ks=None, vs=None):
        """tokens [S] (each slot's last token), positions [S] (where that
        token sits), block_tables [S, MB] int32, seeds [S] (uint32
        values) + steps [S] (per-request sampling identity, see
        :func:`_sample`) → (next_tokens [S] int32, logits [S, V]): the
        forward of :meth:`decode_logits`, then the sampling epilogue."""
        logits = self.decode_logits(kc, vc, tokens, positions, block_tables,
                                    ks, vs)
        return _sample(logits, seeds, steps, temperature, top_k), logits

    def decode_logits(self, kc, vc, tokens, positions, block_tables,
                      ks=None, vs=None):
        """The forward of one decode step, without sampling: tokens [S],
        positions [S], block_tables [S, MB] int32 → logits [S, V]; the
        cache pools are written in place, and with the int8 scale pools
        ``ks``/``vs`` the attention kernel dequantizes per block and
        head.  A beam search ranks these logits on its own.

        Writes each slot's K/V at (position // bs, position % bs)
        through its block table, then attends over positions
        0..position.  Idle slots feed position 0 with an all-zero
        (trash) block table: masked garbage into block 0, token
        ignored by the engine."""
        bs = kc.shape[2]
        S = tokens.shape[0]
        positions = positions.long()
        cl = (positions + 1).to(torch.int32)
        bt = block_tables.to(torch.int32).contiguous()
        blocks = bt.long()[torch.arange(S, device=bt.device),
                           positions // bs]
        offsets = positions % bs
        h = self._embed(tokens, positions)
        for i, layer in enumerate(self.layers):
            q, k, v = self._qkv(layer, h)          # [S, H, Dh]
            if ks is None:
                self._scatter_kv(kc, i, blocks, offsets, k)
                self._scatter_kv(vc, i, blocks, offsets, v)
                ctx = decode_attention(q.contiguous(), kc[i], vc[i], bt, cl)
            else:
                self._append_kv_q(kc, ks, i, blocks, offsets, k)
                self._append_kv_q(vc, vs, i, blocks, offsets, v)
                ctx = decode_attention(q.contiguous(), kc[i], vc[i], bt, cl,
                                       k_scale=ks[i], v_scale=vs[i])
            h = self._post_attn(layer, h, ctx.to(h.dtype))
        return h @ self.out_proj


def _hash_uniform(seeds, steps, kk: int) -> torch.Tensor:
    """Counter-hash uniforms in (0, 1): one murmur-style mix per
    (request seed, token index, candidate lane), keyed per request, so
    a seeded stream replays bit for bit whatever slot it lands on.
    The reference mixes in uint32; this does the same arithmetic in
    int64 masked to 32 bits after every step."""
    seeds = u32(seeds)
    steps = u32(steps)
    lane = torch.arange(kk, dtype=torch.int64, device=seeds.device)[None]
    x = (mul32(seeds[:, None], 0x9E3779B1)
         ^ mul32(steps[:, None], 0x85EBCA77)
         ^ mul32(lane, 0xC2B2AE3D))
    u = (finalize(x) >> 8).to(torch.int32).float() * (1.0 / (1 << 24))
    return torch.clamp(u, 1e-7, 1.0 - 1e-7)


def _sample(logits, seeds, steps, temperature, top_k) -> torch.Tensor:
    """Sampling epilogue on the device: logits [S, V], seeds [S] (per
    REQUEST), steps [S] (each request's token index), temperature [S]
    f32 (<= 0 ⇒ greedy), top_k [S] int (0 ⇒ all of the top
    ``TOPK_MAX``) → tokens [S] int32.  Gumbel-max over the top slice
    with :func:`_hash_uniform` bits.  A stable descending sort stands
    in for ``lax.top_k``: ties keep the lower index first, and greedy
    is the sort's first index."""
    S, V = logits.shape
    kk = min(TOPK_MAX, V)
    vals, idx = torch.sort(logits.float(), dim=-1, descending=True,
                           stable=True)
    vals, idx = vals[:, :kk], idx[:, :kk]
    lane = torch.arange(kk, device=logits.device)[None, :]
    top_k = top_k.long()
    want = torch.where(top_k > 0, torch.clamp_max(top_k, kk),
                       torch.full_like(top_k, kk))[:, None]
    vals = vals.masked_fill(lane >= want, -math.inf)
    g = -torch.log(-torch.log(_hash_uniform(seeds, steps, kk)))
    temp = torch.clamp_min(temperature.float(), 1e-6)[:, None]
    choice = torch.argmax(vals / temp + g, dim=-1)
    greedy = idx[:, 0]
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


# ---------------------------------------------------------------------------
# model-dir persistence (the reference's format, byte for byte)
# ---------------------------------------------------------------------------

_CONFIG_FILE = "decode_config.json"
_PARAMS_FILE = "params.npz"


def save_lm(dirname: str, config: LMConfig, params: Dict) -> None:
    """Write a model dir (config JSON + params npz); atomic per file
    (tmp + replace), the reference's format."""
    os.makedirs(dirname, exist_ok=True)
    cpath = os.path.join(dirname, _CONFIG_FILE)
    with open(cpath + ".tmp", "w") as f:
        json.dump(config.to_dict(), f, indent=2)
    os.replace(cpath + ".tmp", cpath)
    ppath = os.path.join(dirname, _PARAMS_FILE)
    np.savez(ppath + ".tmp.npz",
             **{k: np.asarray(v) for k, v in params.items()})
    os.replace(ppath + ".tmp.npz", ppath)


def load_lm(dirname: str, device: Device = None):
    """(TransformerLM with the weights loaded, params dict) from a
    model dir written by either package's ``save_lm``."""
    with open(os.path.join(dirname, _CONFIG_FILE)) as f:
        cfg = LMConfig.from_dict(json.load(f))
    with np.load(os.path.join(dirname, _PARAMS_FILE)) as z:
        params = {k: z[k].copy() for k in z.files}
    missing = [n for n in _param_names(cfg) if n not in params]
    if missing:
        raise ValueError(f"model dir {dirname!r} is missing params: "
                         f"{missing[:4]}{'...' if len(missing) > 4 else ''}")
    lm = TransformerLM(cfg, device=device)
    lm.load_numpy(params)
    return lm, params


__all__ = ["LMConfig", "TransformerLM", "save_lm", "load_lm", "TOPK_MAX"]
