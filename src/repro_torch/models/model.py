"""Decoder LMs of the dense, MoE, SSM and hybrid families and the
encoder-decoder family: training forward and loss, whole-prompt
prefill, and the serving decode (port of ``repro/models/model.py``).

Parameters keep the reference's tree: ``embed`` (V, d), ``unembed``
(d, V) unless the head is tied to ``embed``, ``final_norm``, and the
scan-stacked ``blocks`` whose leaves carry a leading layer dim (L, ...),
with ``ln1_post``/``ln2_post`` where the config asks for post-sublayer
norms, ``attn.bq``/``bk``/``bv`` with a QKV bias (qwen2.5),
``attn.q_norm``/``k_norm`` with qk-norm (gemma3), and ``moe`` in place
of ``mlp`` where the config has a ``MoEConfig`` (deepseek-moe-16b,
llama4-maverick): ``router`` (d, E), the expert stacks ``w_gate``/
``w_up`` (E, d, fe) and ``w_down`` (E, fe, d), and ``shared``, an MLP
of width ``n_shared * fe``. An SSM block (mamba2) is ``ln1`` and
``ssm``: ``in_proj`` (d, 2 di + 2 G N + H), ``conv_w`` (d_conv,
conv_dim), ``dt_bias``, ``A_log``, ``D`` (H,), ``norm_w`` (di,) and
``out_proj`` (di, d). A hybrid block (hymba) has the attention block's
leaves, ``ssm`` beside them, ``attn_out_norm``/``ssm_out_norm``, and
with meta tokens ``attn.meta_k``/``meta_v`` (M, K, hd) and
``ssm.init_state`` (H, P, N). The encoder-decoder family (whisper) adds
the encoder's stack ``enc_blocks`` (``ln1``, ``attn``, ``ln2``,
``mlp``) and ``enc_norm``; its decoder ``blocks`` carry ``ln_x`` and
the cross-attention ``xattn`` besides; its norms are layernorms (``w``
and ``b``), its MLP the non-gated gelu one (``w_up``, ``w_down``), and
it has no RoPE: sinusoidal positions are added to the audio frames and
the token embeddings. Where the reference
scans over that dim with ``lax.scan`` and per-layer flag arrays
(windows, RoPE bases), the port loops over layers in Python with the
same flags as Python numbers. A model with ``input_mode="embeddings"``
(llava) takes ``batch["embeds"]`` (B, S, d) in place of tokens; one
with ``input_mode="audio+tokens"`` (whisper) takes ``batch["audio"]``
(B, encoder_seq, d) frame embeddings beside the tokens.

The decode cache is updated IN PLACE (the reference returns a new one):
``decode_step``/``decode_chunk`` write each token's K/V into the fixed
lanes or the page pool, and the SSM state and conv tail into their
lanes, and ``prefill_encoder`` writes the encoder-decoder's cross
caches ``ck``/``cv``, and they return the same dict. Writes the reference
drops (``mode="drop"``: released-sentinel pages, positions past the
view, padded chunk tails) are dropped here too, with fixed shapes and
no host sync (see :class:`_DropScatter`). The encoder-decoder family is
served through this API only (``init_cache``, ``prefill_encoder``,
``decode_step``): ``prefill``, ``decode_chunk`` and the serving session
refuse it, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.serve.paged import gather_pages_kv
from repro_torch.serve.quantized import layer_slice
from repro_torch.tree import tree_map

Gather = Optional[Callable[[Any, str], Any]]


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class _DropScatter:
    """``dst[idx] = vals`` for the rows where ``ok``; other rows vanish,
    as the reference's ``.at[idx].set(..., mode="drop")``.

    Fixed shapes and no host sync: a dropped row repeats the write of the
    first kept row (same place, same value), or, when no row is kept,
    writes back what is already at the first row's place. Kept rows
    target distinct places, so every duplicate index carries one value.
    ``idx`` must already be clipped into ``dst``. Built once per step and
    applied to every layer's pool or lane. The donor index is a (1,)
    tensor: indexing with a 0-d tensor would read it on the host.
    """

    def __init__(self, idx: Tuple[torch.Tensor, ...], ok: torch.Tensor):
        donor = torch.argmax(ok.to(torch.uint8)).reshape(1)
        self.loc = tuple(i[donor] for i in idx)
        self.idx = tuple(torch.where(ok, i, l) for i, l in zip(idx, self.loc))
        self.ok, self.donor, self.donor_ok = ok, donor, ok[donor]

    def __call__(self, dst: torch.Tensor, vals: torch.Tensor) -> None:
        vals = vals.to(dst.dtype)
        fill = torch.where(self.donor_ok, vals[self.donor], dst[self.loc])
        ok = self.ok.reshape((-1,) + (1,) * (vals.dim() - 1))
        dst.index_put_(self.idx, torch.where(ok, vals, fill))


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def _check_family(self):
        """The port's models: the GQA family, dense (yi-6b, gemma2-2b,
        gemma3-4b, qwen2.5-14b, and llava-next's mistral decoder, which
        is this family on embedding input) or with MoE feed-forwards
        (deepseek-moe-16b, llama4-maverick); the SSM family (mamba2-2.7b,
        attention-free SSD blocks); the hybrid family (hymba-1.5b:
        attention and SSD heads side by side, meta tokens); the
        encoder-decoder family (whisper-small: a bidirectional encoder
        over audio frames, a causal decoder with cross-attention,
        sinusoidal positions, no RoPE): rmsnorm or layernorm, gated silu
        MLP, non-gated gelu MLP or experts; tied or untied head,
        sliding-window layers, softcaps, post-sublayer norms, embedding
        scaling, QKV bias, qk-norm and a local RoPE base as the config
        says. Any other arch type, input mode, norm or activation is
        refused by name."""
        c = self.cfg
        extras = [name for name, on in (
            (f"arch_type {c.arch_type}", c.arch_type not in (
                "dense", "vlm", "moe", "ssm", "hybrid", "encdec")),
            (f"input_mode {c.input_mode}", c.input_mode not in (
                "tokens", "embeddings", "audio+tokens")),
            (f"norm {c.norm}", c.norm not in ("rmsnorm", "layernorm")),
            (f"act {c.act}", c.act not in ("silu", "gelu"))) if on]
        if extras:
            raise NotImplementedError(
                f"{c.name}: {', '.join(extras)} not ported yet; the other "
                "architecture families are queued in ROADMAP.md")

    # ---------------- init ----------------
    def init(self, key=None, *, seed: int = 0,
             device="cuda") -> Dict[str, Any]:
        """The reference's parameters for ``key`` (default
        ``PRNGKey(seed)``; either form ``core.threefry.as_key`` takes):
        ``Model(cfg).init(key)``'s leaf names, shapes and values, drawn
        through the reference's key tree (``split`` into 6 at the root, one
        ``split`` a layer stack, each family's parameter functions' splits and
        hymba's meta tokens by ``fold_in(key, 7 / 8)``). Weights are
        ``truncated_normal(-2, 2) * 0.02`` (``conv_w`` * 0.2) by
        ``kernels.prng.trunc_normal``, one launch a stacked leaf on the card;
        mamba's ``dt`` is the reference's log-uniform in float32; norms and
        qk-norm weights ones, biases zeros. The weights equal the
        reference's to float32 rounding (XLA's CPU build rounds its
        ``log1p`` and ``erf_inv`` its own way: within 2e-6 times the std).
        The key algebra runs on the host. ``device="meta"`` draws nothing
        and keeps the shapes."""
        from repro_torch.core import threefry as TF
        from repro_torch.kernels import prng
        self._check_family()
        cfg = self.cfg
        dev = torch.device(device)
        meta = dev.type == "meta"
        key = TF.prng_key(seed) if key is None else TF.as_key(key,
                                                              "Model.init")

        def dense(k, *shape, std=0.02):
            """``_dense``: k a (2,) key or an (L, 2) stack of layer keys."""
            if meta:
                return torch.empty(tuple(k.shape[:-1]) + shape,
                                   dtype=torch.float32, device=dev)
            return prng.trunc_normal(k.to(dev), shape, std)

        def full(k, value, *shape):
            return torch.full(tuple(k.shape[:-1]) + shape, value,
                              dtype=torch.float32, device=dev)

        d, H, K, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim_, cfg.d_ff)

        def norm(k):
            """``_norm_param`` (k gives the leading layer dims)."""
            p = {"w": full(k, 1.0, d)}
            if cfg.norm == "layernorm":
                p["b"] = full(k, 0.0, d)
            return p

        def attention(k):
            ks = TF.split(k, 4)
            p = {"q": dense(ks[..., 0, :], d, H * hd),
                 "k": dense(ks[..., 1, :], d, K * hd),
                 "v": dense(ks[..., 2, :], d, K * hd),
                 "o": dense(ks[..., 3, :], H * hd, d)}
            if cfg.qkv_bias:
                for name, width in (("bq", H * hd), ("bk", K * hd),
                                    ("bv", K * hd)):
                    p[name] = full(k, 0.0, width)
            if cfg.qk_norm:
                p["q_norm"], p["k_norm"] = full(k, 1.0, hd), full(k, 1.0, hd)
            if cfg.meta_tokens:
                p["meta_k"] = dense(TF.fold_in(k, 7), cfg.meta_tokens, K, hd)
                p["meta_v"] = dense(TF.fold_in(k, 8), cfg.meta_tokens, K, hd)
            return p

        def mlp(k, d_in=d, d_ff=f):
            ks = TF.split(k, 3)
            if cfg.act == "gelu":
                return {"w_up": dense(ks[..., 0, :], d_in, d_ff),
                        "w_down": dense(ks[..., 1, :], d_ff, d_in)}
            return {"w_gate": dense(ks[..., 0, :], d_in, d_ff),
                    "w_up": dense(ks[..., 1, :], d_in, d_ff),
                    "w_down": dense(ks[..., 2, :], d_ff, d_in)}

        def moe(k):
            m = cfg.moe
            E, fe = m.n_experts, m.d_ff_expert or f
            ks = TF.split(k, 5)
            p = {"router": dense(ks[..., 0, :], d, E),
                 "w_gate": dense(ks[..., 1, :], E, d, fe),
                 "w_up": dense(ks[..., 2, :], E, d, fe),
                 "w_down": dense(ks[..., 3, :], E, fe, d)}
            if m.n_shared:
                p["shared"] = mlp(ks[..., 4, :], d, m.n_shared * fe)
            return p

        def block(k):
            ks = TF.split(k, 8)
            if cfg.arch_type == "ssm":
                return {"ln1": norm(k), "ssm": self._ssm_init(
                    ks[..., 0, :], dense, full, dev)}
            p = {"ln1": norm(k), "attn": attention(ks[..., 0, :]),
                 "ln2": norm(k)}
            if cfg.post_norm:
                p["ln1_post"] = norm(k)
                p["ln2_post"] = norm(k)
            if cfg.arch_type == "hybrid":
                p["ssm"] = self._ssm_init(ks[..., 1, :], dense, full, dev)
                p["attn_out_norm"] = norm(k)
                p["ssm_out_norm"] = norm(k)
            if cfg.moe is not None:
                p["moe"] = moe(ks[..., 2, :])
            else:
                p["mlp"] = mlp(ks[..., 3, :])
            return p

        def encdec_block(k, cross):
            ks = TF.split(k, 4)
            p = {"ln1": norm(k), "attn": attention(ks[..., 0, :]),
                 "ln2": norm(k), "mlp": mlp(ks[..., 1, :])}
            if cross:
                p["ln_x"] = norm(k)
                p["xattn"] = attention(ks[..., 2, :])
            return p

        ks = TF.split(key, 6)
        params = {"embed": dense(ks[0], cfg.vocab_size, d),
                  "final_norm": norm(key)}
        if not cfg.tie_embeddings:
            params["unembed"] = dense(ks[4], d, cfg.vocab_size)
        if cfg.arch_type == "encdec":
            params["enc_blocks"] = encdec_block(
                TF.split(ks[1], cfg.encoder_layers), cross=False)
            params["enc_norm"] = norm(key)
            params["blocks"] = encdec_block(TF.split(ks[2], cfg.n_layers),
                                            cross=True)
        else:
            params["blocks"] = block(TF.split(ks[1], cfg.n_layers))
        return params

    def _ssm_init(self, k, dense, full, dev):
        """One SSD mixer's stacked leaves under the (L, 2) layer keys ``k``
        (the reference's ``_ssm_params``): ``dt_bias`` the inverse softplus
        of dt, log-uniform in [1e-3, 0.1] in float32; ``A_log = log(h % 15
        + 1)`` for heads h = 1..H; ``conv_w`` a truncated normal times 0.2;
        ``D`` and ``norm_w`` ones; with meta tokens, ``init_state`` zeros.
        ``init_state`` is carried so the tree, checkpoints and the
        converter match the reference's, but, as there, neither the
        forward nor the decode reads it."""
        from repro_torch.core import threefry as TF
        cfg = self.cfg
        s, d = cfg.ssm, cfg.d_model
        di, H = cfg.d_inner, cfg.n_ssm_heads
        conv_dim = di + 2 * s.n_groups * s.d_state
        ks = TF.split(k, 4)
        lead = tuple(k.shape[:-1])
        if dev.type == "meta":
            dt_bias = torch.empty(lead + (H,), device=dev)
        else:
            # the reference's float32 constants (numpy float64 scalars
            # folded into float32 by jax's promotion without x64)
            c = [torch.tensor(float(np.float32(v)), dtype=torch.float32)
                 for v in (np.log(0.1) - np.log(1e-3), np.log(1e-3))]
            dt = torch.exp(TF.uniform(ks[..., 2, :], (H,)) * c[0] + c[1])
            dt_bias = (dt + torch.log(-torch.expm1(-dt))).to(dev)
        heads = torch.arange(1, H + 1, dtype=torch.float32, device=dev)
        p = {"in_proj": dense(ks[..., 0, :], d,
                              2 * di + 2 * s.n_groups * s.d_state + H),
             "conv_w": dense(ks[..., 1, :], s.d_conv, conv_dim, std=0.2),
             "dt_bias": dt_bias,
             "A_log": torch.log(heads % 15 + 1.0).expand(lead + (H,))
             .clone(),
             "D": full(k, 1.0, H),
             "norm_w": full(k, 1.0, di),
             "out_proj": dense(ks[..., 3, :], di, d)}
        if cfg.meta_tokens:
            p["init_state"] = full(k, 0.0, H, s.head_dim, s.d_state)
        return p

    # ---------------- embed / head ----------------
    def _embed_in(self, params, inputs, key):
        """The input rows in the activation dtype: ``inputs["embeds"]``
        for an embedding-input model, else the embedding rows of
        ``inputs[key]``; then the embedding scaling where the config has
        it."""
        if self.cfg.input_mode == "embeddings":
            x = inputs["embeds"].to(_dt(self.cfg))
        elif L.code_resident(params["embed"]):
            # code-resident table: gather only the hit rows' codes
            x = params["embed"].astype(_dt(self.cfg)).take(inputs[key])
        else:
            x = params["embed"].to(_dt(self.cfg))[inputs[key].long()]
        if self.cfg.emb_scale:
            # sqrt(d) rounded to x's dtype first, as the reference
            x = x * torch.full((), math.sqrt(self.cfg.d_model),
                               dtype=x.dtype, device=x.device)
        return x

    def _head(self, params, x, backend=None):
        """float32 logits; a tied head contracts x against the embedding
        table's rows (``x @ embed.T``, K1t from codes when the table is
        code-resident), then the final softcap where the config has one."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            w = params["embed"]
            if L.code_resident(w):
                logits = w.astype(x.dtype).matmul_t(x, backend=backend)
            else:
                logits = x @ w.to(x.dtype).T
        else:
            logits = L.pmatmul(x, params["unembed"], backend)
        logits = logits.to(torch.float32)
        return L.apply_softcap(logits, cfg.final_softcap)

    def _ffn(self, p, h, backend=None, ctx: L.ShardCtx = L.ShardCtx()):
        """The feed-forward sublayer of the normed input h: (out, the
        0-d float32 MoE aux loss, or None for a dense MLP)."""
        if self.cfg.moe is None:
            return L.mlp(p["mlp"], h, backend, self.cfg.act), None
        return L.moe(p["moe"], h, self.cfg.moe, ctx, backend)

    def _post(self, out, p, name):
        """The post-sublayer norm (gemma2) where the config has one."""
        if self.cfg.post_norm:
            return L.apply_norm(out, p[name], self.cfg)
        return out

    def _qkv(self, pa, h, q_pos, theta, backend=None):
        """The attention sublayer's q (B, S, H, hd), k and v (B, S, K, hd)
        of the normed input h, in the reference's order: projections,
        the QKV bias (cast to h's dtype), qk-norm per head, RoPE on q and
        k at ``q_pos`` with the layer's base (none in the encoder-decoder
        family, whose positions are absolute sinusoids)."""
        cfg = self.cfg
        Bn, S, _ = h.shape
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        q = L.pmatmul(h, pa["q"], backend)
        k = L.pmatmul(h, pa["k"], backend)
        v = L.pmatmul(h, pa["v"], backend)
        if cfg.qkv_bias:
            q = q + pa["bq"].to(h.dtype)
            k = k + pa["bk"].to(h.dtype)
            v = v + pa["bv"].to(h.dtype)
        q = q.reshape(Bn, S, H, hd)
        k = k.reshape(Bn, S, K, hd)
        v = v.reshape(Bn, S, K, hd)
        if cfg.qk_norm:
            q = L.rmsnorm(q, pa["q_norm"], cfg.norm_eps)
            k = L.rmsnorm(k, pa["k_norm"], cfg.norm_eps)
        if cfg.arch_type == "encdec":
            return q, k, v
        return L.rope(q, q_pos, theta), L.rope(k, q_pos, theta), v

    def _cross(self, pa, h, ck, cv, backend=None,
               ctx: L.ShardCtx = L.ShardCtx()):
        """The encoder-decoder's cross-attention of the normed input h
        (B, S, d) against the encoder's K/V (B, Sa, K, hd) of the layer
        (``enc @ xattn.k/v``; under ``ctx`` this shard's frames, which
        ``attention`` gathers): bidirectional, projected by ``xattn.o``."""
        cfg = self.cfg
        Bn, S, _ = h.shape
        q = L.pmatmul(h, pa["q"], backend).reshape(
            Bn, S, cfg.n_heads, cfg.head_dim_)
        out = L.attention(q, ck, cv, q_pos=None, causal=False,
                          softcap=cfg.attn_softcap, ctx=ctx)
        return L.pmatmul(out.reshape(Bn, S, -1), pa["o"], backend)

    def _enc_kv(self, pa, enc, backend=None):
        """The cross-attention's K and V (B, Sa, K, hd) of the encoder
        output ``enc`` (B, Sa, d), from the layer's ``xattn.k/v``."""
        Bn, Sa, _ = enc.shape
        shape = (Bn, Sa, self.cfg.n_kv_heads, self.cfg.head_dim_)
        return (L.pmatmul(enc, pa["k"], backend).reshape(shape),
                L.pmatmul(enc, pa["v"], backend).reshape(shape))

    def _meta_kv(self, pa, Bn: int, dtype):
        """Hymba's learned K/V prefix of the layer, (B, M, K, hd) each in
        the activation dtype; None without meta tokens."""
        if not self.cfg.meta_tokens:
            return None
        return tuple(pa[name].to(dtype).expand((Bn,) + tuple(
            pa[name].shape)) for name in ("meta_k", "meta_v"))

    def _mix(self, attn, ssm_out, p):
        """The hybrid block's merge of its parallel heads:
        ``0.5 (norm(attn) + norm(ssm))`` (attention alone otherwise)."""
        if ssm_out is None:
            return attn
        return 0.5 * (L.apply_norm(attn, p["attn_out_norm"], self.cfg)
                      + L.apply_norm(ssm_out, p["ssm_out_norm"], self.cfg))

    # ---------------- training forward ----------------
    def _block(self, p, x, q_pos, window, theta, backend=None, kv=None,
               ctx: L.ShardCtx = L.ShardCtx()):
        """One decoder block of the training forward on x (B, S, d) at
        global positions ``q_pos``: (x, the layer's MoE aux loss or
        None); ``kv``, a list, collects the layer's cache entries
        ({"k", "v"} and/or {"ssm", "conv"}: prefill). The layer's
        weights pass ``ctx.gather(p, "blocks")`` first, inside the
        block, so that a checkpointed block gathers them again in the
        backward instead of keeping them.

        An SSM block is ``x + mamba2_mix(ln1(x))``. A hybrid block runs
        the attention and the mixer on the same ``ln1`` output and
        merges them (:meth:`_mix`); with meta tokens the prefix goes in
        front of the (gathered) keys at positions below ``meta_tokens``,
        which the window never masks."""
        cfg = self.cfg
        Bn, S, _ = x.shape
        p = ctx.gather(p, "blocks")
        h = L.apply_norm(x, p["ln1"], cfg)
        if cfg.arch_type == "ssm":
            out, st = L.mamba2_mix(p["ssm"], h, cfg.ssm, cfg.d_model,
                                   ctx=ctx, backend=backend)
            if kv is not None:
                kv.append(st)
            return x + out, None
        pa = p["attn"]
        q, k, v = self._qkv(pa, h, q_pos, theta, backend)
        entry = {"k": k, "v": v}
        meta = self._meta_kv(pa, Bn, h.dtype)
        if meta is None:
            attn = L.attention(q, k, v, q_pos=q_pos, window=window,
                               softcap=cfg.attn_softcap, ctx=ctx)
        else:
            if ctx.sharded:
                from repro_torch.dist import collectives as C
                k = C.gather_shard(k, 1, ctx.cp_size, ctx.cp_group)
                v = C.gather_shard(v, 1, ctx.cp_size, ctx.cp_group)
            M = cfg.meta_tokens
            attn = L.attention(q, torch.cat([meta[0], k], dim=1),
                               torch.cat([meta[1], v], dim=1),
                               q_pos=q_pos + M, window=window,
                               softcap=cfg.attn_softcap, meta_tokens=M)
        attn = L.pmatmul(attn.reshape(Bn, S, -1), pa["o"], backend)
        ssm_out = None
        if cfg.arch_type == "hybrid":
            ssm_out, st = L.mamba2_mix(p["ssm"], h, cfg.ssm, cfg.d_model,
                                       ctx=ctx, backend=backend)
            entry.update(st)
        if kv is not None:
            kv.append(entry)
        attn = self._mix(attn, ssm_out, p)
        x = x + self._post(attn, p, "ln1_post")
        out, aux = self._ffn(p, L.apply_norm(x, p["ln2"], cfg), backend,
                             ctx)
        return x + self._post(out, p, "ln2_post"), aux

    # ---------------- encoder-decoder (whisper) ----------------
    def _enc_block(self, p, x, backend=None, ctx: L.ShardCtx = L.ShardCtx()):
        """One encoder block: bidirectional self-attention over the
        frames (all of them: ``attention`` gathers K/V under ``ctx``),
        then the MLP, each pre-normed and residual."""
        cfg = self.cfg
        Bn, S, _ = x.shape
        p = ctx.gather(p, "enc_blocks")
        pa = p["attn"]
        q, k, v = self._qkv(pa, L.apply_norm(x, p["ln1"], cfg), None, None,
                            backend)
        out = L.attention(q, k, v, q_pos=None, causal=False,
                          softcap=cfg.attn_softcap, ctx=ctx)
        x = x + L.pmatmul(out.reshape(Bn, S, -1), pa["o"], backend)
        out, _ = self._ffn(p, L.apply_norm(x, p["ln2"], cfg), backend)
        return x + out

    def _dec_block(self, p, x, enc, q_pos, backend=None,
                   ctx: L.ShardCtx = L.ShardCtx()):
        """One decoder block of the training forward: causal
        self-attention, the cross-attention against ``enc @ xattn.k/v``
        (normed by ``ln_x``), then the MLP."""
        cfg = self.cfg
        Bn, S, _ = x.shape
        p = ctx.gather(p, "blocks")
        pa = p["attn"]
        q, k, v = self._qkv(pa, L.apply_norm(x, p["ln1"], cfg), q_pos, None,
                            backend)
        out = L.attention(q, k, v, q_pos=q_pos, softcap=cfg.attn_softcap,
                          ctx=ctx)
        x = x + L.pmatmul(out.reshape(Bn, S, -1), pa["o"], backend)
        ck, cv = self._enc_kv(p["xattn"], enc, backend)
        x = x + self._cross(p["xattn"], L.apply_norm(x, p["ln_x"], cfg),
                            ck, cv, backend, ctx)
        out, _ = self._ffn(p, L.apply_norm(x, p["ln2"], cfg), backend)
        return x + out

    @staticmethod
    def _layer_views(stack, n: int, train: bool):
        """The n layers' subtrees of a scan-stacked ``stack``: unbound once
        for a training forward (the backward then stacks each leaf's
        per-layer gradients in one copy), else sliced with
        ``layer_slice`` (code-resident leaves too)."""
        if not train:
            return [layer_slice(stack, i) for i in range(n)]
        per_layer = tree_map(lambda w: torch.unbind(w, 0), stack)
        return [tree_map(lambda ws: ws[i], per_layer) for i in range(n)]

    def _encode(self, params, audio, ctx: L.ShardCtx = L.ShardCtx(),
                backend=None, train: bool = True):
        """The encoder over ``audio`` (B, Sa, d) frame embeddings, this
        shard's Sa frames under ``ctx``: sinusoidal positions from
        ``cp_index * Sa`` added in the activation dtype, the encoder
        blocks (each under ``torch.utils.checkpoint`` when ``train``),
        ``enc_norm``."""
        cfg = self.cfg
        x = audio.to(_dt(cfg))
        _, Sa, d = x.shape
        x = x + L.sinusoidal_positions(Sa, d, ctx.cp_index() * Sa,
                                       x.device).to(x.dtype)[None]
        for p in self._layer_views(params["enc_blocks"], cfg.encoder_layers,
                                   train):
            if train:
                x = checkpoint(self._enc_block, p, x, backend, ctx,
                               use_reentrant=False)
            else:
                x = self._enc_block(p, x, backend, ctx)
        return L.apply_norm(x, params["enc_norm"], cfg)

    def _forward_encdec(self, params, batch, ctx: L.ShardCtx):
        """The encoder-decoder's training forward (the reference's
        ``_forward_encdec``): (float32 logits, an exact 0 aux loss)."""
        cfg = self.cfg
        params = ctx.gather(params, "static")
        enc = self._encode(params, batch["audio"], ctx)
        x = self._embed_in(params, batch, "tokens")
        _, S, d = x.shape
        pos0 = ctx.cp_index() * S
        x = x + L.sinusoidal_positions(S, d, pos0, x.device).to(x.dtype)[None]
        q_pos = pos0 + torch.arange(S, device=x.device)
        for p in self._layer_views(params["blocks"], cfg.n_layers, True):
            x = checkpoint(self._dec_block, p, x, enc, q_pos, None, ctx,
                           use_reentrant=False)
        x = L.apply_norm(x, params["final_norm"], cfg)
        return self._head(params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def forward(self, params, batch,
                ctx: L.ShardCtx = L.ShardCtx()) -> torch.Tensor:
        """Training forward of float parameters -> float32 logits
        (B, S, V); :meth:`forward_with_aux` also returns the MoE aux
        loss."""
        return self.forward_with_aux(params, batch, ctx)[0]

    def forward_with_aux(self, params, batch,
                         ctx: L.ShardCtx = L.ShardCtx()):
        """Training forward of float parameters -> (float32 logits
        (B, S, V), the 0-d float32 aux loss summed over the MoE layers,
        an exact 0 for a dense model), the reference's ``forward``.
        batch: {"tokens": (B, S) int}, or {"embeds": (B, S, d)} for an
        embedding-input model; an encoder-decoder's also holds "audio"
        (B, Sa, d) (:meth:`_forward_encdec`).

        ``ctx`` (``layers.ShardCtx``): under context parallelism the batch
        holds this shard's S positions of the sequence, at global
        positions ``cp_index * S + arange(S)``; ``ctx.gather(params,
        "static")`` and, a layer at a time, ``ctx.gather(p, "blocks")``
        make the whole weights (from model shards in ``dist.step``).

        Each block runs under ``torch.utils.checkpoint`` (non-reentrant):
        its activations are recomputed in the backward, the reference's
        ``remat_policy="full"``. The stacked (L, ...) leaves are unbound
        once, so the backward stacks each leaf's per-layer gradients in
        one copy. The weight products are ``torch.matmul`` in the
        activation dtype, as the reference leaves them to XLA."""
        self._check_family()
        cfg = self.cfg
        if cfg.arch_type == "encdec":
            return self._forward_encdec(params, batch, ctx)
        params = ctx.gather(params, "static")
        x = self._embed_in(params, batch, "tokens")
        S = x.shape[1]
        q_pos = ctx.cp_index() * S + torch.arange(S, device=x.device)
        views = self._layer_views(params["blocks"], cfg.n_layers, True)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, window, theta in zip(views, cfg.layer_windows(),
                                    cfg.layer_rope_thetas()):
            x, aux = checkpoint(self._block, p, x, q_pos, window, theta,
                                None, None, ctx, use_reentrant=False)
            if aux is not None:
                aux_total = aux_total + aux
        x = L.apply_norm(x, params["final_norm"], cfg)
        return self._head(params, x), aux_total

    def prefill(self, params, batch, max_seq_local: int,
                gather: Gather = None, backend: Optional[str] = None,
                ctx: Optional[L.ShardCtx] = None):
        """Whole-prompt prefill: the forward pass over ``batch``'s
        sequence that also returns each layer's cache, as the
        reference's ``forward(collect_cache=True)``. Returns (float32
        logits (B, S, V), cache): {"k", "v": (layers, B, max_seq_local,
        K, hd)} zero-padded past S where the model attends, and {"ssm":
        (layers, B, H, P, N) float32, "conv": (layers, B, d_conv - 1,
        conv_dim)} where it has SSD mixers. ``gather`` is the per-layer
        parameter hook of code-resident weights (``make_dequant_gather``);
        no activations are kept for a backward.

        ``ctx``: a context-parallel prefill (its ``param_gather`` in place
        of ``gather``): ``batch`` holds this shard's positions, K and V
        stay the shard's, and the SSM state and conv tail, which only
        the last shard holds whole, are gathered from it.

        The encoder-decoder family is refused with the reference's
        message: it is served through :meth:`prefill_encoder` and
        :meth:`decode_step`."""
        self._check_family()
        cfg = self.cfg
        if cfg.arch_type == "encdec":
            raise NotImplementedError("use prefill() for enc-dec serving")
        if ctx is None:
            ctx = L.ShardCtx(param_gather=gather)
        params = ctx.gather(params, "static")
        x = self._embed_in(params, batch, "tokens")
        S = x.shape[1]
        if S > max_seq_local:
            raise ValueError(f"a prompt of {S} tokens does not fit "
                             f"max_seq_local={max_seq_local}")
        q_pos = ctx.cp_index() * S + torch.arange(S, device=x.device)
        kv = []
        for i, (window, theta) in enumerate(zip(cfg.layer_windows(),
                                                cfg.layer_rope_thetas())):
            x, _ = self._block(layer_slice(params["blocks"], i), x, q_pos,
                               window, theta, backend, kv, ctx)
        x = L.apply_norm(x, params["final_norm"], cfg)
        logits = self._head(params, x, backend)
        cache = {}
        pad = (0, 0, 0, 0, 0, max_seq_local - S)
        for name in ("k", "v"):
            if name in kv[0]:
                cache[name] = torch.nn.functional.pad(
                    torch.stack([layer[name] for layer in kv]), pad)
        if "ssm" in kv[0]:
            ssm = torch.stack([layer["ssm"] for layer in kv]).to(
                torch.float32)
            conv = torch.stack([layer["conv"] for layer in kv])
            if ctx.sharded:
                from repro_torch.dist import collectives as C
                ssm = C.gather_stack(ssm, ctx.cp_group)[-1]
                conv = C.gather_stack(conv, ctx.cp_group)[-1]
            cache["ssm"], cache["conv"] = ssm, conv
        return logits, cache

    def loss(self, params, batch, ctx: L.ShardCtx = L.ShardCtx()):
        """(sum of masked next-token NLL plus the MoE aux loss, token
        count), both 0-d float32: the caller takes the mean. batch:
        tokens, targets (B, S) and an optional float mask (this shard's
        positions under ``ctx``). A dense model adds no aux term (the
        reference adds its exact 0)."""
        logits, aux = self.forward_with_aux(params, batch, ctx)
        targets = batch["targets"].long()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=logits.device)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
        nll = (logz - gold) * mask
        if self.cfg.moe is None:
            return nll.sum(), mask.sum()
        return nll.sum() + aux, mask.sum()

    # ---------------- KV cache ----------------
    def init_cache(self, batch_size: int, max_seq_local: int, dtype=None,
                   page_pool: Optional[Tuple[int, int]] = None,
                   device="cuda", encoder_seq_local: int = 0
                   ) -> Dict[str, torch.Tensor]:
        """Decode cache: fixed lanes ``k``/``v`` (layers, B, max_seq, K, hd)
        or, with ``page_pool=(num_pages, page_size)``, a page pool
        ``pk``/``pv`` (layers, num_pages, page_size, K, hd) plus a page
        table ``ptab`` (B, max_seq // page_size) initialised to the
        RELEASED sentinel ``num_pages``. SSD mixers add the per-slot
        ``ssm`` state (layers, B, H, P, N) float32 and ``conv`` tail
        (layers, B, d_conv - 1, conv_dim) (O(1) in the sequence: never
        paged); a pure SSM model has no K/V and no page pool. The
        encoder-decoder family adds the per-slot cross caches ``ck``/
        ``cv`` (layers, B, encoder_seq_local, K, hd) in ``dtype`` (fixed
        length: never paged), which :meth:`prefill_encoder` fills."""
        self._check_family()
        cfg = self.cfg
        dtype = dtype or _dt(cfg)
        K, hd, lyr = cfg.n_kv_heads, cfg.head_dim_, cfg.n_layers
        dev = torch.device(device)
        cache = {}
        if cfg.arch_type != "ssm" and page_pool is not None:
            num_pages, page_size = page_pool
            if max_seq_local % page_size:
                raise ValueError(
                    f"max_seq_local={max_seq_local} must be a multiple of "
                    f"page_size={page_size}")
            shape = (lyr, num_pages, page_size, K, hd)
            cache = {"pk": torch.zeros(shape, dtype=dtype, device=dev),
                     "pv": torch.zeros(shape, dtype=dtype, device=dev),
                     "ptab": torch.full(
                         (batch_size, max_seq_local // page_size),
                         num_pages, dtype=torch.int32, device=dev)}
        elif cfg.arch_type != "ssm":
            shape = (lyr, batch_size, max_seq_local, K, hd)
            cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if cfg.arch_type in ("ssm", "hybrid"):
            s = cfg.ssm
            conv_dim = cfg.d_inner + 2 * s.n_groups * s.d_state
            cache["ssm"] = torch.zeros(
                (lyr, batch_size, cfg.n_ssm_heads, s.head_dim, s.d_state),
                dtype=torch.float32, device=dev)
            cache["conv"] = torch.zeros(
                (lyr, batch_size, s.d_conv - 1, conv_dim), dtype=dtype,
                device=dev)
        if cfg.arch_type == "encdec":
            shape = (lyr, batch_size, encoder_seq_local, K, hd)
            cache["ck"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["cv"] = torch.zeros(shape, dtype=dtype, device=dev)
        return cache

    def prefill_encoder(self, params, audio, cache, gather: Gather = None,
                        backend: Optional[str] = None,
                        ctx: Optional[L.ShardCtx] = None):
        """The encoder-decoder's prefill: the encoder over ``audio`` (B,
        Sa, d) frame embeddings, then each decoder layer's cross K/V
        ``enc @ xattn.k/v`` written into ``cache["ck"]``/``["cv"]`` in
        place, a layer at a time (K1 for code-resident weights through
        ``gather``, the per-layer hook of :meth:`decode_step`). Returns
        the cache.

        ``ctx``: a sharded prefill (its ``param_gather`` in place of
        ``gather``): ``audio`` holds this shard's frames, the encoder's
        self-attention gathers K/V over the model group, and the cache
        takes this shard's frames of the cross K/V (``dist.serve``)."""
        self._check_family()
        cfg = self.cfg
        if ctx is None:
            ctx = L.ShardCtx(param_gather=gather)
        params = ctx.gather(params, "static")
        enc = self._encode(params, audio, ctx, backend, train=False)
        for i in range(cfg.n_layers):
            p = ctx.gather(layer_slice(params["blocks"], i), "blocks")
            ck, cv = self._enc_kv(p["xattn"], enc, backend)
            cache["ck"][i].copy_(ck)
            cache["cv"][i].copy_(cv)
        return cache

    def _paged_writes(self, cache, q_pos, valid_q, page0: int = 0):
        """Write targets of tokens at ``q_pos`` (B, S) into the pool, the
        view's ownership mask and positions, and the table in the pool's
        own page ids. The pool holds the pages [page0, page0 + P) of the
        global ids in ``ptab`` (a pool split over the model axis,
        ``dist.serve``): a write to another shard's page drops, and only
        this shard's pages are valid view columns, so the combine across
        the shards counts each page once. K2 clamps the other ids."""
        ptab = cache["ptab"]
        P, ps = cache["pk"].shape[1], cache["pk"].shape[2]
        Bn, npag = ptab.shape
        S_view = npag * ps
        rows = torch.arange(Bn, device=ptab.device)[:, None]
        wslot = torch.clamp(q_pos // ps, 0, npag - 1).long()
        wloc = ptab[rows, wslot].long() - page0
        ok = valid_q & (q_pos < S_view) & (wloc >= 0) & (wloc < P)
        write = _DropScatter((torch.clamp(wloc, 0, P - 1).reshape(-1),
                              (q_pos % ps).long().reshape(-1)),
                             ok.reshape(-1))
        # (B, npag) -> (B, S_view), each page's ps rows
        own = (ptab >= page0) & (ptab < page0 + P)
        extra_valid = own[:, :, None].expand(Bn, npag, ps).reshape(Bn, -1)
        view_pos = torch.arange(S_view, device=ptab.device)
        local = ptab - page0 if page0 else ptab
        return write, extra_valid, view_pos, local

    def _lane_writes(self, cache, q_pos, valid_q):
        """Write targets of tokens at lane positions ``q_pos`` (B, S):
        rows outside [0, S) drop (another shard's part of a
        sequence-sharded lane)."""
        S = cache["k"].shape[2]
        Bn = q_pos.shape[0]
        rows = torch.arange(Bn, device=q_pos.device)[:, None].expand_as(q_pos)
        ok = valid_q & (q_pos < S) & (q_pos >= 0)
        return _DropScatter((rows.reshape(-1),
                             torch.clamp(q_pos, 0, S - 1).long().reshape(-1)),
                            ok.reshape(-1))

    def _mixer_step(self, p, h, cache, i, rows_ok, backend):
        """Layer i's SSD mixer on the normed input h against its cache
        lanes (one token: the recurrence; a chunk: the seeded scan); the
        new state and conv tail are written into the lanes in place, for
        the rows where ``rows_ok`` (None: every row). Returns the mixer's
        output."""
        lanes = {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}
        out, st = L.mamba2_mix(p["ssm"], h, self.cfg.ssm, self.cfg.d_model,
                               decode_cache=lanes, backend=backend)
        for name, dst in lanes.items():
            new = st[name].to(dst.dtype)
            if rows_ok is not None:
                new = torch.where(rows_ok.reshape(
                    (-1,) + (1,) * (new.dim() - 1)), new, dst)
            dst.copy_(new)
        return out

    def _layers(self, params, x, cache, q_pos, valid_q, attend,
                ctx: L.ShardCtx, backend, rows_ok=None):
        """The per-layer body shared by decode_step and decode_chunk:
        x (B, S, d) at positions q_pos (B, S); ``attend(q, kc, vc, view,
        window, meta_kv)`` runs the attention variant with the layer's
        window; ``rows_ok`` (B,) masks the SSD state writes (None:
        every row). An encoder-decoder layer runs its cross-attention
        against the slot's ``ck``/``cv`` after the self-attention.

        Under a sharded ``ctx`` (``dist.serve``) the fixed lanes hold the
        sequence positions [cp_index S_loc, (cp_index + 1) S_loc) and a
        page pool the pages [cp_index P_loc, (cp_index + 1) P_loc); a
        token is written only where its lane position or page is this
        shard's. The SSD state and conv tail are whole on every shard,
        which all run the same recurrence; the MoE layer keeps its
        experts local and exchanges tokens; the cross-attention gathers
        the frames of ``ck``/``cv``."""
        cfg = self.cfg
        Bn, S, _ = x.shape
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        paged = "pk" in cache
        if paged:
            write, extra_valid, view_pos, ptab = self._paged_writes(
                cache, q_pos, valid_q, ctx.cp_index() * cache["pk"].shape[1])
            view = dict(kv_positions=view_pos, extra_valid=extra_valid)
        elif "k" in cache:
            lane0 = ctx.cp_index() * cache["k"].shape[2]
            write = self._lane_writes(cache, q_pos - lane0 if lane0
                                      else q_pos, valid_q)
            view = {}
        thetas, windows = cfg.layer_rope_thetas(), cfg.layer_windows()
        for i in range(cfg.n_layers):
            p = ctx.gather(layer_slice(params["blocks"], i), "blocks")
            h = L.apply_norm(x, p["ln1"], cfg)
            if cfg.arch_type == "ssm":
                x = x + self._mixer_step(p, h, cache, i, rows_ok, backend)
                continue
            pa = p["attn"]
            q, k, v = self._qkv(pa, h, q_pos, thetas[i], backend)
            if paged:
                pk, pv = cache["pk"][i], cache["pv"][i]
                write(pk, k.reshape(Bn * S, K, hd))
                write(pv, v.reshape(Bn * S, K, hd))
                kc, vc = gather_pages_kv(pk, pv, ptab, backend=backend)
            else:
                kc, vc = cache["k"][i], cache["v"][i]
                write(kc, k.reshape(Bn * S, K, hd))
                write(vc, v.reshape(Bn * S, K, hd))
            attn = attend(q, kc, vc, view, windows[i],
                          self._meta_kv(pa, Bn, h.dtype))
            attn = L.pmatmul(attn.reshape(Bn, S, H * hd), pa["o"], backend)
            ssm_out = None
            if cfg.arch_type == "hybrid":
                ssm_out = self._mixer_step(p, h, cache, i, rows_ok, backend)
            attn = self._mix(attn, ssm_out, p)
            x = x + self._post(attn, p, "ln1_post")
            if cfg.arch_type == "encdec":
                x = x + self._cross(p["xattn"],
                                    L.apply_norm(x, p["ln_x"], cfg),
                                    cache["ck"][i], cache["cv"][i], backend,
                                    ctx)
            out, _ = self._ffn(p, L.apply_norm(x, p["ln2"], cfg), backend,
                               ctx)
            x = x + self._post(out, p, "ln2_post")
        return L.apply_norm(x, params["final_norm"], cfg)

    # ---------------- decode ----------------
    def decode_step(self, params, inputs, cache, pos, gather: Gather = None,
                    backend: Optional[str] = None,
                    write: Optional[torch.Tensor] = None,
                    ctx: Optional[L.ShardCtx] = None):
        """One-token decode. inputs: {"token": (B, 1)} or {"embeds": (B,
        1, d)}; pos: the token's position, scalar or (B,) per slot.
        Returns (logits (B, V), cache), the cache updated in place.
        ``gather`` is the per-layer parameter hook
        (``make_dequant_gather``); ``backend`` forces the kernels'
        implementation (default: by device); ``write``, (B,) bool, drops
        the K/V writes of the rows where it is False and keeps their SSM
        state and conv tail (a session's inactive slots, whose lanes the
        reference's step reverts). An encoder-decoder adds the
        sinusoidal positions of ``pos`` to the token embeddings (read on
        the device: the step stays one capturable graph) and attends to
        the cross caches :meth:`prefill_encoder` filled.

        ``ctx``: a sharded decode (``dist.serve.make_serve_step``; its
        ``param_gather`` in place of ``gather``): ``cache`` is this
        shard's, split along the sequence (fixed lanes), the pages (a
        pool) or the frames (``ck``/``cv``) over the model group, and the
        attention combines the shards' partial softmaxes
        (``layers.decode_attention``); see :meth:`_layers`."""
        self._check_family()
        cfg = self.cfg
        if ctx is None:
            ctx = L.ShardCtx(param_gather=gather)
        params = ctx.gather(params, "static")
        x = self._embed_in(params, inputs, "token")
        Bn = x.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        posv = pos.expand(Bn)[:, None]                          # (B, 1)
        if cfg.arch_type == "encdec":
            x = x + L.sinusoidal_positions(1, cfg.d_model,
                                           posv[:, 0]).to(x.dtype)
        valid = (torch.ones_like(posv, dtype=torch.bool) if write is None
                 else write.reshape(Bn, 1))

        def attend(q, kc, vc, view, window, meta_kv):
            return L.decode_attention(q, kc, vc, total_len=posv[:, 0] + 1,
                                      window=window, softcap=cfg.attn_softcap,
                                      meta_kv=meta_kv, ctx=ctx, **view)

        x = self._layers(params, x, cache, posv, valid, attend, ctx,
                         backend, rows_ok=write)
        return self._head(params, x, backend)[:, 0], cache

    def decode_chunk(self, params, inputs, cache, start, nvalid,
                     gather: Gather = None, backend: Optional[str] = None,
                     ctx: Optional[L.ShardCtx] = None):
        """Chunked prefill: advance B slots by one fixed-size chunk of
        prompt tokens. inputs: {"token": (B, Sq)} or {"embeds": (B, Sq,
        d)}; start: (B,) position
        of each slot's first chunk token; nvalid: (B,) valid tokens (the
        padded tail's writes are dropped). Returns (logits (B, V) of
        position start + nvalid - 1, cache updated in place). With SSD
        mixers the scan has no per-token validity: the caller dispatches
        only full chunks whose length is a multiple of ``ssm.chunk`` (the
        session's admission rule). The encoder-decoder family and a
        sharded ``ctx`` (mesh sessions admit by injection) are refused
        with the reference's messages."""
        self._check_family()
        cfg = self.cfg
        if ctx is not None and ctx.sharded:
            raise NotImplementedError("decode_chunk is local-only")
        if cfg.arch_type == "encdec":
            raise NotImplementedError(
                "enc-dec serving prefills via prefill()")
        if ctx is None:
            ctx = L.ShardCtx(param_gather=gather)
        params = ctx.gather(params, "static")
        x = self._embed_in(params, inputs, "token")
        Bn, Sq, _ = x.shape
        dev = x.device
        start = torch.as_tensor(start, dtype=torch.int32, device=dev)
        nvalid = torch.as_tensor(nvalid, dtype=torch.int32, device=dev)
        ar = torch.arange(Sq, dtype=torch.int32, device=dev)[None, :]
        q_pos = start[:, None] + ar                             # (B, Sq)
        valid_q = ar < nvalid[:, None]

        def attend(q, kc, vc, view, window, meta_kv):
            return L.chunk_attention(q, kc, vc, q_pos=q_pos, window=window,
                                     softcap=cfg.attn_softcap,
                                     meta_kv=meta_kv, **view)

        x = self._layers(params, x, cache, q_pos, valid_q, attend, ctx,
                         backend)
        last = torch.clamp(nvalid - 1, 0, Sq - 1).long()
        xl = x[torch.arange(Bn, device=dev), last][:, None]     # (B, 1, d)
        return self._head(params, xl, backend)[:, 0], cache
