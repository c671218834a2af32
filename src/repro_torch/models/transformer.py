"""Decoder stacks (port of ``repro/models/transformer.py``): the dense,
MoE, hybrid (attention + SSM), xLSTM and VLM families' full-sequence
forward and loss, prefill (with the recurrent states of the hybrid and
xLSTM families), decode against the contiguous ``DecodeCache``, and paged
decode and chunked prefill into the page pool (every family with KV rows;
chunks full-attention KV-only models, as in the JAX package).

Params are a flat dict of tensors keyed by the JAX package's keypaths
(``embed``, ``final_norm/scale``, ``layers/attn/w_q`` ...); per-layer
leaves are stacked ``[L, ...]`` (xLSTM: ``xlstm/m/...`` and ``xlstm/s/...``
stacked ``[n_super, n_per_super, ...]``) and the stack is a Python loop
over layers (the JAX package scans). KV pools are updated in place where
the JAX package returns new (donated) buffers; so are the recurrent
states, row by row, where it selects with ``where``: a decode step leaves
the rows of inactive slots bit for bit as they were.

The audio family is the encoder-decoder of ``models/encdec.py``.

Under a model axis (``sharding.api.logical_axis_rules``, ROADMAP.md A18b,
A18c) every family runs on the rank's pieces of the parameters
(``sharding/partition.py``): a d-sharded embedding gathers its rows'
pieces (the VLM's replicated ``vision_proj`` then replaces the first
positions); a tied unembedding is row-parallel (``embed.T`` on the rank's
slice of d) and takes ``reduce_out``, an untied ``lm_head`` is
vocab-parallel and gathers its logits; cross entropy and greedy argmax
then see the full logits on every rank. The hybrid layer fuses the
completed attention and SSM outputs (attention sharded or replicated on
its own rule); the xLSTM blocks run on the rank's heads. Caches and pools
hold the rank's kv heads, SSM channels and xLSTM heads
(``init_cache``/``init_paged_cache(model_size=)``).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (Params, ProductTape, apply_norm, cross_entropy,
                                       dense_init, embed_init, mlp_apply, mlp_init,
                                       norm_init, rmsnorm, run_with_tape, tp, wmatmul)
from repro_torch.sharding import api
from repro_torch.sharding.partition import layout

FULL_SEQUENCE_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm")


def check_full_sequence(cfg):
    """Raise for the families that are not decoder stacks of this module."""
    if cfg.family not in FULL_SEQUENCE_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} is not a decoder stack of "
            "models.transformer (the audio family is models.encdec, the toy "
            "models models.simple; models.model.build_model picks the module)")


def _prefixed(prefix: str, tree: Dict[str, torch.Tensor]) -> Params:
    return {f"{prefix}/{k}": v for k, v in tree.items()}


def _sub(p: Params, prefix: str) -> Params:
    """The leaves under ``prefix/``, keyed without it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + "/")}


def _xlstm_counts(cfg):
    pat = cfg.xlstm_pattern
    return cfg.num_layers // len(pat), pat.count("m"), pat.count("s")


def init_params(cfg, gen: Optional[torch.Generator] = None, *, seed: int = 0,
                device=None) -> Params:
    """Random params, drawn from ``gen`` (or a fresh generator seeded with
    ``seed``) on ``device`` (default ``cuda``), with the keys and shapes of
    the JAX package's ``init_params``. Weights N(0, 1/in_dim), embeddings
    N(0, 0.02^2), norm scales and biases zero, the router N(0, 0.02^2), as
    there (the draws themselves differ). ``learned_pos`` adds ``pos_embed``
    (max(encoder_seq, 32768) rows), the VLM family ``vision_proj``."""
    check_full_sequence(cfg)
    dev = resolve_device(device)
    if gen is None and dev.type != "meta":  # meta: the shapes alone, nothing drawn
        gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    L, d = cfg.num_layers, cfg.d_model
    p: Params = {"embed": embed_init(gen, cfg.vocab_size, d, dt, dev)}
    p.update(_prefixed("final_norm", norm_init(cfg, d, dev)))
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab_size, dt, dev)
    if cfg.learned_pos:
        max_pos = max(cfg.encoder_seq, 2048 if cfg.family == "toy" else 32768)
        p["pos_embed"] = embed_init(gen, max_pos, d, dt, dev)
    if cfg.vision_dim:
        p["vision_proj"] = dense_init(gen, cfg.vision_dim, d, dt, dev)
    if cfg.family == "ssm":  # xLSTM: [n_super, n_per_super, ...] stacks
        n_super, n_m, n_s = _xlstm_counts(cfg)
        for kind, n, init in (("m", n_m, xlstm_mod.mlstm_init), ("s", n_s, xlstm_mod.slstm_init)):
            lead = (n_super, n)
            p.update(_prefixed(f"xlstm/{kind}_norm", norm_init(cfg, d, dev, lead)))
            p.update(_prefixed(f"xlstm/{kind}", init(gen, cfg, d, dt, dev, lead)))
        return p
    lead = (L,)
    p.update(_prefixed("layers/norm1", norm_init(cfg, d, dev, lead)))
    p.update(_prefixed("layers/norm2", norm_init(cfg, d, dev, lead)))
    p.update(_prefixed("layers/attn", attn.attn_init(gen, cfg, d, dt, dev, lead)))
    if cfg.is_moe:
        p.update(_prefixed("layers/moe", moe_mod.moe_init(gen, cfg, d, dt, dev, lead)))
    elif cfg.d_ff:
        p.update(_prefixed("layers/mlp", mlp_init(gen, cfg, d, cfg.d_ff, dt, dev, lead)))
    if cfg.hybrid_parallel_ssm:
        p.update(_prefixed("layers/ssm", ssm_mod.ssm_init(gen, cfg, d, dt, dev, lead)))
        # per-branch output norms of the hybrid fusion (Hymba eq. 2)
        for name in ("attn_out_norm", "ssm_out_norm"):
            p[f"layers/{name}/scale"] = torch.zeros((L, d), dtype=torch.float32, device=dev)
    return p


def layer_params(p: Params, num_layers: int, stack: str = "layers") -> List[Params]:
    """Per-layer views of the stacked ``{stack}/*`` leaves, keyed without
    the ``{stack}/`` prefix (``attn/w_q``); the encoder-decoder's stacks are
    ``enc_layers`` and ``dec_layers``."""
    out: List[Params] = [{} for _ in range(num_layers)]
    for k, v in _sub(p, stack).items():
        for i, t in enumerate(torch.unbind(v)):
            out[i][k] = t
    return out


def _rows(cfg, table, idx):
    """Rows ``idx`` of an embedding table; a d-sharded table's pieces are
    gathered (``api.gather_last``)."""
    h = table[idx]
    return api.gather_last(h) if tp(cfg).embed else h


def embed_tokens(cfg, p: Params, batch):
    """``batch["tokens"]`` [B, S] -> [B, S, d] in the compute type. The VLM
    family's ``batch["patches"]`` [B, P, vision_dim] through
    ``vision_proj`` replace the first P positions; with P > S the patches
    are ignored, as in the JAX package. ``learned_pos`` adds
    ``pos_embed[:S]``."""
    dt = getattr(torch, cfg.compute_dtype)
    h = _rows(cfg, p["embed"], batch["tokens"].long()).to(dt)
    if cfg.vision_dim and "patches" in batch:
        pe = wmatmul(batch["patches"], p["vision_proj"]).to(dt)
        if pe.shape[1] <= h.shape[1]:
            h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    if cfg.learned_pos:
        h = h + _rows(cfg, p["pos_embed"], slice(0, h.shape[1]))[None].to(dt)
    return h


def unembed(cfg, p: Params, h):
    """Final norm, then the logits [..., V], full on every rank: a tied
    unembedding under a d-sharded embedding is row-parallel (the rank's
    slice of d against its rows of ``embed.T``, then ``reduce_out``); a
    vocab-parallel ``lm_head`` is column-parallel and gathers its
    logits."""
    h = apply_norm(cfg, p, "final_norm", h)
    lay = tp(cfg)
    if cfg.tie_embeddings:
        if not lay.embed:
            return wmatmul(h, p["embed"].T)
        n = p["embed"].shape[-1]
        r = api.model_rank()
        return api.reduce_out(wmatmul(api.copy_in(h)[..., r * n:(r + 1) * n], p["embed"].T))
    if lay.vocab:
        return api.gather_last(wmatmul(api.copy_in(h), p["lm_head"]))
    return wmatmul(h, p["lm_head"])


def _ffn(cfg, lp: Params, h, token_mask=None):
    """h plus the layer's FFN (MoE or MLP) on ``norm2(h)`` -> (h, the
    router's aux loss, or None without a router)."""
    if cfg.is_moe:
        y, aux = moe_mod.moe_apply(cfg, _sub(lp, "moe"), apply_norm(cfg, lp, "norm2", h),
                                   token_mask=token_mask)
        return h + y, aux
    if cfg.d_ff:
        h = h + mlp_apply(cfg, lp, apply_norm(cfg, lp, "norm2", h))
    return h, None


def _hybrid_fuse(cfg, lp: Params, a_out, s_out):
    """The mean of the two branches, each through its own rmsnorm (the JAX
    package uses rmsnorm here whatever ``cfg.norm``)."""
    a = rmsnorm(a_out, lp["attn_out_norm/scale"])
    s = rmsnorm(s_out, lp["ssm_out_norm/scale"])
    return 0.5 * (a + s)


def _mixer(cfg, lp: Params, hn, attn_out, state=None):
    """The layer's token mixing on ``hn = norm1(h)`` -> (mix, the SSM's new
    state or None): the attention output, or for the hybrid family its
    fusion with the SSM branch on ``hn``, run from ``state`` (None: zero)."""
    if not cfg.hybrid_parallel_ssm:
        return attn_out, None
    s_out, st = ssm_mod.ssm_apply(cfg, _sub(lp, "ssm"), hn, state)
    return _hybrid_fuse(cfg, lp, attn_out, s_out), st


# ---------------------------------------------------------------------------
# forward / loss (full sequence)
# ---------------------------------------------------------------------------


class _Block:
    """The block a :class:`_Remat` runs: ``fn`` (tensors in, a tuple of
    tensors out, closing over no tensor) and whether it keeps its weight
    products (``dots``); ``n_out`` is set by each forward."""

    def __init__(self, fn, dots: bool):
        self.fn, self.dots, self.n_out = fn, dots, 0


class _Remat(torch.autograd.Function):
    """Rematerialization of one block: ``apply(block, *tensors)`` runs
    ``block.fn(*tensors)`` (a tuple of tensors) without keeping its
    activations and saves only its inputs; the backward runs ``fn`` again
    through ``torch.func.vjp`` on them, differentiating the floating-point
    ones (integer inputs such as positions ride along). ``fn`` must close
    over no tensor: a tensor made inside a ``torch.func`` transform and
    read from a closure is not visible at the level where the block runs.

    ``block.dots`` (``remat="dots"``, the JAX package's
    ``dots_with_no_batch_dims_saveable``): the forward also returns the
    outputs of the block's weight products (``layers.wmatmul``, recorded
    on a ``ProductTape``) and they are saved with the inputs; the
    recompute hands them back in order instead of computing them
    (``layers._SavedProduct``, whose backward is the product's own), and
    recomputes the rest. Gradients keep the bits of ``remat=True``.

    The logical-axis context (``sharding.api``) active at the forward is
    re-entered for the recompute, so a block under a model axis issues
    the same collectives in the backward, in the same order, wherever the
    backward runs.

    Written for ``torch.func`` (``forward`` without ctx,
    ``setup_context``, a generated ``vmap`` rule), so it composes with the
    round's ``vmap(grad_and_value)`` and with the rmsnorm op's own
    ``vmap`` rule inside ``fn``. ``torch.utils.checkpoint`` cannot serve
    here: its non-reentrant form rests on saved-tensor hooks, which
    ``torch.func``'s transforms refuse, and its reentrant form has no
    ``setup_context``. The recompute runs the same ops on the same inputs,
    so it rebuilds the forward's values (MoE routing included) bit for
    bit."""

    generate_vmap_rule = True

    @staticmethod
    def forward(block, *args):
        if not block.dots:
            out = block.fn(*args)
            block.n_out = len(out)
            return out
        tape = ProductTape()
        out = run_with_tape(tape, block.fn, *args)
        block.n_out = len(out)
        return (*out, *tape.saved)

    @staticmethod
    def setup_context(ctx, inputs, output):
        block = inputs[0]
        ctx.block, ctx.n_in = block, len(inputs) - 1
        ctx.rules = api.current_context()
        kept = output[block.n_out:] if block.dots else ()
        ctx.save_for_backward(*inputs[1:], *kept)

    @staticmethod
    def backward(ctx, *grads):
        # torch.func's grad runs the backward with create_graph=True: were
        # the recompute's inputs and cotangents still tracked here, its
        # backward would be recorded, and that graph would keep every
        # block's recomputed activations alive to the end of the whole
        # backward. Detached, nothing is recorded at this level. Grad mode
        # itself stays as the caller set it: some backward formulas depend
        # on it (SiLU's), and turning it off would change the bits.
        saved = [t.detach() for t in ctx.saved_tensors]
        args, kept = saved[:ctx.n_in], saved[ctx.n_in:]
        block = ctx.block
        grads = tuple(g.detach() for g in grads[:block.n_out])
        diff = [i for i, a in enumerate(args) if a.is_floating_point()]

        def fn(*xs):
            full = list(args)
            for i, x in zip(diff, xs):
                full[i] = x
            return run_with_tape(ProductTape(kept) if block.dots else None, block.fn, *full)

        with api.restored_context(ctx.rules):
            _, pull = torch.func.vjp(fn, *(args[i] for i in diff))
            pulled = pull(grads)
        out = [None] * len(args)
        for i, g in zip(diff, pulled):
            out[i] = g
        return (None, *out)


def _remat_wrap(body, remat):
    """``body(h, lp, *extra) -> tuple of tensors`` -> the same function,
    rematerialized when ``remat`` is True (the JAX package's
    ``jax.checkpoint`` around a block) or ``"dots"`` (the same, keeping the
    block's weight products): the block's tensors (``h``, the extra
    tensors and the leaves of the params dict ``lp``) go to
    :class:`_Remat` flat; ``body`` closes over everything else, which
    must hold no tensor. ``remat=False`` returns ``body`` itself."""
    if remat is False:
        return body
    if not (remat is True or (isinstance(remat, str) and remat == "dots")):
        raise ValueError(f'remat must be True, False or "dots", got {remat!r}')
    dots = remat == "dots"

    def run(h, lp: Params, *extra):
        keys, n = list(lp), len(extra)

        def flat(h, *xs):
            return body(h, dict(zip(keys, xs[n:])), *xs[:n])

        block = _Block(flat, dots)
        out = _Remat.apply(block, h, *extra, *lp.values())
        return tuple(out[:block.n_out]) if dots else out

    return run


def layer_apply(cfg, lp: Params, h, positions, impl: str = "auto", window=None):
    """One decoder layer -> (h, aux): the router's aux loss for the MoE
    family, a float32 zero otherwise."""
    hn = apply_norm(cfg, lp, "norm1", h)
    a_out = attn.attention_block(cfg, lp, hn, positions, impl=impl, window=window)
    h, aux = _ffn(cfg, lp, h + _mixer(cfg, lp, hn, a_out)[0])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def _blocks(sp: Params, kind: str, n: int):
    """Views of a super-block's ``n`` blocks of ``kind`` (m or s): each
    ``(norm leaves keyed norm/*, cell leaves keyed without a prefix)``.
    Views by ``unbind``, as ``layer_params`` makes them: its backward
    stacks the blocks' gradients into one buffer, where indexing block by
    block would add a zero buffer of the whole leaf for each block."""
    norms = layer_params(sp, n, f"{kind}_norm")
    return [({f"norm/{k}": v for k, v in nm.items()}, cell)
            for nm, cell in zip(norms, layer_params(sp, n, kind))]


def _row_update(old, new, active=None) -> None:
    """Write the state ``new`` into ``old`` in place (NamedTuples of tensors
    whose batch axis leads): on every row, or with ``active`` [B] on its rows
    only, the others keeping their bits (the JAX package's ``_row_select``)."""
    for o, n in zip(old, new):
        if active is not None:
            n = torch.where(active.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
        o.copy_(n)


def _xlstm_stack(cfg, p: Params, h, cache=None, active=None, remat=True):
    """Super-blocks in order; each runs its mLSTM blocks, then its sLSTM
    blocks, every block pre-normed with a residual (``_xlstm_stack`` of the
    JAX package). Without ``cache`` every block starts from a zero state
    (the forward), and ``remat`` rematerializes each super-block, as in
    the JAX package. With one (a ``DecodeCache`` whose xLSTM leaves are
    ``[n_super, n_per, B, ...]``) each block starts from its state there
    and writes its final state back in place, on the rows of ``active``
    only when given (prefill's ``_xlstm_prefill_states`` and decode's
    ``_xlstm_decode``); ``remat`` does not apply there."""
    n_super, n_m, n_s = _xlstm_counts(cfg)
    cells = (("m", n_m, xlstm_mod.mlstm_apply), ("s", n_s, xlstm_mod.slstm_apply))
    if cache is None:
        def super_block(h, sp):
            for kind, n, apply in cells:
                for norm, cell in _blocks(sp, kind, n):
                    h = h + apply(cfg, cell, apply_norm(cfg, norm, "norm", h), None)[0]
            return (h,)

        block = _remat_wrap(super_block, remat)
        for sp in layer_params(p, n_super, "xlstm"):
            (h,) = block(h, sp)
        return h
    for i, sp in enumerate(layer_params(p, n_super, "xlstm")):
        for kind, n, apply in cells:
            states = cache.xlstm_m if kind == "m" else cache.xlstm_s
            for j, (norm, cell) in enumerate(_blocks(sp, kind, n)):
                st = type(states)(*(x[i, j] for x in states))
                y, new = apply(cfg, cell, apply_norm(cfg, norm, "norm", h), st)
                _row_update(st, new, active)
                h = h + y
    return h


def forward(cfg, p: Params, batch, impl: str = "auto", window=None, remat=True, unroll=1):
    """-> (logits [B, S, V], aux loss: the routers' mean over layers, 0
    without). ``impl`` picks the attention (``attention.attention_block``);
    ``window=None`` applies the config's. ``remat`` (True by default, as
    in the JAX package) rematerializes each decoder layer, or each xLSTM
    super-block, for the backward: a gradient call keeps only the blocks'
    inputs and runs every block's forward twice, so the rmsnorm kernel
    launches 4L + 1 times a gradient call against 2L + 1 with
    ``remat=False`` or under ``no_grad``; values and gradients are the
    same bits either way. ``"dots"`` keeps each block's weight products
    and recomputes the rest (the same launches and bits as True). ``unroll``
    is the JAX package's scan-unrolling compile knob and is ignored: this
    runs eagerly, layer by layer."""
    del unroll
    check_full_sequence(cfg)
    h = embed_tokens(cfg, p, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        return unembed(cfg, p, _xlstm_stack(cfg, p, h, remat=remat)), aux
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def body(h, lp, positions):
        return layer_apply(cfg, lp, h, positions, impl=impl, window=window)

    layer = _remat_wrap(body, remat)
    for lp in layer_params(p, cfg.num_layers):
        h, a = layer(h, lp, positions)
        aux = aux + a
    return unembed(cfg, p, h), aux / max(cfg.num_layers, 1)


def loss_fn(cfg, p: Params, batch, impl: str = "auto", window=None, remat=True, unroll=1):
    """-> (cross entropy + aux, {"ce", "aux"}); ``batch["loss_mask"]``
    optional; ``remat`` and ``unroll`` as in :func:`forward`."""
    logits, aux = forward(cfg, p, batch, impl=impl, window=window, remat=remat,
                          unroll=unroll)
    ce = cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: the contiguous cache, decode and prefill
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    """The contiguous decode cache of a batch of slots: KV rows (leaves
    ``[L, B, W, ...]``) and, for the hybrid family, the SSM state
    (``[L, B, ...]``); the xLSTM family has only its recurrent states
    (``[n_super, n_per, B, ...]``)."""

    kv: Optional[attn.KVCache]
    ssm: Optional[ssm_mod.SSMState] = None
    xlstm_m: Optional[xlstm_mod.MLSTMState] = None
    xlstm_s: Optional[xlstm_mod.SLSTMState] = None


def _stacked(state, lead):
    """Every leaf of a state NamedTuple repeated over the axes ``lead``, each
    in storage of its own: the cache is written in place, and leaves may
    share a tensor (sLSTM's c and h start as one zero tensor), which an
    expand over axes of size 1 followed by ``contiguous`` would keep."""
    return type(state)(*(x.expand(tuple(lead) + x.shape).clone(
        memory_format=torch.contiguous_format) for x in state))


def init_cache(cfg, batch: int, seq_len: int, window: int = 0, device=None,
               model_size: int = 1) -> DecodeCache:
    """An empty ``DecodeCache`` of ``batch`` slots on ``device`` (default
    ``cuda``): KV rows of ``seq_len`` slots, or a ring of ``window or
    cfg.sliding_window``; zero SSM states for the hybrid family; the xLSTM
    family's initial states. ``model_size``: a rank's share under a model
    axis of that extent (its kv heads, SSM channels, xLSTM heads)."""
    check_full_sequence(cfg)
    dev = resolve_device(device)
    lay = layout(cfg, model_size)
    if cfg.family == "ssm":
        n_super, n_m, n_s = _xlstm_counts(cfg)
        d, H = cfg.d_model, lay.xlstm_heads
        return DecodeCache(
            kv=None,
            xlstm_m=_stacked(xlstm_mod.init_mlstm_state(cfg, batch, d, device=dev, heads=H),
                             (n_super, n_m)),
            xlstm_s=_stacked(xlstm_mod.init_slstm_state(cfg, batch, d, device=dev, heads=H),
                             (n_super, n_s)))
    kv = attn.init_kv_cache(cfg, batch, seq_len, window=window or cfg.sliding_window,
                            device=dev, n_layers=cfg.num_layers, kv_heads=lay.kv_heads)
    return DecodeCache(kv=kv, ssm=_ssm_rows(cfg, batch, dev, lay))


def _ssm_rows(cfg, batch: int, device, lay):
    """Zero SSM states of ``batch`` rows stacked ``[L, batch, ...]`` at
    ``lay``'s channels for the hybrid family, None for the others."""
    if not cfg.hybrid_parallel_ssm:
        return None
    st = ssm_mod.init_ssm_state(cfg, batch, cfg.d_model, dtype=getattr(torch, cfg.param_dtype),
                                device=device, channels=lay.ssm_channels)
    return _stacked(st, (cfg.num_layers,))


def _layer_ssm(ssm, l: int):
    return None if ssm is None else ssm_mod.SSMState(*(x[l] for x in ssm))


def _decode_layer(cfg, lp: Params, h, attend, ssm_l, active):
    """One decoder layer on a one-token batch h [B, 1, d]. ``attend(hn)`` is
    the attention sub-block against the layer's cache; the hybrid family's
    SSM rows ``ssm_l`` advance in place on active rows; MoE layers route
    inactive rows behind live ones (``token_mask``), so they never take an
    expert's capacity from a live row."""
    hn = apply_norm(cfg, lp, "norm1", h)
    mix, new = _mixer(cfg, lp, hn, attend(hn), ssm_l)
    if new is not None:
        _row_update(ssm_l, new, active)
    h, _ = _ffn(cfg, lp, h + mix, None if active is None else active[:, None])
    return h


def _embed_step(cfg, p: Params, token, pos):
    """token [B] -> [B, 1, d] in the compute type, plus ``pos_embed[pos]``
    where the config has learned positions."""
    h = _rows(cfg, p["embed"], token.long())[:, None].to(getattr(torch, cfg.compute_dtype))
    if cfg.learned_pos:
        h = h + _rows(cfg, p["pos_embed"], pos.long())[:, None].to(h.dtype)
    return h


def decode_step(cfg, p: Params, cache: DecodeCache, token, pos, window: int = 0, unroll=1,
                cache_update: str = "kernel", active=None):
    """token [B], pos [B] -> (logits [B, V], cache): one token a slot against
    the contiguous cache, which is updated in place (the returned cache is
    ``cache``).

    ``active``: optional bool [B] slot mask; inactive rows leave every
    cache leaf (KV, SSM state, xLSTM state) bit for bit as it was and, in
    MoE layers, never compete for expert capacity; their logits are
    garbage the caller ignores. ``cache_update``: "mask" or an indexed
    write (any other value, as in the JAX package: no TPU kernel touches
    this cache). ``unroll`` is the JAX package's scan knob and is ignored.
    """
    del unroll
    check_full_sequence(cfg)
    h = _embed_step(cfg, p, token, pos)
    if cfg.family == "ssm":
        h = _xlstm_stack(cfg, p, h, cache, active)
        return unembed(cfg, p, h)[:, 0], cache
    W = window or cfg.sliding_window
    for l, lp in enumerate(layer_params(p, cfg.num_layers)):
        kv_l = attn.KVCache(cache.kv.k[l], cache.kv.v[l], cache.kv.pos[l])

        def attend(hn):
            return attn.decode_attention_block(cfg, lp, hn, kv_l, pos, window=W,
                                               cache_update=cache_update, active=active)

        h = _decode_layer(cfg, lp, h, attend, _layer_ssm(cache.ssm, l), active)
    return unembed(cfg, p, h)[:, 0], cache


def insert_cache_slot(cache: DecodeCache, one: DecodeCache, slot: int) -> DecodeCache:
    """Admission: write one request's ``DecodeCache`` (batch 1) into row
    ``slot`` of every leaf in place; the JAX package's one-hot ``where``
    over all slots leaves the same bits. Returns ``cache``."""
    if cache.kv is not None:
        attn.insert_kv_slot(cache.kv, one.kv, slot)
    for leaves, rows, axis in ((cache.ssm, one.ssm, 1), (cache.xlstm_m, one.xlstm_m, 2),
                               (cache.xlstm_s, one.xlstm_s, 2)):
        if leaves is not None:
            for dst, src in zip(leaves, rows):
                dst.select(axis, slot).copy_(src.select(axis, 0))
    return cache


def prefill(cfg, p: Params, batch, *, impl: str = "auto", window: int = 0, pad_to: int = 0,
            unroll=1, length=None):
    """Whole-prompt forward -> (last-token logits [B, V], DecodeCache).

    ``impl`` picks the attention, as in :func:`forward`. ``window``: ring
    size of the cache, ``W = window or cfg.sliding_window``, so a
    full-attention model can prefill into a ``window``-slot ring for ring
    decode, as in the JAX package. ``pad_to``: full-attention cache
    capacity. ``length``: optional int [B] true prompt lengths of
    right-padded prompts (full-attention KV-only models): logits come from
    position length-1 and padded cache slots get pos -1. ``unroll`` is the
    JAX package's scan-unrolling compile knob and is ignored here.

    Attention applies ``window``, or the config's sliding window when it
    is 0, as the JAX package's ``forward`` does. (The JAX ``prefill``
    passes only ``window`` and so attends fully for prompts longer than
    the config's window, ROADMAP.md P1/R1; for S <= W the two agree.)
    MoE layers route the padded tokens behind live ones (``token_mask``),
    so padding never displaces a live token; the capacity still counts the
    padded tokens, as in the JAX package. The hybrid family's cache holds
    each layer's final SSM state beside its KV rows; the xLSTM family's
    holds only its blocks' final states (it takes no ``pad_to``). The
    recurrent families prefill at the exact prompt length: their states
    would absorb padding.
    """
    del unroll
    check_full_sequence(cfg)
    if length is not None and (cfg.family == "ssm" or cfg.hybrid_parallel_ssm):
        raise ValueError(
            "prefill(length=) needs a KV-only cache; recurrent families "
            "must prefill at the exact prompt length")
    W = window or cfg.sliding_window
    if length is not None and W:
        raise ValueError(
            "prefill(length=) is full-attention only: the ring buffer keeps "
            "the last `window` slots of the PADDED prompt, dropping live "
            "tokens — prefill SWA models at the exact prompt length")
    h = embed_tokens(cfg, p, batch)
    B, S = h.shape[:2]
    if cfg.family == "ssm":  # the blocks' final states, captured
        cache = init_cache(cfg, B, S, device=h.device, model_size=api.model_size())
        h = _xlstm_stack(cfg, p, h, cache)
        return unembed(cfg, p, h[:, -1:])[:, 0], cache
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    # pad tokens must not compete for MoE expert capacity
    live = None if length is None else (
        positions[None, :].long() < length.to(h.device).long()[:, None])
    ks, vs, ps_, ssm = [], [], [], []
    for lp in layer_params(p, cfg.num_layers):
        hn = apply_norm(cfg, lp, "norm1", h)
        kv = attn.prefill_kv_cache(cfg, lp, hn, positions, window=W, pad_to=pad_to)
        mix, st = _mixer(cfg, lp, hn, attn.attention_block(cfg, lp, hn, positions, impl=impl,
                                                           window=window or None))
        if st is not None:
            ssm.append(st)
        h, _ = _ffn(cfg, lp, h + mix, live)
        ks.append(kv.k)
        vs.append(kv.v)
        ps_.append(kv.pos)
    kv = attn.KVCache(torch.stack(ks), torch.stack(vs), torch.stack(ps_))
    ssm_st = ssm_mod.SSMState(*(torch.stack(x) for x in zip(*ssm))) if ssm else None
    if length is None:
        logits = unembed(cfg, p, h[:, -1:])[:, 0]
    else:
        length = length.to(device=h.device, dtype=torch.int64)
        last = h.gather(1, (length - 1)[:, None, None].expand(B, 1, h.shape[2]))
        logits = unembed(cfg, p, last)[:, 0]
        kv = kv._replace(pos=torch.where(kv.pos < length[None, :, None], kv.pos,
                                         torch.full_like(kv.pos, -1)))
    return logits, DecodeCache(kv=kv, ssm=ssm_st)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------


class PagedDecodeCache(NamedTuple):
    """KV pool shared by every slot, leaves stacked [L, n_pages, page_size,
    Hkv, hd]. One page id addresses the same page in every layer, so the
    host-owned page table is passed per dispatch, not stored here. The
    hybrid family keeps each slot's SSM state dense beside it ([L, n_slots,
    ...]): recurrent state has nothing to page."""

    kv: attn.PagedKVPool
    ssm: Optional[ssm_mod.SSMState] = None


def init_paged_cache(cfg, n_slots: int, n_pages: int, page_size: int,
                     device=None, model_size: int = 1) -> PagedDecodeCache:
    """A pool of ``n_pages * page_size`` KV rows for ``n_slots`` slots on
    ``device`` (default ``cuda``); ``model_size``: a rank's share under a
    model axis of that extent (its kv heads and SSM channels). The xLSTM
    family has no KV to page and raises, as in the JAX package."""
    check_full_sequence(cfg)
    if cfg.family == "ssm":
        raise ValueError(
            f"{cfg.name}: family='ssm' keeps O(1) recurrent state per slot "
            "— there is no KV cache to page; use init_cache/decode_step")
    dev = resolve_device(device)
    lay = layout(cfg, model_size)
    return PagedDecodeCache(
        kv=attn.init_paged_kv_pool(cfg, n_pages, page_size, dev, n_layers=cfg.num_layers,
                                   kv_heads=lay.kv_heads),
        ssm=_ssm_rows(cfg, n_slots, dev, lay))


def paged_decode_step(cfg, p: Params, cache: PagedDecodeCache, page_table,
                      token, pos, window: int = 0, cache_update: str = "kernel",
                      active=None):
    """token [B], pos [B], page_table [B, P] int32 -> (logits [B, V], cache):
    the paged sibling of :func:`decode_step`, with its guarantees for
    inactive rows (no KV write, SSM rows kept, no MoE capacity taken). The
    pool and the SSM rows are updated in place (the returned cache is
    ``cache``); inactive rows' logits are garbage."""
    check_full_sequence(cfg)
    h = _embed_step(cfg, p, token, pos)
    W = window or cfg.sliding_window
    for l, lp in enumerate(layer_params(p, cfg.num_layers)):
        pool = attn.PagedKVPool(cache.kv.k[l], cache.kv.v[l])

        def attend(hn):
            return attn.paged_decode_attention_block(
                cfg, lp, hn, pool, page_table, pos, window=W, cache_update=cache_update,
                active=active)

        h = _decode_layer(cfg, lp, h, attend, _layer_ssm(cache.ssm, l), active)
    return unembed(cfg, p, h)[:, 0], cache


class KernelExtendFallbackWarning(UserWarning):
    """Chunk prefill lowered ``cache_update="kernel"`` to the ``"scatter"``
    write.

    No TPU kernel writes a prefill chunk into the pool (the JAX package
    lowers these writes to its one-hot ``"mask"`` path), so the port has no
    CUDA kernel to run there either. It takes the indexed ``"scatter"``
    write instead: the same bits as ``"mask"``, without a selector that
    spans the whole pool. Decode and whole-prompt admission keep their
    kernels.
    """


_KERNEL_EXTEND_WARNED = False


def warn_kernel_extend_fallback(site: str) -> None:
    """Warn once a process that chunk writes under ``cache_update="kernel"``
    take the plain ``"scatter"`` path; every lowering site routes through
    here, so the notice fires once whichever site reaches it first."""
    global _KERNEL_EXTEND_WARNED
    if _KERNEL_EXTEND_WARNED:
        return
    _KERNEL_EXTEND_WARNED = True
    warnings.warn(
        KernelExtendFallbackWarning(
            f"{site}: cache_update='kernel' has no chunk-prefill kernel (the "
            "JAX package has no Pallas one to port); chunk writes take the "
            "plain 'scatter' path, bitwise equal to 'mask' (decode and "
            "whole-prompt admission keep their kernels)"),
        stacklevel=3)


def extend_write(cache_update: str) -> str:
    """The pool write a chunk prefill takes under ``cache_update``."""
    return "scatter" if cache_update == "kernel" else cache_update


def paged_prefill_chunk(cfg, p: Params, cache: PagedDecodeCache, page_row, tokens,
                        start: int, length: int, unroll=1,
                        cache_update: str = "kernel"):
    """Prefill one chunk of a single request's prompt straight into the page
    pool (the serve loop's prefix caching and chunked prefill).

    tokens [1, C] covers absolute positions ``[start, start + length)`` of
    the slot whose page-table row is ``page_row`` [P]; rows >= ``length``
    are padding and never written. Returns (logits [1, V] at position
    ``start + length - 1``, cache), the pool updated in place: the logits
    matter only for a prompt's last chunk, where they give the first
    generated token as a whole-prompt prefill would. Earlier chunks and
    prefix pages shared from other slots are read back from the pool;
    ``param_dtype == compute_dtype`` makes that round trip the identity.

    ``cache_update="kernel"`` writes the chunk through ``"scatter"`` (see
    :class:`KernelExtendFallbackWarning`, raised once); ``"scatter"`` and
    ``"mask"`` write as named. ``unroll`` is the JAX package's scan knob
    and is ignored. Recurrent and sliding-window configs raise, as in the
    JAX package. MoE layers route the padding rows behind live ones.
    """
    del unroll
    if cfg.family == "ssm" or cfg.hybrid_parallel_ssm:
        raise ValueError(
            f"{cfg.name}: recurrent state cannot be chunk-prefilled — "
            "the SSM carry does not live in pool pages")
    if cfg.sliding_window:
        raise ValueError(
            f"{cfg.name}: chunked prefill is full-attention only — the SWA "
            "ring wraps KV writes into early (possibly shared) pages")
    if cache_update == "kernel":
        warn_kernel_extend_fallback("models.transformer.paged_prefill_chunk")
    cu = extend_write(cache_update)
    C = tokens.shape[1]
    h = _rows(cfg, p["embed"], tokens.long()).to(getattr(torch, cfg.compute_dtype))  # [1, C, d]
    positions = start + torch.arange(C, device=h.device)
    if cfg.learned_pos:
        h = h + _rows(cfg, p["pos_embed"], positions)[None].to(h.dtype)
    # pad rows must not compete for MoE expert capacity
    live = (torch.arange(C, device=h.device) < length)[None, :]
    for l, lp in enumerate(layer_params(p, cfg.num_layers)):
        pool = attn.PagedKVPool(cache.kv.k[l], cache.kv.v[l])
        a_out = attn.paged_prefill_attention_block(
            cfg, lp, apply_norm(cfg, lp, "norm1", h), pool, page_row, start, length,
            cache_update=cu)
        h, _ = _ffn(cfg, lp, h + a_out, live)
    last = h[:, max(length - 1, 0)][:, None]  # [1, 1, d]
    return unembed(cfg, p, last)[:, 0], cache


def insert_cache_pages(cache: PagedDecodeCache, one: DecodeCache, slot,
                       page_ids, cache_update: str = "kernel") -> PagedDecodeCache:
    """Admission: write one request's prefill cache (batch 1) into its pool
    pages ``page_ids`` [P] in place (-1 = unallocated, skipped). The
    prefill cache is zero-padded up to P * page_size rows so every
    allocated page is overwritten in full. ``cache_update="kernel"`` runs
    the layer-stacked insert kernel (one launch for the whole stack) for
    CUDA tensors; ``"scatter"`` its plain version; ``"mask"`` the JAX
    package's page selector and ``where`` over the whole pool. The hybrid
    family's SSM state lands in row ``slot`` of its dense rows."""
    ps = cache.kv.k.shape[2]
    P = page_ids.shape[0]
    cap, have = P * ps, one.kv.k.shape[2]
    k, v = one.kv.k, one.kv.v
    if have < cap:  # SWA ring of W rows with W not a page multiple
        pad = (0, 0, 0, 0, 0, cap - have)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    attn.insert_kv_pages(cache.kv, attn.KVCache(k, v, one.kv.pos), page_ids,
                         cache_update=cache_update)
    if cache.ssm is not None:  # [L, n_slots, ...]
        for dst, src in zip(cache.ssm, one.ssm):
            dst[:, slot].copy_(src[:, 0])
    return cache
