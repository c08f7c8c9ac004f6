"""Model API (port of ``repro.models.api``) for all seven families: the
attention families ``dense``, ``moe`` (an MoE block in place of the MLP;
with ``moe_every > 1`` only every ``moe_every``-th layer, llama4's
interleave), ``vlm`` (a projected prefix of stubbed patch embeddings
before the text) and ``encoder`` (projected stubbed frame embeddings,
non-causal, no cache and no decode); and the three constant-state
families ``ssm_rwkv6``, ``ssm_mamba2`` and ``hybrid`` (a Mamba2 backbone
with one shared attention block applied every ``attn_every`` layers).

    params = init_params(cfg, generator, device)
    logits, cache = prefill(params, batch, cfg)          # (B, V), caches
    logits, cache = decode_step(params, token, cache, pos, cfg)
    logits = forward_logits(params, batch, cfg)          # (B, S, V)
    loss, metrics = loss_fn(params, batch, cfg)          # training

``loss_fn`` runs ``backbone_fwd(..., train=True)``: each layer under
``torch.utils.checkpoint`` where ``cfg.remat`` is set, the MoE's
load-balancing term summed over layers, then the chunked cross-entropy
(``_chunked_ce``).  ``input_specs`` / ``make_inputs`` give the reference's
input shapes and dtypes for a ``ShapeConfig``.

``batch`` holds ``tokens`` (B, S) and, for the frontends, ``embeds``: the
encoder's (B, S, frontend_dim) frames in place of tokens, the VLM's
(B, n_vision_tokens, frontend_dim) patches before its tokens (logits
cover the text positions; the cache holds the prefix rows too).

and the slot surface of continuous batching:

    cache = prefill_into_slot(params, tokens, cache, slot, start, cfg)
    logits, cache = prefill_into_slot_logits(params, tokens, cache, slot, start, cfg)
    cache = reset_slot(cache, slot, cfg)                 # state families
    pool = init_paged_pool(cfg, n_pages, page_size, device)   # dense, moe, vlm
    logits, pool = decode_step_paged(params, token, pool, pos, pages, cfg)
    pool = prefill_into_slot_paged(params, tokens, pool, pages_row, start, cfg)
    logits, pool = prefill_into_slot_paged_logits(params, tokens, pool, pages_row, start, cfg)
    pool = copy_pool_page(pool, src, dst)

The single-model functions take the JAX package's parameter tree and cache
layouts: attention k, v (L, B, KVH, S, hd), layer l at row l (llama4's
interleave included); mamba2 conv (L, B, K-1, conv_dim)
and ssm (L, B, nh, N, P) f32; rwkv6 tm_x, cm_x (L, B, D) and wkv (L, B, H,
hd, hd) f32; hybrid the mamba2 leaves plus ``attn_k``/``attn_v``, one
(B, KVH, S, hd) leaf per shared-attention invocation; dense pools (L,
n_pages, KVH, page_size, hd).  Each is a thin wrapper over a ``*_members``
function that carries the ensemble axis E explicitly: parameters (E, ...)
with the stacked layer axis second, caches layer-major with E second —
(L, E, B, ...) — so one layer's slab is contiguous for the kernels, the
hybrid's per-invocation leaves (E, B, KVH, S, hd), and pools (L, E, P,
KVH, page_size, hd) under one page table.  The interleaved MoE stacks
keep the JAX package's tree, ``layers = {"dense": (n_groups * (moe_every
- 1) rows), "moe": (n_groups rows)}``; layer l of group l // moe_every is
its MoE layer when it is the group's last.  A Python loop over layers takes
the place of ``lax.scan``.  Caches and pools are updated IN PLACE (and
returned, so call sites read like the JAX package's).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks_dense as BD
from repro_torch.models import blocks_mamba2 as BM
from repro_torch.models import blocks_rwkv6 as BR
from repro_torch.models import layers as L
from repro_torch.models.params import AxesInitializer, Initializer, torch_dtype, tree_map
from repro_torch.sharding.logical import constrain

# the activation and logit layouts the JAX package constrains its
# (member-vmapped) arrays to, with the port's leading member axis: a no-op
# unless a rule table is active and the tensor is a DTensor (the dry run)
_ACT_AXES = ("act_ensemble", "act_batch", "act_seq", "act_embed")
_LOGIT_AXES = ("act_ensemble", "act_batch", "act_vocab")

ATTENTION_FAMILIES = ("dense", "moe", "vlm", "encoder")


def attention_family(cfg: ModelConfig) -> bool:
    """True where every layer is an attention layer over a KV cache (or,
    for the encoder, over the whole sequence)."""
    return cfg.family in ATTENTION_FAMILIES


def interleaved_moe(cfg: ModelConfig) -> bool:
    """MoE every ``moe_every``-th layer (llama4's interleave)."""
    return cfg.family == "moe" and cfg.moe_every > 1


def init_params(cfg: ModelConfig, generator: torch.Generator, device, *, lead=()):
    """Seeded parameters; ``lead=(k,)`` stacks k ensemble members.  The
    tree is the JAX package's: no ``embed`` for the encoder, a
    ``frontend.proj`` (frontend_dim, D) where the config has a frontend,
    the interleaved ``{"dense", "moe"}`` layer stacks for llama4."""
    return _init_tree(cfg, Initializer(generator, cfg.dtype, device, lead))


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``init_params``' tree, the tuples
    the JAX package's ``Box``es carry (``'layers'`` first on the stacked
    layer leaves): the ``axes`` of ``unbox(init_params(...))``."""
    return _init_tree(cfg, AxesInitializer())


def _init_tree(cfg: ModelConfig, ini):
    p = {}
    if not cfg.is_encoder:
        p["embed"] = ini.normal((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), std=0.02)
    if cfg.frontend_dim:
        p["frontend"] = {"proj": ini.normal((cfg.frontend_dim, cfg.d_model), (None, "embed"))}
    if interleaved_moe(cfg):
        me = cfg.moe_every
        assert cfg.n_layers % me == 0, (cfg.n_layers, me)
        n_groups = cfg.n_layers // me
        p["layers"] = {
            "dense": BD.init_dense_layer(ini.stacked(n_groups * (me - 1)), cfg),
            "moe": BD.init_dense_layer(ini.stacked(n_groups), cfg, moe=True),
        }
    elif attention_family(cfg):
        p["layers"] = BD.init_dense_layer(ini.stacked(cfg.n_layers), cfg, moe=cfg.family == "moe")
    elif cfg.family == "ssm_rwkv6":
        p["layers"] = BR.init_rwkv6_block(ini.stacked(cfg.n_layers), cfg)
    else:
        p["layers"] = BM.init_mamba2_block(ini.stacked(cfg.n_layers), cfg)
    if cfg.family == "hybrid" and cfg.attn_every:
        p["shared_attn"] = BD.init_dense_layer(ini, cfg)  # one block, shared by depth
    p["final_norm"] = L.init_norm(ini, cfg, cfg.d_model)
    if not cfg.tie_embeddings:
        p["lm_head"] = ini.normal((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), std=0.02)
    return p


def _members(params):
    return tree_map(lambda t: t[None], params)


def _anchor(params) -> torch.Tensor:
    """A leaf every model has, with the member axis first: the token
    embedding, or the encoder's frontend projection."""
    return params["embed"] if "embed" in params else params["frontend"]["proj"]


def param_device(params) -> torch.device:
    return _anchor(params).device


def member_count(params) -> int:
    return _anchor(params).shape[0]


def _layer(params, l: int, cfg: Optional[ModelConfig] = None):
    """Layer l's parameters, (E, ...) leaves; with llama4's interleave the
    last layer of each ``moe_every`` group comes from the ``moe`` stack
    (``cfg`` is needed only there)."""
    stack, i = params["layers"], l
    if cfg is not None and interleaved_moe(cfg):
        g, r = divmod(l, cfg.moe_every)
        stack, i = (stack["moe"], g) if r == cfg.moe_every - 1 else (stack["dense"], g * (cfg.moe_every - 1) + r)
    return tree_map(lambda t: t[:, i], stack)


def _tokens(batch, device) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=device).to(torch.int64)


def embed_inputs(params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) shared by all members, or (E, B, S) per member ->
    hidden (E, B, S, D)."""
    emb = params["embed"]
    if tokens.ndim == 2:
        return emb[:, tokens]
    return emb[torch.arange(emb.shape[0], device=emb.device)[:, None, None], tokens]


def _project_frontend(params, embeds, device) -> torch.Tensor:
    """Stubbed frontend embeddings (B, S, F), shared by the members, times
    each member's ``frontend.proj`` (E, F, D), in the promoted dtype of the
    two (as a JAX product of mixed dtypes) -> (E, B, S, D)."""
    proj = params["frontend"]["proj"]
    e = torch.as_tensor(embeds, device=device)
    dt = torch.promote_types(e.dtype, proj.dtype)
    return torch.einsum("bsf,efd->ebsd", e.to(dt), proj.to(dt))


def embed_batch(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """The hidden (E, B, S, D) a batch enters the backbone with: the
    encoder's projected frames; for the VLM with ``embeds`` its projected
    patches prepended to the token embeddings; else the token
    embeddings."""
    device = param_device(params)
    if cfg.is_encoder:
        tok = _project_frontend(params, batch["embeds"], device).to(torch_dtype(cfg.dtype))
    else:
        tok = embed_inputs(params, _tokens(batch, device))
        if _has_prefix(batch, cfg):
            vis = _project_frontend(params, batch["embeds"], device).to(tok.dtype)
            tok = torch.cat([vis, tok], dim=2)
    return constrain(tok, _ACT_AXES)


def _has_prefix(batch, cfg: ModelConfig) -> bool:
    return bool(cfg.n_vision_tokens) and "embeds" in batch


def _text_only(x, batch, cfg: ModelConfig):
    """Drop the vision prefix's positions (axis 2) before the head."""
    return x[:, :, cfg.n_vision_tokens:] if _has_prefix(batch, cfg) else x


def _pad_carveout(batch, S: int, cfg: ModelConfig, device):
    """(positions, starts) for a left-padded batch, or (None, None):
    positions are taken relative to each row's prompt start.  Recurrent
    families sweep the sequence unconditionally, so the carve-out cannot
    apply there; starts index the token grid, so a prepended vision prefix
    (which would shift every column the mask refers to) is refused too."""
    starts = batch.get("starts")
    if starts is None:
        return None, None
    _require_carveout(cfg)
    if _has_prefix(batch, cfg):
        raise ValueError("left-pad carve-out indexes token columns; unsupported with a prepended vision prefix")
    starts = torch.as_tensor(starts, device=device).to(torch.int32)
    return torch.arange(S, device=device)[None, :] - starts[:, None], starts


def _require_carveout(cfg: ModelConfig):
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"left-pad carve-out unsupported for family {cfg.family}")


def _require_decoder(cfg: ModelConfig):
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name}: an encoder-only model has no cache and no decode step")


def _state_keys(cfg: ModelConfig):
    """The constant-size recurrent state leaves: everything that is not
    position-masked, so a slot that admits a new request must zero them."""
    return ("tm_x", "cm_x", "wkv") if cfg.family == "ssm_rwkv6" else ("conv", "ssm")


def _attn_after(cfg: ModelConfig, l: int) -> bool:
    """True where the hybrid applies its shared attention block, after
    layer l; invocation ``l // attn_every`` owns that call's KV leaf."""
    return cfg.family == "hybrid" and bool(cfg.attn_every) and (l + 1) % cfg.attn_every == 0


def _recurrent_layer(params, l: int, x, cfg: ModelConfig, state, *, step: bool = False):
    """Layer l of a constant-state family over a sequence or chunk x
    (E, B, S, D), continuing ``state`` (None at a sequence start); with
    ``step`` the single-token decode form (x (E, B, 1, D)).  Returns
    (x, new state)."""
    return _recurrent_block(_layer(params, l, cfg), x, cfg, state, step=step)


def _recurrent_block(lp, x, cfg: ModelConfig, state, *, step: bool = False):
    """``_recurrent_layer`` on one layer's parameters ``lp``."""
    if cfg.family == "ssm_rwkv6":
        if step:
            return BR.rwkv6_step(lp, x, cfg, state)
        return BR.rwkv6_layer_fwd(lp, x, cfg, state=state)
    if step:
        out, state = BM.mamba2_step(lp, x, cfg, state)
    else:
        out, state = BM.mamba2_fwd(lp, x, cfg, initial=state)
    return x + out, state


def _write_kv(k_cache, v_cache, k, v):
    """Prefill K/V (E, B, S, KVH, hd) into rows [0, S) of (E, B, KVH, S', hd)."""
    S = k.shape[2]
    k_cache[:, :, :, :S] = k.permute(0, 1, 3, 2, 4)
    v_cache[:, :, :, :S] = v.permute(0, 1, 3, 2, 4)


def _remat(fn, on: bool):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) when ``on``:
    its activations are recomputed in the backward instead of kept — the
    counterpart of the JAX package's ``_maybe_remat``.  Its
    ``dots_with_no_batch_dims_saveable`` policy changes what is stored, not
    what is computed; here a layer keeps only its inputs."""
    if not on:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def backbone_fwd(params, x, cfg: ModelConfig, *, positions=None, starts=None, cache=None,
                 train: bool = False, window_override: Optional[int] = None):
    """Runs every layer over x (E, B, S, D).  With ``cache`` (from
    ``init_cache_members``, KV rows S' >= S) each attention layer's K/V
    are written into rows [0, S), each recurrent layer's final state into
    its layer slab, and each hybrid attention invocation's K/V into its
    leaf.  The encoder attends without the causal mask.
    ``window_override`` replaces ``cfg.sliding_window``.

    Returns x; with ``train`` (the training forward, no cache) ``(x, aux)``,
    aux the (E,) f32 sum of the MoE layers' load-balancing terms (zeros for
    the other families), each layer (and each call of the hybrid's shared
    block) under ``torch.utils.checkpoint`` when ``cfg.remat`` is set."""
    window = window_override if window_override is not None else cfg.sliding_window
    if train:
        return _backbone_train(params, x, cfg, window)
    if attention_family(cfg):
        for l in range(cfg.n_layers):
            x, (k, v) = BD.dense_layer_fwd(
                _layer(params, l, cfg), x, cfg, causal=not cfg.is_encoder, sliding_window=window,
                positions=positions, starts=starts,
            )
            if cache is not None:
                _write_kv(cache["k"][l], cache["v"][l], k, v)
        return x
    for l in range(cfg.n_layers):
        x, st = _recurrent_layer(params, l, x, cfg, None)
        if cache is not None:
            for name, t in st.items():
                cache[name][l] = t
        if _attn_after(cfg, l):
            x, (k, v) = BD.dense_layer_fwd(
                params["shared_attn"], x, cfg, causal=True, sliding_window=window,
            )
            if cache is not None:
                inv = l // cfg.attn_every
                _write_kv(cache["attn_k"][inv], cache["attn_v"][inv], k, v)
    return x


def _backbone_train(params, x, cfg: ModelConfig, window):
    remat = cfg.remat

    def attn_layer(lp, h, causal):
        h, a, _ = BD.dense_layer_fwd(lp, h, cfg, causal=causal, sliding_window=window, with_aux=True)
        return h, a

    def recurrent_layer(lp, h):
        return _recurrent_block(lp, h, cfg, None)[0]

    attn = _remat(attn_layer, remat)
    aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    if attention_family(cfg):
        for l in range(cfg.n_layers):
            x, a = attn(_layer(params, l, cfg), x, not cfg.is_encoder)
            aux = aux + a
        return x, aux
    recurrent = _remat(recurrent_layer, remat)
    for l in range(cfg.n_layers):
        x = recurrent(_layer(params, l), x)
        if _attn_after(cfg, l):
            x, _ = attn(params["shared_attn"], x, True)
    return x, aux


def forward_logits_members(params, batch, cfg: ModelConfig):
    """Full logits (E, B, S, V); for the VLM with a prefix, S the text
    positions."""
    x = embed_batch(params, batch, cfg)
    positions, starts = _pad_carveout(batch, x.shape[2], cfg, x.device)
    x = backbone_fwd(params, x, cfg, positions=positions, starts=starts)
    return L.project_logits(params, _text_only(x, batch, cfg), cfg)


def init_cache_members(cfg: ModelConfig, E: int, batch: int, max_seq: int, device, dtype=None):
    """Zero member caches, layer-major: attention k, v (L, E, B, KVH,
    max_seq, hd); mamba2 conv (L, E, B, K-1, conv_dim) and ssm (L, E, B, nh, N, P)
    f32; rwkv6 tm_x, cm_x (L, E, B, D) and wkv (L, E, B, H, hd, hd) f32;
    hybrid the mamba2 leaves plus ``attn_k``/``attn_v`` lists of one
    (E, B, KVH, max_seq, hd) leaf per shared-attention invocation."""
    _require_decoder(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    Lyr = cfg.n_layers
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    if attention_family(cfg):
        shape = (Lyr, E, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}
    init_state = BR.init_rwkv6_state if cfg.family == "ssm_rwkv6" else BM.init_mamba2_state
    layer = init_state(cfg, E, batch, dtype, device)  # one layer's state, for its shapes
    cache = {name: t.new_zeros((Lyr,) + tuple(t.shape)) for name, t in layer.items()}
    if cfg.family == "hybrid":
        n_inv = Lyr // cfg.attn_every
        kv = (E, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        cache["attn_k"] = [zeros(*kv) for _ in range(n_inv)]
        cache["attn_v"] = [zeros(*kv) for _ in range(n_inv)]
    return cache


def prefill_members(params, batch, cfg: ModelConfig, *, collect_kv=True, cache=None):
    """Prompt prefill for E members sharing the batch.  Returns
    (last-token logits (E, B, V), member caches as ``init_cache_members``
    lays them out with S KV rows, or None).  With ``cache`` (from
    ``init_cache_members``, KV rows S' >= S) the prompt's K/V land in rows
    [0, S) and the recurrent state in its leaves, in place, and that cache
    is returned: the static cache of a captured batch generation, whose
    decode steps write rows S.. of the same memory.  The encoder keeps no
    cache: its caches come back None.  A VLM's prefix rows are cache rows
    like the text's."""
    x = embed_batch(params, batch, cfg)
    E, B, S, _ = x.shape
    positions, starts = _pad_carveout(batch, S, cfg, x.device)
    if cfg.is_encoder:
        cache, collect_kv = None, False
    if cache is None and collect_kv:
        cache = init_cache_members(cfg, E, B, S, x.device, dtype=x.dtype)
    x = backbone_fwd(params, x, cfg, positions=positions, starts=starts, cache=cache)
    return constrain(L.project_logits(params, x[:, :, -1], cfg), _LOGIT_AXES), cache


def _positions(pos, B: int, device):
    """A Python or numpy int stays an int (the shared scalar position); a
    tensor or array, 0-d or (B,), becomes a (B,) int64 vector on the device
    (sent once, or used in place when it is there already).  A tensor is
    never read back to the host: inside a captured decode step that read
    would freeze the position."""
    if isinstance(pos, (int, np.integer)):
        return int(pos)
    return torch.as_tensor(pos, device=device).to(torch.int64).reshape(-1).expand(B)


def decode_step_members(params, token, cache, pos, cfg: ModelConfig, *, starts=None):
    """One new token per member.  ``pos`` is the shared scalar position (a
    Python int) or a (B,) vector of per-row positions (continuous batching,
    and every captured decode step: a 0-d tensor broadcasts to it).  token
    (E, B, 1); cache from ``init_cache_members``/``prefill_members``,
    updated in place.  Token and a vector ``pos`` already on the device
    are used as they are (no copy), as a captured decode step needs.
    Returns (logits (E, B, V), cache)."""
    _require_decoder(cfg)
    device = param_device(params)
    pos = _positions(pos, token.shape[1], device)
    if starts is not None:
        _require_carveout(cfg)
        starts = torch.as_tensor(starts, device=device).to(torch.int32)
    x = constrain(embed_inputs(params, torch.as_tensor(token, device=device).to(torch.int64)), _ACT_AXES)
    if attention_family(cfg):
        for l in range(cfg.n_layers):
            x = BD.dense_layer_decode(
                _layer(params, l, cfg), x, cfg, cache["k"][l], cache["v"][l], pos,
                sliding_window=cfg.sliding_window, starts=starts,
            )
        return constrain(L.project_logits(params, x[:, :, 0], cfg), _LOGIT_AXES), cache
    for l in range(cfg.n_layers):
        x, st = _recurrent_layer(params, l, x, cfg, {n: cache[n][l] for n in _state_keys(cfg)}, step=True)
        # written in place into the stacked leaf (never rebound): a
        # captured decode step writes the same addresses at every replay
        for name, t in st.items():
            cache[name][l] = t
        if _attn_after(cfg, l):
            inv = l // cfg.attn_every
            x = BD.dense_layer_decode(
                params["shared_attn"], x, cfg, cache["attn_k"][inv], cache["attn_v"][inv], pos,
                sliding_window=cfg.sliding_window,
            )
    return constrain(L.project_logits(params, x[:, :, 0], cfg), _LOGIT_AXES), cache


# ---------------------------------------------------------------------------
# training: loss (chunked over the sequence) and inputs
# ---------------------------------------------------------------------------


def _ce_chunk(h, head, t, m):
    """One chunk's sums: (nll, z, mask, correct), f32 (4,).  The logits
    (B, c, V) are f32 and live only inside this call."""
    # the vocabulary whole on each rank (the dry run's placed step: a
    # target gather from vocabulary-sharded logits is a masked partial
    # result DTensor cannot reduce); a no-op on plain tensors
    logits = constrain((h @ head).float(), ("act_batch", "act_seq", None))
    logz = torch.logsumexp(logits, -1)
    tgt = logits.gather(-1, t[..., None])[..., 0]
    acc = (logits.argmax(-1) == t).float()  # the first index of the maximum
    return torch.stack([((logz - tgt) * m).sum(), (logz.square() * m).sum(), m.sum(), (acc * m).sum()])


def _chunked_ce(params, hidden, targets, mask, cfg: ModelConfig, chunk: int = 512):
    """(mean cross-entropy, mean logz^2, accuracy) over the mask, for one
    model's ``params`` and hidden (B, S, D).  The sequence goes in chunks of
    ``min(chunk, S)`` positions, halved until the chunk divides S; each
    chunk runs under ``torch.utils.checkpoint`` when grad is on, so no more
    than one (B, chunk, V) block of f32 logits lives at once, in the
    forward or the backward."""
    B, S, D = hidden.shape
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    c = min(chunk, S)
    while S % c:  # e.g. the VLM's text length S - n_vision_tokens
        c //= 2
    c = max(c, 1)
    run = _remat(_ce_chunk, torch.is_grad_enabled())
    total = torch.zeros((4,), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, c):
        total = total + run(hidden[:, i:i + c], head, targets[:, i:i + c], mask[:, i:i + c])
    nll_sum, z_sum, n, correct = total.unbind()
    n = torch.clamp(n, min=1.0)
    return nll_sum / n, z_sum / n, correct / n


def loss_fn(params, batch, cfg: ModelConfig, *, window_override: Optional[int] = None):
    """(loss, metrics) of one model (the JAX package's tree, no member
    axis) on ``batch``: tokens (B, S) and targets (B, S), an optional mask
    (ones by default); the encoder's ``embeds`` frames in place of tokens;
    the VLM's ``embeds`` patches before its tokens, whose positions are
    dropped before the loss.  loss = ce + 1e-4 z_loss + aux, metrics
    ``ce``, ``z_loss``, ``acc`` and ``aux`` as f32 device scalars."""
    mp = _members(params)
    x = embed_batch(mp, batch, cfg)
    x, aux = backbone_fwd(mp, x, cfg, train=True, window_override=window_override)
    x = L.apply_norm(mp["final_norm"], x, cfg)
    x = _text_only(x, batch, cfg)[0]
    targets = torch.as_tensor(batch["targets"], device=x.device).to(torch.int64)
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32, device=x.device) if mask is None
            else torch.as_tensor(mask, device=x.device).to(torch.float32))
    ce, zl, acc = _chunked_ce(params, x, targets, mask, cfg)
    aux = aux[0]
    return ce + 1e-4 * zl + aux, {"ce": ce, "z_loss": zl, "acc": acc, "aux": aux}


class InputSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The shape and dtype of every model input of ``shape`` (the JAX
    package's ``input_specs``; nothing is allocated)."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf = torch.int32, torch_dtype(cfg.dtype)
    if shape.kind == "decode":
        return {"token": InputSpec((B, 1), i32), "pos": InputSpec((), i32)}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    if cfg.is_encoder:
        specs, St = {"embeds": InputSpec((B, S, cfg.frontend_dim), bf)}, S
    elif cfg.n_vision_tokens:  # the patches take the first n_vision_tokens positions
        St = S - cfg.n_vision_tokens
        specs = {"tokens": InputSpec((B, St), i32), "embeds": InputSpec((B, cfg.n_vision_tokens, cfg.frontend_dim), bf)}
    else:
        specs, St = {"tokens": InputSpec((B, S), i32)}, S
    if shape.kind == "train":
        specs.update(targets=InputSpec((B, St), i32), mask=InputSpec((B, St), torch.float32))
    return specs


def make_inputs(cfg: ModelConfig, shape: ShapeConfig, generator: Optional[torch.Generator] = None, device=None):
    """Random inputs matching ``input_specs``, drawn from ``generator`` (a
    fresh one seeded 0 if None) on its own device and placed on ``device``
    (None: the card): token ids uniform in [0, vocab), other integers zero,
    the mask ones, embeddings N(0, 1) in their dtype.  The values differ
    from ``jax.random``'s."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32 and name in ("tokens", "targets", "token"):
            t = torch.randint(0, cfg.vocab_size, s.shape, generator=g, device=g.device, dtype=torch.int32)
        elif s.dtype == torch.int32:
            t = torch.zeros(s.shape, dtype=torch.int32)
        elif name == "mask":
            t = torch.ones(s.shape, dtype=s.dtype)
        else:
            t = torch.randn(s.shape, generator=g, device=g.device).to(s.dtype)
        out[name] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# slot-stream support: chunked prefill into one slot, block-paged pools
# ---------------------------------------------------------------------------


def has_slot_state(cfg: ModelConfig) -> bool:
    """True for families whose slot cache carries state the position mask
    does not hide: SSM/RWKV and hybrid."""
    return cfg.family in ("ssm_mamba2", "ssm_rwkv6", "hybrid")


def _zero_slot(cache, slot, cfg: ModelConfig, axis: int):
    if has_slot_state(cfg):
        for name in _state_keys(cfg):
            cache[name].select(axis, int(slot)).zero_()
    return cache


def reset_slot(cache, slot, cfg: ModelConfig):
    """Zero one slot's constant-state leaves at admission, in place, in a
    single-model slot cache (slot axis 1 of every stacked leaf).  Attention
    KV rows need nothing (the per-slot position mask hides a previous
    occupant's rows), so the dense family's cache and the hybrid's
    ``attn_k``/``attn_v`` leaves are left as they are.  Returns ``cache``."""
    return _zero_slot(cache, slot, cfg, 1)


def reset_slot_members(cache, slot, cfg: ModelConfig):
    """``reset_slot`` over member caches (L, E, n_slots, ...): the slot of
    every member."""
    return _zero_slot(cache, slot, cfg, 2)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked-prefill admission: every decoder family.  For MoE a chunk's
    capacity follows its token count, so a capacity-limited chunk may drop
    tokens that one-token decode admission keeps (as the JAX package
    says); with ``capacity_factor >= n_experts`` nothing drops and the two
    admissions emit the same tokens."""
    return not cfg.is_encoder


def supports_draft_verify(cfg: ModelConfig) -> bool:
    """Speculative draft verification needs chunked prefill, to score every
    draft position in one pass, and a position-masked attention cache, so
    rejected draft rows are rolled back by position alone.  Constant-state
    families fail the second: their recurrent state has absorbed the
    rejected tokens."""
    return supports_chunked_prefill(cfg) and not has_slot_state(cfg)


def supports_paging(cfg: ModelConfig) -> bool:
    """Block-paged KV pools serve the attention-cache families (dense, moe,
    vlm).  Constant-state families have O(1) per-slot state, nothing to
    page, and the hybrid's per-invocation KV leaves keep the dense slot
    layout, as in the JAX package."""
    return cfg.family in ("dense", "moe", "vlm") and not cfg.is_encoder


def slot_index(v, device) -> torch.Tensor:
    """A slot index or chunk offset as a (1,) int64 tensor on ``device``: a
    device tensor passes through without a copy (a captured chunk program
    reads it at every replay); a Python or numpy int is sent once."""
    if isinstance(v, torch.Tensor) and v.device == torch.device(device):
        return v.reshape(1).to(torch.int64)
    return torch.tensor([int(v)], dtype=torch.int64, device=device)


def prefill_into_slot_members(params, tokens, cache, slot, start, cfg: ModelConfig, *,
                              return_hidden: bool = False):
    """Consume a C-token chunk of one slot's prompt, positions
    [start, start+C), into every member's slot of the member slot cache
    (``init_cache_members`` with batch = n_slots), in place.  ``slot`` and
    ``start`` are ints or (1,) device tensors (``slot_index``), ``tokens``
    (C,) host or device: with device inputs nothing is copied from the host
    and no value is read back, so the call can be captured.  Attention
    layers write K/V rows at the slot's offset; constant-state layers
    continue the slot's recurrent state (its rows selected and written back
    by index) through the full-sequence block forwards.  No logits: the
    last prompt token always goes through the decode step, whose logits
    pick the first output token — which keeps chunked and decode-only
    admission token-identical.  Returns the cache; with ``return_hidden``
    (attention families only: the speculative verify pass) ``(hidden (E,
    1, C, D), cache)``, from which the caller projects every position's
    logits."""
    assert supports_chunked_prefill(cfg), cfg.family
    device = param_device(params)
    slot, start = slot_index(slot, device), slot_index(start, device)
    x = embed_inputs(params, torch.as_tensor(tokens, device=device).to(torch.int64)[None])
    if attention_family(cfg):
        for l in range(cfg.n_layers):
            x = BD.dense_layer_prefill_chunk(
                _layer(params, l, cfg), x, cfg, cache["k"][l], cache["v"][l], slot, start,
                sliding_window=cfg.sliding_window,
            )
        return (x, cache) if return_hidden else cache
    if return_hidden:  # constant-state families cannot roll a verify back
        raise ValueError(f"return_hidden unsupported for family {cfg.family}")
    for l in range(cfg.n_layers):
        x, st = _recurrent_layer(params, l, x, cfg, {n: cache[n][l].index_select(1, slot) for n in _state_keys(cfg)})
        for name, t in st.items():
            cache[name][l].index_copy_(1, slot, t.to(cache[name].dtype))
        if _attn_after(cfg, l):
            inv = l // cfg.attn_every
            x = BD.dense_layer_prefill_chunk(
                params["shared_attn"], x, cfg, cache["attn_k"][inv], cache["attn_v"][inv], slot, start,
                sliding_window=cfg.sliding_window,
            )
    return cache


def init_paged_pool_members(cfg: ModelConfig, E: int, n_pages: int, page_size: int, device, dtype=None):
    """Zero pools, k and v (L, E, n_pages, KVH, page_size, hd): HBM is
    bound by pages, not slots x max_seq; page contents keep the
    kernel-native (KVH, seq, hd) tile layout."""
    assert supports_paging(cfg), cfg.family
    shape = (cfg.n_layers, E, n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    dtype = dtype or torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def copy_pool_page(pool, src: int, dst: int):
    """Device half of a copy-on-write split: copy page ``src`` to ``dst``
    on every leaf, layer and member plane, in place.  The page axis is
    found from the trailing (P, KVH, page_size, hd) layout, so engine pools
    and member-stacked tier pools take the same call."""
    for t in pool.values():
        ax = t.ndim - 4
        t.select(ax, int(dst)).copy_(t.select(ax, int(src)))
    return pool


def decode_step_paged_members(params, token, pool, pos, pages, cfg: ModelConfig):
    """One decode token per member and slot against the paged pools.

    token (E, B, 1); pos (B,) per-slot positions; pages (B, n_pg) int32
    table (-1 = unmapped), shared by the E member planes; pool from
    ``init_paged_pool_members``, updated in place.  Positions and table go
    to the device once for all layers.  Returns (logits (E, B, V), pool)."""
    assert supports_paging(cfg), cfg.family
    device = param_device(params)
    _, E, P = pool["k"].shape[:3]
    step = L.paged_step(pos, pages, E=E, n_pages=P, page_size=pool["k"].shape[-2], device=device)
    x = embed_inputs(params, torch.as_tensor(token, device=device).to(torch.int64))
    for l in range(cfg.n_layers):
        x = BD.dense_layer_decode_paged(
            _layer(params, l, cfg), x, cfg, pool["k"][l], pool["v"][l], step,
            sliding_window=cfg.sliding_window,
        )
    return L.project_logits(params, x[:, :, 0], cfg), pool


def prefill_into_slot_paged_members(params, tokens, pool, pages_row, start, cfg: ModelConfig, *,
                                    return_hidden: bool = False):
    """Paged counterpart of ``prefill_into_slot_members``: the chunk's K/V
    rows land in the pool pages the slot's (n_pg,) table row maps.
    ``start`` an int or (1,) device tensor; tokens and table row host or
    device (device inputs are used without a copy).  Returns the pool
    (updated in place); with ``return_hidden`` ``(hidden (E, 1, C, D),
    pool)`` for the speculative verify pass."""
    assert supports_paging(cfg), cfg.family
    device = param_device(params)
    pages_row = torch.as_tensor(pages_row, device=device).to(torch.int32)
    start = slot_index(start, device)
    x = embed_inputs(params, torch.as_tensor(tokens, device=device).to(torch.int64)[None])
    for l in range(cfg.n_layers):
        x = BD.dense_layer_prefill_chunk_paged(
            _layer(params, l, cfg), x, cfg, pool["k"][l], pool["v"][l], start, pages_row,
            sliding_window=cfg.sliding_window,
        )
    return (x, pool) if return_hidden else pool


def prefill_into_slot_logits_members(params, tokens, cache, slot, start, cfg: ModelConfig):
    """Chunked prefill that also scores every chunk position: returns
    ``(logits (E, C, V) f32, cache)``, ``logits[:, j]`` the next-token
    distribution after position ``start + j``.  This is the speculative
    verify pass (``serve/speculative.py``): feeding the token before each
    draft position gives, in one chunk, the model's own choice at every
    draft position, through the decode head (``layers.project_logits``)."""
    assert supports_draft_verify(cfg), cfg.family
    h, cache = prefill_into_slot_members(params, tokens, cache, slot, start, cfg, return_hidden=True)
    return L.project_logits(params, h, cfg)[:, 0], cache


def prefill_into_slot_paged_logits_members(params, tokens, pool, pages_row, start, cfg: ModelConfig):
    """Paged twin of ``prefill_into_slot_logits_members``: ``(logits (E, C,
    V) f32, pool)``."""
    assert supports_draft_verify(cfg), cfg.family
    h, pool = prefill_into_slot_paged_members(params, tokens, pool, pages_row, start, cfg, return_hidden=True)
    return L.project_logits(params, h, cfg)[:, 0], pool


# ---------------------------------------------------------------------------
# single-model API (the JAX package's signatures and cache layout)
# ---------------------------------------------------------------------------


def forward_logits(params, batch, cfg: ModelConfig):
    """Full logits (B, S, V)."""
    return forward_logits_members(_members(params), batch, cfg)[0]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device, dtype=None):
    """Zero caches in the JAX package's layout (see the module docstring)."""
    return _single_cache(init_cache_members(cfg, 1, batch, max_seq, device, dtype))


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``init_cache``' tree (the JAX
    layout), as the JAX package's ``init_cache`` boxes them: attention k, v
    ``('layers', 'kv_batch', 'cache_kv_heads', 'kv_seq', 'head_dim')``, the
    recurrent state's batch axis ``'kv_batch'``, the hybrid's
    per-invocation ``attn_k``/``attn_v`` without the layer axis."""
    _require_decoder(cfg)
    kv = ("kv_batch", "cache_kv_heads", "kv_seq", "head_dim")
    if attention_family(cfg):
        return {"k": ("layers",) + kv, "v": ("layers",) + kv}
    if cfg.family == "ssm_rwkv6":
        return {
            "tm_x": ("layers", "kv_batch", None),
            "cm_x": ("layers", "kv_batch", None),
            "wkv": ("layers", "kv_batch", "ssm_heads", None, None),
        }
    axes = {
        "conv": ("layers", "kv_batch", None, "ssm_inner"),
        "ssm": ("layers", "kv_batch", "ssm_heads", None, None),
    }
    if cfg.family == "hybrid":
        n_inv = cfg.n_layers // cfg.attn_every
        axes["attn_k"] = [kv] * n_inv
        axes["attn_v"] = [kv] * n_inv
    return axes


def prefill(params, batch, cfg: ModelConfig, *, cache=None):
    """Returns (last-token logits (B, V), cache in the JAX layout, with S KV
    rows; None for the encoder).  ``batch['starts']`` (B,), optional, is
    the left-pad carve-out (dense, moe and vlm without a prefix).  ``cache`` (``init_cache`` with S' >= S rows): the
    prompt is written into it in place and it is returned."""
    if cache is not None:
        logits, _ = prefill_members(_members(params), batch, cfg, cache=_member_cache(cache))
        return logits[0], cache
    logits, cache = prefill_members(_members(params), batch, cfg)
    return logits[0], None if cache is None else _single_cache(cache)


def last_logits(params, batch, cfg: ModelConfig):
    """Last-token logits (B, V) of a prompt batch, no cache kept (the
    classifier head)."""
    return prefill_members(_members(params), batch, cfg, collect_kv=False)[0][0]


def decode_step(params, token, cache, pos, cfg: ModelConfig, *,
                starts: Optional[torch.Tensor] = None):
    """token (B, 1); cache from ``prefill``/``init_cache`` (updated in
    place); ``pos`` the scalar position of the new token or a (B,) vector
    of per-slot positions.  Returns (logits (B, V), cache)."""
    token = torch.as_tensor(token)
    logits, _ = decode_step_members(
        _members(params), token[None], _member_cache(cache), pos, cfg, starts=starts,
    )
    return logits[0], cache


def _member_cache(cache):
    """A single-model cache or pool as a one-member view (writes go
    through): E enters at axis 1 of stacked leaves, axis 0 of the hybrid's
    per-invocation leaves."""
    return {k: [t[None] for t in v] if isinstance(v, list) else v[:, None] for k, v in cache.items()}


def _single_cache(cache):
    """The inverse of ``_member_cache`` for a one-member cache."""
    return {k: [t[0] for t in v] if isinstance(v, list) else v[:, 0] for k, v in cache.items()}


def prefill_into_slot(params, tokens, cache, slot, start, cfg: ModelConfig):
    """tokens (C,) for positions [start, start+C) of ``slot``; cache the
    single-model slot cache (``init_cache`` with batch = n_slots, updated
    in place).  Returns the cache."""
    prefill_into_slot_members(_members(params), tokens, _member_cache(cache), slot, start, cfg)
    return cache


def prefill_into_slot_logits(params, tokens, cache, slot, start, cfg: ModelConfig):
    """``prefill_into_slot`` that also scores every chunk position: returns
    ``(logits (C, V) f32, cache)``."""
    logits, _ = prefill_into_slot_logits_members(_members(params), tokens, _member_cache(cache), slot, start, cfg)
    return logits[0], cache


def init_paged_pool(cfg: ModelConfig, n_pages: int, page_size: int, device, dtype=None):
    """Zero pools, k and v (L, n_pages, KVH, page_size, hd)."""
    return _single_cache(init_paged_pool_members(cfg, 1, n_pages, page_size, device, dtype))


def decode_step_paged(params, token, pool, pos, pages, cfg: ModelConfig):
    """token (B, 1); pos (B,); pages (B, n_pg) int32; pool from
    ``init_paged_pool`` (updated in place).  Returns (logits (B, V), pool)."""
    token = torch.as_tensor(token)
    logits, _ = decode_step_paged_members(_members(params), token[None], _member_cache(pool), pos, pages, cfg)
    return logits[0], pool


def prefill_into_slot_paged(params, tokens, pool, pages_row, start, cfg: ModelConfig):
    """tokens (C,) for positions [start, start+C); pages_row the slot's
    (n_pg,) table row.  Returns the pool (updated in place)."""
    prefill_into_slot_paged_members(_members(params), tokens, _member_cache(pool), pages_row, start, cfg)
    return pool


def prefill_into_slot_paged_logits(params, tokens, pool, pages_row, start, cfg: ModelConfig):
    """Paged twin of ``prefill_into_slot_logits``: ``(logits (C, V) f32,
    pool)``."""
    logits, _ = prefill_into_slot_paged_logits_members(
        _members(params), tokens, _member_cache(pool), pages_row, start, cfg,
    )
    return logits[0], pool
