"""Model assembly (the port of ``repro.models.model``): embeddings ->
blocks -> final norm -> logits, with train, prefill and decode entry
points.

The reference scans a stacked ``unit`` of layers to keep XLA compile time
flat in depth; PyTorch runs eagerly, so here the layers are a Python loop
over a per-layer parameter list (``params["layers"]``) and a per-layer
cache list (``caches["layers"]``). Caches are written in place. A
weight-shared block (Zamba2's ``shared``) is one parameter dict that every
site of the list references, each site with its own cache.

Memory-conditioned models take their memory through ``extras``, as the
reference's: ``image_embeds`` (B, M, d) for a VLM's ``cross`` layers (or,
with ``image_positions`` on a model without cross layers, Llama-4's early
fusion over those token slots), ``frames`` (B, M, d) and ``frames_mask``
(B, M) for an encoder-decoder, whose encoder (``params["encoder"]``, a
per-layer list of ``enc`` blocks, and ``params["enc_norm"]``) runs in
prefill and never in decode (its output lives on in the ``dec`` layers'
``xk``/``xv`` caches).

Training (``train_loss``) runs the train mode of ``forward``: every
position, no cache, the MoE FFN's aux losses summed over the layers, the
MTP head's loss where the config has one; ``remat`` recomputes each
layer in the backward pass (``torch.utils.checkpoint``).

Under a sharding context on a ``DeviceMesh`` (``sharding.use_sharding``)
the forward is one SPMD program on DTensors: the parameters are placed
by ``sharding.rules.distribute_params``, ``placed_cache`` places the
caches by their leaves' rules (``sharding.rules.distribute_cache``), the
inputs are the same on every rank and join as replicated values
(``sharding.api.use_sharding``), and the reference's ``shard()`` sites,
the kernels on local shards (``sharding.api.local_op``) and the FSDP
weight gathers (``sharding.api.gather_fsdp``) place everything else. The
residual stream's sites at the scanned unit's boundaries (the
reference's ``unit_body``) stand on ``x`` here, the stream with its last
add still pending.
"""
from __future__ import annotations

import copy
import functools
from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import api as SH
from repro_torch.sharding.api import shard


# Block kinds safe under right-padded batched prefill (attention kinds mask
# pad keys by position -1, mamba2 freezes its state on masked tokens), kinds
# whose decode state can live in the paged pool (full attention, or
# fixed-size recurrent state that stays slot-addressed), and kinds whose
# prompt can be chunked (every stateful block's KV in the pool): the
# reference's sets (``repro/models/model.py``). ``rwkv6`` is in none of
# them: its block takes no mask, so its prompts prefill in exact-length
# groups, on the contiguous engine only.
PADDED_PREFILL_KINDS = {"dense", "parallel", "moe", "mla", "mla_moe",
                        "shared", "mamba2"}
PAGED_DECODE_KINDS = {"dense", "parallel", "moe", "shared", "mamba2"}
CHUNKED_PREFILL_KINDS = {"dense", "parallel", "moe", "shared"}


def check_head_padding(params: Dict, cfg: ModelConfig) -> None:
    """Raise unless every attention block of a parameter tree is padded as
    ``attn_init`` and the reference pad it: the wo rows of the padded q
    heads (``n_heads`` .. ``n_heads_padded``) zero, and duplicated kv
    heads (``n_kv_heads_padded`` a multiple of ``n_kv_heads``) equal copies
    in wk and wv. The card's head layouts rely on both
    (``attention.kernel_head_group``: a padded head may read any kv head,
    a real head one copy of its own). A device read per block: run where
    parameters are made (``Model.init``, ``convert.params_from_jax``),
    never in a step."""
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    n_kvp, hd = cfg.n_kv_heads_padded, cfg.head_dim_
    dup = n_kvp // n_kv if n_kvp > n_kv and n_kvp % n_kv == 0 else 1
    if cfg.n_heads_padded == n_q and dup == 1:
        return
    # every attention of the tree: self-attention (``attn``; a ``cross``
    # layer's gated cross-attention is also ``attn``), a ``dec`` layer's
    # cross-attention (``xattn``) and the encoder's layers
    blocks = list(params["layers"]) + list(params.get("encoder", ()))
    for a in (p[name] for p in blocks for name in ("attn", "xattn")
              if name in p):
        mla = "w_uk" in a       # MLA: v_head_dim rows a head, no kv heads
        rows = n_q * (cfg.mla.v_head_dim if mla else hd)
        if a["wo"][rows:].any():
            raise ValueError(
                f"{cfg.name}: wo rows of the padded q heads {n_q}.."
                f"{cfg.n_heads_padded - 1} are not all zero; the padded-head "
                "map needs them zero")
        for name in ("wk", "wv") if dup > 1 and not mla else ():
            w = a[name].reshape(a[name].shape[0], n_kv, dup, hd)
            if not torch.equal(w, w[:, :, :1].expand_as(w)):
                raise ValueError(
                    f"{cfg.name}: {name}'s {dup} copies of each kv head are "
                    "not equal; the kernels read one copy of each")


class Model:
    """A ModelConfig bound to a device. Parameters live outside the object
    (``init`` returns them), as in the reference."""

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = set(cfg.block_pattern)
        # a forward's rows as this many groups, each routing its tokens
        # against its own expert capacity (``moe.moe_apply``)
        self.moe_groups = 1

    def grouped(self, groups: int) -> "Model":
        """This model with its forward's rows taken as ``groups`` equal
        groups for the MoE capacity: a fleet's shards, each routing against
        its own capacity as the reference's ``shard_map`` body does. The
        same config and device; ``self`` is unchanged."""
        model = copy.copy(self)
        model.moe_groups = groups
        return model

    @property
    def supports_padded_prefill(self) -> bool:
        """True when right-padded batched prefill is exact for this model."""
        return not self.cfg.is_encdec and self.kinds <= PADDED_PREFILL_KINDS

    @property
    def supports_paged_decode(self) -> bool:
        """True when decode state can live in a shared paged pool: every
        block is full attention (no ring eviction to translate) or carries
        fixed-size recurrent state (mamba2, which stays slot-addressed).
        Windowed or chunked attention keeps the contiguous ring."""
        return (not self.cfg.is_encdec and self.kinds <= PAGED_DECODE_KINDS
                and self.cfg.sliding_window is None
                and self.cfg.attn_chunk is None)

    @property
    def supports_chunked_prefill(self) -> bool:
        """True when prompts can be prefilled in chunks interleaved with
        decode: every stateful block keeps its KV in the paged pool (chunk
        i reads chunks 0..i-1 through the block table). Recurrent blocks
        (mamba2) would need carried-state chunk resume and keep the
        monolithic prefill."""
        return (self.supports_paged_decode
                and self.kinds <= CHUNKED_PREFILL_KINDS)

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator]) -> Dict:
        """Random parameters from ``generator`` (on ``self.device``). The
        draws differ from the reference's ``jax.random`` ones; to run the
        reference's weights use ``models.convert.params_from_jax``.

        Layers follow the reference's grouping (``cfg.grouping()``): every
        ``shared`` position of the repeated unit is ONE parameter dict (the
        same object at each site, Zamba2's weight-shared block); a
        ``shared`` layer of the unrolled prefix has its own. An
        encoder-decoder config also gets ``encoder`` (``n_encoder_layers``
        ``enc`` blocks) and ``enc_norm``. A config with ``mtp`` also gets
        the reference's ``mtp`` subtree (``proj`` (2d, d), ``norm`` and
        one ``dense`` block), read only by ``train_loss``."""
        cfg, dev = self.cfg, self.device
        dt = L.dtype_of(cfg)
        prefix, unit, repeats = cfg.grouping()
        params = {"embed": L.embedding_init(generator, cfg, dev)}
        layers = [B.block_init(generator, cfg, kind, dev) for kind in prefix]
        shared = None
        for _ in range(repeats):
            for kind in unit:
                if kind == "shared":
                    if shared is None:
                        shared = B.block_init(generator, cfg, kind, dev)
                    layers.append(shared)
                else:
                    layers.append(B.block_init(generator, cfg, kind, dev))
        params["layers"] = layers
        if cfg.is_encdec:
            params["encoder"] = [B.block_init(generator, cfg, "enc", dev)
                                 for _ in range(cfg.n_encoder_layers)]
            params["enc_norm"] = L.rmsnorm_init(cfg.d_model, dt, dev)
        params["final_norm"] = L.rmsnorm_init(cfg.d_model, dt, dev)
        params["lm_head"] = L.lm_head_init(generator, cfg, dev)
        if cfg.mtp:
            # DeepSeek-V3's multi-token-prediction head: read only to
            # train; serving never does, but the meter's parameter counts
            # include it (``costing.param_counts``)
            params["mtp"] = {
                "proj": L.dense_init(generator, 2 * cfg.d_model, cfg.d_model,
                                     dt, dev),
                "norm": L.rmsnorm_init(cfg.d_model, dt, dev),
                "block": B.block_init(generator, cfg, "dense", dev)}
        if dev.type != "meta":
            check_head_padding(params, cfg)
        return params

    def param_shapes(self) -> Dict:
        """The parameter tree on the ``meta`` device: shapes, no storage."""
        return Model(self.cfg, "meta").init(None)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int) -> Dict:
        cfg = self.cfg
        return {
            "t": torch.zeros((batch,), dtype=torch.int32, device=self.device),
            "layers": [B.block_cache_init(cfg, kind, batch, max_len,
                                          self.device, layer_idx=i)
                       for i, kind in enumerate(cfg.block_pattern)],
        }

    def placed_cache(self, params, batch: int, max_len: int) -> Dict:
        """``init_cache`` for ``params``: where they are DTensors (the
        model's DTensor program under a mesh), each leaf placed by its
        rule (``sharding.rules.distribute_cache``)."""
        caches = self.init_cache(batch, max_len)
        tok = params["embed"]["tok"]
        if isinstance(tok, SH.DTensor) and SH.on_mesh():
            from repro_torch.sharding.rules import distribute_cache
            ctx = SH.current_context()
            caches = distribute_cache(caches, tok.device_mesh, ctx.rules)
        return caches

    # --------------------------------------------------------------- forward
    def _encode(self, params, frames: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The encoder over the frames (B, M, d): ``enc`` blocks at
        positions 0..M-1, ``mask`` (B, M) > 0 marking the frames every
        frame attends to, then ``enc_norm``, which performs the last
        block's pending add."""
        cfg = self.cfg
        M = frames.shape[1]
        positions = torch.arange(M, dtype=torch.int32,
                                 device=frames.device)[None].expand(
                                     frames.shape[0], M)
        ctx = B.LayerCtx(cfg=cfg, mode="prefill", positions=positions,
                         mask=mask)
        x, delta = frames, None
        for p in params["encoder"]:
            x, delta, _ = B.block_apply_pending(p, cfg, "enc", ctx, x, delta,
                                                None)
        _, x = L.residual_rmsnorm(SH.gather_fsdp(params["enc_norm"]), x,
                                  B.res_site(delta), cfg.norm_eps)
        return x

    def _memory(self, params, x: torch.Tensor, mode: str,
                extras: Dict) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The reference's use of ``extras``: (x, memory). Early fusion
        (``image_embeds`` on a model without cross layers) writes the
        image embeddings over the token slots ``image_positions``; an
        encoder-decoder's memory is the encoder's output over ``frames``
        (every mode but decode), a VLM's the ``image_embeds`` as given."""
        cfg = self.cfg
        if SH.on_mesh():           # inputs every rank holds the same
            mesh = SH.current_context().mesh
            extras = {k: SH.replicated(v, mesh) for k, v in extras.items()}
        if "image_embeds" in extras and cfg.n_image_tokens == 0:
            img = extras["image_embeds"].to(x.dtype)
            pos = extras["image_positions"].long()
            x = SH.local_op(_fuse_images, [("batch", None, None)] * 2 +
                            [("batch", None)], ("batch", None, None))(
                                x, img, pos)
        if cfg.is_encdec and mode != "decode":
            if "frames" not in extras:
                raise ValueError(
                    f"{cfg.name}: an encoder-decoder prefill needs the "
                    "encoder's input, extras['frames'] (B, M, d_model)")
            return x, self._encode(params, extras["frames"].to(x.dtype),
                                   extras.get("frames_mask"))
        if cfg.n_image_tokens and "image_embeds" in extras:
            return x, extras["image_embeds"].to(x.dtype)
        return x, None

    def forward(self, params, tokens: torch.Tensor, mask=None,
                mode: str = "prefill", caches: Optional[Dict] = None,
                last_index: Optional[torch.Tensor] = None,
                extras: Optional[Dict] = None, remat: bool = False):
        """Returns (logits, caches); in ``mode="train"`` (every position, no
        cache) (logits, aux): the MoE aux losses summed over the layers
        (``moe_aux``, ``moe_z``, ``moe_drop_frac``) and, where the config
        has an MTP head, ``_hidden``, the final norm's output, which
        ``train_loss`` feeds it; ``remat`` wraps each layer in
        ``torch.utils.checkpoint`` (train mode only), its pending residual
        add going in and out as a tensor. ``last_index`` (B,) keeps only that
        token's hidden state before the final norm and the vocab product:
        rows are independent there, so the result equals the full logits
        at those rows without computing the others. Chunk mode keeps the
        last valid token of each row on its own; its block table comes from
        ``caches["paged"]["tbl"]``. ``extras`` carries a memory-conditioned
        model's memory (``image_embeds``, ``image_positions``, ``frames``,
        ``frames_mask``: the module docstring); ``mask`` stays the token
        mask."""
        cfg = self.cfg
        Bsz, S = tokens.shape
        dev = tokens.device
        if mode == "decode":
            positions = caches["t"][:, None]
        elif mode == "chunk":
            # positions continue from the slot's token count; pad queries
            # (a partial last chunk) get -1 like padded prefill
            positions = caches["t"][:, None] + torch.arange(
                S, dtype=torch.int32, device=dev)
        elif mode in ("train", "prefill"):
            positions = torch.arange(S, dtype=torch.int32,
                                     device=dev)[None].expand(Bsz, S)
        else:
            raise ValueError(f"unknown forward mode {mode!r}")
        train = mode == "train"
        if train:
            caches = None
        if mode in ("prefill", "chunk") and mask is not None:
            # right-padded batched prefill / partial chunk: pad slots get
            # position -1, so their cache entries stay masked
            positions = torch.where(mask > 0, positions,
                                    torch.full_like(positions, -1))
        nv = None
        if mode == "chunk":
            nv = (mask.sum(dim=1).to(torch.int32) if mask is not None
                  else torch.full((Bsz,), S, dtype=torch.int32, device=dev))
            last_index = torch.clamp(nv - 1, min=0).long()
        page_tbl = None
        if mode in ("decode", "chunk") and caches is not None \
                and "paged" in caches:
            # (rows, M); an allocator's own table, (1, B, M) for a single
            # engine, reads as its (B, M) one (a fleet hands the model
            # ``serving.paged.model_table``'s pool page ids)
            page_tbl = caches["paged"]["tbl"].flatten(0, -2)

        embed_p = SH.gather_fsdp(params["embed"])
        x = L.embed(embed_p, cfg, tokens)
        x, memory = self._memory(params, x, mode, extras or {})
        emb_orig = x if "shared" in self.kinds else None
        layer_caches = caches["layers"] if caches is not None else None
        delta = None            # each block's last residual add, pending
        aux: Dict[str, torch.Tensor] = {}
        prefix, unit, _ = cfg.grouping()
        for i, kind in enumerate(cfg.block_pattern):
            j = i - len(prefix)          # position in the scanned units
            if j >= 0 and j % len(unit) == 0:
                x = shard(x, "batch", "seq", "embed")
            ctx = B.LayerCtx(cfg=cfg, mode=mode, positions=positions,
                             mask=mask, memory=memory, emb_orig=emb_orig,
                             layer_idx=i, page_tbl=page_tbl,
                             moe_groups=self.moe_groups)
            c = layer_caches[i] if layer_caches is not None else None
            layer = functools.partial(B.block_apply_pending,
                                      params["layers"][i], cfg, kind, ctx)
            if remat and train:
                layer = _in_this_program(layer)
                x, delta, a = checkpoint(layer, x, delta, None,
                                         use_reentrant=False)
            else:
                x, delta, a = layer(x, delta, c)
            if j >= 0 and (j + 1) % len(unit) == 0:
                x = shard(x, "batch", "seq", "embed")
            for k, v in a.items():
                aux[k] = aux[k] + v if k in aux else v
        # the final norm performs the last add over every row, then the
        # kept rows are gathered: one launch fewer than gathering x and
        # delta before the norm, and the same values (rows are independent)
        _, x = L.residual_rmsnorm(SH.gather_fsdp(params["final_norm"]), x,
                                  B.res_site(delta), cfg.norm_eps)
        head_p = SH.gather_fsdp(params["lm_head"])
        if train:
            if cfg.mtp:
                aux["_hidden"] = x      # the MTP head's input (train_loss)
            return L.logits(head_p, embed_p, cfg, x), aux
        if last_index is not None:
            x = _rows_at(x, last_index)
        logits = L.logits(head_p, embed_p, cfg, x)
        if caches is not None:
            if mode == "decode":
                caches["t"] += 1
            elif mode == "chunk":
                caches["t"] += nv
            else:
                lengths = (mask.sum(dim=1).to(torch.int32) if mask is not None
                           else torch.full((Bsz,), S, dtype=torch.int32,
                                           device=dev))
                if isinstance(caches["t"], SH.DTensor):
                    caches["t"] = SH.place(SH.replicated(
                        lengths, caches["t"].device_mesh), ("batch",))
                else:
                    caches["t"].copy_(lengths)
        return logits, caches

    # ---------------------------------------------------------------- train
    def train_loss(self, params, batch: Dict, remat: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: ``tokens`` (B, S), ``labels`` (B, S) (-100 = ignore), and
        any extras (a VLM's ``image_embeds``, an encoder-decoder's
        ``frames``, a ``mask``). Returns (loss, metrics): the masked
        cross-entropy over the real vocab, plus ``router_aux_weight`` x
        ``moe_aux`` and ``router_z_weight`` x ``moe_z`` where the config
        has MoE, plus ``mtp_weight`` x the MTP head's cross-entropy on the
        token after next where it has an MTP head, as the reference's."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        extras = {k: v for k, v in batch.items()
                  if k not in ("tokens", "labels", "mask")}
        logits, aux = self.forward(params, tokens, batch.get("mask"),
                                   mode="train", extras=extras, remat=remat)
        loss, n_tok = _masked_ce(logits, labels, cfg.vocab)
        del logits
        metrics = {"ce": loss, "tokens": n_tok}
        total = loss
        if cfg.moe is not None:
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            total = total + cfg.moe.router_aux_weight * aux.get("moe_aux",
                                                                zero)
            total = total + cfg.moe.router_z_weight * aux.get("moe_z", zero)
            metrics["moe_aux"] = aux.get("moe_aux", zero)
            metrics["moe_drop_frac"] = aux.get("moe_drop_frac", zero)
        if cfg.mtp and "_hidden" in aux:
            h = aux["_hidden"]
            embed_p = SH.gather_fsdp(params["embed"])
            mtp_p = SH.gather_fsdp(params["mtp"], skip=("block",))
            emb_next = L.embed(embed_p, cfg, torch.roll(tokens, -1, dims=1))
            hm = torch.cat([L.rmsnorm(mtp_p["norm"], h, cfg.norm_eps),
                            emb_next], dim=-1) @ mtp_p["proj"]
            pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                               device=tokens.device)[None].expand(
                                   tokens.shape)
            ctx = B.LayerCtx(cfg=cfg, mode="train", positions=pos)
            hm, _ = B.block_apply(params["mtp"]["block"], cfg, "dense", ctx,
                                  hm, None)
            mtp_logits = L.logits(SH.gather_fsdp(params["lm_head"]), embed_p,
                                  cfg, hm)
            mtp_labels = torch.roll(labels, -1, dims=1).clone()
            mtp_labels[:, -1] = -100
            mtp_loss, _ = _masked_ce(mtp_logits, mtp_labels, cfg.vocab)
            total = total + cfg.mtp_weight * mtp_loss
            metrics["mtp_ce"] = mtp_loss
        metrics["loss"] = total
        return total, metrics

    # ---------------------------------------------------------------- serve
    def prefill(self, params, tokens: torch.Tensor, mask=None,
                max_len: Optional[int] = None,
                caches: Optional[Dict] = None,
                extras: Optional[Dict] = None):
        """Process prompts; returns (last-token logits (B, vocab), caches).
        ``extras``: the memory of a memory-conditioned model (``forward``)."""
        Bsz, S = tokens.shape
        if caches is None:
            caches = self.placed_cache(params, Bsz, max_len or S)
        lengths = (mask.sum(dim=1) if mask is not None
                   else torch.full((Bsz,), S, device=tokens.device))
        last = torch.clamp(lengths - 1, min=0).long()
        logits, caches = self.forward(params, tokens, mask, mode="prefill",
                                      caches=caches, last_index=last,
                                      extras=extras)
        return logits[:, 0], caches

    def prefill_chunk(self, params, caches, tokens: torch.Tensor, mask):
        """Process one fixed-size prompt chunk against a paged slot view
        (``serving.paged.gather_slot_view``): the chunk's KV is appended to
        the slots' pages and its queries attend over each slot's whole
        logical history. tokens/mask: (n, C); positions continue from
        ``caches["t"]``. Returns (last-valid-token logits (n, vocab),
        caches)."""
        logits, caches = self.forward(params, tokens, mask, mode="chunk",
                                      caches=caches)
        return logits[:, 0], caches

    def decode_step(self, params, caches, tokens: torch.Tensor):
        """tokens: (B, 1) -> (logits (B, vocab), caches)."""
        logits, caches = self.forward(params, tokens, None, mode="decode",
                                      caches=caches)
        return logits[:, 0], caches


def _in_this_program(fn):
    """``fn`` run, whenever it runs (a checkpointed layer's recompute in
    the backward), under the sharding context and program of this call."""
    ctx = SH.current_context()
    if ctx is None:
        return fn

    def run(*args):
        with SH.use_sharding(ctx.mesh, ctx.rules):
            return fn(*args)
    return run


def _fuse_images(x: torch.Tensor, img: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Early fusion: the image embeddings written over the token slots
    ``pos`` (B, n) of x, out of place (under a mesh x is a view of its
    DTensor's local shard, which autograd does not let a write change)."""
    return x.index_put((torch.arange(x.shape[0], device=x.device)[:, None],
                        pos), img)


def _rows_at(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(B, 1, d): row ``index[b]`` of each batch row of x (B, S, d); under
    a mesh on the local batch rows, the sequence whole."""
    return SH.local_op(
        lambda x, i: x[torch.arange(x.shape[0], device=x.device), i][:, None],
        [("batch", None, None), ("batch",)], ("batch", None, None))(x, index)


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, vocab: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the labels >= 0, the padded vocab classes
    excluded (scored at -1e9); returns (loss, number of labels). Under a
    mesh each rank sums its rows' terms, the vocab whole, and the two
    sums are all-reduced."""
    if not isinstance(logits, SH.DTensor):
        nll, n = _ce_sums(logits, labels, vocab)
    else:
        ctx = SH.current_context()
        spec = ctx.fitted(("batch", "seq", None), logits.shape)
        split = {a for e in spec for a in SH.axes_of(e)}
        part = [SH.Partial() if a in split else SH.Replicate()
                for a in SH.axis_sizes(ctx.mesh)]
        nll, n = SH.local_op(functools.partial(_ce_sums, vocab=vocab),
                             [("batch", "seq", None), ("batch", "seq")],
                             (part, part))(logits, labels)
        nll, n = SH.place(nll, ()), SH.place(n, ())
    n = torch.clamp(n, min=1)
    return nll / n, n


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor, vocab: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_masked_ce``'s sums: the masked NLL and the number of labels."""
    if logits.shape[-1] > vocab:
        pad = logits.new_full(logits.shape[:-1] + (logits.shape[-1] - vocab,),
                              -1e9)
        logits = torch.cat([logits[..., :vocab], pad], dim=-1)
    mask = labels >= 0
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()
