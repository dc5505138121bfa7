#!/usr/bin/env python3
"""Run the PyTorch + CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: device name and count, ``nvidia-smi`` name and power limit;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (one process per source, in parallel), printing ptxas'
   registers / shared memory / spills per kernel;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main paths' shapes (attention at head dims 64 and 112, and the
   paged path's of the dense configurations of phase 4: llama-paper-3b's
   head dim 100, llama-paper-7b's 32 heads of 128, internlm2-20b's GQA
   group 3, minicpm-2b's 48 padded heads of 64 and stablelm-12b's head
   dim 160 at GQA group 2, and Llama-4 Maverick's: flash with q heads
   :40 of 48 at group 5 over the strided view ::2 of 16 duplicated kv
   heads, chunk-local, at its long prompt's S 8,192 and a wave's S 512,
   decode at group 5 on a chunk-local ring of 8,192 filled across a chunk
   boundary and on the global layer's cache of 8,448, each against SDPA
   with the same mask, and with full attention on the paged path: paged
   decode at group 5 over the view ::2 of a pool of 16 duplicated kv
   heads (B8, M128, hd 128) and the chunk kernel's group-5 instance over
   it (a packed chunk of 2 x 256 after 1,024 and 300 tokens, bf16; one of
   64 in float32); both paged kernels at the fleet's shapes,
   4 shards x 8 slots over one pool of 4 x 1,024 pages and its trash page
   through ``paged.model_table``'s table, idle -1 rows included, also
   against each shard's own call on its own pool; the SSD
   chunk at Zamba2's full width, WKV6 at RWKV6's prefill and decode
   shapes, RMSNorm in each of its prologues: the row as it is, the
   residual add, Zamba2's concat with and without the add, Mamba2's gate,
   at d 2048, 3584 and 7168, and DeepSeek-V3's q_norm (1,536), kv_norm
   (512 of each 576-wide row, read through its stride) and ln add (7,168)
   at 8 and 4,096 rows, x + delta bit-identical to PyTorch's and each
   prologue also timed against the launches it replaces; and the
   memory-conditioned families' shapes: flash at Llama-3.2-Vision's 64 q
   heads over 16 duplicated kv heads (group 4, hd 128) at B4 S256 and at
   SeamlessM4T's 16 / 16 heads of 64 at B4 S64, decode at both head
   layouts (B8 W2048 and B4 W128), RMSNorm's add at (8, 8192) and the
   norm with and without its add at SeamlessM4T's 4 x 4,096 encoder rows
   of 1,024), bf16 (atol
   2e-2, rtol 2e-2) and
   float32 (1e-4), on valid query rows; each bf16 kernel also against the
   plain version run in float32 on the same bf16 inputs (atol 2e-3, rtol
   1e-2: the kernels accumulate in float32 and round once at the store,
   while a dropped or doubled key page moves an output by more); WKV6,
   which computes in float32 from either input type, to 1e-5 relative
   and absolute against the largest output (the model's decay w ~ 0.9975
   grows the state's terms to ~100); kernel, plain-version and library
   (``scaled_dot_product_attention``; for the paged kernels over the
   logical view gathered beforehand, the gather not timed;
   ``F.rms_norm`` for RMSNorm; none for the SSD chunk and WKV6, which no
   single PyTorch call computes) times from CUDA events (every kernel
   around the replay of a CUDA graph of the calls, its time alone, with
   the eager time on a line of its own), beside the least time the card
   could take (valid query rows and keys, causal pairs only; the SSD
   chunk's products at the tensor cores' rate of its input type, with the
   CUDA cores' float32 bound printed beside it) and the factor over it;
   the bf16 decode cases beside SDPA on lines of their own. First, the
   bf16 instances of the flash and chunked-prefill kernels: ptxas'
   registers and spills and their tensor-core (HMMA) instruction counts
   from ``cuobjdump -sass`` (no spill and some HMMA, or it fails; none in
   the float32 instances); then every instance of the two decode
   kernels' split-KV core (96 each: hd 8-160 with 100, groups 1-8 with 3
   and 5): registers, and no spill or it fails, the hd 100, hd 160, group
   3 and group 5 instances listed; then every instance of ``wkv6`` (20) and
   ``ssd_chunk`` (40): registers, no spill, and HMMA in every SSD
   instance, or it fails; then
   every instance of ``rmsnorm_kernel`` (60): registers, no spill, or it
   fails. The contiguous decode kernel's MLA instances (hd 24 with hd_v 16
   at group 4, float32 and bf16) are listed with the decode instances, and
   ``ops.mla_decode_attention`` runs the reference's MLA case (B2, H4 over
   one latent head, W24) through them against the plain version, timed
   beside its bound and SDPA at Ev 16 with the same mask;
3b. examples: ``examples/quickstart_torch.py``, ``serve_e2e_torch.py``
   and ``carbon_planner_torch.py`` as a user runs them (the first two on
   the card, their default), the three at once, each to exit 0 with its
   report's last line;
4. engine: random weights from a seed, each path served through
   ``ServingEngine`` with the launch counts set to 0 just before its run
   and read just after. Every engine decodes through CUDA graphs of the
   fused step (``serving/graphs.py``): each served run must have as many
   graph replays as decode chunks and one capture a static key, and
   prints the graphs captured and replayed, the capture's seconds, the
   host's us a replay, the port's kernel launches a micro-step counted at
   capture, the warm wall a micro-step (prefill included) and the decode
   wall a micro-step (a chunk's replay to its end from a drained device,
   the chunks that captured left out), on the four paths of
   ``EAGER_STEP`` (and ``llama3.2-1b``) the kernel nodes a micro-step of
   one more capture, counted by the driver, beside the eager step's
   figures. ``graph_agreement`` holds a graphed chunk against an eager
   call of ``sampling.fused_decode_steps`` from one mid-decode state, on
   clones, bit for bit (tokens, emissions, every cache leaf but a pool's
   trash page, the slot state and the allocator), and times a second
   chunk of each, for ``llama-paper-1b`` contiguous and
   ``llama3.2-1b`` paged, with the host's waits under CUDA's sync debug
   mode equal to ``host_syncs``. ``phase_llama32``: ``llama3.2-1b`` at
   full width (1,269,368,832 parameters) in bf16 on the graphed paged
   main path (page 16, chunk 256 packed 2, prefix sharing, ``max_batch=8,
   max_len=2048``), the paged run's 16 requests, its launch counts, the
   card's draw integrated over the requests (J a token). ``llama-paper-1b`` at full width and depth in
   bf16, twice: the contiguous default path (16 requests; flash + decode
   kernels), then the paged pool with chunked prefill and prefix sharing
   (16 requests, eight sharing a 512-token system prompt; chunked-prefill
   + paged-decode kernels). Then ``zamba2-7b`` at full width and depth in
   bf16 on the paged pool (16 requests; the SSD kernel in all 68 mamba2
   layers and the flash kernel in the 13 shared-attention sites of every
   prefill launch, the paged-decode kernel in the 13 sites of every
   micro-step). Then ``rwkv6-1.6b`` at full width and depth in bf16 on
   the contiguous engine (16 requests, exact-length prefill groups; the
   WKV6 kernel in all 24 layers of every prefill launch and micro-step,
   no attention kernel). RMSNorm runs on every path, once per norm, with
   the residual add, concat or gate before it in the same launch: 45
   launches per forward on llama-paper-1b, 163 on zamba2-7b, 1 on
   rwkv6-1.6b (its blocks use LayerNorm). Then the paper's other dense
   configurations at full width and depth in bf16, 12 requests of the
   paged trace (8 at once, four of them opening with its 512-token system
   prompt, then four adopters of its pages), 32 new tokens each:
   ``llama-paper-3b`` (head dim 100) on the contiguous engine (flash +
   decode) and on the paged main path (chunked prefill + paged decode),
   then ``llama-paper-7b``, ``internlm2-20b`` (GQA group 3) and
   ``minicpm-2b`` (36 heads padded to 48: the group-1 kernels with the
   identity map) on the paged main path, then ``stablelm-12b`` (40
   ``parallel`` blocks with qk-norm, 25% rotary, head dim 160 at group 2,
   12.667 B parameters) on the contiguous engine and on the paged main
   path, each model freed before the next, launch counts (RMSNorm: 2 per
   block, 4 per ``parallel`` block with its q and k norms, and the final
   norm, a forward), prefix hits and the free stack asserted. Small
   float32 configs (llama3.2-1b, zamba2-7b and rwkv6-1.6b smoke, and
   Llama-4 Maverick's smoke and its head map at small size,
   ``maverick_map_config``, at capacity factors 2.0 and 0.5, where
   prefill drops real tokens beside pad tokens) are also served on the
   card and on the CPU (the plain path) and must agree token for token. The front door: llama3.2-1b smoke in float32 through
   ``AsyncServingServer`` on the card and on the CPU (two priority classes,
   the second preempting; ``max_queue`` with reject_lowest and
   ``pressure_clamp``; a (2, 0) tenant quota; a deadline-0.0 request; one
   fault at each launch site) must agree on tokens, finish reasons and
   every front-door counter, and its preempted requests must equal an
   unpreempted card run; then ``llama-paper-1b`` at full width and depth
   on the paged main path, 16 requests in two waves through the server,
   with the planned shed, rate-limited, deadline and retry counts, a
   preemption, every response terminal, the whole pool back and the
   chunk, paged-decode and RMSNorm launches asserted. The fleet
   (``ShardedServingEngine``: S shards as a leading axis of the device
   state, one forward over their rows a micro-step and a chunk):
   llama3.2-1b smoke in float32, 4 shards of 2 slots, sharing,
   preemption and carbon routing over QC, CISO, PACE, CISO, on the card
   and on the CPU (agree on tokens, finish reasons, the shard of every
   request and every stats() key but the wall-clock ones; the card
   fleet's tokens equal the single paged engine's); then
   ``phase_fleet``, ``llama-paper-1b`` at full width and depth, 4 shards
   of 8 slots and 1,024 pages each, carbon routing at the diurnal CI and
   deferral of class 0: 48 requests of 32 new tokens in two waves, every
   response terminal, placements on three shards or more (QC's at least
   PACE's), prefix hits, all 16 deferred released (forced and at the
   window), ``audit()`` and every free stack whole, 22 / 22 / 45
   paged-decode, chunk and RMSNorm launches a micro-step, chunk and
   forward, one fused call a decode chunk and the host's waits for the
   device under CUDA's sync debug mode equal to the decode chunks and
   first-token fetches, per-shard gCO2 summing to the fleet's. The
   fleet's admin paths: ``smoke_fleet_admin``, the smoke fleet and trace
   with a drain, a power cap at the midpoint of idle and TDP draw, an
   unreachable shard loss and two rejoins at fixed quanta
   (``ADMIN_SMOKE``), on the card and on the CPU (agree as
   ``smoke_fleet``; the card's tokens equal the fault-free fleet's on the
   card); then ``phase_fleet_admin``, ``phase_fleet``'s fleet without
   deferral serving its 32 class-1 requests, fault-free (the oracle) and
   then with ``ADMIN_FULL``'s drain of shard 3, cap of shard 2, loss of
   shard 1 and both rejoins: ``audit()`` after every event, migrations
   with ``migrate`` J on both endpoints, migrated requests equal to the
   oracle, the lost shard's part of the cache bit-identical (checksums)
   until its rejoin, launches one forward's a micro-step and a chunk,
   every free stack whole, and the host's waits equal to ``host_syncs``
   plus the counted fetches. The card's own draw (``nvidia-smi``
   ``power.draw.instant``, else ``power.draw``, every 100 ms in a side
   process, written to ``chiprun_out/power_*.csv``) is integrated with
   ``PowerTrace`` over the requests' window around phase 4's paged run
   (beside its modeled J) and the admin run (measured J only: the meter
   prices four modeled devices there). Last, ``phase_maverick``:
   Llama-4 Maverick at full width cut to depth 4 (chunk-local dense, moe
   and dense blocks, then the global moe layer: 35.12 B parameters, 70.2
   GB in bf16; 128 experts top-1 and a shared one; 40 / 8 heads padded to
   48 / 16, run at group 5 over the kv view ::2) on the contiguous engine,
   every earlier model freed first: 8 prompts of 64-512 tokens, then one
   of 8,176 admitted alone that decodes across position 8,192, 32 new
   tokens each, served twice with the same tokens; flash 4 a prefill
   launch, decode 4 a micro-step, RMSNorm 9 a forward, finite logits, the
   host's waits under CUDA's sync debug mode equal to ``host_syncs``, and
   peak memory beside the weights and KV reckoning; then the same weights
   with full attention in every layer (what the reference's paged gate
   admits): ``phase_maverick_paged``, a model-level probe (two prompts
   through chunks of 256 and the first decode step, each kernel call
   within TOL[bf16] of its plain version on the same inputs, the logits'
   argmax the plain versions' and their relative error at most 2^-5) and
   the paged trace (16 requests, prefix sharing,
   chunk 256 packed 2) served twice on the graphed paged main path; and
   ``phase_fleet`` on it, 4 shards of 8 slots, each shard routing its
   tokens against its own expert capacity. Last,
   ``phase_deepseek``: DeepSeek-V3 at full width cut to depth 5 (3 ``mla``
   and 2 ``mla_moe`` blocks, 256 experts top-8 and a shared one, the MTP
   head held: 27,587,293,184 parameters, 55.2 GB) on the contiguous
   engine, Maverick freed first: a 64-token prefill with the RMSNorm
   kernel against the plain norms (bf16 tolerance), then 8 prompts of
   64-512 tokens and one of 3,000 prefilled alone on the attention's
   two-level scan, 32 new tokens each, served twice with the same tokens;
   RMSNorm 21 a forward and no other kernel (MLA and the experts are
   plain PyTorch, as in the reference), the host's waits equal to
   ``host_syncs``, peak memory beside the weights and latent cache.
   Then ``phase_vlm``: Llama-3.2-Vision 90B at full width cut to depth 10
   (two units of (dense x 4, cross), 10,825,670,660 parameters, 21.65
   GB), both gates of each cross layer set to 0.5: at the model level a
   prefill of 4 x 256 tokens over 1,600 stub image embeddings a request
   (flash 8, RMSNorm 21), each kernel call held to ``TOL[bf16]`` against
   its plain version on the same inputs (each residual sum bit for bit)
   and the last-token logits to a float32 referee (no further from it
   than ``REFEREE`` times the plain bf16 path's; a planted fault of
   ``REFEREE_CATCHES`` ulps in the final norm's scale lands past it),
   repeated bit for bit and moved by the
   images (a text-only prefill of the same tokens differs), then 32
   greedy decode steps (decode 8, RMSNorm 21 a step, finite logits),
   run again with each kernel call held against its plain version; on
   the contiguous engine 8 text-only prompts of 64-512 tokens, 32 new
   tokens each, three times with the same tokens: 8 exact-length prefill
   launches, flash 8 a launch, decode 8 a micro-step, RMSNorm 21 a
   forward, no query at position -1, host waits equal to
   ``host_syncs`` (the second run), each kernel call against its plain
   version (the third). Last, ``phase_seamless``: SeamlessM4T-Large v2 in
   full (2,034,886,656 parameters) at the model level: 4 requests of
   4,096 stub frames (the last with its later half masked) under 64
   decoder tokens, the prefill (flash 24, RMSNorm 122: 48 encoder,
   ``enc_norm``, 72 decoder, the final) probed as the VLM's, 32 greedy
   decode steps (decode 24, RMSNorm 73 a step, no
   host wait; run again checked as the VLM's), and the unmasked prefill leaving the other rows within
   tolerance and moving the masked one; peak memory beside the weights
   and the encoder's float32 scores. Last, ``phase_train``: the train
   step's kernel work at its shape (B4 H32 S1024 hd 64 causal bf16, the
   norms' 4,096 rows of 2,048): the flash forward with its row logsumexp
   (bit-identical output to the call without), the attention backward
   (``kernels/autograd.py``, float32 ``torch.matmul``), the RMSNorm and
   add + RMSNorm backward, each beside its bound, the plain version and
   the library (SDPA's, ``F.rms_norm``'s forward + backward); then
   ``llama-paper-1b`` at full width and depth (1,261,529,088 parameters)
   trained for 8 steps through ``Trainer.fit`` (AdamW lr 1e-3, WSD warmup
   2, ``h100_sxm`` @ CISO) on ``lm_batches`` of 4 x 1,024: each step's
   loss, grad norm and lr, tokens/s of steps 2-8, peak memory, 22 flash
   and 45 RMSNorm launches a step and none in the backward (with remat,
   22 and 44 there), modeled J and gCO2 a step and the card's measured J
   over the fit; every loss finite and step 8's below step 1's; then the
   gradient probe: depth 2 at full width, every gradient leaf of the bf16
   kernel path no further from a float32 referee (the plain versions on
   float32 weights) than ``REFEREE`` times the plain bf16 path's,
   relative error in norm. Then ``phase_train_recurrent``: the
   recurrent families' four Functions at the train steps' shapes (``SSDChunk`` at
   Zamba2's (4, 112, 4, 256, 64) float32 with B/C a stride-0 group,
   ``WKV6`` at RWKV6's B4 H32 T1024 hd 64 bf16, ``CatRMSNorm`` with the
   add at (4,096, 3,584 + 3,584) bf16, ``GatedRMSNorm`` at (4,096, 7,168)
   float32 in, bf16 out), each forward bit-identical to its bare kernel,
   each gradient against autograd of the plain version, forward +
   backward ms beside the bound and the plain version's; the dry-run's
   train-step argument bytes of Zamba2's cut; then ``rwkv6-1.6b`` in full
   (1,599,866,880 parameters) and ``zamba2-7b`` at full width cut to depth
   24 (four units of 5 mamba2 and a shared site, 2,135,771,712
   parameters), each trained 16 steps through ``Trainer.fit`` as
   ``phase_train`` (loss, grad norm, lr, tokens/s, peak memory at least 8
   GB under 80, modeled and measured J), one more step counted (WKV6 24
   and RMSNorm 1 a forward; SSD 20, flash 4, RMSNorm 49 a forward; none
   in the backward), every loss finite and the last below the first;
   then each family's gradient probe (RWKV6 depth 2, Zamba2 depth 6)
   within ``REFEREE``. Then ``phase_moe_sharded``: one DeepSeek-V3
   MoE layer at full width (256 experts top-8, d 7,168, expert FFN 2,048,
   one shared expert, bf16: 22.5 GB of expert weights) through
   ``moe_ffn_sharded`` on an NCCL group of one rank and a (1, 1) mesh,
   called directly, against ``moe_ffn`` on the same 4 x 512 tokens at a
   capacity factor of 4 (both drop fractions printed, 0 or it fails;
   ``TOL[bf16]``); every gradient of a backward finite; the collective
   counts (``CommDebugMode``) and ms a call of both paths; the group
   destroyed. Then ``phase_mesh``: the model as one DTensor program on
   an NCCL group of one rank and a (1, 1) ("data", "model") mesh,
   parameters from ``distribute_params`` (FSDP on), every step under
   ``use_sharding(mesh, DEFAULT_RULES)`` and each kernel on the local
   shards (``sharding.api.local_op``): ``llama-paper-1b`` in full, a
   prefill of 4 x 1,024 and 16 decode steps, then one ``train_loss`` +
   AdamW step, each against the plain model on the same parameters, bit
   for bit or within ``TOL[bf16]`` with the first differing ``shard()``
   site named; flash 22 a prefill, decode 22 a step, RMSNorm 45 a
   forward; ``zamba2-7b`` and ``rwkv6-1.6b`` at full width cut to depth
   2, a prefill and 4 decode steps through ``ssd_chunk`` and ``wkv6`` the
   same way; the group destroyed; beside it, in a process of its own
   (a ``fake`` group of 256), the dry-run of ``llama3.2-1b``
   ``train_4k`` and ``decode_32k`` on 16x16: collectives a chip by op
   (count, wire bytes) and ``t_collective``. Last,
   ``phase_dryrun_memory``: the dry-run's per-device
   argument bytes on a (1, 1) mesh against the growth of
   ``torch.cuda.memory_allocated()`` over the same allocation:
   ``llama3.2-1b`` full at ``max_batch=8, max_len=2048`` (``Model.init``
   and ``init_cache``), and ``phase_train``'s step (``llama-paper-1b``'s
   parameters, AdamW moments and a 4 x 1,024 batch), each within 0.1% or
   2 MiB; the counted FLOPs of that step (``launch.op_cost`` on meta)
   beside ``model_flops`` and the TFLOP/s they give at ``phase_train``'s
   step time;
5. one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It needs the card: with ``torch.cuda.is_available()`` false it exits 2
and prints no result.
"""
import asyncio
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_TF32 = 495e12        # H100 SXM dense TF32 tensor-core FLOP/s
PEAK_F32 = 67e12          # H100 SXM float32 outside the tensor cores
HBM_BPS = 3.35e12         # H100 SXM device memory bytes/s
TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
TOL_WIDE = (2e-3, 1e-2)   # bf16 kernel vs the float32 plain version
N_LAYERS = 22             # llama-paper-1b
N_MAMBA, N_SHARED = 68, 13  # zamba2-7b: mamba2 layers, shared-attention sites
N_RWKV = 24               # rwkv6-1.6b
# the dense configurations of phase 4's last part -> layers (full depth)
N_DENSE = {"llama-paper-3b": 26, "llama-paper-7b": 32, "internlm2-20b": 48,
           "minicpm-2b": 40, "stablelm-12b": 40}
# -> the reference's parameters at full width (the leaves of its
# Model.init under jax.eval_shape, padded heads included)
DENSE_PARAMS = {"llama-paper-3b": 3_426_473_600,
                "llama-paper-7b": 6_738_415_616,
                "internlm2-20b": 20_466_702_336,
                "minicpm-2b": 3_008_289_024,
                "stablelm-12b": 12_667_225_600}
DENSE_REQUESTS, DENSE_NEW = 12, 32   # of the paged trace; new tokens each
MAVERICK = "llama4-maverick-400b-a17b"
# its depth-4 cut: chunk-local dense, chunk-local moe, chunk-local dense and
# the global moe layer (global attention every 4th layer), full width
N_MAVERICK = 4
MAVERICK_PARAMS = 35_123_409_920     # the reference's param_counts at depth 4
MAVERICK_LENS = (64, 100, 128, 200, 256, 300, 450, 512)   # the first wave
MAVERICK_LONG = 8176       # a prompt of its own: decodes across 8,192
MAVERICK_NEW = 32
MAVERICK_MAX_LEN = 8448    # the global layer's cache; the rings hold 8,192
MAVERICK_CHUNK = 8192
# the paged path (full attention, as the reference's paged gate requires):
# the paged main path's engine settings, 32 new tokens a request; the
# probe's two prompts through chunks of 256 and one decode step. Its first
# decode logits against the plain versions': each kernel call is held to
# TOL[bf16] on its own inputs, and the logits, four bf16 layers of
# rounding (and the moe routing it moves) later, to this relative error
# (norm of the difference over the plain logits' norm): 4 ulps of bf16's
# 8 significant bits, where a kernel reading a wrong key or head moves the
# logits by their own size
MAVERICK_PAGED_LEN = 2048
MAVERICK_PROBE_LENS = (700, 300)
MAVERICK_PROBE_REL = 2.0 ** -5
DEEPSEEK = "deepseek-v3-671b"
# its depth-5 cut: the 3 dense mla layers and 2 mla_moe layers, the least
# depth that runs the reference's stacked unit (prefix 3 x mla, unit
# mla_moe, repeats 2); full width
N_DEEPSEEK = 5
DEEPSEEK_PARAMS = 27_587_293_184     # the reference's param_counts at depth 5
DEEPSEEK_LENS = (64, 100, 128, 200, 256, 300, 450, 512)   # the first wave
DEEPSEEK_LONG = 3000       # a prompt of its own: a 4,096-key padded prefill
DEEPSEEK_NEW = 32
DEEPSEEK_MAX_LEN = 4160    # the latent cache's rows a slot
VLM = "llama-3.2-vision-90b"
# its depth-10 cut: two units of its (dense x 4, cross) pattern, full width
N_VLM = 10
VLM_ATTN = 8               # the dense layers, which run flash and decode
VLM_PARAMS = 10_825_670_660          # the reference's param_counts at depth 10
VLM_GATE = 0.5             # both gates of each cross layer (0 at init)
VLM_BATCH, VLM_PROMPT = 4, 256       # the image path's prefill
VLM_STEPS = 32             # greedy decode steps after it
VLM_LENS = (64, 100, 128, 200, 256, 300, 450, 512)   # the engine path
VLM_NEW = 32
VLM_MAX_LEN = 576
SEAMLESS = "seamless-m4t-large-v2"
SEAMLESS_PARAMS = 2_034_886_656      # the reference's, encoder included
SEAMLESS_BATCH, SEAMLESS_PROMPT = 4, 64   # requests; decoder prompt tokens
SEAMLESS_STEPS = 32
TRAIN = "llama-paper-1b"
TRAIN_PARAMS = 1_261_529_088         # the reference's param_counts, full
TRAIN_PROBE_DEPTH = 2                # the gradient probe's cut, full width
TRAIN_PROBE_PARAMS = 233_842_688     # the reference's param_counts at depth 2
TRAIN_STEPS, TRAIN_WARMUP = 8, 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_BRANCHING = 4, 1024, 4
TRAIN_LR = 6e-4
MOE_SHARDED_TOKENS = (4, 512)        # one DeepSeek-V3 MoE layer's input
MOE_SHARDED_CF = 4.0                 # C 256 on both paths: no drop
DRYRUN_SERVE = (8, 2048)             # llama3.2-1b: max_batch, max_len
DRYRUN_TOL = (1e-3, 2 * 2**20)       # relative, or bytes
# the probes' referee: bf16 rounding alone moves a full-width model's
# logits past TOL[bf16] (the plain bf16 path against float32 too), so the
# kernels' logits may be at most this many times further from the float32
# path's than the plain bf16 path's are; each kernel call is held to
# TOL[bf16] on its own inputs
REFEREE = 1.5
# the referee's own check, in every probe: the final norm's scale raised
# by each of these many bf16 ulps (``planted``); the fault of
# REFEREE_CATCHES ulps must land past REFEREE
PLANTED_ULPS = (1, 2, 4)
REFEREE_CATCHES = 4
# rmsnorm launches per forward: two per dense (dense_norms: 2 L + 1 on a
# dense model, 4 L + 1 on a parallel one), mamba2 (ln1, gate_norm) and
# shared block, one final norm; rwkv6 blocks norm with LayerNorm
NORMS_ZAMBA = 2 * N_MAMBA + 2 * N_SHARED + 1
NORMS_RWKV = 1
WKV_REL = 1e-5            # WKV6: relative to the largest output
CSRC = "src/repro_torch/kernels/csrc/"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_attention": (CSRC + "flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:77"),
    "decode_attention": (CSRC + "decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:130"),
    "paged_decode_attention": (CSRC + "paged_decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:184"),
    "chunked_prefill_attention": (CSRC + "chunked_prefill_attention.cu",
                                  "src/repro/kernels/chunked_prefill.py:117"),
    "ssd_chunk": (CSRC + "ssd_chunk.cu", "src/repro/kernels/ssd.py:58"),
    "wkv6": (CSRC + "wkv6.cu", "src/repro/kernels/wkv6.py:59"),
    "rmsnorm": (CSRC + "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25"),
}
SYSTEM_PROMPT = 512       # shared prefix of the paged run's traffic


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


POWER_MS = 100            # nvidia-smi's sampling period (-lms)
POWER_MIN = 10            # fewest in-window samples a measured J needs
# preferred first: power.draw.instant is the instantaneous reading;
# power.draw is a one-second average on Hopper drivers
POWER_FIELDS = ("power.draw.instant", "power.draw")


def parse_watts(text: str):
    """Watts from one ``nvidia-smi`` CSV reading ("412.07 W", "412.07"),
    or None when the driver reports none ("[N/A]", "[Not Supported]")."""
    try:
        return float(text.strip().split()[0])
    except (IndexError, ValueError):
        return None


def write_power_csv(path, rows) -> None:
    """The ``t_s,watts`` CSV that ``PowerTrace.from_csv`` reads, one row a
    parsed reading (rows whose watts are None are left out)."""
    with open(path, "w") as f:
        f.write("t_s,watts\n")
        for t, w in rows:
            if w is not None:
                f.write(f"{t:.6f},{w:.6f}\n")


def power_field() -> str:
    """The first of ``POWER_FIELDS`` that this driver answers with a
    number."""
    for field in POWER_FIELDS:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and parse_watts(out.stdout) is not None:
            return field
    raise AssertionError(f"nvidia-smi reads none of {POWER_FIELDS}")


class PowerSampler:
    """``nvidia-smi`` as a side process, one reading of card 0 every
    ``POWER_MS`` ms, each stamped with the host's ``time.perf_counter()``
    (the clock of the requests' ``t_submit`` and ``t_emit``) as it
    arrives. ``stop()`` ends the process, fails if it exited non-zero
    before, and returns the rows."""

    def __init__(self, field: str):
        import threading
        self.field = field
        self.rows = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={field}",
             "--format=csv,noheader,nounits", "-i", "0",
             "-lms", str(POWER_MS)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.rows.append((time.perf_counter(), parse_watts(line)))

    def stop(self):
        rc = self.proc.poll()
        if rc is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.reader.join(timeout=10)
        if rc is not None:
            raise AssertionError(f"nvidia-smi power sampler exited {rc}: "
                                 f"{self.proc.stderr.read()[-500:]}")
        return self.rows


def measured_power(card, label, sampler, reqs, responses, gen_tokens,
                   modeled_j=None) -> float:
    """Integrate the sampler's trace, through ``PowerTrace.from_csv`` of
    the CSV it writes under ``chiprun_out/``, over
    ``ActiveWindow.from_requests`` of the run's requests (submit to last
    token); print the field, the in-window samples, mean W, measured J,
    the modeled J and their ratio when given, and J per generated token,
    on a line with the card's name and power limit. Fails on fewer than
    ``POWER_MIN`` in-window samples. Returns the measured J."""
    from repro_torch.core.power_trace import ActiveWindow, PowerTrace
    rows = sampler.stop()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    slug = "".join(ch if ch.isalnum() else "_" for ch in label)
    path = os.path.join(ROOT, "chiprun_out", f"power_{slug}.csv")
    write_power_csv(path, rows)
    trace = PowerTrace.from_csv(path)
    by_rid = {r.rid: r for r in responses}
    starts = [r.t_submit for r in reqs]
    window = ActiveWindow.from_requests(
        starts, [by_rid[r.rid].t_emit[-1] - r.t_submit for r in reqs])
    inside = [w for t, w in zip(trace.t_s, trace.watts)
              if window.contains(t)]
    span = window.t1 - window.t0
    if len(inside) < POWER_MIN:
        raise AssertionError(
            f"{label}: {len(inside)} power samples in the {span:.3f} s "
            f"window (< {POWER_MIN}); {len(trace)} in all")
    joules = trace.energy_j(window)
    modeled = ("" if modeled_j is None else
               f", modeled {modeled_j:.1f} J (h100_sxm profile), measured / "
               f"modeled {joules / modeled_j:.3f}")
    print(f"  measured power ({card}): {sampler.field} every {POWER_MS} ms, "
          f"{len(inside)} samples in the {span:.3f} s window, mean "
          f"{sum(inside) / len(inside):.1f} W, measured "
          f"{joules:.1f} J{modeled}, {joules / gen_tokens:.4f} J per "
          f"generated token (CSV {os.path.relpath(path, ROOT)})")
    return joules


@functools.lru_cache(maxsize=None)
def _side_stream():
    return torch.cuda.Stream()


def time_ms(fn, warmup: int = 3, iters: int = 20,
            graph: bool = False) -> float:
    """Device ms per call of ``fn`` from CUDA events around ``iters``
    calls. Launched eagerly, a call whose kernels take less than the
    host's cost of issuing them (ctypes, checks, allocation: ~15 us) is
    timed at that cost; ``graph`` captures the ``iters`` calls in a CUDA
    graph and times its replay, which is the kernels' time alone."""
    # an earlier call's graph and its memory pool are freed here, not inside
    # the timed calls (freeing a pool waits for the device)
    gc.collect()
    # graphs warm up and capture on one side stream: every stream that runs
    # a matmul keeps a cuBLAS workspace for the rest of the process
    stream = _side_stream() if graph else torch.cuda.current_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            run()
        g.replay()
        run = g.replay
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(flops: float, nbytes: float, dtype, peak=None) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of ``flops`` over
    ``peak`` (by default the bf16 tensor cores' for bf16, the CUDA cores'
    float32 otherwise) and ``nbytes`` over the memory rate."""
    if peak is None:
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def past_tol(got, want, rows, atol, rtol) -> tuple:
    """(max abs error over valid rows, elements past atol + rtol*|want|)."""
    g, w = got.float()[rows], want.float()[rows]
    err = (g - w).abs()
    return err.max().item(), int((err > atol + rtol * w.abs()).sum())


def check_close(name, got, want, rows, dtype) -> float:
    """Max abs error over valid rows; raise past TOL[dtype]."""
    atol, rtol = TOL[dtype]
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err, bad = past_tol(got, want, rows, atol, rtol)
    if bad:
        raise AssertionError(f"{name}: {bad} elements past atol {atol} rtol "
                             f"{rtol} (max abs err {err:.3e})")
    return err


def check_wide(got, plain, args, rows, dtype):
    """bf16 only: max abs error of ``got`` against ``plain`` run in float32
    on the same inputs, and the elements past TOL_WIDE (phase 3 raises
    after printing every case)."""
    if dtype != torch.bfloat16:
        return None, 0
    wide = [a.float() if a.is_floating_point() else a for a in args]
    return past_tol(got, plain(*wide), rows, *TOL_WIDE)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def flash_inputs(B, Hq, Hkv, S, dtype, gen, hd=64):
    """Right-padded prompts in the model's layout: (B,S,H,hd) projections
    seen as (B,H,S,hd) views, row b holding lens[b] real tokens (row 0
    full). Returns (q, k, v, pos)."""
    dev = "cuda"
    q = torch.randn(B, S, Hq, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype)
    lens = torch.randint(S // 4, S + 1, (B,), generator=gen, device=dev)
    lens[0] = S
    ar = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    pos = torch.where(ar < lens[:, None], ar, torch.full_like(ar, -1))
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            pos.contiguous())


def flash_work(q, k, v, pos, chunk=None):
    """(operations, bytes, mask) of one flash call: causal valid pairs
    (inside one ``chunk`` when given); the valid q rows and the K and V
    rows some valid query sees read once (pad rows need not be read), out
    written once in full (pad rows 0), the positions."""
    from repro_torch.kernels import ref as REF
    Hq, Hkv, hd = q.shape[1], k.shape[1], q.shape[-1]
    mask = (pos[:, None, :, None] >= 0) & REF.attention_mask(
        pos[:, None, :, None], pos[:, None, None, :], None, chunk)
    pairs = float(mask.sum().item()) * Hq
    q_rows = float((pos >= 0).sum().item())
    kv_rows = float(mask.any(dim=2).sum().item())
    nbytes = ((q_rows * Hq + 2 * kv_rows * Hkv) * hd * q.element_size()
              + q.numel() * q.element_size() + 2 * pos.numel() * 4)
    return 4.0 * hd * pairs, nbytes, mask


def flash_case(FA, REF, B, Hq, Hkv, S, dtype, gen, hd=64):
    qt, kt, vt, pos = flash_inputs(B, Hq, Hkv, S, dtype, gen, hd)
    got = FA.flash_attention(qt, kt, vt, pos, pos)
    want = REF.flash_attention(qt, kt, vt, pos, pos)
    rows = (pos >= 0)[:, None, :, None].expand_as(want)
    err = check_close(f"flash B{B} H{Hq}/{Hkv} S{S} hd{hd} {dtype}", got, want,
                      rows, dtype)
    if (got[~rows] != 0).any():
        raise AssertionError(f"flash B{B} S{S} hd{hd}: a pad query's output "
                             "is not 0")
    wide = check_wide(got, REF.flash_attention, (qt, kt, vt, pos, pos),
                      rows, dtype)
    flops, nbytes, mask = flash_work(qt, kt, vt, pos)
    bms, by = bound_ms(flops, nbytes, dtype)
    ms = time_ms(lambda: FA.flash_attention(qt, kt, vt, pos, pos), graph=True)
    plain = time_ms(lambda: REF.flash_attention(qt, kt, vt, pos, pos),
                    graph=True)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv), graph=True)
    eager = time_ms(lambda: FA.flash_attention(qt, kt, vt, pos, pos))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, wide=wide, eager_ms=eager)


def decode_inputs(B, Hq, Hkv, W, dtype, gen, hd=64, fills=None):
    """One decode step over a (B, W, Hkv, hd) ring cache seen as (B, Hkv,
    W, hd) views; ``fills``: tokens written per slot (default mixed, the
    last slot wrapped). Returns (q, k, v, q_pos, k_pos)."""
    dev = "cuda"
    q = torch.randn(B, Hq, hd, generator=gen, device=dev).to(dtype)
    cache_k = torch.randn(B, W, Hkv, hd, generator=gen, device=dev).to(dtype)
    cache_v = torch.randn(B, W, Hkv, hd, generator=gen, device=dev).to(dtype)
    # mixed fills: tokens written so far per slot, one slot wrapped around
    # the ring (k_pos unsorted), pad rows of a right-padded prompt at -1
    n_tok = torch.randint(16, W, (B,), generator=gen, device=dev).tolist()
    n_tok[-1] = W + W // 3
    if fills is not None:
        n_tok = list(fills)
    k_pos = torch.full((B, W), -1, dtype=torch.int32)
    for b, n in enumerate(n_tok):
        t = torch.arange(max(0, n - W), n, dtype=torch.int32)
        k_pos[b, (t % W).long()] = t
        if n > 9:
            k_pos[b, 5:9] = -1
    q_pos = torch.tensor([n - 1 for n in n_tok], dtype=torch.int32)
    k_pos, q_pos = k_pos.to(dev), q_pos.to(dev)
    return q, cache_k.transpose(1, 2), cache_v.transpose(1, 2), q_pos, k_pos


def decode_work(q, k, q_pos, k_pos, hd_v=None, chunk=None):
    """(operations, bytes) of one decode call: the valid keys' K rows (hd)
    and V rows (``hd_v``, by default hd) read once (inside the query's
    ``chunk`` when given), q read and out written once, the positions."""
    from repro_torch.kernels import ref as REF
    Hq, Hkv, hd = q.shape[1], k.shape[1], q.shape[-1]
    hd_v = hd if hd_v is None else hd_v
    valid = float(REF.attention_mask(q_pos[:, None], k_pos, None,
                                     chunk).sum().item())
    e = q.element_size()
    flops = valid * Hq * 2.0 * (hd + hd_v)
    nbytes = (valid * Hkv * (hd + hd_v) * e + q.numel() * e
              + q.numel() // hd * hd_v * e + k_pos.numel() * 4
              + q_pos.numel() * 4)
    return flops, nbytes


def decode_sdpa(q, k, v, q_pos, k_pos, chunk=None):
    """``scaled_dot_product_attention`` of one decode step, same mask."""
    from repro_torch.kernels import ref as REF
    mask = REF.attention_mask(q_pos[:, None], k_pos, None,
                              chunk)[:, None, None, :]
    gqa = q.shape[1] != k.shape[1]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=gqa)


def decode_case(DA, REF, B, Hq, Hkv, W, dtype, gen, hd=64):
    q, kt, vt, q_pos, k_pos = decode_inputs(B, Hq, Hkv, W, dtype, gen, hd)
    got = DA.decode_attention(q, kt, vt, q_pos, k_pos)
    want = REF.decode_attention(q, kt, vt, q_pos, k_pos)
    rows = torch.ones_like(want, dtype=torch.bool)
    err = check_close(f"decode B{B} H{Hq}/{Hkv} W{W} hd{hd} {dtype}", got, want,
                      rows, dtype)
    wide = check_wide(got, REF.decode_attention, (q, kt, vt, q_pos, k_pos),
                      rows, dtype)
    bms, by = bound_ms(*decode_work(q, kt, q_pos, k_pos), dtype)
    ms = time_ms(lambda: DA.decode_attention(q, kt, vt, q_pos, k_pos),
                 graph=True)
    plain = time_ms(lambda: REF.decode_attention(q, kt, vt, q_pos, k_pos),
                    graph=True)
    lib = time_ms(decode_sdpa(q, kt, vt, q_pos, k_pos), graph=True)
    eager = time_ms(lambda: DA.decode_attention(q, kt, vt, q_pos, k_pos))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, wide=wide, eager_ms=eager)


def mla_case(DA, REF, dtype, gen):
    """The reference's MLA decode case (``tests/test_kernels.py::
    test_mla_decode_attention_matches_naive``: B2, H4 over one latent
    head, W24, kvr 16 + rope 8, nope 12, 17 valid keys) as
    ``ops.mla_decode_attention`` lays it out: q = [q_lat | q_rope]
    pre-scaled, k = [ckv | k_rope] as one kv head (hd 24), v = ckv (hd_v
    16). The kernel's (24, 16) group-4 instance against the plain version;
    the library column is SDPA with the same mask at Ev 16 (None where it
    refuses unequal head dims)."""
    dev = "cuda"
    B, H, W, kvr, rope, nope = 2, 4, 24, 16, 8, 12
    q_lat = torch.randn(B, H, kvr, generator=gen, device=dev).to(dtype)
    q_rope = torch.randn(B, H, rope, generator=gen, device=dev).to(dtype)
    ckv = torch.randn(B, W, kvr, generator=gen, device=dev).to(dtype)
    k_rope = torch.randn(B, W, rope, generator=gen, device=dev).to(dtype)
    ar = torch.arange(W, dtype=torch.int32, device=dev)
    k_pos = torch.where(ar < 17, ar, torch.full_like(ar, -1))[None].repeat(
        B, 1)
    q_pos = torch.full((B,), 16, dtype=torch.int32, device=dev)
    q = torch.cat([q_lat, q_rope], -1) * (math.sqrt(kvr + rope)
                                          / math.sqrt(nope + rope))
    k = torch.cat([ckv, k_rope], -1)[:, None]
    v = ckv[:, None]
    from repro_torch.kernels import ops
    got = ops.mla_decode_attention(q_lat, q_rope, ckv, k_rope, q_pos, k_pos,
                                   qk_dim=nope + rope)
    want = REF.decode_attention(q, k, v, q_pos, k_pos)
    rows = torch.ones_like(want, dtype=torch.bool)
    err = check_close(f"mla decode B{B} H{H}/1 W{W} hd 24/16 {dtype}", got,
                      want, rows, dtype)
    if (DA.decode_attention(q, k, v, q_pos, k_pos) != got).any():
        raise AssertionError("mla decode: ops.mla_decode_attention differs "
                             "from the decode kernel on its layout")
    wide = check_wide(got, REF.decode_attention, (q, k, v, q_pos, k_pos),
                      rows, dtype)
    bms, by = bound_ms(*decode_work(q, k, q_pos, k_pos, hd_v=kvr), dtype)
    ms = time_ms(lambda: DA.decode_attention(q, k, v, q_pos, k_pos),
                 graph=True)
    plain = time_ms(lambda: REF.decode_attention(q, k, v, q_pos, k_pos),
                    graph=True)
    try:
        sdpa = decode_sdpa(q, k, v, q_pos, k_pos)
        sdpa()
    except RuntimeError as e:       # the library column only: the kernel
        print(f"  mla decode {dtype}: SDPA refuses Ev != E ({e})")
        lib = None
    else:
        lib = time_ms(sdpa, graph=True)
    eager = time_ms(lambda: DA.decode_attention(q, k, v, q_pos, k_pos))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, wide=wide, eager_ms=eager)


def dup_heads(B, S, Hkv, hd, dtype, gen):
    """Maverick's kv projection: (B, S, 2 Hkv, hd) with heads 2c and 2c + 1
    equal (8 kv heads duplicated to 16); returns the kernels' view of copy
    0 of each, (B, S, Hkv, hd), a stride and no copy."""
    x = torch.randn(B, S, Hkv, 1, hd, generator=gen, device="cuda").to(dtype)
    return x.expand(B, S, Hkv, 2, hd).reshape(B, S, 2 * Hkv, hd)[:, :, ::2]


def maverick_flash_case(FA, REF, B, S, dtype, gen, chunk=MAVERICK_CHUNK):
    """Maverick's prefill: q heads :40 of its 48 padded ones at group 5
    against the strided view of its 16 duplicated kv heads (hd 128),
    chunk-local, right-padded rows (row 0 full)."""
    Hkv, hd = 8, 128
    q = torch.randn(B, S, 48, hd, generator=gen, device="cuda").to(dtype)
    qt = q[:, :, :5 * Hkv].transpose(1, 2)
    kt = dup_heads(B, S, Hkv, hd, dtype, gen).transpose(1, 2)
    vt = dup_heads(B, S, Hkv, hd, dtype, gen).transpose(1, 2)
    lens = torch.randint(S // 4, S + 1, (B,), generator=gen, device="cuda")
    lens[0] = S
    ar = torch.arange(S, device="cuda", dtype=torch.int32)[None].expand(B, S)
    pos = torch.where(ar < lens[:, None], ar, torch.full_like(ar, -1))
    pos = pos.contiguous()
    plain = functools.partial(REF.flash_attention, chunk=chunk)
    args = (qt, kt, vt, pos, pos)
    got = FA.flash_attention(*args, chunk=chunk)
    want = plain(*args)
    rows = (pos >= 0)[:, None, :, None].expand_as(want)
    name = f"flash B{B} H40/8 (kv ::2 of 16) S{S} chunk{chunk} {dtype}"
    err = check_close(name, got, want, rows, dtype)
    if (got[~rows] != 0).any():
        raise AssertionError(f"{name}: a pad query's output is not 0")
    del want
    wide = check_wide(got, plain, args, rows, dtype)
    flops, nbytes, mask = flash_work(qt, kt, vt, pos, chunk)
    bms, by = bound_ms(flops, nbytes, dtype)
    iters = 5 if S > 2048 else 20      # the plain version's scores: S^2 x 40
    ms = time_ms(lambda: FA.flash_attention(*args, chunk=chunk), graph=True)
    plain_ms = time_ms(lambda: plain(*args), iters=iters, graph=True)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), graph=True)
    eager = time_ms(lambda: FA.flash_attention(*args, chunk=chunk))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib,
                bound_ms=bms, bound_by=by, wide=wide, eager_ms=eager)


def maverick_decode_case(DA, REF, B, W, fills, dtype, gen, chunk=None):
    """Maverick's decode step: 40 q heads at group 5 against the strided
    view of a (B, W, 16, 128) cache of duplicated kv heads; ``fills``:
    tokens written per slot (a chunk-local ring past 8,192 evicts and
    masks the last chunk's keys)."""
    Hkv, hd = 8, 128
    q = torch.randn(B, 5 * Hkv, hd, generator=gen, device="cuda").to(dtype)
    kt = dup_heads(B, W, Hkv, hd, dtype, gen).transpose(1, 2)
    vt = dup_heads(B, W, Hkv, hd, dtype, gen).transpose(1, 2)
    k_pos = torch.full((B, W), -1, dtype=torch.int32)
    for b, n in enumerate(fills):
        t = torch.arange(max(0, n - W), n, dtype=torch.int32)
        k_pos[b, (t % W).long()] = t
    q_pos = torch.tensor([n - 1 for n in fills], dtype=torch.int32)
    k_pos, q_pos = k_pos.to("cuda"), q_pos.to("cuda")
    plain = functools.partial(REF.decode_attention, chunk=chunk)
    args = (q, kt, vt, q_pos, k_pos)
    got = DA.decode_attention(*args, chunk=chunk)
    want = plain(*args)
    rows = torch.ones_like(want, dtype=torch.bool)
    err = check_close(f"decode B{B} H40/8 (kv ::2 of 16) W{W} chunk{chunk} "
                      f"{dtype}", got, want, rows, dtype)
    wide = check_wide(got, plain, args, rows, dtype)
    bms, by = bound_ms(*decode_work(q, kt, q_pos, k_pos, chunk=chunk), dtype)
    ms = time_ms(lambda: DA.decode_attention(*args, chunk=chunk), graph=True)
    plain_ms = time_ms(lambda: plain(*args), graph=True)
    lib = time_ms(decode_sdpa(q, kt, vt, q_pos, k_pos, chunk), graph=True)
    eager = time_ms(lambda: DA.decode_attention(*args, chunk=chunk))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib,
                bound_ms=bms, bound_by=by, wide=wide, eager_ms=eager)


def paged_pool(B, Hkv, ps, M, hd, lens, dtype, gen, S=None, shared=True):
    """A (Hkv, P+1, ps, hd) pool with P = B*M pages, block tables taking
    pages from a shuffled permutation, slot b holding lens[b] tokens, one
    unmapped (-1) logical page inside slot 0 and one physical page mapped
    by two slots. With ``S``: the last min(S, len) tokens of each slot are
    its chunk (q_pos (B, S), pads -1); else q_pos is the last token."""
    dev = "cuda"
    P = B * M
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(
        int(sum(lens)))).tolist()
    tbl = torch.full((B, M), -1, dtype=torch.int32)
    k_pos = torch.full((B, M * ps), -1, dtype=torch.int32)
    pi = 0
    for b, L in enumerate(lens):
        npg = -(-L // ps)
        tbl[b, :npg] = torch.tensor(perm[pi:pi + npg], dtype=torch.int32)
        pi += npg
        k_pos[b, :L] = torch.arange(L, dtype=torch.int32)
    if B > 1 and lens[0] > 3 * ps:
        tbl[0, 1] = -1                          # unmapped page in slot 0
        k_pos[0, ps:2 * ps] = -1
    if shared and B > 1 and lens[1] > ps:
        tbl[1, 0] = tbl[0, 0]                   # one page, two slots
    if S is None:
        q_pos = torch.tensor([L - 1 for L in lens], dtype=torch.int32)
    else:
        q_pos = torch.full((B, S), -1, dtype=torch.int32)
        for b, L in enumerate(lens):
            nv = min(S, L)
            q_pos[b, :nv] = torch.arange(L - nv, L, dtype=torch.int32)
    kp = torch.randn(Hkv, P + 1, ps, hd, generator=gen, device=dev).to(dtype)
    vp = torch.randn(Hkv, P + 1, ps, hd, generator=gen, device=dev).to(dtype)
    return kp, vp, tbl.to(dev), q_pos.to(dev), k_pos.to(dev)


def paged_traffic(tbl, q_pos, k_pos, ps, Hq, Hkv, hd, e, S=None):
    """(operations, bytes) the paged function must move at least: valid
    (query, key) pairs for the operations; each valid pool row read once
    (a page mapped by two slots counted once), the valid q rows read
    once, out written once in full, and the table and positions."""
    qp = q_pos if S is not None else q_pos[:, None]
    ok = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= qp[:, :, None])
    pairs = float(ok.sum().item())
    key_valid = ok.any(dim=1)                       # (B, M*ps)
    M = tbl.shape[1]
    lp = torch.arange(M * ps, device=tbl.device) // ps
    phys = tbl[:, lp].long() * ps + torch.arange(
        M * ps, device=tbl.device) % ps
    rows = float(phys[key_valid & (tbl[:, lp] >= 0)].unique().numel())
    n_q, q_rows = q_pos.numel(), float((q_pos >= 0).sum().item())
    flops = 4.0 * hd * pairs * Hq
    nbytes = (rows * Hkv * 2 * hd * e + (q_rows + n_q) * Hq * hd * e
              + (tbl.numel() + k_pos.numel() + q_pos.numel()) * 4)
    return flops, nbytes


def paged_fills():
    """The paged decode cases' fills: 16..2048 tokens in each of 8 slots,
    slot 0 full, slot 1 long enough to share its first page."""
    fills = torch.randint(16, 2049, (8,), generator=torch.Generator()
                          .manual_seed(3)).tolist()
    fills[0], fills[1] = 2048, max(fills[1], 64)
    return fills


def paged_inputs(B, Hq, Hkv, lens, dtype, gen, ps=16, M=128, hd=64):
    """One paged decode step: ``paged_pool`` and q. Returns (q, k_pages,
    v_pages, tbl, q_pos, k_pos)."""
    kp, vp, tbl, q_pos, k_pos = paged_pool(B, Hkv, ps, M, hd, lens, dtype,
                                           gen)
    q = torch.randn(B, Hq, hd, generator=gen, device="cuda").to(dtype)
    return q, kp, vp, tbl, q_pos, k_pos


def paged_sdpa(q, kp, vp, tbl, q_pos, k_pos):
    """``scaled_dot_product_attention`` over the logical view gathered
    beforehand (the gather not timed), same mask."""
    from repro_torch.kernels import ref as REF
    return decode_sdpa(q, REF.logical_view(kp, tbl),
                       REF.logical_view(vp, tbl), q_pos, k_pos)


def paged_case(PD, REF, B, Hq, Hkv, lens, dtype, gen, ps=16, M=128, hd=64):
    args = paged_inputs(B, Hq, Hkv, lens, dtype, gen, ps, M, hd)
    return paged_check(PD, REF, f"paged B{B} H{Hq}/{Hkv} M{M} hd{hd} "
                       f"{dtype}", *args)


def paged_check(PD, REF, name, q, kp, vp, tbl, q_pos, k_pos):
    """One paged decode launch held against the plain version (TOL, and
    TOL_WIDE for bf16), timed beside its bound and SDPA."""
    dtype, ps, (B, Hq, hd), Hkv = q.dtype, kp.shape[2], q.shape, kp.shape[0]
    got = PD.paged_decode_attention(q, kp, vp, tbl, q_pos, k_pos)
    want = REF.paged_decode_attention(q, kp, vp, tbl, q_pos, k_pos)
    rows = torch.ones_like(want, dtype=torch.bool)
    err = check_close(name, got, want, rows, dtype)
    wide = check_wide(got, REF.paged_decode_attention,
                      (q, kp, vp, tbl, q_pos, k_pos), rows, dtype)
    flops, nbytes = paged_traffic(tbl, q_pos, k_pos, ps, Hq, Hkv, hd,
                                  q.element_size())
    bms, by = bound_ms(flops, nbytes, dtype)
    ms = time_ms(lambda: PD.paged_decode_attention(q, kp, vp, tbl, q_pos,
                                                   k_pos), graph=True)
    plain = time_ms(lambda: REF.paged_decode_attention(q, kp, vp, tbl, q_pos,
                                                       k_pos), graph=True)
    lib = time_ms(paged_sdpa(q, kp, vp, tbl, q_pos, k_pos), graph=True)
    eager = time_ms(lambda: PD.paged_decode_attention(q, kp, vp, tbl, q_pos,
                                                      k_pos))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, wide=wide, eager_ms=eager)


def chunk_inputs(Hq, Hkv, lens, S, dtype, gen, ps=16, M=128, hd=64):
    """One chunked-prefill launch's operands: slot b holds lens[b] tokens,
    of which the last min(S, len) are its chunk (the history before them);
    q in the model's (B,S,H,hd) layout seen as (B,H,S,hd). Returns (q,
    k_pages, v_pages, tbl, q_pos, k_pos)."""
    B = len(lens)
    kp, vp, tbl, q_pos, k_pos = paged_pool(B, Hkv, ps, M, hd, lens, dtype,
                                           gen, S=S, shared=False)
    q = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dtype)
    return q.transpose(1, 2), kp, vp, tbl, q_pos, k_pos


def chunk_sdpa(q, kp, vp, tbl, q_pos, k_pos):
    """``scaled_dot_product_attention`` over the logical view gathered
    beforehand (the gather not timed), pad rows unmasked (no NaN)."""
    from repro_torch.kernels import ref as REF
    kk, vv = REF.logical_view(kp, tbl), REF.logical_view(vp, tbl)
    mask = ((k_pos[:, None, :] >= 0)
            & (k_pos[:, None, :] <= q_pos[:, :, None]))[:, None]
    mask = mask | (q_pos < 0)[:, None, :, None]
    gqa = q.shape[1] != kp.shape[0]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kk, vv, attn_mask=mask, enable_gqa=gqa)


def chunk_case(CP, REF, Hq, Hkv, lens, S, dtype, gen, ps=16, M=128,
               hd=64):
    """One chunked-prefill launch: slot b holds lens[b] tokens, of which
    the last min(S, len) are its chunk (the history before them)."""
    B = len(lens)
    args = chunk_inputs(Hq, Hkv, lens, S, dtype, gen, ps, M, hd)
    return chunk_check(CP, REF, f"chunk B{B} H{Hq}/{Hkv} S{S} hd{hd} "
                       f"{dtype}", args)


def chunk_check(CP, REF, name, args):
    """One chunked-prefill launch held against the plain version (TOL,
    and TOL_WIDE for bf16) on its valid query rows, timed beside its bound
    and SDPA."""
    qt, kp, vp, tbl, q_pos, k_pos = args
    dtype, ps, Hkv = qt.dtype, kp.shape[2], kp.shape[0]
    _, Hq, S, hd = qt.shape
    got = CP.chunked_prefill_attention(*args)
    want = REF.chunked_prefill_attention(*args)
    rows = (q_pos >= 0)[:, None, :, None].expand_as(want)
    err = check_close(name, got, want, rows, dtype)
    wide = check_wide(got, REF.chunked_prefill_attention, args, rows, dtype)
    flops, nbytes = paged_traffic(tbl, q_pos, k_pos, ps, Hq, Hkv, hd,
                                  qt.element_size(), S=S)
    bms, by = bound_ms(flops, nbytes, dtype)
    ms = time_ms(lambda: CP.chunked_prefill_attention(*args), graph=True)
    plain = time_ms(lambda: REF.chunked_prefill_attention(*args), graph=True)
    lib = time_ms(chunk_sdpa(*args), graph=True)
    eager = time_ms(lambda: CP.chunked_prefill_attention(*args))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, wide=wide, eager_ms=eager)


def dup_pool(pages):
    """Maverick's pool of a (8, P+1, ps, hd) one: each kv head twice,
    (16, P+1, ps, hd) as ``paginate_cache`` holds its duplicated heads;
    returns the kernels' operand, the view ``::2`` (a stride, no copy)."""
    H = pages.shape[0]
    return pages[:, None].expand(H, 2, *pages.shape[1:]).reshape(
        2 * H, *pages.shape[1:])[::2]


def maverick_paged_case(PD, REF, fills, dtype, gen):
    """Maverick's paged decode step: q heads :40 of 48 at group 5 over the
    view ::2 of a pool of 16 duplicated kv heads (hd 128), the paged
    cases' fills."""
    q, kp, vp, tbl, q_pos, k_pos = paged_inputs(8, 40, 8, fills, dtype, gen,
                                                hd=128)
    q = torch.randn(8, 48, 128, generator=gen, device="cuda").to(
        dtype)[:, :40]
    return paged_check(PD, REF, f"paged B8 H40/8 (kv ::2 of 16) M128 "
                       f"hd128 {dtype}", q, dup_pool(kp), dup_pool(vp), tbl,
                       q_pos, k_pos)


def maverick_chunk_case(CP, REF, lens, S, dtype, gen):
    """Maverick's chunked prefill (group 5, the chunk kernel's instance
    for it): q heads :40 of the (B, S, 48, 128) projection over the view
    ::2 of a pool of 16 duplicated kv heads; slot b holds lens[b] tokens,
    the last min(S, len) its chunk."""
    _, kp, vp, tbl, q_pos, k_pos = chunk_inputs(40, 8, lens, S, dtype, gen,
                                                hd=128)
    q = torch.randn(len(lens), S, 48, 128, generator=gen,
                    device="cuda").to(dtype)[:, :, :40].transpose(1, 2)
    return chunk_check(CP, REF, f"chunk B{len(lens)} H40/8 (kv ::2 of 16) "
                       f"S{S} hd128 {dtype}",
                       (q, dup_pool(kp), dup_pool(vp), tbl, q_pos, k_pos))


def fleet_inputs(Hq, Hkv, fills, dtype, gen, chunk=None, ps=16, M=128,
                 hd=64):
    """One launch of a paged kernel on the fleet's path, its operands built
    as ``ShardedServingEngine`` builds them: S shards of B slots
    (``fills``: S lists of B token counts, 0 an idle slot), each shard
    with its own ``FLEET_PAGES`` pages taken from a shuffled permutation,
    one unmapped (-1) logical page inside its slot 0 and one page mapped by
    its slots 0 and 1; the allocator's (S, B, M) table of shard-local ids
    made into the (S*B, M) table of pool page ids by ``paged.model_table``;
    one (Hkv, S*P + 1, ps, hd) pool. Decode (``chunk`` None): every one of
    the S*B rows, an idle slot's row all -1 with one valid key, the token
    its decode step writes into the trash page. Chunked prefill (``chunk``
    = C): the rows of the slots with tokens, the last min(C, fill) of each
    its chunk. Returns the kernel's operands and the shard-local table."""
    from repro_torch.serving import paged as PG
    dev = "cuda"
    S, B, P = len(fills), len(fills[0]), FLEET_PAGES
    local = torch.full((S, B, M), -1, dtype=torch.int32)
    k_pos = torch.full((S * B, M * ps), -1, dtype=torch.int32)
    q_pos = torch.full((S * B,) if chunk is None else (S * B, chunk), -1,
                       dtype=torch.int32)
    for s, lens in enumerate(fills):
        perm = torch.randperm(P, generator=torch.Generator().manual_seed(
            100 + s)).to(torch.int32)
        pi = 0
        for b, L in enumerate(lens):
            r = s * B + b
            if L == 0:                          # idle: one key, the trash
                k_pos[r, 0], q_pos[r] = 0, 0
                continue
            npg = -(-L // ps)
            local[s, b, :npg] = perm[pi:pi + npg]
            pi += npg
            k_pos[r, :L] = torch.arange(L, dtype=torch.int32)
            if chunk is None:
                q_pos[r] = L - 1
            else:
                nv = min(chunk, L)
                q_pos[r, :nv] = torch.arange(L - nv, L, dtype=torch.int32)
        if lens[0] > 3 * ps:
            local[s, 0, 1] = -1                 # unmapped page in slot 0
            k_pos[s * B, ps:2 * ps] = -1
        if chunk is None and lens[1] > ps:
            local[s, 1, 0] = local[s, 0, 0]     # one page, two slots
    alloc = PG.init_allocator(B, M, P, dev, shards=S)
    alloc["tbl"] = local.to(dev)
    tbl = PG.model_table(alloc)
    rows = torch.tensor([s * B + b for s, lens in enumerate(fills)
                         for b, L in enumerate(lens)
                         if chunk is None or L > 0], device=dev)
    kp = torch.randn(Hkv, S * P + 1, ps, hd, generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn(Hkv, S * P + 1, ps, hd, generator=gen,
                     device=dev).to(dtype)
    n = rows.numel()
    if chunk is None:
        q = torch.randn(n, Hq, hd, generator=gen, device=dev).to(dtype)
    else:
        q = torch.randn(n, chunk, Hq, hd, generator=gen,
                        device=dev).to(dtype).transpose(1, 2)
    return ((q, kp, vp, tbl[rows].contiguous(), q_pos.to(dev)[rows],
             k_pos.to(dev)[rows]), local.to(dev), rows)


def fleet_per_shard(fn, name, args, local, rows, B):
    """``fn`` on each shard's own pool (its P pages and the trash page)
    with its shard-local table, as a single engine of that shard would
    call it: the fleet launch's rows must agree with these to TOL (a
    launch over other rows may split its work otherwise)."""
    q, kp, vp, _, q_pos, k_pos = args
    S, P = local.shape[0], (kp.shape[1] - 1) // local.shape[0]
    full = fn(*args)
    for s in range(S):
        sel = ((rows >= s * B) & (rows < (s + 1) * B)).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        own = [torch.cat([x[:, s * P:(s + 1) * P], x[:, -1:]], dim=1)
               for x in (kp, vp)]
        got = fn(q[sel], *own, local[s][rows[sel] - s * B], q_pos[sel],
                 k_pos[sel])
        valid = q_pos[sel] >= 0                 # chunk: pad queries out
        valid = (valid[:, None, None] if q_pos.dim() == 1
                 else valid[:, None, :, None])
        check_close(f"{name}, shard {s}'s own call", full[sel], got,
                    valid.expand_as(got), q.dtype)


def ssd_inputs(B, H, T, cl, P, N, dtype, gen):
    """One SSD-chunk launch's arguments in the mamba2 block's layout: (B,
    T, H, *) projections seen as (B, H, nc, cl, *) views, one B/C group
    broadcast over the heads through a stride-0 view; dt = softplus(N(0,1)
    - 4) (the model's initial dt is about 0.01) and A = -[1 .. 16], as
    initialised."""
    dev = "cuda"
    nc = T // cl
    x = torch.randn(B, T, H, P, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, H, generator=gen, device=dev) - 4)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    bc = torch.randn(2, B, T, 1, N, generator=gen, device=dev)
    x, dt, bc = x.to(dtype), dt.to(dtype), bc.to(dtype)
    view = lambda t: t.reshape(B, nc, cl, H, -1).permute(0, 3, 1, 2, 4)
    return (view(x), dt.reshape(B, nc, cl, H).permute(0, 3, 1, 2), A,
            view(bc[0].expand(B, T, H, N)), view(bc[1].expand(B, T, H, N)))


def ssd_work(x, dt, A, Bm, Cm) -> tuple:
    """(operations, bytes, peak) of one SSD chunk call: the causal pairs'
    two products and h's; x, dt, one B/C group and A read once, the three
    float32 outputs written once; the products' tensor-core rate (bf16, or
    TF32 for float32 inputs)."""
    B, H, nc, cl, P = x.shape
    N = Bm.shape[-1]
    pairs = B * H * nc * cl * (cl + 1) / 2
    flops = 2.0 * pairs * (N + P) + 2.0 * B * H * nc * cl * P * N
    e = x.element_size()
    outs = B * H * nc * (cl * P + P * N + 1)
    nbytes = ((x.numel() + dt.numel() + 2 * B * nc * cl * N) * e
              + A.numel() * 4 + outs * 4)
    return flops, nbytes, (PEAK_BF16 if x.dtype == torch.bfloat16
                           else PEAK_TF32)


def ssd_check(label, got, want) -> float:
    """Max abs error of the three outputs; raise past atol and rtol 1e-4.
    Both versions read the inputs into float32 and compute there, so the
    kernel is held to the float32 tolerance in either input type (for bf16
    inputs that is the check against the plain version in float32)."""
    return max(check_close(label, g, w, torch.ones_like(w, dtype=torch.bool),
                           torch.float32) for g, w in zip(got, want))


def ssd_case(SSD, REF, B, H, T, cl, P, N, dtype, gen):
    args = ssd_inputs(B, H, T, cl, P, N, dtype, gen)
    label = f"ssd B{B} H{H} T{T} cl{cl} P{P} N{N} {dtype}"
    err = ssd_check(label, SSD.ssd_chunk(*args), REF.ssd_chunk(*args))
    flops, nbytes, peak = ssd_work(*args)
    # on the tensor cores; the CUDA cores' float32 bound printed beside it
    bms, by = bound_ms(flops, nbytes, dtype, peak)
    cuda_core = bound_ms(flops, nbytes, torch.float32, PEAK_F32)[0]
    ms = time_ms(lambda: SSD.ssd_chunk(*args), graph=True)
    plain = time_ms(lambda: REF.ssd_chunk(*args), iters=5)
    eager = time_ms(lambda: SSD.ssd_chunk(*args))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=bms, bound_by=by, eager_ms=eager,
                wide=(err if dtype == torch.bfloat16 else None, 0),
                cuda_core_bound_ms=cuda_core)


def wkv6_inputs(B, H, T, hd, dtype, gen):
    """One WKV6 launch's arguments in the rwkv6 block's layout: (B, T, H,
    hd) projections seen as (B, H, T, hd) views, r/k/v in ``dtype``, the
    decay w = exp(-exp(-6 + N(0, 0.1))) ~ 0.9975 in float32 as the model
    makes it, u ~ N(0, 0.5), s0 ~ N(0, 0.1)."""
    dev = "cuda"
    r, k, v = (torch.randn(B, T, H, hd, generator=gen, device=dev).to(dtype)
               .transpose(1, 2) for _ in range(3))
    w = torch.exp(-torch.exp(-6 + 0.1 * torch.randn(
        B, T, H, hd, generator=gen, device=dev))).transpose(1, 2)
    u = 0.5 * torch.randn(H, hd, generator=gen, device=dev)
    s0 = 0.1 * torch.randn(B, H, hd, hd, generator=gen, device=dev)
    return r, k, v, w, u, s0


def wkv6_work(r, k, v, w, u, s0) -> tuple:
    """(operations, bytes) of one WKV6 call: out = r.S + (r.(u*k)) v and
    the update S = w*S + k(x)v, 4 hd^2 float32 operations a step; r/k/v/w
    read and out written once, u, s0 and the final state once."""
    B, H, T, hd = r.shape
    flops = 4.0 * B * H * T * hd * hd
    nbytes = (3 * r.numel() * r.element_size() + w.numel() * w.element_size()
              + 4 * u.numel() + 2 * 4 * s0.numel() + 4 * r.numel())
    return flops, nbytes


def wkv6_check(label, got, want) -> float:
    """Max abs error of out and the final state; raise past WKV_REL of the
    largest magnitude of each (relative and absolute)."""
    err = 0.0
    for g, wt in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: non-finite output")
        scale = max(1.0, wt.abs().max().item())
        e = (g - wt).abs()
        bad = int((e > WKV_REL * scale + WKV_REL * wt.abs()).sum())
        if bad:
            raise AssertionError(f"{label}: {bad} elements past {WKV_REL} "
                                 f"of the largest output {scale:.3e} (max "
                                 f"abs err {e.max().item():.3e})")
        err = max(err, e.max().item())
    return err


def wkv6_case(WKV, REF, B, H, T, hd, dtype, gen):
    """The kernel with the final state written over s0 (as decode does),
    against the plain version on a copy of s0."""
    r, k, v, w, u, s0 = wkv6_inputs(B, H, T, hd, dtype, gen)
    state = s0.clone()
    got = WKV.wkv6(r, k, v, w, u, state, state)
    err = wkv6_check(f"wkv6 B{B} H{H} T{T} hd{hd} {dtype}", got,
                     REF.wkv6(r, k, v, w, u, s0))
    bms, by = bound_ms(*wkv6_work(r, k, v, w, u, s0), torch.float32)
    ms = time_ms(lambda: WKV.wkv6(r, k, v, w, u, s0), graph=True)
    plain = time_ms(lambda: REF.wkv6(r, k, v, w, u, s0), warmup=1,
                    iters=2 if T > 1 else 20, graph=True)
    eager = time_ms(lambda: WKV.wkv6(r, k, v, w, u, s0))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=bms, bound_by=by, eager_ms=eager,
                wide=(err if dtype == torch.bfloat16 else None, 0))


def rmsnorm_inputs(RMS, REF, variant, R, d, dtype, gen, stride=None):
    """The main paths' inputs of one RMSNorm prologue on (R, d) rows (a
    prefill's or a decode step's): x, delta and the second segment e in
    ``dtype``, x the first d of rows ``stride`` wide where given (MLA's
    ``kv_norm`` reads the latent 512 of each 576-wide ``dkv`` row, no
    copy); the gate's y float32 and z float32 rows of Mamba2's wider
    in-projection (2 d + 240 wide, as zamba2-7b's z among x, B, C and dt);
    scale ~ 1 + N(0, 0.1) in ``dtype``, over 2 d for the concat. Returns
    (kernel, plain, yardstick, unfused, args, bytes): the kernel's wrapper,
    its plain version returning y, one PyTorch sequence the port never
    calls (``F.rms_norm`` after the same add, concat or gate), the launches
    the model made before the prologues (``unfused(norm, *args)``: the
    add, concat or gate, then ``norm``, a plain-row RMSNorm wrapper), the
    inputs, and the bytes read once and written once."""
    F = torch.nn.functional
    dev = "cuda"

    def randn(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    width = 2 * d if "cat" in variant else d
    scale = (1 + 0.1 * torch.randn(width, generator=gen, device=dev)).to(
        dtype)
    x, delta, e = randn(R, stride or d)[:, :d], randn(R, d), randn(R, d)
    es = x.element_size()
    nbytes = width * scale.element_size()
    if variant == "plain":
        return (lambda a, sc: RMS.rmsnorm(a, sc),
                lambda a, sc: REF.rmsnorm(a, sc, 1e-5),
                lambda a, sc: F.rms_norm(a, (d,), sc, 1e-5),
                lambda norm, a, sc: norm(a, sc),
                (x, scale), nbytes + 2.0 * R * d * es)
    if variant == "add":
        return (lambda a, b, sc: RMS.add_rmsnorm(a, b, sc),
                lambda a, b, sc: REF.add_rmsnorm(a, b, sc, 1e-5)[1],
                lambda a, b, sc: F.rms_norm(a + b, (d,), sc, 1e-5),
                lambda norm, a, b, sc: norm(a + b, sc),
                (x, delta, scale), nbytes + 4.0 * R * d * es)
    if variant == "cat":
        return (lambda a, c, sc: RMS.cat_rmsnorm(a, c, sc),
                lambda a, c, sc: REF.cat_rmsnorm(a, c, sc, 1e-5),
                lambda a, c, sc: F.rms_norm(torch.cat([a, c], -1), (2 * d,),
                                            sc, 1e-5),
                lambda norm, a, c, sc: norm(torch.cat([a, c], -1), sc),
                (x, e, scale), nbytes + 4.0 * R * d * es)
    if variant == "add+cat":
        return (lambda a, b, c, sc: RMS.cat_rmsnorm(a, c, sc, delta=b),
                lambda a, b, c, sc: REF.cat_rmsnorm(a, c, sc, 1e-5, b)[1],
                lambda a, b, c, sc: F.rms_norm(torch.cat([a + b, c], -1),
                                               (2 * d,), sc, 1e-5),
                lambda norm, a, b, c, sc: norm(torch.cat([a + b, c], -1),
                                               sc),
                (x, delta, e, scale), nbytes + 6.0 * R * d * es)
    y = randn(R, d, dt=torch.float32)
    z = randn(R, 2 * d + 240, dt=torch.float32)[:, :d]
    return (lambda a, b, sc: RMS.gated_rmsnorm(a, b, sc, 1e-5, sc.dtype),
            lambda a, b, sc: REF.gated_rmsnorm(a, b, sc, 1e-5, sc.dtype),
            lambda a, b, sc: F.rms_norm((a * F.silu(b)).to(sc.dtype), (d,),
                                        sc, 1e-5),
            lambda norm, a, b, sc: norm((a * F.silu(b)).to(sc.dtype), sc),
            (y, z, scale), nbytes + 8.0 * R * d + R * d * es)


# float32 operations per element of the formed row: the norm's square, sum
# and two products, the add, the gate's negation, exp, add, division and
# product
RMS_FLOPS = {"plain": 4, "add": 5, "cat": 4, "add+cat": 4.5, "gate": 9}


def rmsnorm_case(RMS, REF, variant, R, d, dtype, gen, stride=None):
    """One launch of RMSNorm prologue ``variant`` (``rmsnorm_inputs``)
    against its plain version, x + delta bit-identical to PyTorch's; the
    kernel, plain, yardstick and before-the-prologues (``unfused_ms``)
    times from graph replays, and the eager time."""
    kern, plain, lib, unfused, args, nbytes = rmsnorm_inputs(
        RMS, REF, variant, R, d, dtype, gen, stride)
    label = f"{variant} R{R} d{d} {dtype}"
    out = kern(*args)
    if isinstance(out, tuple):
        s, got = out
        if not torch.equal(s, args[0] + args[1]):
            raise AssertionError(f"{label}: x + delta not bit-identical")
    else:
        got = out
    want = plain(*args)
    rows = torch.ones_like(want, dtype=torch.bool)
    err = check_close(f"rmsnorm {label}", got, want, rows, dtype)
    wide = check_wide(got, plain, args, rows, dtype)
    width = got.shape[1]
    bms, by = bound_ms(RMS_FLOPS[variant] * R * width, nbytes,
                       torch.float32)
    ms = time_ms(lambda: kern(*args), graph=True)
    plain_ms = time_ms(lambda: plain(*args), graph=True)
    lib_ms = time_ms(lambda: lib(*args), graph=True)
    unfused_ms = (None if variant == "plain" else time_ms(
        lambda: unfused(RMS.rmsnorm, *args), graph=True))
    eager = time_ms(lambda: kern(*args), iters=200)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, wide=wide, eager_ms=eager,
                unfused_ms=unfused_ms)


def norm_report(card):
    """Every instance of ``rmsnorm_kernel`` (row type x scale type x the
    five prologues x the one-pass register path, the vector loop and the
    element loop): ptxas' registers and spills. Raises on a spill or a
    missing instance."""
    print(f"\n[rmsnorm] kernel instances ({card})")
    inst = _ptxas_instances("rmsnorm", "rmsnorm_kernel")
    args = _template_args(inst, "rmsnorm_kernel")
    for name, e in sorted(inst.items(), key=lambda x: args[x[0]]):
        print(f"  rmsnorm_kernel<{args[name]}>: {e['regs']} registers, "
              f"{e['spill']} bytes spill")
    bad = [args[n] for n, e in inst.items() if e["spill"]]
    if len(inst) != 60 or bad:
        raise AssertionError(f"rmsnorm_kernel: {len(inst)} instances (want "
                             f"60); spilling: {bad}")


def tensor_core_report(card):
    """The bf16 instances of the two prefill attention kernels: ptxas'
    registers and spills per instance, and the tensor-core (HMMA)
    instructions in their SASS (``cuobjdump -sass``). Raises if a bf16 instance spills or
    has no HMMA, or a float32 instance has one."""
    import re
    from pathlib import Path

    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    print(f"\n[tensor cores] bf16 prefill attention instances ({card})")
    for lib in ("flash_attention", "chunked_prefill_attention"):
        entries, cur = {}, None
        for line in build.ptxas_log(lib).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = entries.setdefault(m.group(1), {"ptxas": []})
            elif cur is not None and ("spill" in line or "registers" in line):
                cur["ptxas"].append(line.strip())
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.build([lib])[lib])],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                entries.setdefault(fn, {"ptxas": []})["hmma"] = 0
            elif fn is not None and "HMMA" in line:
                entries[fn]["hmma"] += 1
        named = []
        for name, e in entries.items():
            m = re.search(r"((?:flash|chunk)_(?:tc|fwd)_kernel)ILi(\d+)E",
                          name)
            if m:
                named.append((m.group(1), int(m.group(2)), e))
        for kernel, hd, e in sorted(named, key=lambda x: x[:2]):
            hmma = e.get("hmma", 0)
            tensor = "_tc_" in kernel
            spills = [int(x) for line in e["ptxas"] if "spill" in line
                      for x in re.findall(r"(\d+) bytes spill", line)]
            print(f"  {kernel}<{hd}>: HMMA {hmma}; "
                  + "; ".join(e["ptxas"]))
            if tensor and (hmma == 0 or any(spills)):
                raise AssertionError(f"{kernel}<{hd}>: HMMA {hmma}, spill "
                                     f"bytes {spills}")
            if not tensor and hmma:
                raise AssertionError(f"{kernel}<{hd}>: float32 body has "
                                     f"{hmma} HMMA")


def decode_report(card):
    """Every instance of the two decode kernels (hd 8-160 x groups 1-5
    and 8 x float32 / bf16, and float32 hd 20, one split-KV core, hd_v ==
    hd; and the
    contiguous kernel's MLA pair, hd 24 with hd_v 16 at group 4): ptxas'
    registers, the range per kernel and type, and each hd 100, hd 160,
    group 3, group 5 and MLA instance's; raises if an instance spills or is
    missing."""
    import re

    from repro_torch.kernels import build
    print(f"\n[decode] split-KV core instances ({card})")
    for lib, stem in (("decode_attention", "decode_kernel"),
                      ("paged_decode_attention", "paged_decode_kernel")):
        regs, spills, cur = {}, [], None
        for line in build.ptxas_log(lib).splitlines():
            m = re.search(r"Compiling entry function '\S*" + stem
                          + r"I(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E"
                          r"(?:Li(\d+)E)?", line)
            if m:
                cur = ("bf16" if m.group(1) != "f" else "f32",
                       int(m.group(2)), int(m.group(3)))
                if m.group(4) and int(m.group(4)) != cur[1]:
                    cur += (int(m.group(4)),)        # hd_v != hd
            elif cur and "registers" in line:
                regs[cur] = int(re.search(r"Used (\d+) registers",
                                          line).group(1))
            elif cur and "spill" in line and re.search(
                    r"[1-9]\d* bytes spill", line):
                spills.append((cur, line.strip()))
        want = {(t, hd, g) for t in ("bf16", "f32")
                for hd in (8, 16, 32, 64, 100, 112, 128, 160)
                for g in (1, 2, 3, 4, 5, 8)}
        # float32 hd 20: examples/serve_e2e_torch.py's model
        want |= {("f32", 20, g) for g in (1, 2, 3, 4, 5, 8)}
        if lib == "decode_attention":
            want |= {(t, 24, 4, 16) for t in ("bf16", "f32")}
        for t in ("f32", "bf16"):
            r = {k[1:]: v for k, v in regs.items() if k[0] == t}
            n_spill = sum(1 for k, _ in spills if k[0] == t)
            print(f"  {stem} {t}: {len(r)} instances, registers "
                  f"{min(r.values())}-{max(r.values())} "
                  f"(hd 64 g1 {r.get((64, 1))}, hd 112 g1 "
                  f"{r.get((112, 1))}); {n_spill} spill" if r else
                  f"  {stem} {t}: no instance")
        for t in ("f32", "bf16"):
            print(f"  {stem} {t} hd 100 and 160 (g1-8) and group 3 (hd "
                  "8-160) registers: " + ", ".join(
                      f"hd{k[1]} g{k[2]} {r}" for k, r in sorted(
                          regs.items())
                      if len(k) == 3 and k[0] == t
                      and (k[1] in (100, 160) or k[2] == 3)))
            print(f"  {stem} {t} group 5 (Maverick) registers: " + ", ".join(
                f"hd{k[1]} {r}" for k, r in sorted(regs.items())
                if len(k) == 3 and k[0] == t and k[2] == 5))
            mla = {k: v for k, v in regs.items() if len(k) == 4 and k[0] == t}
            if mla:
                print(f"  {stem} {t} hd 24 / hd_v 16 g4 (MLA) registers: "
                      + ", ".join(str(v) for v in mla.values()))
        if set(regs) != want or spills:
            raise AssertionError(f"{stem}: instances {sorted(want - set(regs))}"
                                 f" missing, spills {spills}")


def _ptxas_instances(lib, stem, csrc=None):
    """{entry: {"regs": n, "spill": bytes}} of the entries of library
    ``lib`` (built from ``csrc``, by default this tree's sources) whose
    mangled name holds ``stem``, from ptxas' report."""
    import re

    from repro_torch.kernels import build
    out, cur = {}, None
    for line in build.ptxas_log(lib, csrc).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if stem in m.group(1) else None
            if cur:
                out[cur] = {"regs": None, "spill": 0}
        elif cur and "registers" in line:
            out[cur]["regs"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
        elif cur and "spill" in line:
            out[cur]["spill"] += sum(int(x) for x in
                                     re.findall(r"(\d+) bytes spill", line))
    return out


def _sass_hmma(lib):
    """{entry: tensor-core (HMMA) instructions} of library ``lib``, from
    ``cuobjdump -sass``."""
    import re
    from pathlib import Path

    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.build([lib])[lib])],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def _template_args(names, stem):
    """{mangled name: 'bf16 f32 64'} for the instances ``stem<...>`` in
    ``names``: their template arguments, demangled by the toolkit's
    ``cu++filt`` (the mangled name where it cannot)."""
    import re
    from pathlib import Path

    from repro_torch.kernels import build
    names = sorted(names)
    try:
        out = subprocess.run(
            [str(Path(build.nvcc_path()).with_name("cu++filt")), *names],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = names
    short = {"__nv_bfloat16": "bf16", "float": "f32"}
    res = {}
    for name, dem in zip(names, out):
        m = re.search(stem + r"<(.*?)>", dem)
        res[name] = (" ".join(
            short.get(x.strip(), x.strip().replace("(int)", ""))
            for x in m.group(1).split(",")) if m else name)
    return res


def scan_report(card):
    """Every instance of the two scan kernels: ``wkv6`` (hd 8-64 x the five
    type combinations of r/k/v, w and u) and ``ssd_chunk`` (P 8-64 x N
    4-64 x float32 / bf16): ptxas' registers and spills, and the SSD
    instances' tensor-core (HMMA) instructions. Raises on a spill, a
    missing instance or an SSD instance without HMMA."""
    print(f"\n[scan kernels] wkv6 and ssd_chunk instances ({card})")
    for lib, stem, want in (("wkv6", "wkv6_kernel", 20),
                            ("ssd_chunk", "ssd_chunk_kernel", 40)):
        inst = _ptxas_instances(lib, stem)
        hmma = _sass_hmma(lib) if lib == "ssd_chunk" else None
        args = _template_args(inst, stem)
        for name, e in sorted(inst.items(), key=lambda x: args[x[0]]):
            tc = "" if hmma is None else f"; HMMA {hmma.get(name, 0)}"
            print(f"  {stem}<{args[name]}>: {e['regs']} registers, "
                  f"{e['spill']} bytes spill{tc}")
        bad = [args[n] for n, e in inst.items()
               if e["spill"] or (hmma is not None and not hmma.get(n))]
        if len(inst) != want or bad:
            raise AssertionError(f"{stem}: {len(inst)} instances (want "
                                 f"{want}); spilling or without HMMA: {bad}")


def phase_kernels(card):
    tensor_core_report(card)
    decode_report(card)
    scan_report(card)
    norm_report(card)
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as REF
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    flash = {}
    for label, args in [
            ("flash B8 H32/32 S128 bf16", (8, 32, 32, 128, bf)),
            ("flash B8 H32/32 S512 bf16", (8, 32, 32, 512, bf)),
            ("flash B8 H32/16 S512 bf16", (8, 32, 16, 512, bf)),
            ("flash B2 H32/32 S128 f32", (2, 32, 32, 128, f32)),
            ("flash B8 H32/32 S512 hd112 bf16", (8, 32, 32, 512, bf, 112)),
            ("flash B2 H32/32 S128 hd112 f32", (2, 32, 32, 128, f32, 112)),
            ("flash B8 H32/32 S512 hd100 bf16", (8, 32, 32, 512, bf, 100)),
            ("flash B2 H32/32 S128 hd100 f32", (2, 32, 32, 128, f32, 100)),
            ("flash B8 H32/16 S512 hd160 bf16", (8, 32, 16, 512, bf, 160)),
            ("flash B2 H32/16 S128 hd160 f32", (2, 32, 16, 128, f32, 160)),
            # the memory-conditioned paths' prefills: llama-3.2-vision's
            # dense layers (64 q heads at group 4 over 16 duplicated kv
            # heads), seamless-m4t's decoder prompt (16 / 16 heads of 64)
            ("flash B4 H64/16 S256 hd128 bf16", (4, 64, 16, 256, bf, 128)),
            ("flash B4 H16/16 S64 bf16", (4, 16, 16, 64, bf))]:
        flash[label] = flash_case(FA, REF, *args[:4], args[4], gen, *args[5:])
    decode = {}
    for label, args in [
            ("decode B8 H32/32 W2048 bf16", (8, 32, 32, 2048, bf)),
            ("decode B8 H32/16 W2048 bf16", (8, 32, 16, 2048, bf)),
            ("decode B8 H32/32 W2048 f32", (8, 32, 32, 2048, f32)),
            ("decode B8 H32/32 W2048 hd112 bf16",
             (8, 32, 32, 2048, bf, 112)),
            ("decode B8 H32/32 W2048 hd100 bf16",
             (8, 32, 32, 2048, bf, 100)),
            ("decode B8 H32/32 W2048 hd128 bf16",
             (8, 32, 32, 2048, bf, 128)),
            ("decode B8 H48/16 W2048 hd128 bf16",
             (8, 48, 16, 2048, bf, 128)),
            ("decode B8 H32/16 W2048 hd160 bf16",
             (8, 32, 16, 2048, bf, 160)),
            ("decode B8 H64/16 W2048 hd128 bf16",
             (8, 64, 16, 2048, bf, 128)),
            ("decode B4 H16/16 W128 bf16", (4, 16, 16, 128, bf))]:
        decode[label] = decode_case(DA, REF, *args[:4], args[4], gen,
                                    *args[5:])
    # MLA decode (hd 24, hd_v 16 at group 4): the reference sweep's case
    mla = {f"mla decode B2 H4/1 W24 hd24/16 {n}": mla_case(DA, REF, t, gen)
           for n, t in (("f32", f32), ("bf16", bf))}
    # Llama-4 Maverick (phase 4's full-width path): flash at its long
    # prompt's bucket and a short wave's, decode at group 5 on a
    # chunk-local ring crossing 8,192 and on the global layer's cache
    ring = [8177, 8192, 8193, 8200, 8208, 300, 4096, 12288]
    maverick = {
        "flash B1 H40/8 S8192 hd128 chunk bf16":
            maverick_flash_case(FA, REF, 1, 8192, bf, gen),
        "flash B4 H40/8 S512 hd128 chunk bf16":
            maverick_flash_case(FA, REF, 4, 512, bf, gen),
        "flash B2 H40/8 S256 hd128 chunk f32":
            maverick_flash_case(FA, REF, 2, 256, f32, gen),
        "decode B8 H40/8 W8192 hd128 chunk bf16":
            maverick_decode_case(DA, REF, 8, MAVERICK_CHUNK, ring, bf, gen,
                                 chunk=MAVERICK_CHUNK),
        "decode B8 H40/8 W8448 hd128 bf16":
            maverick_decode_case(DA, REF, 8, MAVERICK_MAX_LEN,
                                 [8177, 8208, 64, 512, 1000, 4000, 8300,
                                  8448], bf, gen),
        "decode B8 H40/8 W2048 hd128 chunk f32":
            maverick_decode_case(DA, REF, 8, 2048, [100, 1024, 1025, 2048,
                                                    1500, 3000, 4000, 7],
                                 f32, gen, chunk=1024)}
    from repro_torch.kernels import chunked_prefill as CP
    from repro_torch.kernels import paged_decode_attention as PD
    fills = paged_fills()
    paged = {}
    for label, args in [
            ("paged B8 H32/32 ps16 M128 bf16", (8, 32, 32, fills, bf)),
            ("paged B8 H32/16 ps16 M128 bf16", (8, 32, 16, fills, bf)),
            ("paged B8 H32/32 ps16 M128 f32", (8, 32, 32, fills, f32)),
            ("paged B8 H32/32 ps16 M128 hd112 bf16",
             (8, 32, 32, fills, bf, 112)),
            ("paged B8 H32/32 ps16 M128 hd112 f32",
             (8, 32, 32, fills, f32, 112)),
            ("paged B8 H32/32 ps16 M128 hd100 bf16",
             (8, 32, 32, fills, bf, 100)),
            ("paged B8 H32/32 ps16 M128 hd128 bf16",
             (8, 32, 32, fills, bf, 128)),
            ("paged B8 H48/48 ps16 M128 bf16", (8, 48, 48, fills, bf)),
            ("paged B8 H48/16 ps16 M128 hd128 bf16",
             (8, 48, 16, fills, bf, 128)),
            ("paged B8 H32/16 ps16 M128 hd160 bf16",
             (8, 32, 16, fills, bf, 160))]:
        paged[label] = paged_case(PD, REF, *args[:5], gen, hd=args[5]
                                  if len(args) > 5 else 64)
    chunk = {}
    for label, args in [
            ("chunk B1 H32/32 S256 hist0 bf16", (32, 32, [256], 256, bf)),
            ("chunk B1 H32/32 S256 hist256 bf16", (32, 32, [512], 256, bf)),
            ("chunk B1 H32/32 S256 hist768 bf16", (32, 32, [1024], 256, bf)),
            ("chunk B2 H32/32 S256 packed bf16",
             (32, 32, [768, 100], 256, bf)),
            ("chunk B1 H32/16 S256 hist768 bf16", (32, 16, [1024], 256, bf)),
            ("chunk B1 H32/32 S256 hist256 f32", (32, 32, [512], 256, f32)),
            ("chunk B1 H32/32 S256 hist768 hd100 bf16",
             (32, 32, [1024], 256, bf, 100)),
            ("chunk B2 H32/32 S256 packed hd100 bf16",
             (32, 32, [768, 100], 256, bf, 100)),
            ("chunk B1 H32/32 S256 hist768 hd128 bf16",
             (32, 32, [1024], 256, bf, 128)),
            ("chunk B1 H48/48 S256 hist768 bf16", (48, 48, [1024], 256, bf)),
            ("chunk B1 H48/16 S256 hist768 hd128 bf16",
             (48, 16, [1024], 256, bf, 128)),
            ("chunk B1 H32/16 S256 hist768 hd160 bf16",
             (32, 16, [1024], 256, bf, 160)),
            ("chunk B2 H32/16 S256 packed hd160 bf16",
             (32, 16, [768, 100], 256, bf, 160))]:
        chunk[label] = chunk_case(CP, REF, *args[:5], gen,
                                  hd=args[5] if len(args) > 5 else 64)
    # the fleet's launches at phase_fleet's shapes: 4 shards x 8 slots
    # over one (Hkv, 4*1024 + 1, 16, 64) pool through paged.model_table's
    # table, idle (-1) rows and packed chunk lanes included, each also
    # held against every shard's own call on its own pool
    dfills = torch.randint(16, 2049, (FLEET_S, FLEET_B), generator=torch
                           .Generator().manual_seed(5))
    dfills[0, 0], dfills[:, 1] = 2048, dfills[:, 1].clamp(min=64)
    dfills[:, 6:], dfills[3, 4:] = 0, 0         # idle slots
    cfills = [[256, 100, 0, 0, 0, 0, 0, 0], [0, 0, 512, 0, 0, 0, 60, 0],
              [0, 1024, 0, 0, 0, 0, 0, 0], [0, 0, 0, 2048, 0, 0, 0, 160]]
    name = f"paged fleet S{FLEET_S}xB{FLEET_B} P{FLEET_PAGES} H32/32 bf16"
    args, local, rows = fleet_inputs(32, 32, dfills.tolist(), bf, gen)
    fleet_per_shard(PD.paged_decode_attention, name, args, local, rows,
                    FLEET_B)
    paged[name] = paged_check(PD, REF, name, *args)
    name = f"chunk fleet S{FLEET_S} n7 P{FLEET_PAGES} H32/32 S256 bf16"
    args, local, rows = fleet_inputs(32, 32, cfills, bf, gen, chunk=256)
    fleet_per_shard(CP.chunked_prefill_attention, name, args, local, rows,
                    FLEET_B)
    chunk[name] = chunk_check(CP, REF, name, args)
    del args, local
    # Llama-4 Maverick's paged path (full attention): q heads :40 at group
    # 5 over the pool's kv heads ::2, a wave's packed chunk of two rows
    paged["paged B8 H40/8 (kv ::2 of 16) M128 hd128 bf16"] = \
        maverick_paged_case(PD, REF, fills, bf, gen)
    chunk["chunk B2 H40/8 (kv ::2 of 16) S256 packed hd128 bf16"] = \
        maverick_chunk_case(CP, REF, [1024, 300], 256, bf, gen)
    chunk["chunk B1 H40/8 (kv ::2 of 16) S64 hd128 f32"] = \
        maverick_chunk_case(CP, REF, [200], 64, f32, gen)
    from repro_torch.kernels import ssd as SSD
    ssd = {}
    for label, args in [
            ("ssd B2 H112 T1024 cl256 P64 N64 f32",
             (2, 112, 1024, 256, 64, 64, f32)),
            ("ssd B2 H112 T1024 cl256 P64 N64 bf16",
             (2, 112, 1024, 256, 64, 64, bf)),
            ("ssd B1 H112 T64 cl64 P64 N64 f32",
             (1, 112, 64, 64, 64, 64, f32)),
            ("ssd B8 H112 T128 cl128 P64 N64 bf16",
             (8, 112, 128, 128, 64, 64, bf))]:
        ssd[label] = ssd_case(SSD, REF, *args, gen)
    from repro_torch.kernels import rmsnorm as RMS
    from repro_torch.kernels import wkv6 as WKV
    wkv = {}
    for label, args in [
            ("wkv6 B1 H32 T1024 hd64 bf16", (1, 32, 1024, 64, bf)),
            ("wkv6 B8 H32 T1 hd64 bf16", (8, 32, 1, 64, bf)),
            ("wkv6 B1 H32 T1024 hd64 f32", (1, 32, 1024, 64, f32)),
            ("wkv6 B1 H32 T16 hd64 bf16", (1, 32, 16, 64, bf)),
            ("wkv6 B2 H32 T64 hd64 bf16", (2, 32, 64, 64, bf)),
            ("wkv6 B1 H32 T119 hd64 bf16", (1, 32, 119, 64, bf)),
            ("wkv6 B1 H32 T1500 hd64 bf16", (1, 32, 1500, 64, bf))]:
        wkv[label] = wkv6_case(WKV, REF, *args, gen)
    # RMSNorm: every prologue at the main paths' rows, a decode step's 8
    # and a prefill's 1,024 (llama d 2048; zamba2 d 3584, its shared block's
    # concat of two 3584 segments and its gate over d_inner 7168;
    # stablelm-12b's ln1 add and ln2 at d 5120, and its qk-norm over head
    # dim 160: q's 32 heads x a 256-token chunk, q's and k's 32 and 16
    # heads x a decode step's 8; deepseek-v3's q_norm at q_lora 1,536 and
    # kv_norm over the latent 512 of its 576-wide rows, at a decode step's
    # 8 rows and a 4,096-token prefill's, and its ln add at d 7,168; the
    # memory-conditioned families' rows, below)
    rms = {}
    for label, args in [
            ("rmsnorm R1024 d2048 bf16", ("plain", 1024, 2048, bf)),
            ("rmsnorm R8 d2048 bf16", ("plain", 8, 2048, bf)),
            ("rmsnorm R8 d7168 bf16", ("plain", 8, 7168, bf)),
            ("rmsnorm R37 d2048 f32", ("plain", 37, 2048, f32)),
            ("rmsnorm R8 d5120 bf16", ("plain", 8, 5120, bf)),
            ("rmsnorm R8192 d160 bf16", ("plain", 8192, 160, bf)),
            ("rmsnorm R256 d160 bf16", ("plain", 256, 160, bf)),
            ("rmsnorm R128 d160 bf16", ("plain", 128, 160, bf)),
            ("add R8 d2048 bf16", ("add", 8, 2048, bf)),
            ("add R1024 d2048 bf16", ("add", 1024, 2048, bf)),
            ("add R8 d3584 bf16", ("add", 8, 3584, bf)),
            ("add R37 d2048 f32", ("add", 37, 2048, f32)),
            ("add R8 d5120 bf16", ("add", 8, 5120, bf)),
            ("cat R8 d3584+3584 bf16", ("cat", 8, 3584, bf)),
            ("add+cat R8 d3584+3584 bf16", ("add+cat", 8, 3584, bf)),
            ("add+cat R1024 d3584+3584 bf16", ("add+cat", 1024, 3584, bf)),
            ("gate R8 d7168 bf16", ("gate", 8, 7168, bf)),
            ("gate R1024 d7168 bf16", ("gate", 1024, 7168, bf)),
            ("gate R37 d7168 f32", ("gate", 37, 7168, f32)),
            ("rmsnorm R8 d1536 bf16", ("plain", 8, 1536, bf)),
            ("rmsnorm R4096 d1536 bf16", ("plain", 4096, 1536, bf)),
            ("rmsnorm R8 d512/576 bf16", ("plain", 8, 512, bf, 576)),
            ("rmsnorm R4096 d512/576 bf16", ("plain", 4096, 512, bf, 576)),
            ("add R8 d7168 bf16", ("add", 8, 7168, bf)),
            # llama-3.2-vision's decode rows at d 8,192; seamless-m4t's
            # encoder over 4 x 4,096 frames at d 1,024 (its first norm
            # plain, the others with the add)
            ("add R8 d8192 bf16", ("add", 8, 8192, bf)),
            ("rmsnorm R16384 d1024 bf16", ("plain", 16384, 1024, bf)),
            ("add R16384 d1024 bf16", ("add", 16384, 1024, bf))]:
        variant, R, d, dt, *stride = args
        rms[label] = rmsnorm_case(RMS, REF, variant, R, d, dt, gen, *stride)
    print(f"\n[kernels] vs plain version on valid rows ({card})")
    print(f"{'case':34s} {'max_abs_err':>11s} {'err_vs_f32':>10s} "
          f"{'ms':>9s} {'plain_ms':>9s} {'sdpa_ms':>9s} {'bound_ms':>9s} "
          "x_bound bound_by")
    cases = (list(flash.items()) + list(decode.items()) + list(mla.items())
             + list(maverick.items())
             + list(paged.items()) + list(chunk.items()) + list(ssd.items())
             + list(wkv.items()) + list(rms.items()))
    for label, r in cases:
        wide = "-" if r["wide"][0] is None else f"{r['wide'][0]:.3e}"
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"{label:38s} {r['max_abs_err']:11.3e} {wide:>10s} "
              f"{r['ms']:9.4f} {r['plain_ms']:9.4f} {lib:>9s} "
              f"{r['bound_ms']:9.5f} {r['ms'] / r['bound_ms']:6.1f}x "
              f"{r['bound_by']}")
    print("  (err_vs_f32: the bf16 kernel against the plain version in "
          "float32 on the same inputs; paged and chunk sdpa_ms: over the "
          "logical view gathered beforehand, the gather not timed; ssd: "
          "the largest of y_intra, h_chunk and decay, no single library "
          "call; wkv6: the larger of out and the final state, no single "
          "library call; rmsnorm: the library column is F.rms_norm, after "
          "the same add, concat or gate in PyTorch for the prologues)")
    print("  (every kernel's ms, and plain_ms and sdpa_ms but SSD's plain, "
          "from the replay of a CUDA graph of the calls, the kernels' time "
          "alone; launched eagerly, one call of the kernel takes:)")
    for label, r in cases:
        if "eager_ms" in r:
            print(f"    {label:36s} eager {r.pop('eager_ms'):9.4f} ms")
    print(f"\n[rmsnorm] each prologue against the launches it replaces "
          f"(the add, concat or gate, then the plain kernel), graph replay; "
          f"share of its bytes bound ({card})")
    for label, r in rms.items():
        before = r.pop("unfused_ms")
        print(f"  {label:34s} {r['ms']:.4f} ms"
              + ("" if before is None else
                 f", unfused {before:.4f} ms ({before / r['ms']:.2f}x)")
              + f", {100 * r['bound_ms'] / r['ms']:.1f}% of its bound "
              f"{r['bound_ms']:.5f} ms; library {r['library_ms']:.4f} ms")
    print("  (ssd bound_ms: on the tensor cores, bf16 989 TFLOP/s, float32 "
          "inputs as TF32 495; on the CUDA cores' float32, 67 TFLOP/s:)")
    for label, r in ssd.items():
        print(f"    {label:36s} bound on the CUDA cores "
              f"{r.pop('cuda_core_bound_ms'):9.5f} ms")
    print(f"\n[decode] bf16 decode kernels against SDPA with the same mask, "
          f"graph replay ({card})")
    for label, r in list(decode.items()) + list(paged.items()):
        if "bf16" in label and "H32/16" not in label:
            print(f"  {label:38s} {r['ms']:.4f} ms, SDPA "
                  f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}"
                  f"x SDPA), {r['ms'] / r['bound_ms']:.1f}x its bound "
                  f"{r['bound_ms']:.5f} ms; past TOL_WIDE {r['wide'][1]}")
    print(f"\n[mla decode] ops.mla_decode_attention through the decode "
          f"kernel's (24, 16) group-4 instance, graph replay ({card})")
    for label, r in mla.items():
        lib = ("—" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"  {label:38s} {r['ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, SDPA (Ev "
              f"16, same mask) {lib}, max abs err {r['max_abs_err']:.3e}")
    print(f"\n[maverick] q heads :40 at group 5 over the kv view ::2 of its 16 "
          f"duplicated heads (hd 128), chunk-local (8,192) or the global "
          f"layer's cache, against SDPA with the same mask, graph replay "
          f"({card})")
    for label, r in maverick.items():
        print(f"  {label:40s} {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}, {r['ms'] / r['bound_ms']:.1f}x), plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
              f"({r['ms'] / r['library_ms']:.2f}x SDPA), max abs err "
              f"{r['max_abs_err']:.3e}")
    bad = [f"{label}: {r['wide'][1]} elements" for label, r in cases
           if r["wide"][1]]
    if bad:
        raise AssertionError(f"bf16 kernels past atol {TOL_WIDE[0]} rtol "
                             f"{TOL_WIDE[1]} of the float32 plain version: "
                             f"{bad}")
    for r in (flash, decode, mla, maverick, paged, chunk, ssd, wkv, rms):
        for case in r.values():
            del case["wide"]
    # each kernel at the shapes of the path whose launches are reported:
    # flash, paged decode and the SSD chunk on the zamba2 path (head dim
    # 112), decode and chunked prefill on the llama paths, WKV6 at a
    # prefill of the rwkv path, RMSNorm at the llama contiguous path's
    # decode rows, the residual add before each norm fused in
    return {"flash_attention": flash["flash B8 H32/32 S512 hd112 bf16"],
            "decode_attention": decode["decode B8 H32/32 W2048 bf16"],
            "paged_decode_attention":
                paged["paged B8 H32/32 ps16 M128 hd112 bf16"],
            "chunked_prefill_attention":
                chunk["chunk B1 H32/32 S256 hist768 bf16"],
            "ssd_chunk": ssd["ssd B2 H112 T1024 cl256 P64 N64 f32"],
            "wkv6": wkv["wkv6 B1 H32 T1024 hd64 bf16"],
            "rmsnorm": rms["add R8 d2048 bf16"]}


# --------------------------------------------------------------------------
# phase 4: the engine
# --------------------------------------------------------------------------


def maverick_map_config(cf):
    """Maverick smoke with Maverick's head map at small size: 10 q / 2 kv
    heads padded to 12 / 4 (map [0 1 0 1 0 3 2 3 2 3 0 0]), head dim 32,
    (dense, moe) x 2, chunk 8 with a global layer every 2nd, capacity
    factor ``cf`` (tests/test_torch_moe.py's ``small_configs``)."""
    from repro_torch.configs import get_config
    cfg = get_config(MAVERICK, "smoke")
    return dataclasses.replace(
        cfg, name=f"maverick-map-cf{cf}", n_heads=10, n_kv_heads=2,
        pad_heads_to_multiple=4, head_dim=32, attn_chunk=8,
        global_attn_every=2,
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def smoke_agreement():
    """Small float32 configs served on the card (kernels) and on the CPU
    (plain versions) from the same weights: llama3.2-1b on the contiguous
    path and on the paged + chunked + prefix-sharing rung, zamba2-7b on
    the contiguous and paged paths, rwkv6-1.6b on the contiguous path,
    Llama-4 Maverick's smoke and ``maverick_map_config`` at capacity
    factors 2.0 and 0.5 on the contiguous path (prompts wrapping the
    8-slot rings). Identical tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    rng = np.random.default_rng(5)
    vocab = 512                      # both smoke configs
    system = rng.integers(2, vocab, 32).tolist()
    ragged = [(i, rng.integers(2, vocab, int(n)).tolist())
              for i, n in enumerate([5, 40, 70, 17, 90, 33])]
    runs = {
        ("llama3.2-1b", "contiguous"): (EngineConfig(max_batch=4, max_len=64),
                                        ragged),
        ("llama3.2-1b", "paged+chunk+sharing"): (
            EngineConfig(max_batch=4, max_len=128, paged=True, page_size=16,
                         prefill_chunk=16, prefill_pack=2,
                         prefix_sharing=True),
            [(i, system + rng.integers(2, vocab, int(n)).tolist())
             for i, n in enumerate([3, 20, 0, 9, 41, 0, 16])]),
        ("zamba2-7b", "contiguous"): (EngineConfig(max_batch=4, max_len=128),
                                      ragged),
        ("zamba2-7b", "paged"): (EngineConfig(max_batch=4, max_len=128,
                                              paged=True), ragged),
        ("rwkv6-1.6b", "contiguous"): (EngineConfig(max_batch=4, max_len=128),
                                       ragged),
    }
    # Llama-4 Maverick's smoke and its head map at small size (10 / 2 heads
    # padded to 12 / 4: group 5 over the kv view ::2 on the card), the
    # second at capacity factor 0.5, where every prefill drops real tokens
    # beside pad tokens, so the card's pad rows must route as the CPU's
    mav = [(i, rng.integers(2, vocab, int(n)).tolist())
           for i, n in enumerate([5, 19, 30, 9, 3, 14, 27])]
    runs[(MAVERICK, "contiguous")] = (EngineConfig(max_batch=4, max_len=64),
                                      mav)
    runs[(MAVERICK, "head map, contiguous")] = (EngineConfig(
        max_batch=4, max_len=64), mav)
    runs[(MAVERICK, "head map cf 0.5, contiguous")] = (EngineConfig(
        max_batch=4, max_len=64), mav)
    for (arch, name), (ecfg, reqs) in runs.items():
        cfg = get_config(arch, "smoke")
        if "head map" in name:
            cfg = maverick_map_config(0.5 if "0.5" in name else 2.0)
        cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
        toks = {}
        for dev in ("cpu", "cuda"):
            params = _to(cpu_params, dev)
            eng = ServingEngine(Model(cfg, dev), params, ecfg, device=dev)
            for rid, prompt in reqs:
                eng.submit(Request(rid=rid, prompt=prompt,
                                   max_new_tokens=12))
            toks[dev] = {r.rid: r.tokens for r in eng.run()}
        if toks["cpu"] != toks["cuda"]:
            raise AssertionError(f"smoke {arch} {name} tokens differ: cpu "
                                 f"{toks['cpu']} cuda {toks['cuda']}")
        keys = assert_graphed(f"smoke {arch} {name}", eng)
        print(f"[smoke] {cfg.name} f32, {name}: cuda tokens == cpu tokens; "
              f"{eng.graphs.replays} graph replays of {len(keys)} captures")
    smoke_frontdoor()
    smoke_fleet()
    smoke_fleet_admin()


# the front door's traffic: wave A (class 0) arrives at once, wave B (class
# 1) right after quantum FRONTDOOR_Q of the server's drive loop. In wave A,
# tenant "acme" sends three requests over a (2, 0) quota (the third is
# rate limited), one request carries deadline_s = 0.0 (cancelled at the
# first sweep), and the bounded queue sheds what arrives with it full
# (reject_lowest: a class-1 arrival displaces the newest class-0 request).
# A fault fires once at each launch site: page_alloc at quantum 1 (wave A's
# first admission), prefill_chunk and decode_scan at the quanta below.
FRONTDOOR_QUOTA = {"acme": (2, 0.0)}
FRONTDOOR_FAULTS = {"smoke": (("page_alloc", 1), ("prefill_chunk", 4),
                              ("decode_scan", 11)),
                    "full": (("page_alloc", 1), ("prefill_chunk", 4),
                             ("decode_scan", 12))}
FRONTDOOR_Q = {"smoke": 8, "full": 10}


def frontdoor_waves(prompts, new_tokens, n_first, acme, deadline):
    """Request kwargs of the two waves: rids 0.. in prompt order, the first
    ``n_first`` class 0 (tenant "acme" on the rids in ``acme``, deadline
    0.0 on rid ``deadline``), the rest class 1."""
    reqs = [dict(rid=rid, prompt=list(p), max_new_tokens=new_tokens,
                 priority=0 if rid < n_first else 1,
                 tenant="acme" if rid in acme else None,
                 deadline_s=0.0 if rid == deadline else None)
            for rid, p in enumerate(prompts)]
    return reqs[:n_first], reqs[n_first:]


def serve_frontdoor(engine, first, late, q_late, plans):
    """Drive ``engine`` through ``AsyncServingServer``: wave ``first`` at
    once, wave ``late`` right after quantum ``q_late`` (the step signals
    the event loop as it starts that quantum, so the submissions queue on
    the server's lock and land between it and the next, on any device),
    ``plans`` = (site, quantum) faults firing once each. Returns
    {rid: Response}; a FaultError escapes."""
    from repro_torch.serving import (AsyncServingServer, FaultInjector,
                                     FaultPlan, Request)
    engine.faults = FaultInjector([FaultPlan(site, q, absolute=True)
                                   for site, q in plans])

    async def go():
        loop = asyncio.get_running_loop()
        at = asyncio.Event()
        step = engine.step

        def hooked(*a, **k):
            if engine._quantum + 1 == q_late:
                loop.call_soon_threadsafe(at.set)
            return step(*a, **k)

        engine.step = hooked
        srv = AsyncServingServer(engine)
        for r in first:
            await srv.submit(Request(**r))
        await asyncio.wait_for(at.wait(), 900)
        for r in late:
            await srv.submit(Request(**r))
        await srv.drain()
        return {rid: await srv.result(rid) for rid in engine.responses}

    try:
        return asyncio.run(go())
    finally:
        del engine.step


FRONT_COUNTERS = ("shed_count", "rate_limited", "deadline_cancelled",
                  "preemption_count", "clamped_requests", "fault_retries",
                  "queue_depth", "timeout_requests")


def front_counters(st):
    return {k: v for k, v in st.items()
            if k in FRONT_COUNTERS or k.startswith(("shed_class_",
                                                    "fault_retries_"))}


def smoke_frontdoor():
    """The front door on llama3.2-1b smoke in float32, served through
    ``AsyncServingServer`` on the card and on the CPU from the same
    weights: paged + chunked prefill + prefix sharing + preemption, two
    classes (wave B preempts), ``max_queue`` 6 with reject_lowest and
    ``pressure_clamp``, a (2, 0) tenant quota, one deadline 0.0 request,
    one fault at each launch site. Tokens, finish reasons and every
    front-door counter agree; the card's preempted requests equal an
    unpreempted card run of their original requests."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("llama3.2-1b", "smoke")
    rng = np.random.default_rng(9)
    system = rng.integers(2, cfg.vocab, 32).tolist()
    prompts = [system + rng.integers(2, cfg.vocab, int(n)).tolist()
               if i % 2 == 0 else rng.integers(2, cfg.vocab, int(n)).tolist()
               for i, n in enumerate([9, 20, 3, 14, 25, 6, 11, 17,
                                      5, 12, 7, 30, 9, 4])]
    first, late = frontdoor_waves(prompts, 20, 8, acme=(2, 3, 4),
                                  deadline=1)
    ecfg = EngineConfig(max_batch=4, max_len=128, paged=True, page_size=16,
                        prefill_chunk=16, prefill_pack=2, prefix_sharing=True,
                        preemption=True, max_queue=6,
                        shed_policy="reject_lowest", pressure_clamp=8,
                        tenant_quota=FRONTDOOR_QUOTA, max_retries=3)
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    got = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(Model(cfg, dev), _to(cpu_params, dev), ecfg,
                            device=dev)
        resp = serve_frontdoor(eng, first, late, FRONTDOOR_Q["smoke"],
                               FRONTDOOR_FAULTS["smoke"])
        got[dev] = ({rid: (r.tokens, r.finish_reason, r.preemptions)
                     for rid, r in resp.items()},
                    front_counters(eng.stats()))
    if got["cpu"] != got["cuda"]:
        raise AssertionError(f"smoke front door differs: cpu {got['cpu']} "
                             f"cuda {got['cuda']}")
    toks, counters = got["cuda"]
    want = dict(shed_count=2, rate_limited=1, deadline_cancelled=1,
                fault_retries=3)
    if ({k: counters[k] for k in want} != want
            or counters["preemption_count"] < 1):
        raise AssertionError(f"smoke front door counters {counters}, "
                             f"planned {want} and a preemption")
    # the preempted requests, served unpreempted on the card
    victims = [r for r in first + late if toks[r["rid"]][2] > 0]
    oracle = ServingEngine(Model(cfg, "cuda"), _to(cpu_params, "cuda"),
                           EngineConfig(max_batch=16, max_len=128,
                                        paged=True, page_size=16,
                                        prefill_chunk=16), device="cuda")
    for r in victims:
        oracle.submit(Request(rid=r["rid"], prompt=r["prompt"],
                              max_new_tokens=r["max_new_tokens"]))
    for r in oracle.run():
        if toks[r.rid][0] != r.tokens[:len(toks[r.rid][0])]:
            raise AssertionError(f"smoke front door: preempted request "
                                 f"{r.rid} differs from its unpreempted run")
    print(f"[smoke] llama3.2-1b smoke f32, front door through "
          f"AsyncServingServer: cuda == cpu on tokens, finish reasons and "
          f"counters {counters}; {len(victims)} preempted requests equal "
          f"their unpreempted card run")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def engine_requests(vocab):
    from repro_torch.serving import Request
    from repro_torch.training.data import alpaca_like_prompts
    prompts = alpaca_like_prompts(seed=0, n=16, vocab=vocab, max_len=1024)
    # prompts of 16-1024 tokens: short ones repeat to 16, and the first is
    # stretched to 1024 so the largest prefill bucket runs too
    prompts = [np.resize(p, max(len(p), 16)) for p in prompts]
    prompts[0] = np.resize(prompts[0], 1024)
    return [Request(rid=i, prompt=p.tolist(), max_new_tokens=64)
            for i, p in enumerate(prompts)]


def paged_requests(vocab, new_tokens=64):
    """16 requests of ``new_tokens`` new tokens: eight open with one
    512-token system
    prompt (distinct 16-512-token suffixes; one IS the system prompt, the
    copy-on-write path), the rest are Alpaca-like prompts of 16-1024
    tokens. The donor follows a short request, so a slot frees while the
    donor still holds its registered pages, and four sharers wait behind
    the first wave to adopt them (each adopter keeps them indexed for the
    next)."""
    from repro_torch.serving import Request
    from repro_torch.training.data import alpaca_like_prompts
    rng = np.random.default_rng(7)
    system = rng.integers(2, vocab, SYSTEM_PROMPT).tolist()
    other = [np.resize(p, max(len(p), 16)).tolist()
             for p in alpaca_like_prompts(seed=1, n=8, vocab=vocab,
                                          max_len=1024)]
    other[0] = other[0][:32]            # the short request ahead of the donor
    shared = [system + rng.integers(2, vocab, int(n)).tolist()
              for n in rng.integers(16, 513, 7)]
    shared.insert(5, list(system))      # whole prompt shared
    order = ([other[0], shared[0], shared[1], other[1], shared[2],
              other[2], shared[3], other[3]]
             + shared[4:] + other[4:])
    return [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(order)]


def serve(card, label, ecfg, reqs, model, params, new_tokens=64,
          power=None, nodes=False):
    """Serve ``reqs`` once (``new_tokens`` each), the launch counts set to
    0 just before and read just after; with ``power`` (an ``nvidia-smi``
    field) the card's draw is sampled around the run and integrated over
    its requests (``measured_power``). Every decode chunk must be a graph
    replay (``graph_report``, with the kernel nodes of a capture where
    ``nodes`` or the path is one of ``EAGER_STEP``'s). Returns (engine,
    stats, counts); the stats carry the graph's figures under
    ``"graph"`` and the measured J under ``"measured_j"``."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, params, ecfg)
    decode = timed_decode(engine)
    sampler = PowerSampler(power) if power else None
    for r in reqs:
        engine.submit(r)
    ops.reset_launches()
    t0 = time.perf_counter()
    responses = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = engine.stats()
    for r in responses:
        if not (r.finished and r.finish_reason == "length"
                and r.n_tokens == new_tokens):
            raise AssertionError(f"{label} request {r.rid}: finished="
                                 f"{r.finished} reason={r.finish_reason} "
                                 f"n={r.n_tokens}")
        if not all(0 <= t < model.cfg.vocab for t in r.tokens):
            raise AssertionError(f"{label} request {r.rid}: token out of "
                                 "vocab")
    gen_tokens = sum(r.n_tokens for r in responses)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    print(f"\n[engine] {label}: {model.cfg.name} full width bf16, "
          f"{model.cfg.n_layers} layers, {len(reqs)} requests, "
          f"{prompt_tokens} prompt tokens, {gen_tokens} generated ({card})")
    print(f"  wall {wall:.3f} s, {gen_tokens / wall:.1f} generated tokens/s "
          f"({card})")
    print(f"  max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    print(f"  prefill batches {engine.prefill_batches}, prefill chunks "
          f"{engine.prefill_chunks}, decode chunks {engine.decode_chunks}, "
          f"micro-steps with work {st['steps']}, host syncs "
          f"{engine.host_syncs}")
    print(f"  launches: {counts}")
    print(f"  modeled (h100_sxm profile, QC): prefill "
          f"{st['prefill_j_per_token']:.4e} J/token "
          f"{st['prefill_g_per_token']:.4e} g/token; decode "
          f"{st['decode_j_per_token']:.4e} J/token "
          f"{st['decode_g_per_token']:.4e} g/token ({card})")
    st["graph"] = graph_report(card, label, engine, wall, decode,
                               nodes=nodes or label in EAGER_STEP)
    if sampler is not None:
        st["measured_j"] = measured_power(card, label, sampler, reqs,
                                          responses, gen_tokens,
                                          modeled_j=st["total_energy_j"])
    return engine, st, counts


def dense_norms(cfg):
    """RMSNorm launches per forward of a dense model, from its config: ln1
    and ln2 of every block, the q and k norms of a ``parallel`` block's
    qk-norm, and the final norm."""
    return 1 + sum(4 if kind == "parallel" else 2
                   for kind in cfg.block_pattern)


def contiguous_checks(label, cfg, engine, st, counts):
    """The contiguous path's launch counts: flash in every layer of every
    prefill launch, decode in every layer of every micro-step (and only
    whole forwards), one RMSNorm per norm (``dense_norms`` a forward), no
    paged kernel."""
    L, norms = cfg.n_layers, dense_norms(cfg)
    pb = engine.prefill_batches
    checks = [
        (counts["flash_attention"] >= L * pb,
         f"flash launches {counts['flash_attention']} < {L} x {pb} "
         "batches"),
        (counts["decode_attention"] >= L * st["steps"]
         and counts["decode_attention"] % L == 0,
         f"decode launches {counts['decode_attention']} vs {L} x "
         f"{st['steps']} micro-steps"),
        (counts["rmsnorm"] == norms * (
            pb + counts["decode_attention"] // L),
         f"rmsnorm launches {counts['rmsnorm']} != {norms} x "
         f"({pb} + {counts['decode_attention'] // L}) forwards"),
        (counts["paged_decode_attention"] == 0
         and counts["chunked_prefill_attention"] == 0,
         f"paged kernels ran on the contiguous path: {counts}"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"{label}: {what}")


def paged_checks(label, cfg, engine, st, counts):
    """The paged main path's launch counts (chunk and paged decode in every
    layer of every chunk launch and micro-step, no contiguous kernel, one
    RMSNorm per norm: ``dense_norms`` a forward), prefix hits and the
    whole free stack."""
    L, norms = cfg.n_layers, dense_norms(cfg)
    print(f"  pages: total {st['pages_total']}, peak reserved "
          f"{st['peak_pages_reserved']} ({st['peak_kv_rows_reserved']} KV "
          f"rows), free at the end {st['free_pages']}; prefix hit tokens "
          f"{st['prefix_hit_tokens']} over {st['prefix_shared_requests']} "
          f"requests")
    checks = [
        (st["prefix_hit_tokens"] > 0, "no prefix hit"),
        (st["free_pages"] == st["pages_total"], "pages not returned"),
        (counts["paged_decode_attention"] == L * st["steps"],
         f"paged decode launches {counts['paged_decode_attention']} != "
         f"{L} x {st['steps']} micro-steps"),
        (counts["chunked_prefill_attention"] == L * st["prefill_chunks"],
         f"chunked prefill launches {counts['chunked_prefill_attention']} "
         f"!= {L} x {st['prefill_chunks']} chunks"),
        (counts["decode_attention"] == 0 and counts["flash_attention"] == 0,
         f"contiguous kernels ran on the paged path: {counts}"),
        (counts["rmsnorm"] == norms * (st["prefill_chunks"] + st["steps"]),
         f"rmsnorm launches {counts['rmsnorm']} != {norms} x "
         f"({st['prefill_chunks']} chunks + {st['steps']} micro-steps)"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"{label}: {what}")
    alloc = engine.caches["paged"]
    if int(alloc["top"]) != engine.num_pages or (alloc["ref"] != 0).any():
        raise AssertionError(f"{label}: device free stack not whole")


# the eager fused step on the four paths whose graphed figures
# ``graph_report`` prints beside them: kernel launches a micro-step and
# warm wall a micro-step in ms (prefill included) and the device's idle
# share, from ``chip_profile.py`` (PR 18's profile, NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md)
EAGER_STEP = {
    "contiguous": (1349.4, 32.63, 0.929),
    "paged + chunked prefill + prefix sharing": (1886.5, 33.62, 0.927),
    "zamba2 paged": (3353.8, 91.17, 0.893),
    "rwkv6 contiguous": (2620.5, 37.35, 0.907),
}
CU_GRAPH_NODE_TYPE_KERNEL = 0


def graph_kernel_nodes(engine, n: int) -> tuple:
    """(kernel nodes, all nodes, the port's kernel launches) a micro-step
    of one capture of ``engine``'s greedy fused step of ``n`` micro-steps,
    the nodes counted by the driver (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``). The capture reads the engine's tensors and is
    never replayed, so nothing of the engine changes."""
    import ctypes
    from repro_torch.kernels import ops
    from repro_torch.serving import sampling
    caches = dict(engine.caches)
    if "paged" in caches:
        caches["paged"] = dict(caches["paged"])
    cfg = engine.cfg
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream = _side_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with ops.recorded_launches() as ours, torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        sampling.fused_decode_steps(
            engine.model, engine.params, caches, engine.cur_tokens,
            engine.state, None, n, 0.0, cfg.page_size if cfg.paged else 0,
            cfg.prefill_chunk is not None)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    cuda = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise AssertionError(f"{what} returned CUresult {rc}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)),
          "cuGraphGetNodes")
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in nodes:
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)),
              "cuGraphNodeGetType")
        kernels += kind.value == CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels / n, count.value / n, sum(ours.values()) / n


def timed_decode(engine):
    """Wrap ``engine.graphs.step`` so each chunk's replay is timed to its
    end, from a device drained of the prefill work queued before it (the
    engine fetches the chunk's tokens right after, which waits for both
    anyway); returns [seconds and micro-steps of the chunks that were
    replays alone (a chunk whose key was captured first is left out),
    micro-steps of every chunk]."""
    step = engine.graphs.step
    total = [0.0, 0, 0]

    def timed(caches, n_steps, *args, **kw):
        captured = engine.graphs.captured
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(caches, n_steps, *args, **kw)
        torch.cuda.synchronize()
        if engine.graphs.captured == captured:
            total[0] += time.perf_counter() - t0
            total[1] += n_steps
        total[2] += n_steps
        return out

    engine.graphs.step = timed
    return total


def assert_graphed(label, engine) -> list:
    """Fails unless every decode chunk of the card engine's run was a
    replay of a captured graph (one capture a static key, by
    ``DecodeGraphs``' construction); returns the keys, sorted."""
    g = engine.graphs
    if not g.replays == engine.decode_chunks > 0:
        raise AssertionError(
            f"{label}: {g.replays} graph replays for {engine.decode_chunks} "
            f"decode chunks")
    return sorted(g.launches)


def graph_report(card, label, engine, wall=None, decode=None,
                 nodes=False) -> dict:
    """Fails unless every decode chunk of ``engine``'s run was a replay of
    a captured graph, with one capture a static key. Prints the graphs
    captured and replayed, the capture's seconds, the host's us a replay
    (each graph's first, which uploads it, apart),
    the port's kernel launches a micro-step counted at capture, and where
    given the warm wall a micro-step (``wall`` over the micro-steps,
    prefill included) and the decode wall a micro-step (``decode``, from
    ``timed_decode``); with ``nodes``, the kernel nodes a micro-step of
    one more capture (``graph_kernel_nodes``); the eager step's figures
    beside, where ``EAGER_STEP`` has the path. Returns the figures."""
    g = engine.graphs
    steps = engine.stats()["steps"]
    keys = assert_graphed(label, engine)
    n = keys[-1][0]
    later = g.replays - g.captured
    fig = {"captured": g.captured, "replays": g.replays,
           "capture_s": g.capture_s, "upload_s": g.upload_s,
           "replay_host_us": g.replay_host_s / later * 1e6 if later else 0.0,
           "ours": sum(g.launches[keys[-1]].values()) / n}
    print(f"  graphs ({card}): {g.captured} captured (chunk lengths "
          f"{[k[0] for k in keys]}) in {g.capture_s:.3f} s, {g.replays} "
          f"replays = decode chunks; host {fig['replay_host_us']:.1f} us a "
          f"replay ({later} replays; each graph's first, which uploads it, "
          f"{g.upload_s / g.captured * 1e3:.2f} ms); the port's kernels "
          f"{fig['ours']:.1f} a micro-step counted at capture")
    if wall is not None:
        fig["wall_ms"] = wall / steps * 1e3
        print(f"  warm wall a micro-step (prefill included) "
              f"{fig['wall_ms']:.2f} ms over {steps} micro-steps ({card})")
    if decode is not None and decode[1]:
        fig["micro_steps"] = decode[2]
        fig["decode_ms"] = decode[0] / decode[1] * 1e3
        print(f"  decode wall a micro-step (a chunk's replay to its end, "
              f"the chunks that captured left out) {fig['decode_ms']:.3f} "
              f"ms over {decode[1]} of {decode[2]} micro-steps ({card})")
    if nodes:
        kern, every, ours = graph_kernel_nodes(engine, n)
        fig["kernel_nodes"] = kern
        print(f"  one capture of {n} micro-steps: {kern:.1f} kernel nodes a "
              f"micro-step ({every:.1f} nodes in all; the port's kernels "
              f"{ours:.1f}) ({card})")
    if label in EAGER_STEP:
        launches, wall_ms, idle = EAGER_STEP[label]
        print(f"  the eager step here (PR 18's chip_profile.py, NVIDIA H100 "
              f"80GB HBM3, 700.00 W): {launches} kernel launches and "
              f"{wall_ms} ms warm wall a micro-step (prefill included), "
              f"idle {idle:.1%}")
    return fig


def _sorted_leaves(tree, name=None):
    """A tree's tensors in a fixed order; a page pool without its trash
    page (the last), which several writes of one call may hit (its winner
    is undefined on CUDA) and no read sees unmasked."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _sorted_leaves(v)
    elif name in ("k_pages", "v_pages"):
        yield tree[:, :-1]
    else:
        yield tree


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def graph_agreement(card, label, model, params, ecfg, reqs):
    """One engine serving ``reqs`` under CUDA's sync debug mode, stopped
    after its second decode chunk (slots mid-decode): from that state, on
    clones, one chunk of ``sync_every`` greedy micro-steps through a
    captured graph (``DecodeGraphs``) and through an eager call of
    ``sampling.fused_decode_steps``. tok_mat, emit_mat, ``cur_tokens``,
    the slot state, every cache leaf (a pool's pages but its trash page:
    ``_sorted_leaves``) and the allocator (``tbl``, ``free``, ``top``,
    ``ref``) must be equal bit for bit; a second chunk of each is timed
    beside the first (eager against a warm replay). Then the engine runs
    to its end, and the host's waits over both parts must equal
    ``host_syncs``."""
    from repro_torch.serving import ServingEngine, graphs, sampling
    engine = ServingEngine(model, params, ecfg)
    for r in reqs:
        engine.submit(r)

    def until():
        while engine.decode_chunks < 2:
            engine.step()

    _, waits = count_waits(until)
    if not engine.decoding:
        raise AssertionError(f"{label}: no slot decoding after two chunks")
    page_size = ecfg.page_size if ecfg.paged else 0
    freeze = ecfg.prefill_chunk is not None
    n = ecfg.sync_every
    runs, ms = [], []

    def timed(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    for graphed in (False, True):
        caches = _clone_tree(engine.caches)
        cur, state = engine.cur_tokens.clone(), _clone_tree(engine.state)
        if graphed:
            step = graphs.DecodeGraphs(model, params, cur, state, None)

            def call():
                return step.step(caches, n_steps=n, temperature=0.0,
                                 page_size=page_size, freeze_inactive=freeze)
        else:
            def call():
                return sampling.fused_decode_steps(
                    model, params, caches, cur, state, None, n, 0.0,
                    page_size, freeze)
        out = timed(call)
        runs.append([t.clone() for t in list(out) + [cur]
                     + list(_sorted_leaves(state))
                     + list(_sorted_leaves(caches))])
        timed(call)                # a second chunk, timed, not compared
        if graphed and (step.captured, step.replays) != (1, 2):
            raise AssertionError(f"{label}: {step.captured} captures, "
                                 f"{step.replays} replays")
        del caches, cur, state, out, call
    step = None
    torch.cuda.synchronize()
    emitted = int(runs[0][1].sum())
    differ = [i for i, (a, b) in enumerate(zip(*runs))
              if not torch.equal(a, b)]
    if len(runs[0]) != len(runs[1]) or differ or not emitted:
        raise AssertionError(f"{label}: graph and eager differ at tensors "
                             f"{differ} of {len(runs[0])}, {emitted} "
                             "emissions")
    print(f"  graph = eager ({card}): one chunk of {n} micro-steps from a "
          f"mid-decode state, {emitted} emissions; tok_mat, emit_mat and "
          f"{len(runs[0]) - 2} state, cache and allocator tensors equal "
          "bit for bit")
    print(f"  that chunk and the next, from a drained device to the chunk's "
          f"end ({card}): eager {ms[0]:.2f} / {ms[1]:.2f} ms, graphed "
          f"{ms[2]:.2f} (capture and first replay) / {ms[3]:.2f} ms (a "
          f"replay): {ms[1] / n:.3f} against {ms[3] / n:.3f} ms a micro-step")
    del runs
    _, more = count_waits(engine.run)
    if waits + more != engine.host_syncs:
        raise AssertionError(f"{label}: the host waited {waits + more} "
                             f"times, host_syncs {engine.host_syncs}")
    print(f"  the same engine to its end: host waits for the device (sync "
          f"debug mode) {waits + more} = host_syncs {engine.host_syncs}; "
          f"{engine.graphs.captured} graphs, {engine.graphs.replays} "
          "replays")
    graph_report(card, label, engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def phase_engine(card):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("llama-paper-1b")
    assert cfg.n_layers == N_LAYERS and cfg.dtype == "bfloat16"
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    base = dict(max_batch=8, max_len=2048, profile="h100_sxm", region="QC")
    contiguous = EngineConfig(**base)
    paged = EngineConfig(**base, paged=True, page_size=16, prefill_chunk=256,
                         prefill_pack=2, prefix_sharing=True)
    # warm-up engines (library handles, allocator) — not counted
    for ecfg in (contiguous, paged):
        warm = ServingEngine(model, params, ecfg)
        warm.submit(Request(rid=0, prompt=list(range(2, 40)),
                            max_new_tokens=4))
        warm.run()
        del warm

    engine, st, counts = serve(card, "contiguous", contiguous,
                               engine_requests(cfg.vocab), model, params)
    contiguous_checks("contiguous run", cfg, engine, st, counts)
    del engine
    graph_agreement(card, "contiguous graph against eager", model, params,
                    contiguous, engine_requests(cfg.vocab))

    engine, st, pcounts = serve(card, "paged + chunked prefill + prefix "
                                "sharing", paged, paged_requests(cfg.vocab),
                                model, params, power=power_field())
    paged_checks("paged run", cfg, engine, st, pcounts)
    del engine
    phase_frontdoor(card, model, params)
    phase_fleet(card, model, params)
    phase_fleet_admin(card, model, params)
    return {"flash_attention": counts["flash_attention"],
            "decode_attention": counts["decode_attention"],
            "paged_decode_attention": pcounts["paged_decode_attention"],
            "chunked_prefill_attention":
                pcounts["chunked_prefill_attention"],
            "rmsnorm": counts["rmsnorm"]}


LLAMA32 = "llama3.2-1b"
LLAMA32_PARAMS = 1_269_368_832       # the reference's param_counts, full


def phase_llama32(card):
    """``llama3.2-1b`` at full width and depth (16 layers, d_model 2,048,
    32 q heads over 8 kv heads padded to 16, head dim 64, vocab 128,256,
    tied embeddings), bf16, random weights from a seed, through the
    graphed paged main path (page 16, chunked prefill 256 packed 2,
    prefix sharing) at ``max_batch=8, max_len=2048`` with the paged run's
    16 requests of 64 new tokens: launch counts, prefix hits and the free
    stack as the ``llama-paper-1b`` paged run's, tokens/s, the graph's
    figures with a capture's kernel nodes, and the card's draw integrated
    over the requests (J a generated token); then ``graph_agreement``
    from a mid-decode state."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config(LLAMA32)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads_padded,
            cfg.dtype) == (16, 2048, 32, 16, "bfloat16")
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    n_params = sum(t.numel() for t in
                   {id(t): t for t in _leaves(params)}.values())
    if n_params != LLAMA32_PARAMS:
        raise AssertionError(f"{LLAMA32}: {n_params} parameters, the "
                             f"reference counts {LLAMA32_PARAMS}")
    print(f"\n[llama3.2-1b] {cfg.name}: {cfg.n_layers} layers, {n_params} "
          f"parameters at full width ({card})")
    ecfg = EngineConfig(max_batch=8, max_len=2048, paged=True, page_size=16,
                        prefill_chunk=256, prefill_pack=2,
                        prefix_sharing=True, profile="h100_sxm", region="QC")
    warm = ServingEngine(model, params, ecfg)   # not counted
    warm.submit(Request(rid=0, prompt=list(range(2, 40)), max_new_tokens=4))
    warm.run()
    del warm
    label = "llama3.2-1b paged + chunked prefill + prefix sharing"
    engine, st, counts = serve(card, label, ecfg, paged_requests(cfg.vocab),
                               model, params, power=power_field(), nodes=True)
    paged_checks(label, cfg, engine, st, counts)
    del engine
    graph_agreement(card, "llama3.2-1b graph against eager", model, params,
                    ecfg, paged_requests(cfg.vocab))
    model = params = None
    gc.collect()
    torch.cuda.empty_cache()
    return st


def phase_frontdoor(card, model, params):
    """The front door on the paged main path of ``llama-paper-1b`` at full
    width and depth in bf16, driven through ``AsyncServingServer``: the 16
    requests of ``paged_requests`` (64 new tokens each) in two waves, wave
    A rids 0-11 (class 0; tenant "acme" on rids 2, 4, 6 over a (2, 0)
    quota, deadline 0.0 on rid 1, ``max_queue`` 10 with reject_lowest, so
    rid 11 is shed) and wave B rids 12-15 (class 1, preempting), one fault
    at each launch site. Asserts the planned counters, a preemption, every
    response terminal, the whole pool back with no pin, and the kernels'
    launches; reports how many requests' tokens equal a plain paged run of
    the same requests (bf16 rounding may differ with batch composition)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = model.cfg
    L, norms = cfg.n_layers, dense_norms(cfg)
    reqs = paged_requests(cfg.vocab)
    first, late = frontdoor_waves([r.prompt for r in reqs], 64, 12,
                                  acme=(2, 4, 6), deadline=1)
    base = dict(max_batch=8, max_len=2048, profile="h100_sxm", region="QC",
                paged=True, page_size=16, prefill_chunk=256, prefill_pack=2,
                prefix_sharing=True)
    ecfg = EngineConfig(**base, preemption=True, max_queue=10,
                        shed_policy="reject_lowest", pressure_clamp=16,
                        tenant_quota=FRONTDOOR_QUOTA, max_retries=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, params, ecfg)
    recompute = [0]
    meter = engine._meter_prefill

    def counted(batch, seq, useful_seq=None, skip=0, phase="prefill"):
        if phase == "recompute":       # prompt tokens a resume recomputes
            recompute[0] += batch * seq - skip
        return meter(batch, seq, useful_seq=useful_seq, skip=skip,
                     phase=phase)

    engine._meter_prefill = counted
    ops.reset_launches()
    t0 = time.perf_counter()
    resp = serve_frontdoor(engine, first, late, FRONTDOOR_Q["full"],
                           FRONTDOOR_FAULTS["full"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = engine.stats()
    gen_tokens = sum(r.n_tokens for r in resp.values())
    print(f"\n[frontdoor] llama-paper-1b full width bf16, {L} layers, paged "
          f"main path + preemption, served through AsyncServingServer: "
          f"{len(reqs)} requests in two waves (12 class 0, 4 class 1), "
          f"{gen_tokens} generated ({card})")
    print(f"  wall {wall:.3f} s, {gen_tokens / wall:.1f} generated tokens/s "
          f"({card})")
    print(f"  preemptions {st['preemption_count']}, recompute tokens "
          f"{recompute[0]} (modeled recompute {st['preempted_recompute_j']:.4e}"
          f" J), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    print(f"  front door: {front_counters(st)}; faults fired "
          f"{engine.faults.fired}")
    print(f"  prefill chunks {st['prefill_chunks']}, decode chunks "
          f"{st['decode_chunks']}, micro-steps with work {st['steps']}, "
          f"host syncs {st['host_syncs']}; launches: {counts}")
    graph_report(card, "frontdoor", engine, wall)
    planned = dict(shed_count=1, rate_limited=1, deadline_cancelled=1,
                   fault_retries=3)
    reasons = {rid: r.finish_reason for rid, r in resp.items()}
    alloc = engine.caches["paged"]
    checks = [
        ({k: st[k] for k in planned} == planned,
         f"counters {front_counters(st)}, planned {planned}"),
        (st["preemption_count"] >= 1, "no preemption"),
        (sorted({s for s, _ in engine.faults.fired})
         == ["decode_scan", "page_alloc", "prefill_chunk"],
         f"faults fired {engine.faults.fired}"),
        (all(r.finished for r in resp.values())
         and {reasons[1], reasons[6], reasons[11]}
         == {"deadline", "rate_limited", "shed"}
         and all(reasons[rid] == "length" for rid in reasons
                 if rid not in (1, 6, 11)),
         f"finish reasons {reasons}"),
        (all(resp[rid].n_tokens == 64 for rid in reasons
             if reasons[rid] == "length"), "a served request short of 64"),
        (all(0 <= t < cfg.vocab for r in resp.values() for t in r.tokens),
         "token out of vocab"),
        (engine.free_pages == engine.num_pages and not engine._pins
         and not engine._prefix_index, "pages, pins or index left"),
        (int(alloc["top"]) + int((alloc["ref"] > 0).sum())
         == engine.num_pages and bool((alloc["tbl"] == -1).all())
         and bool((alloc["ref"] == 0).all()), "device free stack not whole"),
        (counts["chunked_prefill_attention"] == L * st["prefill_chunks"] > 0,
         f"chunked prefill launches {counts['chunked_prefill_attention']} "
         f"!= {L} x {st['prefill_chunks']} chunks"),
        (counts["paged_decode_attention"] == L * st["steps"] > 0,
         f"paged decode launches {counts['paged_decode_attention']} != "
         f"{L} x {st['steps']} micro-steps"),
        (counts["rmsnorm"] == norms * (st["prefill_chunks"] + st["steps"]),
         f"rmsnorm launches {counts['rmsnorm']} != {norms} x "
         f"({st['prefill_chunks']} + {st['steps']})"),
        (counts["decode_attention"] == counts["flash_attention"] == 0,
         f"contiguous kernels ran on the paged path: {counts}"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"frontdoor run: {what}")
    served = [r for r in first + late if reasons[r["rid"]] == "length"]
    plain = ServingEngine(model, params, EngineConfig(**base))
    for r in served:
        plain.submit(Request(rid=r["rid"], prompt=r["prompt"],
                             max_new_tokens=64))
    same = sum(resp[r.rid].tokens == r.tokens for r in plain.run())
    n_pre = sum(1 for r in resp.values() if r.preemptions)
    print(f"  tokens equal to a plain paged run of the same requests: "
          f"{same} of {len(served)} served ({n_pre} of them preempted; "
          f"reported, not asserted: bf16 rounding may differ with batch "
          f"composition)")
    return counts


# the fleet: S shards of B slots on the one card, carbon routing across the
# paper's three grid regions (QC 31, CISO 262, PACE 647 gCO2/kWh)
FLEET_REGIONS = ("QC", "CISO", "PACE", "CISO")
FLEET_S, FLEET_B, FLEET_PAGES = 4, 8, 1024   # shards, slots, pages a shard
FLEET_NEW = 32                               # new tokens a request
# deferred (class 0) requests: forced out of the deferral queue once
# FLEET_FRAC of their deadline has passed on the wall clock — 0.5 s for
# the short deadline, while the urgent work runs; the long deadline's are
# released when the virtual clock reaches the greenest window
FLEET_FRAC, FLEET_SHORT, FLEET_LONG = 0.01, 50.0, 1e5
# the first wave (class 1 rids 0 and 1, and the deferred class 0) is served
# for FLEET_WAVE quanta, so that rid 0 has registered the system prompt's
# pages, before the other 30 class-1 requests arrive and adopt them
FLEET_WAVE = 4


def smoke_fleet_trace(vocab):
    """The smoke fleet's traffic: ten class-0 requests of 40 new tokens
    (every other one opening with a 32-token system prompt), then four of
    class 1 and 12 new tokens. Returns (class 0, class 1) as Request
    keyword dicts."""
    rng = np.random.default_rng(13)
    system = rng.integers(2, vocab, 32).tolist()
    low = [dict(rid=i, prompt=(system if i % 2 == 0 else [])
                + rng.integers(2, vocab, int(n)).tolist(),
                max_new_tokens=40)
           for i, n in enumerate([9, 20, 3, 14, 25, 6, 11, 17, 5, 12])]
    high = [dict(rid=10 + i, prompt=rng.integers(2, vocab, int(n)).tolist(),
                 max_new_tokens=12, priority=1)
            for i, n in enumerate([7, 30, 9, 4])]
    return low, high


def smoke_fleet():
    """The fleet on llama3.2-1b smoke in float32, on the card and on the
    CPU from the same weights: 4 shards of 2 slots, the paged main path
    with prefix sharing and preemption, carbon routing over
    ``FLEET_REGIONS``. Ten class-0 requests (every other one opening with
    a 32-token system prompt) fill the fleet; four class-1 requests arrive
    after six quanta and preempt. The card and the CPU agree on tokens,
    finish reasons, the shard of every request and every stats() key
    that is not a wall-clock reading; the card fleet's tokens equal the
    single paged engine's on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                     ShardedServingEngine)
    cfg = get_config("llama3.2-1b", "smoke")
    low, high = smoke_fleet_trace(cfg.vocab)
    ecfg = EngineConfig(max_batch=2, max_len=128, paged=True, page_size=16,
                        prefill_chunk=16, prefill_pack=2, prefix_sharing=True,
                        preemption=True, shards=FLEET_S, routing="carbon",
                        shard_regions=FLEET_REGIONS)
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    got = {}
    for dev in ("cpu", "cuda"):
        eng = ShardedServingEngine(Model(cfg, dev), _to(cpu_params, dev),
                                   ecfg, device=dev)
        for r in low:
            eng.submit(Request(**r))
        for _ in range(6):
            eng.step()
        for r in high:
            eng.submit(Request(**r))
        eng.run()
        eng.audit()
        got[dev] = ({rid: (r.tokens, r.finish_reason)
                     for rid, r in eng.responses.items()},
                    dict(eng._req_shard),
                    {k: v for k, v in eng.stats().items()
                     if not k.startswith("queue_wait_")})
    if got["cpu"] != got["cuda"]:
        raise AssertionError(f"smoke fleet differs: cpu {got['cpu']} cuda "
                             f"{got['cuda']}")
    toks, shards, st = got["cuda"]
    if st["preemption_count"] < 1 or len(set(shards.values())) < 3:
        raise AssertionError(f"smoke fleet: preemptions "
                             f"{st['preemption_count']}, shards {shards}")
    single = ServingEngine(Model(cfg, "cuda"), _to(cpu_params, "cuda"),
                           EngineConfig(max_batch=16, max_len=128,
                                        paged=True, page_size=16,
                                        prefill_chunk=16), device="cuda")
    for r in low + high:
        single.submit(Request(**r))
    for r in single.run():
        if toks[r.rid][0] != r.tokens:
            raise AssertionError(f"smoke fleet: request {r.rid} differs "
                                 "from the single paged engine")
    print(f"[smoke] llama3.2-1b smoke f32, fleet of {FLEET_S} shards x 2 "
          f"over {FLEET_REGIONS}, carbon routing, sharing + preemption: "
          f"cuda == cpu on tokens, finish reasons, shards {shards} and "
          f"stats ({st['preemption_count']} preemptions); cuda tokens == "
          f"the single paged engine's")


def fleet_requests(vocab):
    """48 requests of ``FLEET_NEW`` new tokens: 32 of class 1, 16 of them
    opening with one 512-token system prompt (16-256-token suffixes), 16
    Alpaca-like prompts of 16-1024 tokens; then 16 of class 0, deferred:
    8 with ``FLEET_SHORT`` deadlines (forced out of the deferral queue),
    then 8 with ``FLEET_LONG`` ones (released at the greenest window)."""
    from repro_torch.serving import Request
    from repro_torch.training.data import alpaca_like_prompts
    rng = np.random.default_rng(11)
    system = rng.integers(2, vocab, SYSTEM_PROMPT).tolist()
    shared = [system + rng.integers(2, vocab, int(n)).tolist()
              for n in rng.integers(16, 257, 16)]
    other = [np.resize(p, max(len(p), 16)).tolist()
             for p in alpaca_like_prompts(seed=2, n=32, vocab=vocab,
                                          max_len=1024)]
    urgent = [p for pair in zip(shared, other[:16]) for p in pair]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=FLEET_NEW, priority=1)
            for i, p in enumerate(urgent)]
    reqs += [Request(rid=32 + i, prompt=p, max_new_tokens=FLEET_NEW,
                     priority=0,
                     deadline_s=FLEET_SHORT if i < 8 else FLEET_LONG)
             for i, p in enumerate(other[16:])]
    return reqs


def drive_fleet(engine, reqs):
    """Serve ``fleet_requests`` on ``engine`` in its two waves (rids 0 and
    1 and the deferred class first, the rest after ``FLEET_WAVE``
    quanta); returns the responses."""
    first = [r for r in reqs if r.rid < 2 or r.priority == 0]
    for r in first:
        engine.submit(r)
    for _ in range(FLEET_WAVE):
        engine.step()
    for r in reqs:
        if r.rid >= 2 and r.priority > 0:
            engine.submit(r)
    return engine.run()


def fleet_config():
    from repro_torch.serving import EngineConfig
    return EngineConfig(max_batch=FLEET_B, max_len=2048, paged=True,
                        page_size=16, num_pages=FLEET_PAGES,
                        prefill_chunk=256, prefill_pack=2,
                        prefix_sharing=True, preemption=True,
                        profile="h100_sxm", shards=FLEET_S,
                        shard_regions=FLEET_REGIONS, routing="carbon",
                        use_diurnal_ci=True, defer_below_priority=1,
                        defer_deadline_frac=FLEET_FRAC)


def count_waits(run):
    """(run's result, the host's waits for the device in it): CUDA's sync
    debug mode warns at every synchronizing call."""
    waits = [0]

    def record(message, *_):
        if "called a synchronizing CUDA operation" in str(message):
            waits[0] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, waits[0]


def phase_fleet(card, model, params):
    """The fleet at full width: ``llama-paper-1b`` in bf16 at full depth,
    and Llama-4 Maverick at depth 4 with full attention (each shard routing
    its tokens against its own expert capacity), 4 shards of 8 slots (32
    on the card) and 1,024 pages of 16 tokens each,
    the paged main path with chunked prefill (256, pack 2), prefix
    sharing and preemption, carbon routing over ``FLEET_REGIONS`` at the
    diurnal CI, and deferral of class 0 (``fleet_requests``, in two waves:
    ``FLEET_WAVE``). Asserts every response terminal, prefix hits,
    placements on three shards or more with QC's at least PACE's, 16
    deferred and all released (forced and at the window both), ``audit()``
    and every shard's whole free stack, the paged-decode, chunk and
    RMSNorm launches per micro-step and per chunk equal to one forward's
    (22, 22, 45), one fused decode step (a graph replay) per decode chunk,
    the host's waits for the device (counted under CUDA's sync debug mode)
    one per decode chunk and one per first-token fetch for the whole
    fleet, and per-shard gCO2 summing to the fleet's total."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ShardedServingEngine
    cfg = model.cfg
    L, norms = cfg.n_layers, dense_norms(cfg)
    reqs = fleet_requests(cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ShardedServingEngine(model, params, fleet_config())
    step = engine.graphs.step
    n_fused = [0]

    def counted(*a, **k):
        n_fused[0] += 1
        return step(*a, **k)

    engine.graphs.step = counted
    ops.reset_launches()
    t0 = time.perf_counter()
    # the run's real host syncs, counted
    resp, waits = count_waits(lambda: drive_fleet(engine, reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = engine.stats()
    engine.audit()
    S = engine.S
    gen_tokens = sum(r.n_tokens for r in resp)
    placed = [st[f"shard{s}_requests"] for s in range(S)]
    grams = [st[f"shard{s}_carbon_g"] for s in range(S)]
    print(f"\n[fleet] {cfg.name} full width bf16, {L} layers, {S} "
          f"shards x {engine.B} slots over {FLEET_REGIONS}, carbon routing "
          f"(diurnal CI), paged main path + sharing + preemption + "
          f"deferral: {len(reqs)} requests, {gen_tokens} generated ({card})")
    print(f"  wall {wall:.3f} s, {gen_tokens / wall:.1f} generated tokens/s, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    print(f"  placements per shard {placed}; modeled gCO2 per shard "
          f"{[f'{g:.6e}' for g in grams]}, fleet {st['total_carbon_g']:.6e}"
          f" (h100_sxm profile) ({card})")
    print(f"  deferred {st['deferred_requests']}, released "
          f"{st['deferred_released']} ({st['deferred_forced_releases']} "
          f"forced), virtual clock {engine.clock.hours:.3f} h; preemptions "
          f"{st['preemption_count']}, prefix hit tokens "
          f"{st['prefix_hit_tokens']}")
    print(f"  prefill chunks {st['prefill_chunks']}, decode chunks "
          f"{st['decode_chunks']} ({n_fused[0]} fused steps), micro-steps "
          f"with work {st['steps']}, host syncs {st['host_syncs']} "
          f"({waits} host waits for the device under the sync debug "
          f"mode); launches: {counts}")
    graph_report(card, "fleet", engine, wall)
    qc = sum(placed[s] for s in range(S) if FLEET_REGIONS[s] == "QC")
    pace = sum(placed[s] for s in range(S) if FLEET_REGIONS[s] == "PACE")
    alloc = {k: v.cpu() for k, v in engine.caches["paged"].items()}
    window = st["deferred_released"] - st["deferred_forced_releases"]
    checks = [
        (all(r.finished and r.finish_reason == "length"
             and r.n_tokens == FLEET_NEW for r in resp),
         "a response not finished by length at its full budget"),
        (all(0 <= t < cfg.vocab for r in resp for t in r.tokens),
         "token out of vocab"),
        (st["prefix_hit_tokens"] > 0, "no prefix hit"),
        (sum(1 for n in placed if n) >= 3 and qc >= pace,
         f"placements {placed}: fewer than three shards or QC < PACE"),
        (st["deferred_requests"] == 16 and st["deferred_released"] == 16
         and st["deferred_forced_releases"] > 0 and window > 0,
         f"deferral: {st['deferred_requests']} deferred, "
         f"{st['deferred_released']} released, "
         f"{st['deferred_forced_releases']} forced"),
        (bool((alloc["top"] == engine.num_pages).all())
         and bool((alloc["tbl"] == -1).all())
         and bool((alloc["ref"] == 0).all())
         and engine.free_pages == [engine.num_pages] * S
         and not engine._pins, "a shard's free stack is not whole"),
        (counts["paged_decode_attention"] == L * st["steps"] > 0,
         f"paged decode launches {counts['paged_decode_attention']} != "
         f"{L} x {st['steps']} micro-steps"),
        (counts["chunked_prefill_attention"] == L * st["prefill_chunks"] > 0,
         f"chunked prefill launches {counts['chunked_prefill_attention']} "
         f"!= {L} x {st['prefill_chunks']} chunks"),
        (counts["rmsnorm"] == norms * (st["prefill_chunks"] + st["steps"]),
         f"rmsnorm launches {counts['rmsnorm']} != {norms} x "
         f"({st['prefill_chunks']} + {st['steps']})"),
        (counts["decode_attention"] == counts["flash_attention"] == 0,
         f"contiguous kernels ran on the fleet: {counts}"),
        (n_fused[0] == st["decode_chunks"]
         and waits == st["decode_chunks"] + st["prefill_batches"],
         f"{n_fused[0]} fused steps, {waits} host waits for "
         f"{st['decode_chunks']} decode chunks + {st['prefill_batches']} "
         "first-token fetches"),
        (math.isclose(sum(grams), st["total_carbon_g"], rel_tol=1e-12),
         f"per-shard gCO2 {grams} do not sum to {st['total_carbon_g']}"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"{cfg.name} fleet run: {what}")
    return counts


# the fleet's admin paths: at fixed quanta of a served trace, one shard
# drains, one is power-capped at the midpoint of its profile's idle and TDP
# draw, one is lost (unreachable: its slots fold), then the lost and the
# drained shards rejoin. (quantum, action, shard); a rejoin waits for its
# shard to be dead (a drain ends when its slots have moved)
ADMIN_SMOKE = ((8, "drain", 3), (9, "cap", 2), (10, "fail", 1),
               (14, "rejoin", 1), (15, "rejoin", 3))
ADMIN_FULL = ((6, "drain", 3), (8, "cap", 2), (10, "fail", 1),
              (16, "rejoin", 1), (18, "rejoin", 3))


def midpoint_cap(engine, s) -> float:
    prof = engine.shard_profile[s]
    return prof.idle_w + 0.5 * (prof.tdp_w - prof.idle_w)


def drive_admin(engine, waves, events, on_event=None):
    """Serve ``waves`` ((quantum, requests): submitted once that many
    quanta have run) on ``engine``, applying ``events`` (``ADMIN_SMOKE``
    or ``ADMIN_FULL``) between quanta, ``audit()`` after each, then run
    to the end. ``on_event(action, shard)`` is called just after a
    ``fail`` and just before a ``rejoin``. Returns the responses."""
    pending = sorted(events)
    waves = sorted(waves, key=lambda w: w[0])
    q = 0
    while pending or waves:
        if q > 10_000:
            raise AssertionError(f"admin events never applied: {pending}")
        for wq, reqs in [w for w in waves if w[0] <= q]:
            for r in reqs:
                engine.submit(r)
            waves.remove((wq, reqs))
        for ev in [e for e in pending if e[0] <= q]:
            _, action, s = ev
            if action == "rejoin":
                if not engine.health.is_dead(s):
                    continue           # its drain has not ended yet
                if on_event is not None:
                    on_event(action, s)
                engine.rejoin(s)
            elif action == "drain":
                engine.drain(s)
            elif action == "cap":
                engine.power_cap(s, midpoint_cap(engine, s))
            else:
                engine.fail_shard(s, reachable=False)
                if on_event is not None:
                    on_event(action, s)
            engine.audit()
            pending.remove(ev)
        if not (pending or waves):
            break
        engine.step()
        q += 1
    return engine.run()


def smoke_fleet_admin():
    """``smoke_fleet``'s fleet and trace on the card and on the CPU from
    the same weights, with ``ADMIN_SMOKE``'s drain, power cap, loss and
    rejoins: the card and the CPU agree on tokens, finish reasons, the
    shard of every request and every stats() key that is not a wall-clock
    reading, and the card's tokens equal the fault-free fleet's on the
    card for every request (float32: a folded request's re-prefill
    rounds like the decode that made its rows)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ShardedServingEngine
    cfg = get_config("llama3.2-1b", "smoke")
    low, high = smoke_fleet_trace(cfg.vocab)
    ecfg = EngineConfig(max_batch=2, max_len=128, paged=True, page_size=16,
                        prefill_chunk=16, prefill_pack=2, prefix_sharing=True,
                        preemption=True, shards=FLEET_S, routing="carbon",
                        shard_regions=FLEET_REGIONS)
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    got = {}
    for dev, events in (("cpu", ADMIN_SMOKE), ("cuda", ADMIN_SMOKE),
                        ("clean", ())):
        d = "cpu" if dev == "cpu" else "cuda"
        eng = ShardedServingEngine(Model(cfg, d), _to(cpu_params, d), ecfg,
                                   device=d)
        drive_admin(eng, [(0, [Request(**r) for r in low]),
                          (6, [Request(**r) for r in high])], events)
        eng.audit()
        got[dev] = ({rid: (r.tokens, r.finish_reason)
                     for rid, r in eng.responses.items()},
                    dict(eng._req_shard),
                    {k: v for k, v in eng.stats().items()
                     if not k.startswith("queue_wait_")})
    if got["cpu"] != got["cuda"]:
        raise AssertionError(f"smoke fleet admin differs: cpu {got['cpu']} "
                             f"cuda {got['cuda']}")
    toks, shards, st = got["cuda"]
    want = got["clean"][0]
    bad = [rid for rid in want if toks[rid][0] != want[rid][0]]
    if bad:
        raise AssertionError(f"smoke fleet admin: requests {bad} differ "
                             "from the fault-free fleet on the card")
    if not (st["migrations"] >= 1 and st["shard_down_events"] == 2
            and st["shard_rejoins"] == 2 and st["live_shards"] == FLEET_S):
        raise AssertionError(
            f"smoke fleet admin: migrations {st['migrations']}, shard "
            f"downs {st['shard_down_events']}, rejoins "
            f"{st['shard_rejoins']}, live {st['live_shards']}")
    print(f"[smoke] llama3.2-1b smoke f32, fleet of {FLEET_S} shards x 2, "
          f"drain / cap / loss / rejoins at quanta "
          f"{[e[0] for e in ADMIN_SMOKE]}: cuda == cpu on tokens, finish "
          f"reasons, shards and stats ({st['migrations']} migrations of "
          f"{st['migrated_pages']} pages, {st['shard_evacuated']} evacuated, "
          f"{st['preemption_count']} preemptions, {st['power_cap_events']} "
          f"cap); cuda tokens == the fault-free fleet's")


def shard_checksums(engine, s) -> torch.Tensor:
    """Two int64 checksums (the sum, and the sum weighted by position) of
    every part of shard ``s`` in the device cache: its allocator rows, its
    cursor rows and its pages of every pool, the shared trash page
    excluded. One tensor on the device."""
    B, P = engine.B, engine.num_pages
    c = engine.caches
    parts = [v[s] for v in c["paged"].values()] + [c["t"][s * B:(s + 1) * B]]
    for layer in c["layers"]:
        for name, v in layer.items():
            parts.append(v[:, s * P:(s + 1) * P]
                         if name in ("k_pages", "v_pages")
                         else v[s * B:(s + 1) * B])
    sums = []
    for x in parts:
        bits = x.contiguous().view(
            torch.int16 if x.element_size() == 2 else torch.int32)
        bits = bits.reshape(-1).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        sums += [bits.sum(), (bits * w).sum()]
    return torch.stack(sums)


def phase_fleet_admin(card, model, params):
    """The fleet's admin paths at full width and depth: ``phase_fleet``'s
    fleet (``llama-paper-1b`` bf16, 4 shards x 8 slots x 1,024 pages,
    carbon routing over ``FLEET_REGIONS``, sharing, preemption) without
    deferral, serving the 32 class-1 requests of ``fleet_requests`` in its
    two waves, first fault-free (the oracle), then with ``ADMIN_FULL``'s
    drain of shard 3, power cap of shard 2, unreachable loss of shard 1
    and both rejoins. Asserts ``audit()`` after every event, migrations
    with ``migrate`` J on both endpoints, every migrated request that was
    never folded equal to the oracle token for token (its pages are
    copied bit for bit), the dead shard's part of the device cache
    bit-identical (checksums) from its loss to its rejoin, 22 / 22 / 45
    paged-decode, chunk and RMSNorm launches a micro-step, chunk and
    forward, every shard's whole free stack at the end, and the host's
    waits for the device under CUDA's sync debug mode equal to
    ``host_syncs`` plus the counted table, row, audit and checksum
    fetches. Folded requests re-prefill in bf16, which need not round like
    the decode that made their rows: how many differ from the oracle is
    printed, not asserted. The card's draw is sampled around the admin
    run; the meter prices four modeled devices while one card runs, so
    only the measured J is printed."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ShardedServingEngine
    cfg = model.cfg
    L, norms = cfg.n_layers, dense_norms(cfg)
    ecfg = dataclasses.replace(fleet_config(), defer_below_priority=None)

    def trace():
        reqs = [r for r in fleet_requests(cfg.vocab) if r.priority > 0]
        return reqs, [(0, [r for r in reqs if r.rid < 2]),
                      (FLEET_WAVE, [r for r in reqs if r.rid >= 2])]

    reqs, waves = trace()
    oracle = ShardedServingEngine(model, params, ecfg)
    drive_admin(oracle, waves, ())
    want = {rid: r.tokens for rid, r in oracle.responses.items()}
    del oracle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    reqs, waves = trace()
    engine = ShardedServingEngine(model, params, ecfg)
    migrate = engine._migrate_slot
    moved = []

    def logged(s, b, d, src_row):
        moved.append(engine._slot_req[s][b].rid)
        return migrate(s, b, d, src_row)

    engine._migrate_slot = logged
    evacuate = engine._evacuate_shard
    lost = set()                     # on a shard when it was lost

    def logged_evacuate(s, reachable=True):
        lost.update(r for r in engine.slot_rid[s] if r >= 0)
        return evacuate(s, reachable)

    engine._evacuate_shard = logged_evacuate
    sums = {}
    own = [0]                        # this phase's own fetches (checksums)

    def on_event(action, s):
        own[0] += 1
        sums.setdefault(s, []).append(shard_checksums(engine, s).cpu())

    sampler = PowerSampler(power_field())
    ops.reset_launches()
    t0 = time.perf_counter()
    resp, waits = count_waits(
        lambda: drive_admin(engine, waves, ADMIN_FULL, on_event))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = engine.stats()
    gen_tokens = sum(r.n_tokens for r in resp)
    print(f"\n[fleet admin] llama-paper-1b full width bf16, {L} layers, "
          f"{engine.S} shards x {engine.B} slots, {len(reqs)} requests, "
          f"{gen_tokens} generated; events at quanta "
          f"{[e[:2] for e in ADMIN_FULL]} ({card})")
    measured_power(card, "fleet admin", sampler, reqs, resp, gen_tokens)
    graph_report(card, "fleet admin", engine, wall)
    print(f"  wall {wall:.3f} s, {gen_tokens / wall:.1f} generated tokens/s, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    mig_j = [m.phase("migrate").energy_j for m in engine.meters]
    folded = sorted(lost | {r.rid for r in resp if r.preemptions > 0})
    clean_moved = sorted(set(moved) - set(folded))
    differ = {r.rid: next(i for i, (a, b) in enumerate(zip(r.tokens,
                                                           want[r.rid]))
                          if a != b)
              for r in resp if r.rid in folded and r.tokens != want[r.rid]}
    print(f"  migrations {st['migrations']} ({st['migrated_pages']} pages; "
          f"requests {sorted(set(moved))}), migrate J per shard "
          f"{[f'{j:.4e}' for j in mig_j]}; evacuated "
          f"{st['shard_evacuated']}, shard downs {st['shard_down_events']}, "
          f"rejoins {st['shard_rejoins']}, cap events "
          f"{st['power_cap_events']}, preemptions {st['preemption_count']}, "
          f"placements {[st[f'shard{s}_requests'] for s in range(engine.S)]}")
    others = [r.rid for r in resp if r.rid not in folded
              and r.rid not in moved and r.tokens != want[r.rid]]
    print(f"  migrated, never lost: {clean_moved} (asserted equal to the "
          f"oracle); folded or restarted {folded}: {len(differ)} differ "
          f"from the oracle (request: first differing token {differ}; "
          f"reported, not asserted: bf16 re-prefill); others differing "
          f"{others} (reported)")
    print(f"  prefill chunks {st['prefill_chunks']}, micro-steps "
          f"{st['steps']}, decode chunks {st['decode_chunks']}, host syncs "
          f"{st['host_syncs']} + fetches {engine.fetches} + {own[0]} "
          f"checksum fetches; {waits} host waits under the sync debug "
          f"mode; launches: {counts}")
    alloc = {k: v.cpu() for k, v in engine.caches["paged"].items()}
    dead = sums.get(1, [])
    checks = [
        (all(r.finished and r.finish_reason == "length"
             and r.n_tokens == FLEET_NEW for r in resp),
         "a response not finished by length at its full budget"),
        (st["migrations"] >= 1 and mig_j[3] > 0.0
         and any(j > 0.0 for s, j in enumerate(mig_j) if s != 3),
         f"migrations {st['migrations']}, migrate J {mig_j}"),
        (all(r.tokens == want[r.rid] for r in resp if r.rid in clean_moved),
         f"a migrated request differs from the oracle ({clean_moved})"),
        (len(dead) == 2 and torch.equal(dead[0], dead[1]),
         "shard 1's part of the cache changed between its loss and rejoin"),
        (st["shard_down_events"] == 2 and st["shard_rejoins"] == 2
         and st["live_shards"] == engine.S,
         f"shard downs {st['shard_down_events']}, rejoins "
         f"{st['shard_rejoins']}, live {st['live_shards']}"),
        (counts["paged_decode_attention"] == L * st["steps"] > 0,
         f"paged decode launches {counts['paged_decode_attention']} != "
         f"{L} x {st['steps']}"),
        (counts["chunked_prefill_attention"] == L * st["prefill_chunks"] > 0,
         f"chunk launches {counts['chunked_prefill_attention']} != {L} x "
         f"{st['prefill_chunks']}"),
        (counts["rmsnorm"] == norms * (st["prefill_chunks"] + st["steps"]),
         f"rmsnorm launches {counts['rmsnorm']} != {norms} x "
         f"({st['prefill_chunks']} + {st['steps']})"),
        (bool((alloc["top"] == engine.num_pages).all())
         and bool((alloc["tbl"] == -1).all())
         and bool((alloc["ref"] == 0).all())
         and engine.free_pages == [engine.num_pages] * engine.S,
         "a shard's free stack is not whole"),
        (waits == st["host_syncs"] + sum(engine.fetches.values())
         + own[0], f"{waits} host waits != {st['host_syncs']} syncs + "
         f"{engine.fetches} + {own[0]}"),
    ]
    engine.audit()
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"fleet admin run: {what}")
    return counts


def phase_zamba(card):
    """zamba2-7b at full width and depth (81 layers: 68 mamba2, 13 sites of
    one weight-shared attention block), bf16, random weights from a seed,
    on the paged pool with page 16 and the equal-memory pool; the traffic
    of the contiguous llama run. Prompts prefill monolithically, padded to
    power-of-two buckets (recurrent blocks do not chunk)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("zamba2-7b")
    kinds = cfg.block_pattern
    assert (kinds.count("mamba2"), kinds.count("shared")) == (N_MAMBA,
                                                             N_SHARED)
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    weights = sum(t.numel() * t.element_size()
                  for t in {id(t): t for t in _leaves(params)}.values())
    print(f"\n[zamba2] {cfg.name}: {len(kinds)} layers, parameters "
          f"{weights / 1e9:.3f} GB on the card ({card})")
    ecfg = EngineConfig(max_batch=8, max_len=2048, paged=True, page_size=16,
                        profile="h100_sxm", region="QC")
    warm = ServingEngine(model, params, ecfg)   # not counted
    warm.submit(Request(rid=0, prompt=list(range(2, 40)), max_new_tokens=4))
    warm.run()
    del warm
    engine, st, counts = serve(card, "zamba2 paged", ecfg,
                               engine_requests(cfg.vocab), model, params)
    print(f"  pages: total {st['pages_total']}, peak reserved "
          f"{st['peak_pages_reserved']} ({st['peak_kv_rows_reserved']} KV "
          f"rows), free at the end {st['free_pages']}")
    pb, steps = engine.prefill_batches, st["steps"]
    checks = [
        (counts["ssd_chunk"] == N_MAMBA * pb,
         f"ssd_chunk launches {counts['ssd_chunk']} != {N_MAMBA} x {pb} "
         "prefill launches"),
        (counts["flash_attention"] == N_SHARED * pb,
         f"flash launches {counts['flash_attention']} != {N_SHARED} x {pb} "
         "prefill launches"),
        (counts["paged_decode_attention"] == N_SHARED * steps,
         f"paged decode launches {counts['paged_decode_attention']} != "
         f"{N_SHARED} x {steps} micro-steps"),
        (counts["chunked_prefill_attention"] == 0
         and counts["decode_attention"] == 0,
         f"chunked-prefill or contiguous decode kernels ran: {counts}"),
        (counts["rmsnorm"] == NORMS_ZAMBA * (pb + steps),
         f"rmsnorm launches {counts['rmsnorm']} != {NORMS_ZAMBA} x "
         f"({pb} prefill launches + {steps} micro-steps)"),
        (st["free_pages"] == st["pages_total"], "pages not returned"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"zamba2 run: {what}")
    alloc = engine.caches["paged"]
    if int(alloc["top"]) != engine.num_pages or (alloc["ref"] != 0).any():
        raise AssertionError("zamba2 run: device free stack not whole")
    return {"flash_attention": counts["flash_attention"],
            "paged_decode_attention": counts["paged_decode_attention"],
            "ssd_chunk": counts["ssd_chunk"]}


def phase_rwkv(card):
    """rwkv6-1.6b at full width and depth (24 layers, d_model 2048, 32 WKV
    heads of 64, d_ff 7168, vocab 65536), bf16, random weights from a
    seed, on the contiguous engine with the llama contiguous run's
    traffic. Its blocks take no mask, so prompts prefill in exact-length
    groups; its state is O(1) per slot (no KV cache)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("rwkv6-1.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.dtype) == (N_RWKV, 2048,
                                                      "bfloat16")
    assert set(cfg.block_pattern) == {"rwkv6"}
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    n_params = sum(t.numel() for t in _leaves(params))
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"\n[rwkv6] {cfg.name}: {cfg.n_layers} layers, {n_params} "
          f"parameters, {weights / 1e9:.3f} GB on the card ({card})")
    ecfg = EngineConfig(max_batch=8, max_len=2048, profile="h100_sxm",
                        region="QC")
    warm = ServingEngine(model, params, ecfg)   # not counted
    warm.submit(Request(rid=0, prompt=list(range(2, 40)), max_new_tokens=4))
    warm.run()
    del warm
    engine, st, counts = serve(card, "rwkv6 contiguous", ecfg,
                               engine_requests(cfg.vocab), model, params)
    forwards = engine.prefill_batches + st["steps"]
    others = {k: n for k, n in counts.items()
              if k not in ("wkv6", "rmsnorm") and n}
    checks = [
        (counts["wkv6"] == N_RWKV * forwards,
         f"wkv6 launches {counts['wkv6']} != {N_RWKV} x "
         f"({engine.prefill_batches} prefill launches + {st['steps']} "
         "micro-steps)"),
        (counts["rmsnorm"] == NORMS_RWKV * forwards,
         f"rmsnorm launches {counts['rmsnorm']} != {forwards} forwards"),
        (not others, f"attention or SSD kernels ran: {others}"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"rwkv6 run: {what}")
    return {"wkv6": counts["wkv6"]}


def dense_requests(vocab):
    """The paged trace's first ``DENSE_REQUESTS`` requests with
    ``DENSE_NEW`` new tokens each: the first wave of 8 holds the donor and
    three other requests that open with the 512-token system prompt, and
    four Alpaca-like ones; the next four (three suffixes and the whole
    system prompt, the copy-on-write path) queue behind the wave and adopt
    the donor's registered pages. With 8 requests only, every one is
    admitted at once, before any prompt registers its pages, so no prefix
    could be shared."""
    from repro_torch.serving import Request
    return [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=DENSE_NEW)
            for r in paged_requests(vocab)[:DENSE_REQUESTS]]


def phase_dense(card):
    """The paper's other dense configurations at full width and depth in
    bf16, random weights from a seed: ``llama-paper-3b`` (head dim 100) on
    the contiguous engine and on the paged main path, then
    ``llama-paper-7b``, ``internlm2-20b`` (48 q heads on 8 kv heads
    duplicated to 16: GQA group 3) and ``minicpm-2b`` (36 heads padded to
    48, group 1 with the identity map) on the paged main path, and
    ``stablelm-12b`` (40 ``parallel`` blocks: qk-norm, 25% rotary, 32 q
    heads of 160 on 8 kv heads duplicated to 16, GQA group 2) on the
    contiguous engine and on the paged main path. Each model is freed
    before the next. Returns each kernel's launches on these paths."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    base = dict(max_batch=8, max_len=2048, profile="h100_sxm", region="QC")
    runs = [("llama-paper-3b", "contiguous"), ("llama-paper-3b", "paged"),
            ("llama-paper-7b", "paged"), ("internlm2-20b", "paged"),
            ("minicpm-2b", "paged"), ("stablelm-12b", "contiguous"),
            ("stablelm-12b", "paged")]
    total = {}
    model = params = loaded = None
    for arch, path in runs:
        cfg = get_config(arch)
        L = N_DENSE[arch]
        assert cfg.n_layers == L and cfg.dtype == "bfloat16"
        if loaded != arch:
            model = params = None
            gc.collect()
            torch.cuda.empty_cache()
            model = Model(cfg, "cuda")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            params, loaded = model.init(gen), arch
            n_params = sum(t.numel() for t in _leaves(params))
            if n_params != DENSE_PARAMS[arch]:
                raise AssertionError(f"{arch}: {n_params} parameters on the "
                                     f"card, the reference has "
                                     f"{DENSE_PARAMS[arch]}")
            weights = sum(t.numel() * t.element_size()
                          for t in _leaves(params))
            print(f"\n[dense] {arch}: {L} layers, d_model {cfg.d_model}, "
                  f"heads {cfg.n_heads}/{cfg.n_kv_heads} padded to "
                  f"{cfg.n_heads_padded}/{cfg.n_kv_heads_padded}, head dim "
                  f"{cfg.head_dim_}, {n_params} parameters, "
                  f"{weights / 1e9:.3f} GB on the card ({card})")
        ecfg = (EngineConfig(**base) if path == "contiguous" else
                EngineConfig(**base, paged=True, page_size=16,
                             prefill_chunk=256, prefill_pack=2,
                             prefix_sharing=True))
        warm = ServingEngine(model, params, ecfg)   # not counted
        warm.submit(Request(rid=0, prompt=list(range(2, 40)),
                            max_new_tokens=4))
        warm.run()
        del warm
        label = f"{arch} {path}"
        engine, st, counts = serve(card, label, ecfg,
                                   dense_requests(cfg.vocab), model, params,
                                   new_tokens=DENSE_NEW)
        if path == "contiguous":
            contiguous_checks(label, cfg, engine, st, counts)
        else:
            paged_checks(label, cfg, engine, st, counts)
        del engine
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    model = params = None
    gc.collect()
    torch.cuda.empty_cache()
    return total


def maverick_requests(vocab):
    """The first wave: 8 prompts of 64-512 tokens (four prefill buckets);
    then one of 8,176 tokens, which waits for a slot and so is admitted,
    and prefills, alone after the wave (bucket 8,192, 16 pad queries) and
    decodes across position 8,192, where every chunk-local ring evicts the
    first chunk's keys and masks what remains of them. 32 new tokens
    each."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(17)
    lens = list(MAVERICK_LENS) + [MAVERICK_LONG]
    return [Request(rid=i, prompt=rng.integers(2, vocab, n).tolist(),
                    max_new_tokens=MAVERICK_NEW) for i, n in enumerate(lens)]


def maverick_cut():
    """Llama-4 Maverick at full width cut to its first ``N_MAVERICK``
    layers."""
    from repro_torch.configs import get_config
    full = get_config(MAVERICK)
    return dataclasses.replace(full, n_layers=N_MAVERICK,
                               block_pattern=full.block_pattern[:N_MAVERICK])


def phase_maverick(card):
    """Llama-4 Maverick at full width (d 5120, 40 / 8 heads padded to 48 /
    16, head dim 128, 128 experts top-1 plus a shared one, d_ff 8192,
    vocab 202,048) and depth 4 (chunk-local dense, moe, dense, then the
    global moe layer; 35.12 B parameters, 70.2 GB in bf16), random
    weights from a seed, on the contiguous engine, the earlier models
    freed first: ``maverick_requests`` served twice, with the same tokens.
    Asserts flash 4 a prefill launch, decode 4 a micro-step, RMSNorm 9 a
    forward, the long prompt prefilled alone, every response terminal,
    finite logits, and the host's waits (sync debug mode, the second run)
    equal to ``host_syncs``; reports peak memory beside the weights and
    KV reckoning, and tokens/s. Returns each kernel's launches."""
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = maverick_cut()
    L = N_MAVERICK
    assert cfg.block_pattern == ("dense", "moe", "dense", "moe")
    assert [cfg.layer_uses_chunked_attn(i) for i in range(L)] == \
        [True, True, True, False]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"\n[maverick] allocated before loading: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB ({card})")
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != MAVERICK_PARAMS:
        raise AssertionError(f"{MAVERICK} depth {L}: {n_params} parameters "
                             f"on the card, the reference has "
                             f"{MAVERICK_PARAMS}")
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[maverick] {MAVERICK}: depth {L} {cfg.block_pattern}, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} padded to "
          f"{cfg.n_heads_padded}/{cfg.n_kv_heads_padded} (kernels: group 5 "
          f"over kv ::2), {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
          f"+ {cfg.moe.n_shared_experts} shared, {n_params} parameters, "
          f"{weights / 1e9:.3f} GB on the card, drawn in {init_s:.1f} s "
          f"({card})")
    probe = torch.randint(2, cfg.vocab, (1, 64), generator=gen,
                          device="cuda", dtype=torch.int32)
    logits, _ = model.prefill(params, probe, max_len=64)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{MAVERICK}: non-finite prefill logits")
    del logits
    ecfg = EngineConfig(max_batch=8, max_len=MAVERICK_MAX_LEN,
                        profile="h100_sxm", region="QC")
    warm = ServingEngine(model, params, ecfg)          # not counted
    warm.submit(Request(rid=0, prompt=list(range(2, 40)), max_new_tokens=4))
    warm.run()
    del warm
    label = f"{MAVERICK} depth {L} contiguous"
    engine, st, counts = serve(card, label, ecfg,
                               maverick_requests(cfg.vocab), model, params,
                               new_tokens=MAVERICK_NEW)
    contiguous_checks(label, cfg, engine, st, counts)
    pb = engine.prefill_batches
    resp = engine.responses
    long_rid = len(MAVERICK_LENS)
    first = min(resp[long_rid].t_emit)
    checks = [
        (counts["flash_attention"] == L * pb,
         f"flash launches {counts['flash_attention']} != {L} x {pb}"),
        (pb == 5, f"{pb} prefill launches, not the wave's 4 buckets + 1"),
        (all(max(resp[r].t_emit) <= first for r in range(long_rid)),
         "the long prompt was admitted before the wave finished"),
        (MAVERICK_LONG + MAVERICK_NEW - 1 > MAVERICK_CHUNK
         and resp[long_rid].n_tokens == MAVERICK_NEW,
         "the long request does not decode past the first chunk"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"{label}: {what}")
    tokens = {r: list(resp[r].tokens) for r in resp}
    kv = sum(c[n].numel() * c[n].element_size()
             for c in engine.caches["layers"] for n in ("k", "v"))
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak {peak / 1e9:.2f} GB allocated against the reckoning: "
          f"weights {weights / 1e9:.2f} GB + KV {kv / 1e9:.2f} GB (3 rings "
          f"of {MAVERICK_CHUNK} and the global layer's {MAVERICK_MAX_LEN} "
          f"rows a slot) = {(weights + kv) / 1e9:.2f} GB ({card})")
    del engine

    def again():
        eng = ServingEngine(model, params, ecfg)
        for r in maverick_requests(cfg.vocab):
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        return eng

    engine, waits = count_waits(again)
    if {r: list(engine.responses[r].tokens) for r in engine.responses} != \
            tokens:
        raise AssertionError(f"{label}: a second run gave other tokens")
    if waits != engine.host_syncs:
        raise AssertionError(f"{label}: the host waited {waits} times, "
                             f"host_syncs {engine.host_syncs}")
    print(f"  a second run: the same tokens; host waits for the device "
          f"(sync debug mode) {waits} = host_syncs {engine.host_syncs}")
    del engine
    model = None
    gc.collect()
    torch.cuda.empty_cache()
    # the same weights, full attention: the paged main path and the fleet
    t0 = time.perf_counter()
    model, paged = phase_maverick_paged(card, params)
    t1 = time.perf_counter()
    fleet = phase_fleet(card, model, params)
    print(f"\n[maverick] paged phase {t1 - t0:.1f} s, fleet phase "
          f"{time.perf_counter() - t1:.1f} s ({card})")
    model = params = None
    gc.collect()
    torch.cuda.empty_cache()
    return {"contiguous": counts, "paged": paged, "fleet": fleet}


# the port's examples as a user runs them, each with what its report must
# end with: (script, its last line's opening)
EXAMPLE_RUNS = (("quickstart_torch.py", "embodied share of total carbon:"),
                ("serve_e2e_torch.py", "lowest-carbon deployment:"),
                ("carbon_planner_torch.py", "  hourly choices:"))


def phase_examples(card):
    """``examples/quickstart_torch.py``, ``serve_e2e_torch.py`` and
    ``carbon_planner_torch.py`` with no arguments, as a user runs them:
    the serving two on the card (their default device), the planner on
    the host. The three run at once, each in its own process; each must
    exit 0 with its report's last line. Prints each one's last lines and
    the seconds until it had ended."""
    procs, t0 = {}, time.perf_counter()
    for name, _ in EXAMPLE_RUNS:
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", name)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    done = {}
    try:
        for name, last in EXAMPLE_RUNS:
            out, err = procs[name].communicate(timeout=600)
            done[name] = time.perf_counter() - t0
            lines = out.strip().splitlines()
            if procs[name].returncode != 0 or not lines or \
                    not lines[-1].startswith(last):
                raise AssertionError(
                    f"examples/{name}: exit {procs[name].returncode}, last "
                    f"line {lines[-1:]!r}; stderr {err[-2000:]}")
            print(f"\n[examples] {name}: ended within {done[name]:.1f} s "
                  f"({card}); its last lines:")
            for line in lines[-6:]:
                print(f"  {line}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


def maverick_full_attention():
    """``maverick_cut`` with full attention in every layer (no chunk-local
    layers): what the reference's paged gate (``supports_paged_decode``)
    admits. The parameter tree does not depend on the attention span, so
    the contiguous phase's weights serve it."""
    return dataclasses.replace(maverick_cut(), attn_chunk=None,
                               global_attn_every=0)


def paged_chunks(model, params, prompts, chunk, page_size):
    """Prompts (a list of token lists) through the paged pool at the model
    level, as the engine's chunk launches run them (``alloc_chunk_pages``,
    ``gather_slot_view``, ``prefill_chunk``, ``scatter_slot_view``), then
    one decode step of each prompt's greedy next token. Returns the first
    decode step's logits (B, padded vocab)."""
    from repro_torch.serving import paged as PG
    B = len(prompts)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    longest = int(lens.max())
    max_len = -(-(longest + 1) // page_size) * page_size
    caches = PG.paginate_cache(model.init_cache(B, max_len), B, page_size,
                               B * max_len // page_size)
    slots = torch.arange(B, dtype=torch.int32, device="cuda")
    nxt = torch.zeros((B,), dtype=torch.int64)
    for c0 in range(0, longest, chunk):
        tokens = torch.zeros((B, chunk), dtype=torch.int32)
        mask = torch.zeros((B, chunk), dtype=torch.int32)
        for i, p in enumerate(prompts):
            piece = p[c0:c0 + chunk]
            tokens[i, :len(piece)] = torch.tensor(piece, dtype=torch.int32)
            mask[i, :len(piece)] = 1
        t0 = lens.clamp(max=c0)
        nv = mask.sum(1, dtype=torch.int32)
        caches["paged"] = PG.alloc_chunk_pages(
            caches["paged"], slots, (-(-t0 // page_size)).to("cuda"),
            (-(-(t0 + nv) // page_size)).to("cuda"))
        view = PG.gather_slot_view(caches, slots)
        out, view = model.prefill_chunk(params, view, tokens.to("cuda"),
                                        mask.to("cuda"))
        PG.scatter_slot_view(caches, view, slots)
        # a prompt's next token: the logits of its last chunk
        done = (t0 + nv == lens) & (nv > 0)
        nxt = torch.where(done, out[:, :model.cfg.vocab].argmax(-1).cpu(),
                          nxt)
    PG.alloc_decode_pages(caches["paged"], caches["t"],
                          torch.ones(B, dtype=torch.bool, device="cuda"),
                          page_size)
    logits, _ = model.decode_step(params, caches,
                                  nxt[:, None].to(torch.int32).to("cuda"))
    return logits


PAGED_OPS = ("paged_decode_attention", "chunked_prefill_attention",
             "rmsnorm", "add_rmsnorm")


def maverick_paged_probe(card, model, params):
    """``MAVERICK_PROBE_LENS`` prompts through chunks of 256 and the first
    decode step (``paged_chunks``) three times on the same weights: with
    the kernels (launches counted), with each kernel call held against its
    plain version on the same inputs (``checked_run``), and on the plain
    versions. Each kernel call must be within ``TOL[bf16]`` of its plain
    version on the same inputs, the first decode logits the same with and
    without the checks, their argmax the plain versions', and their
    relative error from the plain versions' at most
    ``MAVERICK_PROBE_REL``; the elements past ``TOL[bf16]`` are
    printed."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(23)
    prompts = [rng.integers(2, model.cfg.vocab, n).tolist()
               for n in MAVERICK_PROBE_LENS]
    run = functools.partial(paged_chunks, model, params, prompts, 256, 16)
    torch.cuda.synchronize()
    ops.reset_launches()
    got = run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    again, calls = checked_run(f"{model.cfg.name} paged probe", run,
                               PAGED_OPS)
    with ops.swapped(lambda name, op, plain: plain, PAGED_OPS):
        want = run()
    atol, rtol = TOL[torch.bfloat16]
    rows = torch.ones_like(want, dtype=torch.bool)
    err, bad = past_tol(got, want, rows, atol, rtol)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    n_chunks = -(-max(MAVERICK_PROBE_LENS) // 256)
    L = model.cfg.n_layers
    print(f"\n[maverick paged] probe: prompts {MAVERICK_PROBE_LENS} in "
          f"{n_chunks} chunk launches of 256, then one decode step; each "
          f"kernel call against its plain version on the same inputs (max "
          f"abs err, past atol {atol} rtol {rtol}, calls, sums unequal): "
          f"{calls}; first decode logits against the plain versions': "
          f"relative error {rel:.4e} (bound {MAVERICK_PROBE_REL:.4e}), max "
          f"abs err {err:.4e}, {bad} of {want.numel()} past atol {atol} "
          f"rtol {rtol}, max |logit| {float(want.float().abs().max()):.3f};"
          f" argmax agree {int((got.argmax(-1) == want.argmax(-1)).sum())}/"
          f"{got.shape[0]}; launches {launches} ({card})")
    expect(f"{model.cfg.name} paged probe", [
        (bool(torch.isfinite(got).all()), "non-finite logits"),
        (torch.equal(again, got), "the checked run gave other logits"),
        (torch.equal(got.argmax(-1), want.argmax(-1)),
         "the first decode tokens are not the plain versions'"),
        (rel <= MAVERICK_PROBE_REL,
         f"first decode logits {rel:.4e} from the plain versions', over "
         f"{MAVERICK_PROBE_REL:.4e}"),
        (launches["chunked_prefill_attention"] == L * n_chunks
         and launches["paged_decode_attention"] == L,
         f"launches {launches}: not {L} x {n_chunks} chunk and {L} "
         "paged decode")])


def phase_maverick_paged(card, params):
    """Llama-4 Maverick at full width and depth 4 with full attention
    (``maverick_full_attention``) on the graphed paged main path: the
    paged pool of 16 duplicated kv heads, chunked prefill (256, packed 2)
    and prefix sharing, ``max_batch=8, max_len=2048``, on the contiguous
    phase's weights. The paged kernels run q heads :40 at group 5 over the
    pool's kv heads ::2, and a moe forward's dead query rows get the plain
    version's value (``attention._fill_dead_rows_paged``). First
    ``maverick_paged_probe``; then ``paged_requests`` (32 new tokens each)
    served twice with the same tokens, the second run's host waits (sync
    debug mode) equal to ``host_syncs``; the paged main path's launch
    counts (``paged_checks``), and the pool's bytes and the peak beside
    the weights. Returns (model, counts)."""
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = maverick_full_attention()
    model = Model(cfg, "cuda")
    maverick_paged_probe(card, model, params)
    ecfg = EngineConfig(max_batch=8, max_len=MAVERICK_PAGED_LEN,
                        profile="h100_sxm", region="QC", paged=True,
                        page_size=16, prefill_chunk=256, prefill_pack=2,
                        prefix_sharing=True)
    label = f"{MAVERICK} depth {cfg.n_layers} paged"
    engine, st, counts = serve(card, label, ecfg,
                               paged_requests(cfg.vocab, MAVERICK_NEW),
                               model, params, new_tokens=MAVERICK_NEW)
    paged_checks(label, cfg, engine, st, counts)
    tokens = {r: list(engine.responses[r].tokens) for r in engine.responses}
    pool = sum(c[n].numel() * c[n].element_size()
               for c in engine.caches["layers"]
               for n in ("k_pages", "v_pages"))
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"allocated against the reckoning: weights {weights / 1e9:.2f} GB "
          f"+ the pool {pool / 1e9:.3f} GB ({st['pages_total']} pages and "
          f"the trash page of 16 tokens x 16 kv heads x 128 x k, v x bf16 "
          f"x {cfg.n_layers} layers) ({card})")
    del engine

    def again():
        eng = ServingEngine(model, params, ecfg)
        for r in paged_requests(cfg.vocab, MAVERICK_NEW):
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        return eng

    engine, waits = count_waits(again)
    expect(label, [
        ({r: list(engine.responses[r].tokens) for r in engine.responses}
         == tokens, "a second run gave other tokens"),
        (waits == engine.host_syncs,
         f"the host waited {waits} times, host_syncs {engine.host_syncs}")])
    print(f"  a second run: the same tokens; host waits for the device "
          f"(sync debug mode) {waits} = host_syncs {engine.host_syncs}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return model, counts


def deepseek_requests(vocab):
    """The first wave: 8 prompts of 64-512 tokens (four prefill buckets);
    then one of 3,000 tokens, which waits for a slot and so is admitted,
    and prefills, alone after the wave, in a bucket of 4,096 keys: past
    ``DIRECT_ATTN_MAX_SEQ`` (2,048), the attention's two-level scan. 32
    new tokens each."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(19)
    lens = list(DEEPSEEK_LENS) + [DEEPSEEK_LONG]
    return [Request(rid=i, prompt=rng.integers(2, vocab, n).tolist(),
                    max_new_tokens=DEEPSEEK_NEW) for i, n in enumerate(lens)]


def deepseek_cut():
    """DeepSeek-V3 at full width cut to its first ``N_DEEPSEEK`` layers."""
    from repro_torch.configs import get_config
    full = get_config(DEEPSEEK)
    return dataclasses.replace(full, n_layers=N_DEEPSEEK,
                               block_pattern=full.block_pattern[:N_DEEPSEEK])


def deepseek_norms(cfg):
    """RMSNorm launches per forward of an MLA model: ln1 and ln2 (each
    with the residual add before it), q_norm and kv_norm in every block,
    and the final norm."""
    return 4 * cfg.n_layers + 1


def deepseek_probe(card, model, params, gen):
    """One 64-token prefill at full width with every norm on the RMSNorm
    kernel, and again with the plain versions (``kernels/ref.py``) on the
    card, on the same weights and tokens: the last-token logits within
    ``TOL[bf16]`` (atol and rtol 2e-2, the bf16 kernels' tolerance: the
    logits are bf16 products, one ulp of which is 0.0625 past |8|).
    Returns the max abs error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF
    probe = torch.randint(2, model.cfg.vocab, (1, 64), generator=gen,
                          device="cuda", dtype=torch.int32)
    ops.reset_launches()
    got, _ = model.prefill(params, probe, max_len=64)
    launches = ops.launch_counts()["rmsnorm"]
    kernels = (ops.rmsnorm, ops.add_rmsnorm)
    ops.rmsnorm, ops.add_rmsnorm = REF.rmsnorm, REF.add_rmsnorm
    try:
        want, _ = model.prefill(params, probe, max_len=64)
    finally:
        ops.rmsnorm, ops.add_rmsnorm = kernels
    if launches != deepseek_norms(model.cfg):
        raise AssertionError(f"{DEEPSEEK} probe: {launches} rmsnorm "
                             f"launches, not {deepseek_norms(model.cfg)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{DEEPSEEK}: non-finite probe logits")
    atol, rtol = TOL[torch.bfloat16]
    err, bad = past_tol(got, want, torch.ones_like(want, dtype=torch.bool),
                        atol, rtol)
    print(f"[deepseek] 64-token prefill probe, the RMSNorm kernel against "
          f"the plain versions on the card: last-token logits max abs err "
          f"{err:.4e} (max |logit| {float(want.abs().max()):.3f}), {bad} of "
          f"{want.numel()} past atol {atol} rtol {rtol}; argmax "
          f"{int(got.argmax())} vs {int(want.argmax())}; {launches} rmsnorm "
          f"launches ({card})")
    if bad:
        raise AssertionError(f"{DEEPSEEK} probe: {bad} logits past atol "
                             f"{atol} rtol {rtol}")
    return err


def phase_deepseek(card):
    """DeepSeek-V3 at full width (d 7,168; 128 heads; MLA: q_lora 1,536,
    kv_lora 512, nope 128, rope 64, v 128; dense d_ff 18,432; 256 experts
    of 2,048 top-8 plus a shared one; vocab 129,280; the MTP head held)
    and depth 5 (3 ``mla`` and 2 ``mla_moe`` blocks; 27.59 B parameters),
    random weights from a seed, on the contiguous engine, the earlier
    models freed first: a 64-token probe against the plain norms, then
    ``deepseek_requests`` served twice, with the same tokens. Asserts the
    parameter count, RMSNorm ``deepseek_norms`` (21) a forward and no
    other kernel, the long prompt prefilled alone on the scan path (5 scan
    calls, one a layer), every response terminal, and the host's waits
    (sync debug mode, the second run) equal to ``host_syncs``; reports
    peak memory beside the weights and latent cache reckoning, and
    tokens/s. Returns each kernel's launches."""
    from repro_torch.models import Model
    from repro_torch.models import attention as A
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = deepseek_cut()
    L = N_DEEPSEEK
    assert cfg.block_pattern == ("mla",) * 3 + ("mla_moe",) * 2
    assert cfg.grouping() == (("mla",) * 3, ("mla_moe",), 2)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"\n[deepseek] allocated before loading: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB ({card})")
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != DEEPSEEK_PARAMS:
        raise AssertionError(f"{DEEPSEEK} depth {L}: {n_params} parameters "
                             f"on the card, the reference has "
                             f"{DEEPSEEK_PARAMS}")
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    mtp = sum(t.numel() for t in _leaves(params["mtp"]))
    m = cfg.mla
    print(f"[deepseek] {DEEPSEEK}: depth {L} {cfg.block_pattern}, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, MLA q_lora {m.q_lora_rank} "
          f"kv_lora {m.kv_lora_rank} nope {m.qk_nope_head_dim} rope "
          f"{m.qk_rope_head_dim} v {m.v_head_dim}, {cfg.moe.n_experts} "
          f"experts top-{cfg.moe.top_k} + {cfg.moe.n_shared_experts} shared, "
          f"{n_params} parameters ({mtp} in the MTP head), "
          f"{weights / 1e9:.3f} GB on the card (bf16, the routers float32), "
          f"drawn in {init_s:.1f} s ({card})")
    deepseek_probe(card, model, params, gen)
    ecfg = EngineConfig(max_batch=8, max_len=DEEPSEEK_MAX_LEN,
                        profile="h100_sxm", region="QC")
    warm = ServingEngine(model, params, ecfg)          # not counted
    warm.submit(Request(rid=0, prompt=list(range(2, 40)), max_new_tokens=4))
    warm.run()
    del warm
    forwards = {"prefill": 0, "decode": 0}
    scans = [0]
    forward, scan = model.forward, A._flash_attention

    def count_forward(*a, mode="prefill", **kw):
        forwards[mode] += 1
        return forward(*a, mode=mode, **kw)

    def count_scan(*a, **kw):
        scans[0] += 1
        return scan(*a, **kw)

    model.forward, A._flash_attention = count_forward, count_scan
    label = f"{DEEPSEEK} depth {L} contiguous"
    try:
        engine, st, counts = serve(card, label, ecfg,
                                   deepseek_requests(cfg.vocab), model,
                                   params, new_tokens=DEEPSEEK_NEW)
    finally:
        model.forward, A._flash_attention = forward, scan
    pb = engine.prefill_batches
    resp = engine.responses
    long_rid = len(DEEPSEEK_LENS)
    first = min(resp[long_rid].t_emit)
    # a decode forward runs its Python once, at its graph's capture; the
    # replays run the micro-steps
    captured = sum(k[0] for k in engine.graphs.launches)
    micro = st["graph"]["micro_steps"]
    n_fwd = forwards["prefill"] + micro
    checks = [
        (counts["rmsnorm"] == deepseek_norms(cfg) * n_fwd,
         f"rmsnorm launches {counts['rmsnorm']} != {deepseek_norms(cfg)} x "
         f"{n_fwd} forwards"),
        (forwards["decode"] == captured,
         f"{forwards['decode']} decode forwards called, the captures hold "
         f"{captured} micro-steps"),
        (all(n == 0 for k, n in counts.items() if k != "rmsnorm"),
         f"an attention or scan kernel ran on the MLA path: {counts}"),
        (forwards["prefill"] == pb == 5,
         f"{pb} prefill launches ({forwards['prefill']} prefill forwards), "
         "not the wave's 4 buckets + 1"),
        (micro >= st["steps"],
         f"{micro} decode micro-steps replayed < {st['steps']} steps"),
        (scans[0] == L, f"{scans[0]} scan calls, not one a layer"),
        (all(max(resp[r].t_emit) <= first for r in range(long_rid)),
         "the long prompt was admitted before the wave finished"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"{label}: {what}")
    gen_tokens = sum(r.n_tokens for r in resp.values())
    print(f"  forwards: {forwards['prefill']} prefill + {micro} decode "
          f"(graph replays), rmsnorm {deepseek_norms(cfg)} a forward; the 3,000-token "
          f"prompt's 4,096-key prefill on the scan path ({scans[0]} calls, "
          f"one a layer); modeled {st['total_energy_j'] / gen_tokens:.4e} J "
          f"and {st['total_carbon_g'] / gen_tokens:.4e} gCO2 a generated "
          f"token, host_syncs {engine.host_syncs} ({card})")
    tokens = {r: list(resp[r].tokens) for r in resp}
    cache = sum(c[n].numel() * c[n].element_size()
                for c in engine.caches["layers"] for n in ("ckv", "k_rope"))
    per_tok = (m.kv_lora_rank + m.qk_rope_head_dim) * 2 * L
    if cache != per_tok * ecfg.max_batch * DEEPSEEK_MAX_LEN:
        raise AssertionError(f"{label}: latent cache {cache} B, not "
                             f"{per_tok} B a token a slot")
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak {peak / 1e9:.2f} GB allocated against the reckoning: "
          f"weights {weights / 1e9:.2f} GB + latent cache {cache / 1e9:.3f} "
          f"GB ({per_tok} B a token a slot: ckv {m.kv_lora_rank} + k_rope "
          f"{m.qk_rope_head_dim} in bf16 x {L} layers, {ecfg.max_batch} slots "
          f"x {DEEPSEEK_MAX_LEN} rows) = {(weights + cache) / 1e9:.2f} GB "
          f"({card})")
    del engine

    def again():
        eng = ServingEngine(model, params, ecfg)
        for r in deepseek_requests(cfg.vocab):
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        return eng

    engine, waits = count_waits(again)
    if {r: list(engine.responses[r].tokens) for r in engine.responses} != \
            tokens:
        raise AssertionError(f"{label}: a second run gave other tokens")
    if waits != engine.host_syncs:
        raise AssertionError(f"{label}: the host waited {waits} times, "
                             f"host_syncs {engine.host_syncs}")
    print(f"  a second run: the same tokens; host waits for the device "
          f"(sync debug mode) {waits} = host_syncs {engine.host_syncs}")
    del engine
    model = params = None
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def vlm_cut():
    """Llama-3.2-Vision 90B at full width cut to its first ``N_VLM``
    layers."""
    from repro_torch.configs import get_config
    full = get_config(VLM)
    return dataclasses.replace(full, n_layers=N_VLM,
                               block_pattern=full.block_pattern[:N_VLM])


def memory_norms(cfg):
    """RMSNorm launches per decoder forward of a memory-conditioned model:
    ln1 and ln2 of every ``dense`` and ``cross`` block, ln1, ln_x and ln2
    of every ``dec`` block, and the final norm (each with the residual add
    before it). An encoder-decoder's prefill adds ``encoder_norms``."""
    return 1 + sum(3 if kind == "dec" else 2 for kind in cfg.block_pattern)


def encoder_norms(cfg):
    """ln1 and ln2 of every encoder layer, and ``enc_norm``."""
    return 2 * cfg.n_encoder_layers + 1


def plain_ops():
    """Within: the model's flash, decode, RMSNorm, SSD chunk and WKV6 ops
    are their plain versions (``kernels/ref.py``), on the card."""
    from repro_torch.kernels import ops
    return ops.swapped(lambda name, op, plain: plain,
                       ops.SWAPPABLE + ops.RECURRENT)


def load_model(cfg, n_expected, tag, card):
    """``cfg``'s model on the card, random weights from seed 0; raises
    unless it holds ``n_expected`` parameters. Returns (model, params,
    generator, bytes of the weights)."""
    from repro_torch.models import Model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"\n[{tag}] allocated before loading: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB ({card})")
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    leaves = {id(t): t for t in _leaves(params)}.values()   # shared once
    n_params = sum(t.numel() for t in leaves)
    if n_params != n_expected:
        raise AssertionError(f"{cfg.name} depth {cfg.n_layers}: {n_params} "
                             f"parameters on the card, the reference has "
                             f"{n_expected}")
    weights = sum(t.numel() * t.element_size() for t in leaves)
    print(f"[{tag}] {cfg.name}: depth {cfg.n_layers}, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} padded to "
          f"{cfg.n_heads_padded}/{cfg.n_kv_heads_padded}, head dim "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, {n_params} parameters, "
          f"{weights / 1e9:.3f} GB on the card, drawn in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    return model, params, gen, weights


def checked_ops(record, names=None):
    """Within: each flash, decode and RMSNorm op (or each of ``names``,
    ``kernels/ops.py``'s op names; a chunk's pad query rows left out) of
    the model runs its
    kernel and then its plain version on the same inputs on the card, and
    returns the kernel's output; ``record[name]`` gathers [max abs error,
    elements past ``TOL[bf16]``, calls, residual sum elements other than
    the plain add's] (``add_rmsnorm``'s sum is held bit for bit, as phase
    3 holds it; its norm to the tolerance), the errors and counts as
    tensors on the card, updated in place (a CUDA graph of an engine's
    decode step captured within checks every call of every replay), read
    by the caller: no host wait a call."""
    from repro_torch.kernels import ops
    atol, rtol = TOL[torch.bfloat16]
    names = names or ops.SWAPPABLE

    for name in names:
        record[name] = [torch.zeros((), device="cuda")] + [
            torch.zeros((), dtype=torch.int64, device="cuda")
            for _ in range(3)]

    def check(name, kernel, plain):
        def run(*a, **kw):
            got, want = kernel(*a, **kw), plain(*a, **kw)
            g, w = got, want
            r = record[name]
            if isinstance(got, tuple):             # add_rmsnorm: (s, y)
                r[3].add_((got[0] != want[0]).sum())
                g, w = got[1], want[1]
            err = (g.float() - w.float()).abs()
            if name == "chunked_prefill_attention":
                # a pad query's row: 0 from the kernel, the plain mean
                # written after it by the model (attention._fill_dead_rows)
                err = err * (a[4] >= 0)[:, None, :, None]
            torch.maximum(r[0], err.max(), out=r[0])
            r[1].add_((err > atol + rtol * w.float().abs()).sum())
            r[2].add_(1)
            return got
        return run
    return ops.swapped(check, names)


def checked_run(label, run, names=None):
    """``run()`` within ``checked_ops``, the launch counts set to 0 just
    before and read just after: raises unless every kernel call is within
    ``TOL[bf16]`` of its plain version on the same inputs, every residual
    sum equals the plain add's, and each kernel was checked as often as it
    launched (``names``: ``checked_ops``'s). Returns (run's result, the
    record)."""
    from repro_torch.kernels import ops
    atol, rtol = TOL[torch.bfloat16]
    calls = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    with checked_ops(calls, names):
        out = run()
    launches = ops.launch_counts()
    calls = {n: [float(r[0]), int(r[1]), int(r[2]), int(r[3])]
             for n, r in calls.items()}
    # the kernel each op launches: the RMSNorm forms launch ``rmsnorm``
    checked = {}
    for n, r in calls.items():
        k = "rmsnorm" if n.endswith("rmsnorm") else n
        checked[k] = checked.get(k, 0) + r[2]
    expect(label, [
        (all(r[1] == 0 for r in calls.values()),
         f"kernel calls past atol {atol} rtol {rtol} (max abs err, past, "
         f"calls, sums unequal): {calls}"),
        (all(r[3] == 0 for r in calls.values()),
         f"a residual sum other than the plain add's: {calls}"),
        (all(checked[k] == launches[k] for k in checked)
         and sum(checked.values()) == sum(launches.values()),
         f"checked calls {checked}, launches {launches}")])
    return out, calls


def planted(target, ulps):
    """Within: the kernels, but each RMSNorm call that reads ``target`` (a
    norm's scale, ones at init) reads it ``ulps`` bf16 ulps of 1 higher: a
    fault of ``ulps`` x 0.78% in that norm, which up to 2 ulps no single
    call's ``TOL[bf16]`` can see."""
    from repro_torch.kernels import ops
    at = {"rmsnorm": 1, "add_rmsnorm": 2}

    def make(name, op, plain):
        def run(*a, **kw):
            if a[at[name]] is target:
                a = list(a)
                a[at[name]] = target + ulps * 2.0 ** -7
            return op(*a, **kw)
        return run if name in at else op
    return ops.swapped(make)


def float32_prefill(model, params, tokens, extras, max_len):
    """The referee: the same weights and memory in float32, every op on
    its plain version, on the card. A float32 copy of the weights lives
    for the call (43.3 GB for the VLM's depth-10 cut)."""
    from repro_torch.models import Model

    def up(t):
        if isinstance(t, dict):
            return {k: up(v) for k, v in t.items()}
        if isinstance(t, list):
            return [up(v) for v in t]
        return t.float()

    ref = Model(dataclasses.replace(model.cfg, dtype="float32"), "cuda")
    with plain_ops():
        truth, _ = ref.prefill(up(params), tokens, max_len=max_len, extras={
            k: v.float() if v.is_floating_point() else v
            for k, v in extras.items()})
    gc.collect()
    torch.cuda.empty_cache()
    return truth


def memory_probe(card, tag, model, params, tokens, extras, max_len):
    """One prefill with the kernels (launch counts set to 0 just before
    and read just after); the same prefill again through ``checked_run``
    (each kernel call against its plain version on the same inputs); then
    the prefill on the plain versions in bf16 and in float32
    (``float32_prefill``): the kernels' last-token logits no further from
    the float32 ones than ``REFEREE`` times the plain bf16 path's (max abs
    error). The referee's own check: the kernels' prefill with the final
    norm's scale ``PLANTED_ULPS`` bf16 ulps high (``planted``), each
    printed against the same bound, the fault of ``REFEREE_CATCHES`` ulps
    past it. Returns (logits, caches, the checked prefill's caches,
    launches, prefill ms, peak bytes allocated in the kernel prefill)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    got, caches = model.prefill(params, tokens, max_len=max_len,
                                extras=extras)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()
    (again, checked_caches), calls = checked_run(
        f"{model.cfg.name} checked prefill",
        lambda: model.prefill(params, tokens, max_len=max_len,
                              extras=extras))
    with plain_ops():
        want, _ = model.prefill(params, tokens, max_len=max_len,
                                extras=extras)
    truth = float32_prefill(model, params, tokens, extras, max_len)
    if not all(torch.isfinite(t).all() for t in (got, want, truth)):
        raise AssertionError(f"{model.cfg.name}: non-finite probe logits")
    atol, rtol = TOL[torch.bfloat16]
    rows = torch.ones_like(want, dtype=torch.bool)
    faults = {}
    for ulps in PLANTED_ULPS:
        with planted(params["final_norm"]["scale"], ulps):
            bad, _ = model.prefill(params, tokens, max_len=max_len,
                                   extras=extras)
        faults[ulps] = past_tol(bad, truth, rows, atol, rtol)[0]
        del bad
    pairs = {"kernels vs plain bf16": past_tol(got, want, rows, atol, rtol),
             "kernels vs float32": past_tol(got, truth, rows, atol, rtol),
             "plain bf16 vs float32": past_tol(want, truth, rows, atol,
                                               rtol)}
    print(f"[{tag}] prefill {tuple(tokens.shape)}, {ms:.1f} ms with the "
          f"kernels; each kernel call against its plain version on the "
          f"same inputs on the card (max abs err, past atol {atol} rtol "
          f"{rtol}, calls, residual sums unequal): {calls} ({card})")
    for name, (err, bad) in pairs.items():
        print(f"  last-token logits, {name}: max abs err {err:.4e}, {bad} "
              f"of {want.numel()} past atol {atol} rtol {rtol}")
    print(f"  max |logit| {float(truth.abs().max()):.3f}; argmax agree with "
          f"float32: kernels {int((got.argmax(-1) == truth.argmax(-1)).sum())}"
          f"/{got.shape[0]}, plain bf16 "
          f"{int((want.argmax(-1) == truth.argmax(-1)).sum())}/{got.shape[0]}")
    k32 = pairs["kernels vs float32"][0]
    p32 = pairs["plain bf16 vs float32"][0]
    print(f"  referee: the kernels' logits {k32 / p32:.4f} x as far from "
          f"float32 as the plain bf16 path's (bound {REFEREE})")
    for ulps, err in faults.items():
        print(f"  planted fault, the final norm's scale {ulps} ulp(s) high: "
              f"max abs err {err:.4e} from float32, {err / p32:.4f} x the "
              f"plain bf16 path's, {'past' if err > REFEREE * p32 else 'within'}"
              f" the bound ({card})")
    checks = [
        (torch.equal(again, got), "the checked prefill gave other logits"),
        (k32 <= REFEREE * p32,
         f"kernels' logits {k32:.4e} from float32, over {REFEREE} x the "
         f"plain bf16 path's {p32:.4e}"),
        (faults[REFEREE_CATCHES] > REFEREE * p32,
         f"the referee let a planted fault of {REFEREE_CATCHES} ulps pass: "
         f"{faults[REFEREE_CATCHES]:.4e} within {REFEREE} x {p32:.4e}"),
    ]
    expect(f"{model.cfg.name} probe", checks)
    torch.cuda.reset_peak_memory_stats()
    return got, caches, checked_caches, launches, ms, peak


def checked_decode(label, model, params, caches, logits, toks):
    """The greedy decode steps that gave ``toks`` again, from the checked
    prefill's caches, through ``checked_run``: the same tokens. Returns
    the record."""
    (again, *_), calls = checked_run(
        f"{label} checked decode",
        lambda: greedy_decode(model, params, caches, logits, toks.shape[1]))
    expect(label, [(torch.equal(again, toks),
                    "the checked decode steps gave other tokens")])
    return calls


def greedy_decode(model, params, caches, logits, steps):
    """``steps`` greedy decode steps from ``logits`` at the model level,
    the launch counts set to 0 just before and read just after. Returns
    (tokens (B, steps), every step's logits finite, launches, seconds)."""
    from repro_torch.kernels import ops
    vocab = model.cfg.vocab
    cur = logits[:, :vocab].argmax(-1).to(torch.int32)[:, None]
    finite = torch.ones((), dtype=torch.bool, device=logits.device)
    toks = []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, caches = model.decode_step(params, caches, cur)
        finite &= torch.isfinite(logits).all()
        cur = logits[:, :vocab].argmax(-1).to(torch.int32)[:, None]
        toks.append(cur)
    torch.cuda.synchronize()
    return (torch.cat(toks, dim=1), finite, ops.launch_counts(),
            time.perf_counter() - t0)


def expect(label, checks):
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"{label}: {what}")


def set_gates(params, value=VLM_GATE):
    """Both gates of every ``cross`` layer set to ``value``, in place."""
    for p in params["layers"]:
        if "gate_mlp" in p:
            p["gate_mlp"].fill_(value)
            p["attn"]["gate"].fill_(value)


def seamless_inputs(cfg, gen):
    """``SEAMLESS_BATCH`` x ``SEAMLESS_PROMPT`` decoder tokens and the
    extras: ``encoder_seq`` stub frames a request, the last request's
    later half masked by ``frames_mask``."""
    from repro_torch.models import frontend as FE
    B, M = SEAMLESS_BATCH, cfg.encoder_seq
    frames = FE.audio_frames(gen, B, M, cfg.d_model, torch.bfloat16, "cuda")
    fmask = torch.ones((B, M), dtype=torch.int32, device="cuda")
    fmask[-1, M // 2:] = 0
    tokens = torch.randint(2, cfg.vocab, (B, SEAMLESS_PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    return tokens, {"frames": frames, "frames_mask": fmask}


def vlm_requests(vocab):
    """8 text-only prompts of 64-512 tokens (eight lengths: eight
    exact-length prefill groups), 32 new tokens each."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(23)
    return [Request(rid=i, prompt=rng.integers(2, vocab, n).tolist(),
                    max_new_tokens=VLM_NEW) for i, n in enumerate(VLM_LENS)]


def phase_vlm(card):
    """Llama-3.2-Vision 90B at full width (d 8,192; 64 / 8 heads, the kv
    heads duplicated to 16: the kernels at group 4, head dim 128; d_ff
    28,672; vocab 128,256; 1,600 image tokens) and depth 10 (two units
    of (dense x 4, cross): 10,825,670,660 parameters, 21.65 GB), random
    weights from a seed and both gates of each cross layer set to
    ``VLM_GATE`` (the reference's zero gates would multiply the
    cross-attention away), the earlier models freed first.

    The image path, at the model level: a prefill of ``VLM_BATCH`` x
    ``VLM_PROMPT`` tokens over the port's stub image embeddings, flash 8
    and RMSNorm 21 launches; ``VLM_STEPS`` greedy decode steps, decode 8
    and RMSNorm 21 a step, then again through ``checked_decode``;
    ``memory_probe`` (each kernel call against its plain version, the
    logits against a float32 referee); the same prefill again
    (bit-identical) and without images (other logits). The engine
    path: ``vlm_requests`` served text-only on the contiguous engine
    (exact-length prefill groups, the cross layers over their zeroed
    caches, as the reference's engine serves a VLM), three times with the
    same tokens, the third through ``checked_run``; flash 8 a prefill launch, decode 8 a micro-step, RMSNorm 21 a
    forward, no query row at position -1 (no pad row reaches the
    kernels), the host's waits equal to ``host_syncs``. Returns the engine
    path's launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import frontend as FE
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = vlm_cut()
    assert cfg.block_pattern == (("dense",) * 4 + ("cross",)) * 2
    norms = memory_norms(cfg)
    model, params, gen, weights = load_model(cfg, VLM_PARAMS, "vlm", card)
    set_gates(params)
    B, S, M = VLM_BATCH, VLM_PROMPT, cfg.n_image_tokens
    tokens = torch.randint(2, cfg.vocab, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    images = FE.vision_embeddings(gen, B, M, cfg.d_model, torch.bfloat16,
                                  "cuda")
    extras = {"image_embeds": images}
    max_len = S + VLM_STEPS
    logits, caches, checked_caches, pre, pre_ms, pre_peak = memory_probe(
        card, "vlm", model, params, tokens, extras, max_len)
    label = f"{VLM} depth {N_VLM} image path"
    kv_shape = (B, M, cfg.n_kv_heads_padded, cfg.head_dim_)
    expect(label, [
        (pre["flash_attention"] == VLM_ATTN and pre["rmsnorm"] == norms
         and sum(pre.values()) == VLM_ATTN + norms,
         f"prefill launches {pre}, not flash {VLM_ATTN} and rmsnorm "
         f"{norms}"),
        (all(tuple(c["k"].shape) == kv_shape and c["k"].any()
             for c, kind in zip(caches["layers"], cfg.block_pattern)
             if kind == "cross"),
         f"a cross cache is not the images' {kv_shape} keys")])
    toks, finite, dec, dec_s = greedy_decode(model, params, caches, logits,
                                             VLM_STEPS)
    expect(label, [
        (bool(finite), "non-finite decode logits"),
        (dec["decode_attention"] == VLM_ATTN * VLM_STEPS
         and dec["rmsnorm"] == norms * VLM_STEPS
         and sum(dec.values()) == (VLM_ATTN + norms) * VLM_STEPS,
         f"decode launches {dec}, not decode {VLM_ATTN} and rmsnorm "
         f"{norms} a step"),
        (bool(((toks >= 0) & (toks < cfg.vocab)).all()),
         "a token out of vocab")])
    peak = torch.cuda.max_memory_allocated()
    calls = checked_decode(label, model, params, checked_caches, logits, toks)
    del checked_caches
    print(f"  {VLM_STEPS} decode steps again, each kernel call against its "
          f"plain version (B {B}, W {max_len}): {calls}; the same tokens "
          f"({card})")
    # the images' effect: the kernels are deterministic (a second prefill
    # gives the same bits), so any difference from the text-only prefill
    # of the same tokens comes from the images through the gated cross
    # layers (with the reference's zero gates there is none)
    again, _ = model.prefill(params, tokens, max_len=max_len, extras=extras)
    text, _ = model.prefill(params, tokens, max_len=max_len)
    moved = float((text - logits).abs().max())
    print(f"  launches: prefill {pre}, {VLM_STEPS} decode steps {dec}; "
          f"decode {B * VLM_STEPS / dec_s:.1f} tokens/s "
          f"({dec_s * 1e3 / VLM_STEPS:.2f} ms a step at batch {B}), prefill "
          f"{B * S / pre_ms * 1e3:.1f} tokens/s ({card})")
    print(f"  images matter: the same prefill again is bit-identical "
          f"{torch.equal(again, logits)}; text-only logits max abs diff "
          f"{moved:.4e}, {int((text != logits).sum())} of {text.numel()} "
          "differ")
    kv_bytes = 2 * VLM_ATTN * B * max_len * cfg.n_kv_heads_padded \
        * cfg.head_dim_ * 2
    img_bytes = 2 * 2 * B * M * cfg.n_kv_heads_padded * cfg.head_dim_ * 2
    print(f"  peak {pre_peak / 1e9:.2f} GB allocated in the prefill, "
          f"{peak / 1e9:.2f} GB in the decode steps, against the reckoning: "
          f"weights {weights / 1e9:.2f} GB + self-attention KV "
          f"{kv_bytes / 1e9:.3f} GB + image KV {img_bytes / 1e9:.3f} GB "
          f"({card})")
    if not torch.equal(again, logits) or moved == 0.0:
        raise AssertionError(f"{label}: a repeated prefill changed the "
                             "logits, or the images did not")
    del logits, caches, text, again
    # the engine path, text-only
    ecfg = EngineConfig(max_batch=8, max_len=VLM_MAX_LEN, profile="h100_sxm",
                        region="QC")

    def run_engine():
        eng = ServingEngine(model, params, ecfg)
        for r in vlm_requests(cfg.vocab):
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        return eng

    warm = ServingEngine(model, params, ecfg)          # not counted
    warm.submit(Request(rid=0, prompt=list(range(2, 40)), max_new_tokens=4))
    warm.run()
    del warm
    pads = []

    def no_pad_rows(name, flash, plain):
        def run(q, k, v, q_pos, *a, **kw):
            pads.append(bool((q_pos < 0).any()))   # a host read, this run
            return flash(q, k, v, q_pos, *a, **kw)
        return run

    label = f"{VLM} depth {N_VLM} contiguous"
    with ops.swapped(no_pad_rows, ("flash_attention",)):
        engine, st, counts = serve(card, label, ecfg,
                                   vlm_requests(cfg.vocab), model, params,
                                   new_tokens=VLM_NEW)
    pb = engine.prefill_batches
    expect(label, [
        (pb == len(VLM_LENS), f"{pb} prefill launches, not one a length "
         "(exact-length groups)"),
        (counts["flash_attention"] == VLM_ATTN * pb,
         f"flash launches {counts['flash_attention']} != {VLM_ATTN} x {pb}"),
        (counts["decode_attention"] >= VLM_ATTN * st["steps"]
         and counts["decode_attention"] % VLM_ATTN == 0,
         f"decode launches {counts['decode_attention']} vs {VLM_ATTN} x "
         f"{st['steps']} micro-steps"),
        (counts["rmsnorm"] == norms * (
            pb + counts["decode_attention"] // VLM_ATTN),
         f"rmsnorm launches {counts['rmsnorm']} != {norms} a forward"),
        (counts["paged_decode_attention"] == 0
         and counts["chunked_prefill_attention"] == 0,
         f"paged kernels ran on the contiguous path: {counts}"),
        (len(pads) == counts["flash_attention"] and not any(pads),
         f"{sum(pads)} of {len(pads)} flash calls had a query at -1"),
    ])
    tokens_1 = {r: list(engine.responses[r].tokens)
                for r in engine.responses}
    cache = sum(t.numel() * t.element_size()
                for c in engine.caches["layers"] for t in c.values())
    print(f"  no query row at -1 in {len(pads)} flash calls; engine caches "
          f"{cache / 1e9:.3f} GB (8 slots: {VLM_ATTN} rings of "
          f"{VLM_MAX_LEN} rows and 2 zeroed image caches of {M} rows) "
          f"({card})")
    del engine

    def tokens_of(eng):
        return {r: list(eng.responses[r].tokens) for r in eng.responses}

    engine, waits = count_waits(run_engine)
    if tokens_of(engine) != tokens_1:
        raise AssertionError(f"{label}: a second run gave other tokens")
    if waits != engine.host_syncs:
        raise AssertionError(f"{label}: the host waited {waits} times, "
                             f"host_syncs {engine.host_syncs}")
    print(f"  a second run: the same tokens; host waits for the device "
          f"(sync debug mode) {waits} = host_syncs {engine.host_syncs}")
    del engine
    # a third run, each kernel call against its plain version at the
    # engine's shapes (B1 prefills of each length, decode at B8 W576)
    engine, calls = checked_run(f"{label} checked", run_engine)
    if tokens_of(engine) != tokens_1:
        raise AssertionError(f"{label}: the checked run gave other tokens")
    print(f"  a third run, each kernel call against its plain version: "
          f"{calls}; the same tokens ({card})")
    del engine
    model = params = None
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_seamless(card):
    """SeamlessM4T-Large v2 in full (24 ``enc`` layers over 4,096 stub
    audio frames, 24 ``dec`` layers; d 1,024, 16 / 16 heads of 64, d_ff
    8,192, vocab 256,206 padded to 256,256; 2,034,886,656 parameters),
    random weights from a seed, at the model level (neither engine serves
    an encoder-decoder): ``SEAMLESS_BATCH`` requests of 4,096 frames, the
    last with its later half masked by ``frames_mask``, under a
    ``SEAMLESS_PROMPT``-token decoder prompt; the prefill (flash 24,
    RMSNorm 122: 48 encoder, ``enc_norm``, 72 decoder, the final) through
    ``memory_probe``, then ``SEAMLESS_STEPS`` greedy decode
    steps (decode 24 and RMSNorm 73 a step, no encoder, no host wait),
    again through ``checked_decode``, and
    the same prefill without the mask (the unmasked rows unchanged, the
    masked row's logits moved). Returns the launches of the prefill and
    the decode steps."""
    from repro_torch.configs import get_config
    cfg = get_config(SEAMLESS)
    L = cfg.n_layers
    assert cfg.block_pattern == ("dec",) * 24 and cfg.n_encoder_layers == 24
    model, params, gen, weights = load_model(cfg, SEAMLESS_PARAMS,
                                             "seamless", card)
    B, S, M = SEAMLESS_BATCH, SEAMLESS_PROMPT, cfg.encoder_seq
    tokens, extras = seamless_inputs(cfg, gen)
    max_len = S + SEAMLESS_STEPS
    logits, caches, checked_caches, pre, pre_ms, peak = memory_probe(
        card, "seamless", model, params, tokens, extras, max_len)
    label = f"{SEAMLESS} prefill"
    norms = memory_norms(cfg)
    expect(label, [
        (pre["flash_attention"] == L
         and pre["rmsnorm"] == encoder_norms(cfg) + norms
         and sum(pre.values()) == L + encoder_norms(cfg) + norms,
         f"prefill launches {pre}, not flash {L} and rmsnorm "
         f"{encoder_norms(cfg) + norms}"),
        (all(tuple(c["xk"].shape) == (B, M, cfg.n_kv_heads_padded,
                                      cfg.head_dim_)
             for c in caches["layers"]),
         "an xk cache is not the encoder output's")])
    (toks, finite, dec, dec_s), waits = count_waits(
        lambda: greedy_decode(model, params, caches, logits, SEAMLESS_STEPS))
    expect(f"{SEAMLESS} decode", [
        (bool(finite), "non-finite decode logits"),
        (dec["decode_attention"] == L * SEAMLESS_STEPS
         and dec["rmsnorm"] == norms * SEAMLESS_STEPS
         and sum(dec.values()) == (L + norms) * SEAMLESS_STEPS,
         f"decode launches {dec}, not decode {L} and rmsnorm {norms} a "
         "step"),
        (waits == 0, f"the host waited {waits} times in the decode loop"),
        (bool(((toks >= 0) & (toks < cfg.vocab)).all()),
         "a token out of vocab")])
    calls = checked_decode(f"{SEAMLESS} decode", model, params,
                           checked_caches, logits, toks)
    del checked_caches
    print(f"  {SEAMLESS_STEPS} decode steps again, each kernel call against "
          f"its plain version (B {B}, W {max_len}): {calls}; the same tokens "
          f"({card})")
    whole, _ = model.prefill(params, tokens, max_len=max_len,
                             extras={"frames": extras["frames"]})
    atol, rtol = TOL[torch.bfloat16]
    rows = torch.zeros_like(whole, dtype=torch.bool)
    rows[:-1] = True
    same, bad = past_tol(whole, logits, rows, atol, rtol)
    moved, differ = past_tol(whole, logits, ~rows, atol, rtol)
    enc_scores = B * cfg.n_heads_padded * M * M * 4
    print(f"  launches: prefill {pre}, {SEAMLESS_STEPS} decode steps {dec}; "
          f"host waits in the decode loop {waits}; decode "
          f"{B * SEAMLESS_STEPS / dec_s:.1f} tokens/s "
          f"({dec_s * 1e3 / SEAMLESS_STEPS:.2f} ms a step at batch {B}), "
          f"prefill {pre_ms:.1f} ms for {B} x {M} frames + {B} x {S} tokens "
          f"({card})")
    print(f"  frames_mask: unmasked rows max abs diff {same:.4e} ({bad} past "
          f"tol), the masked row's {moved:.4e} ({differ} past tol)")
    print(f"  peak {peak / 1e9:.2f} GB allocated in the prefill against the "
          f"reckoning: weights {weights / 1e9:.2f} GB + one encoder layer's "
          f"float32 scores {enc_scores / 1e9:.2f} GB ({B} x "
          f"{cfg.n_heads_padded} heads x {M} x {M}; the direct attention "
          f"holds several such at once) ({card})")
    if bad or not differ:
        raise AssertionError(f"{SEAMLESS}: frames_mask moved the unmasked "
                             f"rows ({bad}) or not the masked one "
                             f"({differ})")
    model = params = caches = None
    gc.collect()
    torch.cuda.empty_cache()
    return {k: pre[k] + dec[k] for k in pre}


# --------------------------------------------------------------------------
# training: llama-paper-1b at full width and depth through the Trainer, the
# flash and RMSNorm kernels under autograd (kernels/autograd.py)
# --------------------------------------------------------------------------


def train_work(B, H, S, hd, rows, d):
    """(forward, backward) of causal attention at (B, H, S, hd) bf16 and of
    the RMSNorm backward over (rows, d) bf16, each (flops, bytes): the
    valid pairs' 4 hd operations a pair forward, 10 hd backward (the
    scores again, dP, dV, dQ, dK); bytes of each input read once and each
    output written once (the forward's output and float32 lse; the
    backward's q, k, v, dO, lse in and dq, dk, dv out)."""
    pairs = B * H * S * (S + 1) / 2
    t = B * H * S * hd * 2
    lse = B * H * S * 4
    return {"flash_fwd": (4 * hd * pairs, 4 * t + lse),
            "attn_bwd": (10 * hd * pairs, 7 * t + lse),
            "norm_bwd": (6 * rows * d, 3 * rows * d * 2 + 2 * d * 2),
            "add_norm_bwd": (7 * rows * d, 5 * rows * d * 2 + 2 * d * 2)}


def train_kernels(card):
    """The train step's kernel work at its shape (B4 H32 S1024 hd 64, bf16,
    causal; the norms over its 4,096 rows of 2,048): the flash forward
    with and without lse (graph replay), the attention backward
    (``autograd.flash_backward``, eager) and the RMSNorm and add+RMSNorm
    backward, each beside its bound, the plain version (autograd of
    ``kernels/ref.py``, forward + backward) and the library: SDPA's and
    ``F.rms_norm``'s forward + backward. The forward with lse holds the
    output bit for bit to the call without it. Returns the numbers."""
    import torch.nn.functional as F
    from repro_torch.kernels import autograd as AG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as REF
    B, H, S, hd, d = TRAIN_BATCH, 32, TRAIN_SEQ, 64, 2048
    R = B * S
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)

    q, k, v = (rnd(B, S, H, hd).transpose(1, 2) for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    out = FA.flash_attention(q, k, v, pos, pos, lse=lse)
    if not torch.equal(out, FA.flash_attention(q, k, v, pos, pos)):
        raise AssertionError("flash with lse gave another output")
    dout = rnd(B, H, S, hd)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd(fn, *args):
        def run():
            for t in leaves:
                t.grad = None
            fn(*leaves, *args).backward(dout)
        return run

    x, delta, dy, ds = (rnd(R, d) for _ in range(4))
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(bf)
    nleaves = [t.detach().clone().requires_grad_(True)
               for t in (x, delta, scale)]

    def norm_fwd_bwd(fn):
        def run():
            for t in nleaves:
                t.grad = None
            fn(nleaves[0], nleaves[2]).backward(dy)
        return run

    s_add = x + delta
    ms = {
        "flash_fwd": time_ms(lambda: FA.flash_attention(
            q, k, v, pos, pos, lse=lse), graph=True),
        "flash_fwd_nolse": time_ms(lambda: FA.flash_attention(
            q, k, v, pos, pos), graph=True),
        "attn_bwd": time_ms(lambda: AG.flash_backward(
            q, k, v, lse, dout, pos, pos, None, None)),
        "norm_bwd": time_ms(lambda: AG.rmsnorm_backward(x, scale, dy, 1e-5)),
        "add_norm_bwd": time_ms(lambda: AG.rmsnorm_backward(
            s_add, scale, dy, 1e-5)[0] + ds.float()),
    }
    kernel = {
        "attention fwd+bwd": time_ms(fwd_bwd(
            lambda *a: AG.FlashAttention.apply(*a, None, None), pos, pos)),
        "rmsnorm fwd+bwd": time_ms(norm_fwd_bwd(
            lambda a, sc: AG.RMSNorm.apply(a, sc, 1e-5))),
    }
    plain = {
        "flash_fwd": time_ms(lambda: REF.flash_attention(q, k, v, pos,
                                                         pos)),
        "attention fwd+bwd": time_ms(fwd_bwd(REF.flash_attention, pos,
                                             pos)),
        "rmsnorm fwd+bwd": time_ms(norm_fwd_bwd(
            lambda a, sc: REF.rmsnorm(a, sc, 1e-5))),
    }
    library = {
        "flash_fwd": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "attention fwd+bwd": time_ms(fwd_bwd(
            lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True))),
        "rmsnorm fwd+bwd": time_ms(norm_fwd_bwd(
            lambda a, sc: F.rms_norm(a, (d,), sc, 1e-5))),
    }
    work = train_work(B, H, S, hd, R, d)
    bounds = {n: bound_ms(f, b, bf) for n, (f, b) in work.items()}
    bounds["attention fwd+bwd"] = bound_ms(
        work["flash_fwd"][0] + work["attn_bwd"][0],
        work["flash_fwd"][1] + work["attn_bwd"][1], bf)
    print(f"\n[train kernels] B{B} H{H} S{S} hd {hd} causal bf16; norms "
          f"({R}, {d}) bf16 ({card})")
    print(f"  flash forward with lse {ms['flash_fwd']:.4f} ms (without "
          f"{ms['flash_fwd_nolse']:.4f}; bound {bounds['flash_fwd'][0]:.4f} "
          f"{bounds['flash_fwd'][1]}; plain {plain['flash_fwd']:.4f}; SDPA "
          f"{library['flash_fwd']:.4f}); output bit-identical with and "
          f"without lse")
    print(f"  attention backward {ms['attn_bwd']:.4f} ms (float32 "
          f"torch.matmul; bound {bounds['attn_bwd'][0]:.4f} "
          f"{bounds['attn_bwd'][1]} at the bf16 tensor cores' rate)")
    print(f"  attention forward + backward: kernel Function "
          f"{kernel['attention fwd+bwd']:.4f} ms, plain "
          f"{plain['attention fwd+bwd']:.4f}, SDPA "
          f"{library['attention fwd+bwd']:.4f}, bound "
          f"{bounds['attention fwd+bwd'][0]:.4f} "
          f"{bounds['attention fwd+bwd'][1]}")
    print(f"  RMSNorm backward {ms['norm_bwd']:.4f} ms (bound "
          f"{bounds['norm_bwd'][0]:.4f} {bounds['norm_bwd'][1]}), add + "
          f"RMSNorm backward {ms['add_norm_bwd']:.4f} ms (bound "
          f"{bounds['add_norm_bwd'][0]:.4f} {bounds['add_norm_bwd'][1]}); "
          f"forward + backward: kernel Function "
          f"{kernel['rmsnorm fwd+bwd']:.4f} ms, plain "
          f"{plain['rmsnorm fwd+bwd']:.4f}, F.rms_norm "
          f"{library['rmsnorm fwd+bwd']:.4f}")
    for key, value in list(ms.items()) + list(kernel.items()):
        if not math.isfinite(value):
            raise AssertionError(f"train kernels: {key} not finite")
    return {"ms": ms, "kernel": kernel, "plain": plain, "library": library,
            "bound": bounds}


def counted_step(model, params, batch, remat):
    """One train_loss and backward with the launch counts set to 0 just
    before: (forward launches, backward launches); the gradients dropped."""
    from repro_torch.kernels import ops
    from repro_torch.training.optim import unique_leaves
    torch.cuda.synchronize()
    ops.reset_launches()
    loss, _ = model.train_loss(params, batch, remat=remat)
    fwd = ops.launch_counts()
    loss.backward()
    torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in ops.launch_counts().items()}
    for _, p in unique_leaves(params):
        p.grad = None
    return fwd, bwd


def train_grads(model, params, batch):
    """(loss, [(path, float32 gradient)]) of one ``train_loss``, every
    leaf's gradient present or it fails."""
    from repro_torch.training.optim import unique_leaves
    leaves = list(unique_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss, _ = model.train_loss(params, batch, remat=False)
    loss.backward()
    out = []
    for path, p in leaves:
        if p.grad is None:
            raise AssertionError(f"{'/'.join(path)}: no gradient")
        out.append(("/".join(path), p.grad.float()))
        p.grad = None
        p.requires_grad_(False)
    return float(loss.detach()), out


def train_probe(card, cfg, batch, depth=TRAIN_PROBE_DEPTH,
                n_params=TRAIN_PROBE_PARAMS, want=None):
    """The gradient probe: ``cfg`` cut to ``depth`` at full width, one
    batch; every gradient leaf of the bf16 kernel path (the kernels under
    autograd) and of the plain bf16 path against the float32 referee (the
    plain versions on float32 weights, on the card). The kernel path's
    relative error (norm of the difference over the referee's norm) must
    be at most ``REFEREE`` times the plain bf16 path's, leaf by leaf; its
    launches must be ``want`` (by default a dense model's: flash ``depth``,
    RMSNorm 2 ``depth`` + 1, no other). Returns the worst ratio."""
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    cut = dataclasses.replace(cfg, n_layers=depth,
                              block_pattern=cfg.block_pattern[:depth])
    model, params, _, _ = load_model(cut, n_params, "train probe", card)
    ops.reset_launches()
    loss_k, kern = train_grads(model, params, batch)
    launches = ops.launch_counts()
    if want is None:
        want = {"flash_attention": depth, "rmsnorm": 2 * depth + 1}
    expect("train probe", [
        (launches == {k: want.get(k, 0) for k in launches},
         f"kernel path launches {launches}, want {want}")])
    with plain_ops():
        loss_p, plain = train_grads(model, params, batch)

    def up(t):
        if isinstance(t, dict):
            return {k: up(v) for k, v in t.items()}
        if isinstance(t, list):
            return [up(v) for v in t]
        return t.float()

    ref = Model(dataclasses.replace(cut, dtype="float32"), "cuda")
    with plain_ops():
        loss_t, truth = train_grads(ref, up(params), batch)
    print(f"\n[train probe] {cut.name} depth {cut.n_layers}, batch "
          f"{tuple(batch['tokens'].shape)}: loss kernels {loss_k:.6f}, plain "
          f"bf16 {loss_p:.6f}, float32 {loss_t:.6f}; each gradient leaf's "
          f"relative error from float32 (kernels / plain bf16 / ratio) "
          f"({card})")
    worst, bad = 0.0, []
    for (path, gk), (_, gp), (_, gt) in zip(kern, plain, truth):
        norm = float(gt.norm())
        rk = float((gk - gt).norm()) / max(norm, 1e-30)
        rp = float((gp - gt).norm()) / max(norm, 1e-30)
        ratio = rk / max(rp, 1e-30)
        worst = max(worst, ratio)
        print(f"  {path:32s} {rk:.4e} / {rp:.4e} / {ratio:.4f}")
        if not (math.isfinite(rk) and rk <= REFEREE * rp):
            bad.append(path)
    print(f"  worst ratio {worst:.4f} (bound {REFEREE})")
    expect("train probe", [
        (not bad, f"gradient leaves past {REFEREE} x the plain bf16 path's "
                  f"relative error: {bad}")])
    model = params = ref = None
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def fit_on_card(card, tag, what, model, params, n_params, steps, extra):
    """``Trainer.fit`` of ``model`` for ``steps`` steps (WSD, warmup
    ``TRAIN_WARMUP``, AdamW ``TRAIN_LR``, ``profile="h100_sxm"``,
    ``region="CISO"``, remat off; ``what`` names the cut) on
    ``lm_batches`` of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ``, the launch counts set to 0 just before: prints each
    step's loss, grad norm and lr, tokens/s of steps 2 on, peak memory, the
    launches, the modeled J and gCO2 a step and the card's measured J over
    the fit (``chiprun_out/power_<tag>.csv``). Returns (trainer, the
    ``steps + extra`` batches, history, launches, peak bytes, tokens/s)."""
    from repro_torch.core.power_trace import ActiveWindow, PowerTrace
    from repro_torch.kernels import ops
    from repro_torch.training import AdamWConfig, TrainConfig, Trainer
    from repro_torch.training.data import lm_batches
    cfg = model.cfg
    tcfg = TrainConfig(steps=steps, log_every=1, warmup=TRAIN_WARMUP,
                       schedule="wsd", optim=AdamWConfig(lr=TRAIN_LR),
                       profile="h100_sxm", region="CISO")
    trainer = Trainer(model, tcfg, device="cuda", params=params)
    stream = lm_batches(0, cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                        TRAIN_BRANCHING)
    data = [next(stream) for _ in range(steps + extra)]
    sampler = PowerSampler(power_field())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    hist = trainer.fit(iter(data[:steps]), verbose=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rows = sampler.stop()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"\n[{tag}] {cfg.name} {what} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n_params} parameters), Trainer.fit: "
          f"{steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamW "
          f"lr {TRAIN_LR} WSD warmup {TRAIN_WARMUP}, remat off ({card})")
    for r in hist:
        print(f"  step {r['step']}: loss {r['loss']:.6f} grad_norm "
              f"{r['grad_norm']:.6f} lr {r['lr']:.6e} clip {r['clip']:.4f} "
              f"wall {r['wall_s']:.3f} s")
    steady = hist[-1]["wall_s"] - hist[0]["wall_s"]
    tps = tokens * (len(hist) - 1) / steady
    st = trainer.meter.totals
    print(f"  steps 2-{steps}: {tps:.1f} tokens/s "
          f"({steady / (len(hist) - 1) * 1e3:.1f} ms a step); step 1 "
          f"{hist[0]['wall_s'] * 1e3:.1f} ms; peak {peak / 1e9:.2f} GB "
          f"allocated ({card})")
    print(f"  launches over the fit: {launches}")
    print(f"  modeled (h100_sxm @ CISO): {st.energy_j / st.steps:.2f} J and "
          f"{st.total_g / st.steps:.6f} gCO2 a step")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", f"power_{tag}.csv")
    write_power_csv(path, rows)
    trace = PowerTrace.from_csv(path)
    window = ActiveWindow(t0, t1)
    inside = [w for t, w in zip(trace.t_s, trace.watts)
              if window.contains(t)]
    if len(inside) < POWER_MIN:
        raise AssertionError(f"{tag}: {len(inside)} power samples in the "
                             f"{t1 - t0:.3f} s fit (< {POWER_MIN})")
    joules = trace.energy_j(window)
    print(f"  measured power ({card}): {sampler.field} every {POWER_MS} ms, "
          f"{len(inside)} samples over the {t1 - t0:.3f} s fit, mean "
          f"{sum(inside) / len(inside):.1f} W, measured {joules:.1f} J "
          f"({joules / steps:.1f} J a step; modeled "
          f"{st.energy_j / st.steps:.2f}; measured / modeled "
          f"{joules / st.energy_j:.3f}) (CSV {os.path.relpath(path, ROOT)})")
    return trainer, data, hist, launches, peak, tps


def phase_train(card):
    """``llama-paper-1b`` at full width and depth trained for
    ``TRAIN_STEPS`` steps through ``Trainer.fit`` (WSD, warmup
    ``TRAIN_WARMUP``, ``profile="h100_sxm"``, ``region="CISO"``) on
    ``lm_batches`` of ``TRAIN_BATCH`` x ``TRAIN_SEQ``: each step's loss,
    grad norm and lr, tokens/s of steps 2-8, peak memory, the launches
    (22 flash, 45 RMSNorm a step), the modeled J and gCO2 a step and the
    card's measured J over the steps; one more step counted with its
    backward apart, without and with remat (the backward recomputes each
    layer: 22 flash, 44 RMSNorm); then the gradient probe. Fails on a
    non-finite loss, step 8's loss not below step 1's, or the probe.
    Returns the kernel numbers and the fit's launches."""
    from repro_torch.configs import get_config
    numbers = train_kernels(card)
    cfg = get_config(TRAIN)
    assert cfg.n_layers == N_LAYERS and cfg.dtype == "bfloat16"
    model, params, _, _ = load_model(cfg, TRAIN_PARAMS, "train", card)
    trainer, data, hist, launches, peak, tps = fit_on_card(
        card, "train", "full", model, params, TRAIN_PARAMS, TRAIN_STEPS,
        extra=3)
    counted = {}
    for i, remat in enumerate((False, True)):
        batch = trainer.device_batch(data[TRAIN_STEPS + i])
        counted[remat] = counted_step(model, trainer.params, batch, remat)
        print(f"  one step, remat {'on' if remat else 'off'}: forward "
              f"launches {counted[remat][0]}, backward {counted[remat][1]}")
    L = cfg.n_layers
    none = {k: 0 for k in launches}
    want = dict(none, flash_attention=L, rmsnorm=2 * L + 1)
    losses = [r["loss"] for r in hist]
    expect("train", [
        (len(hist) == TRAIN_STEPS, f"{len(hist)} logged steps"),
        (all(math.isfinite(x) for x in losses), f"losses {losses}"),
        (losses[-1] < losses[0],
         f"step {TRAIN_STEPS}'s loss {losses[-1]} not below step 1's "
         f"{losses[0]}"),
        (launches == {k: TRAIN_STEPS * v for k, v in want.items()},
         f"launches over the fit {launches}"),
        (counted[False] == (want, none), f"one step {counted[False]}"),
        # the backward recomputes each layer (its norms, not the final)
        (counted[True] == (want, dict(none, flash_attention=L,
                                      rmsnorm=2 * L)),
         f"one remat step {counted[True]}"),
    ])
    probe_batch = trainer.device_batch(data[TRAIN_STEPS + 2])
    trainer = model = params = None
    gc.collect()
    torch.cuda.empty_cache()
    numbers["probe_worst"] = train_probe(card, cfg, probe_batch)
    numbers.update(tokens_per_s=tps, peak_gb=peak / 1e9, launches=launches)
    return numbers


# --------------------------------------------------------------------------
# training the recurrent families: rwkv6-1.6b in full and zamba2-7b at full
# width cut to depth 24, through the SSD chunk, WKV6 and the concat and gate
# RMSNorms under autograd (kernels/autograd.py)
# --------------------------------------------------------------------------

RWKV = "rwkv6-1.6b"
RWKV_TRAIN_PARAMS = 1_599_866_880        # costing.param_counts, full
RWKV_PROBE_DEPTH, RWKV_PROBE_PARAMS = 2, 379_389_952
ZAMBA = "zamba2-7b"
# four units of (5 mamba2, shared) at full width: its full 81 layers hold
# 70.5 GB of parameters, gradients and float32 AdamW moments alone; at
# depth 24 the dry-run's train-step arguments and the gradients are 25.6
# GB, and the step's peak must keep TRAIN_HEADROOM under the card's 80 GB
N_ZAMBA_TRAIN = 24
ZAMBA_TRAIN_PARAMS = 2_135_771_712       # costing.param_counts at depth 24
ZAMBA_PROBE_DEPTH, ZAMBA_PROBE_PARAMS = 6, 966_100_752   # one unit
RECURRENT_STEPS = 16
CARD_BYTES, TRAIN_HEADROOM = 80e9, 8e9


def zamba_train_cut():
    """``zamba2-7b`` at full width, its first ``N_ZAMBA_TRAIN`` layers."""
    from repro_torch.configs import get_config
    cfg = get_config(ZAMBA)
    return dataclasses.replace(cfg, n_layers=N_ZAMBA_TRAIN,
                               block_pattern=cfg.block_pattern[
                                   :N_ZAMBA_TRAIN])


def recurrent_launches(cfg) -> dict:
    """Kernel launches of one train forward of a recurrent model: a
    mamba2 layer's SSD chunk and two norms (ln1 and the gate), a shared
    site's flash and two concat norms, an rwkv6 layer's WKV6 (its norms
    are LayerNorms), and the final norm."""
    kinds = cfg.block_pattern
    m, s, r = (kinds.count(k) for k in ("mamba2", "shared", "rwkv6"))
    return {"ssd_chunk": m, "wkv6": r, "flash_attention": s,
            "rmsnorm": 2 * m + 2 * s + 1}


def ssd_train_work(x, dt, A, Bm, Cm) -> tuple:
    """(operations, bytes, peak) of the SSD chunk's forward and backward:
    the forward's (``ssd_work``), then the backward's products over the
    causal pairs (C Bᵀ again, dy xdtᵀ, Mᵀ dy, (dM ∘ W) B and (dM ∘ W)ᵀ C:
    2 (3 N + 2 P) a pair) and h's (B dhᵀ and xdt dh: 4 P N a step); bytes
    of the backward's inputs (x, dt, A, one B/C group and the three
    outputs' gradients) read once and its outputs (their gradients)
    written once."""
    flops, nbytes, peak = ssd_work(x, dt, A, Bm, Cm)
    B, H, nc, cl, P = x.shape
    N = Bm.shape[-1]
    pairs = B * H * nc * cl * (cl + 1) / 2
    flops += 2.0 * pairs * (3 * N + 2 * P) + 4.0 * B * H * nc * cl * P * N
    ins = ((x.numel() + dt.numel() + 2 * B * nc * cl * N) * x.element_size()
           + A.numel() * 4)
    nbytes += 2 * ins + B * H * nc * (cl * P + P * N + 1) * 4
    return flops, nbytes, peak


def wkv6_train_work(r, k, v, w, u, s0) -> tuple:
    """(operations, bytes) of WKV6's forward (``wkv6_work``) and backward:
    14 hd^2 float32 operations a step (the states again, w ∘ S + k vᵀ, and
    the gradient's walk, w ∘ G + r doᵀ, 3 each; dr = S do, dk = G v, dv =
    Gᵀ k and dw = rowsum(G ∘ S), 2 each); bytes of r/k/v/w/u/s0 and dout
    read once and dr/dk/dv/dw/du written once (no ds0: training keeps no
    state)."""
    flops, nbytes = wkv6_work(r, k, v, w, u, s0)
    B, H, T, hd = r.shape
    flops += 14.0 * B * H * T * hd * hd
    grads = 3 * r.numel() * r.element_size() + w.numel() * w.element_size() \
        + 4 * u.numel()
    nbytes += 2 * grads + 4 * s0.numel() + 4 * r.numel()
    return flops, nbytes


def grads_of(fn, leaves, cotangents):
    """``fn(*leaves)``'s outputs and the leaves' gradients (None where a
    leaf takes none) against ``cotangents`` (None: that output takes
    none)."""
    for t in leaves:
        t.grad = None
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(
        [o for o, c in zip(out, cotangents) if c is not None],
        [c for c in cotangents if c is not None])
    return out, [t.grad for t in leaves]


def function_case(label, function, bare, plain, leaves, cotangents,
                  scan, work, dtype, peak=None):
    """One Function at a train step's shape: its forward bit-identical to
    the bare kernel on the same inputs; each input's gradient against
    autograd of the plain version (bf16 gradients at ``TOL[bf16]``;
    float32 ones at ``TOL_WIDE``, or where ``scan`` at ``WKV_REL``
    relative and absolute against the gradient's largest magnitude, as
    phase 3 holds WKV6's outputs: a scan's float32 gradients are sums
    over the sequence of terms that cancel (SSD's ddt and dA a reverse
    cumulative sum, WKV6's dw a row of G ∘ S), where two float32 orders
    differ by ~1e-7 of the largest term);
    forward + backward ms of both beside the bound of ``work`` (operations,
    bytes) at ``dtype``'s rate (or ``peak``). Prints a line; returns the
    numbers."""
    with torch.no_grad():
        want_out = bare(*leaves)
    got_out, got = grads_of(function, leaves, cotangents)
    same = all(torch.equal(g, w) for g, w in
               zip(got_out, want_out if isinstance(want_out, tuple)
                   else (want_out,)))
    _, want = grads_of(plain, leaves, cotangents)
    errs, bad = [], []
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            if g is not None:
                bad.append(f"input {i}: a gradient the plain version lacks")
            continue
        big = max(1.0, float(w.float().abs().max()))
        tol = (TOL[torch.bfloat16] if g.dtype == torch.bfloat16 else
               (WKV_REL * big, WKV_REL) if scan else TOL_WIDE)
        finite = bool(torch.isfinite(g.float()).all())
        err, past = past_tol(g, w, torch.ones_like(w, dtype=torch.bool),
                             *tol)
        errs.append(f"d{i} {err:.3e} (|max| {big:.3e}, {past} past "
                    f"({tol[0]:.3g}, {tol[1]:.3g}))")
        if past or not finite or g.dtype != leaves[i].dtype:
            bad.append(f"input {i}: {past} past {tol}, finite {finite}, "
                       f"{g.dtype}")
    ms = time_ms(lambda: grads_of(function, leaves, cotangents), warmup=1,
                 iters=3)
    plain_ms = time_ms(lambda: grads_of(plain, leaves, cotangents),
                       warmup=1, iters=3)
    bms, by = bound_ms(*work, dtype, peak)
    print(f"  {label}: forward bit-identical to the bare kernel {same}; "
          f"forward + backward {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}, {ms / bms:.1f}x); max abs err of each "
          f"gradient against the plain version: {'; '.join(errs)}")
    expect(label, [(same, "forward not bit-identical to the bare kernel"),
                   (not bad, f"gradients: {bad}"),
                   (math.isfinite(ms) and math.isfinite(plain_ms),
                    f"times {ms} {plain_ms}")])
    for t in leaves:
        t.grad = None
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def recurrent_kernels(card, zcfg, rcfg):
    """The four new Functions at the train steps' shapes (``TRAIN_BATCH``
    x ``TRAIN_SEQ`` tokens): ``SSDChunk`` at Zamba2's (x (4, 112, 4, 256,
    64) float32, B/C a head-stride-0 group), ``WKV6`` at RWKV6's (r/k/v
    (4, 32, 1024, 64) bf16 transposed views, w and u float32, s0 zeros,
    no state gradient), ``CatRMSNorm`` with the add at the shared block's
    (4,096 rows of 3,584 + 3,584, bf16) and ``GatedRMSNorm`` at Mamba2's
    gate (4,096 rows of 7,168, float32 in, bf16 out), each through
    ``function_case``."""
    from repro_torch.kernels import autograd as AG
    from repro_torch.kernels import ref as REF
    from repro_torch.kernels import rmsnorm as RMS
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    B, T = TRAIN_BATCH, TRAIN_SEQ
    s, d = zcfg.ssm, zcfg.d_model
    H, P, N, cl = s.n_heads(d), s.head_dim, s.state_dim, s.chunk
    Hr, hd = rcfg.d_model // rcfg.rwkv.head_dim, rcfg.rwkv.head_dim
    R, di = B * T, s.d_inner(d)

    def rnd(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    print(f"\n[train recurrent kernels] the Functions at the train steps' "
          f"shapes ({card})")
    out = {}
    args = ssd_inputs(B, H, T, cl, P, N, f32, gen)
    leaves = [a.detach().requires_grad_(True) for a in args]
    nc = T // cl
    cots = [rnd(B, H, nc, cl, P), rnd(B, H, nc, P, N), rnd(B, H, nc)]
    flops, nbytes, peak = ssd_train_work(*args)
    out["ssd_chunk"] = function_case(
        f"SSDChunk x {tuple(args[0].shape)} float32", AG.SSDChunk.apply,
        SSD.ssd_chunk, REF.ssd_chunk, leaves, cots, True, (flops, nbytes),
        f32, peak)
    leaves = args = cots = None
    r, k, v, w, u, _ = wkv6_inputs(B, Hr, T, hd, bf, gen)
    s0 = torch.zeros(B, Hr, hd, hd, device="cuda")
    leaves = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
    leaves.append(s0)
    out["wkv6"] = function_case(
        f"WKV6 r {tuple(r.shape)} bf16", AG.WKV6.apply, WKV.wkv6, REF.wkv6,
        leaves, [rnd(B, Hr, T, hd), None], True,
        wkv6_train_work(r, k, v, w, u, s0), f32)
    leaves = None
    x, delta, e = rnd(R, d, dtype=bf), rnd(R, d, dtype=bf), \
        rnd(R, d, dtype=bf)
    scale = (1 + 0.1 * rnd(2 * d)).to(bf)
    leaves = [t.detach().requires_grad_(True) for t in (x, e, scale, delta)]
    # bytes: forward x, delta, e in and s, y out; backward s, e, dy, ds in
    # and dx, ddelta, de out (bf16), scale read twice and dscale written
    n = R * 2 * d
    work = ((4.5 + 7) * n, 2 * 14 * R * d + 3 * 2 * 2 * d)
    out["cat_rmsnorm"] = function_case(
        f"CatRMSNorm with the add ({R}, {d} + {d}) bf16",
        lambda a, b, c, dd: AG.CatRMSNorm.apply(a, b, c, 1e-5, dd),
        lambda a, b, c, dd: RMS.cat_rmsnorm(a, b, c, 1e-5, dd),
        lambda a, b, c, dd: REF.cat_rmsnorm(a, b, c, 1e-5, dd),
        leaves, [rnd(R, d, dtype=bf), rnd(R, 2 * d, dtype=bf)], False,
        work, bf)
    leaves = None
    y, z = rnd(R, di), rnd(R, di)
    scale = (1 + 0.1 * rnd(di)).to(bf)
    leaves = [t.detach().requires_grad_(True) for t in (y, z, scale)]
    # bytes: y, z (float32) read by both passes, out and dout (bf16), dy
    # and dz (float32) written, scale read twice and dscale written
    n = R * di
    work = ((9 + 19) * n, 28 * n + 3 * 2 * di)
    out["gated_rmsnorm"] = function_case(
        f"GatedRMSNorm ({R}, {di}) float32 -> bf16",
        lambda a, b, c: AG.GatedRMSNorm.apply(a, b, c, 1e-5, bf),
        lambda a, b, c: RMS.gated_rmsnorm(a, b, c, 1e-5, bf),
        lambda a, b, c: REF.gated_rmsnorm(a, b, c, 1e-5, bf),
        leaves, [rnd(R, di, dtype=bf)], False, work, f32)
    leaves = None
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_recurrent(card):
    """The recurrent families trained on the card: the four Functions at
    the train steps' shapes (``recurrent_kernels``); the dry-run's
    train-step argument bytes of Zamba2's cut; then ``rwkv6-1.6b`` in full
    and ``zamba2-7b`` at full width cut to depth ``N_ZAMBA_TRAIN``, each
    trained for ``RECURRENT_STEPS`` steps through ``fit_on_card``, one
    more step counted with its backward apart (``recurrent_launches`` a
    forward, none in the backward), peak memory at least
    ``TRAIN_HEADROOM`` under 80 GB, every loss finite and the last below
    the first; then each family's gradient probe (RWKV6 at depth 2,
    Zamba2 at depth 6, one unit) within ``REFEREE``. Returns the
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.models import Model
    from repro_torch.sharding.rules import DEFAULT_RULES

    class OneDevice:
        shape = {"data": 1, "model": 1}

    t_phase = time.perf_counter()
    rcfg = get_config(RWKV)
    zcfg = zamba_train_cut()
    assert rcfg.n_layers == N_RWKV and rcfg.dtype == zcfg.dtype == "bfloat16"
    numbers = {"functions": recurrent_kernels(card, zcfg, rcfg)}
    args = argument_bytes(Model(zcfg, "meta"), "train", TRAIN_BATCH,
                          TRAIN_SEQ, OneDevice(), True, DEFAULT_RULES)
    step_args = args["argument_size_in_bytes"] + args["param_bytes"]
    print(f"\n[train recurrent] sizing: {ZAMBA} at depth {N_ZAMBA_TRAIN}: "
          f"dry-run train-step arguments {args['argument_size_in_bytes']:.0f}"
          f" B (parameters {args['param_bytes']:.0f}, "
          f"{args['moment_dtype']} moments {args['optimizer_bytes']:.0f}) "
          f"+ gradients {args['param_bytes']:.0f} = {step_args / 1e9:.2f} "
          f"GB; the step's activations fill the rest, peak held to "
          f"{(CARD_BYTES - TRAIN_HEADROOM) / 1e9:.0f} GB")
    cases = (("train_rwkv6", "full", rcfg, RWKV_TRAIN_PARAMS,
              RWKV_PROBE_DEPTH, RWKV_PROBE_PARAMS),
             ("train_zamba2", f"full width, depth {N_ZAMBA_TRAIN}", zcfg,
              ZAMBA_TRAIN_PARAMS, ZAMBA_PROBE_DEPTH, ZAMBA_PROBE_PARAMS))
    for tag, what, cfg, n_params, depth, n_probe in cases:
        model, params, _, _ = load_model(cfg, n_params, tag, card)
        trainer, data, hist, launches, peak, tps = fit_on_card(
            card, tag, what, model, params, n_params, RECURRENT_STEPS,
            extra=2)
        step = counted_step(model, trainer.params,
                            trainer.device_batch(data[RECURRENT_STEPS]),
                            False)
        want = recurrent_launches(cfg)
        m = want["ssd_chunk"]
        print(f"  one step: forward launches {step[0]}, backward {step[1]}"
              + (f"; RMSNorm {want['rmsnorm']} = {m} ln1 + {m} gate + "
                 f"{2 * want['flash_attention']} concat (two a shared "
                 f"site) + 1 final" if m else "; RMSNorm: the final norm"))
        none = {k: 0 for k in launches}
        want = dict(none, **want)
        losses = [r["loss"] for r in hist]
        expect(tag, [
            (len(hist) == RECURRENT_STEPS, f"{len(hist)} logged steps"),
            (all(math.isfinite(x) for x in losses), f"losses {losses}"),
            (losses[-1] < losses[0],
             f"step {RECURRENT_STEPS}'s loss {losses[-1]} not below step "
             f"1's {losses[0]}"),
            (launches == {k: RECURRENT_STEPS * v for k, v in want.items()},
             f"launches over the fit {launches}"),
            (step == (want, none), f"one step {step}"),
            (peak <= CARD_BYTES - TRAIN_HEADROOM,
             f"peak {peak / 1e9:.2f} GB leaves less than "
             f"{TRAIN_HEADROOM / 1e9:.0f} GB of {CARD_BYTES / 1e9:.0f}"),
        ])
        probe_batch = trainer.device_batch(data[RECURRENT_STEPS + 1])
        trainer = model = params = None
        gc.collect()
        torch.cuda.empty_cache()
        cut = dataclasses.replace(cfg, n_layers=depth,
                                  block_pattern=cfg.block_pattern[:depth])
        worst = train_probe(card, cfg, probe_batch, depth, n_probe,
                            recurrent_launches(cut))
        numbers[tag] = dict(tokens_per_s=tps, peak_gb=peak / 1e9,
                            launches=launches, probe_worst=worst,
                            losses=losses)
    numbers["seconds"] = time.perf_counter() - t_phase
    print(f"\n[train recurrent] phase {numbers['seconds']:.1f} s ({card})")
    return numbers


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def comm_debug_mode():
    try:
        from torch.distributed.tensor.debug import CommDebugMode
    except ImportError:                 # older torch
        from torch.distributed._tensor.debug import CommDebugMode
    return CommDebugMode()


def phase_moe_sharded(card):
    """One DeepSeek-V3 MoE layer at full width through ``moe_ffn_sharded``
    on an NCCL group of one rank, (1, 1) mesh, against ``moe_ffn`` on the
    same inputs (module docstring). On one rank the expert axes are ()
    and the FFN axes (data, model), as ``expert_axes`` gives: its
    all-gathers and reduce-scatters run, the all-to-all does not. Returns
    the readings."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models import moe_sharded as MOES
    from repro_torch.sharding.rules import expert_axes
    cfg = get_config(DEEPSEEK)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_SHARDED_CF))
    m = cfg.moe
    assert (m.n_experts, m.top_k, cfg.d_model, m.d_ff_expert,
            m.n_shared_experts, cfg.dtype) == (256, 8, 7168, 2048, 1,
                                               "bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_device(0)         # NCCL's communicator binds this card
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        p = MOE.moe_init(gen, cfg, "cuda")
        experts = sum(p[n].numel() * p[n].element_size() for n in
                      ("experts_gate", "experts_up", "experts_down"))
        B, S = MOE_SHARDED_TOKENS
        x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        T = B * S
        print(f"\n[moe_sharded] {cfg.name} MoE layer: {m.n_experts} experts "
              f"top-{m.top_k}, d {cfg.d_model}, expert FFN {m.d_ff_expert}, "
              f"{m.n_shared_experts} shared, {experts / 1e9:.3f} GB of expert "
              f"weights; {B} x {S} tokens, capacity factor {m.capacity_factor}"
              f" (C {MOE.capacity(cfg, T)} dense, {MOES.capacity(cfg, T)} "
              f"sharded); NCCL, 1 rank, mesh (1, 1), expert axes "
              f"{expert_axes(m.n_experts, mesh)} ({card})")
        with torch.no_grad():
            y_d, aux_d = MOE.moe_ffn(p, cfg, x)
            with comm_debug_mode() as cm:
                y_s, aux_s = MOES.moe_ffn_sharded(p, cfg, x, mesh=mesh)
            torch.cuda.synchronize()
            counts = {str(k): v for k, v in cm.get_comm_counts().items()
                      if v}
            drops = (float(aux_d["moe_drop_frac"]),
                     float(aux_s["moe_drop_frac"]))
            err = check_close("moe_ffn_sharded", y_s, y_d,
                              slice(None), torch.bfloat16)
            ms = {"moe_ffn": time_ms(lambda: MOE.moe_ffn(p, cfg, x),
                                     warmup=1, iters=3),
                  "moe_ffn_sharded": time_ms(
                      lambda: MOES.moe_ffn_sharded(p, cfg, x, mesh=mesh),
                      warmup=1, iters=3)}
        print(f"  drop fraction: dense {drops[0]}, sharded {drops[1]}; max "
              f"abs err {err:.3e} (TOL[bf16] {TOL[torch.bfloat16]}); aux "
              f"dense {float(aux_d['moe_aux']):.6f} sharded "
              f"{float(aux_s['moe_aux']):.6f}")
        print(f"  collectives a call (CommDebugMode): {counts}")
        print(f"  ms a call: moe_ffn {ms['moe_ffn']:.4f}, moe_ffn_sharded "
              f"{ms['moe_ffn_sharded']:.4f} ({card})")
        del y_d, y_s
        leaves = [p["router"], p["experts_gate"], p["experts_up"],
                  p["experts_down"], *p["shared"].values()]
        for w in leaves:
            w.requires_grad_(True)
        x.requires_grad_(True)
        torch.cuda.reset_peak_memory_stats()
        y, aux = MOES.moe_ffn_sharded(p, cfg, x, mesh=mesh)
        (y.float().square().mean() + aux["moe_aux"]).backward()
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t.grad).all())
                     for t in leaves + [x])
        peak = torch.cuda.max_memory_allocated()
        print(f"  backward: {len(leaves) + 1} gradients, all finite "
              f"{finite}; peak {peak / 1e9:.2f} GB allocated ({card})")
        expect("moe_sharded", [
            (drops == (0.0, 0.0), f"drop fractions {drops}"),
            (finite, "a non-finite gradient"),
            (counts.get("c10d._allgather_base_", 0) >= 2,
             f"collectives {counts}"),
        ])
    finally:
        p = x = y = aux = None
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return dict(ms=ms, drops=drops, err=err, counts=counts)


MESH_TOKENS = (4, 1024)              # phase_mesh: llama-paper-1b's batch
MESH_STEPS = 16                      # its decode steps after the prefill
MESH_RECURRENT = ("zamba2-7b", "rwkv6-1.6b")
MESH_RECURRENT_DEPTH, MESH_RECURRENT_STEPS = 2, 4
MESH_DRYRUN = ("train_4k", "decode_32k")     # llama3.2-1b on 16x16
MESH_SITE_MODULES = ("attention", "blocks", "layers", "model", "moe",
                     "moe_sharded", "rwkv", "ssm")


class SiteLog:
    """Within: each ``shard()`` site's output of the models, in order, as
    (site, local tensor); a DTensor's local tensor is the whole one on a
    one-rank mesh."""

    def __init__(self):
        self.sites = []

    def __enter__(self):
        import importlib
        self.mods = [importlib.import_module(f"repro_torch.models.{m}")
                     for m in MESH_SITE_MODULES]
        self.saved = [m.shard for m in self.mods]
        for mod, orig in zip(self.mods, self.saved):
            mod.shard = self._wrap(mod.__name__.split(".")[-1], orig)
        return self

    def _wrap(self, where, orig):
        def shard(x, *axes):
            y = orig(x, *axes)
            t = y.to_local() if hasattr(y, "to_local") else y
            self.sites.append((f"{where}.shard{axes}", t.detach()))
            return y
        return shard

    def __exit__(self, *exc):
        for mod, orig in zip(self.mods, self.saved):
            mod.shard = orig
        return False


def first_difference(plain, mesh):
    """The first site whose outputs differ between two ``SiteLog``s: (its
    index and name, the max abs difference), or None."""
    for i, ((name, a), (_, b)) in enumerate(zip(plain.sites, mesh.sites)):
        if a.shape != b.shape or not torch.equal(a, b):
            err = ((a.float() - b.float()).abs().max().item()
                   if a.shape == b.shape else float("inf"))
            return f"site {i} {name}", err
    return None


def mesh_agreement(label, plain, mesh, got, want, dtype, card):
    """Bit for bit, or within ``TOL[dtype]`` with the first differing
    site named; returns (ok, line)."""
    if torch.equal(got, want):
        line = f"  {label}: bit for bit ({card})"
        print(line)
        return True, line
    err = (got.float() - want.float()).abs().max().item()
    first = first_difference(plain, mesh)
    ok = err <= TOL[dtype][0] + TOL[dtype][1] * want.float().abs().max(
        ).item()
    line = (f"  {label}: max abs err {err:.3e} (TOL[{dtype}] "
            f"{TOL[dtype]}), first differing site {first} ({card})")
    print(line)
    return ok, line


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def phase_mesh(card):
    """The model as one SPMD program on a DeviceMesh (module docstring):
    one NCCL rank, a (1, 1) ("data", "model") mesh, the parameters placed
    by ``distribute_params`` (FSDP on), every step under ``use_sharding(
    mesh, DEFAULT_RULES)``, each against the plain model on the same
    parameters; meanwhile the dry-run of ``llama3.2-1b`` on 16x16 in a
    process of its own (a ``fake`` group of 256). Returns the launches
    of its llama-paper-1b prefill."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import run_step
    from repro_torch.launch.mesh import forget_groups, make_mesh
    from repro_torch.models import Model
    from repro_torch.sharding import distribute_params, use_sharding
    from repro_torch.sharding.rules import DEFAULT_RULES
    from repro_torch.training.optim import AdamWConfig

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "mesh")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    dry = {}
    for shape in MESH_DRYRUN:
        path = os.path.join(out_dir, f"dryrun_{shape}.jsonl")
        if os.path.exists(path):
            os.remove(path)
        dry[shape] = (path, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "llama3.2-1b", "--shape", shape, "--out", path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_device(0)         # NCCL's communicator binds this card
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    checks, launches = [], {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_config(TRAIN)
        assert (cfg.n_layers, cfg.d_model, cfg.dtype) == (N_LAYERS, 2048,
                                                          "bfloat16")
        model, params, gen, _ = load_model(cfg, TRAIN_PARAMS, "mesh", card)
        dp = distribute_params(cfg, params, mesh, fsdp=True,
                               src_data_rank=None)
        B, S = MESH_TOKENS
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device="cuda", dtype=torch.int32)
        print(f"[mesh] NCCL, 1 rank, mesh (1, 1) (data, model), "
              f"DEFAULT_RULES, FSDP on; prefill {B} x {S}, {MESH_STEPS} "
              f"decode steps, one train_loss + AdamW step ({card})")
        runs = {}
        for tag in ("plain", "mesh"):
            p = params if tag == "plain" else dp
            ctx = (use_sharding(mesh, DEFAULT_RULES) if tag == "mesh"
                   else contextlib.nullcontext())
            with ctx, SiteLog() as log, torch.no_grad():
                ops.reset_launches()
                logits, caches = run_step(model, "prefill", p, tokens,
                                          max_len=S + MESH_STEPS)
                torch.cuda.synchronize()
                pre = ops.launch_counts()
                steps, step_launches = [logits], []
                feed = runs["plain"]["feed"] if tag == "mesh" else []
                for i in range(MESH_STEPS):
                    if tag == "plain":
                        feed.append(torch.argmax(
                            logits[:, :cfg.vocab], -1)[:, None].int())
                    ops.reset_launches()
                    logits, caches = run_step(model, "decode", p, feed[i],
                                              caches=caches)
                    step_launches.append(ops.launch_counts())
                    steps.append(logits)
                torch.cuda.synchronize()
            runs[tag] = dict(steps=[t.to_local() if hasattr(t, "to_local")
                                    else t for t in steps],
                             log=log, pre=pre, step_launches=step_launches,
                             feed=feed)
            caches = logits = None
        launches = runs["mesh"]["pre"]
        for tag in ("plain", "mesh"):
            r = runs[tag]
            print(f"  {tag}: prefill launches {r['pre']}; a decode step "
                  f"{r['step_launches'][0]} ({len(r['log'].sites)} sites "
                  f"recorded)")
        m = runs["mesh"]
        checks += [
            (m["pre"]["flash_attention"] == N_LAYERS,
             f"flash launches a prefill {m['pre']}"),
            (m["pre"]["rmsnorm"] == 2 * N_LAYERS + 1,
             f"RMSNorm launches a prefill {m['pre']}"),
            (all(s["decode_attention"] == N_LAYERS
                 and s["rmsnorm"] == 2 * N_LAYERS + 1
                 for s in m["step_launches"]),
             f"decode launches {m['step_launches']}"),
            (len(runs["plain"]["log"].sites) == len(m["log"].sites),
             "the runs reached different numbers of sites")]
        for i, (got, want) in enumerate(zip(m["steps"],
                                            runs["plain"]["steps"])):
            checks.append(mesh_agreement(
                "prefill logits" if i == 0 else f"decode step {i} logits",
                runs["plain"]["log"], m["log"], got, want, torch.bfloat16,
                card))
        del runs, dp

        # one train_loss + AdamW step on copies of the same parameters
        labels = torch.roll(tokens, -1, 1)
        opt = AdamWConfig(lr=TRAIN_LR)
        trained = {}
        for tag in ("plain", "mesh"):
            p = _clone_tree(params)
            if tag == "mesh":
                p = distribute_params(cfg, p, mesh, fsdp=True,
                                      src_data_rank=None)
            ctx = (use_sharding(mesh, DEFAULT_RULES) if tag == "mesh"
                   else contextlib.nullcontext())
            gc.collect()
            torch.cuda.empty_cache()
            with ctx, SiteLog() as log:
                ops.reset_launches()
                t0 = time.perf_counter()
                loss, _ = run_step(model, "train", p, tokens, labels=labels,
                                   opt_cfg=opt, remat=False)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                tl = ops.launch_counts()
            loss = loss.to_local() if hasattr(loss, "to_local") else loss
            flat = [t.to_local() if hasattr(t, "to_local") else t
                    for t in _leaves(p)]
            trained[tag] = dict(loss=loss.detach(), params=flat, log=log,
                                launches=tl, ms=ms)
            print(f"  train step ({tag}): loss {loss.item():.6f}, "
                  f"launches {tl}, {ms:.1f} ms" + (
                      " (the first on the mesh: DTensor's sharding "
                      "propagation included)" if tag == "mesh" else "")
                  + f" ({card})")
            p = loss = None
        t_p, t_m = trained["plain"], trained["mesh"]
        checks.append(mesh_agreement("train loss", t_p["log"], t_m["log"],
                                     t_m["loss"], t_p["loss"],
                                     torch.bfloat16, card))
        same = sum(torch.equal(a, b) for a, b in zip(t_m["params"],
                                                     t_p["params"]))
        worst = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(t_m["params"], t_p["params"]))
        print(f"  updated parameters: {same} of {len(t_p['params'])} "
              f"leaves bit for bit, max abs difference {worst:.3e} "
              f"({card})")
        checks += [
            (worst <= TOL[torch.bfloat16][0],
             f"updated parameters differ by {worst}"),
            (t_m["launches"]["flash_attention"] == N_LAYERS
             and t_m["launches"]["rmsnorm"] == 2 * N_LAYERS + 1,
             f"train launches {t_m['launches']}")]
        del trained, t_p, t_m, params, model
        gc.collect()
        torch.cuda.empty_cache()

        # the recurrent families at full width, cut in depth
        for arch in MESH_RECURRENT:
            full = get_config(arch)
            cut = dataclasses.replace(
                full, n_layers=MESH_RECURRENT_DEPTH,
                block_pattern=full.block_pattern[:MESH_RECURRENT_DEPTH])
            model = Model(cut, "cuda")
            g = torch.Generator(device="cuda")
            g.manual_seed(0)
            params = model.init(g)
            dp = distribute_params(cut, params, mesh, fsdp=True,
                                   src_data_rank=None)
            toks = torch.randint(0, cut.vocab, MESH_TOKENS, generator=g,
                                 device="cuda", dtype=torch.int32)
            res = {}
            for tag in ("plain", "mesh"):
                p = params if tag == "plain" else dp
                ctx = (use_sharding(mesh, DEFAULT_RULES) if tag == "mesh"
                       else contextlib.nullcontext())
                with ctx, SiteLog() as log, torch.no_grad():
                    ops.reset_launches()
                    logits, caches = run_step(
                        model, "prefill", p, toks,
                        max_len=MESH_TOKENS[1] + MESH_RECURRENT_STEPS)
                    outs = [logits]
                    feed = res["plain"]["feed"] if tag == "mesh" else []
                    for i in range(MESH_RECURRENT_STEPS):
                        if tag == "plain":
                            feed.append(torch.argmax(
                                logits[:, :cut.vocab], -1)[:, None].int())
                        logits, caches = run_step(model, "decode", p,
                                                  feed[i], caches=caches)
                        outs.append(logits)
                    torch.cuda.synchronize()
                    counts = ops.launch_counts()
                res[tag] = dict(outs=[t.to_local() if hasattr(
                    t, "to_local") else t for t in outs], log=log,
                    feed=feed, counts=counts)
            kernel = "ssd_chunk" if arch.startswith("zamba") else "wkv6"
            print(f"  {arch} depth {MESH_RECURRENT_DEPTH}, d_model "
                  f"{cut.d_model}: prefill {MESH_TOKENS[0]} x "
                  f"{MESH_TOKENS[1]} and {MESH_RECURRENT_STEPS} decode "
                  f"steps; launches on the mesh {res['mesh']['counts']} "
                  f"({card})")
            checks.append((res["mesh"]["counts"][kernel] > 0,
                           f"{arch}: {kernel} never launched on the mesh"))
            for i, (got, want) in enumerate(zip(res["mesh"]["outs"],
                                                res["plain"]["outs"])):
                checks.append(mesh_agreement(
                    f"{arch} " + ("prefill logits" if i == 0 else
                                  f"decode step {i} logits"),
                    res["plain"]["log"], res["mesh"]["log"], got, want,
                    torch.bfloat16, card))
            del res, dp, params, model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        forget_groups()

    for shape, (path, proc) in dry.items():
        log, _ = proc.communicate(timeout=600)
        checks.append((proc.returncode == 0,
                       f"dry-run {shape}: {log[-2000:]}"))
        if proc.returncode:
            continue
        with open(path) as f:
            rec = json.loads(f.read().splitlines()[-1])
        r = rec["roofline"]
        print(f"  dry-run llama3.2-1b {shape} on {rec['mesh']} "
              f"({rec['chips']} chips, FSDP {rec['fsdp']}): collectives a "
              f"chip by op (count, wire bytes) "
              f"{ {k: (r['coll_counts'][k], r['coll_bytes_by_op'][k]) for k in r['coll_counts']} }"
              f"; ICI {r['coll_ici_bytes']:.6e} B, DCN "
              f"{r['coll_dcn_bytes']:.6e} B; t_collective "
              f"{r['t_collective_s']:.6e} s, t_compute "
              f"{r['t_compute_s']:.6e} s, t_memory {r['t_memory_s']:.6e} "
              f"s -> {r['dominant']}-bound (links: "
              f"{r['link_assumption']}); counted in {rec['count_s']} s")
        checks.append((r["t_collective_s"] is not None
                       and r["coll_counts"].get("all-gather", 0) > 0,
                       f"dry-run {shape}: no priced collectives"))
    print(f"  phase_mesh took {time.perf_counter() - t_phase:.1f} s "
          f"({card})")
    expect("mesh", checks)
    return launches


def phase_dryrun_memory(card, train):
    """The dry-run's per-device argument bytes on a (1, 1) mesh against
    the card's own allocation, and ``phase_train``'s step counted on meta
    (module docstring). ``train``: ``phase_train``'s numbers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import argument_bytes, count_step
    from repro_torch.models import Model
    from repro_torch.models.costing import model_flops
    from repro_torch.sharding.rules import DEFAULT_RULES
    from repro_torch.training.optim import AdamWConfig, adamw_init

    class OneDevice:
        shape = {"data": 1, "model": 1}

    def grown(alloc):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        held = alloc()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() - before, held

    def agree(label, want, got):
        ok = abs(got - want) <= max(DRYRUN_TOL[0] * want, DRYRUN_TOL[1])
        print(f"  {label}: dry-run {want:.0f} B, card {got} B, "
              f"difference {got - want:+.0f} B ({(got - want) / want:+.3e}) "
              f"({card})")
        return ok, f"{label}: dry-run {want}, card {got}"

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = []
    print(f"\n[dryrun_memory] argument bytes of the dry-run on a (1, 1) "
          f"mesh against torch.cuda.memory_allocated() ({card})")
    cfg = get_config("llama3.2-1b")
    model = Model(cfg, "cuda")
    B, W = DRYRUN_SERVE
    want = argument_bytes(Model(cfg, "meta"), "decode", B, W, OneDevice(),
                          True, DEFAULT_RULES)
    got_p, params = grown(lambda: model.init(gen))
    got_c, caches = grown(lambda: model.init_cache(B, W))
    checks.append(agree(f"{cfg.name} parameters", want["param_bytes"],
                        got_p))
    checks.append(agree(f"{cfg.name} caches (max_batch {B}, max_len {W})",
                        want["cache_bytes"], got_c))
    params = caches = model = None

    cfg = get_config(TRAIN)
    model = Model(cfg, "cuda")
    meta = Model(cfg, "meta")
    want = argument_bytes(meta, "train", TRAIN_BATCH, TRAIN_SEQ, OneDevice(),
                          True, DEFAULT_RULES)

    def train_args():
        params = model.init(gen)
        batch = {k: torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                                device="cuda") for k in ("tokens", "labels")}
        return params, adamw_init(params, AdamWConfig(lr=TRAIN_LR)), batch
    got_t, held = grown(train_args)
    checks.append(agree(f"{cfg.name} train step arguments (parameters, "
                        f"{want['moment_dtype']} moments, {TRAIN_BATCH} x "
                        f"{TRAIN_SEQ} batch)",
                        want["argument_size_in_bytes"], got_t))
    held = model = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step = count_step(meta, "train", TRAIN_BATCH, TRAIN_SEQ,
                      AdamWConfig(lr=TRAIN_LR), remat=False)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mf = model_flops(cfg, tokens, training=True)
    step_s = tokens / train["tokens_per_s"]
    print(f"  {cfg.name} train step ({TRAIN_BATCH} x {TRAIN_SEQ}, remat off)"
          f" counted on meta in {time.perf_counter() - t0:.1f} s: "
          f"{step.flops:.6e} FLOPs, {step.bytes:.6e} bytes; model_flops "
          f"{mf:.6e} (ratio {mf / step.flops:.4f}); at phase_train's "
          f"{step_s * 1e3:.1f} ms a step: {step.flops / step_s / 1e12:.2f} "
          f"TFLOP/s counted, {mf / step_s / 1e12:.2f} TFLOP/s of "
          f"model_flops ({card})")
    expect("dryrun_memory", checks)
    return dict(flops=step.flops, model_flops=mf, step_s=step_s)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"[card] {kind}, device_count {count}")
    print(card)

    t_start = t0 = time.perf_counter()
    libs = build.build()
    print(f"\n[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s"
          f" (nvcc, sm_90a)")
    for name in libs:
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    measured = phase_kernels(card)
    t0 = time.perf_counter()
    phase_examples(card)
    print(f"\n[examples] phase {time.perf_counter() - t0:.1f} s ({card})")
    gc.collect()                 # phase 3's graphs and their memory pools
    torch.cuda.empty_cache()
    print(f"\n[memory] allocated before the engines: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB ({card})")
    smoke_agreement()
    launches = phase_engine(card)
    torch.cuda.empty_cache()
    llama32 = phase_llama32(card)
    print(f"\n[llama3.2-1b] {llama32['decode_tokens']} decode tokens, "
          f"{llama32['graph']['captured']} graphs, "
          f"{llama32['graph']['replays']} replays, measured "
          f"{llama32['measured_j']:.1f} J ({card})")
    # flash and paged decode are reported from the zamba2 path, at the head
    # dim 112 timed in phase 3
    launches.update(phase_zamba(card))
    torch.cuda.empty_cache()
    launches.update(phase_rwkv(card))
    torch.cuda.empty_cache()
    # the dense configurations' paths, read but not reported in the line:
    # the line keeps each kernel's launches on the path timed in phase 3
    dense = phase_dense(card)
    print(f"\n[dense] launches over the seven dense runs: {dense}")
    maverick = phase_maverick(card)
    print(f"\n[maverick] launches on its path: {maverick}")
    deepseek = phase_deepseek(card)
    print(f"\n[deepseek] launches on its path: {deepseek}")
    vlm = phase_vlm(card)
    print(f"\n[vlm] launches on its engine path: {vlm}")
    seamless = phase_seamless(card)
    print(f"\n[seamless] launches of its prefill and decode steps: "
          f"{seamless}")
    train = phase_train(card)
    print(f"\n[train] launches over the fit: {train['launches']}; "
          f"{train['tokens_per_s']:.1f} tokens/s; probe's worst ratio "
          f"{train['probe_worst']:.4f}")
    recurrent = phase_train_recurrent(card)
    for tag in ("train_rwkv6", "train_zamba2"):
        r = recurrent[tag]
        print(f"[{tag}] launches over the fit: {r['launches']}; "
              f"{r['tokens_per_s']:.1f} tokens/s; peak {r['peak_gb']:.2f} "
              f"GB; probe's worst ratio {r['probe_worst']:.4f}")
    moe = phase_moe_sharded(card)
    print(f"\n[moe_sharded] ms a call {moe['ms']}; drops {moe['drops']}")
    mesh = phase_mesh(card)
    print(f"\n[mesh] launches of llama-paper-1b's prefill on the mesh: "
          f"{mesh}")
    mem = phase_dryrun_memory(card, train)
    print(f"\n[dryrun_memory] counted {mem['flops']:.6e} FLOPs a train "
          f"step, model_flops {mem['model_flops']:.6e}")

    kernels = [dict(name=name, route="cuda", source=src, replaces=tpu,
                    launches=launches[name], **measured[name])
               for name, (src, tpu) in KERNELS.items()]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']}: no launch on its path")
        for key in ("max_abs_err", "ms", "plain_ms", "library_ms",
                    "bound_ms"):
            if k[key] is None and key == "library_ms":
                continue               # no single library call
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} not finite")
    print(f"\n[time] {time.perf_counter() - t_start:.1f} s from the build "
          f"to the result ({card})")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
