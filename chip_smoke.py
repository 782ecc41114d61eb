#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the repository root

It builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`
with nvcc, checks and times each against its plain torch version, and
drives the port's paths: the synchronous FedAdp round of the flat engine
through `repro_torch.FedServer`, at the full width of the paper's CNN,
on every uplink wire (f32, bf16, int8, int4), with the quantized and
delta downlink, in sequential mode and as the buffered-async server,
scanned with a bit-exact kill/resume and with round telemetry; the
algorithm on the MLR golden task; federated training of a dense LM (the
100m preset of examples/torch_fl_lm_train.py, the flash kernel under
torch.func.vmap(grad) in every local step); dense-LM serving
(`launch.serve.generate`: gemma-2b at full width and depth in bf16,
prefill on the flash-attention kernel, then greedy decode); serving of
the other families (MoE with MLA, the Mamba hybrid, RWKV-6, Qwen2-VL's
M-RoPE prefix, the Whisper encoder-decoder) at full width in bf16; and
`kernels/ops.py` on a real CNN round's deltas. Each
phase prints one JSON line; any failure raises and the script exits
non-zero. It imports nothing of jax or of the JAX package `repro`.

Phases: device, build (all seven sources at once; ptxas's registers and
spills; the HMMA / HGMMA count in the SASS of each head-dim instance of
both flash kernels, bf16 and f32, which must not be 0; the I2F and
LDG.E.128 counts and registers of the wire aggregations and statistics,
which must have no I2F and 16-byte loads), kernels (correctness of the
f32 kernels on f32 and bf16 input and of the int8 / int4 wire kernels at
the main path's shape, at the rows a rank holds in phase `sharded` (5 and
3 of the CNN's N) and at edge shapes, the f32 kernels also on storage
4, 8 and 12 bytes past a 16-byte boundary, a second launch of each wire
kernel giving the same bits, then timing of every kernel variant, and
the device kernels of one call of each wire kernel, by a profile: one per
aggregation, two per statistics call; round_stats at (1, N), sequential
mode's shape; batched_dot and
grad_dot_stats the same; flash attention at the reference test's cases,
at every head dim of both kernels, causal and not, at ragged T, through
gqa_flash with grouped KV heads, and at gemma-2b's prefill shape, where
the bf16 and the f32 kernel are timed against SDPA, whose device kernel
is named from a profile), wire (the quantizer on the card equals the quantizer on the CPU
bit for bit), slice (per wire: 3 CNN rounds with eval, with 2
aggregation + 1 statistics launches of the wire's kernels per round, the
quantizer's time, flat == tree on the card, one more round under
torch.profiler; and one int8 run with error feedback), downlink (3 CNN
rounds each of an int8 broadcast on the f32 uplink, a bf16 broadcast with
error feedback on the int8 uplink, and an int8 delta broadcast with a
2-deep ring on the int4 uplink at 5 of 10 clients: 2 + 1 launches of the
uplink wire's kernels a round, flat == tree, the (1, N) compress on the
card == on the CPU, every client's pull replayed from the ring bitwise
onto the head or refused as a resync, `ver` and `head_ver` as the
cohorts imply; round ms and bytes), sequential (3 CNN rounds of the
exact round and of stale_angles: 10 round_stats launches a round at
(1, N), none of weighted_agg; ms a round; the exact round == the
parallel tree round at 2e-4 / 2e-5), buffered (buffered(m = K) == sync,
f32 bit for bit and int8 at 1e-5; the golden buffered schedule's 8 ticks
on the int8 uplink: 2 + 1 f32 kernel launches a tick, none of the _q
ones, flushes on the ticks of the same schedule's CPU run; ms a tick),
resume (kill/resume on the CNN: a scanned run of 2 blocks x 2 rounds
with checkpoints, and a fresh FedServer restored at the first block edge
running the second block, on the int8 uplink with EF and the int8 delta
downlink with EF at 5 of 10 clients, and on the buffered server (int8 +
EF, a report in flight at the edge): state, generator and History bit
for bit, deterministic cuDNN; 2 + 1 wire kernel launches a round on both
sides; the checkpoint's bytes, write and read ms), telemetry
(telemetry="node" into a JSONLSink on the f32 round and on the int8
uplink with the int8 delta downlink at 5 of 10: the stream validates, K
node events a round, bytes_up / bytes_down as `round_bytes` or the split
the recorded cohorts imply; on == off bit for bit with the same launches
and no more host syncs a round; the sequential round on == off; the
device kernels telemetry adds to a profiled round; ms a round stepwise
against scanned, block = 8, in turns; the idle share of a profiled
scanned block), algorithm (fedadp reaches 85% on MLR in no more rounds than fedavg, per
uplink f32, bf16, int8 and int4, on the golden delta section's wires at
5 of 10 clients, and in sequential mode; buffered fedadp under the
golden schedule in no more ticks than sync fedavg, on f32/f32 and
int4/int8; each wire's fedadp rounds over f32's printed), sharded
(engine="flat_sharded" at the CNN's full width: world 1 over NCCL in
this process per uplink f32 / int8 / int4, 3 rounds against the flat
engine from the same seed under deterministic cuDNN, 2 + 1 launches a
round, equal to 1e-5 (the max difference printed), ms a round of both;
then a gloo world of two processes sharing this card (`--sharded-child`)
on f32 and int8: the ranks bit for bit, one round at 2 local steps from
the initial model against the flat round at 2e-4 / 2e-5, 2 + 1 launches
per rank per round over K_loc = 5 rows, fedadp in no more MLR rounds to
85% than fedavg; NCCL over min(cards, 4) cards when there are two or
more; the kernel table's `launches_sharded`), mesh2d (the 2D
(client x model) mesh: the aggregation and statistics kernels, f32,
bf16, int8 and int4, at a (K_loc, N_loc) = (5, 831,685) tile against
their plain versions; the CNN on a (2, 2) gloo world of four processes
on this card (`--mesh2d-child`) per uplink wire: one round at 2 local
steps from the initial model on the 2D flat_sharded and tree engines
(and the 1D flat engine on f32 / bf16) aggregating the same pinned
deltas, equal at 1e-5, and on f32 / bf16 the two 2D engines on their
own trained deltas at 2e-4 / 2e-5; then 2 counted FedServer rounds: the
ranks bit for bit, 2 + 1 launches a rank a round, ms a round per rank;
NCCL over (2, 2)
cards or (1, 2) where there are 4 or 2-3; then the 100m LM on a (1, 2)
gloo world, f32 and int8, one round after a warm-up: 2D flat_sharded ==
2D tree at 1e-5, every region output of its shard shape, the region's
largest all_gather below the smallest model-sharded leaf, peak memory
and the bytes of every collective; the kernel table's
`launches_mesh2d`), tp (tensor-parallel execution over the model axis:
the 100m preset, f32, flash, K = 4, tau = 2, B = 4, T = 256, on (1, 2)
and (2, 2) gloo worlds on this card (`--mesh2d-child tp`): the state
placed in each rank's blocks, memory_allocated() within 1% plus 512 B a
tensor of the specs' shard bytes; a warm-up round whose every flash
launch, at the rank's local heads, is held to the plain version at
2e-5; one recorded round: 2 + 1 FL launches and one flash launch a
layer a local step, the "tp" collectives' count and bytes equal to
those of the shapes, no other all_gather as large as a sharded block,
every state leaf of its shard shape, the gathered params and the
metrics == the whole-model 2D round at 2e-4, the ranks bit for bit; NCCL
across two cards where there are two; then the launcher on a (1, 2)
gloo world (`--mesh2d-child launch`): gemma-2b at full width and depth,
bf16, K = 1, B = 4, T = 1024, 2 rounds, ms a round and the peak a rank,
the gathered params_sha256 equal on both ranks, and at the smoke width a
resumed run bit for bit the uninterrupted one; the kernel table's
`launches_tp`), tp_serve (tensor-parallel serving and the DeepSeek
family over the model axis: the whole models' results in this process,
each model freed before one (1, 2) gloo world on this card
(`--mesh2d-child tp_serve`) initialises its blocks leaf by leaf and
serves gemma-2b at full width and depth, bf16, flash, B = 4, prompt
1024, 32 steps (18 flash launches a prefill, each on the rank's 4 of 8
heads; the "tp" collectives of a prefill and a decode step equal to
those of the shapes; prefill and decode ms and the peak a rank; the
logit gap and the greedy ids against the whole model) and
deepseek-v2-lite-16b at full width and depth, bf16, B = 4, prompt 512,
16 steps (the peak after init at most the blocks + 1 GB; the routing
bit for bit across ranks; the dropped share; the last logits against
the whole model); holds four reduced f32 configs' prefill and decode
through the step builders to the whole model at 2e-4; trains
deepseek-v2-lite at full width cut to 2 layers, f32, one round through
the launcher, == the host mesh's round at 2e-4 with 2 + 1 FL launches
a rank; and runs the serving launcher (gemma-2b, decode_32k, B = 4,
cache 4096): its ms/token; NCCL across two cards where there are two;
the kernel table's `launches_tp_serve`), lm_train
(grads through gqa_flash under vmap(grad) on the card, f32 and bf16,
equal the plain version's at the forward's tolerance, and the forward
runs the dtype's kernel; the 100m preset, f32, K = 4, tau = 2, B = 4,
T = 256, on the flat engine: 3 rounds on the xla attention path, then 3
on the flash path, from the same params on the same tokens, each round
2 weighted_agg + 1 round_stats launches and on the flash path one flash
launch per layer per local step; round 1 flash == xla at 2e-4, flat ==
tree at 1e-5; the metrics finite, and the loss of round 0's batches
lower after the 3 rounds than at the initial params; round ms, peak
memory, a profiled flash round; then the f32 kernel at the training
shape beside its bound, its plain version, SDPA and one layer's
backward recompute), serve
(gemma-2b, B = 4, prompt 1024, 32 greedy steps: 18
flash launches per prefill and none in decode, prefill and decode times,
peak memory, the tensor-core kernel's share of a profiled prefill, where
the f32 kernel must not appear; flash == xla prefill logits on the f32
model, on the f32 kernel, and the two f32 prefill times), families
(each family's reduced f32 config, and deepseek-v2-236b's q-LoRA
branch, card == CPU to 2e-4 on prefill logits and cache, 4 decode steps
and the loss; then deepseek-v2-lite-16b at full width and depth,
deepseek-v2-236b at 2 layers, jamba at one pattern group with 4
experts, rwkv6-3b, qwen2-vl-2b and whisper-small in bf16 through
generate, B = 4, 16 steps: init peak at most the params + 1 GB, flash
launches = the causal GQA layers per prefill and none in decode, the
prefill's argmax = generate's first token, prefill and decode times,
peak memory, the MoE capacity's dropped share, profiles), ops (tree_vdot_batched and tree_dot_and_norms
on the tree view of a CNN round's (K, N) buffer equal that round's
round_stats; one client's tree_dot_and_norms runs one grad_dot device
kernel a leaf of at most one block, two a larger leaf), launch (the
dry run of gemma-2b x train_4k on the 32x8 mesh; the training launcher
in this process at gemma-2b's full width and depth, bf16, host mesh,
K = 1, T = 1024, B = 4: 3 rounds, then 2 with a checkpoint and --resume
to 3, the params_sha256 equal; then for that train step, a prefill
(B = 4, T = 1024) and a decode step (B = 4, S = 4096) the dry run's
argument bytes against memory_allocated() once the inputs are placed,
within 1% plus 512 B a tensor, and its live bytes against
max_memory_allocated() over the step, the ratio within [0.8, 1.25]),
and last fsdp (params and the decode cache over "data": the whole
models' results in this process, each freed before one (2, 2) gloo
world on this card
(`--mesh2d-child fsdp`) runs (a) the sequential round of
deepseek-v2-lite at full width cut to one layer, f32, K = 4, tau = 1,
B = 4, T = 256, in FSDP blocks == the whole-model round at 2e-4, with
4 round_stats launches a rank at its (1, n_local) block, each held to
the plain version, the "fsdp" collectives' count and bytes those of the
shapes, ms a round and the peak against the round's trees in blocks +
one group's backward working set + 1 GB; (b) deepseek-v2-236b at full
width cut to one layer, bf16, fsdp=True, B = 4, prompt 512, 3 decode
steps: prefill and decode ms, the peak against the blocks + one group
gathered + the same prefill's activations with the params on "model"
only + 1 GB, the routing bit for bit across ranks, the logit gap
and the routing flips against the whole model; (c) long_500k at B = 1
with the cache's sequence on "data": gemma-2b whole (its ring of 8,192
slots split at 4,096, positions across that edge and the wrap) and
deepseek-v2-lite cut to 8 layers over 524,288 latent positions
(positions across 262,144): ms a step and the logit gap to the whole
model; (d) three reduced f32 configs with fsdp=True at B = 2 and B = 1
== the whole model at 2e-4, every flash call held to its plain version;
(e) the serving launcher at long_500k on the (2, 2) world; the kernel
table's `round_stats_fsdp` row and `launches_fsdp`).
Then, on lines of their own: the kernel table as one JSON object, the card's name and
power limit as nvidia-smi reports them, and last
`{"ok": true, "device": {...}}`.

Without a CUDA device, or without the repository's `src/` beside it, it
prints no result and exits non-zero. TF32 is off for matmuls and cuDNN
convs, so f32 means f32 everywhere (the f32 flash kernel's 3xTF32 holds
f32 accuracy).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks: HBM3 bandwidth, f32 outside the tensor
# cores (the FL kernels are f32 elementwise-and-reduce work) and dense
# bf16 on the tensor cores (where attention's products would run); f32
# products held to f32 accuracy on the tensor cores are 3xTF32, three
# TF32 products (495 TFLOP/s dense) for each f32 one.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
TF32X3_FLOPS_PER_S = 495e12 / 3
TOL = 1e-5
MAIN_K, MAIN_N = 10, 1_663_370  # K clients x the CNN's parameter count
EDGE_KS = (1, 3, 37, 128)
# the rows a rank holds in phase `sharded` at the main N: K = 10 over two
# ranks, and padded to 12 over four
SHARD_KS = (5, 3)
# the odd N give int4 a pad nibble; 13 is shorter than one 16-byte tile of
# the wire aggregations, and 16,385 walks the rows' start through every
# residue mod 16 (int8 and int4)
EDGE_NS = (13, 7_850, 16_385, 1_000_003)
# int4 group sizes checked: 2 and 8 give each byte (or every other byte)
# of a thread its own scale, the others one scale for a thread's columns
GROUP_SIZES = (2, 8, 32, 512, 16_384)
MAIN_GS = 512  # FLConfig's default int4 group size
WIDE_K = 128  # a second timing of each kernel, at 12.8x the main K
REPS = 50
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's clock: the host's head start
HEAD_START = 8  # throwaway sleep kernels that begin a counted trace
TAIL_END = 8  # and that end it
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's device kernel
WIRES = ("f32", "bf16", "int8", "int4")
SOURCES = ("weighted_agg", "round_stats", "weighted_agg_q", "round_stats_q",
           "flash_attn", "batched_dot", "grad_dot")
# device kernels of the ported sources, by name, for the profile
WIRE_AGG_KERNELS = ("agg_q8_kernel", "agg_q4_kernel")
WIRE_STATS_KERNEL = "stats_q_kernel"
F32_STATS_KERNEL = "stats_f32_kernel"  # round_stats on f32 x
BF16_STATS_KERNEL = "stats_bf16_kernel"  # round_stats on bf16 x
SUM_KERNEL = "stats_sum_kernel"  # the statistics' dependent second launch
GDOT_KERNEL = "gdot_kernel"  # grad_dot_stats
PORTED = ("agg_kernel", *WIRE_AGG_KERNELS, F32_STATS_KERNEL,
          WIRE_STATS_KERNEL, BF16_STATS_KERNEL, SUM_KERNEL,
          "flash_tf32_kernel", "flash_mma_kernel", "bdot_stage", GDOT_KERNEL)
# device kernels of one call of each wire wrapper (round_stats on the f32
# and bf16 wires included): the aggregations fold w into the scales in
# their kernel; the statistics write block partials, then sum them in a
# second (programmatic dependent) launch
WIRE_CALL_KERNELS = {"agg_q8_kernel": 1, "agg_q4_kernel": 1,
                     WIRE_STATS_KERNEL: 2, F32_STATS_KERNEL: 1,
                     BF16_STATS_KERNEL: 1, SUM_KERNEL: 4}
# kernel instances whose SASS must hold 16-byte loads (LDG.E.128), by
# source: agg_q8_kernel and agg_q4_kernel<WIDE> (3); stats_q_kernel<INT4,
# WIDE, MASKED> for int8 and both int4 paths, masked and not (6);
# stats_f32_kernel<MASKED> and stats_bf16_kernel<MASKED> (4);
# gdot_kernel<T, SA, SB> for f32 and bf16, each input aligned or not (8).
# The wire kernels must hold no I2F.
SASS_INSTANCES = {"weighted_agg_q": (WIRE_AGG_KERNELS, 3),
                  "round_stats_q": ((WIRE_STATS_KERNEL,), 6),
                  "round_stats": ((F32_STATS_KERNEL, BF16_STATS_KERNEL), 4),
                  "grad_dot": ((GDOT_KERNEL,), 8)}
NO_I2F = ("weighted_agg_q", "round_stats_q")
GDOT_SPAN = 2048  # grad_dot.cu's kSpan: elements a block
# flash attention (BH, T, d, dtype, causal, blk_q, blk_k): the reference
# test's cases, then each kernel (bf16 and f32) at every head dim, causal
# and not, and at T = 96 and 40, not a multiple of its tiles
FLASH_CASES = ((4, 256, 64, "float32", True, 64, 64),
               (2, 256, 128, "float32", False, 128, 64),
               (2, 512, 64, "float32", True, 128, 128),
               (3, 128, 64, "bfloat16", True, 64, 32),
               (2, 256, 64, "bfloat16", False, 64, 64),
               (2, 256, 128, "bfloat16", True, 128, 64),
               (2, 256, 128, "bfloat16", False, 64, 64),
               (2, 256, 256, "bfloat16", True, 128, 128),
               (2, 256, 256, "bfloat16", False, 64, 64),
               (3, 96, 64, "bfloat16", True, 32, 32),
               (2, 96, 128, "bfloat16", False, 32, 32),
               (2, 96, 256, "bfloat16", True, 32, 32),
               (2, 96, 256, "float32", True, 32, 32),
               (2, 256, 64, "float32", False, 64, 64),
               (2, 256, 128, "float32", True, 128, 64),
               (2, 256, 256, "float32", True, 128, 128),
               (2, 256, 256, "float32", False, 64, 64),
               (3, 96, 64, "float32", True, 32, 32),
               (2, 96, 128, "float32", False, 32, 32),
               (2, 96, 256, "float32", False, 32, 32),
               (2, 40, 128, "float32", True, 8, 8),
               (2, 40, 256, "float32", False, 8, 8))
# gqa_flash at (B, T, hd) with these (H, G, dtype), and gemma-2b's
# prefill shape (B, T, H, G, hd)
FLASH_GQA = ((8, 1, "bfloat16"), (4, 2, "bfloat16"), (4, 2, "float32"))
FLASH_GQA_SHAPE = (2, 320, 256)
FLASH_MAIN = (4, 1024, 8, 1, 256)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # the reference test's
SERVE_B, SERVE_T, SERVE_STEPS = 4, 1024, 32
# federated LM training: the 100m preset of examples/torch_fl_lm_train.py
# at its defaults (K clients, tau local steps, B sequences of T tokens)
LM_PRESET, LM_ROUNDS = "100m", 3
LM_K, LM_TAU, LM_B, LM_T = 4, 2, 4, 256
LM_HEADS = (12, 4, 64)  # H query heads over G KV heads, head dim
# grads through gqa_flash under vmap(grad): clients, (B, T, H, G, hd)
LM_GRAD_N, LM_GRAD_SHAPE = 3, (2, 256, 12, 4, 64)
PARITY_B, PARITY_T, PARITY_TOL = 2, 512, 2e-4
# the other model families served at full width: (architecture, the cut
# of its config, the cut as printed, prompt tokens). B sequences, greedy
# steps through launch.serve.generate; bf16, flash attention
FAMILY_MODELS = (
    ("deepseek-v2-lite-16b", {}, "none", 1024),
    ("deepseek-v2-236b", {"num_layers": 2}, "depth 60 -> 2 layers", 1024),
    ("jamba-1.5-large-398b", {"num_layers": 8, "moe": {"num_experts": 4}},
     "depth 72 -> 8 (one pattern group); experts 16 -> 4, top-2 kept",
     1024),
    ("rwkv6-3b", {}, "none", 1024),  # a multiple of chunk_len 16
    ("qwen2-vl-2b", {}, "none", 1024),  # after the 256-patch stub prefix
    ("whisper-small", {}, "none", 384),  # its decoder's context is 448
)
FAMILY_B, FAMILY_STEPS = 4, 16
# the causal GQA attention layers of each (one flash launch a prefill)
FAMILY_FLASH = {"deepseek-v2-lite-16b": 0, "deepseek-v2-236b": 0,
                "jamba-1.5-large-398b": 1, "rwkv6-3b": 0, "qwen2-vl-2b": 28,
                "whisper-small": 12}
# the reduced (smoke) configs held card == CPU in f32: the six families
# and deepseek-v2-236b's q-LoRA branch, which reduced() zeroes
FAMILY_PARITY = tuple((name, {}) for name, *_ in FAMILY_MODELS) + (
    ("deepseek-v2-236b", {"mla": {"q_lora_rank": 32}}),)
FAMILY_PARITY_B, FAMILY_PARITY_T, FAMILY_PARITY_STEPS = 2, 64, 4
INIT_SLACK = 1e9  # bytes an init may hold beyond the params (one draw)
# the launch phase: the launcher's path at gemma-2b's full width and depth,
# host mesh (K = 1), and the dry run's prediction against the card
LAUNCH_ARGV = ["--arch", "gemma-2b", "--host-mesh", "--seq", "1024",
               "--global-batch", "4"]
LAUNCH_STEPS = {"train": (1024, 4), "prefill": (1024, 4), "decode": (4096, 4)}
ARG_RTOL, ARG_SLACK = 0.01, 512  # the allocator rounds a tensor to 512 B
PEAK_RATIO = (0.8, 1.25)  # the card's peak over the dry run's live bytes


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_us(fn, flush: torch.Tensor) -> float:
    """Median device time of `fn` over REPS launches (CUDA events), after
    warm-up. Before each launch the 256 MB `flush` buffer is summed: a
    read, so it evicts the 50 MB L2 without leaving dirty lines for the
    timed launch to write back, and every launch reads its inputs from
    HBM. A sleep kernel first holds the device back while the host
    enqueues every launch, so no timed interval waits on the host (a
    wrapper that launches two kernels with Python between them would
    otherwise be timed with the host's delay on a busy host)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in
                            zip(starts, ends)])) * 1e3


def bound_us(nbytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---- correctness measures (float64 on the card) ----

def agg_err(y, y_ref, w, x) -> tuple[float, float]:
    """(max |dy|, max |dy_n| / sum_k |w_k x_kn|)."""
    d = (y.double() - y_ref.double()).abs()
    scale = (w.double().abs()[:, None] * x.double().abs()).sum(0)
    return float(d.max()), float((d / scale.clamp_min(1e-30)).max())


def stats_err(got, ref, x, g, mask) -> tuple[float, float]:
    """(max abs error, max normalised error): dots against
    sum_n |x_kn g_n|, squared norms relative to themselves."""
    xd, gd = x.double(), g.double()
    if mask is not None:
        xd, gd = xd * mask.double()[None], gd * mask.double()
    scales = ((xd.abs() * gd.abs()[None]).sum(1), ref[1].double().abs(),
              ref[2].double().abs())
    abs_err = norm_err = 0.0
    for a, b, s in zip(got, ref, scales):
        d = (a.double() - b.double()).abs()
        abs_err = max(abs_err, float(d.max()))
        norm_err = max(norm_err, float((d / s.clamp_min(1e-30)).max()))
    return abs_err, norm_err


def spread(x: torch.Tensor, block: int) -> torch.Tensor:
    """x with its magnitude changed by orders of magnitude from one block
    of columns to the next, so a kernel that reads the wrong scale column
    fails loudly."""
    cols = torch.arange(x.shape[1], device=x.device) // block % 5
    return x * (10.0 ** cols.float())[None]


def shifted(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of x whose storage starts `offset` bytes past a
    16-byte boundary."""
    per = x.element_size()
    flat = torch.empty(x.numel() + 16 // per, dtype=x.dtype,
                       device=x.device)
    y = flat[offset // per:offset // per + x.numel()].view(x.shape)
    y.copy_(x)
    if y.data_ptr() % 16 != offset:
        raise AssertionError(f"storage at {y.data_ptr() % 16} mod 16, want "
                             f"{offset}")
    return y


def check_wire(name, agg, agg_plain, stats, stats_plain, q, x, w, g, mask,
               **kw):
    """One wire kernel pair against its plain versions: (worst abs error,
    worst normalised error) per wrapper name."""
    akw = dict(kw, n=x.shape[1]) if "group_size" in kw else {}
    y = agg(w, q.values, q.scales, **akw)
    a, na = agg_err(y, agg_plain(w, q.values, q.scales, **akw), w, x)
    if not torch.equal(y, agg(w, q.values, q.scales, **akw)):
        raise AssertionError(f"weighted_agg_{name}: a second launch gave "
                             "other bits")
    s_abs = ns = 0.0
    for m in (None, mask):
        got = stats(q.values, q.scales, g, m, **kw)
        sa, nm = stats_err(got, stats_plain(q.values, q.scales, g, m, **kw),
                           x, g, m)
        s_abs, ns = max(s_abs, sa), max(ns, nm)
        if not all(torch.equal(a, b) for a, b in
                   zip(got, stats(q.values, q.scales, g, m, **kw))):
            raise AssertionError(f"round_stats_{name}: a second launch gave "
                                 "other bits")
    return {f"weighted_agg_{name}": (a, na), f"round_stats_{name}": (s_abs,
                                                                    ns)}


def phase_kernels(wa, rs, tq, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(k, n):
        x = torch.randn(k, n, device=dev, generator=gen)
        g = torch.randn(n, device=dev, generator=gen)
        w = torch.rand(k, device=dev, generator=gen)
        mask = (torch.rand(n, device=dev, generator=gen) > 0.25).float()
        return x, g, w, mask

    shapes = ([(MAIN_K, MAIN_N)] + [(k, MAIN_N) for k in SHARD_KS]
              + [(k, n) for k in EDGE_KS for n in EDGE_NS])
    worst, main_abs = {}, {}
    for k, n in shapes:
        x, g, w, mask = inputs(k, n)
        errs = {}
        # the f32 kernels on f32 and on bf16 input (the bf16 wire), also
        # with x's storage 4, 8 and 12 bytes past a 16-byte boundary (a
        # rank's block of the buffered flush is such a view), and the
        # statistics with a second call giving the same bits
        xb = x.to(torch.bfloat16)
        for tag, xt in (("", x), ("_bf16", xb)):
            xins = [xt] + [shifted(xt, off) for off in (4, 8, 12)]
            xf = xins[0].float()
            a_abs = na = s_abs = ns = 0.0
            for xi in xins:
                aa, an = agg_err(
                    wa.weighted_agg(w, xi, out_dtype=torch.float32),
                    wa.weighted_agg_plain(w, xi, torch.float32), w, xf)
                a_abs, na = max(a_abs, aa), max(na, an)
            errs["weighted_agg" + tag] = (a_abs, na)
            for xi in xins:
                for m in (None, mask):
                    got = rs.round_stats(xi, g, m)
                    sa, nm = stats_err(got, rs.round_stats_plain(xi, g, m),
                                       xf, g, m)
                    s_abs, ns = max(s_abs, sa), max(ns, nm)
                    if not all(torch.equal(a, b) for a, b in zip(
                            got, rs.round_stats(xi, g, m))):
                        raise AssertionError(f"round_stats{tag}: a second "
                                             "launch gave other bits")
            errs["round_stats" + tag] = (s_abs, ns)
            del xins
        # the int8 and int4 wire kernels
        q8 = tq.quantize(spread(x, tq.CHUNK), "int8")
        errs.update(check_wire("q", wa.weighted_agg_q,
                               wa.weighted_agg_q_plain, rs.round_stats_q,
                               rs.round_stats_q_plain, q8, tq.dequantize(q8),
                               w, g, mask))
        for gs in GROUP_SIZES:
            q4 = tq.quantize(spread(x, gs), "int4", group_size=gs)
            for key, v in check_wire(
                    "q4", wa.weighted_agg_q4, wa.weighted_agg_q4_plain,
                    rs.round_stats_q4, rs.round_stats_q4_plain, q4,
                    tq.dequantize(q4), w, g, mask, group_size=gs).items():
                old = errs.get(key, (0.0, 0.0))
                errs[key] = (max(old[0], v[0]), max(old[1], v[1]))
        torch.cuda.synchronize()
        emit({"phase": "kernels", "check": [k, n],
              "norm_err": {key: v[1] for key, v in errs.items()}})
        for key, (a, e) in errs.items():
            worst[key] = max(worst.get(key, 0.0), e)
            if (k, n) == (MAIN_K, MAIN_N):
                main_abs[key] = a
            if not e <= TOL:
                raise AssertionError(f"{key} disagrees with its plain "
                                     f"version at K={k}, N={n}: {e}")

    # timing at the main path's shape and dtypes (no mask, as the round),
    # and of the kernels alone at WIDE_K clients: ~13x the bytes, so a
    # kernel whose time grows less than that is held back by a fixed cost
    # (launch, the one wave of blocks), not by the memory rate
    flush = torch.zeros(64 << 20, device=dev)
    rows = timing_rows(wa, rs, tq, *inputs(MAIN_K, MAIN_N)[:3])
    wide = timing_rows(wa, rs, tq, *inputs(WIDE_K, MAIN_N)[:3])
    table = {}
    for name, r in rows.items():
        us = time_us(r["kernel"], flush)
        plain_us = time_us(r["plain"], flush)
        lib_us = time_us(r["library"], flush) if r["library"] else None
        wide_us = time_us(wide[name]["kernel"], flush)
        b_us, b_by = bound_us(r["nbytes"], r["flops"])
        table[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{r['source']}.cu",
            "replaces": r["replaces"], "wire": r["wire"],
            "max_abs_err": main_abs[name], "max_err": worst[name],
            "tol": TOL,
            "us": us, "ms": us / 1e3, "plain_us": plain_us,
            "plain_ms": plain_us / 1e3, "bound_us": b_us,
            "bound_ms": b_us / 1e3, "bound_by": b_by,
            "library_us": lib_us,
            "library_ms": None if lib_us is None else lib_us / 1e3,
            "shape": [MAIN_K, MAIN_N], "bytes": r["nbytes"],
            "hbm_share_of_peak": b_us / us,
            "wide_k": WIDE_K, "wide_us": wide_us,
            "wide_hbm_share_of_peak": bound_us(wide[name]["nbytes"],
                                               wide[name]["flops"])[0]
            / wide_us,
        }
        emit({"phase": "kernels", "timing": table[name]})
    del flush
    # one call of each wire wrapper: exactly the device kernels of
    # WIRE_CALL_KERNELS, and no PyTorch op beside them
    wire = ("weighted_agg_q", "weighted_agg_q4", "round_stats_q",
            "round_stats_q4", "round_stats", "round_stats_bf16")
    ran = device_kernels(lambda: [rows[name]["kernel"]() for name in wire])
    calls = {key: sum(c for k, c in ran if key in k)
             for key in WIRE_CALL_KERNELS}
    emit({"phase": "kernels", "device_kernels_of_one_call_each": {
        "wrappers": wire, "kernels": ran}})
    if calls != WIRE_CALL_KERNELS or sum(c for _, c in ran) != sum(
            WIRE_CALL_KERNELS.values()):
        raise AssertionError(f"one call each of {wire} ran {ran}, want "
                             f"{WIRE_CALL_KERNELS}")
    return table


def timing_rows(wa, rs, tq, x, g, w) -> dict:
    """Every kernel variant of the round at x's shape: the kernel, its
    plain version, a PyTorch call of the same function where one exists,
    and the bytes and flops of its bound."""
    xb = x.to(torch.bfloat16)
    q8 = tq.quantize(x, "int8")
    q4 = tq.quantize(x, "int4", group_size=MAIN_GS)
    k, n = x.shape
    c8, c4, nb = q8.scales.shape[1], q4.scales.shape[1], q4.values.shape[1]
    stats_out = 4 * (2 * k + 1)
    f32 = torch.float32
    return {
        "weighted_agg": dict(
            kernel=lambda: wa.weighted_agg(w, x),
            plain=lambda: wa.weighted_agg_plain(w, x),
            library=lambda: w @ x,
            nbytes=4 * (k * n + k + n), flops=2 * k * n,
            replaces="src/repro/kernels/weighted_agg.py:187",
            source="weighted_agg", wire="f32"),
        "weighted_agg_bf16": dict(
            kernel=lambda: wa.weighted_agg(w, xb, out_dtype=f32),
            plain=lambda: wa.weighted_agg_plain(w, xb, f32),
            # no single call: matmul wants one dtype, and a bf16 matmul
            # returns a bf16 sum
            library=None,
            nbytes=2 * k * n + 4 * (k + n), flops=2 * k * n,
            replaces="src/repro/kernels/weighted_agg.py:187",
            source="weighted_agg", wire="bf16"),
        "round_stats": dict(
            kernel=lambda: rs.round_stats(x, g),
            plain=lambda: rs.round_stats_plain(x, g),
            library=None,  # no single torch call returns dots, sqs, ||g||^2
            nbytes=4 * (k * n + n) + stats_out, flops=4 * k * n + 2 * n,
            replaces="src/repro/kernels/round_stats.py:157",
            source="round_stats", wire="f32"),
        "round_stats_bf16": dict(
            kernel=lambda: rs.round_stats(xb, g),
            plain=lambda: rs.round_stats_plain(xb, g),
            library=None,
            nbytes=2 * k * n + 4 * n + stats_out, flops=4 * k * n + 2 * n,
            replaces="src/repro/kernels/round_stats.py:157",
            source="round_stats", wire="bf16"),
        # the wire kernels: no PyTorch call dequantizes and reduces in one
        "weighted_agg_q": dict(
            kernel=lambda: wa.weighted_agg_q(w, q8.values, q8.scales),
            plain=lambda: wa.weighted_agg_q_plain(w, q8.values, q8.scales),
            library=None,
            nbytes=k * n + 4 * (k * c8 + k + n), flops=2 * k * n + k * c8,
            replaces="src/repro/kernels/weighted_agg.py:236",
            source="weighted_agg_q", wire="int8"),
        "weighted_agg_q4": dict(
            kernel=lambda: wa.weighted_agg_q4(w, q4.values, q4.scales, n=n,
                                              group_size=MAIN_GS),
            plain=lambda: wa.weighted_agg_q4_plain(
                w, q4.values, q4.scales, n=n, group_size=MAIN_GS),
            library=None,
            nbytes=k * nb + 4 * (k * c4 + k + n), flops=2 * k * n + k * c4,
            replaces="src/repro/kernels/weighted_agg.py:298",
            source="weighted_agg_q", wire="int4"),
        "round_stats_q": dict(
            kernel=lambda: rs.round_stats_q(q8.values, q8.scales, g),
            plain=lambda: rs.round_stats_q_plain(q8.values, q8.scales, g),
            library=None,
            nbytes=k * n + 4 * (k * c8 + n) + stats_out,
            flops=5 * k * n + 2 * n,
            replaces="src/repro/kernels/round_stats.py:402",
            source="round_stats_q", wire="int8"),
        "round_stats_q4": dict(
            kernel=lambda: rs.round_stats_q4(q4.values, q4.scales, g,
                                             group_size=MAIN_GS),
            plain=lambda: rs.round_stats_q4_plain(q4.values, q4.scales, g,
                                                  group_size=MAIN_GS),
            library=None,
            nbytes=k * nb + 4 * (k * c4 + n) + stats_out,
            flops=5 * k * n + 2 * n,
            replaces="src/repro/kernels/round_stats.py:293",
            source="round_stats_q", wire="int4"),
    }


def phase_wire(tq, dev) -> dict:
    """The quantizer on the card against the quantizer on the CPU, bit for
    bit, at the main path's shape."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = spread(torch.randn(MAIN_K, MAIN_N, device=dev, generator=gen),
               MAIN_GS) * 1e-3
    x[-1, :tq.CHUNK + 5] = 0.0  # all-zero chunks and groups
    x_cpu = x.cpu()
    out = {"phase": "wire", "shape": [MAIN_K, MAIN_N]}
    for transport in ("bf16", "int8", "int4"):
        a = tq.quantize(x, transport, group_size=MAIN_GS)
        b = tq.quantize(x_cpu, transport, group_size=MAIN_GS)
        same = torch.equal(a.values.cpu().view(torch.uint8),
                           b.values.view(torch.uint8)) and (
            b.scales is None or torch.equal(a.scales.cpu().view(torch.int32),
                                            b.scales.view(torch.int32)))
        if not same:
            raise AssertionError(f"{transport}: the card's wire differs "
                                 "from the CPU's")
        out[transport] = {"values_bytes": a.values.numel()
                          * a.values.element_size(), "bit_equal": True}
    emit(out)
    return out


def image_task():
    from repro_torch.data import synthetic

    train, test = synthetic.make_image_task(num_train=12000, num_test=2000)
    spec = [("iid", None)] * 5 + [("xclass", 1)] * 5
    nodes = synthetic.make_federated(train, spec, samples_per_node=600,
                                     seed=1)
    return nodes, test


def slice_config(transport: str, **kw):
    import repro_torch

    return repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                local_steps=12, method="fedadp",
                                engine="flat", base_lr=0.05,
                                transport=transport, **kw)


def counters(wa, rs) -> dict:
    return {"weighted_agg": wa.weighted_agg, "round_stats": rs.round_stats,
            "weighted_agg_q": wa.weighted_agg_q,
            "weighted_agg_q4": wa.weighted_agg_q4,
            "round_stats_q": rs.round_stats_q,
            "round_stats_q4": rs.round_stats_q4}


def expected_launches(transport: str, rounds: int) -> dict:
    suffix = {"int8": "_q", "int4": "_q4"}.get(transport, "")
    want = {name: 0 for name in ("weighted_agg", "round_stats",
                                 "weighted_agg_q", "weighted_agg_q4",
                                 "round_stats_q", "round_stats_q4")}
    want["weighted_agg" + suffix] = 2 * rounds
    want["round_stats" + suffix] = rounds
    return want


def excess_err(pairs: dict, rtol: float, atol: float) -> tuple[float, str]:
    """The worst of max(|a - b| - rtol |b|) - atol over `pairs` ({name:
    (a, b)}) and its name: <= 0 passes."""
    excess = {}
    for key, (a, b) in pairs.items():
        d = (a.double() - b.double()).abs() - rtol * b.double().abs()
        excess[key] = float(d.max()) - atol
    worst = max(excess, key=excess.get)
    return excess[worst], worst


def state_pairs(a, ma, b, mb, keys=None) -> dict:
    """{name: (a's tensor, b's)} over two rounds' new states and metrics:
    params, angles, prev_delta, the EF residuals, the broadcast head."""
    pairs = {f"params/{k}": (a.params[k], b.params[k]) for k in a.params}
    pairs.update({f"prev_delta/{k}": (a.prev_delta[k], b.prev_delta[k])
                  for k in a.prev_delta})
    pairs["angle"] = (a.angle.smoothed, b.angle.smoothed)
    for field in ("ef", "dl_ef"):
        if getattr(a, field) is not None:
            pairs[field] = (getattr(a, field), getattr(b, field))
    if a.bcast is not None:
        pairs["bcast/head"] = (a.bcast.head, b.bcast.head)
    pairs.update({f"metrics/{k}": (ma[k], mb[k]) for k in (keys or ma)})
    return pairs


def counted_rounds(server, wrappers, rounds: int, eval_every: int = 1,
                   after=None):
    """`rounds` steps of `server` with every wrapper's count set to 0
    first: (ms of each step, its host metrics, the counts). Every metric
    must be finite and a flush's weights sum to 1. `after(server)` runs
    after each step, outside the timed span."""
    for fn in wrappers.values():
        fn.launches = 0
    ms, metrics = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        m = server.step(eval_every=eval_every)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after(server)
        for key, v in m.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"metric {key} is not finite: {v}")
        if int(m.get("flushed", 1)) and abs(
                float(np.sum(m["weights"])) - 1.0) > 1e-6:
            raise AssertionError(f"weights sum to {np.sum(m['weights'])}")
        metrics.append(m)
    return ms, metrics, {name: fn.launches for name, fn in wrappers.items()}


def phase_slice(wa, rs, tq, dev, nodes, test, transport) -> dict:
    import repro_torch
    from repro_torch.core import fl as fl_mod
    from repro_torch.models import small

    cfg = slice_config(transport)
    server = repro_torch.FedServer("cnn", cfg, nodes, test, batch_size=50,
                                   device=dev)
    n_params = fl_mod.param_count(server.params)
    if n_params != MAIN_N:
        raise AssertionError(f"CNN has {n_params} params, want {MAIN_N}")
    server.step(eval_every=0)  # warm-up: cuDNN plans, allocator
    server.reset()
    torch.cuda.synchronize()

    # the main path, counted: every launch of every wrapper in these rounds
    round_ms, ms, launches = counted_rounds(server, counters(wa, rs), 3)
    accs = [float(m["accuracy"]) for m in ms]
    if launches != expected_launches(transport, 3):
        raise AssertionError(f"{transport}: 3 rounds launched {launches}, "
                             "want 2 aggregations + 1 statistics per round "
                             "of the wire's kernels")

    # the quantizer's share of a round: one quantize of the round's (K, N)
    # f32 buffer (and the dequantize that error feedback and the tree
    # engine run), timed alone with CUDA events
    quant = {}
    if transport != "f32":
        buf = torch.randn(MAIN_K, MAIN_N, device=dev) * 1e-2
        flush = torch.zeros(64 << 20, device=dev)
        wire = tq.quantize(buf, transport)
        quant = {"quantize_us": time_us(lambda: tq.quantize(buf, transport),
                                        flush),
                 "dequantize_us": time_us(lambda: tq.dequantize(wire),
                                          flush)}
        del buf, flush, wire

    # flat == tree on the card, from the same state and batches
    from repro_torch.core import driver

    def loss_fn(p, b):
        return small.classification_loss(small.cnn_apply, p, *b)

    gen = torch.Generator(device=dev).manual_seed(123)
    sel = driver.select_clients(gen, 10, 10)
    batches = driver.epoch_batches(gen, server.data, sel)
    sizes = server.data.sizes[sel].float()
    # Each engine trains its clients anew. cuDNN's default backward
    # algorithms sum with atomics, so two trainings differ in the last
    # bits, and on the synthetic images' flat 0/1 plateaus such bits flip
    # max-pool winners; deterministic algorithms make both engines see
    # the same deltas, so the comparison is of the engines alone.
    torch.backends.cudnn.deterministic = True
    outs = {}
    for engine in ("flat", "tree"):
        c = dataclasses.replace(cfg, engine=engine)
        outs[engine] = fl_mod.make_round_fn(loss_fn, c)(
            server.state, batches, sel, sizes)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    worst, where = excess_err(state_pairs(*outs["flat"], *outs["tree"]),
                              1e-5, 1e-5)
    if worst > 0:
        raise AssertionError(f"{transport}: flat and tree rounds differ at "
                             f"{where}: {worst}")

    out = {"phase": "slice", "model": "cnn", "transport": transport,
           "params": n_params, "clients": 10, "local_steps": 12,
           "batch": 50, "round_ms": round_ms, "accuracy": accs,
           "launches": launches, **quant,
           "flat_vs_tree_excess_err": worst,
           "flat_vs_tree_worst": where, "profile": profile_round(server)}
    emit(out)
    return launches


def phase_error_feedback(nodes, test, dev) -> dict:
    """int8 with and without error feedback from the same seed: the same
    round 1 (the residual starts at zero), different rounds from 2 on;
    the carried residual is finite and nonzero. Deterministic cuDNN, so
    the two runs train the same deltas until the residual enters."""
    import repro_torch

    torch.backends.cudnn.deterministic = True
    servers = {ef: repro_torch.FedServer(
        "cnn", slice_config("int8", error_feedback=ef), nodes, test,
        batch_size=50, device=dev) for ef in (False, True)}
    gaps = []
    for _ in range(3):
        for s in servers.values():
            s.step(eval_every=0)
        gaps.append(max(float((servers[True].params[k]
                               - servers[False].params[k]).abs().max())
                        for k in servers[True].params))
    torch.backends.cudnn.deterministic = False
    ef = servers[True].state.ef
    ef_abs = float(ef.abs().max())
    if servers[False].state.ef is not None:
        raise AssertionError("a config without error_feedback carries ef")
    if not (math.isfinite(ef_abs) and ef_abs > 0
            and bool(torch.isfinite(ef).all())):
        raise AssertionError(f"state.ef is not finite and nonzero: {ef_abs}")
    if not (gaps[0] <= 1e-6 and min(gaps[1:]) > 10 * max(gaps[0], 1e-7)):
        raise AssertionError(f"EF trajectory gaps per round {gaps}: want "
                             "the same round 1 and a gap from round 2 on")
    out = {"phase": "error_feedback", "transport": "int8",
           "param_gap_per_round": gaps, "ef_abs_max": ef_abs}
    emit(out)
    return out


# ---- the rest of the server round: the downlink, sequential mode and the
# buffered-async server ----

# (name, FLConfig fields, clients a round) of the downlink phase
DOWNLINK_CONFIGS = (
    ("int8_down", dict(transport="f32", downlink="int8"), 10),
    ("bf16_down_ef_int8_up", dict(transport="int8", downlink="bf16",
                                  downlink_error_feedback=True), 10),
    ("int8_delta_ring2_int4_up", dict(transport="int4", downlink="int8",
                                      downlink_delta=True, downlink_ring=2),
     5),
)
SEQ_TOL = (2e-4, 2e-5)  # rtol, atol of the reference's seq == parallel
# local steps of the seq == parallel round: sequential mode trains a
# client's batch of 50 alone, vmap folds the K clients into one batch of
# 500, and the convs round the two differently; local training amplifies
# that (on the CPU, 12 steps from a trained state put 2.4% between one
# client's two deltas), so the engines are compared over 2 steps
SEQ_TAU = 2
# the metrics buffered(m = K) and sync share the formula of (divergence
# averages over the landed rows in the buffered tick)
EQUIV_KEYS = ("loss", "theta", "theta_smoothed", "weights", "cos",
              "expected_contribution")


def cnn_loss(p, b):
    from repro_torch.models import small

    return small.classification_loss(small.cnn_apply, p, *b)


def check_decode(downlink, bcast, base, w: int, ring: int) -> str:
    """A client at version w pulling `bcast`'s head: "decoded" when it
    replays the ring bitwise onto the head, "resync" when it must (and
    client_decode refuses); raises otherwise."""
    v = int(bcast.head_ver)
    if bool(downlink.resync_mask(w, v, ring)):
        try:
            downlink.client_decode(bcast, base, w)
        except ValueError:
            return "resync"
        raise AssertionError(f"client_decode replayed {w} -> {v} past a "
                             f"{ring}-deep ring")
    got = downlink.client_decode(bcast, base, w)
    if not torch.equal(got.view(torch.int32), bcast.head.view(torch.int32)):
        raise AssertionError(f"a client at version {w} decodes version {v} "
                             "off the head")
    return "decoded"


def phase_downlink(wa, rs, tq, dev, nodes, test) -> dict:
    """The quantized and delta downlink on the CNN at full width: per
    config, 3 counted rounds through FedServer (2 + 1 launches of the
    uplink wire's kernels a round), flat == tree, the (1, N) compress on
    the card == on the CPU, and, for the delta config, every pull against
    the ring: a client re-selected after sitting out decodes bitwise to
    the head, `ver` and `head_ver` follow the recorded cohorts."""
    import repro_torch
    from repro_torch.core import driver
    from repro_torch.core import fl as fl_mod
    from repro_torch.core import treemath
    from repro_torch.transport import downlink

    wrappers = counters(wa, rs)
    out = {"phase": "downlink", "model": "cnn", "params": MAIN_N,
           "configs": {}}
    for name, kw, k in DOWNLINK_CONFIGS:
        cfg = dataclasses.replace(slice_config(**kw), clients_per_round=k)
        server = repro_torch.FedServer("cnn", cfg, nodes, test,
                                       batch_size=50, device=dev)
        server.step(eval_every=0)  # warm-up
        server.reset()
        torch.cuda.synchronize()
        cohorts, real_select = [], driver.select_clients

        def record(gen, num_clients, kk):
            sel = real_select(gen, num_clients, kk)
            cohorts.append(sel.tolist())
            return sel

        heads = {}

        def keep_head(s):
            if s.state.bcast is not None:
                heads[int(s.state.bcast.head_ver)] = s.state.bcast.head.clone()

        driver.select_clients = record
        try:
            round_ms, _, launches = counted_rounds(server, wrappers, 3,
                                                   after=keep_head)
        finally:
            driver.select_clients = real_select
        if launches != expected_launches(cfg.transport, 3):
            raise AssertionError(f"{name}: 3 rounds launched {launches}")
        st = server.state
        n_params = fl_mod.param_count(st.params)
        if n_params != MAIN_N:
            raise AssertionError(f"CNN has {n_params} params, want {MAIN_N}")
        row = {"clients": k, "round_ms": round_ms, "launches": launches,
               "round_bytes": tq.round_bytes(
                   k, n_params, cfg.transport, cfg.downlink,
                   group_size=cfg.group_size),
               "cohorts": cohorts}

        # the (1, N) compress on the card against the CPU's, bit for bit
        pvec, _ = treemath.tree_ravel(st.params)
        vecs = {"params": pvec}
        if cfg.downlink_delta:
            vecs["diff"] = pvec - st.bcast.head
        for vname, vec in vecs.items():
            a = downlink.compress(vec, cfg.downlink)
            b = downlink.compress(vec.cpu(), cfg.downlink)
            if not (torch.equal(a.values.cpu().view(torch.uint8),
                                b.values.view(torch.uint8))
                    and (b.scales is None or torch.equal(
                        a.scales.cpu().view(torch.int32),
                        b.scales.view(torch.int32)))):
                raise AssertionError(f"{name}: the card's (1, N) compress "
                                     f"of {vname} differs from the CPU's")
        row["compress_bit_equal"] = list(vecs)

        if cfg.downlink_delta:
            row.update(delta_checks(fl_mod, driver, downlink, server, cfg,
                                    cohorts, heads))
        elif cfg.downlink_error_feedback:
            res = float(st.dl_ef.abs().max())
            if not (math.isfinite(res) and res > 0):
                raise AssertionError(f"{name}: dl_ef is {res}")
            row["dl_ef_abs_max"] = res

        # flat == tree, from the same state and batches
        gen = torch.Generator(device=dev).manual_seed(321)
        sel = driver.select_clients(gen, 10, k)
        batches = driver.epoch_batches(gen, server.data, sel)
        sizes = server.data.sizes[sel].float()
        torch.backends.cudnn.deterministic = True
        outs = {e: fl_mod.make_round_fn(cnn_loss, dataclasses.replace(
            cfg, engine=e))(st, batches, sel, sizes)
            for e in ("flat", "tree")}
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        worst, where = excess_err(state_pairs(*outs["flat"], *outs["tree"]),
                                  1e-5, 1e-5)
        if worst > 0:
            raise AssertionError(f"{name}: flat and tree rounds differ at "
                                 f"{where}: {worst}")
        row.update(flat_vs_tree_excess_err=worst, flat_vs_tree_worst=where)
        out["configs"][name] = row
        del server, outs, st
    emit(out)
    return out


def delta_checks(fl_mod, driver, downlink, server, cfg, cohorts,
                 heads) -> dict:
    """The delta downlink's per-client state after the counted rounds:
    `ver` and `head_ver` as the recorded cohorts imply; then two more
    rounds with the last cohort sitting out one, so that each of its
    clients is re-selected two versions on and must decode bitwise onto
    the head from the base it pulled, and every other pull decodes or is
    a resync as the ring's depth says. `heads`: the head of each version
    the counted rounds published."""
    st = server.state
    want = [downlink.NEVER_PULLED] * cfg.num_clients
    for r, sel in enumerate(cohorts):
        for c in sel:
            want[c] = r
    if st.bcast.ver.tolist() != want or int(st.bcast.head_ver) != \
            len(cohorts) - 1:
        raise AssertionError(f"ver {st.bcast.ver.tolist()} / head_ver "
                             f"{int(st.bcast.head_ver)}, want {want} / "
                             f"{len(cohorts) - 1}")
    last = cohorts[-1]
    rest = [c for c in range(cfg.num_clients) if c not in last]
    rest = rest[:cfg.clients_per_round]
    round_fn = fl_mod.make_round_fn(cnn_loss, cfg)
    gen = torch.Generator(device=st.bcast.head.device).manual_seed(99)
    outcome = {"decoded": 0, "resync": 0}
    for sel in (rest, last):
        ver_before = st.bcast.ver.clone()
        sel_t = torch.tensor(sel, device=gen.device)
        batches = driver.epoch_batches(gen, server.data, sel_t)
        st, _ = round_fn(st, batches, sel_t,
                         server.data.sizes[sel_t].float())
        heads[int(st.bcast.head_ver)] = st.bcast.head.clone()
        for c in sel:
            w = int(ver_before[c])
            outcome[check_decode(downlink, st.bcast, heads.get(w), w,
                                 cfg.downlink_ring)] += 1
    torch.cuda.synchronize()
    if outcome["decoded"] < len(last):
        raise AssertionError(f"the re-selected cohort {last} did not all "
                             f"decode: {outcome}")
    v = int(st.bcast.head_ver)
    if [int(st.bcast.ver[c]) for c in last] != [v] * len(last):
        raise AssertionError("the re-selected clients' ver did not move")
    return {"pulls_after": outcome, "ver": st.bcast.ver.tolist(),
            "head_ver": v}


def phase_sequential(wa, rs, dev, nodes, test) -> tuple[dict, int]:
    """Sequential mode on the CNN at full width, K = 10, fedadp, the
    exact round and stale_angles: 3 counted rounds each through
    FedServer, exactly K round_stats launches a round at (1, N) and no
    aggregation; then one exact round against the parallel tree round
    from the initial model and the same batches (continuous images,
    SEQ_TAU local steps, deterministic cuDNN) at the reference's 2e-4 /
    2e-5. Returns (the phase's line,
    the exact round's round_stats launches)."""
    import repro_torch
    from repro_torch.core import fl as fl_mod

    wrappers = counters(wa, rs)
    out = {"phase": "sequential", "model": "cnn", "params": MAIN_N,
           "clients": 10, "local_steps": 12, "batch": 50}
    k1_launches = 0
    for stale in (False, True):
        cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                   local_steps=12, method="fedadp",
                                   mode="sequential", stale_angles=stale,
                                   base_lr=0.05)
        server = repro_torch.FedServer("cnn", cfg, nodes, test,
                                       batch_size=50, device=dev)
        server.step(eval_every=0)  # warm-up
        server.reset()
        torch.cuda.synchronize()
        state = server.state
        round_ms, ms, launches = counted_rounds(server, wrappers, 3)
        want = {name: 0 for name in wrappers}
        want["round_stats"] = 3 * 10
        if launches != want:
            raise AssertionError(f"sequential (stale={stale}): 3 rounds "
                                 f"launched {launches}, want {want}")
        key = "stale" if stale else "exact"
        out[key] = {"round_ms": round_ms, "launches": launches,
                    "accuracy": [float(m["accuracy"]) for m in ms]}
        if not stale:
            k1_launches = launches["round_stats"]
            start = state
        del server

    # the exact round against the parallel tree round, from the initial
    # model, over SEQ_TAU local steps
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.rand((10, SEQ_TAU, 50, 28, 28, 1), generator=gen, device=dev)
    y = torch.randint(0, 10, (10, SEQ_TAU, 50), generator=gen, device=dev)
    sel = torch.arange(10, device=dev)
    sizes = torch.full((10,), 600.0, device=dev)
    base = dict(num_clients=10, clients_per_round=10, local_steps=12,
                method="fedadp", base_lr=0.05)
    torch.backends.cudnn.deterministic = True
    outs = {mode: fl_mod.make_round_fn(cnn_loss, repro_torch.FLConfig(
        mode=mode, **base))(start, (x, y), sel, sizes)
        for mode in ("sequential", "parallel")}
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    worst, where = excess_err(state_pairs(
        *outs["sequential"], *outs["parallel"],
        keys=("theta", "theta_smoothed", "weights")), *SEQ_TOL)
    out.update(seq_vs_parallel_excess_err=worst, seq_vs_parallel_worst=where,
               tol=list(SEQ_TOL), seq_vs_parallel_local_steps=SEQ_TAU)
    emit(out)
    if worst > 0:
        raise AssertionError(f"sequential and parallel rounds differ at "
                             f"{where}: {worst}")
    return out, k1_launches


def golden_schedule():
    """The golden buffered task's arrival schedule (delays, drops), (T, K)
    numpy, and its task, from tests/golden/convergence.json."""
    with open(os.path.join(ROOT, "tests", "golden", "convergence.json")) as f:
        t = json.load(f)["buffered"]["task"]
    s = t["schedule"]
    delays = np.zeros((s["ticks"], s["num_clients"]), np.int32)
    drops = np.zeros_like(delays, bool)
    for tk, c in s["stragglers"]:
        delays[tk, c] = s["delay"]
    for tk, c in s["drops"]:
        drops[tk, c] = True
    return delays, drops, t


def buffered_config(transport: str, task: dict, **kw):
    import repro_torch

    return repro_torch.FLConfig(
        num_clients=10, clients_per_round=10, local_steps=12,
        method="fedadp", engine="flat", base_lr=0.05, transport=transport,
        group_size=task["group_size"], aggregation="buffered",
        buffer_m=task["buffer_m"], staleness_beta=task["staleness_beta"],
        **kw)


def phase_buffered(wa, rs, dev, nodes, test) -> dict:
    """The buffered-async server on the CNN at full width: buffered(m = K)
    == sync from one state and batches (f32: bit for bit; int8 uplink:
    1e-5, the sync round reading the wire with the _q kernels), then the
    golden buffered schedule's 8 ticks through FedServer on the int8
    uplink: each tick runs 2 + 1 f32 kernel launches over the buffer's
    dequantized rows and no _q kernel, and flushes on the ticks of the
    same schedule's CPU run."""
    import repro_torch
    from repro_torch.core import driver
    from repro_torch.core import fl as fl_mod

    delays, drops, task = golden_schedule()
    out = {"phase": "buffered", "model": "cnn", "params": MAIN_N,
           "buffer_m": task["buffer_m"],
           "staleness_beta": task["staleness_beta"]}

    # buffered(m = K, no stragglers) == sync
    state_srv = repro_torch.FedServer("cnn", slice_config("f32"), nodes,
                                      test, batch_size=50, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    sel = driver.select_clients(gen, 10, 10)
    batches = driver.epoch_batches(gen, state_srv.data, sel)
    sizes = state_srv.data.sizes[sel].float()
    out["equivalence"] = {}
    torch.backends.cudnn.deterministic = True
    for transport, tol in (("f32", 0.0), ("int8", 1e-5)):
        sync_cfg = slice_config(transport)
        buf_cfg = dataclasses.replace(sync_cfg, aggregation="buffered")
        a = fl_mod.make_round_fn(cnn_loss, sync_cfg)(
            fl_mod.init_round_state(sync_cfg, state_srv.params), batches,
            sel, sizes)
        b = fl_mod.make_round_fn(cnn_loss, buf_cfg)(
            fl_mod.init_round_state(buf_cfg, state_srv.params), batches,
            sel, sizes)
        torch.cuda.synchronize()
        worst, where = excess_err(state_pairs(*b, *a, keys=EQUIV_KEYS),
                                  0.0, tol)
        out["equivalence"][transport] = {"tol": tol, "excess_err": worst,
                                         "worst": where}
        if worst > 0 or not bool(b[0].buf.free.all()):
            raise AssertionError(f"buffered(m = K) != sync on {transport} at "
                                 f"{where}: {worst}")
    torch.backends.cudnn.deterministic = False
    del state_srv

    # the golden schedule: the CPU's flush ticks (MLR: they depend on the
    # schedule alone), then the card's on the CNN, counted
    cpu = repro_torch.FedServer(
        "mlr", buffered_config("int8", task), nodes, test, batch_size=50,
        device="cpu",
        arrival_fn=repro_torch.fixed_arrival_schedule(delays, drops))
    cpu_flush = [int(cpu.step()["flushed"]) for _ in range(len(delays))]
    server = repro_torch.FedServer(
        "cnn", buffered_config("int8", task), nodes, test, batch_size=50,
        device=dev,
        arrival_fn=repro_torch.fixed_arrival_schedule(delays, drops))
    server.step(eval_every=0)  # warm-up
    server.reset()
    torch.cuda.synchronize()
    wrappers = counters(wa, rs)
    tick_ms, ms, launches = counted_rounds(server, wrappers, len(delays))
    flush = [int(m["flushed"]) for m in ms]
    ticks = len(delays)
    want = {name: 0 for name in wrappers}
    want.update(weighted_agg=2 * ticks, round_stats=ticks)
    out.update(transport="int8", ticks=ticks, tick_ms=tick_ms,
               flushed=flush, cpu_flushed=cpu_flush,
               landed=[int(m["buffer_landed"]) for m in ms],
               staleness=[float(m["staleness"]) for m in ms],
               accuracy=[float(m["accuracy"]) for m in ms],
               launches=launches)
    emit(out)
    if flush != cpu_flush:
        raise AssertionError(f"flush ticks {flush}, the CPU's {cpu_flush}")
    if launches != want:
        raise AssertionError(f"{ticks} ticks launched {launches}, want "
                             f"{want}")
    return out


# ---- the run surface: scanned mode, checkpoint and kill/resume, round
# telemetry ----

RESUME_BLOCK = 2  # rounds a block; the uninterrupted run is 2 blocks


def tree_mismatches(a, b) -> list:
    """The paths at which two trees of tensors (and GeneratorStates)
    differ in any bit, dtype or shape."""
    from repro_torch.core import treemath

    pa, pb = treemath.tree_paths(a), treemath.tree_paths(b)
    if pa != pb:
        return ["<structure>"]
    bad = []
    for path, x, y in zip(pa, treemath.tree_leaves(a),
                          treemath.tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            same = (x.dtype == y.dtype and x.shape == y.shape and torch.equal(
                x.detach().contiguous().reshape(-1).view(torch.uint8),
                y.detach().contiguous().reshape(-1).view(torch.uint8)))
        else:
            same = x == y
        if not same:
            bad.append("/".join(map(str, path)))
    return bad


def history_mismatches(h, h_ref, start: int) -> list:
    """The History fields where `h` differs from `h_ref`'s rounds from
    `start` on, bit for bit."""
    bad = [key for key in ("accuracy", "loss", "divergence")
           if getattr(h, key) != getattr(h_ref, key)[start:]]
    for key in ("thetas", "weights"):
        got, want = getattr(h, key), getattr(h_ref, key)[start:]
        if len(got) != len(want) or any(
                a.tobytes() != b.tobytes() for a, b in zip(got, want)):
            bad.append(key)
    return bad


def phase_resume(wa, rs, dev, nodes, test) -> dict:
    """Kill/resume on the CNN at full width, bit for bit: an uninterrupted
    scanned run of 2 blocks x 2 rounds with a checkpoint at each block
    edge, then a fresh FedServer restored from the first edge's archive
    runs block 2. Params, both EF residuals, the broadcast ring, head and
    `ver`, the report buffer, the angles, the round, the generator's
    state and every History entry must equal the uninterrupted run's bit
    for bit, and the two generators draw the same next numbers. Two
    configs: the int8 uplink with EF and the int8 delta downlink with EF
    at 5 of 10 clients (every optional sync field live), and the buffered
    server on the int8 uplink with EF under the golden schedule one tick
    later (a report in flight at the edge). Both sides launch 2 + 1 of
    the wire's kernels a round. Deterministic cuDNN: a cuDNN training
    sums with atomics otherwise, and two runs part in the last bits."""
    import shutil
    import tempfile

    import repro_torch
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import fl as fl_mod

    delays, drops, task = golden_schedule()
    # one tick later (its last tick, all on time, first), so that a
    # straggler's report is in flight at the block edge
    delays, drops = np.roll(delays, 1, axis=0), np.roll(drops, 1, axis=0)
    wrappers = counters(wa, rs)
    configs = {
        "int8ef_up_int8ef_delta_down_5of10": (dataclasses.replace(
            slice_config("int8", error_feedback=True, downlink="int8",
                         downlink_error_feedback=True, downlink_delta=True),
            clients_per_round=5), None),
        "buffered_int8ef_golden_schedule_late": (
            buffered_config("int8", task, error_feedback=True),
            (delays, drops)),
    }
    rounds = 2 * RESUME_BLOCK
    t_phase = time.perf_counter()
    out = {"phase": "resume", "model": "cnn", "params": MAIN_N,
           "block": RESUME_BLOCK, "rounds": rounds, "configs": {}}
    torch.backends.cudnn.deterministic = True
    for name, (cfg, sched) in configs.items():
        buffered = cfg.aggregation == "buffered"

        def server():
            s = repro_torch.FedServer(
                "cnn", cfg, nodes, test, batch_size=50, device=dev,
                arrival_fn=(repro_torch.fixed_arrival_schedule(*sched)
                            if sched else None))
            s.step(eval_every=0)  # warm-up: cuDNN plans, allocator
            s.reset()
            torch.cuda.synchronize()
            return s

        def want(n):
            if buffered:  # the buffer's f32 rows on every wire
                return {k: ({"weighted_agg": 2 * n, "round_stats": n}
                            .get(k, 0)) for k in wrappers}
            return expected_launches(cfg.transport, n)

        tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
        try:
            ref = server()
            for fn in wrappers.values():
                fn.launches = 0
            h_ref = ref.run(rounds, eval_every=1, mode="scanned",
                            block=RESUME_BLOCK, ckpt_dir=tmp, ckpt_keep=0)
            launches_ref = {k: fn.launches for k, fn in wrappers.items()}
            saved = dict(ckpt_io.list_checkpoints(tmp))
            edge = RESUME_BLOCK
            res = server()
            for fn in wrappers.values():
                fn.launches = 0
            if res.restore(saved[edge]) != edge:
                raise AssertionError(f"{name}: restored at round "
                                     f"{res.round}, want {edge}")
            h_res = res.run(rounds - edge, eval_every=1, mode="scanned",
                            block=RESUME_BLOCK)
            launches_res = {k: fn.launches for k, fn in wrappers.items()}
            torch.cuda.synchronize()
            bad = tree_mismatches(fl_mod.state_to_tree(res.state),
                                  fl_mod.state_to_tree(ref.state))
            bad += history_mismatches(h_res, h_ref, edge)
            draws = [torch.rand(4, generator=s.state.rng, device=dev)
                     for s in (ref, res)]
            same_stream = torch.equal(*draws)

            # one checkpoint's size, write and read (+ restore) times
            path = os.path.join(tmp, "timed")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ckpt_io.save(path, fl_mod.state_to_tree(ref.state))
            write_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            back = fl_mod.state_from_tree(cfg, ckpt_io.load(path),
                                          device=dev)
            torch.cuda.synchronize()
            read_ms = (time.perf_counter() - t0) * 1e3
            bad += [f"reread/{p}" for p in tree_mismatches(
                fl_mod.state_to_tree(back), fl_mod.state_to_tree(ref.state))]
            row = {"checkpoints": sorted(saved),
                   "bytes": os.path.getsize(path),
                   "write_ms": write_ms, "read_restore_ms": read_ms,
                   "launches_uninterrupted": launches_ref,
                   "launches_resumed": launches_res,
                   "mismatches": bad, "generator_continues": same_stream,
                   "accuracy": h_ref.accuracy}
            if buffered:
                row["in_flight_at_edge"] = int(
                    (~ckpt_io.load(saved[edge])["buf"]["free"]).sum())
            if ref.state.bcast is not None:
                row["ver"] = ref.state.bcast.ver.tolist()
            out["configs"][name] = row
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if bad or not same_stream:
            emit(out)
            raise AssertionError(f"resume {name}: the resumed run differs "
                                 f"at {bad} (generator continues: "
                                 f"{same_stream})")
        if launches_ref != want(rounds) or launches_res != want(
                rounds - edge):
            emit(out)
            raise AssertionError(f"resume {name}: launches {launches_ref} / "
                                 f"{launches_res}, want {want(rounds)} / "
                                 f"{want(rounds - edge)}")
        if buffered and not row["in_flight_at_edge"]:
            emit(out)
            raise AssertionError(f"resume {name}: no report in flight at "
                                 "the block edge")
        del ref, res, back
    torch.backends.cudnn.deterministic = False
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def host_syncs(fn) -> int:
    """The synchronizing CUDA calls `fn` makes (torch's sync debug mode,
    counted from its warnings)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's first use also warns that it is a prototype: not a sync
    return sum(str(w.message).startswith("called a synchronizing")
               for w in caught)


def expected_down_split(cohorts, ring: int, unit: int) -> list:
    """(delta bytes, full bytes) of each round's pulls under a delta
    downlink, from the recorded cohorts: one payload per version a
    client is behind, a full model when it never pulled or is more than
    `ring` versions behind."""
    last, out = {}, []
    for v, sel in enumerate(cohorts):
        d = f = 0
        for c in sel:
            w = last.get(c)
            if w is None or v - w > ring:
                f += 1
            else:
                d += v - w
            last[c] = v
        out.append((d * unit, f * unit))
    return out


def timed_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_telemetry(wa, rs, tq, dev, nodes, test) -> dict:
    """FLConfig(telemetry="node") on the CNN at full width: per config
    (the f32 round; the int8 uplink with the int8 delta downlink at 5 of
    10), 3 rounds with telemetry on into a JSONLSink and 3 with it off
    from the same seed. The stream validates, each round has K node
    events, bytes_up is `round_bytes`'s, bytes_down its K pulls or, under
    delta, the split the recorded cohorts imply; the two runs' states and
    Histories are bitwise equal and launch the same 2 + 1 wire kernels a
    round; a round with telemetry on makes no more host syncs than one
    with it off. Then the sequential round on and off (bitwise, 10
    round_stats launches each), the device kernels of one profiled round
    with telemetry off and on, ms a round stepwise against scanned
    (block = 8) in turns, and the idle share of one profiled scanned
    block beside 8 profiled stepwise rounds. Deterministic cuDNN for the
    bitwise comparisons."""
    import shutil
    import tempfile

    import repro_torch
    from repro_torch.core import driver
    from repro_torch.core import fl as fl_mod
    from repro_torch.telemetry import schema, sinks

    wrappers = counters(wa, rs)
    t_phase = time.perf_counter()
    out = {"phase": "telemetry", "model": "cnn", "params": MAIN_N,
           "configs": {}}
    configs = {
        "f32": slice_config("f32"),
        "int8_up_int8_delta_down_5of10": dataclasses.replace(
            slice_config("int8", downlink="int8", downlink_delta=True),
            clients_per_round=5),
    }
    tmp = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    torch.backends.cudnn.deterministic = True
    try:
        for name, cfg in configs.items():
            k = cfg.clients_per_round
            runs = {}
            for tel in ("node", None):
                s = repro_torch.FedServer(
                    "cnn", dataclasses.replace(cfg, telemetry=tel), nodes,
                    test, batch_size=50, device=dev)
                s.step(eval_every=0)  # warm-up
                s.reset()
                torch.cuda.synchronize()
                sink = sinks.JSONLSink(os.path.join(tmp, f"{name}.jsonl")) \
                    if tel else None
                cohorts, real_select = [], driver.select_clients

                def record(gen, num_clients, kk):
                    sel = real_select(gen, num_clients, kk)
                    cohorts.append(sel.tolist())
                    return sel

                for fn in wrappers.values():
                    fn.launches = 0
                driver.select_clients = record
                try:
                    hist = s.run(3, eval_every=1, sink=sink)
                finally:
                    driver.select_clients = real_select
                launches = {key: fn.launches for key, fn in wrappers.items()}
                if sink is not None:
                    sink.close()
                # the host syncs inside one round, outside the metrics copy
                syncs = host_syncs(lambda: s._step_fn(s.state, 1))
                runs[tel] = (s, hist, launches, cohorts, syncs)
            (s_on, h_on, l_on, cohorts, sync_on) = runs["node"]
            (s_off, h_off, l_off, _, sync_off) = runs[None]
            events = sinks.load_events(os.path.join(tmp, f"{name}.jsonl"))
            counts = schema.validate_events(events)
            rounds = [e for e in events if e["event"] == "round"]
            rb = tq.round_bytes(k, MAIN_N, cfg.transport, cfg.downlink,
                                group_size=cfg.group_size)
            bad = []
            if counts["round"] != 3 or counts["node"] != 3 * k:
                bad.append(f"event counts {counts}")
            if cfg.downlink_delta:
                split = expected_down_split(
                    cohorts, cfg.downlink_ring,
                    tq.wire_bytes(1, MAIN_N, cfg.downlink))
                got = [(e["bytes_down_delta"], e["bytes_down_full"])
                       for e in rounds]
                if got != split or any(
                        e["bytes_down"] != sum(p) for e, p in
                        zip(rounds, split)):
                    bad.append(f"bytes_down split {got}, want {split}")
            elif any(e["bytes_down"] != rb["down"] for e in rounds):
                bad.append("bytes_down")
            if any(e["bytes_up"] != rb["up"] for e in rounds):
                bad.append("bytes_up")
            diff = tree_mismatches(fl_mod.state_to_tree(s_on.state),
                                   fl_mod.state_to_tree(s_off.state))
            diff += history_mismatches(h_on, h_off, 0)
            if diff:
                bad.append(f"on != off at {diff}")
            if l_on != l_off or l_on != expected_launches(cfg.transport, 3):
                bad.append(f"launches on {l_on} / off {l_off}")
            if sync_on > sync_off:
                bad.append(f"host syncs a round on {sync_on} > off "
                           f"{sync_off}")
            out["configs"][name] = {
                "clients": k, "events": counts, "launches": l_on,
                "host_syncs_round": {"on": sync_on, "off": sync_off},
                "bytes_up": [e["bytes_up"] for e in rounds],
                "bytes_down": [e["bytes_down"] for e in rounds],
                "bytes_down_delta": [e.get("bytes_down_delta")
                                     for e in rounds],
                "bytes_down_full": [e.get("bytes_down_full")
                                    for e in rounds],
                "cohorts": cohorts,
                "weight_entropy": [e["weight_entropy"] for e in rounds],
                "mismatches": bad}
            if bad:
                emit(out)
                raise AssertionError(f"telemetry {name}: {bad}")

        # the sequential round, on and off
        seq = {}
        for tel in ("node", None):
            cfg = repro_torch.FLConfig(
                num_clients=10, clients_per_round=10, local_steps=12,
                method="fedadp", mode="sequential", base_lr=0.05,
                telemetry=tel)
            s = repro_torch.FedServer("cnn", cfg, nodes, test,
                                      batch_size=50, device=dev)
            _, ms, launches = counted_rounds(s, wrappers, 1)
            seq[tel] = (s, ms[0], launches,
                        host_syncs(lambda: s._step_fn(s.state, 1)))
        diff = tree_mismatches(fl_mod.state_to_tree(seq["node"][0].state),
                               fl_mod.state_to_tree(seq[None][0].state))
        diff += [k for k in seq[None][1]
                 if seq[None][1][k].tobytes() != seq["node"][1][k].tobytes()]
        want = {name: 0 for name in wrappers}
        want["round_stats"] = 10
        out["sequential"] = {"launches": seq["node"][2],
                             "tel_keys": sorted(k for k in seq["node"][1]
                                                if k.startswith("tel/")),
                             "host_syncs_round": {"on": seq["node"][3],
                                                  "off": seq[None][3]},
                             "mismatches": diff}
        if (diff or seq["node"][2] != want or seq[None][2] != want
                or seq["node"][3] > seq[None][3]):
            emit(out)
            raise AssertionError(f"telemetry sequential: {out['sequential']}")
        del seq

        # the host syncs inside a buffered tick (the golden schedule)
        delays, drops, task = golden_schedule()
        syncs = {}
        for tel in ("node", None):
            s = repro_torch.FedServer(
                "cnn", buffered_config("int8", task, telemetry=tel), nodes,
                test, batch_size=50, device=dev,
                arrival_fn=repro_torch.fixed_arrival_schedule(delays, drops))
            s.step(eval_every=0)
            syncs[tel] = host_syncs(lambda: s._step_fn(s.state, 1))
        out["buffered_host_syncs_tick"] = {"on": syncs["node"],
                                           "off": syncs[None]}
        if syncs["node"] > syncs[None]:
            emit(out)
            raise AssertionError(f"telemetry buffered: {syncs}")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)

    # the device kernels of one round with telemetry off and on (f32)
    kern = {}
    for tel in (None, "node"):
        s = repro_torch.FedServer(
            "cnn", slice_config("f32", telemetry=tel), nodes, test,
            batch_size=50, device=dev)
        s.step(eval_every=0)
        kern[tel] = dict(device_kernels(lambda: s.step(eval_every=0),
                                        whole=False))
    extra = {k: c - kern[None].get(k, 0) for k, c in kern["node"].items()
             if c != kern[None].get(k, 0)}
    out["round_kernels"] = {
        "off": {"distinct": len(kern[None]),
                "launches": sum(kern[None].values())},
        "on": {"distinct": len(kern["node"]),
               "launches": sum(kern["node"].values())},
        "added_by_telemetry": extra,
        "missing_with_telemetry": sorted(set(kern[None]) - set(kern["node"]))}

    # ms a round, stepwise against scanned (block = 8), in turns, and the
    # idle share of a profiled scanned block beside 8 stepwise rounds
    s = repro_torch.FedServer("cnn", slice_config("f32"), nodes, test,
                              batch_size=50, device=dev)
    s.step(eval_every=0)
    turns = []
    for mode in ("stepwise", "scanned", "scanned", "stepwise"):
        s.reset()
        turns.append((mode, timed_ms(lambda: s.run(
            8, eval_every=1, mode=mode, block=8)) / 8))
    out["ms_per_round"] = {
        "turns": turns,
        "stepwise": [t for m, t in turns if m == "stepwise"],
        "scanned_block8": [t for m, t in turns if m == "scanned"]}
    # the profiler's own host cost slows the run it traces, so the idle
    # share is also given against the same mode's unprofiled time
    prof = {}
    for mode in ("scanned", "stepwise"):
        s.reset()
        p = profile_device(lambda: s.run(8, eval_every=1, mode=mode,
                                         block=8))
        unprofiled_us = 8e3 * float(np.mean(
            [t for m, t in turns if m == mode]))
        prof[mode] = {k: p[k] for k in (
            "wall_us", "device_busy_union_us", "device_idle_share_union",
            "device_idle_share_sum", "device_events")}
        prof[mode]["idle_share_vs_unprofiled_wall"] = \
            1.0 - p["device_busy_union_us"] / unprofiled_us
    out["profile_8_rounds"] = prof
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def phase_k1_stats(rs, dev) -> dict:
    """round_stats (f32) at (1, N), the shape sequential mode gives it
    (one client's row against g): checked against its plain version, with
    the row also 4, 8 and 12 bytes past a 16-byte boundary and a second
    call giving the same bits, and timed, with its bound."""
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(1, MAIN_N, device=dev, generator=gen)
    g = torch.randn(MAIN_N, device=dev, generator=gen)
    abs_err, norm_err = 0.0, 0.0
    for m in (None, (torch.rand(MAIN_N, device=dev, generator=gen)
                     > 0.25).float()):
        for xi in [x] + [shifted(x, off) for off in (4, 8, 12)]:
            got = rs.round_stats(xi, g, m)
            a, e = stats_err(got, rs.round_stats_plain(xi, g, m), x, g, m)
            abs_err, norm_err = max(abs_err, a), max(norm_err, e)
            if not all(torch.equal(u, v) for u, v in zip(
                    got, rs.round_stats(xi, g, m))):
                raise AssertionError("round_stats at K = 1: a second "
                                     "launch gave other bits")
    if not norm_err <= TOL:
        raise AssertionError(f"round_stats at K = 1 disagrees with its plain "
                             f"version: {norm_err}")
    flush = torch.zeros(64 << 20, device=dev)
    row = timing_entry(
        "round_stats_k1", "round_stats.cu",
        "src/repro/kernels/round_stats.py:157",
        lambda: rs.round_stats(x, g), lambda: rs.round_stats_plain(x, g),
        None, 4 * 2 * MAIN_N + 12, 6 * MAIN_N, flush, abs_err, TOL,
        (1, MAIN_N))
    row.update(max_err=norm_err, wire="f32")
    emit({"phase": "kernels", "timing": row})
    return row


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def overlaps(events, top: int = 8) -> list:
    """The pairs of device events that overlap in time most: each event
    against the one that, of those started before it, ends last."""
    pairs, last = [], None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if last is not None and e.time_range.start < last.time_range.end:
            pairs.append((min(e.time_range.end, last.time_range.end)
                          - e.time_range.start, last, e))
        if last is None or e.time_range.end > last.time_range.end:
            last = e
    pairs.sort(key=lambda p: -p[0])
    return [{"us": us, "first": a.name[:60], "first_stream": stream_of(a),
             "second": b.name[:60], "second_stream": stream_of(b)}
            for us, a, b in pairs[:top]]


def stream_of(event) -> str:
    # a device event's resource id is the CUDA stream it ran on
    return str(getattr(event, "device_resource_id", None))


def profile_round(server) -> dict:
    """Where one CNN round's device time goes (`profile_device`)."""
    return profile_device(lambda: server.step(eval_every=0))


def device_kernels(fn, whole: bool = True, tries: int = 6) -> list:
    """[(kernel name, calls)] of one call of `fn`, which launches no sleep
    kernel of its own. Each trace wraps the call in short sleep kernels,
    `head` before it and TAIL_END after it, left out of the list. A trace
    on the H100 loses device events at its ends and never gains one: now
    and then its first, in a process that has launched many kernels its
    first three every time, in one run its first eleven in three traces
    running, and once its last six; once, late in a run, it kept both
    ends and lost every kernel between them. So a trace whose first and
    last device events are sleep kernels, with at least one kernel of the
    call between them (every caller's `fn` launches one), holds every
    kernel of the call. Up to `tries` traces are taken, the head doubled
    after each that lost it, until one is whole; if none is, this raises,
    or with `whole` False (a report, not a check) gives the trace with
    the most events."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    head, lost, fullest = HEAD_START, [], []
    for _ in range(tries):
        torch.cuda.synchronize()  # no earlier work in the trace
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(head):
                torch.cuda._sleep(1000)
            fn()
            for _ in range(TAIL_END):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [name for _, _, name in sorted(
            {(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)})]
        kernels = Counter(n for n in names if SPIN_KERNEL not in n)
        first = bool(names) and SPIN_KERNEL in names[0]
        last = bool(names) and SPIN_KERNEL in names[-1]
        if first and last and kernels:
            return kernels.most_common()
        lost.append({"head": head, "events": len(names),
                     "first_kept": first, "last_kept": last,
                     "between": sum(kernels.values())})
        if sum(kernels.values()) > sum(c for _, c in fullest):
            fullest = kernels.most_common()
        if not first:
            head *= 2
    emit({"phase": "trace", "lost_an_end": lost})
    if whole:
        raise AssertionError(f"{tries} traces of one call each lost an end: "
                             f"{lost}")
    return fullest


def profile_whole(fn, traces: int = 3, top: int = 12) -> dict:
    """`profile_device` of a call without side effects, `traces` times,
    keeping the trace with the most device events: where the time goes
    and which kernels ran, for a check that needs no whole count. A
    trace on the H100 now and then loses device events at its ends and
    never gains one; a check that counts kernels uses `device_kernels`,
    which knows when a trace is whole."""
    return max((profile_device(fn, top) for _ in range(traces)),
               key=lambda p: p["device_events_distinct"])


def profile_device(fn, top: int = 12) -> dict:
    """Where one call of `fn`'s device time goes (torch.profiler): the
    GPU kernels by name, the ported kernels' share, and how busy the
    device was. Busy time is given two ways, the sum of the device
    events' times and the union of their intervals; they differ only
    where events overlap in time. Each is given per stream too, with the
    events that overlap most, so that an overlap can be told apart: work
    on two streams at once, or events of one stream. Events that only
    mark a user annotation on the device's timeline are counted apart.
    `top`: the kernels listed, longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # no earlier work in the trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    events = [e for e in device
              if not getattr(e, "is_user_annotation", False)]

    def span(e):
        return e.time_range.start, e.time_range.end

    busy_sum = sum(hi - lo for lo, hi in map(span, events))
    busy_union = union_us(map(span, events))
    streams = {}
    for e in events:
        streams.setdefault(stream_of(e), []).append(e)
    ported = sum(r[0] for r in rows if any(p in r[1] for p in PORTED))
    return {"wall_us": wall_us,
            "device_busy_sum_us": busy_sum,
            "device_busy_union_us": busy_union,
            "device_idle_share_sum": 1.0 - busy_sum / wall_us,
            "device_idle_share_union": 1.0 - busy_union / wall_us,
            "kernel_time_sum_us": sum(r[0] for r in rows),
            "device_events": len(events),
            "device_events_distinct": len({(e.name, *span(e))
                                           for e in events}),
            "annotation_events": len(device) - len(events),
            "streams": {s: {"events": len(es),
                            "sum_us": sum(hi - lo for lo, hi in map(span, es)),
                            "union_us": union_us(map(span, es))}
                        for s, es in streams.items()},
            "overlaps": overlaps(events),
            "ported_kernels_us": ported,
            "ported_by_kernel_us": {
                p: sum(r[0] for r in rows if p in r[1]) for p in PORTED
                if any(p in r[1] for r in rows)},
            "top": [{"us": u, "kernel": k[:90], "calls": c}
                    for u, k, c in rows[:top]]}


def phase_algorithm(dev, nodes, test) -> dict:
    import repro_torch

    rounds = {}
    for transport in WIRES:
        for method in ("fedadp", "fedavg"):
            cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                       local_steps=12, method=method,
                                       engine="flat", base_lr=0.05,
                                       transport=transport)
            server = repro_torch.FedServer("mlr", cfg, nodes, test,
                                           batch_size=50, device=dev)
            t0 = time.perf_counter()
            hist = server.run(60, target_acc=0.85, eval_every=1)
            rounds[f"{transport}/{method}"] = hist.rounds_to_target
            rounds[f"{transport}/{method}_s"] = time.perf_counter() - t0
        adp = rounds[f"{transport}/fedadp"]
        avg = rounds[f"{transport}/fedavg"]
        avg = math.inf if avg is None else avg
        if adp is None or adp > avg:
            raise AssertionError(f"uplink {transport}: fedadp {adp} rounds "
                                 f"vs fedavg {avg}")
    # each wire's fedadp rounds over f32's, printed and not held: one seed
    # moves a threshold crossing by whole rounds in either package
    ratio = {t: rounds[f"{t}/fedadp"] / rounds["f32/fedadp"]
             for t in WIRES[1:]}

    def run(cfg, max_rounds, target, arrival_fn=None):
        server = repro_torch.FedServer("mlr", cfg, nodes, test,
                                       batch_size=50, device=dev,
                                       arrival_fn=arrival_fn)
        t0 = time.perf_counter()
        hist = server.run(max_rounds, target_acc=target, eval_every=1)
        return hist.rounds_to_target, time.perf_counter() - t0

    def held(adp, avg, what):
        if adp is None or adp > (math.inf if avg is None else avg):
            raise AssertionError(f"{what}: fedadp {adp} vs fedavg {avg}")

    # the golden delta section: 5 of 10 clients, an R-deep ring
    with open(os.path.join(ROOT, "tests", "golden", "convergence.json")) as f:
        golden = json.load(f)
    dt = golden["delta"]["task"]
    delta = {}
    for up, down in golden["delta"]["wires"]:
        for method in ("fedadp", "fedavg"):
            cfg = repro_torch.FLConfig(
                num_clients=10, clients_per_round=dt["clients_per_round"],
                local_steps=12, method=method, engine="flat", base_lr=0.05,
                transport=up, downlink=down, downlink_delta=True,
                downlink_ring=dt["downlink_ring"],
                group_size=dt["group_size"])
            key = f"{method}/{up}/{down}"
            delta[key], delta[key + "_s"] = run(cfg, dt["max_rounds"],
                                                dt["target"])
        held(delta[f"fedadp/{up}/{down}"], delta[f"fedavg/{up}/{down}"],
             f"delta {up}/{down}")
    # sequential mode, f32
    seq = {}
    for method in ("fedadp", "fedavg"):
        cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                   local_steps=12, method=method,
                                   mode="sequential", base_lr=0.05)
        seq[method], seq[method + "_s"] = run(cfg, 60, 0.85)
    held(seq["fedadp"], seq["fedavg"], "sequential")
    # the buffered server under the golden schedule, against sync fedavg
    delays, drops, bt = golden_schedule()
    buffered = {}
    for up, down in (("f32", "f32"), ("int4", "int8")):
        key = f"{up}/{down}"
        cfg = dataclasses.replace(buffered_config(up, bt), downlink=down)
        buffered[key], buffered[key + "_s"] = run(
            cfg, bt["max_rounds"], bt["target"],
            repro_torch.fixed_arrival_schedule(delays, drops))
        if key == "f32/f32":
            sync_avg = rounds["f32/fedavg"]
        else:
            sync_avg, buffered["sync_fedavg_" + key + "_s"] = run(
                repro_torch.FLConfig(
                    num_clients=10, clients_per_round=10, local_steps=12,
                    method="fedavg", engine="flat", base_lr=0.05,
                    transport=up, downlink=down,
                    group_size=bt["group_size"]), 60, 0.85)
        buffered["sync_fedavg_" + key] = sync_avg
        held(buffered[key], sync_avg, f"buffered {key}")
    out = {"phase": "algorithm", "model": "mlr", "target": 0.85,
           "rounds_to_target": rounds, "fedadp_rounds_over_f32": ratio,
           "delta_rounds_to_target": delta,
           "sequential_rounds_to_target": seq,
           "buffered_ticks_to_target": buffered}
    emit(out)
    return out


# ---- the client-sharded engine (engine="flat_sharded") ----

SHARD_WIRES = ("f32", "int8", "int4")  # world 1 over NCCL, in this process
SHARD_CHILD_WIRES = ("f32", "int8")  # the worlds of child processes
SHARD_ROUNDS = 3
SHARD_TIMEOUT = 240  # seconds a world of child processes may take


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_pairs(a, ma, b, mb) -> dict:
    """{name: (a's tensor, b's)} over two servers' states and their last
    rounds' host metrics."""
    pairs = {f"params/{k}": (a.params[k], b.params[k]) for k in a.params}
    pairs.update({f"prev_delta/{k}": (a.prev_delta[k], b.prev_delta[k])
                  for k in a.prev_delta})
    pairs["angle"] = (a.angle.smoothed, b.angle.smoothed)
    pairs.update({f"metrics/{k}": (torch.as_tensor(ma[k]),
                                   torch.as_tensor(mb[k])) for k in ma})
    return pairs


def max_abs_diff(pairs: dict) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in pairs.values())


def sharded_world1(wa, rs, dev, nodes, test) -> tuple[dict, dict]:
    """World 1 over NCCL in this process: per uplink wire, 3 CNN rounds of
    FedServer(engine="flat_sharded", mesh=make_client_mesh()) against the
    flat engine from the same seed (deterministic cuDNN, so both train the
    same deltas): 2 + 1 launches of the wire's kernels a round, states
    equal to 1e-5 (a one-rank all_reduce is a copy: 0 expected), ms a
    round of both. Returns (the line's part, launches per wire)."""
    import torch.distributed as dist

    import repro_torch

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    out, launches = {}, {}
    try:
        mesh = repro_torch.make_client_mesh(device=dev)
        torch.backends.cudnn.deterministic = True
        for wire in SHARD_WIRES:
            runs = {}
            for engine in ("flat", "flat_sharded"):
                cfg = dataclasses.replace(slice_config(wire), engine=engine)
                server = repro_torch.FedServer(
                    "cnn", cfg, nodes, test, batch_size=50, device=dev,
                    mesh=mesh if engine == "flat_sharded" else None)
                server.step(eval_every=0)  # warm-up
                server.reset()
                torch.cuda.synchronize()
                ms, metrics, counts = counted_rounds(
                    server, counters(wa, rs), SHARD_ROUNDS)
                if counts != expected_launches(wire, SHARD_ROUNDS):
                    raise AssertionError(
                        f"{engine} {wire}: {SHARD_ROUNDS} rounds launched "
                        f"{counts}, want 2 + 1 of the wire's kernels")
                runs[engine] = (server, metrics[-1], ms, counts)
            flat, sharded = runs["flat"], runs["flat_sharded"]
            pairs = shard_pairs(flat[0].state, flat[1], sharded[0].state,
                                sharded[1])
            worst, where = excess_err(pairs, TOL, TOL)
            out[wire] = {"sharded_round_ms": sharded[2],
                         "flat_round_ms": flat[2],
                         "launches": sharded[3],
                         "max_abs_diff_vs_flat": max_abs_diff(pairs)}
            if worst > 0:
                raise AssertionError(f"world 1 {wire}: flat_sharded and flat "
                                     f"differ at {where}: {worst}")
            launches[wire] = sharded[3]
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    return out, launches


def run_world(backend: str, world: int, argv=None,
              timeout: float = SHARD_TIMEOUT) -> list:
    """`world` child processes of this script, one rank each, joined with
    `timeout` seconds; returns each rank's result. `argv` is the
    children's arguments with "{rank}", "{port}" and "{out}" filled in
    per rank (default: `--sharded-child`'s). A child that fails or
    outlives the timeout raises."""
    import tempfile

    port = free_port()
    argv = argv or ["--sharded-child", backend, "{rank}", str(world),
                    "{port}", "{out}"]
    # the children share the card: hand them what this process's
    # allocator keeps cached and no longer uses
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    print(f"world of {world}: this process held {reserved} B reserved, "
          f"{torch.cuda.memory_allocated()} B allocated; now "
          f"{torch.cuda.memory_reserved()} B reserved", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)]
            + [a.format(rank=r, port=port, out=outs[r]) for a in argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        deadline = time.monotonic() + timeout
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode != 0]
        if bad:
            raise AssertionError(f"{backend} world of {world}: ranks {bad} "
                                 f"failed:\n" + "\n".join(
                                     log[-3000:] for log in logs))
        return [torch.load(o, weights_only=True) for o in outs]


def check_world(results: list, what: str) -> dict:
    """The ranks of one world agree bit for bit; rank 0's sharded round
    equals its flat round at SEQ_TOL; every rank launched 2 + 1 of the
    wire's kernels a round; fedadp needs no more MLR rounds than
    fedavg. Returns the line's part."""
    r0 = results[0]
    for r, res in enumerate(results[1:], 1):
        for key, t in r0["tensors"].items():
            o = res["tensors"][key]
            if t.dtype != o.dtype or not torch.equal(t, o):
                raise AssertionError(f"{what}: rank {r} differs from rank 0 "
                                     f"at {key}")
    out = {"ranks": len(results), "ranks_bit_equal": True}
    for wire in SHARD_CHILD_WIRES:
        pairs = {k: (r0["tensors"][f"{wire}/sharded/{k}"],
                     r0["flat"][f"{wire}/{k}"])
                 for k in r0["flat_keys"][wire]}
        worst, where = excess_err(pairs, *SEQ_TOL)
        if worst > 0:
            raise AssertionError(f"{what} {wire}: the sharded round and the "
                                 f"flat round differ at {where}: {worst}")
        for r, res in enumerate(results):
            if res["launches"][wire] != expected_launches(wire,
                                                          SHARD_ROUNDS):
                raise AssertionError(f"{what} {wire}: rank {r} launched "
                                     f"{res['launches'][wire]}")
        out[wire] = {"vs_flat_excess_err": worst, "vs_flat_worst": where,
                     "vs_flat_max_abs_diff": max_abs_diff(pairs),
                     "round_ms_per_rank": [res["round_ms"][wire]
                                           for res in results],
                     "launches_per_rank": r0["launches"][wire],
                     "accuracy": r0["accuracy"][wire]}
    adp, avg = r0["mlr"]["fedadp"], r0["mlr"]["fedavg"]
    if adp is None or adp > (math.inf if avg is None else avg):
        raise AssertionError(f"{what}: MLR fedadp {adp} vs fedavg {avg}")
    out["mlr_rounds_to_85"] = r0["mlr"]
    return out


def sharded_child(backend: str, rank: int, world: int, port: int,
                  out_path: str) -> int:
    """One rank of a child world: the CNN round at SHARD_TAU local steps
    from the initial model on continuous images (rank 0 also runs the
    flat round), SHARD_ROUNDS counted FedServer rounds per wire, and
    fedadp / fedavg to 85% on MLR, all on engine="flat_sharded"."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch
    from repro_torch.core import fl as fl_mod
    from repro_torch.kernels import round_stats as rs
    from repro_torch.kernels import weighted_agg as wa

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = repro_torch.make_client_mesh(device=dev)
        nodes, test = image_task()
        res = {"tensors": {}, "flat": {}, "flat_keys": {}, "launches": {},
               "round_ms": {}, "accuracy": {}, "mlr": {}}
        for wire in SHARD_CHILD_WIRES:
            cfg = dataclasses.replace(slice_config(wire),
                                      engine="flat_sharded")
            server = repro_torch.FedServer("cnn", cfg, nodes, test,
                                           batch_size=50, mesh=mesh)
            gen = torch.Generator(device=dev).manual_seed(7)
            x = torch.rand((10, SEQ_TAU, 50, 28, 28, 1), generator=gen,
                           device=dev)
            y = torch.randint(0, 10, (10, SEQ_TAU, 50), generator=gen,
                              device=dev)
            args = ((x, y), torch.arange(10, device=dev),
                    torch.full((10,), 600.0, device=dev))
            torch.backends.cudnn.deterministic = True
            st, m = fl_mod.make_round_fn(cnn_loss, cfg, mesh=mesh)(
                server.state, *args)
            pairs = shard_pairs(st, m, st, m)
            res["tensors"].update({f"{wire}/sharded/{k}": a.cpu()
                                   for k, (a, _) in pairs.items()})
            if rank == 0:
                fst, fm = fl_mod.make_round_fn(cnn_loss, dataclasses.replace(
                    cfg, engine="flat"))(server.state, *args)
                res["flat"].update({f"{wire}/{k}": a.cpu() for k, (a, _) in
                                    shard_pairs(fst, fm, fst, fm).items()})
                res["flat_keys"][wire] = list(pairs)
            torch.backends.cudnn.deterministic = False
            server.step(eval_every=0)  # warm-up
            server.reset()
            torch.cuda.synchronize()
            ms, metrics, counts = counted_rounds(server, counters(wa, rs),
                                                 SHARD_ROUNDS)
            res["tensors"].update({f"{wire}/server/{k}": a.cpu() for k, (a, _)
                                   in shard_pairs(server.state, metrics[-1],
                                                  server.state,
                                                  metrics[-1]).items()})
            res["launches"][wire] = counts
            res["round_ms"][wire] = ms
            res["accuracy"][wire] = [float(mm["accuracy"]) for mm in metrics]
        for method in ("fedadp", "fedavg"):
            cfg = repro_torch.FLConfig(num_clients=10, clients_per_round=10,
                                       local_steps=12, method=method,
                                       engine="flat_sharded", base_lr=0.05)
            hist = repro_torch.FedServer("mlr", cfg, nodes, test,
                                         batch_size=50, mesh=mesh).run(
                60, target_acc=0.85, eval_every=1)
            res["mlr"][method] = hist.rounds_to_target
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def phase_sharded(wa, rs, dev, nodes, test) -> dict:
    """engine="flat_sharded" at the CNN's full width (K = 10, B = 50): world
    1 over NCCL in this process (`sharded_world1`), then two gloo
    processes sharing this card, and NCCL over min(count, 4) cards when
    there are two or more. Returns the world-1 launches per wire."""
    t0 = time.perf_counter()
    world1, launches = sharded_world1(wa, rs, dev, nodes, test)
    out = {"phase": "sharded", "model": "cnn", "clients": 10,
           "local_steps": 12, "batch": 50, "equal_tau": SEQ_TAU,
           "world1_nccl": world1}
    t1 = time.perf_counter()
    out["world2_gloo_one_card"] = check_world(run_world("gloo", 2),
                                              "gloo world 2")
    out["world2_gloo_one_card"]["seconds"] = time.perf_counter() - t1
    out["world2_gloo_one_card"]["note"] = (
        "two processes share one device: round_ms is no speed-up")
    cards = torch.cuda.device_count()
    if cards >= 2:
        out[f"nccl_world{min(cards, 4)}"] = check_world(
            run_world("nccl", min(cards, 4)), "nccl world")
    else:
        print(f"sharded: NCCL across cards not run: {cards} card visible",
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return launches


# ---- the 2D (client x model) mesh ----

MESH2D_TILE = (5, MAIN_N // 2)  # (K_loc, N_loc) of the CNN on a (2, 2) mesh
MESH2D_CNN = (2, 2)  # (data, model): four gloo processes on one card
MESH2D_LM = (1, 2)  # two gloo processes on one card
MESH2D_LM_WIRES = ("f32", "int8")
MESH2D_ROUNDS = 2
MESH2D_CARD_NOTE = "processes share one card: no speed-up"


def mesh2d_kernel_check(wa, rs, tq, dev) -> dict:
    """Rows 1-6 at a 2D tile's shape, (K_loc, N_loc) = MESH2D_TILE (the
    CNN's ceil-split columns: N_loc odd), against their plain versions
    at the kernels phase's tolerance: {row: (max abs error, normalised
    error)}."""
    k, n = MESH2D_TILE
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(k, n, device=dev, generator=gen)
    g = torch.randn(n, device=dev, generator=gen)
    w = torch.rand(k, device=dev, generator=gen)
    mask = (torch.rand(n, device=dev, generator=gen) > 0.25).float()
    errs = {}
    for tag, xt in (("", x), ("_bf16", x.to(torch.bfloat16))):
        xf = xt.float()
        errs["weighted_agg" + tag] = agg_err(
            wa.weighted_agg(w, xt, out_dtype=torch.float32),
            wa.weighted_agg_plain(w, xt, torch.float32), w, xf)
        worst = (0.0, 0.0)
        for m in (None, mask):
            e = stats_err(rs.round_stats(xt, g, m),
                          rs.round_stats_plain(xt, g, m), xf, g, m)
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        errs["round_stats" + tag] = worst
    q8 = tq.quantize(spread(x, tq.CHUNK), "int8")
    errs.update(check_wire("q", wa.weighted_agg_q, wa.weighted_agg_q_plain,
                           rs.round_stats_q, rs.round_stats_q_plain, q8,
                           tq.dequantize(q8), w, g, mask))
    q4 = tq.quantize(spread(x, MAIN_GS), "int4", group_size=MAIN_GS)
    errs.update(check_wire("q4", wa.weighted_agg_q4,
                           wa.weighted_agg_q4_plain, rs.round_stats_q4,
                           rs.round_stats_q4_plain, q4, tq.dequantize(q4),
                           w, g, mask, group_size=MAIN_GS))
    torch.cuda.synchronize()
    bad = {key: e for key, e in errs.items() if not e[1] <= TOL}
    if bad:
        raise AssertionError(f"at the 2D tile {MESH2D_TILE}: {bad}")
    return errs


def digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def collective_bytes(log) -> dict:
    """{"op axes scope": bytes this rank sent} over a recording."""
    out: dict = {}
    for c in log:
        key = f"{c.op} {'+'.join(c.axes)} {c.scope or 'round'}"
        out[key] = out.get(key, 0) + c.nbytes
    return out


def mesh2d_cnn(mesh, dev, rank: int) -> dict:
    """One rank of the CNN's 2D world. Per wire: one round at SEQ_TAU
    local steps from the initial model on continuous images, on the 2D
    flat_sharded and tree engines (and on rank 0 the 1D flat one), every
    engine aggregating the same deltas: all clients trained once on this
    rank and pinned by `delta_constraint` (a rank trains K_loc = 5
    clients, and cuDNN need not give a batch of 5 the bits of a batch of
    10); on f32 and bf16 the same round of both 2D engines on their own
    trained deltas;
    then MESH2D_ROUNDS counted FedServer rounds after a warm-up."""
    import repro_torch
    from repro_torch.core import fl as fl_mod
    from repro_torch.core import fl_shard_map
    from repro_torch.kernels import round_stats as rs
    from repro_torch.kernels import weighted_agg as wa

    nodes, test = image_task()
    res = {"tensors": {}, "flat": {}, "launches": {}, "round_ms": {}}
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.rand((10, SEQ_TAU, 50, 28, 28, 1), generator=gen, device=dev)
    y = torch.randint(0, 10, (10, SEQ_TAU, 50), generator=gen, device=dev)
    args = ((x, y), torch.arange(10, device=dev),
            torch.full((10,), 600.0, device=dev))
    for wire in WIRES:
        cfg = dataclasses.replace(slice_config(wire), engine="flat_sharded")
        server = repro_torch.FedServer("cnn", cfg, nodes, test,
                                       batch_size=50, mesh=mesh)
        torch.backends.cudnn.deterministic = True
        ref, _ = fl_mod._clients(cnn_loss, cfg, None, None)(
            server.state.params, (x, y), fl_mod._lr_at(cfg, 0))
        rows = fl_shard_map.flat_client_sharding(mesh).rows(10)

        def pin(deltas):
            if deltas["c1"].shape[0] == 10:
                return ref
            return {key: v[rows] for key, v in ref.items()}

        runs = {}
        for engine in ("flat_sharded", "tree", "flat"):
            if engine == "flat" and (rank or wire not in ("f32", "bf16")):
                continue
            mine = None if engine == "flat" else mesh
            c = dataclasses.replace(cfg, engine=engine)
            runs[engine] = fl_mod.make_round_fn(cnn_loss, c, pin, mesh=mine)(
                server.state, *args)
            if mine is not None and wire in ("f32", "bf16"):
                runs["own_" + engine] = fl_mod.make_round_fn(
                    cnn_loss, c, mesh=mine)(server.state, *args)
        torch.backends.cudnn.deterministic = False
        for engine, (st, m) in runs.items():
            pairs = state_pairs(st, m, st, m, keys=EQUIV_KEYS)
            dest = res["flat"] if engine == "flat" else res["tensors"]
            dest.update({f"{wire}/{engine}/{k}": a.cpu()
                         for k, (a, _) in pairs.items()})
        server.step(eval_every=0)  # warm-up
        server.reset()
        torch.cuda.synchronize()
        ms, metrics, counts = counted_rounds(server, counters(wa, rs),
                                             MESH2D_ROUNDS)
        res["tensors"].update({
            f"{wire}/server/{k}": a.cpu() for k, (a, _) in shard_pairs(
                server.state, metrics[-1], server.state,
                metrics[-1]).items()})
        res["launches"][wire] = counts
        res["round_ms"][wire] = ms
    return res


def mesh2d_lm(mesh, dev, rank: int) -> dict:
    """One rank of the 100m LM's 2D world: per wire, one round of the 2D
    flat_sharded engine after a warm-up, recorded (every collective, the
    region's outputs against their shard shapes, the launches, the peak
    memory), then the 2D tree engine's round from the same state."""
    import repro_torch
    from repro_torch.core import fl_shard_map
    from repro_torch.core import treemath
    from repro_torch.kernels import round_stats as rs
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.models import sharding, transformer

    ex = load_lm_example()
    cfg = ex.model_config(LM_PRESET, "xla")
    params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    specs = sharding.param_pspecs(params, mesh)
    sharded_sizes = [leaf.numel() for leaf, spec in zip(
        treemath.tree_leaves(params), treemath.tree_leaves_like(params,
                                                                specs))
        if "model" in spec]
    k, tau, b, t = LM_K, LM_TAU, LM_B, LM_T
    tokens = ex.round_tokens(0, k, tau, b, t, cfg.vocab_size, dev)
    sel = torch.arange(k, dtype=torch.int32, device=dev)
    sizes = torch.ones((k,), device=dev)
    shapes_ok = []
    build = fl_shard_map.make_round_ops_2d

    def spy(mesh_, template, pspecs, **kw):
        """The region, its outputs held to their shard shapes."""
        op = build(mesh_, template, pspecs, **kw)
        want = [sharding.NamedSpec(mesh_, spec).shard_shape(leaf.shape[1:])
                for leaf, spec in zip(treemath.tree_leaves(template),
                                      treemath.tree_leaves_like(template,
                                                                pspecs))]

        def region(*a):
            out = op(*a)
            shapes_ok.append(all(
                tuple(leaf.shape) == w for tree in (out[0], out[4])
                for leaf, w in zip(treemath.tree_leaves(tree), want)))
            return out

        return region

    fl_shard_map.make_round_ops_2d = spy
    res = {"params": transformer.count_params(cfg),
           "sharded_leaves": len(sharded_sizes),
           "smallest_sharded_leaf": min(sharded_sizes)}
    try:
        for wire in MESH2D_LM_WIRES:
            fl = repro_torch.FLConfig(
                num_clients=k, clients_per_round=k, local_steps=tau,
                method="fedadp", base_lr=0.05, lr_decay=0.999,
                engine="flat_sharded", transport=wire)
            rounds = {engine: repro_torch.make_round_fn(
                lambda p, bt: transformer.loss_fn(p, cfg, bt),
                dataclasses.replace(fl, engine=engine), mesh=mesh)
                for engine in ("flat_sharded", "tree")}
            state0 = repro_torch.init_round_state(fl, params)
            rounds["flat_sharded"](state0, tokens, sel, sizes)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters(wa, rs).values():
                fn.launches = 0
            del shapes_ok[:]
            with mesh.recording() as log:
                t0 = time.perf_counter()
                st, m = rounds["flat_sharded"](state0, tokens, sel, sizes)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            launches = {name: fn.launches
                        for name, fn in counters(wa, rs).items()}
            peak = torch.cuda.max_memory_allocated()
            region_gathers = [c.nbytes // 4 * mesh.model_size for c in log
                              if c.op == "all_gather"
                              and c.scope == "round_ops_2d"]
            ts, tm = rounds["tree"](state0, tokens, sel, sizes)
            torch.cuda.synchronize()
            worst, where = excess_err({
                **tree_pairs("params", st.params, ts.params),
                **tree_pairs("prev_delta", st.prev_delta, ts.prev_delta),
                "angle": (st.angle.smoothed, ts.angle.smoothed),
                **{f"metrics/{key}": (m[key], tm[key])
                   for key in ("loss", "weights", "theta", "divergence")}},
                TOL, TOL)
            res[wire] = {
                "round_ms": ms, "peak_bytes": peak, "launches": launches,
                "collective_bytes": collective_bytes(log),
                "largest_region_gather": max(region_gathers, default=0),
                "region_shapes_ok": shapes_ok[:],
                "vs_tree_excess_err": worst, "vs_tree_worst": where,
                "params_sha256": digest(treemath.tree_ravel(st.params)[0]),
                "weights": m["weights"].cpu(),
                "finite": bool(all(torch.isfinite(v).all()
                                   for v in m.values()))}
            del st, ts, m, tm, state0
            torch.cuda.empty_cache()
    finally:
        fl_shard_map.make_round_ops_2d = build
    return res


def mesh2d_child(task: str, backend: str, rank: int, world: int,
                 model: int, port: int, out_path: str) -> int:
    """One rank of a 2D world: `task` "cnn", "lm", "tp" (the 100m LM
    tensor-parallel), "launch" (the launcher), "tp_serve"
    (tensor-parallel serving and the DeepSeek family) or "fsdp" (params
    and the decode cache over "data") on a (world / model, model) mesh
    over `backend`."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = repro_torch.make_client_mesh(device=dev, model=model)
        if task == "launch":  # the launcher makes its own mesh
            res = tp_launch(mesh, dev, rank, out_path)
        else:
            res = {"cnn": mesh2d_cnn, "lm": mesh2d_lm, "tp": tp_lm,
                   "tp_serve": tp_serve, "fsdp": fsdp_child}[task](
                       mesh, dev, rank)
        res["coords"] = (mesh.client_index, mesh.model_index)
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh2d(task: str, backend: str, shape: tuple,
               timeout: float = SHARD_TIMEOUT) -> list:
    """A world of child processes of this script (`--mesh2d-child`), one
    rank each on a `shape` (data, model) mesh; each rank's result."""
    return run_world(backend, shape[0] * shape[1],
                     ["--mesh2d-child", task, backend, "{rank}",
                      str(shape[0] * shape[1]), str(shape[1]), "{port}",
                      "{out}"], timeout)


def check_mesh2d_cnn(results: list, what: str) -> dict:
    """The ranks bit for bit; per wire, on the pinned deltas, 2D
    flat_sharded == 2D tree at 1e-5 and, on f32 and bf16, == the 1D flat
    engine at 1e-5; on f32 and bf16 the two 2D engines on their own
    trained deltas at SEQ_TOL (the sharded phase's tolerance across batch
    sizes; on an int wire deltas that far apart can round one step
    apart, and a step of int4 is a seventh of a group's largest value);
    2 + 1 launches a rank a round. Returns the line's part."""
    r0 = results[0]
    for r, res in enumerate(results[1:], 1):
        for key, t in r0["tensors"].items():
            o = res["tensors"][key]
            if t.dtype != o.dtype or not torch.equal(t, o):
                raise AssertionError(f"{what}: rank {r} differs from rank 0 "
                                     f"at {key}")
    out = {"ranks": len(results), "ranks_bit_equal": True,
           "coords": [res["coords"] for res in results]}
    for wire in WIRES:
        keys = [k[len(f"{wire}/tree/"):] for k in r0["tensors"]
                if k.startswith(f"{wire}/tree/")]
        checks = {"tree": {k: (r0["tensors"][f"{wire}/flat_sharded/{k}"],
                               r0["tensors"][f"{wire}/tree/{k}"])
                           for k in keys}}
        if wire in ("f32", "bf16"):
            checks["own_tree"] = {
                k: (r0["tensors"][f"{wire}/own_flat_sharded/{k}"],
                    r0["tensors"][f"{wire}/own_tree/{k}"]) for k in keys}
            checks["flat_1d"] = {k: (r0["tensors"][f"{wire}/flat_sharded/"
                                                   f"{k}"],
                                     r0["flat"][f"{wire}/flat/{k}"])
                                 for k in keys}
        part = {}
        for name, pairs in checks.items():
            tol = SEQ_TOL if name.startswith("own") else (TOL, TOL)
            worst, where = excess_err(pairs, *tol)
            part[f"vs_{name}_excess_err"] = worst
            part[f"vs_{name}_max_abs_diff"] = max_abs_diff(pairs)
            if worst > 0:
                raise AssertionError(f"{what} {wire}: 2D flat_sharded and "
                                     f"{name} differ at {where}: {worst}")
        for r, res in enumerate(results):
            if res["launches"][wire] != expected_launches(wire,
                                                          MESH2D_ROUNDS):
                raise AssertionError(f"{what} {wire}: rank {r} launched "
                                     f"{res['launches'][wire]}")
        out[wire] = {**part, "round_ms_per_rank": [res["round_ms"][wire]
                                           for res in results],
                     "launches_per_rank": r0["launches"][wire]}
    return out


def check_mesh2d_lm(results: list) -> dict:
    """The ranks bit for bit (params digest, weights); per wire 2D
    flat_sharded == 2D tree at 1e-5, every region output of its shard
    shape, the region's largest all_gather below the smallest
    model-sharded leaf, 2 + 1 launches. Returns the line's part."""
    r0 = results[0]
    out = {"params": r0["params"], "sharded_leaves": r0["sharded_leaves"],
           "smallest_sharded_leaf": r0["smallest_sharded_leaf"]}
    for wire in MESH2D_LM_WIRES:
        parts = [res[wire] for res in results]
        p0 = parts[0]
        if any(p["params_sha256"] != p0["params_sha256"]
               or not torch.equal(p["weights"], p0["weights"])
               for p in parts):
            raise AssertionError(f"lm {wire}: the ranks differ")
        if not all(p["finite"] for p in parts):
            raise AssertionError(f"lm {wire}: metrics not finite")
        for r, p in enumerate(parts):
            if p["vs_tree_excess_err"] > 0:
                raise AssertionError(f"lm {wire} rank {r}: 2D flat_sharded "
                                     f"and tree differ at "
                                     f"{p['vs_tree_worst']}: "
                                     f"{p['vs_tree_excess_err']}")
            if p["region_shapes_ok"] != [True]:
                raise AssertionError(f"lm {wire} rank {r}: region outputs "
                                     f"{p['region_shapes_ok']}, want one "
                                     "call of shard shapes")
            if not 0 < p["largest_region_gather"] < \
                    r0["smallest_sharded_leaf"]:
                raise AssertionError(f"lm {wire} rank {r}: the region's "
                                     f"largest all_gather "
                                     f"{p['largest_region_gather']} vs the "
                                     f"smallest sharded leaf "
                                     f"{r0['smallest_sharded_leaf']}")
            if p["launches"] != expected_launches(wire, 1):
                raise AssertionError(f"lm {wire} rank {r}: launched "
                                     f"{p['launches']}")
        out[wire] = {
            "round_ms_per_rank": [p["round_ms"] for p in parts],
            "peak_bytes_per_rank": [p["peak_bytes"] for p in parts],
            "collective_bytes_rank0": p0["collective_bytes"],
            "largest_region_gather": p0["largest_region_gather"],
            "vs_tree_excess_err": max(p["vs_tree_excess_err"]
                                      for p in parts),
            "launches_per_rank": p0["launches"]}
    return out


def phase_mesh2d(wa, rs, tq, dev, smi: str) -> dict:
    """The 2D (client x model) mesh: the kernels at a 2D tile's shape,
    the CNN on a (2, 2) gloo world of four processes on this card (every
    wire), NCCL across cards where there are two or more, and the 100m
    LM on a (1, 2) gloo world (f32, int8). Returns rank 0's CNN launches
    a wire."""
    t0 = time.perf_counter()
    out = {"phase": "mesh2d", "card": smi, "note": MESH2D_CARD_NOTE,
           "kernels_at_tile": {
               "shape": list(MESH2D_TILE),
               "errors": mesh2d_kernel_check(wa, rs, tq, dev)}}
    t1 = time.perf_counter()
    cnn = check_mesh2d_cnn(run_mesh2d("cnn", "gloo", MESH2D_CNN),
                           "cnn gloo (2, 2)")
    out["cnn_gloo_2x2_one_card"] = {**cnn,
                                    "seconds": time.perf_counter() - t1}
    cards = torch.cuda.device_count()
    if cards >= 2:
        shape = (2, 2) if cards >= 4 else (1, 2)
        out[f"cnn_nccl_{shape[0]}x{shape[1]}"] = check_mesh2d_cnn(
            run_mesh2d("cnn", "nccl", shape), f"cnn nccl {shape}")
    else:
        print(f"mesh2d: NCCL across cards not run: {cards} card visible",
              flush=True)
    t1 = time.perf_counter()
    out["lm_gloo_1x2_one_card"] = {
        **check_mesh2d_lm(run_mesh2d("lm", "gloo", MESH2D_LM)),
        "seconds": time.perf_counter() - t1}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return cnn


# ---- tensor-parallel model execution over the mesh's model axis ----

TP_LM_MESHES = {"1x2": (1, 2), "2x2": (2, 2)}  # gloo worlds on one card
TP_LAUNCH_ARGV = ["--arch", "gemma-2b", "--seq", "1024", "--global-batch",
                  "4", "--rounds", "2"]  # bf16, K = 1, B = 4, full width
TP_SMOKE_ARGV = ["--arch", "gemma-2b", "--smoke", "--seq", "64",
                 "--global-batch", "2"]  # the resume, at the smoke width


def tp_collectives_from_shapes(cfg, k_loc: int) -> tuple[int, int]:
    """(count, bytes) of the collectives a rank's clients run under "tp"
    in one round of the dense LM at LM_TAU steps, from the shapes, on a
    model axis whose blocks hold whole heads: a step is the
    vocab-parallel embedding's all-reduce; per layer the forward's two
    all-reduces (after wo and w_down), again in the recompute's rerun,
    and the backward's two (copy_to_model's cotangents at the attention
    and FFN inputs), each of the (K_loc, B, T, d) f32 activations; the
    head's input cotangent (the same size); and the loss's max, exp sum
    and label pick over (K_loc, B, T - 1)."""
    act = k_loc * LM_B * LM_T * cfg.d_model * 4
    small = k_loc * LM_B * (LM_T - 1) * 4
    per_step = (6 * cfg.num_layers + 2, 3)
    return (LM_TAU * sum(per_step),
            LM_TAU * (per_step[0] * act + per_step[1] * small))


def tp_lm(mesh, dev, rank: int) -> dict:
    """One rank of the 100m LM's tensor-parallel world: the state placed
    in this rank's blocks (memory_allocated against the specs' shard
    bytes), a warm-up round whose every flash launch is held to the plain
    version at its local shape, one recorded round (the collectives by
    scope, the launches, ms, the peak), then the whole-model 2D round from
    the same state and tokens for the comparison."""
    import repro_torch
    from repro_torch.core import fl_shard_map, treemath
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import round_stats as rs
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.models import sharding, transformer
    from repro_torch.models.sharding import NamedSpec

    ex = load_lm_example()
    cfg = ex.model_config(LM_PRESET, "flash")
    k, tau, b, t = LM_K, LM_TAU, LM_B, LM_T
    fl = repro_torch.FLConfig(num_clients=k, clients_per_round=k,
                              local_steps=tau, method="fedadp",
                              base_lr=0.05, lr_decay=0.999,
                              engine="flat_sharded")
    shapes = transformer.init_params(None, cfg, device="meta")
    specs = sharding.param_pspecs(shapes, mesh)

    def init():
        return transformer.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)

    # the placed state: this rank's blocks of the params, prev_delta in f32
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state0 = repro_torch.init_round_state(
        fl, sharding.shard_params(init(), mesh, specs))
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - base
    shard = [math.prod(NamedSpec(mesh, s).shard_shape(tuple(x.shape)))
             for x, s in zip(treemath.tree_leaves(shapes),
                             treemath.tree_leaves_like(shapes, specs))]
    want_placed = (sum(shard) * (cfg.tdtype.itemsize + 4)
                   + k * 4 * 2)  # params, prev_delta f32, the angles
    n_tensors = 2 * len(shard) + 2
    tokens = ex.round_tokens(0, k, tau, b, t, cfg.vocab_size, dev)
    sel = torch.arange(k, dtype=torch.int32, device=dev)
    sizes = torch.ones((k,), device=dev)

    def loss(p, bt):
        return transformer.loss_fn(p, cfg, bt)

    tp_round = repro_torch.make_round_fn(loss, fl, mesh=mesh,
                                         param_specs=specs)
    flash_calls = []
    real = fa._forward

    def spy(q, k_, v, causal):
        o = real(q, k_, v, causal)
        flash_calls.append((list(q.shape), list(k_.shape), allclose_err(
            o, gqa_plain(fa, q, k_, v), FLASH_TOL["float32"])))
        return o

    fa._forward = spy
    try:
        tp_round(state0, tokens, sel, sizes)  # warm-up, every flash call held
    finally:
        fa._forward = real
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = {"weighted_agg": wa.weighted_agg,
                "round_stats": rs.round_stats,
                "flash_attention": fa.flash_attention}
    for fn in wrappers.values():
        fn.launches = 0
    with mesh.recording() as log:
        t0 = time.perf_counter()
        st, m = tp_round(state0, tokens, sel, sizes)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    leaves_ok = all(
        tuple(x.shape) == NamedSpec(mesh, s).shard_shape(tuple(w.shape))
        for tree in (st.params, st.prev_delta)
        for x, w, s in zip(treemath.tree_leaves(tree),
                           treemath.tree_leaves(shapes),
                           treemath.tree_leaves_like(shapes, specs)))
    sharded_blocks = [n * 4 for n, s in zip(
        shard, treemath.tree_leaves_like(shapes, specs)) if "model" in s]
    full = {"params": sharding.gather_params(st.params, mesh, specs),
            "prev_delta": sharding.gather_params(st.prev_delta, mesh,
                                                 specs)}
    del st, state0
    torch.cuda.empty_cache()
    params = init()
    sw, mw = repro_torch.make_round_fn(loss, fl, mesh=mesh)(
        repro_torch.init_round_state(fl, params), tokens, sel, sizes)
    torch.cuda.synchronize()
    worst, where = excess_err({
        **tree_pairs("params", full["params"], sw.params),
        **tree_pairs("prev_delta", full["prev_delta"], sw.prev_delta),
        **{f"metrics/{key}": (m[key], mw[key])
           for key in ("loss", "weights", "theta", "divergence")}},
        PARITY_TOL, PARITY_TOL)
    by_scope = collective_bytes(log)
    return {
        "round_ms": ms, "peak_bytes": peak, "launches": launches,
        "layers": cfg.num_layers, "placed_bytes": placed,
        "want_placed_bytes": want_placed,
        "placed_tensors": n_tensors, "leaves_of_shard_shape": leaves_ok,
        "collective_bytes": by_scope,
        "tp_count": sum(c.scope == "tp" for c in log),
        "tp_bytes": sum(c.nbytes for c in log if c.scope == "tp"),
        "want_tp": tp_collectives_from_shapes(  # the rank's clients
            cfg, fl_shard_map.padded_k(k, mesh.client_size)
            // mesh.client_size),
        "largest_other_gather": max(
            [c.nbytes for c in log if c.op == "all_gather"
             and c.scope != "tp"], default=0),
        "smallest_block_bytes": min(sharded_blocks),
        "flash_calls": flash_calls,
        "vs_whole_excess_err": worst, "vs_whole_worst": where,
        "params_sha256": digest(treemath.tree_ravel(full["params"])[0]),
        "weights": m["weights"].cpu(),
        "finite": bool(all(torch.isfinite(v).all() for v in m.values()))}


def tp_launch(mesh, dev, rank: int, out_path: str) -> dict:
    """One rank of the launcher on a (1, 2) world: gemma-2b at full width
    and depth for 2 rounds (ms a round, the peak, the gathered sha), then
    at the smoke width 3 rounds against 2 + a resumed 1 from a checkpoint
    that rank 0 writes beside `out_path`."""
    from repro_torch.launch import train

    torch.cuda.reset_peak_memory_stats()
    run = train.main(TP_LAUNCH_ARGV + ["--device", str(dev)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    ckpt = os.path.join(os.path.dirname(out_path), "tp_ckpt")
    smoke = TP_SMOKE_ARGV + ["--device", str(dev)]
    whole = train.main(smoke + ["--rounds", "3"])
    half = train.main(smoke + ["--rounds", "2", "--ckpt", ckpt])
    resumed = train.main(smoke + ["--rounds", "3", "--ckpt", ckpt,
                                  "--resume"])
    return {"round_seconds": run["seconds"], "losses": run["losses"],
            "peak_bytes": peak, "params_sha256": run["params_sha256"],
            "engine": run["meta"]["flcfg"]["engine"], "K": run["meta"]["K"],
            "smoke_sha": whole["params_sha256"],
            "resumed_sha": resumed["params_sha256"],
            "resumed_start": resumed["start_round"],
            "half_losses": half["losses"], "whole_losses": whole["losses"],
            "resumed_losses": resumed["losses"]}


def check_tp_lm(results: list, what: str) -> dict:
    """The ranks bit for bit; the tensor-parallel round == the whole-model
    2D round at PARITY_TOL; 2 + 1 FL launches and LM_TAU flash launches a
    layer; every flash call at its local shape within FLASH_TOL of the
    plain version; the "tp" collectives' count and bytes those of the
    shapes; no other all_gather as large as a sharded block; each state
    leaf of its shard shape; memory_allocated of the placed state within
    1% + 512 B a tensor of the shard bytes. Returns the line's part."""
    r0 = results[0]
    if any(r["params_sha256"] != r0["params_sha256"]
           or not torch.equal(r["weights"], r0["weights"])
           for r in results):
        raise AssertionError(f"{what}: the ranks differ")
    for r, res in enumerate(results):
        want_launch = {"weighted_agg": 2, "round_stats": 1,
                       "flash_attention": res["layers"] * LM_TAU}
        flash_worst = max(e[1] for _, _, e in res["flash_calls"])
        slack = 0.01 * res["want_placed_bytes"] + 512 * res["placed_tensors"]
        checks = {
            "finite": res["finite"],
            "vs whole-model": res["vs_whole_excess_err"] <= 0,
            "launches": res["launches"] == want_launch,
            "flash calls": (len(res["flash_calls"])
                            == res["layers"] * LM_TAU
                            and flash_worst <= 1.0),
            "tp collectives": (res["tp_count"], res["tp_bytes"])
            == tuple(res["want_tp"]),
            "no sharded gather": res["largest_other_gather"]
            < res["smallest_block_bytes"],
            "shard shapes": res["leaves_of_shard_shape"],
            "placed bytes": abs(res["placed_bytes"]
                                - res["want_placed_bytes"]) <= slack,
        }
        bad = [name for name, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(
                f"{what} rank {r}: {bad}: " + json.dumps({
                    key: res[key] for key in (
                        "vs_whole_excess_err", "vs_whole_worst", "launches",
                        "tp_count", "tp_bytes", "want_tp",
                        "largest_other_gather", "smallest_block_bytes",
                        "placed_bytes", "want_placed_bytes")},
                    default=str) + f" flash worst {flash_worst}")
    return {"ranks": len(results), "ranks_bit_equal": True,
            "round_ms_per_rank": [r["round_ms"] for r in results],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in results],
            "placed_bytes_per_rank": [r["placed_bytes"] for r in results],
            "want_placed_bytes": r0["want_placed_bytes"],
            "collective_bytes_rank0": r0["collective_bytes"],
            "tp_collectives": [r0["tp_count"], r0["tp_bytes"]],
            "vs_whole_excess_err": max(r["vs_whole_excess_err"]
                                       for r in results),
            "flash_local_shapes": sorted({str(c[:2])
                                          for c in r0["flash_calls"]}),
            "flash_max_abs_err": max(c[2][0] for c in r0["flash_calls"]),
            "launches_per_rank": r0["launches"]}


def check_tp_launch(results: list) -> dict:
    """The ranks' gathered shas equal, 2 finite rounds on the
    flat_sharded round; at the smoke width the resumed run bit for bit
    the uninterrupted one."""
    r0 = results[0]
    for r, res in enumerate(results):
        ok = (res["params_sha256"] == r0["params_sha256"]
              and res["engine"] == "flat_sharded" and res["K"] == 1
              and len(res["losses"]) == 2
              and all(np.isfinite(res["losses"]))
              and res["resumed_start"] == 2
              and res["resumed_sha"] == res["smoke_sha"]
              and res["half_losses"] == res["whole_losses"][:2]
              and res["resumed_losses"] == res["whole_losses"][2:])
        if not ok:
            raise AssertionError(f"tp launch rank {r}: {res}")
    return {"round_seconds_per_rank": [r["round_seconds"] for r in results],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in results],
            "losses": r0["losses"], "params_sha256": r0["params_sha256"],
            "smoke_resume_bit_equal": True}


def phase_tp(smi: str) -> dict:
    """Tensor-parallel execution: the 100m LM on (1, 2) and (2, 2) gloo
    worlds on this card (`tp_lm`), NCCL across cards where two or more
    are visible, then the launcher on a (1, 2) world for gemma-2b at full
    width (`tp_launch`). Returns rank 0's launches on (1, 2)."""
    t0 = time.perf_counter()
    out = {"phase": "tp", "card": smi, "note": MESH2D_CARD_NOTE,
           "model": f"{LM_PRESET} f32 flash, K = {LM_K}, tau = {LM_TAU}, "
                    f"B = {LM_B}, T = {LM_T}"}
    launches = None
    for name, shape in TP_LM_MESHES.items():
        t1 = time.perf_counter()
        res = check_tp_lm(run_mesh2d("tp", "gloo", shape),
                          f"tp gloo {name}")
        out[f"lm_gloo_{name}_one_card"] = {
            **res, "seconds": time.perf_counter() - t1}
        launches = launches or res["launches_per_rank"]
    cards = torch.cuda.device_count()
    if cards >= 2:
        out["lm_nccl_1x2"] = check_tp_lm(run_mesh2d("tp", "nccl", (1, 2)),
                                         "tp nccl (1, 2)")
    else:
        print(f"tp: NCCL across cards not run: {cards} card visible",
              flush=True)
    t1 = time.perf_counter()
    out["launch_gemma_gloo_1x2_one_card"] = {
        **check_tp_launch(run_mesh2d("launch", "gloo", (1, 2))),
        "seconds": time.perf_counter() - t1}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return launches


# ---- tensor-parallel serving and the DeepSeek family over "model" ----

TPS_SHAPE = (1, 2)  # a gloo world of two ranks on this card
TPS_TIMEOUT = 600  # seconds the world may take
TPS_GEMMA = (4, 1024, 32)  # B, prompt, greedy steps: bf16, flash
TPS_DEEPSEEK = (4, 512, 16)  # bf16; MLA runs no flash
TPS_DIRECT_STEPS = 8  # gemma decode steps timed alone, as the CLI times
# the configs held tensor-parallel == whole at PARITY_TOL, in f32: the
# reduced ones, and deepseek-v2-lite at full width cut to 2 layers (its
# 64 experts split on E, 16 MLA heads a whole 8 a rank)
TPS_PARITY = (("gemma-2b", "gemma-2b", {}, False),
              ("minitron-4b-flash", "minitron-4b", {"attention_impl": "flash"},
               False),
              ("deepseek-v2-lite-16b", "deepseek-v2-lite-16b", {}, False),
              ("deepseek-v2-lite-16b-q32", "deepseek-v2-lite-16b",
               {"mla": {"q_lora_rank": 32}}, False),
              ("deepseek-v2-lite-16b-full-2l", "deepseek-v2-lite-16b",
               {"num_layers": 2, "dtype": "float32"}, True))
TPS_PARITY_B, TPS_PARITY_T, TPS_PARITY_STEPS = 2, 64, 4
# one round through launch.train: deepseek-v2-lite at full width, cut
TPS_ROUND_CUT = {"num_layers": 2, "dtype": "float32"}
TPS_ROUND_ARGV = ["--arch", "deepseek-v2-lite-16b", "--seq", "128",
                  "--global-batch", "2", "--rounds", "1"]
TPS_SERVE_ARGV = ["--arch", "gemma-2b", "--shape", "decode_32k", "--batch",
                  "4", "--seq", "4096", "--steps", "8"]
TPS_REFS = "CHIP_SMOKE_TP_SERVE_REFS"  # env: the whole-model results' dir


def tps_tokens(vocab: int, b: int, t: int, seed: int) -> torch.Tensor:
    """(b, t) token ids from a CPU generator: the same on every process."""
    return torch.randint(0, vocab, (b, t),
                         generator=torch.Generator().manual_seed(seed))


def tps_init(cfg, dev, mesh=None):
    """The params of `cfg` from seed 0 on `dev`: whole, or this rank's
    blocks of the same draws (`init_params(..., mesh=, specs=)`)."""
    from repro_torch.models import sharding, transformer

    specs = None
    if mesh is not None:
        specs = sharding.param_pspecs(
            transformer.init_params(None, cfg, device="meta"), mesh)
    return transformer.init_params(torch.Generator(device=dev).manual_seed(0),
                                   cfg, mesh=mesh, specs=specs)


def tps_gemma_cfg():
    from repro_torch.configs import registry

    return dataclasses.replace(registry.get("gemma-2b"),
                               attention_impl="flash")


def tps_last_logits(params, cfg, tokens) -> torch.Tensor:
    """The prefill's last-position logits (B, V), whole: inside a
    tp.scope its vocab blocks gathered."""
    from repro_torch.models import tp, transformer

    with torch.no_grad():
        logits, _, _ = transformer.forward(params, cfg, {"tokens": tokens},
                                           mode="prefill")
        return tp.gather_logits(logits[:, -1], cfg.vocab_size)


def tps_round(dev, extra: list) -> dict:
    """One round of deepseek-v2-lite cut to TPS_ROUND_CUT through
    `launch.train.main` (its registry lookup pointed at the cut), and
    the round's params (this rank's blocks off the host mesh) with their
    spec tree (None on the host mesh), as the launcher hands them to its
    `params_sha256` at the end."""
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models.config import with_changes

    real_get, real_sha = registry.get, train.params_sha256
    seen = {}

    def get(name):
        cfg = real_get(name)
        return with_changes(cfg, TPS_ROUND_CUT) \
            if name == "deepseek-v2-lite-16b" else cfg

    def sha(params, mesh=None, specs=None):
        seen.update(params=params, specs=specs)
        return real_sha(params, mesh, specs)

    registry.get, train.params_sha256 = get, sha
    try:
        res = train.main(TPS_ROUND_ARGV + extra + ["--device", str(dev)])
    finally:
        registry.get, train.params_sha256 = real_get, real_sha
    return {**res, **seen}


def tps_parity_run(cfg, params, prefill, decode, i: int, dev):
    """The f32 parity case i: the prefill step's last logits, then
    TPS_PARITY_STEPS decode steps on seeded tokens, (B, 1 + steps, V)."""
    b, t, steps = TPS_PARITY_B, TPS_PARITY_T, TPS_PARITY_STEPS
    tokens = tps_tokens(cfg.vocab_size, b, t, 20 + i).to(dev)
    dec = tps_tokens(cfg.vocab_size, b, steps, 30 + i).to(dev)
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": tokens})
        out = [logits]
        for s_ in range(steps):
            logits, cache = decode(params, dec[:, s_:s_ + 1], cache, t + s_)
            out.append(logits)
    return torch.cat(out, dim=1)


def tps_parity_cfg(name: str, changes: dict, full: bool):
    """A parity case's config: the registry's full config or its reduced
    one, with `changes`; f32 either way."""
    from repro_torch.configs import registry
    from repro_torch.models.config import with_changes

    cfg = with_changes(registry.get(name) if full else registry.smoke(name),
                       changes)
    assert cfg.dtype == "float32", cfg.dtype
    return cfg


def tps_parity_steps(cfg, mesh):
    """build_prefill_step's and build_decode_step's fns for a parity
    case on `mesh` (a host mesh: the whole model)."""
    from repro_torch.configs import shapes
    from repro_torch.launch import steps

    b, t, n = TPS_PARITY_B, TPS_PARITY_T, TPS_PARITY_STEPS
    prefill = steps.build_prefill_step(
        cfg, mesh, shapes.InputShape("prefill", t + n, b, "prefill"))[0]
    decode = steps.build_decode_step(
        cfg, mesh, shapes.InputShape("decode", t + n, b, "decode"))[0]
    return prefill, decode


def tp_serve_refs(dev, out_dir: str) -> dict:
    """The whole-model results the tensor-parallel world is held to,
    each model made, run and freed in turn in this process before the
    world starts: gemma-2b's last prefill logits and greedy ids, the
    same of deepseek-v2-lite-16b, the f32 parity cases through the step
    builders on the host mesh, and the cut deepseek round on the host
    mesh (its params written to `out_dir`). Returns the seconds."""
    from repro_torch.configs import registry
    from repro_torch.core import treemath
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    t0 = time.perf_counter()
    for name, cfg, (b, t, n) in (
            ("gemma", tps_gemma_cfg(), TPS_GEMMA),
            ("deepseek", registry.get("deepseek-v2-lite-16b"),
             TPS_DEEPSEEK)):
        params = tps_init(cfg, dev)
        tokens = tps_tokens(cfg.vocab_size, b, t, 11).to(dev)
        with moe.record_routing() as routing:
            last = tps_last_logits(params, cfg, tokens)
        ids = serve.generate(params, cfg, tokens, n)
        torch.save({"last": last.float().cpu(), "ids": ids.cpu(),
                    "experts": [c["experts"].cpu() for c in routing]},
                   os.path.join(out_dir, f"{name}.pt"))
        del params, last, ids
        torch.cuda.empty_cache()
    host = make_host_mesh(dev)
    parity = {}
    for i, (_, name, changes, full) in enumerate(TPS_PARITY):
        cfg = tps_parity_cfg(name, changes, full)
        params = tps_init(cfg, dev)
        parity[i] = tps_parity_run(cfg, params, *tps_parity_steps(cfg, host),
                                   i, dev).cpu()
        del params
        torch.cuda.empty_cache()
    torch.save(parity, os.path.join(out_dir, "parity.pt"))
    res = tps_round(dev, ["--host-mesh"])
    params = res.pop("params")
    torch.save({"/".join(p): x.detach().cpu() for p, x in zip(
        treemath.tree_paths(params), treemath.tree_leaves(params))},
        os.path.join(out_dir, "round.pt"))
    torch.save({"losses": res["losses"]},
               os.path.join(out_dir, "round_losses.pt"))
    del params, res
    torch.cuda.empty_cache()
    return {"seconds": time.perf_counter() - t0}


def tps_collectives_from_shapes(cfg, b: int, t: int) -> tuple[int, int]:
    """(count, bytes) of the "tp" collectives of one gemma prefill step of
    b rows of t tokens (a decode step: t = 1) on a model axis of 2 whose
    q blocks hold whole heads and whose one KV head's head_dim is split:
    the vocab-parallel embedding's all-reduce; per layer the all_gathers
    of k and v (this rank's half of the head_dim) and the all-reduces
    after wo and w_down; the last position's logits gathered."""
    act = b * t * cfg.d_model * cfg.tdtype.itemsize
    kv = b * t * cfg.num_kv_heads * cfg.hd // 2 * cfg.tdtype.itemsize
    logits = b * cfg.vocab_size // 2 * cfg.tdtype.itemsize
    layers_ = cfg.num_layers
    return (2 + 4 * layers_,
            act + layers_ * (2 * kv + 2 * act) + logits)


def tps_flash_spy(fa, calls: list, tol: float):
    """A stand-in for `fa._forward` that runs the kernel and holds each
    call's output against `gqa_plain` on the same q, k, v at `tol`,
    listing (q heads, (max |d|, excess)) in `calls`."""
    real = fa._forward

    def spy(q, k, v, causal):
        o = real(q, k, v, causal)
        calls.append((q.shape[2], allclose_err(o, gqa_plain(fa, q, k, v),
                                               tol)))
        return o

    return spy


def tps_flash_worst(calls: list) -> list:
    """[calls, worst max |d|, worst excess] of a spy's list."""
    return [len(calls), max((c[1][0] for c in calls), default=0.0),
            max((c[1][1] for c in calls), default=0.0)]


def tps_gemma(mesh, dev) -> dict:
    """(a): gemma-2b at full width and depth, bf16, flash, in this rank's
    blocks: generate under a scope (prefill ms, decode ms a step, the
    peak), the flash launches and heads of a prefill, each flash call of
    the warm-up at its local shape against its plain version, the "tp"
    collectives of one prefill and one decode step through the step
    builders, and the last logits and greedy ids against the whole
    model's."""
    from repro_torch.configs import shapes
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import serve, steps
    from repro_torch.models import tp

    cfg = tps_gemma_cfg()
    b, t, n = TPS_GEMMA
    ref = torch.load(os.path.join(os.environ[TPS_REFS], "gemma.pt"))
    params = tps_init(cfg, dev, mesh)
    tokens = tps_tokens(cfg.vocab_size, b, t, 11).to(dev)
    calls, real = [], fa._forward
    with tp.scope(mesh, rows_over_data=True):
        fa._forward = tps_flash_spy(fa, calls, FLASH_TOL["bfloat16"])
        try:
            serve.generate(params, cfg, tokens, 2)  # warm-up, heads seen
        finally:
            fa._forward = real
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run(steps_):
            fa.flash_attention.launches = 0
            t0 = time.perf_counter()
            ids_ = serve.generate(params, cfg, tokens, steps_)
            torch.cuda.synchronize()
            return ids_, (time.perf_counter() - t0) * 1e3, \
                fa.flash_attention.launches

        ids, total_ms, launches = run(n)  # the main path, counted
        peak = torch.cuda.max_memory_allocated()
        pre = [run(1) for _ in range(3)]
        last = tps_last_logits(params, cfg, tokens).float().cpu()
    prefill_ms = float(np.median([p[1] for p in pre]))
    s_ = t + 2 + TPS_DIRECT_STEPS
    prefill, _, _, _, _ = steps.build_prefill_step(
        cfg, mesh, shapes.InputShape("prefill", s_, b, "prefill"))
    decode, _, _, _, _ = steps.build_decode_step(
        cfg, mesh, shapes.InputShape("decode", s_, b, "decode"))
    tok = ids[:, :1]
    with torch.no_grad():
        with mesh.recording() as plog:
            _, cache = prefill(params, {"tokens": tokens})
        with mesh.recording() as dlog:
            decode(params, tok, cache, t)
        # decode steps alone through the step builder's fn, as the
        # serving CLI times them, then one profiled step and prefill
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TPS_DIRECT_STEPS):
            decode(params, tok, cache, t + 1 + i)
        torch.cuda.synchronize()
        direct_ms = (time.perf_counter() - t0) * 1e3 / TPS_DIRECT_STEPS
        prof_decode = brief(profile_device(lambda: decode(
            params, tok, cache, t + 1 + TPS_DIRECT_STEPS)))
        del cache
        prof_prefill = brief(profile_device(lambda: prefill(
            params, {"tokens": tokens})))
    ids = ids.cpu()
    out = {
        "prefill_ms": prefill_ms,
        "prefill_ms_runs": [p[1] for p in pre],
        "decode_ms_per_step": (total_ms - prefill_ms) / (n - 1),
        "decode_ms_per_step_direct": direct_ms,
        "profile_decode_step": prof_decode,
        "profile_prefill_step": prof_prefill,
        "generate_ms": total_ms, "peak_bytes": peak,
        "flash_launches": launches,
        "flash_launches_prefill_alone": [p[2] for p in pre],
        "flash_heads": sorted(set(c[0] for c in calls)),
        "flash_calls_warmup": len(calls),
        "flash_vs_plain": tps_flash_worst(calls),
        "tp_prefill": [sum(c.scope == "tp" for c in plog),
                       sum(c.nbytes for c in plog if c.scope == "tp")],
        "tp_decode": [sum(c.scope == "tp" for c in dlog),
                      sum(c.nbytes for c in dlog if c.scope == "tp")],
        "want_tp_prefill": tps_collectives_from_shapes(cfg, b, t),
        "want_tp_decode": tps_collectives_from_shapes(cfg, b, 1),
        "other_collectives": sum(c.scope != "tp" for c in plog + dlog),
        "logit_gap": float((last - ref["last"]).abs().max()),
        "logit_scale": float(ref["last"].abs().max()),
        "ids_equal_share": float((ids == ref["ids"]).float().mean()),
        "ids": ids, "finite": bool(torch.isfinite(last).all()),
        "layers": cfg.num_layers, "heads_per_rank":
            cfg.num_heads // mesh.model_size}
    del params
    torch.cuda.empty_cache()
    return out


def tps_deepseek(mesh, dev) -> dict:
    """(b): deepseek-v2-lite-16b at full width and depth, bf16, in this
    rank's blocks: the block bytes, the peak after init (held to those +
    INIT_SLACK), prefill ms, decode ms a step, the routing of one prefill
    (its digest, held equal across ranks, and the dropped share), and
    the last prefill logits against the whole model's."""
    from repro_torch.configs import registry
    from repro_torch.core import treemath
    from repro_torch.launch import serve
    from repro_torch.models import moe, tp

    cfg = registry.get("deepseek-v2-lite-16b")
    b, t, n = TPS_DEEPSEEK
    ref = torch.load(os.path.join(os.environ[TPS_REFS], "deepseek.pt"))
    t0 = time.perf_counter()
    params = tps_init(cfg, dev, mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    blocks = sum(x.numel() * x.element_size()
                 for x in treemath.tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    tokens = tps_tokens(cfg.vocab_size, b, t, 11).to(dev)
    with tp.scope(mesh, rows_over_data=True):
        serve.generate(params, cfg, tokens, 2)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = serve.generate(params, cfg, tokens, n)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        pre = []
        for _ in range(3):
            with moe.record_routing() as routing:
                t0 = time.perf_counter()
                serve.generate(params, cfg, tokens, 1)
                torch.cuda.synchronize()
                pre.append((time.perf_counter() - t0) * 1e3)
        last = tps_last_logits(params, cfg, tokens).float().cpu()
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = float(np.median(pre))
    keep = torch.cat([c["keep"].reshape(-1) for c in routing])
    # the assignments whose expert set differs from the whole model's
    # (each token's top-k sorted), layer by layer
    k_ = cfg.moe.top_k
    flips = [int((torch.sort(c["experts"].cpu().reshape(-1, k_))[0]
                  != torch.sort(w.reshape(-1, k_))[0]).sum())
             for c, w in zip(routing, ref["experts"])]
    digest_ = hashlib.sha256()
    for call in routing:
        for key in sorted(call):
            digest_.update(call[key].contiguous().view(torch.uint8).cpu()
                           .numpy().tobytes())
    out = {"init_s": init_s, "block_bytes": blocks, "peak_after_init": peak,
           "prefill_ms": prefill_ms, "prefill_ms_runs": pre,
           "decode_ms_per_step": (total_ms - prefill_ms) / (n - 1),
           "generate_ms": total_ms, "routing_calls": len(routing),
           "routing_sha256": digest_.hexdigest(),
           "dropped_share": float(1.0 - keep.float().mean()),
           "routing_vs_whole_differing": flips,
           "routing_vs_whole_assignments": int(keep.numel()),
           "logit_gap": float((last - ref["last"]).abs().max()),
           "logit_scale": float(ref["last"].abs().max()),
           "last_argmax_equal_share": float(
               (last.argmax(-1) == ref["last"].argmax(-1)).float().mean()),
           "ids_equal_share": float((ids.cpu() == ref["ids"]).float()
                                    .mean()),
           "finite": bool(torch.isfinite(last).all()),
           "layers": cfg.num_layers}
    del params, ids
    torch.cuda.empty_cache()
    return out


def tps_parity(mesh, dev) -> dict:
    """(c): each f32 parity case through the step builders' fns on this
    rank's blocks against the whole model's, at PARITY_TOL; the flash
    launches of each case's counted run, each call held against its
    plain version at its local shape."""
    from repro_torch.kernels import flash_attn as fa

    refs = torch.load(os.path.join(os.environ[TPS_REFS], "parity.pt"))
    out, real = {}, fa._forward
    for i, (label, name, changes, full) in enumerate(TPS_PARITY):
        cfg = tps_parity_cfg(name, changes, full)
        params = tps_init(cfg, dev, mesh)
        fa.flash_attention.launches, calls = 0, []
        fa._forward = tps_flash_spy(fa, calls, FLASH_TOL["float32"])
        try:
            got = tps_parity_run(cfg, params, *tps_parity_steps(cfg, mesh),
                                 i, dev).cpu()
        finally:
            fa._forward = real
        err, excess = allclose_err(got, refs[i], PARITY_TOL)
        out[label] = {
            "max_abs": err, "excess": excess,
            "flash_launches": fa.flash_attention.launches,
            "flash_vs_plain": tps_flash_worst(calls)}
        del params
        torch.cuda.empty_cache()
    return out


def tps_round_child(mesh, dev) -> dict:
    """(d): the cut deepseek round through launch.train on this world:
    its FL launches, and its params (this rank's blocks) and loss
    against the host mesh's round at PARITY_TOL."""
    from repro_torch.core import treemath
    from repro_torch.kernels import round_stats as rs
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.models import sharding

    refs = os.environ[TPS_REFS]
    wa.weighted_agg.launches = rs.round_stats.launches = 0
    res = tps_round(dev, [])
    launches = {"weighted_agg": wa.weighted_agg.launches,
                "round_stats": rs.round_stats.launches}
    params, specs = res.pop("params"), res["specs"]
    whole = torch.load(os.path.join(refs, "round.pt"), mmap=True)
    worst, where, max_abs = -math.inf, "", 0.0
    for path, x, spec in zip(treemath.tree_paths(params),
                             treemath.tree_leaves(params),
                             treemath.tree_leaves_like(params, specs)):
        key = "/".join(path)
        want = sharding.block(whole[key], mesh, spec).to(dev)
        e, w = excess_err({key: (x, want)}, PARITY_TOL, PARITY_TOL)
        max_abs = max(max_abs, float((x.double() - want.double()).abs()
                                     .max()))
        if e > worst:
            worst, where = e, w
        del want
    want = torch.load(os.path.join(refs, "round_losses.pt"))["losses"]
    loss_err = allclose_err(torch.tensor(res["losses"]), torch.tensor(want),
                            PARITY_TOL)
    del params, res, whole
    torch.cuda.empty_cache()
    return {"launches": launches, "excess": worst, "worst_leaf": where,
            "max_abs": max_abs, "specs_given": specs is not None,
            "loss_whole": want, "loss_max_abs": loss_err[0],
            "loss_excess": loss_err[1]}


def tps_serve_cli(dev) -> dict:
    """(e): `python -m repro_torch.launch.serve TPS_SERVE_ARGV` on this
    world: its ms a token and tokens."""
    from repro_torch.launch import serve

    res = serve.main(TPS_SERVE_ARGV + ["--device", str(dev)])
    out = {"ms_per_token": res["ms_per_token"],
           "tokens": res["tokens"]}
    del res
    torch.cuda.empty_cache()
    return out


def tp_serve(mesh, dev, rank: int) -> dict:
    """One rank of the tensor-parallel serving world: (b) deepseek-v2-lite
    first (the largest blocks), then (a) gemma-2b, (c) the f32 parity
    cases, (d) the cut deepseek round and (e) the serving CLI."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    out = {"deepseek": tps_deepseek(mesh, dev),
           "gemma": tps_gemma(mesh, dev),
           "parity": tps_parity(mesh, dev),
           "round": tps_round_child(mesh, dev),
           "serve_cli": tps_serve_cli(dev)}
    return out


def check_tp_serve(results: list) -> dict:
    """The ranks' greedy ids, routing and CLI tokens equal; (a) 18 flash
    launches a prefill, each on the rank's heads, the "tp" collectives
    of the shapes; (b) the peak after init within the block bytes +
    INIT_SLACK; (c) every parity case within PARITY_TOL; (d) 2 + 1 FL
    launches and the round within PARITY_TOL. Returns the line's part."""
    r0 = results[0]
    g0, d0 = r0["gemma"], r0["deepseek"]
    bad = []
    for r, res in enumerate(results):
        g, d, rd = res["gemma"], res["deepseek"], res["round"]
        checks = {
            "gemma ids equal across ranks": torch.equal(g["ids"], g0["ids"]),
            "gemma finite": g["finite"],
            "gemma flash launches": g["flash_launches"] == g["layers"]
            and all(x == g["layers"]
                    for x in g["flash_launches_prefill_alone"]),
            "gemma flash on the rank's heads":
                g["flash_heads"] == [g["heads_per_rank"]],
            "gemma flash vs plain": g["flash_vs_plain"][0] == g["layers"]
            and g["flash_vs_plain"][2] <= 1.0,
            "gemma tp prefill collectives":
                tuple(g["tp_prefill"]) == tuple(g["want_tp_prefill"]),
            "gemma tp decode collectives":
                tuple(g["tp_decode"]) == tuple(g["want_tp_decode"]),
            "gemma no other collective": g["other_collectives"] == 0,
            "deepseek routing equal across ranks":
                d["routing_sha256"] == d0["routing_sha256"]
                and d["routing_calls"] == d["layers"],
            "deepseek peak": d["peak_after_init"]
            <= d["block_bytes"] + INIT_SLACK,
            "deepseek finite": d["finite"],
            "parity": all(c["excess"] <= 1.0
                          for c in res["parity"].values()),
            "parity flash vs plain": all(
                c["flash_vs_plain"][0] == c["flash_launches"]
                and c["flash_vs_plain"][2] <= 1.0
                for c in res["parity"].values())
            and res["parity"]["minitron-4b-flash"]["flash_launches"] > 0,
            "round launches": rd["launches"] == {"weighted_agg": 2,
                                                 "round_stats": 1},
            "round vs whole": rd["excess"] <= 0 and rd["specs_given"]
            and rd["loss_excess"] <= 1.0,
            "serve cli tokens": torch.equal(
                res["serve_cli"]["tokens"], r0["serve_cli"]["tokens"])
            and math.isfinite(res["serve_cli"]["ms_per_token"]),
        }
        bad += [f"rank {r}: {name}" for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"tp_serve: {bad}: " + json.dumps(
            {k: v for k, v in r0.items()}, default=str)[:6000])
    return {
        "ranks": len(results),
        "gemma": {**{k: v for k, v in g0.items() if k != "ids"},
                  "prefill_ms_per_rank": [r["gemma"]["prefill_ms"]
                                          for r in results],
                  "decode_ms_per_step_per_rank": [
                      r["gemma"]["decode_ms_per_step"] for r in results],
                  "decode_ms_per_step_direct_per_rank": [
                      r["gemma"]["decode_ms_per_step_direct"]
                      for r in results],
                  "peak_bytes_per_rank": [r["gemma"]["peak_bytes"]
                                          for r in results],
                  "sample_ids": g0["ids"][0, :12].tolist()},
        "deepseek": {**d0,
                     "prefill_ms_per_rank": [r["deepseek"]["prefill_ms"]
                                             for r in results],
                     "decode_ms_per_step_per_rank": [
                         r["deepseek"]["decode_ms_per_step"]
                         for r in results],
                     "peak_after_init_per_rank": [
                         r["deepseek"]["peak_after_init"] for r in results],
                     "routing_bit_equal": True},
        "parity": r0["parity"],
        "round": {**r0["round"],
                  "excess_per_rank": [r["round"]["excess"]
                                      for r in results]},
        "serve_cli": {"argv": " ".join(TPS_SERVE_ARGV),
                      "ms_per_token_per_rank": [
                          r["serve_cli"]["ms_per_token"] for r in results],
                      "tokens_rank0": r0["serve_cli"]["tokens"][0].tolist()},
    }


def phase_tp_serve(smi: str) -> dict:
    """Tensor-parallel serving and the DeepSeek family over "model": the
    whole-model references in this process (each freed before the world
    starts), then one (1, 2) gloo world on this card runs (a)-(e)
    (`tp_serve`), and a (1, 2) NCCL world across two cards where two or
    more are visible. Returns rank 0's launches of the slice's kernels
    on the gloo world."""
    import tempfile

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {"phase": "tp_serve", "card": smi, "note": MESH2D_CARD_NOTE,
           "mesh": list(TPS_SHAPE)}
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as refs:
        out["whole_model_refs"] = tp_serve_refs(dev, refs)
        torch.cuda.empty_cache()
        os.environ[TPS_REFS] = refs
        t1 = time.perf_counter()
        try:
            results = run_mesh2d("tp_serve", "gloo", TPS_SHAPE, TPS_TIMEOUT)
            out["world_seconds"] = time.perf_counter() - t1
            if cards >= 2:  # one rank a card
                out["nccl_1x2"] = check_tp_serve(run_mesh2d(
                    "tp_serve", "nccl", TPS_SHAPE, TPS_TIMEOUT))
            else:
                print(f"tp_serve: NCCL across cards not run: {cards} card "
                      "visible", flush=True)
        finally:
            os.environ.pop(TPS_REFS, None)
    out.update(check_tp_serve(results))
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    r0 = results[0]
    return {"flash_attention": r0["gemma"]["flash_launches"],
            "flash_attention_f32":
                r0["parity"]["minitron-4b-flash"]["flash_launches"],
            **r0["round"]["launches"]}


# ---- FSDP: params over "data" (the sequential round, serving) and the
# decode cache's sequence on "data" ----

FSDP_SHAPE = (2, 2)  # a gloo world of four ranks on this card
FSDP_TIMEOUT = 900  # seconds the world may take
# (a) the sequential (FSDP) round: deepseek-v2-lite-16b at full width,
# cut to one layer (at two, four ranks' rounds did not fit the card)
FSDP_ROUND_CUT = {"num_layers": 1, "dtype": "float32"}
FSDP_ROUND = (4, 1, 4, 256)  # K, tau, B, T
# the most param-sized f32 trees the sequential round holds at once, in
# blocks: the params, prev_delta, g (raveled), the two online sums, and
# in a client's step its gradient, stepped params and delta
FSDP_ROUND_TREES = 8
# one group's working set in a backward, in its gathered size: the
# leaves, their cotangents and the reduce-scatter's staging copy
FSDP_GROUP_BACKWARD = 3
# (b) FSDP serving: deepseek-v2-236b at full width, bf16, one layer
# (each decode step gathers every layer over gloo's host staging)
FSDP_SERVE_CUT = {"num_layers": 1}
# B, prompt, greedy tokens (a prefill and 3 decode steps: at ~9 s a step
# through gloo on one card, 16 steps would take ~150 s alone)
FSDP_SERVE = (4, 512, 4)
# (c) long_500k, B = 1, the cache's sequence on "data": gemma-2b whole
# (its ring of 8,192 slots split at 4,096 on (2, 2)), then
# deepseek-v2-lite cut to 8 layers over its 524,288 latent positions
# (split at 262,144); positions crossing those and gemma's ring wrap
FSDP_LONG = (
    ("gemma-2b", {}, (503806, 503807, 503808, 503809,
                      507902, 507903, 507904, 507905)),
    ("deepseek-v2-lite-16b", {"num_layers": 8},
     (262142, 262143, 262144, 262145)))
# (d) f32 reduced configs with fsdp=True: B = 2 (rows over "data"), and
# B = 1 (the cache's sequence over "data", its block edge at position
# 65, which the decode steps cross)
FSDP_PARITY = (("gemma-2b", {"attention_impl": "flash"}),
               ("minitron-4b", {"attention_impl": "flash"}),
               ("deepseek-v2-lite-16b", {"mla": {"q_lora_rank": 32}}))
FSDP_PARITY_T, FSDP_PARITY_STEPS = 64, 3
FSDP_PARITY_S = {2: 68, 1: 130}  # B -> cache positions
FSDP_SERVE_ARGV = ["--arch", "gemma-2b", "--shape", "long_500k", "--steps",
                   "8"]
FSDP_REFS = "CHIP_SMOKE_FSDP_REFS"  # env: the whole-model results' dir


def fsdp_specs(cfg, mesh, fsdp: bool = True):
    """The UNSTACKED param specs of `cfg` on `mesh`, FSDP or not."""
    from repro_torch.models import sharding, transformer

    return sharding.param_pspecs(
        transformer.init_params(None, cfg, device="meta"), mesh, fsdp=fsdp)


def fsdp_init(cfg, dev, mesh=None, fsdp: bool = True):
    """The params of `cfg` from seed 0: whole, or this rank's blocks of
    the same draws on both axes (FSDP) or on "model" only."""
    from repro_torch.models import transformer

    specs = None if mesh is None else fsdp_specs(cfg, mesh, fsdp)
    return transformer.init_params(torch.Generator(device=dev).manual_seed(0),
                                   cfg, mesh=mesh, specs=specs)


def fsdp_round_cfg():
    from repro_torch.configs import registry
    from repro_torch.models.config import with_changes

    return with_changes(registry.get("deepseek-v2-lite-16b"), FSDP_ROUND_CUT)


def fsdp_round_fl():
    import repro_torch

    k, tau, _, _ = FSDP_ROUND
    return repro_torch.FLConfig(num_clients=k, clients_per_round=k,
                                local_steps=tau, mode="sequential")


def fsdp_round_inputs(cfg, dev):
    k, tau, b, t = FSDP_ROUND
    toks = tps_tokens(cfg.vocab_size, k * tau * b, t, 41).reshape(
        k, tau, b, t).to(dev)
    return ({"tokens": toks}, torch.arange(k, dtype=torch.int32, device=dev),
            torch.arange(1, k + 1, dtype=torch.float32, device=dev))


def fsdp_cache(cfg, b: int, s: int, dev, seed: int, mesh=None):
    """A decode cache of `cfg` (b rows, s positions) filled from `seed`
    with N(0, 1): whole, or this rank's blocks of the same draws
    (`sharding.cache_pspecs`), each leaf cut as it is filled."""
    from repro_torch.models import layers, sharding, transformer

    shapes = transformer.init_cache(cfg, b, s, device="meta")

    def inits(tree):
        if isinstance(tree, dict):
            return {k: inits(v) for k, v in tree.items()}
        return layers.normal(tuple(tree.shape), 1.0, tree.dtype)

    cut = None
    if mesh is not None:
        specs = sharding.cache_pspecs(shapes, mesh)

        def cut(keys, x):
            return sharding.block(x, mesh, sharding.spec_at(specs, keys))
    return layers.make(inits(shapes), torch.Generator(device=dev)
                       .manual_seed(seed), dev, cut)


def fsdp_long_len() -> int:
    """long_500k's cache positions."""
    from repro_torch.configs import shapes

    return shapes.SHAPES["long_500k"].seq_len


def fsdp_long_cfg(name: str, changes: dict):
    from repro_torch.configs import registry, shapes
    from repro_torch.models.config import with_changes

    cfg = with_changes(registry.get(name), changes)
    return cfg, shapes.config_for_shape(cfg, shapes.SHAPES["long_500k"])


def fsdp_parity_cfg(name: str, changes: dict):
    from repro_torch.configs import registry
    from repro_torch.models.config import with_changes

    cfg = with_changes(registry.smoke(name), changes)
    assert cfg.dtype == "float32", cfg.dtype
    return cfg


def fsdp_parity_run(cfg, params, mesh, b: int, i: int, dev):
    """Prefill and FSDP_PARITY_STEPS decode steps through the step
    builders' fns with fsdp=True (this data index's rows, or all where b
    does not split over "data"): the logits (rows, 1 + steps, V)."""
    from repro_torch.configs import shapes
    from repro_torch.launch import steps

    t, n, s = FSDP_PARITY_T, FSDP_PARITY_STEPS, FSDP_PARITY_S[b]
    prefill = steps.build_prefill_step(
        cfg, mesh, shapes.InputShape("prefill", s, b, "prefill"),
        fsdp=True)[0]
    decode = steps.build_decode_step(
        cfg, mesh, shapes.InputShape("decode", s, b, "decode"), fsdp=True)[0]
    rows = fsdp_rows(mesh, b)
    tokens = tps_tokens(cfg.vocab_size, b, t, 50 + i)[rows].to(dev)
    dec = tps_tokens(cfg.vocab_size, b, n, 60 + i)[rows].to(dev)
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": tokens})
        out = [logits]
        for s_ in range(n):
            logits, cache = decode(params, dec[:, s_:s_ + 1], cache, t + s_)
            out.append(logits)
    return torch.cat(out, dim=1)


def fsdp_rows(mesh, b: int) -> slice:
    """This data index's rows of a global batch of b (all rows on the
    host mesh or where b does not split over "data")."""
    from repro_torch.launch import steps

    if not steps._tensor_parallel(mesh) or not steps.rows_split(mesh, b):
        return slice(0, b)
    n = b // mesh.client_size
    return slice(mesh.client_index * n, (mesh.client_index + 1) * n)


def fsdp_long_run(cfg, cfg2, params, cache, mesh, positions, dev):
    """Decode steps at `positions` on a B = 1 cache through the step
    builder's fn at long_500k (the host mesh's fn is the whole model's
    decode_step): the logits (1, steps, V) and ms a step."""
    from repro_torch.configs import shapes
    from repro_torch.launch import steps

    decode = steps.build_decode_step(cfg, mesh, shapes.SHAPES["long_500k"],
                                     fsdp=False)[0]
    toks = tps_tokens(cfg2.vocab_size, 1, len(positions), 70).to(dev)
    out = []
    with torch.no_grad():
        decode(params, toks[:, :1], cache, positions[0])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, pos in enumerate(positions):
            logits, cache = decode(params, toks[:, i:i + 1], cache, pos)
            out.append(logits)
        torch.cuda.synchronize()
    return (torch.cat(out, dim=1),
            (time.perf_counter() - t0) * 1e3 / len(positions))


def fsdp_refs(dev, out_dir: str) -> dict:
    """The whole-model results the FSDP world is held to, each model
    made, run and freed in turn in this process: (a) the sequential
    round of the cut lite (its new params and prev_delta written leaf by
    leaf to `out_dir`), (b) the cut 236b's last prefill logits, routing
    and greedy ids, (c) each long_500k decode on its seeded cache, (d)
    the f32 parity cases on the host mesh. Returns the seconds."""
    import repro_torch
    from repro_torch.configs import registry
    from repro_torch.core import treemath
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe, transformer
    from repro_torch.models.config import with_changes

    t0 = time.perf_counter()
    host = make_host_mesh(dev)
    # (a)
    cfg = fsdp_round_cfg()
    fl = fsdp_round_fl()
    state = repro_torch.init_round_state(fl, fsdp_init(cfg, dev))
    batch, sel, sizes = fsdp_round_inputs(cfg, dev)
    rf = repro_torch.make_round_fn(
        lambda p, bt: transformer.loss_fn(p, cfg, bt), fl)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    state, m = rf(state, batch, sel, sizes)
    torch.cuda.synchronize()
    whole_round_ms = (time.perf_counter() - t1) * 1e3
    whole_peak = torch.cuda.max_memory_allocated()
    for name in ("params", "prev_delta"):
        tree = getattr(state, name)
        torch.save({"/".join(p): x.detach().cpu() for p, x in zip(
            treemath.tree_paths(tree), treemath.tree_leaves(tree))},
            os.path.join(out_dir, f"round_{name}.pt"))
    torch.save({"metrics": {k: v.cpu() for k, v in m.items()},
                "angle": state.angle.smoothed.cpu(),
                "count": state.angle.count.cpu(),
                "ms": whole_round_ms, "peak": whole_peak},
               os.path.join(out_dir, "round_metrics.pt"))
    del state, m, rf, batch
    torch.cuda.empty_cache()
    # (b)
    cfg = with_changes(registry.get("deepseek-v2-236b"), FSDP_SERVE_CUT)
    b, t, n = FSDP_SERVE
    params = fsdp_init(cfg, dev)
    tokens = tps_tokens(cfg.vocab_size, b, t, 43).to(dev)
    with moe.record_routing() as routing:
        last = tps_last_logits(params, cfg, tokens)
    ids = serve.generate(params, cfg, tokens, n)
    torch.save({"last": last.float().cpu(), "ids": ids.cpu(),
                "experts": [c["experts"].cpu() for c in routing]},
               os.path.join(out_dir, "serve.pt"))
    del params, last, ids
    torch.cuda.empty_cache()
    # (c)
    for j, (name, changes, positions) in enumerate(FSDP_LONG):
        cfg, cfg2 = fsdp_long_cfg(name, changes)
        params = fsdp_init(cfg2, dev)
        cache = fsdp_cache(cfg2, 1, fsdp_long_len(), dev, 80 + j)
        logits, ms = fsdp_long_run(cfg, cfg2, params, cache, host,
                                   positions, dev)
        torch.save({"logits": logits.float().cpu(), "ms": ms},
                   os.path.join(out_dir, f"long{j}.pt"))
        del params, cache, logits
        torch.cuda.empty_cache()
    # (d)
    parity = {}
    for i, (name, changes) in enumerate(FSDP_PARITY):
        cfg = fsdp_parity_cfg(name, changes)
        params = fsdp_init(cfg, dev)
        for b in FSDP_PARITY_S:
            parity[(i, b)] = fsdp_parity_run(cfg, params, host, b, i,
                                             dev).cpu()
        del params
        torch.cuda.empty_cache()
    torch.save(parity, os.path.join(out_dir, "parity.pt"))
    return {"seconds": time.perf_counter() - t0,
            "whole_round_ms": whole_round_ms, "whole_round_peak": whole_peak}


def fsdp_collectives_from_shapes(cfg, mesh, passes: int, k: int) -> dict:
    """{op: [count, bytes]} of a rank's "fsdp" collectives in one
    sequential round (`passes` trainings of each of `k` clients, one
    local step each) from the shapes and the FSDP specs: per training,
    the embedding and the head gathered once (autograd keeps them), each
    block leaf with an FSDP dim gathered in the forward and again in its
    group's backward rerun, then each such leaf's, the embedding's and
    the head's cotangent reduce-scattered (this records the gathered
    cotangent); an all-reduce of the cotangent of every leaf with no
    FSDP dim (the norms, and a leaf whose dims do not divide); the loss's
    token count and the loss itself (4 B each)."""
    from repro_torch.core import treemath
    from repro_torch.models import sharding, tp
    from repro_torch.models.sharding import NamedSpec

    shapes = transformer_meta(cfg)
    specs = fsdp_specs(cfg, mesh)
    out = {"all_gather": [0, 0], "reduce_scatter": [0, 0],
           "all_reduce": [2, 8]}
    for path, x, spec in zip(treemath.tree_paths(shapes),
                             treemath.tree_leaves(shapes),
                             treemath.tree_leaves_like(shapes, specs)):
        block = math.prod(NamedSpec(mesh, spec).shard_shape(
            tuple(x.shape))) * x.element_size()
        if path[0] == "blocks":  # one group's slice a training, G groups
            block //= x.shape[0]
            times = x.shape[0]
        else:
            times = 1
        if tp.data_dim(spec) < 0:
            out["all_reduce"][0] += times
            out["all_reduce"][1] += times * block
            continue
        gathers = 2 if path[0] == "blocks" else 1
        out["all_gather"][0] += gathers * times
        out["all_gather"][1] += gathers * times * block
        out["reduce_scatter"][0] += times
        out["reduce_scatter"][1] += times * block * mesh.client_size
    del sharding
    return {op: [c * passes * k, n * passes * k] for op, (c, n) in out.items()}


def transformer_meta(cfg):
    from repro_torch.models import transformer

    return transformer.init_params(None, cfg, device="meta")


def fsdp_group_bytes(cfg, mesh) -> int:
    """The bytes of the largest group's leaves gathered over "data": each
    leaf's block on "model" alone."""
    from repro_torch.core import treemath
    from repro_torch.models import sharding
    from repro_torch.models.sharding import NamedSpec

    shapes = transformer_meta(cfg)
    model_only = sharding.param_pspecs(shapes, mesh)
    total = 0
    for x, spec in zip(treemath.tree_leaves(shapes["blocks"]),
                       treemath.tree_leaves_like(shapes["blocks"],
                                                 model_only["blocks"])):
        total += math.prod(NamedSpec(mesh, spec).shard_shape(
            tuple(x.shape))) * x.element_size() // x.shape[0]
    return total


def fsdp_round_child(mesh, dev) -> dict:
    """(a): the sequential round of the cut lite in this rank's FSDP
    blocks: every round_stats call held to its plain version on the same
    block, the launches, the "fsdp" collectives, ms, the peak, and the
    new params, prev_delta and metrics against the whole-model round."""
    import repro_torch
    from repro_torch.core import fl as fl_mod
    from repro_torch.core import treemath
    from repro_torch.kernels import round_stats as rs
    from repro_torch.models import sharding, transformer

    refs = os.environ[FSDP_REFS]
    cfg = fsdp_round_cfg()
    fl = fsdp_round_fl()
    specs = fsdp_specs(cfg, mesh)
    params = fsdp_init(cfg, dev, mesh)
    block_bytes = sum(x.numel() * x.element_size()
                      for x in treemath.tree_leaves(params))
    state = repro_torch.init_round_state(fl, params)
    del params
    batch, sel, sizes = fsdp_round_inputs(cfg, dev)
    batch = {k: v[:, :, fsdp_rows(mesh, v.shape[2])] for k, v in
             batch.items()}
    rf = repro_torch.make_round_fn(
        lambda p, bt: transformer.loss_fn(p, cfg, bt), fl, mesh=mesh,
        param_specs=specs, rows_over_data=True)
    calls, peaks, real = [], [], fl_mod.round_stats

    def spy(x, g, mask=None):
        # the kernel, then its plain version on the same block; the
        # check's own memory is kept out of the round's peak
        out = real(x, g, mask)
        peaks.append(torch.cuda.max_memory_allocated())
        calls.append([list(x.shape), *chunked_stats_err(rs, out, x, g,
                                                        mask)])
        torch.cuda.reset_peak_memory_stats()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rs.round_stats.launches = 0
    fl_mod.round_stats = spy
    try:
        with mesh.recording() as log:
            t0 = time.perf_counter()
            state, m = rf(state, batch, sel, sizes)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        fl_mod.round_stats = real
    launches = rs.round_stats.launches
    peak = max(peaks + [torch.cuda.max_memory_allocated()])
    got = {}
    for op in ("all_gather", "reduce_scatter", "all_reduce"):
        got[op] = [sum(1 for c in log if c.scope == "fsdp" and c.op == op),
                   sum(c.nbytes for c in log
                       if c.scope == "fsdp" and c.op == op)]
    shapes_ok = all(
        tuple(x.shape) == sharding.NamedSpec(mesh, s).shard_shape(
            tuple(w.shape))
        for tree in (state.params, state.prev_delta)
        for x, w, s in zip(treemath.tree_leaves(tree),
                           treemath.tree_leaves(transformer_meta(cfg)),
                           treemath.tree_leaves_like(tree, specs)))
    worst, where, max_abs = -math.inf, "", 0.0
    for name in ("params", "prev_delta"):
        whole = torch.load(os.path.join(refs, f"round_{name}.pt"),
                           mmap=True)
        tree = getattr(state, name)
        for path, x, spec in zip(treemath.tree_paths(tree),
                                 treemath.tree_leaves(tree),
                                 treemath.tree_leaves_like(tree, specs)):
            key = "/".join(path)
            want = sharding.block(whole[key], mesh, spec).to(dev)
            e, w_ = excess_err({f"{name}/{key}": (x, want)}, PARITY_TOL,
                               PARITY_TOL)
            max_abs = max(max_abs, float((x.double() - want.double())
                                         .abs().max()))
            if e > worst:
                worst, where = e, w_
            del want
        del whole
    ref = torch.load(os.path.join(refs, "round_metrics.pt"))
    m_worst, m_where = excess_err(
        {**{f"metrics/{k}": (m[k].cpu(), ref["metrics"][k])
            for k in ("loss", "theta", "weights", "divergence")},
         "angle": (state.angle.smoothed.cpu(), ref["angle"])},
        PARITY_TOL, PARITY_TOL)
    out = {"ms": ms, "peak_bytes": peak, "block_bytes": block_bytes,
           "group_bytes": fsdp_group_bytes(cfg, mesh),
           "launches": launches, "stats_calls": calls,
           "collectives": got,
           "want_collectives": fsdp_collectives_from_shapes(
               cfg, mesh, 1 if fl.stale_angles else 2, fl.clients_per_round),
           "other_collectives": sorted({f"{c.scope}:{c.op}" for c in log
                                        if c.scope != "fsdp"}),
           "shard_shapes_ok": shapes_ok, "excess": worst,
           "worst_leaf": where, "max_abs": max_abs,
           "metrics_excess": m_worst, "metrics_worst": m_where,
           "count_equal": bool(torch.equal(state.angle.count.cpu(),
                                           ref["count"])),
           "weights": m["weights"].cpu(), "loss": float(m["loss"]),
           "whole_ms": ref["ms"], "whole_peak": ref["peak"],
           "finite": bool(all(torch.isfinite(v).all() for v in m.values()))}
    del state, m, rf
    torch.cuda.empty_cache()
    return out


def chunked_stats_err(rs, got, x, g, mask,
                      chunk: int = 1 << 24) -> tuple[float, float]:
    """`stats_err` of round_stats' output `got` on x (K, N) against its
    plain version summed over column chunks, the scales in float64 chunk
    by chunk: the check at a block whose whole temporaries would not fit
    beside four ranks' rounds."""
    n = x.shape[1]
    plain, scale = None, torch.zeros(x.shape[0], dtype=torch.float64,
                                     device=x.device)
    for i in range(0, n, chunk):
        cols = slice(i, min(n, i + chunk))
        m = None if mask is None else mask[cols]
        part = rs.round_stats_plain(x[:, cols], g[cols], m)
        plain = part if plain is None else tuple(
            a + b for a, b in zip(plain, part))
        xd, gd = x[:, cols].double(), g[cols].double()
        if m is not None:
            xd, gd = xd * m.double()[None], gd * m.double()
        scale += (xd.abs() * gd.abs()[None]).sum(1)
    scales = (scale, plain[1].double().abs(), plain[2].double().abs())
    abs_err = norm_err = 0.0
    for a, b, s in zip(got, plain, scales):
        d = (a.double() - b.double()).abs()
        abs_err = max(abs_err, float(d.max()))
        norm_err = max(norm_err, float((d / s.clamp_min(1e-30)).max()))
    return abs_err, norm_err


def fsdp_serve_child(mesh, dev) -> dict:
    """(b): the cut deepseek-v2-236b in this rank's FSDP blocks, bf16:
    prefill and decode through `generate` on this data index's rows
    (ms; the peak beyond the blocks against one group gathered + the
    same prefill's activations with the params on "model" only + 1 GB),
    the routing of one prefill (its digest, held equal across ranks; its
    assignments per layer against the whole model's) and the last
    logits against the whole model's."""
    from repro_torch.configs import registry
    from repro_torch.core import treemath
    from repro_torch.launch import serve
    from repro_torch.models import moe, tp
    from repro_torch.models.config import with_changes

    cfg = with_changes(registry.get("deepseek-v2-236b"), FSDP_SERVE_CUT)
    b, t, n = FSDP_SERVE
    ref = torch.load(os.path.join(os.environ[FSDP_REFS], "serve.pt"))
    rows = fsdp_rows(mesh, b)
    tokens = tps_tokens(cfg.vocab_size, b, t, 43)[rows].to(dev)
    # the prefill's activations without FSDP: the params on "model" only
    params = fsdp_init(cfg, dev, mesh, fsdp=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tp.scope(mesh, rows_over_data=True):
        tps_last_logits(params, cfg, tokens)
    torch.cuda.synchronize()
    activations = torch.cuda.max_memory_allocated() - base
    del params
    torch.cuda.empty_cache()
    specs = fsdp_specs(cfg, mesh)
    params = fsdp_init(cfg, dev, mesh)
    blocks = sum(x.numel() * x.element_size()
                 for x in treemath.tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tp.scope(mesh, rows_over_data=True, specs=specs):
        with moe.record_routing() as routing:
            t0 = time.perf_counter()
            last = tps_last_logits(params, cfg, tokens).float().cpu()
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
        peak_prefill = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        ids = serve.generate(params, cfg, tokens, n)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    k_ = cfg.moe.top_k
    flips = [int((torch.sort(c["experts"].cpu().reshape(-1, k_))[0]
                  != torch.sort(w.reshape(-1, k_))[0]).sum())
             for c, w in zip(routing, ref["experts"])]
    digest_ = hashlib.sha256()
    for call in routing:
        for key in sorted(call):
            digest_.update(call[key].contiguous().view(torch.uint8).cpu()
                           .numpy().tobytes())
    want_last = ref["last"][rows]
    out = {"block_bytes": blocks, "group_bytes": fsdp_group_bytes(cfg, mesh),
           "peak_bytes": peak, "peak_bytes_prefill": peak_prefill,
           "activation_bytes_without_fsdp": activations,
           "prefill_ms": prefill_ms,
           "decode_ms_per_step": (total_ms - prefill_ms) / (n - 1),
           "generate_ms": total_ms, "routing_calls": len(routing),
           "routing_sha256": digest_.hexdigest(),
           "routing_vs_whole_differing": flips,
           "routing_assignments_per_layer": int(
               routing[0]["experts"].numel()) if routing else 0,
           "logit_gap": float((last - want_last).abs().max()),
           "logit_scale": float(want_last.abs().max()),
           "ids_equal_share": float((ids.cpu() == ref["ids"][rows]).float()
                                    .mean()),
           "finite": bool(torch.isfinite(last).all()),
           "layers": cfg.num_layers}
    del params, ids
    torch.cuda.empty_cache()
    return out


def fsdp_long_child(mesh, dev) -> list:
    """(c): each long_500k decode on this rank's block of the seeded
    cache's positions (the params on "model" only, the reference's
    fsdp=False): ms a step and the logit gap to the whole model."""
    from repro_torch.core import treemath

    out = []
    for j, (name, changes, positions) in enumerate(FSDP_LONG):
        cfg, cfg2 = fsdp_long_cfg(name, changes)
        ref = torch.load(os.path.join(os.environ[FSDP_REFS], f"long{j}.pt"))
        params = fsdp_init(cfg2, dev, mesh, fsdp=False)
        cache = fsdp_cache(cfg2, 1, fsdp_long_len(), dev, 80 + j, mesh)
        cache_bytes = sum(x.numel() * x.element_size()
                          for x in treemath.tree_leaves(cache))
        logits, ms = fsdp_long_run(cfg, cfg2, params, cache, mesh,
                                   positions, dev)
        logits = logits.float().cpu()
        out.append({"arch": cfg2.name, "layers": cfg2.num_layers,
                    "window": cfg2.sliding_window, "positions": positions,
                    "cache_bytes": cache_bytes, "ms_per_step": ms,
                    "whole_ms_per_step": ref["ms"],
                    "logit_gap": float((logits - ref["logits"]).abs().max()),
                    "logit_scale": float(ref["logits"].abs().max()),
                    "argmax_equal_share": float(
                        (logits.argmax(-1) == ref["logits"].argmax(-1))
                        .float().mean()),
                    "finite": bool(torch.isfinite(logits).all())})
        del params, cache
        torch.cuda.empty_cache()
    return out


def fsdp_parity_child(mesh, dev) -> dict:
    """(d): each f32 parity case with fsdp=True against the whole model
    at PARITY_TOL, B = 2 (rows over "data") and B = 1 (the cache's
    sequence over "data"); every flash call held to its plain version at
    its local shape."""
    from repro_torch.kernels import flash_attn as fa

    refs = torch.load(os.path.join(os.environ[FSDP_REFS], "parity.pt"))
    out, real = {}, fa._forward
    for i, (name, changes) in enumerate(FSDP_PARITY):
        cfg = fsdp_parity_cfg(name, changes)
        params = fsdp_init(cfg, dev, mesh)
        for b in FSDP_PARITY_S:
            fa.flash_attention.launches, calls = 0, []
            fa._forward = tps_flash_spy(fa, calls, FLASH_TOL["float32"])
            try:
                got = fsdp_parity_run(cfg, params, mesh, b, i, dev).cpu()
            finally:
                fa._forward = real
            err, excess = allclose_err(got, refs[(i, b)][fsdp_rows(mesh, b)],
                                       PARITY_TOL)
            out[f"{name}/B{b}"] = {
                "max_abs": err, "excess": excess,
                "flash_launches": fa.flash_attention.launches,
                "flash_vs_plain": tps_flash_worst(calls)}
        del params
        torch.cuda.empty_cache()
    return out


def fsdp_serve_cli(dev) -> dict:
    """(e): `python -m repro_torch.launch.serve FSDP_SERVE_ARGV` on this
    world, the launcher's world mesh made (2, 2): ms a token, tokens."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve

    real = mesh_mod.WORLD_MODEL_AXIS
    mesh_mod.WORLD_MODEL_AXIS = FSDP_SHAPE[1]
    try:
        res = serve.main(FSDP_SERVE_ARGV + ["--device", str(dev)])
    finally:
        mesh_mod.WORLD_MODEL_AXIS = real
    out = {"ms_per_token": res["ms_per_token"], "tokens": res["tokens"]}
    del res
    torch.cuda.empty_cache()
    return out


def fsdp_child(mesh, dev, rank: int) -> dict:
    """One rank of the FSDP world: (a)-(e) in turn, each freed before
    the next."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    out = {}
    for key, fn in (("round", fsdp_round_child), ("serve", fsdp_serve_child),
                    ("long", fsdp_long_child),
                    ("parity", fsdp_parity_child)):
        t0 = time.perf_counter()
        out[key] = fn(mesh, dev)
        out[f"{key}_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve_cli"] = fsdp_serve_cli(dev)
    out["serve_cli_seconds"] = time.perf_counter() - t0
    return out


def check_fsdp(results: list) -> dict:
    """(a) the round == whole at PARITY_TOL, K round_stats launches, each
    call within its tolerance of the plain version, the "fsdp"
    collectives those of the shapes, the peak within the round's trees
    in blocks + one group gathered + 1 GB, the ranks' weights bit for
    bit; (b) the peak within the blocks + one group gathered + the prefill's
    activations without FSDP + 1 GB, the routing bit for bit across
    ranks; (c) finite; (d) every case within
    PARITY_TOL and its flash calls within FLASH_TOL; (e) the tokens
    equal across ranks. Returns the line's part."""
    r0 = results[0]
    bad = []
    k = FSDP_ROUND[0]
    for r, res in enumerate(results):
        a, sv = res["round"], res["serve"]
        checks = {
            "round vs whole": a["excess"] <= 0 and a["metrics_excess"] <= 0
            and a["count_equal"] and a["finite"],
            "round weights equal across ranks":
                torch.equal(a["weights"], r0["round"]["weights"]),
            "round_stats launches": a["launches"] == k
            and len(a["stats_calls"]) == k,
            "round_stats vs plain": all(c[2] <= TOL for c in a["stats_calls"]),
            "fsdp collectives": a["collectives"] == a["want_collectives"],
            "round shard shapes": a["shard_shapes_ok"],
            "round peak": a["peak_bytes"] <= fsdp_round_bound(a),
            "serve peak": sv["peak_bytes"] <= fsdp_serve_bound(sv),
            "serve routing equal across ranks":
                sv["routing_sha256"] == r0["serve"]["routing_sha256"]
                and sv["routing_calls"] == sv["layers"],
            "serve finite": sv["finite"],
            "long finite": all(c["finite"] for c in res["long"]),
            "parity": all(c["excess"] <= 1.0
                          for c in res["parity"].values()),
            "parity flash vs plain": all(
                c["flash_vs_plain"][0] == c["flash_launches"]
                and c["flash_vs_plain"][2] <= 1.0
                for c in res["parity"].values())
            and res["parity"]["gemma-2b/B2"]["flash_launches"] > 0,
            "serve cli tokens": torch.equal(
                res["serve_cli"]["tokens"], r0["serve_cli"]["tokens"])
            and math.isfinite(res["serve_cli"]["ms_per_token"]),
        }
        bad += [f"rank {r}: {name}" for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"fsdp: {bad}: " + json.dumps(
            {key: v for key, v in r0.items()}, default=str)[:8000])
    a0 = r0["round"]
    return {
        "ranks": len(results),
        "round": {**{key: v for key, v in a0.items()
                     if key not in ("stats_calls", "weights")},
                  "stats_max_err": max(c[1] for c in a0["stats_calls"]),
                  "stats_shape": a0["stats_calls"][0][0],
                  "ms_per_rank": [r["round"]["ms"] for r in results],
                  "peak_bytes_per_rank": [r["round"]["peak_bytes"]
                                          for r in results],
                  "peak_bound": fsdp_round_bound(a0)},
        "serve": {**r0["serve"],
                  "prefill_ms_per_rank": [r["serve"]["prefill_ms"]
                                          for r in results],
                  "decode_ms_per_step_per_rank": [
                      r["serve"]["decode_ms_per_step"] for r in results],
                  "peak_bytes_per_rank": [r["serve"]["peak_bytes"]
                                          for r in results],
                  "logit_gap_per_rank": [r["serve"]["logit_gap"]
                                         for r in results],
                  "peak_bound": fsdp_serve_bound(r0["serve"])},
        "long": [{**c, "ms_per_step_per_rank": [
            r["long"][j]["ms_per_step"] for r in results],
            "logit_gap_per_rank": [r["long"][j]["logit_gap"]
                                   for r in results]}
            for j, c in enumerate(r0["long"])],
        "parity": r0["parity"],
        "serve_cli": {"argv": " ".join(FSDP_SERVE_ARGV),
                      "mesh": list(FSDP_SHAPE),
                      "ms_per_token_per_rank": [
                          r["serve_cli"]["ms_per_token"] for r in results],
                      "tokens_rank0": r0["serve_cli"]["tokens"][0].tolist()},
        "seconds_rank0": {key: r0[key] for key in r0
                          if key.endswith("_seconds")},
    }


def fsdp_round_bound(a: dict) -> int:
    """The peak a rank's FSDP round may reach: its param-sized trees in
    blocks, one group's backward working set, and INIT_SLACK."""
    return (FSDP_ROUND_TREES * a["block_bytes"]
            + FSDP_GROUP_BACKWARD * a["group_bytes"] + INIT_SLACK)


def fsdp_serve_bound(sv: dict) -> int:
    """The peak a rank's FSDP serving may reach: its blocks, one group
    gathered, the activations the same prefill has without FSDP, and
    INIT_SLACK."""
    return (sv["block_bytes"] + sv["group_bytes"]
            + sv["activation_bytes_without_fsdp"] + INIT_SLACK)


def phase_fsdp(smi: str) -> dict:
    """FSDP over the mesh's "data" axis: the whole-model references in
    this process (each freed before the world starts), then one (2, 2)
    gloo world of four processes on this card runs (a)-(e)
    (`fsdp_child`). Returns rank 0's launches of the slice's kernels."""
    import tempfile

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {"phase": "fsdp", "card": smi, "note": MESH2D_CARD_NOTE,
           "mesh": list(FSDP_SHAPE)}
    with tempfile.TemporaryDirectory() as refs:
        out["whole_model_refs"] = fsdp_refs(dev, refs)
        torch.cuda.empty_cache()
        os.environ[FSDP_REFS] = refs
        t1 = time.perf_counter()
        try:
            results = run_mesh2d("fsdp", "gloo", FSDP_SHAPE, FSDP_TIMEOUT)
        finally:
            os.environ.pop(FSDP_REFS, None)
        out["world_seconds"] = time.perf_counter() - t1
    out.update(check_fsdp(results))
    r0 = results[0]
    out["round_stats_row"] = row = fsdp_stats_row(
        r0["round"]["block_bytes"] // 4,
        max(c[1] for c in r0["round"]["stats_calls"]), dev)
    row["launches"] = r0["round"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return {"round_stats_fsdp": row,
            "flash_attention_f32": sum(
                c["flash_launches"] for c in r0["parity"].values())}


def fsdp_stats_row(n: int, max_abs_err: float, dev) -> dict:
    """round_stats' row at the FSDP round's (1, n_local) block with the
    statistics' mask (the ownership mask times the angle filter's),
    timed against its plain version and its bound; `max_abs_err` is the
    worst of the round's calls against the plain version."""
    from repro_torch.kernels import round_stats as rs

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(1, n, device=dev, generator=gen)
    g = torch.randn(n, device=dev, generator=gen)
    mask = (torch.rand(n, device=dev, generator=gen) > 0.25).float()
    flush = torch.zeros(64 << 20, device=dev)
    row = timing_entry(
        "round_stats_fsdp", "round_stats.cu",
        "src/repro/kernels/round_stats.py:157",
        lambda: rs.round_stats(x, g, mask),
        lambda: rs.round_stats_plain(x, g, mask), None, 4 * 3 * n + 12,
        6 * n, flush, max_abs_err, TOL, (1, n))
    row["wire"] = "f32"
    del x, g, mask, flush
    torch.cuda.empty_cache()
    return row


# ---- the dense-LM serving path and kernels/ops.py ----

def timing_entry(name, source, replaces, kernel, plain, library, nbytes,
                 flops, flush, max_abs_err, tol, shape,
                 flops_per_s=F32_FLOPS_PER_S) -> dict:
    """One kernel's row of the table: its time, its plain version's, a
    library call's (None where no single call computes the function),
    and its bound, all at `shape`. `source`: the file of csrc/ that holds
    the kernel."""
    us = time_us(kernel, flush)
    plain_us = time_us(plain, flush)
    lib_us = time_us(library, flush) if library else None
    b_us, b_by = bound_us(nbytes, flops, flops_per_s)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "max_abs_err": max_abs_err, "tol": tol,
            "us": us, "ms": us / 1e3, "plain_us": plain_us,
            "plain_ms": plain_us / 1e3, "bound_us": b_us,
            "bound_ms": b_us / 1e3, "bound_by": b_by, "library_us": lib_us,
            "library_ms": None if lib_us is None else lib_us / 1e3,
            "shape": list(shape), "bytes": nbytes, "flops": flops}


def sums_err(got, ref, terms) -> tuple[float, float]:
    """(max abs error, max error / sum of |terms|) over paired sums."""
    abs_err = norm_err = 0.0
    for a, b, t in zip(got, ref, terms):
        d = (a.double() - b.double()).abs()
        abs_err = max(abs_err, float(d.max()))
        norm_err = max(norm_err, float((d / t.clamp_min(1e-30)).max()))
    return abs_err, norm_err


def dot_terms(a, b) -> list:
    """The |terms| of (<a,b>, ||a||^2, ||b||^2), in float64."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return [(a * b).abs().sum(), (a * a).sum(), (b * b).sum()]


def phase_ops_kernels(wa, gd, dev) -> dict:
    """batched_dot and grad_dot_stats against their plain versions at
    the edge shapes and the CNN's (K, N), f32 and bf16 input, then timed
    at the CNN's shape in f32 (batched_dot: K = 10 rows against g;
    grad_dot_stats: one client's delta against g)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    worst, main_abs = {}, {}
    for k, n in [(MAIN_K, MAIN_N)] + [(k, n) for k in EDGE_KS
                                      for n in EDGE_NS]:
        x = torch.randn(k, n, device=dev, generator=gen)
        y = torch.randn(k, n, device=dev, generator=gen)
        g = torch.randn(n, device=dev, generator=gen)
        errs = {}
        for tag, dt in (("", torch.float32), ("_bf16", torch.bfloat16)):
            xi, yi, gi = x.to(dt), y.to(dt), g.to(dt)
            terms = [(xi.double().abs() * gi.double().abs()[None]).sum(1)]
            errs["batched_dot" + tag] = sums_err(
                [wa.batched_dot(xi, gi)], [wa.batched_dot_plain(xi, gi)],
                terms)
            errs["grad_dot_stats" + tag] = sums_err(
                gd.grad_dot_stats(xi, yi), gd.grad_dot_stats_plain(xi, yi),
                dot_terms(xi, yi))
        torch.cuda.synchronize()
        emit({"phase": "kernels", "check": [k, n],
              "norm_err": {key: v[1] for key, v in errs.items()}})
        for key, (a, e) in errs.items():
            worst[key] = max(worst.get(key, 0.0), e)
            if (k, n) == (MAIN_K, MAIN_N):
                main_abs[key] = a
            if not e <= TOL:
                raise AssertionError(f"{key} disagrees with its plain "
                                     f"version at K={k}, N={n}: {e}")
        del x, y, g
    emit({"phase": "kernels", "ops_worst_norm_err": worst})

    # grad_dot_stats runs one device kernel on one block and a second
    # (the dependent sum) above
    a = torch.randn(GDOT_SPAN + 1, device=dev, generator=gen)
    for n, want in ((GDOT_SPAN, {GDOT_KERNEL: 1, SUM_KERNEL: 0}),
                    (GDOT_SPAN + 1, {GDOT_KERNEL: 1, SUM_KERNEL: 1})):
        ran = device_kernels(lambda: gd.grad_dot_stats(a[:n], a[:n]))
        got = {key: sum(c for k, c in ran if key in k) for key in want}
        emit({"phase": "kernels", "grad_dot_stats_device_kernels": {
            "n": n, "kernels": ran}})
        if got != want or sum(c for _, c in ran) != sum(want.values()):
            raise AssertionError(f"grad_dot_stats at n = {n} ran {ran}, "
                                 f"want {want}")

    flush = torch.zeros(64 << 20, device=dev)
    x = torch.randn(MAIN_K, MAIN_N, device=dev, generator=gen)
    g = torch.randn(MAIN_N, device=dev, generator=gen)
    k, n = x.shape
    # client 1's row of the round's buffer starts 8 bytes past a 16-byte
    # boundary; g here too
    g8 = shifted(g, 8)
    table = {
        "batched_dot": timing_entry(
            "batched_dot", "batched_dot.cu",
            "src/repro/kernels/weighted_agg.py:347",
            lambda: wa.batched_dot(x, g), lambda: wa.batched_dot_plain(x, g),
            lambda: x @ g, 4 * (k * n + n + k), 2 * k * n, flush,
            main_abs["batched_dot"], TOL, (k, n)),
        # no single torch call returns all three sums
        "grad_dot_stats": timing_entry(
            "grad_dot_stats", "grad_dot.cu",
            "src/repro/kernels/grad_dot.py:61",
            lambda: gd.grad_dot_stats(x[0], g),
            lambda: gd.grad_dot_stats_plain(x[0], g), None, 4 * 2 * n + 12,
            6 * n, flush, main_abs["grad_dot_stats"], TOL, (n,)),
        "grad_dot_stats_off8": timing_entry(
            "grad_dot_stats_off8", "grad_dot.cu",
            "src/repro/kernels/grad_dot.py:61",
            lambda: gd.grad_dot_stats(x[1], g8),
            lambda: gd.grad_dot_stats_plain(x[1], g8), None,
            4 * 2 * n + 12, 6 * n, flush,
            sums_err(gd.grad_dot_stats(x[1], g8),
                     gd.grad_dot_stats_plain(x[1], g8),
                     dot_terms(x[1], g8))[0], TOL, (n,)),
    }
    table["grad_dot_stats_off8"]["offsets_mod_16"] = [
        x[1].data_ptr() % 16, g8.data_ptr() % 16]
    for row in table.values():
        row["max_err"] = worst[row["name"].removesuffix("_off8")]
        emit({"phase": "kernels", "timing": row})
    return table


def gqa_plain(fa, q, k, v):
    """gqa_flash's plain version on (B, T, H, hd) / (B, T, G, hd)."""
    b, t, h, hd = q.shape
    rep = h // k.shape[2]

    def flat(z):
        return z.movedim(2, 1).reshape(-1, t, hd)

    o = fa.flash_attention_plain(flat(q), flat(k.repeat_interleave(rep, 2)),
                                 flat(v.repeat_interleave(rep, 2)), True)
    return o.reshape(b, h, t, hd).movedim(1, 2)


def allclose_err(got, want, tol) -> tuple[float, float]:
    """(max |d|, max |d| / (tol + tol |want|)): <= 1 passes, the
    reference test's assert_allclose(atol=tol, rtol=tol)."""
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d / (tol + tol * want.double().abs()))
                                 .max())


def phase_flash_kernel(fa, dev) -> dict:
    """flash_attention against its plain version at FLASH_CASES, gqa_flash
    at FLASH_GQA and at gemma-2b's prefill shape (bf16 and f32); then both
    kernels timed at gemma's shape: bf16 (bf16 wgmma) and f32 (3xTF32
    mma.sync), each beside SDPA in its dtype (KV repeated to H), with the
    device kernel SDPA ran in one profiled call, and the plain version.
    The f32 row's bound is the 3xTF32 one on the tensor cores; the bound
    on the f32 CUDA cores is given beside it."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(4)
    checks = {}
    for bh, t, d, dtype, causal, bq, bk in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(bh, t, d, device=dev, generator=gen).to(dt)
                   for _ in range(3))
        got = fa.flash_attention(q, k, v, causal, bq, bk)
        want = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        checks[f"{bh}x{t}x{d}/{dtype}/causal={causal}/{bq}x{bk}"] = \
            allclose_err(got, want, FLASH_TOL[dtype])
    b, t, hd = FLASH_GQA_SHAPE
    for h, g, dtype in FLASH_GQA:
        dt = getattr(torch, dtype)
        q = torch.randn(b, t, h, hd, device=dev, generator=gen).to(dt)
        k, v = (torch.randn(b, t, g, hd, device=dev, generator=gen).to(dt)
                for _ in range(2))
        checks[f"gqa {b}x{t}x{h}/{g}x{hd}/{dtype}/causal"] = allclose_err(
            fa.gqa_flash(q, k, v, blk_q=64, blk_k=64),
            gqa_plain(fa, q, k, v), FLASH_TOL[dtype])
    b, t, h, g, hd = FLASH_MAIN
    main = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q = torch.randn(b, t, h, hd, device=dev, generator=gen).to(dt)
        k, v = (torch.randn(b, t, g, hd, device=dev, generator=gen).to(dt)
                for _ in range(2))
        err = allclose_err(fa.gqa_flash(q, k, v), gqa_plain(fa, q, k, v),
                           FLASH_TOL[dtype])
        checks[f"gemma-2b {b}x{t}x{h}/{g}x{hd}/{dtype}/causal"] = err
        main[dtype] = (q, k, v, err[0])
    worst = {dtype: max(e[1] for key, e in checks.items()
                        if f"/{dtype}/" in key) for dtype in FLASH_TOL}
    emit({"phase": "kernels", "flash_checks": checks,
          "flash_worst_excess": worst})
    bad = {key: e for key, e in checks.items() if not e[1] <= 1.0}
    if bad:
        raise AssertionError(f"flash attention disagrees with its plain "
                             f"version: {bad}")

    flush = torch.zeros(64 << 20, device=dev)
    flops = b * h * 2 * t * t * hd  # causal: half of 4 T^2 d per head
    table = {}
    for name, dtype, source, rate in (
            ("flash_attention", "bfloat16", "flash_mma.cuh",
             BF16_TC_FLOPS_PER_S),
            ("flash_attention_f32", "float32", "flash_attn.cu",
             TF32X3_FLOPS_PER_S)):
        q, k, v, err = main[dtype]
        qh = q.movedim(2, 1).contiguous()  # (B, H, T, hd), SDPA's layout
        kh, vh = (z.repeat_interleave(h // g, 2).movedim(2, 1).contiguous()
                  for z in (k, v))
        nbytes = q.element_size() * (2 * b * t * h * hd + 2 * b * t * g * hd)
        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        row = timing_entry(
            name, source, "src/repro/kernels/flash_attn.py:84",
            lambda: fa.gqa_flash(q, k, v), lambda: gqa_plain(fa, q, k, v),
            sdpa, nbytes, flops, flush, err, FLASH_TOL[dtype], FLASH_MAIN,
            flops_per_s=rate)
        row["dtype"], row["device_kernel"] = dtype, fa.KERNELS[q.dtype]
        # which kernel the library call ran: the longest one of a profile
        row["library_device_kernel"] = profile_whole(sdpa)["top"][0]
        row["bound_f32_cores_us"] = bound_us(nbytes, flops)[0]
        row["bound_tf32x3_tensor_cores_us"] = bound_us(
            nbytes, flops, TF32X3_FLOPS_PER_S)[0]
        row["max_err"] = worst[dtype]
        emit({"phase": "kernels", "timing": row})
        table[name] = row
    return table


def sass_counts(lib, kernel: str, opcodes) -> dict:
    """How many SASS instructions of each of `opcodes` (matched as
    substrings: "I2F" also counts I2FP) every instance of `kernel` in the
    built library `lib` holds, by cuobjdump (from nvcc's directory):
    {mangled name: {opcode: count}}."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if kernel in fn:
                counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn in counts:
            for op in opcodes:
                counts[fn][op] += op in line
    return counts


def ptxas_registers(log: str) -> dict:
    """{mangled kernel name: registers} from an nvcc -Xptxas=-v log."""
    regs, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = int(line.split("Used", 1)[1].split()[0])
    return regs


def kernel_registers(source: str, logs: dict) -> dict:
    """{mangled kernel name: registers} of csrc/<source>.cu's build: from
    this process's nvcc log, else (a library built earlier) from
    cuobjdump -res-usage."""
    if source in logs:
        return ptxas_registers(logs[source])
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-res-usage",
                          str(_build.library_path(source))],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    regs, fn = {}, None
    for line in out.splitlines():
        if "Function" in line:
            fn = line.split("Function", 1)[1].strip().rstrip(":")
        elif fn and "REG:" in line:
            regs[fn] = int(line.split("REG:", 1)[1].split()[0])
    return regs


def stats_wave(rs, sass: dict, kernel: str, dtype: torch.dtype) -> dict:
    """Whether the unmasked statistics kernel `kernel`'s grid (x of
    `dtype`) at the main shape fits one wave: the blocks of 64 threads an
    SM holds at its registers (allocated 256 a warp), against the grid's
    blocks."""
    regs = [c["registers"] for fn, c in sass.items()
            if kernel in fn and "ILb0" in fn]
    if len(regs) != 1 or regs[0] is None:
        raise AssertionError(f"no registers of the unmasked {kernel}: "
                             f"{sass}")
    per_warp = -(-regs[0] * 32 // 256) * 256
    per_sm = min(32, 65536 // (2 * per_warp))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = rs.stats_blocks(MAIN_K, MAIN_N, dtype)
    return {"registers": regs[0], "blocks_per_sm": per_sm, "sms": sms,
            "blocks": blocks, "one_wave": per_sm * sms >= blocks}


def load_lm_example():
    """examples/torch_fl_lm_train.py as a module: its presets, its round
    (`make_round`) and its tokens (`round_tokens`)."""
    import importlib.util

    path = os.path.join(ROOT, "examples", "torch_fl_lm_train.py")
    spec = importlib.util.spec_from_file_location("torch_fl_lm_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_pairs(name: str, a, b) -> dict:
    """{name/path: (a's leaf, b's leaf)} over two trees of one layout."""
    from repro_torch.core import treemath

    return {f"{name}/" + "/".join(map(str, path)): (x, y)
            for path, x, y in zip(treemath.tree_paths(a),
                                  treemath.tree_leaves(a),
                                  treemath.tree_leaves(b))}


def flash_train_grads(fa, dev) -> dict:
    """Grads of a scalar through gqa_flash under vmap(grad) over LM_GRAD_N
    clients, on the card, f32 and bf16, causal: the kernel's forward with
    the recompute backward against autograd through the plain version,
    at the forward's tolerance; the forward's device kernel by name."""
    n, (b, t, h, g, hd) = LM_GRAD_N, LM_GRAD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q = torch.randn(n, b, t, h, hd, device=dev, generator=gen).to(dt)
        k, v = (torch.randn(n, b, t, g, hd, device=dev, generator=gen).to(dt)
                for _ in range(2))
        w = torch.randn(b, t, h, hd, device=dev, generator=gen)

        def grads(attend):
            def f(q, k, v):
                return torch.sum(attend(q, k, v).float() * w)

            return torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(
                q, k, v)

        def kernel(q, k, v):
            return fa.gqa_flash(q, k, v, blk_q=64, blk_k=64)

        got = grads(kernel)
        want = grads(lambda q, k, v: gqa_plain(fa, q, k, v))
        torch.cuda.synchronize()
        errs = {f"d{name}": allclose_err(a, e, FLASH_TOL[dtype])
                for name, a, e in zip("qkv", got, want)}
        ran = dict(device_kernels(lambda: grads(kernel)))
        flash = {name: sum(c for key, c in ran.items() if name in key)
                 for name in fa.KERNELS.values()}
        out[dtype] = {"errors": errs, "flash_device_kernels": flash}
        if not all(e[1] <= 1.0 for e in errs.values()):
            raise AssertionError(f"{dtype} grads through the flash kernel "
                                 f"differ from the plain version's: {errs}")
        want_kernels = {name: int(name == fa.KERNELS[dt])
                        for name in fa.KERNELS.values()}
        if flash != want_kernels:
            raise AssertionError(f"{dtype} vmap(grad) ran flash kernels "
                                 f"{flash}, want {want_kernels}")
    return out


def phase_lm_train(wa, rs, fa, dev) -> dict:
    """Federated training of the dense LM, the 100m preset of
    examples/torch_fl_lm_train.py at its defaults (K = 4, tau = 2,
    B = 4, T = 256, f32) through its round (`make_round`) on the flat
    engine: 3 rounds on the xla attention path, then 3 on the flash path,
    from the same params on the same tokens. Per round: 2 weighted_agg
    and 1 round_stats launches, and on the flash path one flash launch
    per layer per local step (the vmap rule folds the K clients into
    one). Flash == xla on round 1 (weights, params) at the serve phase's
    f32 tolerance; flat == tree on round 1 at 1e-5; the metrics finite;
    the loss of round 0's batches falls over the 3 rounds (each round's
    own loss is printed, not held: every round's clients draw new
    vocabulary permutations). Then the flash kernel at the training
    shape beside its bound, its plain version, SDPA and one layer's
    backward recompute."""
    import torch.nn.functional as F

    import repro_torch
    from repro_torch.models import transformer

    grads = flash_train_grads(fa, dev)
    ex = load_lm_example()
    cfgs = {impl: ex.model_config(LM_PRESET, impl)
            for impl in ("xla", "flash")}
    n_params = transformer.count_params(cfgs["xla"])
    params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(0), cfgs["xla"])
    k, tau, b, t = LM_K, LM_TAU, LM_B, LM_T
    fl = repro_torch.FLConfig(num_clients=k, clients_per_round=k,
                              local_steps=tau, method="fedadp",
                              base_lr=0.05, lr_decay=0.999, engine="flat")
    tokens = [ex.round_tokens(r, k, tau, b, t, cfgs["xla"].vocab_size, dev)
              for r in range(LM_ROUNDS)]
    sel = torch.arange(k, dtype=torch.int32, device=dev)
    sizes = torch.ones((k,), device=dev)
    wrappers = {"weighted_agg": wa.weighted_agg,
                "round_stats": rs.round_stats,
                "flash_attention": fa.flash_attention}

    @torch.no_grad()
    def batch_loss(p, cfg):
        # the mean loss of round 0's first local batch of every client
        return float(torch.mean(torch.stack([transformer.loss_fn(
            p, cfg, {"tokens": tokens[0]["tokens"][i, 0]})
            for i in range(k)])))

    runs = {}
    for impl, cfg in cfgs.items():
        round_fn = ex.make_round(cfg, fl)
        state0 = repro_torch.init_round_state(fl, params)
        round_fn(state0, tokens[0], sel, sizes)  # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, ms, per_round, metrics, first = state0, [], [], [], None
        for r in range(LM_ROUNDS):
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            state, m = round_fn(state, tokens[r], sel, sizes)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_round.append({name: fn.launches
                              for name, fn in wrappers.items()})
            metrics.append({key: m[key].detach().cpu().double().numpy()
                            for key in ("loss", "weights", "divergence")})
            if first is None:
                first = (state, m)
        runs[impl] = {"ms": ms, "launches": per_round, "metrics": metrics,
                      "first": first, "round_fn": round_fn,
                      "peak": torch.cuda.max_memory_allocated(),
                      "batch_loss": (batch_loss(params, cfg),
                                     batch_loss(state.params, cfg))}
        del state
    want_flash = cfgs["flash"].num_layers * tau
    for impl, run in runs.items():
        want = {"weighted_agg": 2, "round_stats": 1,
                "flash_attention": want_flash if impl == "flash" else 0}
        if any(c != want for c in run["launches"]):
            raise AssertionError(f"{impl}: rounds launched "
                                 f"{run['launches']}, want {want} each")
        losses = [float(m["loss"]) for m in run["metrics"]]
        if not all(np.isfinite(v).all() for m in run["metrics"]
                   for v in m.values()):
            raise AssertionError(f"{impl}: metrics not finite: "
                                 f"{run['metrics']}")
        # each round's clients draw new vocabulary permutations
        # (lm_token_batches(seed=r)), so the round's own loss need not
        # fall; the loss of round 0's batches at the params must
        before, after = run["batch_loss"]
        if not after < before:
            raise AssertionError(f"{impl}: the loss of round 0's batches "
                                 f"did not fall: {before} -> {after} "
                                 f"(rounds: {losses})")

    # flash == xla on round 1, and flat == tree (xla path) on round 1
    (sf, mf), (sx, mx) = runs["flash"]["first"], runs["xla"]["first"]
    pairs = {"weights": (mf["weights"], mx["weights"]),
             **tree_pairs("params", sf.params, sx.params)}
    parity = {key: allclose_err(a, e, PARITY_TOL)
              for key, (a, e) in pairs.items()}
    if not all(e[1] <= 1.0 for e in parity.values()):
        raise AssertionError(f"round 1: flash and xla differ beyond "
                             f"{PARITY_TOL}: {parity}")
    tree_fn = ex.make_round(cfgs["xla"], dataclasses.replace(fl,
                                                             engine="tree"))
    st, mt = tree_fn(repro_torch.init_round_state(fl, params), tokens[0],
                     sel, sizes)
    torch.cuda.synchronize()
    flat_tree, flat_tree_at = excess_err({
        **tree_pairs("params", sx.params, st.params),
        **tree_pairs("prev_delta", sx.prev_delta, st.prev_delta),
        "angle": (sx.angle.smoothed, st.angle.smoothed),
        **{f"metrics/{key}": (mx[key], mt[key])
           for key in ("loss", "weights", "theta", "divergence")}},
        TOL, TOL)
    del st, mt, sf, mf, sx, mx
    if flat_tree > 0:
        raise AssertionError(f"round 1: flat and tree differ at "
                             f"{flat_tree_at}: {flat_tree}")
    # one profiled flash round: where its device time goes
    state0 = repro_torch.init_round_state(fl, params)
    prof = profile_device(lambda: runs["flash"]["round_fn"](
        state0, tokens[0], sel, sizes))
    for run in runs.values():
        del run["first"], run["round_fn"]
    del state0, params
    torch.cuda.empty_cache()

    # the flash kernel at the training shape: K * B sequences of the
    # vmapped local step, beside its bound, SDPA and the backward
    bt, (h, g, hd) = k * b, LM_HEADS
    gen = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(bt, t, h, hd, device=dev, generator=gen)
    kk, vv = (torch.randn(bt, t, g, hd, device=dev, generator=gen)
              for _ in range(2))
    do = torch.randn(bt, t, h, hd, device=dev, generator=gen)
    err = allclose_err(fa.gqa_flash(q, kk, vv, blk_q=64, blk_k=64),
                       gqa_plain(fa, q, kk, vv),
                       FLASH_TOL["float32"])
    if not err[1] <= 1.0:
        raise AssertionError(f"flash at the training shape: {err}")
    qh = q.movedim(2, 1).contiguous()
    kh, vh = (z.repeat_interleave(h // g, 2).movedim(2, 1).contiguous()
              for z in (kk, vv))
    flops = bt * h * 2 * t * t * hd  # causal: half of 4 T^2 d per head
    nbytes = 4 * (2 * bt * t * h * hd + 2 * bt * t * g * hd)
    flush = torch.zeros(64 << 20, device=dev)
    row = timing_entry(
        "flash_attention_f32_train", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:84",
        lambda: fa.gqa_flash(q, kk, vv, blk_q=64, blk_k=64),
        lambda: gqa_plain(fa, q, kk, vv),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
        nbytes, flops, flush, err[0], FLASH_TOL["float32"],
        (bt, t, h, g, hd), flops_per_s=TF32X3_FLOPS_PER_S)
    row["dtype"], row["device_kernel"] = "float32", fa.KERNELS[torch.float32]
    row["bound_f32_cores_us"] = bound_us(nbytes, flops)[0]
    row["backward_recompute_us"] = time_us(
        lambda: fa._backward(q, kk, vv, do, True), flush)
    row["max_err"] = err[1]
    row["launches"] = sum(c["flash_attention"]
                          for c in runs["flash"]["launches"])
    emit({"phase": "kernels", "timing": row})
    del q, kk, vv, do, qh, kh, vh, flush
    torch.cuda.empty_cache()

    out = {"phase": "lm_train", "preset": LM_PRESET, "params": n_params,
           "clients": k, "local_steps": tau, "batch": b, "seq": t,
           "dtype": "float32", "engine": "flat",
           "delta_buffer_bytes": 4 * k * n_params,
           "grads_on_card": grads, "parity_tol": PARITY_TOL,
           "flash_vs_xla_round1": parity,
           "flat_vs_tree_excess_err": flat_tree,
           "flat_vs_tree_worst": flat_tree_at,
           "round_ms": {impl: run["ms"] for impl, run in runs.items()},
           "round_ms_median": {impl: float(np.median(run["ms"]))
                               for impl, run in runs.items()},
           "launches": {impl: run["launches"] for impl, run in runs.items()},
           "loss": {impl: [float(m["loss"]) for m in run["metrics"]]
                    for impl, run in runs.items()},
           "round0_batch_loss_before_after": {
               impl: run["batch_loss"] for impl, run in runs.items()},
           "weights": {impl: [m["weights"].tolist() for m in run["metrics"]]
                       for impl, run in runs.items()},
           "max_memory_allocated": {impl: run["peak"]
                                    for impl, run in runs.items()},
           "profile_flash_round": prof,
           # the profiler slows the host: busy time against an
           # unprofiled round's wall too
           "flash_idle_share_vs_unprofiled": 1.0 - prof[
               "device_busy_union_us"] / (1e3 * float(np.median(
                   runs["flash"]["ms"])))}
    emit(out)
    # each kernel's launches over the flash run's rounds
    return {"row": row, "launches": {
        name: sum(c[name] for c in runs["flash"]["launches"])
        for name in wrappers}}


def phase_serve(fa, dev) -> dict:
    """The dense-LM serving path at full width and depth: gemma-2b in
    bf16 with flash attention, random weights from a seed, through
    `launch.serve.generate` (B = 4, prompt 1024, 32 greedy steps). Then
    the f32 model's prefill logits, flash against xla."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(registry.get("gemma-2b"),
                              attention_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(gen, cfg)
    n_params = transformer.count_params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_T),
                           generator=gen, device=dev)
    serve.generate(params, cfg, tokens, 2)  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    def run(steps):
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        ids = serve.generate(params, cfg, tokens, steps)
        torch.cuda.synchronize()
        return ids, (time.perf_counter() - t0) * 1e3, \
            fa.flash_attention.launches

    # the main path, counted: every flash launch of one generate call
    torch.cuda.reset_peak_memory_stats()
    ids, total_ms, launches = run(SERVE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers:
        raise AssertionError(f"generate launched flash attention "
                             f"{launches} times, want {cfg.num_layers}: "
                             "one per layer of the prefill, none in decode")
    if ids.shape != (SERVE_B, SERVE_STEPS) or not bool(
            ((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(ids.shape)} ids "
                             "outside the vocabulary")
    pre = [run(1) for _ in range(3)]  # the prefill alone, three times
    if any(p[2] != cfg.num_layers for p in pre) or not all(
            torch.equal(p[0], ids[:, :1]) for p in pre):
        raise AssertionError("a prefill alone launched another count or "
                             "chose another first token")
    prefill_ms = float(np.median([p[1] for p in pre]))
    decode_ms = (total_ms - prefill_ms) / (SERVE_STEPS - 1)
    prof = profile_whole(lambda: serve.generate(params, cfg, tokens, 1), 2)
    # bf16 attention must run on the tensor-core kernel, none on the f32 one
    by_kernel = prof["ported_by_kernel_us"]
    flash_us = by_kernel.get(fa.KERNELS[torch.bfloat16], 0.0)
    if not (flash_us > 0 and prof["kernel_time_sum_us"] > 0) or \
            by_kernel.get(fa.KERNELS[torch.float32], 0.0) > 0:
        raise AssertionError(f"the profiled bf16 prefill shows ported "
                             f"kernels {by_kernel}: want device time for "
                             f"{fa.KERNELS[torch.bfloat16]} and none for "
                             f"{fa.KERNELS[torch.float32]}")
    # two decode steps from a prefilled cache, profiled: where decode's
    # time goes (device events per step, idle share)
    with torch.no_grad():
        _, _, cache = transformer.forward(
            params, cfg, {"tokens": tokens}, mode="prefill",
            max_len=SERVE_T + SERVE_STEPS)
        tok = ids[:, :1]
        prof_decode = profile_device(lambda: [transformer.decode_step(
            params, cfg, tok, cache, SERVE_T + i) for i in range(2)])
    del cache

    # bf16: the flash-vs-xla gap of the prefill logits, printed, not held
    xcfg = dataclasses.replace(cfg, attention_impl="xla")
    with torch.no_grad():
        lf, _, _ = transformer.forward(params, cfg, {"tokens": tokens},
                                       mode="prefill")
        lx, _, _ = transformer.forward(params, xcfg, {"tokens": tokens},
                                       mode="prefill")
        bf16_gap = max(float((lf[i].float() - lx[i].float()).abs().max())
                       for i in range(SERVE_B))
        bf16_same_argmax = float((lf[:, -1].argmax(-1) == lx[:, -1].argmax(
            -1)).float().mean())
        logits_finite = bool(torch.isfinite(lf).all())
    del params, lf, lx
    torch.cuda.empty_cache()
    if not logits_finite:
        raise AssertionError("the bf16 prefill logits are not finite")

    # f32: the flash path's prefill logits against xla's, held
    fcfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = transformer.init_params(gen, fcfg)
    ptok = torch.randint(0, cfg.vocab_size, (PARITY_B, PARITY_T),
                         generator=gen, device=dev)
    fa.flash_attention.launches = 0
    with torch.no_grad():
        lf, _, _ = transformer.forward(params, fcfg, {"tokens": ptok},
                                       mode="prefill")
        f32_launches = fa.flash_attention.launches
        if f32_launches != cfg.num_layers:
            raise AssertionError("the f32 flash prefill did not run the "
                                 "kernel once per layer")
        xfcfg = dataclasses.replace(fcfg, attention_impl="xla")
        lx, _, _ = transformer.forward(params, xfcfg, {"tokens": ptok},
                                       mode="prefill")
        f32_abs, f32_excess = allclose_err(lf, lx, PARITY_TOL)
        del lf, lx
        f32_prefill_ms = {}  # median of 3 prefills each, after the above
        for impl, c in (("flash", fcfg), ("xla", xfcfg)):
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                transformer.forward(params, c, {"tokens": ptok},
                                    mode="prefill")
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            f32_prefill_ms[impl] = float(np.median(runs))
    del params
    torch.cuda.empty_cache()
    if not f32_excess <= 1.0:
        raise AssertionError(f"f32 prefill logits: flash vs xla max |d| "
                             f"{f32_abs}, {f32_excess}x the tolerance")

    out = {"phase": "serve", "model": cfg.name, "params": n_params,
           "dtype": cfg.dtype, "batch": SERVE_B, "prompt": SERVE_T,
           "steps": SERVE_STEPS, "flash_launches": launches,
           "generate_ms": total_ms, "prefill_ms": prefill_ms,
           "prefill_ms_runs": [p[1] for p in pre],
           "decode_ms_per_step": decode_ms,
           "prefill_tokens_per_s": SERVE_B * SERVE_T / prefill_ms * 1e3,
           "decode_tokens_per_s": SERVE_B / decode_ms * 1e3,
           "max_memory_allocated": peak,
           "flash_share_of_prefill_kernel_time":
               flash_us / prof["kernel_time_sum_us"],
           "flash_us_in_prefill": flash_us,
           "sample_ids": ids[0, :12].tolist(),
           "bf16_flash_vs_xla_max_abs": bf16_gap,
           "bf16_flash_vs_xla_same_last_argmax": bf16_same_argmax,
           "f32_parity": {"batch": PARITY_B, "prompt": PARITY_T,
                          "tol": PARITY_TOL, "max_abs": f32_abs,
                          "excess": f32_excess,
                          "flash_launches": f32_launches,
                          "prefill_ms": f32_prefill_ms},
           "profile_prefill": prof, "profile_decode_2_steps": prof_decode}
    emit(out)
    return out


def family_inputs(cfg, b: int, t: int, steps: int, dev) -> tuple:
    """Seeded numpy inputs on `dev`: the prefill batch (tokens after the
    vision prefix, stub embeddings, distinct M-RoPE streams) and each
    decode step's tokens and extras."""
    rng = np.random.default_rng(3)
    p = cfg.vision_prefix
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t - p))}
    if p:
        batch["vision_embeds"] = rng.normal(size=(b, p, cfg.d_model)) * 0.02
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.normal(
            size=(b, cfg.encoder_len, cfg.d_model)) * 0.02
    if cfg.rope_style == "mrope":
        pos = np.arange(t)
        batch["positions"] = np.stack([np.broadcast_to(z, (b, t)) for z in
                                       (pos, pos // 4, pos % 4)])
    feed = rng.integers(0, cfg.vocab_size, (steps, b, 1))
    extras = [{"positions": rng.integers(0, 2 * t, (3, b, 1))}
              if cfg.rope_style == "mrope" else {} for _ in range(steps)]

    def put(x):
        t_ = torch.from_numpy(np.asarray(x))
        return t_.to(dev, torch.float32 if t_.is_floating_point()
                     else torch.int64)

    return ({k: put(v) for k, v in batch.items()}, [put(f) for f in feed],
            [{k: put(v) for k, v in e.items()} for e in extras])


def family_run(transformer, params, cfg, dev) -> dict:
    """Prefill, the decode steps and loss_fn of a reduced model on
    `dev`: every output (logits, the caches after prefill and after the
    last step, aux, the loss) on the CPU, flattened by name."""
    from repro_torch.core import treemath

    b, t, steps = FAMILY_PARITY_B, FAMILY_PARITY_T, FAMILY_PARITY_STEPS
    batch, feed, extras = family_inputs(cfg, b, t, steps, dev)
    out = {}

    def keep(name, tree):
        for path, leaf in zip(treemath.tree_paths(tree),
                              treemath.tree_leaves(tree)):
            # a copy: decode writes the prefill's cache in place
            out["/".join([name, *map(str, path)])] = \
                leaf.detach().to("cpu", copy=True)

    with torch.no_grad():
        logits, aux, cache = transformer.forward(
            params, cfg, batch, mode="prefill", max_len=t + steps)
        keep("prefill", {"logits": logits, "aux": aux, "cache": cache})
        for i in range(steps):
            logits, cache = transformer.decode_step(
                params, cfg, feed[i], cache, t + i, extras[i])
            keep(f"decode{i}", {"logits": logits})
        keep("decoded", cache)
        keep("loss", {"loss": transformer.loss_fn(params, cfg, batch)})
    return out


def family_parity(transformer, registry, dev) -> dict:
    """Each family's reduced config in f32 with flash attention: params
    drawn once on the CPU from a seeded generator and copied to the card;
    prefill, decode steps and loss_fn on both devices; card == CPU at
    PARITY_TOL on every output."""
    from repro_torch.core import treemath
    from repro_torch.models.config import with_changes

    worst = {}
    for name, changes in FAMILY_PARITY:
        cfg = with_changes(registry.smoke(name, attention_impl="flash"),
                           changes)
        params = transformer.init_params(torch.Generator().manual_seed(0),
                                         cfg, device="cpu")
        on_card = treemath.tree_map(lambda z: z.to(dev), params)
        want = family_run(transformer, params, cfg, torch.device("cpu"))
        got = family_run(transformer, on_card, cfg, dev)
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: the card's outputs {sorted(got)}"
                                 f" are not the CPU's {sorted(want)}")
        errs = {k: allclose_err(got[k], want[k], PARITY_TOL) for k in got}
        key = name + "".join(f"-{k}_{v}" for sub in changes.values()
                             for k, v in sub.items())
        top = max(errs, key=lambda k: errs[k][1])
        worst[key] = {"max_abs": max(e[0] for e in errs.values()),
                      "excess": errs[top][1], "where": top,
                      "outputs": len(errs)}
        if not errs[top][1] <= 1.0:
            raise AssertionError(f"{key}: card vs CPU {top} max |d| "
                                 f"{errs[top][0]}, {errs[top][1]}x the "
                                 f"tolerance {PARITY_TOL}")
        del on_card
    return worst


def brief(prof: dict, top: int = 5) -> dict:
    """The wall, busy union, idle share and longest kernels of a
    `profile_device` result."""
    return {k: prof[k] for k in ("wall_us", "device_busy_union_us",
                                 "device_idle_share_union",
                                 "device_events")} | {"top": prof["top"][:top]}


def phase_families(fa, dev) -> tuple[dict, dict]:
    """The other model families (MoE with MLA, the Mamba hybrid, RWKV-6,
    M-RoPE with a vision prefix, the Whisper encoder-decoder): first
    card == CPU at the reduced size, then each served at full width in
    bf16 through launch.serve.generate. Returns the flash launches of
    each model's counted generate call, and each model's worst
    (max |d|, excess) of its flash calls against the plain version."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.core import treemath
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer
    from repro_torch.models.config import with_changes

    t_phase = time.perf_counter()
    parity = family_parity(transformer, registry, dev)
    emit({"phase": "families", "part": "card_vs_cpu_f32",
          "tol": PARITY_TOL, "batch": FAMILY_PARITY_B,
          "prompt": FAMILY_PARITY_T, "decode_steps": FAMILY_PARITY_STEPS,
          "worst": parity,
          "seconds": time.perf_counter() - t_phase})

    launches, flash_errs = {}, {}
    route = moe._route
    for name, changes, cut, prompt in FAMILY_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = with_changes(dataclasses.replace(registry.get(name),
                                               attention_impl="flash"),
                           changes)
        want_flash = FAMILY_FLASH[name]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        params = transformer.init_params(gen, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        peak_init = torch.cuda.max_memory_allocated() - base
        nbytes = sum(z.numel() * z.element_size()
                     for z in treemath.tree_leaves(params))
        if peak_init > nbytes + INIT_SLACK:
            raise AssertionError(f"{name}: init peaked at {peak_init} "
                                 f"bytes for {nbytes} bytes of params")
        tokens = torch.randint(0, cfg.vocab_size, (FAMILY_B, prompt),
                               generator=gen, device=dev)
        extras = serve.stub_extras(cfg, FAMILY_B, dev)
        serve.generate(params, cfg, tokens, 2, extras=extras)  # warm-up
        torch.cuda.synchronize()

        def run(steps):
            fa.flash_attention.launches = 0
            t1 = time.perf_counter()
            ids = serve.generate(params, cfg, tokens, steps, extras=extras)
            torch.cuda.synchronize()
            return ids, (time.perf_counter() - t1) * 1e3, \
                fa.flash_attention.launches

        # the main path, counted: every flash launch of one generate call
        torch.cuda.reset_peak_memory_stats()
        ids, total_ms, n_flash = run(FAMILY_STEPS)
        peak_gen = torch.cuda.max_memory_allocated() - base
        launches[name] = n_flash
        if n_flash != want_flash:
            raise AssertionError(f"{name}: generate launched flash "
                                 f"attention {n_flash} times, want "
                                 f"{want_flash}: one per causal GQA layer "
                                 "of the prefill, none in decode")
        if ids.shape != (FAMILY_B, FAMILY_STEPS) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"{name}: generate returned "
                                 f"{tuple(ids.shape)} ids or ids outside "
                                 "the vocabulary")
        pre = [run(1) for _ in range(3)]  # the prefill alone
        if any(p[2] != want_flash for p in pre) or not all(
                torch.equal(p[0], ids[:, :1]) for p in pre):
            raise AssertionError(f"{name}: a prefill alone launched "
                                 "another count or chose another first "
                                 "token")
        prefill_ms = float(np.median([p[1] for p in pre]))
        # one more prefill: its logits finite and its argmax generate's
        # first token; the MoE layers' assignments dropped by capacity;
        # each flash launch held against the plain version on the inputs
        # and tiles the model gave it
        kept, flash_checks = [], []

        def spy(*a):
            out = route(*a)
            kept.append(out[5])
            return out

        def flash_spy(q, k, v, **kw):
            out = gqa(q, k, v, **kw)
            if not kw.get("causal", True):
                raise AssertionError(f"{name}: a non-causal flash call")
            dtype = str(q.dtype).removeprefix("torch.")
            flash_checks.append({
                "q": list(q.shape), "kv_heads": k.shape[2], "dtype": dtype,
                "blk": [kw.get("blk_q"), kw.get("blk_k")],
                "err": allclose_err(out, gqa_plain(fa, q, k, v),
                                    FLASH_TOL[dtype])})
            return out

        gqa = fa.gqa_flash
        moe._route, fa.gqa_flash = spy, flash_spy
        try:
            with torch.no_grad():
                logits, _, _ = transformer.forward(
                    params, cfg, {"tokens": tokens, **extras},
                    mode="prefill")
                last = logits[:, -1]
                finite = bool(torch.isfinite(logits).all())
                del logits
        finally:
            moe._route, fa.gqa_flash = route, gqa
        flash_worst = max((c["err"] for c in flash_checks),
                          key=lambda e: e[1], default=None)
        if len(flash_checks) != want_flash or (
                flash_checks and not flash_worst[1] <= 1.0):
            raise AssertionError(
                f"{name}: {len(flash_checks)} flash calls in a prefill, "
                f"want {want_flash}; against the plain version at "
                f"{FLASH_TOL}: {flash_checks}")
        flash_errs[name] = flash_worst
        if not finite or not torch.equal(last.argmax(-1)[:, None],
                                         ids[:, :1]):
            raise AssertionError(f"{name}: prefill logits finite {finite}; "
                                 "their argmax is not generate's first "
                                 "token")
        dropped = None
        if kept:
            k = torch.cat(kept)
            dropped = float((~k).sum()) / k.numel()
        # where the time goes: a profiled prefill, and two decode steps
        # from a prefilled cache. A recurrent prefill (a Python loop over
        # tokens or chunks) leaves ~10^5 events in a trace, which the
        # profiler takes minutes to read back: its prefill is not traced
        with torch.no_grad():
            prof_prefill = None
            if not {"mamba", "rwkv"} & set(cfg.block_pattern):
                prof_prefill = brief(profile_device(lambda: serve.generate(
                    params, cfg, tokens, 1, extras=extras)))
            start = prompt + cfg.vision_prefix
            _, _, cache = transformer.forward(
                params, cfg, {"tokens": tokens, **extras}, mode="prefill",
                max_len=start + 2)
            prof_decode = brief(profile_device(lambda: [
                transformer.decode_step(params, cfg, ids[:, i:i + 1], cache,
                                        start + i) for i in range(2)]))
            del cache
        out = {"phase": "families", "model": name, "reduced": cut,
               "dtype": cfg.dtype, "params": transformer.count_params(cfg),
               "active_params": transformer.count_params(cfg, True),
               "param_bytes": nbytes, "init_s": init_s,
               "peak_after_init": peak_init,
               "peak_after_init_minus_params": peak_init - nbytes,
               "peak_after_generate": peak_gen, "batch": FAMILY_B,
               "prompt": prompt, "vision_prefix": cfg.vision_prefix,
               "steps": FAMILY_STEPS, "flash_launches": n_flash,
               "generate_ms": total_ms, "prefill_ms": prefill_ms,
               "prefill_ms_runs": [p[1] for p in pre],
               "decode_ms_per_step":
                   (total_ms - prefill_ms) / (FAMILY_STEPS - 1),
               "moe_dropped_share": dropped,
               "flash_calls_checked": len(flash_checks),
               "flash_call": {k: v for k, v in flash_checks[0].items()
                              if k != "err"} if flash_checks else None,
               "flash_max_abs_err_and_excess": flash_worst,
               "sample_ids": ids[0, :8].tolist(),
               "profile_prefill": prof_prefill,
               "profile_decode_2_steps": prof_decode}
        emit(out)
        del params, tokens, extras, last, ids
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families", "seconds": time.perf_counter() - t_phase,
          "flash_launches": launches, "flash_max_abs_err_and_excess":
          flash_errs})
    return launches, flash_errs


def phase_ops(wa, gd, ops, dev, nodes, test) -> dict:
    """kernels/ops.py on a real f32 CNN round: the tree view of the
    (K, N) buffer that the round's flat engine passed to round_stats,
    and its global delta g. tree_vdot_batched must give that round's
    dots, and tree_dot_and_norms per client its squared norms and
    ||g||^2, to 1e-5 normalised."""
    import repro_torch
    from repro_torch.core import fl as fl_mod
    from repro_torch.core import treemath

    server = repro_torch.FedServer("cnn", slice_config("f32"), nodes, test,
                                   batch_size=50, device=dev)
    seen = []
    real = fl_mod.round_stats

    def capture(x, g, mask=None):
        out = real(x, g, mask)
        seen.append((x, g, mask, out))
        return out

    fl_mod.round_stats = capture
    try:
        server.step(eval_every=0)
    finally:
        fl_mod.round_stats = real
    torch.cuda.synchronize()
    if len(seen) != 1 or seen[0][2] is not None:
        raise AssertionError(f"captured {len(seen)} round_stats calls")
    x, g, _, (dots, sqs, sqg) = seen[0]
    template = {key: p[None] for key, p in server.params.items()}
    xs = treemath.tree_unravel_stacked(template, x)
    gs = treemath.tree_map(lambda z: z[0],
                           treemath.tree_unravel_stacked(template, g[None]))
    k = x.shape[0]

    # the ops path, counted
    wa.batched_dot.launches = gd.grad_dot_stats.launches = 0
    u = ops.tree_vdot_batched(xs, gs)
    per_client = [ops.tree_dot_and_norms(
        treemath.tree_map(lambda z: z[i], xs), gs) for i in range(k)]
    torch.cuda.synchronize()
    launches = {"batched_dot": wa.batched_dot.launches,
                "grad_dot_stats": gd.grad_dot_stats.launches}
    leaves = len(treemath.tree_leaves(gs))
    if launches != {"batched_dot": leaves, "grad_dot_stats": k * leaves}:
        raise AssertionError(f"ops launched {launches} for {leaves} leaves "
                             f"and K = {k}")
    # the device kernels of one client's tree_dot_and_norms call (clients
    # 0 and 1: rows 0 and 8 bytes past a 16-byte boundary): one a leaf of
    # at most one block, two a larger leaf, beside the PyTorch ops that
    # add the leaves' sums
    sizes = [z.numel() for z in treemath.tree_leaves(gs)]
    want = len(sizes) + sum(z > GDOT_SPAN for z in sizes)
    per_call = {}
    for i in (0, 1):
        ran = device_kernels(lambda: ops.tree_dot_and_norms(
            treemath.tree_map(lambda z: z[i], xs), gs))
        per_call[i] = {"grad_dot": sum(c for key, c in ran
                                       if GDOT_KERNEL in key
                                       or SUM_KERNEL in key),
                       "all": sum(c for _, c in ran), "kernels": ran}
        if per_call[i]["grad_dot"] != want:
            raise AssertionError(f"client {i}'s tree_dot_and_norms ran "
                                 f"{ran}: want {want} grad_dot_stats "
                                 f"kernels for leaves of {sizes}")
    xd, gd64 = x.double(), g.double()
    dot_scale = (xd.abs() * gd64.abs()[None]).sum(1)
    errs = {
        "vdot_vs_round_dots": sums_err([u], [dots], [dot_scale])[1],
        "tree_dots_vs_round_dots": sums_err(
            [torch.stack([c[0] for c in per_client])], [dots],
            [dot_scale])[1],
        "tree_sqs_vs_round_sqs": sums_err(
            [torch.stack([c[1] for c in per_client])], [sqs],
            [sqs.double().abs()])[1],
        "tree_sqg_vs_round_sqg": max(
            sums_err([c[2]], [sqg], [sqg.double().abs()])[1]
            for c in per_client)}
    out = {"phase": "ops", "model": "cnn", "clients": k,
           "params": x.shape[1], "leaves": leaves, "leaf_sizes": sizes,
           "launches": launches, "norm_err": errs,
           "device_kernels_of_one_client_call": per_call}
    emit(out)
    bad = {key: e for key, e in errs.items() if not e <= TOL}
    if bad:
        raise AssertionError(f"ops disagree with the round's round_stats: "
                             f"{bad}")
    return launches


def launch_inputs(kind, cfg, args, meta, dev):
    """Real tensors on the card for a step built on the meta device:
    params drawn from a seed, the train step's RoundState from the
    runtime's own init, random tokens, a zero decode cache."""
    import repro_torch
    from repro_torch.core import treemath
    from repro_torch.models import transformer

    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(gen, cfg)

    def like(x, fill):
        t = torch.empty(x.shape, dtype=x.dtype, device=dev)
        return fill(t)

    def tokens(x):
        return like(x, lambda t: t.random_(0, cfg.vocab_size, generator=gen))

    if kind == "train":
        fl = repro_torch.FLConfig(**meta["flcfg"])
        state = repro_torch.init_round_state(fl, params)
        batch = {k: tokens(v) if k == "tokens" else like(v, torch.zeros_like)
                 for k, v in args[1].items()}
        k = meta["K"]
        return (state, batch, torch.arange(k, dtype=torch.int32, device=dev),
                torch.ones((k,), device=dev))
    if kind == "prefill":
        return params, {k: tokens(v) if k == "tokens"
                        else like(v, torch.zeros_like)
                        for k, v in args[1].items()}
    cache = treemath.tree_map(lambda x: like(x, torch.zeros_like), args[2])
    pos = torch.tensor(args[1].shape[1] - 1, dtype=torch.int32, device=dev)
    return params, tokens(args[1]), cache, pos


def phase_launch(dev) -> dict:
    """The launch layer: the dry run of gemma-2b x train_4k on the 32x8
    mesh under this card's torch; the launcher's path in this process
    (gemma-2b at full width and depth, bf16, host mesh, K = 1, T = 1024,
    B = 4): 3 rounds, then 2 rounds with a checkpoint and --resume to 3,
    the two params_sha256 equal; then for the train step, a prefill
    (B = 4, T = 1024) and a decode step (B = 4, S = 4096), each built on
    a (1, 1) mesh, the dry run's prediction against the card: the
    argument bytes against memory_allocated() once the inputs are placed
    (within 1% plus 512 B a tensor), and the live bytes (arguments +
    outputs + temp - alias) against max_memory_allocated() over one run
    of the step (the ratio within PEAK_RATIO)."""
    import tempfile

    from repro_torch.configs import registry, shapes
    from repro_torch.launch import dryrun, steps, train
    from repro_torch.launch.mesh import AbstractMesh, HBM_BYTES

    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(dev).total_memory
    if total != HBM_BYTES:
        raise AssertionError(f"launch.mesh.HBM_BYTES {HBM_BYTES} is not "
                             f"this card's memory {total}")
    dry = dryrun.run_one("gemma-2b", "train_4k", verbose=False)
    emit({"phase": "launch", "dryrun": dry})

    with tempfile.TemporaryDirectory() as ckpt:
        whole = train.main(LAUNCH_ARGV + ["--rounds", "3"])
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        half = train.main(LAUNCH_ARGV + ["--rounds", "2", "--ckpt", ckpt])
        half_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = train.main(LAUNCH_ARGV + ["--rounds", "3", "--ckpt", ckpt,
                                            "--resume"])
        resume_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
    if resumed["params_sha256"] != whole["params_sha256"]:
        raise AssertionError(f"resumed params {resumed['params_sha256']} != "
                             f"uninterrupted {whole['params_sha256']}")
    if half["losses"] != whole["losses"][:2] or not np.isfinite(
            whole["losses"]).all():
        raise AssertionError(f"launcher losses: {whole['losses']} then "
                             f"{half['losses']}")

    cfg = registry.get("gemma-2b")
    host = AbstractMesh((1, 1), ("data", "model"))
    checks = {}
    for kind, (t, b) in LAUNCH_STEPS.items():
        builder = getattr(steps, f"build_{kind}_step")
        fn, args, ins, outs, meta = builder(
            cfg, host, shapes.InputShape(kind, t, b, kind))
        pred = dryrun.step_record(fn, args, ins, outs, host)
        n_args = len(steps.spec_leaves(ins, args))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        real = launch_inputs(kind, cfg, args, meta, dev)
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn(*real)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        want_args = pred["memory"]["argument_bytes"]
        checks[kind] = {
            "argument_bytes": want_args, "card_argument_bytes": placed,
            "tensors": n_args, "memory": pred["memory"],
            "live_bytes": pred["live_bytes"], "card_peak_bytes": peak,
            "peak_ratio": peak / pred["live_bytes"], "ms": ms,
            "global_flops": pred["global"]["flops"]}
        del out, real
        torch.cuda.empty_cache()
        if abs(placed - want_args) > ARG_RTOL * want_args + ARG_SLACK * n_args:
            raise AssertionError(f"{kind}: the card holds {placed} B of "
                                 f"arguments, the dry run says {want_args}")
        lo, hi = PEAK_RATIO
        if not lo <= checks[kind]["peak_ratio"] <= hi:
            raise AssertionError(f"{kind}: the card's peak {peak} B over "
                                 f"the dry run's {pred['live_bytes']} B is "
                                 f"outside {PEAK_RATIO}: {checks[kind]}")
    out = {"phase": "launch", "dryrun_build_s": dry["build_s"],
           "dryrun_fits": dry["fits"], "total_memory": total,
           "launcher": {"losses": whole["losses"],
                        "ms_a_round": [1e3 * x for x in whole["seconds"]],
                        "params_sha256": whole["params_sha256"],
                        "resumed_sha256": resumed["params_sha256"],
                        "checkpointed_run_s": half_s,
                        "resume_run_s": resume_s},
           "prediction_vs_card": checks,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import transport as tq
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attn as fa
        from repro_torch.kernels import grad_dot as gd
        from repro_torch.kernels import ops
        from repro_torch.kernels import round_stats as rs
        from repro_torch.kernels import weighted_agg as wa
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False,
          "total_memory": torch.cuda.get_device_properties(0).total_memory})

    t0 = time.perf_counter()
    logs = _build.build(SOURCES)  # one nvcc per source, all at once
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    # both flash kernels must run on the tensor cores: mma in their SASS
    mma = {dt: {fn: c["HMMA"] + c["HGMMA"] for fn, c in sass_counts(
        _build.library_path("flash_attn"), fa.KERNELS[dt],
        ("HMMA", "HGMMA")).items()}
        for dt in (torch.bfloat16, torch.float32)}
    # the wire kernels, the f32 / bf16 statistics and grad_dot: 16-byte
    # loads (and in the wire kernels no integer-to-float conversion)
    wire_sass = {}
    for source, (kernels, _) in SASS_INSTANCES.items():
        regs = kernel_registers(source, logs)
        wire_sass[source] = {}
        for kernel in kernels:
            for fn, c in sass_counts(_build.library_path(source), kernel,
                                     ("I2F", "LDG.E.128")).items():
                wire_sass[source][fn] = {"registers": regs.get(fn), **c}
    # the statistics' grids at the main shape, unmasked: bf16's must be
    # one wave; f32's, twice the blocks, cannot be at two rows in flight
    # a lane (round_stats.cu) and is printed
    waves = {k: stats_wave(rs, wire_sass["round_stats"], k, dt)
             for k, dt in ((F32_STATS_KERNEL, torch.float32),
                           (BF16_STATS_KERNEL, torch.bfloat16))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas,
          "flash_sass_mma_count": {fa.KERNELS[dt]: c
                                   for dt, c in mma.items()},
          "wire_sass": wire_sass, "stats_waves": waves})
    for dt, counts in mma.items():
        if len(counts) != len(fa.HEAD_DIMS) or not all(counts.values()):
            raise AssertionError(f"{fa.KERNELS[dt]}: want HMMA or HGMMA in "
                                 f"each of {len(fa.HEAD_DIMS)} head-dim "
                                 f"instances, got {counts}")
    for source, (_, want) in SASS_INSTANCES.items():
        counts = wire_sass[source]
        if len(counts) != want or any(
                (source in NO_I2F and c["I2F"]) or not c["LDG.E.128"]
                for c in counts.values()):
            raise AssertionError(f"{source}: want {want} kernel instances "
                                 f"with 16-byte loads in their SASS (and "
                                 f"no I2F in {NO_I2F}): {counts}")
    if not waves[BF16_STATS_KERNEL]["one_wave"]:
        raise AssertionError(f"the bf16 statistics' main grid needs more "
                             f"than one wave: {waves}")

    table = phase_kernels(wa, rs, tq, dev)
    k1_row = phase_k1_stats(rs, dev)
    lm_table = {**phase_ops_kernels(wa, gd, dev),
                **phase_flash_kernel(fa, dev)}
    phase_wire(tq, dev)
    nodes, test = image_task()
    launches = {t: phase_slice(wa, rs, tq, dev, nodes, test, t)
                for t in WIRES}
    phase_error_feedback(nodes, test, dev)
    phase_downlink(wa, rs, tq, dev, nodes, test)
    _, k1_row["launches"] = phase_sequential(wa, rs, dev, nodes, test)
    phase_buffered(wa, rs, dev, nodes, test)
    phase_resume(wa, rs, dev, nodes, test)
    phase_telemetry(wa, rs, tq, dev, nodes, test)
    phase_algorithm(dev, nodes, test)
    sharded_launches = phase_sharded(wa, rs, dev, nodes, test)
    mesh2d = phase_mesh2d(wa, rs, tq, dev, smi)
    tp_launches = phase_tp(smi)
    tp_serve_launches = phase_tp_serve(smi)
    lm_out = phase_lm_train(wa, rs, fa, dev)
    serve_out = phase_serve(fa, dev)
    family_launches, family_flash_errs = phase_families(fa, dev)
    ops_launches = phase_ops(wa, gd, ops, dev, nodes, test)
    phase_launch(dev)
    # last: its whole-model references launch many kernels in this
    # process, after which the profiles of the phases above have lost
    # every kernel between their ends (device_kernels)
    fsdp_out = phase_fsdp(smi)

    for name, row in table.items():
        # each row's launches: its wrapper's count on its own wire's path
        wrapper = name[:-len("_bf16")] if name.endswith("_bf16") else name
        row["launches"] = launches[row["wire"]][wrapper]
        if row["wire"] in sharded_launches:  # the same kernels at K_loc
            row["launches_sharded"] = sharded_launches[row["wire"]][wrapper]
        # and at a (K_loc, N_loc) tile of the (2, 2) mesh, per rank
        row["launches_mesh2d"] = \
            mesh2d[row["wire"]]["launches_per_rank"][wrapper]
    # the LM kernels' launches: serving's generate call, and the ops path
    # (bf16 in the generate call, f32 in the f32 model's prefill)
    lm_table["flash_attention"]["launches"] = serve_out["flash_launches"]
    # and each of the other families' generate call (qwen2-vl, jamba and
    # whisper's decoder prefill on the bf16 kernel; MLA and RWKV never)
    lm_table["flash_attention"]["launches_families"] = family_launches
    # and its worst error against the plain version at those prefills
    lm_table["flash_attention"]["max_abs_err_families"] = {
        name: e[0] for name, e in family_flash_errs.items() if e}
    lm_table["flash_attention_f32"]["launches"] = \
        serve_out["f32_parity"]["flash_launches"]
    for name in ("batched_dot", "grad_dot_stats"):
        lm_table[name]["launches"] = ops_launches[name]
    lm_table["grad_dot_stats_off8"]["launches"] = \
        ops_launches["grad_dot_stats"]
    table["round_stats_k1"] = k1_row  # launches: 3 sequential rounds
    # the federated LM's rounds run the f32 aggregation and statistics and
    # the f32 flash kernel under vmap(grad)
    table["weighted_agg"]["launches_lm_train"] = \
        lm_out["launches"]["weighted_agg"]
    table["round_stats"]["launches_lm_train"] = \
        lm_out["launches"]["round_stats"]
    lm_table["flash_attention_f32"]["launches_lm_train"] = \
        lm_out["launches"]["flash_attention"]
    lm_table["flash_attention_f32_train"] = lm_out["row"]
    # and the tensor-parallel 100m round, per rank of the (1, 2) world:
    # the aggregation and statistics at the (K, N / 2) tile, flash over
    # the rank's 6 of 12 heads
    table["weighted_agg"]["launches_tp"] = tp_launches["weighted_agg"]
    table["round_stats"]["launches_tp"] = tp_launches["round_stats"]
    for name in ("flash_attention_f32", "flash_attention_f32_train"):
        lm_table[name]["launches_tp"] = tp_launches["flash_attention"]
    # and tensor-parallel serving per rank of the (1, 2) world: gemma-2b's
    # bf16 prefill on the rank's 4 of 8 heads, the f32 minitron parity
    # case's prefill, and the cut deepseek round's aggregation/statistics
    lm_table["flash_attention"]["launches_tp_serve"] = \
        tp_serve_launches["flash_attention"]
    lm_table["flash_attention_f32"]["launches_tp_serve"] = \
        tp_serve_launches["flash_attention_f32"]
    table["weighted_agg"]["launches_tp_serve"] = \
        tp_serve_launches["weighted_agg"]
    table["round_stats"]["launches_tp_serve"] = \
        tp_serve_launches["round_stats"]
    # the FSDP round's statistics at the rank's (1, n_local) block, and
    # the f32 flash kernel in the FSDP parity cases' prefills, per rank
    table["round_stats_fsdp"] = fsdp_out["round_stats_fsdp"]
    lm_table["flash_attention_f32"]["launches_fsdp"] = \
        fsdp_out["flash_attention_f32"]
    table.update(lm_table)
    for name, row in table.items():
        if row["launches"] == 0:
            raise AssertionError(f"{name} never launched on its path")
    print(json.dumps({"kernels": list(table.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-child"]:  # one rank of phase_sharded
        backend, rank, world, port, out_path = sys.argv[2:7]
        sys.exit(sharded_child(backend, int(rank), int(world), int(port),
                               out_path))
    if sys.argv[1:2] == ["--mesh2d-child"]:  # one rank of phase_mesh2d
        task, backend, rank, world, model, port, out_path = sys.argv[2:9]
        sys.exit(mesh2d_child(task, backend, int(rank), int(world),
                              int(model), int(port), out_path))
    sys.exit(main())
