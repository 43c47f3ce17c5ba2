"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, one JSON line each:

  env      torch/CUDA versions, the card (nvidia-smi name and power
           limit), and the seconds to build the CUDA kernels from
           src/repro_torch/csrc (into build/repro_torch/).
  kernels  each CUDA kernel against its plain PyTorch version at the
           glm4-9b main-path shapes (batch 8, prompt 512, cache 1024,
           lanes with left pad; verify at T = 1, 4 and 511, and 128 against a
           512-row cache: the chunk case), held per
           element at rtol = atol = 2e-2 (bf16) on the rows that see a
           key, extract_pack exactly (called as decode_superstep calls
           it, into a slot of (K, B, T, F) signal buffers; path
           ballot_uint4): max abs error, finiteness, plain ms, the ms
           of one PyTorch library call computing the same function, and
           each kernel's call three ways (repro_torch.obs.timing): ms,
           the median of CUDA events around one call (they bracket the
           wrapper's host work); device_ms, its kernel's device time per
           launch (torch.profiler); host_ms, the host's time per call,
           calls enqueued without a sync.  The phase runs in a process
           of its own (chip_smoke.py --kernels) and reads every
           device_ms last: after a torch.profiler session each kernel
           launch of the process costs the host more
           (repro_torch/obs/timing.py), which no event or host time of
           the phase, and no serve, may pay.  The paged kernels (page 16,
           shuffled tables, lanes 0-3 sharing their first 8 pages) are
           also held bit for bit (torch.equal) against the dense kernel
           on the gathered view; their library yardstick is two calls,
           the pool[tbl] gather and scaled_dot_product_attention.  The
           verify kernels' tree mode (W = 4, gamma = 3, T = 13), dense
           and paged, against its plain version; W = 1 bit for bit
           against the chain kernel, paged bit for bit against dense on
           the gathered view, also in a window > 0 sweep at a small
           width; yardstick SDPA with the explicit tree mask.  Each
           attention row is also held to pad-shift invariance: one
           lane's prompt at pads 0, 5, 17, 31, 32, 100 of rows 0 and 40
           wider gives the same rows bit for bit (pad_shift_equal).  The
           prefill rows name their path (prefill_path:
           tensor_core_bf16) and the error of a one-bf16-P emulation
           (p_bf16_rel_l2_emulated), the verify rows theirs
           (verify_path: tensor_core_bf16, asserted).  The verify row
           also holds the chunk case (chunk_case): T = 128 query rows a
           lane against a 512-row cache, pads up to 400, a chunked
           refill's continuation on glm4-9b, against its plain version,
           counted at T = 128 (launches_at_t), its pad_shift_equal on
           kind verify128, timed like the others; every row with a
           library call gets ms_over_library_ms.  linear_rows, the
           prefill's row-invariant matrix product (path wgmma_tma: the
           wgmma kernel fed by TMA; its tile, read from the built
           kernel and held to the one k_splits counts, and its K-split
           per product named), at glm4-9b's (K, N) of k_proj, q_proj/o_proj,
           ffn_up, ffn_down and lm_head: each row of x gives the same
           row, torch.equal, at M = 1, 2, 63, 64, 65, 126, 127, 128,
           129, 992 and 3968 and shifted by one row, a one-hot x gives
           w's rows exactly; its time against torch.matmul (which is
           also its plain version) at M 3968 and 128.
           flash_attention_bwd, the backward of the prefill attention
           (no Pallas twin: the draft's and the target's training
           steps), at the glm4-9b training shape, q (8, S, 32, 128) and
           k/v (8, S, 2, 128) bf16, S 62 (the train phase's 63-token
           window less its last token), 512, 64 and 47 (the launch
           phase's target steps): each gradient against its
           plain version (float64) as above, equal across two calls
           (equal_twice), the forward that stores the LSE equal bit for
           bit to the serving forward (lse_forward_equal), and its time
           against the autograd backward of
           scaled_dot_product_attention(is_causal=True, enable_gqa=True).
           The sampling kernels (csrc/threefry_sample.cu; no Pallas twin:
           JAX samples in jnp code): threefry2x32 bit for bit against its
           plain version at R 8 and N 1, 3, 4 and 151 552;
           categorical_rows at (8, 151 552) and (32, 151 552) on random
           and on peaked logits, token for token except where the plain
           version's top two of logits + gumbel lie within
           4 eps32 max|logits + gumbel| (counted as near_tie_rows);
           library none.  Then Leviathan's check at the full vocabulary
           (4000 lanes, mass on 8 tokens, the rest at -30; the chain's
           verify_sample and a W 2 tree's verify_tree_sample on the
           draft as the engine draws it): the committed first token's
           histogram within 0.035 (tests/test_speculative.py:88) of its
           exact law, the target's softmax for the chain; the tree's law
           departs from the softmax (the reference's rule; reported).
  launch   the port's entry points (src/repro_torch/launch) at glm4-9b's
           full width and depth, in a process of its own
           (chip_smoke.py --launch) run before any engine is built, one
           line per step.  train: the launch/train twin's loop
           (launch.train.train: batch 8, seq 64, Adafactor at LAUNCH_LR,
           LAUNCH_TRAIN_STEPS steps on random weights from seed 0): step
           ms (the first apart) and the optimizer update's share of it
           (the host clock around the update, synchronized before and
           after), losses, peak memory, launches per step
           of the prefill kernel and of flash_attention_bwd (asserted 40
           and 40: one each a layer), the loss finite and the mean of the
           last 3 below the first.  pretrain: pretrain_target on the
           serve CLI's corpus (launch.serve.serve_corpus: 128 rows of 48
           tokens) with Adafactor at PRETRAIN_LR, PRETRAIN_STEPS steps,
           asserted as train.  profile: launch.serve.measure_profile, the
           paper's startup profiling pass (T(n) of one target decode step
           for n = 1..16 lanes, D0 of one draft step), its c(b), beta(b,
           gamma) and Eq. 5 threshold table, every value finite and > 0.
           serve_a: launch.serve.serve with the CLI's configuration
           (waves of 4, gamma 3, K 8, 32 new tokens, a train cycle per 4
           windows of 16, sync mode) and --no-adaptive on the pretrained
           target: cycles and their events, deploys, the accepted-length
           trend of the first and last quarter of the rounds, tokens/s,
           launches (verify at T = 1 and T = 4), peak memory; every
           request finishes with its budget, no trainer failure, at
           least one cycle.  serve_b: the same requests with the Eq. 5
           gate on the measured profile, --spec-park 2, from serve A's
           last draft, traced (--trace-out chiprun_out/): spec rounds
           against all, parks, probes and resumes, launches; its streams
           must equal serve A's, or depart only where the target's top-2
           logit gap is within BF16_TOL of its top logit.
  families the attention-mixer families beside glm4-9b, in a process of
           its own (chip_smoke.py --families) run right after launch,
           one at a time, each freed before the next: phi3-medium-14b
           (SwiGLU, 40/10 heads), starcoder2-7b (the GELU FFN, 36/4),
           granite-moe-3b-a800m (MoE, 40 experts top 8, 24/8 heads at
           head_dim 64, vocabulary 49 155) and gpt-oss-120b (MoE, 128
           experts top 4, 64/8 heads at head_dim 64) cut to 8 of its 36
           layers (reduced: {"num_layers": [36, 8]}), each at its
           published widths from a seed with its EAGLE-3 draft.  Each
           serves 4 requests (prompts 24-64, 16 new tokens, greedy chain
           gamma 3, K 8, speculation always on) on a dense engine and
           then a paged one (page 16): every request reaches its budget,
           the paged streams equal the dense ones, the prefill, verify,
           extract_pack and linear_rows kernels launch (their paged
           twins on the paged engine), no page leaks.  Then each
           attention kernel at the family's target and draft heads
           (prefill at batch 4, width 64, left pads; verify at T 1, 4
           and tree 13 against a 128-row cache; dense and paged, paged
           equal to dense on the view) and linear_rows at its (K, N)
           (granite's N 49 155 and the router's fp32 included; rows
           equal across M) against their plain versions; a MoE family's
           layer-0 FFN twice on 256 tokens, equal bit for bit, and
           against the one-hot oracle; its first run, and one on a
           chain verify's 16 rows, under torch.cuda's sync debug mode
           "error" (no host sync).  starcoder2-7b's cobatch verdict
           must read none; granite-moe's (its capacity comes from the
           refill's token count) is recorded.  One line a family:
           parameters, peak memory, tokens/s, superstep ms, prefill ms,
           the bytes a target forward reads and their time at 3.35 TB/s,
           reduced; then the phase's seconds.
  ladder   glm4-9b width at 2 layers, random weights: the same 8
           requests through superstep_rounds=8 and =0 give equal greedy
           streams, dense and paged (page 16), tree speculation at
           W = 2 gives equal streams stepwise, in supersteps (K 8), as a
           stream (K 8 and 3) and in waves, and the card's prefill
           logits agree with the CPU's.  Sampled (seed 5, batch 4): the
           chain's streams at K 8, K 0, in waves of 4 and paged are
           equal, and tree W = 2's at K 8 and K 0; every sampling kernel
           launches.  Chunked refill prefill (chunk 32), greedy and
           sampled: K 8, K 0, waves of 4 and paged equal.  Overload
           (batch 4, deadline admission on the round clock: four loose
           residents, a tight pair at round 4, a loose tail), greedy and
           sampled, dense and paged: preempt-on streams equal preempt-off
           streams, at least one preemption, every spill restored or
           dropped, no page leaked.
  serve    glm4-9b at full width and depth, random bf16 weights from a
           seeded generator: ServingEngine (batch 8, max_len 1024,
           gamma 3, K=8, greedy, no drafter) serves 16 requests (prompts
           64-512, 64 new tokens; requests 1, 3, 5 and 7 share one
           prompt) with serve_stream.  Every kernel's launch count is
           zeroed just before and read just after.  linear_rows
           launches once per prefill product and once per product of
           the draft seed the rows depend on (fuse, fc, q, k, v, o).
  cobatch  the serve's shortest prompt refilled alone and beside its
           longest (the engine's own refill packing: another pad, width
           and row count) through glm4-9b at full depth, op by op: the
           first op whose rows of the prompt depart (verdict) and every
           op that departs with equal input rows.  The verdict must be
           none and no op may depart alone.  Beside it, the same steps
           with torch.matmul for the products under
           allow_bf16_reduced_precision_reduction = False: what cuBLAS
           alone would give with that setting (reported, not asserted).
  paged_serve  the same engine configuration with page_size 16 on the
           same weights and requests, twice: with the dense footprint of
           512 pages (no admission can defer, so the schedule is the
           dense serve's: streams, supersteps and host syncs must equal
           it exactly, prefix hits > 0), then with 256 pages (the
           admission guard defers; every request must finish, the peak
           must stay within the pool, every paged kernel must launch,
           and all 16 streams must equal dense).
           The allocator is clean at drain in both.
  tree_serve  the serve's configuration, weights and requests with
           tree speculation, W = 1 (streams, supersteps and host syncs
           must equal the chain serve's) and W = 4 (tokens/s, superstep
           ms, host syncs per superstep no more than the chain's, the
           streams that differ from the chain's and the top-2 logit gap
           at the first flip); each target verify must be one tree-mode
           launch per layer.
  paged_tree_serve  tree speculation over paged KV (page 16) on the same
           weights and requests, three times: W = 1 and W = 4 with the
           dense footprint of 512 pages (W = 1's streams, supersteps
           and host syncs must equal the chain serve's, W = 4's streams
           the dense W = 4 tree serve's), then W = 4 with 256 pages
           (the tree's larger reservation makes the guard defer; its
           streams must equal the dense W = 4 tree's).  Every
           target verify is one launch per layer of the paged kernel in
           tree mode (layers x speculative rounds, asserted), the draft
           attends through the paged kernel in chain mode, the dense
           verify kernel runs only for the refills' draft seeding, and
           no page leaks after a drain.
  sampled_serve  the serve's configuration, weights and requests with
           sampled decoding (greedy=False, seed 5): a dense chain serve,
           the paged engine at 512 pages (streams equal to the dense
           sampled serve's, bit for bit) and a tree W = 4 serve; every
           request reaches its budget and both sampling kernels launch
           (their main-path launches are the dense sampled serve's).
           Each prints tokens/s, superstep ms, host syncs per superstep,
           mean accepted length and launches beside the greedy serve's
           (chain or tree W = 4) from this run.
  chunked_serve  chunked refill prefill (prefill_chunk 128: prompts of
           64-512 make 1-4 chunks) on the serve's configuration, weights
           and requests, four times: dense with cohort commit (the 16),
           dense with eager commit and paged (page 16) at 512 pages (the
           first 8), paged at 256 (the 16: admission defers, so the
           pipelines group other requests).
           Every request reaches its budget; the four serves' streams
           are equal; each equals the one-shot serve's or departs only
           where the target's top-2 gap is within BF16_TOL of its top
           logit; no prefill op is wider than 128 (the one-shot serve's
           widest is reported); the verify kernel's launches at T = 128
           equal 40 x the target continuations plus the draft's extends
           at that width (from the chunk ops the serve ran); every
           kernel of the path launches; no page leaks.  Each prints
           tokens/s, superstep ms, host syncs per superstep, TTFT p50,
           prefill_chunks, the prefill gap tokens, peak memory and
           launches beside the one-shot serve's.  After the dense cohort
           serve, one pipeline of two 512-wide prompts against the
           one-shot prefill's rows on the valid region: bit for bit, or
           relative L2 below REL_L2_TOL with the first departing op.
           After the 512-page serve, its longest prompt alone, twice:
           the second pipeline resumes from the shared prefix pages
           (fewer chunks, tokens saved) with the same stream.
  overload_serve  the overload response on the serve's weights (batch
           8, max_len 1024, gamma 3, K 8, greedy, deadline admission with
           lookahead 8 over gated arrivals, the engine's clock bound to
           its round count): OVERLOAD_ROWS (8 loose residents from round
           0, 4 tight requests at round 10, 3 loose tail requests, one
           hopeless request with deadline 4 at round 2; prompts 64-256),
           three serves: (a) no preemption or shedding, (b)
           preempt="deadline" and shed="expired", (c) as (b) paged at 512
           pages of 16.  (b) and (c) assert at least one preemption,
           restores plus dropped spills equal to preemptions, evictions
           summed over the requests equal to them, one request shed with
           an empty stream, every other stream equal to (a)'s bit for
           bit, and the tight requests' deadline hits at least (a)'s;
           (c) spilled pages and a clean allocator; each serve launches
           the verify and prefill kernels.  Then the 8 residents alone
           (budget 16, a trace that never overloads) without and with
           (b)'s policies: equal streams, round stamps, supersteps and
           host syncs.  Prints the counts, the tight requests' TTFT in
           rounds, each spill's and restore's host ms and CUDA-event ms
           (median), a spill's snapshot bytes against their bound at
           3.35 TB/s (read once, written once), superstep ms, host syncs
           per superstep and peak memory beside (a)'s.
  train    the draft's training step (the paper loop's step 8):
           DraftTrainer.train_cycle on the 16 63-token signal windows
           the serve phase's SignalExtractor collected (drained right
           after that serve; 15 train, 1 eval; 8 a step, TRAIN_STEPS
           steps, adamw), then a replay: a fresh engine with the
           trained draft serves the same 16 requests, whose streams
           must equal the serve's.  Reports steps, step ms, the loss
           curve, train and eval accuracy, peak memory, the forward and
           backward attention launches per step (2 and 2 with TTT) and
           the mean accepted length before and after; fails on a
           non-finite loss, a loss that does not fall or a replay stream
           that differs.  Every earlier engine is freed first; a
           step split (forward, backward, update) and a short profile
           of five steps come last.
  tide     the synchronous adaptation loop (TideSystem, async_train
           False) on the serve's weights and untrained draft: batch 8,
           max_len 1024, gamma 3, K 8, signal_window 63, n_threshold 8
           windows, TIDE_SYNC_STEPS steps a cycle.  Stream 1 serves the
           16 requests, training at request-completion boundaries (the
           first cycle runs once 8 windows are in, and a draft the gate
           accepts serves from the next dispatch); stream 2 serves fresh
           requests of the first TIDE_STREAM2 prompts.  Reports each
           cycle (eval and train accuracy, baseline, deployed, steps,
           seconds, engine round, prefill and backward launches), the
           round and superstep of each deploy, the mean accepted length
           of stream 1 before and after its first deploy and of stream
           2, every kernel's launches over the phase, peak memory.
           Asserts both streams equal the serve's (stream 2 its first
           TIDE_STREAM2), the gate deployed inside stream 1,
           stream 2's mean accepted length is above 1.0, and each cycle
           launched the attention backward twice a step.
  reseed   the deploy-time re-seed of the draft cache at full width
           (batch 8, max_len 1024, gamma 3, K 8, reseed_window 24): the
           serve's first 8 requests through three supersteps with the
           serve's draft (A) and, from their own prologue, with a second
           draft B (eagle.draft_init seed 99); A's cache re-seeded from
           its capture ring with B must hold to B's on the window,
           position for position (relative L2 below REL_L2_TOL, per
           element BF16_TOL), and move away from A's; re-seeded with A
           it must stay within the same bounds of A's.  Again with page
           16: the paged re-seed's rows equal the dense re-seed's on the
           gathered view (torch.equal) and no page leaks.  Reports the
           re-seed's host ms and CUDA-event ms, dense and paged, and
           the error of the window computed in one pass, as JAX does
           (the engine computes it in blocks of gamma + 1 columns,
           serving's extend shapes).
  tide_async  TideSystem in async mode (async_train True, reseed_window
           16, TIDE_STEPS steps a cycle, otherwise the tide phase's
           configuration) on the serve's weights and untrained draft:
           the training service's thread trains on a CUDA stream of its
           own while the serving thread serves the 16 requests as
           stream 1, then the first TIDE_STREAM2 again as stream 2 (a
           third such stream only if no deploy was picked up by then).
           Each stream and superstep is timed with the serving stream's
           synchronize, never the device's.  Reports the card count and
           pick_training_device(), each cycle (event, seconds, the
           engine's dispatch count at its start and end, backward
           launches), each deploy's round, superstep and re-seeds, the
           mean superstep ms with a cycle in flight and without, the
           stream walls beside the tide phase's, the mean accepted
           length of stream 1 after its first deploy and of stream 2,
           thread_cap and peak memory.  Asserts every stream equals the
           serve's, no trainer failure, at least one cycle with at least
           one superstep dispatched while it ran, a deploy picked up
           inside a stream, re-seeds equal to deploys, two backward
           launches a step, and the thread gone after close() (a second
           close() a no-op).
  fleet    the fleet (src/repro_torch/fleet) on the same weights and
           untrained draft, three runs.  (a) remote_sync: the tide
           phase's TideConfig with fleet=FleetConfig(trainer_endpoint=
           "spawn"): the trainer in a process of its own on the card
           (python -m repro_torch.fleet.trainer_main), its two streams
           must give the tide phase's streams, cycle count, deploy
           rounds and second-stream mean accepted length, with no
           trainer failure.  (b) remote_async: the tide_async
           configuration with a spawned trainer; streams of the 16
           requests, then of the first TIDE_STREAM2, until a deploy is
           picked up; each superstep timed on the serving stream and
           set against the trainer's cycles (their ends on the host's
           monotonic clock, less their seconds); then kill_trainer() and
           a stream of TIDE_STREAM2 requests: it must finish within
           FLEET_STREAM_S on the last deployed draft with the serve's
           streams and one failure.  (c) replicas: ServingFleet with
           FleetConfig(replicas=2) and the in-process sync trainer on
           the 16 requests, newest first (see _fleet_replicas): every
           stream equal to the serve's, both replicas used, a cycle, a
           deploy that reaches both replicas through the bus, both
           engines on the params object, peak memory within
           FLEET_PEAK_GB of the tide phase's.  (a) and (b) print the
           spawn-to-ready seconds, the INIT frame's and each DRAFT
           frame's bytes and seconds on both sides (encode and send in
           the sender, decode and copy in the receiver), both processes'
           peak RSS (the serving process's over the whole run) and the
           trainer's device peak; (b) its supersteps during a remote
           cycle, during a DRAFT's transfer (the trainer's encode to the
           serving side's copy) and neither, beside tide_async's
           in-process figures.
           The verify and prefill kernels launch in every run.
  profile  torch.profiler over a short serve (8 requests of prompt 256,
           PROFILE_NEW new tokens: a prologue and one superstep of 2
           decoding rounds; each line carries its seconds) on the
           dense engine right
           after its serve, then on the half-pool paged engine, each
           tree engine and the W = 4 paged tree engine, each right after
           its serve: device busy share, device time by kernel class,
           and the host-blocking CUDA calls (synchronizations, pageable
           host-to-device copies) of each; no paged or tree serve may
           block the host more than the chain.  Each engine is freed
           before the next is built.

Then a ``total`` line with the run's seconds and the overload_serve,
tide and fleet phases' and each profile's seconds, and the kernel table
(``{"kernels": [...]}``: eleven rows, each with its launch count from
the main-path serve (for flash_attention_bwd, the train phase; for the
sampling kernels, the dense sampled serve) that runs it, the launch
phase's count
(launch_phase_launches) and its ms,
device_ms and host_ms), the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``.  Each kernel row also
carries its launches in the dense cohort chunked serve
(chunked_serve_launches), in the overload phase's serve (b)
(overload_serve_launches) and in the families phase's serves
(families_launches).  Any failure raises
and exits non-zero before the last line.  Without a CUDA card it exits non-zero
at once.
"""
from __future__ import annotations

import dataclasses
import json
from functools import partial
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16
BF16_TOL = 2e-2                  # per element, as tests/test_kernels.py
# whole tensor: set from readings on an H100 (at most 2.9e-5 at the
# shapes below), so a systematic error above 0.1 % fails
REL_L2_TOL = 1e-3
GLM = dict(B=8, S=512, SMAX=1024, HQ=32, HK=2, D=128, F=3 * 4096, GAMMA=3,
           P=16, TREE_W=4, TRAIN_WINDOW=63)
# optimizer steps of the train phase: 200 steps of 8 of the 15 train
# windows, ~107 epochs, enough for the loss to flatten (training until
# saturation, paper Fig. 5)
TRAIN_STEPS = 200
# the tide phase's steps a cycle: its batch holds all 7 train windows, so
# each window is seen 100 times (the train phase's ~107); at 200 the run
# passed half its time limit
TIDE_STEPS = TRAIN_STEPS // 2
# the sync tide phase's steps a cycle, and both tide phases' requests
# in each stream after the first, cut from TIDE_STEPS and 16 to make room
# for the overload phase (the async phase keeps TIDE_STEPS: its cycle
# must stay long enough for a superstep to be dispatched during it).  7
# windows stay under a cycle's 8, so no third cycle trains a draft that
# no stream serves
TIDE_SYNC_STEPS = TRAIN_STEPS // 4
TIDE_STREAM2 = 7


T_START = time.perf_counter()
# what a run writes beside its output lines (git-ignored)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")


def emit(obj):
    """One JSON line; a phase line also gets the seconds since start."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - T_START, 1))
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=60, check=True)
    return out.stdout.decode().strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Median ms of ``fn`` by CUDA events around each call."""
    from repro_torch.obs.timing import event_ms
    return event_ms(fn, iters)


# the port's CUDA kernels, by the names the profiler lists
PORT_KERNELS = ("attn_rows", "mma_rows", "extract_pack", "linear_rows",
                "flash_bwd", "threefry", "categorical")


def kernel_ms(call: partial, iters: int = 20) -> dict:
    """A kernel wrapper's call, its arguments bound now (its device time
    is read at the end of the phase, when loop variables have moved on),
    timed three ways
    (``repro_torch.obs.timing.split_ms``): ``ms``, CUDA events around one
    call (they bracket the wrapper's host work too); ``host_ms``, the
    host's time per call, calls enqueued without a sync; ``device_ms``,
    the port's kernels' device time per call (torch.profiler), read at
    the end of the phase by ``resolve``."""
    from repro_torch.obs.timing import split_ms
    return split_ms(call, PORT_KERNELS, iters)


def bound(nbytes: float, flops: float):
    mem, ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def hold(out, ref, what: str):
    """Hold a bf16 kernel output against its plain version: per element
    at rtol = atol = BF16_TOL, and as a whole at relative L2 error below
    REL_L2_TOL (a key dropped or double-counted in rows that see hundreds
    of keys moves each element by less than the per-element tolerance,
    but the whole tensor by several percent).  Returns (max abs error,
    relative L2 error)."""
    out, ref = out.float(), ref.float()
    torch.testing.assert_close(out, ref, rtol=BF16_TOL, atol=BF16_TOL,
                               msg=lambda m: f"{what}: {m}")
    rel = float((out - ref).norm() / ref.norm())
    assert rel < REL_L2_TOL, f"{what}: relative L2 error {rel}"
    return max_err(out, ref), rel


# ------------------------------------------------------------------ env
def _use_checkout():
    """Refuse to run without a card; import the port from this checkout."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))


def phase_env():
    _use_checkout()
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi(),
          "build_s": round(time.perf_counter() - t0, 2),
          "nvcc_s": round(build.BUILD_SECONDS, 2)})


# -------------------------------------------------------------- kernels
def _sdpa(q, k, v, mask):
    """One library call for masked GQA attention (yardstick only)."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None]).transpose(1, 2)


def phase_kernels():
    from repro_torch.kernels.extract_pack.ops import pack_signals
    from repro_torch.kernels.extract_pack.ref import extract_pack_ref
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import (flash_attention_ref,
                                                    prefill_mask)
    from repro_torch.kernels.verify_attn.ops import (verify_attention,
                                                     verify_route)
    from repro_torch.kernels.verify_attn.ref import (verify_attention_ref,
                                                     verify_mask)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, SMAX, HQ, HK, D = (GLM[k] for k in ("B", "S", "SMAX", "HQ", "HK", "D"))
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    rows = []
    # ---- prefill (serving prefill with left pad)
    q, k, v = rnd(B, S, HQ, D), rnd(B, S, HK, D), rnd(B, S, HK, D)
    pad = torch.tensor([0, 17, 100, 311, 0, 5, 64, 400], dtype=torch.int32,
                       device=dev)
    out = flash_attention(q, k, v, pad)
    ref = flash_attention_ref(q, k, v, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all(), "flash_attention wrote non-finite"
    valid = (torch.arange(S, device=dev)[None, :] >= pad[:, None])
    err, rel = hold(out[valid], ref[valid], "flash_attention")
    assert not out[~valid].any(), "rows before pad must be zeros"
    vis = torch.clamp(torch.arange(S, device=dev)[None, :] - pad[:, None] + 1,
                      min=0).sum().item() * HQ
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B
    mask = prefill_mask(B, S, pad, device=dev)
    b_ms, b_by = bound(nbytes, 4.0 * vis * D)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn/kernel.py:167",
        prefill_path="tensor_core_bf16",
        max_abs_err=err, rel_l2_err=rel,
        p_bf16_rel_l2_emulated=_p_bf16_rel_l2(q, k, v, mask, ref, valid),
        **kernel_ms(partial(flash_attention, q, k, v, pad)),
        plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v, pad), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: _sdpa(q, k, v, mask)),
        shape=f"q {tuple(q.shape)} kv {tuple(k.shape)} bf16, pad>0"))

    # ---- verify attention at T = 4 (target verify), 1, 511
    kc, vc = rnd(B, SMAX, HK, D), rnd(B, SMAX, HK, D)
    cases = []
    for t, lengths in ((4, [600, 517, 812, 1000, 64, 256, 700, 333]),
                       (1, [600, 517, 812, 1000, 64, 256, 700, 333]),
                       (511, [0] * B)):
        qt = rnd(B, t, HQ, D)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        pd = torch.minimum(pad, ln) if t < 511 else pad
        o = verify_attention(qt, kc, vc, ln, pd)
        r = verify_attention_ref(qt, kc, vc, ln, pd)
        torch.cuda.synchronize()
        assert torch.isfinite(o).all(), "verify_attention wrote non-finite"
        qpos = ln[:, None] + torch.arange(t, device=dev)[None, :]
        live = qpos >= pd[:, None]
        e, rel_t = hold(o[live], r[live], f"verify_attention T={t}")
        nvis = (torch.clamp(torch.clamp(qpos, max=SMAX - 1) - pd[:, None] + 1,
                            min=0)).sum().item() * HQ
        span = (torch.clamp(ln + t, max=SMAX) - pd).clamp(min=0).sum().item()
        nbytes = 2 * 2 * qt.numel() + 2 * 2 * span * HK * D + 8 * B
        vmask = verify_mask(ln, t, SMAX, pd)
        b_ms, b_by = bound(nbytes, 4.0 * nvis * D)
        cases.append(dict(
            T=t, max_abs_err=e, rel_l2_err=rel_t,
            **kernel_ms(partial(verify_attention, qt, kc, vc, ln, pd)),
            plain_ms=cuda_ms(lambda: verify_attention_ref(qt, kc, vc, ln, pd),
                             iters=5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: _sdpa(qt, kc, vc, vmask))))
    cases.append(_chunk_verify_case(rnd, pad))
    head = cases[0]
    vpath = verify_route(bf, D)
    assert vpath == "tensor_core_bf16", vpath
    rows.append(dict(
        name="verify_attention", route="cuda",
        source="src/repro_torch/csrc/verify_attn.cu",
        replaces="src/repro/kernels/verify_attn/kernel.py:214",
        verify_path=vpath,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        **{k: head[k] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")},
        shape=f"T=4 q {(B, 4, HQ, D)} cache {tuple(kc.shape)} bf16",
        cases=cases))

    # ---- paged kernels: pools of B * 64 pages + trash at P 16; each lane's
    # table a shuffled page list, lanes 0-3 sharing their first 8 pages
    from repro_torch.core.paging import gather_view
    from repro_torch.kernels.flash_attn.ops import flash_attention_paged
    from repro_torch.kernels.flash_attn.ref import flash_attention_paged_ref
    from repro_torch.kernels.verify_attn.ops import verify_attention_paged
    from repro_torch.kernels.verify_attn.ref import verify_attention_paged_ref
    P = GLM["P"]
    n_tbl = SMAX // P
    n_pages = B * n_tbl
    kpool, vpool = rnd(n_pages + 1, P, HK, D), rnd(n_pages + 1, P, HK, D)
    full = torch.randperm(n_pages, generator=g, device=dev).to(
        torch.int32).reshape(B, n_tbl)
    full[1:4, :8] = full[0, :8]

    def table(need):
        """Rows of ``full`` with entries past need[b] pages on trash."""
        col = torch.arange(n_tbl, device=dev)[None, :]
        return torch.where(col < need[:, None], full,
                           torch.full_like(full, n_pages)).contiguous()

    pcases = []
    for t, lengths in ((4, [600, 517, 812, 1000, 64, 256, 700, 333]),
                       (1, [600, 517, 812, 1000, 64, 256, 700, 333]),
                       (511, [0] * B)):
        qt = rnd(B, t, HQ, D)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        pd = torch.minimum(pad, ln) if t < 511 else pad
        need = torch.clamp(-(-(ln + t) // P), max=n_tbl)
        tb = table(need)
        kv_k, kv_v = gather_view(kpool, tb), gather_view(vpool, tb)
        o = verify_attention_paged(qt, kpool, vpool, tb, ln, pd)
        r = verify_attention_paged_ref(qt, kpool, vpool, tb, ln, pd)
        dense = verify_attention(qt, kv_k, kv_v, ln, pd)
        torch.cuda.synchronize()
        assert torch.isfinite(o).all(), "verify_attention_paged non-finite"
        assert torch.equal(o, dense), \
            f"verify_attention_paged T={t} != dense kernel on the view"
        qpos = ln[:, None] + torch.arange(t, device=dev)[None, :]
        live = qpos >= pd[:, None]
        e, rel_t = hold(o[live], r[live], f"verify_attention_paged T={t}")
        nvis = (torch.clamp(torch.clamp(qpos, max=SMAX - 1) - pd[:, None] + 1,
                            min=0)).sum().item() * HQ
        span = (torch.clamp(ln + t, max=SMAX) - pd).clamp(min=0).sum().item()
        pages = (need - pd // P).clamp(min=0).sum().item()
        nbytes = (2 * 2 * qt.numel() + 2 * 2 * span * HK * D + 4 * pages
                  + 8 * B)
        vmask = verify_mask(ln, t, SMAX, pd)
        b_ms, b_by = bound(nbytes, 4.0 * nvis * D)
        pcases.append(dict(
            T=t, max_abs_err=e, rel_l2_err=rel_t, equal_dense=True,
            **kernel_ms(partial(verify_attention_paged, qt, kpool, vpool,
                                tb, ln, pd)),
            plain_ms=cuda_ms(lambda: verify_attention_paged_ref(
                qt, kpool, vpool, tb, ln, pd), iters=5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: _sdpa(qt, gather_view(kpool, tb),
                                             gather_view(vpool, tb), vmask))))
    head = pcases[0]
    rows.append(dict(
        name="verify_attention_paged", route="cuda",
        source="src/repro_torch/csrc/verify_attn_paged.cu",
        replaces="src/repro/kernels/verify_attn/kernel.py:157",
        verify_path=vpath,
        max_abs_err=max(c["max_abs_err"] for c in pcases),
        **{k: head[k] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")},
        library="pool[tbl] gather + scaled_dot_product_attention (2 calls)",
        shape=f"T=4 q {(B, 4, HQ, D)} pools {tuple(kpool.shape)} "
              f"tbl {tuple(full.shape)} bf16", cases=pcases))

    need = torch.full((B,), S // P, dtype=torch.int64, device=dev)
    tb = table(need)
    o = flash_attention_paged(q, kpool, vpool, tb, pad)
    r = flash_attention_paged_ref(q, kpool, vpool, tb, pad)
    kv_k = gather_view(kpool, tb)[:, :S].contiguous()
    kv_v = gather_view(vpool, tb)[:, :S].contiguous()
    dense = flash_attention(q, kv_k, kv_v, pad)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all(), "flash_attention_paged wrote non-finite"
    assert torch.equal(o, dense), "flash_attention_paged != dense on the view"
    err, rel = hold(o[valid], r[valid], "flash_attention_paged")
    assert not o[~valid].any(), "rows before pad must be zeros"
    pages = (need - pad // P).sum().item()
    nbytes = (2 * (2 * q.numel() + 2 * B * S * HK * D) - 2 * 2 * HK * D
              * pad.sum().item() + 4 * pages + 4 * B)
    b_ms, b_by = bound(nbytes, 4.0 * vis * D)
    rows.append(dict(
        name="flash_attention_paged", route="cuda",
        source="src/repro_torch/csrc/flash_attn_paged.cu",
        replaces="src/repro/kernels/flash_attn/kernel.py:115",
        prefill_path="tensor_core_bf16",
        max_abs_err=err, rel_l2_err=rel, equal_dense=True,
        **kernel_ms(partial(flash_attention_paged, q, kpool, vpool, tb, pad)),
        plain_ms=cuda_ms(lambda: flash_attention_paged_ref(
            q, kpool, vpool, tb, pad), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: _sdpa(
            q, gather_view(kpool, tb[:, :S // P]),
            gather_view(vpool, tb[:, :S // P]), mask)),
        library="pool[tbl] gather + scaled_dot_product_attention (2 calls)",
        shape=f"q {tuple(q.shape)} pools {tuple(kpool.shape)} bf16, pad>0"))

    rows += _tree_rows(rnd, kc, vc, pad, kpool, vpool, table)
    launch_cases = _launch_serve_cases(rnd, g)

    # ---- extract_pack (exact), called as decode_superstep calls it: into
    # one slot of a superstep's (K, B, T, F) signal buffers
    F_ = GLM["F"]
    T4 = GLM["GAMMA"] + 1
    feats = rnd(B, T4, F_)
    toks = torch.randint(0, 151552, (B, T4), generator=g, device=dev,
                         dtype=torch.int32)
    msk = torch.rand((B, T4), generator=g, device=dev) < 0.6
    bufs = (torch.zeros((8, B, T4, F_), dtype=bf, device=dev),
            torch.zeros((8, B, T4), dtype=torch.int32, device=dev),
            torch.zeros((8, B), dtype=torch.int32, device=dev))
    slot = tuple(x[3] for x in bufs)
    got = pack_signals(feats, toks, msk)
    pack_signals(feats, toks, msk, out=slot)
    want = extract_pack_ref(feats, toks, msk)
    torch.cuda.synchronize()
    for a, s_, w in zip(got, slot, want):
        assert torch.equal(a, w) and torch.equal(s_, w), \
            "extract_pack is not exact"
    # each accepted row read once, every row, token and count written once
    kept = int(msk.sum())
    nbytes = (2 * F_ * (kept + B * T4) + 4 * (kept + B * T4) + msk.numel()
              + 4 * B)
    b_ms, b_by = bound(nbytes, 0.0)
    rows.append(dict(
        name="extract_pack", route="cuda",
        source="src/repro_torch/csrc/extract_pack.cu",
        replaces="src/repro/kernels/extract_pack/kernel.py:46",
        path="ballot_uint4", max_abs_err=0.0,
        **kernel_ms(partial(pack_signals, feats, toks, msk, out=slot),
                    iters=50),
        plain_ms=cuda_ms(lambda: extract_pack_ref(feats, toks, msk), iters=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library="none: no single PyTorch call compacts by a mask",
        shape=f"feats {tuple(feats.shape)} bf16, {kept} rows kept, out= "
              f"slot 3 of {tuple(bufs[0].shape)}"))
    rows.append(_linear_rows_row(g))
    rows.append(_flash_bwd_row(g))
    rows += _sample_rows(g)
    for row in rows:
        got = launch_cases.get(row["name"])
        if got:
            row["launch_serve_cases"] = got
            row["max_abs_err"] = max(row["max_abs_err"],
                                     *(c["max_abs_err"] for c in got))
    # every device time after every event and host time (obs/timing.py)
    from repro_torch.obs.timing import device_ms, resolve
    rows = resolve(rows)
    _bwd_blocks(next(r for r in rows if r["name"] == "flash_attention_bwd"))
    for row in rows:
        kinds = SHIFT_KINDS_OF[row["name"]]
        row["pad_shift_equal"] = _pad_shift_equal(kinds) if kinds else None
        if row["library_ms"]:
            row["ms_over_library_ms"] = row["ms"] / row["library_ms"]
    emit({"phase": "kernels", "profiler_retries": device_ms.retries,
          "kernels": rows})
    return rows


# a chunked refill's continuation on glm4-9b (chunked_serve): T = C =
# 128 query rows a lane against the pipeline's 512-row staging cache.
# N_CUT: the requests of the eager and 512-page chunked serves, the
# first wave of the 16 (requests 1, 3, 5 and 7 share a prompt); cut from
# 16 to make room for the families phase (ROADMAP H11)
CHUNK = dict(C=128, S=512, N_CUT=8)


def _chunk_verify_case(rnd, pad) -> dict:
    """verify_attention at the chunk shape: B 8, T 128 against a 512-row
    cache, pads up to 400 (rows before a lane's pad see no key and must
    be zero), held against its plain version on the rows that see a key;
    the lane's rows at the chunk shape do not move with its pad or batch
    (``pad_shift_equal``, kind ``verify128``)."""
    from repro_torch.kernels.verify_attn.ops import verify_attention
    from repro_torch.kernels.verify_attn.ref import (verify_attention_ref,
                                                     verify_mask)
    from repro_torch.obs.cobatch import lane_inputs, pad_shift_departure
    dev = pad.device
    B, HQ, HK, D = (GLM[k] for k in ("B", "HQ", "HK", "D"))
    t, smax = CHUNK["C"], CHUNK["S"]
    kc, vc = rnd(B, smax, HK, D), rnd(B, smax, HK, D)
    qt = rnd(B, t, HQ, D)
    ln = torch.tensor([128, 256, 384, 136, 264, 200, 384, 0],
                      dtype=torch.int32, device=dev)
    pd = pad
    n128 = verify_attention.launches_at_t[t]
    o = verify_attention(qt, kc, vc, ln, pd)
    r = verify_attention_ref(qt, kc, vc, ln, pd)
    torch.cuda.synchronize()
    assert verify_attention.launches_at_t[t] == n128 + 1, "T=128 uncounted"
    assert torch.isfinite(o).all(), "verify_attention T=128 non-finite"
    qpos = ln[:, None] + torch.arange(t, device=dev)[None, :]
    live = qpos >= pd[:, None]
    assert not o[~live].any(), "rows that see no key must be zeros"
    e, rel_t = hold(o[live], r[live], "verify_attention T=128")
    nvis = (qpos - pd[:, None] + 1).clamp(min=0).sum().item() * HQ
    span = (ln + t - pd).clamp(min=0).sum().item()
    nbytes = 2 * 2 * qt.numel() + 2 * 2 * span * HK * D + 8 * B
    b_ms, b_by = bound(nbytes, 4.0 * nvis * D)
    vmask = verify_mask(ln, t, smax, pd)
    lane = lane_inputs(150, HQ, HK, D, torch.bfloat16, dev, 81)
    moved = pad_shift_departure("verify128", lane, extras=(0, 40))
    assert moved is None, f"verify128: a lane's rows moved at {moved}"
    return dict(
        T=t, cache=smax, chunk_case=True, max_abs_err=e, rel_l2_err=rel_t,
        pad_shift_equal=True,
        **kernel_ms(partial(verify_attention, qt, kc, vc, ln, pd)),
        plain_ms=cuda_ms(lambda: verify_attention_ref(qt, kc, vc, ln, pd),
                         iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: _sdpa(qt, kc, vc, vmask)))


# the launch phase's serve (the serve CLI's configuration): batch 4,
# max_len 96 (one and a half 64-key tiles), prompts of 12-23 tokens
# refilled at a width of 24
LAUNCH_SERVE = dict(B=4, SMAX=96, S=24)


def _launch_serve_cases(rnd, g) -> dict:
    """The kernels at the launch phase's serve shapes, each held against
    its plain version: the prefill at batch 4, width 24 with left pads;
    verify_attention at T 4 and 1 against a cache of 96 rows, lengths up
    to its end; extract_pack into a (4, 4, F) slot.  Returns
    {kernel name: [case, ...]}."""
    from repro_torch.kernels.extract_pack.ops import pack_signals
    from repro_torch.kernels.extract_pack.ref import extract_pack_ref
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.kernels.verify_attn.ops import verify_attention
    from repro_torch.kernels.verify_attn.ref import verify_attention_ref
    dev = torch.device("cuda")
    B, SMAX, S = (LAUNCH_SERVE[k] for k in ("B", "SMAX", "S"))
    HQ, HK, D = GLM["HQ"], GLM["HK"], GLM["D"]
    pad = torch.tensor([1, 5, 9, 12], dtype=torch.int32, device=dev)
    q, k, v = rnd(B, S, HQ, D), rnd(B, S, HK, D), rnd(B, S, HK, D)
    out = flash_attention(q, k, v, pad)
    ref = flash_attention_ref(q, k, v, pad)
    torch.cuda.synchronize()
    valid = torch.arange(S, device=dev)[None, :] >= pad[:, None]
    err, rel = hold(out[valid], ref[valid], "flash_attention B=4 S=24")
    assert not out[~valid].any(), "rows before pad must be zeros"
    got = {"flash_attention": [dict(
        shape=f"q {tuple(q.shape)} kv {tuple(k.shape)} bf16, pad "
              f"{pad.tolist()}", max_abs_err=err, rel_l2_err=rel)]}
    kc, vc = rnd(B, SMAX, HK, D), rnd(B, SMAX, HK, D)
    vcases = []
    for t, lengths in ((4, [20, 57, 88, 92]), (1, [24, 60, 90, 95])):
        qt = rnd(B, t, HQ, D)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        o = verify_attention(qt, kc, vc, ln, pad)
        r = verify_attention_ref(qt, kc, vc, ln, pad)
        torch.cuda.synchronize()
        assert torch.isfinite(o).all(), "verify_attention wrote non-finite"
        e, rel_t = hold(o, r, f"verify_attention B=4 T={t} Smax=96")
        vcases.append(dict(T=t, lengths=lengths, shape=f"q {tuple(qt.shape)} "
                           f"cache {tuple(kc.shape)} bf16",
                           max_abs_err=e, rel_l2_err=rel_t))
    got["verify_attention"] = vcases
    T4 = GLM["GAMMA"] + 1
    feats = rnd(B, T4, GLM["F"])
    toks = torch.randint(0, 151552, (B, T4), generator=g, device=dev,
                         dtype=torch.int32)
    msk = torch.rand((B, T4), generator=g, device=dev) < 0.6
    slot = (torch.zeros_like(feats), torch.zeros_like(toks),
            torch.zeros((B,), dtype=torch.int32, device=dev))
    pack_signals(feats, toks, msk, out=slot)
    torch.cuda.synchronize()
    for s_, w in zip(slot, extract_pack_ref(feats, toks, msk)):
        assert torch.equal(s_, w), "extract_pack B=4 is not exact"
    got["extract_pack"] = [dict(shape=f"feats {tuple(feats.shape)} bf16, "
                                f"{int(msk.sum())} rows kept",
                                max_abs_err=0.0)]
    return got


def phase_kernels_apart():
    """The kernels phase in a process of its own (``chip_smoke.py
    --kernels``), which ends before the serves: after its torch.profiler
    sessions (device_ms) every kernel launch of the process costs the
    host more (obs/timing.py), and the serves must not pay that.
    Returns its rows."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--kernels"], stdout=subprocess.PIPE,
                          timeout=900, check=True)
    line = json.loads(proc.stdout.decode().splitlines()[-1])
    emit(line)
    return line["kernels"]


# ------------------------------------------------------------- launch
# the launch phase's target training: steps of the launch/train twin
# (batch 8 and seq 64, the CLI's defaults) and of pretrain_target on the
# serve CLI's corpus, both with Adafactor (AdamW's fp32 moments for 9.40 B
# parameters are ~75 GB) at lr 1e-4: at the CLI's 1e-3 the loss rises
# after 3 steps (12.31 to 14.37 in 12), and of 1e-4, 2e-4, 3e-4 and 5e-4
# 1e-4 lowered it most in 12 steps (scripts/launch_lr.py on an H100)
LAUNCH_TRAIN_STEPS = 12
LAUNCH_LR = 1e-4
PRETRAIN_STEPS = 40
PRETRAIN_LR = 1e-4
# the CLI's serve: requests (waves of --batch 4, 32 new tokens each)
LAUNCH_REQUESTS = 16


def _launch_counts(fns) -> dict:
    out = {name: fn.launches for name, fn in fns.items()}
    out["verify_attention_t1"] = fns["verify_attention"].t1_launches
    out["verify_attention_tree"] = fns["verify_attention"].tree_launches
    out["verify_attention_t4"] = (out["verify_attention"]
                                  - out["verify_attention_t1"]
                                  - out["verify_attention_tree"])
    return out


def _zero_counts(fns):
    for fn in fns.values():
        fn.launches = 0
        for attr in ("tree_launches", "t1_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _timed_update(opt):
    """``opt`` with each update timed apart from the forward and backward
    before it (synchronized on both sides).  Returns (optimizer, update
    ms, host time at each update's end)."""
    update_ms, ends = [], []

    def update(*a):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = opt.update(*a)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        update_ms.append((ends[-1] - s) * 1e3)
        return out

    return opt._replace(update=update), update_ms, ends


def _serve_row(sys_, done, wall_s, counts, args):
    from repro_torch.launch import serve as S
    s = sys_.summary()
    first, last = S.accept_trend(sys_)
    events = [{k: e.get(k) for k in ("eval_acc", "train_acc", "baseline",
                                     "deployed", "steps", "seconds",
                                     "engine_steps")}
              for e in sys_.events if e["kind"] == "train_cycle"]
    return {"requests": len(done), "batch": args.batch,
            "gamma": args.gamma, "max_new_tokens": args.max_new_tokens,
            "adaptive": not args.no_adaptive, "spec_park": args.spec_park,
            "wall_s": wall_s, "tokens_per_s": s["throughput_tok_s"],
            "steps": s["steps"], "spec_steps": s["spec_steps"],
            "accept_len": s["accept_len"],
            "accept_len_trend": [first, last],
            "cycles": len(events), "events": events,
            "deploys": s["deploys"], "deployed": s["deployed"],
            "spec_parks": s["spec_parks"],
            "spec_resumes": s["spec_resumes"],
            "signals_collected": s["signals_collected"],
            "trainer_failures": s["trainer_failures"],
            "trainer_last_error": sys_.service.last_error,
            "launches": counts,
            "max_memory_allocated_GB":
                torch.cuda.max_memory_allocated() / 1e9}


def phase_launch(arch: str = "glm4-9b", device: str = "cuda"):
    """The port's entry points at ``arch``'s full width and depth, in a
    process of its own (``chip_smoke.py --launch``): the launch/train
    twin, pretrain_target, the startup profiling pass and two serves
    through the serve CLI's pieces.  One JSON line per step; the CLIs'
    own printed lines go to the parent's stderr."""
    import math

    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.core.adaptive import accept_threshold_table
    from repro_torch.core.tide import TideConfig
    from repro_torch.kernels.flash_attn.ops import flash_attention_bwd
    from repro_torch.launch import serve as S
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import adafactor
    from repro_torch.training.trainer import pretrain_target
    cfg = get(arch)
    dev = torch.device(device)
    fns = dict(_kernel_fns(), flash_attention_bwd=flash_attention_bwd)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # 1. launch_train: the launch/train twin at full width
    args = TR.build_parser().parse_args(
        ["--arch", cfg.name, "--steps", str(LAUNCH_TRAIN_STEPS),
         "--optimizer", "adafactor", "--lr", str(LAUNCH_LR)])
    t0 = time.perf_counter()
    params = T.init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt, update_ms, _ = _timed_update(adafactor(lr=args.lr))
    _zero_counts(fns)
    log = TR.train(cfg, params, args, device=dev, opt=opt)
    torch.cuda.synchronize()
    counts = _launch_counts(fns)
    add(counts)
    losses = [e["loss"] for e in log]
    steps = len(log)
    row = {"phase": "launch", "step": "train", "model": cfg.name,
           "layers": cfg.num_layers,
           "params_B": round(cfg.param_count() / 1e9, 3),
           "batch": args.batch, "seq": args.seq, "lr": args.lr,
           "optimizer": args.optimizer, "steps": steps, "init_s": init_s,
           "step_ms_first": log[0]["ms"],
           "step_ms_median_rest": statistics.median(
               e["ms"] for e in log[1:]),
           "update_ms_median_rest": statistics.median(update_ms[1:]),
           "losses": losses, "accuracy": [e["accuracy"] for e in log],
           "grad_norm": [e["grad_norm"] for e in log],
           "max_memory_allocated_GB":
               torch.cuda.max_memory_allocated() / 1e9,
           "flash_attention_per_step": counts["flash_attention"] / steps,
           "flash_attention_bwd_per_step":
               counts["flash_attention_bwd"] / steps,
           "launches": counts, "nvidia_smi": smi()}
    emit(row)
    assert all(math.isfinite(x) for x in losses), "non-finite loss"
    assert statistics.mean(losses[-3:]) < losses[0], "the loss did not fall"
    assert counts["flash_attention"] == counts["flash_attention_bwd"] \
        == cfg.num_layers * steps, counts
    del params, log
    _free()

    # 2. pretrain: the serve CLI's target, pretrained on its corpus
    params = T.init(cfg, 0, device=dev)
    domains, corpus = S.serve_corpus(cfg)
    opt, _, ends = _timed_update(adafactor(lr=PRETRAIN_LR))
    _zero_counts(fns)
    t0 = time.perf_counter()
    params, losses = pretrain_target(cfg, params, corpus,
                                     steps=PRETRAIN_STEPS, opt=opt)
    torch.cuda.synchronize()
    # a step ends with its update (the first one's time includes the
    # optimizer's init)
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + ends, ends)]
    counts = _launch_counts(fns)
    add(counts)
    row = {"phase": "launch", "step": "pretrain", "steps": PRETRAIN_STEPS,
           "batch": 8, "seq": corpus.shape[1] - 1, "optimizer": "adafactor",
           "lr": PRETRAIN_LR, "corpus_rows": corpus.shape[0],
           "losses": losses, "step_ms_first": step_ms[0],
           "step_ms_median_rest": statistics.median(step_ms[1:]),
           "max_memory_allocated_GB":
               torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    emit(row)
    assert all(math.isfinite(x) for x in losses), "non-finite loss"
    assert statistics.mean(losses[-3:]) < losses[0], "the loss did not fall"
    assert counts["flash_attention"] == counts["flash_attention_bwd"] \
        == cfg.num_layers * PRETRAIN_STEPS, counts
    _free()

    # 3. the startup profiling pass, on the pretrained target and the
    # serve's untrained draft
    args_a = S.build_parser().parse_args(
        ["--arch", cfg.name, "--requests", str(LAUNCH_REQUESTS),
         "--no-adaptive"])
    args_a.continuous = False
    dcfg = eagle.draft_config(cfg)
    dparams = eagle.draft_init(dcfg, TideConfig.seed + 7, device=dev)
    sizes = S.profile_batch_sizes(args_a.batch, args_a.gamma)
    t0 = time.perf_counter()
    profile = S.measure_profile(cfg, params, dcfg, dparams, sizes, dev,
                                max_len=S.config_from_args(args_a).max_len,
                                draft_batch=args_a.batch)
    prof_s = time.perf_counter() - t0
    g = args_a.gamma
    table = accept_threshold_table(profile, g, args_a.batch).tolist()
    row = {"phase": "launch", "step": "profile", "batch_sizes": sizes,
           "t_ms": profile.t_ms, "d0_ms": profile.d0_ms,
           "c": {b: profile.c(b) for b in range(1, args_a.batch + 1)},
           "beta": {b: profile.beta(b, g)
                    for b in range(1, args_a.batch + 1)},
           "threshold_table": table, "seconds": prof_s}
    emit(row)
    vals = list(profile.t_ms) + [profile.d0_ms] + list(row["c"].values()) \
        + list(row["beta"].values()) + table[1:]
    assert all(math.isfinite(v) and v > 0 for v in vals), row

    # 4. serve A: the CLI's configuration with --no-adaptive (TIDE-default)
    _zero_counts(fns)
    sys_a, done_a, wall_a = S.serve(args_a, cfg, params, None, domains,
                                    device=dev, dparams=dparams)
    torch.cuda.synchronize()
    S.report(args_a, sys_a, wall_a)
    counts = _launch_counts(fns)
    add(counts)
    row = {"phase": "launch", "step": "serve_a",
           **_serve_row(sys_a, done_a, wall_a, counts, args_a),
           "nvidia_smi": smi()}
    emit(row)
    streams_a = [list(r.generated) for r in done_a]
    assert len(done_a) == LAUNCH_REQUESTS and all(
        r.finish_t is not None and len(r.generated) == args_a.max_new_tokens
        for r in done_a), "a request did not finish with its budget"
    assert row["trainer_failures"] == 0, row["trainer_last_error"]
    assert row["cycles"] >= 1, "no train cycle ran"
    assert row["cycles"] == sys_a.service.cycles, row
    for name in ("flash_attention", "verify_attention", "extract_pack",
                 "linear_rows", "flash_attention_bwd"):
        assert counts[name] > 0, (name, counts)
    draft_a, _ = sys_a.gate.current()
    del sys_a, done_a
    _free()

    # 5. serve B: the same requests with the Eq. 5 gate on the measured
    # profile, parking after 2 gated-off rounds, from serve A's draft
    args_b = S.build_parser().parse_args(
        ["--arch", cfg.name, "--requests", str(LAUNCH_REQUESTS),
         "--spec-park", "2", "--trace-out",
         os.path.join(OUT_DIR, "launch_serve_b_trace.json")])
    args_b.continuous = False
    os.makedirs(OUT_DIR, exist_ok=True)
    _zero_counts(fns)
    sys_b, done_b, wall_b = S.serve(args_b, cfg, params, profile, domains,
                                    device=dev, dparams=draft_a)
    torch.cuda.synchronize()
    S.report(args_b, sys_b, wall_b)
    counts = _launch_counts(fns)
    add(counts)
    streams_b = [list(r.generated) for r in done_b]
    flips = _flips(sys_b.engine, done_b, streams_b, streams_a)
    tl = sys_b.engine.stats.timeline
    row = {"phase": "launch", "step": "serve_b",
           **_serve_row(sys_b, done_b, wall_b, counts, args_b),
           "probes": sum(1 for e in sys_b.tracer.events()
                         if e[1] == "spec.probe"),
           "spec_rounds_first_last_quarter": [
               sum(x["spec"] for x in tl[:max(len(tl) // 4, 1)]),
               sum(x["spec"] for x in tl[-max(len(tl) // 4, 1):])],
           "streams_equal_serve_a": streams_b == streams_a,
           "streams_differing": len(flips), "flips": flips,
           "nvidia_smi": smi()}
    emit(row)
    assert len(done_b) == LAUNCH_REQUESTS and all(
        len(r.generated) == args_b.max_new_tokens for r in done_b)
    assert row["trainer_failures"] == 0, row["trainer_last_error"]
    for f in flips:
        assert f["top2_logit_gap"] <= BF16_TOL * abs(f["top_logit"]), \
            f"serve B departs from serve A at no near-tie: {f}"
    del sys_b, done_b, params, draft_a
    _free()
    emit({"phase": "launch", "step": "total", "launches": total})


def phase_launch_apart():
    """The launch phase in a process of its own (``chip_smoke.py
    --launch``), run before the parent makes any engine: no profiler
    residue on its times, and the card's whole memory for a full-width
    training step.  Forwards its JSON lines, sends its other lines
    (the CLIs' own prints) to stderr, and returns its launches."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--launch"], stdout=subprocess.PIPE,
                          timeout=600, check=True)
    total = None
    for line in proc.stdout.decode().splitlines():
        if not line.startswith("{"):
            print(line, file=sys.stderr)
            continue
        row = json.loads(line)
        if row.get("step") == "total":
            total = row["launches"]
        emit(row)
    return total


# ------------------------------------------------------------- families
# the attention-mixer families beside glm4-9b, each at its published
# width from a seed with its EAGLE-3 draft; gpt-oss-120b (the paper's
# target) with 8 of its 36 layers, four repeats of its two-block
# pattern: one layer is ~3.2 B parameters (6.4 GB of experts in bf16), so
# all 36 do not fit the card's 80 GB
FAMILIES = (("phi3-medium-14b", 0), ("starcoder2-7b", 0),
            ("granite-moe-3b-a800m", 0), ("gpt-oss-120b", 8))
# the serve of each: 4 requests, prompts of 24-64 tokens, 16 new tokens,
# greedy chain gamma 3, K 8, speculation always on (no drafter: ROADMAP
# H10, a measured Eq. 5 profile follows host jitter); paged at page 16
FAMILY = dict(B=4, N=4, LO=24, HI=64, NEW=16, SMAX=128, GAMMA=3, P=16,
              PREFILL_S=64, M=256)
# the families whose cobatch verdict is read: starcoder2-7b, dense, must
# read none; granite-moe's MoE capacity comes from the refill's token
# count (JAX's _capacity), so its verdict is recorded, not asserted
COBATCH_FAMILIES = {"starcoder2-7b": True, "granite-moe-3b-a800m": False}
# moe_sort against the one-hot oracle in bf16, as a whole: each of the
# three expert products rounds its output to bf16 and the sort path adds
# a token's k contributions in bf16 (JAX's order), the oracle in fp32;
# on an H100 80GB HBM3 at 700 W the two read 3.9e-3 (gpt-oss-120b) and
# 4.6e-3 (granite-moe) apart
MOE_REL_L2_TOL = 2e-2


def _family_cfg(arch, layers):
    """(config, reduced) of one family: published widths, ``layers``
    (0: all) of its depth."""
    from repro_torch.configs import get
    cfg = get(arch)
    if not layers:
        return cfg, None
    return (dataclasses.replace(cfg, num_layers=layers),
            {"num_layers": [cfg.num_layers, layers]})


def _family_attention_cases(heads, g) -> dict:
    """The attention kernels at one (Hq, Hk, D) of a family (its target's
    or its draft's), each against its plain version in bf16: the prefill
    at batch 4, width 64 with left pads, dense and paged (page 16, a
    shuffled table; equal to dense on the gathered view); the verify at
    T 1 and 4 (chain) and 13 (tree W 4, gamma 3) against a 128-row cache,
    dense and paged (equal to dense on the view).  Returns {kernel name:
    [case, ...]}."""
    from repro_torch.core.paging import gather_view
    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_paged)
    from repro_torch.kernels.flash_attn.ref import (flash_attention_paged_ref,
                                                    flash_attention_ref)
    from repro_torch.kernels.verify_attn.ops import (verify_attention,
                                                     verify_attention_paged,
                                                     verify_route)
    from repro_torch.kernels.verify_attn.ref import (
        verify_attention_paged_ref, verify_attention_ref,
        verify_attention_tree_paged_ref, verify_attention_tree_ref)
    dev = torch.device("cuda")
    hq, hk, d = heads
    B, S, SMAX, P = (FAMILY[k] for k in ("B", "PREFILL_S", "SMAX", "P"))
    tag = f"Hq {hq} Hk {hk} D {d}"

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    n_tbl = SMAX // P
    n_pages = B * n_tbl
    tbl = torch.randperm(n_pages, generator=g, device=dev).to(
        torch.int32).reshape(B, n_tbl).contiguous()
    kpool, vpool = rnd(n_pages + 1, P, hk, d), rnd(n_pages + 1, P, hk, d)
    kc, vc = gather_view(kpool, tbl), gather_view(vpool, tbl)
    pad = torch.tensor([0, 7, 23, 40], dtype=torch.int32, device=dev)
    got = {}
    q = rnd(B, S, hq, d)
    k, v = kc[:, :S].contiguous(), vc[:, :S].contiguous()
    valid = torch.arange(S, device=dev)[None, :] >= pad[:, None]
    for name, out, ref in (
            ("flash_attention", flash_attention(q, k, v, pad),
             flash_attention_ref(q, k, v, pad)),
            ("flash_attention_paged",
             flash_attention_paged(q, kpool, vpool, tbl, pad),
             flash_attention_paged_ref(q, kpool, vpool, tbl, pad))):
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), f"{name} {tag} non-finite"
        err, rel = hold(out[valid], ref[valid], f"{name} {tag}")
        assert not out[~valid].any(), "rows before pad must be zeros"
        if name == "flash_attention_paged":
            assert torch.equal(out, got["_prefill_out"]), \
                f"{name} {tag} != dense kernel on the view"
        got["_prefill_out"] = out
        got[name] = [dict(shape=f"q {tuple(q.shape)} {tag} bf16, pad "
                                f"{pad.tolist()}", max_abs_err=err,
                          rel_l2_err=rel)]
    del got["_prefill_out"]
    ln = torch.tensor([40, 57, 90, 110], dtype=torch.int32, device=dev)
    for t, tree in ((1, None), (4, None), (13, (4, 3))):
        qt = rnd(B, t, hq, d)
        kw = {} if tree is None else {"tree": tree}
        dense = verify_attention(qt, kc, vc, ln, pad, **kw)
        paged = verify_attention_paged(qt, kpool, vpool, tbl, ln, pad, **kw)
        if tree is None:
            ref = verify_attention_ref(qt, kc, vc, ln, pad)
            pref = verify_attention_paged_ref(qt, kpool, vpool, tbl, ln, pad)
        else:
            ref = verify_attention_tree_ref(qt, kc, vc, ln, pad, tree=tree)
            pref = verify_attention_tree_paged_ref(qt, kpool, vpool, tbl, ln,
                                                   pad, tree=tree)
        torch.cuda.synchronize()
        assert torch.equal(dense, paged), \
            f"verify_attention_paged {tag} T={t} != dense kernel on the view"
        for name, out, want in (("verify_attention", dense, ref),
                                ("verify_attention_paged", paged, pref)):
            assert torch.isfinite(out).all(), f"{name} {tag} non-finite"
            err, rel = hold(out, want, f"{name} {tag} T={t}")
            name = name + ("_tree" if tree else "")
            got.setdefault(name, []).append(dict(
                T=t, shape=f"q {tuple(qt.shape)} cache {tuple(kc.shape)} "
                           f"{tag} bf16", path=verify_route(torch.bfloat16, d),
                max_abs_err=err, rel_l2_err=rel))
    return got


def _family_linear_cases(cfg, dcfg, g) -> list:
    """``linear_rows`` at a family's (K, N) of the prefill and the draft
    seed (the router's in fp32; the LM head's N is the vocabulary, 49 155
    for granite-moe): M rows of a refill against the plain version per
    element at BF16_TOL and against float64 as a whole (relative L2 below
    3e-3 in bf16, one rounding of the output; 1e-5 in fp32, as the card
    test), and the first 1, 65 and M - 1 rows equal to the widest
    call's."""
    from repro_torch.kernels.linear_rows.ops import linear_rows
    from repro_torch.kernels.linear_rows.ref import linear_rows_ref
    from repro_torch.models.config import FFN_MOE
    dev = torch.device("cuda")
    d, m = cfg.d_model, FAMILY["M"]
    kn = [("q_proj", d, cfg.num_heads * cfg.head_dim, torch.bfloat16),
          ("k_proj", d, cfg.num_kv_heads * cfg.head_dim, torch.bfloat16),
          ("o_proj", cfg.num_heads * cfg.head_dim, d, torch.bfloat16),
          ("lm_head", d, cfg.vocab_size, torch.bfloat16),
          ("draft_fc", 2 * d, d, torch.bfloat16),
          ("draft_q", d, dcfg.num_heads * dcfg.head_dim, torch.bfloat16),
          ("draft_k", d, dcfg.num_kv_heads * dcfg.head_dim, torch.bfloat16)]
    if any(b.ffn == FFN_MOE for b in cfg.pattern):
        kn.append(("router", d, cfg.num_experts, torch.float32))
    else:
        kn += [("ffn_up", d, cfg.d_ff, torch.bfloat16),
               ("ffn_down", cfg.d_ff, d, torch.bfloat16)]
    cases = []
    for name, k, n, dt in kn:
        x = torch.randn((m, k), generator=g, device=dev).to(dt)
        w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dt)
        full = linear_rows(x, w)
        for rows in (1, 65, m - 1):
            assert torch.equal(linear_rows(x[:rows], w), full[:rows]), \
                f"linear_rows {name} ({k}, {n}): rows move with M = {rows}"
        ref = linear_rows_ref(x, w)
        want = x[:128].double() @ w.double()
        torch.cuda.synchronize()
        assert full.shape == (m, n) and torch.isfinite(full).all()
        torch.testing.assert_close(
            full.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL,
            msg=lambda e: f"linear_rows {name} ({k}, {n}): {e}")
        err = max_err(full[:128].double(), want)
        rel = float((full[:128].double() - want).norm() / want.norm())
        assert rel < (3e-3 if dt == torch.bfloat16 else 1e-5), \
            f"linear_rows {name} ({k}, {n}): rel L2 {rel} vs float64"
        del want
        cases.append(dict(product=name, K=k, N=n, M=m,
                          dtype=str(dt).replace("torch.", ""),
                          rows_equal_across_M=[1, 65, m - 1],
                          max_abs_err=err, rel_l2_err=rel))
    return cases


def _moe_repeatable(cfg, params, g) -> dict:
    """Layer 0's MoE FFN on a refill's worth of tokens, twice: the same
    output and aux bit for bit (the combine adds in a fixed order); and
    against the one-hot einsum oracle in bf16, per element at BF16_TOL
    and as a whole at relative L2 below MOE_REL_L2_TOL.  The first call,
    and one at the chain verify's B x (gamma + 1) rows, run under
    ``torch.cuda.set_sync_debug_mode("error")``: the routing and dispatch
    read nothing back to the host."""
    from repro_torch.models import moe
    from repro_torch.models.param import unflatten
    p = unflatten({k: v[0] for k, v in params["body"]["pos0"]["moe"]
                   .flat().items()})
    x = torch.randn((FAMILY["B"], FAMILY["PREFILL_S"], cfg.d_model),
                    generator=g, device="cuda").to(torch.bfloat16)
    xv = torch.randn((FAMILY["B"], FAMILY["GAMMA"] + 1, cfg.d_model),
                     generator=g, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_sort(cfg, p, xv)
        a, aa = moe.moe_sort(cfg, p, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    b, ab = moe.moe_sort(cfg, p, x)
    ref, _ = moe.moe_einsum(cfg, p, x)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(aa, ab), \
        f"{cfg.name}: moe_sort differs between two runs of one input"
    torch.testing.assert_close(a.float(), ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    err = max_err(a, ref)
    rel = float((a.float() - ref.float()).norm() / ref.float().norm())
    assert rel < MOE_REL_L2_TOL, f"{cfg.name} moe_sort vs einsum: {rel}"
    n = x.shape[0] * x.shape[1]
    idx, _, _ = moe._route(cfg, p, x.reshape(n, -1))
    keep = moe.dispatch(cfg, idx, n)["keep"]
    return {"tokens": n, "capacity": moe._capacity(cfg, n),
            "dropped": int((~keep).sum()), "assignments": keep.numel(),
            "equal_twice": True, "no_host_sync": True,
            "vs_einsum_max_abs_err": err,
            "vs_einsum_rel_l2_err": rel}


def _family_cobatch(eng, prompts) -> dict:
    """The cobatch check (``phase_cobatch``) on a family: its shortest
    prompt refilled alone and beside its longest."""
    from repro_torch.obs.cobatch import cobatch_diff
    from repro_torch.serving.request import Request
    short, long_ = min(prompts, key=len), max(prompts, key=len)

    def batch(ps):
        reqs = [Request(prompt=list(p), max_new_tokens=1) for p in ps]
        for i, r in enumerate(reqs):
            r.sid = i
        return eng._refill_arrays(list(enumerate(reqs)))[:2]

    d = cobatch_diff(eng.cfg, eng.params, (*batch([short]), 0),
                     (*batch([long_, short]), 1))
    return {"verdict": d["first_departing_op"] or "none",
            "first_max_abs_diff": d["first_max_abs_diff"],
            "departing_alone_count": len(d["departing_alone"]),
            "departing_alone": d["departing_alone"][:8],
            "argmax_equal": d["argmax_equal"],
            "logits_max_abs_diff": d["logits_max_abs_diff"],
            "prompt_len": d["prompt_len"], "batch_b": d["batch_b"]}


def phase_families():
    """The families in a process of its own (``chip_smoke.py
    --families``), one at a time, each freed before the next: built at
    full width from a seed with its EAGLE-3 draft, served dense and
    paged (FAMILY), its kernels held at its own shapes, its MoE combine
    run twice, and (COBATCH_FAMILIES) its cobatch verdict.  One JSON line
    a family, then the launches of all its serves."""
    from repro_torch.core import eagle
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.models import transformer as T
    from repro_torch.models.config import FFN_MOE
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    dev = torch.device("cuda")
    total = {}
    for arch, layers in FAMILIES:
        t_start = time.perf_counter()
        cfg, reduced = _family_cfg(arch, layers)
        dcfg = eagle.draft_config(cfg)
        t0 = time.perf_counter()
        params = T.init(cfg, 0, device=dev)
        dparams = eagle.draft_init(dcfg, 1, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = [r.prompt for r in _requests(
            np.random.default_rng(11), FAMILY["N"], FAMILY["LO"],
            FAMILY["HI"], FAMILY["NEW"], cfg.vocab_size)]
        serves, streams = {}, {}
        for kind, page in (("dense", 0), ("paged", FAMILY["P"])):
            from repro_torch.serving.request import Request
            conf = ServingConfig(batch_size=FAMILY["B"],
                                 max_len=FAMILY["SMAX"],
                                 gamma=FAMILY["GAMMA"], superstep_rounds=8,
                                 page_size=page)
            eng = ServingEngine(cfg, params, dcfg, dparams, config=conf,
                                device=dev,
                                extractor=SignalExtractor(SignalStore()))
            reqs = [Request(prompt=list(p), max_new_tokens=FAMILY["NEW"])
                    for p in prompts]
            summary, launches = _timed_serve(eng, reqs)
            streams[kind] = [list(r.generated) for r in reqs]
            need = ("flash_attention", "verify_attention", "extract_pack",
                    "linear_rows") if not page else (
                "flash_attention_paged", "verify_attention_paged",
                "extract_pack", "linear_rows")
            for name in need:
                assert launches[name] > 0, (arch, kind, name, launches)
            for name, n in launches.items():
                if isinstance(n, int):
                    total[name] = total.get(name, 0) + n
            if page:
                eng.release_prefix_cache()
                eng.allocator.assert_clean()
            serves[kind] = {k: summary[k] for k in (
                "tokens_per_s", "wall_s", "superstep_ms_median",
                "supersteps", "rounds", "spec_rounds", "mean_accept_len",
                "host_syncs_per_superstep", "max_memory_allocated_GB")}
            serves[kind]["prefill_ms"] = [
                ms for _, _, ms in summary["prefill_rows_width_ms"]]
            serves[kind]["prefill_rows_width"] = [
                [r, w] for r, w, _ in summary["prefill_rows_width_ms"]]
            serves[kind]["launches"] = launches
            if arch in COBATCH_FAMILIES and not page:
                cob = _family_cobatch(eng, prompts)
            del eng
        assert streams["paged"] == streams["dense"], \
            f"{arch}: paged streams != dense streams"
        g = torch.Generator(device=dev).manual_seed(7)
        heads = {(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
                 (dcfg.num_heads, dcfg.num_kv_heads, dcfg.head_dim)}
        kernels = {}
        for h in sorted(heads):
            for name, cases in _family_attention_cases(h, g).items():
                kernels.setdefault(name, []).extend(cases)
        kernels["linear_rows"] = _family_linear_cases(cfg, dcfg, g)
        is_moe = any(b.ffn == FFN_MOE for b in cfg.pattern)
        # the bytes one target forward reads: every weight but the
        # embedding (a MoE layer's every expert: the batched product reads
        # all E weight slices, filled or not)
        wbytes = 2 * (cfg.param_count() - cfg.vocab_size * cfg.d_model)
        row = {"phase": "families", "model": cfg.name, "arch": arch,
               "reduced": reduced, "layers": cfg.num_layers,
               "ffn": sorted({b.ffn for b in cfg.pattern}),
               "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
               "draft_heads": [dcfg.num_heads, dcfg.num_kv_heads,
                               dcfg.head_dim],
               "params_B": cfg.param_count() / 1e9,
               "params_B_published": _family_cfg(arch, 0)[0].param_count()
               / 1e9,
               "active_params_B": cfg.active_param_count() / 1e9,
               "draft_params_B": eagle.draft_param_count(dcfg) / 1e9,
               "init_s": init_s, "requests": len(prompts),
               "prompt_lens": [len(p) for p in prompts],
               "new_tokens": FAMILY["NEW"],
               "target_read_GB": wbytes / 1e9,
               "verify_bound_ms": wbytes / HBM_BYTES_PER_S * 1e3,
               "dense": serves["dense"], "paged": serves["paged"],
               "paged_streams_equal_dense": True,
               "tokens_per_s": serves["dense"]["tokens_per_s"],
               "superstep_ms": serves["dense"]["superstep_ms_median"],
               "prefill_ms": statistics.median(serves["dense"]["prefill_ms"]),
               "max_memory_allocated_GB":
                   max(s["max_memory_allocated_GB"] for s in serves.values()),
               "kernels": kernels}
        if is_moe:
            row["moe"] = _moe_repeatable(cfg, params, g)
        if arch in COBATCH_FAMILIES:
            row["cobatch"] = cob
        row["seconds"] = time.perf_counter() - t_start
        row["nvidia_smi"] = smi()
        emit(row)
        if arch in COBATCH_FAMILIES and COBATCH_FAMILIES[arch]:
            assert cob["verdict"] == "none", \
                f"{arch}: {cob['verdict']} departs with the refill batch"
            assert not cob["departing_alone"], cob["departing_alone"]
        del params, dparams
        _free()
    emit({"phase": "families", "step": "total", "launches": total})


def phase_families_apart():
    """The families phase in a process of its own (``chip_smoke.py
    --families``), run before the parent makes any engine: each family
    needs the card's memory (gpt-oss-120b at 8 layers ~55 GB with its
    draft).  Forwards its JSON lines and returns its launches."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--families"], stdout=subprocess.PIPE,
                          timeout=600, check=True)
    total = None
    for line in proc.stdout.decode().splitlines():
        if not line.startswith("{"):
            print(line, file=sys.stderr)
            continue
        row = json.loads(line)
        if row.get("step") == "total":
            total = row["launches"]
        emit(row)
    emit({"phase": "families", "step": "seconds",
          "seconds": time.perf_counter() - t0})
    return total


# the pad-shift placements (repro_torch.obs.cobatch.placed_rows) each
# kernel row is held to; extract_pack and linear_rows have no pad
SHIFT_KINDS_OF = {
    "flash_attention": ("prefill",), "flash_attention_paged": ("prefill_paged",),
    "verify_attention": ("verify4", "verify1"),
    "verify_attention_paged": ("verify_paged4", "verify_paged1"),
    "verify_attention_tree": ("tree",),
    "verify_attention_paged_tree": ("tree_paged",), "extract_pack": (),
    "linear_rows": (), "flash_attention_bwd": (), "threefry2x32": (),
    "categorical_rows": ()}

# glm4-9b's (name, K, N) of the prefill's products
LINEAR_KN = (("k_proj", 4096, 256), ("q_proj/o_proj", 4096, 4096),
             ("ffn_up/gate", 4096, 13696), ("ffn_down", 13696, 4096),
             ("lm_head", 4096, 151552))
# (4, 16 and 96: the launch phase's serve, batch 4 at T 1 and 4 and its
# refill of 4 x 24)
LINEAR_M = (1, 2, 4, 16, 63, 64, 65, 96, 126, 127, 128, 129, 992, 3968)


def _linear_rows_row(g):
    """linear_rows at glm4-9b's (K, N): every row of x gives the same
    row, bit for bit, at each M of LINEAR_M (the first M rows of one x,
    and the M rows after its first); a one-hot x (row r picks row r mod
    K of w) gives those rows of w exactly; error against float64 on 128
    rows and at most 4096 columns; time against torch.matmul (the plain
    version, and the library call) at M 3968 and 128.  The row's
    headline is ffn_down at M 3968 (a refill of 8 x 496 rows)."""
    from repro_torch.kernels.linear_rows import ops
    from repro_torch.kernels.linear_rows.ops import k_splits, linear_rows
    from repro_torch.kernels.linear_rows.ref import linear_rows_ref
    dev = torch.device("cuda")
    bf = torch.bfloat16
    top_m = max(LINEAR_M)
    tile = ops.tile()
    assert (tile["BN"], tile["BK"]) == (ops.BLOCK_N, ops.BLOCK_K), \
        f"linear_rows: k_splits counts {ops.BLOCK_N} x {ops.BLOCK_K}, " \
        f"the kernel's tile is {tile}"
    cases = []
    for name, k, n in LINEAR_KN:
        x = torch.randn((top_m + 1, k), generator=g, device=dev).to(bf)
        w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(bf)
        full = linear_rows(x, w)
        for m in LINEAR_M:
            assert torch.equal(linear_rows(x[:m], w), full[:m]), \
                f"linear_rows {name}: rows move with M = {m}"
            assert torch.equal(linear_rows(x[1:m + 1], w), full[1:m + 1]), \
                f"linear_rows {name}: rows move with a shift at M = {m}"
        rows = torch.arange(top_m + 1, device=dev) % k
        onehot = torch.zeros_like(x)
        onehot[torch.arange(top_m + 1, device=dev), rows] = 1
        assert torch.equal(linear_rows(onehot, w), w[rows]), \
            f"linear_rows {name}: one-hot rows are not w's rows"
        del onehot, rows
        cols = slice(0, min(n, 4096))
        want = x[:128].double() @ w[:, cols].double()
        got = full[:128, cols].double()
        torch.cuda.synchronize()
        assert torch.isfinite(full).all(), f"linear_rows {name} non-finite"
        rel = float((got - want).norm() / want.norm())
        assert rel < 3e-3, f"linear_rows {name}: rel L2 {rel} vs float64"
        case = dict(product=name, K=k, N=n, k_splits=k_splits(n, k),
                    rows_equal_across_M=list(LINEAR_M), shift_equal=True,
                    one_hot_exact=True, rel_l2_vs_f64=rel,
                    max_abs_err=float((got - want).abs().max()))
        for m in (top_m, 128):
            xm = x[:m]
            b_ms, b_by = bound(2 * (m * k + k * n + m * n), 2.0 * m * n * k)
            case[f"M{m}"] = dict(
                **kernel_ms(partial(linear_rows, xm, w)),
                plain_ms=cuda_ms(lambda: linear_rows_ref(xm, w)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(lambda: torch.matmul(xm, w)))
        cases.append(case)
        del x, w, full
    head = next(c for c in cases if c["product"] == "ffn_down")
    top = head[f"M{top_m}"]
    return dict(name="linear_rows", route="cuda",
                source="src/repro_torch/csrc/linear_rows.cu",
                replaces="none: no Pallas kernel; the products of "
                         "src/repro/models/attention.py:373 qkv_proj and the "
                         "FFN, which XLA computes",
                path="wgmma_tma",
                tile=tile,
                k_splits={c["product"]: c["k_splits"] for c in cases},
                max_abs_err=max(c["max_abs_err"] for c in cases),
                rel_l2_err=max(c["rel_l2_vs_f64"] for c in cases),
                **top, library="torch.matmul (also the plain version)",
                shape=f"ffn_down x ({top_m}, {head['K']}) @ w "
                      f"({head['K']}, {head['N']}) bf16", cases=cases)


# the sampling kernels' operation counts an element, for their bound: the
# threefry hash is 80 32-bit integer operations (4 key-schedule adds and
# xors, 20 rounds of add, rotate and xor, 5 injections of 3 adds); the
# draw adds ~10 float32 operations (the uniform's shift, or, subtract and
# clamp, two logf counted as one each, the add and the compare).  An H100
# SM issues 64 32-bit integer operations a clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0): 132
# SMs x 64 x 1.98 GHz = 16.7 T/s; float32 runs at the card's non-tensor
# rate (67 T/s).  The two kinds issue side by side, so the operations'
# bound is the larger of the two times.
HASH_OPS, DRAW_F32_OPS = 80, 10
INT32_OPS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 67e12
SAMPLE_V = 151552               # glm4-9b's vocabulary
LEVIATHAN_LANES = 4000
# the Leviathan check's 8 live tokens (spread over the vocabulary and its
# kernel's chunks) and their target and draft logits (as
# tests/test_speculative.py:88); every other token sits at -30
LEVIATHAN_IDS = (3, 2047, 2048, 40000, 75776, 100001, 151000, 151551)
LEVIATHAN_T = (0.5, 2.0, -1.0, 0.0, 1.0, -2.0, 0.3, 0.7)
LEVIATHAN_D = (2.0, -1.0, 0.5, 1.5, -0.5, 0.0, 1.0, -2.0)


def _sample_bound(nbytes: float, int_ops: float, f32_ops: float = 0.0):
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    op = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return (mem, "bytes") if mem >= op else (op, "operations")


def _sample_rows(g):
    """The sampling kernels (csrc/threefry_sample.cu) against their plain
    versions: threefry2x32 bit for bit at R 8 and N 1, 3, 4 and 151 552;
    categorical_rows at (8, 151 552) and (32, 151 552) on random and on
    peaked logits, token for token except where the plain version's top
    two of logits + gumbel lie within 4 eps32 max|logits + gumbel| (such
    rows counted as near_tie_rows); then the Leviathan check at the full
    vocabulary (``_leviathan``).  Returns the two rows."""
    from repro_torch.kernels.sample.ops import categorical_rows, threefry2x32
    from repro_torch.kernels.sample.ref import (near_tie_rows,
                                                perturbed_rows_ref,
                                                threefry2x32_ref)
    dev = torch.device("cuda")

    def words(*shape):
        return torch.randint(0, 2 ** 32, shape, generator=g, device=dev,
                             dtype=torch.int64)
    tcases = []
    for n in (1, 3, 4, SAMPLE_V):
        keys, ctr = words(8, 2), words(8, n, 2)
        got = threefry2x32(keys, ctr)
        torch.cuda.synchronize()
        assert torch.equal(got, threefry2x32_ref(keys, ctr)), \
            f"threefry2x32 N={n} differs from its plain version"
        b_ms, b_by = _sample_bound(8 * (2 * 8 + 4 * 8 * n), HASH_OPS * 8 * n)
        tcases.append(dict(
            R=8, N=n, equal=True,
            **kernel_ms(partial(threefry2x32, keys, ctr), iters=50),
            plain_ms=cuda_ms(lambda: threefry2x32_ref(keys, ctr), iters=5),
            bound_ms=b_ms, bound_by=b_by))
    head = tcases[1]                    # N = gamma: the draft step keys
    trow = dict(name="threefry2x32", route="cuda",
                source="src/repro_torch/csrc/threefry_sample.cu",
                replaces="none: no Pallas kernel; jax.random.fold_in, split "
                         "and uniform (threefry2x32) in jnp code, "
                         "src/repro/core/speculative.py:65-70, 355-360, "
                         "812-815",
                max_abs_err=0.0,
                **{k: head[k] for k in ("ms", "device_ms", "host_ms",
                                        "plain_ms", "bound_ms", "bound_by")},
                library_ms=None,
                library="none: no PyTorch call computes JAX's threefry",
                shape="keys (8, 2), counters (8, 3, 2) int64 words",
                cases=tcases)
    ccases = []
    for r, peaked in ((8, False), (8, True), (32, False), (32, True)):
        keys = words(r, 2)
        lg = torch.randn((r, SAMPLE_V), generator=g, device=dev) * 3
        if peaked:
            lg = torch.full_like(lg, -30.0)
            lg[:, list(LEVIATHAN_IDS)] = torch.randn((r, 8), generator=g,
                                                     device=dev)
        got = categorical_rows(keys, lg)
        z = perturbed_rows_ref(keys, lg)
        want = z.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        ties = near_tie_rows(z)
        differ = got != want
        assert not (differ & ~ties).any(), \
            f"categorical_rows ({r}, {SAMPLE_V}) differs off a near-tie"
        b_ms, b_by = _sample_bound(4 * r * SAMPLE_V + 16 * r + 4 * r,
                                   HASH_OPS * r * SAMPLE_V,
                                   DRAW_F32_OPS * r * SAMPLE_V)
        ccases.append(dict(
            R=r, V=SAMPLE_V, logits="peaked" if peaked else "random",
            tokens_differing=int(differ.sum()),
            near_tie_rows=int(ties.sum()),
            **kernel_ms(partial(categorical_rows, keys, lg)),
            plain_ms=cuda_ms(lambda: perturbed_rows_ref(keys, lg).argmax(-1),
                             iters=5),
            bound_ms=b_ms, bound_by=b_by))
        del lg, z
    head = ccases[0]
    crow = dict(name="categorical_rows", route="cuda",
                source="src/repro_torch/csrc/threefry_sample.cu",
                replaces="none: no Pallas kernel; jax.random.categorical in "
                         "jnp code, src/repro/core/speculative.py:88-90, "
                         "234-236, 519-522, src/repro/core/eagle.py:228-231",
                max_abs_err=0.0,
                **{k: head[k] for k in ("ms", "device_ms", "host_ms",
                                        "plain_ms", "bound_ms", "bound_by")},
                library_ms=None,
                library="none: no single PyTorch call draws JAX's "
                        "categorical",
                shape=f"keys (8, 2), logits (8, {SAMPLE_V}) fp32",
                cases=ccases, leviathan=_leviathan())
    return [trow, crow]


def _leviathan() -> dict:
    """Leviathan's check at the full vocabulary, on the card's kernels:
    fixed target and draft logits (mass on LEVIATHAN_IDS, the rest at
    -30) for 4000 lanes of per-lane keys; the draft drawn as the engine
    draws it (``eagle.draft_propose_tree``: branch 0 a sampled chain,
    step j with fold_in(key, j), sibling roots greedy over the masked
    logits), then ``verify_sample`` (the chain) and ``verify_tree_sample``
    at W 2.  The committed first tokens' histogram must lie within the
    JAX test's bound (tests/test_speculative.py:88: 0.035) of the exact
    law of that token (``tree_first_token_law``): for the chain, the
    target's softmax; for the tree, the reference algorithm's law, whose
    distance from the softmax is reported (``law_vs_softmax``)."""
    from repro_torch.core import prng
    from repro_torch.core import speculative as spec
    from repro_torch.kernels.sample import ops as sample
    from repro_torch.kernels.sample.ref import tree_first_token_law
    dev = torch.device("cuda")
    ids = torch.tensor(LEVIATHAN_IDS, device=dev)
    t = torch.full((SAMPLE_V,), -30.0, device=dev)
    d = torch.full((SAMPLE_V,), -30.0, device=dev)
    t[ids] = torch.tensor(LEVIATHAN_T, device=dev)
    d[ids] = torch.tensor(LEVIATHAN_D, device=dev)
    keys = prng.split(prng.key(0, dev), LEVIATHAN_LANES)
    out = {}
    for w in (1, 2):
        law = tree_first_token_law(t.cpu(), d.cpu(), w)[ids.cpu()]
        first = []
        for lo in range(0, LEVIATHAN_LANES, 500):
            kk = sample.fold_in_each(keys[lo:lo + 500], 2)
            n = kk.shape[0]
            sk = sample.fold_in_each(kk[:, 0], GLM["GAMMA"])
            dn = d.expand(n, SAMPLE_V)
            toks = [torch.stack([sample.categorical_rows(sk[:, j], dn)
                                 for j in range(GLM["GAMMA"])], dim=1)]
            dlog = [d.expand(n, GLM["GAMMA"], SAMPLE_V)]
            masked = dn.clone()
            for _ in range(1, w):
                masked.scatter_(1, toks[-1][:, :1].long(), -1e30)
                root = masked.argmax(-1).to(torch.int32)
                rest = torch.full((n, GLM["GAMMA"] - 1), int(d.argmax()),
                                  dtype=torch.int32, device=dev)
                toks.append(torch.cat([root[:, None], rest], dim=1))
                dlog.append(torch.cat([masked[:, None], dlog[0][:, 1:]],
                                      dim=1))
            tl = t.expand(n, w * GLM["GAMMA"] + 1, SAMPLE_V)
            if w == 1:
                na, bonus = spec.verify_sample(None, tl, dlog[0], toks[0],
                                               keys=kk[:, 1])
                sel = torch.zeros_like(na)
            else:
                na, sel, bonus = spec.verify_tree_sample(
                    None, tl, torch.stack(dlog, 1), torch.stack(toks, 1),
                    keys=kk[:, 1])
            tree = torch.stack(toks, 1)
            first.append(torch.where(
                na > 0, tree[torch.arange(n, device=dev), sel.long(), 0],
                bonus))
            del masked, dlog, tl
        first = torch.cat(first)
        torch.cuda.synchronize()
        hist = torch.stack([(first == i).sum() for i in ids]).double().cpu()
        emp = hist / LEVIATHAN_LANES
        dev_law = float((emp - law).abs().max())
        soft = torch.softmax(torch.tensor(LEVIATHAN_T, dtype=torch.float64),
                             dim=0)
        assert int(hist.sum()) == LEVIATHAN_LANES, "a token off the 8 live"
        assert dev_law < 0.035, \
            f"Leviathan W={w}: histogram {emp.tolist()} vs law {law.tolist()}"
        out[f"W{w}"] = dict(lanes=LEVIATHAN_LANES,
                            max_dev_from_law=dev_law,
                            max_dev_from_softmax=float(
                                (emp - soft).abs().max()),
                            law_vs_softmax=float((law - soft).abs().max()))
    return out


def _sdpa_bwd(q, k, v, do):
    """The autograd backward of one causal GQA
    ``scaled_dot_product_attention`` call (yardstick only): a function
    computing (dq, dk, dv) from the saved graph."""
    import torch.nn.functional as F
    qq, kk, vv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    gdo = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qq, kk, vv), gdo,
                                       retain_graph=True)


def _flash_bwd_row(g):
    """flash_attention_bwd at the glm4-9b training shapes (batch 8, 32/2
    heads, D 128, bf16: the draft's and the target's) at S 62 (the train
    phase's), 512, 64 and 47 (the launch phase's target steps, launch/train
    and pretrain_target): each
    gradient held against its plain version, two calls equal, a lane's
    gradients equal alone and as lanes 0 and 5 of the batch, the
    LSE-storing forward equal to the serving forward; the error of a
    one-bf16 P and dS emulation beside the kernel's; timed, and each of
    its three passes (dQ with delta, dK/dV, the reduce of the splits) on
    the device clock, against the autograd backward of SDPA on both
    clocks; the dK/dV launch's grid read from the profiler's trace
    (``_bwd_blocks`` holds it to the schedule).  The row's numbers are
    S 62's."""
    from repro_torch.kernels.flash_attn.ops import (bwd_schedule, bwd_tile,
                                                    flash_attention,
                                                    flash_attention_bwd)
    from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                    flash_attention_lse_ref)
    from repro_torch.obs.timing import Deferred, launch_grids
    dev = torch.device("cuda")
    B, HQ, HK, D = (GLM[k] for k in ("B", "HQ", "HK", "D"))
    cases = []
    for s in (GLM["TRAIN_WINDOW"] - 1, GLM["S"], 64, 47):
        q, do = (torch.randn((B, s, HQ, D), generator=g, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, s, HK, D), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = flash_attention(q, k, v, return_lse=True)
        served = flash_attention(q, k, v)
        first = flash_attention_bwd(q, k, v, o, do, lse)
        again = flash_attention_bwd(q, k, v, o, do, lse)
        alone = {lane: flash_attention_bwd(
            *(t[lane:lane + 1].contiguous() for t in (q, k, v, o, do, lse)))
            for lane in (0, 5)}
        torch.cuda.synchronize()
        assert torch.equal(o, served), "the LSE store changed the forward"
        assert all(torch.equal(a, b) for a, b in zip(first, again)), \
            "flash_attention_bwd differs between two calls"
        for lane, grads in alone.items():
            assert all(torch.equal(a[0], b[lane])
                       for a, b in zip(grads, first)), \
                f"flash_attention_bwd: lane {lane} alone != in the batch"
        lse_err = float((lse - flash_attention_lse_ref(q, k)).abs().max())
        assert lse_err < 1e-4, f"LSE error {lse_err}"
        want = flash_attention_bwd_ref(q, k, v, o, do, lse)
        errs = {}
        for name, x, y in zip(("dq", "dk", "dv"), first, want):
            assert torch.isfinite(x).all(), f"{name} non-finite"
            errs[name] = hold(x, y, f"flash_attention_bwd {name} S={s}")
        # causal (row, key) pairs of every query head
        vis = B * HQ * s * (s + 1) // 2
        # q, o, dO read and dq written (q-sized, bf16), k, v read and dk,
        # dv written, the LSE read (fp32)
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        # the score recompute and the four products dV, dP, dQ, dK
        b_ms, b_by = bound(nbytes, 5 * 2.0 * vis * D)
        call = partial(flash_attention_bwd, q, k, v, o, do, lse)
        sdpa = _sdpa_bwd(q, k, v, do)
        cases.append(dict(
            S=s, lse_forward_equal=True, equal_twice=True,
            lane_equal_alone=[0, 5],
            dkdv_blocks_scheduled=len(bwd_schedule(
                s, HQ // HK, **bwd_tile())[0]) * HK * B,
            # the dK/dV launch's grid as the profiler's trace records it
            dkdv_grid=Deferred(call, ("flash_bwd_dkdv",), 1,
                               read=launch_grids),
            lse_max_abs_err=lse_err,
            max_abs_err=max(e[0] for e in errs.values()),
            rel_l2_err={n: e[1] for n, e in errs.items()},
            pbf16_dsbf16_rel_l2_emulated=_bwd_bf16_rel_l2(
                q, k, v, o, do, lse, want),
            **kernel_ms(call),
            device_ms_passes={p: Deferred(call, (f"flash_bwd_{p}",), 20)
                              for p in ("dq", "dkdv", "reduce")},
            plain_ms=cuda_ms(lambda: flash_attention_bwd_ref(
                q, k, v, o, do, lse), iters=5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(sdpa),
            # every kernel the library call launches
            library_device_ms=Deferred(sdpa, ("",), 20)))
        del first, again, alone, want
    head = cases[0]
    return dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attn_bwd.cu",
        replaces="none: no Pallas kernel has a backward (JAX differentiates "
                 "the jnp attention of src/repro/core/eagle.py:100 "
                 "_layer_full)",
        path="mma_bf16_split_rows",
        max_abs_err=max(c["max_abs_err"] for c in cases),
        **{k: head[k] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "library_device_ms")},
        library="autograd backward of scaled_dot_product_attention("
                "is_causal=True, enable_gqa=True)",
        shape=f"q {(B, head['S'], HQ, D)} kv {(B, head['S'], HK, D)} bf16, "
              "causal, no pad", cases=cases)


def _bwd_blocks(row):
    """After ``resolve``: each case's dK/dV blocks from the grid of its one
    dK/dV launch a call, equal to the schedule's count, and at least one
    wave of the card (128 of 132 SMs) at the train phase's S."""
    for case in row["cases"]:
        grids = case["dkdv_grid"]
        assert len(grids) == 1, f"dK/dV launches a call: {grids}"
        x, y, z = grids[0]
        case["dkdv_blocks"] = x * y * z
        assert case["dkdv_blocks"] == case["dkdv_blocks_scheduled"], case
    row["dkdv_blocks"] = row["cases"][0]["dkdv_blocks"]
    assert row["dkdv_blocks"] >= 128, row["dkdv_blocks"]


def _bwd_bf16_rel_l2(q, k, v, o, do, lse, want) -> dict:
    """Relative L2 error per gradient, against the plain version
    (``want``), of the same backward with P and dS each rounded to one
    bf16 before the products that take them (dV = P^T.dO, dK = dS^T.Q,
    dQ = dS.K), float64 otherwise: what the tensor-core products would
    read without the hi/lo pairs the kernel feeds them."""
    import math
    b, s, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    qr = q.double().reshape(b, s, hk, g, d)
    dor = do.double().reshape(b, s, hk, g, d)
    kd, vd = k.double(), v.double()
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    lse_r = lse.double().reshape(b, s, hk, g).permute(0, 2, 3, 1)[..., None]
    p = torch.exp(torch.einsum("btkgd,bskd->bkgts", qr, kd) * scale - lse_r)
    p = p.masked_fill(~causal, 0.0)
    delta = (do.double() * o.double()).sum(-1).reshape(b, s, hk, g)
    ds = p * (torch.einsum("btkgd,bskd->bkgts", dor, vd)
              - delta.permute(0, 2, 3, 1)[..., None])
    p1 = p.to(torch.bfloat16).double()
    ds1 = ds.to(torch.bfloat16).double()
    del p, ds
    got = (torch.einsum("bkgts,bskd->btkgd", ds1, kd).reshape(b, s, hq, d)
           * scale,
           torch.einsum("bkgts,btkgd->bskd", ds1, qr) * scale,
           torch.einsum("bkgts,btkgd->bskd", p1, dor))
    out = {}
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        x, y = x.to(torch.bfloat16).float(), y.float()
        out[name] = float((x - y).norm() / y.norm())
    return out


def _pad_shift_equal(kinds) -> bool:
    """One lane's prompt (150 rows, glm4-9b heads, bf16) at pads 0, 5,
    17, 31, 32, 100 of batch rows 0 and 40 wider, beside other lanes:
    its rows of each kernel must be equal bit for bit."""
    from repro_torch.obs.cobatch import lane_inputs, pad_shift_departure
    lane = lane_inputs(150, GLM["HQ"], GLM["HK"], GLM["D"], torch.bfloat16,
                       torch.device("cuda"), 81)
    for kind in kinds:
        moved = pad_shift_departure(kind, lane, extras=(0, 40))
        assert moved is None, \
            f"{kind}: a lane's rows moved with its pad at (pad, +) {moved}"
    return True


def _p_bf16_rel_l2(q, k, v, mask, ref, valid) -> float:
    """Relative L2 error, against the plain version, of the same
    attention with P rounded to bf16 before P·V (the row sums kept in
    fp32): what a tensor-core P·V with one bf16 P would read.  The
    kernel splits P into two bf16 halves instead."""
    import math
    g = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    sc = torch.einsum("bthd,bshd->bhts", q.float(), kf) / math.sqrt(q.shape[3])
    sc = sc.masked_fill(~mask[:, None], float("-inf"))
    mx = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx)))
    p = p.masked_fill(~mask[:, None], 0.0)
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", p.to(torch.bfloat16).float(), vf)
    out = (out / torch.where(den > 0, den, torch.ones_like(den)).transpose(1, 2)
           ).to(q.dtype)
    a, b = out[valid].float(), ref[valid].float()
    return float((a - b).norm() / b.norm())


def _tree_rows(rnd, kc, vc, pad, kpool, vpool, table):
    """The verify kernels' tree mode (the target verify of a tree round):
    W = 4 branches of depth 3, T = 13 rows, at the verify shapes above,
    dense and paged (on the paged section's shuffled pools), against the
    plain version; W = 1 bit for bit against the chain kernel and the
    paged tree bit for bit against the dense tree on the gathered view.
    Then a window > 0 sweep at a small width.  The library yardstick is
    scaled_dot_product_attention with the explicit tree mask."""
    from repro_torch.core.paging import gather_view
    from repro_torch.kernels.verify_attn.ops import (verify_attention,
                                                     verify_attention_paged,
                                                     verify_route)
    from repro_torch.kernels.verify_attn.ref import (
        tree_mask, verify_attention_tree_paged_ref, verify_attention_tree_ref)
    dev = kc.device
    B, SMAX, HQ, HK, D, P = (GLM[k] for k in ("B", "SMAX", "HQ", "HK", "D",
                                              "P"))
    W, G = GLM["TREE_W"], GLM["GAMMA"]
    T = W * G + 1
    ln = torch.tensor([600, 517, 812, 1000, 64, 256, 700, 333],
                      dtype=torch.int32, device=dev)
    pd = torch.minimum(pad, ln)
    qt = rnd(B, T, HQ, D)
    tmask = tree_mask(ln, (W, G), SMAX, pd)
    nvis = tmask.sum().item() * HQ
    span = (torch.clamp(ln + T, max=SMAX) - pd).clamp(min=0).sum().item()
    kv_bytes = 2 * 2 * span * HK * D
    b_ms, b_by = bound(2 * 2 * qt.numel() + kv_bytes + 8 * B, 4.0 * nvis * D)

    o = verify_attention(qt, kc, vc, ln, pd, tree=(W, G))
    r = verify_attention_tree_ref(qt, kc, vc, ln, pd, tree=(W, G))
    q1 = qt[:, :G + 1].contiguous()
    one = verify_attention(q1, kc, vc, ln, pd, tree=(1, G))
    chain = verify_attention(q1, kc, vc, ln, pd)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all(), "tree verify wrote non-finite"
    assert torch.equal(one, chain), "tree W=1 != chain kernel"
    err, rel = hold(o, r, "verify_attention tree")
    dense_row = dict(
        name="verify_attention_tree", route="cuda",
        source="src/repro_torch/csrc/verify_attn.cu (prefill_rows.cuh tree "
               "mode)",
        replaces="src/repro/kernels/verify_attn/kernel.py:27",
        verify_path=verify_route(qt.dtype, D),
        max_abs_err=err, rel_l2_err=rel, w1_equal_chain=True,
        **kernel_ms(partial(verify_attention, qt, kc, vc, ln, pd,
                            tree=(W, G))),
        plain_ms=cuda_ms(lambda: verify_attention_tree_ref(
            qt, kc, vc, ln, pd, tree=(W, G)), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: _sdpa(qt, kc, vc, tmask)),
        shape=f"tree=({W},{G}) q {tuple(qt.shape)} cache {tuple(kc.shape)} "
              "bf16")

    need = torch.clamp(-(-(ln + T) // P), max=SMAX // P)
    tb = table(need)
    pages = (need - pd // P).clamp(min=0).sum().item()
    po = verify_attention_paged(qt, kpool, vpool, tb, ln, pd, tree=(W, G))
    pr = verify_attention_tree_paged_ref(qt, kpool, vpool, tb, ln, pd,
                                         tree=(W, G))
    kv_k, kv_v = gather_view(kpool, tb), gather_view(vpool, tb)
    pdense = verify_attention(qt, kv_k, kv_v, ln, pd, tree=(W, G))
    torch.cuda.synchronize()
    assert torch.isfinite(po).all(), "paged tree verify wrote non-finite"
    assert torch.equal(po, pdense), "paged tree != dense tree on the view"
    perr, prel = hold(po, pr, "verify_attention_paged tree")
    pb_ms, pb_by = bound(2 * 2 * qt.numel() + kv_bytes + 4 * pages + 8 * B,
                         4.0 * nvis * D)
    paged_row = dict(
        name="verify_attention_paged_tree", route="cuda",
        source="src/repro_torch/csrc/verify_attn_paged.cu "
               "(prefill_rows.cuh tree mode)",
        replaces="src/repro/kernels/verify_attn/kernel.py:134",
        verify_path=verify_route(qt.dtype, D),
        max_abs_err=perr, rel_l2_err=prel, equal_dense=True,
        **kernel_ms(partial(verify_attention_paged, qt, kpool, vpool, tb,
                            ln, pd, tree=(W, G))),
        plain_ms=cuda_ms(lambda: verify_attention_tree_paged_ref(
            qt, kpool, vpool, tb, ln, pd, tree=(W, G)), iters=5),
        bound_ms=pb_ms, bound_by=pb_by,
        library_ms=cuda_ms(lambda: _sdpa(qt, gather_view(kpool, tb),
                                         gather_view(vpool, tb), tmask)),
        library="pool[tbl] gather + scaled_dot_product_attention (2 calls)",
        shape=f"tree=({W},{G}) q {tuple(qt.shape)} pools "
              f"{tuple(kpool.shape)} bf16")

    # window > 0 at a small width (glm4-9b has no window): the tree
    # window compares logical positions, so its lower key bound is not
    # the chain's
    g = torch.Generator(device=dev).manual_seed(7)
    sweep = []
    for w, gam, window in ((2, 4, 6), (4, 2, 5), (4, 3, 8), (1, 3, 4)):
        t = w * gam + 1
        b, hq, hk, d, smax, pg = 4, 8, 2, 64, 256, 16
        q = torch.randn((b, t, hq, d), generator=g, device=dev).to(kc.dtype)
        k = torch.randn((b, smax, hk, d), generator=g, device=dev).to(kc.dtype)
        v = torch.randn((b, smax, hk, d), generator=g, device=dev).to(kc.dtype)
        lw = torch.tensor([20, 100, 200, smax - 2], dtype=torch.int32,
                          device=dev)
        pw = torch.tensor([3, 0, 150, 40], dtype=torch.int32, device=dev)
        ow = verify_attention(q, k, v, lw, pw, window=window, tree=(w, gam))
        rw = verify_attention_tree_ref(q, k, v, lw, pw, window=window,
                                       tree=(w, gam))
        tbl = torch.randperm(b * smax // pg, generator=g, device=dev).to(
            torch.int32).reshape(b, smax // pg)
        kp = torch.zeros((b * smax // pg + 1, pg, hk, d), dtype=k.dtype,
                         device=dev)
        vp = torch.zeros_like(kp)
        kp[tbl.long()] = k.reshape(b, smax // pg, pg, hk, d)
        vp[tbl.long()] = v.reshape(b, smax // pg, pg, hk, d)
        opw = verify_attention_paged(q, kp, vp, tbl, lw, pw, window=window,
                                     tree=(w, gam))
        torch.cuda.synchronize()
        assert torch.equal(opw, ow), f"paged tree != dense, window {window}"
        e, rl = hold(ow, rw, f"tree=({w},{gam}) window={window}")
        case = dict(tree=[w, gam], window=window, max_abs_err=e,
                    rel_l2_err=rl, paged_equal_dense=True)
        if w == 1:
            assert torch.equal(ow, verify_attention(q, k, v, lw, pw,
                                                    window=window)), \
                f"tree W=1 != chain kernel, window {window}"
            case["w1_equal_chain"] = True
        sweep.append(case)
    dense_row["window_sweep"] = sweep
    return [dense_row, paged_row]


# ------------------------------------------------------ model helpers
def _requests(rng, n, lo, hi, new, vocab):
    from repro_torch.serving.request import Request
    return [Request(prompt=rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist(),
                    max_new_tokens=new) for _ in range(n)]


def phase_ladder():
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    cfg = dataclasses.replace(get("glm4-9b"), num_layers=2)
    dcfg = eagle.draft_config(cfg)
    dev = torch.device("cuda")
    params = T.init(cfg, 1, device=dev)
    dparams = eagle.draft_init(dcfg, 2, device=dev)
    streams = {}
    for k in (8, 0):
        eng = ServingEngine(cfg, params, dcfg, dparams, batch_size=8,
                            max_len=256, gamma=3, superstep_rounds=k,
                            device=dev)
        reqs = _requests(np.random.default_rng(3), 8, 16, 128, 24,
                         cfg.vocab_size)
        eng.serve_wave(reqs)
        streams[k] = [list(r.generated) for r in reqs]
        assert all(len(s) == 24 for s in streams[k])
    assert streams[8] == streams[0], "superstep stream != stepwise stream"
    paged = {}
    for k in (8, 0):
        conf = ServingConfig(batch_size=8, max_len=256, gamma=3,
                             superstep_rounds=k, page_size=GLM["P"])
        eng = ServingEngine(cfg, params, dcfg, dparams, config=conf,
                            device=dev)
        reqs = _requests(np.random.default_rng(3), 8, 16, 128, 24,
                         cfg.vocab_size)
        eng.serve_wave(reqs)
        paged[k] = [list(r.generated) for r in reqs]
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
    assert paged[8] == streams[8], "paged stream != dense stream"
    assert paged[0] == paged[8], "paged stepwise != paged superstep"
    # tree speculation, W = 2: stepwise == superstep (waves of 4) ==
    # stream (K 8 and 3)
    tree = {}
    for mode, k in (("wave", 0), ("wave", 8), ("stream", 8), ("stream", 3)):
        conf = ServingConfig(batch_size=4, max_len=256, gamma=3,
                             superstep_rounds=k, tree_width=2)
        eng = ServingEngine(cfg, params, dcfg, dparams, config=conf,
                            device=dev)
        reqs = _requests(np.random.default_rng(3), 8, 16, 128, 24,
                         cfg.vocab_size)
        if mode == "wave":
            eng.serve_wave(reqs[:4])
            eng.serve_wave(reqs[4:])
        else:
            eng.serve_stream(iter(reqs))
        tree[(mode, k)] = [list(r.generated) for r in reqs]
        assert all(len(s_) == 24 for s_ in tree[(mode, k)])
    ref = tree[("wave", 0)]
    assert all(v == ref for v in tree.values()), \
        "tree W=2: stepwise / superstep / stream / wave streams differ"
    sampled = _sampled_ladder(cfg, params, dcfg, dparams)
    chunked = _chunked_ladder(cfg, params, dcfg, dparams, streams[8])
    overload = _overload_ladder(cfg, params, dcfg, dparams)
    # the card's prefill against the CPU's (plain kernels) on one prompt
    toks = torch.tensor([np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=48).tolist()], dtype=torch.int32)
    pad = torch.tensor([5], dtype=torch.int32)
    gpu = T.prefill(cfg, params, toks.to(dev), pad=pad.to(dev))["logits"]
    gpu = gpu.cpu()
    params.to("cpu")            # moves the module's weights (in place)
    cpu = T.prefill(cfg, params, toks, pad=pad)["logits"]
    assert torch.isfinite(gpu).all()
    rel = float((gpu - cpu).norm() / cpu.norm())
    assert rel < 2e-2, f"card vs CPU prefill logits rel err {rel}"
    emit({"phase": "ladder", "layers": 2, "requests": 8, "new_tokens": 24,
          "streams_equal": True, "paged_streams_equal": True,
          "tree2_stepwise_superstep_stream_wave_equal": True,
          "tree2_requests_equal_chain": sum(
              a == b for a, b in zip(ref, streams[8])),
          "sampled": sampled, "chunked": chunked, "overload": overload,
          "prefill_logits_rel_err_vs_cpu": rel,
          "argmax_equal": bool(gpu.argmax() == cpu.argmax())})
    del params, dparams
    torch.cuda.empty_cache()


def _sampled_ladder(cfg, params, dcfg, dparams) -> dict:
    """The sampled ladder (greedy=False, seed 5; tests/test_continuous.py
    :133, tests/test_superstep.py:98), held exactly: the chain's streams
    at K 8 == K 0 == waves of 4 == stream, paged (page 16) == dense, and
    tree W 2 superstep == stepwise; every sampling kernel launched."""
    from repro_torch.kernels.sample.ops import categorical_rows, threefry2x32
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    dev = torch.device("cuda")
    runs = {}
    for name, k, mode, kw in (("K8", 8, "stream", {}),
                              ("K0", 0, "stream", {}),
                              ("waves4", 8, "wave", {}),
                              ("paged", 8, "stream", {"page_size": GLM["P"]}),
                              ("tree2_K8", 8, "stream", {"tree_width": 2}),
                              ("tree2_K0", 0, "stream", {"tree_width": 2})):
        conf = ServingConfig(batch_size=4, max_len=256, gamma=3,
                             superstep_rounds=k, greedy=False, seed=5, **kw)
        eng = ServingEngine(cfg, params, dcfg, dparams, config=conf,
                            device=dev)
        reqs = _requests(np.random.default_rng(3), 8, 16, 128, 24,
                         cfg.vocab_size)
        n0 = (threefry2x32.launches, categorical_rows.launches)
        if mode == "wave":
            eng.serve_wave(reqs[:4])
            eng.serve_wave(reqs[4:])
        else:
            eng.serve_stream(iter(reqs))
        torch.cuda.synchronize()
        assert threefry2x32.launches > n0[0] and \
            categorical_rows.launches > n0[1], f"sampled {name}: no launch"
        runs[name] = [list(r.generated) for r in reqs]
        assert all(len(s_) == 24 for s_ in runs[name])
        if eng.paged:
            eng.release_prefix_cache()
            eng.allocator.assert_clean()
        del eng
    for name in ("K0", "waves4", "paged"):
        assert runs[name] == runs["K8"], f"sampled chain {name} != K8"
    assert runs["tree2_K0"] == runs["tree2_K8"], \
        "sampled tree W=2 stepwise != superstep"
    return {"chain_K8_K0_waves_stream_equal": True,
            "paged_equal_dense": True, "tree2_stepwise_superstep_equal": True,
            "tree2_requests_equal_chain": sum(
                a == b for a, b in zip(runs["tree2_K8"], runs["K8"]))}


def _chunked_ladder(cfg, params, dcfg, dparams, one_shot) -> dict:
    """Chunked refill prefill (chunk 32: the ladder's prompts of 16-128
    tokens make 1-4 chunks), greedy and sampled (seed 5), held exactly:
    K 8 == K 0 == waves of 4, paged (page 16) == dense; the greedy
    streams against the one-shot ladder's (reported: chunked and one-shot
    rows differ in the last bits, so a near-tie may flip)."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    dev = torch.device("cuda")
    out = {}
    for greedy in (True, False):
        runs = {}
        for name, k, mode, kw in (("K8", 8, "stream", {}),
                                  ("K0", 0, "stream", {}),
                                  ("waves4", 8, "wave", {}),
                                  ("paged", 8, "stream",
                                   {"page_size": GLM["P"]})):
            conf = ServingConfig(batch_size=4, max_len=256, gamma=3,
                                 superstep_rounds=k, greedy=greedy, seed=5,
                                 prefill_chunk=32, **kw)
            eng = ServingEngine(cfg, params, dcfg, dparams, config=conf,
                                device=dev)
            reqs = _requests(np.random.default_rng(3), 8, 16, 128, 24,
                             cfg.vocab_size)
            if mode == "wave":
                eng.serve_wave(reqs[:4])
                eng.serve_wave(reqs[4:])
            else:
                eng.serve_stream(iter(reqs))
            assert eng.stats.prefill_chunks > 0 and \
                eng.stats.prefill_op_width.max <= 32
            runs[name] = [list(r.generated) for r in reqs]
            assert all(len(s_) == 24 for s_ in runs[name])
            if eng.paged:
                eng.release_prefix_cache()
                eng.allocator.assert_clean()
            del eng
        kind = "greedy" if greedy else "sampled"
        for name in ("K0", "waves4", "paged"):
            assert runs[name] == runs["K8"], f"chunked {kind} {name} != K8"
        out[kind] = {"K8_K0_waves_paged_equal": True}
        if greedy:
            out[kind]["requests_equal_one_shot"] = sum(
                a == b for a, b in zip(runs["K8"], one_shot))
    return out


def _kernel_fns():
    from repro_torch.kernels.extract_pack.ops import pack_signals
    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_paged)
    from repro_torch.kernels.linear_rows.ops import linear_rows
    from repro_torch.kernels.sample.ops import categorical_rows, threefry2x32
    from repro_torch.kernels.verify_attn.ops import (verify_attention,
                                                     verify_attention_paged)
    return {"flash_attention": flash_attention,
            "threefry2x32": threefry2x32,
            "categorical_rows": categorical_rows,
            "verify_attention": verify_attention,
            "extract_pack": pack_signals,
            "verify_attention_paged": verify_attention_paged,
            "flash_attention_paged": flash_attention_paged,
            "linear_rows": linear_rows}


def _serve_requests(vocab):
    """16 requests, prompts 64-512, 64 new tokens; 1, 3, 5 and 7 (all in
    the first wave) share one prompt."""
    reqs = _requests(np.random.default_rng(5), 16, 64, 512, 64, vocab)
    for i in (3, 5, 7):
        reqs[i].prompt = list(reqs[1].prompt)
    return reqs


def _timed_serve(eng, reqs):
    """serve_stream with every kernel's launch count zeroed just before
    and read just after, and the prefill and superstep ops timed on the
    host clock around a synchronize.  Returns (summary, launches)."""
    from repro_torch.core import eagle
    timed = {"prefill": [], "superstep": []}

    def timing(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - s) * 1e3
            # prefill: [rows, width, ms] (a[0] is the token batch)
            timed[name].append([*a[0].shape, ms] if name == "prefill" else ms)
            return out
        return run

    eng._prefill = timing("prefill", eng._prefill)
    eng._superstep = timing("superstep", eng._superstep)
    chunks = []
    if eng.prefill_chunk:
        # a chunk op (unfused, or fused with its commit): [kind, rows,
        # width, ms]; a continuation's width is its T
        def chunk_timing(kind, fn, toks_arg):
            def run(*a, **kw):
                torch.cuda.synchronize()
                s = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                chunks.append([kind, *a[toks_arg].shape,
                               (time.perf_counter() - s) * 1e3])
                return out
            return run
        eng._chunk_start_core = chunk_timing("start", eng._chunk_start_core,
                                             0)
        eng._chunk_cont_core = chunk_timing("cont", eng._chunk_cont_core, 2)
    cfg = eng.cfg
    fns = _kernel_fns()
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "tree_launches"):
            fn.tree_launches = 0
    fns["verify_attention"].launches_at_t.clear()
    eng.serve_stream(iter(reqs))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in fns.items()}
    for name in ("verify_attention", "verify_attention_paged"):
        launches[name + "_tree"] = fns[name].tree_launches
    launches["verify_attention_by_t"] = dict(
        fns["verify_attention"].launches_at_t)
    assert all(r.finish_t is not None and len(r.generated) == (
        0 if r.shed else r.max_new_tokens) for r in reqs), \
        "a request did not finish with its tokens"
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    st = eng.stats
    summary = {
        "model": cfg.name, "layers": cfg.num_layers,
        "params_B": round(cfg.param_count() / 1e9, 3),
        "draft_params_B": round(eagle.draft_param_count(eng.dcfg) / 1e9, 3),
        "requests": len(reqs),
        "tokens_out": st.tokens_out, "wall_s": st.wall_s,
        "tokens_per_s": st.throughput,
        "prefill_rows_width_ms": timed["prefill"],
        "superstep_ms_median": statistics.median(timed["superstep"]),
        "superstep_ms": timed["superstep"],
        "supersteps": st.dispatches, "rounds": st.steps,
        "spec_rounds": st.spec_steps,
        "mean_accept_len": st.accept_len,
        "ttft_p50_s": st.ttft_p50,
        "prefill_op_width_max": st.prefill_op_width.max,
        "prefill_gap_tokens": {"n": st.prefill_gap_tokens.n,
                               "max": st.prefill_gap_tokens.max,
                               "mean": st.prefill_gap_tokens.mean},
        "host_syncs": eng.host_syncs,
        "host_syncs_per_superstep": eng.host_syncs / max(st.dispatches, 1),
        "tree_width": eng.tree_width,
        "signal_windows": eng.extractor.store.total_added,
        "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    if eng.prefill_chunk:
        summary.update(prefill_chunks=st.prefill_chunks,
                       prefill_lane_rounds=st.prefill_lane_rounds,
                       chunk_ops=chunks)
    return summary, launches


def phase_serve():
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.core.signals import SignalExtractor, SignalStore
    cfg = get("glm4-9b")
    dcfg = eagle.draft_config(cfg)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = T.init(cfg, 0, device=dev)
    dparams = eagle.draft_init(dcfg, 1, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(cfg, params, dcfg, dparams, batch_size=8,
                        max_len=1024, gamma=GLM["GAMMA"], superstep_rounds=8,
                        device=dev, extractor=SignalExtractor(SignalStore()))
    reqs = _serve_requests(cfg.vocab_size)
    summary, launches = _timed_serve(eng, reqs)
    for name in ("flash_attention", "verify_attention", "extract_pack"):
        assert launches[name] > 0, launches
    # every prefill op: q, k, v, o, gate, up and down of each layer and
    # the last-position lm_head; then its draft seed: the three fuse
    # products, fc, q, k, v and o
    assert launches["linear_rows"] == len(summary["prefill_rows_width_ms"]) \
        * (7 * cfg.num_layers + 1 + 8), launches
    emit({"phase": "serve", **summary, "init_s": round(init_s, 2),
          "nvidia_smi": smi()})
    # the train phase's signals: this serve's windows, drained before
    # any later serve on this engine adds its own
    signals = eng.extractor.store.drain()
    return launches, eng, summary, [list(r.generated) for r in reqs], signals


def _flips(eng, reqs, streams, ref_streams):
    """Every request whose stream differs from ``ref_streams``: the step
    where it first departs, and the target's top-2 logit gap there beside
    its top logit (one prefill of prompt + the common prefix)."""
    from repro_torch.models import transformer as T
    out = []
    for i, (a, b) in enumerate(zip(streams, ref_streams)):
        if a == b:
            continue
        j = next((n for n in range(min(len(a), len(b))) if a[n] != b[n]),
                 min(len(a), len(b)))
        seq = torch.tensor([list(reqs[i].prompt) + list(b[:j])],
                           dtype=torch.int32, device=eng.device)
        with torch.no_grad():
            top = T.prefill(eng.cfg, eng.params,
                            seq)["logits"][0].topk(2).values
        out.append({"request": i, "step": j,
                    "top2_logit_gap": float(top[0] - top[1]),
                    "top_logit": float(top[0])})
    return out


def phase_cobatch(eng):
    """One prompt of the serve (its shortest) refilled alone and beside
    the serve's longest prompt, packed by the serving engine's own refill
    (``_refill_arrays``: another left pad, width and row count), through
    glm4-9b at full depth: the first op whose rows of that prompt depart
    (layer by layer: hidden states, K/V rows, last-position logits), or
    none, and every op that departs with its inputs' rows made equal
    (``repro_torch.obs.cobatch``).  No op may depart, alone or through
    its inputs.  The same steps with torch.matmul under
    ``allow_bf16_reduced_precision_reduction = False`` are reported
    beside it."""
    from repro_torch.obs.cobatch import cobatch_diff
    from repro_torch.serving.request import Request
    prompts = sorted((r.prompt for r in _serve_requests(eng.cfg.vocab_size)),
                     key=len)
    short, long_ = prompts[0], prompts[-1]

    def batch(ps):
        reqs = [Request(prompt=list(p), max_new_tokens=1) for p in ps]
        for i, r in enumerate(reqs):
            r.sid = i
        return eng._refill_arrays(list(enumerate(reqs)))[:2]

    a_, b_ = (*batch([short]), 0), (*batch([long_, short]), 1)
    # the library alone, with cuBLAS's reduced-precision bf16 reductions
    # off: does that setting pin its rows at these two row counts?
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        lib = cobatch_diff(eng.cfg, eng.params, a_, b_, linear=torch.matmul)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    d = cobatch_diff(eng.cfg, eng.params, a_, b_)
    emit({"phase": "cobatch", "verdict": d["first_departing_op"] or "none",
          **d, "departing_alone_count": len(d["departing_alone"]),
          "departing_alone": d["departing_alone"][:12],
          "torch_matmul_bf16_reduction_off": {
              "verdict": lib["first_departing_op"] or "none",
              "departing_alone_count": len(lib["departing_alone"]),
              "departing_alone": lib["departing_alone"][:12],
              "logits_max_abs_diff": lib["logits_max_abs_diff"]}})
    assert d["first_departing_op"] is None, \
        f"{d['first_departing_op']} departs with the refill batch"
    assert not d["departing_alone"], d["departing_alone"]
    assert d["kv_rows_equal"] and d["hidden_equal"] and d["logits_equal"]


def phase_paged_serve(dense_eng, dense, dense_streams, blocking):
    """The serve on a paged engine (page 16) with the same weights and
    requests: first with the dense footprint of pages, where the schedule
    must be the dense serve's exactly, then with half of it, whose engine
    is then profiled.  Each engine is freed before the next is built.
    Returns the half run's launches."""
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    for name, num_pages in (("dense_footprint", 512), ("half", 256)):
        conf = ServingConfig(batch_size=8, max_len=1024, gamma=GLM["GAMMA"],
                             superstep_rounds=8, page_size=GLM["P"],
                             num_pages=num_pages)
        eng = ServingEngine(dense_eng.cfg, dense_eng.params, dense_eng.dcfg,
                            dense_eng.dparams, config=conf,
                            device=dense_eng.device,
                            extractor=SignalExtractor(SignalStore()))
        reqs = _serve_requests(eng.cfg.vocab_size)
        summary, launches = _timed_serve(eng, reqs)
        st = eng.stats
        streams = [list(r.generated) for r in reqs]
        assert st.pages_peak <= num_pages
        assert st.prefix_hits > 0, "the shared prompt was not adopted"
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
        for k in ("verify_attention_paged", "flash_attention_paged",
                  "verify_attention", "extract_pack"):
            assert launches[k] > 0, launches
        assert launches["flash_attention"] == 0, launches
        emit({"phase": "paged_serve", "run": name, "page_size": GLM["P"],
              "num_pages": num_pages, **summary,
              "pages_peak": st.pages_peak,
              "admission_deferrals": st.admission_deferrals,
              "prefix_hits": st.prefix_hits,
              "prefix_tokens_saved": st.prefix_tokens_saved,
              "streams_equal_dense": streams == dense_streams,
              "requests_equal_dense": sum(
                  a == b for a, b in zip(streams, dense_streams)),
              **({"first_flip": _flips(eng, reqs, streams,
                                       dense_streams)[0]}
                 if streams != dense_streams else {}),
              "host_syncs_per_superstep_dense":
                  dense["host_syncs_per_superstep"],
              "nvidia_smi": smi()})
        # the half pool's deferrals move prompts to other refill batches;
        # no op of the prefill departs with its batch (cobatch), so its
        # streams hold as the dense footprint's do
        assert streams == dense_streams, f"{name}: paged streams != dense"
        if name == "half":
            assert st.admission_deferrals > 0, "the guard never deferred"
        if name == "dense_footprint":
            assert st.admission_deferrals == 0
            assert st.dispatches == dense["supersteps"]
            assert eng.host_syncs == dense["host_syncs"], \
                (eng.host_syncs, dense["host_syncs"])
        if name == "half":
            half = launches
            profile_against(eng, "paged", blocking)
        del eng
        torch.cuda.empty_cache()
    return half


def phase_tree_serve(dense_eng, dense, dense_streams, blocking):
    """Greedy tree speculation on the serve phase's engine configuration,
    weights and requests (glm4-9b at full width and depth), W = 1 and
    W = 4.  W = 1 must be the chain serve exactly: streams, supersteps
    and host syncs.  W = 4 commits the target's greedy tokens like the
    chain, but its verify scores 13 rows where the chain scores 4, so
    bf16 products round differently and a near-tie of the top-2 logits
    can flip; the phase reports how many streams differ and the gap at
    the first flip.  Random weights: the draft's proposals are (almost)
    never accepted, so the mean accepted length is about 1.0 and the
    winning branch is 0.  Each engine is profiled right after its serve
    and freed before the next is built.  Returns {W: (launches,
    streams, summary)}."""
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    out = {}
    for width in (1, GLM["TREE_W"]):
        conf = ServingConfig(batch_size=8, max_len=1024, gamma=GLM["GAMMA"],
                             superstep_rounds=8, tree_width=width)
        eng = ServingEngine(dense_eng.cfg, dense_eng.params, dense_eng.dcfg,
                            dense_eng.dparams, config=conf,
                            device=dense_eng.device,
                            extractor=SignalExtractor(SignalStore()))
        reqs = _serve_requests(eng.cfg.vocab_size)
        summary, launches = _timed_serve(eng, reqs)
        st = eng.stats
        streams = [list(r.generated) for r in reqs]
        n_layers = eng.cfg.num_layers
        # every target verify of a speculative round is one tree-mode
        # launch per layer; plain rounds and draft calls use the chain
        assert launches["verify_attention_tree"] == n_layers * st.spec_steps, \
            (launches, st.spec_steps)
        assert launches["verify_attention_paged"] == 0, launches
        for k in ("flash_attention", "verify_attention", "extract_pack"):
            assert launches[k] > 0, launches
        diff = [i for i, (a, b) in enumerate(zip(streams, dense_streams))
                if a != b]
        row = {"phase": "tree_serve", "tree_width": width, **summary,
               "streams_differing_from_chain": len(diff),
               "host_syncs_per_superstep_chain":
                   dense["host_syncs_per_superstep"],
               "tokens_per_s_chain": dense["tokens_per_s"],
               "superstep_ms_median_chain": dense["superstep_ms_median"],
               "note": "random weights: mean accepted length ~1.0",
               "nvidia_smi": smi()}
        if width == 1:
            assert streams == dense_streams, "tree W=1 streams != chain"
            assert st.dispatches == dense["supersteps"]
            assert eng.host_syncs == dense["host_syncs"], \
                (eng.host_syncs, dense["host_syncs"])
        else:
            assert summary["host_syncs_per_superstep"] <= \
                dense["host_syncs_per_superstep"], "tree serve syncs more"
            if diff:
                row["first_flip"] = _flips(eng, reqs, streams,
                                           dense_streams)[0]
        out[width] = (launches, streams, summary)
        emit(row)
        profile_against(eng, f"tree W={width}", blocking)
        del eng
        torch.cuda.empty_cache()
    return out


def phase_paged_tree_serve(dense_eng, dense, dense_streams, tree_streams,
                           blocking):
    """Greedy tree speculation over paged KV (page 16) on the serve
    phase's weights and requests: W = 1 and W = 4 with the dense
    footprint of 512 pages, then W = 4 with 256.  The target verify of
    every speculative round is one launch per layer of the paged kernel
    in tree mode, and no dense kernel verifies a target block; the draft
    attends through the paged kernel in chain mode (one extend and
    W * gamma proposes a round), and the dense verify kernel runs once
    per prefill op, for the refill's draft seeding on its dense staging
    cache.  With 512 pages W = 1 must be the chain serve (streams,
    supersteps, host syncs) and W = 4 the dense W = 4 tree serve
    (streams); with 256 the tree's reservation (gamma * W + 1 = 13 rows
    where the chain reserves 4) makes the guard defer.  No page leaks
    after a drain.  The W = 4 full-pool engine is profiled.  Each engine
    is freed before the next is built.  Returns the W = 4 full-pool
    launches."""
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    W4, G = GLM["TREE_W"], GLM["GAMMA"]
    out = None
    for width, num_pages in ((1, 512), (W4, 512), (W4, 256)):
        conf = ServingConfig(batch_size=8, max_len=1024, gamma=G,
                             superstep_rounds=8, page_size=GLM["P"],
                             num_pages=num_pages, tree_width=width)
        eng = ServingEngine(dense_eng.cfg, dense_eng.params, dense_eng.dcfg,
                            dense_eng.dparams, config=conf,
                            device=dense_eng.device,
                            extractor=SignalExtractor(SignalStore()))
        reqs = _serve_requests(eng.cfg.vocab_size)
        summary, launches = _timed_serve(eng, reqs)
        st = eng.stats
        streams = [list(r.generated) for r in reqs]
        eng.release_prefix_cache()
        eng.allocator.assert_clean()
        assert st.pages_peak <= num_pages
        n_layers = eng.cfg.num_layers
        n_ops = len(summary["prefill_rows_width_ms"])
        draft_paged = (launches["verify_attention_paged"]
                       - launches["verify_attention_paged_tree"])
        assert launches["verify_attention_paged_tree"] == \
            n_layers * st.spec_steps, (launches, st.spec_steps)
        assert launches["verify_attention_tree"] == 0, launches
        assert draft_paged == st.spec_steps * (1 + width * G), launches
        assert launches["verify_attention"] == n_ops, (launches, n_ops)
        assert launches["flash_attention_paged"] == n_layers * n_ops, launches
        assert launches["flash_attention"] == 0, launches
        assert launches["extract_pack"] > 0, launches
        row = {"phase": "paged_tree_serve", "tree_width": width,
               "page_size": GLM["P"], "num_pages": num_pages, **summary,
               "pages_peak": st.pages_peak,
               "admission_deferrals": st.admission_deferrals,
               "prefix_hits": st.prefix_hits,
               "reservation_block_rows": G * width + 1,
               "draft_attention": "verify_attention_paged, chain mode: "
                                  f"{draft_paged} launches",
               "dense_verify_launches_refill_seeding":
                   launches["verify_attention"],
               "streams_differing_from_chain": sum(
                   a != b for a, b in zip(streams, dense_streams)),
               "streams_differing_from_dense_tree": sum(
                   a != b for a, b in zip(streams, tree_streams[width])),
               "tokens_per_s_chain": dense["tokens_per_s"],
               "superstep_ms_median_chain": dense["superstep_ms_median"],
               "note": "random weights: mean accepted length ~1.0",
               "nvidia_smi": smi()}
        if streams != tree_streams[width]:
            row["first_flip_vs_dense_tree"] = _flips(
                eng, reqs, streams, tree_streams[width])[0]
        emit(row)
        # at 256 pages the guard defers, so prompts meet other refill
        # batches; no prefill op departs with its batch (cobatch)
        assert streams == tree_streams[width], \
            f"paged tree W={width} at {num_pages} pages != dense tree"
        if num_pages == 512:
            assert st.admission_deferrals == 0
        else:
            assert st.admission_deferrals > 0, "the guard never deferred"
        if width == 1:
            assert streams == dense_streams, "paged tree W=1 != chain"
            assert st.dispatches == dense["supersteps"]
            assert eng.host_syncs == dense["host_syncs"], \
                (eng.host_syncs, dense["host_syncs"])
        if width == W4 and num_pages == 512:
            out = launches
            profile_against(eng, f"paged tree W={W4}", blocking)
        del eng
        torch.cuda.empty_cache()
    return out


def phase_sampled_serve(dense_eng, dense, tree_greedy):
    """Sampled decoding (greedy=False, seed 5) on the serve phase's
    configuration, weights and 16 requests (glm4-9b at full width and
    depth): a dense chain serve, the same requests through the paged
    engine (page 16, the dense footprint of 512 pages; its streams must
    equal the dense serve's bit for bit), and a tree W 4 serve.  Every
    request must reach its budget and every sampling kernel launch.
    Each prints tokens/s, superstep ms, host syncs per superstep, mean
    accepted length and launches beside the greedy serve's figures from
    this run.  Returns the dense sampled serve's launches."""
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    keys = ("tokens_per_s", "superstep_ms_median", "host_syncs_per_superstep",
            "mean_accept_len")
    out, streams = None, None
    for name, kw, greedy in (("chain", {}, dense),
                             ("paged", {"page_size": GLM["P"]}, dense),
                             ("tree", {"tree_width": GLM["TREE_W"]},
                              tree_greedy)):
        conf = ServingConfig(batch_size=8, max_len=1024, gamma=GLM["GAMMA"],
                             superstep_rounds=8, greedy=False, seed=5, **kw)
        eng = ServingEngine(dense_eng.cfg, dense_eng.params, dense_eng.dcfg,
                            dense_eng.dparams, config=conf,
                            device=dense_eng.device,
                            extractor=SignalExtractor(SignalStore()))
        reqs = _serve_requests(eng.cfg.vocab_size)
        summary, launches = _timed_serve(eng, reqs)
        got = [list(r.generated) for r in reqs]
        for k in ("threefry2x32", "categorical_rows", "extract_pack"):
            assert launches[k] > 0, (name, launches)
        row = {"phase": "sampled_serve", "engine": name, "seed": 5,
               **summary, "greedy": {k: greedy[k] for k in keys},
               "nvidia_smi": smi()}
        if name == "chain":
            out, streams = launches, got
        elif name == "paged":
            assert got == streams, "sampled paged streams != dense"
            row["streams_equal_dense"] = True
            eng.release_prefix_cache()
            eng.allocator.assert_clean()
        else:
            row["streams_differing_from_chain"] = sum(
                a != b for a, b in zip(got, streams))
        emit(row)
        del eng
        torch.cuda.empty_cache()
    return out


def _chunk_expected_t128(n_layers: int, ops) -> int:
    """verify_attention launches at T = 128 that a chunked serve's chunk
    ops make: a continuation of width 128 launches it in each target
    layer and once in the draft's extend; a first chunk of width 128
    once, in the draft's extend (its target side is the prefill
    kernel)."""
    t = CHUNK["C"]
    conts = sum(1 for kind, _, w, _ in ops if kind == "cont" and w == t)
    starts = sum(1 for kind, _, w, _ in ops if kind == "start" and w == t)
    return n_layers * conts + conts + starts


def _staging_vs_one_shot(eng) -> dict:
    """One pipeline of two prompts of one width bucket (509 and 505
    tokens: width 512, pads 3 and 7, four chunks of 128) driven to its
    end on a chunked engine, against the one-shot prefill and draft seed
    of the same padded batch, on the valid region: equal bit for bit, or
    within REL_L2_TOL (relative L2 per leaf) with the first departing op
    named (target K/V by layer, then the draft's K/V, the logits)."""
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(11)
    reqs = [Request(prompt=rng.integers(0, eng.cfg.vocab_size, size=n)
                    .tolist(), max_new_tokens=1) for n in (509, 505)]
    for i, r in enumerate(reqs):
        r.sid = i
    pl = eng._make_pipeline(list(enumerate(reqs)))
    while not pl.done:
        eng._advance_pipeline(pl)
    pre = T.prefill(eng.cfg, eng.params, pl.toks, max_len=eng.max_len,
                    pad=pl.pad)
    rdc = eagle.seed_refill_cache(eng.dcfg, eng.dparams,
                                  eng.params["embed"], pre["captures"],
                                  pl.toks, pl.pad, eng.max_len)
    torch.cuda.synchronize()
    w = pl.width
    dlen = int(pl.dcache["lengths"][0])
    assert (pl.dcache["lengths"] == rdc["lengths"]).all()
    pads = [int(p) for p in pl.pad]
    pairs = []
    for layer in range(eng.cfg.num_layers):
        for leaf in ("k", "v"):
            pairs.append((f"target {leaf} layer {layer}",
                          [pl.cache["body"]["pos0"][leaf][layer, i, p:w]
                           for i, p in enumerate(pads)],
                          [pre["cache"]["body"]["pos0"][leaf][layer, i, p:w]
                           for i, p in enumerate(pads)]))
    for leaf in ("k", "v"):
        pairs.append((f"draft {leaf}",
                      [pl.dcache[leaf][i, p:dlen] for i, p in enumerate(pads)],
                      [rdc[leaf][i, p:dlen] for i, p in enumerate(pads)]))
    pairs.append(("logits", [pl.logits], [pre["logits"]]))
    pairs.append(("last capture", [pl.caps_last], [pre["captures"][:, -1]]))
    first, worst, equal = None, 0.0, True
    for name, got, want in pairs:
        got, want = torch.cat([g.reshape(-1) for g in got]).float(), \
            torch.cat([x.reshape(-1) for x in want]).float()
        if torch.equal(got, want):
            continue
        equal = False
        rel = float((got - want).norm() / want.norm())
        worst = max(worst, rel)
        if first is None:
            pos = None
            if name.startswith("target"):
                layer = int(name.rsplit(" ", 1)[1])
                leaf = name.split()[1]
                for i, p in enumerate(pads):
                    d = (pl.cache["body"]["pos0"][leaf][layer, i, p:w]
                         != pre["cache"]["body"]["pos0"][leaf][layer, i, p:w])
                    idx = d.reshape(d.shape[0], -1).any(1).nonzero()
                    if idx.numel():
                        pos = p + int(idx[0])
                        break
            first = {"op": name, "position": pos, "rel_l2": rel}
        assert rel < REL_L2_TOL, f"staging {name} rel L2 {rel} vs one-shot"
    first_tok = bool(torch.equal(pl.logits.argmax(-1),
                                 pre["logits"].argmax(-1)))
    return {"rows": pl.rows, "width": w, "chunks": -(-w // pl.chunk),
            "first_width": pl.first_width, "pads": pads,
            "equal_bitwise": equal, "worst_rel_l2": worst,
            "first_departing": first, "first_tokens_equal": first_tok}


def _prefix_resume(eng, reqs, streams) -> dict:
    """On a paged chunked engine after its serve: the serve's longest
    prompt served alone twice (8 new tokens).  The second admission's
    pipeline finds all its rows' prefix pages in the registry and
    gathers the chunks they cover (``_chunk_resume``) instead of
    prefilling them: fewer chunks, prefix tokens saved, and the stream
    of the first and of the serve."""
    from repro_torch.serving.request import Request
    i = max(range(len(reqs)), key=lambda j: len(reqs[j].prompt))
    st = eng.stats
    runs = []
    for _ in range(2):
        c0, s0 = st.prefill_chunks, st.prefix_tokens_saved
        r = Request(prompt=list(reqs[i].prompt), max_new_tokens=8)
        eng.serve_wave([r])
        runs.append({"chunks": st.prefill_chunks - c0,
                     "prefix_tokens_saved": st.prefix_tokens_saved - s0,
                     "stream": list(r.generated)})
    full = -(-max(8, -(-len(reqs[i].prompt) // 8) * 8) // eng.prefill_chunk)
    assert runs[1]["chunks"] < full and runs[1]["prefix_tokens_saved"] > 0, \
        (runs, full)
    assert runs[0]["stream"] == runs[1]["stream"] == streams[i][:8], runs
    return {"prompt_len": len(reqs[i].prompt), "chunks_full": full,
            "runs": [{k: v for k, v in x.items() if k != "stream"}
                     for x in runs], "streams_equal": True}


def phase_chunked_serve(dense_eng, dense, dense_streams):
    """Chunked refill prefill (prefill_chunk 128: the serve's prompts of
    64-512 tokens make 1-4 chunks) on the serve phase's configuration,
    weights and requests (glm4-9b at full width and depth): dense with
    cohort commit (the 16 requests), dense with eager commit and paged
    (page 16) at the dense footprint of 512 pages (the first CHUNK["N_CUT"]
    requests), and paged at 256 pages (the 16; admission defers, so the
    pipelines group other requests).  Asserts every request reaches
    its budget, the four serves' streams equal, each stream equal to the
    one-shot serve's or departing only at a near-tie (top-2 logit gap
    within BF16_TOL of the top logit), no prefill op wider than 128, the
    verify kernel's T = 128 launches equal to the chunk ops' (layers x
    target continuations, plus the draft's extends), every kernel of the
    path launched, and no page leaked.  Then one pipeline's staging rows
    against the one-shot prefill's (``_staging_vs_one_shot``), and on the
    512-page engine a pipeline resumed from shared prefix pages
    (``_prefix_resume``).  Each
    serve prints tokens/s, superstep ms, host syncs per superstep, TTFT
    p50, chunks, prefill gap tokens, peak memory and launches beside the
    one-shot serve's.  Returns the dense cohort serve's launches."""
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    keys = ("tokens_per_s", "superstep_ms_median", "host_syncs_per_superstep",
            "ttft_p50_s", "prefill_op_width_max", "prefill_gap_tokens",
            "max_memory_allocated_GB")
    one_shot_width = max(w for _, w, _ in dense["prefill_rows_width_ms"])
    out, streams, staging = None, None, None
    for name, kw, n in (("dense_cohort", {}, 16),
                        ("dense_eager", {"commit": "eager"}, CHUNK["N_CUT"]),
                        ("paged", {"page_size": GLM["P"]}, CHUNK["N_CUT"]),
                        ("paged_half", {"page_size": GLM["P"],
                                        "num_pages": 256}, 16)):
        conf = ServingConfig(batch_size=8, max_len=1024, gamma=GLM["GAMMA"],
                             superstep_rounds=8,
                             prefill_chunk=CHUNK["C"], **kw)
        eng = ServingEngine(dense_eng.cfg, dense_eng.params, dense_eng.dcfg,
                            dense_eng.dparams, config=conf,
                            device=dense_eng.device,
                            extractor=SignalExtractor(SignalStore()))
        reqs = _serve_requests(eng.cfg.vocab_size)[:n]
        summary, launches = _timed_serve(eng, reqs)
        got = [list(r.generated) for r in reqs]
        st = eng.stats
        assert st.prefill_op_width.max <= CHUNK["C"], st.prefill_op_width.max
        assert st.prefill_chunks > st.refills / 2, summary
        t128 = launches["verify_attention_by_t"].get(CHUNK["C"], 0)
        want128 = _chunk_expected_t128(eng.cfg.num_layers,
                                       summary["chunk_ops"])
        assert t128 == want128 > 0, (t128, want128)
        for k in ("flash_attention", "verify_attention", "extract_pack",
                  "linear_rows"):
            assert launches[k] > 0, (name, launches)
        if eng.paged:
            assert launches["verify_attention_paged"] > 0, launches
        flips = _flips(eng, reqs, got, dense_streams)
        for f in flips:
            assert f["top2_logit_gap"] <= BF16_TOL * abs(f["top_logit"]), \
                f"chunked {name} departs from one-shot at no near-tie: {f}"
        row = {"phase": "chunked_serve", "engine": name,
               "prefill_chunk": CHUNK["C"], "requests_served": n, **summary,
               "t128_launches": t128,
               "streams_differing_from_one_shot": len(flips),
               "flips": flips, "one_shot": {k: dense[k] for k in keys},
               "one_shot_prefill_op_width_max": one_shot_width,
               "nvidia_smi": smi()}
        if name == "dense_cohort":
            out, streams = launches, got
            staging = _staging_vs_one_shot(eng)
            row["staging_vs_one_shot"] = staging
        else:
            assert got == streams[:n], \
                f"chunked {name} streams != dense cohort"
            row["streams_equal_dense_cohort"] = True
        if eng.paged:
            row["admission_deferrals"] = st.admission_deferrals
            row["pages_peak"] = st.pages_peak
            row["prefix_hits"] = st.prefix_hits
            if name == "paged":
                row["prefix_resume"] = _prefix_resume(eng, reqs, got)
            eng.release_prefix_cache()
            eng.allocator.assert_clean()
            if name == "paged_half":
                assert st.admission_deferrals > 0, "256 pages never deferred"
        emit(row)
        del eng
        torch.cuda.empty_cache()
    return out


# the overload phase's trace (rows of (arrives_at, deadline, budget), in
# rounds of the engine's round clock): 8 loose residents from round 0, a
# tight burst of 4 at round 10 while they decode, 3 loose tail requests
# from round 0 and one hopeless request (deadline 4) at round 2
OVERLOAD_ROWS = ([(0.0, 1000.0 + i, 64) for i in range(8)]
                 + [(10.0, 40.0 + i, 16) for i in range(4)]
                 + [(0.0, 1010.0 + i, 16) for i in range(3)]
                 + [(2.0, 4.0, 16)])
OVERLOAD_PLEN = (64, 256)


def _overload_requests(vocab, rows, plen=OVERLOAD_PLEN, seed=9, sids=False):
    """Gated requests of ``rows``, prompts of plen[0]-plen[1] tokens from
    a fixed seed; ``sids`` numbers them in creation order (the sampled
    streams' keys), else the engine numbers them at admission."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    out = []
    for i, (at, deadline, new) in enumerate(rows):
        n = int(rng.integers(plen[0], plen[1] + 1))
        r = Request(prompt=rng.integers(0, vocab, size=n).tolist(),
                    max_new_tokens=new, deadline=deadline)
        r.arrives_at = at
        r.sid = i if sids else None
        out.append(r)
    return out


def _round_clock(eng):
    """The engine's clock bound to its executed-round count
    (tests/test_overload.py:84): arrivals, deadlines and every stamp are
    rounds, so the schedule is deterministic."""
    eng._clock = lambda: float(eng.stats.steps)
    return eng


def _overload_ladder(cfg, params, dcfg, dparams) -> dict:
    """Preempt-on against preempt-off on a burst (batch 4: four loose
    residents, a tight pair at round 4, one loose tail; prompts 16-128),
    greedy and sampled (seed 5), dense and paged (page 16), held exactly;
    each preempting serve spills and restores or drops every victim and
    leaves a clean allocator."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    rows = ([(0.0, 1000.0 + i, 24) for i in range(4)]
            + [(4.0, 20.0 + i, 8) for i in range(2)] + [(0.0, 1010.0, 8)])
    out = {}
    for greedy in (True, False):
        for paged in (False, True):
            runs = {}
            for preempt in ("none", "deadline"):
                conf = ServingConfig(
                    batch_size=4, max_len=256, gamma=3, superstep_rounds=8,
                    greedy=greedy, seed=5, admission="deadline",
                    admission_lookahead=8, gate_arrivals=True,
                    preempt=preempt, page_size=GLM["P"] if paged else 0)
                eng = _round_clock(ServingEngine(
                    cfg, params, dcfg, dparams, config=conf,
                    device=torch.device("cuda")))
                reqs = _overload_requests(cfg.vocab_size, rows, (16, 128),
                                          seed=3, sids=True)
                eng.serve_stream(iter(reqs))
                assert all(len(r.generated) == r.max_new_tokens
                           for r in reqs)
                runs[preempt] = [list(r.generated) for r in reqs]
                st = eng.stats
                if preempt == "deadline":
                    assert st.preemptions >= 1, "the ladder burst never " \
                        "preempted"
                    assert st.restores + eng._spills.dropped == \
                        st.preemptions and not eng._spills
                    n = (st.preemptions, st.restores)
                if eng.paged:
                    eng.release_prefix_cache()
                    eng.allocator.assert_clean()
                del eng
            kind = ("greedy" if greedy else "sampled") + (
                "_paged" if paged else "_dense")
            assert runs["deadline"] == runs["none"], \
                f"overload {kind}: preempt-on streams != preempt-off"
            out[kind] = {"streams_equal_preempt_off": True,
                         "preemptions": n[0], "restores": n[1]}
    return out


def _spill_bytes(sp) -> int:
    """Bytes of one spill snapshot (a tree of tensors)."""
    if torch.is_tensor(sp):
        return sp.numel() * sp.element_size()
    return sum(_spill_bytes(v) for v in sp.values())


def _timed_overload_ops(eng):
    """Wrap the engine's spill and restore ops: each call's host ms (the
    host clock around it, nothing synchronized) and a CUDA event pair,
    read after the serve; a spill's snapshot bytes.  Returns the record."""
    rec = {"_spill": [], "_restore": []}
    for name in rec:
        fn = getattr(eng, name)

        def run(*a, _fn=fn, _name=name, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = _fn(*a, **kw)
            end.record()
            host = (time.perf_counter() - t0) * 1e3
            nbytes = _spill_bytes(out) if _name == "_spill" else 0
            rec[_name].append((start, end, host, nbytes))
            return out
        setattr(eng, name, run)
    return rec


def _op_summary(calls) -> dict:
    """Medians of the recorded ops (after a synchronize)."""
    if not calls:
        return {"n": 0}
    ev = [s.elapsed_time(e) for s, e, _, _ in calls]
    out = {"n": len(calls), "event_ms_median": statistics.median(ev),
           "host_ms_median": statistics.median(h for _, _, h, _ in calls),
           "event_ms": ev}
    nbytes = calls[0][3]
    if nbytes:
        # a copy reads every byte once and writes it once
        moved = 2 * nbytes
        out.update(snapshot_bytes=nbytes, bytes_moved=moved,
                   bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return out


def phase_overload_serve(dense_eng):
    """Overload on the serve phase's glm4-9b weights (full width and
    depth, the EAGLE-3 draft): batch 8, max_len 1024, gamma 3, K 8,
    greedy, deadline admission (lookahead 8) over gated arrivals on the
    round clock, ``OVERLOAD_ROWS`` (prompts 64-256).  Three serves, each
    on an engine of its own: (a) no preemption, no shedding; (b)
    ``preempt="deadline"``, ``shed="expired"``; (c) as (b), paged at 512
    pages of 16.  (b) and (c): at least one preemption, every spill
    restored or dropped, one request shed with an empty stream, every
    other stream equal to (a)'s bit for bit, the tight requests' deadline
    hits at least (a)'s; (c): spilled pages, a clean allocator.  Every
    serve launches the verify and prefill kernels.  Then a trace that
    never overloads (the 8 residents, budget 16) without and with
    (b)'s policies: equal streams, round stamps, supersteps and host
    syncs.  Prints the counts, the burst's TTFT in rounds, each op's host
    and event ms, a spill's bytes against its bound, superstep ms, host
    syncs per superstep and peak memory beside (a)'s.  Returns (b)'s
    launches."""
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    base = dict(batch_size=8, max_len=1024, gamma=GLM["GAMMA"],
                superstep_rounds=8, admission="deadline",
                admission_lookahead=8, gate_arrivals=True)
    overload = dict(preempt="deadline", shed="expired")
    vocab = dense_eng.cfg.vocab_size

    def engine(**kw):
        return _round_clock(ServingEngine(
            dense_eng.cfg, dense_eng.params, dense_eng.dcfg,
            dense_eng.dparams, config=ServingConfig(**base, **kw),
            device=dense_eng.device,
            extractor=SignalExtractor(SignalStore())))

    def tight(reqs):
        return reqs[8:12]

    def hits(reqs):
        return sum(r.finish_round is not None
                   and r.finish_round <= r.deadline for r in tight(reqs))

    ref, out = None, None
    for name, kw in (("a", {}), ("b", overload),
                     ("c", dict(overload, page_size=GLM["P"],
                                num_pages=512))):
        eng = engine(**kw)
        ops = _timed_overload_ops(eng)
        reqs = _overload_requests(vocab, OVERLOAD_ROWS)
        t0 = time.perf_counter()
        summary, launches = _timed_serve(eng, reqs)
        wall = time.perf_counter() - t0
        st = eng.stats
        prefill = "flash_attention_paged" if eng.paged else "flash_attention"
        verify = ("verify_attention_paged" if eng.paged
                  else "verify_attention")
        for k in (prefill, verify, "extract_pack", "linear_rows"):
            assert launches[k] > 0, (name, launches)
        streams = [list(r.generated) for r in reqs]
        row = {"phase": "overload_serve", "engine": name, "config": kw,
               "requests": len(reqs), "wall_s": wall,
               "tokens_per_s": st.tokens_out / wall,
               "rounds": st.steps, "supersteps": st.dispatches,
               "superstep_ms_median": summary["superstep_ms_median"],
               "host_syncs_per_superstep":
                   summary["host_syncs_per_superstep"],
               "max_memory_allocated_GB":
                   summary["max_memory_allocated_GB"],
               "preemptions": st.preemptions, "restores": st.restores,
               "dropped": eng._spills.dropped,
               "shed_requests": st.shed_requests,
               "evictions": sum(r.evictions for r in reqs),
               "tight_deadline_hits": hits(reqs),
               "tight_ttft_rounds": [r.first_token_round - r.arrives_at
                                     for r in tight(reqs)],
               "tight_finish_rounds": [r.finish_round for r in tight(reqs)],
               "spill": _op_summary(ops["_spill"]),
               "restore": _op_summary(ops["_restore"]),
               "launches": launches, "nvidia_smi": smi()}
        if name == "a":
            ref = (streams, row)
            assert st.preemptions == st.shed_requests == 0
        else:
            assert st.preemptions >= 1, f"({name}) never preempted"
            assert st.restores + eng._spills.dropped == st.preemptions
            assert not eng._spills, "spilled requests left parked"
            assert row["evictions"] == st.preemptions
            shed = [r for r in reqs if r.shed]
            assert st.shed_requests == len(shed) == 1 and \
                shed[0].generated == [], "the hopeless request was not shed"
            differ = [i for i, r in enumerate(reqs)
                      if not r.shed and streams[i] != ref[0][i]]
            assert not differ, f"({name}) streams differ from (a): {differ}"
            assert row["tight_deadline_hits"] >= ref[1]["tight_deadline_hits"]
            row["streams_equal_a"] = True
            row["a"] = {k: ref[1][k] for k in (
                "tight_deadline_hits", "tight_ttft_rounds",
                "superstep_ms_median", "host_syncs_per_superstep",
                "max_memory_allocated_GB", "rounds", "tokens_per_s")}
            if name == "b":
                out = launches
        if eng.paged:
            row["spilled_pages"] = eng.allocator.spilled_pages
            assert eng.allocator.spilled_pages > 0
            eng.release_prefix_cache()
            eng.allocator.assert_clean()
        emit(row)
        del eng, ops
        torch.cuda.empty_cache()
    # a trace that never overloads: (b)'s policies change nothing
    idle = [(0.0, 1000.0 + i, 16) for i in range(8)]
    seen = {}
    for name, kw in (("off", {}), ("on", overload)):
        eng = engine(**kw)
        reqs = _overload_requests(vocab, idle)
        eng.serve_stream(iter(reqs))
        torch.cuda.synchronize()
        assert eng.stats.preemptions == eng.stats.shed_requests == 0
        seen[name] = ([list(r.generated) for r in reqs],
                      [(r.admit_round, r.first_token_round, r.finish_round)
                       for r in reqs],
                      eng.stats.dispatches, eng.host_syncs)
        del eng
    assert seen["on"] == seen["off"], "preempt-on changed an idle serve"
    emit({"phase": "overload_serve", "engine": "idle", "requests": 8,
          "streams_stamps_supersteps_syncs_equal": True,
          "supersteps": seen["on"][2],
          "host_syncs_per_superstep": seen["on"][3] / seen["on"][2]})
    return out


def phase_train(cfg, params, dcfg, dparams, dense, dense_streams, batches):
    """The draft's training step on the card (the adaptation loop's
    synchronous training half): one ``DraftTrainer.train_cycle`` of
    ``TRAIN_STEPS`` adamw steps on the signal windows the serve phase
    collected (its 16 requests through a SignalExtractor, drained right
    after it), then a replay of the same 16 requests on a fresh engine
    with the trained draft, whose streams must equal the serve's (greedy:
    the target decides every token, and no op departs with its batch).
    Returns the backward kernel's launches."""
    import gc
    import math

    from repro_torch.core import eagle
    from repro_torch.core.signals import SignalExtractor, SignalStore
    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_bwd)
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.draft_trainer import DraftTrainer
    dev = torch.device("cuda")
    keep = ("tokens_per_s", "superstep_ms_median", "rounds", "spec_rounds",
            "mean_accept_len", "host_syncs_per_superstep")
    windows = sorted({len(b.tokens) for b in batches})
    assert windows == [GLM["TRAIN_WINDOW"]] and len(batches) == 16, \
        (windows, len(batches))
    trainer = DraftTrainer(cfg, dcfg, params["embed"], device=dev)
    flash_attention.launches = flash_attention_bwd.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = trainer.train_cycle(dparams, batches, epochs=2,
                              min_steps=TRAIN_STEPS, seed=0)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    steps = res["steps"]
    losses = [e["loss"] for e in trainer.log]
    step_ms = [e["ms"] for e in trainer.log]
    row = {"phase": "train", "model": cfg.name,
           "draft_params_B": round(eagle.draft_param_count(dcfg) / 1e9, 3),
           "windows": len(batches), "window": windows[0],
           "batch": trainer.batch_size, "steps": steps,
           "seconds": res["seconds"],
           "step_ms_median": statistics.median(step_ms),
           "step_ms_first": step_ms[0],
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_last10_mean": statistics.mean(losses[-10:]),
           "loss_every_20": losses[::20],
           "train_acc": res["train_acc"], "eval_acc": res["eval_acc"],
           "max_memory_allocated_GB": peak_gb,
           "host_syncs": trainer.host_syncs,
           "flash_attention_launches": fwd,
           "flash_attention_bwd_launches": bwd,
           "forward_launches_per_step": (fwd - 1) / steps,
           "backward_launches_per_step": bwd / steps,
           "collect": {k: dense[k] for k in keep}}
    assert all(math.isfinite(x) for x in losses), "non-finite loss"
    assert row["loss_last10_mean"] < 0.5 * losses[0], "the loss did not fall"
    # TTT: two forwards and two backwards a step; one eval forward
    assert (fwd, bwd) == (2 * steps + 1, 2 * steps), (fwd, bwd, steps)
    eng = ServingEngine(cfg, params, dcfg, res["dparams"], batch_size=8,
                        max_len=1024, gamma=GLM["GAMMA"], superstep_rounds=8,
                        device=dev, extractor=SignalExtractor(SignalStore()))
    reqs = _serve_requests(cfg.vocab_size)
    after, _ = _timed_serve(eng, reqs)
    after = {k: after[k] for k in keep}
    replay_streams = [list(r.generated) for r in reqs]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    row.update(replay=after,
               replay_streams_equal=replay_streams == dense_streams,
               mean_accept_len_before=dense["mean_accept_len"],
               mean_accept_len_after=after["mean_accept_len"],
               nvidia_smi=smi())
    row["step_split"] = _train_step_split(trainer, res["dparams"], batches)
    emit(row)
    assert replay_streams == dense_streams, "replay streams != the serve's"
    del res, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return bwd


def _mean_accept(timeline) -> float:
    return statistics.mean(r["accept_len"] for r in timeline) \
        if timeline else float("nan")


def _tide_config(async_train: bool = False, **kw):
    """The tide phases' ``TideConfig`` on glm4-9b: batch 8, max_len 1024,
    gamma 3, K 8, no Eq. 5 gate, windows of 63 signals, a cycle per 8;
    sync with TIDE_SYNC_STEPS steps a cycle, or async with TIDE_STEPS and
    reseed_window 16.  ``kw`` adds fields (the fleet phase's ``fleet``)."""
    from repro_torch.core.tide import TideConfig
    mode = (dict(train_min_steps=TIDE_STEPS, async_train=True,
                 reseed_window=16) if async_train
            else dict(train_min_steps=TIDE_SYNC_STEPS))
    return TideConfig(gamma=GLM["GAMMA"], batch_size=8, max_len=1024,
                      superstep_rounds=8, adaptive_spec=False,
                      signal_window=GLM["TRAIN_WINDOW"], n_threshold=8,
                      train_epochs=2, seed=0, **mode, **kw)


def _tide_streams(system):
    """The tide phases' two streams on ``system``: the 16 requests, then
    the first TIDE_STREAM2, each to its budget, the device synchronized
    after each.  Returns (streams, walls, timeline marks)."""
    eng = system.engine
    streams, walls, marks = [], [], []
    for n in (16, TIDE_STREAM2):
        reqs = _serve_requests(eng.cfg.vocab_size)[:n]
        marks.append(len(eng.stats.timeline))
        t0 = time.perf_counter()
        system.run_stream(iter(reqs))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        assert all(r.finish_t is not None and len(r.generated) == 64
                   for r in reqs), "a request did not finish"
        streams.append([list(r.generated) for r in reqs])
    return streams, walls, marks


def phase_tide(cfg, params, dcfg, dparams, dense, dense_streams):
    """The synchronous adaptation loop on the card: ``TideSystem`` in sync
    mode on the serve phase's weights and untrained draft serves the 16
    requests as a stream, training at request-completion boundaries
    (the first cycle after the 8th window, deployed at the next
    dispatch), then a second stream of the first ``TIDE_STREAM2``
    prompts with the deployed draft.  Both streams must equal the
    serve's, the gate must
    have deployed, the second stream's mean accepted length must be
    above 1.0, and every cycle must launch the attention backward twice
    a step.  Acceptance inside the first stream is reported only."""
    import gc

    from repro_torch.core.tide import TideSystem
    from repro_torch.kernels.flash_attn.ops import flash_attention_bwd
    tc = _tide_config()
    system = TideSystem(cfg, params, tc, dparams=dparams, device="cuda")
    eng = system.engine
    fns = dict(_kernel_fns(), flash_attention_bwd=flash_attention_bwd)
    deploys, cycles = [], []
    poll_deploy, train_cycle = eng._poll_deploy, system.trainer.train_cycle

    def polled(source=None):
        ver = poll_deploy(source)
        if ver is not None:
            deploys.append({"seq": ver.seq, "round": eng.stats.steps,
                            "superstep": eng.stats.dispatches})
        return ver

    def counted(*a, **kw):
        fwd, bwd = fns["flash_attention"].launches, flash_attention_bwd.launches
        res = train_cycle(*a, **kw)
        cycles.append({"flash_attention": fns["flash_attention"].launches
                       - fwd, "flash_attention_bwd":
                       flash_attention_bwd.launches - bwd})
        return res

    eng._poll_deploy, system.trainer.train_cycle = polled, counted
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "tree_launches"):
            fn.tree_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    streams, walls, marks = _tide_streams(system)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in fns.items()}
    timeline = list(eng.stats.timeline)
    assert len(timeline) == eng.stats.steps, "the timeline ring dropped"
    one, two = timeline[:marks[1]], timeline[marks[1]:]
    first = deploys[0]["round"] if deploys else len(one)
    events = [{k: e[k] for k in ("eval_acc", "train_acc", "baseline",
                                 "deployed", "steps", "seconds",
                                 "engine_steps")} | cyc
              for e, cyc in zip(system.events, cycles)]
    row = {"phase": "tide", "model": cfg.name,
           "requests": [16, TIDE_STREAM2],
           "config": {k: getattr(tc, k) for k in (
               "batch_size", "max_len", "gamma", "superstep_rounds",
               "signal_window", "n_threshold", "train_epochs",
               "train_min_steps", "selective_training", "adaptive_spec")},
           "cycles": len(events), "events": events, "deploys": deploys,
           "gate_version": system.gate.version,
           "stream_wall_s": walls,
           "stream1_rounds": len(one), "stream2_rounds": len(two),
           "stream1_accept_before_first_deploy": _mean_accept(one[:first]),
           "stream1_accept_after_first_deploy": _mean_accept(one[first:]),
           "stream2_mean_accept_len": _mean_accept(two),
           "streams_equal_serve": [s == dense_streams[:len(s)]
                                   for s in streams],
           "serve_mean_accept_len": dense["mean_accept_len"],
           "summary": system.summary(), "launches": launches,
           "trainer_failures": system.service.failures,
           "trainer_last_error": system.service.last_error,
           "max_memory_allocated_GB": peak_gb, "nvidia_smi": smi()}
    emit(row)
    ran = (system.service.cycles, len(system.events), len(cycles))
    system.close()
    del system, eng
    gc.collect()
    torch.cuda.empty_cache()
    # drain() turns a cycle that raises into a count and goes on serving:
    # here any such cycle, or one that ran and left no event, is a fault
    assert row["trainer_failures"] == 0, \
        f"a train cycle failed: {row['trainer_last_error']}"
    assert ran[0] == ran[1] == ran[2] == row["summary"]["train_cycles"], \
        f"cycles run/recorded/trained differ: {ran}"
    assert streams[0] == dense_streams, "stream 1 != the serve's streams"
    assert streams[1] == dense_streams[:TIDE_STREAM2], \
        "stream 2 != the serve's streams"
    assert events and row["gate_version"] >= 1, "the gate never deployed"
    assert deploys and deploys[0]["round"] < len(one), \
        "no deploy inside the first stream"
    assert all(e["flash_attention_bwd"] == 2 * e["steps"] for e in events), \
        events
    assert row["stream2_mean_accept_len"] > 1.0, row["stream2_mean_accept_len"]
    return row


def _drive_reseed(cfg, params, dcfg, dp, reqs, **kw):
    """An engine with a capture ring: the prologue of ``reqs`` and three
    supersteps (24 rounds, every lane still active), with draft ``dp``.
    Returns (engine, dcache, state)."""
    from repro_torch.core import speculative as spec
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.policy import ServingConfig
    from repro_torch.serving.scheduler import Scheduler
    dev = torch.device("cuda")
    eng = ServingEngine(cfg, params, dcfg, dp, device=dev,
                        deploy_source=lambda: None, config=ServingConfig(
                            batch_size=8, max_len=1024, gamma=GLM["GAMMA"],
                            superstep_rounds=8, reseed_window=24, **kw))
    sched = Scheduler(8, iter(reqs))
    eng._assign_sids(sched.admit())
    cache, dcache, carry, first = eng._prologue(reqs)
    state = spec.init_superstep_state(
        carry, first, sids=torch.as_tensor(eng._slot_sids(reqs), device=dev),
        capture_window=eng.reseed_window)
    mx = torch.full((8,), 64, dtype=torch.int32, device=dev)
    for _ in range(3):
        out = eng._superstep(cache, dcache, state, mx,
                             eng.policy.speculation.dispatch_table())
        cache, dcache, state = out["cache"], out["dcache"], out["state"]
    torch.cuda.synchronize()
    assert bool(state.active.all()), "a lane finished inside the window"
    return eng, dcache, state


def _timed_reseed(eng, dp, dcache, state):
    """One re-seed, timed on the host clock (its enqueue) and by CUDA
    events around it; returns (dcache, host_ms, event_ms)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    out = eng._reseed_fn(dp, dcache, state)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return out, host_ms, start.elapsed_time(end)


def phase_reseed(cfg, params, dcfg, dparams):
    """The deploy-time re-seed at full width: JAX's
    test_reseed_matches_new_draft_serving on the card, its idempotence
    within bounds, and the paged re-seed against the dense one."""
    import gc

    from repro_torch.core import eagle, paging
    draft_b = eagle.draft_init(dcfg, 99, device=torch.device("cuda"))
    reqs = _serve_requests(cfg.vocab_size)[:8]
    launches0 = {k: f.launches for k, f in _kernel_fns().items()}

    def fresh():
        return [type(r)(prompt=list(r.prompt), max_new_tokens=64)
                for r in reqs]

    eng_a, dc_a, st_a = _drive_reseed(cfg, params, dcfg, dparams, fresh())
    _, dc_b, st_b = _drive_reseed(cfg, params, dcfg, draft_b, fresh())
    w = eng_a.reseed_window
    n = torch.clamp(st_a.cap_count, max=w)
    assert bool((n > 0).all()), "the capture ring never filled"
    len_a, len_b = dc_a["lengths"].tolist(), dc_b["lengths"].tolist()
    spans = [(int(len_a[i] - n[i]), min(len_a[i], len_b[i]))
             for i in range(8)]
    assert all(hi > lo for lo, hi in spans), spans

    def window(dc):
        return {leaf: torch.cat([dc[leaf][i, lo:hi]
                                 for i, (lo, hi) in enumerate(spans)])
                for leaf in ("k", "v")}

    a_before = {k: v.clone() for k, v in dc_a.items()}
    win_a = window(a_before)
    # JAX's shape, the window in one pass (M = 8 * 24 rows a product):
    # reported beside the engine's blocks of gamma + 1 columns
    one = eagle.reseed_draft_rows_from_ring(
        dcfg, draft_b, params["embed"], {k: v.clone() for k, v in
                                         a_before.items()},
        st_a.cap_feats, st_a.cap_toks, st_a.cap_count)
    out, host_ms, event_ms = _timed_reseed(eng_a, draft_b, dc_a, st_a)
    win_r, win_b, win_one = window(out), window(dc_b), window(one)
    one_pass_rel_l2 = {
        leaf: float((win_one[leaf].float() - win_b[leaf].float()).norm()
                    / win_b[leaf].float().norm()) for leaf in ("k", "v")}
    equal_b = all(torch.equal(win_r[leaf], win_b[leaf])
                  for leaf in ("k", "v"))
    err = {leaf: hold(win_r[leaf], win_b[leaf], f"reseed {leaf} vs B")
           for leaf in ("k", "v")}
    moved = {leaf: float((win_r[leaf].float() - win_a[leaf].float()).norm()
                         / win_a[leaf].float().norm()) for leaf in ("k", "v")}
    assert min(moved.values()) > 100 * REL_L2_TOL, moved
    # A re-seeded with A: within the same bounds of A's own rows
    same = {k: v.clone() for k, v in a_before.items()}
    same, same_host_ms, same_event_ms = _timed_reseed(eng_a, dparams, same,
                                                      st_a)
    win_s = window(same)
    err_same = {leaf: hold(win_s[leaf], win_a[leaf], f"reseed {leaf} vs A")
                for leaf in ("k", "v")}
    bitwise_same = all(torch.equal(same[leaf], a_before[leaf])
                       for leaf in ("k", "v"))
    # paged: the same lanes through page 16, re-seeded with B
    eng_p, dc_p, st_p = _drive_reseed(cfg, params, dcfg, dparams, fresh(),
                                      page_size=GLM["P"])
    assert torch.equal(st_p.cap_count, st_a.cap_count)
    assert torch.equal(dc_p["lengths"], dc_a["lengths"])
    pout, p_host_ms, p_event_ms = _timed_reseed(eng_p, draft_b, dc_p, st_p)
    paged_equal = {}
    for leaf in ("k", "v"):
        view = paging.gather_view(pout[leaf], pout["tbl"])
        paged_equal[leaf] = all(
            torch.equal(view[i, lo:hi], out[leaf][i, lo:hi])
            for i, (lo, hi) in enumerate(spans))
    for lane in range(8):
        eng_p.allocator.free_lane(lane)
    eng_p.release_prefix_cache()
    eng_p.allocator.assert_clean()
    launches = {k: f.launches - launches0[k]
                for k, f in _kernel_fns().items()}
    row = {"phase": "reseed", "model": cfg.name, "batch": 8,
           "max_len": 1024, "gamma": GLM["GAMMA"], "reseed_window": w,
           "cap_count": st_a.cap_count.tolist(), "lengths_a": len_a,
           "lengths_b": len_b, "window_rows": sum(hi - lo for lo, hi in spans),
           "max_abs_err_rel_l2_vs_b": err, "equal_b_bitwise": equal_b,
           "one_pass_rel_l2_vs_b": one_pass_rel_l2,
           "rel_l2_moved_from_a": moved,
           "max_abs_err_rel_l2_same_draft": err_same,
           "same_draft_bitwise": bitwise_same,
           "paged_equal_dense": paged_equal,
           "host_ms": {"dense": host_ms, "dense_same_draft": same_host_ms,
                       "paged": p_host_ms},
           "event_ms": {"dense": event_ms,
                        "dense_same_draft": same_event_ms,
                        "paged": p_event_ms},
           "launches": launches, "nvidia_smi": smi()}
    emit(row)
    assert all(paged_equal.values()), paged_equal
    del eng_a, eng_p, dc_a, dc_b, dc_p, out, pout, same, a_before, one
    gc.collect()
    torch.cuda.empty_cache()


def phase_tide_async(cfg, params, dcfg, dparams, dense, dense_streams,
                     sync_row):
    """The asynchronous adaptation loop on the card: ``TideSystem`` with
    ``async_train=True`` serves the 16 requests, then the first
    ``TIDE_STREAM2`` again, while its service thread trains on its own
    CUDA stream, and each deploy picked up at a
    superstep re-seeds the resident lanes' draft caches.  Streams and
    supersteps are timed with the serving stream's synchronize (a
    device-wide one would wait for training too)."""
    import gc
    import threading

    from repro_torch.core.tide import TideSystem
    from repro_torch.core.transport import pick_training_device
    from repro_torch.kernels.flash_attn.ops import flash_attention_bwd
    tc = _tide_config(async_train=True)
    fns = dict(_kernel_fns(), flash_attention_bwd=flash_attention_bwd)
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "tree_launches"):
            fn.tree_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    system = TideSystem(cfg, params, tc, dparams=dparams, device="cuda")
    eng, svc = system.engine, system.service
    assert svc.running and svc._stream is not None
    serving = torch.cuda.current_stream()
    assert svc._stream != serving
    deploys, cycles, steps_ms = [], [], []
    in_flight = threading.Event()
    poll_deploy, train_cycle = eng._poll_deploy, system.trainer.train_cycle
    superstep = eng._superstep

    def polled(source=None):
        ver = poll_deploy(source)
        if ver is not None:
            deploys.append({"seq": ver.seq, "round": eng.stats.steps,
                            "superstep": eng.stats.dispatches,
                            "stream": len(walls) + 1,
                            "in_flight": in_flight.is_set()})
        return ver

    def counted(*a, **kw):
        bwd = flash_attention_bwd.launches
        rec = {"dispatches_start": eng.stats.dispatches,
               "t_start": time.perf_counter() - t_phase,
               "stream": torch.cuda.current_stream() == svc._stream}
        in_flight.set()
        try:
            res = train_cycle(*a, **kw)
        finally:
            in_flight.clear()
        rec.update(dispatches_end=eng.stats.dispatches,
                   t_end=time.perf_counter() - t_phase,
                   flash_attention_bwd=flash_attention_bwd.launches - bwd)
        cycles.append(rec)
        return res

    def timed(*a, **kw):
        serving.synchronize()
        during = in_flight.is_set()
        s = time.perf_counter()
        out = superstep(*a, **kw)
        serving.synchronize()
        steps_ms.append(((time.perf_counter() - s) * 1e3,
                         during or in_flight.is_set()))
        return out

    eng._poll_deploy, system.trainer.train_cycle = polled, counted
    eng._superstep = timed
    t_phase = time.perf_counter()
    streams, walls, marks = [], [], []
    while len(streams) < 2 or (not deploys and len(streams) < 3):
        reqs = _serve_requests(cfg.vocab_size)[
            :TIDE_STREAM2 if streams else 16]
        marks.append(len(eng.stats.timeline))
        serving.synchronize()
        t0 = time.perf_counter()
        system.run_stream(iter(reqs))
        serving.synchronize()
        walls.append(time.perf_counter() - t0)
        assert all(r.finish_t is not None and len(r.generated) == 64
                   for r in reqs), "a request did not finish"
        streams.append([list(r.generated) for r in reqs])
    served_s = time.perf_counter() - t_phase
    thread = svc._thread
    t0 = time.perf_counter()
    svc.close(timeout=600.0)
    close_s = time.perf_counter() - t0
    thread_alive = thread is not None and thread.is_alive()
    failures = svc.failures
    system.close()                     # a second close: a no-op
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in fns.items()}
    timeline = list(eng.stats.timeline)
    assert len(timeline) == eng.stats.steps, "the timeline ring dropped"
    bounds = marks[1:] + [len(timeline)]
    parts = [timeline[a:b] for a, b in zip(marks, bounds)]
    first = deploys[0]["round"] - marks[deploys[0]["stream"] - 1] \
        if deploys else None
    events = [{k: e[k] for k in ("eval_acc", "train_acc", "baseline",
                                 "deployed", "steps", "seconds",
                                 "engine_steps")} | cyc
              for e, cyc in zip(system.events, cycles)]
    during = [ms for ms, d in steps_ms if d]
    outside = [ms for ms, d in steps_ms if not d]
    summary = system.summary()
    row = {"phase": "tide_async", "model": cfg.name,
           "requests": [len(x) for x in streams],
           "config": {k: getattr(tc, k) for k in (
               "batch_size", "max_len", "gamma", "superstep_rounds",
               "signal_window", "n_threshold", "train_epochs",
               "train_min_steps", "async_train", "reseed_window")},
           "device_count": torch.cuda.device_count(),
           "pick_training_device": str(pick_training_device()),
           "cycles": len(events), "events": events, "deploys": deploys,
           "gate_version": system.gate.version,
           "reseeds": summary["reseeds"], "deploys_picked": summary["deploys"],
           "superstep_ms_mean_during_cycle":
               statistics.mean(during) if during else None,
           "superstep_ms_mean_outside_cycle":
               statistics.mean(outside) if outside else None,
           "supersteps_during_cycle": len(during),
           "supersteps_outside_cycle": len(outside),
           "stream_wall_s": walls, "tide_sync_stream_wall_s":
               sync_row["stream_wall_s"],
           "stream_rounds": [len(p) for p in parts],
           "stream1_accept_after_first_deploy": (
               _mean_accept(parts[0][first:])
               if deploys and deploys[0]["stream"] == 1 else None),
           "stream_mean_accept_len": [_mean_accept(p) for p in parts],
           "streams_equal_serve": [x == dense_streams[:len(x)]
                                   for x in streams],
           "serve_mean_accept_len": dense["mean_accept_len"],
           "backward_launches_per_step": [
               e["flash_attention_bwd"] / max(e["steps"], 1) for e in events],
           "thread_cap": svc.stats()["thread_cap"],
           "served_s": served_s, "close_s": close_s,
           "summary": summary, "launches": launches,
           "trainer_failures": failures,
           "trainer_last_error": svc.last_error,
           "max_memory_allocated_GB": peak_gb, "nvidia_smi": smi()}
    emit(row)
    ran = (svc.cycles, len(system.events), len(cycles))
    del system, eng, svc
    gc.collect()
    torch.cuda.empty_cache()
    assert failures == 0 == row["trainer_failures"], \
        f"a train cycle failed: {row['trainer_last_error']}"
    assert not thread_alive, "the training thread outlived close()"
    assert ran[0] == ran[1] == ran[2] >= 1, f"cycles run/recorded: {ran}"
    assert all(c["stream"] for c in cycles), "a cycle ran off its stream"
    assert all(s == dense_streams[:len(s)] for s in streams), \
        "an async stream != the serve's streams"
    assert any(c["dispatches_end"] > c["dispatches_start"] for c in cycles), \
        "no superstep was dispatched while a cycle ran"
    assert row["gate_version"] >= 1 and deploys, \
        "no deploy was picked up inside a stream"
    assert row["reseeds"] == row["deploys_picked"] == len(deploys), row
    assert all(e["flash_attention_bwd"] == 2 * e["steps"] for e in events), \
        events
    return row


# --------------------------------------------------------------- fleet
FLEET_KILL_WAIT_S = 30.0     # bound on noticing a killed trainer
FLEET_STREAM_S = 120.0       # bound on the stream served after the kill
FLEET_PEAK_GB = 4.0          # two replicas' peak above the tide phase's


def _draft_frames(svc) -> list:
    """Each DRAFT frame a ``RemoteTrainingService`` received: its bytes,
    the trainer's encode and send seconds and the serving side's decode
    and copy seconds (host clocks)."""
    sent = [t for t in svc.wire_log["trainer"] if "wire_draft_bytes" in t]
    return [{"seq": d["seq"], "bytes": d["bytes"],
             "encode_s": t["wire_draft_encode_s"],
             "send_s": t["wire_draft_send_s"],
             "decode_s": d["decode_s"], "copy_s": d["copy_s"]}
            for d, t in zip(svc.wire_log["drafts"], sent)]


def _wire_row(svc) -> dict:
    """A remote trainer's wire figures: spawn to ready, the INIT frame on
    both sides, every DRAFT frame, both processes' peak RSS (the serving
    process's over the whole run; the trainer's largest sample, taken
    where it holds the most) and the trainer's device peak."""
    from repro_torch.fleet.trainer_main import peak_rss_mb
    log = svc.wire_log
    trainer = [log.get("trainer_ready", {})] + log["trainer"]
    return {"trainer_pid": log.get("trainer_pid"),
            "spawn_to_ready_s": log.get("spawn_to_ready_s"),
            "init": dict(log["init"], decode_s=trainer[0].get(
                "wire_init_decode_s"), copy_s=trainer[0].get(
                "wire_init_copy_s")),
            "drafts": _draft_frames(svc),
            "peak_rss_mb": {"serving": peak_rss_mb(), "trainer_sampled": max(
                (t["wire_rss_mb"] for t in trainer
                 if t.get("wire_rss_mb") is not None), default=None)},
            "trainer_device_peak_gb": max(
                (t.get("wire_device_peak_gb", 0.0) for t in trainer),
                default=None),
            "frames_sent": svc.frames_sent, "bytes_sent": svc.bytes_sent,
            "frames_recv": svc.frames_recv, "bytes_recv": svc.bytes_recv}


def _served_kernels(fns) -> dict:
    """The serving process's launches since the counts were zeroed; the
    verify and prefill kernels must have launched."""
    launches = {name: fn.launches for name, fn in fns.items()}
    assert launches["verify_attention"] > 0 \
        and launches["flash_attention"] > 0, launches
    return launches


def _fleet_remote_sync(cfg, params, dparams, dense_streams, tide_row):
    """(a) The tide phase's ``TideSystem`` with its trainer spawned in a
    process of its own: the same two streams must give the tide phase's
    streams, cycles, deploy rounds and second-stream accepted length."""
    from repro_torch.core.tide import TideSystem
    from repro_torch.fleet import FleetConfig
    fns = _kernel_fns()
    _zero_counts(fns)
    t0 = time.perf_counter()
    system = TideSystem(cfg, params, _tide_config(
        fleet=FleetConfig(trainer_endpoint="spawn")), dparams=dparams,
        device="cuda")
    try:
        built_s = time.perf_counter() - t0
        eng, svc = system.engine, system.service
        deploys = []
        poll_deploy = eng._poll_deploy

        def polled(source=None):
            ver = poll_deploy(source)
            if ver is not None:
                deploys.append({"seq": ver.seq, "round": eng.stats.steps,
                                "superstep": eng.stats.dispatches})
            return ver

        eng._poll_deploy = polled
        streams, walls, marks = _tide_streams(system)
    finally:
        system.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    keys = ("eval_acc", "train_acc", "baseline", "deployed", "steps",
            "engine_steps")
    events = [{k: e[k] for k in keys + ("seconds",)} for e in system.events]
    two = list(eng.stats.timeline)[marks[1]:]
    row = {"phase": "fleet", "run": "remote_sync", "endpoint": "spawn",
           "system_built_s": built_s, **_wire_row(svc),
           "cycles": len(events), "events": events, "deploys": deploys,
           "gate_version": system.gate.version,
           "events_equal_tide": [
               all(e[k] == f[k] for k in keys)
               for e, f in zip(events, tide_row["events"])],
           "stream_wall_s": walls,
           "stream2_mean_accept_len": _mean_accept(two),
           "tide": {k: tide_row[k] for k in (
               "cycles", "deploys", "stream_wall_s",
               "stream2_mean_accept_len", "max_memory_allocated_GB")},
           "streams_equal_serve": [s == dense_streams[:len(s)]
                                   for s in streams],
           "launches": _served_kernels(fns), "summary": system.summary(),
           "trainer_failures": svc.failures,
           "trainer_last_error": svc.last_error,
           "max_memory_allocated_GB": peak_gb, "nvidia_smi": smi()}
    emit(row)
    assert svc._proc.poll() is not None, "the trainer outlived close()"
    assert row["trainer_failures"] == 0, row["trainer_last_error"]
    assert all(row["streams_equal_serve"]), "a remote stream != the serve's"
    assert row["cycles"] == tide_row["cycles"], \
        f"cycles {row['cycles']} != the tide phase's {tide_row['cycles']}"
    assert deploys == tide_row["deploys"], \
        f"deploy rounds {deploys} != the tide phase's {tide_row['deploys']}"
    assert row["stream2_mean_accept_len"] == \
        tide_row["stream2_mean_accept_len"], row["stream2_mean_accept_len"]
    return row


def _overlapping(spans, windows) -> list:
    return [any(s < b and e > a for a, b in windows) for s, e in spans]


def _fleet_remote_async(cfg, params, dparams, dense_streams, async_row):
    """(b) The tide_async configuration with a spawned trainer: streams of
    the 16 requests (then of the first TIDE_STREAM2) until a deploy is
    picked up; each superstep timed on the serving stream and set
    against the trainer's cycles (their ends on the host's monotonic
    clock, less their seconds).  Then the trainer is killed and a stream
    of TIDE_STREAM2 requests served on the last deployed draft."""
    from repro_torch.core.tide import TideSystem
    from repro_torch.fleet import FleetConfig
    fns = _kernel_fns()
    _zero_counts(fns)
    system = TideSystem(cfg, params, _tide_config(
        async_train=True, fleet=FleetConfig(trainer_endpoint="spawn")),
        dparams=dparams, device="cuda")
    try:
        eng, svc = system.engine, system.service
        serving = torch.cuda.current_stream()
        deploys, spans, streams, walls = [], [], [], []
        poll_deploy, superstep = eng._poll_deploy, eng._superstep

        def polled(source=None):
            ver = poll_deploy(source)
            if ver is not None:
                deploys.append({"seq": ver.seq, "round": eng.stats.steps,
                                "superstep": eng.stats.dispatches,
                                "stream": len(walls) + 1})
            return ver

        def timed(*a, **kw):
            serving.synchronize()
            s = time.perf_counter()
            out = superstep(*a, **kw)
            serving.synchronize()
            spans.append((s, time.perf_counter()))
            return out

        eng._poll_deploy, eng._superstep = polled, timed

        def stream(n):
            reqs = _serve_requests(cfg.vocab_size)[:n]
            serving.synchronize()
            t0 = time.perf_counter()
            system.run_stream(iter(reqs))
            serving.synchronize()
            walls.append(time.perf_counter() - t0)
            assert all(r.finish_t is not None and len(r.generated) == 64
                       for r in reqs), "a request did not finish"
            streams.append([list(r.generated) for r in reqs])

        while not streams or (not deploys and len(streams) < 3):
            stream(TIDE_STREAM2 if streams else 16)
        cycles = list(zip(svc.events, svc.wire_log["trainer"]))
        windows = [(t["wire_cycle_end_t"] - e["seconds"],
                    t["wire_cycle_end_t"]) for e, t in cycles]
        # a DRAFT from the trainer's encode to the serving side's copy
        sent = [t for _, t in cycles if "wire_draft_bytes" in t]
        transfers = [(t["wire_cycle_end_t"], d["t_end"])
                     for d, t in zip(svc.wire_log["drafts"], sent)]
        during = _overlapping(spans, windows)
        moving = _overlapping(spans, transfers)
        ms = [(e - s) * 1e3 for s, e in spans]
        before = {"cycles": len(cycles), "deploys": len(deploys),
                  "supersteps": len(spans)}
        t0 = time.perf_counter()
        svc.kill_trainer()
        while svc.running and time.perf_counter() - t0 < FLEET_KILL_WAIT_S:
            time.sleep(0.05)
        dead_s = time.perf_counter() - t0
        # the receiver has handled every frame the trainer sent
        last = svc.poll()
        stream(TIDE_STREAM2)
        served_last = (last is not None and eng.dparams is last.dparams
                       and eng._deploy_seq == last.seq)
        running, failures = svc.running, svc.failures
        summary = system.summary()
    finally:
        t0 = time.perf_counter()
        system.close()
        close_s = time.perf_counter() - t0

    def mean(xs):
        return statistics.mean(xs) if xs else None
    d_ms = [m for m, d in zip(ms, during) if d]
    o_ms = [m for m, d in zip(ms, during) if not d]
    t_ms = [m for m, d, t in zip(ms, during, moving) if t and not d]
    i_ms = [m for m, d, t in zip(ms, during, moving) if not (t or d)]
    row = {"phase": "fleet", "run": "remote_async", "endpoint": "spawn",
           **_wire_row(svc),
           "cycles": before["cycles"], "events": [
               {k: e[k] for k in ("eval_acc", "train_acc", "baseline",
                                  "deployed", "steps", "seconds",
                                  "engine_steps")} for e, _ in cycles],
           "deploys": deploys, "reseeds": summary["reseeds"],
           "supersteps_during_cycle": len(d_ms),
           "supersteps_outside_cycle": len(o_ms),
           "superstep_ms_mean_during_cycle": mean(d_ms),
           "superstep_ms_mean_outside_cycle": mean(o_ms),
           "during_over_outside": (mean(d_ms) / mean(o_ms)
                                   if d_ms and o_ms else None),
           "supersteps_during_draft_transfer": len(t_ms),
           "superstep_ms_mean_during_draft_transfer": mean(t_ms),
           "supersteps_idle": len(i_ms), "superstep_ms_mean_idle": mean(i_ms),
           "in_process": {k: async_row[k] for k in (
               "supersteps_during_cycle", "supersteps_outside_cycle",
               "superstep_ms_mean_during_cycle",
               "superstep_ms_mean_outside_cycle", "stream_wall_s")},
           "stream_wall_s": walls,
           "streams_equal_serve": [s == dense_streams[:len(s)]
                                   for s in streams],
           "kill": {"dead_after_s": dead_s, "running": running,
                    "failures": failures, "last_seq": last and last.seq,
                    "served_last_draft": served_last,
                    "stream_wall_s": walls[-1], "close_s": close_s,
                    "last_error": svc.last_error},
           "launches": _served_kernels(fns), "summary": summary,
           "max_memory_allocated_GB": torch.cuda.max_memory_allocated()
           / 1e9, "nvidia_smi": smi()}
    emit(row)
    assert svc._proc.poll() is not None, "the trainer outlived close()"
    assert before["deploys"] >= 1, "no deploy was picked up"
    assert all(row["streams_equal_serve"]), "a remote stream != the serve's"
    assert not running and failures == 1, (running, failures)
    assert served_last, "the stream after the kill left the last draft"
    assert walls[-1] < FLEET_STREAM_S, walls
    assert row["reseeds"] == summary["deploys"] == len(deploys), row
    return row


def _fleet_replicas(cfg, params, dparams, dense_streams, tide_row):
    """(c) ``ServingFleet`` of two replicas over one params object with
    the in-process sync trainer, on the 16 requests, newest first: every
    stream equal to the serve's, both replicas used, a cycle, a deploy
    that reaches both replicas through the bus, and no second target in
    memory.

    Why newest first: on random weights a cycle's draft learns only what
    it saw, so a cycle deploys when its eval window (the last of its 8,
    the last lane's) repeats a training window: the tide phases deploy
    because their first cycle evaluates on request 7, which shares its
    prompt with 1, 3 and 5.  In arrival order the router gives replica 0
    requests 0, 3, 4, 6, 8, 10, 12, 14 and replica 1 1, 2, 5, 7, 9, 11,
    13, 15, and neither cycle evaluates on a repeat (both read eval 0.0
    on the card); newest first, replica 0 serves 15, 13, 10, 9, 7, 5, 3,
    1, so its cycle evaluates on request 1, and replica 1 picks its
    deploy up."""
    from repro_torch.fleet import FleetConfig
    from repro_torch.fleet.router import ServingFleet
    fns = _kernel_fns()
    _zero_counts(fns)
    fleet = ServingFleet(cfg, params, _tide_config(
        fleet=FleetConfig(replicas=2)), dparams=dparams, device="cuda")
    try:
        reqs = _serve_requests(cfg.vocab_size)
        t0 = time.perf_counter()
        fleet.serve(reqs[::-1])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        assert all(r.finish_t is not None and len(r.generated) == 64
                   for r in reqs), "a request did not finish"
    finally:
        fleet.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = fleet.summary()
    one_params = all(e.params is params for e in fleet.engines)
    row = {"phase": "fleet", "run": "replicas", "replicas": fleet.n,
           "wall_s": wall_s, "summary": summary,
           "same_params_object": one_params,
           "streams_equal_serve": [list(r.generated) for r in reqs]
           == dense_streams,
           "events": [{k: e[k] for k in ("eval_acc", "deployed", "steps",
                                         "seconds", "engine_steps")}
                      for e in fleet.events],
           "launches": _served_kernels(fns),
           "trainer_failures": fleet.service.failures,
           "max_memory_allocated_GB": peak_gb,
           "tide_max_memory_allocated_GB":
               tide_row["max_memory_allocated_GB"], "nvidia_smi": smi()}
    emit(row)
    assert row["streams_equal_serve"], "a fleet stream != the serve's"
    assert one_params, "a replica holds its own params"
    assert all(n > 0 for n in summary["router_assigned"]), summary
    assert summary["train_cycles"] >= 1 and summary["deployed"] >= 1 \
        and summary["bus"]["published"] >= 1, summary
    assert all(sub["delivered_seq"] >= 1 for sub in
               summary["bus"]["subscribers"].values()), summary["bus"]
    assert row["trainer_failures"] == 0
    assert peak_gb <= tide_row["max_memory_allocated_GB"] + FLEET_PEAK_GB, \
        f"two replicas peak at {peak_gb} GB"
    return row


def phase_fleet(cfg, params, dcfg, dparams, dense_streams, tide_row,
                async_row):
    """The fleet on glm4-9b: (a) a spawned trainer in sync mode, (b) in
    async mode then killed, (c) two replicas behind the in-process
    trainer.  Each run frees what it made before the next."""
    import gc
    for run in (partial(_fleet_remote_sync, tide_row=tide_row),
                partial(_fleet_remote_async, async_row=async_row),
                partial(_fleet_replicas, tide_row=tide_row)):
        run(cfg, params, dparams, dense_streams)
        gc.collect()
        torch.cuda.empty_cache()


def _train_step_split(trainer, dparams, batches, steps: int = 5) -> dict:
    """Where a train step's time goes, on fresh trainable copies of
    ``dparams`` and the first batch: the host clock around the loss
    forward, ``autograd.grad`` and the optimizer update of each step,
    each ending in a synchronize (medians of ``steps`` after a warm-up),
    then ``torch.profiler`` over ``steps`` whole steps (device ms by
    kernel class, per step).  Runs last in its process: a profiler
    session makes every later launch dearer (obs/timing.py)."""
    from torch.profiler import ProfilerActivity, profile
    (tf, tt), _ = trainer.make_arrays(batches)
    feats, toks = trainer.device_arrays(tf[:trainer.batch_size],
                                        tt[:trainer.batch_size])
    params = trainer.trainable(dparams)
    state = trainer.opt.init(params)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    split = {"forward": [], "backward": [], "update": []}
    for it in range(steps + 1):
        (loss, _), f_ms = timed(lambda: trainer.loss(params, feats, toks,
                                                     trainer.ttt))
        grads, b_ms = timed(lambda: torch.autograd.grad(
            loss, list(params.values())))
        _, u_ms = timed(lambda: trainer.opt.update(
            params, dict(zip(params, grads)), state, it))
        if it:
            for k, v in zip(split, (f_ms, b_ms, u_ms)):
                split[k].append(v)
    out = {f"{k}_ms": statistics.median(v) for k, v in split.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(steps):
            trainer.step(params, state, feats, toks, steps + 1 + it)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev = _device_classes(prof.key_averages(), per=steps)
    out.update(profiled_steps=steps, wall_ms_per_step=wall_ms,
               device_busy_ms_per_step=dev["device_busy_ms"],
               idle_share=1.0 - dev["device_busy_ms"] / wall_ms,
               classes_per_step=dev["classes"], top_per_step=dev["top"])
    return out


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "attn_rows" in n or "mma_rows" in n or "flash_bwd" in n:
        return "attention kernels (port)"
    if "extract_pack" in n:
        return "extract_pack (port)"
    if "linear_rows" in n:
        return "linear_rows (port)"
    if "threefry" in n or "categorical" in n:
        return "sampling kernels (port)"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "xmma" in n \
            or "splitk" in n or "nvjet" in n:   # nvjet: cuBLAS's sm90 GEMMs
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, reductions)"


def _blocking(name: str) -> bool:
    """A CUDA runtime call or copy that makes the host wait."""
    return "Synchronize" in name or "Pageable" in name


def _device_classes(events, per: float = 1.0) -> dict:
    """A profile's device time from its ``key_averages()``: busy ms, ms
    and launches by kernel class and the ten heaviest kernels, each
    divided by ``per``."""
    from torch.autograd import DeviceType
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        return us / 1e3 / per

    classes = {}
    for e in kernels:
        c = classes.setdefault(_kernel_class(e.key), [0.0, 0])
        c[0] += dev_ms(e)
        c[1] += e.count / per
    return {"device_busy_ms": sum(dev_ms(e) for e in kernels),
            "classes": {k: {"ms": v[0], "launches": v[1]}
                        for k, v in sorted(classes.items())},
            "top": [{"kernel": e.key[:90], "ms": dev_ms(e),
                     "count": e.count / per}
                    for e in sorted(kernels, key=dev_ms, reverse=True)[:10]]}


# the profile phase's new tokens a request: the first token and one
# superstep, of which 2 rounds decode (17, two supersteps, until the
# sampled phases needed the time; 9, 8 rounds, until the fleet phase
# did: a profile's seconds follow its launches)
PROFILE_NEW = 3
# each profile's seconds (the serve, the profiler's processing, the
# phase's reading), for the total line
PROFILE_S = {}


def phase_profile(eng, which="dense"):
    """Where a serve's time goes: ``torch.profiler`` over a short stream
    on a served engine (8 requests, prompt 256, PROFILE_NEW new tokens:
    one prologue prefill and one superstep), with the count of
    host-blocking CUDA calls.  Returns that count."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    reqs = _requests(np.random.default_rng(6), 8, 256, 256, PROFILE_NEW,
                     eng.cfg.vocab_size)
    torch.cuda.synchronize()
    syncs0 = eng.host_syncs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve_stream(iter(reqs))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = _device_classes(events)
    blocking = {e.key: e.count for e in events if _blocking(e.key)}
    PROFILE_S[which] = round(time.perf_counter() - t_phase, 1)
    emit({"phase": "profile", "engine": which, "requests": len(reqs),
          "new_tokens": PROFILE_NEW,
          "host_syncs": eng.host_syncs - syncs0, "blocking_calls": blocking,
          "wall_ms": wall_ms, "device_busy_ms": dev["device_busy_ms"],
          "idle_share": 1.0 - dev["device_busy_ms"] / wall_ms,
          "classes": dev["classes"], "top": dev["top"],
          "seconds": PROFILE_S[which]})
    return blocking


def profile_against(eng, which, blocking):
    """Profile a served engine and hold it to the chain's blocking
    calls: no paged or tree serve may block the host more."""
    more = phase_profile(eng, which)
    assert all(n <= blocking.get(k, 0) for k, n in more.items()), \
        f"{which} serve blocks the host more: {more} vs {blocking}"


def main():
    phase_env()
    rows = phase_kernels_apart()
    launch = phase_launch_apart()
    families = phase_families_apart()
    phase_ladder()
    launches, eng, dense, dense_streams, signals = phase_serve()
    phase_cobatch(eng)
    blocking = phase_profile(eng, "dense")
    paged = phase_paged_serve(eng, dense, dense_streams, blocking)
    for name in ("verify_attention_paged", "flash_attention_paged"):
        launches[name] = paged[name]
    trees = phase_tree_serve(eng, dense, dense_streams, blocking)
    launches["verify_attention_tree"] = \
        trees[GLM["TREE_W"]][0]["verify_attention_tree"]
    ptree = phase_paged_tree_serve(
        eng, dense, dense_streams, {w: s for w, (_, s, _) in trees.items()},
        blocking)
    launches["verify_attention_paged_tree"] = \
        ptree["verify_attention_paged_tree"]
    sampled = phase_sampled_serve(eng, dense, trees[GLM["TREE_W"]][2])
    for name in ("threefry2x32", "categorical_rows"):
        launches[name] = sampled[name]
    chunked = phase_chunked_serve(eng, dense, dense_streams)
    t0 = time.perf_counter()
    overload = phase_overload_serve(eng)
    overload_s = time.perf_counter() - t0
    model = (eng.cfg, eng.params, eng.dcfg, eng.dparams)
    del eng, trees
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    launches["flash_attention_bwd"] = phase_train(*model, dense,
                                                  dense_streams, signals)
    t0 = time.perf_counter()
    tide_row = phase_tide(*model, dense, dense_streams)
    tide_s = time.perf_counter() - t0
    phase_reseed(*model)
    async_row = phase_tide_async(*model, dense, dense_streams, tide_row)
    t0 = time.perf_counter()
    phase_fleet(*model, dense_streams, tide_row, async_row)
    fleet_s = time.perf_counter() - t0
    del model
    emit({"phase": "total", "seconds": round(time.perf_counter() - T_START,
                                             1),
          "overload_serve_s": round(overload_s, 1),
          "tide_s": round(tide_s, 1), "fleet_s": round(fleet_s, 1),
          "profile_s": PROFILE_S})
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launch_phase_launches"] = launch.get(row["name"], 0)
        row["chunked_serve_launches"] = chunked.get(row["name"], 0)
        row["overload_serve_launches"] = overload.get(row["name"], 0)
        row["families_launches"] = families.get(row["name"], 0)
        assert row["launches"] > 0, f"{row['name']} had no main-path launch"
    emit({"kernels": [{k: row[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "launch_phase_launches", "chunked_serve_launches",
        "overload_serve_launches", "families_launches")}
        for row in rows]})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:] == ["--kernels"]:
        _use_checkout()
        phase_kernels()
    elif sys.argv[1:] == ["--launch"]:
        _use_checkout()
        phase_launch()
    elif sys.argv[1:] == ["--families"]:
        _use_checkout()
        phase_families()
    else:
        main()
