#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``). Imports only the
port (``kubedl_tpu_torch``), never JAX or the JAX package. Phases; any
failure raises and the script exits non-zero before its last line:

1. build — every kernel under ``kubedl_tpu_torch/csrc/`` with ``nvcc``
   for ``sm_90a`` (build seconds and ``ptxas`` resource lines printed);
2. forward kernel check — the flash forward against its plain PyTorch
   version on the card, on the serving path's shape, the edge cases and
   the training shape at b=1, each case on the route ``flash_fwd_route``
   gives it (``sm90``: the tensor-core kernel of ``flash_fwd_sm90.cu``
   for bf16/f16 at hd 64, 128 and 256; ``simt``: ``flash_fwd.cu`` for
   the rest), timed beside its plain version, SDPA, its bound and the
   earlier design (``flash_fwd.cu`` on the same bf16 inputs); then the
   decode tick's attention kernel (``paged_decode_sm90.cu``) against its
   plain version at the chat and batch cells' shapes, Gemma-2's hd 256
   with softcap and window and a tp=8 rank's head map, timed beside its
   bound, its plain version, the gathered-view einsum it replaced and
   SDPA, and a captured tick through it (``--phases decode`` alone);
3. serving — Llama-3-8B at full width, its first ``SERVE_LAYERS`` of 32
   layers (random bf16 weights from a seed), behind ``InferenceServer``
   over ``InferenceEngine``: ``:predict`` (buffered, streamed, and greedy
   held against ``greedy_rollout``),
   ``/v1/completions`` and ``/v1/embeddings``, whose every layer must
   launch the flash kernel once, every launch on the ``sm90`` route;
4. backward kernel check — the dQ and dK/dV kernels against their plain
   versions on the forward's cases and the training shape at b=1, each
   kernel on the route its own function gives (``flash_dq_route``,
   ``flash_dkv_route``; ``sm90``: the tensor-core kernels of
   ``flash_bwd_sm90.cu`` for bf16/f16 at hd 64, 128 and 256; ``simt``:
   ``flash_bwd.cu`` for the rest);
5. timing at the training shape (b=4, s=2048, Llama-3-8B's heads, bf16,
   causal) — each of the three kernels beside its plain version, SDPA's
   forward or backward, its bound and its earlier design (``simt``), and
   Δ (``flash_delta``);
6. training — ``python -m kubedl_tpu_torch.train``'s ``main`` in-process
   on Llama-3-8B at full width, 8 layers deep, batch 4 x 2048, 6 steps
   on one repeated batch: seconds per step, tokens/s, MFU, peak memory,
   falling loss and the kernels' launches per step, every forward and
   backward launch on the ``sm90`` route;
7. gradient check — every parameter's gradient at b=1 through the
   kernels against the gradient through the chunked attention path;
8. the kernels line (JSON), the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.

Between phases 3 and 4 run the predictor's engine (continuous batching,
the predictor subprocess), then the slice of Gemma, quantization and
LoRA: Llama-3-8B quantized to int8 and to int4 on the card (16 requests
on the graph route, the tick at 1/4/8 lanes against a bound on the
quantized bytes), adapter pages (3 adapters, 2 resident), Gemma-2B at
full width and depth in the engine (16 requests, ``/v1/embeddings`` on
K1's ``sm90`` route, the tick) and through ``python -m
kubedl_tpu_torch.serving`` (then its batch mode with
``KUBEDL_SERVING_QUANTIZE=int8``). The kernel checks and timings add
Gemma-2B's attention shapes and the edge cases at head dim 256 (K1, K2
and K3 on ``sm90``, each also beside its earlier ``simt`` design; K3 at
1, 2, 4 and 8 splits of the GQA group; K2 and K3 checked to repeat bit
for bit), and after phase 7 ``python -m kubedl_tpu_torch.train`` trains
``gemma.gemma_2b`` (full size, b=2, s=2048, 3 steps, every K1, K2 and K3
launch on ``sm90``), every gradient of a 2-layer Gemma-2B at full width
is checked against the chunked path,
and the slice's Llama configuration trains with ``"lora"`` (rank 16, 4
steps: the base stays bit for bit, the optimizer state is
adapter-sized).

After the Gemma predictor run the MoE family's phases: Mixtral-8x7B at
full width cut to 8 layers (bf16, dropless routing) in the predictor's
engine (16 requests through ``:predict`` held to the MoE reference,
at most ``MOE_HALF_SHARE`` of the tokens beyond ``NEAR_TIE``, and
planted lost K/V writes failing the check; ``/v1/embeddings`` with its 8
K1 launches on ``sm90``; the tick; the graph route's tokens equal to the
eager route's, dropless and at the preset's capacity factor 1.25), the
predictor subprocess on a 1-layer artifact, the same 8 layers widened to
float32 (held with ``NEAR_TIE``'s limits for dense models, and planted
lost K/V writes failing them too), 8 layers in int8 (32 until slice 18) built
one layer at a time on the card (the tick with bf16 activations; the 16 requests with
bf16 and with float32 activations through the near-tie check), and
after the LoRA run Mixtral width 2 layers deep through ``python -m
kubedl_tpu_torch.train`` (3 steps, every K1-K3 launch on ``sm90``, MFU
from the active params) and its gradient check (the chunked run routing
on its own may differ from the kernel run only at router near-ties; the
compared run replays the kernel run's expert choices). The kernel checks
add Mixtral's training shape (b=2, s=2048), all three kernels on
``sm90``, and after the MoE gradient check the three kernels are timed
there.

Then slice 10's phases, on google/gemma-2b's published config at full
width, its depth cut to ``SLICE10_LAYERS`` (the card machine's disk takes
45 GiB of writes a run): ``hf`` writes random bf16 weights as a
HuggingFace directory (two shards and the index) and converts it with
``python -m kubedl_tpu_torch.models.convert`` as a subprocess (the
artifact's config and every leaf as drawn, greedy tokens equal, K1 in
``/v1/embeddings``, ``--reverse`` back to float32 HF); ``lifecycle`` runs
``python -m kubedl_tpu_torch.train``'s ``main`` on the artifact at b=2 x
2048: two steps with a checkpoint and an eval, a fresh job that resumes
at step 2 (its restored state equal to what was saved), four steps
without a checkpoint (the resumed losses within 2e-3), ``mode:
evaluate`` (perplexity and multiple-choice choices held to
``llama.forward``'s logits) and ``mode: dpo`` (the first loss ln 2, then
falling; its ``export_hf_path`` reloads to the final weights); ``resnet``
trains ResNet-50 at b=128 bf16 (images/s), holds float32 logits on the
card to the CPU's, and has the MLP memorize a batch. Every K1-K3 launch
on those paths is on ``sm90``; the kernels line reports them by path.
``--phases hf,lifecycle,resnet,moe_timing,dist [--layers N]`` runs only
those after the build.

Since slice 11, right after the Gemma-2B training run, ``dist`` runs the
same training through the sharded path: the train entrypoint's ``main``
in-process under the operator's rendezvous contract for one process
(``KUBEDL_COORDINATOR_ADDRESS`` on a free localhost port), so ``main``
opens a world-size-1 NCCL group, lays ``"mesh": {"fsdp": -1}`` over it
and trains on DTensor state; its losses must equal the unsharded run's
(bit for bit expected; a gap is printed and held to the bf16 rule), every
K1-K3 launch is on ``sm90``, and its step time and peak memory print
beside the unsharded run's. Then a sharded ``llama.tiny`` state is saved
with ``torch.distributed.checkpoint`` under a new NCCL group and restored
bit for bit. Every group is destroyed before the next phase; the card
machine has one card, so no phase runs more than one rank.

Since slice 12, right after the adapter pages, tensor-parallel serving:
``tp`` opens a one-rank NCCL group and serves the continuous phase's
16 requests through ``ContinuousBatchingEngine(mesh=...)`` on the
``MeshConfig(dp=1, fsdp=1, tp=1)`` serving mesh (every device step
posted on the step channel, every tick on the graph route; tokens equal
to the continuous phase's bit for bit), reads the graph tick against the
unsharded one in turns, serves ``/v1/embeddings`` through the server on
that engine (one K1 launch a layer on ``sm90``, vectors equal bit for bit to an
unsharded server's), checks that ``build_engine(tp=2)`` refuses on one
card, and times K1 at one tp=2 rank's embeddings shape. ``tp2`` runs
tp=2 for real in two processes on the one card under gloo (NCCL refuses
two ranks on one device; the weights reach them over CUDA IPC): the
eager route, K1 checked at each rank's local shape, 8 Llama-3-8B and 4
Gemma-2B requests held to the unsharded reference by the near-tie check,
the embeddings forward as an engine step (K1 on each rank's own heads;
ids drawn over the whole vocabulary, so both vocab shards serve the
lookup) with rank 0's hidden states held to the unsharded forward
position by position, and each rank's peak memory. ``--phases tp,tp2`` runs them alone after
the unsharded continuous run they compare with.

Since slice 13, after the MoE timing, context and expert parallelism:
``ring`` runs ring attention for ``RING_CP`` = 4 ranks in one process
(``parallel.ring.ring_schedule``: the loops the ranks run, the shift a
rotation of the list) at Llama's training shape (shards of 512),
Gemma-2B's (hd 256) and Llama's heads in float32 (``simt``): forward and
gradients against the unsharded kernels by max abs and norm-wise
relative error, K1-K3 launched cp² times each on the route, the whole
ring's ms beside the unsharded kernels', Δ, each kernel at one ring
block beside its plain version, bound and SDPA, K1-K3 on one rank's rows
against the whole sequence's keys with split segment ids, and K1-K3
against their plain versions, timed, at [cp2]'s ring block and Ulysses
shape. ``cp2`` trains Llama-3-8B width (2 layers, one global batch of 2
x 4096) through the train entrypoint's ``main`` under ``"mesh": {"cp":
2}`` in two processes on the one card over gloo, on the ring and with
``cp_impl: "ulysses"``, against the same job unsharded; ``ep2`` trains
the ``moe_training`` job under ``"mesh": {"ep": 2}`` (4 of the 8 experts
a rank) against that phase's run. Every K1-K3 launch is on ``sm90``; the
losses, and the first step's hidden states, gradients and (ep) router
choices against the same step on one process, are held to
``MESH_BOUNDS``; each rank's step time and peak memory print.
``--phases ring,cp2,ep2`` runs them alone (``ep2`` after the MoE
training run it compares with).

Since slice 14, after ``ep2``, pipeline parallelism and GRPO: ``pp``
holds the training cell's configuration (Llama-3-8B width, 8 layers, b=4
x 2048) in 4 stages of one process (``parallel.pipeline.local_stages``,
the slots the ranks run) and checks the train entry's GPipe loss
(``build_pp_pretrain``, 4 microbatches) against the flat step and
``pipeline_grads_1f1b`` against GPipe on the same weights, with each
run's K1-K3 launches, time and peak memory and each stage's stash peak
beside 1F1B's ``max_inflight``, then K1-K3 at the microbatch shape.
``pp2`` trains Llama-3-8B width and Gemma-2B width (2 layers each)
through the train entrypoint's ``main`` under ``"mesh": {"pp": 2}`` in
two gloo processes on the one card, each against the same job unsharded
(``_hold_mesh_run``; the exchanges must go through the host). ``grpo``
runs ``main`` in ``mode: grpo`` on Gemma-2B at full size (2 rounds of 2
steps, 2 prompts x 4 completions of 32 tokens): the on-policy identity
at each round's first step, round 2's rollouts on the updated weights;
then ``rl.FlywheelLearner`` steps and publishes a small model, and the
continuous engine, refreshed in place with the published policy, samples
on it through its captured decode graphs. ``--phases pp,pp2,grpo`` runs
them alone.

Since slice 15, ``lifecycle``'s (a) and (b) are an in-cluster job of
the operator: the job's identity and ``KUBERNETES_SERVICE_HOST``, with
the port's ``KubeAPIServer`` over this script's stub API server (stdlib
``http.server``: GET and merge-PATCH on the one PyTorchJob path) handed
in as ``main``'s ``api``. (a) also has the env the operator renders for
the master of a one-pod PyTorchJob (``MASTER_ADDR`` 127.0.0.1, a free
``MASTER_PORT``, ``RANK`` 0, ``WORLD_SIZE`` 1, so ``main`` opens a
world-size-1 NCCL group and trains DTensor state). The stub raises
``ckpt-requested-version`` at step 2 of (a): the elastic agent's save
there replaces the periodic one (no more bytes written than before), and
its acknowledgement must land with the requested version. (b) has no
rendezvous contract, so it is one process with no group, as (c) is: it
restores (a)'s sharded save into plain tensors bit for bit, and its own
save at step 4, of plain tensors, is read back bit for bit. The phase
prints the poll's host time per step, the step time with the agent
((b)) beside the step time without it ((c)), and the elastic save's copy
and write, each with the card's name and power limit.

Since slice 16, after ``tp2``, ``replay`` runs the replays' request days
on the port's engines (``--phases replay``). Since slice 17, after it,
``spec`` decodes the serving phases' Llama-3-8B with the standalone
speculative engine (a draft cut to its first layers, then itself): its
tokens held to the static engine's greedy decode by the near-tie rule in
bf16 and exactly in float32 on the same weights cut to 2 layers, where a
self-draft must accept everything; then its adapter behind
``InferenceServer`` (``:predict``, the spec gauges on ``/metrics``,
``/v1/embeddings`` on the target's weights with K1 on ``sm90``).
``cp2`` also runs ``mode: evaluate`` (perplexity, multiple-choice
choices) and ``mode: dpo`` in the same two ranks, ring and Ulysses,
against the same jobs unsharded; ``ep2`` also serves Mixtral width over
``ep=2`` in two processes, its tokens equal to one process's
(``--phases spec,cp2,ep2``).

Since slice 18 ``moe_int8`` runs Mixtral at 8 of its 32 layers
(``MOE_INT8_LAYERS``) to keep the script inside its time limit, and three
phases join: ``auto``, after ``spec``, runs the serving auto-configurator's
search (``autoconfigure_multi``: batch 1 and 8, bf16 and int8, k 0 and 4)
on the serving phases' Llama-3-8B, checks ``kv_cache_bytes`` against the
engine's pool and serves [cont]'s first 4 requests through the winner's
env and the predictor's ``build_engine``; ``replay`` gains (d), both arms
of the multi-model fleet day held to the CPU's; ``native``, after the
gradient check, trains through ``data.kind: text`` on a 16.9 MB corpus
with every pack on the C++ packer (K1-K3 counted), then holds the packer
to the Python loop bit for bit with each one's tokens/s
(``--phases native,auto,replay``).

Since slice 19, after ``auto``, ``fed`` runs the federation day
(``FederationReplay``: three regions in lockstep, each a journaled,
replicated control plane with its scheduler and a two-replica serving
fleet, one region evacuated) with its six engines sharing the serving
phases' Llama-3-8B bf16 weights, held key by key to the same day on the
CPU on the tiny float32 model, every decode tick on the graph route,
K1-K3 counted for the kernels line; its journals go to a temporary
directory under ``build/chip_smoke/``, removed after the day
(``--phases fed``). To keep the script inside its time limit,
``gemma_predictor`` serves Gemma-2B cut to its first 4 of 18
(``GPRED_LAYERS``), and every serving phase's Llama-3-8B, ``replay``'s
days included, runs at its first 8 of 32 layers (``SERVE_LAYERS``).

Since slice 20, inside ``predictor``, after its batch mode and on the
same 2-layer artifact, ``op`` runs the port's operator in process as
``python -m kubedl_tpu_torch`` builds it (``parse_args``,
``config_from_args``, ``build_operator``, ``run``; SQLite storage under
``build/chip_smoke/``, tracing on): an ``Inference`` submitted through
the clientset becomes a Deployment and a pod, whose rendered container
command (``python -m kubedl_tpu_torch.serving``) the script runs as
kubelet would, with the rendered env (only the model path, the port and
``PYTHONPATH`` rewritten); then the console (``ConsoleServer`` over a
``DataProxy`` of the operator) lists it, proxies ``/v1/completions``
(the same answer as a direct call), ``:predict`` serves ``predictor``'s
tokens, ``InferenceClient.embed`` equals a raw ``/v1/embeddings`` bit
for bit, deleting the ``Inference`` takes the pod away and the
predictor exits 0 on SIGTERM, and the store and the console keep the
pod's record and the operator's events (``--phases op``: ``predictor``
and ``op`` alone).

The configurations the JAX package runs beside: ``tp2``'s two ranks also
serve Llama-3-8B's first 2 layers over ``fsdp=2`` (each rank JAX's
``embed`` shard, gathered per use), ``dp=2`` and ``pp=2`` (replicated,
the model's mesh showing them as 1), tokens held by the near-tie rule;
``tp8``, after ``tp2``, serves Qwen2-7B at full width, 2 layers deep,
over tp=8 in eight gloo processes on the card, its 28 query heads as 4
on ranks 0-3 and 3 on ranks 4-7 (K1 at each rank's heads, checked and
two of them timed), with the tokens held as above, the embeddings
against the unsharded forward and each rank's bytes; ``cp2``'s ranks
also take a packed Gemma-2-2B-width first step on the ring setting
(its knobs on the chunked path at global offsets) against one process
(``--phases tp2,tp8,cp2``). For the time limit ``tp2``'s Llama-3-8B run
at tp=2 serves ``TP2_REQS`` requests.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import unittest.mock
import urllib.request
from pathlib import Path

#: published H100 SXM peaks (NVIDIA data sheet), dense
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

#: the serving path's attention shape: the embeddings request below sends
#: two inputs, the longer 512 tokens, through Llama-3-8B's 32 q / 8 kv
#: heads of width 128
MAIN = dict(b=2, sq=512, sk=512, nh=32, nkv=8, hd=128, dtype="bfloat16",
            causal=True)
#: out within one bf16 ulp at unit scale (the kernel and the plain version
#: sum in different orders before rounding), f16 likewise at its 8x finer
#: ulp; f32 to its last digits; lse is f32 on both sides
ATOL = {"bfloat16": 1e-2, "float16": 2e-3, "float32": 2e-5, "lse": 1e-3}

#: the training path's attention shape: Llama-3-8B's heads at the
#: training slice's batch 4 x seq 2048
TRAIN = dict(b=4, sq=2048, sk=2048, nh=32, nkv=8, hd=128, dtype="bfloat16",
             causal=True)
#: dq/dk/dv sum up to reps * s terms of growing size: bf16 results within
#: 4 bf16 ulps (2**-7 each) at the scale of the largest value, f16 within
#: 4 of its ulps (2**-10), f32 within 1e-5 of that scale
BWD_TOL = {"bfloat16": 4 * 2.0 ** -7, "float16": 4 * 2.0 ** -10,
           "float32": 1e-5}
#: causal dq/dk/dv are large at the first rows and keys and small in the
#: bulk, so the bound above sits near a typical value. The norm-wise
#: relative error ||got - want|| / ||want|| cannot hide in the bulk: the
#: kernel and the plain version both sum in float32 and round once, so
#: bf16 results differ by at most one rounding (2**-8 relative) wherever
#: they differ, and f32 ones by reordered sums; the bound is twice that
BWD_NORM_TOL = {"bfloat16": 2 * 2.0 ** -8, "float16": 2 * 2.0 ** -11,
                "float32": 1e-5}
#: operations per kept (row, key) pair: K1 q.k and p.v; K2 adds dO.v and
#: ds.k; K3 q.k, dO.v, p^T.dO and ds^T.q
OPS_PER_PAIR = {"flash_forward": 4, "flash_dq": 6, "flash_dkv": 8}
TRAIN_STEPS = 6
#: the tensor-core kernels' designs, for the kernels line
DESIGN = {
    "flash_forward": "wgmma bf16, persistent grid (1 block per SM) dealing "
                     "(b*nh, 128 q rows) tiles heaviest first; TMA Q and a "
                     "3-stage ring of 128-key K/V tiles (K and V under "
                     "their own mbarriers) run on across tiles; 1 producer "
                     "warp + 2 consumer warpgroups of 64 q rows; S = Q.K^T "
                     "from smem, online softmax in registers (exp2, quad "
                     "reductions, branch-free masks), O += P.V with P from "
                     "registers (rest of P in a second product on edge "
                     "tiles), O through smem by TMA store",
    "flash_dq": "wgmma bf16, TMA ring of K/V tiles (2 stages) under "
                "mbarriers, 1 producer warp + 2 consumer warpgroups of 64 q "
                "rows, block per (b*nh, 128 q rows), heaviest first; S and "
                "dP from smem, dQ += dS.K with dS from registers",
    "flash_dkv": "wgmma bf16, K/V resident, TMA ring of (Q, dO, lse, delta) "
                 "tiles (2 stages) under mbarriers, 1 producer warp + 2 "
                 "consumer warpgroups of 64 k rows, block per (b*nkv, 128 k "
                 "rows) over the GQA group's heads, heaviest first; S^T and "
                 "dP^T from smem, dV += P^T.dO and dK += dS^T.Q from "
                 "registers"}
#: the hd-256 instances (Gemma)
DESIGN_HD256 = {
    "flash_forward": "the hd-128 design with 64-key K/V tiles in a 2-stage "
                     "ring (192 KB of smem with the 128-row Q tile), 240 "
                     "registers per consumer thread (O is 128 of them), "
                     "O += P.V as one m64n256k16 per 16 keys",
    "flash_dq": "block per (b*nh, 64 q rows), Q/dO resident, TMA ring of "
                "64-key K/V tiles (2 stages, 226 KB of smem with the f32 "
                "swap); both consumer warpgroups own all 64 rows: "
                "warpgroup 0 computes S = Q.K^T, warpgroup 1 dP = dO.V^T "
                "(m64n64 from smem), the two swap them through smem, each "
                "forms dS and sums its 128 columns of dQ += dS.K "
                "(m64n128k16 from registers)",
    "flash_dkv": "block per (b*nkv, split of the GQA group, 64 k rows), "
                 "K/V resident, TMA ring of (Q, dO, lse, delta) tiles of 64 "
                 "q rows (2 stages, 194 KB of smem); warpgroup 0 sums dV += "
                 "P^T.dO, warpgroup 1 dK += dS^T.Q (m64n256k16 from "
                 "registers), each computing S^T itself; splits > 1 write "
                 "f32 sums that a hand-written pass adds in split order"}
#: the hd-128 K1/K2/K3 times at the Llama training shape recorded in
#: PERF.md's kernel table by the slice before the hd-256 dQ kernel (H100
#: 80GB HBM3, 700 W), printed beside this run's: the hd-128 code did not
#: change
HD128_EARLIER_MS = {"flash_forward": 0.3223, "flash_dq": 0.6114,
                    "flash_dkv": 0.7546}
#: norm-wise relative gap of a parameter's gradient between the kernel
#: path and the chunked path: both round attention outputs and dq/dk/dv
#: to bf16 (unit roundoff 2**-9), at other places, through 8 layers; the
#: bound allows ~25 roundoffs of drift
GRAD_REL_BOUND = 0.05
BUILD_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke"
#: cycles of the spin before each timed call (~0.25 ms at the H100's clock)
SPIN_CYCLES = 500_000


def log(msg: str) -> None:
    print(msg, flush=True)


def _inputs(torch, case, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, case["dtype"])

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    b, sq, sk = case["b"], case["sq"], case["sk"]
    q = randn(b, sq, case["nh"], case["hd"])
    k = randn(b, sk, case["nkv"], case["hd"])
    v = randn(b, sk, case["nkv"], case["hd"])
    seg = None
    if case.get("segments"):
        # three packed documents per row, boundaries differing per row
        pos = torch.arange(sq, device="cuda")
        seg = torch.stack([(pos >= sq // 3 + 7 * i).int()
                           + (pos >= (2 * sq) // 3 - 5 * i).int()
                           for i in range(b)])
    return q, k, v, seg


def _kw(case, seg):
    return dict(segment_ids=seg, offsets=case.get("offsets"),
                window=case.get("window", 0))


def _time_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Median device time of one call. A 64 MB write between calls pushes
    the inputs out of the 50 MB L2, as a layer's worth of other work does
    on the serving path. A spin on the card (~0.25 ms) then keeps it busy
    while the host runs the call's Python and launch path, so the start
    event does not fire before the call's first kernel is queued and the
    time is the card's alone (the host's share is timed apart)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in times)
    return ms[len(ms) // 2]


#: the kernels timed beside their earlier design, and the route function
#: that picks it
EARLIER_ROUTE = {"flash_forward": "flash_fwd_route",
                 "flash_dq": "flash_dq_route",
                 "flash_dkv": "flash_dkv_route"}


def _earlier_ms(torch, attn, kernel, fn, **kw) -> float:
    """``_time_ms`` of ``fn`` with every launch of ``kernel`` (K1, K2 or
    K3) sent to the ``simt`` route: its earlier design (``flash_fwd.cu``,
    ``flash_bwd.cu``) on inputs the ``sm90`` route takes, timed as the
    new design is."""
    wrapper = getattr(attn, kernel)
    with unittest.mock.patch.object(attn, EARLIER_ROUTE[kernel],
                                    lambda dtype, hd: "simt"):
        before = wrapper.launches_by_route["simt"]
        ms = _time_ms(torch, fn, **kw)
        if wrapper.launches_by_route["simt"] == before:
            raise AssertionError("the earlier design was not launched")
    return ms


def _flash_bound(torch, case, seg, name="flash_forward") -> tuple:
    """(ms, "bytes" or "operations"): the least time for the work these
    inputs need. Each input and output moves once at the HBM rate: K1
    reads q/k/v and writes out/lse, K2 reads q/k/v/dO/lse/Δ and writes
    dq, K3 reads the same and writes dk/dv. The products of the (row,
    key) pairs the mask keeps (``OPS_PER_PAIR`` x hd operations each) run
    at the peak rate of the input type."""
    b, sq, sk, nh, nkv, hd = (case[n] for n in
                              ("b", "sq", "sk", "nh", "nkv", "hd"))
    item = 2 if case["dtype"] == "bfloat16" else 4
    q_side, kv_side, rows = b * sq * nh * hd, b * sk * nkv * hd, b * nh * sq
    moved = {"flash_forward": item * (2 * q_side + 2 * kv_side) + 4 * rows,
             "flash_dq": item * (3 * q_side + 2 * kv_side) + 8 * rows,
             "flash_dkv": item * (2 * q_side + 4 * kv_side) + 8 * rows}[name]
    rows_i = torch.arange(sq)[:, None]
    cols = torch.arange(sk)[None, :]
    keep = torch.ones(1, sq, sk, dtype=torch.bool)
    if case["causal"]:
        q_off, k_off = case.get("offsets") or (0, 0)
        keep = (cols + k_off) <= (rows_i + q_off)
        if case.get("window", 0):
            keep &= (cols + k_off) > (rows_i + q_off) - case["window"]
        keep = keep[None]
    if seg is not None:
        seg = seg.cpu()
        keep = keep & (seg[:, :, None] == seg[:, None, :])
    pairs = int(keep.expand(b, sq, sk).sum())
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = (OPS_PER_PAIR[name] * hd * pairs * nh
             / PEAK_FLOPS_PER_S[case["dtype"]])
    return 1e3 * max(t_bytes, t_ops), \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from kubedl_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {len(_build.sources())} kernel source(s), built "
        f"{sorted(logs)} in {dt:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("Used", "spill", "wgmma",
                                       "Performance")):
                log(f"[build] {name}: {line.strip()}")


#: the kernels' check cases: the serving shape and the edge cases
CASES = {
    "main": MAIN,
    "non_causal": {**MAIN, "causal": False},
    "mha": {**MAIN, "nkv": 32},
    "window_128": {**MAIN, "window": 128},
    "segment_ids": {**MAIN, "segments": True},
    "offsets": {**MAIN, "offsets": (256, 0)},
    "offsets_masked_rows": {**MAIN, "offsets": (0, 256)},
    "ragged_300": {**MAIN, "sq": 300, "sk": 300},
    "sq_gt_sk": {**MAIN, "sq": 512, "sk": 256},
    "float32": {**MAIN, "dtype": "float32"},
    "hd_64": {**MAIN, "hd": 64, "sq": 200, "sk": 200},
    "hd_256": {**MAIN, "hd": 256, "sq": 256, "sk": 256},
    "hd_80_padded": {**MAIN, "hd": 80, "sq": 130, "sk": 130},
}
#: the training shape at b=1, checked beside the edge cases
TRAIN_B1 = {**TRAIN, "b": 1}
#: Gemma-2B's attention (8 q heads, 1 kv head of width 256: K1, K2 and K3
#: on the ``sm90`` route) at its embeddings shape (2 inputs,
#: the longer 512 tokens), its training shape (b=2, s=2048: K3 splits the
#: GQA group in 4 on 132 SMs) and that shape at b=1 (8 splits of one
#: head); checked after the cases above
GEMMA_EMBED = {**MAIN, "nh": 8, "nkv": 1, "hd": 256}
GEMMA_TRAIN = {**TRAIN, "b": 2, "nh": 8, "nkv": 1, "hd": 256}
GEMMA_CASES = {"gemma_embed": GEMMA_EMBED, "gemma_train": GEMMA_TRAIN,
               "gemma_train_b1": {**GEMMA_TRAIN, "b": 1}}
#: edge cases at head dim 256 around Gemma-2B's embeddings shape: ragged
#: and unequal lengths, window, segments, both offsets (fully masked rows
#: included), Gemma-7B's MHA (16/16 heads), f16, non-causal
HD256_CASES = {
    "hd256_ragged_300": {**GEMMA_EMBED, "sq": 300, "sk": 300},
    "hd256_sq_gt_sk": {**GEMMA_EMBED, "sq": 512, "sk": 256},
    "hd256_window_128": {**GEMMA_EMBED, "window": 128},
    "hd256_segments": {**GEMMA_EMBED, "segments": True},
    "hd256_offsets": {**GEMMA_EMBED, "offsets": (256, 0)},
    "hd256_offsets_masked_rows": {**GEMMA_EMBED, "offsets": (0, 256)},
    "hd256_mha": {**GEMMA_EMBED, "nh": 16, "nkv": 16},
    "hd256_float16": {**GEMMA_EMBED, "dtype": "float16"},
    "hd256_non_causal": {**GEMMA_EMBED, "causal": False},
}
#: Mixtral's attention (Llama-3-8B's heads: 32/8 of width 128, bf16,
#: causal; K1, K2 and K3 on ``sm90``) at its training shape as the
#: MoE training step launches it (b=2, s=2048); checked after the cases
#: above, so their seeds stay as they were
MOE_TRAIN = {**TRAIN, "b": 2}
MOE_CASES = {"moe_train": MOE_TRAIN}
#: the cases whose every launch must take the ``sm90`` route
SM90_CASES = (*GEMMA_CASES, *MOE_CASES)


def phase_kernel_check(torch):
    from kubedl_tpu_torch.ops import attention as attn

    errs = {}
    for i, (name, case) in enumerate({**CASES, "train_b1": TRAIN_B1,
                                      **GEMMA_CASES, **HD256_CASES,
                                      **MOE_CASES}.items()):
        q, k, v, seg = _inputs(torch, case, seed=100 + i)
        route = attn.flash_fwd_route(q.dtype, case["hd"])
        if (name in SM90_CASES or case["hd"] == 256
                and case["dtype"] != "float32") and route != "sm90":
            raise AssertionError(f"flash_forward case {name}: route {route}, "
                                 f"want sm90")
        before = attn.flash_forward.launches_by_route[route]
        out, lse = attn.flash_forward(q, k, v, case["causal"], **_kw(case, seg))
        ref, ref_lse = attn.flash_forward_plain(q, k, v, case["causal"],
                                                **_kw(case, seg))
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = (math.isfinite(err) and err <= ATOL[case["dtype"]]
              and lse_err <= ATOL["lse"]
              and bool(torch.isfinite(out.float()).all())
              and attn.flash_forward.launches_by_route[route] == before + 1)
        log(f"[kernel] flash_forward {name} ({route}): out max_abs_err "
            f"{err:.3e} (atol {ATOL[case['dtype']]:g}), lse max_abs_err "
            f"{lse_err:.3e} (atol {ATOL['lse']:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_forward disagrees with its plain "
                                 f"version on case {name}")
        errs[name] = err

    row = _fwd_timing(torch, MAIN, seed=100)
    kernel_ms, plain_ms, library_ms, bound_ms, bound_by, earlier_ms = (
        row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_by", "earlier_design_ms"))
    q, k, v, _ = _inputs(torch, MAIN, seed=100)
    causal = MAIN["causal"]
    # the host's share: back-to-back calls, not synchronised, so the card
    # (faster here) waits on the wrapper's checks and the launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        attn.flash_forward(q, k, v, causal)
    host_ms = (time.perf_counter() - t0) * 1e3 / 100
    torch.cuda.synchronize()
    log(f"[kernel] flash_forward at b=2 s=512 nh=32 nkv=8 hd=128 bf16 "
        f"causal: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"earlier design (flash_fwd.cu) {earlier_ms:.4f} ms; host path "
        f"{host_ms:.4f} ms per call back to back")
    return {"max_abs_err": errs["main"], "train_max_abs_err":
            errs["train_b1"], "gemma_max_abs_err": {
                k: errs[k] for k in GEMMA_CASES},
            "moe_max_abs_err": errs["moe_train"], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "earlier_design_ms": earlier_ms,
            "host_ms": host_ms}


#: the decode tick's attention (``ops.decode.paged_decode``) on the card:
#: the serving cells' shapes in a pool of 64-slot blocks, 2,048 slots a
#: lane (contexts drawn from their mixes' prompt laws, half the chat lanes
#: idle on the sink block), Gemma-2-9B's heads (hd 256, softcap 50, query
#: scale 256, a 1,024-key window on and off) and Qwen2-7B's tp=8 rank 1
#: (query heads 4..7 over KV heads 0 and 1)
DECODE_CASES = {
    "chat": dict(nh=28, nkv=4, hd=128, prompt=(512, 0.9, 32, 1536),
                 out=(128, 0.8, 16, 512), idle=16),
    "batch": dict(nh=32, nkv=8, hd=128, prompt=(1024, 0.7, 256, 1536),
                  out=(256, 0.7, 64, 512)),
    "gemma2_hd256": dict(nh=16, nkv=8, hd=256, prompt=(1024, 0.7, 256,
                                                       1536),
                         out=(256, 0.7, 64, 512), softcap=50.0,
                         scale=256 ** -0.5, window=1024),
    "gemma2_hd256_global": dict(nh=16, nkv=8, hd=256,
                                prompt=(1024, 0.7, 256, 1536),
                                out=(256, 0.7, 64, 512), softcap=50.0,
                                scale=256 ** -0.5),
    "tp8_rank1": dict(nh=4, nkv=4, hd=128, prompt=(512, 0.9, 32, 1536),
                      out=(128, 0.8, 16, 512), q_first=4, group=7),
}
DECODE_LANES, DECODE_BLOCK, DECODE_SLOTS = 32, 64, 2048


def _decode_inputs(torch, case, seed):
    """q [lanes, nh, hd] and pools [lanes x 32 + 1 blocks, 64, nkv, hd] in
    bf16, block tables over a shuffled pool (live blocks only, the rest
    on the sink block 0) and positions: a prompt drawn from the case's
    lognormal law (median, sigma, clipped) plus a uniform share of an
    output drawn likewise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, n_blk = DECODE_LANES, DECODE_SLOTS // DECODE_BLOCK

    def law(spec):
        med, sigma, lo, hi = spec
        return np.clip(rng.lognormal(np.log(med), sigma, b), lo, hi)

    pos = law(case["prompt"]) + rng.uniform(0, 1, b) * law(case["out"])
    pos = np.minimum(pos.astype(np.int64), DECODE_SLOTS - 1)
    pos[:case.get("idle", 0)] = 0
    pool_blocks = b * n_blk + 1
    perm = rng.permutation(pool_blocks - 1) + 1
    tables = perm.reshape(b, n_blk)
    tables[np.arange(n_blk)[None, :] > (pos // DECODE_BLOCK)[:, None]] = 0
    tables[:case.get("idle", 0)] = 0
    shape = (pool_blocks, DECODE_BLOCK, case["nkv"], case["hd"])
    k_pool = torch.randn(shape, generator=g, device="cuda").bfloat16()
    v_pool = torch.randn(shape, generator=g, device="cuda").bfloat16()
    q = torch.randn((b, case["nh"], case["hd"]), generator=g,
                    device="cuda").bfloat16()
    kw = dict(scale=case.get("scale", case["hd"] ** -0.5),
              softcap=case.get("softcap", 0.0),
              window=case.get("window", 0), q_first=case.get("q_first", 0),
              group=case.get("group"))
    return (q, k_pool, v_pool, torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos).cuda(), kw)


def _decode_bound_ms(q, k_pool, tables, pos, kw) -> float:
    """The least time for the call: the live K/V rows each lane attends
    (inside the window) read once, the live table entries, q and the
    output, at the HBM rate."""
    b, nh, hd = q.shape
    nkv = k_pool.shape[2]
    group = kw["group"] or nh // nkv
    first = kw["q_first"] // group
    kv_heads = (kw["q_first"] + nh - 1) // group + 1 - first
    keys = pos.cpu().long() + 1
    if kw["window"]:
        keys = keys.clamp(max=kw["window"])
    rows = int(keys.sum()) * kv_heads
    blocks = int(((pos.cpu().long() // DECODE_BLOCK) + 1).sum())
    moved = (2 * rows * hd * k_pool.element_size() + 8 * blocks
             + 2 * b * nh * hd * q.element_size())
    return 1e3 * moved / HBM_BYTES_PER_S


def _sdpa_view_ms(torch, q, k_pool, v_pool, tables, pos, kw) -> float:
    """SDPA (a yardstick only) on the gathered bf16 view, the view made
    before the timing; the cases without softcap or window."""
    import torch.nn.functional as F
    b, nh, hd = q.shape
    nkv = k_pool.shape[2]
    kv = [p[tables].reshape(b, -1, nkv, hd).transpose(1, 2).contiguous()
          for p in (k_pool, v_pool)]
    mask = (torch.arange(kv[0].shape[2], device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    return _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kv[0], kv[1], attn_mask=mask, scale=kw["scale"],
        enable_gqa=True))


def _decode_check(torch, name, case, seed) -> dict:
    """The kernel against its plain version (the einsum path's gathered
    view, the tick's read before the kernel) on one case: in bf16 within
    one bf16 rounding of the plain version's float32 result, in float32
    activations within 1e-5, the same bits on a second call; then the
    kernel's and the plain version's times beside the bound (and SDPA's
    where it computes the same function)."""
    from kubedl_tpu_torch.ops import decode
    q, kp, vp, tables, pos, kw = _decode_inputs(torch, case, seed)
    want = decode.paged_decode_plain(q.float(), kp, vp, tables, pos, **kw)
    got = decode.paged_decode(q, kp, vp, tables, pos, **kw)
    again = decode.paged_decode(q, kp, vp, tables, pos, **kw)
    got32 = decode.paged_decode(q.float(), kp, vp, tables, pos, **kw)
    torch.cuda.synchronize()
    over = float(((got.float() - want).abs()
                  - 2.0 ** -8 * want.abs()).max())
    err32 = float((got32 - want).abs().max())
    out = {"lanes": DECODE_LANES, "heads": (case["nh"], case["nkv"]),
           "hd": case["hd"], "live_keys": int((pos + 1).sum()),
           "bf16_over_one_rounding": over, "f32_max_abs_err": err32,
           "repeats_bit_for_bit": bool(torch.equal(got, again))}
    if not (over <= 1e-5 and err32 <= 1e-5
            and out["repeats_bit_for_bit"]):
        raise AssertionError(f"[decode] {name}: the kernel strays from its "
                             f"plain version: {out}")
    args = (q, kp, vp, tables, pos)
    out["ms"] = _time_ms(torch, lambda: decode.paged_decode(*args, **kw))
    out["bound_ms"] = _decode_bound_ms(q, kp, tables, pos, kw)
    out["roofline_pct"] = 100 * out["bound_ms"] / out["ms"]
    out["plain_ms"] = _time_ms(torch, lambda: decode.paged_decode_plain(
        *args, **kw), reps=10, warmup=2)
    if not (kw["softcap"] or kw["window"] or kw["q_first"]):
        out["sdpa_view_ms"] = _sdpa_view_ms(torch, *args, kw)
    log(f"[decode] {name}: {out}")
    return out


def _decode_graph(torch) -> dict:
    """A captured ``DecodeTick`` through the kernel: Qwen2-7B at full
    width, 2 layers, bf16, 8 paged lanes with a registered prefix; every
    card tick on the graph route, the tokens equal to the same engine's
    eager ticks; then parity mode (the dense slab read by the same
    kernel) asserting dense and paged logits every step."""
    import dataclasses

    import numpy as np

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import decode
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    cfg = dataclasses.replace(llama.qwen2_7b(), n_layers=2,
                              max_seq_len=1024)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(26), device="cuda")
    rng = np.random.default_rng(26)
    prefix = rng.integers(3, cfg.vocab_size, 80).tolist()
    reqs = []
    for i in range(12):
        p = rng.integers(3, cfg.vocab_size, int(rng.integers(8, 300)))
        reqs.append(((prefix if i % 3 == 0 else []) + p.tolist(),
                     24 + 4 * i))

    def engine(route, **kw):
        eng = ContinuousBatchingEngine(cfg, params, lanes=8, max_len=1024,
                                       device="cuda", **kw)
        if route == "eager":
            for tick in eng._ticks():
                tick.route = "eager"
        if eng.kv_mode == "paged":
            # parity's dense shadow prefills a prefixed prompt from 0, the
            # pool from the prefix's end: other bf16 sums, whatever the tick
            eng.register_prefix(prefix)
        return eng

    out = {}
    want = engine("eager").run(reqs)
    eng = engine("graph")
    before = decode.paged_decode.launches
    got = eng.run(reqs)
    out["kernel_launches"] = decode.paged_decode.launches - before
    out["ticks"] = _graph_only(eng, "[decode] graph")
    # a call a layer: the two warm-up ticks before the capture, then each
    # replay (the captured tick itself launches nothing)
    out["kernel_launches_want"] = (2 + out["ticks"]["graph"]) * cfg.n_layers
    out["graph_tokens_equal_eager"] = got == want
    par = engine("graph", kv_mode="parity")
    par.run(reqs)                # raises on a step whose layouts diverge
    out["parity_ticks"] = _graph_only(par, "[decode] parity")
    log(f"[decode] captured tick: {out}")
    if not (out["graph_tokens_equal_eager"]
            and out["kernel_launches"] == out["kernel_launches_want"]):
        raise AssertionError(f"[decode] the captured tick: {out}")
    return out


def phase_decode(torch) -> dict:
    """The decode tick's attention kernel on the card: each of
    ``DECODE_CASES`` against its plain version and timed beside its
    bound, then a captured tick through it."""
    out = {name: _decode_check(torch, name, case, 2600 + i)
           for i, (name, case) in enumerate(DECODE_CASES.items())}
    gc.collect()
    torch.cuda.empty_cache()
    out["graph"] = _decode_graph(torch)
    return out


def _post(url: str, path: str, body: dict) -> str:
    req = urllib.request.Request(
        url + path, method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        return r.read().decode()


def phase_serving(torch, cfg, device="cuda"):
    """Drive the serving path; returns (flash_forward launches during it,
    the model's parameters)."""
    import numpy as np

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.serving import (GenerateConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)
    from kubedl_tpu_torch.serving.engine import greedy_rollout
    from kubedl_tpu_torch.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    log(f"[serve] model: d_model {cfg.d_model}, {cfg.n_layers} layers "
        f"deep, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.2f} B params "
        f"{str(cfg.dtype).removeprefix('torch.')}, random from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = InferenceEngine(cfg, params, GenerateConfig(max_len=1024),
                          device=device)
    srv = InferenceServer(eng, ServerConfig(
        model_name="llama3-8b", host="127.0.0.1", port=0,
        tokenizer=ByteTokenizer())).start()
    rng = np.random.default_rng(0)
    try:
        attn.flash_forward.launches = 0
        attn.flash_forward.launches_by_route = {"sm90": 0, "simt": 0}
        # 1. buffered :predict, 4 instances of mixed lengths
        lens = (256, 200, 97, 31)
        prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens]
        t0 = time.perf_counter()
        got = json.loads(_post(srv.url, "/v1/models/llama3-8b:predict", {
            "instances": [{"prompt_tokens": p, "max_tokens": 16}
                          for p in prompts]}))
        preds = [p["tokens"] for p in got["predictions"]]
        if [len(t) for t in preds] != [16] * 4 or not all(
                0 <= t < cfg.vocab_size for p in preds for t in p):
            raise AssertionError(f"bad :predict tokens {preds}")
        log(f"[serve] :predict 4 instances (lengths {lens}) x 16 tokens in "
            f"{time.perf_counter() - t0:.2f} s")
        # 2. streamed :predict
        raw = _post(srv.url, "/v1/models/llama3-8b:predict", {
            "instances": [{"prompt_tokens": prompts[2], "max_tokens": 8}],
            "stream": True})
        events = [json.loads(line[len("data: "):])
                  for line in raw.splitlines() if line.startswith("data: ")]
        streamed = [e["token"] for e in events if "token" in e]
        if not (events[-1].get("done") and events[-1]["tokens"] == streamed
                and len(streamed) == 8):
            raise AssertionError(f"bad stream {events}")
        log(f"[serve] streamed :predict: {len(streamed)} token events + done")
        # 3. /v1/completions on text
        cmpl = json.loads(_post(srv.url, "/v1/completions", {
            "prompt": "The port serves Llama-3-8B on one card.",
            "max_tokens": 8}))
        if cmpl["usage"]["completion_tokens"] != 8:
            raise AssertionError(f"bad completion {cmpl}")
        log(f"[serve] /v1/completions: usage {cmpl['usage']}")
        # 4. /v1/embeddings, 2 inputs: every layer launches the kernel once
        texts = ["kubedl " * 73, "a TPU kernel ported by hand to Hopper " * 8]
        texts[0] = texts[0][:511]          # + BOS = 512 tokens: MAIN's shape
        before = attn.flash_forward.launches
        before_sm90 = attn.flash_forward.launches_by_route["sm90"]
        t0 = time.perf_counter()
        emb = json.loads(_post(srv.url, "/v1/embeddings", {"input": texts}))
        emb_s = time.perf_counter() - t0
        launched = attn.flash_forward.launches - before
        on_sm90 = attn.flash_forward.launches_by_route["sm90"] - before_sm90
        vecs = np.asarray([d["embedding"] for d in emb["data"]])
        norms = np.linalg.norm(vecs, axis=-1)
        if vecs.shape != (2, cfg.d_model) or not np.isfinite(vecs).all() \
                or np.abs(norms - 1).max() > 1e-3:
            raise AssertionError(f"bad embeddings: shape {vecs.shape}, "
                                 f"norms {norms}")
        if launched != cfg.n_layers or on_sm90 != launched:
            raise AssertionError(f"embeddings launched flash_forward "
                                 f"{launched} times, {on_sm90} on sm90; "
                                 f"want {cfg.n_layers}, all on sm90")
        log(f"[serve] /v1/embeddings 2 inputs ({emb['usage']['prompt_tokens']}"
            f" tokens) in {emb_s:.3f} s: {launched} flash_forward launches, "
            f"all sm90, unit norms {norms.round(6).tolist()}")
        # 5. greedy :predict with equal lengths against greedy_rollout
        same = rng.integers(3, cfg.vocab_size, (4, 128))
        got = json.loads(_post(srv.url, "/v1/models/llama3-8b:predict", {
            "instances": [{"prompt_tokens": p, "max_tokens": 16}
                          for p in same.tolist()]}))
        served = [p["tokens"] for p in got["predictions"]]
        rolled = greedy_rollout(cfg, eng.params, same, 16).tolist()
        if served != rolled:
            raise AssertionError(f"greedy :predict {served} != "
                                 f"greedy_rollout {rolled}")
        log("[serve] greedy :predict (4 x 128 tokens) == greedy_rollout")
        launches = attn.flash_forward.launches
        if attn.flash_forward.launches_by_route != {"sm90": launches,
                                                    "simt": 0}:
            raise AssertionError(
                f"serving launched flash_forward on routes "
                f"{attn.flash_forward.launches_by_route}: every launch "
                f"should take sm90")

        # the embeddings against the same forward with the plain attention
        # path (chunked) in place of the kernel
        from unittest import mock

        from kubedl_tpu_torch.tokenizer import encode_prompt
        tok = ByteTokenizer()
        ids = [encode_prompt(tok, t) for t in texts]
        toks = np.zeros((2, max(map(len, ids))), np.int64)
        for i, r in enumerate(ids):
            toks[i, :len(r)] = r
        plain = mock.patch.object(
            llama, "multi_head_attention",
            lambda *a, **k: attn.multi_head_attention(*a, impl="chunked",
                                                      **k))
        with plain, torch.inference_mode():
            x = llama.forward_hidden(cfg, eng.params,
                                     torch.as_tensor(toks, device=device))
        ref = []
        for i, r in enumerate(ids):
            pooled = x[i, :len(r)].float().mean(0)
            ref.append((pooled / pooled.norm()).cpu().numpy())
        cos = [float(np.dot(a, b)) for a, b in zip(vecs, ref)]
        if min(cos) < 0.99:
            raise AssertionError(f"embeddings disagree with the plain "
                                 f"attention path: cosine {cos}")
        log(f"[serve] embeddings vs the plain attention path: cosine "
            f"{[round(c, 6) for c in cos]}, max_abs_err "
            f"{float(np.abs(vecs - np.asarray(ref)).max()):.3e}")

        perf = eng.score_throughput(batch=4, prompt_len=128, new_tokens=16)
        log(f"[serve] batch 4, prompt 128: TTFT {perf['ttft_ms']:.2f} ms; "
            f"a 16-token generation {perf['latency_per_token_ms']:.3f} ms "
            f"per token, prefill included "
            f"({perf['decode_tokens_per_s']:.1f} tokens/s)")
    finally:
        srv.stop()
    return launches, eng.params


#: how far a served greedy token may lie from the reference, the plain
#: forward teacher-forced on the served tokens: its logit below the
#: reference's largest, and its log-probability from the reference's. Two
#: bf16 computations of one logit row that round at other places (a
#: [lanes, 1] decode tick against a prompt-long prefill, bucket padding, a
#: verify chunk) differ by up to two bf16 ulps at |logit| 4-8, where this
#: model's largest logits lie (0.0625), so candidates that close are a tie
#: either side may win. A run passes when at most ``NEAR_TIE_SHARE`` of
#: its tokens lie beyond ``NEAR_TIE`` and none beyond twice it; the
#: continuous phase plants lost K/V writes that must fail this.
NEAR_TIE = 0.07
NEAR_TIE_SHARE = 0.01
#: the continuous-serving phase's 16 prompts (31-512 tokens); those at
#: PREFIXED start with one 256-token system prompt (4 pool blocks of 64)
CONT_LENS = (31, 512, 97, 300, 64, 200, 128, 450, 40, 256, 77, 380, 150,
             500, 90, 220)
PREFIXED = (3, 7, 11, 13)
SYSTEM_LEN = 256
CONT_LANES, CONT_MAX_LEN = 8, 1024
#: the serving phases' depth: Llama-3-8B at full width cut to its first 8
#: of 32 layers, to keep the whole script inside its time limit with room
#: to spare on a slower host
SERVE_LAYERS = 8


def _serving_llama(llama):
    """The serving phases' model: Llama-3-8B at full width,
    ``SERVE_LAYERS`` deep."""
    import dataclasses
    return dataclasses.replace(llama.llama3_8b(), n_layers=SERVE_LAYERS)


def _cont_requests(cfg) -> tuple:
    """(system prompt, [(prompt, max_new)] x 16): 32-64 new tokens each."""
    import numpy as np
    rng = np.random.default_rng(5)
    system = rng.integers(3, cfg.vocab_size, SYSTEM_LEN).tolist()
    reqs = []
    for i, n in enumerate(CONT_LENS):
        p = rng.integers(3, cfg.vocab_size, n).tolist()
        if i in PREFIXED:
            p = system + p[SYSTEM_LEN:]
        reqs.append((p, 32 + (7 * i) % 33))
    return system, reqs


#: a router near-tie of an MoE model: at some layer the reference's k-th
#: and (k+1)-th router probabilities lie within this many bf16 ulps of the
#: k-th (bfloat16's spacing at that value). The router reads bf16 hidden
#: states, which the engine and the reference round at other places, so
#: such a choice may go either way, and a flipped expert moves the
#: position's logits by far more than ``NEAR_TIE``
ROUTER_TIE_ULPS = 4
#: the most of an MoE model's served tokens that may lie beyond
#: ``NEAR_TIE`` in half precision, where a third of the positions sit at
#: a router near-tie and a flipped expert moves its position's logits, and
#: those of every later position that reads its K/V, by far more: no
#: excuse by position tells that from a fault (one that excused positions
#: at and after a tie under ``ROUTER_TIE_ULPS`` refused 21 of 56
#: fault-free runs and passed 6 of 48 faulty ones). Over 28 request draws
#: each of ``phase_moe``'s and ``phase_moe_int8``'s models, fault-free
#: engines (the tick's attention on its kernel and on the gathered einsum)
#: put 3.4-9.1% of their tokens beyond ``NEAR_TIE``, and engines that
#: lose one layer's decode K/V writes (layer 0, 4, 5, 6 or 7) 19.1-93.4%
MOE_HALF_SHARE = 0.13


def _margin_ulps(torch, probs, k):
    """[...]: the k-th largest of ``probs`` [..., E] less the (k+1)-th,
    in bf16 ulps of the k-th."""
    top = probs.float().topk(k + 1, dim=-1).values
    pk = top[..., k - 1]
    return (pk - top[..., k]) / torch.exp2(torch.floor(torch.log2(pk)) - 7)


def _gaps(torch, cfg, params, prompt, toks, lps=None) -> tuple:
    """Per generated position: the reference's largest logit minus its
    logit of the served token (0 where that token is its argmax); with
    the served log-probabilities ``lps``, their distance from the
    reference's (else None); and for an MoE model in half precision the
    reference's smallest router margin over the layers
    (:func:`_margin_ulps`, else None). The reference is the model family's
    ``forward_step`` over prompt + served tokens in one pass."""
    import contextlib

    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.models.io import family_of
    family = family_of(cfg)
    probs, watch = [], contextlib.nullcontext()
    if family is moe and cfg.dtype != torch.float32:
        route = moe.route

        def recording(config, p, capacity, token_mask=None, mesh=None):
            probs.append(p.detach())
            return route(config, p, capacity, token_mask, mesh=mesh)
        watch = unittest.mock.patch.object(moe, "route", recording)
    seq = torch.as_tensor([prompt + toks[:-1]], device="cuda")
    with watch, torch.no_grad():
        cache = family.init_cache(cfg, 1, seq.shape[1], device="cuda")
        logits, _ = family.forward_step(cfg, params, seq, cache, 0,
                                        all_logits=True)
    start = len(prompt) - 1
    ref = logits[0, start:]
    got = torch.as_tensor(toks, device="cuda")[:, None]
    top, mine = ref.max(-1).values, ref.gather(-1, got)[:, 0]
    margin = None
    if probs:
        margin = torch.stack([_margin_ulps(torch, p[0, start:], cfg.top_k)
                              for p in probs]).min(0).values.cpu()
    if lps is None:
        return (top - mine).cpu(), None, margin
    lp = torch.log_softmax(ref, -1).gather(-1, got)[:, 0]
    return (top - mine).cpu(), (torch.as_tensor(lps, device="cuda")
                                - lp).abs().cpu(), margin


def _reading(torch, cfg, params, reqs, outs, lps=None) -> dict:
    """The served tokens against the reference (see ``_gaps``): positions
    off its argmax, the largest gap and log-probability distance, the
    positions beyond ``NEAR_TIE`` on either, and whether the run passes
    (``ok``): at most ``NEAR_TIE_SHARE`` of the tokens beyond
    ``NEAR_TIE`` and none beyond twice it; for an MoE model in half
    precision, at most ``MOE_HALF_SHARE`` of them beyond ``NEAR_TIE``
    (those at a router near-tie counted apart, a reading)."""
    r = {"tokens": sum(len(t) for t in outs), "off_argmax": 0,
         "max_gap": 0.0, "max_dlp": None, "beyond": 0, "router": None}
    worst_all = 0.0
    for i, ((prompt, n), toks) in enumerate(zip(reqs, outs)):
        if len(toks) != n:
            raise AssertionError(f"request {i} got {len(toks)} tokens, "
                                 f"wants {n}")
        g, d, margin = _gaps(torch, cfg, params, prompt, toks,
                             None if lps is None else lps[i])
        r["off_argmax"] += int((g > 0).sum())
        r["max_gap"] = max(r["max_gap"], float(g.max()))
        worst = g
        if d is not None:
            r["max_dlp"] = max(r["max_dlp"] or 0.0, float(d.max()))
            worst = torch.maximum(g, d)
        worst_all = max(worst_all, float(worst.max()))
        beyond = worst > NEAR_TIE
        r["beyond"] += int(beyond.sum())
        if margin is not None:
            tie = margin < ROUTER_TIE_ULPS
            rt = r["router"] = r["router"] or {"at_tie": 0, "ties": 0}
            rt["at_tie"] += int((beyond & tie).sum())
            rt["ties"] += int(tie.sum())
    if r["router"] is None:
        r["ok"] = (worst_all <= 2 * NEAR_TIE
                   and r["beyond"] <= NEAR_TIE_SHARE * r["tokens"])
    else:
        r["ok"] = r["beyond"] <= MOE_HALF_SHARE * r["tokens"]
    return r


def _describe(r) -> str:
    lp = ("" if r["max_dlp"] is None else
          f", of a log-probability {r['max_dlp']:.4f}")
    rt = r["router"]
    limits = (f"{NEAR_TIE_SHARE:.0%} of the tokens, none beyond "
              f"{2 * NEAR_TIE}" if rt is None else
              f"{MOE_HALF_SHARE:.0%} of the tokens")
    router = "" if rt is None else (
        f" ({r['beyond'] / r['tokens']:.1%}); {rt['at_tie']} of them at a "
        f"router near-tie (under {ROUTER_TIE_ULPS} bf16 ulps; {rt['ties']} "
        f"of all positions are)")
    return (f"{r['tokens']} tokens; the reference's greedy choice at all but "
            f"{r['off_argmax']} positions; largest gap {r['max_gap']:.4f}"
            f"{lp}; {r['beyond']} positions beyond {NEAR_TIE}{router} "
            f"(limits: {limits})")


def _hold(torch, cfg, params, reqs, outs, label, want=None,
          want_label="", exact=False, lps=None) -> dict:
    """Every served token is the reference's greedy choice up to a near
    tie and, with ``lps``, has its log-probability (``_reading``'s
    limits); with ``want``, count the requests whose tokens are identical
    to it and, with ``exact``, require all of them to be."""
    try:
        r = _reading(torch, cfg, params, reqs, outs, lps)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None
    same, diverge = 0, []
    for i, toks in enumerate(outs if want is not None else []):
        if toks == want[i]:
            same += 1
        else:
            diverge.append((i, next(j for j, (a, b) in
                                     enumerate(zip(toks, want[i]))
                                     if a != b)))
    msg = (f"{label}: " if label.startswith("[") else f"[cont] {label}: ") \
        + f"{len(outs)} requests, {_describe(r)}"
    if want is not None:
        msg += (f"; identical to {want_label}: {same}/{len(outs)} requests"
                + (f", first divergence (request, token) {diverge}"
                   if diverge else ""))
    log(msg)
    if not r["ok"]:
        raise AssertionError(f"{label}: the served tokens lie beyond the "
                             f"near-tie limits of the reference")
    if exact and diverge:
        raise AssertionError(f"{label}: tokens differ from {want_label} at "
                             f"{diverge}")
    return {**r, "identical": same}


def _run(eng, reqs) -> tuple:
    """``eng.run(reqs)`` with each token's log-probability: (tokens,
    log-probabilities), one list per request."""
    rs = [eng.submit(p, n, logprobs=True) for p, n in reqs]
    eng.run([])                     # steps inline until every request ends
    return [r.result() for r in rs], [list(r.logprobs) for r in rs]


def _lost_write(llama, pool, layer):
    """``attention_step`` with ``layer``'s decode-tick K/V writes lost: the
    tick writes into a copy of that layer's pool, so later ticks read
    whatever the slots held before. A planted fault for the check."""
    orig = llama.attention_step
    ptr = pool["k"][layer].data_ptr()

    def step(config, x, lp, kc, vc, *args, **kw):
        if x.shape[1] == 1 and kc.data_ptr() == ptr:
            x = orig(config, x, lp, kc.clone(), vc.clone(), *args, **kw)[0]
            return x, kc, vc
        return orig(config, x, lp, kc, vc, *args, **kw)

    return step


def _graph_only(eng, label) -> dict:
    """Every decode tick the engine ran on the card took the graph route."""
    ticks = eng.tick_launches
    if ticks["eager"] or not ticks["graph"]:
        raise AssertionError(f"{label}: decode ticks by route {ticks}; every "
                             f"card tick should replay the graph")
    return ticks


def _tick_ms(torch, eng, route, reps=20) -> float:
    """Host wall time of one decode tick on the engine's lane state, the
    sampled tokens on the host (what the scheduler waits for)."""
    for _ in range(3):
        eng.decode_tick(route).argmax(-1).cpu()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.decode_tick(route).argmax(-1).cpu()
    return (time.perf_counter() - t0) * 1e3 / reps


def _tick_bound_ms(cfg, params, lanes, live) -> tuple:
    """(ms, weight GB): every weight read once in its stored form (int8
    bytes and scales, packed int4 nibbles and group scales, bf16), except
    an untied embedding table, of which only the lanes' rows are read (a
    tied one is the LM head, read whole); the K/V of the ``live`` cached
    tokens read and the lanes' new K/V written, at the HBM rate. The
    tick's 2 x params x lanes operations take ~1% of that at the bf16
    peak, so bytes bound it."""
    from kubedl_tpu_torch.ops.quant import tree_nbytes
    w = tree_nbytes(params)
    if not cfg.tie_embeddings:
        emb = params["embed"]
        w -= tree_nbytes(emb) - lanes * cfg.d_model * emb.element_size()
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * (live + lanes)
    return 1e3 * (w + kv) / HBM_BYTES_PER_S, w / 1e9


def _tick_launches(torch, eng, route) -> tuple:
    """(host launch calls, device kernels, device busy ms) of one tick,
    counted as ``profile_torch_serving.py`` counts them."""
    from profile_torch_serving import device_profile
    eng.decode_tick(route).argmax(-1).cpu()
    p = device_profile(lambda: eng.decode_tick(route).argmax(-1).cpu())
    return p["host_calls"], len(p["kernels"]), p["busy_us"] / 1e3


def phase_continuous(torch, cfg, params) -> dict:
    """The predictor's engine, ``ContinuousBatchingEngine``, on Llama-3-8B
    at full width, ``SERVE_LAYERS`` deep (the serving phase's weights):
    (a) 16 greedy requests through ``InferenceServer`` against
    ``greedy_rollout``; (b)
    parity, a shrunk pool that preempts and prefill lanes that hand off;
    (c) a registered prefix; (d) speculative lanes with the target's
    first 2 layers as the draft; (e) the graph tick against the eager tick
    at 1, 4 and 8 lanes. Between (a) and (b), lost K/V writes are planted
    and the check must refuse them."""
    import dataclasses

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.serving import (ContinuousBatchingEngine,
                                          InferenceServer, ServerConfig)
    from kubedl_tpu_torch.ops.quant import tree_nbytes
    from kubedl_tpu_torch.serving.engine import greedy_rollout

    torch.cuda.reset_peak_memory_stats()
    system, reqs = _cont_requests(cfg)
    out = {}

    def engine(**kw):
        kw.setdefault("lanes", CONT_LANES)
        return ContinuousBatchingEngine(cfg, params, max_len=CONT_MAX_LEN,
                                        device="cuda", **kw)

    # (a) the predictor's default engine (paged, 8 lanes) behind the server
    eng = engine().start()
    srv = InferenceServer(eng, ServerConfig(
        model_name="llama3-8b", host="127.0.0.1", port=0, max_batch=16,
        max_new_tokens=128)).start()
    try:
        t0 = time.perf_counter()
        json.loads(_post(srv.url, "/v1/models/llama3-8b:predict", {
            "instances": [{"prompt_tokens": [1, 2, 3], "max_tokens": 2}]}))
        log(f"[cont] first request (captures the decode graph) "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        got = json.loads(_post(srv.url, "/v1/models/llama3-8b:predict", {
            "instances": [{"prompt_tokens": p, "max_tokens": n,
                           "logprobs": True} for p, n in reqs]}))
        wall = time.perf_counter() - t0
        served = [p["tokens"] for p in got["predictions"]]
        served_lps = [p["logprobs"] for p in got["predictions"]]
        n_tok = sum(len(t) for t in served)
        out["tokens_per_s"] = n_tok / wall
        log(f"[cont] (a) 16 requests (prompts {min(CONT_LENS)}-"
            f"{max(CONT_LENS)} tokens, {sum(n for _, n in reqs)} new) on 8 "
            f"lanes through :predict in {wall:.3f} s: {n_tok} tokens, "
            f"{out['tokens_per_s']:.1f} tokens/s, peak active lanes "
            f"{eng.peak_active}")
        ttft = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.submit(reqs[1][0], 1).result(timeout=120)
            ttft.append(1e3 * (time.perf_counter() - t0))
        out["ttft_ms"] = ttft
        log(f"[cont] TTFT of a 512-token prompt (prefill + first token, one "
            f"request on an idle engine): {[round(x, 3) for x in ttft]} ms")
    finally:
        srv.stop()
        eng.stop()
    out["ticks_a"] = _graph_only(eng, "(a)")
    del eng
    gc.collect()                 # an engine and its ticks form a cycle
    t0 = time.perf_counter()
    rolled = [greedy_rollout(cfg, params, [p], n)[0].tolist()
              for p, n in reqs]
    log(f"[cont] greedy_rollout of the 16 prompts in "
        f"{time.perf_counter() - t0:.1f} s")
    out["a"] = _hold(torch, cfg, params, reqs, served, "(a) continuous",
                     want=rolled, want_label="greedy_rollout",
                     lps=served_lps)

    # the check must refuse a faulty engine: one layer's decode-tick K/V
    # writes lost, planted in the middle layer and in the last
    out["planted"] = {}
    for layer in (cfg.n_layers // 2, cfg.n_layers - 1):
        bad = engine()
        with unittest.mock.patch.object(
                llama, "attention_step", _lost_write(llama, bad._pool, layer)):
            got, lps = _run(bad, reqs)
        r = _reading(torch, cfg, params, reqs, got, lps)
        r["identical"] = sum(a == b for a, b in zip(got, served))
        out["planted"][layer] = r
        log(f"[cont] planted fault, layer {layer}'s decode K/V writes lost: "
            f"{_describe(r)}; identical to (a): {r['identical']}/16 requests")
        if r["ok"]:
            raise AssertionError(f"the check passes an engine that loses "
                                 f"layer {layer}'s K/V writes")
        del bad
        gc.collect()

    # (b) parity on 4 requests; a shrunk pool; prefill lanes
    sub = list(range(4))
    par = engine(kv_mode="parity")
    got, lps = _run(par, [reqs[i] for i in sub])
    _graph_only(par, "(b) parity")
    _hold(torch, cfg, params, [reqs[i] for i in sub], got,
          "(b) parity (dense and paged asserted every step)",
          want=[served[i] for i in sub], want_label="(a)", exact=True,
          lps=lps)
    del par
    gc.collect()
    small = engine(pool_blocks=2 * CONT_MAX_LEN // 64)
    got, lps = _run(small, reqs)
    out["preempted"] = small.preempted
    if small.preempted < 1:
        raise AssertionError("the shrunk pool never preempted")
    log(f"[cont] (b) pool of {small.pool_blocks} blocks for 8 lanes: "
        f"{small.preempted} preemptions, peak active lanes "
        f"{small.peak_active}")
    _graph_only(small, "(b) shrunk pool")
    out["b_preempt"] = _hold(torch, cfg, params, reqs, got,
                             "(b) shrunk pool", want=served, want_label="(a)",
                             lps=lps)
    del small
    gc.collect()
    dis = engine(prefill_lanes=2)
    got, lps = _run(dis, reqs)
    out["handoffs"] = dis.handoffs
    if dis.handoffs < 1:
        raise AssertionError("the prefill lanes handed nothing off")
    log(f"[cont] (b) 2 prefill lanes + 6 decode lanes: {dis.handoffs} "
        f"block-table handoffs")
    _graph_only(dis, "(b) prefill lanes")
    _hold(torch, cfg, params, reqs, got, "(b) prefill lanes", want=served,
          want_label="(a)", exact=True, lps=lps)
    del dis
    gc.collect()

    # (c) the registered prefix
    pre = engine()
    pre.register_prefix(system)
    hits = [reqs[i] for i in PREFIXED]
    got, lps = _run(pre, hits)
    prefilled = sum(len(p) for p, _ in hits)
    if pre.prefill_tokens_total != prefilled - len(hits) * SYSTEM_LEN:
        raise AssertionError(f"prefix hits prefilled "
                             f"{pre.prefill_tokens_total} tokens of "
                             f"{prefilled}")
    log(f"[cont] (c) {len(hits)} prefix hits prefilled "
        f"{pre.prefill_tokens_total} of {prefilled} prompt tokens "
        f"({pre.pool_stats()['blocks_pinned']} blocks pinned)")
    _graph_only(pre, "(c) prefix")
    out["c_prefix"] = _hold(torch, cfg, params, hits, got, "(c) prefix hits",
                            want=[served[i] for i in PREFIXED],
                            want_label="(a)", lps=lps)
    del pre
    gc.collect()

    # (d) speculative lanes, the draft = the target's first 2 layers
    dcfg = dataclasses.replace(cfg, n_layers=2)
    dparams = {**params, "layers": {k: v[:2]
                                    for k, v in params["layers"].items()}}
    spec = engine(draft_config=dcfg, draft_params=dparams, spec_k=4)
    t0 = time.perf_counter()
    got, lps = _run(spec, reqs)
    wall = time.perf_counter() - t0
    out["acceptance"] = spec.stats.acceptance_rate
    log(f"[cont] (d) speculative lanes (k=4, 2-layer draft) in {wall:.3f} "
        f"s: acceptance {spec.stats.accepted}/{spec.stats.proposed} = "
        f"{spec.stats.acceptance_rate:.4f}; decode ticks by route (target "
        f"and draft) {spec.tick_launches}")
    _graph_only(spec, "(d) speculative")
    out["d_spec"] = _hold(torch, cfg, params, reqs, got,
                          "(d) speculative lanes", want=served,
                          want_label="(a)", lps=lps)
    del spec
    gc.collect()

    # (e) the graph tick against the eager tick, at 1, 4 and 8 lanes
    out["ticks"] = _tick_table(torch, engine, cfg, params, reqs[1][0],
                               "[cont] (e)")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[cont] {out['peak_gib']:.2f} GiB peak device memory in the phase "
        f"({tree_nbytes(params) / 1e9:.2f} GB of weights)")
    out["reqs"], out["served"] = reqs, served
    return out


def _tick_table(torch, engine, cfg, params, prompt, tag) -> dict:
    """The decode tick at 1, 4 and 8 lanes, every lane ``prompt[:500]``
    plus one token of its own, each lane count on a fresh
    ``engine(lanes=...)``: graph, eager, graph again, against
    ``_tick_bound_ms``; at 8 lanes the graph's logits against the eager
    tick's on one state, and the launches per tick."""
    rows = {}
    for lanes in (1, 4, 8):
        eng = engine(lanes=lanes)
        for i in range(lanes):
            eng.submit(prompt[:500] + [i + 3], 256)
        eng.step()                      # prefill every lane + one tick
        live = lanes * 502               # every lane's K/V after the tick
        graph_ms = _tick_ms(torch, eng, None)
        eager_ms = _tick_ms(torch, eng, "eager")
        graph_ms2 = _tick_ms(torch, eng, None)
        bound_ms, w_gb = _tick_bound_ms(cfg, eng.params, lanes, live)
        row = {"graph_ms": [graph_ms, graph_ms2], "eager_ms": eager_ms,
               "bound_ms": bound_ms, "live_tokens": live,
               "weight_gb": w_gb}
        if lanes == 8:
            g = eng.decode_tick().float().cpu()
            e = eng.decode_tick("eager").float().cpu()
            row["max_abs_diff"] = float((g - e).abs().max())
            if not torch.equal(g.argmax(-1), e.argmax(-1)):
                raise AssertionError(f"{tag}: the graph tick's greedy tokens "
                                     f"differ from the eager tick's")
            row["launches_graph"] = _tick_launches(torch, eng, None)
            row["launches_eager"] = _tick_launches(torch, eng, "eager")
        _graph_only(eng, f"{tag} {lanes} lanes")
        rows[lanes] = row
        log(f"{tag} {lanes} lane(s), {live} live tokens: decode tick "
            f"graph {graph_ms:.3f} / {graph_ms2:.3f} ms, eager "
            f"{eager_ms:.3f} ms, bound {bound_ms:.3f} ms (bytes: "
            f"{w_gb:.2f} GB of weights read once + the live K/V at 3.35 "
            f"TB/s)")
        del eng
        gc.collect()
    t8 = rows[8]
    log(f"{tag} 8 lanes, same state: graph vs eager logits max abs "
        f"diff {t8['max_abs_diff']:.3e}, same greedy tokens; per tick "
        f"(host launch calls, device kernels, device busy ms): graph "
        f"{t8['launches_graph']}, eager {t8['launches_eager']}")
    return rows


def _agree(got, want) -> tuple:
    """(identical requests, tokens before each request's first
    divergence) of ``got`` against ``want``."""
    same = sum(a == b for a, b in zip(got, want))
    prefix = 0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if x != y:
                break
            prefix += 1
    return same, prefix


def phase_quantized(torch, cfg, params, cont) -> dict:
    """The predictor's engine on Llama-3-8B quantized from the serving
    phase's bf16 weights, int8 then int4 (``quantize=``): the 16 requests
    of the continuous phase on the graph route, held to the quantized
    model's own teacher-forced reference; the tokens that agree with the
    bf16 run (a reading); the weights' bytes against bf16's; the tick at
    1, 4 and 8 lanes against a bound on the quantized bytes; graph
    against eager logits at 8 lanes."""
    from kubedl_tpu_torch.ops import quant
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine

    reqs, served = cont["reqs"], cont["served"]
    bf16_bytes = quant.tree_nbytes(params)
    out = {}
    for mode, wrapper in (("int8", quant.QTensor), ("int4", quant.Q4Tensor)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_alloc = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = ContinuousBatchingEngine(cfg, params, lanes=CONT_LANES,
                                       max_len=CONT_MAX_LEN, quantize=mode,
                                       device="cuda")
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
        qparams = eng.params
        leaves = [qparams["lm_head"]] + [qparams["layers"][k] for k in (
            "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
        if not all(isinstance(w, wrapper) and w.device.type == "cuda"
                   for w in leaves):
            raise AssertionError(f"the {mode} engine does not hold "
                                 f"{wrapper.__name__} leaves on the card")
        nbytes = quant.tree_nbytes(qparams)
        t0 = time.perf_counter()
        got, lps = _run(eng, reqs)
        wall = time.perf_counter() - t0
        ticks_run = _graph_only(eng, f"({mode})")
        peak = torch.cuda.max_memory_allocated()
        del eng
        gc.collect()
        same, prefix = _agree(got, served)
        row = {"quantize_s": q_s, "bytes": nbytes, "bf16_bytes": bf16_bytes,
               "run_s": wall, "identical_to_bf16": same,
               "tokens_agreeing_with_bf16": prefix,
               "peak_gib": peak / 2**30,
               "peak_over_base_gib": (peak - base_alloc) / 2**30}
        log(f"[quant] {mode}: quantized on the card in {q_s:.1f} s; weights "
            f"{nbytes / 1e9:.3f} GB against bf16's {bf16_bytes / 1e9:.3f} "
            f"GB ({nbytes / bf16_bytes:.4f}); peak device memory "
            f"{row['peak_gib']:.2f} GiB ({row['peak_over_base_gib']:.2f} "
            f"GiB above the bf16 weights already held); 16 requests in "
            f"{wall:.3f} s ({sum(map(len, got)) / wall:.1f} tokens/s, the "
            f"decode graph's capture included), ticks by route {ticks_run}")
        log(f"[quant] {mode} against the bf16 run (a reading, not a gate): "
            f"{same}/16 requests identical, {prefix} of "
            f"{sum(map(len, served))} tokens before each request's first "
            f"divergence")
        row["hold"] = _hold(torch, cfg, qparams, reqs, got,
                            f"({mode}) quantized continuous", lps=lps)

        def engine(lanes, qp=qparams):
            return ContinuousBatchingEngine(cfg, qp, lanes=lanes,
                                            max_len=CONT_MAX_LEN,
                                            device="cuda")
        row["ticks"] = _tick_table(torch, engine, cfg, qparams, reqs[1][0],
                                   f"[quant] {mode}")
        out[mode] = row
        del qparams, leaves, engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_adapters(torch, cfg, params, cont) -> dict:
    """Adapter pages in the predictor's engine: a catalog of 3 adapters
    of 2 pool pages each, at most 2 resident, and 12 of the continuous
    phase's requests spread over the base model and the adapters. The
    tokens must equal the base model's run (a), adapters fault in and
    evict, every tick replays the graph, and every page but the resident
    adapters' pins is back in the pool at the end."""
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    from kubedl_tpu_torch.serving.adapters import AdapterCatalog, AdapterSpec

    cat = AdapterCatalog()
    for m in ("m-a", "m-b", "m-c"):
        cat.register(AdapterSpec(model=m, pages=2, rank=16))
    eng = ContinuousBatchingEngine(cfg, params, lanes=CONT_LANES,
                                   max_len=CONT_MAX_LEN, adapters=cat,
                                   max_adapters=2, device="cuda")
    reqs = cont["reqs"][:12]
    models = ["", "m-a", "m-b", "m-c"] * 3
    t0 = time.perf_counter()
    rs = [eng.submit(p, n, logprobs=True, model=m)
          for (p, n), m in zip(reqs, models)]
    eng.run([])
    wall = time.perf_counter() - t0
    got = [r.result() for r in rs]
    lps = [list(r.logprobs) for r in rs]
    ticks = _graph_only(eng, "(adapters)")
    st = eng.adapter_status()
    refs = eng._bpool.refcounts()
    log(f"[adapt] 12 requests over the base model and 3 adapters (2 pages "
        f"each, at most 2 resident) in {wall:.3f} s: faults {st['faults']}, "
        f"evictions {st['evictions']}, loads {st['loads']}, resident "
        f"{st['resident']} ({st['pages']} pages, peak {st['peak_pages']}); "
        f"pool {eng._bpool.free_count}/{eng.pool_blocks} blocks free; "
        f"ticks by route {ticks}")
    if sum(st["faults"].values()) < 3 or st["evictions"] < 1:
        raise AssertionError(f"the adapters never faulted and evicted: {st}")
    if st["active"] or eng._bpool.free_count != eng.pool_blocks - \
            st["pages"] or any(r != 1 for r in refs.values()):
        raise AssertionError(f"pages not back in the pool: {st}, "
                             f"{eng._bpool.free_count} free, refcounts "
                             f"{refs}")
    r = _hold(torch, cfg, params, reqs, got, "(adapters) base + 3 adapters",
              want=cont["served"][:12], want_label="the base model's (a)",
              exact=True, lps=lps)
    return {"status": st, "run_s": wall, "identical": r["identical"],
            "ticks": ticks}


#: the tensor-parallel phases' timeout for every wait of one rank on
#: another, seconds
TP_TIMEOUT_S = 300.0
#: K1 at the local shape of one rank of Llama-3-8B over tp=2 in
#: ``/v1/embeddings``: half the query and half the KV heads
TP_LOCAL = {**MAIN, "nh": 16, "nkv": 4}
#: the embeddings phases' two inputs (the longer is 512 tokens with BOS)
EMBED_TEXTS = ("kubedl " * 73)[:511], "a TPU kernel ported by hand to " \
    "Hopper " * 8


#: ``[tp2]``'s serving runs over the axes that place nothing (``dp``,
#: ``pp``) or the model width (``fsdp``): Llama-3-8B's first
#: ``TP2_OTHER_LAYERS`` layers, the first ``len(TP2_OTHER_NEW)`` continuous
#: requests with these new-token counts (under ``fsdp`` every step gathers
#: each weight through the host, 0.9 GB a layer and 2.1 GB of embedding
#: and head: ~3 s a step on an H100 at 700 W, PERF.md §6)
TP2_OTHER_AXES, TP2_OTHER_LAYERS, TP2_OTHER_NEW = ("fsdp", "dp", "pp"), 2, (
    4, 4)
#: ``[tp2]``'s Llama-3-8B requests at tp=2 (the script's time limit)
TP2_REQS = 4


#: ``[tp2]``'s embeddings check: the least cosine of any position's hidden
#: state on rank 0 with the unsharded forward's (bf16 rounds the two
#: ranks' partial sums before their sum, so the directions differ a
#: little; a rank reading wrong rows or wrong KV heads turns them)
TP2_HIDDEN_COS = 0.99


def _tp2_embed_ids(cfg) -> "np.ndarray":
    """``[tp2]``'s embeddings input: [2, 512] ids drawn over the whole
    vocabulary (seed 6), so each rank's vocab shard holds about half of
    the looked-up rows (byte-tokenized text lies in rank 0's alone)."""
    import numpy as np
    rng = np.random.default_rng(6)
    return rng.integers(3, cfg.vocab_size, (TP_LOCAL["b"], TP_LOCAL["sq"]),
                        dtype=np.int64)


def _embed_ids(texts) -> "np.ndarray":
    import numpy as np

    from kubedl_tpu_torch.tokenizer import ByteTokenizer, encode_prompt
    tok = ByteTokenizer()
    ids = [encode_prompt(tok, t) for t in texts]
    out = np.zeros((len(ids), max(map(len, ids))), np.int64)
    for i, r in enumerate(ids):
        out[i, :len(r)] = r
    return out


def phase_tp(torch, cfg, params, cont) -> dict:
    """Tensor-parallel serving through its own path at world size 1: a
    one-rank NCCL group (``parallel.launch.open_group``) and the serving
    mesh ``MeshConfig(dp=1, fsdp=1, tp=1)`` over it, so
    ``ContinuousBatchingEngine(mesh=...)`` runs on the continuous phase's
    Llama-3-8B weights with every device step posted on the step channel
    (packed and pickled; one rank broadcasts nothing) and the tick on the
    graph route (one rank's collectives are capturable). (a) The
    continuous phase's 16 requests: tokens equal to its served tokens bit
    for bit (tp=1 cuts nothing, so the computation is the unsharded
    one); (b) the graph tick at 1, 4 and 8 lanes against the unsharded
    engine's on the same state, in turns (the channel's host cost: a
    reading, not a gate); (c)
    ``/v1/embeddings`` through ``InferenceServer`` on the meshed engine:
    one K1 launch a layer, all ``sm90``, vectors equal bit for bit to an
    unsharded server's on the same weights; (d) ``build_engine`` with
    ``tp=2`` refuses on a one-card machine before reading anything.

    What world size 1 cannot show: the all-reduces, the vocab lookup's
    sum and the logits' all-gather inside a captured tick (each collective
    on a one-rank group is skipped). ``[tp2]`` runs them over gloo."""
    import numpy as np
    import torch.distributed as dist

    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.parallel import launch
    from kubedl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from kubedl_tpu_torch.serving import (ContinuousBatchingEngine,
                                          InferenceServer, ServerConfig)
    from kubedl_tpu_torch.serving import __main__ as serve_main
    from kubedl_tpu_torch.tokenizer import ByteTokenizer

    reqs, served = cont["reqs"], cont["served"]
    out = {}
    launch.open_group(0, 1, _free_port(), torch.device("cuda", 0),
                      TP_TIMEOUT_S)
    try:
        mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=1), device="cuda")

        def engine(**kw):
            kw.setdefault("lanes", CONT_LANES)
            return ContinuousBatchingEngine(cfg, params, max_len=CONT_MAX_LEN,
                                            mesh=mesh, device="cuda", **kw)

        eng = engine()
        t0 = time.perf_counter()
        got, lps = _run(eng, reqs)
        wall = time.perf_counter() - t0
        out["ticks_a"] = _graph_only(eng, "[tp] (a)")
        out["posts"] = eng._channel.posts
        same = sum(a == b for a, b in zip(got, served))
        log(f"[tp] (a) 16 requests through the step channel (tp=1, NCCL "
            f"group of one): {wall:.3f} s, {eng._channel.posts} steps "
            f"posted, ticks by route {out['ticks_a']}; tokens identical to "
            f"the continuous phase's: {same}/16 requests")
        if got != served:
            raise AssertionError("[tp] tokens differ from the unsharded "
                                 "engine's")
        _hold(torch, cfg, params, reqs, got, "[tp] (a) tp=1 mesh",
              want=served, want_label="the continuous phase", exact=True,
              lps=lps)
        del eng
        gc.collect()

        out["ticks"] = _tp_tick_ab(torch, cfg, params, mesh, reqs[1][0])

        ids = _embed_ids(EMBED_TEXTS)
        vecs = {}
        for tag, kw in (("tp", {"mesh": mesh}), ("unsharded", {})):
            e = ContinuousBatchingEngine(cfg, params, lanes=1,
                                         max_len=CONT_MAX_LEN, device="cuda",
                                         **kw).start()
            srv = InferenceServer(e, ServerConfig(
                model_name="llama3-8b", host="127.0.0.1", port=0,
                tokenizer=ByteTokenizer())).start()
            try:
                if tag == "tp":
                    _reset_counts(attn)
                emb = json.loads(_post(srv.url, "/v1/embeddings",
                                       {"input": list(EMBED_TEXTS)}))
                if tag == "tp":
                    out["embeddings_launches"] = attn.flash_forward.launches
                    out["embeddings_by_route"] = dict(
                        attn.flash_forward.launches_by_route)
            finally:
                srv.stop()
                e.stop()
            vecs[tag] = np.asarray([d["embedding"] for d in emb["data"]])
        k1 = out["embeddings_launches"]
        if k1 != cfg.n_layers or out["embeddings_by_route"]["sm90"] != k1:
            raise AssertionError(f"[tp] /v1/embeddings launched K1 {k1} "
                                 f"times {out['embeddings_by_route']}; want "
                                 f"{cfg.n_layers}, all sm90")
        if vecs["tp"].shape != (2, cfg.d_model) or not np.array_equal(
                vecs["tp"], vecs["unsharded"]):
            raise AssertionError(
                f"[tp] embeddings differ from the unsharded server's: max "
                f"abs diff {np.abs(vecs['tp'] - vecs['unsharded']).max()}")
        log(f"[tp] (c) /v1/embeddings ({ids.shape[1]} tokens) on the meshed "
            f"engine: {k1} K1 launches {out['embeddings_by_route']}, vectors "
            f"equal bit for bit to the unsharded server's")
    finally:
        dist.destroy_process_group()

    if torch.cuda.device_count() == 1:
        try:
            serve_main.build_engine(str(BUILD_OUT / "no-such-artifact"),
                                    CONT_LANES, "", 0, tp=2)
        except ValueError as e:
            out["refusal"] = str(e)
        if out.get("refusal") != "KUBEDL_SERVING_TP=2 but only 1 local " \
                "devices":
            raise AssertionError(f"[tp] build_engine(tp=2) on one card: "
                                 f"{out.get('refusal')!r}")
        log(f"[tp] (d) build_engine(tp=2) on one card refuses before "
            f"loading: {out['refusal']}")
    row = _fwd_timing(torch, TP_LOCAL, seed=460)
    q, k, v, _ = _inputs(torch, TP_LOCAL, seed=460)
    got_o, _ = attn.flash_forward(q, k, v, True)
    ref_o, _ = attn.flash_forward_plain(q, k, v, True)
    row["max_abs_err"] = (got_o.float() - ref_o.float()).abs().max().item()
    if row["max_abs_err"] > ATOL["bfloat16"] or row["kernel_route"] != \
            "sm90":
        raise AssertionError(f"[tp] K1 at {_shape(TP_LOCAL)}: {row}")
    out["k1_local"] = row
    log(f"[tp] K1 at one tp=2 rank's embeddings shape {_shape(TP_LOCAL)} "
        f"({row['kernel_route']}): max_abs_err {row['max_abs_err']:.3e}, "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return out


def _tp_tick_ab(torch, cfg, params, mesh, prompt) -> dict:
    """The graph tick through the step channel (tp=1 mesh) against the
    unsharded engine's on the same weights and lane state, at 1, 4 and 8
    lanes, timed in turns (unsharded, meshed, meshed, unsharded) so run
    order does not read as the channel's cost; at 8 lanes the device
    busy time and kernels of each (``_tick_launches``)."""
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    rows = {}
    for lanes in (1, 4, 8):
        engs = {}
        for tag, kw in (("unsharded", {}), ("tp", {"mesh": mesh})):
            e = ContinuousBatchingEngine(cfg, params, lanes=lanes,
                                         max_len=CONT_MAX_LEN, device="cuda",
                                         **kw)
            for i in range(lanes):
                e.submit(prompt[:500] + [i + 3], 256)
            e.step()
            engs[tag] = e
        row = {tag: [] for tag in engs}
        for tag in ("unsharded", "tp", "tp", "unsharded"):
            row[tag].append(_tick_ms(torch, engs[tag], None))
        if lanes == 8:
            row["launches"] = {tag: _tick_launches(torch, e, None)
                               for tag, e in engs.items()}
            # the post alone, host clock: what the meshed tick adds
            e = engs["tp"]
            args = {"tick": "paged", "buf": e._tick_p.pack(
                e._cur, e._pos, e._tables), "eager": False}
            t0 = time.perf_counter()
            for _ in range(10000):
                e._channel.post("decode", args)
            row["post_us"] = (time.perf_counter() - t0) * 1e2
        for tag, e in engs.items():
            _graph_only(e, f"[tp] (b) {tag} {lanes} lanes")
        row["host_cost_ms"] = (sum(row["tp"]) - sum(row["unsharded"])) / 2
        rows[lanes] = row
        log(f"[tp] (b) {lanes} lane(s), graph tick in turns: unsharded "
            f"{row['unsharded'][0]:.3f}, tp=1 mesh {row['tp'][0]:.3f} / "
            f"{row['tp'][1]:.3f}, unsharded {row['unsharded'][1]:.3f} ms "
            f"(channel's cost {row['host_cost_ms']:+.3f} ms)"
            + ("" if lanes != 8 else
               f"; per tick (host launch calls, device kernels, device busy "
               f"ms): unsharded {row['launches']['unsharded']}, tp "
               f"{row['launches']['tp']}; one post of the tick alone "
               f"{row['post_us']:.2f} us (host clock, 10,000 posts)"))
        del engs, e
        gc.collect()
    return rows


def _tp2_rank(rank, port, models, queue):
    """One rank of ``[tp2]`` on ``cuda:0`` (both ranks share the card):
    a gloo group over the two processes, the serving mesh at tp=2, K1 at
    this rank's local shape against its plain version, then Llama-3-8B
    and Gemma-2B (``models``: name -> (config, the parent's weights over
    CUDA IPC, requests, embeddings ids)) through
    ``ContinuousBatchingEngine(mesh=...)`` (rank 0 schedules, rank 1
    follows) and the embeddings forward as an engine step. Each model's
    shared weights are dropped before the next: the parent frees a
    shared block only once every process that opened it has let it go.
    Puts ``(rank, result)`` or ``(rank, traceback)`` on ``queue``."""
    import traceback
    from datetime import timedelta

    try:
        import torch
        import torch.distributed as dist

        from kubedl_tpu_torch.ops import attention as attn
        from kubedl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
        from kubedl_tpu_torch.serving import ContinuousBatchingEngine

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank,
                                timeout=timedelta(seconds=TP_TIMEOUT_S))
        mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=2), device="cuda:0")
        res = {"rank": rank}
        q, k, v, _ = _inputs(torch, TP_LOCAL, seed=470 + rank)
        o, _ = attn.flash_forward(q, k, v, True)
        ref, _ = attn.flash_forward_plain(q, k, v, True)
        res["k1_err"] = (o.float() - ref.float()).abs().max().item()
        res["k1_route"] = attn.flash_fwd_route(q.dtype, TP_LOCAL["hd"])
        del q, k, v, o, ref
        for tag in ("llama", "gemma"):
            c, p, rs, emb = models.pop(tag)
            gc.collect()             # an engine and its ticks form a cycle
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            eng = ContinuousBatchingEngine(c, p, lanes=CONT_LANES,
                                           max_len=CONT_MAX_LEN, mesh=mesh,
                                           device="cuda:0")
            row = {"route": eng._tick_p.route}
            if eng._channel.leader:
                t0 = time.perf_counter()
                row["tokens"], row["logprobs"] = _run(eng, rs)
                row["seconds"] = time.perf_counter() - t0
                row["ticks"] = eng.tick_launches
                _reset_counts(attn)
                with torch.inference_mode():
                    x = eng.hidden_states(emb)
                    row["hidden"] = x.float().cpu().numpy()
                eng.stop()
            else:
                _reset_counts(attn)
                row["followed"] = eng.follow()
            torch.cuda.synchronize()
            row["k1"] = attn.flash_forward.launches
            row["k1_by_route"] = dict(attn.flash_forward.launches_by_route)
            row["peak_gib"] = (torch.cuda.max_memory_allocated()
                               - held) / 2**30
            row["local_wq"] = tuple(eng.params["layers"]["wq"].shape)
            row["local_cache"] = tuple(
                eng._pool["k"].shape)
            res[tag] = row
            del eng, p
        c2, p2, rs2 = models.pop("llama2")
        res["meshes"] = {}
        for axis in TP2_OTHER_AXES:
            other = build_mesh(MeshConfig(**{"fsdp": 1, axis: 2}),
                               device="cuda:0")
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            eng = ContinuousBatchingEngine(c2, p2, lanes=CONT_LANES,
                                           max_len=CONT_MAX_LEN, mesh=other,
                                           device="cuda:0")
            wq = eng.params["layers"]["wq"]
            row = {"route": eng._tick_p.route,
                   "model_mesh": {a: n for a, n in eng.mesh.shape.items()
                                  if n > 1},
                   "local_wq": tuple(getattr(wq, "local", wq).shape)}
            if eng._channel.leader:
                t0 = time.perf_counter()
                row["tokens"], row["logprobs"] = _run(eng, rs2)
                row["seconds"] = time.perf_counter() - t0
                row["ticks"] = eng.tick_launches
                eng.stop()
            else:
                row["followed"] = eng.follow()
            torch.cuda.synchronize()
            row["peak_gib"] = (torch.cuda.max_memory_allocated()
                               - held) / 2**30
            res["meshes"][axis] = row
            del eng, wq
        del p2
        gc.collect()
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, traceback.format_exc()))


def _tp2_meshes(torch, res, cfg2, params2, reqs2) -> dict:
    """``[tp2]``'s serving runs over ``fsdp``, ``dp`` and ``pp`` = 2,
    checked: every served token held to the teacher-forced reference by
    the near-tie rule and counted against the one-process engine's; the
    tick's route (``graph`` where the step runs no collective: ``dp`` and
    ``pp`` replicate, the model's mesh shows them as 1; ``eager`` under
    ``fsdp``'s gloo gathers); rank 1 followed every step; ``fsdp`` holds
    half of ``wq``'s model-width rows, ``dp`` and ``pp`` all of them."""
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(cfg2, params2, lanes=CONT_LANES,
                                   max_len=CONT_MAX_LEN, device="cuda")
    want, _ = _run(eng, reqs2)
    del eng
    gc.collect()
    out = {}
    for axis in TP2_OTHER_AXES:
        lead, follow = res[0]["meshes"][axis], res[1]["meshes"][axis]
        route = "eager" if axis == "fsdp" else "graph"
        want_rank = (route, cfg2.d_model // (2 if axis == "fsdp" else 1),
                     {"fsdp": 2} if axis == "fsdp" else {})
        bad = [f"rank {r}: route, local wq rows, model mesh {got}, want "
               f"{want_rank}" for r, got in enumerate(
                   (run["route"], run["local_wq"][1], run["model_mesh"])
                   for run in (lead, follow)) if got != want_rank]
        if not follow["followed"] or lead["ticks"][route] == 0:
            bad.append(f"ticks {lead['ticks']}, rank 1 followed "
                       f"{follow['followed']} steps")
        if bad:
            raise AssertionError(f"[tp2] {axis}=2: {bad}")
        r = _hold(torch, cfg2, params2, reqs2, lead["tokens"],
                  f"[tp2] {axis}=2", want=want,
                  want_label="the one-process engine", lps=lead["logprobs"])
        out[axis] = {"reading": r, "seconds": lead["seconds"],
                     "ticks": lead["ticks"],
                     "followed": follow["followed"],
                     "peak_gib": [lead["peak_gib"], follow["peak_gib"]]}
        log(f"[tp2] {axis}=2 ({cfg2.n_layers} layers): {len(reqs2)} "
            f"requests in {lead['seconds']:.2f} s, ticks {lead['ticks']}, "
            f"rank 1 followed {follow['followed']} steps; local wq "
            f"{lead['local_wq']}; peak "
            f"{[round(x, 3) for x in out[axis]['peak_gib']]} GiB by rank")
    return out


def _tp2_hidden(torch, tag, cfg, params, ids, hidden, tp=2,
                phase="tp2") -> dict:
    """Rank 0's embeddings forward at ``tp`` (``hidden`` [b, s, d]) held
    to the unsharded ``forward_hidden`` on the same weights and ids,
    position by position: the least cosine must reach
    ``TP2_HIDDEN_COS``."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import attention as attn

    with torch.inference_mode():
        ref = llama.forward_hidden(cfg, params, torch.as_tensor(
            ids, device="cuda")).float()
    _reset_counts(attn)          # the reference ran K1 too
    got = torch.from_numpy(hidden).cuda()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"[{phase}] {tag} embeddings: shape "
                             f"{tuple(got.shape)}, want {tuple(ref.shape)}, "
                             "all finite")
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    rel = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    last = cfg.vocab_size // tp * (tp - 1)
    out = {"min_cos": cos.min().item(), "max_rel": rel.max().item(),
           "max_abs_err": (got - ref).abs().max().item(),
           "ids_on_last_rank": int((ids >= last).sum())}
    log(f"[{phase}] {tag} embeddings of {ids.shape} ids "
        f"({out['ids_on_last_rank']} in rank {tp - 1}'s vocab shard) "
        f"against the unsharded forward, by position: least cosine "
        f"{out['min_cos']:.6f}, largest relative error "
        f"{out['max_rel']:.4f}, max_abs_err {out['max_abs_err']:.4f}")
    if out["min_cos"] < TP2_HIDDEN_COS:
        raise AssertionError(f"[{phase}] {tag} embeddings disagree with "
                             f"the unsharded forward: {out}")
    return out


def _tp2_reading(torch, tag, res, model) -> dict:
    """One model's ``[tp2]`` results from both ranks, checked: the eager
    route, K1 once a layer on each rank, all ``sm90``, rank 0's hidden
    states against the unsharded forward, and the served tokens held to
    the unsharded reference."""
    cfg, params, reqs, ids = model
    lead = res[0][tag]
    for rank in (0, 1):
        row = res[rank][tag]
        if row["route"] != "eager":
            raise AssertionError(f"[tp2] {tag} rank {rank}: tick route "
                                 f"{row['route']}, want eager (gloo)")
        if row["k1"] != cfg.n_layers or \
                row["k1_by_route"]["sm90"] != cfg.n_layers:
            raise AssertionError(f"[tp2] {tag} rank {rank}: K1 {row['k1']} "
                                 f"{row['k1_by_route']}, want "
                                 f"{cfg.n_layers} on sm90")
    if lead["ticks"]["graph"] or not lead["ticks"]["eager"]:
        raise AssertionError(f"[tp2] {tag}: ticks {lead['ticks']}")
    hidden = _tp2_hidden(torch, tag, cfg, params, ids, lead.pop("hidden"))
    r = _hold(torch, cfg, params, reqs, lead["tokens"], f"[tp2] {tag} tp=2",
              lps=lead["logprobs"])
    out = {"reading": r, "hidden": hidden, "ticks": lead["ticks"],
           "seconds": lead["seconds"],
           "followed": res[1][tag]["followed"],
           "k1": [res[k][tag]["k1"] for k in (0, 1)],
           "peak_gib": [res[k][tag]["peak_gib"] for k in (0, 1)]}
    log(f"[tp2] {tag}: {len(reqs)} requests in {lead['seconds']:.2f} s on "
        f"2 ranks (ticks {lead['ticks']}, rank 1 followed "
        f"{res[1][tag]['followed']} steps); local wq {lead['local_wq']}, "
        f"local pool {lead['local_cache']}; K1 {out['k1']} launches by "
        f"rank, all sm90; peak {[round(x, 2) for x in out['peak_gib']]} GiB "
        f"by rank")
    return out


def phase_tp2(torch, cfg, params, reqs) -> dict:
    """Tensor-parallel serving at tp=2 on the one card: two processes on
    ``cuda:0`` under a gloo group (NCCL refuses two ranks on one device),
    so the tick's collectives run eagerly (the route asserted ``eager``)
    and every collective moves through the host. Llama-3-8B at full width
    (the continuous phase's weights, shared with the children over CUDA
    IPC): each rank holds half of every sharded leaf and 4 of the 8 KV
    heads; ``TP2_REQS`` of the continuous phase's requests, every served
    token and its log-probability held to the unsharded teacher-forced
    reference (``_hold``). Then Gemma-2B at full size (random bf16, seed 0; one KV
    head, so every rank holds K/V whole and writes the same cache) with 4
    requests. Each rank checks K1 at its local embeddings shape against
    the plain version and runs the embeddings forward as an engine step
    (K1 on its own heads: 32 and 18 launches a rank) on [2, 512] ids
    drawn over the whole vocabulary; rank 0's hidden states must agree
    with the unsharded forward's position by position (``_tp2_hidden``);
    each rank's peak memory is reported. Then the same two ranks serve
    Llama-3-8B's first 2 layers over ``fsdp=2``, ``dp=2`` and ``pp=2``
    (``_tp2_meshes``)."""
    import dataclasses

    import torch.multiprocessing as tmp

    from kubedl_tpu_torch.models import gemma, llama

    gcfg = gemma.gemma_2b()
    gparams = llama.init_params(
        gcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    reqs_tp = reqs[:TP2_REQS]
    greqs = [(p[:200], n) for p, n in reqs[8:12]]
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    cfg2 = dataclasses.replace(cfg, n_layers=TP2_OTHER_LAYERS)
    params2 = _first_layers(params, TP2_OTHER_LAYERS)
    reqs2 = [(p, n) for (p, _), n in zip(reqs, TP2_OTHER_NEW)]
    t0 = time.perf_counter()
    models = {"llama": (cfg, params, reqs_tp, _tp2_embed_ids(cfg)),
              "gemma": (gcfg, gparams, greqs, _tp2_embed_ids(gcfg)),
              "llama2": (cfg2, params2, reqs2)}
    procs = [ctx.Process(target=_tp2_rank, daemon=True,
                         args=(r, port, models, queue)) for r in range(2)]
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < 2:
            rank, value = queue.get(timeout=TP_TIMEOUT_S)
            res[rank] = value
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(10)
        # the blocks the children opened, released by them, go back to
        # the allocator (else they stay held until this process ends)
        torch.cuda.ipc_collect()
    wall = time.perf_counter() - t0
    for rank, value in res.items():
        if isinstance(value, str):
            raise AssertionError(f"[tp2] rank {rank} failed:\n{value}")
    out = {"seconds": wall}
    for tag in ("llama", "gemma"):
        out[tag] = _tp2_reading(torch, tag, res, models[tag])
    out["meshes"] = _tp2_meshes(torch, res, cfg2, params2, reqs2)
    out["k1_err"] = [res[k]["k1_err"] for k in (0, 1)]
    if max(out["k1_err"]) > ATOL["bfloat16"] or {
            res[k]["k1_route"] for k in (0, 1)} != {"sm90"}:
        raise AssertionError(f"[tp2] K1 at {_shape(TP_LOCAL)}: errors "
                             f"{out['k1_err']}")
    log(f"[tp2] K1 at {_shape(TP_LOCAL)} on each rank against its plain "
        f"version: max_abs_err {out['k1_err']}; phase {wall:.1f} s")
    before = torch.cuda.memory_allocated()
    del gparams, models
    gc.collect()
    torch.cuda.ipc_collect()
    freed = (before - torch.cuda.memory_allocated()) / 1e9
    want = gcfg.num_params * 2 / 1e9
    log(f"[tp2] Gemma-2B's weights, shared with both ranks, freed: "
        f"{freed:.2f} GB of {want:.2f} GB")
    if freed < 0.99 * want:
        raise AssertionError("[tp2] the weights the ranks shared were not "
                             "given back")
    return out


#: ``[tp8]``: Qwen2-7B at full width, TP8_LAYERS deep, random bf16 from
#: seed 0, over tp=8 in eight gloo processes on the one card; its
#: continuous requests are the first TP8_REQS of the continuous phase's
#: prompts (drawn over its vocabulary), TP8_NEW new tokens each (an eager
#: tick of eight gloo ranks took ~0.5 s on an H100 at 700 W: PERF.md §6)
TP8, TP8_LAYERS, TP8_REQS, TP8_NEW = 8, 2, 4, 16
#: K1 at two of ``[tp8]``'s local embeddings shapes, timed: rank 0's 4
#: query heads over the 1 KV head they read, rank 5's 3 over 3
TP8_LOCAL = {"rank0": {**TP_LOCAL, "nh": 4, "nkv": 1},
             "rank5": {**TP_LOCAL, "nh": 3, "nkv": 3}}


def _tp8_rank(rank, port, model, queue):
    """One of ``[tp8]``'s eight ranks on ``cuda:0``: a gloo group of 8,
    the serving mesh at tp=8 (28 query heads: ranks 0-3 compute 4, ranks
    4-7 three; the 4 KV heads held whole), K1 at this rank's embeddings
    shape (its query heads and the KV heads they read, ``_local_kv``)
    against its plain version, then ``ContinuousBatchingEngine(mesh=...)``
    on the parent's weights (CUDA IPC): rank 0 serves the requests and
    runs the embeddings forward as an engine step, the others follow.
    Reports the rank's bytes of weights and cache, its peak memory and its
    K1 launches. Puts ``(rank, result)`` or ``(rank, traceback)`` on
    ``queue``."""
    import traceback
    from datetime import timedelta

    try:
        import torch
        import torch.distributed as dist

        from kubedl_tpu_torch.models import llama
        from kubedl_tpu_torch.ops import attention as attn
        from kubedl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
        from kubedl_tpu_torch.serving import ContinuousBatchingEngine

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=TP8, rank=rank,
                                timeout=timedelta(seconds=TP_TIMEOUT_S))
        mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=TP8), device="cuda:0")
        cfg, params, reqs, ids = model
        first, n = llama.head_split(cfg.n_heads, TP8, rank)
        res = {"rank": rank, "heads": (first, n)}
        kv = torch.randn((TP_LOCAL["b"], TP_LOCAL["sq"], cfg.n_kv_heads,
                          cfg.hd), generator=torch.Generator(
                              device="cuda").manual_seed(480 + rank),
                         device="cuda", dtype=torch.bfloat16)
        k, v = llama._local_kv(cfg, kv, kv.flip(1), mesh)
        q = torch.randn((TP_LOCAL["b"], TP_LOCAL["sq"], n, cfg.hd),
                        generator=torch.Generator(device="cuda").manual_seed(
                            490 + rank), device="cuda", dtype=torch.bfloat16)
        o, _ = attn.flash_forward(q, k, v, True)
        ref, _ = attn.flash_forward_plain(q, k, v, True)
        res["k1_shape"] = (tuple(q.shape), tuple(k.shape))
        res["k1_err"] = (o.float() - ref.float()).abs().max().item()
        res["k1_route"] = attn.flash_fwd_route(q.dtype, cfg.hd)
        del q, k, v, o, ref, kv
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = ContinuousBatchingEngine(cfg, params, lanes=CONT_LANES,
                                       max_len=CONT_MAX_LEN, mesh=mesh,
                                       device="cuda:0")
        res["build_s"] = time.perf_counter() - t0
        res["route"] = eng._tick_p.route
        res["weight_bytes"] = sum(
            t.numel() * t.element_size() for v in eng.params.values()
            for t in (v.values() if isinstance(v, dict) else [v]))
        res["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for t in eng._pool.values())
        res["local_wq"] = tuple(eng.params["layers"]["wq"].shape)
        res["local_pool"] = tuple(eng._pool["k"].shape)
        if eng._channel.leader:
            t0 = time.perf_counter()
            res["tokens"], res["logprobs"] = _run(eng, reqs)
            res["seconds"] = time.perf_counter() - t0
            res["ticks"] = eng.tick_launches
            _reset_counts(attn)
            t0 = time.perf_counter()
            with torch.inference_mode():
                res["hidden"] = eng.hidden_states(ids).float().cpu().numpy()
            res["embed_s"] = time.perf_counter() - t0
            eng.stop()
        else:
            _reset_counts(attn)
            res["followed"] = eng.follow()
        torch.cuda.synchronize()
        res["k1"] = attn.flash_forward.launches
        res["k1_by_route"] = dict(attn.flash_forward.launches_by_route)
        res["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
        del eng, params, model
        gc.collect()
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, traceback.format_exc()))


def phase_tp8(torch) -> dict:
    """Tensor-parallel serving where ``tp`` does not divide the query
    heads: Qwen2-7B (``qwen2_7b()``: 28 query heads over 4 KV heads of
    width 128, q/k/v biases) at full width, ``TP8_LAYERS`` layers deep,
    random bf16 weights from seed 0, over tp=8 in eight processes on
    ``cuda:0`` under gloo (``_tp8_rank``; the weights shared over CUDA
    IPC). Ranks 0-3 compute 4 whole query heads and ranks 4-7 three;
    every rank holds the 4 KV heads whole and reads the ones its heads
    map to. ``TP8_REQS`` greedy requests served on rank 0, every token
    and its log-probability held to the teacher-forced reference by the
    near-tie rule and counted against the one-process engine's tokens;
    ``/v1/embeddings``' forward of [2, 512] ids as an engine step, K1 once
    a layer on every rank, all ``sm90`` (at 4 and 3 local query heads),
    rank 0's hidden states against the unsharded forward position by
    position (``TP2_HIDDEN_COS``); each rank's K1 at its local shape
    against the plain version, and K1 timed at two of them
    (``TP8_LOCAL``); seconds, bytes and peak memory by rank."""
    import dataclasses

    import torch.multiprocessing as tmp

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine

    cfg = dataclasses.replace(llama.qwen2_7b(), n_layers=TP8_LAYERS)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    reqs = [(p, TP8_NEW) for p, _ in _cont_requests(cfg)[1][:TP8_REQS]]
    ids = _tp2_embed_ids(cfg)
    eng = ContinuousBatchingEngine(cfg, params, lanes=CONT_LANES,
                                   max_len=CONT_MAX_LEN, device="cuda")
    want, _ = _run(eng, reqs)
    del eng
    gc.collect()
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_tp8_rank, daemon=True,
                         args=(r, port, (cfg, params, reqs, ids), queue))
             for r in range(TP8)]
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < TP8:
            rank, value = queue.get(timeout=TP_TIMEOUT_S)
            if isinstance(value, str):
                raise AssertionError(f"[tp8] rank {rank} failed:\n{value}")
            res[rank] = value
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(10)
        torch.cuda.ipc_collect()
    wall = time.perf_counter() - t0
    lead = res[0]
    bad = []
    for r in range(TP8):
        row = res[r]
        first, n = row["heads"]
        if row["route"] != "eager" or row["k1"] != cfg.n_layers or \
                row["k1_by_route"]["sm90"] != cfg.n_layers:
            bad.append(f"rank {r}: tick route {row['route']}, K1 "
                       f"{row['k1_by_route']} (want eager, {cfg.n_layers} "
                       "on sm90)")
        if row["local_wq"] != (cfg.n_layers, cfg.d_model, n * cfg.hd):
            bad.append(f"rank {r}: local wq {row['local_wq']} for {n} "
                       "heads")
        if row["k1_err"] > ATOL["bfloat16"] or row["k1_route"] != "sm90":
            bad.append(f"rank {r}: K1 at {row['k1_shape']} on "
                       f"{row['k1_route']}: max_abs_err {row['k1_err']}")
        if r and not row["followed"]:
            bad.append(f"rank {r} followed no step")
    if lead["ticks"]["graph"] or not lead["ticks"]["eager"]:
        bad.append(f"ticks {lead['ticks']}")
    if bad:
        raise AssertionError(f"[tp8] {bad}")
    reading = _hold(torch, cfg, params, reqs, lead["tokens"], "[tp8] tp=8",
                    want=want, want_label="the one-process engine",
                    lps=lead["logprobs"])
    hidden = _tp2_hidden(torch, "qwen2-7b", cfg, params, ids,
                         lead.pop("hidden"), tp=TP8, phase="tp8")
    heads = [res[r]["heads"][1] for r in range(TP8)]
    timed = {}
    for tag, case in TP8_LOCAL.items():
        row = timed[tag] = {"shape": _shape(case),
                            **_fwd_timing(torch, case, seed=500 + case["nh"])}
        q, k, v, _ = _inputs(torch, case, seed=500 + case["nh"])
        row["max_abs_err"] = (attn.flash_forward(q, k, v, True)[0].float()
                              - attn.flash_forward_plain(q, k, v, True)[0]
                              .float()).abs().max().item()
        if row["max_abs_err"] > ATOL["bfloat16"] or \
                row["kernel_route"] != "sm90":
            raise AssertionError(f"[tp8] K1 at {row['shape']}: {row}")
        log(f"[tp8] K1 at {tag}'s shape {row['shape']} "
            f"({row['kernel_route']}): max_abs_err {row['max_abs_err']:.3e}, "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    out = {"seconds": wall, "timed": timed, "serve_s": lead["seconds"],
           "embed_s": lead["embed_s"], "ticks": lead["ticks"],
           "reading": reading, "hidden": hidden, "heads": heads,
           "k1": [res[r]["k1"] for r in range(TP8)],
           "k1_shapes": [res[r]["k1_shape"] for r in range(TP8)],
           "k1_err": [res[r]["k1_err"] for r in range(TP8)],
           "weight_bytes": [res[r]["weight_bytes"] for r in range(TP8)],
           "cache_bytes": [res[r]["cache_bytes"] for r in range(TP8)],
           "peak_gib": [res[r]["peak_gib"] for r in range(TP8)],
           "build_s": [res[r]["build_s"] for r in range(TP8)],
           "whole_weight_bytes": cfg.num_params * 2}
    log(f"[tp8] Qwen2-7B ({cfg.n_layers} layers, bf16) over tp=8 in 8 gloo "
        f"processes: query heads by rank {heads}; {len(reqs)} requests in "
        f"{lead['seconds']:.2f} s (ticks {lead['ticks']}); embeddings "
        f"{ids.shape} in {lead['embed_s']:.3f} s, K1 by rank {out['k1']}, "
        f"all sm90; phase {wall:.1f} s ({_card()})")
    log(f"[tp8] K1 by rank at (q, k) shapes {out['k1_shapes']}: max_abs_err "
        f"{[f'{e:.3e}' for e in out['k1_err']]}")
    log(f"[tp8] bytes by rank: weights {out['weight_bytes']} (whole "
        f"{out['whole_weight_bytes']}), KV pool {out['cache_bytes']}; peak "
        f"{[round(x, 3) for x in out['peak_gib']]} GiB; engine built in "
        f"{[round(x, 2) for x in out['build_s']]} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_gemma(torch) -> tuple:
    """Gemma-2B at full width and depth (random bf16 weights from seed 0)
    in the predictor's engine behind ``InferenceServer``: 16 greedy
    requests on 8 paged lanes held to the teacher-forced reference with
    their log-probabilities; ``/v1/embeddings`` of 2 inputs (512 and 305
    tokens), whose every layer must launch K1 once on the ``sm90`` route
    (head dim 256); the tick at 1, 4 and 8 lanes. Returns (config,
    params, readings)."""
    import numpy as np

    from kubedl_tpu_torch.models import gemma, llama
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.serving import (ContinuousBatchingEngine,
                                          InferenceServer, ServerConfig)
    from kubedl_tpu_torch.tokenizer import ByteTokenizer, encode_prompt

    cfg = gemma.gemma_2b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    log(f"[gemma] model: d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} of width {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied head, GeGLU, "
        f"{cfg.num_params / 1e9:.3f} B params bf16, random from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    _, reqs = _cont_requests(cfg)
    out = {}

    def engine(lanes=CONT_LANES):
        return ContinuousBatchingEngine(cfg, params, lanes=lanes,
                                        max_len=CONT_MAX_LEN, device="cuda")

    eng = engine().start()
    srv = InferenceServer(eng, ServerConfig(
        model_name="gemma-2b", host="127.0.0.1", port=0, max_batch=16,
        max_new_tokens=128, tokenizer=ByteTokenizer())).start()
    texts = ["kubedl " * 73, "a TPU kernel ported by hand to Hopper " * 8]
    texts[0] = texts[0][:511]          # + BOS = 512 tokens
    try:
        _post(srv.url, "/v1/models/gemma-2b:predict", {
            "instances": [{"prompt_tokens": [1, 2, 3], "max_tokens": 2}]})
        t0 = time.perf_counter()
        got = json.loads(_post(srv.url, "/v1/models/gemma-2b:predict", {
            "instances": [{"prompt_tokens": p, "max_tokens": n,
                           "logprobs": True} for p, n in reqs]}))
        wall = time.perf_counter() - t0
        served = [p["tokens"] for p in got["predictions"]]
        lps = [p["logprobs"] for p in got["predictions"]]
        out["tokens_per_s"] = sum(map(len, served)) / wall
        log(f"[gemma] 16 requests (prompts {min(CONT_LENS)}-"
            f"{max(CONT_LENS)} tokens) on 8 paged lanes through :predict in "
            f"{wall:.3f} s: {sum(map(len, served))} tokens, "
            f"{out['tokens_per_s']:.1f} tokens/s")
        ttft = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.submit(reqs[1][0], 1).result(timeout=120)
            ttft.append(1e3 * (time.perf_counter() - t0))
        out["ttft_ms"] = ttft
        log(f"[gemma] TTFT of a 512-token prompt: "
            f"{[round(x, 3) for x in ttft]} ms")
        # /v1/embeddings: the counts go to 0 just before and are read after
        attn.flash_forward.launches = 0
        attn.flash_forward.launches_by_route = {"sm90": 0, "simt": 0}
        t0 = time.perf_counter()
        emb = json.loads(_post(srv.url, "/v1/embeddings", {"input": texts}))
        out["embeddings_s"] = time.perf_counter() - t0
        out["embeddings_launches"] = attn.flash_forward.launches
        by_route = dict(attn.flash_forward.launches_by_route)
    finally:
        srv.stop()
        eng.stop()
    out["ticks_run"] = _graph_only(eng, "(gemma)")
    del eng
    gc.collect()
    vecs = np.asarray([d["embedding"] for d in emb["data"]])
    norms = np.linalg.norm(vecs, axis=-1)
    if vecs.shape != (2, cfg.d_model) or not np.isfinite(vecs).all() \
            or np.abs(norms - 1).max() > 1e-3:
        raise AssertionError(f"bad Gemma embeddings: shape {vecs.shape}, "
                             f"norms {norms}")
    if out["embeddings_launches"] != cfg.n_layers or \
            by_route != {"sm90": cfg.n_layers, "simt": 0}:
        raise AssertionError(f"Gemma embeddings launched flash_forward "
                             f"{out['embeddings_launches']} times, by route "
                             f"{by_route}; want {cfg.n_layers}, all sm90 "
                             f"(head dim 256)")
    tok = ByteTokenizer()
    ids = [encode_prompt(tok, t) for t in texts]
    toks = np.zeros((2, max(map(len, ids))), np.int64)
    for i, r in enumerate(ids):
        toks[i, :len(r)] = r
    chunked = unittest.mock.patch.object(
        llama, "multi_head_attention",
        lambda *a, **k: attn.multi_head_attention(*a, impl="chunked", **k))
    with chunked, torch.inference_mode():
        x = llama.forward_hidden(cfg, params,
                                 torch.as_tensor(toks, device="cuda"))
    ref = []
    for i, r in enumerate(ids):
        pooled = x[i, :len(r)].float().mean(0)
        ref.append((pooled / pooled.norm()).cpu().numpy())
    cos = [float(np.dot(a, b)) for a, b in zip(vecs, ref)]
    if min(cos) < 0.99:
        raise AssertionError(f"Gemma embeddings disagree with the chunked "
                             f"attention path: cosine {cos}")
    log(f"[gemma] /v1/embeddings 2 inputs ({emb['usage']['prompt_tokens']} "
        f"tokens) in {out['embeddings_s']:.3f} s: {cfg.n_layers} "
        f"flash_forward launches, by route {by_route}; against the chunked "
        f"path: cosine {[round(c, 6) for c in cos]}")
    out["hold"] = _hold(torch, cfg, params, reqs, served,
                        "(gemma) continuous", lps=lps)
    out["ticks"] = _tick_table(torch, engine, cfg, params, reqs[1][0],
                               "[gemma]")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[gemma] {out['peak_gib']:.2f} GiB peak device memory in the phase")
    return cfg, params, out


#: [gpred]'s depth: Gemma-2B at full width cut to its first 4 of 18 layers
#: since slice 19, to keep the script inside its time limit (the 18-layer
#: float32 artifact, ~10 GB, took ~75-90 s to write and load twice)
GPRED_LAYERS = 4


def phase_gemma_predictor(torch, cfg, params) -> dict:
    """``python -m kubedl_tpu_torch.serving`` over a ``save_model``
    artifact of Gemma-2B at full width cut to its first ``GPRED_LAYERS``
    layers (float32 ``params.npz``): ready, ``:predict`` held to the
    in-process engine, SIGTERM → 0; then the batch mode on the same
    artifact with ``KUBEDL_SERVING_QUANTIZE=int8``, held to the int8
    model's teacher-forced reference."""
    import dataclasses
    import os
    import shutil
    import signal

    import numpy as np

    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.ops.quant import quantize_params
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine

    cfg = dataclasses.replace(cfg, n_layers=GPRED_LAYERS)
    params = _first_layers(params, GPRED_LAYERS)
    path = BUILD_OUT / "gemma_model"
    t0 = time.perf_counter()
    io.save_model(cfg, params, str(path))
    size = (path / "params.npz").stat().st_size
    log(f"[gpred] artifact: {size / 1e9:.2f} GB params.npz written in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(3, cfg.vocab_size, n).tolist(), 12)
            for n in (40, 130, 300)]
    ref = ContinuousBatchingEngine(cfg, params, lanes=4,
                                   max_len=CONT_MAX_LEN, device="cuda")
    want = ref.run(reqs)
    del ref
    gc.collect()
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root),
           "KUBEDL_MODEL_PATH": str(path), "KUBEDL_MODEL_NAME": "gemma",
           "KUBEDL_SERVING_LANES": "4",
           "KUBEDL_SERVING_MAX_LEN": str(CONT_MAX_LEN),
           "KUBEDL_TOKENIZER": "off", "KUBEDL_SERVING_PORT": str(port)}
    env.pop("KUBEDL_KV_MODE", None)
    env.pop("KUBEDL_SERVING_QUANTIZE", None)
    log_path = BUILD_OUT / "gemma_predictor.log"
    cmd = [sys.executable, "-m", "kubedl_tpu_torch.serving"]
    out = {}
    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, cwd=root, stdout=logf,
                                stderr=subprocess.STDOUT)
        try:
            _wait_ready(url, proc, log_path, timeout=900)
            out["ready_s"] = time.perf_counter() - t0
            got = json.loads(_post(url, "/v1/models/gemma:predict", {
                "instances": [{"prompt_tokens": p, "max_tokens": n}
                              for p, n in reqs]}))
            served = [p["tokens"] for p in got["predictions"]]
            log(f"[gpred] ready in {out['ready_s']:.1f} s (load, graph "
                f"capture, bind); :predict of 3 requests")
            proc.send_signal(signal.SIGTERM)
            out["sigterm_rc"] = proc.wait(timeout=120)
            if out["sigterm_rc"] != 0:
                raise AssertionError(f"the Gemma predictor exited "
                                     f"{out['sigterm_rc']} on SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        _hold(torch, cfg, params, reqs, served, "(gpred) predictor",
              want=want, want_label="the in-process engine")
        inp, res = BUILD_OUT / "gemma_in.jsonl", BUILD_OUT / "gemma_out.jsonl"
        inp.write_text("\n".join(json.dumps({"prompt": p, "max_tokens": n})
                                 for p, n in reqs))
        t0 = time.perf_counter()
        rc = subprocess.run(cmd + ["--batch-input", str(inp),
                                   "--batch-output", str(res)],
                            env={**env, "KUBEDL_SERVING_QUANTIZE": "int8"},
                            cwd=root, stdout=logf, stderr=subprocess.STDOUT,
                            timeout=900).returncode
    out["batch_int8_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"int8 batch mode exited {rc}: "
                             f"{log_path.read_text()[-3000:]}")
    rows = [json.loads(ln) for ln in res.read_text().splitlines()]
    log(f"[gpred] batch mode, KUBEDL_SERVING_QUANTIZE=int8: {len(rows)} rows "
        f"in {out['batch_int8_s']:.1f} s, exit 0")
    shutil.rmtree(path)                  # ~3.9 GB of float32 weights
    qparams = quantize_params(params, mode="int8")
    _hold(torch, cfg, qparams, reqs, [r["tokens"] for r in rows],
          "(gpred) int8 batch mode")
    same, prefix = _agree([r["tokens"] for r in rows], want)
    log(f"[gpred] int8 against bf16 (a reading): {same}/3 requests "
        f"identical, {prefix} of 36 tokens before the first divergence")
    return out


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_ready(url: str, proc, log_path, timeout: float) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"the predictor exited {proc.returncode}: "
                                 f"{log_path.read_text()[-3000:]}")
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.5)
    raise AssertionError(f"the predictor never became ready: "
                         f"{log_path.read_text()[-3000:]}")


def phase_predictor(torch, cfg, params) -> dict:
    """``python -m kubedl_tpu_torch.serving`` as a subprocess on the card,
    over a ``save_model`` artifact of Llama-3-8B's width cut to its first
    2 layers (the float32 ``params.npz`` of 32 layers would be ~32 GB):
    readiness, buffered and streamed ``:predict``, ``:registerPrefix``,
    ``/metrics``, SIGTERM → exit 0; then the batch mode on the same
    artifact. The tokens are held against the in-process engine at the
    predictor's settings and against the plain reference."""
    import dataclasses
    import os
    import shutil
    import signal

    import numpy as np

    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = {**params, "layers": {k: v[:2]
                                    for k, v in params["layers"].items()}}
    path = BUILD_OUT / "predictor_model"
    t0 = time.perf_counter()
    io.save_model(cfg2, params2, str(path))
    size = (path / "params.npz").stat().st_size
    log(f"[pred] artifact {path.relative_to(BUILD_OUT.parent.parent)}: "
        f"{size / 1e9:.2f} GB params.npz written in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in (40, 130)]
    system = rng.integers(3, cfg.vocab_size, 128).tolist()
    hit = system + prompts[0][:5]
    reqs = [(prompts[0], 12), (prompts[1], 12), (hit, 8)]
    ref = ContinuousBatchingEngine(cfg2, params2, lanes=4,
                                   max_len=CONT_MAX_LEN, device="cuda")
    want = ref.run(reqs[:2])
    ref.register_prefix(system)
    want += ref.run(reqs[2:])
    del ref
    gc.collect()
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root),
           "KUBEDL_MODEL_PATH": str(path), "KUBEDL_MODEL_NAME": "m",
           "KUBEDL_SERVING_LANES": "4",
           "KUBEDL_SERVING_MAX_LEN": str(CONT_MAX_LEN),
           "KUBEDL_TOKENIZER": "off", "KUBEDL_SERVING_PORT": str(port)}
    env.pop("KUBEDL_KV_MODE", None)
    log_path = BUILD_OUT / "predictor.log"
    cmd = [sys.executable, "-m", "kubedl_tpu_torch.serving"]
    out = {}
    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, cwd=root, stdout=logf,
                                stderr=subprocess.STDOUT)
        try:
            _wait_ready(url, proc, log_path, timeout=600)
            out["ready_s"] = time.perf_counter() - t0
            got = json.loads(_post(url, "/v1/models/m:predict", {
                "instances": [{"prompt_tokens": p, "max_tokens": n}
                              for p, n in reqs[:2]]}))
            served = [p["tokens"] for p in got["predictions"]]
            raw = _post(url, "/v1/models/m:predict", {
                "stream": True, "instances": [{"prompt_tokens": prompts[0],
                                               "max_tokens": 12}]})
            events = [json.loads(ln[6:]) for ln in raw.splitlines()
                      if ln.startswith("data: ")]
            streamed = [e["token"] for e in events if "token" in e]
            if not (events[-1].get("done")
                    and events[-1]["tokens"] == streamed == served[0]):
                raise AssertionError(f"bad stream {events}")
            reg = json.loads(_post(url, "/v1/models/m:registerPrefix",
                                   {"prefix_tokens": system}))
            if reg != {"registered": len(system)}:
                raise AssertionError(f"bad :registerPrefix answer {reg}")
            got = json.loads(_post(url, "/v1/models/m:predict", {
                "instances": [{"prompt_tokens": hit, "max_tokens": 8}]}))
            served.append(got["predictions"][0]["tokens"])
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                page = r.read().decode()
            gauges = {ln.split()[0]: ln.split()[1] for ln in page.splitlines()
                      if ln.startswith("kubedl_serving_kv_")}
            if gauges.get("kubedl_serving_kv_blocks_pinned") != "2.0":
                raise AssertionError(f"bad /metrics KV gauges {gauges}")
            log(f"[pred] ready in {out['ready_s']:.1f} s (load, graph "
                f"capture, bind); buffered + streamed :predict, "
                f":registerPrefix, /metrics KV gauges {gauges}")
            proc.send_signal(signal.SIGTERM)
            out["sigterm_rc"] = proc.wait(timeout=120)
            if out["sigterm_rc"] != 0:
                raise AssertionError(f"the predictor exited "
                                     f"{out['sigterm_rc']} on SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        _hold(torch, cfg2, params2, reqs, served, "(f) predictor subprocess",
              want=want, want_label="the in-process engine")
        inp, res = BUILD_OUT / "batch_in.jsonl", BUILD_OUT / "batch_out.jsonl"
        inp.write_text("\n".join(json.dumps({"prompt": p, "max_tokens": n})
                                 for p, n in reqs[:2]))
        t0 = time.perf_counter()
        rc = subprocess.run(cmd + ["--batch-input", str(inp),
                                   "--batch-output", str(res)],
                            env=env, cwd=root, stdout=logf,
                            stderr=subprocess.STDOUT, timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"batch mode exited {rc}: "
                             f"{log_path.read_text()[-3000:]}")
    rows = [json.loads(ln) for ln in res.read_text().splitlines()]
    log(f"[pred] batch mode: {len(rows)} rows in "
        f"{time.perf_counter() - t0:.1f} s, exit 0")
    _hold(torch, cfg2, params2, reqs[:2], [r["tokens"] for r in rows],
          "(f) batch mode", want=want[:2],
          want_label="the in-process engine")
    t0 = time.perf_counter()
    try:
        out["op"] = phase_op(torch, cfg2, params2, path, reqs[:2],
                             want[:2], served[:2])
    finally:
        shutil.rmtree(path)              # ~6 GB of float32 weights
    log(f"[phase] op {time.perf_counter() - t0:.1f} s")
    return out


#: ``[op]``'s Inference: its name, its predictor's and the text the
#: console's playground sends (the byte tokenizer's ids all lie in the
#: vocabulary; the random model's answer decodes to whatever bytes its
#: ids below 259 give)
OP_NAME, OP_PREDICTOR = "op-llama", "main"
OP_PROMPT = "The operator brings up the predictor of a port to Hopper:"
#: proxied and direct calls timed for ``[op]``'s medians
OP_REPS = 5


def _op_command(cmd: list) -> list:
    """The rendered container's command as kubelet would exec it on this
    machine: its ``python`` is this interpreter."""
    return [sys.executable if cmd[0] == "python" else cmd[0], *cmd[1:]]


def _op_wait(fn, what: str, timeout: float = 120.0, proc=None,
             log_path=None):
    """``fn()``'s first truthy value, polled; a dead predictor or the
    timeout fails."""
    deadline = time.time() + timeout
    while True:
        got = fn()
        if got:
            return got
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"[op] the predictor exited "
                                 f"{proc.returncode} waiting for {what}: "
                                 f"{log_path.read_text()[-3000:]}")
        if time.time() > deadline:
            raise AssertionError(f"[op] {what} never happened")
        time.sleep(0.05)


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _op_seconds(fn, reps: int = OP_REPS) -> list:
    """The host seconds of ``reps`` calls of ``fn``."""
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        seconds.append(time.perf_counter() - t0)
    return seconds


def phase_op(torch, cfg2, params2, path, reqs, want, served) -> dict:
    """The port's operator bringing up the port's predictor on the card,
    with the console and the clients in front of it (the checks are in
    the module's docstring). ``path`` is ``[pred]``'s artifact; ``reqs``,
    ``want`` and ``served`` are its first two requests, the in-process
    engine's tokens for them and what its predictor served."""
    import os
    import signal
    import sqlite3

    from kubedl_tpu_torch import __main__ as op_main
    from kubedl_tpu_torch.client import Clientset
    from kubedl_tpu_torch.client.inference import InferenceClient
    from kubedl_tpu_torch.console import (ConsoleConfig, ConsoleServer,
                                          DataProxy)
    from kubedl_tpu_torch.controllers.registry import build_operator
    from kubedl_tpu_torch.controllers.testing import set_pod_phase

    card = _card()
    db = BUILD_OUT / "op.db"
    db.unlink(missing_ok=True)
    args = op_main.parse_args([
        "--workloads", "PyTorchJob", "--enable-tracing",
        "--metrics-port", "0", "--object-storage", f"sqlite://{db}",
        "--event-storage", f"sqlite://{db}"])
    template_env = {"KUBEDL_SERVING_LANES": "4",
                    "KUBEDL_SERVING_MAX_LEN": str(CONT_MAX_LEN),
                    "KUBEDL_MODEL_NAME": "m", "KUBEDL_TOKENIZER": "byte"}
    inf = {"apiVersion": "serving.kubedl.io/v1alpha1", "kind": "Inference",
           "metadata": {"name": OP_NAME, "namespace": "default"},
           "spec": {"framework": "JAXServing", "predictors": [{
               "name": OP_PREDICTOR, "replicas": 1,
               "modelPath": "/models/m",
               "template": {"spec": {"containers": [{
                   "name": "predictor", "image": "kubedl-tpu-torch",
                   "env": [{"name": k, "value": v}
                           for k, v in template_env.items()]}]}}}]}}
    deploy_name = f"{OP_NAME}-{OP_PREDICTOR}"
    pod_name = f"{deploy_name}-0"
    root = Path(__file__).resolve().parent
    log_path = BUILD_OUT / "op_predictor.log"
    proc = console = operator = None
    out = {"card": card}
    try:
        operator = build_operator(config=op_main.config_from_args(args))
        operator.run()
        api, cs = operator.api, Clientset(operator.api)
        t_submit = time.perf_counter()
        cs.kind("Inference").create(inf)
        pod = _op_wait(lambda: api.try_get("Pod", "default", pod_name),
                       "the predictor's pod")
        ct = pod["spec"]["containers"][0]
        env = {e["name"]: e["value"] for e in ct.get("env", [])
               if "value" in e}
        checks = {
            "command": ct.get("command") == [
                "python", "-m", "kubedl_tpu_torch.serving"],
            "port 8000": env.get("KUBEDL_SERVING_PORT") == "8000",
            "model path": env.get("KUBEDL_MODEL_PATH") == "/models/m",
            "template env": all(env.get(k) == v
                                for k, v in template_env.items())}
        log(f"[op] rendered pod {pod_name}: command {ct.get('command')}, "
            f"env {env}")
        if not all(checks.values()):
            raise AssertionError(f"[op] bad rendered pod: {checks}")
        out["rendered_env"] = env
        # kubelet: the rendered command and env, with the model path, the
        # port and PYTHONPATH rewritten for this machine
        port = _free_port()
        url = f"http://127.0.0.1:{port}"
        run_env = {**os.environ, **env, "KUBEDL_MODEL_PATH": str(path),
                   "KUBEDL_SERVING_PORT": str(port),
                   "PYTHONPATH": str(root)}
        run_env.pop("KUBEDL_KV_MODE", None)
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                _op_command(ct["command"]) + list(ct.get("args") or []),
                env=run_env, cwd=root, stdout=logf,
                stderr=subprocess.STDOUT)
        _wait_ready(url, proc, log_path, timeout=600)
        set_pod_phase(api, pod, "Running")
        pod = api.get("Pod", "default", pod_name)
        pod["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
        api.update_status(pod)

        def ready():
            st = api.get("Inference", "default", OP_NAME).get("status", {})
            ps = st.get("predictorStatuses") or [{}]
            return st if ps[0].get("readyReplicas") == 1 else None
        status = _op_wait(ready, "a ready predictor", proc=proc,
                          log_path=log_path)
        out["submit_to_ready_s"] = time.perf_counter() - t_submit
        log(f"[op] submit -> predictor ready in "
            f"{out['submit_to_ready_s']:.2f} s (the predictor's start "
            f"included) on {card}")

        proxy = DataProxy(api, operator.object_backend,
                          operator.event_backend,
                          job_kinds=tuple(operator.engines),
                          tracer=operator.tracer,
                          scheduler=operator.scheduler,
                          telemetry=operator.telemetry,
                          journal=operator.journal,
                          replication=operator.replication,
                          elastic=operator.elastic_enabled,
                          serving_fleet=operator.serving_fleet)
        console = ConsoleServer(proxy, ConsoleConfig(
            host="127.0.0.1", port=_free_port(), users={},
            predictor_resolver=lambda _inf: url))
        console.start()
        # 1. the console lists the Inference, its predictor and its status
        listed = [i for i in _get_json(
            console.url + "/api/v1/inference/list")["data"]
            if i["name"] == OP_NAME]
        if not (len(listed) == 1 and listed[0]["predictors"] == [
                {"name": OP_PREDICTOR, "replicas": 1}]
                and listed[0]["status"] == status):
            raise AssertionError(f"[op] bad /api/v1/inference/list "
                                 f"{listed}")
        # 2. the playground's text route, proxied and direct
        body = {"namespace": "default", "name": OP_NAME,
                "prompt": OP_PROMPT, "max_tokens": 12}
        direct_body = {"max_tokens": 12, "prompt": OP_PROMPT}
        proxied = json.loads(_post(console.url, "/api/v1/inference/predict",
                                   body))["data"]
        direct = json.loads(_post(url, "/v1/completions", direct_body))

        def same(a, b):
            keep = {k: v for k, v in a.items() if k not in ("id", "created")}
            return json.dumps(keep, sort_keys=True) == json.dumps(
                {k: v for k, v in b.items() if k not in ("id", "created")},
                sort_keys=True)
        n_proxied = int(proxied["id"].rsplit("-", 1)[1])
        if not (same(proxied, direct)
                and direct["id"] == f"cmpl-{n_proxied + 1}"
                and 0 < direct["usage"]["completion_tokens"] <= 12):
            raise AssertionError(f"[op] the console's answer {proxied} is "
                                 f"not the predictor's {direct}")
        out["proxy_ms"] = _median_ms(_op_seconds(lambda: _post(
            console.url, "/api/v1/inference/predict", body)))
        out["direct_ms"] = _median_ms(_op_seconds(lambda: _post(
            url, "/v1/completions", direct_body)))
        log(f"[op] /api/v1/inference/predict == /v1/completions but for "
            f"the id and time ({direct['usage']}); host ms, median of "
            f"{OP_REPS}: proxied {out['proxy_ms']:.2f}, direct "
            f"{out['direct_ms']:.2f} on {card}")
        # 3. :predict with [pred]'s requests
        got = json.loads(_post(url, "/v1/models/m:predict", {
            "instances": [{"prompt_tokens": p, "max_tokens": n}
                          for p, n in reqs]}))
        toks = [p["tokens"] for p in got["predictions"]]
        if toks != served:
            raise AssertionError(f"[op] :predict gave {toks}, [pred]'s "
                                 f"predictor {served}")
        _hold(torch, cfg2, params2, reqs, toks, "[op] operator's predictor",
              want=want, want_label="the in-process engine")
        # 4. the client's embeddings, bit for bit the raw route's
        vecs = InferenceClient(url).embed(list(EMBED_TEXTS))
        raw = json.loads(_post(url, "/v1/embeddings",
                               {"input": list(EMBED_TEXTS)}))
        raw_vecs = [d["embedding"] for d in sorted(
            raw["data"], key=lambda d: d["index"])]
        if not (vecs == raw_vecs and len(vecs) == 2
                and len(vecs[0]) == cfg2.d_model):
            raise AssertionError("[op] InferenceClient.embed differs from "
                                 "the raw /v1/embeddings")
        log(f"[op] :predict == [pred]'s tokens; InferenceClient.embed == "
            f"/v1/embeddings bit for bit ({len(vecs)} x {len(vecs[0])})")
        # 5. teardown: the Inference goes, the operator takes the
        # Deployment and the pod with it, kubelet stops the container
        cs.kind("Inference").delete(OP_NAME)
        _op_wait(lambda: api.try_get("Deployment", "default", deploy_name)
                 is None and api.try_get("Pod", "default", pod_name) is None,
                 "the Deployment's and the pod's removal")
        proc.send_signal(signal.SIGTERM)
        out["sigterm_rc"] = proc.wait(timeout=120)
        if out["sigterm_rc"] != 0:
            raise AssertionError(f"[op] the predictor exited "
                                 f"{out['sigterm_rc']} on SIGTERM")
        # 6. storage: the pod's record and the operator's events outlive
        # them in SQLite, and the console serves the events from there
        def stored():
            with sqlite3.connect(db) as conn:
                pods = conn.execute(
                    "SELECT name, is_in_etcd FROM pods").fetchall()
                events = conn.execute(
                    "SELECT obj_name, reason FROM events").fetchall()
            return (pods, events) if (pod_name, 0) in pods and events \
                else None
        pods, events = _op_wait(stored, "the stored records")
        served_events = _get_json(
            console.url + f"/api/v1/event/events/default/{OP_NAME}")["data"]
        if not (served_events and sorted(
                (e["obj_name"], e["reason"]) for e in served_events)
                == sorted(e for e in events if e[0] == OP_NAME)):
            raise AssertionError(f"[op] the console's events "
                                 f"{served_events}, the store's {events}")
        out["stored"] = {"pods": pods, "events": events}
        log(f"[op] teardown: the pod and the Deployment removed, SIGTERM "
            f"-> 0; stored pods {pods}, events {events}, served back by "
            f"the console")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if console is not None:
            console.stop()
        if operator is not None:
            operator.manager.stop()
        db.unlink(missing_ok=True)
    return out


def _bwd_err(torch, got, want, dtype, tol=None, rel_tol=None) -> dict:
    """The max abs error beside its tolerance at the largest value's
    scale (``tol``, absolute, where given), the norm-wise relative error
    beside its bound (``BWD_NORM_TOL`` unless ``rel_tol``), and the
    median |want| (the bulk's scale)."""
    got, want = got.float(), want.float()
    mag = want.abs()
    diff = got - want
    err = dict(max=float(diff.abs().max()),
               tol=(BWD_TOL[dtype] * max(float(mag.max()), 1.0)
                    if tol is None else tol),
               rel=float(diff.norm() / want.norm().clamp_min(1e-30)),
               rel_tol=BWD_NORM_TOL[dtype] if rel_tol is None else rel_tol,
               median=float(mag.median()))
    err["ok"] = (math.isfinite(err["max"]) and err["max"] <= err["tol"]
                 and err["rel"] <= err["rel_tol"]
                 and bool(torch.isfinite(got).all()))
    return err


def _want_dkv_splits(case, sms: int) -> int:
    """The split count K3 must take at head dim 256, stated apart from the
    wrapper's rule: the fewest of 1, 2, 4, ... dividing the GQA group that
    give each of the ``sms`` SMs a block of 64 k rows."""
    reps = case["nh"] // case["nkv"]
    blocks = case["b"] * case["nkv"] * -(-case["sk"] // 64)
    n = 1
    while n < reps and blocks * n < sms:
        n *= 2
    return n


def phase_bwd_check(torch):
    """K2 and K3 against their plain versions on the forward's cases, the
    training shape at b=1, Gemma-2B's shapes (its training shape at b=2
    as the training runs it) and Mixtral's training shape as its step
    runs it (b=2), each on its own route (on ``sm90`` at head dim 256 in
    half precision and in ``SM90_CASES``; K3 must take the split count
    :func:`_want_dkv_splits` gives at head dim 256). Returns {kernel: max
    abs error} at the training shapes, and the split count at
    Gemma-2B's."""
    from kubedl_tpu_torch.ops import attention as attn

    cases = {**CASES, "train_b1": TRAIN_B1, **GEMMA_CASES, **HD256_CASES,
             **MOE_CASES}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    picked = []

    def spy(*a):
        picked.append(real_splits(*a))
        return picked[-1]
    real_splits = attn.dkv_splits
    errs, splits = {}, {}
    for i, (name, case) in enumerate(cases.items()):
        q, k, v, seg = _inputs(torch, case, seed=200 + i)
        do = torch.randn(q.shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(300 + i)).to(q.dtype)
        causal, kw = case["causal"], _kw(case, seg)
        routes = {"dq": attn.flash_dq_route(q.dtype, case["hd"]),
                  "dkv": attn.flash_dkv_route(q.dtype, case["hd"])}
        if (name in SM90_CASES or case["hd"] == 256
                and case["dtype"] != "float32") \
                and routes != {"dq": "sm90", "dkv": "sm90"}:
            raise AssertionError(f"backward case {name}: routes {routes}, "
                                 f"want dq and dkv on sm90")
        o, lse = attn.flash_forward(q, k, v, causal, **kw)
        delta = attn.flash_delta(o, do)
        before = {fn: dict(getattr(attn, f"flash_{fn}").launches_by_route)
                  for fn in routes}
        dq = attn.flash_dq(q, k, v, do, lse, delta, causal, **kw)
        picked.clear()
        with unittest.mock.patch.object(attn, "dkv_splits", spy):
            dk, dv = attn.flash_dkv(q, k, v, do, lse, delta, causal, **kw)
        if routes["dkv"] == "sm90" and case["hd"] == 256:
            splits[name] = picked[0] if picked else None
            if splits[name] != _want_dkv_splits(case, sms):
                raise AssertionError(
                    f"flash_dkv case {name}: {splits[name]} splits of the "
                    f"GQA group, want {_want_dkv_splits(case, sms)} on "
                    f"{sms} SMs")
        for fn, route in routes.items():
            if getattr(attn, f"flash_{fn}").launches_by_route[route] \
                    != before[fn][route] + 1:
                raise AssertionError(f"flash_{fn} did not launch on route "
                                     f"{route} for case {name}")
        ref_dq = attn.flash_dq_plain(q, k, v, do, lse, delta, causal, **kw)
        ref_dk, ref_dv = attn.flash_dkv_plain(q, k, v, do, lse, delta,
                                              causal, **kw)
        torch.cuda.synchronize()
        parts = []
        for label, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                                 ("dv", dv, ref_dv)):
            e = _bwd_err(torch, got, want, case["dtype"])
            parts.append(f"{label} {e['max']:.3e} (tol {e['tol']:.3g}, "
                         f"median |want| {e['median']:.3g}) rel "
                         f"{e['rel']:.3e} (bound {e['rel_tol']:.3g})")
            if not e["ok"]:
                raise AssertionError(f"backward kernel disagrees with its "
                                     f"plain version on case {name}: "
                                     f"{label} {e}")
            errs[(name, label)] = e["max"]
        log(f"[bwd] {name} (dq {routes['dq']}, dkv {routes['dkv']}"
            + (f", {splits[name]} splits" if name in splits else "") + "): "
            + ", ".join(parts) + " ok")
    return {"flash_dq": errs[("train_b1", "dq")],
            "flash_dkv": max(errs[("train_b1", "dk")],
                             errs[("train_b1", "dv")]),
            "gemma": {"flash_dq": errs[("gemma_train", "dq")],
                      "flash_dkv": max(errs[("gemma_train", "dk")],
                                       errs[("gemma_train", "dv")]),
                      "dkv_splits": splits["gemma_train"]},
            "moe": {"flash_dq": errs[("moe_train", "dq")],
                    "flash_dkv": max(errs[("moe_train", "dk")],
                                     errs[("moe_train", "dv")])}}


def _shape(case) -> str:
    dt = {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}
    return (f"b={case['b']} s={case['sq']} nh={case['nh']} nkv="
            f"{case['nkv']} hd={case['hd']} {dt[case['dtype']]}"
            f"{' causal' if case['causal'] else ''}")


def _fwd_timing(torch, case, seed) -> dict:
    """K1 at ``case`` on its route, beside its plain version, SDPA (a
    yardstick only: the port never calls it), its bound and, on the
    ``sm90`` route, its earlier design on the same inputs."""
    from kubedl_tpu_torch.ops import attention as attn

    q, k, v, seg = _inputs(torch, case, seed=seed)
    causal = case["causal"]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        return attn.flash_forward(q, k, v, causal)

    row = {"kernel_route": attn.flash_fwd_route(q.dtype, case["hd"]),
           "ms": _time_ms(torch, kernel),
           "plain_ms": _time_ms(torch, lambda: attn.flash_forward_plain(
               q, k, v, causal), reps=20),
           "library_ms": _time_ms(torch, lambda: sdpa(
               qt, kt, vt, is_causal=causal, enable_gqa=True))}
    if row["kernel_route"] == "sm90":
        row["earlier_design_ms"] = _earlier_ms(torch, attn, "flash_forward",
                                               kernel)
    row["bound_ms"], row["bound_by"] = _flash_bound(torch, case, seg)
    return row


def phase_gemma_embed_timing(torch) -> dict:
    """K1 at Gemma-2B's embeddings shape (``sm90`` route), beside its
    earlier design."""
    row = _fwd_timing(torch, GEMMA_EMBED, seed=450)
    log(f"[time] flash_forward at {_shape(GEMMA_EMBED)} "
        f"({row['kernel_route']}): kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), earlier design "
        f"(flash_fwd.cu) {row['earlier_design_ms']:.4f} ms")
    return row


def phase_timing(torch, case=TRAIN, seed=400):
    """K1, K2 and K3 at a training shape, each on its own route beside its
    plain version, SDPA (forward for K1, backward for K2 and K3 together:
    the one library call that computes dq/dk/dv) and its bound (each on
    the ``sm90`` route also beside its earlier design); and Δ, the
    PyTorch op the backward runs before K2 and K3. At head dim 256 K3 is
    also timed at 1, 2, 4 and 8 splits of the GQA group, and two calls of
    K2 and of K3 must give the same bits."""
    from kubedl_tpu_torch.ops import attention as attn

    q, k, v, _ = _inputs(torch, case, seed=seed)
    do = torch.randn(q.shape, device="cuda",
                     generator=torch.Generator(device="cuda")
                     .manual_seed(seed + 1)).to(q.dtype)
    causal, hd = case["causal"], case["hd"]
    routes = {"flash_forward": attn.flash_fwd_route(q.dtype, hd),
              "flash_dq": attn.flash_dq_route(q.dtype, hd),
              "flash_dkv": attn.flash_dkv_route(q.dtype, hd)}
    o, lse = attn.flash_forward(q, k, v, causal)
    delta = attn.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # yardsticks only (the port never calls SDPA): the forward with GQA,
    # the backward on k/v repeated to the q heads
    reps = case["nh"] // case["nkv"]
    leaves = [t.detach().clone().requires_grad_() for t in
              (qt, kt.repeat_interleave(reps, 1), vt.repeat_interleave(reps,
                                                                      1))]
    out = sdpa(*leaves, is_causal=causal)
    gt = do.transpose(1, 2)
    sdpa_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, gt, retain_graph=True))
    timed = {
        "flash_forward": (lambda: attn.flash_forward(q, k, v, causal),
                          lambda: attn.flash_forward_plain(q, k, v, causal),
                          _time_ms(torch, lambda: sdpa(
                              qt, kt, vt, is_causal=causal,
                              enable_gqa=True))),
        "flash_dq": (lambda: attn.flash_dq(*args),
                     lambda: attn.flash_dq_plain(*args), sdpa_bwd_ms),
        "flash_dkv": (lambda: attn.flash_dkv(*args),
                      lambda: attn.flash_dkv_plain(*args), sdpa_bwd_ms),
    }
    rows = {}
    for name, (kernel, plain, library_ms) in timed.items():
        route = routes[name]
        ms = _time_ms(torch, kernel, reps=20, warmup=2)
        plain_ms = _time_ms(torch, plain, reps=5, warmup=1)
        bound_ms, bound_by = _flash_bound(torch, case, None, name)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          kernel_route=route)
        earlier = name in EARLIER_ROUTE and route == "sm90"
        if earlier:
            rows[name]["earlier_design_ms"] = _earlier_ms(
                torch, attn, name, kernel, reps=20, warmup=2)
        log(f"[time] {name} at {_shape(case)} ({route}): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{'backward ' if name != 'flash_forward' else ''}"
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
            + (f", earlier design (simt) "
               f"{rows[name]['earlier_design_ms']:.4f} ms"
               if earlier else ""))
    if hd == 256 and routes["flash_dkv"] == "sm90":
        rows["flash_dkv"].update(_dkv_splits_readings(torch, attn, case,
                                                      timed["flash_dkv"][0]))
    if hd == 256 and routes["flash_dq"] == "sm90":
        first, second = timed["flash_dq"][0](), timed["flash_dq"][0]()
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        log(f"[time] flash_dq at {_shape(case)}: two calls bit for bit: "
            f"{same}")
        if not same:
            raise AssertionError("flash_dq gave other bits on a second call")
        rows["flash_dq"]["repeats_bit_for_bit"] = same
    if hd == 128:
        log("[time] hd-128 kernels against their earlier readings in "
            "PERF.md (H100 80GB HBM3, 700 W): " + ", ".join(
                f"{n} {rows[n]['ms']:.4f} ms (earlier {ms:.4f} ms, "
                f"{rows[n]['ms'] / ms - 1:+.1%})"
                for n, ms in HD128_EARLIER_MS.items()))
    rows["flash_dq"]["delta_ms"] = _time_ms(
        torch, lambda: attn.flash_delta(o, do), reps=20, warmup=2)
    log(f"[time] flash_delta (PyTorch) at the same shape: "
        f"{rows['flash_dq']['delta_ms']:.4f} ms")
    return rows


def _dkv_splits_readings(torch, attn, case, kernel) -> dict:
    """K3 at ``case`` (head dim 256): the split count the wrapper picks,
    the time at 1, 2, 4 and 8 splits of the GQA group (those dividing
    it), and two calls at the picked count compared bit for bit."""
    reps = case["nh"] // case["nkv"]
    splits = attn.dkv_splits(case["b"], case["nkv"], case["sk"], reps,
                             case["hd"], torch.cuda.get_device_properties(
                                 0).multi_processor_count)
    by_splits = {}
    for n in (1, 2, 4, 8):
        if reps % n:
            continue
        with unittest.mock.patch.object(attn, "dkv_splits",
                                        lambda *a, n=n: n):
            by_splits[n] = _time_ms(torch, kernel, reps=20, warmup=2)
    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[time] flash_dkv at {_shape(case)}: {splits} splits of the "
        f"{reps}-head group picked; by splits "
        f"{ {n: round(ms, 4) for n, ms in by_splits.items()} } ms; two "
        f"calls bit for bit: {same}")
    if not same:
        raise AssertionError("flash_dkv gave other bits on a second call")
    return {"splits": splits, "ms_by_splits": by_splits,
            "repeats_bit_for_bit": same}


def _train_config(name="train", model="llama.llama3_8b", vocab=128256,
                  overrides=None, batch=4, steps=TRAIN_STEPS, seq=2048,
                  **extra) -> tuple:
    """(config path, token path, config dict) of a training run on one
    batch of ``batch`` x (``seq`` + 1) tokens from seed 0, written as a
    token file so every step sees the same rows. The defaults are the
    slice's Llama-3-8B run, 8 layers deep."""
    import numpy as np

    BUILD_OUT.mkdir(parents=True, exist_ok=True)
    tokens = BUILD_OUT / f"{name}_tokens.bin"
    np.random.default_rng(0).integers(0, vocab, batch * (seq + 1),
                                      dtype=np.int32).tofile(tokens)
    cfg = {"model": model,
           "model_overrides": ({"n_layers": 8} if overrides is None
                               else overrides),
           "mode": "pretrain", "data": {"kind": "tokens",
                                        "path": str(tokens)},
           "batch": batch, "seq": seq, "steps": steps, "seed": 0,
           "optimizer": {"warmup_steps": 1}, "log_every": 1, **extra}
    path = BUILD_OUT / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path), str(tokens), cfg


def model_flops_per_token(cfg, seq: int) -> float:
    """Fwd+bwd FLOPs per trained token (``bench.py``'s formula): 6*N
    params term + causal-attention term 12*L*d_head*n_heads*(seq/2). N is
    the params a token touches: all of them for a dense model, the
    ``active_params`` (top-k of the experts) for an MoE one."""
    n = getattr(cfg, "active_params", cfg.num_params)
    return (6.0 * n
            + 12.0 * cfg.n_layers * cfg.hd * cfg.n_heads * (seq / 2))


#: every kernel on the tensor cores (Llama at hd 128, Gemma at hd 256)
ALL_SM90 = {"flash_forward": "sm90", "flash_dq": "sm90", "flash_dkv": "sm90"}


def _train_run(torch, tag, cfg_path, cfg, routes, mfu=True,
               falling=True) -> dict:
    """``python -m kubedl_tpu_torch.train``'s main, in-process, on the
    config at ``cfg_path``: the loss finite and, with ``falling``, falling
    over the repeated batch, and every launch of each of K1-K3 on its route in ``routes``
    (K1 2*L per step with remat, K2/K3 L). The kernels' counts go to 0
    just before the run and are read just after. Returns the readings."""
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.train import __main__ as train_main

    config, _ = train_main.resolve_model(cfg, device="cuda")
    n_layers, steps = config.n_layers, cfg["steps"]
    marks = []
    torch.cuda.reset_peak_memory_stats()
    log(f"[{tag}] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"before training; {cfg['model']}: {config.num_params / 1e9:.3f} B "
        f"params, {n_layers} layers, d_model {config.d_model}, heads "
        f"{config.n_heads}/{config.n_kv_heads} of width {config.hd}, d_ff "
        f"{config.d_ff}, vocab {config.vocab_size}, remat {config.remat}, "
        f"loss_chunk {config.loss_chunk}; batch {cfg['batch']} x "
        f"{cfg['seq']}, {steps} steps"
        + (f", lora {cfg['lora']}" if cfg.get("lora") else ""))
    kernels = (attn.flash_forward, attn.flash_dq, attn.flash_dkv)
    for fn in kernels:
        fn.launches = 0
        fn.launches_by_route = {"sm90": 0, "simt": 0}
    t0 = time.perf_counter()
    rc = train_main.main(["--config", cfg_path],
                         on_step=lambda step, loss: marks.append(
                             (time.perf_counter(), step, loss)))
    launches = {fn.__name__: fn.launches for fn in kernels}
    by_route = {fn.__name__: dict(fn.launches_by_route) for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    losses = [m[2] for m in marks]
    if rc != 0 or len(marks) != steps:
        raise AssertionError(f"{tag}: training returned {rc} after "
                             f"{len(marks)} steps")
    if not all(math.isfinite(x) for x in losses) or (
            falling and losses[-1] >= losses[0]):
        raise AssertionError(f"{tag}: training loss not finite and falling: "
                             f"{losses}")
    want = {"flash_forward": 2 * n_layers * steps,
            "flash_dq": n_layers * steps, "flash_dkv": n_layers * steps}
    if launches != want:
        raise AssertionError(f"{tag}: training launched {launches}, want "
                             f"{want} (K1 2*L per step with remat, K2/K3 L)")
    for name, got in by_route.items():
        route = routes[name]
        other = "simt" if route == "sm90" else "sm90"
        if got != {route: want[name], other: 0}:
            raise AssertionError(f"{tag}: training launched {name} on "
                                 f"routes {got}: every launch should "
                                 f"take {route}")
    steady = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    step_s = sum(steady) / len(steady)
    tok_s = cfg["batch"] * cfg["seq"] / step_s
    out = {"launches": launches, "by_route": by_route, "losses": losses,
           "step_s": step_s, "tokens_per_s": tok_s,
           "step_times": [round(x, 4) for x in steady],
           "peak_gib": peak / 2**30, "first_step_s": marks[0][0] - t0}
    line = ""
    if mfu:
        out["mfu"] = (model_flops_per_token(config, cfg["seq"]) * tok_s
                      / PEAK_FLOPS_PER_S["bfloat16"])
        line = (f", MFU {out['mfu']:.4f} against 989 TFLOP/s bf16 "
                f"({model_flops_per_token(config, cfg['seq']):.4e} "
                f"FLOP/token)")
    log(f"[{tag}] losses {[round(x, 4) for x in losses]}")
    log(f"[{tag}] first step {out['first_step_s']:.3f} s (model init, data "
        f"and first launches included); steps 2-{steps}: {step_s:.4f} s "
        f"per step, {tok_s:.1f} tokens/s{line}")
    log(f"[{tag}] per-step times {[round(x, 4) for x in steady]} s")
    log(f"[{tag}] {out['peak_gib']:.2f} GiB peak device memory; launches "
        f"{launches} over {steps} steps = "
        f"{ {k: n // steps for k, n in launches.items()} } per step; "
        f"routes {by_route}")
    return out


def phase_training(torch):
    """The slice's training run (Llama-3-8B width, 8 layers, b=4 s=2048).
    Returns (readings, config dict, token path)."""
    cfg_path, tokens, cfg = _train_config()
    return _train_run(torch, "train", cfg_path, cfg, ALL_SM90), cfg, tokens


def phase_gemma_training(torch) -> dict:
    """``python -m kubedl_tpu_torch.train`` on ``gemma.gemma_2b`` at full
    width and depth, b=2 s=2048, 3 steps: at head dim 256 every K1, K2
    and K3 launch takes the ``sm90`` route."""
    cfg_path, _, cfg = _train_config("gemma_train", model="gemma.gemma_2b",
                                     vocab=256128, overrides={}, batch=2,
                                     steps=3)
    return _train_run(torch, "gtrain", cfg_path, cfg, ALL_SM90)


#: the bf16 rule for a loss gap, in ulps at the loss's scale (the rule
#: the port's CPU tests hold bf16 runs to)
BF16_LOSS_ULPS = 4


def _contract_env(port: int) -> dict:
    """The operator's rendezvous contract for one process on this host."""
    return {"KUBEDL_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "KUBEDL_NUM_PROCESSES": "1", "KUBEDL_PROCESS_ID": "0"}


def _with_env(env: dict, fn, *args):
    """``fn(*args)`` with ``env`` set, then the variables removed, so no
    later phase sees a rendezvous contract."""
    import os
    os.environ.update(env)
    try:
        return fn(*args)
    finally:
        for key in env:
            os.environ.pop(key, None)


def phase_dist(torch, gtrain) -> dict:
    """``python -m kubedl_tpu_torch.train``'s ``main`` in-process under
    the rendezvous contract for one process: ``main`` opens a
    world-size-1 NCCL group, lays ``"mesh": {"fsdp": -1}`` over it and
    trains ``gemma.gemma_2b`` on the unsharded phase's config (full size,
    b=2 x 2048) through the sharded trainer (DTensor state, per-layer
    views, the global-norm all-reduce), one step more than that phase so
    the steady step is read over 3 steps. The losses of the steps both
    runs take must equal the unsharded run's (bit for bit is expected at
    world size 1; a gap is printed and held to ``BF16_LOSS_ULPS`` bf16
    ulps), every K1-K3 launch takes ``sm90``, and ``main`` destroys its
    group. Then a
    ``torch.distributed.checkpoint`` save and restore of a sharded
    ``llama.tiny`` state under a new NCCL group (a few MB of disk).

    What world size 1 checks: the DTensor state, its placement and DCP
    under NCCL, and the sharded step's wrapping. Every mesh axis has
    size 1, so ``loss_share`` is the local mean (no count is summed),
    ``gather`` and ``tp_sum`` return their input and the norm's
    all-reduce is skipped: no NCCL all-gather, reduce-scatter or
    all-reduce runs here, and the equal losses hold by construction.
    The collectives and the sharded losses are checked only over gloo
    on the CPU (``tests/test_torch_sharded_*.py``)."""
    import torch.distributed as dist

    cfg_path, _, cfg = _train_config(
        "gemma_dist", model="gemma.gemma_2b", vocab=256128, overrides={},
        batch=2, steps=len(gtrain["losses"]) + 1, mesh={"fsdp": -1})
    out = _with_env(_contract_env(_free_port()), _train_run, torch,
                    "dist", cfg_path, cfg, ALL_SM90)
    if dist.is_initialized():
        raise AssertionError("dist: main left its process group open")
    gaps = [abs(a - b) for a, b in zip(out["losses"], gtrain["losses"])]
    shared = out["losses"][:len(gtrain["losses"])]
    top = max(abs(x) for x in gtrain["losses"])
    rule = BF16_LOSS_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    out["loss_gap"] = max(gaps)
    if out["loss_gap"] > rule:
        raise AssertionError(f"dist: losses {shared} against the "
                             f"unsharded {gtrain['losses']}: gap "
                             f"{out['loss_gap']} > {rule}")
    log(f"[dist] losses {shared} against the unsharded "
        f"{gtrain['losses']}: "
        + ("bit for bit" if out["loss_gap"] == 0 else
           f"max gap {out['loss_gap']} (bf16 rule {rule})"))
    log(f"[dist] step {out['step_s']:.4f} s ({out['tokens_per_s']:.1f} "
        f"tokens/s, MFU {out['mfu']:.4f}) and {out['peak_gib']:.2f} GiB "
        f"peak, against the unsharded {gtrain['step_s']:.4f} s "
        f"({gtrain['tokens_per_s']:.1f} tokens/s) and "
        f"{gtrain['peak_gib']:.2f} GiB: the sharded path's overhead at "
        f"world size 1 is {out['step_s'] / gtrain['step_s'] - 1:+.2%} "
        f"of the step (per step {out['step_times']} against "
        f"{gtrain['step_times']} s)")
    out["checkpoint"] = _with_env(_contract_env(_free_port()),
                                  _dist_checkpoint, torch)
    return out


def _dist_checkpoint(torch) -> dict:
    """A sharded ``llama.tiny`` state (bf16, on the card) trained 2 steps
    under a world-size-1 NCCL group, saved asynchronously and restored
    into a state from other weights: every leaf equal bit for bit, then
    one more step with a finite loss. The group is destroyed after."""
    import shutil

    import torch.distributed as dist
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.parallel.sharding import full_tensor
    from kubedl_tpu_torch.runtime import bootstrap
    from kubedl_tpu_torch.train import checkpoint as ck
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train import trainer as ttrainer

    directory = BUILD_OUT / "dist_checkpoint"
    shutil.rmtree(directory, ignore_errors=True)
    bootstrap.initialize_distributed()
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"dist: backend {dist.get_backend()}")
        mesh = tmesh.build_mesh(tmesh.MeshConfig(fsdp=-1))
        cfg = llama.tiny(vocab=512, seq=256)
        trainer = ttrainer.Trainer(
            lambda p, b: llama.loss_fn(cfg, p, b["tokens"], b["targets"],
                                       mesh=mesh),
            ttrainer.TrainConfig(warmup_steps=1),
            param_specs=llama.param_specs(cfg), mesh=mesh)

        def fresh(seed):
            return trainer.init_state(llama.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(seed),
                device="cuda"))
        batches = tdata.prefetch_to_device(
            tdata.synthetic_lm_batches(4, 256, cfg.vocab_size, seed=0),
            mesh=mesh)
        state = fresh(0)
        for _ in range(2):
            state, _ = trainer.step(state, next(batches))
        mgr = ck.CheckpointManager(ck.CheckpointConfig(str(directory)))
        t0 = time.perf_counter()
        mgr.save(state, force=True, data_state={"consumed_batches": 2})
        mgr.wait_until_finished()
        save_s = time.perf_counter() - t0
        restored = mgr.restore(fresh(1))

        def leaves(st):
            out = dict(ttrainer.tree_leaves(st.params))
            out.update({f"mu/{k}": v for k, v in st.opt_state.mu.items()})
            out.update({f"nu/{k}": v for k, v in st.opt_state.nu.items()})
            return out
        want, got = leaves(state), leaves(restored)
        same = [k for k in want
                if torch.equal(full_tensor(want[k]), full_tensor(got[k]))]
        if len(same) != len(want) or restored.step != 2 \
                or restored.opt_state.count != 2:
            raise AssertionError(
                f"dist: restored {len(same)} of {len(want)} leaves bit "
                f"for bit, step {restored.step}")
        _, loss = trainer.step(restored, next(batches))
        if not math.isfinite(float(loss)):
            raise AssertionError(f"dist: loss {loss} after the restore")
        nbytes = mgr.last_save["bytes"]
        log(f"[dist] checkpoint under NCCL: {len(want)} DTensor leaves, "
            f"{nbytes / 2**20:.1f} MiB, saved in {save_s:.3f} s and "
            f"restored bit for bit in {mgr.last_restore['seconds']:.3f} s; "
            f"next loss {float(loss):.4f}")
        return {"leaves": len(want), "bytes": nbytes, "save_s": save_s,
                "restore_s": mgr.last_restore["seconds"]}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(directory, ignore_errors=True)


LORA_RANK = 16


def phase_lora_training(torch) -> dict:
    """The slice's training configuration with ``"lora"`` (rank 16, the
    attention projections), 4 steps at learning rate 1e-3: the loss falls,
    the base weights stay bit for bit the seeded ones, and the optimizer's
    moments are each the adapters' size. The base and the trainer state
    are read by wrapping ``merge_params`` and ``Trainer.init_state``."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import lora, quant
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train import trainer

    cfg_path, _, cfg = _train_config(
        "lora_train", steps=4, lora={"rank": LORA_RANK},
        optimizer={"warmup_steps": 1, "learning_rate": 1e-3})
    seen = {}
    merge, init_state = lora.merge_params, trainer.Trainer.init_state

    def record_merge(base, adapters, alpha=16.0):
        seen.setdefault("base", base)
        return merge(base, adapters, alpha=alpha)

    def record_state(self, params):
        seen["state"] = init_state(self, params)
        return seen["state"]

    with unittest.mock.patch.object(lora, "merge_params", record_merge), \
            unittest.mock.patch.object(trainer.Trainer, "init_state",
                                       record_state):
        out = _train_run(torch, "lora", cfg_path, cfg, ALL_SM90, mfu=False)
    state, base = seen.pop("state"), seen.pop("base")
    adapter_bytes = quant.tree_nbytes(state.params)
    mu, nu = (quant.tree_nbytes(state.opt_state.mu),
              quant.tree_nbytes(state.opt_state.nu))
    config, _ = train_main.resolve_model(cfg, device="cuda")
    seeded = llama.init_params(
        config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    from kubedl_tpu_torch.train.trainer import tree_leaves
    moved = [k for (k, a), (_, b) in zip(tree_leaves(base),
                                         tree_leaves(seeded))
             if not torch.equal(a, b)]
    out.update(adapter_bytes=adapter_bytes, mu_bytes=mu, nu_bytes=nu,
               base_bytes=quant.tree_nbytes(base), base_moved=moved)
    log(f"[lora] adapters {adapter_bytes / 1e6:.2f} MB "
        f"({adapter_bytes // 4 / 1e6:.2f} M float32 params) against the "
        f"base's {out['base_bytes'] / 1e9:.3f} GB; optimizer moments mu "
        f"{mu / 1e6:.2f} MB, nu {nu / 1e6:.2f} MB; base leaves that moved: "
        f"{moved or 'none'}; peak {out['peak_gib']:.2f} GiB against the full "
        f"run's")
    if mu != adapter_bytes or nu != adapter_bytes:
        raise AssertionError("the optimizer state is not adapter-sized")
    if moved:
        raise AssertionError(f"LoRA training changed base leaves {moved}")
    return out


def phase_grad_check(torch, cfg, tokens, routes=ALL_SM90, tag="grad"):
    """One step's gradient of every parameter leaf at b=1, through the
    kernels (each launch on its route in ``routes``) and through the
    chunked attention path, on the same weights and tokens, with the
    config's family (``llama`` or ``moe``)."""
    from unittest import mock

    import numpy as np

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.models.io import family_of
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train.trainer import tree_leaves

    config, _ = train_main.resolve_model(cfg, device="cuda")
    family = family_of(config)
    row = np.fromfile(tokens, dtype=np.int32)[:cfg["seq"] + 1]
    toks = torch.as_tensor(row[None].astype(np.int64), device="cuda")
    params = family.init_params(
        config, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    leaves = tree_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)

    # an MoE model's expert choices are discrete: where the router's top-k
    # margin is within rounding, the two attention paths pick different
    # experts and the gradients part for reasons other than the kernels.
    # Every run records its selections with the router probabilities; the
    # chunked run routing on its own may differ from the kernel run only
    # at router near-ties (``_flips``), and the chunked run whose
    # gradients are compared replays the kernel run's selections (the
    # gates stay differentiable functions of its own router)
    from kubedl_tpu_torch.models import moe
    picks, replay = [], []
    top_k = moe._top_k

    def routed(probs, k):
        if replay:
            idx = replay.pop(0)
            return probs.gather(-1, idx), idx
        vals, idx = top_k(probs, k)
        picks.append((idx, probs.detach()))
        return vals, idx

    def grads(impl, routing=()):
        patch = mock.patch.object(
            llama, "multi_head_attention",
            lambda *a, **k: attn.multi_head_attention(*a, impl=impl, **k))
        replay[:], picks[:] = list(routing), []
        with patch, mock.patch.object(moe, "_top_k", routed):
            loss = family.loss_fn(config, params, toks[:, :-1], toks[:, 1:])
            out = torch.autograd.grad(loss, [p for _, p in leaves])
        if replay:
            raise AssertionError(f"{tag}: {len(replay)} recorded routings "
                                 f"were not replayed")
        return loss.item(), out, list(picks)

    before = attn.flash_dq.launches
    kernels = {name: getattr(attn, name) for name in routes}
    by_route = {name: dict(fn.launches_by_route)
                for name, fn in kernels.items()}
    loss_k, g_k, kernel_picks = grads("kernel")
    if attn.flash_dq.launches != before + config.n_layers:
        raise AssertionError("the kernel path did not launch the dQ kernel "
                             "once per layer")
    for name, fn in kernels.items():
        moved = {r: n - by_route[name][r]
                 for r, n in fn.launches_by_route.items()}
        if moved[routes[name]] == 0 or sum(moved.values()) \
                != moved[routes[name]]:
            raise AssertionError(f"{tag}: {name} launched by route {moved}; "
                                 f"want {routes[name]} only")

    def gaps(g_c):
        return {name: float((a.float() - b.float()).norm()
                            / b.float().norm().clamp_min(1e-30))
                for (name, _), a, b in zip(leaves, g_k, g_c)}

    moe_model = family is moe
    if moe_model:
        # the chunked path routing on its own
        loss_free, g_free, free_picks = grads("chunked")
        free = gaps(g_free)
        del g_free
        worst_free = max(free, key=free.get)
        flips = _flips(torch, kernel_picks, free_picks, config)
        log(f"[{tag}] the chunked path routing on its own: loss "
            f"{loss_free:.6f}, worst gradient gap {worst_free} "
            f"{free[worst_free]:.4e} (a reading); expert choices of "
            f"{flips['tokens']} (token, layer) pairs, {flips['differ']} "
            f"differ from the kernel run's: {flips['at_tie']} at a router "
            f"near-tie (under {ROUTER_TIE_ULPS} bf16 ulps; "
            f"{flips['ties']} pairs are), after a flip in an earlier "
            f"layer {flips['after_own']} of the token's own and "
            f"{flips['after_earlier']} of an earlier token's, "
            f"{flips['unexplained']} otherwise; away from a near-tie "
            f"(layer, position, margin in ulps) {flips['away']}")
        if flips["unexplained"]:
            raise AssertionError(f"{tag}: {flips['unexplained']} expert "
                                 f"choices of the chunked path differ from "
                                 f"the kernel path's away from a router "
                                 f"near-tie")
    loss_c, g_c, _ = grads("chunked", [idx for idx, _ in kernel_picks]
                           if moe_model else ())
    rel = gaps(g_c)
    worst = max(rel, key=rel.get)
    log(f"[{tag}] {cfg['model']}, {config.n_layers} layers, b=1 "
        f"s={cfg['seq']}: loss kernel {loss_k:.6f}, chunked "
        f"{loss_c:.6f}"
        f"{' (the kernel run routing replayed)' if moe_model else ''}"
        f"; relative gradient gap per leaf "
        f"{ {k: float(f'{x:.3e}') for k, x in rel.items()} }")
    log(f"[{tag}] worst {worst} {rel[worst]:.4e} (bound {GRAD_REL_BOUND})")
    if not rel[worst] <= GRAD_REL_BOUND:
        raise AssertionError(f"gradient of {worst} through the kernels is "
                             f"{rel[worst]:.3e} from the chunked path's")


def _flips(torch, picks_a, picks_b, config) -> dict:
    """Where two runs' expert choices differ, over the forward pass's
    ``config.n_layers`` router calls (``(indices, probabilities)`` each,
    in layer order; calls past those are remat's recompute). The first
    layer's router sees the two runs' attention rounding only, so its
    choices may differ only at a router near-tie of run a
    (:func:`_margin_ulps` under ``ROUTER_TIE_ULPS``). A later layer's
    also inherit the earlier layers' flips: the token's own (its hidden
    state differs from there on) and, through causal attention, those of
    every earlier token of its row. Returns the (token, layer) pairs, the
    pairs at a near-tie in all, and of the differing pairs those at a
    near-tie, after the token's own flip, after an earlier token's flip,
    and the rest (``unexplained``), with (layer, position, margin in
    ulps) of the first few differing pairs away from a near-tie."""
    n = config.n_layers
    out = dict.fromkeys(("tokens", "ties", "differ", "at_tie", "after_own",
                         "after_earlier", "unexplained"), 0)
    out["away"] = []
    before = None
    for layer, ((ia, pa), (ib, _)) in enumerate(zip(picks_a[:n],
                                                     picks_b[:n])):
        differ = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        margin = _margin_ulps(torch, pa, config.top_k)
        tie = margin < ROUTER_TIE_ULPS
        if before is None:
            before = torch.zeros_like(differ)
        earlier = (torch.cumsum(before.int(), 1) - before.int()) > 0
        away = differ & ~tie
        for key, m in (("tokens", torch.ones_like(differ)), ("ties", tie),
                       ("differ", differ), ("at_tie", differ & tie),
                       ("after_own", away & before),
                       ("after_earlier", away & ~before & earlier),
                       ("unexplained", away & ~before & ~earlier)):
            out[key] += int(m.sum())
        for row, t in away.nonzero().tolist()[:8 - len(out["away"])]:
            out["away"].append((layer, t, round(float(margin[row, t]), 2)))
        before = before | differ
    return out


def phase_gemma_grad_check(torch):
    """``phase_grad_check`` on Gemma-2B at full width, 2 layers deep, b=1
    s=2048: K1, K2 and K3 on ``sm90``."""
    _, tokens, cfg = _train_config("gemma_grad", model="gemma.gemma_2b",
                                   vocab=256128, overrides={"n_layers": 2},
                                   batch=1, steps=1)
    phase_grad_check(torch, cfg, tokens, ALL_SM90, tag="ggrad")


#: Mixtral-8x7B's cuts in the MoE phases: the engine's model 8 layers deep
#: (11.87 B params, 23.7 GB of bf16 weights; 32 would be 93.4 GB), the
#: predictor's artifact 1 layer (~6.9 GB of float32), training and its
#: gradient check 2 layers (3.165 B params, ~32 GB of training state).
#: The int8 phase cuts to ``MOE_INT8_LAYERS`` (8; all 32 until slice 18).
MOE_LAYERS, MOE_PRED_LAYERS, MOE_TRAIN_LAYERS = 8, 1, 2


def _moe_dropless(cfg):
    """``cfg`` at capacity_factor n_experts / top_k: capacity equals the
    chunk length, so nothing drops at any chunk length, routing is
    dropless (as Mixtral's published routing is), and the one-pass
    teacher-forced reference routes every token as the engine's prefill
    buckets and one-token ticks did. At the preset's 1.25 a one-pass
    reference's capacity differs from a tick's."""
    import dataclasses
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)


def _eager(eng):
    """``eng`` with every decode tick on the eager route."""
    for tick in eng._ticks():
        tick.route = "eager"
    return eng


def phase_moe(torch) -> tuple:
    """Mixtral-8x7B at full width, cut to 8 layers (random bf16 weights
    from seed 0, dropless routing) in the predictor's engine behind
    ``InferenceServer``: the 16 greedy requests through ``:predict``,
    held to the MoE reference (``_hold``: at most ``MOE_HALF_SHARE`` of
    the tokens beyond ``NEAR_TIE``), and lost decode K/V writes planted
    in one layer must fail that check; ``/v1/embeddings`` of 2 inputs (512 and 305 tokens), whose every
    layer must launch K1 once on ``sm90``, held to the chunked attention
    path; the tick at 1, 4 and 8 lanes, graph and eager. Then the 16
    requests inline on the graph route and on the eager route must give
    the same tokens, and so must 4 of them at the preset's capacity
    factor (1.25). Returns (dropless config, params, readings)."""
    import dataclasses

    import numpy as np

    from kubedl_tpu_torch.models import llama, moe
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.serving import (ContinuousBatchingEngine,
                                          InferenceServer, ServerConfig)
    from kubedl_tpu_torch.tokenizer import ByteTokenizer, encode_prompt

    preset = dataclasses.replace(moe.mixtral_8x7b(), n_layers=MOE_LAYERS)
    cfg = _moe_dropless(preset)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = moe.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    log(f"[moe] model: Mixtral-8x7B width (d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of width {cfg.hd}, {cfg.n_experts} "
        f"experts of d_ff {cfg.d_ff}, top-{cfg.top_k}, vocab "
        f"{cfg.vocab_size}), {cfg.n_layers} of {moe.mixtral_8x7b().n_layers}"
        f" layers: {cfg.num_params / 1e9:.3f} B params "
        f"({cfg.active_params / 1e9:.3f} B active per token) "
        f"{str(cfg.dtype).removeprefix('torch.')}, random from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s; capacity factor "
        f"{cfg.capacity_factor} (dropless)")
    _, reqs = _cont_requests(cfg)
    out = {}

    def engine(lanes=CONT_LANES, config=cfg):
        return ContinuousBatchingEngine(config, params, lanes=lanes,
                                        max_len=CONT_MAX_LEN, device="cuda")

    eng = engine().start()
    srv = InferenceServer(eng, ServerConfig(
        model_name="mixtral", host="127.0.0.1", port=0, max_batch=16,
        max_new_tokens=128, tokenizer=ByteTokenizer())).start()
    texts = ["kubedl " * 73, "a TPU kernel ported by hand to Hopper " * 8]
    texts[0] = texts[0][:511]          # + BOS = 512 tokens
    try:
        t0 = time.perf_counter()
        _post(srv.url, "/v1/models/mixtral:predict", {
            "instances": [{"prompt_tokens": [1, 2, 3], "max_tokens": 2}]})
        log(f"[moe] first request (captures the decode graph) "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        got = json.loads(_post(srv.url, "/v1/models/mixtral:predict", {
            "instances": [{"prompt_tokens": p, "max_tokens": n,
                           "logprobs": True} for p, n in reqs]}))
        wall = time.perf_counter() - t0
        served = [p["tokens"] for p in got["predictions"]]
        lps = [p["logprobs"] for p in got["predictions"]]
        out["tokens_per_s"] = sum(map(len, served)) / wall
        log(f"[moe] 16 requests (prompts {min(CONT_LENS)}-{max(CONT_LENS)} "
            f"tokens, {sum(n for _, n in reqs)} new) on 8 paged lanes "
            f"through :predict in {wall:.3f} s: {sum(map(len, served))} "
            f"tokens, {out['tokens_per_s']:.1f} tokens/s, peak active lanes "
            f"{eng.peak_active}")
        ttft = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.submit(reqs[1][0], 1).result(timeout=120)
            ttft.append(1e3 * (time.perf_counter() - t0))
        out["ttft_ms"] = ttft
        log(f"[moe] TTFT of a 512-token prompt: "
            f"{[round(x, 3) for x in ttft]} ms")
        # /v1/embeddings: the counts go to 0 just before and are read after
        attn.flash_forward.launches = 0
        attn.flash_forward.launches_by_route = {"sm90": 0, "simt": 0}
        t0 = time.perf_counter()
        emb = json.loads(_post(srv.url, "/v1/embeddings", {"input": texts}))
        out["embeddings_s"] = time.perf_counter() - t0
        out["embeddings_launches"] = attn.flash_forward.launches
        by_route = dict(attn.flash_forward.launches_by_route)
    finally:
        srv.stop()
        eng.stop()
    out["ticks_run"] = _graph_only(eng, "(moe)")
    del eng
    gc.collect()
    vecs = np.asarray([d["embedding"] for d in emb["data"]])
    norms = np.linalg.norm(vecs, axis=-1)
    if vecs.shape != (2, cfg.d_model) or not np.isfinite(vecs).all() \
            or np.abs(norms - 1).max() > 1e-3:
        raise AssertionError(f"bad MoE embeddings: shape {vecs.shape}, "
                             f"norms {norms}")
    if out["embeddings_launches"] != cfg.n_layers or \
            by_route != {"sm90": cfg.n_layers, "simt": 0}:
        raise AssertionError(f"MoE embeddings launched flash_forward "
                             f"{out['embeddings_launches']} times, by route "
                             f"{by_route}; want {cfg.n_layers}, all sm90")
    ids = [encode_prompt(ByteTokenizer(), t) for t in texts]
    toks = np.zeros((2, 512), np.int64)      # the server's 128-token bucket
    for i, r in enumerate(ids):
        toks[i, :len(r)] = r
    chunked = unittest.mock.patch.object(
        llama, "multi_head_attention",
        lambda *a, **k: attn.multi_head_attention(*a, impl="chunked", **k))
    with chunked, torch.inference_mode():
        x, _ = moe.forward_hidden(cfg, params,
                                  torch.as_tensor(toks, device="cuda"))
    ref = []
    for i, r in enumerate(ids):
        pooled = x[i, :len(r)].float().mean(0)
        ref.append((pooled / pooled.norm()).cpu().numpy())
    cos = [float(np.dot(a, b)) for a, b in zip(vecs, ref)]
    if min(cos) < 0.99:
        raise AssertionError(f"MoE embeddings disagree with the chunked "
                             f"attention path: cosine {cos}")
    log(f"[moe] /v1/embeddings 2 inputs ({emb['usage']['prompt_tokens']} "
        f"tokens) in {out['embeddings_s']:.3f} s: {cfg.n_layers} "
        f"flash_forward launches, by route {by_route}; against the chunked "
        f"path: cosine {[round(c, 6) for c in cos]}")
    out["hold"] = _hold(torch, cfg, params, reqs, served,
                        "(moe) bf16 continuous", lps=lps)
    # the check must refuse a faulty engine: one layer's decode-tick K/V
    # writes lost, in the middle layer and in the last
    out["planted"] = {}
    for layer in (cfg.n_layers // 2, cfg.n_layers - 1):
        bad = engine()
        with unittest.mock.patch.object(
                llama, "attention_step", _lost_write(llama, bad._pool, layer)):
            got, bad_lps = _run(bad, reqs)
        del bad
        gc.collect()
        r = out["planted"][layer] = _reading(torch, cfg, params, reqs, got,
                                             bad_lps)
        log(f"[moe] planted fault, layer {layer}'s decode K/V writes lost: "
            f"{_describe(r)}; identical to :predict's: "
            f"{_agree(got, served)[0]}/16 requests")
        if r["ok"]:
            raise AssertionError(f"the MoE check passes an engine that loses "
                                 f"layer {layer}'s K/V writes")
    out["ticks"] = _tick_table(torch, engine, cfg, params, reqs[1][0],
                               "[moe]")
    # the graph route against the eager route on one schedule, dropless
    # and at the preset's capacity factor (whose one-pass reference would
    # route with another capacity than the ticks)
    for config, sub in ((cfg, reqs), (preset, reqs[:4])):
        t0 = time.perf_counter()
        g = engine(config=config)
        graph, _ = _run(g, sub)
        _graph_only(g, f"(moe {config.capacity_factor}) graph")
        eager, _ = _run(_eager(engine(config=config)), sub)
        del g
        gc.collect()
        same, prefix = _agree(graph, eager)
        log(f"[moe] capacity factor {config.capacity_factor}: {len(sub)} "
            f"requests inline on the graph and the eager route in "
            f"{time.perf_counter() - t0:.1f} s: {same}/{len(sub)} identical "
            f"({prefix} of {sum(map(len, eager))} tokens before each first "
            f"divergence); against :predict's dropless tokens: "
            f"{_agree(graph, served[:len(sub)])[0]}/{len(sub)} identical "
            f"(a reading)")
        if graph != eager:
            raise AssertionError(f"at capacity factor "
                                 f"{config.capacity_factor} the graph "
                                 f"route's tokens differ from the eager "
                                 f"route's")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[moe] {out['peak_gib']:.2f} GiB peak device memory in the phase "
        f"({cfg.num_params * 2 / 1e9:.2f} GB of weights)")
    out["reqs"], out["served"] = reqs, served
    return cfg, params, out


def phase_moe_f32(torch, cfg, params) -> dict:
    """``phase_moe``'s weights widened in place to float32 (the same
    model, exactly), the 16 requests on 8 paged lanes on the graph route,
    every served token and its log-probability held to the MoE reference
    with a dense model's limits (``NEAR_TIE``, ``NEAR_TIE_SHARE``): in
    float32 the engine and the reference agree far inside the router's
    margins, so every token is routed alike on both sides. Then the
    check must refuse a faulty engine: one layer's decode-tick K/V writes
    lost, in the middle layer and in the last."""
    import dataclasses

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    for tree in (params, params["layers"]):
        for k, v in tree.items():
            if torch.is_tensor(v):
                tree[k] = v.float()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, reqs = _cont_requests(cfg32)
    eng = ContinuousBatchingEngine(cfg32, params, lanes=CONT_LANES,
                                   max_len=CONT_MAX_LEN, device="cuda")
    t0 = time.perf_counter()
    got, lps = _run(eng, reqs)
    wall = time.perf_counter() - t0
    ticks = _graph_only(eng, "(moe f32)")
    del eng
    gc.collect()
    log(f"[moe32] the {cfg32.n_layers}-layer model in float32 "
        f"({cfg32.num_params * 4 / 1e9:.1f}"
        f" GB): 16 requests on 8 paged lanes in {wall:.3f} s, ticks by "
        f"route {ticks}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    out = _hold(torch, cfg32, params, reqs, got, "(moe f32) continuous",
                lps=lps)
    out["planted"] = {}
    for layer in (cfg32.n_layers // 2, cfg32.n_layers - 1):
        bad = ContinuousBatchingEngine(cfg32, params, lanes=CONT_LANES,
                                       max_len=CONT_MAX_LEN, device="cuda")
        with unittest.mock.patch.object(
                llama, "attention_step", _lost_write(llama, bad._pool, layer)):
            bad_got, bad_lps = _run(bad, reqs)
        del bad
        gc.collect()
        r = out["planted"][layer] = _reading(torch, cfg32, params, reqs,
                                             bad_got, bad_lps)
        log(f"[moe32] planted fault, layer {layer}'s decode K/V writes lost: "
            f"{_describe(r)}; identical to the fault-free run's: "
            f"{_agree(bad_got, got)[0]}/16 requests")
        if r["ok"]:
            raise AssertionError(f"the MoE check passes an engine that loses "
                                 f"layer {layer}'s K/V writes")
    return out


def phase_moe_predictor(torch, cfg, params) -> dict:
    """``python -m kubedl_tpu_torch.serving`` over a Mixtral-width
    ``save_model`` artifact of 1 layer (float32 ``params.npz``, ~6.9 GB):
    time to ready, ``:predict`` held to the in-process engine on the same
    weights and to the MoE reference, SIGTERM → exit 0."""
    import dataclasses
    import os
    import shutil
    import signal

    import numpy as np

    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine

    cfg1 = dataclasses.replace(cfg, n_layers=MOE_PRED_LAYERS)
    params1 = {**params, "layers": {
        k: v[:MOE_PRED_LAYERS] for k, v in params["layers"].items()}}
    path = BUILD_OUT / "moe_model"
    t0 = time.perf_counter()
    io.save_model(cfg1, params1, str(path))
    size = (path / "params.npz").stat().st_size
    log(f"[mpred] artifact: {size / 1e9:.2f} GB params.npz (family "
        f"{json.loads((path / 'config.json').read_text())['family']}) "
        f"written in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(13)
    reqs = [(rng.integers(3, cfg.vocab_size, n).tolist(), 12)
            for n in (40, 130, 300)]
    ref = ContinuousBatchingEngine(cfg1, params1, lanes=4,
                                   max_len=CONT_MAX_LEN, device="cuda")
    want = ref.run(reqs)
    del ref
    gc.collect()
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root),
           "KUBEDL_MODEL_PATH": str(path), "KUBEDL_MODEL_NAME": "mixtral",
           "KUBEDL_SERVING_LANES": "4",
           "KUBEDL_SERVING_MAX_LEN": str(CONT_MAX_LEN),
           "KUBEDL_TOKENIZER": "off", "KUBEDL_SERVING_PORT": str(port)}
    env.pop("KUBEDL_KV_MODE", None)
    env.pop("KUBEDL_SERVING_QUANTIZE", None)
    log_path = BUILD_OUT / "moe_predictor.log"
    out = {}
    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubedl_tpu_torch.serving"], env=env,
            cwd=root, stdout=logf, stderr=subprocess.STDOUT)
        try:
            _wait_ready(url, proc, log_path, timeout=600)
            out["ready_s"] = time.perf_counter() - t0
            got = json.loads(_post(url, "/v1/models/mixtral:predict", {
                "instances": [{"prompt_tokens": p, "max_tokens": n}
                              for p, n in reqs]}))
            served = [p["tokens"] for p in got["predictions"]]
            log(f"[mpred] ready in {out['ready_s']:.1f} s (load, graph "
                f"capture, bind); :predict of 3 requests")
            proc.send_signal(signal.SIGTERM)
            out["sigterm_rc"] = proc.wait(timeout=120)
            if out["sigterm_rc"] != 0:
                raise AssertionError(f"the MoE predictor exited "
                                     f"{out['sigterm_rc']} on SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    shutil.rmtree(path)
    _hold(torch, cfg1, params1, reqs, served, "(mpred) predictor",
          want=want, want_label="the in-process engine")
    return out


def _moe_int8_params(torch, cfg) -> dict:
    """Random Mixtral weights quantized to int8 on the card one layer at a
    time: each layer is drawn in bf16 (``moe.init_layer``), its matmul
    weights quantized (``quant.quantize_int8``, per output channel) into
    preallocated stacks, and freed, so the bf16 tree never exists."""
    import dataclasses

    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(0)
    n = cfg.n_layers
    layers = {}
    for name, (shape, f32) in moe.param_shapes(cfg)["layers"].items():
        if name in quant.QUANTIZABLE:
            layers[name] = quant.QTensor(
                q=torch.empty((n,) + shape, dtype=torch.int8, device="cuda"),
                scale=torch.empty((n,) + shape[:-2] + shape[-1:],
                                  dtype=torch.float32, device="cuda"))
        else:
            layers[name] = torch.empty(
                (n,) + shape, device="cuda",
                dtype=torch.float32 if f32 else cfg.dtype)
    for i in range(n):
        for name, w in moe.init_layer(cfg, gen, "cuda").items():
            dst = layers[name]
            if isinstance(dst, quant.QTensor):
                q = quant.quantize_int8(w)
                dst.q[i].copy_(q.q)
                dst.scale[i].copy_(q.scale)
            else:
                dst[i].copy_(w)
            del w
    top = moe.init_params(dataclasses.replace(cfg, n_layers=0), gen, "cuda")
    top["lm_head"] = quant.quantize_int8(top["lm_head"])
    return {**top, "layers": layers}


def _moe_ticks(torch, cfg, params, prompt, tag, reps=5) -> dict:
    """The graph tick at 1, 4 and 8 lanes (``_tick_table``'s state: every
    lane ``prompt[:500]`` plus one token), against ``_tick_bound_ms``."""
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    rows = {}
    for lanes in (1, 4, 8):
        eng = ContinuousBatchingEngine(cfg, params, lanes=lanes,
                                       max_len=CONT_MAX_LEN, device="cuda")
        for i in range(lanes):
            eng.submit(prompt[:500] + [i + 3], 256)
        eng.step()
        live = lanes * 502
        ms = _tick_ms(torch, eng, None, reps=reps)
        bound_ms, w_gb = _tick_bound_ms(cfg, eng.params, lanes, live)
        _graph_only(eng, f"{tag} {lanes} lanes")
        rows[lanes] = {"graph_ms": ms, "bound_ms": bound_ms,
                       "live_tokens": live, "weight_gb": w_gb}
        log(f"{tag} {lanes} lane(s), {live} live tokens: decode tick graph "
            f"{ms:.3f} ms, bound {bound_ms:.3f} ms ({w_gb:.2f} GB of "
            f"weights read once + the live K/V at 3.35 TB/s): "
            f"{ms / bound_ms:.2f}x")
        del eng
        gc.collect()
    return rows


#: [moe8]'s depth: Mixtral-8x7B at full width, cut to 8 of its 32 layers
#: (~12.0 GB in int8) so the script's later phases fit its time limit; the
#: 32-layer int8 run (46.87 GB) is an earlier slice's reading in PERF.md
MOE_INT8_LAYERS = 8


def phase_moe_int8(torch) -> dict:
    """Mixtral-8x7B at full width, ``MOE_INT8_LAYERS`` of its 32 layers
    deep, int8, built one layer at a time on the card (the bf16 tree never
    exists): the graph tick at 1, 4 and 8 lanes with bf16
    activations (the serving configuration); then the continuous phase's
    16 requests on 8 paged lanes, dropless, with bf16 activations and
    again with float32 activations, every token and its log-probability
    held to the int8 model's reference with ``NEAR_TIE`` unchanged (in
    bf16 at most ``MOE_HALF_SHARE`` of the tokens beyond it, as in
    ``phase_moe``; in float32 a dense model's limits); peak device
    memory."""
    import dataclasses

    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.ops import quant
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine

    cfg = _moe_dropless(dataclasses.replace(moe.mixtral_8x7b(),
                                            n_layers=MOE_INT8_LAYERS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _moe_int8_params(torch, cfg)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0,
           "bytes": quant.tree_nbytes(params),
           "build_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[moe8] Mixtral-8x7B, {cfg.n_layers} layers, "
        f"{cfg.num_params / 1e9:.3f} B params "
        f"({cfg.num_params * 2 / 1e9:.1f} GB in bf16) built in int8 one "
        f"layer at a time on the card in {out['build_s']:.1f} s: "
        f"{out['bytes'] / 1e9:.3f} GB of weights, peak "
        f"{out['build_peak_gib']:.2f} GiB during the build")
    _, reqs = _cont_requests(cfg)
    out["ticks"] = _moe_ticks(torch, cfg, params, reqs[1][0], "[moe8]")
    for acts in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=getattr(torch, acts))
        eng = ContinuousBatchingEngine(c, params, lanes=CONT_LANES,
                                       max_len=CONT_MAX_LEN, device="cuda")
        t0 = time.perf_counter()
        got, lps = _run(eng, reqs)
        wall = out[f"run_s_{acts}"] = time.perf_counter() - t0
        ticks = _graph_only(eng, f"(moe int8, {acts})")
        del eng
        gc.collect()
        log(f"[moe8] {acts} activations: 16 requests on 8 paged lanes in "
            f"{wall:.3f} s ({sum(map(len, got)) / wall:.1f} tokens/s, the "
            f"decode graph's capture included), ticks by route {ticks}")
        out[f"hold_{acts}"] = _hold(
            torch, c, params, reqs, got,
            f"(moe int8, {acts} activations) continuous", lps=lps)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[moe8] {out['peak_gib']:.2f} GiB peak device memory in the phase")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe_training(torch) -> tuple:
    """``python -m kubedl_tpu_torch.train`` on ``moe.mixtral_8x7b`` cut to
    2 layers, b=2 s=2048, the preset's capacity factor, remat,
    ``loss_chunk`` 512, 3 steps: a falling loss, every K1-K3 launch on
    ``sm90``, MFU from the active params. Returns (readings, config dict,
    token path)."""
    cfg_path, tokens, cfg = _train_config(
        "moe_train", model="moe.mixtral_8x7b", vocab=32000,
        overrides={"n_layers": MOE_TRAIN_LAYERS}, batch=2, steps=3)
    return _train_run(torch, "mtrain", cfg_path, cfg, ALL_SM90), cfg, tokens


def phase_moe_grad_check(torch):
    """``phase_grad_check`` on Mixtral's width, 2 layers, b=1 s=2048:
    every gradient, ``w_router`` included, through K1-K3 on ``sm90``
    against the chunked attention path."""
    _, tokens, cfg = _train_config(
        "moe_grad", model="moe.mixtral_8x7b", vocab=32000,
        overrides={"n_layers": MOE_TRAIN_LAYERS}, batch=1, steps=1)
    phase_grad_check(torch, cfg, tokens, ALL_SM90, tag="mgrad")



# -- slice 13: context and expert parallelism ----------------------------------

#: the ring's card check: every shape cut into RING_CP sequence shards and
#: run as the cp ranks' schedule in one process (``parallel.ring``)
RING_CP = 4
#: Llama's training shape (shards of 512), Gemma-2B's at b=2 (hd 256),
#: and Llama's heads in float32 on the simt route (b=1)
RING_CASES = {"llama": TRAIN, "gemma": GEMMA_TRAIN,
              "llama_f32": {**TRAIN, "b": 1, "dtype": "float32"}}
#: the ring against the unsharded kernels. The ring rounds each block's
#: partial output and dq/dk/dv to bf16 before the float32 merge or sum
#: over the cp blocks (ROADMAP §C "Rounding"), where one process rounds
#: once: cp + 1 roundings of 2**-8 relative, summed with cancellation. So
#: the norm-wise relative error (``_bwd_err``) within RING_NORM_TOL, a few
#: times 2**-8, beside a max abs at the largest value's scale within 0.05
#: for the gradients (ATOL for the output); float32 within the kernels'
#: own bounds
RING_GRAD_TOL = {"bfloat16": 0.05, "float32": BWD_TOL["float32"]}
RING_NORM_TOL = {"bfloat16": 4 * 2.0 ** -8,
                 "float32": BWD_NORM_TOL["float32"]}
#: the kernels' shapes on [cp2]'s paths at Llama-3-8B's heads: one ring
#: step of a rank's 2048 rows against the other rank's 2048 keys (offsets
#: (2048, 0)), and Ulysses' local attention, the whole 4096 on 32 / 2
#: query heads with K/V expanded to them
CP2_BLOCK = {**TRAIN, "b": 2, "sq": 2048, "sk": 2048, "offsets": (2048, 0)}
ULYSSES_LOCAL = {**TRAIN, "b": 2, "sq": 4096, "sk": 4096, "nh": 16,
                 "nkv": 16}
#: [cp2] and [ep2]: two processes on the one card under gloo
MESH_TIMEOUT_S = 300.0
#: [cp2]: Llama-3-8B width, 2 layers, global b=2 x 4096 (each cp rank
#: b=2 x 2048); [ep2]: Mixtral width at MOE_TRAIN_LAYERS, each ep rank 4
#: of the 8 experts, on the moe_training phase's config
CP2_LAYERS, CP2_SEQ, CP2_STEPS = 2, 4096, 3
#: what the sharded path decides, against the same job unsharded: the
#: losses of every step within LOSS_GAP, and the first step's final
#: hidden states (every position, gathered over cp) and whole gradient
#: tree, each by norm-wise relative error, within HIDDEN_REL and GRAD_REL
#: (``_hold_mesh_run``). Set at 2-5x the readings on an H100 80GB HBM3
#: at 700 W (PERF.md §6): ring / Ulysses loss gaps 2.1e-4 / 2.7e-4,
#: hidden 7.1e-3 / 0, gradients 9.2e-3 / 5.1e-3; ep loss gap 0.0467,
#: hidden 0.0395, gradients 0.0549, where the router flipped 16 near-tie
#: choices of 8,192. A ring without its K/V shift read 1.12 / 0.878 /
#: 0.845, an ep run without ``ep_sum`` 0.533 / 0.968 / 0.846
#: [cp2]'s ``logp_gap`` holds a multiple-choice option's log-probability
#: per token of the option against the same job unsharded (the NLL of
#: ``mode: evaluate`` over 8,192 tokens and DPO's losses take
#: ``loss_gap``): an option sums 3-12 tokens, whose bf16 rounding does
#: not average out as the perplexity's does. Set at ~3x the ring's first
#: reading on an H100 80GB HBM3 at 700 W (PERF.md §6), 6.875e-3 (Ulysses
#: 1.3e-6), the scale of the ring's hidden states (7.1e-3)
MESH_BOUNDS = {"cp2": {"loss_gap": 1e-3, "hidden_rel": 2e-2,
                       "grad_rel": 3e-2, "logp_gap": 2e-2},
               "ep2": {"loss_gap": 0.1, "hidden_rel": 0.1,
                       "grad_rel": 0.15},
               # set before the first reading: the stages run the
               # unsharded layers on microbatches, and the leaves outside
               # the stages add two stages' bf16 gradients; read on an
               # H100 at 700 W (PERF.md §6): loss gaps 4.4e-5 (Llama) and
               # 2.1e-4 (Gemma-2B), hidden states 0, gradients 2.4e-3
               "pp2": {"loss_gap": 5e-3, "hidden_rel": 2e-2,
                       "grad_rel": 3e-2}}


def _ring_block(case, sq) -> dict:
    """One ring step's kernel shape: a shard of ``sq`` q rows against one
    block of ``sq`` keys wholly below the diagonal (offsets (sq, 0)), the
    heaviest step the ring runs."""
    return {**case, "sq": sq, "sk": sq, "offsets": (sq, 0)}


def _sdpa_ms(torch, q, k, v, do, causal) -> tuple:
    """(forward ms, backward ms) of SDPA on the same q, k, v (K/V
    repeated to the query heads for the backward)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    reps = q.shape[2] // k.shape[2]
    fwd = _time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
                                       enable_gqa=True), reps=20)
    leaves = [t.detach().clone().requires_grad_() for t in
              (qt, kt.repeat_interleave(reps, 1),
               vt.repeat_interleave(reps, 1))]
    out = sdpa(*leaves, is_causal=causal)
    bwd = _time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do.transpose(1, 2), retain_graph=True), reps=20)
    return fwd, bwd


def _kernels_at(torch, attn, what, case, q, k, v, do, timed=False,
                tag="ring", **kw) -> dict:
    """K1, K2 and K3 at one shape of the slice's paths (``kw``: offsets,
    segment ids, ``kv_segment_ids``), each against its plain version on
    the same inputs by ``_bwd_err``: the max abs (K1's within ATOL, K2's
    and K3's within BWD_TOL at the largest value's scale) and the
    norm-wise relative error within BWD_NORM_TOL; K1's lse within
    ATOL["lse"]. With ``timed``, each kernel beside its plain version, its
    bound and SDPA on the same q, k, v (the shape's mask is all visible or
    causal from 0)."""
    dt = case["dtype"]
    o, lse = attn.flash_forward(q, k, v, True, **kw)
    delta = attn.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, True)
    calls = {
        "flash_forward": (lambda: attn.flash_forward(q, k, v, True, **kw),
                          lambda: attn.flash_forward_plain(q, k, v, True,
                                                           **kw)),
        "flash_dq": (lambda: attn.flash_dq(*args, **kw),
                     lambda: attn.flash_dq_plain(*args, **kw)),
        "flash_dkv": (lambda: attn.flash_dkv(*args, **kw),
                      lambda: attn.flash_dkv_plain(*args, **kw))}
    if timed:
        lib = _sdpa_ms(torch, q, k, v, do, causal=not kw.get("offsets"))
    shape = _shape(case) + (f" offsets {kw['offsets']}"
                            if kw.get("offsets") else "")
    rows = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        row = {"shape": shape}
        if name == "flash_forward":
            row["lse_err"] = float((got[1] - want[1]).abs().max())
            got, want = got[:1], want[:1]
        errs = [_bwd_err(torch, a, b, dt,
                         tol=ATOL[dt] if name == "flash_forward" else None)
                for a, b in zip(got, want)]
        row.update(max_abs_err=max(e["max"] for e in errs),
                   rel_err=max(e["rel"] for e in errs), checks=errs)
        ok = all(e["ok"] for e in errs) and row.get("lse_err", 0.0) <= \
            ATOL["lse"]
        line = "; ".join(
            f"max {e['max']:.3e} (limit {e['tol']:.3e}), norm-wise "
            f"{e['rel']:.3e} (limit {e['rel_tol']:.3e}), median |want| "
            f"{e['median']:.3e}" for e in errs)
        if timed:
            bound_ms, bound_by = _flash_bound(torch, {**case, **kw}, None,
                                              name)
            row.update(ms=_time_ms(torch, kernel, reps=20, warmup=2),
                       plain_ms=_time_ms(torch, plain, reps=5, warmup=1),
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib[0] if name == "flash_forward"
                       else lib[1])
            line += (f"; kernel {row['ms']:.4f} ms, plain "
                     f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f}"
                     f" ms, bound {bound_ms:.4f} ms ({bound_by})")
        log(f"[{tag}] {name} at {what} {shape} "
            f"({attn.flash_fwd_route(q.dtype, case['hd'])}): {line}"
            + (f"; lse {row['lse_err']:.3e}" if "lse_err" in row else ""))
        if not ok:
            raise AssertionError(f"[{tag}] {name} at {what} {shape} "
                                 f"disagrees with its plain version: "
                                 f"{errs}, lse {row.get('lse_err')}")
        rows[name] = row
    return rows


def _kernels_at_shape(torch, attn, what, case, seed, timed=True,
                      tag="ring") -> dict:
    """``_kernels_at`` on fresh inputs of ``case`` from ``seed``."""
    q, k, v, _ = _inputs(torch, case, seed)
    do = torch.randn(q.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed + 1)).to(q.dtype)
    kw = {"offsets": case["offsets"]} if case.get("offsets") else {}
    return _kernels_at(torch, attn, what, case, q, k, v, do, timed=timed,
                       tag=tag, **kw)


def _split_segments_check(torch, attn, case, seed) -> dict:
    """K1-K3 on one cp rank's query rows (the second of 2 shards) against
    the whole sequence's keys with packed segment ids, the query rows'
    apart from the keys' (``kv_segment_ids``, offsets (s/2, 0)): the
    llama block's case on the ring setting with segment ids, each kernel
    against its plain version (``_kernels_at``)."""
    q, k, v, _ = _inputs(torch, case, seed)
    sq = case["sq"] // 2
    q = q[:, sq:].contiguous()
    do = torch.randn(q.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed + 1)).to(q.dtype)
    pos = torch.arange(case["sq"], device="cuda")
    seg = torch.stack([(pos >= case["sq"] // 3 + 7 * i).int()
                       + (pos >= (2 * case["sq"]) // 3 - 5 * i).int()
                       for i in range(case["b"])])
    rows = _kernels_at(
        torch, attn, f"a rank's rows {sq}-{case['sq']} against all "
        f"{case['sq']} keys with split segments,", {**case, "sq": sq}, q, k,
        v, do, segment_ids=seg[:, sq:], kv_segment_ids=seg, offsets=(sq, 0))
    return {name: row["max_abs_err"] for name, row in rows.items()}


def _ring_err(torch, what, got, want, dtype) -> dict:
    """``_bwd_err`` of the ring against the unsharded kernels, held to the
    ring's bounds (``RING_GRAD_TOL``, ``RING_NORM_TOL``)."""
    scale = max(float(want.float().abs().max()), 1.0)
    return _bwd_err(torch, got, want, dtype,
                    tol=(ATOL[dtype] if what == "out"
                         else RING_GRAD_TOL[dtype] * scale),
                    rel_tol=RING_NORM_TOL[dtype])


def phase_ring(torch) -> dict:
    """Ring attention's loops on the card in one process
    (``parallel.ring.ring_schedule``: every one of ``RING_CP`` ranks'
    ring steps in ring order, through the loops the ranks run, the shift
    a rotation of the list) at Llama's training shape (shards of 512),
    Gemma-2B's (hd 256, b=2) and Llama's heads in float32 (simt): the
    forward and the q/k/v gradients against the unsharded
    ``flash_attention`` on the same inputs (``_ring_err``: max abs and
    norm-wise relative error), K1, K2 and K3 each launched cp² times on
    the shape's route. Times the whole ring's forward and backward beside
    the unsharded kernels', Δ, and (Llama) each kernel at one ring block
    beside its plain version, its bound and SDPA. Each shape also checks
    K1-K3 on one rank's query rows against the whole sequence's keys with
    split segment ids (``_split_segments_check``); then K1-K3 against
    their plain versions, timed, at the shapes [cp2] launches them
    (``CP2_BLOCK``, ``ULYSSES_LOCAL``)."""
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.parallel import ring

    out = {}
    for i, (tag, case) in enumerate(RING_CASES.items()):
        split = _split_segments_check(torch, attn, {**case, "b": 2}, 730 + i)
        q, k, v, _ = _inputs(torch, case, seed=700 + i)
        do = torch.randn(q.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(710 + i)).to(q.dtype)
        dt, hd = case["dtype"], case["hd"]
        route = attn.flash_fwd_route(q.dtype, hd)
        qs, ks, vs, dos = (list(t.chunk(RING_CP, 1)) for t in (q, k, v, do))
        leaves = [t.clone().requires_grad_() for t in qs + ks + vs]
        _reset_counts(attn)
        outs = ring.ring_schedule(leaves[:RING_CP],
                                  leaves[RING_CP:2 * RING_CP],
                                  leaves[2 * RING_CP:], causal=True)
        grads = torch.autograd.grad(outs, leaves, dos)
        torch.cuda.synchronize()
        counts = {fn.__name__: dict(fn.launches_by_route)
                  for fn in (attn.flash_forward, attn.flash_dq,
                             attn.flash_dkv)}
        want = {route: RING_CP ** 2,
                "simt" if route == "sm90" else "sm90": 0}
        if any(c != want for c in counts.values()):
            raise AssertionError(f"[ring] {tag}: launches {counts}, want "
                                 f"{want} for each kernel")
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = attn.flash_attention(*full, causal=True)
        ref_grads = torch.autograd.grad(ref, full, do)
        got = [torch.cat(outs, 1)] + [
            torch.cat(grads[j * RING_CP:(j + 1) * RING_CP], 1)
            for j in range(3)]
        checks = {what: _ring_err(torch, what, a.detach(), b.detach(), dt)
                  for what, a, b in zip(("out", "dq", "dk", "dv"), got,
                                        [ref, *ref_grads])}
        errs = {what: e["max"] for what, e in checks.items()}
        log(f"[ring] {tag} against the unsharded kernels: " + "; ".join(
            f"{what} max {e['max']:.3e} (limit {e['tol']:.3e}), norm-wise "
            f"{e['rel']:.3e} (limit {e['rel_tol']:.3e}), median |want| "
            f"{e['median']:.3e}" for what, e in checks.items()))
        bad = {what: e for what, e in checks.items() if not e["ok"]}
        if bad:
            raise AssertionError(f"[ring] {tag} disagrees with the "
                                 f"unsharded kernels: {bad}")
        del outs, grads, ref, ref_grads, full, leaves
        shards = [t.contiguous() for t in qs + ks + vs]
        sq_, sk_, sv_ = (shards[j * RING_CP:(j + 1) * RING_CP]
                         for j in range(3))
        local = ring.local_ring(RING_CP)
        routs, rlses = ring.flash_ring_forward(local, sq_, sk_, sv_, True)
        o, lse = attn.flash_forward(q, k, v, True)
        row = {"shape": _shape(case), "cp": RING_CP, "route": route,
               "launches_by_kernel": counts, "max_abs_err": errs,
               "rel_err": {what: e["rel"] for what, e in checks.items()},
               "split_segments_max_abs_err": split,
               "ring_fwd_ms": _time_ms(
                   torch, lambda: ring.flash_ring_forward(
                       local, sq_, sk_, sv_, True), reps=10, warmup=2),
               "unsharded_fwd_ms": _time_ms(
                   torch, lambda: attn.flash_forward(q, k, v, True),
                   reps=10, warmup=2),
               "ring_bwd_ms": _time_ms(
                   torch, lambda: ring.flash_ring_backward(
                       local, sq_, sk_, sv_, routs, rlses, dos, True),
                   reps=10, warmup=2),
               "unsharded_bwd_ms": _time_ms(
                   torch, lambda: attn.flash_backward(q, k, v, o, lse, do,
                                                      True),
                   reps=10, warmup=2),
               "delta_ms": _time_ms(torch, lambda: attn.flash_delta(o, do),
                                    reps=20, warmup=2)}
        log(f"[ring] {tag} at {row['shape']} in {RING_CP} shards "
            f"({route}): launches {counts}; whole ring "
            f"forward {row['ring_fwd_ms']:.4f} ms against the unsharded "
            f"K1 {row['unsharded_fwd_ms']:.4f} ms; whole ring backward "
            f"{row['ring_bwd_ms']:.4f} ms against the unsharded Δ+K2+K3 "
            f"{row['unsharded_bwd_ms']:.4f} ms; Δ {row['delta_ms']:.4f} ms "
            f"(once per ring backward)")
        if tag == "llama":
            row["block"] = _kernels_at(
                torch, attn, "one ring block", _ring_block(case, q.shape[1]
                                                          // RING_CP),
                sq_[1], sk_[0], sv_[0], dos[1].contiguous(), timed=True,
                offsets=(q.shape[1] // RING_CP, 0))
        out[tag] = row
        del q, k, v, do, qs, ks, vs, dos, shards, sq_, sk_, sv_, routs
        del rlses, o, lse
        gc.collect()
        torch.cuda.empty_cache()
    out["cp2_block"] = _kernels_at_shape(torch, attn, "[cp2]'s ring block",
                                         CP2_BLOCK, 740)
    out["ulysses_local"] = _kernels_at_shape(
        torch, attn, "[cp2]'s Ulysses attention", ULYSSES_LOCAL, 750)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sq_dist(torch, a, b=None) -> float:
    """sum((a - b)^2) (or sum(a^2)) in float64, a chunk of 2**26 values
    at a time: an expert stack is 940 M values."""
    a = a.reshape(-1)
    b = None if b is None else b.reshape(-1)
    total = 0.0
    for i in range(0, a.numel(), 1 << 26):
        x = a[i:i + (1 << 26)].float()
        if b is not None:
            x = x - b[i:i + (1 << 26)].float()
        total += float(x.double().square().sum())
    return total


def _first_step(torch, path) -> dict:
    """The first step of the training job at ``path`` as its sharded path
    decides it, against the same step unsharded: the weights
    ``init_params`` makes from the job's seed (as ``main`` does), the
    job's first batch. On the rank's mesh: the final hidden states
    (``forward_hidden``, gathered over ``cp``), the gradient of every
    leaf's local piece for the rank's share of the loss, and for an MoE
    model the router's choices. Then every rank runs the step on one
    process (no collective) and compares: the hidden states' norm-wise
    relative error and least cosine by position, and for each leaf the
    squared distance and squared norm of its local piece against the same
    piece of the unsharded gradient (``sharding.local_shard``; a leaf
    sharded on ``ep`` is summed over the ranks by ``_hold_mesh_run``), the
    first loss, and the router's choices that differ by layer
    (``_flips``)."""
    import torch.distributed as dist

    from kubedl_tpu_torch.models import io, moe
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.parallel import collectives, sharding
    from kubedl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train.trainer import tree_leaves

    cfg = json.loads(Path(path).read_text())
    config, _ = train_main.resolve_model(cfg, device="cuda")
    fam = io.family_of(config)
    mesh = build_mesh(MeshConfig(**cfg["mesh"]), device="cuda")
    params = fam.init_params(config, torch.Generator(
        device="cuda").manual_seed(int(cfg["seed"])), device="cuda")
    host = (_packed_batch(config, cfg["batch"], cfg["seq"], int(cfg["seed"]))
            if cfg.get("packed") else next(iter(train_main._raw_stream(
                cfg["data"], config, cfg["batch"], cfg["seq"]))))
    route = moe.route

    def packing(b):
        return {k: b[k] for k in ("segment_ids", "positions") if k in b}

    def hidden(p, b, m, picks):
        def recording(config_, probs, capacity, token_mask=None,
                      mesh=None):
            picks.append((probs.topk(config_.top_k, -1).indices,
                          probs.detach()))
            return route(config_, probs, capacity, token_mask, mesh=mesh)
        with torch.no_grad(), unittest.mock.patch.object(
                moe, "route", recording):
            h = fam.forward_hidden(config, p, b["tokens"], mesh=m,
                                   **packing(b))
        return h[0] if isinstance(h, tuple) else h

    rank = dist.get_rank()
    log(f"[first step] rank {rank}: {cfg['mesh']} on the mesh")
    placed = sharding.shard_tree(params, mesh, fam.param_specs(config))
    specs = {k: sharding.spec_of(p.placements)
             for k, p in tree_leaves(placed)}
    batch = {k: sharding.local_of(v)
             for k, v in tdata.shard_batch(host, mesh).items()}
    picks = []
    h = collectives.all_gather(
        hidden(sharding.views(placed, mesh), batch, mesh, picks),
        mesh, 1).float()
    view = sharding.views(placed, mesh, requires_grad=True)
    leaves = tree_leaves(view)
    share = fam.loss_fn(config, view, batch["tokens"], batch["targets"],
                        mesh=mesh, mask=batch.get("mask"), **packing(batch))
    grads = torch.autograd.grad(share, [getattr(p, "local", p)
                                        for _, p in leaves])
    loss = float(collectives.world_sum(share))
    local = {k: g for (k, _), g in zip(leaves, grads)}
    del view, leaves, grads, placed, share
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[first step] rank {rank}: unsharded")
    full = tdata.to_device(host, torch.device("cuda"))
    ref_picks = []
    ref_h = hidden(params, full, None, ref_picks).float()
    ref_leaves = [(k, t.requires_grad_()) for k, t in tree_leaves(params)]
    ref_loss = fam.loss_fn(config, params, full["tokens"], full["targets"],
                           mask=full.get("mask"), **packing(full))
    ref_grads = torch.autograd.grad(ref_loss, [t for _, t in ref_leaves])
    _reset_counts(attn)            # the checks launched K1-K3 too
    out = {"loss": loss, "ref_loss": float(ref_loss),
           "hidden_rel": float((h - ref_h).norm() / ref_h.norm()),
           "hidden_min_cos": float(torch.nn.functional.cosine_similarity(
               h, ref_h, dim=-1).min()),
           "leaves": {}}
    for (k, _), g in zip(ref_leaves, ref_grads):
        want = sharding.local_shard(g, mesh, specs[k])
        out["leaves"][k] = (_sq_dist(torch, local[k], want),
                            _sq_dist(torch, want),
                            tuple(want.shape) != tuple(g.shape))
    if ref_picks:
        n = config.n_layers
        out["router_differ_by_layer"] = [
            int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
            for (a, _), (b, _) in zip(ref_picks[:n], picks[:n])]
        out["router"] = _flips(torch, ref_picks, picks, config)
    return out


def _packed_batch(config, batch: int, seq: int, seed: int) -> dict:
    """A packed batch of ``batch`` rows of ``seq`` tokens from ``seed``:
    three documents a row, the middle one across the middle of the row
    (so across the cut between two ``cp`` ranks), positions restarting
    per document and a mask over the targets inside one document (the
    form ``train.data.pack_documents`` gives)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, config.vocab_size, (batch, seq + 1))
    cuts = [0, seq * 3 // 8, seq * 7 // 10, seq]
    seg = np.zeros((batch, seq), np.int64)
    pos = np.zeros((batch, seq), np.int64)
    for i in range(3):
        seg[:, cuts[i]:cuts[i + 1]] = i
        pos[:, cuts[i]:cuts[i + 1]] = np.arange(cuts[i + 1] - cuts[i])
    mask = np.concatenate([seg[:, :-1] == seg[:, 1:],
                           np.zeros((batch, 1), bool)], 1)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "segment_ids": seg, "positions": pos, "mask": mask}


def _first_step_dpo(torch, path) -> dict:
    """The first step of the DPO job at ``path`` as its sharded path
    decides it, against the same step unsharded: the weights
    ``init_params`` makes from the job's seed, both the policy and the
    frozen reference (as at ``main``'s first step), and the job's first
    ``batch`` pairs. On the rank's mesh: the reference log-probabilities
    without autograd, the loss (``make_dpo_loss_fn``), and the gradient
    of every leaf's local piece for the rank's share; then the same step
    on one process; per leaf the squared distance and squared norm
    against the same piece of the unsharded gradient (``_grad_rel``)."""
    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.parallel import collectives, sharding
    from kubedl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train import dpo
    from kubedl_tpu_torch.train.trainer import tree_leaves

    cfg = json.loads(Path(path).read_text())
    config, _ = train_main.resolve_model(cfg, device="cuda")
    fam = io.family_of(config)
    mesh = build_mesh(MeshConfig(**cfg["mesh"]), device="cuda")
    params = fam.init_params(config, torch.Generator(
        device="cuda").manual_seed(int(cfg["seed"])), device="cuda")
    rows = [json.loads(line) for line in Path(
        cfg["data"]["path"]).read_text().splitlines()][:cfg["batch"]]
    host = dpo.preference_batch([r["chosen"] for r in rows],
                                [r["rejected"] for r in rows],
                                [r["prompt_len"] for r in rows])
    dcfg = dpo.DPOConfig(**cfg.get("dpo", {}))

    def share(p, batch, m):
        local = {k: sharding.local_of(v) for k, v in batch.items()}
        local["ref_chosen_logps"], local["ref_rejected_logps"] = \
            dpo.reference_logps_fn(config, p, m)(local)   # no autograd
        return dpo.make_dpo_loss_fn(config, dcfg, mesh=m)(p, local)

    placed = sharding.shard_tree(params, mesh, fam.param_specs(config))
    specs = {k: sharding.spec_of(p.placements)
             for k, p in tree_leaves(placed)}
    view = sharding.views(placed, mesh, requires_grad=True)
    leaves = tree_leaves(view)
    mine = share(view, tdata.shard_batch(host, mesh), mesh)
    grads = torch.autograd.grad(mine, [getattr(p, "local", p)
                                       for _, p in leaves])
    loss = float(collectives.world_sum(mine.detach()))
    local = {k: g for (k, _), g in zip(leaves, grads)}
    del view, leaves, grads, placed, mine
    gc.collect()
    torch.cuda.empty_cache()
    ref_leaves = [(k, t.requires_grad_()) for k, t in tree_leaves(params)]
    ref_loss = share(params, tdata.to_device(host, torch.device("cuda")),
                     None)
    ref_grads = torch.autograd.grad(ref_loss, [t for _, t in ref_leaves])
    _reset_counts(attn)            # the checks launched K1-K3 too
    out = {"loss": loss, "ref_loss": float(ref_loss.detach()), "leaves": {}}
    for (k, _), g in zip(ref_leaves, ref_grads):
        want = sharding.local_shard(g, mesh, specs[k])
        out["leaves"][k] = (_sq_dist(torch, local[k], want),
                            _sq_dist(torch, want),
                            tuple(want.shape) != tuple(g.shape))
    return out


def _grad_rel(readings) -> tuple:
    """(norm-wise relative error of the whole gradient tree, worst leaf,
    its error) from the ranks' ``_first_step`` pieces: a sharded leaf's
    pieces summed over the ranks, a replicated leaf's taken once."""
    num = den = 0.0
    worst = ("", 0.0)
    for k, (d, n, sharded) in readings[0]["leaves"].items():
        if sharded:
            d = sum(r["leaves"][k][0] for r in readings)
            n = sum(r["leaves"][k][1] for r in readings)
        num, den = num + d, den + n
        rel = math.sqrt(d / n) if n else math.sqrt(d)
        if rel > worst[1]:
            worst = (k, rel)
    return math.sqrt(num / den), worst[0], worst[1]


def _main_readings(torch, path) -> dict:
    """``python -m kubedl_tpu_torch.train``'s ``main`` on the config at
    ``path`` in this process, the kernels' counts set to 0 just before
    the run and read just after: rc, the losses by step, the launches by
    kernel and route, what ``evaluate.perplexity`` and
    ``evaluate.loglikelihood_ranks`` returned (``mode: evaluate``), the
    exchanges staged through the host, peak memory and step times."""
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.parallel import collectives
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train import evaluate

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks, results = [], {}

    def recording(name, fn):
        def run(*a, **kw):
            results[name] = fn(*a, **kw)
            return results[name]
        return run
    _reset_counts(attn)
    collectives.ring_shift.host_staged = 0
    collectives.pp_shift.host_staged = 0
    t0 = time.perf_counter()
    with unittest.mock.patch.object(
            evaluate, "perplexity",
            recording("perplexity", evaluate.perplexity)), \
            unittest.mock.patch.object(
                evaluate, "loglikelihood_ranks",
                recording("choices", evaluate.loglikelihood_ranks)):
        rc = train_main.main(["--config", path],
                             on_step=lambda step, loss: marks.append(
                                 (time.perf_counter(), step, loss)))
    torch.cuda.synchronize()
    steady = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    return {
        "rc": rc, "losses": [m[2] for m in marks], "results": results,
        "launches": {fn.__name__: fn.launches for fn in (
            attn.flash_forward, attn.flash_dq, attn.flash_dkv)},
        "by_route": {fn.__name__: dict(fn.launches_by_route)
                     for fn in (attn.flash_forward, attn.flash_dq,
                                attn.flash_dkv)},
        "host_staged": collectives.ring_shift.host_staged,
        "pp_staged": collectives.pp_shift.host_staged,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "first_step_s": marks[0][0] - t0 if marks else None,
        "step_s": sum(steady) / len(steady) if steady else None,
        "step_times": [round(x, 4) for x in steady]}


def _mesh_rank(rank, port, jobs, queue):
    """One of two ranks on ``cuda:0`` under a gloo group (NCCL refuses two
    ranks on one device): ``python -m kubedl_tpu_torch.train``'s ``main``
    on each ``(tag, config path)`` of ``jobs`` over the open group
    (``_main_readings``), and for a training or DPO job its first step
    against the same step unsharded; a ``packed`` job (``_packed_batch``)
    takes its first step only. Puts ``(rank, {tag: readings})`` or
    ``(rank, traceback)`` on ``queue``."""
    import traceback
    from datetime import timedelta

    try:
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank,
                                timeout=timedelta(seconds=MESH_TIMEOUT_S))
        res = {}
        for tag, path in jobs:
            cfg = json.loads(Path(path).read_text())
            if cfg.get("packed"):
                res[tag] = {"first_step": _first_step(torch, path)}
                continue
            res[tag] = _main_readings(torch, path)
            gc.collect()
            torch.cuda.empty_cache()
            mode = cfg.get("mode", "pretrain")
            if mode == "evaluate":
                continue
            pipelined = cfg["mesh"].get("pp", 1) > 1
            res[tag]["first_step"] = (
                _first_step_dpo if mode == "dpo" else _first_step_pp
                if pipelined else _first_step)(torch, path)
            gc.collect()
            torch.cuda.empty_cache()
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, traceback.format_exc()))


def _two_ranks(torch, tag, jobs) -> dict:
    """``_mesh_rank`` in two processes on the one card; {rank: results}.
    A rank that fails fails the phase at once (the other is killed)."""
    import torch.multiprocessing as tmp

    gc.collect()
    torch.cuda.empty_cache()
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_mesh_rank, daemon=True,
                         args=(r, port, jobs, queue)) for r in range(2)]
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < 2:
            rank, value = queue.get(timeout=MESH_TIMEOUT_S)
            if isinstance(value, str):
                raise AssertionError(f"[{tag}] rank {rank} failed:\n{value}")
            res[rank] = value
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(10)
    return res


def _hold_mesh_run(tag, job, res, ref, n_layers, cp) -> tuple:
    """Both ranks' readings of ``job`` against the unsharded run ``ref``,
    logged, and what fails: rc 0, every K1-K3 launch on ``sm90`` at the
    counts the path gives (K1 2*L per step with remat, K2/K3 L, each
    times ``cp`` on the ring), the same losses on both ranks, and
    ``MESH_BOUNDS[tag]`` on the loss gap and on rank 0's first-step
    readings (``_first_step``). Returns (readings, failures)."""
    runs = [res[r][job] for r in (0, 1)]
    bounds = MESH_BOUNDS[tag]
    first = dict(runs[0]["first_step"])
    first["grad_rel"], first["worst_leaf"], first["worst_leaf_rel"] = \
        _grad_rel([run["first_step"] for run in runs])
    del first["leaves"]
    steps = len(ref["losses"])
    want = {"flash_forward": 2 * n_layers * steps * cp,
            "flash_dq": n_layers * steps * cp,
            "flash_dkv": n_layers * steps * cp}
    bad = []
    for r, run in enumerate(runs):
        if run["rc"] != 0 or len(run["losses"]) != steps:
            bad.append(f"rank {r}: rc {run['rc']} after "
                       f"{len(run['losses'])} steps")
        if run["launches"] != want or any(
                c["simt"] for c in run["by_route"].values()):
            bad.append(f"rank {r}: launched {run['by_route']}, want {want} "
                       f"on sm90")
    if runs[0]["losses"] != runs[1]["losses"]:
        bad.append(f"the ranks' losses differ: {runs[0]['losses']} / "
                   f"{runs[1]['losses']}")
    gap = max(abs(a - b) for a, b in zip(runs[0]["losses"], ref["losses"]))
    for key, got in (("loss_gap", gap), ("hidden_rel", first["hidden_rel"]),
                     ("grad_rel", first["grad_rel"])):
        if not got <= bounds[key]:
            bad.append(f"{key} {got} > {bounds[key]}")
    if "router" in first and (first["router_differ_by_layer"][0]
                              or first["router"]["unexplained"]):
        bad.append("the router chose other experts on layer 0's inputs, "
                   "which are the unsharded run's, or away from a near-tie "
                   f"and from any earlier flip: by layer "
                   f"{first['router_differ_by_layer']}, {first['router']}")
    log(f"[{tag}] {job}: losses {[round(x, 5) for x in runs[0]['losses']]} "
        f"against the unsharded {[round(x, 5) for x in ref['losses']]} "
        f"(max gap {gap}, limit {bounds['loss_gap']}); launches per rank "
        f"{runs[0]['launches']}")
    log(f"[{tag}] {job} first step against the same step unsharded: loss "
        f"{first['loss']} / {first['ref_loss']}; final hidden states "
        f"norm-wise {first['hidden_rel']:.4e} (limit "
        f"{bounds['hidden_rel']}), least cosine by position "
        f"{first['hidden_min_cos']:.6f}; gradients norm-wise "
        f"{first['grad_rel']:.4e} (limit {bounds['grad_rel']}), worst leaf "
        f"{first['worst_leaf']} {first['worst_leaf_rel']:.4e}")
    if "router" in first:
        log(f"[{tag}] {job} router choices differing from the unsharded "
            f"step by layer {first['router_differ_by_layer']} of "
            f"{first['router']['tokens'] // n_layers} tokens a layer; "
            f"{first['router']}")
    for r, run in enumerate(runs):
        log(f"[{tag}] {job} rank {r}: step {run['step_s']:.4f} s (per step "
            f"{run['step_times']}; both ranks share the one card and every "
            f"collective goes through the host), first step "
            f"{run['first_step_s']:.3f} s, peak device memory "
            f"{run['peak_gib']:.2f} GiB, ring shifts staged through the "
            f"host {run['host_staged']}")
    return {"losses": runs[0]["losses"], "loss_gap": gap,
            "first_step": first,
            "launches": runs[0]["launches"],
            "launches_by_rank": [run["launches"] for run in runs],
            "step_s": [run["step_s"] for run in runs],
            "peak_gib": [run["peak_gib"] for run in runs],
            "host_staged": [run["host_staged"] for run in runs]}, \
        [f"[{tag}] {job}: {b}" for b in bad]


#: [cp2]'s evaluate and DPO jobs at Llama-3-8B width, CP2_LAYERS deep:
#: perplexity over the training job's 2 x 4096 tokens; CP2_MC_ROWS
#: multiple-choice questions of a 100-token prompt and 4 options of 3-12
#: tokens (padded to 128, so 64 columns a rank); CP2_DPO_PAIRS pairs of a
#: 120-token prompt and 80 / 60 completion tokens (padded to 256),
#: CP2_DPO_STEPS steps (the first at the warmup's learning rate 0)
CP2_MC_ROWS, CP2_DPO_PAIRS, CP2_DPO_STEPS = 4, 2, 3


def _cp2_mode_configs(tokens) -> dict:
    """{(mode tag, impl or None): config path} of [cp2]'s evaluate and DPO
    jobs, unsharded (impl None) and over ``cp=2`` with each ``cp_impl``;
    the data files they read (a few KB) under ``BUILD_OUT``."""
    import numpy as np
    rng = np.random.default_rng(23)
    mc = BUILD_OUT / "cp2_choices.jsonl"
    mc.write_text("\n".join(json.dumps({
        "prompt": rng.integers(3, 128256, 100).tolist(),
        "options": [rng.integers(3, 128256, int(n)).tolist()
                    for n in rng.integers(3, 13, 4)]})
        for _ in range(CP2_MC_ROWS)))
    pairs = BUILD_OUT / "cp2_pairs.jsonl"
    rows = []
    for _ in range(CP2_DPO_PAIRS):
        prompt = rng.integers(3, 128256, 120).tolist()
        rows.append({"chosen": prompt + rng.integers(3, 128256, 80).tolist(),
                     "rejected": prompt + rng.integers(3, 128256,
                                                       60).tolist(),
                     "prompt_len": 120})
    pairs.write_text("\n".join(json.dumps(r) for r in rows))
    jobs = {"evaluate": {"mode": "evaluate", "batch": 2, "seq": CP2_SEQ,
                         "steps": 1,
                         "data": {"kind": "tokens", "path": tokens}},
            "choices": {"mode": "evaluate",
                        "data": {"kind": "eval_jsonl", "path": str(mc)}},
            "dpo": {"mode": "dpo", "batch": CP2_DPO_PAIRS,
                    "steps": CP2_DPO_STEPS,
                    "data": {"kind": "dpo_jsonl", "path": str(pairs)}}}
    out = {}
    for tag, job in jobs.items():
        for impl in (None, "ring", "ulysses"):
            over = {"n_layers": CP2_LAYERS}
            extra = {}
            if impl:
                over["cp_impl"] = impl
                extra["mesh"] = {"cp": 2}
            name = f"cp2_{tag}_{impl or 'ref'}"
            cfg = {"model": "llama.llama3_8b", "model_overrides": over,
                   "seed": 0, "optimizer": {"warmup_steps": 1},
                   "log_every": 1, **job, **extra}
            path = BUILD_OUT / f"{name}.json"
            path.write_text(json.dumps(cfg))
            out[(tag, impl)] = str(path)
    return out


def _hold_mesh_mode(tag, job, res, ref, factor) -> tuple:
    """Both ranks' ``evaluate`` or ``dpo`` run of ``job`` over ``cp=2``
    against the same job unsharded (``ref``): rc 0; every K1-K3 launch on
    ``sm90``, ``factor`` times the unsharded run's (``cp`` on the ring,
    where every block of keys is one launch; 1 through Ulysses); both
    ranks alike; and within ``MESH_BOUNDS[tag]``: perplexity's NLL and
    DPO's losses (the first ln 2: the policy starts as its reference) by
    ``loss_gap``, each option's log-probability per token of the option
    by ``logp_gap`` (the choices are reported); DPO's first-step
    gradients (``_first_step_dpo``) by ``grad_rel``. Returns (readings,
    failures)."""
    runs = [res[r][job] for r in (0, 1)]
    bound = MESH_BOUNDS[tag]["logp_gap" if "choices" in ref["results"]
                             else "loss_gap"]
    want = {k: n * factor for k, n in ref["launches"].items()}
    bad = []
    for r, run in enumerate(runs):
        if run["rc"] != 0:
            bad.append(f"rank {r}: rc {run['rc']}")
        if run["launches"] != want or any(
                c["simt"] for c in run["by_route"].values()):
            bad.append(f"rank {r}: launched {run['by_route']}, want {want} "
                       f"on sm90")
    got, base = runs[0]["results"], ref["results"]
    out = {"launches": runs[0]["launches"],
           "launches_by_rank": [run["launches"] for run in runs]}
    if "perplexity" in base:
        g, w = got["perplexity"], base["perplexity"]
        out.update(nll=g["nll"], ref_nll=w["nll"], tokens=g["tokens"],
                   gap=abs(g["nll"] - w["nll"]))
        if g["tokens"] != w["tokens"] or \
                runs[1]["results"]["perplexity"] != g:
            bad.append(f"tokens {g['tokens']} / {w['tokens']}, or the ranks "
                       "differ")
        what = (f"perplexity NLL {g['nll']:.6f} against the unsharded "
                f"{w['nll']:.6f} over {g['tokens']} tokens")
    elif "choices" in base:
        rows = [json.loads(line) for line in Path(json.loads(Path(
            res[0][job]["path"]).read_text())["data"]["path"])
            .read_text().splitlines()]
        lens = [len(o) for row in rows for o in row["options"]]
        g = [x for q in got["choices"] for x in q["logps"]]
        w = [x for q in base["choices"] for x in q["logps"]]
        out.update(logps=g, ref_logps=w,
                   gap=max(abs(a - b) / n for a, b, n in zip(g, w, lens)),
                   same_choices=sum(a["choice"] == b["choice"] for a, b in
                                    zip(got["choices"], base["choices"])))
        if runs[1]["results"]["choices"] != got["choices"]:
            bad.append("the ranks' choices differ")
        what = (f"{len(g)} option log-probabilities, largest gap per option "
                f"token {out['gap']:.3e}; choices equal to the unsharded "
                f"run's for {out['same_choices']}/{len(rows)} questions")
    else:
        g, w = runs[0]["losses"], ref["losses"]
        first = runs[0]["first_step"]
        grad_rel, worst, worst_rel = _grad_rel([run["first_step"]
                                                for run in runs])
        out.update(losses=g, ref_losses=w,
                   gap=max(abs(a - b) for a, b in zip(g, w)),
                   grad_rel=grad_rel, worst_leaf=worst,
                   worst_leaf_rel=worst_rel)
        if len(g) != len(w) or runs[1]["losses"] != g or \
                abs(g[0] - math.log(2)) > 1e-6 or \
                abs(first["loss"] - math.log(2)) > 1e-6:
            bad.append(f"losses {g} / {runs[1]['losses']}, first step "
                       f"{first['loss']}, want {len(w)} alike on both "
                       "ranks, the first ln 2")
        if not grad_rel <= MESH_BOUNDS[tag]["grad_rel"]:
            bad.append(f"grad_rel {grad_rel} > "
                       f"{MESH_BOUNDS[tag]['grad_rel']}")
        what = (f"losses {[round(x, 6) for x in g]} against the unsharded "
                f"{[round(x, 6) for x in w]}; the first step's gradients "
                f"norm-wise {grad_rel:.4e} (limit "
                f"{MESH_BOUNDS[tag]['grad_rel']}), worst leaf {worst} "
                f"{worst_rel:.4e}")
    if not out["gap"] <= bound:
        bad.append(f"gap {out['gap']} > {bound}")
    log(f"[{tag}] {job}: {what} (gap {out['gap']:.3e}, limit {bound}); "
        f"K1-K3 launches per rank {runs[0]['launches']} ({factor}x the "
        f"unsharded run's {ref['launches']}), all sm90")
    return out, [f"[{tag}] {job}: {b}" for b in bad]


#: [cp2]'s packed Gemma-2 step: Gemma-2-2B width (8 query heads over 4
#: KV heads of width 256, softcaps, query scale 256, sandwich norms, the
#: alternate window) cut to 2 layers and its window to 1024 tokens, so
#: the even layer's window cuts into the other rank's rows; one packed
#: row of 4096 tokens (``_packed_batch``), first step only, on the ring
#: setting at cp=2 (the knobs' chunked path at global offsets)
CP2_GEMMA2 = {"model": "gemma.gemma2_2b",
              "model_overrides": {"n_layers": 2, "sliding_window": 1024,
                                  "loss_chunk": 512},
              "mesh": {"cp": 2}, "seed": 0, "batch": 1, "seq": 4096,
              "packed": True}


def _hold_packed_step(tag, job, res) -> tuple:
    """Both ranks' first step of the packed ``job`` against the same step
    unsharded (``_first_step``), held to ``MESH_BOUNDS[tag]``: the loss
    gap, the final hidden states and the whole gradient, norm-wise.
    Returns (readings, failures)."""
    bounds = MESH_BOUNDS[tag]
    first = dict(res[0][job]["first_step"])
    first["grad_rel"], first["worst_leaf"], first["worst_leaf_rel"] = \
        _grad_rel([res[r][job]["first_step"] for r in (0, 1)])
    del first["leaves"]
    first["loss_gap"] = abs(first["loss"] - first["ref_loss"])
    bad = [f"[{tag}] {job}: {key} {first[key]} > {bounds[key]}"
           for key in ("loss_gap", "hidden_rel", "grad_rel")
           if not first[key] <= bounds[key]]
    log(f"[{tag}] {job} first step against the same step unsharded: loss "
        f"{first['loss']} / {first['ref_loss']} (gap {first['loss_gap']:.3e},"
        f" limit {bounds['loss_gap']}); final hidden states norm-wise "
        f"{first['hidden_rel']:.4e} (limit {bounds['hidden_rel']}), least "
        f"cosine by position {first['hidden_min_cos']:.6f}; gradients "
        f"norm-wise {first['grad_rel']:.4e} (limit {bounds['grad_rel']}), "
        f"worst leaf {first['worst_leaf']} {first['worst_leaf_rel']:.4e}")
    return first, bad


def phase_cp2(torch) -> dict:
    """Context parallelism at cp=2 on the one card: ``python -m
    kubedl_tpu_torch.train``'s ``main`` on Llama-3-8B at full width, 2
    layers deep, one global batch of 2 x 4096 tokens (each rank b=2 x
    2048), 3 steps, under ``"mesh": {"cp": 2}`` in two processes over
    gloo: once on the ring (K1-K3 at global offsets, the K/V blocks
    shifted through the host: gloo's point-to-point calls take host
    memory only) and once with ``cp_impl: "ulysses"`` (two all-to-alls a
    layer). Each run against the same job unsharded on one process:
    every K1-K3 launch on ``sm90``, the losses, and the first step's
    hidden states and gradients (``_hold_mesh_run``); each rank's step
    time and peak memory. Both runs are read before either fails. In the
    same two ranks, a packed Gemma-2 first step (``CP2_GEMMA2``) on the
    ring setting against one process (``_hold_packed_step``)."""
    over = {"n_layers": CP2_LAYERS}
    path, tokens, cfg = _train_config("cp2_ref", overrides=over, batch=2,
                                      steps=CP2_STEPS, seq=CP2_SEQ)
    ref = _train_run(torch, "cp2_ref", path, cfg, ALL_SM90)
    jobs = []
    for impl in ("ring", "ulysses"):
        p, _, _ = _train_config(f"cp2_{impl}", overrides={
            **over, "cp_impl": impl}, batch=2, steps=CP2_STEPS, seq=CP2_SEQ,
            mesh={"cp": 2})
        jobs.append((impl, p))
    modes = _cp2_mode_configs(tokens)
    jobs += [(f"{tag}_{impl}", p) for (tag, impl), p in modes.items()
             if impl]
    packed = BUILD_OUT / "cp2_gemma2_packed.json"
    packed.write_text(json.dumps(CP2_GEMMA2))
    jobs.append(("gemma2_packed", str(packed)))
    mode_refs = {tag: _main_readings(torch, p)
                 for (tag, impl), p in modes.items() if impl is None}
    t0 = time.perf_counter()
    res = _two_ranks(torch, "cp2", jobs)
    for r in (0, 1):
        for tag, p in jobs:
            res[r][tag]["path"] = p
    out = {"unsharded": {k: ref[k] for k in ("losses", "step_s", "peak_gib",
                                              "launches")},
           "seconds": time.perf_counter() - t0}
    out["ring"], bad = _hold_mesh_run("cp2", "ring", res, ref, CP2_LAYERS, 2)
    out["ulysses"], bad_u = _hold_mesh_run("cp2", "ulysses", res, ref,
                                           CP2_LAYERS, 1)
    if min(out["ring"]["host_staged"]) == 0:
        bad.append("[cp2] the ring shifted no block")
    for tag, mode_ref in mode_refs.items():
        if mode_ref["rc"] != 0:
            bad.append(f"[cp2] the unsharded {tag} job returned "
                       f"{mode_ref['rc']}")
        for impl, factor in (("ring", 2), ("ulysses", 1)):
            out[f"{tag}_{impl}"], more = _hold_mesh_mode(
                "cp2", f"{tag}_{impl}", res, mode_ref, factor)
            bad += more
    out["gemma2_packed"], more = _hold_packed_step(
        "cp2", "gemma2_packed", res)
    bad += more
    log(f"[cp2] unsharded: step {ref['step_s']:.4f} s, peak "
        f"{ref['peak_gib']:.2f} GiB; the two ranks ran in "
        f"{out['seconds']:.1f} s ({_card()})")
    if bad + bad_u:
        raise AssertionError("; ".join(bad + bad_u))
    return out


#: [ep2]'s serving run: Mixtral width at MOE_TRAIN_LAYERS layers in
#: float32 (seed 0), 4 greedy requests of these prompt lengths (seed 29),
#: EP2_NEW tokens each, on one lane each
EP2_LENS, EP2_NEW, EP2_MAX_LEN = (31, 97, 128, 64), 16, 256


def _ep2_serve_rank(rank, port, model, queue):
    """One rank of ``[ep2]``'s serving run on ``cuda:0``: a gloo group over
    the two processes, the serving mesh at ep=2, and
    ``ContinuousBatchingEngine(mesh=...)`` over the parent's weights
    (CUDA IPC; each rank copies its 4 of the 8 experts of every stack):
    rank 0 schedules the requests, rank 1 follows. Puts ``(rank, row)``
    or ``(rank, traceback)`` on ``queue``."""
    import traceback
    from datetime import timedelta

    try:
        import torch
        import torch.distributed as dist

        from kubedl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
        from kubedl_tpu_torch.serving import ContinuousBatchingEngine

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank,
                                timeout=timedelta(seconds=MESH_TIMEOUT_S))
        mesh = build_mesh(MeshConfig(fsdp=1, ep=2), device="cuda:0")
        cfg, params, reqs = model.pop("moe")
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        eng = ContinuousBatchingEngine(cfg, params, lanes=len(reqs),
                                       max_len=EP2_MAX_LEN, mesh=mesh,
                                       device="cuda:0")
        del params
        row = {"route": eng._tick_p.route,
               "experts": tuple(eng.params["layers"]["w_gate"].shape)}
        if eng._channel.leader:
            t0 = time.perf_counter()
            row["tokens"] = eng.run(reqs)
            row["seconds"] = time.perf_counter() - t0
            row["ticks"] = eng.tick_launches
            eng.stop()
        else:
            row["followed"] = eng.follow()
        torch.cuda.synchronize()
        row["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
        del eng
        gc.collect()
        dist.destroy_process_group()
        queue.put((rank, row))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, traceback.format_exc()))


def _ep2_serving(torch) -> dict:
    """The continuous engine over ``ep=2`` on the one card: Mixtral width
    at ``MOE_TRAIN_LAYERS`` layers in float32, served by one process, then
    by two gloo processes on ``cuda:0`` sharing the weights (the tick's
    ``ep_sum`` runs eagerly on gloo); the two-rank tokens must equal the
    one-process engine's (float32: only the order of the experts' partial
    sums differs), each rank must hold 4 of the 8 experts."""
    import dataclasses

    import numpy as np
    import torch.multiprocessing as tmp

    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine

    cfg = dataclasses.replace(moe.mixtral_8x7b(), n_layers=MOE_TRAIN_LAYERS,
                              dtype=torch.float32)
    params = moe.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), device="cuda")
    rng = np.random.default_rng(29)
    reqs = [(rng.integers(3, cfg.vocab_size, n).tolist(), EP2_NEW)
            for n in EP2_LENS]
    one = ContinuousBatchingEngine(cfg, params, lanes=len(reqs),
                                   max_len=EP2_MAX_LEN, device="cuda")
    t0 = time.perf_counter()
    want = one.run(reqs)
    one_s = time.perf_counter() - t0
    one.stop()
    del one
    gc.collect()
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    model = {"moe": (cfg, params, reqs)}
    procs = [ctx.Process(target=_ep2_serve_rank, daemon=True,
                         args=(r, port, model, queue)) for r in range(2)]
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < 2:
            rank, value = queue.get(timeout=MESH_TIMEOUT_S)
            res[rank] = value
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(10)
        del model, params
        gc.collect()
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    for rank, value in res.items():
        if isinstance(value, str):
            raise AssertionError(f"[ep2] serving rank {rank} failed:\n"
                                 f"{value}")
    lead = res[0]
    out = {"seconds": wall, "one_process_s": one_s,
           "served_s": lead["seconds"], "ticks": lead["ticks"],
           "followed": res[1]["followed"],
           "experts_by_rank": [res[r]["experts"][1] for r in (0, 1)],
           "peak_gib": [res[r]["peak_gib"] for r in (0, 1)],
           "identical": sum(a == b for a, b in zip(lead["tokens"], want))}
    log(f"[ep2] serving Mixtral width, {MOE_TRAIN_LAYERS} layers float32, "
        f"{len(reqs)} requests of {EP2_NEW} tokens over ep=2: "
        f"{out['identical']}/{len(reqs)} identical to the one-process "
        f"engine's; {lead['seconds']:.2f} s on 2 ranks (ticks "
        f"{lead['ticks']}, rank 1 followed {out['followed']} steps) "
        f"against {one_s:.2f} s on one; experts a rank "
        f"{out['experts_by_rank']} of {cfg.n_experts}; peak "
        f"{[round(x, 2) for x in out['peak_gib']]} GiB by rank; phase "
        f"part {wall:.1f} s")
    if lead["tokens"] != want or out["experts_by_rank"] != [
            cfg.n_experts // 2] * 2 or {res[r]["route"] for r in (0, 1)} \
            != {"eager"} or not out["followed"]:
        raise AssertionError(f"[ep2] serving over ep=2: {out}, routes "
                             f"{[res[r]['route'] for r in (0, 1)]}")
    return out


def phase_ep2(torch, mtrain) -> dict:
    """Expert parallelism at ep=2 on the one card: the moe_training
    phase's job (Mixtral-8x7B at full width, ``MOE_TRAIN_LAYERS`` layers,
    b=2 x 2048, 3 steps on one repeated batch) under ``"mesh": {"ep":
    2}`` in two processes over gloo, each rank holding 4 of the 8 experts
    of every layer; against that phase's unsharded run and the same first
    step on one process (``_hold_mesh_run``): every K1-K3 launch on
    ``sm90``, the losses, the hidden states, the gradients, and the
    router's choices by layer: layer 0's inputs are the unsharded run's,
    so it must choose alike, and a later layer may differ only at a
    near-tie or after a flip (``_flips``), since each rank's bf16 partial
    sum of its experts' outputs rounds otherwise than one einsum over 8;
    each rank's step time and peak memory."""
    path, _, _ = _train_config(
        "ep2", model="moe.mixtral_8x7b", vocab=32000,
        overrides={"n_layers": MOE_TRAIN_LAYERS}, batch=2, steps=3,
        mesh={"ep": 2})
    t0 = time.perf_counter()
    res = _two_ranks(torch, "ep2", [("ep", path)])
    out = {"seconds": time.perf_counter() - t0,
           "unsharded": {k: mtrain[k] for k in ("losses", "step_s",
                                                 "peak_gib")}}
    out["ep"], bad = _hold_mesh_run("ep2", "ep", res, mtrain,
                                    MOE_TRAIN_LAYERS, 1)
    log(f"[ep2] unsharded: step {mtrain['step_s']:.4f} s, peak "
        f"{mtrain['peak_gib']:.2f} GiB; the two ranks ran in "
        f"{out['seconds']:.1f} s")
    if bad:
        raise AssertionError("; ".join(bad))
    out["serving"] = _ep2_serving(torch)
    return out


# -- slice 14: pipeline parallelism, GRPO and the RL learner ------------------

#: [pp]: the training cell's configuration (Llama-3-8B width, 8 layers, b=4
#: x 2048, bf16, remat) in PP_STAGES stages held by one process, PP_MICRO
#: microbatches
PP_STAGES, PP_MICRO = 4, 4
#: K1-K3 at [pp]'s microbatch shape: one row of Llama's training shape
PP_MICRO_CASE = {**TRAIN, "b": TRAIN["b"] // PP_MICRO}
#: the pipelines against the flat step on the same weights (GPipe) and
#: against GPipe (1F1B): the loss gap and the norm-wise relative error of
#: the whole gradient tree. The microbatches' matmuls (a quarter of the
#: rows) round otherwise in bf16, and the stages' gradients add up over
#: the microbatches in float32 before one bf16 rounding, so a few bf16
#: ulps apart; a pipeline that drops or misroutes a stage reads ~1
PP_BOUNDS = {"loss_gap": 5e-3, "grad_rel": 5e-2}
#: [pp2]: two ranks at pp=2 over gloo, 2 layers, 3 steps, num_micro 2
PP2_LAYERS, PP2_STEPS, PP2_MICRO = 2, 3, 2
#: [grpo]: Gemma-2B at full size through the train entry's ``main`` in
#: ``mode: grpo``: rounds, steps a round, prompts a round, the group and
#: the completion length
GRPO_ROUNDS, GRPO_STEPS, GRPO_PROMPTS, GRPO_GROUP, GRPO_NEW = 2, 2, 2, 4, 32
#: the on-policy identity: at a round's first step the policy's own
#: ``token_logps`` of the rollout over the engine's behavior logprobs
#: average to 1 within the bf16 rule (BF16_LOSS_ULPS ulps at 1.0)
GRPO_RATIO_TOL = BF16_LOSS_ULPS * 2.0 ** -7
#: the learner's model: Llama-3's head width on a small body, its train
#: state well under 1 GB (each of the two checkpoint tiers holds a copy)
FLYWHEEL_CFG = dict(vocab_size=32000, d_model=512, n_layers=2, n_heads=4,
                    n_kv_heads=4, d_ff=1536)


#: [replay]: the flywheel day's learner: ``FLYWHEEL_CFG``'s body and head
#: width (K1-K3 on ``sm90`` at hd 128, bf16) at vocab 8192, so the day's
#: six copies of the train state (two publishes and the resize save, each
#: in both checkpoint tiers) write ~0.73 GB (~1.9 GB at vocab 32000)
REPLAY_RL_CFG = {**FLYWHEEL_CFG, "vocab_size": 8192}
#: the fleet smoke profile of the JAX package's fleet tests at its
#: 60-request, 120 s day, with the disaggregated leg's overrides
REPLAY_FLEET = dict(sim_seconds=120.0, requests=60, bursts=10, replicas=2,
                    max_replicas=2, decode_lanes=6, prefill_lanes=1,
                    pool_blocks=100, prefixes=10, max_prefixes_per_replica=5,
                    zipf_s=0.7, long_prompt_frac=0.5, prefix_share=0.35)
#: the job of the JAX package's ``test_flywheel_replay_small_profile``
REPLAY_RL_SPEC = dict(total_batches=4, publish_every=2,
                      resize_after_batches=3, gen_interval_s=5.0,
                      max_new_tokens=4)
#: the ``rl`` fields that depend on the sampled tokens
REPLAY_SAMPLED = ("losses",)
#: the multi-model smoke profile of the JAX package's multi-model tests at
#: its determinism test's 60-request, 120 s day: 2 replicas of 4 decode
#: lanes (its 1 prefill lane is reserved only when disaggregated), 64-block
#: pools, 6 adapters of 2 pages, at most 2 resident a replica
REPLAY_MM = dict(sim_seconds=120.0, requests=60, bursts=6, replicas=2,
                 max_replicas=2, decode_lanes=4, prefill_lanes=1,
                 pool_blocks=64, prefixes=6, max_prefixes_per_replica=4,
                 zipf_s=0.7, adapters=6, adapter_pages=2, adapter_share=0.7,
                 max_adapters_per_replica=2, adapter_fault_page_s=0.03)


def _nested(pairs) -> dict:
    """The tree of ``[(path, tensor)]`` (``train.trainer.tree_leaves``'s
    ``/``-joined paths)."""
    tree = {}
    for path, t in pairs:
        node = tree
        *up, last = path.split("/")
        for key in up:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def _tree_rel(torch, got, want) -> tuple:
    """(norm-wise relative error of a whole gradient tree, worst leaf, its
    error); ``got``/``want`` map leaf names to tensors of one shape."""
    num = den = 0.0
    worst = ("", 0.0)
    for k, w in want.items():
        d, n = _sq_dist(torch, got[k], w), _sq_dist(torch, w)
        num, den = num + d, den + n
        rel = math.sqrt(d / n) if n else math.sqrt(d)
        if rel > worst[1]:
            worst = (k, rel)
    return math.sqrt(num / den), worst[0], worst[1]


def _pp_layer(torch, llama, config):
    """The layer a stage runs, as the train entry's pipeline runs it:
    ``llama._layer_forward`` under ``torch.utils.checkpoint`` when autograd
    records (``config.remat``)."""
    from torch.utils.checkpoint import checkpoint

    def layer(x, lp, cos, sin):
        if config.remat and torch.is_grad_enabled():
            return checkpoint(llama._layer_forward, config, x, lp, cos, sin,
                              None, use_reentrant=False)
        return llama._layer_forward(config, x, lp, cos, sin, None)
    return layer


def phase_pp(torch) -> dict:
    """Pipeline parallelism at pp=``PP_STAGES`` in one process
    (``parallel.pipeline.local_stages``: every stage's slots in the order
    the ranks run them, the neighbor exchange a shift of the list) on the
    training cell's configuration: the flat step (loss and every
    gradient), the train entry's GPipe loss (``build_pp_pretrain``) on the
    same weights and batch in ``PP_MICRO`` microbatches, and
    ``pipeline_grads_1f1b`` on the same batch, held to ``PP_BOUNDS``
    (GPipe against the flat step, 1F1B against GPipe). Each run's K1-K3
    launches (all ``sm90``, at the counts the schedule gives), its time
    (two runs after the checked one) and its peak device memory above the
    weights; by stage the schedule's ``max_inflight`` beside the
    stash's measured peak, for GPipe and 1F1B. Then K1-K3 at the
    microbatch shape against their plain versions, timed beside their
    bound and SDPA."""
    import numpy as np

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.parallel import pipeline as pipe
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train.trainer import tree_leaves

    _, tokens, cfg = _train_config("pp")
    config, _ = train_main.resolve_model(cfg, device="cuda")
    L, S, M = config.n_layers, PP_STAGES, PP_MICRO
    params = llama.init_params(config, torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    row = np.fromfile(tokens, dtype=np.int32).reshape(cfg["batch"],
                                                      cfg["seq"] + 1)
    toks = torch.as_tensor(row.astype(np.int64), device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    log(f"[pp] {cfg['model']} {L} layers ({config.num_params / 1e9:.3f} B "
        f"params), b={cfg['batch']} s={cfg['seq']}, {S} stages of "
        f"{L // S} layers in one process, {M} microbatches, remat "
        f"{config.remat}, loss_chunk {config.loss_chunk}")

    def leaves(tree):
        """Autograd leaves aliasing ``tree``'s storage."""
        return [(k, t.detach().requires_grad_(True))
                for k, t in tree_leaves(tree)]

    flat = leaves(params)
    loss_stats = {}
    real_apply = pipe.pipeline_apply

    def gpipe_apply(*args, **kw):
        return real_apply(*args, stats=loss_stats, **kw)
    with unittest.mock.patch.object(pipe, "pipeline_apply", gpipe_apply):
        loss_fn, to_pp, _, _ = train_main.build_pp_pretrain(
            config, None, M, stages=pipe.local_stages(S))
    staged = leaves(to_pp(params))
    head_keys = ["final_norm", "lm_head"]     # what the loss reads
    layer = _pp_layer(torch, llama, config)
    f1b_stats = {}

    def flat_step():
        loss = llama.loss_fn(config, _nested(flat), batch["tokens"],
                             batch["targets"])
        return loss.detach(), torch.autograd.grad(loss,
                                                  [t for _, t in flat])

    def gpipe_step():
        loss = loss_fn(_nested(staged), batch)
        return loss.detach(), torch.autograd.grad(loss,
                                                  [t for _, t in staged])

    def f1b_step():
        tree = _nested(staged)
        with torch.no_grad():
            x = llama._embed(config, tree, batch["tokens"])
        cos, sin = llama.rope_frequencies(
            config, torch.arange(cfg["seq"], device="cuda"))

        def loss_mb(hp, y, aux):
            h = llama.rms_norm(y, hp["final_norm"], config.rms_eps,
                               config.norm_weight_offset)
            return llama.lm_loss(config, h, hp, aux["targets"])
        return pipe.pipeline_grads_1f1b(
            pipe.local_stages(S),
            pipe.stage_scan(lambda h, lp: layer(h, lp, cos, sin)),
            tree["stages"], {k: tree[k] for k in head_keys}, x,
            {"targets": batch["targets"]}, M, loss_mb, stats=f1b_stats)

    sched = pipe.Schedule1F1B(S, M)
    want = {"flat": {"flash_forward": 2 * L, "flash_dq": L, "flash_dkv": L},
            "gpipe": {"flash_forward": 2 * L * M, "flash_dq": L * M,
                      "flash_dkv": L * M},
            # 1F1B's forward slots run the stages but the last without
            # autograd (one K1 a layer); each backward slot recomputes
            # its stage under the remat checkpoint (two)
            "1f1b": {"flash_forward": 2 * L * M + (S - 1) * L * M // S,
                     "flash_dq": L * M, "flash_dkv": L * M}}
    runs = {}
    results = {}
    for tag, fn in (("flat", flat_step), ("gpipe", gpipe_step),
                    ("1f1b", f1b_step)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_counts(attn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[tag] = fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = _read_counts(attn, f"[pp] {tag}", want[tag])
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        runs[tag] = {"launches": launches, "first_s": first,
                     "step_s": sum(times) / len(times),
                     "step_times": [round(x, 4) for x in times],
                     "peak_gib_above_weights": peak}
        log(f"[pp] {tag}: loss and gradients {runs[tag]['step_s']:.4f} s "
            f"(runs {runs[tag]['step_times']}, the checked one "
            f"{first:.3f} s), peak {peak:.2f} GiB above the weights, "
            f"launches {launches} (all sm90)")
    names = [k for k, _ in flat]
    loss_f, g_f = results["flat"]
    g_flat = dict(zip(names, g_f))
    loss_g, g_g = results["gpipe"]
    g_pipe = {k.replace("stages/", "layers/"): g.reshape(g_flat[
        k.replace("stages/", "layers/")].shape)
        for (k, _), g in zip(staged, g_g)}
    loss_1, sg_1, hg_1 = results["1f1b"]
    g_1f1b = {**{f"layers/{k}": g.reshape(g_flat[f"layers/{k}"].shape)
                 for k, g in sg_1.items()}, **hg_1}
    gap_g = abs(float(loss_g) - float(loss_f))
    gap_1 = abs(float(loss_1) - float(loss_g))
    rel_g = _tree_rel(torch, g_pipe, g_flat)
    rel_1 = _tree_rel(torch, g_1f1b, {k: g_pipe[k] for k in g_1f1b})
    del results, g_f, g_g, g_flat, g_pipe, g_1f1b, sg_1, hg_1
    gc.collect()
    torch.cuda.empty_cache()
    stash = {"gpipe": loss_stats, "1f1b": f1b_stats}
    out = {"config": {"layers": L, "stages": S, "num_micro": M,
                      "batch": cfg["batch"], "seq": cfg["seq"]},
           "runs": runs, "loss": {"flat": float(loss_f),
                                  "gpipe": float(loss_g),
                                  "1f1b": float(loss_1)},
           "loss_gap": {"gpipe_vs_flat": gap_g, "1f1b_vs_gpipe": gap_1},
           "grad_rel": {"gpipe_vs_flat": rel_g, "1f1b_vs_gpipe": rel_1},
           "max_inflight": [sched.max_inflight(s) for s in range(S)],
           "stash_peak": {k: v["stash_peak"] for k, v in stash.items()},
           "stash_peak_mib": {k: [round(b / 2**20, 2)
                                  for b in v["stash_peak_bytes"]]
                              for k, v in stash.items()}}
    log(f"[pp] losses flat {float(loss_f):.6f}, GPipe {float(loss_g):.6f}, "
        f"1F1B {float(loss_1):.6f}: gaps {gap_g:.3e} and {gap_1:.3e} "
        f"(limit {PP_BOUNDS['loss_gap']}); gradients norm-wise GPipe vs "
        f"flat {rel_g[0]:.4e} (worst {rel_g[1]} {rel_g[2]:.4e}), 1F1B vs "
        f"GPipe {rel_1[0]:.4e} (worst {rel_1[1]} {rel_1[2]:.4e}) (limit "
        f"{PP_BOUNDS['grad_rel']})")
    log(f"[pp] by stage: 1F1B max_inflight {out['max_inflight']}; stashed "
        f"microbatches at the peak GPipe {out['stash_peak']['gpipe']}, 1F1B "
        f"{out['stash_peak']['1f1b']}; their inputs (MiB) GPipe "
        f"{out['stash_peak_mib']['gpipe']}, 1F1B "
        f"{out['stash_peak_mib']['1f1b']}")
    bad = [f"{what} loss gap {gap} > {PP_BOUNDS['loss_gap']}"
           for what, gap in out["loss_gap"].items()
           if not gap <= PP_BOUNDS["loss_gap"]]
    bad += [f"{what} gradients {rel[0]} > {PP_BOUNDS['grad_rel']}"
            for what, rel in out["grad_rel"].items()
            if not rel[0] <= PP_BOUNDS["grad_rel"]]
    if out["stash_peak"]["1f1b"] != out["max_inflight"] or \
            out["stash_peak"]["gpipe"] != [M] * S:
        bad.append(f"stash peaks {out['stash_peak']} against 1F1B's "
                   f"max_inflight {out['max_inflight']} and GPipe's {M}")
    if bad:
        raise AssertionError("[pp] " + "; ".join(bad))
    del params, flat, staged
    gc.collect()
    torch.cuda.empty_cache()
    out["micro_kernels"] = _kernels_at_shape(
        torch, attn, "[pp]'s microbatch", PP_MICRO_CASE, 700, tag="pp")
    return out


def _first_step_pp(torch, path) -> dict:
    """``_first_step`` for a pipeline job: the first step as the train
    entry's pipeline runs it on this rank's stage of the pp mesh
    (``build_pp_pretrain`` on ``init_params`` from the job's seed and its
    first batch), against the same step on one process through the flat
    model: the final hidden states (the last stage holds them; their
    norm-wise error and least cosine by position are shared with the
    other stage), each leaf's gradient piece (a stage leaf's rows of the
    staged gradient; a leaf outside the stages whole, summed over pp as
    the trainer sums it), and the first loss."""
    import torch.distributed as dist

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.parallel import collectives, sharding
    from kubedl_tpu_torch.parallel import pipeline as pipe
    from kubedl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train.trainer import tree_leaves

    cfg = json.loads(Path(path).read_text())
    config, _ = train_main.resolve_model(cfg, device="cuda")
    mesh = build_mesh(MeshConfig(**cfg["mesh"]), device="cuda")
    num_micro = train_main.pp_num_micro(cfg, config, mesh, cfg["batch"])
    loss_fn, to_pp, _, specs_of = train_main.build_pp_pretrain(
        config, mesh, num_micro)
    params = llama.init_params(config, torch.Generator(
        device="cuda").manual_seed(int(cfg["seed"])), device="cuda")
    host = next(iter(train_main._raw_stream(cfg["data"], config,
                                            cfg["batch"], cfg["seq"])))
    staged = to_pp(params)
    specs = specs_of(staged)
    placed = sharding.shard_tree(staged, mesh, specs)
    batch = {k: sharding.local_of(v)
             for k, v in tdata.shard_batch(host, mesh).items()}
    layer = _pp_layer(torch, llama, config)
    rank = dist.get_rank()
    log(f"[first step] rank {rank}: {cfg['mesh']}, stage "
        f"{mesh.index('pp')} of {mesh.size('pp')}, {num_micro} microbatches")
    view = sharding.views(placed, mesh)
    local_stages = {k: sharding.materialize(v)
                    for k, v in view["stages"].items()}

    def apply_layers(x, cos, sin):
        return pipe.pipeline_apply(
            mesh, pipe.stage_scan(lambda h, lp: layer(h, lp, cos, sin)),
            local_stages, x, num_micro)
    with torch.no_grad():
        h = llama.forward_hidden(config, view, batch["tokens"],
                                 apply_layers=apply_layers).float()
    view = sharding.views(placed, mesh, requires_grad=True)
    leaves = tree_leaves(view)
    share = loss_fn(view, batch)
    grads = torch.autograd.grad(share, [p.local for _, p in leaves],
                                materialize_grads=True)
    for (k, _), g in zip(leaves, grads):
        if not k.startswith("stages/"):
            dist.all_reduce(g, group=mesh.group("pp"))
    loss = float(collectives.world_sum(share))
    local = {k: g for (k, _), g in zip(leaves, grads)}
    del view, leaves, grads, placed, share
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[first step] rank {rank}: unsharded")
    full = tdata.to_device(host, torch.device("cuda"))
    with torch.no_grad():
        ref_h = llama.forward_hidden(config, params, full["tokens"]).float()
    ref_h = sharding.local_shard(ref_h, mesh, (("dp", "fsdp"),))
    last = pipe.stages_of(mesh).holds_last
    shared = torch.zeros(2, device="cuda")
    if last:
        shared[0] = (h - ref_h).norm() / ref_h.norm()
        shared[1] = torch.nn.functional.cosine_similarity(
            h, ref_h, dim=-1).min()
    dist.all_reduce(shared, group=mesh.group("pp"))
    del h, ref_h
    ref_leaves = [(k, t.requires_grad_()) for k, t in tree_leaves(params)]
    ref_loss = llama.loss_fn(config, params, full["tokens"], full["targets"])
    ref_grads = dict(zip([k for k, _ in ref_leaves], torch.autograd.grad(
        ref_loss, [t for _, t in ref_leaves])))
    _reset_counts(attn)            # the checks launched K1-K3 too
    out = {"loss": loss, "ref_loss": float(ref_loss.detach()),
           "hidden_rel": float(shared[0]),
           "hidden_min_cos": float(shared[1]), "leaves": {}}
    flat_specs = sharding.spec_leaves(specs)
    for k, g in local.items():
        ref = ref_grads[k.replace("stages/", "layers/")]
        if k.startswith("stages/"):
            pp = mesh.size("pp")
            ref = ref.reshape((pp, config.n_layers // pp)
                              + tuple(ref.shape[1:]))
        want = sharding.local_shard(ref, mesh, flat_specs[k])
        out["leaves"][k] = (_sq_dist(torch, g, want), _sq_dist(torch, want),
                            tuple(want.shape) != tuple(ref.shape))
    return out


def _pp2_job(name, model, vocab, layers, batch) -> tuple:
    """(ref config path and dict, pp=2 config path) of one [pp2] job."""
    over = {"n_layers": layers}
    ref = _train_config(f"pp2_{name}_ref", model=model, vocab=vocab,
                        overrides=over, batch=batch, steps=PP2_STEPS)
    path, _, _ = _train_config(f"pp2_{name}", model=model, vocab=vocab,
                               overrides=over, batch=batch, steps=PP2_STEPS,
                               mesh={"pp": 2},
                               pipeline={"num_micro": PP2_MICRO})
    return ref, path


def phase_pp2(torch) -> dict:
    """Pipeline parallelism at pp=2 on the one card: ``python -m
    kubedl_tpu_torch.train``'s ``main`` under ``"mesh": {"pp": 2}`` in
    two processes over gloo (each rank one stage; activations and
    cotangents cross through the host, as gloo's point-to-point calls
    take host memory only), GPipe in ``PP2_MICRO`` microbatches, for two
    jobs: Llama-3-8B width at ``PP2_LAYERS`` layers, b=4 x 2048, and
    Gemma-2B width at ``PP2_LAYERS`` layers, b=2 x 2048 (its tied
    embedding serves the lookup on stage 0 and the head on stage 1, and
    its gradient is summed over the stages). Each against the same job
    unsharded on one process (``_hold_mesh_run``): every K1-K3 launch on
    ``sm90`` (a rank runs its ``L/pp`` layers for each microbatch), the
    losses, the first step's hidden states and gradients
    (``_first_step_pp``); the exchanges staged through the host, one each
    way a slot; each rank's step time and peak memory."""
    jobs, refs = [], {}
    for name, model, vocab, batch in (
            ("llama", "llama.llama3_8b", 128256, 4),
            ("gemma", "gemma.gemma_2b", 256128, 2)):
        (ref_path, _, ref_cfg), path = _pp2_job(name, model, vocab,
                                                PP2_LAYERS, batch)
        refs[name] = _train_run(torch, f"pp2_{name}_ref", ref_path,
                                ref_cfg, ALL_SM90, mfu=False)
        gc.collect()
        torch.cuda.empty_cache()
        jobs.append((name, path))
    t0 = time.perf_counter()
    res = _two_ranks(torch, "pp2", jobs)
    out = {"seconds": time.perf_counter() - t0}
    bad = []
    per_rank_layers = PP2_LAYERS * PP2_MICRO // 2
    want_staged = 2 * (PP2_MICRO + 2 - 2) * PP2_STEPS
    for name, _ in jobs:
        out[name], bad_j = _hold_mesh_run("pp2", name, res, refs[name],
                                          per_rank_layers, 1)
        out[name]["unsharded"] = {k: refs[name][k] for k in (
            "losses", "step_s", "peak_gib")}
        staged = [res[r][name]["pp_staged"] for r in (0, 1)]
        out[name]["pp_staged"] = staged
        log(f"[pp2] {name}: exchanges staged through the host by rank "
            f"{staged} (want {want_staged}: one a slot each way, "
            f"{PP2_MICRO} + 2 - 2 slots that send, {PP2_STEPS} steps); "
            f"unsharded step {refs[name]['step_s']:.4f} s, peak "
            f"{refs[name]['peak_gib']:.2f} GiB")
        if staged != [want_staged] * 2:
            bad_j.append(f"[pp2] {name}: the pipeline's exchanges staged "
                         f"{staged} times, want {want_staged} a rank")
        bad += bad_j
    log(f"[pp2] the two ranks ran both jobs in {out['seconds']:.1f} s")
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def _grpo_reading(torch, grpo, config, params, batch, gcfg) -> dict:
    """The on-policy identity on a rollout batch: the policy ``params``'
    ``token_logps`` against the behavior logprobs the engine reported
    (``old_logps``): ``grpo_loss``'s ratio_mean, and the mean absolute
    logprob gap over the completion tokens to the policy and, where the
    batch holds them, to the frozen initial weights' (``ref_logps``)."""
    with torch.no_grad():
        lp = grpo.token_logps(config, params, batch["tokens"],
                              batch["targets"])
        old = batch["old_logps"]
        ref = batch.get("ref_logps", old)
        _, m = grpo.grpo_loss(lp, old, ref, batch["advantages"],
                              batch["mask"], gcfg)
        mask = batch["mask"] > 0
        return {"ratio_mean": float(m["ratio_mean"]),
                "policy_gap": float((old - lp)[mask].abs().mean()),
                "initial_gap": float((old - ref)[mask].abs().mean()),
                "tokens": int(mask.sum())}


def _grpo_files(out_dir, vocab, rows) -> tuple:
    """(prompts path, reward spec): ``rows`` prompts of random token ids
    from seed 0, and a reward function in its own ``.py`` file that
    scores token ids (the share of even ids), so a group's completions
    differ in reward."""
    import numpy as np
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    prompts = out_dir / "prompts.jsonl"
    prompts.write_text("".join(
        json.dumps({"prompt": rng.integers(3, vocab, n).tolist()}) + "\n"
        for n in (17, 41, 29, 64)[:rows]))
    reward = out_dir / "reward.py"
    reward.write_text("def reward(prompt, completion):\n"
                      "    return sum(t % 2 == 0 for t in completion) "
                      "/ max(len(completion), 1)\n")
    return str(prompts), f"{reward}:reward"


def phase_grpo(torch) -> dict:
    """GRPO through ``python -m kubedl_tpu_torch.train``'s ``main`` in
    ``mode: grpo`` on Gemma-2B at full size (random bf16 weights from a
    seed): ``GRPO_ROUNDS`` rounds of ``GRPO_STEPS`` steps, each round
    ``GRPO_PROMPTS`` prompts x a group of ``GRPO_GROUP`` sampled by the
    static engine (``GRPO_NEW`` tokens), refreshed in place to the policy
    before every round; the reference scored on the frozen initial
    weights; no checkpoint. Held, at each round's first step (read
    through the trainer's step): the on-policy identity, ratio_mean 1
    within ``GRPO_RATIO_TOL``; in round 2 the behavior logprobs nearer
    the updated policy's than the initial weights' by at least 2x; finite
    losses; K1-K3 at the counts the path gives (each step's forward and
    remat recompute, each round's reference scoring), all ``sm90``. Then
    ``_grpo_flywheel``."""
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train import grpo
    from kubedl_tpu_torch.train import trainer as trainer_mod

    out_dir = BUILD_OUT / "grpo"
    prompts, reward = _grpo_files(out_dir, 256000, GRPO_PROMPTS)
    cfg = {"model": "gemma.gemma_2b", "mode": "grpo", "seed": 0,
           "data": {"kind": "prompts_jsonl", "path": prompts},
           "reward": reward, "grpo": {"group_size": GRPO_GROUP},
           "rollout": {"rounds": GRPO_ROUNDS, "steps_per_round": GRPO_STEPS,
                       "max_new_tokens": GRPO_NEW, "max_len": 256,
                       "prompts_per_round": GRPO_PROMPTS},
           # the JAX trainer's default peak rate, with no warm-up so the
           # first update moves every bf16 weight (~2.5 ulps at its scale)
           "optimizer": {"learning_rate": 3e-4, "warmup_steps": 0}}
    path = out_dir / "grpo.json"
    path.write_text(json.dumps(cfg))
    config, _ = train_main.resolve_model(cfg, device="cuda")
    gcfg = grpo.GRPOConfig(group_size=GRPO_GROUP)
    readings, held = [], []
    real_step = trainer_mod.Trainer.step

    def step(self, state, batch):
        if not any(b is batch for b in held):
            # a round's first step: read the on-policy identity, and keep
            # this reading's launches out of the path's counts
            held.append(batch)
            kernels = (attn.flash_forward, attn.flash_dq, attn.flash_dkv)
            snap = [(fn.launches, dict(fn.launches_by_route))
                    for fn in kernels]
            readings.append(_grpo_reading(torch, grpo, config, state.params,
                                          batch, gcfg))
            for fn, (n, by) in zip(kernels, snap):
                fn.launches, fn.launches_by_route = n, by
        return real_step(self, state, batch)

    marks = []
    L = config.n_layers
    steps = GRPO_ROUNDS * GRPO_STEPS
    want = {"flash_forward": GRPO_ROUNDS * L + steps * 2 * L,
            "flash_dq": steps * L, "flash_dkv": steps * L}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(attn)
    t0 = time.perf_counter()
    with unittest.mock.patch.object(trainer_mod.Trainer, "step", step):
        rc = train_main.main(["--config", str(path)],
                             on_step=lambda s, loss: marks.append(
                                 (time.perf_counter(), s, loss)))
    seconds = time.perf_counter() - t0
    launches = _read_counts(attn, "[grpo]", want)
    losses = [m[2] for m in marks]
    out = {"rc": rc, "losses": losses, "rounds": readings,
           "launches": launches, "seconds": seconds,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "step_times": [round(b[0] - a[0], 4)
                          for a, b in zip(marks, marks[1:])]}
    for i, r in enumerate(readings):
        log(f"[grpo] round {i + 1}: ratio_mean {r['ratio_mean']:.6f} (limit "
            f"1 +- {GRPO_RATIO_TOL}), mean |behavior - policy| logprob "
            f"{r['policy_gap']:.4e}, mean |behavior - initial weights| "
            f"{r['initial_gap']:.4e} over {r['tokens']} tokens")
    log(f"[grpo] losses {losses}; {seconds:.1f} s through main, times "
        f"between steps {out['step_times']} s (a round's rollout and "
        f"reference scoring fall between its last step and the next "
        f"round's first); peak {out['peak_gib']:.2f} GiB; launches "
        f"{launches} (all sm90)")
    bad = []
    if rc != 0 or len(losses) != steps or not all(map(math.isfinite,
                                                      losses)):
        bad.append(f"rc {rc}, losses {losses}")
    if len(readings) != GRPO_ROUNDS:
        bad.append(f"{len(readings)} rounds read, want {GRPO_ROUNDS}")
    bad += [f"round {i + 1} ratio_mean {r['ratio_mean']}"
            for i, r in enumerate(readings)
            if not abs(r["ratio_mean"] - 1.0) <= GRPO_RATIO_TOL]
    if len(readings) > 1 and not (2 * readings[1]["policy_gap"]
                                  <= readings[1]["initial_gap"]):
        bad.append(f"round 2's behavior logprobs are not the updated "
                   f"policy's: {readings[1]}")
    if bad:
        raise AssertionError("[grpo] " + "; ".join(bad))
    out["flywheel"] = _grpo_flywheel(torch, out_dir)
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    return out


def _grpo_flywheel(torch, out_dir) -> dict:
    """``rl.FlywheelLearner`` on ``FLYWHEEL_CFG`` (bf16, its train state
    well under 1 GB): a rollout of the continuous engine (8 lanes, the
    decode tick on the graph route), one ``step`` (the reference scored
    on the host copy of the initial weights), one ``publish`` through the
    ``TieredCheckpointManager`` (a fresh manager restores the published
    params bit for bit), then ``load_weights`` of the published params
    into the engine, whose captured graphs replay on them: the next
    rollout is on the updated policy (the ratio within
    ``GRPO_RATIO_TOL``, nearer the policy than the initial weights by at
    least 2x)."""
    import types

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.rl import FlywheelLearner
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    from kubedl_tpu_torch.train import grpo
    from kubedl_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                   TieredCheckpointManager)
    from kubedl_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                tree_leaves, tree_map)

    config = llama.LlamaConfig(**FLYWHEEL_CFG, loss_chunk=512)
    params = llama.init_params(config, torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    gcfg = grpo.GRPOConfig(group_size=GRPO_GROUP)
    engine = ContinuousBatchingEngine(config, tree_map(torch.clone, params),
                                      lanes=8, max_len=256, device="cuda")
    prompts_path, reward_spec = _grpo_files(out_dir / "flywheel",
                                            config.vocab_size, 2)
    prompts = [json.loads(line)["prompt"]
               for line in Path(prompts_path).read_text().splitlines()]
    from kubedl_tpu_torch.train.__main__ import resolve_reward
    reward = resolve_reward(reward_spec)
    ck = TieredCheckpointManager(CheckpointConfig(str(out_dir / "local")),
                                 str(out_dir / "object"))
    learner = FlywheelLearner(config, Trainer(None, TrainConfig(
        learning_rate=1e-3, warmup_steps=0)), params, grpo=gcfg,
        checkpoint=ck)
    state_bytes = sum(t.numel() * t.element_size() for tree in (
        learner.state.params, learner.state.opt_state.mu,
        learner.state.opt_state.nu) for _, t in tree_leaves(tree))
    first = grpo.rollout_batch(engine, prompts, reward, GRPO_NEW, cfg=gcfg,
                               seed=0)
    ticks = engine.tick_launches
    _reset_counts(attn)
    t0 = time.perf_counter()
    loss = learner.step(types.SimpleNamespace(batch=first, version=0))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    L = config.n_layers
    launches = _read_counts(attn, "[grpo] learner step", {
        "flash_forward": L + 2 * L, "flash_dq": L, "flash_dkv": L})
    t0 = time.perf_counter()
    published = learner.publish()
    publish_s = time.perf_counter() - t0
    other = TieredCheckpointManager(
        CheckpointConfig(str(out_dir / "fresh")), str(out_dir / "object"))
    restored = other.restore(Trainer(None, TrainConfig(
        learning_rate=1e-3, warmup_steps=0), device="cuda").init_state(
        tree_map(torch.zeros_like, params)))
    want = dict(tree_leaves(published))
    same = all(torch.equal(t.detach().cpu(), want[k])
               for k, t in tree_leaves(restored.params))
    engine.load_weights(published)
    second = grpo.rollout_batch(engine, prompts, reward, GRPO_NEW, cfg=gcfg,
                                seed=1)
    second = {k: torch.as_tensor(v, device="cuda") for k, v in
              second.items()}
    second["tokens"], second["targets"] = (second["tokens"].long(),
                                           second["targets"].long())
    with torch.no_grad():
        second["ref_logps"] = grpo.token_logps(
            config, tree_map(lambda t: t.to("cuda"), learner.ref_params),
            second["tokens"], second["targets"])
    reading = _grpo_reading(torch, grpo, config, learner.state.params,
                            second, gcfg)
    after = engine.tick_launches
    out = {"loss": loss, "launches": launches, "step_s": step_s,
           "publish_s": publish_s, "state_gib": state_bytes / 2**30,
           "published_restored": same, "refreshed": reading,
           "ticks": {"before": ticks, "after": after}}
    log(f"[grpo] learner: {config.num_params / 1e6:.1f} M params, train "
        f"state {out['state_gib']:.3f} GiB; step {step_s:.3f} s (loss "
        f"{loss:.5f}, launches {launches}, all sm90), publish "
        f"{publish_s:.3f} s, restored bit for bit by a fresh manager: "
        f"{same}; rollout ticks {ticks} then {after}")
    log(f"[grpo] after load_weights of the published policy into the "
        f"engine: ratio_mean {reading['ratio_mean']:.6f}, mean |behavior - "
        f"policy| {reading['policy_gap']:.4e}, mean |behavior - initial| "
        f"{reading['initial_gap']:.4e}")
    ck.close()
    other.close()
    bad = []
    if not same:
        bad.append("the published params did not restore bit for bit")
    if not (after["graph"] > ticks["graph"] > 0 and after["eager"] == 0):
        bad.append(f"the rollouts' ticks {ticks} then {after}: every tick "
                   f"on the graph route, both rollouts")
    if not abs(reading["ratio_mean"] - 1.0) <= GRPO_RATIO_TOL or not (
            2 * reading["policy_gap"] <= reading["initial_gap"]):
        bad.append(f"the refreshed engine's rollout is not the published "
                   f"policy's: {reading}")
    if not math.isfinite(loss):
        bad.append(f"loss {loss}")
    if bad:
        raise AssertionError("[grpo] learner: " + "; ".join(bad))
    return out


# -- slice 10: HF checkpoints, the training lifecycle, ResNet and the MLP ----

#: google/gemma-2b's published config.json fields, typed as the model
#: card has them: the synthetic HF directory's config
HF_GEMMA_2B = {
    "architectures": ["GemmaForCausalLM"], "model_type": "gemma",
    "vocab_size": 256000, "hidden_size": 2048, "intermediate_size": 16384,
    "num_hidden_layers": 18, "num_attention_heads": 8,
    "num_key_value_heads": 1, "head_dim": 256, "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0, "max_position_embeddings": 8192,
    "hidden_act": "gelu", "attention_bias": False, "bos_token_id": 2,
    "eos_token_id": 1, "pad_token_id": 0, "torch_dtype": "bfloat16"}
#: HF's names of the llama-family layer weights (the published layout,
#: stated here apart from the converter under test)
HF_LAYER_NAMES = {"attn_norm": "input_layernorm.weight",
                  "wq": "self_attn.q_proj.weight",
                  "wk": "self_attn.k_proj.weight",
                  "wv": "self_attn.v_proj.weight",
                  "wo": "self_attn.o_proj.weight",
                  "mlp_norm": "post_attention_layernorm.weight",
                  "w_gate": "mlp.gate_proj.weight",
                  "w_up": "mlp.up_proj.weight",
                  "w_down": "mlp.down_proj.weight"}
#: the slice-10 phases run google/gemma-2b's published config with its
#: depth cut to this many layers (full width: the 256000-token embedding,
#: d_model 2048, heads of width 256). At its 18 layers they would write
#: ~85 GB to disk (the HF shards 5.0, the artifact 10.0, ``--reverse``
#: 10.0, two 20.05 GB checkpoints, the DPO export 20.0), and the card
#: machine takes at most 45 GiB of writes in a run, 22.8 GB of which the
#: earlier phases' artifacts take. ``--phases hf --layers 18`` runs the
#: conversion alone at full depth.
SLICE10_LAYERS = 1
#: every directory the slice-10 phases write (removed before the end)
SLICE10_OUT = BUILD_OUT / "slice10"
#: the new paths whose kernel launches the kernels line reports
SLICE10_PATHS = ("hf_serve", "lifecycle_train", "lifecycle_resume",
                 "lifecycle_eval", "evaluate", "dpo")
#: ResNet-50's parameter count, JAX's ``resnet50()`` (pinned against the
#: JAX package by ``tests/test_torch_resnet.py``)
RESNET50_PARAMS = 25_557_032
#: the lifecycle's resumed losses against the uninterrupted run's
RESUME_ATOL = 2e-3


def _host_timer(obj, attr: str, sync=None) -> list:
    """Wrap ``obj.attr`` so each call appends its host seconds (after
    ``sync``, when given) to the returned list."""
    fn = getattr(obj, attr)
    seconds = []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        if sync is not None:
            sync()
        seconds.append(time.perf_counter() - t0)
        return res
    setattr(obj, attr, timed)
    return seconds


def _same_day(tag, got, want, skip=()) -> None:
    """A card day's observation dict equal to the CPU day's, key by key
    (the ``rl`` block's too, but for ``skip``)."""
    bad = [k for k in sorted(set(got) | set(want))
           if k != "rl" and got.get(k) != want.get(k)]
    if "rl" in want:
        bad += [f"rl.{k}" for k in sorted(set(got["rl"]) | set(want["rl"]))
                if k not in skip and got["rl"].get(k) != want["rl"].get(k)]
    if bad:
        raise AssertionError(
            f"{tag}: the card's day differs from the CPU's at {bad}: "
            + "; ".join(f"{k}: {str(got.get(k))[:200]} != "
                        f"{str(want.get(k))[:200]}" for k in bad[:3]))


def _median_ms(seconds) -> float:
    import statistics
    return 1e3 * statistics.median(seconds)


def phase_replay(torch, cfg, params) -> dict:
    """The engine-driven replays on the card, each held to the same day
    run on the CPU on the replays' tiny float32 model: every request has
    a fixed ``max_new`` and no stop token, so what a day observes is
    scheduling and the observation dicts must be equal key by key.

    (a) ``ServingReplay`` of the smoke serving day on Llama-3-8B (the
    continuous phases' bf16 weights), every decode tick on the graph
    route; (b) ``ServingFleetReplay`` of the fleet smoke day,
    disaggregated (prefill lanes hand block tables to decode lanes), its
    two replicas sharing those weights (nothing writes them); (c)
    ``FlywheelReplay`` of the RL smoke day on ``REPLAY_RL_CFG`` in bf16
    with ``resize=True``, each replica on tensors of its own: the
    learner's four GRPO steps launch K1-K3 on ``sm90`` (counted here),
    the resize restores bit for bit, every replica ends on the published
    version, and only the losses (sampled rollouts) are held to
    themselves (finite); (d) ``MultiModelReplay`` of the multi-model smoke
    day (``REPLAY_MM``), adapter-aware and adapter-blind, its two
    replicas sharing the Llama-3-8B weights, each arm held to its CPU
    day, with adapter faults, evictions and per-model TTFT p99. The
    Llama-3-8B of (a), (b) and (d) is the serving phases' model,
    ``SERVE_LAYERS`` deep (a day observes scheduling, which no layer count
    changes)."""
    import dataclasses

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.replay import (FLEET_PROFILES, FleetProfile,
                                         FlywheelReplay, RLJobSpec,
                                         ServingFleetReplay, ServingReplay,
                                         generate, generate_fleet)
    out = {}

    # (a) the serving smoke day
    t0 = time.perf_counter()
    want = ServingReplay(generate("smoke", 0), device="cpu").run()
    cpu_s = time.perf_counter() - t0
    replay = ServingReplay(generate("smoke", 0), model=(cfg, params),
                           device="cuda")
    host = _host_timer(replay.engine, "step")
    t0 = time.perf_counter()
    got = replay.run()
    wall = time.perf_counter() - t0
    _same_day("[replay] (a) the serving day", got, want)
    ticks = _graph_only(replay.engine, "[replay] (a) the serving day")
    out["serving"] = {"ticks": got["engine_ticks"], "wall_s": wall,
                      "cpu_s": cpu_s, "host_ms_median": _median_ms(host),
                      "tick_launches": ticks,
                      "requests": got["requests_completed"],
                      "tokens": got["tokens_generated"]}
    log(f"[replay] (a) the smoke serving day on Llama-3-8B bf16 "
        f"({cfg.n_layers} layers): "
        f"{got['requests_completed']} requests, {got['tokens_generated']} "
        f"tokens, {got['engine_ticks']} ticks in {wall:.2f} s (median "
        f"host {out['serving']['host_ms_median']:.3f} ms a tick; decode "
        f"ticks {ticks}); the CPU day {cpu_s:.2f} s; the observation "
        f"dicts equal key by key")
    del replay
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the disaggregated fleet day
    profile = FleetProfile(name="smoke", **REPLAY_FLEET)
    t0 = time.perf_counter()
    want = ServingFleetReplay(generate_fleet(profile, 1), router="prefix",
                              disaggregate=True, device="cpu").run()
    cpu_s = time.perf_counter() - t0
    replay = ServingFleetReplay(generate_fleet(profile, 1), router="prefix",
                                disaggregate=True, model=(cfg, params),
                                device="cuda")
    host = [_host_timer(rep.engine, "step") for rep in replay.fleet.replicas]
    t0 = time.perf_counter()
    got = replay.run()
    wall = time.perf_counter() - t0
    _same_day("[replay] (b) the fleet day", got, want)
    if not got["handoffs"] > 0:
        raise AssertionError(f"[replay] (b): {got['handoffs']} handoffs")
    ticks = [_graph_only(rep.engine, f"[replay] (b) {rep.name}")
             for rep in replay.fleet.replicas]
    out["fleet"] = {"ticks": got["engine_ticks"], "wall_s": wall,
                    "cpu_s": cpu_s, "handoffs": got["handoffs"],
                    "host_ms_median": _median_ms([x for h in host
                                                  for x in h]),
                    "tick_launches": ticks}
    log(f"[replay] (b) the disaggregated fleet day on Llama-3-8B bf16 "
        f"({cfg.n_layers} layers), 2 "
        f"replicas sharing the weights: {got['requests_completed']} "
        f"requests, {got['handoffs']} handoffs, {got['engine_ticks']} "
        f"ticks in {wall:.2f} s (median host "
        f"{out['fleet']['host_ms_median']:.3f} ms a replica step; decode "
        f"ticks {ticks}); the CPU day {cpu_s:.2f} s; equal key by key")
    del replay
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the RL flywheel day
    rl_profile = dataclasses.replace(
        FLEET_PROFILES["routing"], name="rl-smoke", sim_seconds=300.0,
        requests=300, bursts=4)
    spec = RLJobSpec(**REPLAY_RL_SPEC)
    t0 = time.perf_counter()
    want = FlywheelReplay(generate_fleet(rl_profile, 0), spec=spec,
                          device="cpu").run()
    cpu_s = time.perf_counter() - t0
    rcfg = llama.LlamaConfig(**REPLAY_RL_CFG, loss_chunk=512)
    rparams = llama.init_params(rcfg, torch.Generator(
        device="cuda").manual_seed(4), device="cuda")
    state_gb = 8 * rcfg.num_params / 1e9    # bf16 params and nu, f32 mu
    replay = FlywheelReplay(generate_fleet(rl_profile, 0), spec=spec,
                            model=(rcfg, rparams), device="cuda")
    steps = _host_timer(replay.learner, "step", torch.cuda.synchronize)
    _reset_counts(attn)
    t0 = time.perf_counter()
    got = replay.run()
    wall = time.perf_counter() - t0
    L = rcfg.n_layers
    n = got["rl"]["batches_consumed"]
    launches = _read_counts(attn, "[replay] (c) the flywheel day", {
        "flash_forward": 3 * L * n, "flash_dq": L * n, "flash_dkv": L * n})
    _same_day("[replay] (c) the flywheel day", got, want,
              skip=REPLAY_SAMPLED)
    rl = got["rl"]
    losses = rl["losses"]
    if not (len(losses) == n == spec.total_batches
            and all(math.isfinite(x) for x in losses)
            and rl["resize_restore_bit_identical"] == 1
            and rl["elastic_resizes"] == 1
            and set(rl["serving_versions"].values())
            == {rl["policy_version"]} and rl["publishes"] == 2):
        raise AssertionError(f"[replay] (c): {rl}")
    ticks = [_graph_only(rep.engine, f"[replay] (c) {rep.name}")
             for rep in replay.fleet.replicas]
    out["flywheel"] = {"ticks": got["engine_ticks"], "wall_s": wall,
                       "cpu_s": cpu_s, "launches": launches,
                       "learner_step_ms": [1e3 * x for x in steps],
                       "losses": losses, "state_gb": state_gb,
                       "checkpoint_gb": 6 * state_gb,
                       "tick_launches": ticks}
    log(f"[replay] (c) the RL flywheel day, learner "
        f"{rcfg.num_params / 1e6:.1f} M params bf16 (state {state_gb:.3f} GB, six copies "
        f"{6 * state_gb:.3f} GB written): {rl['batches_consumed']} batches, "
        f"{rl['publishes']} publishes rolled over {rl['replicas_rolled']} "
        f"replica swaps, resize at step {rl['resize_at_step']} bit for bit, "
        f"versions {rl['serving_versions']}; {got['engine_ticks']} ticks in "
        f"{wall:.2f} s; learner steps "
        f"{[round(1e3 * x, 2) for x in steps]} ms; K1-K3 launches "
        f"{launches} (all sm90); losses {losses}; the CPU day {cpu_s:.2f} s;"
        f" equal key by key but for the losses")
    del replay, rparams
    gc.collect()
    torch.cuda.empty_cache()
    out["multimodel"] = _multimodel_days(torch, cfg, params)
    return out


def _multimodel_days(torch, cfg, params) -> dict:
    """[replay] (d): both arms of the multi-model day on the card, each
    held to the same arm's day on the CPU key by key."""
    from kubedl_tpu_torch.replay.multimodel import (MultiModelProfile,
                                                    MultiModelReplay,
                                                    generate_multimodel)
    profile = MultiModelProfile(name="mm-smoke", **REPLAY_MM)
    out = {}
    for arm, affinity in (("adapter_aware", True), ("adapter_blind", False)):
        tag = f"[replay] (d) the multi-model day, {arm}"
        t0 = time.perf_counter()
        want = MultiModelReplay(generate_multimodel(profile, 1),
                                adapter_affinity=affinity,
                                device="cpu").run()
        cpu_s = time.perf_counter() - t0
        replay = MultiModelReplay(generate_multimodel(profile, 1),
                                  adapter_affinity=affinity,
                                  model=(cfg, params), device="cuda")
        host = [_host_timer(rep.engine, "step")
                for rep in replay.fleet.replicas]
        t0 = time.perf_counter()
        got = replay.run()
        wall = time.perf_counter() - t0
        _same_day(tag, got, want)
        ticks = [_graph_only(rep.engine, f"{tag} {rep.name}")
                 for rep in replay.fleet.replicas]
        mm = got["multi_model"]
        if not (mm["models_reported"] == mm["models"] == 6
                and got["requests_completed"] == got["requests_submitted"]
                and mm["adapter_faults"] > 0):
            raise AssertionError(f"{tag}: {mm}")
        out[arm] = {"ticks": got["engine_ticks"], "wall_s": wall,
                    "cpu_s": cpu_s,
                    "host_ms_median": _median_ms([x for h in host
                                                  for x in h]),
                    "tick_launches": ticks,
                    "adapter_faults": mm["adapter_faults"],
                    "adapter_evictions": mm["adapter_evictions"],
                    "fault_rate": mm["fault_rate"],
                    "model_ttft_p99_s": mm["model_ttft_s"]["p99"],
                    "per_model_ttft_p99_s": {
                        m: v["ttft_s"].get("p99")
                        for m, v in mm["per_model"].items()}}
        log(f"{tag} on Llama-3-8B bf16 ({cfg.n_layers} layers), 2 replicas "
            f"sharing the weights: "
            f"{got['requests_completed']} requests, {got['engine_ticks']} "
            f"ticks in {wall:.2f} s (median host "
            f"{out[arm]['host_ms_median']:.3f} ms a replica step; decode "
            f"ticks {ticks}); adapter faults {mm['adapter_faults']}, "
            f"evictions {mm['adapter_evictions']}, model TTFT p99 "
            f"{mm['model_ttft_s']['p99']} s, per model "
            f"{out[arm]['per_model_ttft_p99_s']}; the CPU day "
            f"{cpu_s:.2f} s; equal key by key ({_card()})")
        del replay
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- slice 17: standalone speculative decoding behind the predictor ----------

#: [spec]: the draft lookahead, the drafts' depth (the target's first
#: layers, sharing its embedding, head and weights), and the requests:
#: 3 prompts of these lengths (seed 17), SPEC_NEW greedy tokens each
SPEC_K, SPEC_DRAFT_LAYERS = 4, 2
SPEC_LENS, SPEC_NEW, SPEC_MAX_LEN = (31, 97, 200), 32, 512


def _first_layers(params, n) -> dict:
    """A model cut from ``params`` to its first ``n`` layers (views of the
    stacked layers) with the same embedding, final norm and head: a draft
    that needs no new weights."""
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": {k: v[:n] for k, v in params["layers"].items()}}


def _timed_generate(torch, fn, reqs) -> tuple:
    """(outputs, ms per emitted token) of ``fn(prompt, n)`` over ``reqs``
    (each output ends on the host, so the card is done)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(p, n) for p, n in reqs]
    ms = 1e3 * (time.perf_counter() - t0)
    return outs, ms / max(sum(len(o) for o in outs), 1)


def phase_spec(torch, cfg, params) -> dict:
    """The standalone speculative engine (``serving/speculative.py``) on
    the serving phases' Llama-3-8B (full width, bf16, seed 0), k=SPEC_K:

    (a) with a draft cut to the target's first SPEC_DRAFT_LAYERS layers,
    3 greedy requests of SPEC_NEW tokens held to the target's own greedy
    decode through ``InferenceEngine``: identical requests counted, and
    every token held to the teacher-forced reference within the near-tie
    limits (``_hold``; the verify pass multiplies [1, k+1] rows where the
    static engine multiplies one, so bf16 rounds otherwise and a near-tie
    may go either way); then the target as its own draft, whose
    acceptance is read. Rounds, acceptance and ms per emitted token
    beside the static engine's.
    (b) float32, on the target cut to 2 layers (the same weights
    widened): with a 1-layer draft the tokens must equal the static
    engine's exactly, and as its own draft every proposal must be
    accepted (acceptance 1.0).
    (c) ``SpeculativeServingAdapter`` behind ``InferenceServer``: one
    ``:predict`` (the engine's tokens), one ``/metrics`` carrying the spec
    gauges, one ``/v1/embeddings`` on the target's weights, whose vectors
    must equal a static engine's server's bit for bit with its K1 launches
    (one a layer) all on ``sm90``."""
    import dataclasses

    import numpy as np

    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.serving import (GenerateConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)
    from kubedl_tpu_torch.serving.speculative import (
        SpecStats, SpeculativeEngine, SpeculativeServingAdapter)
    from kubedl_tpu_torch.tokenizer import ByteTokenizer

    rng = np.random.default_rng(17)
    reqs = [(rng.integers(3, cfg.vocab_size, n).tolist(), SPEC_NEW)
            for n in SPEC_LENS]
    gen = GenerateConfig(max_len=SPEC_MAX_LEN)
    out = {}

    # (a) the full-width target in bf16
    static = InferenceEngine(cfg, params, gen, device="cuda")
    spec = SpeculativeEngine(
        cfg, params, dataclasses.replace(cfg, n_layers=SPEC_DRAFT_LAYERS),
        _first_layers(params, SPEC_DRAFT_LAYERS), k=SPEC_K,
        max_len=SPEC_MAX_LEN, device="cuda")
    static.generate([reqs[0][0]], 4)               # first shapes
    spec.generate(reqs[0][0], 4)
    want, static_ms = _timed_generate(
        torch, lambda p, n: static.generate([p], n)[0], reqs)
    stats = SpecStats()
    got, spec_ms = _timed_generate(
        torch, lambda p, n: spec.generate(p, n, stats=stats), reqs)
    held = _hold(torch, cfg, params, reqs, got,
                 f"[spec] (a) Llama-3-8B bf16, {SPEC_DRAFT_LAYERS}-layer "
                 f"draft, k={SPEC_K}", want=want,
                 want_label="the static engine's greedy decode")
    self_spec = SpeculativeEngine(cfg, params, cfg, params, k=SPEC_K,
                                  max_len=SPEC_MAX_LEN, device="cuda")
    self_stats = SpecStats()
    self_got, self_ms = _timed_generate(
        torch, lambda p, n: self_spec.generate(p, n, stats=self_stats),
        reqs[:1])
    out["bf16"] = {"identical": held["identical"], "requests": len(reqs),
                   "rounds": stats.proposed // SPEC_K,
                   "acceptance": stats.acceptance_rate,
                   "ms_per_token": spec_ms, "static_ms_per_token": static_ms,
                   "self_acceptance": self_stats.acceptance_rate,
                   "self_rounds": self_stats.proposed // SPEC_K,
                   "self_ms_per_token": self_ms,
                   "self_identical": self_got[0] == want[0]}
    del static, spec, self_spec
    gc.collect()
    torch.cuda.empty_cache()

    # (b) float32 on the target cut to 2 layers: exact
    c32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    p32 = {k: ({n: t[:2].float() for n, t in v.items()}
               if k == "layers" else v.float()) for k, v in params.items()}
    static32 = InferenceEngine(c32, p32, gen, device="cuda")
    want32 = [static32.generate([p], n)[0] for p, n in reqs[:2]]
    spec32 = SpeculativeEngine(c32, p32, dataclasses.replace(c32, n_layers=1),
                               _first_layers(p32, 1), k=SPEC_K,
                               max_len=SPEC_MAX_LEN, device="cuda")
    got32 = [spec32.generate(p, n) for p, n in reqs[:2]]
    st32 = SpecStats()
    self32 = SpeculativeEngine(c32, p32, c32, p32, k=SPEC_K,
                               max_len=SPEC_MAX_LEN, device="cuda")
    got_self32 = self32.generate(reqs[0][0], SPEC_NEW, stats=st32)
    out["f32"] = {"identical": got32 == want32,
                  "self_identical": got_self32 == want32[0],
                  "self_acceptance": st32.acceptance_rate}
    if got32 != want32 or got_self32 != want32[0] or \
            st32.acceptance_rate != 1.0:
        raise AssertionError(f"[spec] (b) float32: {out['f32']}")
    del p32, static32, spec32, self32
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the adapter behind the server
    adapter = SpeculativeServingAdapter(
        SpeculativeEngine(cfg, params, dataclasses.replace(
            cfg, n_layers=SPEC_DRAFT_LAYERS),
            _first_layers(params, SPEC_DRAFT_LAYERS), k=SPEC_K,
            max_len=SPEC_MAX_LEN, device="cuda"), gen=gen)
    vecs = {}
    for tag, eng in (("spec", adapter),
                     ("static", InferenceEngine(cfg, params, gen,
                                                device="cuda"))):
        srv = InferenceServer(eng, ServerConfig(
            model_name="spec", host="127.0.0.1", port=0,
            tokenizer=ByteTokenizer())).start()
        try:
            if tag == "spec":
                pred = json.loads(_post(srv.url, "/v1/models/spec:predict", {
                    "instances": [{"prompt_tokens": reqs[1][0],
                                   "max_tokens": SPEC_NEW}]}))
                page = urllib.request.urlopen(srv.url + "/metrics",
                                              timeout=60).read().decode()
                _reset_counts(attn)
            emb = json.loads(_post(srv.url, "/v1/embeddings",
                                   {"input": list(EMBED_TEXTS)}))
            if tag == "spec":
                out["embeddings_launches"] = _read_counts(
                    attn, "[spec] (c) /v1/embeddings")["flash_forward"]
        finally:
            srv.stop()
        vecs[tag] = np.asarray([d["embedding"] for d in emb["data"]])
    adapter.stop()
    if pred["predictions"][0]["tokens"] != got[1]:
        raise AssertionError("[spec] (c) :predict through the adapter gave "
                             "other tokens than the engine")
    if "kubedl_serving_spec_proposed_total" not in page or \
            "kubedl_serving_spec_acceptance_rate" not in page:
        raise AssertionError("[spec] (c) /metrics lacks the spec gauges")
    if out["embeddings_launches"] != cfg.n_layers or not np.array_equal(
            vecs["spec"], vecs["static"]):
        raise AssertionError(
            f"[spec] (c) /v1/embeddings: K1 {out['embeddings_launches']} "
            f"times, want {cfg.n_layers}; max abs diff from the static "
            f"server's {np.abs(vecs['spec'] - vecs['static']).max()}")
    gauge = next(line for line in page.splitlines() if line.startswith(
        "kubedl_serving_spec_acceptance_rate"))
    b = out["bf16"]
    smi = _card()
    log(f"[spec] (a) Llama-3-8B bf16, draft = its first "
        f"{SPEC_DRAFT_LAYERS} layers, k={SPEC_K}: {b['rounds']} rounds, "
        f"acceptance {b['acceptance']:.4f}, {b['ms_per_token']:.3f} ms per "
        f"emitted token against the static engine's "
        f"{b['static_ms_per_token']:.3f}; {b['identical']}/{b['requests']} "
        f"requests identical to its greedy decode; self-draft: "
        f"{b['self_rounds']} rounds, acceptance {b['self_acceptance']:.4f}, "
        f"{b['self_ms_per_token']:.3f} ms per token, identical "
        f"{b['self_identical']} ({smi})")
    log(f"[spec] (b) float32, 2 layers: 1-layer draft tokens equal the "
        f"static engine's, self-draft acceptance "
        f"{out['f32']['self_acceptance']}")
    log(f"[spec] (c) the adapter behind InferenceServer: :predict tokens "
        f"equal the engine's; /metrics '{gauge}'; /v1/embeddings "
        f"{out['embeddings_launches']} K1 launches, all sm90, vectors equal "
        f"bit for bit to the static engine's server's")
    return out


# -- slice 18: the native packer, the serving auto-configurator and the
#    multi-model fleet day ---------------------------------------------------

#: [native]: the text corpus (seed 0), NATIVE_DOCS documents of 1 to
#: NATIVE_MAX_BYTES printable ASCII bytes (~16.9 MB of text, ~17.3 MB of
#: jsonl), byte-tokenized, and the job that trains on it: Llama-3-8B width,
#: NATIVE_LAYERS layers, b=4 x 2048, NATIVE_STEPS steps
NATIVE_DOCS, NATIVE_MAX_BYTES = 4096, 8192
NATIVE_LAYERS, NATIVE_STEPS = 2, 2


def _host_cpu() -> str:
    """The host CPU's model name, architecture and core count (the
    packer's rates are the host's, not the card's): ``lscpu``'s model
    name, else ``/proc/cpuinfo``'s."""
    import os
    import platform
    name = ""
    try:
        res = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30)
        name = next((line.split(":", 1)[1].strip()
                     for line in res.stdout.splitlines()
                     if line.strip().lower().startswith("model name")), "")
    except (OSError, subprocess.SubprocessError):
        pass
    if not name:
        try:
            with open("/proc/cpuinfo") as f:
                name = next((line.split(":", 1)[1].strip() for line in f
                             if line.lower().startswith(("model name",
                                                         "cpu model"))),
                            "")
        except OSError:
            pass
    return (f"{name or 'CPU model not reported'}, {platform.machine()}, "
            f"{os.cpu_count()} cores")


def _same_batches(got, want) -> bool:
    """Two lists of packed batches equal bit for bit, dtypes included."""
    import numpy as np
    return len(got) == len(want) and all(
        g.keys() == w.keys() and all(
            g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
            for k in g) for g, w in zip(got, want))


def phase_native(torch) -> dict:
    """The C++ document packer (``kubedl_tpu_torch.native``) on the
    trainer's main path. A jsonl corpus from seed 0 trains through
    ``python -m kubedl_tpu_torch.train``'s ``main`` with ``data.kind:
    text`` (the byte tokenizer): every call of ``pack_rows_native`` is
    counted here by wrapping it (the package counts nothing), and each
    must have taken the native route; K1-K3 launch on ``sm90`` (counted
    from 0 just before ``main``). Then the whole corpus's token lists are
    packed through ``pack_documents`` by the packer (a list) and by the
    Python loop (a generator, the plain version): bit for bit equal, with
    each one's tokens/s on the host."""
    import numpy as np

    from kubedl_tpu_torch import native
    from kubedl_tpu_torch.tokenizer import ByteTokenizer, text_documents
    from kubedl_tpu_torch.train.data import pack_documents

    out_dir = BUILD_OUT / "native"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    so = native.ensure_built()
    build_s = time.perf_counter() - t0
    if so is None:
        raise AssertionError("[native] no C++ compiler on PATH")
    rng = np.random.default_rng(0)
    corpus = out_dir / "corpus.jsonl"
    text_bytes = 0
    with open(corpus, "w") as f:
        for n in rng.integers(1, NATIVE_MAX_BYTES + 1, NATIVE_DOCS):
            text = rng.integers(32, 127, n, dtype=np.uint8).tobytes()
            text_bytes += len(text)
            f.write(json.dumps({"text": text.decode()}) + "\n")
    cfg = {"model": "llama.llama3_8b",
           "model_overrides": {"n_layers": NATIVE_LAYERS},
           "mode": "pretrain",
           "data": {"kind": "text", "path": str(corpus),
                    "tokenizer": "byte"},
           "batch": 4, "seq": 2048, "steps": NATIVE_STEPS, "seed": 0,
           "optimizer": {"warmup_steps": 1}, "log_every": 1}
    cfg_path = out_dir / "train.json"
    cfg_path.write_text(json.dumps(cfg))
    calls = []
    real = native.pack_rows_native

    def counted(docs, seq_len, pad_id=0):
        t0 = time.perf_counter()
        res = real(docs, seq_len, pad_id)
        calls.append({"native": res is not None, "docs": len(docs),
                      "s": time.perf_counter() - t0})
        return res
    native.pack_rows_native = counted
    try:
        # the batches differ from step to step, so the loss need not fall
        run = _train_run(torch, "native", str(cfg_path), cfg, ALL_SM90,
                         falling=False)
    finally:
        native.pack_rows_native = real
    if not calls or not all(c["native"] for c in calls):
        raise AssertionError(f"[native] pack_documents did not take the "
                             f"native route in the job: {calls}")
    tok = ByteTokenizer()
    docs = list(text_documents(str(corpus), tok))
    n_tokens = sum(map(len, docs))
    t0 = time.perf_counter()
    got = list(pack_documents(docs, cfg["seq"], cfg["batch"],
                              pad_id=tok.pad_id))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = list(pack_documents(iter(docs), cfg["seq"], cfg["batch"],
                               pad_id=tok.pad_id))
    loop_s = time.perf_counter() - t0
    if not got or not _same_batches(got, want):
        raise AssertionError(f"[native] the packer's {len(got)} batches "
                             f"differ from the Python loop's {len(want)}")
    out = {"build_s": build_s, "library": so.name,
           "corpus_bytes": corpus.stat().st_size, "text_bytes": text_bytes,
           "tokens": n_tokens, "batches": len(got), "calls": calls,
           "native_s": native_s, "loop_s": loop_s,
           "native_tokens_per_s": n_tokens / native_s,
           "loop_tokens_per_s": n_tokens / loop_s,
           "ratio": loop_s / native_s, "host": _host_cpu(),
           "launches": run["launches"], "by_route": run["by_route"],
           "step_s": run["step_s"], "losses": run["losses"]}
    corpus.unlink()
    log(f"[native] {so.name} built in {build_s:.2f} s; the job packed its "
        f"corpus ({NATIVE_DOCS} documents, {text_bytes} bytes of text, "
        f"{out['corpus_bytes']} bytes of jsonl) through the native route "
        f"{len(calls)} time(s) ({[round(c['s'], 3) for c in calls]} s); "
        f"K1-K3 {run['launches']} on {run['by_route']}; losses "
        f"{[round(x, 4) for x in run['losses']]}")
    log(f"[native] the whole corpus, {n_tokens} tokens into {len(got)} "
        f"batches of 4 x 2048: packer {native_s:.3f} s "
        f"({out['native_tokens_per_s']:.4e} tokens/s), Python loop "
        f"{loop_s:.3f} s ({out['loop_tokens_per_s']:.4e} tokens/s), "
        f"{out['ratio']:.2f}x; bit for bit equal (host {out['host']}; "
        f"card {_card()})")
    return out


#: [auto]: the serving auto-configurator's search over
#: Llama-3-8B (bf16, seed 0) with its first AUTO_DRAFT_LAYERS layers as the
#: draft, and the requests of [cont] its winner serves
AUTO_SEARCH = dict(batches=(1, 8), quantize_opts=(None, "int8"),
                   spec_ks=(0, 4), kv_blocks=(0,), prompt_len=64,
                   new_tokens=16)
AUTO_SLO = dict(p99_latency_ms=25.0, ttft_ms=100.0)
AUTO_DRAFT_LAYERS, AUTO_SERVED = 2, 4


def _recording_runs(torch, runs: list):
    """A context in which every run of a ``ContinuousBatchingEngine``
    (scheduler steps from one that finds requests queued on an idle engine
    to one that finds nothing left: ``run`` and the probe's own stepping
    alike) appends a record to ``runs``: lanes, requests, new tokens each,
    the tokens each got, wall ms, the ms of each step (the first admits
    every lane: the prefills and one tick) and of each admission (a
    prompt's prefill), the garbage collector's ms, the allocator's
    cudaMalloc calls, the decode graphs captured and the decode ticks run,
    and on an engine's first run its tick bound (``_tick_bound_ms`` on
    its own weights at its lanes, every lane holding the prompt)."""
    import contextlib

    from kubedl_tpu_torch.serving import batching
    eng_cls = batching.ContinuousBatchingEngine
    real_step, real_admit = eng_cls._step_once, eng_cls._admit
    real_capture = batching.DecodeTick._capture
    clock = {"gc_ms": 0.0, "captures": 0, "t": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            clock["t"] = time.perf_counter()
        else:
            clock["gc_ms"] += 1e3 * (time.perf_counter() - clock["t"])

    def capture(self, host):
        clock["captures"] += 1
        return real_capture(self, host)

    def counters(eng):
        return {"gc_ms": clock["gc_ms"], "captures": clock["captures"],
                "mallocs": torch.cuda.memory_stats().get(
                    "num_device_alloc", 0),
                "ticks": sum(eng.tick_launches.values())}

    def admit(self, lane):
        t0 = time.perf_counter()
        try:
            return real_admit(self, lane)
        finally:
            self._auto_rec["admits_ms"].append(
                1e3 * (time.perf_counter() - t0))

    def step_once(self):
        rec = getattr(self, "_auto_rec", None)
        if rec is None:
            reqs = list(self._queue)
            rec = self._auto_rec = {
                "lanes": self.lanes, "requests": len(reqs),
                "new": reqs[0].max_new, "steps_ms": [],
                "admits_ms": [], "reqs": reqs, "at": counters(self)}
            if not getattr(self, "_auto_seen", False):
                self._auto_seen = True
                rec["bound_ms"], rec["weight_gb"] = _tick_bound_ms(
                    self.config, self.params, self.lanes,
                    self.lanes * len(reqs[0].prompt))
        t0 = time.perf_counter()
        more = real_step(self)
        rec["steps_ms"].append(1e3 * (time.perf_counter() - t0))
        if not more:
            self._auto_rec = None
            at, now = rec.pop("at"), counters(self)
            rec.update({k: now[k] - at[k] for k in now},
                       wall_ms=sum(rec["steps_ms"]),
                       tokens=sorted({len(r.tokens)
                                      for r in rec.pop("reqs")}))
            runs.append(rec)
        return more

    @contextlib.contextmanager
    def recording():
        gc.callbacks.append(on_gc)
        try:
            with unittest.mock.patch.object(eng_cls, "_step_once",
                                            step_once), \
                    unittest.mock.patch.object(eng_cls, "_admit", admit), \
                    unittest.mock.patch.object(batching.DecodeTick,
                                               "_capture", capture):
                yield runs
        finally:
            gc.callbacks.remove(on_gc)
    return recording()


def _probe_runs(cand, probe, mine, repeats, smi) -> dict:
    """One probe's runs (the two warm-ups, the TTFT run, then one run a
    repeat, whose short run ends with its admitting step) held to its
    physical ceiling: ``batch`` tokens a tick bound (``batch * (k + 1)``
    a bound under speculative k); fails if the probe reads above it or a
    run returned other than the tokens it asked for. Returns the reading,
    printed with the timed runs' spread: their admitting steps (the
    prefills) against the steps after them."""
    for rec in mine:
        if rec["tokens"] != [rec["new"]]:
            raise AssertionError(f"[auto] {cand}: a run of {rec['new']} "
                                 f"tokens returned {rec['tokens']}")
    timed = mine[3:]
    bound_ms = mine[0]["bound_ms"]
    ceiling = cand.batch * (cand.speculative_k + 1) / (bound_ms / 1e3)
    read = probe["decode_tokens_per_s"]
    admits = sorted(x for r in timed for x in r["admits_ms"])
    out = {"ceiling": ceiling, "bound_ms": bound_ms,
           "weight_gb": mine[0]["weight_gb"],
           "remeasured": len(timed) - repeats,
           "admitting_ms": [r["steps_ms"][0] for r in timed],
           "after_ms": [r["wall_ms"] - r["steps_ms"][0] for r in timed],
           "prefill_ms": (admits[0], admits[-1]), "runs": mine}
    log(f"[auto] {cand}: {read} tokens/s against a ceiling of "
        f"{ceiling:.2f} ({cand.batch} lanes x {cand.speculative_k + 1} "
        f"tokens a {bound_ms:.3f} ms tick bound, {out['weight_gb']:.3f} GB "
        f"of weights); {out['remeasured']} repeat(s) measured again; each "
        f"run's admitting step ms " + ", ".join(
            f"{x:.1f}" for x in out["admitting_ms"])
        + ", the steps after it " + ", ".join(
            f"{x:.1f}" for x in out["after_ms"])
        + f"; a prefill {admits[0]:.1f}-{admits[-1]:.1f} ms ({smi})")
    if not read <= ceiling:
        raise AssertionError(f"[auto] {cand} reads {read} tokens/s, above "
                             f"its physical ceiling {ceiling:.2f}")
    return out


def _config_only(cfg, path: Path) -> str:
    """A model directory holding ``cfg``'s ``config.json`` and no weights
    (``_loading`` hands the weights over): the predictor reads its config
    from there without the phase writing an 8B artifact to disk."""
    from kubedl_tpu_torch.models import io
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(
        {"family": io.family_name(cfg), "config": cfg.to_dict()}))
    return str(path)


def _loading(models: dict):
    """``models.io.load_model`` answering each path of ``models`` with its
    ``(config, params)`` already on the card."""
    from kubedl_tpu_torch.models import io
    return unittest.mock.patch.object(
        io, "load_model", lambda path, device=None, select=None:
        models[path])


def phase_auto(torch, cfg, params) -> dict:
    """The serving auto-configurator (``serving/autoconfig.py``) on the
    card: ``autoconfigure_multi`` over the serving phases' Llama-3-8B
    (full width, bf16, seed 0) with its first layers as the draft, every
    probe printed (each probe's seconds read by wrapping
    ``probe_candidate``); the winner must meet the SLO or be the
    least-violating probe; ``kv_cache_bytes`` of ``Candidate(batch=8)`` at
    max_len 1024 must equal the bytes of the KV pool the engine allocates;
    then the winner's ``to_env()`` goes through the predictor's env reader
    (``serving.__main__.engine_settings``) into ``build_engine``, whose
    engine serves [cont]'s first requests, held to the teacher-forced
    reference by the near-tie rule. Every engine run of the search is
    recorded (``_recording_runs``): each probe must read at most its
    physical ceiling (``_probe_runs``); the repeats it measured again and
    its timed runs' admitting steps against the steps after them are
    printed."""
    import dataclasses
    import inspect

    from kubedl_tpu_torch.serving import (Candidate, ContinuousBatchingEngine,
                                          ServingSLO, autoconfig,
                                          autoconfigure_multi)
    from kubedl_tpu_torch.serving import __main__ as serve_main

    draft = (dataclasses.replace(cfg, n_layers=AUTO_DRAFT_LAYERS),
             _first_layers(params, AUTO_DRAFT_LAYERS))
    free, _ = torch.cuda.mem_get_info()
    slo = ServingSLO(**AUTO_SLO)
    probes, runs, read = [], [], []
    real = autoconfig.probe_candidate
    repeats = inspect.signature(real).parameters["repeats"].default
    smi = _card()

    def timed_probe(model, cand, **kw):
        mark = len(runs)
        t0 = time.perf_counter()
        probe = real(model, cand, **kw)
        probes.append((cand, time.perf_counter() - t0))
        log(f"[auto] probe {cand}: {probe} in {probes[-1][1]:.2f} s")
        if probe is not None:
            read.append({"cand": str(cand), **_probe_runs(
                cand, probe, runs[mark:], kw.get("repeats", repeats), smi)})
        gc.collect()
        torch.cuda.empty_cache()
        return probe
    t0 = time.perf_counter()
    with unittest.mock.patch.object(autoconfig, "probe_candidate",
                                    timed_probe), _recording_runs(torch,
                                                                  runs):
        res = autoconfigure_multi((cfg, params), draft, slo=slo,
                                  hbm_budget_bytes=free, device="cuda",
                                  **AUTO_SEARCH)
    search_s = time.perf_counter() - t0
    BUILD_OUT.mkdir(parents=True, exist_ok=True)
    (BUILD_OUT / "auto_runs.json").write_text(json.dumps(read, indent=1))
    timed = [run for r in read for run in r["runs"][3:]]
    log(f"[auto] {sum(r['remeasured'] for r in read)} repeat(s) measured "
        f"again over {len(read)} probes; over the {len(timed)} timed runs "
        f"at most {max(r['gc_ms'] for r in timed):.2f} ms of garbage "
        f"collection a run, {sum(r['mallocs'] for r in timed)} cudaMalloc "
        f"calls, {sum(r['captures'] for r in timed)} graph captures (every "
        f"run in {BUILD_OUT / 'auto_runs.json'})")
    best = res.best_probe
    least = min(res.measurements, key=slo.violation)
    if not (slo.met_by(best) or slo.violation(best)
            == slo.violation(least)):
        raise AssertionError(f"[auto] the winner {res.best} neither meets "
                             f"{slo} nor violates it least: {best}")
    log(f"[auto] {len(res.measurements)} probes in {search_s:.1f} s under "
        f"{slo} (budget {free / 2**30:.2f} GiB free after the weights); "
        f"winner {res.best}, probe {best}, meets the SLO "
        f"{slo.met_by(best)} ({smi})")

    # the pool the engine allocates, against the auto-configurator's price
    eng = ContinuousBatchingEngine(cfg, params, lanes=8, max_len=1024,
                                   device="cuda")
    pool = sum(t.numel() * t.element_size() for t in eng._pool.values())
    priced = autoconfig.kv_cache_bytes(cfg, Candidate(batch=8), 1024)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if pool != priced:
        raise AssertionError(f"[auto] kv_cache_bytes {priced} != the "
                             f"engine's pool {pool} bytes")
    log(f"[auto] kv_cache_bytes(Candidate(batch=8), max_len 1024) = "
        f"{priced} bytes = the engine's paged pool")

    # the winner's env through the predictor's reader into its engine
    out_dir = BUILD_OUT / "auto"
    env = res.to_env()
    paths = {_config_only(cfg, out_dir / "model"): (cfg, params)}
    if res.best.speculative_k:
        env["KUBEDL_SERVING_DRAFT_PATH"] = _config_only(draft[0],
                                                        out_dir / "draft")
        paths[env["KUBEDL_SERVING_DRAFT_PATH"]] = draft
    settings = serve_main.engine_settings(env)
    with _loading(paths):
        eng = serve_main.build_engine(next(iter(paths)), **settings,
                                      device="cuda")
    _, reqs = _cont_requests(cfg)
    reqs = reqs[:AUTO_SERVED]
    try:
        t0 = time.perf_counter()
        got, lps = _run(eng, reqs)
        serve_s = time.perf_counter() - t0
    finally:
        eng.stop()
    # the reference runs the weights the engine served (int8 ones, if the
    # winner quantizes)
    held = _hold(torch, cfg, eng.params, reqs, got,
                 f"[auto] the winner's env {env} through build_engine",
                 lps=lps)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"measurements": res.measurements,
            "probe_s": [(str(c), s) for c, s in probes],
            "search_s": search_s, "best": dataclasses.asdict(res.best),
            "best_probe": best, "meets_slo": slo.met_by(best),
            "env": env, "settings": settings, "pool_bytes": pool,
            "serve_s": serve_s, "served": held}


# -- slice 19: the federation day -------------------------------------------

#: [fed]: the three-region topology of the JAX package's federation tests
FED_TOPOLOGY = ("us-east,us-west,eu-west;us-east~us-west=65/0.02;"
                "us-east~eu-west=140/0.05;us-west~eu-west=150/0.05")


def _federation_day(device, model=None, on_engine=None) -> tuple:
    """(the federation object, its result, its journals' bytes) of one
    ``FederationReplay`` of ``FED_TOPOLOGY`` at seed 0, its journals in a
    temporary directory under the build folder, removed after the day;
    ``on_engine`` is handed every engine the fleets' factory builds (the
    evacuation may build more)."""
    import shutil
    import tempfile

    from kubedl_tpu_torch.federation import FederationReplay, RegionTopology
    from kubedl_tpu_torch.serving import batching

    real = batching.ContinuousBatchingEngine

    class Recorded(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            if on_engine is not None:
                on_engine(self)
    BUILD_OUT.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="fed-", dir=BUILD_OUT)
    try:
        with unittest.mock.patch.object(batching, "ContinuousBatchingEngine",
                                        Recorded):
            fed = FederationReplay(RegionTopology.parse(FED_TOPOLOGY), root,
                                   seed=0, model=model, device=device)
            res = fed.run()
        return fed, res, _dir_bytes(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_fed(torch, cfg, params) -> dict:
    """The federation day (``federation/replay.py``): three regions in
    lockstep on one sim clock, each a journaled, replicated control plane
    with its scheduler and elastic gate and a two-replica serving fleet,
    one region evacuated mid-day. On the card its six engines share the
    serving phases' Llama-3-8B bf16 weights (nothing writes them), at full
    width and depth; the day is held key by key, and its live status
    document too, to the same day on the CPU on the replays' tiny float32
    model (every request has a fixed ``max_new`` and no stop token, so
    what the day observes is scheduling). Every decode tick of every
    engine takes the graph route; K1-K3 launches are counted (none are
    expected: the engines decode by einsum over the cache)."""
    from kubedl_tpu_torch.ops import attention as attn
    tag = "[fed]"
    t0 = time.perf_counter()
    cpu_fed, want, _ = _federation_day("cpu")
    cpu_s = time.perf_counter() - t0
    engines, host = [], []

    def built(eng):
        engines.append(eng)
        host.append(_host_timer(eng, "step"))
    _reset_counts(attn)
    t0 = time.perf_counter()
    fed, got, journal_bytes = _federation_day("cuda", (cfg, params), built)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts(attn, tag)
    _same_day(f"{tag} the federation day", got, want)
    if fed.status() != cpu_fed.status():
        raise AssertionError(f"{tag}: the live status differs from the "
                             f"CPU day's: {fed.status()} != "
                             f"{cpu_fed.status()}")
    jobs, serving = got["jobs"], got["serving"]
    lost = [e["ackObjectsLost"] for e in got["evacuations"].values()]
    if not (len(engines) == 6 and jobs["completed"] == jobs["submitted"]
            and serving["completed_ok"] == serving["streams"] > 0
            and lost and not any(lost)
            and got["slo_health"]["stranded_alerts"] == 0
            and got["forensics"]["summary"]["pages_unlinked"] == 0):
        raise AssertionError(f"{tag}: {len(engines)} engines, jobs {jobs}, "
                             f"serving {serving}, lost {lost}, "
                             f"{got['slo_health']}")
    ticks = [_graph_only(eng, f"{tag} engine {i}")
             for i, eng in enumerate(engines)]
    steps = [x for h in host for x in h]
    out = {"wall_s": wall, "cpu_s": cpu_s, "rounds": got["rounds"],
           "ticks": sum(t["graph"] for t in ticks), "tick_launches": ticks,
           "replica_steps": len(steps), "host_ms_median": _median_ms(steps),
           "launches": launches, "journal_bytes": journal_bytes,
           "jobs": jobs["completed"], "streams": serving["completed_ok"],
           "rerouted": serving["rerouted"]}
    log(f"{tag} the federation day on Llama-3-8B bf16, 3 regions x 2 "
        f"replicas sharing the weights, one region evacuated: "
        f"{jobs['completed']}/{jobs['submitted']} jobs, "
        f"{serving['completed_ok']}/{serving['streams']} streams "
        f"({serving['rerouted']} rerouted), {got['rounds']} rounds, "
        f"{out['ticks']} decode ticks (all graph, by engine "
        f"{[t['graph'] for t in ticks]}) in {wall:.2f} s; median host "
        f"{out['host_ms_median']:.3f} ms over {len(steps)} replica steps; "
        f"K1-K3 launches {launches}; journals {journal_bytes} bytes "
        f"(removed); the CPU day {cpu_s:.2f} s; equal key by key "
        f"({_card()})")
    del fed, engines, host
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _reset_counts(attn) -> None:
    for fn in (attn.flash_forward, attn.flash_dq, attn.flash_dkv):
        fn.launches = 0
        fn.launches_by_route = {"sm90": 0, "simt": 0}
    _bank_d1()


#: the decode attention kernel's calls in the running phase (``main``'s
#: ``timed`` clears it before each phase and reads it after): launches on
#: the card, graph replays included, and calls by route
D1_TALLY = {"launches": 0, "sm90": 0, "plain": 0}


def _bank_d1() -> None:
    """Add ``ops.decode.paged_decode``'s counts to :data:`D1_TALLY` and set
    them to 0."""
    from kubedl_tpu_torch.ops import decode
    fn = decode.paged_decode
    D1_TALLY["launches"] += fn.launches
    for route, n in fn.launches_by_route.items():
        D1_TALLY[route] += n
    fn.launches = 0
    fn.launches_by_route = {"sm90": 0, "plain": 0}


def _read_counts(attn, tag, want=None) -> dict:
    """The three kernels' launches since :func:`_reset_counts`, every one
    on ``sm90``; ``want`` pins the counts."""
    got = {fn.__name__: fn.launches
           for fn in (attn.flash_forward, attn.flash_dq, attn.flash_dkv)}
    for fn in (attn.flash_forward, attn.flash_dq, attn.flash_dkv):
        if fn.launches_by_route.get("simt", 0):
            raise AssertionError(f"{tag}: {fn.__name__} took the simt route "
                                 f"{fn.launches_by_route}")
    if want is not None and got != want:
        raise AssertionError(f"{tag}: launched {got}, want {want}")
    return got


def _gb_s(nbytes, seconds) -> str:
    return f"{nbytes / 1e9:.3f} GB in {seconds:.2f} s, " \
        f"{nbytes / 1e9 / max(seconds, 1e-9):.2f} GB/s"


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def _convert(args, tag) -> tuple:
    """``python -m kubedl_tpu_torch.models.convert`` as a subprocess (its
    default device: the card). Returns (seconds, its report line)."""
    import os
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "kubedl_tpu_torch.models.convert", *args],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
        capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{tag}: convert {args} exited "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    return seconds, res.stdout.strip().splitlines()[-1]


def phase_hf(torch, layers=None) -> tuple:
    """Gemma-2B at full width through a HuggingFace directory, ``layers``
    deep (default :data:`SLICE10_LAYERS`): random bf16 weights from seed
    10 (norm scales drawn bf16-representable), written by the port's
    safetensors writer in HF's key layout as two shards and
    ``model.safetensors.index.json`` with google/gemma-2b's published
    config (its depth cut); ``python -m kubedl_tpu_torch.models.convert``
    on it as a subprocess. Gates: the artifact's config is ``gemma_2b()``
    but for ``vocab_size``, ``rms_eps`` and the depth; every loaded leaf
    equals the drawn one;
    4 greedy requests on the converted model equal those on the drawn
    weights token for token; ``/v1/embeddings`` launches K1 once a layer,
    on ``sm90``; ``--reverse`` writes tensors equal to the input's widened
    to float32. Returns (config, the converted params, artifact path,
    readings)."""
    import dataclasses
    import shutil

    import numpy as np

    from kubedl_tpu_torch.models import convert, gemma, io, llama
    from kubedl_tpu_torch.models import safetensors_io as sio
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.serving import (GenerateConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)
    from kubedl_tpu_torch.tokenizer import ByteTokenizer
    from kubedl_tpu_torch.train.trainer import tree_leaves

    shutil.rmtree(SLICE10_OUT, ignore_errors=True)
    SLICE10_OUT.mkdir(parents=True)
    src, art, back = (SLICE10_OUT / "hf_gemma_2b", SLICE10_OUT / "artifact",
                      SLICE10_OUT / "hf_reverse")
    out = {}
    hf_config = dict(HF_GEMMA_2B,
                     num_hidden_layers=layers or SLICE10_LAYERS)
    cfg = convert.config_from_hf(hf_config)
    want_cfg = dataclasses.replace(
        gemma.gemma_2b(), vocab_size=hf_config["vocab_size"],
        rms_eps=hf_config["rms_norm_eps"],
        n_layers=hf_config["num_hidden_layers"])
    if cfg != want_cfg:
        raise AssertionError(f"[hf] config_from_hf gave {cfg}")
    g = torch.Generator(device="cuda").manual_seed(10)
    drawn = llama.init_params(cfg, g, device="cuda")
    for k, (shape, f32) in llama.param_shapes(cfg)["layers"].items():
        if f32:
            drawn["layers"][k].copy_((0.1 * torch.randn(
                drawn["layers"][k].shape, generator=g, device="cuda"))
                .bfloat16().float())
    drawn["final_norm"].copy_((0.1 * torch.randn(
        cfg.d_model, generator=g, device="cuda")).bfloat16().float())

    # the HF state dict on the host, bf16, [out, in]
    t0 = time.perf_counter()
    stacks = {k: (v.to(torch.bfloat16).mT if v.ndim == 3 else
                  v.to(torch.bfloat16)).contiguous().cpu()
              for k, v in drawn["layers"].items()}
    sd = {"model.embed_tokens.weight": drawn["embed"].cpu(),
          "model.norm.weight": drawn["final_norm"].bfloat16().cpu()}
    for i in range(cfg.n_layers):
        for k, name in HF_LAYER_NAMES.items():
            sd[f"model.layers.{i}.{name}"] = stacks[k][i]
    host_s = time.perf_counter() - t0
    src.mkdir()
    (src / "config.json").write_text(json.dumps(hf_config, indent=1))
    half = (cfg.n_layers + 1) // 2
    shards = {"model-00001-of-00002.safetensors": [
        k for k in sd if k == "model.embed_tokens.weight"
        or (k.startswith("model.layers.") and int(k.split(".")[2]) < half)]}
    shards["model-00002-of-00002.safetensors"] = [
        k for k in sd if k not in shards["model-00001-of-00002.safetensors"]]
    t0 = time.perf_counter()
    for name, keys in shards.items():
        sio.save_file({k: sd[k] for k in keys}, str(src / name),
                      metadata={"format": "pt"})
    (src / "model.safetensors.index.json").write_text(json.dumps({
        "metadata": {"total_size": sum(t.numel() * 2 for t in sd.values())},
        "weight_map": {k: n for n, keys in shards.items() for k in keys}}))
    out["hf_write_s"] = time.perf_counter() - t0
    out["hf_bytes"] = _dir_bytes(src)
    log(f"[hf] Gemma-2B width, {cfg.n_layers} of 18 layers: "
        f"{cfg.num_params / 1e9:.3f} B params, bf16 from seed 10; the "
        f"HF directory (2 shards + index, google/gemma-2b's config): "
        f"{_gb_s(out['hf_bytes'], out['hf_write_s'])} (host copy "
        f"{host_s:.2f} s before)")

    out["convert_s"], line = _convert([str(src), str(art)], "[hf]")
    out["artifact_bytes"] = _dir_bytes(art)
    log(f"[hf] convert subprocess: {out['convert_s']:.2f} s wall, "
        f"{out['hf_bytes'] / 1e9:.3f} GB in, {out['artifact_bytes'] / 1e9:.3f}"
        f" GB out; it reports: {line}")
    got_cfg = io.read_config(str(art))
    if got_cfg != want_cfg:
        raise AssertionError(f"[hf] the artifact's config {got_cfg} is not "
                             f"{want_cfg}")
    t0 = time.perf_counter()
    _, params = io.load_model(str(art), device="cuda")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    moved = [k for (k, a), (_, b) in zip(tree_leaves(params),
                                         tree_leaves(drawn))
             if a.dtype != b.dtype or not torch.equal(a, b)]
    log(f"[hf] artifact loaded: {_gb_s(out['artifact_bytes'], out['load_s'])}"
        f"; leaves unequal to the drawn weights: {moved or 'none'}")
    if moved:
        raise AssertionError(f"[hf] converted leaves {moved} differ")

    rng = np.random.default_rng(12)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in (31, 97, 256, 512)]
    runs = {}
    for label, p in (("drawn", drawn), ("converted", params)):
        eng = InferenceEngine(cfg, p, GenerateConfig(max_len=1024),
                              device="cuda")
        runs[label] = eng.generate(prompts, 16)
        del eng
    if runs["drawn"] != runs["converted"]:
        raise AssertionError("[hf] greedy tokens differ between the drawn "
                             "and the converted weights")
    log(f"[hf] 4 greedy requests (prompts 31-512 tokens, 16 new): converted "
        f"== drawn token for token ({sum(map(len, runs['drawn']))} tokens)")
    del drawn
    gc.collect()
    torch.cuda.empty_cache()

    eng = InferenceEngine(cfg, params, GenerateConfig(max_len=1024),
                          device="cuda")
    srv = InferenceServer(eng, ServerConfig(
        model_name="gemma-2b-hf", host="127.0.0.1", port=0,
        tokenizer=ByteTokenizer())).start()
    try:
        _reset_counts(attn)
        emb = json.loads(_post(srv.url, "/v1/embeddings", {
            "input": ["converted from a HuggingFace directory " * 6,
                      "kubedl " * 40]}))
        out["launches"] = {"hf_serve": _read_counts(
            attn, "[hf] /v1/embeddings",
            want={"flash_forward": cfg.n_layers, "flash_dq": 0,
                  "flash_dkv": 0})}
    finally:
        srv.stop()
    del eng
    vecs = np.asarray([d["embedding"] for d in emb["data"]])
    if vecs.shape != (2, cfg.d_model) or not np.isfinite(vecs).all():
        raise AssertionError(f"[hf] bad embeddings {vecs.shape}")
    log(f"[hf] /v1/embeddings on the converted model: {cfg.n_layers} K1 "
        f"launches, all sm90")

    out["reverse_s"], line = _convert(["--reverse", str(art), str(back)],
                                      "[hf]")
    out["reverse_bytes"] = _dir_bytes(back)
    t0 = time.perf_counter()
    exported = sio.load_file(str(back / "model.safetensors"))
    bad = sorted(set(exported) ^ set(sd))
    bad += [k for k in sd if k in exported and not (
        exported[k].dtype == torch.float32
        and torch.equal(exported[k], sd[k].float()))]
    out["reverse_check_s"] = time.perf_counter() - t0
    hf_cfg = json.loads((back / "config.json").read_text())
    log(f"[hf] --reverse subprocess: {out['reverse_s']:.2f} s wall, "
        f"{out['reverse_bytes'] / 1e9:.3f} GB out; it reports: {line}; read "
        f"back and compared in {out['reverse_check_s']:.2f} s; tensors "
        f"unequal to the input widened to float32: {bad or 'none'}; "
        f"model_type {hf_cfg['model_type']}")
    if bad or hf_cfg["model_type"] != "gemma":
        raise AssertionError(f"[hf] --reverse differs at {bad[:4]}")
    del exported, sd, stacks
    shutil.rmtree(src)
    shutil.rmtree(back)
    return cfg, params, art, out


def _tokens_file(name, vocab, rows, seed) -> str:
    import numpy as np
    path = SLICE10_OUT / name
    np.random.default_rng(seed).integers(0, vocab, rows * 2049,
                                         dtype=np.int32).tofile(path)
    return str(path)


def _write_config(name, cfg) -> str:
    path = SLICE10_OUT / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


#: the in-cluster job of [life]: its identity, and the checkpoint version
#: the stub API server requests at step 2 of run (a)
LIFE_JOB = {"KUBEDL_JOB_KIND": "PyTorchJob", "KUBEDL_JOB_NAMESPACE": "default",
            "KUBEDL_JOB_NAME": "life"}
LIFE_VERSION = 7


class _StubJobServer:
    """A stub API server holding one PyTorchJob: GET and merge-PATCH on
    the job's path, 404 elsewhere (stdlib ``http.server`` on a free
    localhost port; the elastic agent reaches it through the port's
    ``KubeAPIServer``). :meth:`request` raises the checkpoint request as
    the operator's scale-in would."""

    def __init__(self, namespace: str, name: str):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.path = (f"/apis/training.kubedl.io/v1alpha1/namespaces/"
                     f"{namespace}/pytorchjobs/{name}")
        self.job = {"apiVersion": "training.kubedl.io/v1alpha1",
                    "kind": "PyTorchJob", "metadata": {
                        "name": name, "namespace": namespace,
                        "annotations": {}}, "spec": {}}
        self.calls = {"GET": 0, "PATCH": 0}
        self.lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _send(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _answer(self, method, patch=None):
                if self.path != stub.path:
                    return self._send(404, {"kind": "Status", "code": 404,
                                            "message": "not found"})
                with stub.lock:
                    stub.calls[method] += 1
                    if patch is not None:
                        _merge_patch(stub.job, patch)
                    body = json.loads(json.dumps(stub.job))
                self._send(200, body)

            def do_GET(self):
                self._answer("GET")

            def do_PATCH(self):
                n = int(self.headers.get("Content-Length") or 0)
                self._answer("PATCH", json.loads(self.rfile.read(n)))

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def annotations(self) -> dict:
        with self.lock:
            return dict(self.job["metadata"]["annotations"])

    def request(self, version: int) -> None:
        from kubedl_tpu_torch.train.checkpoint import \
            ANNOTATION_CKPT_REQUESTED_VERSION
        with self.lock:
            self.job["metadata"]["annotations"][
                ANNOTATION_CKPT_REQUESTED_VERSION] = str(version)

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def _merge_patch(target: dict, patch: dict) -> None:
    """RFC 7386 merge patch in place: dicts merge, null deletes."""
    for k, v in patch.items():
        if v is None:
            target.pop(k, None)
        elif isinstance(v, dict) and isinstance(target.get(k), dict):
            _merge_patch(target[k], v)
        else:
            target[k] = v


def _pytorchjob_master_env() -> dict:
    """What the operator renders for the master of a one-pod PyTorchJob,
    the master's address on this host: the group opens over NCCL."""
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
            "RANK": "0", "WORLD_SIZE": "1"}


def _lifecycle_runs(torch, attn, train_main, ck, cfg, art, out) -> None:
    """The in-cluster job: (a) two steps with an eval at step 2 under the
    PyTorchJob master's env (a world-size-1 NCCL group, DTensor state),
    where the stub API server requests a checkpoint and the elastic agent
    takes it and acknowledges; (b) a fresh job on the same directory
    taking two more steps (it resumes at step 2 and runs steps 3-4:
    ``steps`` counts the steps a run takes, as in the JAX entry point)
    with the agent polling, in the cluster but with no rendezvous
    contract: one process and no process group, so it restores (a)'s
    sharded save into plain tensors and its own save at step 4 is of
    plain tensors, read back bit for bit after it; (c) four steps, one
    process, with no checkpoint and so no agent."""
    from kubedl_tpu_torch.core.kubeclient import ClusterConfig, KubeAPIServer
    from kubedl_tpu_torch.parallel.sharding import local_of

    L = cfg.n_layers
    card = _card()
    base = {"model": {"model_path": str(art)}, "mode": "pretrain",
            "data": {"kind": "tokens", "path": _tokens_file(
                "lifecycle_tokens.bin", cfg.vocab_size, 8, 1)},
            "batch": 2, "seq": 2048, "seed": 0, "log_every": 1,
            "optimizer": {"warmup_steps": 1}}
    # no periodic saves: the elastic save at step 2 is (a)'s one
    # checkpoint, and (b) saves once, at its end
    ckpt = {"directory": str(SLICE10_OUT / "ckpt"), "save_interval_steps": 0,
            "max_to_keep": 1}
    stub = _StubJobServer(LIFE_JOB["KUBEDL_JOB_NAMESPACE"],
                          LIFE_JOB["KUBEDL_JOB_NAME"])
    in_cluster = {**LIFE_JOB, "KUBERNETES_SERVICE_HOST": "127.0.0.1",
                  "KUBERNETES_SERVICE_PORT": str(stub.port)}
    saved, managers, checked, writes, polls = {}, [], {}, [], []
    init, write = ck.CheckpointManager.__init__, ck.CheckpointManager._write
    restore_or = ck.CheckpointManager.restore_or
    poll = ck.ElasticCheckpointAgent.poll

    def record_init(self, config):
        init(self, config)
        managers.append(self)

    def record_write(self, step, host, data_state):
        # each save's host copy, kept for the checks of what is read back
        writes.append(step)
        saved[step] = (host, data_state)
        return write(self, step, host, data_state)

    def unequal(cur, host) -> tuple:
        """(leaves, the paths of those unequal) of a state dict against
        a saved host copy (a DTensor's local shard is all of it at one
        process)."""
        pairs = [(k, (local_of(a), local_of(b)))
                 for k, (a, b) in _pairs_of(cur, host)]
        return len(pairs), [
            k for k, (a, b) in pairs
            if a.dtype != b.dtype or not torch.equal(a, b.to(a.device))]

    def check_restore(self, state, init_fn):
        got = restore_or(self, state, init_fn)
        if not saved:                    # (a): nothing on disk yet
            return got
        host, data_state = saved[2]
        leaves, bad = unequal(ck._state_dict(got, copy_to_host=False), host)
        checked.update(step=got.step, count=got.opt_state.count, bad=bad,
                       cursor=self.latest_data_state() == data_state,
                       leaves=leaves,
                       group=torch.distributed.is_initialized())
        return got

    def timed_poll(self, state):
        t0 = time.perf_counter()
        took = poll(self, state)
        polls.append((int(state.step), took, time.perf_counter() - t0))
        return took

    patches = [unittest.mock.patch.object(ck.CheckpointManager, "__init__",
                                          record_init),
               unittest.mock.patch.object(ck.CheckpointManager, "_write",
                                          record_write),
               unittest.mock.patch.object(ck.CheckpointManager, "restore_or",
                                          check_restore),
               unittest.mock.patch.object(ck.ElasticCheckpointAgent, "poll",
                                          timed_poll)]
    api = KubeAPIServer(ClusterConfig(server=stub.url))
    for p in patches:
        p.start()
    try:
        marks, counts = [], {}

        def step_a(step, loss):
            marks.append((time.perf_counter(), step, loss))
            if step == 2:
                counts["train"] = _read_counts(attn, "[life] (a) training")
                stub.request(LIFE_VERSION)   # the operator's scale-in

        _reset_counts(attn)
        t0 = time.perf_counter()
        _with_env({**_pytorchjob_master_env(), **in_cluster},
                  train_main.main, ["--config", _write_config("life_a", {
                      **base, "steps": 2, "checkpoint": ckpt,
                      "eval": {"every": 2, "max_batches": 1, "data": {
                          "kind": "tokens", "path": _tokens_file(
                              "lifecycle_eval.bin", cfg.vocab_size, 2,
                              2)}}})], None, step_a, api)
        out["a_s"] = time.perf_counter() - t0
        total = _read_counts(attn, "[life] (a)")
        out["launches"]["lifecycle_train"] = counts["train"]
        out["launches"]["lifecycle_eval"] = {
            k: total[k] - counts["train"][k] for k in total}
        want_train = {"flash_forward": 4 * L, "flash_dq": 2 * L,
                      "flash_dkv": 2 * L}
        if counts["train"] != want_train or \
                out["launches"]["lifecycle_eval"] != {
                    "flash_forward": L, "flash_dq": 0, "flash_dkv": 0}:
            raise AssertionError(f"[life] (a) launched {counts['train']} "
                                 f"training, {total} in all")
        ann = stub.annotations()
        acked = (ann.get(ck.ANNOTATION_CKPT_REQUESTED_VERSION),
                 ann.get(ck.ANNOTATION_CKPT_COMPLETED_VERSION))
        out["elastic"] = {"requested": acked[0], "completed": acked[1],
                          "polls_a": [(s, t) for s, t, _ in polls],
                          "writes": list(writes), "api_calls": dict(
                              stub.calls)}
        if acked != (str(LIFE_VERSION),) * 2 or \
                [(s, t) for s, t, _ in polls] != [(1, False), (2, True)] \
                or writes != [2] or stub.calls["PATCH"] != 1:
            raise AssertionError(f"[life] (a) the elastic checkpoint: "
                                 f"{out['elastic']}")
        save = dict(managers[-1].last_save)
        out["checkpoint_bytes"] = save["bytes"]
        out["save_copy_s"], out["save_write_s"] = save["copy_s"], \
            save["write_s"]
        out["elastic_poll_s"] = polls[-1][2]
        out["checkpoint_disk_bytes"] = _dir_bytes(Path(ckpt["directory"]))
        a_losses = [m[2] for m in marks]
        log(f"[life] (a) the in-cluster job, 2 steps from the artifact and "
            f"an eval at step 2, a PyTorchJob master's env (NCCL group of 1)"
            f": {out['a_s']:.1f} s wall; losses "
            f"{[round(x, 4) for x in a_losses]}; the stub API server "
            f"requested checkpoint v{LIFE_VERSION} at step 2, the agent "
            f"saved at step {save['step']} and acknowledged v{acked[1]} "
            f"({stub.calls['GET']} GETs, {stub.calls['PATCH']} PATCH); "
            f"checkpoint {save['bytes'] / 1e9:.3f} GB (params bf16, mu f32, "
            f"nu bf16; {out['checkpoint_disk_bytes'] / 1e9:.3f} GB on disk, "
            f"the run's only save): elastic save's host copy "
            f"{_gb_s(save['bytes'], save['copy_s'])}, write "
            f"{_gb_s(save['bytes'], save['write_s'])}, the whole poll "
            f"{polls[-1][2]:.3f} s; launches: training {counts['train']}, "
            f"eval {out['launches']['lifecycle_eval']}, all sm90; {card}")

        resumed, b_marks = [], []

        def step_b(step, loss):
            b_marks.append(time.perf_counter())
            resumed.append((step, loss))

        _reset_counts(attn)
        t0 = time.perf_counter()
        _with_env(in_cluster, train_main.main, ["--config", _write_config(
            "life_b", {**base, "steps": 2, "checkpoint": ckpt})], None,
            step_b, api)
        out["b_s"] = time.perf_counter() - t0
        out["launches"]["lifecycle_resume"] = _read_counts(
            attn, "[life] (b)", want=want_train)
        restore = dict(managers[-1].last_restore)
        out["restore_s"] = restore["seconds"]
        log(f"[life] (b) a fresh job on the same directory: restored step "
            f"{checked.get('step')} (count {checked.get('count')}), "
            f"{_gb_s(restore['bytes'], restore['seconds'])}; "
            f"{checked.get('leaves')} leaves (step, count, params, mu, nu) "
            f"against what (a) saved, unequal: {checked.get('bad') or 'none'};"
            f" data cursor equal: {checked.get('cursor')}; then steps "
            f"{[s for s, _ in resumed]} in {out['b_s']:.1f} s wall")
        if checked.get("step") != 2 or checked.get("count") != 2 or \
                checked.get("bad") or not checked.get("cursor") or \
                checked.get("group") is not False or \
                [s for s, _ in resumed] != [3, 4] or \
                [(s, t) for s, t, _ in polls[2:]] != [(3, False),
                                                     (4, False)] or \
                writes != [2, 4]:
            raise AssertionError(f"[life] the resume is not (a)'s state: "
                                 f"{checked}, steps {resumed}, polls "
                                 f"{polls}, writes {writes}")
        # (b)'s save at step 4, of plain tensors with no process group,
        # read back into host zeros through the manager's restore
        host, data_state = saved[4]
        kinds = {type(t).__name__ for t in ck._leaves(host)}
        zeros = ck.tree_map(torch.zeros_like, host)
        template = ck.TrainState(
            step=0, params=zeros["params"], opt_state=ck.AdamState(
                count=0, mu=zeros["opt_state"]["mu"],
                nu=zeros["opt_state"]["nu"]))
        reader = ck.CheckpointManager(ck.CheckpointConfig(ckpt["directory"]))
        t0 = time.perf_counter()
        got = reader.restore(template, step=4)
        leaves, bad = unequal(ck._state_dict(got, copy_to_host=False), host)
        out["plain_save"] = {
            "step": got.step, "count": got.opt_state.count, "leaves": leaves,
            "unequal": bad, "kinds": sorted(kinds),
            "cursor": reader.latest_data_state(4) == data_state,
            "read_s": time.perf_counter() - t0}
        log(f"[life] (b)'s save at step 4 ({sorted(kinds)} leaves, no "
            f"process group) read back: step {got.step}, count "
            f"{got.opt_state.count}, {leaves} leaves, unequal: "
            f"{bad or 'none'}; cursor equal: {out['plain_save']['cursor']}"
            f"; {out['plain_save']['read_s']:.2f} s")
        if got.step != 4 or got.opt_state.count != 4 or bad or \
                kinds != {"Tensor"} or \
                not out["plain_save"]["cursor"]:
            raise AssertionError(f"[life] (b)'s plain save read back "
                                 f"unequal: {out['plain_save']}")
    finally:
        for p in patches:
            p.stop()
        stub.close()
    import shutil
    shutil.rmtree(ckpt["directory"])
    saved.clear()

    whole, c_marks = [], []

    def step_c(step, loss):
        c_marks.append(time.perf_counter())
        whole.append((step, loss))

    _reset_counts(attn)
    t0 = time.perf_counter()
    train_main.main(["--config", _write_config("life_c", {
        **base, "steps": 4})], on_step=step_c)
    out["c_s"] = time.perf_counter() - t0
    gaps = [abs(a[1] - b[1]) for a, b in zip(resumed, whole[2:])]
    out["resume_gap"] = max(gaps)
    out["resume_bit_identical"] = [x for _, x in resumed] == \
        [x for _, x in whole[2:]]
    idle = sorted(t for _, took, t in polls if not took)
    out["poll_ms"] = {"median": 1e3 * idle[len(idle) // 2],
                      "max": 1e3 * idle[-1], "n": len(idle)}
    # step 4's interval (on_step of step 3 to step 4's): with the agent's
    # poll in (b), without an agent in (c)
    out["step_s_agent"] = b_marks[1] - b_marks[0]
    out["step_s_plain"] = c_marks[3] - c_marks[2]
    out["card"] = card
    log(f"[life] (c) 4 steps, one process, no checkpoint and no agent: "
        f"losses {[round(x, 4) for _, x in whole]}; (b) at steps 3-4 "
        f"{[round(x, 6) for _, x in resumed]} against (c) "
        f"{[round(x, 6) for _, x in whole[2:]]}: largest gap "
        f"{out['resume_gap']:.3e} (limit {RESUME_ATOL}), bit for bit: "
        f"{out['resume_bit_identical']}; (c) {out['c_s']:.1f} s wall")
    log(f"[life] the agent's poll (a GET of the job over HTTP) took "
        f"{out['poll_ms']['median']:.3f} ms median, "
        f"{out['poll_ms']['max']:.3f} ms max on the host over the "
        f"{len(idle)} steps without a request; step 4 took "
        f"{out['step_s_agent']:.4f} s with the agent ((b)) and "
        f"{out['step_s_plain']:.4f} s without ((c)); {card}")
    if out["resume_gap"] > RESUME_ATOL or \
            not all(math.isfinite(x) for _, x in whole):
        raise AssertionError(f"[life] resumed losses {resumed} against "
                             f"{whole}")


def _pairs_of(cur, host) -> list:
    """Matched (path, (tensor, saved host tensor)) over two state dicts."""
    from kubedl_tpu_torch.train.trainer import tree_leaves
    a, b = dict(tree_leaves(cur)), dict(tree_leaves(host))
    if set(a) != set(b):
        raise AssertionError(f"state dicts differ in keys: "
                             f"{sorted(set(a) ^ set(b))[:4]}")
    return [(k, (a[k], b[k])) for k in sorted(a)]


def _evaluate_runs(torch, attn, train_main, cfg, params, art, out) -> None:
    """``mode: evaluate`` on the artifact over a byte-tokenized corpus
    (perplexity) and 8 multiple-choice questions, each held to this
    script's own float32 NLL from ``llama.forward``'s full logits."""
    import numpy as np

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel.mesh import build_mesh
    from kubedl_tpu_torch.tokenizer import ByteTokenizer

    corpus = SLICE10_OUT / "corpus.txt"
    rng = np.random.default_rng(13)
    words = ("kernel", "tensor", "core", "card", "port", "checkpoint",
             "resume", "gradient", "the", "a", "of", "runs", "on", "held")
    corpus.write_text("\n".join(" ".join(rng.choice(words, 60))
                                for _ in range(80)))
    ecfg = {"model": {"model_path": str(art)}, "mode": "evaluate",
            "data": {"kind": "text", "path": str(corpus),
                     "tokenizer": "byte"},
            "batch": 2, "seq": 512, "steps": 2,
            "results_path": str(SLICE10_OUT / "ppl.json")}
    _reset_counts(attn)
    t0 = time.perf_counter()
    train_main.main(["--config", _write_config("eval_ppl", ecfg)])
    out["evaluate_s"] = time.perf_counter() - t0
    ppl = json.loads((SLICE10_OUT / "ppl.json").read_text())
    launches = _read_counts(attn, "[eval] perplexity", want={
        "flash_forward": 2 * cfg.n_layers, "flash_dq": 0, "flash_dkv": 0})
    stream = train_main.data_stream(ecfg, cfg, build_mesh(device="cuda"),
                                    2, 512)
    total = count = 0.0
    with torch.inference_mode():
        for _ in range(2):
            b = next(stream)
            logits = llama.forward(cfg, params, b["tokens"])
            nll = torch.logsumexp(logits, -1) - torch.gather(
                logits, -1, b["targets"][..., None])[..., 0]
            mask = b["mask"].float()
            total += float((nll * mask).sum())
            count += float(mask.sum())
    want = math.exp(total / count)
    rel = abs(ppl["perplexity"] - want) / want
    log(f"[eval] perplexity over 2 x 512 packed byte tokens x 2 batches "
        f"({ppl['tokens']} targets): {ppl['perplexity']:.4f}; from "
        f"llama.forward's float32 logits {want:.4f}: relative gap {rel:.2e} "
        f"(limit 1e-3); {out['evaluate_s']:.1f} s wall")
    if rel > 1e-3 or int(count) != ppl["tokens"]:
        raise AssertionError(f"[eval] perplexity {ppl} against {want}")

    _reset_counts(attn)          # the reference above ran K1 too
    tok = ByteTokenizer()
    rows = [{"prompt": f"question {i}: which word follows "
                       f"{' '.join(rng.choice(words, 6))}?",
             "options": [f" {w}" for w in rng.choice(words, 4, False)],
             "answer": int(i % 4)} for i in range(8)]
    path = SLICE10_OUT / "questions.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    t0 = time.perf_counter()
    train_main.main(["--config", _write_config("eval_mc", {
        "model": {"model_path": str(art)}, "mode": "evaluate",
        "data": {"kind": "eval_jsonl", "path": str(path),
                 "tokenizer": "byte"},
        "results_path": str(SLICE10_OUT / "mc.json")})])
    out["evaluate_mc_s"] = time.perf_counter() - t0
    mc = json.loads((SLICE10_OUT / "mc.json").read_text())
    more = _read_counts(attn, "[eval] choices", want={
        "flash_forward": 8 * cfg.n_layers, "flash_dq": 0, "flash_dkv": 0})
    out["launches"]["evaluate"] = {k: launches[k] + more[k]
                                   for k in launches}
    want_choices, margins = [], []
    with torch.inference_mode():
        for r in rows:
            prompt = tok.encode(r["prompt"], add_bos=True)
            opts = [tok.encode(o) for o in r["options"]]
            logps = []
            for o in opts:
                ids = torch.tensor([prompt + o], device="cuda")
                logits = llama.forward(cfg, params, ids)[0]
                lp = torch.log_softmax(logits, -1)
                tgt = ids[0, len(prompt):]
                logps.append(float(lp[len(prompt) - 1:-1].gather(
                    -1, tgt[:, None]).sum()))
            order = np.argsort(logps)[::-1]
            want_choices.append(int(order[0]))
            margins.append(logps[order[0]] - logps[order[1]])
    log(f"[eval] 8 questions of 4 options: choices {mc['choices']}, from "
        f"llama.forward's logits {want_choices} (smallest margin "
        f"{min(margins):.4f} nats); {out['evaluate_mc_s']:.1f} s wall; "
        f"launches {more}, all sm90")
    if mc["choices"] != want_choices:
        raise AssertionError(f"[eval] choices {mc['choices']} against "
                             f"{want_choices} (margins {margins})")


def _dpo_run(torch, attn, train_main, cfg, art, out) -> None:
    """``mode: dpo`` on the artifact: 3 steps on 2 preference pairs, the
    first loss ln 2, then falling; ``export_hf_path`` reloads to the
    run's final parameters leaf for leaf."""
    import shutil

    import numpy as np

    from kubedl_tpu_torch.models import convert
    from kubedl_tpu_torch.train import trainer as trainer_mod
    from kubedl_tpu_torch.train.trainer import tree_leaves

    rng = np.random.default_rng(14)
    pairs = []
    for n in (40, 70):
        prompt = [2] + rng.integers(3, cfg.vocab_size, n).tolist()
        pairs.append({"chosen": prompt + rng.integers(
            3, cfg.vocab_size, 30).tolist(), "rejected": prompt + rng.integers(
            3, cfg.vocab_size, 20).tolist(), "prompt_len": len(prompt)})
    path = SLICE10_OUT / "pairs.jsonl"
    path.write_text("\n".join(json.dumps(p) for p in pairs))
    hf_out, art_out = SLICE10_OUT / "dpo_hf", SLICE10_OUT / "dpo_artifact"
    finals, losses = [], []
    fit = trainer_mod.Trainer.fit

    def record_fit(self, state, *a, **k):
        finals.append(fit(self, state, *a, **k))
        return finals[-1]

    _reset_counts(attn)
    L = cfg.n_layers
    t0 = time.perf_counter()
    with unittest.mock.patch.object(trainer_mod.Trainer, "fit", record_fit):
        train_main.main(["--config", _write_config("dpo", {
            "model": {"model_path": str(art)}, "mode": "dpo",
            "data": {"kind": "dpo_jsonl", "path": str(path)}, "batch": 2,
            "steps": 3, "log_every": 1, "dpo": {"beta": 0.1},
            "optimizer": {"learning_rate": 1e-6, "warmup_steps": 0,
                          "decay_steps": 10},
            "export_path": str(art_out), "export_hf_path": str(hf_out)})],
            on_step=lambda s, loss: losses.append(loss))
    out["dpo_s"] = time.perf_counter() - t0
    # per step: the reference forward (no autograd), then the policy's
    # forward twice (remat) and its backward
    out["launches"]["dpo"] = _read_counts(attn, "[dpo]", want={
        "flash_forward": 3 * 3 * L, "flash_dq": 3 * L, "flash_dkv": 3 * L})
    t0 = time.perf_counter()
    hf_cfg, reloaded = convert.load_hf_checkpoint(str(hf_out), device="cuda")
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t0
    final = finals[-1].params
    bad = [k for (k, a), (_, b) in zip(tree_leaves(final),
                                       tree_leaves(reloaded))
           if a.dtype != b.dtype or not torch.equal(a.detach(), b)]
    log(f"[dpo] 3 steps on 2 pairs: losses {[round(x, 6) for x in losses]} "
        f"(ln 2 = {math.log(2):.6f}); {out['dpo_s']:.1f} s wall with the "
        f"export ({_dir_bytes(art_out) / 1e9:.3f} GB artifact, "
        f"{_dir_bytes(hf_out) / 1e9:.3f} GB HF); the HF export reloaded in "
        f"{reload_s:.2f} s, leaves unequal to the final params: "
        f"{bad or 'none'}; launches {out['launches']['dpo']}, all sm90")
    if abs(losses[0] - math.log(2)) > 1e-3 or not losses[-1] < losses[0]:
        raise AssertionError(f"[dpo] losses {losses}")
    if bad or hf_cfg.vocab_size != cfg.vocab_size:
        raise AssertionError(f"[dpo] the HF export differs at {bad[:4]}")
    out["dpo_losses"] = losses
    shutil.rmtree(hf_out)
    shutil.rmtree(art_out)


def phase_lifecycle(torch, cfg, params, art) -> dict:
    """A fine-tuning job's life on the converted Gemma-2B artifact (full
    width, :data:`SLICE10_LAYERS` deep) through ``python -m
    kubedl_tpu_torch.train``'s ``main`` at b=2 x 2048: train with a
    checkpoint and an eval, resume, evaluate, DPO with an HF export. Every
    K1-K3 launch on ``sm90``."""
    import shutil

    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train import checkpoint as ck

    out = {"launches": {}}
    torch.cuda.reset_peak_memory_stats()
    _lifecycle_runs(torch, attn, train_main, ck, cfg, art, out)
    gc.collect()
    torch.cuda.empty_cache()
    _evaluate_runs(torch, attn, train_main, cfg, params, art, out)
    gc.collect()
    torch.cuda.empty_cache()
    _dpo_run(torch, attn, train_main, cfg, art, out)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[life] {out['peak_gib']:.2f} GiB peak device memory in the phase")
    shutil.rmtree(SLICE10_OUT)
    return out


def phase_resnet(torch) -> dict:
    """ResNet-50 (BASELINE config 2) at full size: its parameter count,
    6 steps through ``Trainer`` at b=128 x 224 x 224 x 3 bf16 on one
    repeated batch (images/s, peak memory, the loss falling), float32
    logits at b=8 on the card against the CPU's on the same weights; and
    the MNIST-shaped MLP memorizing one batch in 30 steps."""
    import dataclasses

    from kubedl_tpu_torch.models import mlp, resnet
    from kubedl_tpu_torch.train.trainer import TrainConfig, Trainer, tree_map

    cfg = resnet.resnet50()
    n = resnet.num_params(cfg)
    log(f"[resnet] ResNet-50: {n:,} params (JAX's resnet50(): "
        f"{RESNET50_PARAMS:,})")
    if n != RESNET50_PARAMS:
        raise AssertionError(f"[resnet] {n} params")
    out = {"params": n}
    g = torch.Generator(device="cuda").manual_seed(0)
    params = resnet.init_params(cfg, g, device="cuda")
    batch = {"images": torch.randn(128, 224, 224, 3, generator=g,
                                   device="cuda").bfloat16(),
             "labels": torch.randint(0, cfg.n_classes, (128,), generator=g,
                                     device="cuda")}
    trainer = Trainer(lambda p, b: resnet.loss_fn(cfg, p, b["images"],
                                                  b["labels"]),
                      TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                  decay_steps=100), device="cuda")
    state = trainer.init_state(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, losses = [time.perf_counter()], []
    for _ in range(6):
        state, loss = trainer.step(state, batch)
        losses.append(float(loss))         # syncs
        marks.append(time.perf_counter())
    steady = [b - a for a, b in zip(marks[1:], marks[2:])]
    out["step_s"] = sum(steady) / len(steady)
    out["images_per_s"] = 128 / out["step_s"]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[resnet] b=128 x 224 x 224 x 3 bf16, 6 steps: losses "
        f"{[round(x, 4) for x in losses]}; first step "
        f"{marks[1] - marks[0]:.3f} s; steps 2-6 {out['step_s']:.4f} s per "
        f"step, {out['images_per_s']:.1f} images/s; "
        f"{out['peak_gib']:.2f} GiB peak device memory")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"[resnet] loss not finite and falling: "
                             f"{losses}")
    del state, trainer, batch
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu = resnet.init_params(cfg32, torch.Generator().manual_seed(1),
                             device="cpu")
    images = torch.randn(8, 224, 224, 3, generator=torch.Generator()
                         .manual_seed(2))
    with torch.inference_mode():
        want = resnet.forward(cfg32, cpu, images)
        got = resnet.forward(cfg32, tree_map(lambda t: t.cuda(), cpu),
                             images.cuda()).cpu()
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"[resnet] float32 logits at b=8 on the card against the CPU on the "
        f"same weights: largest gap {rel:.3e} of the largest logit (limit "
        f"1e-3)")
    if not rel <= 1e-3:
        raise AssertionError(f"[resnet] card and CPU logits differ: {rel}")
    out["card_cpu_rel"] = rel

    mcfg = mlp.MLPConfig()
    gm = torch.Generator(device="cuda").manual_seed(3)
    mb = {"x": torch.randn(64, 784, generator=gm, device="cuda"),
          "y": torch.randint(0, 10, (64,), generator=gm, device="cuda")}
    mt = Trainer(lambda p, b: mlp.loss_fn(mcfg, p, b["x"], b["y"]),
                 TrainConfig(learning_rate=1e-2, warmup_steps=1,
                             decay_steps=100), device="cuda")
    mstate = mt.init_state(mlp.init_params(mcfg, gm, device="cuda"))
    for _ in range(30):
        mstate, mloss = mt.step(mstate, mb)
    acc = float(mlp.accuracy(mcfg, mstate.params, mb["x"], mb["y"]))
    log(f"[mlp] 784-512-256-10, one batch of 64 for 30 steps: loss "
        f"{float(mloss):.4f}, accuracy {acc:.3f}")
    if acc != 1.0:
        raise AssertionError(f"[mlp] did not memorize the batch: {acc}")
    out["mlp_accuracy"] = acc
    return out


def _tp_probe(torch, only, timed) -> None:
    """``[tp]`` and ``[tp2]`` on their own: Llama-3-8B from seed 0 (the
    serving phase's weights) and the unsharded continuous engine's 16
    requests, which ``[tp]`` compares with."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    cfg = _serving_llama(llama)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")

    def engine(**kw):
        kw.setdefault("lanes", CONT_LANES)
        return ContinuousBatchingEngine(cfg, params, max_len=CONT_MAX_LEN,
                                        device="cuda", **kw)
    _, reqs = _cont_requests(cfg)
    cont = {"reqs": reqs}
    if "tp" in only:
        cont["served"], _ = _run(engine(), reqs)
        gc.collect()
        timed("tp", phase_tp, torch, cfg, params, cont)
    if "tp2" in only:
        timed("tp2", phase_tp2, torch, cfg, params, reqs)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[tp] device memory still allocated after the phases: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def _replay_probe(torch, only, timed) -> None:
    """``[replay]``, ``[spec]``, ``[auto]`` and ``[fed]`` on their own,
    on Llama-3-8B from seed 0 (the serving phase's weights)."""
    from kubedl_tpu_torch.models import llama
    cfg = _serving_llama(llama)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    for name, fn in (("replay", phase_replay), ("spec", phase_spec),
                     ("auto", phase_auto), ("fed", phase_fed)):
        if name in only:
            timed(name, fn, torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _probe(torch, argv, timed) -> int:
    """``--phases decode,hf,lifecycle,resnet,moe_timing,dist,tp,tp2,tp8,
    ring,cp2,ep2,pp,pp2,grpo,replay,spec,auto,fed,native,moe,moe_int8,op
    [--layers N]``:
    the
    named
    phases alone after the
    build,
    the slice-10 ones on Gemma-2B ``N`` layers deep, ``dist`` after the
    unsharded
    Gemma-2B training it compares with, ``tp`` after the unsharded
    continuous run it compares with, ``ep2`` after the MoE training run
    it compares with (a quick check of one part on the card; no kernels
    line and no last line)."""
    if len(argv) not in (2, 4) or argv[0] != "--phases" or (
            len(argv) == 4 and argv[2] != "--layers"):
        print("usage: chip_smoke.py [--phases decode,hf,lifecycle,resnet,"
              "moe_timing,dist,tp,tp2,tp8,ring,cp2,ep2,pp,pp2,grpo,replay,"
              "spec,"
              "auto,fed,native,moe,moe_int8,op [--layers N]]",
              file=sys.stderr)
        return 2
    only = set(argv[1].split(","))
    layers = int(argv[3]) if len(argv) == 4 else None
    log("[env] " + _card())
    if "decode" in only:
        timed("decode", phase_decode, torch)
    if only & {"tp", "tp2"}:
        _tp_probe(torch, only, timed)
    if "tp8" in only:
        timed("tp8", phase_tp8, torch)
    if only & {"replay", "spec", "auto", "fed"}:
        _replay_probe(torch, only, timed)
    if "op" in only:
        from kubedl_tpu_torch.models import llama
        cfg = _serving_llama(llama)
        params = llama.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        timed("predictor", phase_predictor, torch, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if "native" in only:
        timed("native", phase_native, torch)
    if "moe" in only:
        mcfg, mparams, _ = timed("moe", phase_moe, torch)
        timed("moe_f32", phase_moe_f32, torch, mcfg, mparams)
        del mparams
        gc.collect()
        torch.cuda.empty_cache()
    if "moe_int8" in only:
        timed("moe_int8", phase_moe_int8, torch)
    if "dist" in only:
        gtrain = timed("gemma_training", phase_gemma_training, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed("dist", phase_dist, torch, gtrain)
        gc.collect()
        torch.cuda.empty_cache()
    if "moe_timing" in only:
        timed("moe_timing", phase_timing, torch, MOE_TRAIN, 600)
    if "ring" in only:
        timed("ring", phase_ring, torch)
    if "cp2" in only:
        timed("cp2", phase_cp2, torch)
    if "ep2" in only:
        mtrain, _, _ = timed("moe_training", phase_moe_training, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed("ep2", phase_ep2, torch, mtrain)
    for name, fn in (("pp", phase_pp), ("pp2", phase_pp2),
                     ("grpo", phase_grpo)):
        if name in only:
            gc.collect()
            torch.cuda.empty_cache()
            timed(name, fn, torch)
    if only & {"hf", "lifecycle"}:
        cfg, params, art, _ = timed("hf", phase_hf, torch, layers)
        if "lifecycle" in only:
            timed("lifecycle", phase_lifecycle, torch, cfg, params, art)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if "resnet" in only:
        timed("resnet", phase_resnet, torch)
    import shutil
    shutil.rmtree(SLICE10_OUT, ignore_errors=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import kubedl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    seconds, d1 = {}, {}

    def timed(name, fn, *args):
        _bank_d1()
        D1_TALLY.update(launches=0, sm90=0, plain=0)
        t0 = time.perf_counter()
        res = fn(*args)
        seconds[name] = time.perf_counter() - t0
        _bank_d1()
        if any(D1_TALLY.values()):
            d1[name] = dict(D1_TALLY)
        log(f"[phase] {name} {seconds[name]:.1f} s"
            + (f"; paged_decode {d1[name]}" if name in d1 else ""))
        return res

    timed("build", phase_build)
    if len(sys.argv) > 1:
        return _probe(torch, sys.argv[1:], timed)
    fwd = timed("kernel_check", phase_kernel_check, torch)
    dec = timed("decode", phase_decode, torch)
    from kubedl_tpu_torch.models import llama
    cfg8b = _serving_llama(llama)
    serving_launches, params = timed("serving", phase_serving, torch, cfg8b)
    log(f"[serve] {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak "
        "device memory")
    cont = timed("continuous", phase_continuous, torch, cfg8b, params)
    timed("predictor", phase_predictor, torch, cfg8b, params)
    timed("quantized", phase_quantized, torch, cfg8b, params, cont)
    timed("adapters", phase_adapters, torch, cfg8b, params, cont)
    tp_run = timed("tp", phase_tp, torch, cfg8b, params, cont)
    gc.collect()
    tp2_run = timed("tp2", phase_tp2, torch, cfg8b, params, cont["reqs"])
    gc.collect()
    tp8_run = timed("tp8", phase_tp8, torch)
    gc.collect()
    replay_run = timed("replay", phase_replay, torch, cfg8b, params)
    spec_run = timed("spec", phase_spec, torch, cfg8b, params)
    timed("auto", phase_auto, torch, cfg8b, params)
    fed_run = timed("fed", phase_fed, torch, cfg8b, params)
    del params, cont
    gc.collect()                 # the serving model goes first
    torch.cuda.empty_cache()
    gcfg, gparams, gemma = timed("gemma", phase_gemma, torch)
    timed("gemma_predictor", phase_gemma_predictor, torch, gcfg, gparams)
    del gparams
    gc.collect()
    torch.cuda.empty_cache()
    mcfg, mparams, moe_out = timed("moe", phase_moe, torch)
    timed("moe_predictor", phase_moe_predictor, torch, mcfg, mparams)
    timed("moe_f32", phase_moe_f32, torch, mcfg, mparams)
    del mparams
    gc.collect()                 # the MoE model (47.5 GB in f32) goes first
    torch.cuda.empty_cache()
    timed("moe_int8", phase_moe_int8, torch)
    gc.collect()
    torch.cuda.empty_cache()
    bwd_err = timed("bwd_check", phase_bwd_check, torch)
    times = timed("timing", phase_timing, torch)
    gtimes = timed("gemma_timing", phase_timing, torch, GEMMA_TRAIN, 500)
    gtimes["embed"] = timed("gemma_embed_timing", phase_gemma_embed_timing,
                            torch)
    train, cfg, tokens = timed("training", phase_training, torch)
    gc.collect()
    torch.cuda.empty_cache()
    timed("grad_check", phase_grad_check, torch, cfg, tokens)
    gc.collect()
    torch.cuda.empty_cache()
    native_run = timed("native", phase_native, torch)
    gc.collect()
    torch.cuda.empty_cache()
    timed("gemma_grad_check", phase_gemma_grad_check, torch)
    gc.collect()
    torch.cuda.empty_cache()
    gtrain = timed("gemma_training", phase_gemma_training, torch)
    gc.collect()
    torch.cuda.empty_cache()
    dist_run = timed("dist", phase_dist, torch, gtrain)
    gc.collect()
    torch.cuda.empty_cache()
    lora_run = timed("lora_training", phase_lora_training, torch)
    gc.collect()
    torch.cuda.empty_cache()
    mtrain, _, _ = timed("moe_training", phase_moe_training, torch)
    gc.collect()
    torch.cuda.empty_cache()
    timed("moe_grad_check", phase_moe_grad_check, torch)
    mtimes = timed("moe_timing", phase_timing, torch, MOE_TRAIN, 600)
    gc.collect()
    torch.cuda.empty_cache()
    ring_run = timed("ring", phase_ring, torch)
    cp2_run = timed("cp2", phase_cp2, torch)
    ep2_run = timed("ep2", phase_ep2, torch, mtrain)
    gc.collect()
    torch.cuda.empty_cache()
    pp_run = timed("pp", phase_pp, torch)
    gc.collect()
    torch.cuda.empty_cache()
    pp2_run = timed("pp2", phase_pp2, torch)
    gc.collect()
    torch.cuda.empty_cache()
    grpo_run = timed("grpo", phase_grpo, torch)
    gc.collect()
    torch.cuda.empty_cache()
    hcfg, hparams, hart, hf = timed("hf", phase_hf, torch)
    life = timed("lifecycle", phase_lifecycle, torch, hcfg, hparams, hart)
    del hparams
    gc.collect()
    torch.cuda.empty_cache()
    timed("resnet", phase_resnet, torch)
    log(f"[lora] peak device memory {lora_run['peak_gib']:.2f} GiB with "
        f"rank-{LORA_RANK} adapters against {train['peak_gib']:.2f} GiB for "
        f"the full run of the same configuration; step "
        f"{lora_run['step_s']:.4f} s against {train['step_s']:.4f} s")
    smi = _card()
    log(f"[done] {time.perf_counter() - t_all:.1f} s; by phase "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    from kubedl_tpu_torch.ops import attention as attn

    def source(name, route):
        """The source of kernel ``name`` on ``route``, from the tables the
        wrappers build from."""
        table = (attn._FWD_SOURCES if name == "flash_forward"
                 else attn._BWD_SOURCES)
        return f"kubedl_tpu_torch/csrc/{table[route][0]}.cu"
    shape = _shape(TRAIN)
    def both_ranks(run, name):
        return sum(r[name] for r in run["launches_by_rank"])
    launches = {name: {"training": train["launches"][name],
                       "gemma_training": gtrain["launches"][name],
                       "dist_training": dist_run["launches"][name],
                       "lora_training": lora_run["launches"][name],
                       "moe_training": mtrain["launches"][name],
                       "cp2_ring_training": both_ranks(cp2_run["ring"],
                                                       name),
                       "cp2_ulysses_training": both_ranks(
                           cp2_run["ulysses"], name),
                       "ep2_training": both_ranks(ep2_run["ep"], name),
                       "pp_gpipe": pp_run["runs"]["gpipe"]["launches"][name],
                       "pp_1f1b": pp_run["runs"]["1f1b"]["launches"][name],
                       "pp2_llama_training": both_ranks(pp2_run["llama"],
                                                        name),
                       "pp2_gemma_training": both_ranks(pp2_run["gemma"],
                                                        name),
                       "grpo": grpo_run["launches"][name],
                       "grpo_learner": grpo_run["flywheel"]["launches"][
                           name],
                       "replay_flywheel": replay_run["flywheel"][
                           "launches"][name],
                       "fed": fed_run["launches"][name],
                       "native_training": native_run["launches"][name],
                       **{f"cp2_{impl}_{mode}": both_ranks(
                           cp2_run[f"{mode}_{impl}"], name)
                          for impl in ("ring", "ulysses")
                          for mode in ("evaluate", "choices", "dpo")}}
                for name in ("flash_forward", "flash_dq", "flash_dkv")}
    launches["flash_forward"].update(
        serving=serving_launches,
        gemma_embeddings=gemma["embeddings_launches"],
        moe_embeddings=moe_out["embeddings_launches"],
        tp_embeddings=tp_run["embeddings_launches"],
        spec_embeddings=spec_run["embeddings_launches"],
        tp2_embeddings=sum(tp2_run["llama"]["k1"] + tp2_run["gemma"]["k1"]),
        tp8_embeddings=sum(tp8_run["k1"]))
    new_paths = {**hf["launches"], **life["launches"]}
    for name in launches:
        launches[name].update({path: new_paths[path][name]
                               for path in SLICE10_PATHS})

    def gemma_row(name, err, **extra):
        """The kernel at Gemma-2B's shapes (head dim 256, ``sm90``): its
        training shape and, for K1, its embeddings shape."""
        route = gtimes[name]["kernel_route"]
        row = {"shape": _shape(GEMMA_TRAIN), "max_abs_err": err, **extra,
               "kernel_route": route,
               "source": source(name, route),
               "design": DESIGN_HD256[name],
               "launches": {"gemma_training": gtrain["launches"][name],
                            "gemma_training_by_route": gtrain["by_route"][
                                name],
                            "dist_training": dist_run["launches"][name],
                            "dist_training_by_route": dist_run["by_route"][
                                name]},
               **gtimes[name]}
        if name == "flash_forward":
            row["launches"]["gemma_embeddings"] = \
                gemma["embeddings_launches"]
            row["embeddings"] = {"shape": _shape(GEMMA_EMBED),
                                 "max_abs_err": fwd["gemma_max_abs_err"][
                                     "gemma_embed"], **gtimes["embed"]}
        return row

    def ring_row(name):
        """The kernel at one ring block of Llama's training shape cut in
        ``RING_CP`` shards, and the whole ring's forward (K1) or backward
        (Δ, K2 and K3) against the unsharded kernels', by case."""
        def plain(row):
            return {k: v for k, v in row.items() if k != "checks"}
        return {**plain(ring_run["llama"]["block"][name]),
                "whole_ring": {tag: {k: ring_run[tag][k] for k in (
                    "shape", "cp", "route", "ring_fwd_ms",
                    "unsharded_fwd_ms", "ring_bwd_ms", "unsharded_bwd_ms",
                    "delta_ms", "max_abs_err", "rel_err")}
                    for tag in RING_CASES},
                "launches": {tag: ring_run[tag]["launches_by_kernel"][name]
                             for tag in RING_CASES},
                "cp2_block": plain(ring_run["cp2_block"][name]),
                "ulysses_local": plain(ring_run["ulysses_local"][name])}

    def pp_row(name):
        """The kernel at [pp]'s microbatch shape (one row of Llama's
        training shape), and its launches on the slice-14 paths."""
        row = {k: v for k, v in pp_run["micro_kernels"][name].items()
               if k != "checks"}
        row["launches"] = {path: launches[name][path] for path in (
            "pp_gpipe", "pp_1f1b", "pp2_llama_training",
            "pp2_gemma_training", "grpo", "grpo_learner")}
        return row

    def moe_row(name, err):
        """The kernel checked and timed at Mixtral's training shape, as its
        step launches it, and its launches there by route."""
        return {"shape": _shape(MOE_TRAIN), "max_abs_err": err,
                **mtimes[name],
                "launches": {"moe_training": mtrain["launches"][name],
                             "moe_training_by_route": mtrain["by_route"][
                                 name]}}

    rows = [
        {"name": "flash_forward", "route": "cuda",
         "source": source("flash_forward", "sm90"),
         "replaces": "kubedl_tpu/ops/attention.py:259:_flash_kernel",
         "launches": sum(launches["flash_forward"].values()),
         "launches_by_path": launches["flash_forward"],
         "max_abs_err": fwd["train_max_abs_err"], **times["flash_forward"],
         "shape": shape, "library": "sdpa forward",
         "serving": {k: fwd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "earlier_design_ms",
                                         "host_ms")},
         "gemma": gemma_row("flash_forward",
                            fwd["gemma_max_abs_err"]["gemma_train"]),
         "moe": moe_row("flash_forward", fwd["moe_max_abs_err"]),
         "ring": ring_row("flash_forward"),
         "pp": pp_row("flash_forward"),
         "tp": {"shape": _shape(TP_LOCAL), **tp_run["k1_local"],
                "launches": {"tp_embeddings": tp_run["embeddings_launches"],
                             "tp2_embeddings_by_rank": {
                                 "llama": tp2_run["llama"]["k1"],
                                 "gemma": tp2_run["gemma"]["k1"]},
                             "tp8_embeddings_by_rank": tp8_run["k1"]},
                "tp2_max_abs_err_by_rank": tp2_run["k1_err"],
                "tp8": {"query_heads_by_rank": tp8_run["heads"],
                        "shapes_by_rank": tp8_run["k1_shapes"],
                        "max_abs_err_by_rank": tp8_run["k1_err"],
                        **tp8_run["timed"]}},
         "simt_source": source("flash_forward", "simt"),
         "kernel_route": "sm90", "design": DESIGN["flash_forward"]},
        {"name": "flash_dq", "route": "cuda",
         "source": source("flash_dq", "sm90"),
         "replaces": "kubedl_tpu/ops/attention.py:449:_flash_dq_kernel",
         "launches": sum(launches["flash_dq"].values()),
         "launches_by_path": launches["flash_dq"],
         "max_abs_err": bwd_err["flash_dq"], **times["flash_dq"],
         "shape": shape, "library": "sdpa backward (dq, dk and dv)",
         "gemma": gemma_row("flash_dq", bwd_err["gemma"]["flash_dq"]),
         "moe": moe_row("flash_dq", bwd_err["moe"]["flash_dq"]),
         "ring": ring_row("flash_dq"),
         "pp": pp_row("flash_dq"),
         "simt_source": source("flash_dq", "simt"),
         "kernel_route": "sm90",
         "design": DESIGN["flash_dq"]},
        {"name": "flash_dkv", "route": "cuda",
         "source": source("flash_dkv", "sm90"),
         "replaces": "kubedl_tpu/ops/attention.py:512:_flash_dkv_kernel",
         "launches": sum(launches["flash_dkv"].values()),
         "launches_by_path": launches["flash_dkv"],
         "max_abs_err": bwd_err["flash_dkv"], **times["flash_dkv"],
         "shape": shape, "library": "sdpa backward (dq, dk and dv)",
         "gemma": gemma_row("flash_dkv", bwd_err["gemma"]["flash_dkv"],
                            checked_splits=bwd_err["gemma"]["dkv_splits"]),
         "moe": moe_row("flash_dkv", bwd_err["moe"]["flash_dkv"]),
         "ring": ring_row("flash_dkv"),
         "pp": pp_row("flash_dkv"),
         "simt_source": source("flash_dkv", "simt"),
         "kernel_route": "sm90",
         "design": DESIGN["flash_dkv"]},
        {"name": "paged_decode", "route": "cuda",
         "source": "kubedl_tpu_torch/csrc/paged_decode_sm90.cu",
         "replaces": None,
         "launches": sum(v["launches"] for v in d1.values()),
         "launches_by_path": {k: v["launches"] for k, v in d1.items()},
         "launches_by_route": {r: sum(v[r] for v in d1.values())
                               for r in ("sm90", "plain")},
         "launches_counted": "each phase's in-process calls on the card, "
                             "every graph replay included; the subprocess "
                             "servers' and follower ranks' are not seen",
         "cases": dec},
    ]
    print(json.dumps({"kernels": rows}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
