#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubeml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result line):
  1. build    every hand-written kernel from ops/csrc, one nvcc per source,
              all started together; prints build time and ptxas usage.
  2. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes (gpt-mini: H=4, D=64, pages of G=16,
              Pmax=32; decode S=8 slots x T=1, a prefill call S=1 slot x
              T=16 chunk tokens, and S=8 x T=16), with bf16, int8 and f32
              pages; tolerance: bf16 outputs atol = rtol = 2e-2, f32 1e-5.
              A second launch on the same inputs must equal the first bit
              for bit, and at S=8 each slot launched alone (S=1) must equal
              its slot of the batched call bit for bit. Times the kernel
              (the decode and prefill calls also with the L2 cold: operand
              sets cycled over 2.4 x the L2), the plain version and one
              library yardstick (gather + scaled_dot_product_attention,
              which the port never calls); the bound counts the bytes of
              the pages the run's page tables actually name.
  3. serve    gpt-mini at its published widths, random weights from --seed
              (numpy, through convert.py), served by ServeService over
              DecodeEngine(slots=8, page=16, prefill_chunk=16) with bf16 and
              then int8 KV pages: 8 greedy requests, prompts of 1..200
              tokens, 32 new tokens each, two sharing a 48-token prompt so a
              prefix hit and a copy-on-write split happen. The kernel launch
              counts are zeroed just before and read just after; each run
              must launch layers x (decode + prefill dispatches) kernels,
              and every request's tokens served alone must equal its tokens
              served in the batch.
  4. check    gpt-nano in f32 served on the card (kernel) and on the CPU
              (plain version) gives the same greedy tokens.
  5. trace    the bf16 batch once more under torch.profiler: device busy
              and idle share of the run's wall time, device activities per
              dispatch, the kernel's share, the top device consumers.
  6. flash    the three flash-attention kernels (forward, dK/dV, dQ)
              against their plain versions at the training path's shape
              (B=8, T=512, H=4, D=64, bf16, causal; padded tails and one
              fully padded sequence), the same not causal, in f32, and at a
              ragged T=200; tolerance bf16 atol = rtol = 2e-2, f32 2e-5.
              Times each kernel, its plain version and the library yardstick
              (scaled_dot_product_attention with the same additive mask:
              forward for the forward kernel, its autograd backward for
              dK/dV and dQ together; the port never calls it); the bound
              counts each input read once and each output written once, and
              2*D operations per causally allowed (q, k) pair per product.
              No atomics: a second launch of each kernel on the same
              inputs must equal the first bit for bit. At the main shape
              the three kernels are also timed with the L2 cold (operand
              sets cycled over 2.4 x the L2, as in phase 9a).
  7. train    gpt-mini at its published widths, random weights from --seed,
              dropout 0.1, bf16 compute: three KAvgEngine.train_rounds of
              W=2 workers x K=4 steps of B=8 sequences of T=512 tokens
              (arithmetic token runs, some ending in padding; one step of
              worker 1 masked), lr 1e-3. Flash launch counts are zeroed just
              before each round and read just after: layers x real steps
              for each kernel. The third round's mean loss must be below the
              first's, both workers contribute, and an eval_round runs.
              Then gpt-nano in f32 (dropout 0): one round on the card
              (kernels) and on the CPU (plain versions) merge to the same
              parameters within AdamW's bound (2 x K x lr for any element,
              99.5 % of them within 1e-5).
  8. trace    one more gpt-mini training round under torch.profiler: device
              busy and idle share, activities per local step, the flash
              kernels' share, the top device consumers.
  9. merge    (a) the fused merge-apply kernel against its plain version,
              bit for bit (torch.equal), avg and sgd mode, raw_count 3 and 0
              (the guard path, with a NaN in s, must return ref), at
              gpt-mini's five bucket lengths under the 4 MB EF cap and at
              N = 7 and 5000; times by CUDA-graph replay with the L2 warm
              and cold (operand sets cycled over 2.4 x the L2), the plain
              version's time and the bytes bound (12 bytes per element);
              no single PyTorch call computes this function, so there is
              no library yardstick. (b)+(c) gpt-mini at its published
              widths, bf16, dropout 0.1, n_lanes=2, W=4, K=4, B=8, T=512:
              three train_rounds each with the bucketed (4 MB), ef_bf16 and
              ef_int8 merges; the merge kernel's launches are zeroed just
              before and read just after (5 buckets x 3 rounds), the flash
              launches too; the loss falls, EF residuals stay finite, and
              after a round with lane 1 masked out its residual is exactly
              zero while lane 0's is not. The first bucketed round's
              contributions merged by MonolithicMerge and by
              BucketedMerge(4 MB) are equal bit for bit. (d) gpt-nano in
              f32, ef_int8, n_lanes=2, one round on the card and on the CPU:
              merged params within 2 x K x lr + the bucket's int8 scale, 99.5
              % within 1e-5. (e) one ef_int8 round profiled, and its merge
              replayed alone under the profiler: the fused kernel, copies
              and quantize ops against the round's device busy time.
 10. job      the training job end to end, under a fresh KUBEML_TPU_HOME:
              a registry dataset of 1024 train and 128 test windows of
              T=512 tokens (phase 7's arithmetic runs, half ending in
              padding) from --seed; TrainJob(gpt-mini, bf16, B=8, K=4, lr
              1e-3, 3 epochs, default_parallelism=2, max_parallelism=4,
              merge_bucket_mb=4, validate_every=1, train_stats off so the
              engine is phase 7's) with a scripted parallelism callback
              adding 1 each epoch. The kernel counts are zeroed before each
              epoch and read after it (its validation included): dK/dV and
              dQ = layers x local steps, the forward that plus layers x
              eval steps, the fused merge 5 buckets x rounds. The history's
              parallelism must be [2, 3, 4] and the loss fall; the final
              checkpoint loads back equal to the job's weights, and a
              restart with resume_from=<job> finishes as done without a
              launch. Epoch 1's rounds, fed by hand from the same
              RoundLoader to a KAvgEngine, must give the job's weights bit
              for bit (torch.equal). A gpt-nano f32 job (one epoch, N=2)
              from one seed checkpoint on the card and on the CPU agrees
              within AdamW's bound (2 lr per local step, 99.5 % within
              1e-5). Prints per epoch wall seconds, samples/s, non-pad
              tokens/s, ms per local step and the data_wait / dispatch /
              merge_wait seconds, and the job's ms per local step against
              phase 7's engine-direct one.
 11. vision   ResNet-18 at its published widths (CIFAR stem, stages
              (2, 2, 2, 2) at widths 64..512, 10 classes, bf16 compute with
              f32 parameters and f32 batch statistics), random weights from
              the flax initializers drawn from --seed: (a) a registry
              dataset of 50,000 train and 10,000 test CIFAR-shaped u8 NHWC
              images (class k lifts channel k % 3) with a u8 -> f32 / 255
              host transform and its device twin; TrainJob(resnet18, B=256,
              K=8 (bench.py's), lr 0.1, N=2, merge_bucket_mb=4) for 2
              epochs with device_cache='auto' (the sharded cache), then one
              more epoch warm-started from its checkpoint with
              device_cache='off'. The fused merge's launches are zeroed
              before each epoch and read after it: 10 buckets x 13 rounds
              (from the plan). The loss must fall. Prints per epoch wall,
              samples/s, ms per local step, the phase split, and the cached
              epoch against the host-staged one. (b) One ResNet-18 round
              index-fed == host-staged and two index-fed rounds grouped ==
              two single rounds, bit for bit under
              torch.backends.cudnn.deterministic (and whether the first
              pair is equal without it); the bucketed merge against the
              monolithic one within 2e-2. (c) One f32 round of a narrow
              ResNet (stages (1, 1), width 16) and one of LeNet on the card
              and on the CPU: parameters and running statistics within
              1e-4. (d) One ResNet-18 round profiled: device busy and idle
              share, the convolutions' and the merge's share, the top
              device consumers. (e) The fused merge over ResNet-18's 10
              buckets (warm times, plain version, bytes bound).
 12. control  the training control plane on the card, under a fresh
              KUBEML_TPU_HOME and cudnn.deterministic: start_deployment()
              (storage, PS, scheduler, controller over HTTP on localhost)
              driven by KubemlClient. (a) Two user function files
              registered through the controller (phase 11's dataset
              transform beside ResNet-18, phase 10's token windows beside
              gpt-mini); phase 11's images uploaded as four .npy files
              (upload seconds, MiB/s); resnet18 submitted at phase 11's
              B=256, K=8, lr 0.1, static N=2, merge_bucket_mb=4,
              device_cache='auto', one epoch, its history polled through
              the controller: the fused merge's launches, zeroed before
              the submit and read after, must be 10 buckets x 13 rounds;
              /metrics must show the job's families at its epoch's publish
              and none after its finish; the checkpoint must equal bit for
              bit that of a direct TrainJob of the same task and seed run
              next. Prints POST /train -> first dispatch, and both jobs'
              wall, samples/s and ms per local step. (b) 64 test images
              through POST /infer at the controller equal the model's infer
              on the loaded checkpoint. (c) Phase 10's windows uploaded,
              gpt-mini for 2 epochs under the scheduler's throughput policy
              (default 2, max 4): the history's parallelism is the policy's
              [2, 3], the loss falls, and each epoch's launches (read at
              its publish) are phase 10's plan. (d) One epoch of that task
              at a static N=2 threaded, then in a
              start_deployment(standalone_jobs=True) whose job runs in a
              `python -m kubeml_tpu_torch.train.jobserver` child on the
              card: histories (but the epoch durations) and checkpoints
              equal bit for bit.

Prints every number beside the card's name and power limit (nvidia-smi),
then a line {"kernels": [...]} with one entry per kernel instantiation on
the main paths (bf16 pages, int8 pages: decode numbers at the top level,
the S=1 prefill call's under "prefill", launches from that page type's own
serving run; the three bf16 flash kernels at the training shape, launches
from the last training round; the fused merge over one whole gpt-mini
merge, launches from the ef_int8 run, the sgd mode under "sgd"; each of
the four training kernels also carries "job_launches", its launches in
each epoch of phase 10's job, and "deployment_launches" those of phase
12's jobs; the merge's "resnet18" entry carries phase 11's plan, times and
launches per epoch), the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Exits
non-zero without a CUDA device or without the kubeml_tpu_torch package
beside it.

    python3 chip_smoke.py --flash-only
    python3 chip_smoke.py --paged-only

build the kernels and run phase 6 (phase 2) alone, printing its rows as one
JSON line and no result line: copied into another tree of the repo (a `git
archive` of another commit) the script times that tree's kernels the same
way, so two commits compare in one session.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12,   # dense tensor-core rate
                  "f32": 67e12}     # f32 outside the tensor cores
TOL = {"bf16": 2e-2, "f32": 1e-5}
FLASH_TOL = {"bf16": 2e-2, "f32": 2e-5}   # the JAX package's flash tolerance


def log(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, calls: int = 20, reps: int = 15) -> float:
    """Device time of one call: `calls` calls captured in a CUDA graph,
    the graph replayed `reps` times between CUDA events, the median
    replay divided by `calls`. Replaying a graph keeps the host's launch
    overhead out of the number (timing each eager call would measure the
    Python wrapper instead of the kernel). Inputs stay resident in the
    50 MB L2 between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# ------------------------------------------------------------------ phase 2
H, D, G, PMAX = 4, 64, 16, 32
# (slots S, query tokens T): a decode call, a prefill call as the main path
# makes it (one slot per call), and a prefill chunk for all 8 slots
SHAPES = ((8, 1), (1, 16), (8, 16))
PREFILL_CTX = 200        # the serve phase's longest prompt


def paged_operands(torch, rng, S, T, pages, dev):
    """Kernel operands at gpt-mini's serving shapes with realistic
    masking: slot s holds a context of n_s tokens on its first pages
    (spread over T+5 .. C-7 for 8 slots; PREFILL_CTX for one), table
    tails point at the null page 0, and the bias is NEG_INF past each
    query's causal position and the slot's valid prefix."""
    from kubeml_tpu_torch.ops.attention import NEG_INF

    C = PMAX * G
    P = S * PMAX + 1
    cdt = torch.float32 if pages == "f32" else torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((S, T, H, D)).astype(np.float32))
    if pages == "int8":
        k = torch.from_numpy(rng.integers(-127, 128, (P, G, H, D),
                                          dtype=np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, (P, G, H, D),
                                          dtype=np.int8))
        ks = torch.from_numpy(rng.uniform(0.001, 0.05, P).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.001, 0.05, P).astype(np.float32))
    else:
        k = torch.from_numpy(rng.standard_normal((P, G, H, D))
                             .astype(np.float32)).to(cdt)
        v = torch.from_numpy(rng.standard_normal((P, G, H, D))
                             .astype(np.float32)).to(cdt)
        ks = torch.zeros(P)
        vs = torch.zeros(P)
    n_ctx = (np.linspace(T + 5, C - 7, S).astype(np.int64) if S > 1
             else np.array([PREFILL_CTX]))
    tables = np.zeros((S, PMAX), np.int32)
    keep = np.zeros((S, 1, T, C), np.float32)
    cols = np.arange(C)
    for s in range(S):
        used = -(-int(n_ctx[s]) // G)
        tables[s, :used] = 1 + s * PMAX + np.arange(used)
        for t in range(T):
            keep[s, 0, t] = cols <= n_ctx[s] - T + t
    bias = torch.from_numpy((1.0 - keep) * NEG_INF)
    args = [q.to(cdt), k, v, ks, vs, torch.from_numpy(tables), bias]
    return [a.to(dev).contiguous() for a in args], cdt


def library_attention(torch, q, k_pages, v_pages, k_scale, v_scale, tables,
                      bias, quantized, cdt):
    """One library yardstick for the same function: a page gather and
    torch's scaled_dot_product_attention (timed only; the port never
    calls it)."""
    import torch.nn.functional as F

    if quantized:
        k_pages = (k_pages.float() * k_scale[:, None, None, None]).to(cdt)
        v_pages = (v_pages.float() * v_scale[:, None, None, None]).to(cdt)
    S = q.shape[0]
    C = tables.shape[1] * k_pages.shape[1]
    ck = k_pages[tables].reshape(S, C, H, D).transpose(1, 2)
    cv = v_pages[tables].reshape(S, C, H, D).transpose(1, 2)
    out = F.scaled_dot_product_attention(q.transpose(1, 2), ck, cv,
                                         attn_mask=bias.to(cdt))
    return out.transpose(1, 2)


def bound(torch, q, k_pages, tables, bias, quantized, cdt_name):
    """Least time (ms) for one call on these inputs: the bytes it must
    move over the memory rate, against its operations over the peak rate
    for its compute type; the larger of the two. Bytes: every distinct
    page the tables name (tails share the null page 0) read once for K
    and for V, with its two scales when int8; the bias, queries and page
    tables read once; the output written once. Operations: 4*H*D*T
    (QK and PV multiply-adds) for each context token on a page other
    than the null page."""
    T = q.shape[1]
    page_bytes = G * H * D * k_pages.element_size()
    distinct = int(torch.unique(tables).numel())
    nbytes = (2 * distinct * page_bytes + bias.numel() * 4
              + 2 * q.numel() * q.element_size() + tables.numel() * 4)
    if quantized:
        nbytes += 2 * distinct * 4
    ops = 4 * H * D * T * G * int((tables != 0).sum())
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[cdt_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_kernels(torch, card, seed):
    from kubeml_tpu_torch.ops.paged_attention import _pa_plain, paged_attention

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    rows = {}
    for pages in ("bf16", "int8", "f32"):
        for S, T in SHAPES:
            args, cdt = paged_operands(torch, rng, S, T, pages, dev)
            quant = pages == "int8"
            cdt_name = "f32" if cdt == torch.float32 else "bf16"

            def call(*a):
                return paged_attention(*a, quantized=quant,
                                       compute_dtype=cdt)

            out = call(*args)
            torch.cuda.synchronize()
            ref = _pa_plain(*args, quantized=quant, compute_dtype=cdt)
            tol = TOL[cdt_name]
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            err = float((out.float() - ref.float()).abs().max())
            # no atomics: a second launch is equal bit for bit; and a slot
            # launched alone equals the same slot of the batched call
            assert torch.equal(out, call(*args)), (pages, S, T)
            for s in range(S if S > 1 else 0):
                q, kp, vp, ks, vs, tables, bias = args
                alone = call(q[s:s + 1], kp, vp, ks, vs, tables[s:s + 1],
                             bias[s:s + 1])
                assert torch.equal(alone, out[s:s + 1]), (pages, S, T, s)
            ms = time_ms(torch, lambda: call(*args))
            plain_ms = time_ms(torch, lambda: _pa_plain(
                *args, quantized=quant, compute_dtype=cdt))
            lib_ms = time_ms(torch, lambda: library_attention(
                torch, *args, quant, cdt))
            q, k_pages, _, _, _, tables, bias = args
            b_ms, b_by = bound(torch, q, k_pages, tables, bias, quant,
                               cdt_name)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            if (S, T) != (8, 16):       # the main path's two calls
                row["cold_ms"] = paged_cold_ms(torch, rng, S, T, pages, dev,
                                               call)
            rows[(pages, S, T)] = row
            log(card, f"paged_attention pages={pages} S={S} T={T}: kernel "
                f"{ms:.4f} ms"
                + (f" (L2 cold {row['cold_ms']:.4f} ms)" if "cold_ms" in row
                   else "")
                + f", plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                f"bound {b_ms:.5f} ms ({b_by}), max|err| {err:.3g} (tol "
                f"{tol}); two launches equal bit for bit"
                + (f", each of the {S} slots alone equals its batched "
                   "output bit for bit" if S > 1 else ""))
    return rows


def paged_cold_ms(torch, rng, S, T, pages, dev, call) -> float:
    """The kernel's time with the L2 cold: operand sets of the same shape
    and masking cycled over COLD_BYTES (as phase 9a times the merge
    kernel)."""
    sets = []
    while sum(sum(t.numel() * t.element_size() for t in s)
              for s in sets) < COLD_BYTES:
        sets.append(paged_operands(torch, rng, S, T, pages, dev)[0])
    return time_ms_cold(torch, call, sets)


# ------------------------------------------------------------------ phase 3
PROMPT_LENS = (1, 33, 97, 150, 200, 64)
SHARED_LEN = 48          # 3 full pages of 16: prefix hit + CoW split
NEW_TOKENS = 32


def build_gpt(torch, name, seed, dtype, device):
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models import get_builtin
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    module = get_builtin(name)(dtype=dtype, device=device)
    module.load_state_dict(params_from_flax(
        random_flax_params(**GPT_CONFIGS[name], seed=seed)))
    return module


def batch_prompts(seed, vocab):
    """The batch's prompts (random ids from the seed) and the prompt that
    is served twice; the first copy is the fourth prompt."""
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]
    shared = rng.integers(1, vocab, SHARED_LEN).tolist()
    prompts.insert(3, shared)
    return prompts, shared


def serve_batch(svc, prompts, shared, timeout=300.0):
    """Submit every prompt, then — once the first shared-prompt request
    has its first token, so its pages are registered — the second one."""
    reqs = [svc.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    first = reqs[prompts.index(shared)]
    deadline = time.monotonic() + timeout
    while first.first_token_at is None and not first.done:
        if time.monotonic() > deadline:
            raise TimeoutError("shared-prompt request never produced a token")
        time.sleep(0.001)
    reqs.append(svc.submit(shared, max_new_tokens=NEW_TOKENS))
    for r in reqs:
        if not r.wait(max(1.0, deadline - time.monotonic())):
            raise TimeoutError(f"request {r.rid} never finished")
    return reqs


def phase_serve(torch, card, seed, module, kv_dtype):
    from kubeml_tpu_torch.ops.paged_attention import paged_attention
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.service import ServeService

    vocab = module.vocab_size
    prompts, shared = batch_prompts(seed, vocab)

    def service():
        eng = DecodeEngine(module, slots=8, page=16, prefill_chunk=16,
                           kv_dtype=kv_dtype)
        return ServeService("gpt-mini", eng).start()

    warm = service()              # first calls: cuBLAS and kernel load
    try:
        assert warm.submit(prompts[0], max_new_tokens=4).wait(120)
    finally:
        warm.stop()

    svc = service()
    try:
        paged_attention.launches = 0     # the main path's run starts here
        t0 = time.perf_counter()
        reqs = serve_batch(svc, prompts, shared)
        wall = time.perf_counter() - t0
        launches = paged_attention.launches    # ... and ends here
    finally:
        svc.stop()
    st = svc.engine.stats
    bad = [(r.rid, r.outcome, r.error, len(r.tokens)) for r in reqs
           if r.outcome != "ok" or len(r.tokens) != NEW_TOKENS]
    assert not bad, f"requests did not finish with {NEW_TOKENS} tokens: {bad}"
    assert all(0 < t < vocab for r in reqs for t in r.tokens)
    assert st["prefix_hits"] > 0, st
    assert st["cow_splits"] >= 1, st
    want = module.layers * (st["dispatches"] + st["prefill_dispatches"])
    assert launches == want, (launches, want, st)
    assert reqs[-1].tokens == reqs[3].tokens   # cache hit == cache miss

    solo = service()
    try:
        for r in reqs:
            alone = solo.submit(r.prompt, max_new_tokens=NEW_TOKENS)
            assert alone.wait(120), "solo request never finished"
            assert alone.tokens == r.tokens, (r.prompt[:8], alone.tokens,
                                              r.tokens)
    finally:
        solo.stop()

    tokens = sum(len(r.tokens) for r in reqs)
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    pages = "bf16" if kv_dtype == "f32" else kv_dtype  # module dtype pages
    log(card, f"serve gpt-mini, {pages} KV pages: {len(reqs)} requests, "
        f"{tokens} tokens in {wall:.4f} s = {tokens / wall:.2f} tokens/s, "
        f"mean TTFT {1e3 * statistics.mean(ttft):.3f} ms, decode "
        f"dispatches {st['dispatches']}, prefill dispatches "
        f"{st['prefill_dispatches']}, prefix hits {st['prefix_hits']}, "
        f"CoW splits {st['cow_splits']}, kernel launches {launches}; "
        f"solo == batched for all {len(reqs)}")
    return launches


# ------------------------------------------------------------------ phase 4
def phase_check(torch, card, seed):
    """gpt-nano in f32: the card (kernel) and the CPU (plain version)
    serve the same greedy tokens."""
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(1, 512, n).tolist() for n in (3, 17, 40)]
    toks = {}
    for dev in ("cuda", "cpu"):
        module = build_gpt(torch, "gpt-nano", seed, torch.float32, dev)
        eng = DecodeEngine(module, slots=4, page=8, prefill_chunk=8,
                           device=dev)
        reqs = [GenerateRequest(p, max_new_tokens=12) for p in prompts]
        for r in reqs:
            eng.attach(r)
        while eng.active():
            eng.step()
        toks[dev] = [r.tokens for r in reqs]
    assert toks["cuda"] == toks["cpu"], toks
    log(card, "gpt-nano f32: greedy tokens on the card (kernel) equal the "
        "CPU's (plain) for 3 requests x 12 tokens")


# ------------------------------------------------------------------ phase 5
def phase_trace(torch, card, seed, module):
    """Where a serving run's time goes: the bf16 batch of phase 3 again,
    under torch.profiler; device time summed over the CUDA activities
    CUPTI recorded, against the run's wall time. Reports "not measured"
    when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.service import ServeService

    prompts, shared = batch_prompts(seed, module.vocab_size)
    svc = ServeService("gpt-mini", DecodeEngine(
        module, slots=8, page=16, prefill_chunk=16)).start()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve_batch(svc, prompts, shared)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        svc.stop()
    st = svc.engine.stats
    dispatches = st["dispatches"] + st["prefill_dispatches"]
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            tot, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        log(card, "trace: device time not measured (the profiler recorded "
            "no CUDA activity)")
        return
    busy = sum(t for t, _ in by_name.values())
    calls = sum(n for _, n in by_name.values())
    # pa_cluster_kernel (bf16, int8 pages) and pa_kernel (f32)
    pa = sum(t for name, (t, _) in by_name.items()
             if "pa_kernel" in name or "pa_cluster_kernel" in name)
    log(card, f"trace gpt-mini bf16 batch (profiled): wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.2f}%), idle "
        f"{100 * (1 - busy / wall_ms):.2f}%; {dispatches} dispatches, "
        f"{calls} device activities ({calls / dispatches:.1f} per "
        f"dispatch), host {(wall_ms - busy) / dispatches:.3f} ms per "
        f"dispatch unhidden; paged_attention {pa:.3f} ms "
        f"({100 * pa / busy:.2f}% of device time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (t, n) in top:
        log(card, f"trace top device time: {t:.3f} ms over {n} calls: "
            f"{name[:90]}")


# ------------------------------------------------------------------ phase 6
FA_B, FA_H, FA_D = 8, 4, 64
FA_CASES = (  # (name, dtype, T, causal): the training path's shape first
    ("bf16 causal", "bf16", 512, True),
    ("bf16 not causal", "bf16", 512, False),
    ("f32 causal", "f32", 512, True),
    ("bf16 causal T=200", "bf16", 200, True),
)


def flash_operands(torch, rng, dtype, T, dev):
    """q, k, v, g ~ N(0, 1) in the compute dtype and a keep-mask: sequence
    0 full, 1..6 ending in padding at spread lengths, 7 fully padded."""
    cdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (FA_B, T, FA_H, FA_D)).astype(np.float32)).to(dev, cdt)
        for _ in range(4))
    lengths = np.concatenate([[T], np.linspace(T - 7, 5, FA_B - 2)
                              .astype(np.int64), [0]])
    pad = torch.from_numpy((np.arange(T)[None, :] < lengths[:, None])
                           .astype(np.float32)).to(dev)
    return q, k, v, g, pad


def flash_bound(q, causal, kernel):
    """Least time (ms) of one call: bytes over the memory rate against the
    products' operations over the peak rate for the dtype, the larger.
    Bytes: every input read once, every output written once (a [B,T,H,D]
    tensor is x bytes, a row statistic B*H*T*4, the mask B*T*4).
    Operations: 2*D per causally allowed (q, k) pair per product — 2
    products forward, 4 for dK/dV, 3 for dQ."""
    B, T, H, D = q.shape
    x = q.numel() * q.element_size()
    row, mask = B * H * T * 4, B * T * 4
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    nbytes, products = {
        "forward": (4 * x + 2 * row + mask, 2),     # q k v in, out m l out
        "dK/dV": (6 * x + 3 * row + mask, 4),       # q k v g m l delta in
        "dQ": (5 * x + 3 * row + mask, 3),
    }[kernel]
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    cdt = "bf16" if q.element_size() == 2 else "f32"
    t_ops = products * 2 * D * pairs / PEAK_OPS_PER_S[cdt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def library_flash_ms(torch, q, k, v, g, pad, causal):
    """The yardstick the port never calls: scaled_dot_product_attention
    with the same additive mask; (forward ms, backward ms), the backward
    timed as forward + autograd backward minus the forward."""
    import torch.nn.functional as F

    from kubeml_tpu_torch.ops.attention import composed_bias

    T = q.shape[1]
    bias = composed_bias(pad, causal, T).to(q.dtype)
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    gt = g.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qt, kt, vt), gt)

    f_ms = time_ms(torch, fwd)
    return f_ms, time_ms(torch, fwd_bwd) - f_ms


def phase_flash(torch, card, seed):
    from kubeml_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 3)
    rows = {}
    for name, dtype, T, causal in FA_CASES:
        q, k, v, g, pad = flash_operands(torch, rng, dtype, T, dev)
        tol = FLASH_TOL[dtype]

        def check(got, ref):
            for a, b in zip(got, ref):
                torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                           atol=tol)
            return max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(got, ref))

        out, m, l = fa.fa_fwd_kernel(q, k, v, pad, causal)
        again = fa.fa_fwd_kernel(q, k, v, pad, causal)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip((out, m, l), again)), \
            name
        ref_out, ref_m, ref_l = fa._fa_forward_plain(q, k, v, pad, causal)
        check((m, l), (ref_m, ref_l))   # m sits at NEG_INF scale: relative
        err_f = check((out,), (ref_out,))
        # the fully padded sequence is uniform: l counts its keys
        want = (torch.arange(1, T + 1, device=dev) if causal
                else torch.full((T,), T, device=dev)).float()
        torch.testing.assert_close(l.reshape(FA_B, FA_H, T)[-1],
                                   want.expand(FA_H, T), rtol=1e-6, atol=0)
        delta = fa._delta(g, out)
        bwd = (q, k, v, pad, g, m, l, delta, causal)
        dk, dv = fa.fa_bwd_dkv_kernel(*bwd)
        dq = fa.fa_bwd_dq_kernel(*bwd)
        torch.cuda.synchronize()
        err_kv = check((dk, dv), fa._fa_bwd_dkv_plain(*bwd))
        err_q = check((dq,), (fa._fa_bwd_dq_plain(*bwd),))
        # no atomics: a second launch on the same inputs is equal bit for bit
        dk2, dv2 = fa.fa_bwd_dkv_kernel(*bwd)
        dq2 = fa.fa_bwd_dq_kernel(*bwd)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in
                   ((dk, dk2), (dv, dv2), (dq, dq2))), name
        lib_f, lib_b = library_flash_ms(torch, q, k, v, g, pad, causal)
        for kernel, err, fn, plain in (
                ("forward", err_f,
                 lambda: fa.fa_fwd_kernel(q, k, v, pad, causal),
                 lambda: fa._fa_forward_plain(q, k, v, pad, causal)),
                ("dK/dV", err_kv, lambda: fa.fa_bwd_dkv_kernel(*bwd),
                 lambda: fa._fa_bwd_dkv_plain(*bwd)),
                ("dQ", err_q, lambda: fa.fa_bwd_dq_kernel(*bwd),
                 lambda: fa._fa_bwd_dq_plain(*bwd))):
            ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
            b_ms, b_by = flash_bound(q, causal, kernel)
            lib = lib_f if kernel == "forward" else lib_b
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            if name == FA_CASES[0][0]:
                row["cold_ms"] = flash_cold_ms(torch, rng, dtype, T, causal,
                                               kernel, dev)
            rows[(name, kernel)] = row
            log(card, f"flash {kernel} {name} (B={FA_B} T={T} H={FA_H} "
                f"D={FA_D}): kernel {ms:.4f} ms"
                + (f" (L2 cold {row['cold_ms']:.4f} ms)" if "cold_ms" in row
                   else "")
                + f", plain {plain_ms:.4f} ms, library {lib:.4f} ms "
                f"({'forward' if kernel == 'forward' else 'backward, dQ+dK+dV'}"
                f"), bound {b_ms:.5f} ms ({b_by}), {ms / b_ms:.1f}x bound, "
                f"max|err| {err:.3g} (tol {tol}); two launches equal bit "
                f"for bit")
    return rows


def flash_cold_ms(torch, rng, dtype, T, causal, kernel, dev) -> float:
    """A flash kernel's time with the L2 cold: operand sets (q, k, v and
    the mask; for the backward also g and the forward's m, l, delta)
    cycled over COLD_BYTES, as phase 9a times the merge kernel."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    fn = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
          "dQ": fa.fa_bwd_dq_kernel}[kernel]
    sets = []
    while sum(sum(t.numel() * t.element_size() for t in s[:-1])
              for s in sets) < COLD_BYTES:
        q, k, v, g, pad = flash_operands(torch, rng, dtype, T, dev)
        if kernel == "forward":
            sets.append((q, k, v, pad, causal))
            continue
        out, m, l = fa.fa_fwd_kernel(q, k, v, pad, causal)
        sets.append((q, k, v, pad, g, m, l, fa._delta(g, out), causal))
    return time_ms_cold(torch, fn, sets)


# ------------------------------------------------------------------ phase 7
TRAIN_W, TRAIN_K, TRAIN_B, TRAIN_T, TRAIN_LR = 2, 4, 8, 512, 1e-3
MASKED_STEP = (1, 2)          # (worker, step) left out of the round


RUN_PERIOD = 255      # token runs cycle through ids 1..255


def lm_round(rng, W, K, B, T):
    """One round's inputs: arithmetic token runs (token t+1 follows t, as
    in tests/test_job.py's LM task, cycling through ids 1..RUN_PERIOD of
    the model's vocabulary — learnable within a few rounds), half the
    sequences ending in padding at random lengths, all examples real, one
    step masked."""
    start = rng.integers(1, RUN_PERIOD + 1, (W, K, B, 1))
    x = ((start + np.arange(T) - 1) % RUN_PERIOD + 1).astype(np.int32)
    lengths = np.where(rng.random((W, K, B)) < 0.5,
                       rng.integers(T // 4, T, (W, K, B)), T)
    x[np.arange(T) >= lengths[..., None]] = 0
    step_mask = np.ones((W, K), np.float32)
    if W > MASKED_STEP[0] and K > MASKED_STEP[1]:
        step_mask[MASKED_STEP] = 0.0
    rngs = rng.integers(0, 2 ** 32, (W, K, 2), dtype=np.uint32)
    return ({"x": x}, np.ones((W, K, B), np.float32), step_mask,
            np.ones(W, np.float32), rngs)


def train_setup(torch, name, seed, dtype, device, **engine_kw):
    """A registered model, its module with weights from the seed (through
    convert.py), an engine over it (``engine_kw``: lanes and merge
    knobs), and the weights as round state."""
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    model = get_model(name)()
    module = model.build(dtype=dtype, device=device)
    module.load_state_dict(params_from_flax(
        random_flax_params(**GPT_CONFIGS[name], seed=seed)))
    engine = KAvgEngine(module, model.loss, model.metrics,
                        model.configure_optimizers, **engine_kw)
    state = {n: p.detach().clone() for n, p in module.named_parameters()}
    return module, engine, state


def phase_train(torch, card, seed):
    from kubeml_tpu_torch.ops import flash_attention as fa

    module, engine, state = train_setup(torch, "gpt-mini", seed,
                                        torch.bfloat16, "cuda")
    rng = np.random.default_rng(seed + 4)
    kernels = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
               "dQ": fa.fa_bwd_dq_kernel}
    means, counts, ms = [], {}, []
    for r in range(3):
        args = lm_round(rng, TRAIN_W, TRAIN_K, TRAIN_B, TRAIN_T)
        batch, smask, stmask, wmask, _ = args
        real = stmask * wmask[:, None]
        steps = int(real.sum())
        for fn in kernels.values():     # the main path's run starts here
            fn.launches = 0
        t0 = time.perf_counter()
        state, st = engine.train_round(state, *args, TRAIN_LR, 0)
        loss_sum = st.loss_sum
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in kernels.items()}  # ... ends
        assert np.isfinite(loss_sum).all(), loss_sum
        assert st.contributors == TRAIN_W, st
        want = module.layers * steps
        assert all(n == want for n in counts.values()), (counts, want)
        means.append(float(loss_sum.sum()) / steps)
        ms.append(1e3 * wall / steps)
        samples = float((smask * real[..., None]).sum())
        tokens = int(((batch["x"] != 0) * real[..., None, None]).sum())
        log(card, f"train gpt-mini round {r + 1}: mean loss "
            f"{means[-1]:.4f}, {steps} local steps of B={TRAIN_B} x "
            f"T={TRAIN_T} in {wall:.4f} s = {samples / wall:.2f} samples/s, "
            f"{tokens / wall:.1f} tokens/s (non-pad), "
            f"{1e3 * wall / steps:.3f} ms per local step; flash launches "
            f"{counts} (= {module.layers} layers x {steps} steps)")
    assert means[2] < means[0], means
    rng_e = np.random.default_rng(seed + 5)
    batch, smask, *_ = lm_round(rng_e, TRAIN_W, 1, TRAIN_B,
                                TRAIN_T)
    ev = engine.eval_round(state, batch, smask)
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 1.0, ev
    log(card, f"train gpt-mini: mean loss {means[0]:.4f} -> {means[2]:.4f} "
        f"over 3 rounds; eval_round loss {ev['loss']:.4f}, accuracy "
        f"{ev['accuracy']:.4f} over n={ev['n']:.0f} sequences")
    return counts, ms


def phase_train_check(torch, card, seed):
    """gpt-nano in f32, dropout 0: one round on the card (flash kernels)
    and on the CPU (plain versions) merge to the same parameters within
    AdamW's bound: its first steps divide every gradient element by its
    own magnitude, so an element whose near-zero gradient flips sign under
    another summation order moves by up to 2 lr per step."""
    K = 2
    args = lm_round(np.random.default_rng(seed + 6), 2, K, 4, 64)
    out = {}
    for dev in ("cuda", "cpu"):
        _, engine, state = train_setup(torch, "gpt-nano", seed,
                                       torch.float32, dev)
        out[dev] = engine.train_round(state, *args, TRAIN_LR, 0)
    (card_state, card_st), (cpu_state, cpu_st) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(card_st.loss_sum, cpu_st.loss_sum, rtol=1e-4)
    assert card_st.contributors == cpu_st.contributors == 2
    diffs = torch.cat([(card_state[n].cpu() - cpu_state[n]).abs().ravel()
                       for n in cpu_state])
    within = float((diffs <= 1e-5).float().mean())
    assert float(diffs.max()) <= 2 * K * TRAIN_LR, float(diffs.max())
    assert within >= 0.995, within
    log(card, f"gpt-nano f32 round, card (kernels) vs CPU (plain): loss "
        f"sums {card_st.loss_sum.tolist()} vs {cpu_st.loss_sum.tolist()}, "
        f"merged params max|diff| {float(diffs.max()):.3g} (bound "
        f"{2 * K * TRAIN_LR:g}), {100 * within:.3f} % within 1e-5")


# ------------------------------------------------------------------ phase 8
def phase_train_trace(torch, card, seed):
    """Where a training round's time goes: one gpt-mini round of phase 7's
    shape under torch.profiler; "not measured" when the profiler records
    no device activity."""
    from torch.profiler import ProfilerActivity, profile

    module, engine, state = train_setup(torch, "gpt-mini", seed,
                                        torch.bfloat16, "cuda")
    rng = np.random.default_rng(seed + 7)
    args = lm_round(rng, TRAIN_W, TRAIN_K, TRAIN_B, TRAIN_T)
    steps = int((args[2] * args[3][:, None]).sum())
    engine.train_round(state, *args, TRAIN_LR, 0)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_round(state, *args, TRAIN_LR, 0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for ev in prof.events():
        # user annotations (the optimizer's step range) are mirrored onto
        # the device track as spans over other kernels: not device time
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(ev, "is_user_annotation", False):
            tot, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        log(card, "train trace: device time not measured (the profiler "
            "recorded no CUDA activity)")
        return
    busy = sum(t for t, _ in by_name.values())
    calls = sum(n for _, n in by_name.values())
    share = {k: sum(t for name, (t, _) in by_name.items() if tag in name)
             for k, tag in (("forward", "fa_fwd_"), ("dK/dV", "fa_dkv_"),
                            ("dQ", "fa_dq_"))}
    flash = sum(share.values())
    log(card, f"trace gpt-mini train round (profiled, {steps} local steps): "
        f"wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.2f}%), idle "
        f"{100 * (1 - busy / wall_ms):.2f}%; {calls} device activities "
        f"({calls / steps:.1f} per local step); flash kernels "
        f"{flash:.3f} ms ({100 * flash / busy:.2f}% of device time: "
        + ", ".join(f"{k} {t:.3f} ms" for k, t in share.items()) + ")")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (t, n) in top:
        log(card, f"train trace top device time: {t:.3f} ms over {n} "
            f"calls: {name[:90]}")


# ------------------------------------------------------------------ phase 9
# gpt-mini's buckets at the 4 MB EF cap (the reference's plan), then two
# ragged lengths
MERGE_BUCKETS = (791296, 789760, 789760, 919808, 2097152)
MERGE_RAGGED = (7, 5000)
MERGE_CAP_MB = 4.0
MERGE_LANES, MERGE_W, MERGE_R = 2, 4, 3
MERGE_SGD_LR = 0.05
COLD_BYTES = 120e6        # operand sets cycled per timing: 2.4 x the L2


def merge_bound(n: int) -> float:
    """Least time (ms) of one merge-apply over n elements: 12 bytes each
    (s and ref read, out written) over the memory rate; 3 flops each are
    nothing beside that."""
    return 12 * n / H100_BYTES_PER_S * 1e3


def time_ms_cold(torch, fn, operand_sets) -> float:
    """time_ms with the L2 cold: consecutive calls take consecutive
    operand sets of COLD_BYTES in all, so each call's operands were
    evicted by the sets in between; every call's output is kept, so each
    writes its own buffer and the writes reach device memory too."""
    n = len(operand_sets)
    outs = []

    def cycled():
        outs.append(fn(*operand_sets[len(outs) % n]))

    try:
        return time_ms(torch, cycled, calls=2 * n)
    finally:
        outs.clear()


def phase_merge_kernel(torch, card, seed):
    """(a) the fused merge-apply kernel against its plain version, bit for
    bit (torch.equal), both modes, raw_count 3 and 0 (the guard path with
    a NaN in s must return ref), at gpt-mini's bucket lengths and two
    ragged ones; warm and L2-cold device times, the plain version's, and
    the bytes bound."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    rows = {}
    for n in dict.fromkeys(MERGE_BUCKETS + MERGE_RAGGED):   # each length once
        s = torch.randn(n, device=dev, generator=gen) * 7
        ref = torch.randn(n, device=dev, generator=gen)
        s_nan = s.clone()
        s_nan[n // 2] = float("nan")
        row = {}
        for mode, lr in (("avg", 0.0), ("sgd", MERGE_SGD_LR)):
            for raw in (3.0, 0.0):
                raw_t = torch.tensor(raw, device=dev)
                cnt = raw_t.clamp_min(1.0)
                src = s if raw > 0 else s_nan
                got = fm.fused_merge_kernel(mode, src, ref, cnt, raw_t, lr)
                torch.cuda.synchronize()
                want = fm._apply_plain(mode, src, ref, cnt, raw_t, lr)
                assert torch.equal(got, want), (mode, n, raw)
                if raw == 0:
                    assert torch.equal(got, ref), (mode, n)
            raw_t = torch.tensor(3.0, device=dev)
            cnt = raw_t.clamp_min(1.0)
            ms = time_ms(torch, lambda: fm.fused_merge_kernel(
                mode, s, ref, cnt, raw_t, lr))
            plain_ms = time_ms(torch, lambda: fm._apply_plain(
                mode, s, ref, cnt, raw_t, lr))
            entry = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=merge_bound(n))
            if n in MERGE_BUCKETS:
                sets = [(torch.randn(n, device=dev, generator=gen),
                         torch.randn(n, device=dev, generator=gen))
                        for _ in range(max(2, -(-int(COLD_BYTES)
                                                // (8 * n))))]
                entry["cold_ms"] = time_ms_cold(
                    torch, lambda a, b: fm.fused_merge_kernel(
                        mode, a, b, cnt, raw_t, lr), sets)
                del sets
            row[mode] = entry
            log(card, f"fused_merge {mode} N={n}: kernel {ms:.4f} ms"
                + (f" (L2 cold {entry['cold_ms']:.4f} ms)"
                   if "cold_ms" in entry else "")
                + f", plain {plain_ms:.4f} ms, bound {merge_bound(n):.5f} "
                f"ms (bytes), {ms / merge_bound(n):.2f}x bound; kernel == "
                f"plain bit for bit (raw_count 3 and 0)")
        rows[n] = row
    return rows


def stacked_rounds(rng, R, W, K, B, T):
    """R of phase 7's rounds with a leading round axis (train_rounds)."""
    rounds = [lm_round(rng, W, K, B, T) for _ in range(R)]
    batch = {"x": np.stack([r[0]["x"] for r in rounds])}
    return (batch, *(np.stack([r[i] for r in rounds]) for i in range(1, 5)))


def record_merges(engine):
    """Wrap the engine's lane_merge to keep each call's inputs (copies):
    a real round's contributions for the parity check and the replay."""
    calls = []
    inner = engine._merge.lane_merge

    def recording(contrib, ref, raw_count, count, lane_alive=None,
                  residual=None):
        calls.append(dict(
            contrib={k: v.clone() for k, v in contrib.items()},
            ref={k: v.clone() for k, v in ref.items()},
            raw_count=raw_count.clone(), count=count.clone(),
            lane_alive=lane_alive.clone(),
            residual=({k: v.clone() for k, v in residual.items()}
                      if residual is not None else None)))
        return inner(contrib, ref, raw_count, count, lane_alive, residual)

    engine._merge.lane_merge = recording
    return calls


def int8_quanta(torch, engine, call):
    """Each parameter's int8 quantum in a recorded merge: its bucket's
    shared scale, max|payload| over every lane / 127."""
    names, plan = engine._merge._plan(call["ref"])
    alive = call["lane_alive"].reshape(-1, 1)
    quanta = {}
    for bi, bucket in enumerate(plan.buckets):
        members = [names[i] for i in bucket.indices]
        c = torch.cat([call["contrib"][n].reshape(alive.shape[0], -1)
                       for n in members], dim=1)
        r = call["residual"][f"b{bi}"].reshape(c.shape)
        scale = float(torch.where(alive, c + r, 0.0).abs().max()) / 127.0
        quanta.update({n: scale for n in members})
    return quanta


def phase_merge_train(torch, card, seed):
    """(b) + (c): gpt-mini at full width, bf16, dropout 0.1, n_lanes=2,
    W=4, K=4, B=8, T=512, three train_rounds per strategy (bucketed at
    4 MB, ef_bf16, ef_int8); the merge kernel's launches (5 buckets x 3
    rounds), the flash launches, falling loss, finite residuals, a dead
    lane's zeroed residual; and the first bucketed round's contributions
    merged by MonolithicMerge and by BucketedMerge(4 MB) on the card,
    equal bit for bit."""
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm
    from kubeml_tpu_torch.parallel.merge import BucketedMerge, MonolithicMerge

    flash = (fa.fa_fwd_kernel, fa.fa_bwd_dkv_kernel, fa.fa_bwd_dq_kernel)
    launches = {}
    engines = {}
    for name, knobs in (("bucketed", dict(merge_bucket_mb=MERGE_CAP_MB)),
                        ("ef_bf16", dict(merge_compress="bf16")),
                        ("ef_int8", dict(merge_compress="int8"))):
        module, engine, state = train_setup(
            torch, "gpt-mini", seed, torch.bfloat16, "cuda",
            n_lanes=MERGE_LANES, **knobs)
        assert engine.merge_strategy == name, engine.merge_strategy
        calls = record_merges(engine) if name == "bucketed" else []
        rng = np.random.default_rng(seed + 9)
        args = stacked_rounds(rng, MERGE_R, MERGE_W, TRAIN_K, TRAIN_B,
                              TRAIN_T)
        real = args[2] * args[3][..., None]             # [R, W, S]
        fm.fused_merge_kernel.launches = 0   # the main path's run starts
        for fn in flash:
            fn.launches = 0
        t0 = time.perf_counter()
        state, st = engine.train_rounds(state, *args, TRAIN_LR, 0)
        loss_sum = st.loss_sum
        wall = time.perf_counter() - t0
        n = fm.fused_merge_kernel.launches   # ... and ends here
        flash_n = [fn.launches for fn in flash]
        n_buckets = engine.merge_comm_proxy(state)["buckets_per_round"]
        assert n_buckets == len(MERGE_BUCKETS), n_buckets
        assert n == n_buckets * MERGE_R, (name, n)
        steps = real.sum(axis=(1, 2))
        assert flash_n == [module.layers * int(steps.sum())] * 3, flash_n
        assert np.isfinite(loss_sum).all(), loss_sum
        assert st.contributors == MERGE_W * MERGE_R, st.contributors
        means = loss_sum.sum(axis=1) / steps
        assert means[-1] < means[0], (name, means)
        launches[name] = n
        msg = ""
        if engine._ef:
            assert all(bool(torch.isfinite(v).all())
                       for v in engine._ef_state.values())
            # one more round with lane 1's workers masked out
            batch, smask, stmask, _, rngs = lm_round(
                rng, MERGE_W, TRAIN_K, TRAIN_B, TRAIN_T)
            state, _ = engine.train_round(
                state, batch, smask, stmask,
                np.array([1, 1, 0, 0], np.float32), rngs, TRAIN_LR, 0)
            for k, v in engine._ef_state.items():
                lanes = v.reshape(MERGE_LANES, -1)
                assert not bool(lanes[1].any()), (name, k)
                assert bool(lanes[0].any()), (name, k)
            msg = ("; residuals finite, and after a round with lane 1 dead "
                   "its residual is exactly zero while lane 0's is not")
        log(card, f"merge train gpt-mini {name} (n_lanes={MERGE_LANES}, "
            f"W={MERGE_W}, K={TRAIN_K}, R={MERGE_R}): mean loss "
            + " -> ".join(f"{m:.4f}" for m in means)
            + f", {int(steps.sum())} local steps in {wall:.4f} s = "
            f"{1e3 * wall / steps.sum():.3f} ms per local step; fused merge "
            f"launches {n} (= {n_buckets} buckets x {MERGE_R} rounds), flash "
            f"launches {flash_n}" + msg)
        engines[name] = (module, engine, state)
        if calls:
            call = calls[0]
            args = (call["contrib"], call["ref"], call["raw_count"],
                    call["count"], call["lane_alive"])
            mono, _ = MonolithicMerge().lane_merge(*args)
            buck, _ = BucketedMerge(bucket_mb=MERGE_CAP_MB).lane_merge(*args)
            torch.cuda.synchronize()
            assert all(torch.equal(mono[k], buck[k]) for k in mono)
            log(card, f"merge parity on the card: a real gpt-mini round's "
                f"contributions ({MERGE_LANES} lanes) merged by "
                f"MonolithicMerge ({len(mono)} leaves) and by "
                f"BucketedMerge({MERGE_CAP_MB:g} MB, fused kernel) are "
                f"equal bit for bit")
            del calls[:]
    return launches, engines


def phase_merge_check(torch, card, seed):
    """(d) gpt-nano in f32, ef_int8, n_lanes=2: one round on the card
    (kernels, one merge launch per bucket) and on the CPU (plain versions)
    merge to the same parameters within AdamW's bound plus one int8
    quantum of the bucket, 99.5 % of the elements within 1e-5."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    K = 2
    args = lm_round(np.random.default_rng(seed + 10), MERGE_W, K, 4, 64)
    out = {}
    for dev in ("cuda", "cpu"):
        _, engine, state = train_setup(torch, "gpt-nano", seed,
                                       torch.float32, dev,
                                       n_lanes=MERGE_LANES,
                                       merge_compress="int8",
                                       merge_bucket_mb=0.02)
        calls = record_merges(engine)
        before = fm.fused_merge_kernel.launches
        out[dev] = engine.train_round(state, *args, TRAIN_LR, 0)
        n_buckets = engine.merge_comm_proxy(state)["buckets_per_round"]
        launched = fm.fused_merge_kernel.launches - before
        assert launched == (n_buckets if dev == "cuda" else 0), launched
        if dev == "cpu":
            quanta = int8_quanta(torch, engine, calls[0])
    (card_state, card_st), (cpu_state, cpu_st) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(card_st.loss_sum, cpu_st.loss_sum, rtol=1e-4)
    np.testing.assert_array_equal(card_st.dropped, cpu_st.dropped)
    worst, diffs = -1.0, []
    for n in cpu_state:
        d = (card_state[n].cpu() - cpu_state[n]).abs().ravel()
        diffs.append(d)
        worst = max(worst, float(d.max()) / (2 * K * TRAIN_LR + quanta[n]))
    diffs = torch.cat(diffs)
    within = float((diffs <= 1e-5).float().mean())
    assert worst <= 1.0, worst
    assert within >= 0.995, within
    log(card, f"gpt-nano f32 ef_int8 round (n_lanes={MERGE_LANES}, "
        f"{n_buckets} buckets), card vs CPU: merged params max|diff| "
        f"{float(diffs.max()):.3g}, at most {worst:.3f} of the bound 2 x K x "
        f"lr + the bucket's int8 scale; {100 * within:.3f} % within 1e-5")


def device_events(torch, prof):
    """{kernel name: (device ms, calls)} of a profile, user annotations
    (spans over other kernels) left out."""
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(ev, "is_user_annotation", False):
            tot, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


def phase_merge_trace(torch, card, seed, engines):
    """(e) where the merge's time goes: one ef_int8 gpt-mini round under
    torch.profiler (device busy time), then that round's merge replayed
    alone on its recorded inputs under the profiler: the fused kernel,
    the cat/split copies and the quantize ops, against the round's busy
    time."""
    from torch.profiler import ProfilerActivity, profile

    _, engine, state = engines["ef_int8"]
    args = lm_round(np.random.default_rng(seed + 11), MERGE_W, TRAIN_K,
                    TRAIN_B, TRAIN_T)
    calls = record_merges(engine)
    engine.train_round(state, *args, TRAIN_LR, 0)    # records its merge
    del engine._merge.lane_merge                      # and unwraps it
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_round(state, *args, TRAIN_LR, 0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    round_ev = device_events(torch, prof)
    call = calls[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine._merge.lane_merge(call["contrib"], call["ref"],
                                 call["raw_count"], call["count"],
                                 call["lane_alive"], call["residual"])
        torch.cuda.synchronize()
    merge_ev = device_events(torch, prof)
    if not round_ev or not merge_ev:
        log(card, "merge trace: device time not measured (the profiler "
            "recorded no CUDA activity)")
        return None
    busy = sum(t for t, _ in round_ev.values())
    merge = sum(t for t, _ in merge_ev.values())
    parts = {"fused kernel": 0.0, "copies": 0.0, "quantize and sums": 0.0}
    for name, (t, _) in merge_ev.items():
        if "fused_merge" in name:
            parts["fused kernel"] += t
        elif "opy" in name or "Cat" in name or "cat" in name:
            parts["copies"] += t
        else:
            parts["quantize and sums"] += t
    calls_n = sum(n for _, n in merge_ev.values())
    log(card, f"merge trace gpt-mini ef_int8 round (profiled): wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms; its merge replayed "
        f"alone: {merge:.3f} ms of device time over {calls_n} device "
        f"activities = {100 * merge / busy:.2f}% of the round's busy time ("
        + ", ".join(f"{k} {t:.3f} ms" for k, t in parts.items()) + ")")
    top = sorted(merge_ev.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (t, n) in top:
        log(card, f"merge trace top device time: {t:.3f} ms over {n} calls: "
            f"{name[:90]}")
    return dict(merge_ms=merge, round_busy_ms=busy, **parts)


# ----------------------------------------------------------------- phase 10
JOB_TRAIN, JOB_TEST = 1024, 128          # token windows of TRAIN_T tokens
JOB_B, JOB_K, JOB_EPOCHS, JOB_LR = 8, 4, 3, 1e-3
JOB_N0, JOB_NMAX = 2, 4
JOB_BUCKETS = len(MERGE_BUCKETS)         # gpt-mini's merge at 4 MB


def token_windows(rng, n, T):
    """n windows of T int32 tokens: phase 7's arithmetic runs, half of
    them ending in padding at a random length."""
    start = rng.integers(1, RUN_PERIOD + 1, (n, 1))
    x = ((start + np.arange(T) - 1) % RUN_PERIOD + 1).astype(np.int32)
    lengths = np.where(rng.random(n) < 0.5, rng.integers(T // 4, T, n), T)
    x[np.arange(T) >= lengths[:, None]] = 0
    return x


def token_dataset():
    """A KubeDataset of token windows with no labels (the JAX package's
    TextWindows example): the batch is {"x": int32 [B, T]}."""
    from kubeml_tpu_torch.models.base import KubeDataset

    class TokenWindows(KubeDataset):
        def transform_train(self, data, labels):
            return {"x": np.asarray(data).astype(np.int32)}

        transform_test = transform_train

    return TokenWindows("tokens")


def job_task(job_id, epochs, **opts):
    from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                            TrainTask)

    model = opts.pop("model", "gpt-mini")
    req = TrainRequest(model_type=model, batch_size=opts.pop("batch", JOB_B),
                       epochs=epochs, dataset=opts.pop("dataset", "tokens"),
                       lr=opts.pop("lr", JOB_LR),
                       resume_from=opts.pop("resume_from", ""),
                       options=TrainOptions(**opts))
    return TrainTask(job_id=job_id, parameters=req,
                     parallelism=req.options.default_parallelism)


def phase_job(torch, card, seed, engine_ms):
    """gpt-mini TrainJob end to end (see the module docstring, phase 10);
    returns the per-epoch kernel launches of the job's run."""
    import os
    import tempfile

    from kubeml_tpu_torch.data.registry import DatasetRegistry

    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = tmp
        try:
            rng = np.random.default_rng(seed + 12)
            DatasetRegistry().create(
                "tokens", token_windows(rng, JOB_TRAIN, TRAIN_T),
                np.zeros(JOB_TRAIN, np.int32),
                token_windows(rng, JOB_TEST, TRAIN_T),
                np.zeros(JOB_TEST, np.int32))
            launches = job_run(torch, card, seed, engine_ms)
            job_check(torch, card, seed)
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home
    return launches


def _epoch_counts(parallelism, eval_workers):
    """What one epoch of the job must launch, from the JAX package's
    epoch plan (ported in data/sharding.py): (real local steps, rounds,
    eval steps = every (worker, step) slot of the eval batches)."""
    from kubeml_tpu_torch.data.sharding import plan_epoch

    plan = plan_epoch(JOB_TRAIN, parallelism, JOB_K, JOB_B)
    test = plan_epoch(JOB_TEST, eval_workers, -1, JOB_B)
    return (plan.total_steps, len(plan.rounds),
            eval_workers * test.rounds[0].max_steps)


def job_run(torch, card, seed, engine_ms):
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine
    from kubeml_tpu_torch.data.loader import RoundLoader
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    kernels = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
               "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel}

    def zero():
        for fn in kernels.values():
            fn.launches = 0

    # a train_stats-free job runs the same engine as phase 7 (the health
    # stats clone every parameter per step), so ms per local step compare
    task = job_task("smoke-job", JOB_EPOCHS, default_parallelism=JOB_N0,
                    max_parallelism=JOB_NMAX, static_parallelism=False,
                    k=JOB_K, merge_bucket_mb=MERGE_CAP_MB, validate_every=1,
                    train_stats=False)
    epochs, after_epoch1 = [], {}

    def publish(m):
        # the epoch's run (training and its validation) ends here
        counts = {k: fn.launches for k, fn in kernels.items()}
        epochs.append((m, counts))
        if len(epochs) == 1:
            after_epoch1.update({k: v.clone() for k, v in job.state.items()})
        zero()                                  # ... and the next starts

    model = get_model("gpt-mini")()
    job = TrainJob(task, model, token_dataset(), device="cuda",
                   callbacks=JobCallbacks(
                       request_parallelism=lambda t: t.parallelism + 1,
                       publish_metrics=publish))
    zero()                                      # the main path's run starts
    t0 = time.perf_counter()
    record = job.train()
    wall = time.perf_counter() - t0
    hist = record.data
    assert hist.parallelism == [2, 3, 4], hist.parallelism
    assert hist.train_loss[-1] < hist.train_loss[0], hist.train_loss
    assert all(np.isfinite(hist.validation_loss)), hist.validation_loss
    layers = job._engine.module.layers
    x, _ = job._handle.train_arrays()
    tokens = int((np.asarray(x) != 0).sum())   # every sample once an epoch
    launches, steps_all, job_ms = [], 0, []
    for e, (m, counts) in enumerate(epochs):
        n = hist.parallelism[e]
        # validation runs at the pinned worker count, JOB_NMAX
        steps, rounds, evals = _epoch_counts(n, JOB_NMAX)
        want = {"forward": layers * (steps + evals), "dK/dV": layers * steps,
                "dQ": layers * steps, "fused_merge": JOB_BUCKETS * rounds}
        assert counts == want, (e, counts, want)
        launches.append(counts)
        steps_all += steps
        samples = steps * JOB_B
        ph = {k: sum(v) for k, v in m.phase_times.items()}
        sec = hist.epoch_duration[e]
        job_ms.append(1e3 * sec / steps)
        log(card, f"job gpt-mini epoch {e + 1}/{JOB_EPOCHS} N={n}: train "
            f"loss {hist.train_loss[e]:.4f}, validation loss "
            f"{hist.validation_loss[e]:.4f}, {steps} local steps in "
            f"{rounds} rounds, wall {sec:.4f} s = {samples / sec:.2f} "
            f"samples/s, {tokens / sec:.1f} tokens/s (non-pad), "
            f"{1e3 * sec / steps:.3f} ms per local step; data_wait "
            f"{ph['data_wait']:.4f} s, dispatch {ph['dispatch']:.4f} s, "
            f"merge_wait {ph['merge_wait']:.4f} s; launches {counts} "
            f"(= {layers} layers x {steps} steps (+ {evals} eval steps), "
            f"{JOB_BUCKETS} buckets x {rounds} rounds); peak device memory "
            f"{m.hbm_peak_bytes / 2**20:.1f} MiB")
    log(card, f"job vs engine: the job's ms per local step "
        f"{', '.join(f'{x:.3f}' for x in job_ms)} (epochs 1-3) against "
        f"phase 7's engine-direct {', '.join(f'{x:.3f}' for x in engine_ms)}"
        f" (rounds 1-3); median {statistics.median(job_ms):.3f} vs "
        f"{statistics.median(engine_ms):.3f} ms; job wall {wall:.3f} s "
        f"for {steps_all} local steps and {JOB_EPOCHS} validations")

    # the final checkpoint loads back through the port, equal to the state
    tree, manifest = load_checkpoint("smoke-job")
    back = model.params_from_flax(tree["params"])
    assert manifest["completed"] and manifest["epoch"] == JOB_EPOCHS
    assert all(torch.equal(back[k], v.cpu()) for k, v in job.state.items())
    # a restart of the finished job resumes as done: nothing retrained
    zero()
    again = TrainJob(job_task("smoke-job", JOB_EPOCHS,
                              default_parallelism=JOB_N0,
                              max_parallelism=JOB_NMAX, k=JOB_K,
                              merge_bucket_mb=MERGE_CAP_MB,
                              train_stats=False, resume_from="smoke-job"),
                     get_model("gpt-mini")(), token_dataset(), device="cuda")
    rec2 = again.train()
    assert again._start_epoch == JOB_EPOCHS, again._start_epoch
    assert rec2.data.train_loss == hist.train_loss
    assert all(fn.launches == 0 for fn in kernels.values())
    log(card, f"job checkpoint: loads back equal to the job's weights "
        f"({len(back)} tensors); a restart with resume_from=smoke-job "
        f"resumed at epoch {again._start_epoch} as done, no kernel launched")

    # the same epoch 1 driven by hand: the job's rounds fed to the engine
    hand_model = get_model("gpt-mini")()
    handle = job._handle
    loader = RoundLoader(handle, token_dataset(), n_lanes=1, seed=0,
                         w_floor=JOB_NMAX)
    x, y = handle.doc_range("train", 0, 1)
    sample = token_dataset().transform_train(np.asarray(x[:JOB_B]),
                                             np.asarray(y[:JOB_B]))
    module = hand_model.init_module(sample, torch.Generator().manual_seed(0),
                                    device="cuda")
    engine = KAvgEngine(module, hand_model.loss, hand_model.metrics,
                        hand_model.configure_optimizers,
                        merge_bucket_mb=MERGE_CAP_MB)
    state = {n: p.detach().clone() for n, p in module.named_parameters()}
    torch.cuda.synchronize()
    hand_s = 0.0       # the engine's calls alone: assembly is left out
    for rb in loader.epoch_rounds(loader.plan(JOB_N0, JOB_K, JOB_B), 0):
        t0 = time.perf_counter()
        state, st = engine.train_round(state, rb.batch, rb.sample_mask,
                                       rb.step_mask, rb.worker_mask,
                                       rb.rngs, lr=JOB_LR, epoch=0)
        hand_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    hand_s += time.perf_counter() - t0
    diff = max(float((state[k] - after_epoch1[k]).abs().max())
               for k in state)
    assert all(torch.equal(state[k], after_epoch1[k]) for k in state), diff
    steps1 = _epoch_counts(JOB_N0, JOB_NMAX)[0]
    log(card, f"job == engine driven by hand: epoch 1's weights equal bit "
        f"for bit (torch.equal) over {len(state)} tensors; the same "
        f"{steps1} local steps driven by hand take {hand_s:.4f} s of engine "
        f"calls = {1e3 * hand_s / steps1:.3f} ms per local step, against "
        f"the job's {job_ms[0]:.3f} ms (epoch 1)")
    return launches


def job_check(torch, card, seed):
    """gpt-nano in f32 (dropout 0): one epoch of a TrainJob on the card
    and on the CPU, both warm-started from one seed checkpoint, within
    AdamW's bound of 2 lr per local step, 99.5 % within 1e-5."""
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint
    from kubeml_tpu_torch.train.job import TrainJob

    cfg = GPT_CONFIGS["gpt-nano"]
    rng = np.random.default_rng(seed + 13)
    T, B, K = cfg["max_len"], 32, 2
    DatasetRegistry().create(
        "nano-tokens", token_windows(rng, 256, T),
        np.zeros(256, np.int32), token_windows(rng, 64, T),
        np.zeros(64, np.int32))
    save_checkpoint("nano-seed", {"params": random_flax_params(**cfg,
                                                               seed=seed)},
                    {"model": "gpt-nano", "function": "gpt-nano"})
    out = {}
    for dev in ("cuda", "cpu"):
        task = job_task(f"nano-{dev}", 1, model="gpt-nano", batch=B, k=K,
                        dataset="nano-tokens", default_parallelism=2,
                        static_parallelism=True, resume_from="nano-seed",
                        merge_bucket_mb=0.02)
        job = TrainJob(task, get_model("gpt-nano")(dtype=torch.float32),
                       token_dataset(), device=dev)
        out[dev] = (job.train(), {k: v.cpu() for k, v in job.state.items()})
    (card_rec, card_state), (cpu_rec, cpu_state) = out["cuda"], out["cpu"]
    steps = 2 * K      # 128 samples per worker: 2 rounds of K steps of 32
    diffs = torch.cat([(card_state[k] - cpu_state[k]).abs().ravel()
                       for k in cpu_state])
    within = float((diffs <= 1e-5).float().mean())
    np.testing.assert_allclose(card_rec.data.train_loss,
                               cpu_rec.data.train_loss, rtol=1e-4)
    assert float(diffs.max()) <= 2 * steps * JOB_LR, float(diffs.max())
    assert within >= 0.995, within
    log(card, f"gpt-nano f32 job, card vs CPU (one epoch, {steps} local "
        f"steps per worker): train loss {card_rec.data.train_loss[0]:.6f} "
        f"vs {cpu_rec.data.train_loss[0]:.6f}, params max|diff| "
        f"{float(diffs.max()):.3g} (bound {2 * steps * JOB_LR:g}), "
        f"{100 * within:.3f} % within 1e-5")


# ----------------------------------------------------------------- phase 11
CIFAR_TRAIN, CIFAR_TEST, CIFAR_HW = 50_000, 10_000, 32
VIS_B, VIS_K, VIS_LR, VIS_N = 256, 8, 0.1, 2   # bench.py's B and K
VIS_EPOCHS = 2
VIS_BUCKET_MB = 4.0
VIS_CPU_BOUND = 1e-4       # card vs CPU, f32 rounds: parameters and stats


def cifar_arrays(rng, n):
    """n CIFAR-10-shaped u8 NHWC images and int32 labels: uniform noise
    in [0, 220), and class k lifts channel k % 3 by 3 * (k // 3 + 1), a
    shift of 1.5 standard deviations of an image's channel mean between
    neighbouring classes: learnable, and not solved in one epoch."""
    y = rng.integers(0, 10, n).astype(np.int32)
    x = rng.integers(0, 220, (n, CIFAR_HW, CIFAR_HW, 3), dtype=np.uint8)
    lift = (3 * (y // 3 + 1)).astype(np.uint8)
    x[np.arange(n), :, :, y % 3] += lift[:, None, None]
    return x, y


def cifar_dataset():
    """u8 -> f32 / 255 on the host (transform_train / transform_test) and
    the same on the card (transform_train_device), so the job may run
    from the device cache."""
    from kubeml_tpu_torch.models.base import KubeDataset

    class Cifar(KubeDataset):
        def transform_train(self, data, labels):
            return {"x": np.asarray(data).astype(np.float32) / 255.0,
                    "y": np.asarray(labels)}

        transform_test = transform_train

        @staticmethod
        def transform_train_device(x, y):
            return {"x": x.float() / 255.0, "y": y}

    return Cifar("cifar")


def resnet18_plan():
    """ResNet-18's merge buckets at VIS_BUCKET_MB over its whole variable
    tree (batch_stats and params) in flax flatten order: the reference's
    plan, from shapes alone."""
    import torch

    from kubeml_tpu_torch.convert import flax_leaf_order
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import module_state
    from kubeml_tpu_torch.parallel.merge import plan_buckets

    state = module_state(get_model("resnet18")().build(
        dtype=torch.bfloat16, device="cpu"))
    return plan_buckets([state[n] for n in flax_leaf_order(state)],
                        VIS_BUCKET_MB)


def phase_vision(torch, card, seed):
    """ResNet-18 on the card (see the module docstring, phase 11); returns
    (the merge's ResNet-18 launches per epoch, the row for the kernels
    line)."""
    import os
    import tempfile

    from kubeml_tpu_torch.data.registry import DatasetRegistry

    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = tmp
        try:
            rng = np.random.default_rng(seed + 14)
            t0 = time.perf_counter()
            DatasetRegistry().create("cifar", *cifar_arrays(rng, CIFAR_TRAIN),
                                     *cifar_arrays(rng, CIFAR_TEST))
            log(card, f"vision dataset: {CIFAR_TRAIN} train and {CIFAR_TEST} "
                f"test u8 images 32x32x3 written in "
                f"{time.perf_counter() - t0:.2f} s")
            launches = vision_job(torch, card, seed)
            vision_rounds(torch, card, seed)
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home
    vision_check(torch, card, seed)
    vision_trace(torch, card, seed)
    return launches


def vision_task(job_id, epochs, **opts):
    return job_task(job_id, epochs, model="resnet18", batch=VIS_B,
                    dataset="cifar", lr=VIS_LR, k=VIS_K,
                    default_parallelism=VIS_N, static_parallelism=True,
                    merge_bucket_mb=VIS_BUCKET_MB, train_stats=False,
                    **opts)


def vision_job(torch, card, seed):
    """TrainJob(resnet18) for VIS_EPOCHS epochs from the device cache
    (device_cache='auto'), then one more epoch of the same job host-staged
    (device_cache='off', warm-started from the first run's checkpoint):
    per epoch wall, samples/s, ms per local step, the phase split and the
    merge kernel's launches, which must be buckets x rounds of the plan."""
    from kubeml_tpu_torch.data.sharding import plan_epoch
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.ops import fused_merge as fm
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    plan = plan_epoch(CIFAR_TRAIN, VIS_N, VIS_K, VIS_B)
    steps, rounds = plan.total_steps, len(plan.rounds)
    buckets = resnet18_plan().n_buckets
    rows = []

    def run(job_id, epochs, mode, resume_from=""):
        epochs_seen = []

        def publish(m):
            # the epoch's run (training and its validation) ends here
            epochs_seen.append((m, fm.fused_merge_kernel.launches))
            fm.fused_merge_kernel.launches = 0   # ... and the next starts

        job = TrainJob(vision_task(job_id, epochs, device_cache=mode,
                                   resume_from=resume_from),
                       get_model("resnet18")(), cifar_dataset(),
                       device="cuda",
                       callbacks=JobCallbacks(publish_metrics=publish))
        fm.fused_merge_kernel.launches = 0       # the main path's run starts
        hist = job.train().data
        for e, (m, n) in enumerate(epochs_seen):
            sec = hist.epoch_duration[e]
            ph = {k: sum(v) for k, v in m.phase_times.items()}
            assert n == buckets * rounds, (n, buckets, rounds)
            row = dict(cache=mode, epoch=e + 1, wall_s=sec,
                       samples_per_s=CIFAR_TRAIN / sec,
                       ms_per_step=1e3 * sec / steps, launches=n,
                       loss=hist.train_loss[e], **ph)
            rows.append(row)
            log(card, f"vision job resnet18 device_cache={mode} epoch "
                f"{e + 1}/{epochs} N={VIS_N}: train loss "
                f"{hist.train_loss[e]:.4f}, validation loss "
                f"{hist.validation_loss[e]:.4f}, accuracy "
                f"{hist.accuracy[e]:.2f} %, {steps} local steps of "
                f"B={VIS_B} in {rounds} rounds, wall {sec:.4f} s = "
                f"{CIFAR_TRAIN / sec:.2f} samples/s, {1e3 * sec / steps:.3f} "
                f"ms per local step; data_wait {ph['data_wait']:.4f} s, "
                f"dispatch {ph['dispatch']:.4f} s, merge_wait "
                f"{ph['merge_wait']:.4f} s; fused_merge launches {n} (= "
                f"{buckets} buckets x {rounds} rounds); peak device memory "
                f"{m.hbm_peak_bytes / 2**20:.1f} MiB")
        assert all(np.isfinite(hist.validation_loss)), hist.validation_loss
        return job, hist, [n for _, n in epochs_seen]

    job, hist, launches = run("vision", VIS_EPOCHS, "auto")
    cache = job._device_cache
    assert cache is not None and cache.layout == "sharded", cache
    assert cache.stats["uploads"] == 1, cache.stats
    assert hist.train_loss[-1] < hist.train_loss[0], hist.train_loss
    slots = VIS_N * VIS_K * VIS_B
    per_sample = cache.per_sample_bytes(cache.handle)
    log(card, f"vision device cache: {cache.layout}, "
        f"{cache.device_bytes / 2**20:.1f} MiB on the card, uploaded "
        f"{cache.stats['uploads']} time(s); a round carries {slots * 4} B "
        f"of indices against {slots * per_sample} B of u8 samples "
        f"(host-staged rounds ship {slots * CIFAR_HW * CIFAR_HW * 3 * 4} B "
        f"of f32 pixels)")
    off_job, _, off_launches = run("vision-off", 1, "off",
                                   resume_from="vision")
    assert off_job._device_cache is None
    cached, staged = rows[VIS_EPOCHS - 1], rows[-1]
    log(card, f"vision cache vs host-staged: epoch {VIS_EPOCHS} from the "
        f"cache {cached['wall_s']:.4f} s ({cached['samples_per_s']:.2f} "
        f"samples/s, {cached['ms_per_step']:.3f} ms per local step) against "
        f"the host-staged epoch {staged['wall_s']:.4f} s "
        f"({staged['samples_per_s']:.2f} samples/s, "
        f"{staged['ms_per_step']:.3f} ms per local step): the cache "
        f"{'faster' if cached['wall_s'] < staged['wall_s'] else 'slower'} "
        f"by {100 * abs(staged['wall_s'] / cached['wall_s'] - 1):.2f} %")
    print(json.dumps({"vision_epochs": rows}), flush=True)
    return launches + off_launches


def vision_engine(torch, device, dtype, stages=(2, 2, 2, 2), width=64,
                  lenet=False, seed=0, **engine_kw):
    """An engine over a ResNet (or LeNet) module whose variables come
    from the seed (through the port's flax initializers), and its state."""
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import module_state
    from kubeml_tpu_torch.models.resnet import ResNetModule
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine
    from kubeml_tpu_torch.models.base import flax_default_init_

    model = get_model("lenet" if lenet else "resnet18")()
    if lenet:
        module = model.build(dtype=dtype, device=device)
    else:
        module = ResNetModule(stages, width=width, dtype=dtype,
                              device=device)
    flax_default_init_(module, torch.Generator().manual_seed(seed))
    engine = KAvgEngine(module, model.loss, model.metrics,
                        model.configure_optimizers, **engine_kw)
    state = {k: v.detach().clone() for k, v in module_state(module).items()}
    return engine, state


def _max_diff(a, b) -> float:
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
               for k in a)


def _equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(a[k].equal(b[k]) for k in a)


def vision_rounds(torch, card, seed):
    """Engine-level ResNet-18 checks on the card from the job's own
    dataset and loader: one round index-fed == host-staged, two index-fed
    rounds grouped (R=2) == the two single rounds, and the bucketed merge
    (4 MB, the fused kernel) against the monolithic one. cuDNN picks its
    algorithms per call; the equality checks run with
    torch.backends.cudnn.deterministic = True, and the same index-fed vs
    host-staged pair is also run without it to record whether bit
    equality holds then."""
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache
    from kubeml_tpu_torch.data.loader import RoundLoader
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    handle = DatasetRegistry().get("cifar")
    dataset = cifar_dataset()
    loader = RoundLoader(handle, dataset, n_lanes=1, seed=seed)
    plan = loader.plan(VIS_N, VIS_K, VIS_B)
    W = loader.round_geometry(plan)[0]
    cache = DeviceDatasetCache(handle, "cuda", layout="sharded",
                               device_transform=dataset.transform_train_device)
    cache.ensure(plan, W)
    host = [rb for _, rb in zip(range(2), loader.epoch_rounds(plan, 0))]
    idx = [rb for _, rb in zip(range(2), loader.epoch_index_rounds(
        plan, 0, cache.lane_starts))]

    def one(rb, indexed, **kw):
        engine, state = vision_engine(torch, "cuda", torch.bfloat16,
                                      seed=seed, **kw)
        if indexed:
            return engine.train_round_indexed(
                state, cache, rb.batch["idx"], rb.sample_mask, rb.step_mask,
                rb.worker_mask, rb.rngs, lr=VIS_LR, epoch=0)
        return engine.train_round(state, rb.batch, rb.sample_mask,
                                  rb.step_mask, rb.worker_mask, rb.rngs,
                                  lr=VIS_LR, epoch=0)

    out = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        a, sa = one(host[0], False)
        b, sb = one(idx[0], True)
        out[det] = (_equal(a, b), _max_diff(a, b),
                    sa.loss_sum_device.equal(sb.loss_sum_device))
    try:
        torch.backends.cudnn.deterministic = True
        assert out[True][0] and out[True][2], out
        # R=2 grouped == two single rounds
        engine, state = vision_engine(torch, "cuda", torch.bfloat16,
                                      seed=seed)
        stack = {k: np.stack([getattr(r, k) for r in idx])
                 for k in ("sample_mask", "step_mask", "worker_mask",
                           "rngs")}
        grouped, st_g = engine.train_rounds_indexed(
            state, cache, np.stack([r.batch["idx"] for r in idx]),
            lr=VIS_LR, epoch=0, **stack)
        engine, single = vision_engine(torch, "cuda", torch.bfloat16,
                                       seed=seed)
        sums = []
        for r in idx:
            single, st = engine.train_round_indexed(
                single, cache, r.batch["idx"], r.sample_mask, r.step_mask,
                r.worker_mask, r.rngs, lr=VIS_LR, epoch=0)
            sums.append(st.loss_sum_device)
        assert _equal(grouped, single), _max_diff(grouped, single)
        assert st_g.loss_sum_device.equal(torch.stack(sums))
        # bucketed (the fused kernel) against monolithic
        mono, _ = one(idx[0], True)
        buck, _ = one(idx[0], True, merge_bucket_mb=VIS_BUCKET_MB)
        diff = _max_diff(buck, mono)
        assert diff <= TOL["bf16"], diff
    finally:
        torch.backends.cudnn.deterministic = False
    log(card, f"vision rounds (ResNet-18, W={W}, K={VIS_K}, B={VIS_B}, "
        f"bf16): index-fed == host-staged bit for bit with "
        f"cudnn.deterministic: {out[True][0]} (max|diff| {out[True][1]:.3g}); "
        f"without it: {out[False][0]} (max|diff| {out[False][1]:.3g}, loss "
        f"sums equal {out[False][2]}); R=2 grouped index-fed == two single "
        f"rounds bit for bit (deterministic); bucketed ({VIS_BUCKET_MB:g} "
        f"MB, the fused kernel) vs monolithic max|diff| {diff:.3g} (bound "
        f"{TOL['bf16']:g}, {'equal' if diff == 0 else 'not equal'} bit for "
        f"bit)")


def vision_check(torch, card, seed):
    """One f32 round of a narrow ResNet (stages (1, 1), width 16, 32x32)
    and one of LeNet (28x28) on the card and on the CPU, from the same
    state and inputs: merged parameters and running statistics within
    VIS_CPU_BOUND, counts equal."""
    rng = np.random.default_rng(seed + 15)
    W, K, B = 2, 2, 16
    for name, shape, kw in (("resnet (1, 1) width 16", (32, 32, 3),
                             dict(stages=(1, 1), width=16)),
                            ("lenet", (28, 28), dict(lenet=True))):
        y = rng.integers(0, 10, (W, K, B)).astype(np.int32)
        x = rng.standard_normal((W, K, B) + shape).astype(np.float32)
        args = ({"x": x, "y": y}, np.ones((W, K, B), np.float32),
                np.ones((W, K), np.float32), np.ones(W, np.float32),
                rng.integers(0, 2 ** 32, (W, K, 2), dtype=np.uint32))
        out = {}
        for dev in ("cuda", "cpu"):
            engine, state = vision_engine(torch, dev, torch.float32,
                                          seed=seed, **kw)
            out[dev] = engine.train_round(state, *args, lr=VIS_LR, epoch=0)
        (cs, cst), (ps, pst) = out["cuda"], out["cpu"]
        np.testing.assert_allclose(cst.loss_sum, pst.loss_sum, rtol=1e-5)
        assert cst.contributors == pst.contributors == W
        diff = _max_diff(cs, ps)
        stats = [k for k in ps if "running_" in k]
        sdiff = _max_diff({k: cs[k] for k in stats},
                          {k: ps[k] for k in stats}) if stats else 0.0
        assert diff <= VIS_CPU_BOUND, (name, diff)
        log(card, f"vision {name} f32 round, card vs CPU: loss sums "
            f"{cst.loss_sum.tolist()} vs {pst.loss_sum.tolist()}, max|diff| "
            f"{diff:.3g} over parameters and running statistics (running "
            f"statistics alone {sdiff:.3g}; bound {VIS_CPU_BOUND:g})")


def vision_trace(torch, card, seed):
    """Where a ResNet-18 round's time goes: one round (W=VIS_N, K=VIS_K,
    B=VIS_B, bf16, bucketed merge) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed + 16)
    W, K, B = VIS_N, VIS_K, VIS_B
    x, y = cifar_arrays(rng, W * K * B)
    batch = {"x": (x.astype(np.float32) / 255.0).reshape(
        W, K, B, CIFAR_HW, CIFAR_HW, 3), "y": y.reshape(W, K, B)}
    args = (batch, np.ones((W, K, B), np.float32), np.ones((W, K),
            np.float32), np.ones(W, np.float32),
            rng.integers(0, 2 ** 32, (W, K, 2), dtype=np.uint32))
    engine, state = vision_engine(torch, "cuda", torch.bfloat16, seed=seed,
                                  merge_bucket_mb=VIS_BUCKET_MB)
    state, _ = engine.train_round(state, *args, lr=VIS_LR, epoch=0)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_round(state, *args, lr=VIS_LR, epoch=0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = device_events(torch, prof)
    if not by_name:
        log(card, "vision trace: device time not measured (the profiler "
            "recorded no CUDA activity)")
        return
    busy = sum(t for t, _ in by_name.values())
    calls = sum(n for _, n in by_name.values())
    steps = W * K
    merge = sum(t for name, (t, _) in by_name.items() if "fused_merge" in name)
    conv = sum(t for name, (t, _) in by_name.items()
               if any(s in name.lower() for s in ("conv", "wgrad", "dgrad",
                                                   "xmma", "implicit")))
    log(card, f"trace resnet18 train round (profiled, {steps} local steps "
        f"of B={B}): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.2f}%), idle "
        f"{100 * (1 - busy / wall_ms):.2f}%; {calls} device activities "
        f"({calls / steps:.1f} per local step); convolution kernels "
        f"{conv:.3f} ms ({100 * conv / busy:.2f}%), the fused merge "
        f"{merge:.3f} ms ({100 * merge / busy:.2f}%)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (t, n) in top:
        log(card, f"vision trace top device time: {t:.3f} ms over {n} "
            f"calls: {name[:90]}")


def resnet18_merge_row(torch, card, seed, launches):
    """The fused merge at ResNet-18's plan: every bucket timed like phase
    9a (CUDA-graph replay, the L2 warm and cold), the plain version, and
    the bytes bound of the whole merge; with its launches per epoch of
    phase 11's job."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    lengths = [b.length for b in resnet18_plan().buckets]
    raw_t = torch.tensor(3.0, device=dev)
    cnt = raw_t.clamp_min(1.0)
    ms = cold_ms = plain_ms = 0.0
    for n in lengths:
        s = torch.randn(n, device=dev, generator=gen)
        ref = torch.randn(n, device=dev, generator=gen)
        got = fm.fused_merge_kernel("avg", s, ref, cnt, raw_t)
        assert torch.equal(got, fm._apply_plain("avg", s, ref, cnt, raw_t,
                                                0.0)), n
        ms += time_ms(torch, lambda: fm.fused_merge_kernel(
            "avg", s, ref, cnt, raw_t))
        plain_ms += time_ms(torch, lambda: fm._apply_plain(
            "avg", s, ref, cnt, raw_t, 0.0))
        sets = [(torch.randn(n, device=dev, generator=gen),
                 torch.randn(n, device=dev, generator=gen))
                for _ in range(max(2, -(-int(COLD_BYTES) // (8 * n))))]
        cold_ms += time_ms_cold(torch, lambda a, b: fm.fused_merge_kernel(
            "avg", a, b, cnt, raw_t), sets)
        del sets
    row = dict(buckets=len(lengths), elements=sum(lengths),
               launches_per_epoch=launches, ms=ms, cold_ms=cold_ms,
               plain_ms=plain_ms, bound_ms=merge_bound(sum(lengths)),
               max_abs_err=0.0)
    log(card, f"fused_merge at ResNet-18's {VIS_BUCKET_MB:g} MB plan: "
        f"{len(lengths)} buckets, {sum(lengths)} f32 elements; whole merge "
        f"kernel {ms:.4f} ms (L2 cold {cold_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {row['bound_ms']:.5f} ms (bytes), "
        f"{cold_ms / row['bound_ms']:.2f}x bound L2-cold; launches per "
        f"epoch {launches}; kernel == plain bit for bit")
    return row


# ----------------------------------------------------------------- phase 12
CP_RESNET_FN, CP_GPT_FN = "resnet18-cifar", "gpt-mini-tokens"
CP_GPT_EPOCHS = 2
CP_INFER_N = 64
# the user function files the control-plane phase registers: phase 11's
# and phase 10's datasets as KubeDataset classes beside their models
CP_FUNCTIONS = {
    CP_RESNET_FN: '''
import numpy as np
from kubeml_tpu_torch.models.base import KubeDataset
from kubeml_tpu_torch.models.resnet import ResNet18


class Cifar(KubeDataset):
    def transform_train(self, data, labels):
        return {"x": np.asarray(data).astype(np.float32) / 255.0,
                "y": np.asarray(labels)}

    transform_test = transform_train

    @staticmethod
    def transform_train_device(x, y):
        return {"x": x.float() / 255.0, "y": y}


class CifarResNet18(ResNet18):
    """ResNet-18 over u8 CIFAR-shaped images."""
''',
    CP_GPT_FN: '''
import numpy as np
from kubeml_tpu_torch.models.base import KubeDataset
from kubeml_tpu_torch.models.gpt import GPTMini


class TokenWindows(KubeDataset):
    def transform_train(self, data, labels):
        return {"x": np.asarray(data).astype(np.int32)}

    transform_test = transform_train


class TokensGPTMini(GPTMini):
    """gpt-mini over label-free token windows."""
''',
}


def cp_request(fn, dataset, epochs, batch, lr, **opts):
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    return TrainRequest(model_type="resnet18" if fn == CP_RESNET_FN
                        else "gpt-mini", function_name=fn,
                        batch_size=batch, epochs=epochs, dataset=dataset,
                        lr=lr, options=TrainOptions(train_stats=False,
                                                    **opts))


def cp_wait(client, dep, job_id, timeout=900.0):
    """The job's history, polled through the controller twice a second
    (as a user would) until it is written; a job that finishes without
    one (it failed) fails the phase with its error."""
    from kubeml_tpu_torch.api.errors import KubeMLException

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            hist = client.histories().get(job_id)
            assert dep.ps.wait_for_job(job_id, timeout=120), job_id
            return hist
        except KubeMLException as e:
            if e.status_code != 404:
                raise
        with dep.ps._jobs_lock:
            running = job_id in dep.ps.jobs
        if not running and job_id in dep.ps.errors:
            raise RuntimeError(f"job {job_id} failed inside the deployment: "
                               f"{dep.ps.errors[job_id]}")
        time.sleep(0.5)
    raise TimeoutError(f"job {job_id}: no history within {timeout} s")


def first_dispatch_probe():
    """Wrap the engine's round entry points to stamp the first call of
    any job in this process; returns (stamps, restore)."""
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    names = ("train_round", "train_rounds", "train_round_indexed",
             "train_rounds_indexed")
    orig = {n: getattr(KAvgEngine, n) for n in names}
    stamps = []

    def wrap(fn):
        def call(self, *a, **k):
            if not stamps:
                stamps.append(time.perf_counter())
            return fn(self, *a, **k)
        return call

    for n in names:
        setattr(KAvgEngine, n, wrap(orig[n]))

    def restore():
        for n in names:
            setattr(KAvgEngine, n, orig[n])
    return stamps, restore


def on_publish(ps, hook):
    """Run hook(m) after the PS applies each threaded job's MetricUpdate
    (the job thread's own callback, so it sees the epoch's end), for the
    jobs started until the returned restore() is called."""
    real = ps._publish_metrics

    def publish(m):
        real(m)
        hook(m)
    ps._publish_metrics = publish

    def restore():
        ps._publish_metrics = real
    return restore


def equal_checkpoints(a, b) -> bool:
    from kubeml_tpu_torch.train.checkpoint import _flatten, load_checkpoint

    fa, fb = (_flatten(load_checkpoint(j)[0]) for j in (a, b))
    return fa.keys() == fb.keys() and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


def phase_control(torch, card, seed):
    """The training control plane on the card (see the module docstring,
    phase 12); returns the fused merge's ResNet-18 launches and the
    per-epoch launches of the gpt-mini job, both through the deployment."""
    import os
    import tempfile

    home = os.environ.get("KUBEML_TPU_HOME")
    det = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "home")
        torch.backends.cudnn.deterministic = True
        try:
            return control_run(torch, card, seed, tmp)
        finally:
            torch.backends.cudnn.deterministic = det
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home


def control_run(torch, card, seed, tmp):
    import os

    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment

    for name, src in CP_FUNCTIONS.items():
        with open(os.path.join(tmp, f"{name}.py"), "w") as f:
            f.write(src)
    dep = start_deployment(device=None)
    try:
        client = KubemlClient(dep.controller_url).v1()
        for name in CP_FUNCTIONS:
            client.functions().create(name, os.path.join(tmp, f"{name}.py"))
        resnet_launches, job_id, row = control_resnet(torch, card, seed,
                                                      tmp, dep, client)
        control_infer(torch, card, dep, client, job_id)
        gpt_launches = control_gpt(torch, card, seed, tmp, dep, client)
        threaded = control_gpt_static(card, dep, client, "threaded")
    finally:
        dep.stop()
    dep = start_deployment(device=None, standalone_jobs=True)
    try:
        client = KubemlClient(dep.controller_url).v1()
        standalone = control_gpt_static(card, dep, client, "standalone")
    finally:
        dep.stop()
    (hist_t, id_t), (hist_s, id_s) = threaded, standalone
    a, b = hist_t.data.to_dict(), hist_s.data.to_dict()
    a.pop("epoch_duration"), b.pop("epoch_duration")
    assert a == b, (a, b)
    assert equal_checkpoints(id_t, id_s), "standalone weights differ"
    log(card, f"control standalone: the gpt-mini job in a jobserver child "
        f"on the card equals the threaded job bit for bit (history without "
        f"its epoch durations, and every checkpoint leaf); train loss "
        f"{hist_s.data.train_loss[0]:.6f}; epoch "
        f"{hist_s.data.epoch_duration[0]:.4f} s in the child vs "
        f"{hist_t.data.epoch_duration[0]:.4f} s threaded")
    print(json.dumps({"control": dict(row, gpt_launches=gpt_launches)}),
          flush=True)
    return resnet_launches, gpt_launches


def control_resnet(torch, card, seed, tmp, dep, client):
    """(a): phase 11's dataset uploaded as four .npy files, resnet18
    submitted through the controller, against a direct TrainJob."""
    import os
    import urllib.request

    from kubeml_tpu_torch.data.sharding import plan_epoch
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.ops import fused_merge as fm
    from kubeml_tpu_torch.train.job import TrainJob

    rng = np.random.default_rng(seed + 14)        # phase 11's images
    paths = []
    for split, n in (("train", CIFAR_TRAIN), ("test", CIFAR_TEST)):
        x, y = cifar_arrays(rng, n)
        for which, arr in (("x", x), ("y", y)):
            p = os.path.join(tmp, f"{which}_{split}.npy")
            np.save(p, arr)
            paths.append(p)
    xtr, ytr, xte, yte = paths
    mb = sum(os.path.getsize(p) for p in paths) / 2**20
    t0 = time.perf_counter()
    summary = client.datasets().create("cifar", xtr, ytr, xte, yte)
    up = time.perf_counter() - t0
    assert (summary.train_set_size, summary.test_set_size) == \
        (CIFAR_TRAIN, CIFAR_TEST), summary
    log(card, f"control upload: {CIFAR_TRAIN} + {CIFAR_TEST} u8 images as "
        f"four .npy files ({mb:.1f} MiB) through client -> controller -> "
        f"storage in {up:.3f} s = {mb / up:.1f} MiB/s")

    plan = plan_epoch(CIFAR_TRAIN, VIS_N, VIS_K, VIS_B)
    steps, rounds = plan.total_steps, len(plan.rounds)
    buckets = resnet18_plan().n_buckets
    scraped = []

    def scrape(m):
        text = urllib.request.urlopen(dep.ps.url + "/metrics").read().decode()
        scraped.append(f'kubeml_job_train_loss{{jobid="{m.job_id}"}}' in text)
    unhook = on_publish(dep.ps, scrape)
    req = cp_request(CP_RESNET_FN, "cifar", 1, VIS_B, VIS_LR, k=VIS_K,
                     default_parallelism=VIS_N, static_parallelism=True,
                     merge_bucket_mb=VIS_BUCKET_MB, device_cache="auto")
    stamps, restore = first_dispatch_probe()
    try:
        fm.fused_merge_kernel.launches = 0      # the main path's run starts
        t0 = time.perf_counter()
        job_id = client.networks().train(req)
        hist = cp_wait(client, dep, job_id)
        wall = time.perf_counter() - t0
        launches = fm.fused_merge_kernel.launches
    finally:
        restore()
        unhook()
    assert launches == buckets * rounds, (launches, buckets, rounds)
    text = urllib.request.urlopen(dep.ps.url + "/metrics").read().decode()
    cleared = f'jobid="{job_id}"' not in text
    assert scraped == [True] and cleared, (scraped, cleared)
    sec = hist.data.epoch_duration[0]
    log(card, f"control resnet18 through the deployment (job {job_id}): "
        f"POST /train -> first dispatch {stamps[0] - t0:.3f} s (queue, "
        f"PS start, model init, device cache upload); epoch wall {sec:.4f} "
        f"s = {CIFAR_TRAIN / sec:.2f} samples/s, {1e3 * sec / steps:.3f} ms "
        f"per local step; POST /train -> history {wall:.3f} s; train loss "
        f"{hist.data.train_loss[0]:.4f}, accuracy {hist.data.accuracy[0]:.2f} "
        f"%; fused_merge launches {launches} (= {buckets} buckets x "
        f"{rounds} rounds); /metrics showed the job's families at its "
        f"epoch's publish: {scraped[0]}, none after the finish: {cleared}")

    t1 = time.perf_counter()
    direct = TrainJob(vision_task("direct", 1, device_cache="auto"),
                      get_model("resnet18")(), cifar_dataset(),
                      device="cuda").train()
    dwall = time.perf_counter() - t1
    dsec = direct.data.epoch_duration[0]
    assert equal_checkpoints(job_id, "direct"), \
        "the deployment's checkpoint differs from the direct job's"
    assert direct.data.train_loss == hist.data.train_loss
    log(card, f"control resnet18 direct TrainJob, same task and seed: epoch "
        f"wall {dsec:.4f} s = {CIFAR_TRAIN / dsec:.2f} samples/s, "
        f"{1e3 * dsec / steps:.3f} ms per local step (train() {dwall:.3f} "
        f"s); deployment / direct ms per local step = {sec / dsec:.4f}; "
        f"checkpoints equal bit for bit under cudnn.deterministic")
    return launches, job_id, {
        "upload_s": up, "upload_mib": mb, "upload_mib_per_s": mb / up,
        "submit_to_first_dispatch_s": stamps[0] - t0,
        "deployment": {"wall_s": sec, "samples_per_s": CIFAR_TRAIN / sec,
                       "ms_per_step": 1e3 * sec / steps},
        "direct": {"wall_s": dsec, "samples_per_s": CIFAR_TRAIN / dsec,
                   "ms_per_step": 1e3 * dsec / steps},
        "deployment_over_direct": sec / dsec, "launches": launches}


def control_infer(torch, card, dep, client, job_id):
    """(b): 64 test images through POST /infer at the controller against
    the port model's infer on the loaded checkpoint."""
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint
    from kubeml_tpu_torch.train.functionlib import FunctionRegistry

    x, _ = DatasetRegistry().get("cifar").test_arrays()
    data = (np.asarray(x[:CP_INFER_N]).astype(np.float32) / 255.0).tolist()
    t0 = time.perf_counter()
    preds = client.networks().infer(job_id, data)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = client.networks().infer(job_id, data)
    cached = time.perf_counter() - t0
    model = FunctionRegistry().resolve(CP_RESNET_FN)[0]()
    module = model.module_from_flax(load_checkpoint(job_id)[0],
                                    device="cuda")
    module.eval()
    want = model.infer(module, np.asarray(data))
    assert preds == again == want.tolist(), (preds, want)
    log(card, f"control /infer: {CP_INFER_N} test images through the "
        f"controller equal the model's infer on the loaded checkpoint bit "
        f"for bit; round trip {first:.3f} s cold (checkpoint load), "
        f"{cached:.3f} s from the PS's cache; {len(set(preds))} distinct "
        f"classes predicted")


def control_gpt(torch, card, seed, tmp, dep, client):
    """(c): phase 10's dataset, gpt-mini for CP_GPT_EPOCHS epochs under
    the scheduler's throughput policy; per-epoch launches."""
    import os

    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm

    rng = np.random.default_rng(seed + 12)        # phase 10's windows
    arrays = (token_windows(rng, JOB_TRAIN, TRAIN_T),
              np.zeros(JOB_TRAIN, np.int32),
              token_windows(rng, JOB_TEST, TRAIN_T),
              np.zeros(JOB_TEST, np.int32))
    paths = []
    for name, arr in zip(("xtr", "ytr", "xte", "yte"), arrays):
        paths.append(os.path.join(tmp, f"tok_{name}.npy"))
        np.save(paths[-1], arr)
    client.datasets().create("tokens", *paths)
    kernels = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
               "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel}
    epochs = []

    def zero():
        for fn in kernels.values():
            fn.launches = 0

    def count(m):
        epochs.append({k: fn.launches for k, fn in kernels.items()})
        zero()                                  # ... and the next starts
    unhook = on_publish(dep.ps, count)
    req = cp_request(CP_GPT_FN, "tokens", CP_GPT_EPOCHS, JOB_B, JOB_LR,
                     k=JOB_K, default_parallelism=JOB_N0,
                     max_parallelism=JOB_NMAX, static_parallelism=False,
                     merge_bucket_mb=MERGE_CAP_MB)
    zero()                                      # the main path's run starts
    try:
        job_id = client.networks().train(req)
        hist = cp_wait(client, dep, job_id).data
    finally:
        unhook()
    layers = GPT_CONFIGS["gpt-mini"]["layers"]
    assert hist.parallelism == [JOB_N0, JOB_N0 + 1], hist.parallelism
    assert hist.train_loss[-1] < hist.train_loss[0], hist.train_loss
    assert len(epochs) == CP_GPT_EPOCHS, epochs
    for e, counts in enumerate(epochs):
        steps, rounds, evals = _epoch_counts(hist.parallelism[e], JOB_NMAX)
        want = {"forward": layers * (steps + evals), "dK/dV": layers * steps,
                "dQ": layers * steps, "fused_merge": JOB_BUCKETS * rounds}
        assert counts == want, (e, counts, want)
        sec = hist.epoch_duration[e]
        log(card, f"control gpt-mini through the deployment epoch {e + 1}/"
            f"{CP_GPT_EPOCHS}: the scheduler granted N="
            f"{hist.parallelism[e]}; train loss {hist.train_loss[e]:.4f}, "
            f"{steps} local steps in {rounds} rounds, wall {sec:.4f} s = "
            f"{steps * JOB_B / sec:.2f} samples/s, {1e3 * sec / steps:.3f} ms "
            f"per local step; launches {counts} (= {layers} layers x {steps} "
            f"steps (+ {evals} eval steps), {JOB_BUCKETS} buckets x {rounds} "
            f"rounds)")
    return epochs


def control_gpt_static(card, dep, client, mode):
    """(d): one epoch of (c)'s task at a static N=2, threaded or in a
    jobserver child; returns (history, job id)."""
    req = cp_request(CP_GPT_FN, "tokens", 1, JOB_B, JOB_LR, k=JOB_K,
                     default_parallelism=JOB_N0, static_parallelism=True,
                     merge_bucket_mb=MERGE_CAP_MB)
    t0 = time.perf_counter()
    job_id = client.networks().train(req)
    ready = ""
    if mode == "standalone":
        # the child is ready once the PS has its URL (spawn, import,
        # CUDA context, port bound, /health answered, /start pushed)
        seen = False
        while time.perf_counter() - t0 < 600:
            with dep.ps._jobs_lock:
                rec = dep.ps.jobs.get(job_id)
            if rec is not None and rec.url is not None:
                ready = (f", POST /train -> child ready "
                         f"{time.perf_counter() - t0:.3f} s")
                break
            if seen and rec is None:
                break
            seen = seen or rec is not None
            time.sleep(0.02)
    hist = cp_wait(client, dep, job_id)
    log(card, f"control gpt-mini {mode} job {job_id}: N={JOB_N0} static"
        f"{ready}, POST /train -> history {time.perf_counter() - t0:.3f} s, "
        f"epoch {hist.data.epoch_duration[0]:.4f} s")
    return hist, job_id


def merge_entry(rows, launches):
    """The kernels-line entry of the fused merge: one whole gpt-mini merge
    (the sum over its five buckets) in avg mode, the sgd check under it."""
    def total(mode, key):
        return sum(rows[n][mode][key] for n in MERGE_BUCKETS)

    return {
        "name": "fused_merge (avg)",
        "route": "cuda",
        "source": "kubeml_tpu_torch/ops/csrc/fused_merge.cu",
        "replaces": "kubeml_tpu/ops/pallas/fused_merge.py:51",
        "launches": launches["ef_int8"],
        "launches_by_strategy": launches,
        "shape": (f"gpt-mini's {len(MERGE_BUCKETS)} buckets at "
                  f"{MERGE_CAP_MB:g} MB, {sum(MERGE_BUCKETS)} f32 elements "
                  "(one whole merge; times summed over the buckets)"),
        "max_abs_err": 0.0,
        "ms": total("avg", "ms"),
        "cold_ms": total("avg", "cold_ms"),
        "plain_ms": total("avg", "plain_ms"),
        "bound_ms": total("avg", "bound_ms"),
        "bound_by": "bytes",
        "library_ms": None,
        "buckets": [{"n": n, **rows[n]["avg"]} for n in MERGE_BUCKETS],
        "ragged": [{"n": n, **rows[n]["avg"]} for n in MERGE_RAGGED],
        "sgd": {"max_abs_err": 0.0, "ms": total("sgd", "ms"),
                "cold_ms": total("sgd", "cold_ms"),
                "plain_ms": total("sgd", "plain_ms"),
                "bound_ms": total("sgd", "bound_ms")},
    }


def start(torch, sources=None) -> str:
    """f32 products stay f32; then phase 1: every kernel source (or the
    named ones), one nvcc each, all started together, logging the build
    time and ptxas's register, shared-memory and spill lines. Returns the
    card line."""
    from kubeml_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    logs = _build.build(sources)
    log(card, f"build: {len(logs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(card, f"ptxas {name}: {line.strip()}")
    return card


def run(torch, seed) -> list:
    card = start(torch)
    rows = phase_kernels(torch, card, seed)

    module = build_gpt(torch, "gpt-mini", seed, torch.bfloat16, "cuda")
    # the main paths: one batch served with bf16 KV pages ("f32" keeps the
    # module's dtype), one with int8 pages; each launches its own
    # instantiation of the kernel and is counted on its own
    launches = {pages: phase_serve(torch, card, seed, module, kv)
                for pages, kv in (("bf16", "f32"), ("int8", "int8"))}

    phase_check(torch, card, seed)
    phase_trace(torch, card, seed, module)

    flash = phase_flash(torch, card, seed)
    train_launches, engine_ms = phase_train(torch, card, seed)
    phase_train_check(torch, card, seed)
    phase_train_trace(torch, card, seed)

    merge_rows = phase_merge_kernel(torch, card, seed)
    merge_launches, engines = phase_merge_train(torch, card, seed)
    phase_merge_check(torch, card, seed)
    phase_merge_trace(torch, card, seed, engines)
    del engines
    job_launches = phase_job(torch, card, seed, engine_ms)
    vision_launches = phase_vision(torch, card, seed)
    vision_merge = resnet18_merge_row(torch, card, seed, vision_launches)
    cp_resnet, cp_gpt = phase_control(torch, card, seed)

    paged = [{
        "name": f"paged_attention ({pages} pages)",
        "route": "cuda",
        "source": "kubeml_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "kubeml_tpu/ops/pallas/paged_attention.py:73",
        "launches": n,
        "shape": f"decode S=8 T=1 H={H} D={D} G={G} Pmax={PMAX}",
        **rows[(pages, 8, 1)],
        "prefill": {"shape": f"S=1 T=16 context {PREFILL_CTX}",
                    **rows[(pages, 1, 16)]},
    } for pages, n in launches.items()]
    main = FA_CASES[0]
    return paged + [{
        "name": f"flash_attention {kernel} (bf16)",
        "route": "cuda",
        "source": "kubeml_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": f"kubeml_tpu/ops/pallas/flash_attention.py:{line}",
        "launches": train_launches[kernel],
        "job_launches": [e[kernel] for e in job_launches],
        "deployment_launches": [e[kernel] for e in cp_gpt],
        "shape": f"B={FA_B} T={main[2]} H={FA_H} D={FA_D} causal",
        **flash[(main[0], kernel)],
    } for kernel, line in (("forward", 80), ("dK/dV", 228), ("dQ", 281))] \
        + [dict(merge_entry(merge_rows, merge_launches),
                job_launches=[e["fused_merge"] for e in job_launches],
                deployment_launches={
                    "gpt-mini": [e["fused_merge"] for e in cp_gpt],
                    "resnet18": cp_resnet},
                resnet18=vision_merge)], card


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    ap.add_argument("--paged-only", action="store_true",
                    help="build the kernels and run phase 2 alone, then "
                         "print its rows as one JSON line and no result "
                         "line (the paged twin of --flash-only)")
    ap.add_argument("--flash-only", action="store_true",
                    help="build the kernels and run phase 6 alone, then "
                         "print its rows as one JSON line and no result "
                         "line (to compare two trees' flash kernels in one "
                         "session: copy this script into each tree and run "
                         "it there)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    try:
        import kubeml_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the kubeml_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 1
    try:
        if args.paged_only:
            card = start(torch, ["paged_attention"])
            rows = phase_kernels(torch, card, args.seed)
            print(json.dumps({"card": card, "paged": [
                {"pages": p, "S": S, "T": T, **r}
                for (p, S, T), r in rows.items()]}))
            return 0
        if args.flash_only:
            card = start(torch, ["flash_attention"])
            rows = phase_flash(torch, card, args.seed)
            print(json.dumps({"card": card, "flash": [
                {"case": c, "kernel": k, **r} for (c, k), r in rows.items()]}))
            return 0
        kernels, card = run(torch, args.seed)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
