"""kubeml CLI of the PyTorch/CUDA port (twin of kubeml_tpu/cli/main.py,
over the port's client).

The same verbs, flags, defaults and printed output as the JAX package's
CLI, itself the reference cobra CLI's surface (ml/pkg/kubeml-cli/):

    kubeml train -f FN -d DS -e N -b N --lr F [--validate-every N]
                 [-p N] [--static] [-K N] [--sparse-avg] [--goal-accuracy F]
                 [--resume-from JOBID] [--checkpoint-every N] ...
    kubeml infer -n JOBID --datafile FILE
    kubeml dataset create|append|delete|list
    kubeml fn create|delete|list
    kubeml task list|stop|prune
    kubeml history get|delete|list|prune
    kubeml logs --id JOBID [-f]
    kubeml trace --id JOBID [-o FILE]
    kubeml health --id JOBID
    kubeml top --id JOBID [--interval S] [--iterations N]
    kubeml cost --id JOBID
    kubeml serve [--role all|controller|scheduler|ps|storage] [--device D]

    python -m kubeml_tpu_torch.cli --controller URL <verb> ...

``--controller`` is global (before the verb) and defaults to
KUBEML_CONTROLLER_URL. ``serve`` starts the control plane on the card;
its port-only ``--device`` defaults to CUDA and, as every entry point of
the port, raises without a card unless it is given ``cpu``.

``serve --coordinator HOST:PORT --num-processes N --process-id R``
(or the ``KUBEML_*`` environment of ``tools/launch_distributed.py``) joins
a process group first; ``--mesh-data D`` runs every job over D lanes.
``train --seq-parallel N [--seq-impl ring|ulysses]``, ``--expert-parallel
E``, ``--tensor-parallel M [--tp-impl gspmd|manual]`` and
``--pipeline-parallel P [--pp-microbatches M]`` reach the job, which
trains over inner groups of M x N x P x E ranks of that group (and
answers the JAX package's 400 where the ranks do not split into them).
``serve --serve-decode-steps K --serve-draft-model ID`` turns on the
multi-step and speculative decode programs. ``dataset append`` commits a
generation of a continual dataset, and ``train --continual`` (``-e 0``
for an unbounded loop, ``--window-generations``,
``--publish-every-rounds``) trains its sliding window. ``serve --role
all`` takes the cluster allocator's ``--cluster-*`` flags and the durable
control plane's ``--control-*`` (a second start on the same
``--control-dir`` recovers); ``--role scheduler`` takes ``--cluster-*``.
A refusal prints ``error: ...`` and exits non-zero, as every failed verb
does.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import numpy as np

from kubeml_tpu_torch.api.const import MAX_BATCH_SIZE, kubeml_home
from kubeml_tpu_torch.api.errors import KubeMLException
from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
from kubeml_tpu_torch.control.client import KubemlClient
from kubeml_tpu_torch.metrics.ledger import attributed_from_snapshot

def _client(args) -> KubemlClient:
    return KubemlClient(args.controller or None)


def _fail(msg: str, code: int = 1):
    print(f"error: {msg}", file=sys.stderr)
    sys.exit(code)


# --------------------------------------------------------------------- train

def cmd_train(args):
    req = train_request(args)
    client = _client(args)
    # pre-validation (cmd/train.go:89-148): dataset + function must exist
    try:
        client.v1().datasets().get(args.dataset)
    except KubeMLException as e:
        _fail(f"dataset {args.dataset!r}: {e.message}")
    try:
        client.v1().functions().get(args.function)
    except KubeMLException as e:
        _fail(f"function {args.function!r}: {e.message}")
    job_id = client.v1().networks().train(req)
    print(job_id)


def train_request(args) -> TrainRequest:
    """The TrainRequest of parsed ``train`` arguments, after the CLI's
    checks and the job's own refusal of unported options (exits 1 on
    either): what ``kubeml train`` submits, and what a program that runs
    a job on every rank of a group builds from the same flags."""
    if args.batch <= 0 or args.batch > MAX_BATCH_SIZE:
        _fail(f"batch size must be in (0, {MAX_BATCH_SIZE}]")
    if args.epochs <= 0 and not args.continual:
        _fail("epochs must be positive (continual jobs may pass "
              "--epochs 0 for an unbounded sliding-window loop)")
    if args.window_generations < 0:
        _fail("--window-generations must be >= 0")
    if args.publish_every_rounds < 0:
        _fail("--publish-every-rounds must be >= 0")
    if (args.window_generations or args.publish_every_rounds) \
            and not args.continual:
        _fail("--window-generations/--publish-every-rounds require "
              "--continual")
    if args.publish_every_rounds and args.engine != "kavg":
        _fail("--publish-every-rounds requires --engine kavg (the "
              "publish save reuses the round-granular checkpoint path)")
    if args.tensor_parallel < 1 or args.seq_parallel < 1 \
            or args.expert_parallel < 1 or args.pipeline_parallel < 1:
        _fail("--tensor-parallel/--seq-parallel/--expert-parallel/"
              "--pipeline-parallel must be >= 1")
    if args.pp_microbatches < 0:
        _fail("--pp-microbatches must be >= 0")
    if args.rounds_per_dispatch < 1:
        _fail("--rounds-per-dispatch must be >= 1")
    if args.merge_bucket_mb < 0:
        _fail("--merge-bucket-mb must be >= 0")
    if args.merge_dtype and args.merge_compress != "none":
        _fail("--merge-dtype and --merge-compress are mutually exclusive "
              "(the wire cast has no residual; pick one)")
    if args.fsdp and args.engine != "syncdp":
        _fail("--fsdp requires --engine syncdp")
    if args.pipeline_parallel > 1 and \
            (args.tensor_parallel > 1 or args.seq_parallel > 1):
        _fail("--pipeline-parallel composes with --expert-parallel only")
    if args.max_parallelism < 0:
        _fail("--max-parallelism must be >= 0")
    if args.max_restarts < 0:
        _fail("--max-restarts must be >= 0")
    if args.checkpoint_every_rounds < 0:
        _fail("--checkpoint-every-rounds must be >= 0")
    if args.quarantine_after < 0:
        _fail("--quarantine-after must be >= 0")
    if args.reassign_on_quarantine and args.quarantine_after <= 0:
        _fail("--reassign-on-quarantine requires --quarantine-after")
    if args.tensor_parallel > 1 and args.seq_parallel > 1 \
            and args.seq_impl == "ulysses":
        _fail("tensor parallelism composes with --seq-impl ring only "
              "(ulysses re-shards the head axis the TP split owns)")
    k = -1 if args.sparse_avg else args.K
    options = TrainOptions(
        default_parallelism=args.parallelism,
        static_parallelism=args.static,
        validate_every=args.validate_every, k=k,
        goal_accuracy=args.goal_accuracy,
        checkpoint_every=args.checkpoint_every,
        engine=args.engine,
        shuffle=args.shuffle,
        n_model=args.tensor_parallel,
        n_seq=args.seq_parallel,
        n_expert=args.expert_parallel,
        n_stage=args.pipeline_parallel,
        pp_microbatches=args.pp_microbatches,
        fsdp=args.fsdp,
        rounds_per_dispatch=args.rounds_per_dispatch,
        merge_dtype=args.merge_dtype,
        merge_compress=args.merge_compress,
        merge_bucket_mb=args.merge_bucket_mb,
        seq_impl=args.seq_impl,
        tp_impl=args.tp_impl,
        max_parallelism=args.max_parallelism,
        max_restarts=args.max_restarts,
        checkpoint_every_rounds=args.checkpoint_every_rounds,
        quarantine_after=args.quarantine_after,
        reassign_on_quarantine=args.reassign_on_quarantine,
        continual=args.continual,
        window_generations=args.window_generations,
        publish_every_rounds=args.publish_every_rounds)
    return TrainRequest(
        model_type=args.function, batch_size=args.batch, epochs=args.epochs,
        dataset=args.dataset, lr=args.lr, function_name=args.function,
        resume_from=args.resume_from,
        priority=args.priority, tenant=args.tenant, options=options)


def cmd_infer(args):
    ext = os.path.splitext(args.datafile)[1].lower()
    if ext == ".npy":
        data = np.load(args.datafile).tolist()
    else:
        with open(args.datafile) as f:
            data = json.load(f)
    preds = _client(args).v1().networks().infer(args.network, data)
    print(json.dumps(preds))


# ------------------------------------------------------------------- dataset

def cmd_dataset_create(args):
    s = _client(args).v1().datasets().create(
        args.name, args.traindata, args.trainlabels, args.testdata,
        args.testlabels)
    print(f"created dataset {s.name} "
          f"(train={s.train_set_size}, test={s.test_set_size})")


def cmd_dataset_append(args):
    out = _client(args).v1().datasets().append(
        args.name, args.traindata, args.trainlabels,
        generation=args.generation, retention=args.retention)
    print(f"appended to dataset {args.name} "
          f"(generation={out.get('generation')}, "
          f"train={out.get('train_set_size')})")


def cmd_dataset_delete(args):
    _client(args).v1().datasets().delete(args.name)
    print(f"deleted dataset {args.name}")


def cmd_dataset_list(args):
    rows = _client(args).v1().datasets().list()
    print(f"{'NAME':<20}{'TRAIN':>10}{'TEST':>10}")
    for s in rows:
        print(f"{s.name:<20}{s.train_set_size:>10}{s.test_set_size:>10}")


# ------------------------------------------------------------------ function

def cmd_fn_create(args):
    _client(args).v1().functions().create(args.name, args.code)
    print(f"created function {args.name}")


def cmd_fn_delete(args):
    _client(args).v1().functions().delete(args.name)
    print(f"deleted function {args.name}")


def cmd_fn_list(args):
    print(f"{'NAME':<24}{'KIND':<10}")
    for fn in _client(args).v1().functions().list():
        print(f"{fn['name']:<24}{fn['kind']:<10}")


# ---------------------------------------------------------------------- task

def cmd_task_list(args):
    client = _client(args)
    tasks = client.v1().tasks().list()
    health = client.v1().health()
    print(f"{'ID':<12}{'FUNCTION':<18}{'DATASET':<14}{'STATE':<12}{'N':>4}"
          f"{'RESTARTS':>10}{'PREEMPT':>9}{'HEALTH':>10}{'GRAD':>9}")
    for t in tasks:
        hstate, grad = "-", "-"
        try:
            v = health.get(t.job_id)
            hstate = v.get("state", "-")
            gn = (v.get("latest") or {}).get("grad_norms") or []
            if gn:
                grad = f"{max(float(x) for x in gn):.3g}"
        except KubeMLException:
            pass  # health endpoint down: the rest of the row still prints
        print(f"{t.job_id:<12}{t.parameters.function_name:<18}"
              f"{t.parameters.dataset:<14}{t.state:<12}{t.parallelism:>4}"
              f"{getattr(t, 'restarts', 0):>10}"
              f"{getattr(t, 'preemptions', 0):>9}{hstate:>10}{grad:>9}")


def cmd_task_stop(args):
    _client(args).v1().tasks().stop(args.id)
    print(f"stop requested for {args.id}")


def cmd_task_prune(args):
    # parity: cmd/task.go:63-119 deletes leftover job pods/services; here
    # leftover per-job artifacts are log files of jobs that are neither
    # running nor recorded in history
    logs_dir = os.path.join(kubeml_home(), "logs")
    from kubeml_tpu_torch.train.history import HistoryStore
    keep = {h.id for h in HistoryStore().list()}
    try:
        keep |= {t.job_id for t in _client(args).v1().tasks().list()}
    except KubeMLException:
        pass  # control plane down: history is the only liveness source
    removed = 0
    if os.path.isdir(logs_dir):
        for f in os.listdir(logs_dir):
            if f.endswith(".log") and f[:-4] not in keep:
                os.remove(os.path.join(logs_dir, f))
                removed += 1
    print(f"pruned {removed} orphaned job artifacts")


# ------------------------------------------------------------------- history

def cmd_history_get(args):
    h = _client(args).v1().histories().get(args.id)
    print(json.dumps(h.to_dict(), indent=2))


def cmd_history_delete(args):
    _client(args).v1().histories().delete(args.id)
    print(f"deleted history {args.id}")


def cmd_history_list(args):
    rows = _client(args).v1().histories().list()
    print(f"{'ID':<12}{'FUNCTION':<18}{'DATASET':<14}{'EPOCHS':>7}"
          f"{'BEST_ACC':>10}{'RST/PRE':>9}{'REASSIGN':>10}"
          f"{'GRAD(MAX)':>11}{'UPD(MEAN)':>11}")
    for h in rows:
        accs = [a for a in h.data.accuracy if a == a]
        best = f"{max(accs):.2f}" if accs else "-"
        lifecycle = (f"{getattr(h.data, 'restarts', 0)}"
                     f"/{getattr(h.data, 'preemptions', 0)}")
        reassigned = sum(getattr(h.data, 'reassigned_batches', []) or [])
        # per-epoch [min, mean, max] summaries of the on-device stat
        # lanes (JobHistory.grad_norm_summary / update_ratio_summary):
        # worst grad norm and mean update/param ratio over the run
        gns = [s[2] for s in getattr(h.data, 'grad_norm_summary', [])
               if len(s) == 3 and s[2] > 0]
        urs = [s[1] for s in getattr(h.data, 'update_ratio_summary', [])
               if len(s) == 3 and s[1] > 0]
        grad = f"{max(gns):.3g}" if gns else "-"
        upd = f"{sum(urs) / len(urs):.3g}" if urs else "-"
        print(f"{h.id:<12}{h.task.function_name or h.task.model_type:<18}"
              f"{h.task.dataset:<14}{len(h.data.train_loss):>7}{best:>10}"
              f"{lifecycle:>9}{reassigned:>10}{grad:>11}{upd:>11}")


def cmd_history_prune(args):
    n = _client(args).v1().histories().prune()
    print(f"pruned {n} histories")


# ---------------------------------------------------------------------- logs

def cmd_logs(args):
    path = os.path.join(kubeml_home(), "logs", f"{args.id}.log")
    if not os.path.isfile(path):
        _fail(f"no logs for job {args.id}")
    with open(path) as f:
        print(f.read(), end="")
        if args.follow:
            try:
                while True:
                    line = f.readline()
                    if line:
                        print(line, end="", flush=True)
                    else:
                        time.sleep(0.5)
            except KeyboardInterrupt:
                pass


# --------------------------------------------------------------------- trace

def cmd_trace(args):
    """Fetch a job's merged Chrome trace (client + scheduler + PS + job
    process spans on one trace id). Load the output in Perfetto
    (ui.perfetto.dev) or chrome://tracing."""
    doc = _client(args).v1().traces().get(args.id)
    payload = json.dumps(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        meta = doc.get("metadata", {})
        print(f"wrote {args.out}: {len(doc.get('traceEvents', []))} events "
              f"from {len(meta.get('sources', []))} file(s), trace_id(s) "
              f"{','.join(meta.get('trace_ids', [])) or '-'}")
    else:
        print(payload)


# ---------------------------------------------------------------------- cost

def _fmt_si(n) -> str:
    n = float(n or 0)
    for unit in ("", "K", "M", "G", "T"):
        if abs(n) < 1000 or unit == "T":
            return f"{n:.3g}{unit}"
        n /= 1000
    return f"{n:.3g}T"


def cmd_cost(args):
    """Per-program analytic cost table (GET /cost/{jobId}): the
    deterministic FLOPs / HBM-byte attribution of the cost ledger (the
    port's closed-form records; a JAX deployment's may come from XLA's
    cost analysis), with the roofline arithmetic intensity (flops per
    HBM byte) per program, plus the per-plane amortized cost — per
    sample trained, per token generated."""
    doc = _client(args).v1().cost().get(args.id)
    if args.json:
        print(json.dumps(doc, indent=2))
        return
    progs = doc.get("programs") or {}
    print(f"cost {doc.get('id', '?')}  ({len(progs)} programs)")
    print(f"{'PROGRAM':<26} {'PLANE':<7} {'DISP':>8} {'FLOPS/D':>9} "
          f"{'BYTES/D':>10} {'AI':>7} {'FLOPS_TOT':>10} {'BYTES_TOT':>10} "
          f"SRC")
    for name in sorted(progs):
        e = progs[name]
        fl = float(e.get("flops", 0) or 0)
        hb = float(e.get("hbm_bytes", 0) or 0)
        # roofline arithmetic intensity: flops per HBM byte moved —
        # low AI programs (decode) are bandwidth-bound, high AI
        # programs (train matmuls) are compute-bound
        ai = f"{fl / hb:.2f}" if hb else "-"
        print(f"{name:<26} {e.get('plane', '?'):<7} "
              f"{e.get('dispatches', 0):>8} {_fmt_si(fl):>9} "
              f"{_fmt_bytes(hb):>10} {ai:>7} "
              f"{_fmt_si(e.get('flops_total', 0)):>10} "
              f"{_fmt_bytes(e.get('hbm_bytes_total', 0)):>10} "
              f"{e.get('source', '?')}")
    att = doc.get("attributed") or {}
    tr = att.get("train") or {}
    if tr.get("samples"):
        print(f"train: {_fmt_si(tr.get('flops_per_sample'))} flops/sample  "
              f"{_fmt_bytes(tr.get('bytes_per_sample'))}/sample  "
              f"({tr['samples']:g} samples, {tr['dispatches']:g} dispatches)")
    sv = att.get("serve") or {}
    if sv.get("tokens"):
        print(f"serve: {_fmt_si(sv.get('flops_per_token'))} flops/token  "
              f"{_fmt_bytes(sv.get('bytes_per_token'))}/token  "
              f"({sv['tokens']:g} tokens, {sv['dispatches']:g} dispatches)")


# -------------------------------------------------------------------- health

def cmd_health(args):
    """One-shot machine-readable training-health verdict for a job
    (the same document `kubeml top` renders, GET /health/{jobId})."""
    print(json.dumps(_client(args).v1().health().get(args.id), indent=2))


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _render_top(doc: dict) -> str:
    """Render one health verdict as the `kubeml top` screen: job state
    + reasons, the per-worker stat table, and the runtime gauges."""
    latest = doc.get("latest") or {}
    lines = [f"job {doc.get('id', '?')}  state={doc.get('state', '?')}  "
             f"N={latest.get('parallelism', '-')}  "
             f"loss={latest.get('train_loss', float('nan')):.4f}  "
             f"epoch_s={latest.get('epoch_duration', 0.0):.2f}"]
    for r in doc.get("reasons", []):
        lines.append(f"  [{r.get('severity', '?'):>8}] "
                     f"{r.get('rule', '?')}: {r.get('detail', '')}")
    if latest.get("serve_slot_cap") is not None:
        # serving pane: the serve:<model> pseudo job publishes slot /
        # queue / KV occupancy and the recent-window TTFT percentiles
        def _ms(x):
            return f"{float(x) * 1000:.0f}ms" if x is not None else "-"
        lines.append(
            f"serve: slots {latest.get('serve_active_slots', 0):g}"
            f"/{latest.get('serve_slot_cap', 0):g}  "
            f"queue {latest.get('serve_queue_depth', 0):g}"
            f"/{latest.get('serve_queue_cap', 0):g}  "
            f"kv pages {float(latest.get('serve_kv_page_utilization', 0.0)):.0%}  "
            f"ttft p50/p99 {_ms(latest.get('serve_ttft_p50'))}"
            f"/{_ms(latest.get('serve_ttft_p99'))}  "
            f"shed {latest.get('serve_rejected_total', 0):g}  "
            f"prefill backlog "
            f"{latest.get('serve_prefill_backlog_tokens', 0):g}  "
            f"prefix hit {latest.get('serve_prefix_hit_pct', 0):g}%")
        if latest.get("serve_ttft_queue_s") is not None:
            # TTFT attribution (recent-window means): where the first
            # token's latency went — admission queueing, prefill
            # compute, or interleave delay behind co-resident decode
            lines.append(
                f"ttft breakdown: queue "
                f"{_ms(latest.get('serve_ttft_queue_s'))}  prefill "
                f"{_ms(latest.get('serve_ttft_prefill_s'))}  interleave "
                f"{_ms(latest.get('serve_ttft_interleave_s'))}")
        if latest.get("serve_kv_bytes_per_token") is not None:
            # decode bandwidth pane: the deterministic per-token KV
            # traffic proxy (page geometry x storage dtype, no timers)
            # and which storage mode produced it
            lines.append(
                f"decode bw: "
                f"{latest.get('serve_kv_bytes_per_token', 0):g} B/token  "
                f"kv dtype {latest.get('serve_kv_dtype', 'f32')}")
        if latest.get("serve_dispatches_per_token") is not None:
            # decode amortization pane: dispatches per emitted token
            # (1.0 = one program launch per token; <1.0 means multi-step
            # or speculative decode is amortizing launches) plus the
            # speculative accept rate when a verify program is live
            amort = (f"decode amortization: "
                     f"{latest.get('serve_dispatches_per_token', 0):g} "
                     f"dispatches/token")
            if latest.get("serve_accepted_per_dispatch"):
                amort += (f"  accepted "
                          f"{latest.get('serve_accepted_per_dispatch', 0):g}"
                          f"/verify")
            lines.append(amort)
        if latest.get("serve_engine_restarts") is not None:
            # fault pane: supervisor restarts, quarantined poisoners,
            # deadline expiries — all zero on a healthy replica
            lines.append(
                f"serve faults: restarts "
                f"{latest.get('serve_engine_restarts', 0):g}  poisoned "
                f"{latest.get('serve_poisoned_total', 0):g}  deadline "
                f"{latest.get('serve_deadline_total', 0):g}")
        if latest.get("fleet_replicas") is not None:
            # fleet pane: replica count against the autoscaler bounds,
            # the router's spill/retry activity, and the lifetime
            # scale-event counters (cold starts include scale-from-zero)
            lines.append(
                f"fleet: replicas {latest.get('fleet_replicas', 0):g} "
                f"[{latest.get('fleet_replicas_min', 0):g}"
                f"..{latest.get('fleet_replicas_max', 0):g}]  "
                f"draining {latest.get('fleet_draining', 0):g}  "
                f"spills {latest.get('fleet_spills_total', 0):g}  "
                f"retries {latest.get('fleet_router_retries_total', 0):g}  "
                f"cold starts {latest.get('fleet_cold_starts_total', 0):g}  "
                f"grow/shrink/zero "
                f"{latest.get('fleet_grows_total', 0):g}/"
                f"{latest.get('fleet_shrinks_total', 0):g}/"
                f"{latest.get('fleet_scale_to_zero_total', 0):g}")
        if latest.get("serve_slo_attainment") is not None:
            # SLO pane: windowed attainment against the configured
            # target plus the fast/slow burn rates (>1.0 in both
            # windows means the error budget is being spent too fast)
            lines.append(
                f"slo: attainment "
                f"{float(latest.get('serve_slo_attainment', 1.0)):.1%}"
                f" (target "
                f"{float(latest.get('serve_slo_target', 0.0)):.0%})  "
                f"burn fast "
                f"{float(latest.get('serve_slo_burn_fast', 0.0)):.2f} "
                f"slow "
                f"{float(latest.get('serve_slo_burn_slow', 0.0)):.2f}  "
                f"good/bad "
                f"{latest.get('serve_slo_good_total', 0):g}/"
                f"{latest.get('serve_slo_bad_total', 0):g}")
        if latest.get("fleet_ejections_total") is not None:
            # fleet fault pane: supervisor ejections / stream failover
            # activity plus the circuit-breaker state (replicas in
            # probation earning their vnodes back via probes)
            lines.append(
                f"fleet faults: ejections "
                f"{latest.get('fleet_ejections_total', 0):g}  failovers "
                f"{latest.get('fleet_failovers_total', 0):g}  migrated "
                f"{latest.get('fleet_migrated_streams_total', 0):g}  "
                f"probes {latest.get('fleet_probes_total', 0):g}  hedges "
                f"{latest.get('fleet_hedges_total', 0):g}  probation "
                f"{latest.get('fleet_probation', 0):g}")
    if latest.get("data_lag_generations") is not None \
            and float(latest.get("data_lag_generations", -1)) >= 0:
        # continual pane: dataset freshness — the generation the job last
        # trained vs how far the registry has moved past it; the serve
        # plane's live weight generation rides along when published
        lag = float(latest.get("data_lag_generations", 0))
        line = (f"continual: trained gen "
                f"{latest.get('dataset_generation', 0):g}  "
                f"registry lag {lag:g} gen{'s' if lag != 1 else ''}")
        if latest.get("serve_weight_generation") is not None:
            line += (f"  served gen "
                     f"{latest.get('serve_weight_generation', 0):g}")
        lines.append(line)
    if latest.get("cluster_pool_lanes") is not None:
        # cluster pane: the `cluster` pseudo job publishes the allocator
        # snapshot — pool utilization, per-tenant share vs quota, queue
        # depth by priority, and the lifetime preemption count
        pool = float(latest.get("cluster_pool_lanes", 0) or 0)
        used = float(latest.get("cluster_lanes_in_use", 0) or 0)
        util = used / pool if pool else 0.0
        lines.append(
            f"cluster: lanes {used:g}/{pool:g} ({util:.0%})  "
            f"running {latest.get('cluster_running_jobs', 0):g}  "
            f"queued {latest.get('cluster_queue_depth', 0):g}  "
            f"oldest wait {float(latest.get('cluster_oldest_wait_s', 0.0)):.1f}s  "
            f"preemptions {latest.get('cluster_preemptions_total', 0):g}")
        by_prio = latest.get("cluster_queue_by_priority") or {}
        if by_prio:
            depths = "  ".join(
                f"p{p}:{by_prio[p]:g}"
                for p in sorted(by_prio, key=lambda x: -int(x)))
            lines.append(f"  queue by priority: {depths}")
        tenant_lanes = latest.get("cluster_tenant_lanes") or {}
        quotas = latest.get("cluster_tenant_quota") or {}
        for tname in sorted(tenant_lanes):
            share = float(tenant_lanes[tname]) / pool if pool else 0.0
            quota = quotas.get(tname)
            lines.append(
                f"  tenant {tname:<12} lanes {tenant_lanes[tname]:g}"
                f"/{quota if quota is not None else pool:g} "
                f"share {share:.0%}")
        # control pane: durable-control-plane counters ride the same
        # snapshot once the allocator journals (zero records = the
        # durability layer is off, keep the pane quiet)
        if float(latest.get("cluster_journal_records_total", 0) or 0) > 0 \
                or float(latest.get("cluster_recoveries_total", 0) or 0) > 0:
            lines.append(
                f"control: epoch "
                f"{latest.get('cluster_fencing_epoch', 0):g}  "
                f"recoveries "
                f"{latest.get('cluster_recoveries_total', 0):g}  journal "
                f"{latest.get('cluster_journal_records_total', 0):g} rec/"
                f"{latest.get('cluster_journal_compactions_total', 0):g} "
                f"compactions  torn "
                f"{latest.get('cluster_journal_torn_drops_total', 0):g}  "
                f"fence rejects "
                f"{latest.get('cluster_fencing_rejections_total', 0):g}")
    # cost pane: amortized analytic cost from the ledger snapshot that
    # rode the latest sample — what one trained sample / one generated
    # token costs in FLOPs and HBM traffic (kubeml cost has the full
    # per-program roofline table)
    cost_progs = dict(latest.get("cost_programs") or {})
    cost_progs.update(latest.get("serve_cost_programs") or {})
    if cost_progs:
        att = attributed_from_snapshot(cost_progs)
        parts = []
        tr = att.get("train") or {}
        if tr.get("samples"):
            parts.append(
                f"train {_fmt_si(tr.get('flops_per_sample'))} flops/sample "
                f"{_fmt_bytes(tr.get('bytes_per_sample'))}/sample")
        sv = att.get("serve") or {}
        if sv.get("tokens"):
            parts.append(
                f"serve {_fmt_si(sv.get('flops_per_token'))} flops/tok "
                f"{_fmt_bytes(sv.get('bytes_per_token'))}/tok")
        if parts:
            lines.append("cost: " + " · ".join(parts))
    worker_losses = latest.get("worker_losses") or []
    grad_norms = latest.get("grad_norms") or []
    update_ratios = latest.get("update_ratios") or []
    phases = latest.get("phase_times") or {}
    dispatch = [float(t) for t in phases.get("dispatch", [])]
    if worker_losses or grad_norms:
        lines.append(f"{'WORKER':<8}{'LOSS':>12}{'GRAD_NORM':>12}"
                     f"{'UPD_RATIO':>12}")
        n = max(len(worker_losses), len(grad_norms), len(update_ratios))
        for w in range(n):
            def cell(xs, fmt):
                return fmt.format(xs[w]) if w < len(xs) else "-"
            lines.append(f"{w:<8}"
                         f"{cell(worker_losses, '{:.4f}'):>12}"
                         f"{cell(grad_norms, '{:.3g}'):>12}"
                         f"{cell(update_ratios, '{:.3g}'):>12}")
    if latest.get("loss_spread"):
        lines.append(f"loss spread: {float(latest['loss_spread']):.4g}")
    if dispatch:
        lines.append(
            f"dispatch: n={len(dispatch)} "
            f"mean={sum(dispatch) / len(dispatch):.3f}s "
            f"max={max(dispatch):.3f}s")
    # merge split: merge_wait is blocking drain time, merge_overlap is
    # host bookkeeping hidden behind device execution (merge.py levers);
    # device_drain is the pre-split name for the blocking portion
    wait = [float(t) for t in (phases.get("merge_wait", [])
                               or phases.get("device_drain", []))]
    overlap = [float(t) for t in phases.get("merge_overlap", [])]
    if wait or overlap:
        lines.append(
            f"merge: wait={sum(wait):.3f}s/{len(wait)} "
            f"overlap={sum(overlap):.3f}s/{len(overlap)}")
    lines.append(
        f"hbm: peak={_fmt_bytes(latest.get('hbm_peak_bytes'))} "
        f"in_use={_fmt_bytes(latest.get('hbm_in_use_bytes'))}   "
        f"jit compiles: {latest.get('jit_compiles', 0)}   "
        f"dropped/quarantined: "
        f"{latest.get('dropped_workers', 0):g}"
        f"/{latest.get('quarantined_workers', 0)}")
    return "\n".join(lines)


def cmd_top(args):
    """Live per-worker training view: polls the job's health verdict
    every --interval seconds and redraws (the htop of `kubeml`);
    --iterations bounds the loop (0 = until interrupted, 1 = one shot —
    what tests and scripts use)."""
    health = _client(args).v1().health()
    shown = 0
    try:
        while True:
            doc = health.get(args.id)
            if shown and sys.stdout.isatty():
                print("\x1b[2J\x1b[H", end="")  # clear + home
            print(_render_top(doc), flush=True)
            shown += 1
            if args.iterations and shown >= args.iterations:
                break
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        pass


# --------------------------------------------------------------------- serve

def _refuse_serve_flags(args) -> None:
    """The durable control plane runs with --role all only: a single role
    would drop its flags silently."""
    if args.role != "all" and (args.control_durable or args.control_dir):
        _fail("--control-durable and --control-dir need --role all (the "
              "scheduler's and the PS's state recover together)")


def _serve_knobs(args) -> dict:
    """The serve_* flags as the PS's keyword arguments (None = the
    KUBEML_SERVE_* variable or the default)."""
    from kubeml_tpu_torch.control.deployment import SERVE_KNOBS

    knobs = {k: getattr(args, k) for k in SERVE_KNOBS}
    if args.serve_prefix_cache is not None:   # on|off
        knobs["serve_prefix_cache"] = args.serve_prefix_cache == "on"
    return knobs


def parse_env_spec(spec: str) -> dict:
    """'K=V[;K2=V2]' -> env dict (copy of kubeml_tpu/utils/env.py's). ';'
    separates the pairs so VALUES may contain commas: device lists like
    CUDA_VISIBLE_DEVICES=0,1 are the primary use (--job-partition)."""
    out = {}
    for pair in spec.split(";"):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise ValueError(f"bad env spec {pair!r}: expected KEY=VALUE")
        k, v = pair.split("=", 1)
        out[k.strip()] = v
    return out


def cmd_serve(args):
    """Role mux, parity with the reference's single binary whose role is
    chosen by flag (ml/cmd/ml/main.go:60-156): --role all boots the whole
    control plane in one process; a single role binds only that service
    and reaches its peers through the --*-url flags / KUBEML_*_URL env.
    Jobs (threaded, or standalone children) and /infer run on --device:
    the card unless it is `cpu`, over --mesh-data lanes. A multi-process
    deployment joins its process group first (--coordinator,
    --num-processes, --process-id, else the KUBEML_* environment of
    tools/launch_distributed.py; a no-op on a single host)."""
    from kubeml_tpu_torch.api import const
    from kubeml_tpu_torch.parallel.distributed import initialize

    _refuse_serve_flags(args)
    try:
        initialize(args.coordinator, args.num_processes, args.process_id,
                   device=args.device)
    except (RuntimeError, ValueError) as e:   # no card; a failed join
        _fail(str(e))
    partitions = None
    if args.job_partition:
        try:
            partitions = [parse_env_spec(spec)
                          for spec in args.job_partition]
        except ValueError as e:
            _fail(str(e))
    try:
        if args.role == "all":
            from kubeml_tpu_torch.control.deployment import start_deployment
            svc = start_deployment(device=args.device,
                                   use_default_ports=not args.free_ports,
                                   standalone_jobs=args.standalone_jobs,
                                   job_partitions=partitions,
                                   infer_cache_size=args.infer_cache_size,
                                   cluster_lanes=args.cluster_lanes,
                                   cluster_tenants=args.cluster_tenant,
                                   cluster_aging_s=args.cluster_aging_s,
                                   control_durable=args.control_durable,
                                   control_dir=args.control_dir,
                                   n_lanes=args.mesh_data or 1,
                                   **_serve_knobs(args))
            print(f"controller: {svc.controller.url}")
            print(f"scheduler:  {svc.scheduler.url}")
            print(f"ps:         {svc.ps.url}  (metrics at "
                  f"{svc.ps.url}/metrics)")
            print(f"storage:    {svc.storage.url}", flush=True)
        elif args.role == "controller":
            from kubeml_tpu_torch.control.controller import Controller
            svc = Controller(scheduler_url=args.scheduler_url,
                             ps_url=args.ps_url, storage_url=args.storage_url,
                             port=args.port or const.CONTROLLER_PORT)
        elif args.role == "scheduler":
            from kubeml_tpu_torch.control.deployment import build_allocator
            from kubeml_tpu_torch.control.scheduler import Scheduler
            svc = Scheduler(ps_url=args.ps_url,
                            port=args.port or const.SCHEDULER_PORT,
                            allocator=build_allocator(args.cluster_lanes,
                                                      args.cluster_tenant,
                                                      args.cluster_aging_s))
        elif args.role == "ps":
            from kubeml_tpu_torch._device import require_cuda
            from kubeml_tpu_torch.control.ps import ParameterServer
            if args.device is None:
                require_cuda()  # as start_deployment: before binding
            svc = ParameterServer(device=args.device,
                                  n_lanes=args.mesh_data or 1,
                                  port=args.port or const.PS_PORT,
                                  scheduler_url=args.scheduler_url,
                                  standalone_jobs=args.standalone_jobs
                                  or None,
                                  job_partitions=partitions,
                                  infer_cache_size=args.infer_cache_size,
                                  **_serve_knobs(args))
        else:  # storage
            from kubeml_tpu_torch.control.storage import StorageService
            svc = StorageService(port=args.port or const.STORAGE_PORT)
    except (RuntimeError, ValueError) as e:  # no card; a bad partition
        _fail(str(e))
    if args.role != "all":
        svc.start()
        print(f"{args.role}: {svc.url}", flush=True)
    # SIGTERM (a supervisor's stop) stops the services as ^C does
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        svc.stop()


def _interrupt(signum, frame):
    raise KeyboardInterrupt


# ---------------------------------------------------------------------- main


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kubeml", description="KubeML CLI (PyTorch/CUDA port)")
    p.add_argument("--controller", default=os.environ.get(
        "KUBEML_CONTROLLER_URL", ""), help="controller URL")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="submit a train job")
    t.add_argument("-f", "--function", required=True)
    t.add_argument("-d", "--dataset", required=True)
    t.add_argument("-e", "--epochs", type=int, required=True)
    t.add_argument("-b", "--batch", type=int, default=64)
    t.add_argument("--lr", type=float, required=True)
    t.add_argument("--validate-every", type=int, default=1)
    t.add_argument("-p", "--parallelism", type=int, default=2)
    t.add_argument("--static", action="store_true")
    t.add_argument("-K", type=int, default=1)
    t.add_argument("--sparse-avg", action="store_true",
                   help="average once per epoch (K=-1)")
    t.add_argument("--goal-accuracy", type=float, default=100.0)
    t.add_argument("--resume-from", default="", metavar="JOBID",
                   help="warm-start from another job's checkpoint")
    t.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="checkpoint every N epochs (0 = auto: every "
                        "validated epoch, so the job is inferable "
                        "mid-run; -1 = final checkpoint only)")
    t.add_argument("--engine", choices=("kavg", "syncdp"), default="kavg",
                   help="kavg = K-step local SGD with weight averaging "
                        "(reference semantics); syncdp = per-step gradient "
                        "averaging with persistent optimizer state")
    t.add_argument("--shuffle", action="store_true",
                   help="reshuffle training docs each epoch (the "
                        "reference never shuffles; recommended for "
                        "real-data convergence)")
    t.add_argument("--tensor-parallel", type=int, default=1, metavar="M",
                   help="Megatron tensor parallelism over the mesh "
                        "model axis (function must publish tp_rules; "
                        "transformer families do)")
    t.add_argument("--seq-parallel", type=int, default=1, metavar="S",
                   help="ring/ulysses sequence parallelism over the "
                        "mesh seq axis (transformer families)")
    t.add_argument("--expert-parallel", type=int, default=1, metavar="E",
                   help="shard MoE experts over the mesh expert axis "
                        "(MoE families): alone via GSPMD token "
                        "all-to-alls; with --seq-parallel or "
                        "--pipeline-parallel via the manual expert "
                        "path inside the same round")
    t.add_argument("--pipeline-parallel", type=int, default=1,
                   metavar="P",
                   help="GPipe pipeline parallelism over the mesh "
                        "stage axis: the decoder trunk splits into P "
                        "groups of consecutive layers, microbatches "
                        "ppermuting along ICI (transformer families; "
                        "composes with --expert-parallel)")
    t.add_argument("--pp-microbatches", type=int, default=0, metavar="M",
                   help="pipeline microbatch count (default 0 = auto: "
                        "2 x stages); must divide the batch size — "
                        "more microbatches shrink the (P-1)/(M+P-1) "
                        "bubble")
    t.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3 / FSDP: shard parameters AND optimizer "
                        "state over the data axis (each chip stores 1/D "
                        "of the model; GSPMD all-gathers weights at use "
                        "and reduce-scatters grads). Requires "
                        "--engine syncdp")
    t.add_argument("--rounds-per-dispatch", type=int, default=1,
                   metavar="R",
                   help="sync rounds executed per engine dispatch "
                        "(identical math, merges preserved); > 1 "
                        "amortizes per-round submission overhead")
    t.add_argument("--merge-dtype", choices=("", "bf16"), default="",
                   help="lossy wire dtype for the kavg weight merge "
                        "(no residual; kavg engine only)")
    t.add_argument("--merge-compress", choices=("none", "bf16", "int8"),
                   default="none",
                   help="error-feedback compressed cross-slice merges: "
                        "bf16 (2x) or symmetric int8 (~4x) payloads with "
                        "persistent per-lane residuals "
                        "(docs/performance.md)")
    t.add_argument("--merge-bucket-mb", type=float, default=0.0,
                   metavar="MB",
                   help="size cap for bucketed merge overlap: each "
                        "bucket's reduction issues as its leaves "
                        "finalize; 0 = monolithic (bit-identical either "
                        "way)")
    t.add_argument("--seq-impl", choices=("ring", "ulysses"),
                   default="ring",
                   help="sequence-parallel attention implementation")
    t.add_argument("--tp-impl", choices=("gspmd", "manual"),
                   default="gspmd",
                   help="tensor-parallel execution: GSPMD placement or "
                        "explicit Megatron collectives (TP+SP combined "
                        "always runs manual)")
    t.add_argument("--max-parallelism", type=int, default=0, metavar="N",
                   help="cap scheduler-driven parallelism growth at N "
                        "(0 = unbounded, reference parity)")
    t.add_argument("--max-restarts", type=int, default=1, metavar="N",
                   help="restart a crashed standalone job process from "
                        "its own checkpoint up to N times, resuming its "
                        "epoch/history/topology (0 = a dead process "
                        "fails the job)")
    t.add_argument("--checkpoint-every-rounds", type=int, default=0,
                   metavar="R",
                   help="round-granular checkpoint cadence: every R "
                        "sync rounds, save weights plus the epoch's "
                        "round cursor, so a crash or preemption resumes "
                        "mid-epoch at the failed round instead of "
                        "replaying the epoch (kavg engine only; 0 = "
                        "epoch-granular checkpoints)")
    t.add_argument("--quarantine-after", type=int, default=0, metavar="Q",
                   help="mask a worker out for the rest of the epoch "
                        "after Q consecutive non-finite rounds (0 = "
                        "off; per-round device readback cost)")
    t.add_argument("--priority", type=int, default=0, metavar="P",
                   help="cluster-allocator priority: higher-priority "
                        "jobs place first and may preempt (drain + "
                        "checkpoint + requeue, no restart budget spent) "
                        "strictly lower-priority running jobs; ignored "
                        "without --cluster-lanes on the deployment")
    t.add_argument("--tenant", default="",
                   help="cluster-allocator tenant for quota and "
                        "weighted-fair-share accounting (default: the "
                        "shared 'default' tenant)")
    t.add_argument("--continual", action="store_true",
                   help="continual training: poll the dataset registry "
                        "at every epoch boundary and slide onto freshly "
                        "appended generations without restarting "
                        "(--epochs 0 = unbounded loop, stop via "
                        "`kubeml task stop`; --epochs N still caps the "
                        "total)")
    t.add_argument("--window-generations", type=int, default=0,
                   metavar="W",
                   help="train only the newest W append generations "
                        "(sliding window; 0 = the whole retained "
                        "dataset); requires --continual")
    t.add_argument("--publish-every-rounds", type=int, default=0,
                   metavar="P",
                   help="publish serving weights every P sync rounds "
                        "via the round-granular checkpoint path, so a "
                        "co-deployed serve plane hot-swaps mid-epoch "
                        "(kavg engine; requires --continual; 0 = "
                        "publish at checkpoint cadence only)")
    t.add_argument("--reassign-on-quarantine", action="store_true",
                   help="elastic degraded mode: when a worker is "
                        "quarantined mid-epoch, re-deal its unconsumed "
                        "rounds to the surviving workers at epoch end "
                        "so every sample still trains exactly once "
                        "(kavg engine; requires --quarantine-after)")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer", help="run inference on a trained model")
    i.add_argument("-n", "--network", required=True, help="job id")
    i.add_argument("--datafile", required=True, help=".json or .npy input")
    i.set_defaults(fn=cmd_infer)

    d = sub.add_parser("dataset").add_subparsers(dest="sub", required=True)
    dc = d.add_parser("create")
    dc.add_argument("-n", "--name", required=True)
    dc.add_argument("--traindata", required=True)
    dc.add_argument("--trainlabels", required=True)
    dc.add_argument("--testdata", required=True)
    dc.add_argument("--testlabels", required=True)
    dc.set_defaults(fn=cmd_dataset_create)
    da = d.add_parser("append",
                      help="append a generation-tagged train chunk "
                           "(streaming ingest; continual jobs pick the "
                           "new window up at their next epoch boundary)")
    da.add_argument("-n", "--name", required=True)
    da.add_argument("--traindata", required=True)
    da.add_argument("--trainlabels", required=True)
    da.add_argument("--generation", type=int, default=None, metavar="G",
                    help="expected next generation (optimistic "
                         "concurrency: a stale/duplicate producer tag "
                         "is a 400; default = whatever is next)")
    da.add_argument("--retention", type=int, default=0, metavar="W",
                    help="drop whole append windows beyond the newest W "
                         "(0 = keep everything)")
    da.set_defaults(fn=cmd_dataset_append)
    dd = d.add_parser("delete")
    dd.add_argument("-n", "--name", required=True)
    dd.set_defaults(fn=cmd_dataset_delete)
    d.add_parser("list").set_defaults(fn=cmd_dataset_list)

    f = sub.add_parser("fn").add_subparsers(dest="sub", required=True)
    fc = f.add_parser("create")
    fc.add_argument("-n", "--name", required=True)
    fc.add_argument("--code", required=True, help="python file with a "
                    "KubeModel subclass")
    fc.set_defaults(fn=cmd_fn_create)
    fd = f.add_parser("delete")
    fd.add_argument("-n", "--name", required=True)
    fd.set_defaults(fn=cmd_fn_delete)
    f.add_parser("list").set_defaults(fn=cmd_fn_list)

    k = sub.add_parser("task").add_subparsers(dest="sub", required=True)
    k.add_parser("list").set_defaults(fn=cmd_task_list)
    ks = k.add_parser("stop")
    ks.add_argument("--id", required=True)
    ks.set_defaults(fn=cmd_task_stop)
    k.add_parser("prune").set_defaults(fn=cmd_task_prune)

    h = sub.add_parser("history").add_subparsers(dest="sub", required=True)
    hg = h.add_parser("get")
    hg.add_argument("--id", required=True)
    hg.set_defaults(fn=cmd_history_get)
    hd = h.add_parser("delete")
    hd.add_argument("--id", required=True)
    hd.set_defaults(fn=cmd_history_delete)
    h.add_parser("list").set_defaults(fn=cmd_history_list)
    h.add_parser("prune").set_defaults(fn=cmd_history_prune)

    lg = sub.add_parser("logs")
    lg.add_argument("--id", required=True)
    lg.add_argument("-f", "--follow", action="store_true")
    lg.set_defaults(fn=cmd_logs)

    tr = sub.add_parser("trace",
                        help="fetch a job's merged Chrome trace "
                             "(Perfetto-viewable)")
    tr.add_argument("--id", required=True)
    tr.add_argument("-o", "--out", default=None,
                    help="write the trace JSON here instead of stdout")
    tr.set_defaults(fn=cmd_trace)

    co = sub.add_parser("cost",
                        help="per-program analytic cost table (FLOPs, "
                             "HBM bytes, roofline intensity, amortized "
                             "per-sample/per-token cost)")
    co.add_argument("--id", required=True,
                    help="train job id or serve:<model>")
    co.add_argument("--json", action="store_true",
                    help="print the raw /cost document instead of the "
                         "table")
    co.set_defaults(fn=cmd_cost)

    he = sub.add_parser("health",
                        help="one-shot training-health verdict for a job "
                             "(machine-readable JSON)")
    he.add_argument("--id", required=True)
    he.set_defaults(fn=cmd_health)

    tp = sub.add_parser("top",
                        help="live per-worker training view (loss, grad "
                             "norm, phase times, HBM, health state)")
    tp.add_argument("--id", required=True)
    tp.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="poll/redraw period in seconds")
    tp.add_argument("--iterations", type=int, default=0, metavar="N",
                    help="stop after N redraws (0 = run until ^C; 1 = "
                         "one-shot, for scripts)")
    tp.set_defaults(fn=cmd_top)

    s = sub.add_parser("serve", help="start the control plane on this host")
    s.add_argument("--device", default=None,
                   help="device of the jobs and /infer (default: the "
                        "CUDA card; `cpu` runs them on the CPU)")
    s.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process coordinator (rank 0's address; "
                        "default: $KUBEML_COORDINATOR_ADDRESS)")
    s.add_argument("--num-processes", type=int, default=None,
                   help="multi-process process count (default: "
                        "$KUBEML_NUM_PROCESSES)")
    s.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (default: $KUBEML_PROCESS_ID)")
    s.add_argument("--mesh-data", type=int, default=0,
                   help="data lanes of every job (default 1)")
    s.add_argument("--free-ports", action="store_true")
    s.add_argument("--role", default="all",
                   choices=["all", "controller", "scheduler", "ps",
                            "storage"],
                   help="run one role (reference main.go:60-156); the "
                        "job role runs via python -m "
                        "kubeml_tpu_torch.train.jobserver")
    s.add_argument("--port", type=int, default=0,
                   help="port for a single role (default: the role's "
                        "standard port)")
    s.add_argument("--scheduler-url", default=os.environ.get(
        "KUBEML_SCHEDULER_URL"))
    s.add_argument("--ps-url", default=os.environ.get("KUBEML_PS_URL"))
    s.add_argument("--storage-url", default=os.environ.get(
        "KUBEML_STORAGE_URL"))
    s.add_argument("--standalone-jobs", action="store_true",
                   help="run each job as its own process "
                        "(STANDALONE_JOBS=true equivalent)")
    s.add_argument("--job-partition", action="append", metavar="K=V[;K=V]",
                   help="device-partition env for ONE concurrent "
                        "standalone job slot; repeat per slot (e.g. "
                        "--job-partition CUDA_VISIBLE_DEVICES=0,1 "
                        "--job-partition CUDA_VISIBLE_DEVICES=2,3; "
                        "';' separates multiple K=V pairs so values may "
                        "contain commas). A starting job leases a free "
                        "slot until its process exits; while every slot "
                        "is leased the scheduler requeues new tasks")
    s.add_argument("--infer-cache-size", type=int, default=None,
                   help="max checkpoints kept hot in the PS inference "
                        "cache (KUBEML_INFER_CACHE_SIZE, default 4); "
                        "entries are also evicted when the cache would "
                        "exceed the serving HBM budget")
    s.add_argument("--serve-slots", type=int, default=None,
                   help="decode slots per served model — the concurrent "
                        "stream cap for POST /generate "
                        "(KUBEML_SERVE_SLOTS, default 8)")
    s.add_argument("--serve-queue-depth", type=int, default=None,
                   help="admission queue depth beyond the slot pool; "
                        "past slots+queue, /generate sheds with 429 + "
                        "Retry-After (KUBEML_SERVE_QUEUE, default 16)")
    s.add_argument("--serve-prefill-chunk", type=int, default=None,
                   help="prompt tokens per chunked-prefill dispatch; 0 "
                        "feeds prompts through the decode program one "
                        "token per dispatch "
                        "(KUBEML_SERVE_PREFILL_CHUNK, default 16)")
    s.add_argument("--serve-kv-dtype", choices=("f32", "int8"),
                   default=None,
                   help="KV-page storage for served models: f32 keeps "
                        "pages in the model dtype (bit-identity "
                        "baseline), int8 quantizes pages on write with "
                        "per-page scales, cutting decode HBM traffic "
                        "~4x (KUBEML_SERVE_KV_DTYPE, default f32)")
    s.add_argument("--serve-decode-steps", type=int, default=None,
                   metavar="K",
                   help="fused decode steps per dispatch in the all-"
                        "decode steady state: K>1 runs K decode steps "
                        "on the device per dispatch, with one read of "
                        "the tokens back to the host, emitting up to K "
                        "tokens per slot bit-identical to K single "
                        "steps (KUBEML_SERVE_DECODE_STEPS, default 1)")
    s.add_argument("--serve-draft-model", default=None, metavar="NAME",
                   help="registered model used as the speculative-decode"
                        " draft: it proposes tokens that one target "
                        "verify dispatch scores, amortizing dispatches "
                        "per token; emitted tokens stay bit-identical "
                        "to the target model alone "
                        "(KUBEML_SERVE_DRAFT_MODEL, default off)")
    s.add_argument("--serve-prefix-cache", choices=("on", "off"),
                   default=None,
                   help="share full prompt pages across /generate "
                        "requests by content hash, with copy-on-write "
                        "on divergence "
                        "(KUBEML_SERVE_PREFIX_CACHE, default on)")
    s.add_argument("--serve-drain-grace-s", type=float, default=None,
                   metavar="S",
                   help="graceful-drain budget on shutdown: admission "
                        "answers 503 + Retry-After while in-flight "
                        "streams get S seconds to finish; 0 stops hard "
                        "(KUBEML_SERVE_DRAIN_GRACE_S, default 0)")
    s.add_argument("--serve-replicas-min", type=int, default=None,
                   metavar="N",
                   help="floor of the serving fleet: each served model "
                        "fronts at least N decode replicas behind the "
                        "prefix-affinity router; 0 lets the autoscaler "
                        "park the model entirely "
                        "(KUBEML_SERVE_REPLICAS_MIN, default 1)")
    s.add_argument("--serve-replicas-max", type=int, default=None,
                   metavar="N",
                   help="ceiling of the serving fleet: the autoscaler "
                        "grows toward N replicas under shed/queue/TTFT "
                        "pressure and shrinks back when idle "
                        "(KUBEML_SERVE_REPLICAS_MAX, default 1)")
    s.add_argument("--serve-scale-to-zero-s", type=float, default=None,
                   metavar="S",
                   help="retire every replica after S seconds with no "
                        "traffic; the next /generate cold-starts one "
                        "synchronously (peers get 429 + warm-up "
                        "Retry-After meanwhile); 0 disables "
                        "(KUBEML_SERVE_SCALE_TO_ZERO_S, default 0)")
    s.add_argument("--serve-replica-restart-budget", type=int,
                   default=None, metavar="N",
                   help="watchdog restarts one replica may burn before "
                        "the fleet supervisor calls it crash-looping "
                        "and ejects it, live-migrating its streams "
                        "(KUBEML_SERVE_REPLICA_RESTART_BUDGET, default 2)")
    s.add_argument("--serve-probe-requests", type=int, default=None,
                   metavar="N",
                   help="half-open probe requests a probation replica "
                        "must serve to 'ok' before its vnodes rejoin "
                        "the routing ring after an ejection "
                        "(KUBEML_SERVE_PROBE_REQUESTS, default 2)")
    s.add_argument("--serve-hedge-after-s", type=float, default=None,
                   metavar="S",
                   help="hedged retry for gray failures: a stream still "
                        "queued (no slot) after S seconds on one "
                        "replica is re-issued on the least-loaded peer; "
                        "0 disables (KUBEML_SERVE_HEDGE_AFTER_S, "
                        "default 0)")
    s.add_argument("--serve-slo-ttft-ms", type=float, default=None,
                   metavar="MS",
                   help="TTFT objective in milliseconds for the serving "
                        "SLO plane: a request whose first token takes "
                        "longer counts against the error budget; 0 "
                        "disables the TTFT objective "
                        "(KUBEML_SERVE_SLO_TTFT_MS, default 0)")
    s.add_argument("--serve-slo-tpot-ms", type=float, default=None,
                   metavar="MS",
                   help="per-output-token (TPOT) objective in "
                        "milliseconds for the serving SLO plane; 0 "
                        "disables the TPOT objective "
                        "(KUBEML_SERVE_SLO_TPOT_MS, default 0)")
    s.add_argument("--serve-slo-target", type=float, default=None,
                   metavar="FRAC",
                   help="SLO attainment target as a fraction; the burn "
                        "rate is bad_fraction / (1 - target), so 1.0 "
                        "means spending the error budget exactly at "
                        "the sustainable rate "
                        "(KUBEML_SERVE_SLO_TARGET, default 0.99)")
    s.add_argument("--cluster-lanes", type=int, default=None, metavar="N",
                   help="turn on the cluster allocator over N shared "
                        "worker lanes: gang placement, priority "
                        "preemption and weighted fair sharing "
                        "(control/cluster.py); default off = legacy "
                        "one-job-at-a-time scheduling")
    s.add_argument("--cluster-tenant", action="append",
                   metavar="NAME=WEIGHT[:QUOTA]",
                   help="declare a tenant's fair-share weight and "
                        "optional lane quota; repeat per tenant (e.g. "
                        "--cluster-tenant prod=3:6 "
                        "--cluster-tenant batch=1). Undeclared tenants "
                        "get weight 1 and no quota")
    s.add_argument("--cluster-aging-s", type=float, default=None,
                   metavar="S",
                   help="queue-aging period: a parked job gains one "
                        "effective priority level per S seconds waited "
                        "so low-priority gangs cannot starve "
                        "(default 30; <= 0 disables aging)")
    s.add_argument("--control-durable", action="store_true",
                   help="durable control plane: journal every allocator "
                        "decision and mirror scheduler/PS registries to "
                        "state files so a restart RECOVERS (re-adopting "
                        "surviving children, rebuilding serving fleets) "
                        "instead of starting cold")
    s.add_argument("--control-dir", default=None, metavar="DIR",
                   help="state directory for --control-durable "
                        "(default $KUBEML_TPU_HOME/control/); giving a DIR "
                        "implies --control-durable")
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except KubeMLException as e:
        _fail(e.message)


if __name__ == "__main__":
    main()
