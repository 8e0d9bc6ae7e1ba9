"""Standalone per-job server — the reference's job pod, as a process
(twin of kubeml_tpu/train/jobserver.py over the port's TrainJob).

The PS spawns one child per training job in standalone mode
(ml/pkg/ps/job_pod.go:140-217) with the per-job REST surface of the
reference's TrainJob (ml/pkg/train/api.go:141-149):

    POST   /start     receive the TrainTask, begin training
    POST   /update    next-epoch parallelism push {"parallelism": N,
                      "grant_epoch": E}: a re-grant's fencing epoch, when
                      present, becomes the task's
    DELETE /stop      graceful stop at the next epoch boundary
    GET    /health    readiness probe (built into JsonService)

Control-plane callbacks run over HTTP like the reference job pod's: metric
pushes to the PS (``POST {ps}/metrics/{jobId}``, ml/pkg/train/
util.go:19-50), re-parallelization asks to the scheduler (``POST
{scheduler}/job``, then a wait for the PS-relayed /update, ml/pkg/train/
job.go:196-215), progress heartbeats with the job's (epoch, round) cursor
(``POST {ps}/heartbeat/{jobId}``, what the PS's liveness reaper watches)
and the finish notification (``POST {ps}/finish/{jobId}``), with a
bounded, jittered backoff seeded from the job id.

Preemption: SIGTERM asks the job to drain (``TrainJob.preempt``): it
finishes the round in flight, checkpoints at the round cursor and raises
JobPreemptedError, which this server turns into ``POST
{ps}/preempted/{jobId}`` with ``{epoch, round}`` instead of /finish, so
the PS reschedules the job from its cursor.

    python -m kubeml_tpu_torch.train.jobserver --job-id abc123 \
        --ps-url http://host:port --scheduler-url http://host:port \
        [--port 9090] [--port-file /path] [--device cpu] [--mesh-data D]

``--mesh-data D`` runs the job over D data lanes. Before it builds a job
the process joins the process group its ``KUBEML_*`` environment declares
(``parallel/distributed.initialize``; a quiet no-op without one), as the
JAX package's job pods join their cluster.

The job writes its log lines to ``$KUBEML_TPU_HOME/logs/<job>.log`` (what
``kubeml logs`` prints) and its spans to ``TraceSink(job, "job")`` under
the trace id its task carries, beside the parent's files.

Without ``--device`` the job runs on CUDA, and the process exits with an
error before it binds its port when there is no card.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import signal
import threading
import time
import zlib
from typing import Optional

from kubeml_tpu_torch.api.errors import (InvalidArgsError, JobPreemptedError,
                                         KubeMLException)
from kubeml_tpu_torch.api.types import MetricUpdate, TrainTask
from kubeml_tpu_torch.control.httpd import JsonService, Request, http_json
from kubeml_tpu_torch.control.journal import atomic_write_json

logger = logging.getLogger("kubeml_tpu_torch.jobserver")


class JobServer(JsonService):
    name = "job"

    def __init__(self, job_id: str, ps_url: Optional[str] = None,
                 scheduler_url: Optional[str] = None, port: int = 0,
                 device=None, n_lanes: int = 1):
        super().__init__(port=port)
        self.job_id = job_id
        self.ps_url = ps_url
        self.scheduler_url = scheduler_url
        self.device = device
        self.n_lanes = int(n_lanes)
        self.finished = threading.Event()  # set after the job ends
        self.exit_error: Optional[str] = None
        self._job = None
        self._job_thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        # progress heartbeats to the PS; 0 disables
        self.heartbeat_interval = float(
            os.environ.get("KUBEML_HEARTBEAT_INTERVAL", "10"))
        self._next_parallelism: Optional[int] = None
        self._update_event = threading.Event()
        # backoff jitter source, seeded from the job id so a run replays
        # the same retry schedule
        self._rng = random.Random(zlib.crc32(job_id.encode()))

        self.route("POST", "/start", self._h_start)
        self.route("POST", "/update", self._h_update)
        self.route("DELETE", "/stop", self._h_stop)

    # ------------------------------------------------------------- handlers

    def _h_start(self, req: Request):
        if self._job is not None:
            raise InvalidArgsError(f"job {self.job_id} already started")
        task = TrainTask.from_dict(req.body)
        if task.job_id != self.job_id:
            raise InvalidArgsError(
                f"task {task.job_id} sent to job server {self.job_id}")
        self._launch(task)
        return {"job_id": self.job_id}

    def _h_update(self, req: Request):
        self._next_parallelism = int(req.body["parallelism"])
        epoch = req.body.get("grant_epoch")
        if epoch is not None and self._job is not None:
            # a recovered scheduler re-grants surviving jobs under a new
            # fencing epoch and relays it here: adopt it, so the next
            # /job ask is not 409'd as a stale pre-crash grant
            self._job.task.grant_epoch = int(epoch)
        self._update_event.set()
        return {"ok": True}

    def _h_stop(self, req: Request):
        if self._job is None:
            raise InvalidArgsError("job not started")
        self._job.stop()
        return {"ok": True}

    # ------------------------------------------------------------ lifecycle

    def _launch(self, task: TrainTask):
        from kubeml_tpu_torch.api.const import kubeml_home
        from kubeml_tpu_torch.data.registry import DatasetRegistry
        from kubeml_tpu_torch.models.base import KubeDataset
        from kubeml_tpu_torch.train.functionlib import FunctionRegistry
        from kubeml_tpu_torch.train.history import HistoryStore
        from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

        fn_name = task.parameters.function_name or task.parameters.model_type
        model_cls, dataset_cls = FunctionRegistry().resolve(fn_name)
        dataset = (dataset_cls(task.parameters.dataset) if dataset_cls
                   else KubeDataset(task.parameters.dataset))
        self._job = TrainJob(
            task, model_cls(), dataset, device=self.device,
            n_lanes=self.n_lanes,
            registry=DatasetRegistry(), history_store=HistoryStore(),
            callbacks=JobCallbacks(
                request_parallelism=self._request_parallelism,
                publish_metrics=self._publish_metrics,
                on_finish=self._on_finish),
            log_file=os.path.join(kubeml_home(), "logs",
                                  f"{task.job_id}.log"))
        self._job_thread = threading.Thread(
            target=self._run, name=f"job-{self.job_id}", daemon=True)
        self._job_thread.start()
        if self.ps_url is not None and self.heartbeat_interval > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"heartbeat-{self.job_id}", daemon=True)
            self._hb_thread.start()

    def _post_with_retry(self, what: str, url: str, body: dict,
                         attempts: int = 5, base_delay: float = 0.05,
                         max_delay: float = 2.0) -> bool:
        """Control-plane callback with bounded, jittered exponential
        backoff (jitter from the job-id-seeded RNG): a PS or scheduler
        that is busy for a moment gets the notification late instead of
        never. After ``attempts`` the loss is logged."""
        delay = base_delay
        for attempt in range(attempts):
            try:
                http_json("POST", url, body)
                return True
            except KubeMLException as e:
                if attempt == attempts - 1:
                    logger.warning("%s failed after %d attempt(s): %s",
                                   what, attempts, e.message)
                    return False
                logger.debug("%s attempt %d failed (%s); retrying",
                             what, attempt + 1, e.message)
                time.sleep(delay * (0.5 + self._rng.random() / 2))
                delay = min(delay * 2, max_delay)
        return False

    def _run(self):
        try:
            self._job.train()
        except JobPreemptedError as e:
            # the cursor is on disk: the PS reschedules the job (not
            # /finish, which would tear down the record the restart needs)
            logger.warning("job %s preempted at epoch %d round %d; "
                           "notifying PS", self.job_id, e.epoch, e.round)
            if self.ps_url is not None:
                self._post_with_retry(
                    "preemption notification",
                    f"{self.ps_url}/preempted/{self.job_id}",
                    {"epoch": e.epoch, "round": e.round})
            self.finished.set()
        except Exception:
            logger.exception("job %s failed", self.job_id)
            self.finished.set()  # train() reports on_finish itself; backstop

    def preempt(self):
        """SIGTERM: drain the round in flight, checkpoint at the round
        cursor, exit for rescheduling; with no task yet, just exit."""
        job = self._job
        if job is not None:
            logger.warning("job server %s: preemption notice (SIGTERM); "
                           "draining in-flight round", self.job_id)
            job.preempt()
        else:
            self.finished.set()

    def _heartbeat_loop(self):
        """Progress heartbeats (the job's (epoch, round) cursor) to the
        PS's liveness reaper, paced on the finished event so shutdown is
        prompt."""
        while not self.finished.wait(timeout=self.heartbeat_interval):
            job = self._job
            if job is None:
                continue
            epoch, rnd = job._progress
            # a short bounded retry: the next beat is one interval away
            self._post_with_retry(
                "heartbeat", f"{self.ps_url}/heartbeat/{self.job_id}",
                {"epoch": int(epoch), "round": int(rnd)},
                attempts=3, max_delay=0.5)

    # ------------------------------------------------------------ callbacks

    def _request_parallelism(self, task: TrainTask) -> Optional[int]:
        """job.go:196-215 over HTTP: ask the scheduler, then block for the
        PS-relayed POST /update."""
        if self.scheduler_url is None:
            return None
        self._update_event.clear()
        try:
            http_json("POST", f"{self.scheduler_url}/job", task.to_dict())
        except KubeMLException as e:
            logger.warning("scheduler unreachable: %s", e.message)
            return None
        if not self._update_event.wait(timeout=60.0):
            logger.warning("no parallelism update within 60s")
            return None
        self._update_event.clear()
        return self._next_parallelism

    def _publish_metrics(self, m: MetricUpdate):
        if self.ps_url is None:
            return
        try:
            http_json("POST", f"{self.ps_url}/metrics/{self.job_id}",
                      m.to_dict())
        except KubeMLException as e:
            logger.warning("metric push failed: %s", e.message)

    def _on_finish(self, job_id: str, error: Optional[str]):
        self.exit_error = error
        if self.ps_url is not None:
            self._post_with_retry("finish notification",
                                  f"{self.ps_url}/finish/{job_id}",
                                  {"error": error})
        self.finished.set()


def main(argv=None):
    p = argparse.ArgumentParser(prog="kubeml-torch-job")
    p.add_argument("--job-id", required=True)
    p.add_argument("--ps-url", default=None)
    p.add_argument("--scheduler-url", default=None)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--port-file", default=None,
                   help="write the bound port here (parent discovery)")
    p.add_argument("--device", default=None,
                   help="device of the job (default: CUDA)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data lanes of the job (default 1)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from kubeml_tpu_torch._device import resolve_device
    from kubeml_tpu_torch.parallel.distributed import initialize

    # a job pod of a multi-process deployment joins its group first (the
    # KUBEML_* environment; a no-op without one), which makes this rank's
    # card current; then this raises, before the port is bound, when CUDA
    # is asked for (the default) and there is no card: the PS sees the
    # child exit
    initialize(device=args.device)
    device = resolve_device(args.device)
    server = JobServer(args.job_id, ps_url=args.ps_url,
                       scheduler_url=args.scheduler_url, port=args.port,
                       device=device, n_lanes=args.mesh_data or 1)
    port = server.start()
    # the platform's eviction notice: drain, checkpoint, /preempted (the
    # handler only sets events; the work happens on the job's thread)
    signal.signal(signal.SIGTERM, lambda *_: server.preempt())
    if args.port_file:
        atomic_write_json(args.port_file, port)  # never read half-written
    logger.info("job server %s on port %d", args.job_id, port)
    # a bounded wait for the task: a child whose parent died (or whose
    # /start push was lost) must not linger as an idle orphan. Once the
    # job runs, the job decides when it is finished.
    start_timeout = float(os.environ.get("KUBEML_JOB_START_TIMEOUT",
                                         120.0)) + 180.0
    while not server.finished.wait(timeout=1.0):
        if server._job is None:
            start_timeout -= 1.0
            if start_timeout <= 0:
                logger.error("job server %s received no task within the "
                             "start window; exiting", args.job_id)
                break
    server.stop()


if __name__ == "__main__":
    main()
