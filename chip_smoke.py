#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubeml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result line). Merge
counts: every phase that counts the fused merge holds two numbers, its
segments (buckets merged) = buckets x merges, and its launches = merges x
ceil(buckets / 64), one grouped launch for up to 64 buckets of a merge
(every plan here has at most 14 buckets: one launch a merge).
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
              version's time and the bytes bound (avg 8 bytes per
              element, s read and out written; sgd 12, ref read too);
              no single PyTorch call computes this function, so there is
              no library yardstick. (a2) the grouped launch (every bucket
              of a merge in one launch) at each model's 4 MB plan
              (gpt-mini, ResNet-18, gpt-moe-mini, vgg11, bert-tiny, the
              LSTM): bit for bit against the plain version in both modes,
              at raw_count 3 and 0; warm and L2-cold times beside the
              plain version and the 8 B bound. (b)+(c)
              gpt-mini at its published
              widths, bf16, dropout 0.1, n_lanes=2, W=4, K=4, B=8, T=512:
              three train_rounds each with the bucketed (4 MB), ef_bf16 and
              ef_int8 merges; the merge kernel's counts are zeroed just
              before and read just after (3 launches of 5 segments), the
              flash
              launches too; the loss falls, EF residuals stay finite, and
              after a round with lane 1 masked out its residual is exactly
              zero while lane 0's is not. The first bucketed round's
              contributions merged by MonolithicMerge and by
              BucketedMerge(4 MB) are equal bit for bit. (d)
              gpt-nano in
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
              eval steps, the fused merge 5 buckets x rounds (in one launch
              a round). The history's
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
              device_cache='off'. The fused merge's counts are zeroed
              before each epoch and read after it: 10 buckets x 13 rounds
              (from the plan) in 13 launches. The loss must fall. Prints
              per epoch wall, samples/s, ms per local step, the phase
              split, and the cached epoch against the host-staged one.
              (b) One ResNet-18 round index-fed == host-staged and two
              index-fed rounds grouped ==
              two single rounds, bit for bit under
              torch.backends.cudnn.deterministic (and whether the first
              pair is equal without it); the bucketed merge against the
              monolithic one within 2e-2. (c) One f32 round of a narrow
              ResNet (stages (1, 1), width 16) and one of LeNet on the card
              and on the CPU: parameters and running statistics within
              1e-4. (d) One ResNet-18 round profiled: device busy and idle
              share, the convolutions' and the merge's share, the top
              device consumers. (Phase 9 (a2) times the fused merge at
              ResNet-18's plan.)
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
              the controller: the fused merge's counts, zeroed before
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
 13. cli      the kubeml CLI on the card, under a fresh KUBEML_TPU_HOME:
              `python -m kubeml_tpu_torch.cli serve --role all
              --free-ports` as a child process (run through runpy under
              phase 12's numerics: cudnn.deterministic, no TF32, and a
              wrapper on the PS's publish that writes each epoch's kernel
              launches to a file, since they happen in the child), driven
              only by `python -m kubeml_tpu_torch.cli` processes, each timed
              from spawn to exit (`fn list` is the cold start). (a) `fn
              create` of phase 12's ResNet-18 function, `dataset create` of
              phase 11's images, `kubeml train` of ResNet-18 with phase
              12's task (B=256, K=8, lr 0.1, static N=2, 4 MB buckets) for
              3 epochs: its epoch-1 checkpoint, read while epoch 2 runs,
              must equal phase 12's deployment job bit for bit (the spans
              time the host only; train stats are on, as the CLI sends
              them), and the fused merge must merge 130 buckets in 13
              launches an epoch.
              (b) Once the PS's verdict reads healthy, `kubeml health`,
              `kubeml top --iterations 1` and `kubeml task list` run
              together and must show the job live and healthy. (c) After
              the job: the verdict reads unknown; `history get` (3 epochs,
              loss falls), `logs` (3 epoch lines with the tracer's summary),
              `trace --out` (client, scheduler, PS and job files under one
              trace id, a dispatch span per round) and `infer` of 64 test
              images (equal to the model's infer on the checkpoint). (d)
              Phase 10's windows and gpt-mini for one epoch at N=2 through
              `kubeml train`: launches = the plan. Prints ms per local step
              by epoch beside phase 12's, the child's start and the CLI's
              cold start.
 14. ps serve serving through the PS: a seeded gpt-mini checkpoint (phase
              3's weights, written by the port's writer in the JAX package's
              format) served by start_deployment() with phase 3's knobs (8
              slots, 16-token pages and prefill chunks, prefix cache on),
              once with bf16 and once with int8 KV pages. (a) Phase 3's 8
              greedy requests as 8 concurrent streaming POST /generate
              calls: tokens must equal phase 3's direct tokens; tokens/s and
              client-side mean TTFT (to the first ndjson line) beside phase
              3's; the paged kernel's launches zeroed just before and read
              just after must be layers x the replica's decode + prefill
              dispatches. (b) Saturation: 24 held streams fill slots + queue,
              the next request answers 429 with Retry-After, and a deadline
              below the queued prompt backlog answers 429 too. (c) Hot-swap:
              a second checkpoint saved while 4 streams are in flight; they
              finish with phase 3's tokens (generation 1), the 4 admitted
              after it decode generation 2 (equal to a direct run on the new
              weights), kubeml_serve_weight_generation reads 2 and
              generation 1 retires. (d) A two-replica deployment on the one
              card: three prompts sharing a 48-token prefix route to one
              replica, whose prefix hits show; a ServeFleet built directly
              with a fleet_replica_crash on the replica holding most of the
              batch migrates its streams, which finish with phase 3's
              tokens. (e) GET /flight, /trace (one generate tree per
              request under its response's trace id), /health and /metrics
              of serve:gpt-mini.
 15. cluster  the cluster allocator and the durable control plane: a
              `kubeml serve --role all --standalone-jobs --cluster-lanes 4
              --cluster-tenant prod=3:4 --cluster-tenant batch=1
              --control-dir D` child (phase 14's serve knobs, bf16 pages,
              no replica floor) on fixed ports, each job in a jobserver
              child, over phase 10's windows (1024 + 128). (a) Gang
              placement: gpt-mini at a static N=2 (tenant batch) places, an
              N=3 job (tenant prod) parks on the 2 free lanes and places
              when the first finishes; each job's queue wait, launches per
              epoch (= the plan) and a checkpoint equal bit for bit to a
              direct TrainJob at the same N. (b) Serve-elastic: the first
              POST /generate cold-starts a replica whose gang places
              through POST /serve/resize; phase 3's batch gives phase 3's
              tokens with paged launches = 4 x dispatches; a priority-1
              N=4 arrival preempts the serving gang, the fleet drains to
              zero, the job places, and the next /generate cold-starts
              with phase 3's tokens. (c) Recovery: a 3-epoch N=2 job is
              held after epoch 1's MetricUpdate, the serve child is
              SIGKILLed (not its job child) and started again on D: the
              child is re-adopted (same pid, no restart spent), the
              fencing epoch rises by 1 and reaches the child's task
              through PS /update (its later epochs run under it), /job
              with the old epoch answers 409, the fleet comes back at 1
              replica with phase 3's tokens; released, the job finishes
              (at its goal accuracy after epoch 2, as the direct job
              does) with a checkpoint equal bit for bit to an
              uninterrupted direct job's. Prints
              kubeml_control_recovery_seconds per role and
              torch.cuda.mem_get_info's free bytes around the kill.
 16. degraded degraded-mode training and the preemption of training jobs,
              under a fresh KUBEML_TPU_HOME and cudnn.deterministic, over
              phase 10's windows (1024 + 128): gpt-mini at its published
              widths whose per-sequence loss is scaled by a float batch
              key w of ones (token ids are integers, which a NaN burst
              leaves alone: w is the leaf it poisons), static N=4, K=4,
              B=8, 32 windows a doc (8 rounds an epoch), 4 MB buckets.
              (a) A nan FaultPlan event on worker 1 at round 2 of a
              one-epoch job and a dropout event there end with the same
              weights bit for bit; dropped_workers [1]. (b) NaN on every
              worker at rounds 2 and 3: the weights after each round
              equal those before round 2 (the fused merge's raw_count = 0
              select) and
              abort_after=2 fails the job with the JAX package's
              diagnostic. (c) quarantine_after=2 and reassignment with NaN
              on worker 2 at rounds 2-3: quarantined from round 4, the
              makeup rounds cover its orphaned windows exactly once,
              reassigned_batches equals the host's makeup plan. Then the
              round cursor's cost: the same epoch with and without
              checkpoint_every_rounds=1 (ms per local step, equal
              weights). Then three sub-phases side by side, each mostly
              cold child starts. (d) In start_deployment(standalone_jobs=
              True) a job server child (N=2, 8 rounds of 8 steps,
              checkpoint_every_rounds=2) crashes at round 5; the watchdog
              restarts it from its cursor: restarts 1, weights equal to
              the uninterrupted direct job. (f) The same job with a slow
              round 5: its child is stopped (SIGSTOP) there, the
              heartbeat reaper (0.25 s beats x 16) kills it, the watchdog
              restarts it: restarts 1, kubeml_ps_wedged_kills_total 1,
              equal weights. (e) In phase 15's cluster-mode serve child a
              priority-1 N=4 arrival preempts a running N=2 job: SIGTERM
              -> drain at a round -> /preempted -> /requeue -> re-place
              -> resume; restarts 0, preemptions 1, equal weights; prints
              the drain, requeue -> re-place and re-place -> done
              seconds. Each flash and merge launch count is held to the
              plan.
 17. cost     the cost ledger and the runtime metrics, under a fresh
              KUBEML_TPU_HOME: (a) one epoch of phase 10's task (gpt-mini,
              static N=2, K=4, B=8, 4 MB buckets) as a threaded job of an
              in-process start_deployment: the PS's /cost?id=, the
              controller's /cost/{jobId} and `kubeml cost --id J --json`
              give one document; the kavg.train* dispatches equal the
              rounds and their samples the real samples; merge.bucketed's
              hbm_bytes equals comm_proxy's payload and its argument_bytes
              the buckets per round; the flash launches equal the plan,
              the fused merge's buckets x rounds; jit_compiles equals the
              distinct round keys; the kubeml_cost_* lines equal the
              document; prints the ledger's and the tracker's host us per
              round and the job's ms per local step beside phase 10's.
              (b) the same job in a job-server child (its MetricUpdate
              through POST /metrics): the same document but its id.
              (c) phase 14's 8 streams through POST /generate on 2
              replicas, bf16 pages: /cost?id=serve:gpt-mini's decode +
              prefill dispatches x layers equal the paged kernel's
              launches, its tokens the tokens streamed, the fleet's totals
              the sum over its replicas, pager.decode_kv the slab's
              decode_bytes_per_token. (d) (a)'s
              kubeml_device_hbm_bytes{kind="peak"} equals
              torch.cuda.max_memory_allocated() read at the epoch's end.
 18. continual the continual mode, under a fresh KUBEML_TPU_HOME: (a)
              gpt-mini through an in-process start_deployment driven by
              `kubeml` processes: `dataset create` (generation 1, 256
              token windows), `train --continual -e 40
              --window-generations 2 --publish-every-rounds 1
              --goal-accuracy 200` (static N=2, K=4, B=8), and at the end
              of the first epoch on each generation a `dataset append`
              (128 windows each) while the job trains on; the phase stops
              the job after its first epoch on generation 3. Meanwhile
              two client threads send greedy POST /generate streams (16
              or 64 new tokens, 0.25 s apart) for the job's model. Checks: the (dataset_generation,
              data_lag_generations) pairs end at (3, 0) with lag 0
              throughout; each slide's window equals the registry's
              windowed handle (generation 1 slides out at generation 3);
              each epoch's flash and merge launches equal its window's
              plan; each installed saved_at stamp raises the generation
              by one (kubeml_serve_weight_generation = the stamps); the
              streams in flight at a swap equal a direct DecodeEngine on
              the weights they attached under; the paged kernel's
              launches = layers x (decode + prefill dispatches). Prints
              the seconds from `dataset append`'s exit (and from the
              storage commit) to the window slide, and from a publish to
              the first admission that decodes it. (b) a direct continual
              ResNet-18 TrainJob, device_cache='on' (sharded,
              incremental), over three generations of 8192 CIFAR-shaped
              images and a window of 2 (grow after epoch 1, slide after
              epoch 3): after every epoch the slabs equal a cold cache's
              of the same handle (torch.equal on the card); prints the
              refresh's host-to-device bytes against a cold upload's,
              lanes_reused and lanes_refreshed, the ms per local step
              before and after the slide, and the merge's launches
              (buckets x rounds).
 19. spec     multi-step and speculative decode: (a) phase 3's batch and
              geometry, bf16 then int8 pages, under three engines —
              decode_steps=4, a self-draft (gpt-mini drafting for itself,
              4 proposals a verify call) and a disagreeing draft
              (gpt-mini from seed + 11) — each batch's greedy tokens equal
              phase 3's, and two sampled requests (32 new tokens at
              temperatures 0.8 and 1.1) equal the single step's bit for
              bit, profiled to count the host readbacks (device DtoH
              copies) per decode dispatch. (b) the batch as 8 streaming
              POST /generate through a deployment started from `kubeml
              serve`'s flags --serve-decode-steps 4 --serve-draft-model
              <id> (the disagreeing draft, saved as a checkpoint): tokens
              equal phase 3's, /metrics' draft/accepted/rejected counters
              equal the engine's, the snapshot's accepted per dispatch
              equals accepted / verify dispatches. (c) in every run the
              launches equal the plan: paged = layers x (single decode +
              prefill + 4 x multi-step + 2 x 5 x verify dispatches), the
              flash forward = draft layers x 4 x verify dispatches; the
              ledger's serve.multi_step / serve.spec_verify dispatches
              equal the engine's. (An engine at 12-token pages is
              served in phase 20 (d).) Prints tokens/s, mean TTFT,
              dispatches per token, accepted tokens per verify dispatch
              and host readbacks per dispatch
              for each mode and page type, and the all-decode steady
              state alone (8 one-token prompts, bf16 pages): tokens/s
              and ms per dispatch of the single step, multi-step and the
              self-draft, equal tokens.
 20. text     the text classifiers (bench_text.py's BASELINE configs 5
              and 4 at their published widths): (a) bert-tiny (vocab
              30522, hidden 128, 2 layers, 2 heads of 64, dropout 0.1,
              AdamW) as a TrainJob over a registry dataset of 4096 + 1024
              band-structured int32 sequences (T=64; ragged pad tails,
              interior pads, one row in 32 all padding) at B=32, K=16,
              N=4, 2 epochs from the device cache: per epoch the forward
              kernel launches 2 layers x (local steps + eval slots), dK/dV
              and dQ 2 x local steps, the fused merge buckets x rounds;
              the loss falls; the fused merge against its plain version
              (bit for bit, timed) at each bucket length of the model's
              4 MB plan; then one f32 round (dropout 0, W=2 lanes, K=4,
              B=8, the 4 MB plan: one fused merge launch a round) on the
              card and on the CPU within 2 x K x lr. (b) the
              2-layer LSTM (vocab 32000, embed 128, hidden 256, Adam) the
              same way at B=64, K=8, N=4 over 4096 + 512 sequences (the
              merge is its only TPU kernel), its merge and f32 round
              checks, and one worker's round of K steps profiled: ms per
              local step and the device idle share. (c) the flash kernels
              not causal at BERT-tiny's shapes (B=32, H=2, D=64, bf16,
              T = 64 and 128) against their plain versions within 2e-2,
              the fully padded rows finite and uniform, timed warm and
              L2-cold against SDPA with the bytes bound. (d) ROADMAP
              C.3: the paged kernel at page sizes 4, 12 and 20 (bf16 and
              int8 pages, ~512-token contexts) against its plain version,
              timed against a page gather + SDPA; a gpt-mini engine at
              12-token pages, built under attn_impl "auto" and "kernel",
              serves phase 3's batch through the kernel with launches =
              layers x dispatches, each call held against the plain
              version on its operands (2e-2); its tokens compared with
              the same requests through the plain version on the card,
              which launches nothing (a flip reported with its logit
              margin).
 21. moe-vgg  the last two built-in models: (a) gpt-moe-mini at its
              published widths (gpt-mini's, with 8 experts of a 512-wide
              FFN, top-2 routing at capacity 1.25, aux 0.01, dropout
              0.1, bf16, AdamW) as a TrainJob over phase 10's windows
              (1024 + 128, T=512) at B=8, K=4, N=2, 2 epochs (rounds
              staged from the host, as phase 10's): per epoch the flash
              forward launches 4
              layers x (local steps + eval slots), dK/dV and dQ 4 x
              local steps, the fused merge buckets x rounds of its 4 MB
              plan; the loss falls; one local step profiled (idle share,
              top consumers) and the dispatch and combine einsums timed
              alone at its shapes (their share of the step's device
              time). (b) vgg11 (hidden 4096, 100 classes, dropout 0.5,
              SGD with momentum 0.9, examples/function_vgg11.py's B=128,
              lr 0.05 and normalization) over 50,000 + 10,000
              CIFAR-100-shaped u8 images (labels 0..99) at K=8, N=2, 2
              epochs from the device cache: the fused merge merges
              buckets x rounds of its 109 MB plan (Dense_1's 16,777,216
              elements a bucket of their own); the loss falls; one step
              profiled. (c) card vs CPU: a gpt-moe-mini at gpt-nano's
              widths with 4 experts, f32, one round on 2 lanes (flash
              kernels in f32, one merge launch a round) within 2 x K x
              lr, 99.5 % of the weights within 1e-5; a hidden-64 vgg11
              in f32, forward and one round within 1e-4. (d) the fused
              merge against its plain version, bit for bit and timed warm
              and L2-cold in avg mode, at every bucket length of both
              plans, each whole merge against its bytes bound (8 B an
              element). (e) a DecodeEngine over gpt-moe-mini on
              the card raises the reference's refusal.
 22. syncdp   the SyncDP engine (parallel/syncdp.py) over 2 lanes:
              (b) gpt-mini at its published widths, bf16, dropout 0.1,
              2 dispatches of K=4 global steps of G = W x B = 2 x 8
              sequences of T=512 (phase 7's runs, half ending in padding,
              worker 1's step 2 masked so lane 1 is dead there), reflowed
              as the job does, on the implicit path and under the
              bucketed (4 MB), ef_bf16 and ef_int8 merges: counts zeroed
              just before and read just after each dispatch; the flash
              kernels launch layers x real global steps (x lanes on the
              explicit path, every lane of a real step running), the
              fused merge one launch of 5 segments a step under the
              explicit merges, none on the implicit path; no step
              skipped; ms per global step. (a) card vs CPU: gpt-mini at
              its widths in f32 (dropout 0), 2 dispatches of each path
              of G = 2 x 1 sequences of T=512 (cut for the CPU's run)
              on the card and on the CPU (plain versions): weights
              within 2 x steps x lr, 99.5 % within 1e-5. (a2) #2-#4 in
              bf16 at the path's shapes, the implicit global batch
              [16, 512] and the explicit lane [8, 512] (H=4, D=64,
              causal, a dispatch's keep-mask): each against its plain
              version within the flash tolerance, timed beside the
              plain version, SDPA and the bound. (c) #5 at the SyncDP
              call (avg mode, count 1, a zero ref, gpt-mini's 5 buckets
              in one launch): bit for bit against the plain version at
              raw_count 2 and 0; timed L2-warm and L2-cold against the
              plain version and the bytes bound.
              (d) phase 16's weighted gpt-mini under ef_bf16: a FaultPlan
              nan event in worker 1 of a round skips every step of the
              dispatch, leaving parameters, Adam's moments and step
              count bit for bit as before it and the EF residuals zero.
              (e) TrainJob(gpt-mini, engine='syncdp',
              merge_compress='bf16', N=2, K=4, B=8) for 2 epochs over
              512 + 128 windows from the replicated device cache:
              launches per epoch against the plan (eval slots on the
              forward), ms per global step, samples/s, guard readbacks
              per step, one dispatch profiled (idle share, DtoH copies
              per step), and the kavg job over the same data for one
              epoch (ms per local step).

 23. dist     data lanes as torch.distributed ranks, each rank a child
              of this process with the KUBEML_* environment (this process
              joins no group and runs the one-process runs they are held
              to): (a) one NCCL rank holding 2 lanes, phase 7's gpt-mini
              round (bf16, W=2, K=4, B=8, T=512) twice under bucketed (4
              MB) and twice under ef_int8: weights and EF residuals equal
              the same rounds without a group bit for bit; round 2's
              #2-#5 launches = the plan and its collectives counted (1 +
              buckets all-reduces, ef_int8 1 + 2 x buckets, 1
              all-gather); (b) two gloo ranks on the one card, 1 lane
              each, the same rounds: both ranks' weights equal each other
              and the one-process 2-lane rounds bit for bit, each rank's
              residual its lane's slice, #5 once a merge on each rank, ms
              a round against the one-process round; (c) a two-rank
              TrainJob (gpt-mini, ef_bf16, N=2, K=4, B=8, 1 epoch over 128
              + 32 windows, host-staged): both ranks' histories and final
              weights equal each other and the one-process job's, launches
              per rank against the plan (every rank validates the whole
              set), ms per local step against the one-process job; which
              collectives gloo takes CUDA tensors for, tried directly; and
              the error NCCL gives two ranks on one card.
 24. sd-dist  the SyncDP engine over ranks with physical ZeRO-1/FSDP
              shards, each rank a child as in phase 23 (this process joins
              no group): phase 22's gpt-mini dispatches (bf16, dropout
              0.1, 2 lanes, G = 2 x 8 sequences of T=512, 4 steps, AdamW
              1e-3) twice on the implicit path (zero1, replicated, fsdp)
              and under bucketed (4 MB), ef_bf16 and ef_int8: (a) one
              NCCL rank holding both lanes: weights, Adam's moments and
              EF residuals equal the engine without a group bit for bit;
              (b) two gloo ranks on the one card, one lane each, against one
              process of 2 lanes: the explicit paths bit for bit (weights,
              the ranks' moment shards gathered, each rank's residual its
              lane's slice), the implicit paths within AdamW's 2 x steps x
              lr, the gathered first moments within 0.03 relative L2 and
              every step's loss within 1e-3 relative (the shares within 1e-5
              printed), the ranks equal each other bit for bit; (b32) the
              implicit paths again in f32, where a rank's half batch and one
              process's whole batch differ only in f32 rounding: the weights
              99.5 % within 1e-5 and within 2 x steps x lr, every step's
              loss within 1e-4 relative, the gathered first moments within
              1e-3 relative L2; (c) each rank's moment (and fsdp parameter)
              elements = the ZeRO plan, the bytes a rank holds between
              dispatches and the peak device memory of a dispatch beside
              what was allocated before it (this process's earlier phases
              too), replicated / zero1 / fsdp; (d) the second dispatch's
              collectives (reduce-scatter, all-reduce, all-gather-into) and
              #2-#5 launches and segments = the plan on each rank; (e) ms
              per global step on each rank, host clock, beside the
              one-process run's and phase 22's; (f) whether gloo takes CUDA
              tensors for reduce_scatter_tensor and all_gather_into_tensor,
              each tried directly in processes of its own; (g) two-rank
              syncdp TrainJobs (ef_bf16, then fsdp; N=2, 1 epoch over phase
              23's 128 + 32 windows) against the one-process jobs: histories
              and weights (ef_bf16 bit for bit; the fsdp job, in f32, held
              as (b32): losses within 1e-4 relative, weights 99.5 % within
              1e-5 and within AdamW's bound). The tight checks of (b), (b32)
              and (g) report every miss together after (g).
  phase 25    sequence parallelism over ranks: (a) #2-#4 at the ring's
              block shapes (gpt-mini, B=8, T=512 over two ranks: blocks
              of 256, H=4, D=64, bf16; phase 7's keep-mask): the forward
              on the causal diagonal block, a visiting block and an
              all-zero keep-mask (a dropped block: m = NEG_INF, l = T_k,
              a finite out), and the backward of each fed the GLOBAL m
              and l merged from rank 1's two blocks (the dropped block's
              gradients zero), each against its plain version within the
              flash tolerance, warm times beside the plain version's,
              SDPA's and the bound; then this process's dense rounds,
              and two gloo seq ranks on the one card (one lane group,
              n_seq=2) as its children: (b) two K-avg rounds of gpt-mini
              (W=1 lane, K=2, B=8, T=512, SGD, dropout 0.1, the 4 MB
              bucketed merge; the second counted and timed) under the
              ring and under Ulysses, bf16 and f32, against the dense
              one-process rounds on the card:
              both ranks bit for bit, the weights within the reference's
              SP-vs-dense bounds in bf16 (rtol 2e-2, atol 2e-3) and
              (1e-4, 1e-5) in f32, the loss 5e-3 / 1e-5 relative; a
              rank's launches = the plan (the ring: #2, #3 and #4 each
              layers x n a local step, dropped blocks included; Ulysses
              and the dense round: layers a step; #5 once a merge);
              (c) forward_seq_parallel's logits against the dense
              forward's (2e-2 / 1e-4 of their largest magnitude); (d) a
              two-rank n_seq=2 TrainJob (ring, one lane, N=2, one epoch
              over 128 + 32 windows): equal histories, #3/#4 = the plan;
              (e) whether gloo's all_to_all_single takes CUDA tensors,
              tried directly (the port's all-to-all relies on it).
              Every miss of (b)-(d) is raised together after (d).
  phase 26    expert parallelism over ranks (gpt-moe-mini at its
              published widths, gloo ranks on the one card, started
              together while this process runs the one-process layer and
              rounds they are held to): (a) ``ep_partial_ffn`` over two
              expert ranks (4 of the 8 experts each; the [4096, 8, 640]
              dispatch of B=8, T=512, f32) against one process's
              ``moe_apply``: the ranks bit for bit, rtol = atol = 1e-4;
              (b) two K-avg rounds (one lane, K=2, B=8, T=512, SGD,
              dropout 0.1, the 4 MB bucketed merge; the second counted
              and timed) on two ranks (data 1 x expert 2), bf16 and f32,
              against the one-process rounds: both ranks bit for bit,
              the weights within (2e-2, 2e-3) in bf16 and (1e-4, 1e-5)
              in f32, the loss 5e-3 / 1e-5 relative, #2-#4 layers x
              steps and #5 one launch a merge on each rank, every
              merge's grouped #5 output equal to its plain version bit
              for bit; (c) the f32 round (two lanes) on four ranks (seq
              2 x expert 2) against four ranks (data 2 x seq 2) with
              replicated experts, within (1e-4, 1e-5), the ring's
              launches (#2-#4 layers x 2 a local step); (d) one epoch of
              `kubeml train -f gpt-moe-mini --expert-parallel 2
              --merge-bucket-mb 4` (the CLI's TrainRequest) on two ranks
              started through tools.launch_distributed: equal
              histories, #3/#4 = layers x steps and #5 one launch a
              merge; (e) ms a round a rank beside the one-process round
              and phase 21's ms per local step (not a gate). Every miss
              is raised together after (e).
  phase 27    tensor parallelism over ranks (gloo ranks on the one card,
              started together while this process runs what they are
              held to): (a) #2-#4 at the local head counts M = 2 gives
              (gpt-mini's [8, 512] causal with 2 of its 4 heads,
              bert-tiny's [32, 64] not causal with 1 of its 2; bf16, a
              padded tail and a fully padded sequence) each against its
              plain version within the flash tolerance, a second launch
              equal bit for bit, warm times beside the plain version's,
              SDPA's and the bound; gpt-mini's first block at B=8,
              T=512 over two model ranks (the Megatron layers of
              ``parallel/manual.py``) against the dense block in one
              process: the ranks bit for bit, f32 within 1e-5, bf16
              within 2e-2; (b) two K-avg rounds (one lane, K=2, SGD
              1e-2, dropout 0.1, the 4 MB bucketed merge; the second
              counted and timed) of gpt-mini (B=8, T=512) and bert-tiny
              (B=32, T=64) at (data 1 x model 2), bf16 and f32, against
              the one-process rounds: both ranks bit for bit, the
              weights within (2e-2, 2e-3) in bf16 and (1e-4, 1e-5) in
              f32, the loss 2e-2 / 1e-5 relative to max(1, |loss|),
              #2-#4 layers x steps and #5 one launch a merge on each
              rank; (c) gpt-mini's f32 round on four ranks (model 2 x
              seq 2: the flash ring on the local heads) against one
              process, the ring's launches (layers x 2 a step); one NCCL
              rank running the tensor-parallel module at M = 1 equal to
              the same round without a group bit for bit; (d) one epoch
              of `kubeml train -f gpt-mini --tensor-parallel 2
              --merge-bucket-mb 4` (the GSPMD route's plan) on two ranks
              started through tools.launch_distributed: equal
              histories, #3/#4 = layers x steps and #5 one launch a
              merge; (e) ms a round a model rank beside the one-process
              round (not a gate). Every miss is raised together after
              (e).
  phase 28    pipeline parallelism over ranks (gloo ranks on the one
              card, started together while this process runs what they
              are held to; M = 4 microbatches): (a) #2-#4 at the
              microbatch shapes (gpt-mini's [2, 512, 4, 64] causal of
              B=8, bert-tiny's [8, 64, 2, 64] not causal of B=32; bf16,
              a padded tail and a fully padded sequence) each against
              its plain version within the flash tolerance, a second
              launch equal bit for bit, warm times beside the plain
              version's, SDPA's and the bound; (b) two K-avg rounds (one
              lane, K=2, SGD 1e-2, dropout 0.1, the 4 MB bucketed merge;
              the second counted and timed) of gpt-mini (B=8, T=512) and
              bert-tiny (B=32, T=64) at (data 1 x stage 2), bf16 and
              f32, against one process's sequential schedule (the same
              microbatches and draws): both ranks bit for bit, the
              weights and the loss within 1e-6 in f32 and 2e-2 in bf16,
              #2-#4 M x L / P a step and #5 one launch a merge on each
              rank, 2 (M + P - 2) hops a step; at dropout 0 in f32
              against the dense one-process round within 1e-5; (c)
              gpt-mini's f32 round on four ranks (stage 4) against
              stage 2 and gpt-moe-mini's on (stage 2 x expert 2) against
              stage 2 with replicated experts, within 1e-6;
              forward_pipelined of gpt-moe-mini under ep_impl='alltoall'
              against 'replicated' over (stage 2 x expert 2) at capacity
              factor 8 (no expert overflows), f32 logits within 1e-5;
              one NCCL rank: gpt-mini's four blocks as one stage through
              pipeline_lane against sequential_apply, the outputs bit for
              bit; (d) one epoch of `kubeml train -f gpt-mini
              --pipeline-parallel 2 --merge-bucket-mb 4` on two ranks
              started through tools.launch_distributed: equal histories,
              #3/#4 = M x L / P x steps and #5 one launch a merge; (e) ms
              a round a stage rank beside the one-process round (not a
              gate). Every miss is raised together after (e).

Phases 1-9 run in this process. Phases 10-28 then run in three
processes side by side: 15, 16, 14 and 23 here, and two lanes of this
script (``--lane DIR``), one running 10, 17, 11, 12, 13, 18, 25 and 28
and the other 22, 24, 19, 20, 21, 26 and 27; the lanes start after phase 1 (imports,
CUDA, their gpt-mini, torch._dynamo, which torch.optim's first call
imports) and wait for the end of phase 9. Each process holds
its own launch counts, so every phase still zeroes and reads its own; a
lane pickles its phases' results for this process, which prints the
lanes' output after its own and assembles the kernels line. Those phases
mostly start child processes and wait on them, so side by side they take
about the longest process's share; their times are taken beside the
other processes' work on the card, and phases 1-9's alone. A failed lane
fails the run; a lane ends with everything it started when this process
stops it or is gone.

Prints every number beside the card's name and power limit (nvidia-smi),
then a line {"kernels": [...]} with one entry per kernel instantiation on
the main paths (bf16 pages, int8 pages: decode numbers at the top level,
the S=1 prefill call's under "prefill", launches from that page type's own
serving run; the three bf16 flash kernels at the training shape, launches
from the last training round; the fused merge over one whole gpt-mini
merge (one grouped launch; every plan's grouped rows under "plans"),
launches and
segments from the ef_int8 run, the sgd mode under "sgd"; each of
the paged kernel's entries also carry "ps_launches", phase 14's launches
through the PS for that page type; each of
the four training kernels also carries "job_launches", its launches in
each epoch of phase 10's job, "deployment_launches" those of phase
12's jobs and "cli_launches" those of phase 13's; every entry carries
"cluster_launches", its launches through phase 15's deployment (null for
int8 pages, which phase 15 does not serve), "degraded_launches", its
launches in phase 16 (0 for the paged kernel), "cost_launches", its
launches through phase 17's (a) and (c) (null for int8 pages, which phase
17 does not serve), and "continual_launches", its launches in phase 18
(null for int8 pages; the merge's over gpt-mini and ResNet-18, split in
"continual_launches_by_model"), and "spec_launches" (phase 19's two
speculative runs per page type for the paged kernel, both page types'
for the flash forward, 0 for the others) with "spec_ps_launches" (phase
19 (b)); the paged kernel's entries also carry "multi_launches", phase
19's multi-step run; every entry carries "text_launches", phase 20's:
the page-12 engine's for the paged kernel, bert-tiny's per epoch for the
flash kernels, both models' per epoch for the merge; the flash entries
carry "noncausal" (phase 20 (c)'s rows at each T) and the paged entries
"ragged_pages" (phase 20 (d)'s rows), the merge "text_buckets" (its
rows at each bucket length of both text models' plans); every entry
carries "moe_vgg_launches", phase 21's: 0 for the paged kernel,
gpt-moe-mini's per epoch for the flash kernels, both models' per epoch
for the merge, which also carries "moe_vgg_buckets" (its rows at each
bucket length of both models' plans); every entry carries
"syncdp_launches", phase 22's (0 for the paged kernel; per gradient path
per dispatch, the skipped dispatch and the job per epoch for the flash
kernels and the merge, which also carries "syncdp_segments" and
"syncdp_count1", its row at the SyncDP call; the flash entries carry
"syncdp_shapes", phase 22 (a2)'s rows at the path's shapes); every entry
carries "dist_launches", phase 23's (0 for the paged kernel; (a)'s and
(b)'s counted round per strategy, per rank for (b), and (c)'s job per
rank and in one process; the merge also "dist_segments"); every entry
carries "syncdp_dist_launches", phase 24's (0 for the paged kernel; the
counted dispatch per path, on the NCCL rank and per gloo rank, and the
two-rank jobs per rank; the merge also "syncdp_dist_segments"); every
entry carries "seq_launches", phase 25's (0 for the paged kernel; each
(b) round per rank and the dense round in one process, per dtype, and
(d)'s job per rank), and the flash entries "seq_shapes", phase 25 (a)'s
rows at the ring's block shapes; every entry carries "ep_launches",
phase 26's (0 for the paged kernel; each (b) and (c) round per rank, the
one-process rounds per dtype, (d)'s job per rank; the merge also
"ep_segments"); every entry carries "tp_launches", phase 27's (0 for the
paged kernel; each (b) and (c) round per rank, the NCCL rank's round,
the one-process rounds per model and dtype, (d)'s job per rank; the
merge also "tp_segments"), and the flash entries "tp_shapes", phase 27
(a)'s rows at the local head counts; every entry carries "pp_launches",
phase 28's (0 for the paged kernel; each (b) and (c) round per rank, the
one-process rounds, (d)'s job per rank; the merge also "pp_segments"),
and the flash entries "pp_shapes", phase 28 (a)'s rows at the microbatch
shapes; the
merge's
"resnet18"
entry carries phase 11's plan, times and launches per epoch), the
nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Exits
non-zero without a CUDA device or without the kubeml_tpu_torch package
beside it.

    python3 chip_smoke.py --flash-only
    python3 chip_smoke.py --paged-only

build the kernels and run phase 6 (phase 2) alone, printing its rows as one
JSON line and no result line: copied into another tree of the repo (a `git
archive` of another commit) the script times that tree's kernels the same
way, so two commits compare in one session.

    python3 chip_smoke.py --vision-job-only

does the same for phase 11's ResNet-18 TrainJob (its "vision_epochs"
line): the job's host path, the tracer's spans included, timed per
epoch.

    python3 chip_smoke.py --serve-only

builds the paged kernel and runs phases 3 and 14 alone (serving direct and
through the PS), printing their numbers as one JSON line.

    python3 chip_smoke.py --cluster-only

builds the kernels and runs phase 3 (bf16 pages) and phase 15 alone,
printing phase 15's launches as one JSON line.

    python3 chip_smoke.py --degraded-only

builds the flash and merge kernels and runs phase 16 alone, printing its
launches as one JSON line.

    python3 chip_smoke.py --cost-only

builds the kernels and runs phase 17 alone (without phase 10, so (a)'s
ms per local step stands alone), printing its launches as one JSON line.

    python3 chip_smoke.py --continual-only

builds the kernels and runs phase 18 alone, printing its launches as one
JSON line.

    python3 chip_smoke.py --spec-only

builds the paged and flash kernels and runs phases 3 and 19 alone,
printing phase 19's launches as one JSON line.

    python3 chip_smoke.py --text-only

builds the kernels and runs phase 20 alone, printing its launches and
rows as one JSON line.

    python3 chip_smoke.py --moe-vgg-only

builds the kernels and runs phase 21 alone, printing its launches as one
JSON line.

    python3 chip_smoke.py --syncdp-only

builds the flash and merge kernels and runs phase 22 alone, printing its
launches, ms per global step, #5's row at the SyncDP call and the job's
numbers as one JSON line.

    python3 chip_smoke.py --dist-only

builds the flash and merge kernels and runs phase 23 alone, printing its
launches, ms a round and ms per local step as one JSON line.

    python3 chip_smoke.py --syncdp-dist-only

builds the flash and merge kernels and runs phase 24 alone, printing its
launches, ms per global step, shard bytes and the gloo probes as one
JSON line.

    python3 chip_smoke.py --seq-only

builds the flash and merge kernels and runs phase 25 alone, printing its
(a) rows and launches as one JSON line.

    python3 chip_smoke.py --ep-only

builds the flash and merge kernels and runs phase 26 alone, printing its
launches as one JSON line.

    python3 chip_smoke.py --tp-only

builds the flash and merge kernels and runs phase 27 alone, printing its
(a) rows and launches as one JSON line.

    python3 chip_smoke.py --pp-only

builds the flash and merge kernels and runs phase 28 alone, printing its
(a) rows and launches as one JSON line.
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


def paged_operands(torch, rng, S, T, pages, dev, G=G, PMAX=PMAX):
    """Kernel operands at gpt-mini's serving shapes with realistic
    masking: slot s holds a context of n_s tokens on its first pages
    (spread over T+5 .. C-7 for 8 slots; PREFILL_CTX for one), table
    tails point at the null page 0, and the bias is NEG_INF past each
    query's causal position and the slot's valid prefix. ``G`` and
    ``PMAX`` default to the serving geometry's page size and table
    width."""
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
    T, G_ = q.shape[1], k_pages.shape[1]
    page_bytes = G_ * H * D * k_pages.element_size()
    distinct = int(torch.unique(tables).numel())
    nbytes = (2 * distinct * page_bytes + bias.numel() * 4
              + 2 * q.numel() * q.element_size() + tables.numel() * 4)
    if quantized:
        nbytes += 2 * distinct * 4
    ops = 4 * H * D * T * G_ * int((tables != 0).sum())
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


def paged_cold_ms(torch, rng, S, T, pages, dev, call, **geometry) -> float:
    """The kernel's time with the L2 cold: operand sets of the same shape
    and masking cycled over COLD_BYTES (as phase 9a times the merge
    kernel)."""
    sets = []
    while sum(sum(t.numel() * t.element_size() for t in s)
              for s in sets) < COLD_BYTES:
        sets.append(paged_operands(torch, rng, S, T, pages, dev,
                                   **geometry)[0])
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
    return {"launches": launches, "tokens": [r.tokens for r in reqs],
            "tokens_per_s": tokens / wall,
            "ttft_ms": 1e3 * statistics.mean(ttft)}


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


def flash_operands(torch, rng, dtype, T, dev, B=FA_B, H=FA_H):
    """q, k, v, g ~ N(0, 1) in the compute dtype and a keep-mask: sequence
    0 full, 1..B-2 ending in padding at spread lengths, B-1 fully
    padded."""
    cdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (B, T, H, FA_D)).astype(np.float32)).to(dev, cdt)
        for _ in range(4))
    lengths = np.concatenate([[T], np.linspace(T - 7, 5, B - 2)
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


def flash_cold_ms(torch, rng, dtype, T, causal, kernel, dev,
                  **shape) -> float:
    """A flash kernel's time with the L2 cold: operand sets (q, k, v and
    the mask; for the backward also g and the forward's m, l, delta)
    cycled over COLD_BYTES, as phase 9a times the merge kernel."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    fn = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
          "dQ": fa.fa_bwd_dq_kernel}[kernel]
    sets = []
    while sum(sum(t.numel() * t.element_size() for t in s[:-1])
              for s in sets) < COLD_BYTES:
        q, k, v, g, pad = flash_operands(torch, rng, dtype, T, dev, **shape)
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


MERGE_BYTES = {"avg": 8, "sgd": 12}   # per element at raw_count > 0
# every model's merge at 4 MB (the reference's plan): bucket lengths in
# flax flatten order, from the models' variable trees at their published
# widths (phases 11, 20 and 21 hold their jobs' plans to these)
MERGE_PLANS = {
    "gpt-mini": MERGE_BUCKETS,
    "resnet18": (979072, 624128, 589824, 591872, 1179648, 2359296, 134144,
                 2359296, 2359296, 6986),
    "gpt-moe-mini": (75520, 1048576, 1048576, 272384, 1048576, 1048576,
                     272384, 1048576, 1048576, 272384, 1048576, 1048576,
                     328448, 2097152),
    "vgg11": (961408, 1179648, 512, 2359296, 512, 2359296, 512, 2359296,
              4096, 2097152, 4096, 16777216, 409700),
    "bert-tiny": (413442, 3906816),
    "lstm": (1028, 4096000, 919552),
}


class MergeSegments:
    """The fused merge's segment count (buckets merged) under a kernel's
    ``launches`` name, so a phase's loop over its kernels zeroes and reads
    it with the launch counts."""

    @property
    def launches(self) -> int:
        from kubeml_tpu_torch.ops import fused_merge as fm
        return fm.fused_merge_kernel.segments

    @launches.setter
    def launches(self, n: int) -> None:
        from kubeml_tpu_torch.ops import fused_merge as fm
        fm.fused_merge_kernel.segments = n


def merge_counts(buckets: int, merges: int) -> dict:
    """The fused merge's counts over ``merges`` merges of a plan of
    ``buckets`` buckets: one launch per MAX_SEGMENTS buckets of a merge,
    every bucket one segment."""
    from kubeml_tpu_torch.ops.fused_merge import MAX_SEGMENTS

    return {"fused_merge": merges * -(-buckets // MAX_SEGMENTS),
            "merge segments": buckets * merges}


def merge_count_now() -> dict:
    """The fused merge's two counts as they stand."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    return {"fused_merge": fm.fused_merge_kernel.launches,
            "merge segments": fm.fused_merge_kernel.segments}


def merge_count_zero() -> None:
    from kubeml_tpu_torch.ops import fused_merge as fm

    fm.fused_merge_kernel.launches = fm.fused_merge_kernel.segments = 0


def merge_bound(n: int, mode: str) -> float:
    """Least time (ms) of one merge-apply over n elements at raw_count > 0,
    as every timed call runs: the bytes the function must move over the
    memory rate. avg reads s and writes out, 8 bytes an element (ref is
    the output only at raw_count 0, where s is not needed); sgd reads s
    and ref and writes out, 12. Its 1-3 flops an element are nothing
    beside that."""
    return MERGE_BYTES[mode] * n / H100_BYTES_PER_S * 1e3


def merge_sass_loads(card) -> dict:
    """The built fused merge's global loads, stores and bulk copies per
    kernel, counted in its SASS (``cuobjdump -sass``): LDG / STG are the
    loads of count and raw_count and the register path's (and the
    st.global.cs stores), UBLKCP the TMA bulk loads. Logged, not held:
    the bound is the function's, whatever the compiler makes of the
    kernel."""
    import re
    import shutil

    from kubeml_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run(
            [tool, "-sass", str(_build.library_path("fused_merge"))],
            capture_output=True, text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(card, f"fused_merge SASS: cuobjdump failed ({e})")
        return {}
    counts = {}
    for block in sass.split("Function : ")[1:]:
        m = re.search(r"fused_merge_kernelILi(\d)E", block.split()[0])
        if m is None:
            continue
        counts[('avg', 'sgd')[int(m[1])]] = tuple(
            len(re.findall(pat, block))
            for pat in (r"\bLDG\.", r"\bSTG\.", r"\bUBLKCP\b"))
    log(card, "fused_merge SASS (cuobjdump), LDG/STG/UBLKCP per kernel: "
        + ", ".join(f"{k} {'/'.join(map(str, v))}"
                    for k, v in sorted(counts.items())))
    return counts


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
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    rows = merge_kernel_rows(torch, card, gen, MERGE_BUCKETS + MERGE_RAGGED,
                             cold=MERGE_BUCKETS)
    return {"lengths": rows, "plans": merge_group_rows(torch, card, gen)}


def host_us(torch, fn, calls: int = 30) -> float:
    """Host microseconds of one eager call of fn (the Python wrappers and
    their launches, with the device idle at each start): the median over
    ``calls``, each followed by a synchronize outside the timed span."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def merge_group_rows(torch, card, gen):
    """Phase 9 (a2): the grouped launch (every bucket of a merge in one
    launch) at each model's 4 MB plan. Bit for bit against the plain
    version in both modes, at raw_count 3 and 0 (a NaN in every s; the
    output must be ref); then, avg at raw_count 3, warm and L2-cold times,
    the plain version's and the 8 B bound. Rows by model."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    dev = torch.device("cuda")
    nan = float("nan")

    def operands(lengths):
        return [(torch.randn(n, device=dev, generator=gen) * 7,
                 torch.randn(n, device=dev, generator=gen)) for n in lengths]

    rows = {}
    for name, lengths in MERGE_PLANS.items():
        pairs = operands(lengths)
        nan_pairs = [(s.clone().index_fill_(0, torch.tensor(
            [s.numel() // 2], device=dev), nan), r) for s, r in pairs]
        for mode, lr in (("avg", 0.0), ("sgd", MERGE_SGD_LR)):
            for raw in (3.0, 0.0):
                raw_t = torch.tensor(raw, device=dev)
                cnt = raw_t.clamp_min(1.0)
                src = pairs if raw > 0 else nan_pairs
                got = fm.fused_merge_apply(mode, src, cnt, raw_t, lr)
                torch.cuda.synchronize()
                for (s, r), out in zip(src, got):
                    want = fm._apply_plain(mode, s, r, cnt, raw_t, lr)
                    assert torch.equal(out, want), (name, mode, raw,
                                                    s.numel())
                    if raw == 0:
                        assert torch.equal(out, r), (name, mode)
        raw_t = torch.tensor(3.0, device=dev)
        cnt = raw_t.clamp_min(1.0)
        total = sum(lengths)

        def grouped(ps):
            return fm.fused_merge_apply("avg", ps, cnt, raw_t)

        sets = [(pairs,)] + [(operands(lengths),) for _ in range(
            max(2, -(-int(COLD_BYTES) // (8 * total))) - 1)]
        row = dict(buckets=len(lengths), elements=total, max_abs_err=0.0,
                   ms=time_ms(torch, lambda: grouped(pairs)),
                   cold_ms=time_ms_cold(torch, grouped, sets),
                   plain_ms=time_ms(torch, lambda: [
                       fm._apply_plain("avg", s, r, cnt, raw_t, 0.0)
                       for s, r in pairs]),
                   bound_ms=merge_bound(total, "avg"))
        del sets
        log(card, f"fused_merge grouped, {name}'s {MERGE_CAP_MB:g} MB plan ("
            f"{len(lengths)} buckets, {total} f32 elements, one launch): "
            f"{row['ms']:.4f} ms (L2 cold {row['cold_ms']:.4f}); plain "
            f"{row['plain_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms (8 B "
            f"an element): L2 cold {row['cold_ms'] / row['bound_ms']:.2f}x "
            f"the bound; == plain bit for bit (avg and sgd, raw_count 3 "
            f"and 0)")
        rows[name] = row
    return rows


def merge_kernel_rows(torch, card, gen, lengths, cold, label="fused_merge",
                      timed=("avg", "sgd")):
    """Phase 9 (a)'s check and times at each of ``lengths`` (each once),
    L2-cold times at those in ``cold``; rows by length and mode. Both
    modes are checked; the modes in ``timed`` are timed."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    dev = torch.device("cuda")
    rows = {}
    for n in dict.fromkeys(lengths):                      # each length once
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
            if mode not in timed:
                log(card, f"{label} {mode} N={n}: kernel == plain bit for "
                    f"bit (raw_count 3 and 0)")
                continue
            raw_t = torch.tensor(3.0, device=dev)
            cnt = raw_t.clamp_min(1.0)
            ms = time_ms(torch, lambda: fm.fused_merge_kernel(
                mode, s, ref, cnt, raw_t, lr))
            plain_ms = time_ms(torch, lambda: fm._apply_plain(
                mode, s, ref, cnt, raw_t, lr))
            entry = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=merge_bound(n, mode))
            if n in cold:
                sets = [(torch.randn(n, device=dev, generator=gen),
                         torch.randn(n, device=dev, generator=gen))
                        for _ in range(max(2, -(-int(COLD_BYTES)
                                                // (8 * n))))]
                entry["cold_ms"] = time_ms_cold(
                    torch, lambda a, b: fm.fused_merge_kernel(
                        mode, a, b, cnt, raw_t, lr), sets)
                del sets
            row[mode] = entry
            log(card, f"{label} {mode} N={n}: kernel {ms:.4f} ms"
                + (f" (L2 cold {entry['cold_ms']:.4f} ms)"
                   if "cold_ms" in entry else "")
                + f", plain {plain_ms:.4f} ms, bound "
                f"{entry['bound_ms']:.5f} ms (bytes, {MERGE_BYTES[mode]} B "
                f"an element), {ms / entry['bound_ms']:.2f}x bound; kernel == "
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
    4 MB, ef_bf16, ef_int8); the merge kernel's counts (3 launches of 5
    segments), the flash launches, falling loss, finite residuals, a dead
    lane's zeroed residual; and the first bucketed round's contributions
    merged by MonolithicMerge and by BucketedMerge(4 MB) on the card,
    equal bit for bit."""
    from kubeml_tpu_torch.ops import flash_attention as fa
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
        merge_count_zero()                   # the main path's run starts
        for fn in flash:
            fn.launches = 0
        t0 = time.perf_counter()
        state, st = engine.train_rounds(state, *args, TRAIN_LR, 0)
        loss_sum = st.loss_sum
        wall = time.perf_counter() - t0
        n = merge_count_now()                # ... and ends here
        flash_n = [fn.launches for fn in flash]
        n_buckets = engine.merge_comm_proxy(state)["buckets_per_round"]
        assert n_buckets == len(MERGE_BUCKETS), n_buckets
        assert n == merge_counts(n_buckets, MERGE_R), (name, n)
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
            f"{n['fused_merge']} launches of {n['merge segments']} segments "
            f"(= {n_buckets} buckets x {MERGE_R} rounds), flash launches "
            f"{flash_n}" + msg)
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
                f"BucketedMerge({MERGE_CAP_MB:g} MB, one grouped fused "
                f"launch) are equal bit for bit")
            del calls[:]
    return launches, engines


def phase_merge_check(torch, card, seed):
    """(d) gpt-nano in f32, ef_int8, n_lanes=2: one round on the card
    (kernels, one merge launch for its buckets) and on the CPU (plain
    versions) merge to the same parameters within AdamW's bound plus one
    int8 quantum of the bucket, 99.5 % of the elements within 1e-5."""
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
        merge_count_zero()
        out[dev] = engine.train_round(state, *args, TRAIN_LR, 0)
        n_buckets = engine.merge_comm_proxy(state)["buckets_per_round"]
        launched = merge_count_now()
        assert launched == (merge_counts(n_buckets, 1) if dev == "cuda"
                            else merge_counts(0, 0)), launched
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


def _profiled_round(torch, engine, state, args, lr):
    """One engine round under torch.profiler (CUDA activity only) after a
    warm one: (wall ms, {kernel: (device ms, calls)})."""
    from torch.profiler import ProfilerActivity, profile

    engine.train_round(state, *args, lr, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_round(state, *args, lr, 0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return wall_ms, device_events(torch, prof)


def _log_profile(card, label, wall_ms, by_name, steps):
    """Busy and idle share of a profiled round and its top consumers;
    returns the device busy ms (None when nothing was recorded)."""
    if not by_name:
        log(card, f"{label}: device time not measured (the profiler "
            "recorded no CUDA activity)")
        return None
    busy = sum(t for t, _ in by_name.values())
    calls = sum(n for _, n in by_name.values())
    log(card, f"{label}: wall {wall_ms:.3f} ms = {wall_ms / steps:.3f} ms "
        f"per local step, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.2f}%), idle "
        f"{100 * (1 - busy / wall_ms):.2f}%; {calls} device activities "
        f"({calls / steps:.1f} per local step)")
    for kname, (t, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        log(card, f"{label} top device time: {t:.3f} ms "
            f"({100 * t / busy:.2f}%) over {n} calls: {kname[:90]}")
    return busy


def event_ms(torch, fn, calls: int = 10) -> float:
    """Device ms of one eager call of fn (CUDA events around `calls`
    calls after a warm one): for calls whose kernels run long beside
    their launches, and for autograd, which a graph capture refuses."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


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
    returns the per-epoch kernel launches of the job's run and its ms per
    local step by epoch."""
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
            launches, job_ms = job_run(torch, card, seed, engine_ms)
            job_check(torch, card, seed)
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home
    return launches, job_ms


def _epoch_counts(parallelism, eval_workers, n_train=JOB_TRAIN,
                  n_test=JOB_TEST, k=None, batch=None):
    """What one epoch of the job must launch, from the JAX package's
    epoch plan (ported in data/sharding.py): (real local steps, rounds,
    eval steps = every (worker, step) slot of the eval batches). K and B
    default to phase 10's."""
    from kubeml_tpu_torch.data.sharding import plan_epoch

    k, batch = k or JOB_K, batch or JOB_B
    plan = plan_epoch(n_train, parallelism, k, batch)
    test = plan_epoch(n_test, eval_workers, -1, batch)
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
               "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
               "merge segments": MergeSegments()}

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
                "dQ": layers * steps, **merge_counts(JOB_BUCKETS, rounds)}
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
    return launches, job_ms


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


def phase_vision(torch, card, seed, job_only=False):
    """ResNet-18 on the card (see the module docstring, phase 11); returns
    the merge's ResNet-18 launches per epoch. job_only runs (a), the
    job, alone."""
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
            if job_only:
                return launches
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
    merge kernel's counts, which must be buckets x rounds of the plan in
    one launch a round."""
    from kubeml_tpu_torch.data.sharding import plan_epoch
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    plan = plan_epoch(CIFAR_TRAIN, VIS_N, VIS_K, VIS_B)
    steps, rounds = plan.total_steps, len(plan.rounds)
    lengths = tuple(b.length for b in resnet18_plan().buckets)
    assert lengths == MERGE_PLANS["resnet18"], lengths
    buckets = len(lengths)
    rows = []

    def run(job_id, epochs, mode, resume_from=""):
        epochs_seen = []

        def publish(m):
            # the epoch's run (training and its validation) ends here
            epochs_seen.append((m, merge_count_now()))
            merge_count_zero()                   # ... and the next starts

        job = TrainJob(vision_task(job_id, epochs, device_cache=mode,
                                   resume_from=resume_from),
                       get_model("resnet18")(), cifar_dataset(),
                       device="cuda",
                       callbacks=JobCallbacks(publish_metrics=publish))
        merge_count_zero()                       # the main path's run starts
        hist = job.train().data
        for e, (m, n) in enumerate(epochs_seen):
            sec = hist.epoch_duration[e]
            ph = {k: sum(v) for k, v in m.phase_times.items()}
            assert n == merge_counts(buckets, rounds), (n, buckets, rounds)
            row = dict(cache=mode, epoch=e + 1, wall_s=sec,
                       samples_per_s=CIFAR_TRAIN / sec,
                       ms_per_step=1e3 * sec / steps,
                       launches=n["fused_merge"],
                       segments=n["merge segments"],
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
                f"{ph['merge_wait']:.4f} s; fused_merge "
                f"{n['fused_merge']} launches of {n['merge segments']} "
                f"segments (= {buckets} buckets x {rounds} rounds); peak "
                f"device memory {m.hbm_peak_bytes / 2**20:.1f} MiB")
        assert all(np.isfinite(hist.validation_loss)), hist.validation_loss
        return job, hist, [n["fused_merge"] for _, n in epochs_seen]

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
    per-epoch launches of the gpt-mini job, both through the deployment,
    and what phase 13 holds its CLI job against (the ResNet-18 job's
    checkpoint, train loss and ms per local step)."""
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
    from kubeml_tpu_torch.train.checkpoint import _flatten, load_checkpoint

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
        cli_ref = {"checkpoint": _flatten(load_checkpoint(job_id)[0]),
                   "train_loss": client.histories().get(
                       job_id).data.train_loss[0],
                   "ms_per_step": row["deployment"]["ms_per_step"]}
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
    return resnet_launches, gpt_launches, cli_ref


def control_resnet(torch, card, seed, tmp, dep, client):
    """(a): phase 11's dataset uploaded as four .npy files, resnet18
    submitted through the controller, against a direct TrainJob."""
    import os
    import urllib.request

    from kubeml_tpu_torch.data.sharding import plan_epoch
    from kubeml_tpu_torch.models import get_model
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
        merge_count_zero()                      # the main path's run starts
        t0 = time.perf_counter()
        job_id = client.networks().train(req)
        hist = cp_wait(client, dep, job_id)
        wall = time.perf_counter() - t0
        counts = merge_count_now()
    finally:
        restore()
        unhook()
    assert counts == merge_counts(buckets, rounds), (counts, buckets, rounds)
    launches = counts["fused_merge"]
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
        f"%; fused_merge {launches} launches of {counts['merge segments']} "
        f"segments (= {buckets} buckets x {rounds} rounds); /metrics "
        f"showed the job's families at its epoch's publish: {scraped[0]}, "
        f"none after the finish: {cleared}")

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
               "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
               "merge segments": MergeSegments()}
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
                "dQ": layers * steps, **merge_counts(JOB_BUCKETS, rounds)}
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


# ----------------------------------------------------------------- phase 13
CLI_EPOCHS = 3      # epoch 1 is held against phase 12's job; the live
                    # verdict is read while the later epochs run
CLI_INFER_N = 64
# The deployment child: `python -m kubeml_tpu_torch.cli serve --role all
# --free-ports` run through runpy under phase 12's numerics (cudnn
# deterministic, no TF32), with a wrapper on the PS's in-process publish
# that appends each epoch's kernel launches to the file named by argv[1]
# and zeroes the counts: the launches happen in the child, where this
# script cannot read them.
CLI_SERVE = r'''
import json, runpy, sys
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from kubeml_tpu_torch.control.ps import ParameterServer
from kubeml_tpu_torch.ops import flash_attention as fa, fused_merge as fm
class Segments:      # the merge's segment count as a `launches` counter
    launches = property(
        lambda self: fm.fused_merge_kernel.segments,
        lambda self, n: setattr(fm.fused_merge_kernel, "segments", n))
KERNELS = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
           "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
           "merge segments": Segments()}
counts, real = sys.argv[1], ParameterServer._publish_metrics
def publish(self, m):
    real(self, m)
    with open(counts, "a") as f:
        f.write(json.dumps({"job": m.job_id, **{
            k: fn.launches for k, fn in KERNELS.items()}}) + "\n")
    for fn in KERNELS.values():
        fn.launches = 0
ParameterServer._publish_metrics = publish
sys.argv = ["kubeml", "serve", "--role", "all", "--free-ports"]
runpy.run_module("kubeml_tpu_torch.cli", run_name="__main__",
                 alter_sys=True)
'''


def phase_cli(torch, card, seed, ref):
    """The kubeml CLI on the card (see the module docstring, phase 13);
    ref is phase 12's ResNet-18 job (its checkpoint, history and ms per
    local step). Returns the per-epoch launches of the CLI's jobs."""
    import os
    import tempfile

    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "home")
        try:
            return cli_run(torch, card, seed, ref, tmp)
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home


class CliProcesses:
    """The deployment child and the CLI processes that drive it, each
    timed from spawn to exit."""

    def __init__(self, card, tmp):
        import os

        self.card = card
        self.counts = os.path.join(tmp, "launches.jsonl")
        repo = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=repo + os.pathsep
                        + os.environ.get("PYTHONPATH", ""))
        self.env.pop("KUBEML_CONTROLLER_URL", None)
        self.cwd = repo
        self.walls = []
        self.url = None
        t0 = time.perf_counter()
        self.server = subprocess.Popen(
            [sys.executable, "-c", CLI_SERVE, self.counts], env=self.env,
            cwd=repo, stdout=subprocess.PIPE, text=True)
        line = self.server.stdout.readline()   # "controller: URL"
        if not line.startswith("controller:"):
            self.stop()
            raise RuntimeError(f"the serve child printed {line!r} "
                               f"(rc {self.server.poll()})")
        self.url = line.split()[-1]
        self.ready_s = time.perf_counter() - t0

    def spawn(self, *argv) -> subprocess.Popen:
        p = subprocess.Popen(
            [sys.executable, "-m", "kubeml_tpu_torch.cli", "--controller",
             self.url, *argv], env=self.env, cwd=self.cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        p.t0, p.argv = time.perf_counter(), argv
        return p

    def finish(self, p, timeout=600.0) -> str:
        out, err = p.communicate(timeout=timeout)
        self.walls.append((" ".join(p.argv[:2]), time.perf_counter() - p.t0))
        if p.returncode != 0:
            raise RuntimeError(f"kubeml {' '.join(p.argv)} exited "
                               f"{p.returncode}: {err.strip()[-2000:]}")
        return out

    def run(self, *argv, timeout=600.0) -> str:
        return self.finish(self.spawn(*argv), timeout)

    def launches(self, job_id):
        with open(self.counts) as f:
            rows = [json.loads(line) for line in f]
        return [{k: v for k, v in r.items() if k != "job"}
                for r in rows if r["job"] == job_id]

    def stop(self):
        import signal

        if self.server.poll() is None:
            self.server.send_signal(signal.SIGTERM)   # stops its services
            try:
                self.server.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.server.kill()
                self.server.wait()


def cli_wait(cli, job_id, timeout=900.0):
    """Poll the controller's task list until the job has left it (its
    history saved, its health window and series cleared)."""
    from kubeml_tpu_torch.control.httpd import http_json

    deadline = time.perf_counter() + timeout
    while any(t["job_id"] == job_id
              for t in http_json("GET", f"{cli.url}/tasks")):
        assert time.perf_counter() < deadline, f"job {job_id} never ended"
        time.sleep(0.2)
    http_json("GET", f"{cli.url}/history/{job_id}")   # 404: it failed


def read_manifest(job_id):
    """The job's checkpoint manifest, or None while there is none."""
    import os

    from kubeml_tpu_torch.api.const import kubeml_home

    try:
        with open(os.path.join(kubeml_home(), "models", job_id,
                               "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def cli_run(torch, card, seed, ref, tmp):
    import os

    for name, src in CP_FUNCTIONS.items():
        with open(os.path.join(tmp, f"{name}.py"), "w") as f:
            f.write(src)
    rng = np.random.default_rng(seed + 14)        # phase 11's images
    paths = {}
    for split, n in (("train", CIFAR_TRAIN), ("test", CIFAR_TEST)):
        x, y = cifar_arrays(rng, n)
        for which, arr in (("x", x), ("y", y)):
            paths[f"{which}{split}"] = os.path.join(tmp, f"{which}_{split}.npy")
            np.save(paths[f"{which}{split}"], arr)
    infer_x = (x[:CLI_INFER_N].astype(np.float32) / 255.0)
    paths["infer"] = os.path.join(tmp, "infer.npy")
    np.save(paths["infer"], infer_x)
    cli = CliProcesses(card, tmp)
    try:
        log(card, f"cli serve: `python -m kubeml_tpu_torch.cli serve --role "
            f"all --free-ports` (a child on the card) printed its "
            f"controller {cli.url} {cli.ready_s:.3f} s after spawn")
        cold = cli.run("fn", "list")
        assert "resnet18" in cold, cold
        cold_s = cli.walls[-1][1]
        cli.run("fn", "create", "-n", CP_RESNET_FN, "--code",
                os.path.join(tmp, f"{CP_RESNET_FN}.py"))
        out = cli.run("dataset", "create", "-n", "cifar", "--traindata",
                      paths["xtrain"], "--trainlabels", paths["ytrain"],
                      "--testdata", paths["xtest"], "--testlabels",
                      paths["ytest"])
        assert f"train={CIFAR_TRAIN}, test={CIFAR_TEST}" in out, out
        upload_s = cli.walls[-1][1]
        upload_mib = sum(os.path.getsize(paths[k]) for k in (
            "xtrain", "ytrain", "xtest", "ytest")) / 2**20
        row = cli_resnet(torch, card, cli, ref, paths)
        gpt = cli_gpt(card, cli, seed, tmp)
    finally:
        cli.stop()
    walls = [w for _, w in cli.walls]
    row.update(child_ready_s=cli.ready_s, cold_start_s=cold_s,
               upload_s=upload_s, upload_mib=upload_mib,
               cli_calls=len(walls),
               cli_wall_s={"min": min(walls), "median":
                           statistics.median(walls), "max": max(walls)},
               gpt_launches=gpt)
    log(card, f"cli processes: {len(walls)} calls of `python -m "
        f"kubeml_tpu_torch.cli`, each from spawn to exit: cold start "
        f"(`fn list`) {cold_s:.3f} s; min {min(walls):.3f} s, median "
        f"{statistics.median(walls):.3f} s, max {max(walls):.3f} s "
        f"(`dataset create` of {upload_mib:.1f} MiB {upload_s:.3f} s); the "
        f"serve child "
        f"stopped with rc {cli.server.returncode}")
    print(json.dumps({"cli": row}), flush=True)
    return row


def cli_resnet(torch, card, cli, ref, paths):
    """(a)-(c): ResNet-18 submitted by `kubeml train`, its epoch-1
    checkpoint against phase 12's job, the live verdict through `health`
    and `top`, then `task list`, `history get`, `logs`, `trace --out`
    and `infer`."""
    import os

    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.data.sharding import plan_epoch
    from kubeml_tpu_torch.train.checkpoint import _flatten, load_checkpoint
    from kubeml_tpu_torch.train.functionlib import FunctionRegistry

    plan = plan_epoch(CIFAR_TRAIN, VIS_N, VIS_K, VIS_B)
    steps, rounds = plan.total_steps, len(plan.rounds)
    buckets = resnet18_plan().n_buckets
    job_id = cli.run("train", "-f", CP_RESNET_FN, "-d", "cifar", "-e",
                     str(CLI_EPOCHS), "-b", str(VIS_B), "--lr", str(VIS_LR),
                     "-K", str(VIS_K), "-p", str(VIS_N), "--static",
                     "--merge-bucket-mb", str(VIS_BUCKET_MB)).strip()
    t0 = time.perf_counter()

    # (a) the epoch-1 checkpoint, read while epoch 2 runs
    deadline = t0 + 900
    while (read_manifest(job_id) or {}).get("epoch") is None:
        assert time.perf_counter() < deadline, "no epoch-1 checkpoint"
        time.sleep(0.05)
    tree, manifest = load_checkpoint(job_id)
    assert manifest["epoch"] == 1, \
        f"read the checkpoint of epoch {manifest['epoch']}, not epoch 1"
    got = _flatten(tree)
    equal = got.keys() == ref["checkpoint"].keys() and all(
        np.array_equal(got[k], ref["checkpoint"][k]) for k in got)
    assert equal, "the CLI job's epoch-1 checkpoint differs from phase 12's"
    loss1 = manifest["history"]["train_loss"][0]
    assert loss1 == ref["train_loss"], (loss1, ref["train_loss"])

    # (b) a live healthy verdict (epoch 1 of a cold child may read as a
    # straggler: its first round pays the process's first cuDNN use)
    while http_json("GET", f"{cli.url}/health/{job_id}")["state"] != \
            "healthy":
        assert time.perf_counter() < deadline, "no healthy verdict"
        time.sleep(0.05)
    live = [cli.spawn("health", "--id", job_id),
            cli.spawn("top", "--id", job_id, "--iterations", "1"),
            cli.spawn("task", "list")]
    health, top, tasks = (cli.finish(p) for p in live)
    verdict = json.loads(health)
    assert verdict["id"] == job_id and verdict["state"] == "healthy", health
    assert f"job {job_id}  state=healthy  N={VIS_N}" in top, top
    assert "WORKER" in top and "dispatch: n=" in top, top
    row_line = [ln for ln in tasks.splitlines() if ln.startswith(job_id)]
    assert row_line and "running" in row_line[0], tasks
    log(card, f"cli live verdict of job {job_id} ({CLI_EPOCHS} epochs): "
        f"`kubeml health` {verdict['state']}, "
        f"{len(verdict['latest'].get('grad_norms', []))} worker grad norms; "
        f"`kubeml top --iterations 1`: {top.splitlines()[0]!r}; "
        f"`kubeml task list`: {' '.join(row_line[0].split())!r}")
    for ln in top.splitlines()[1:]:
        log(card, f"cli top | {ln}")

    cli_wait(cli, job_id)
    wall = time.perf_counter() - t0
    hist = json.loads(cli.run("history", "get", "--id", job_id))["data"]
    assert len(hist["train_loss"]) == CLI_EPOCHS, hist
    assert hist["train_loss"][0] == ref["train_loss"]
    assert hist["train_loss"][-1] < hist["train_loss"][0], hist
    launches = cli.launches(job_id)
    per_epoch = [c["fused_merge"] for c in launches]
    planned = merge_counts(buckets, rounds)
    assert len(launches) == CLI_EPOCHS and all(
        c[k] == planned.get(k, 0) for c in launches for k in c), launches
    assert http_json("GET", f"{cli.url}/health/{job_id}")["state"] == \
        "unknown"

    logs = cli.run("logs", "--id", job_id)
    lines = [ln for ln in logs.splitlines() if " loss=" in ln]
    assert len(lines) == CLI_EPOCHS and all(
        f"epoch {e + 1}/{CLI_EPOCHS}" in lines[e] and "dispatch=" in lines[e]
        and "merge_wait=" in lines[e] for e in range(CLI_EPOCHS)), logs
    out = os.path.join(os.path.dirname(paths["infer"]), "trace.json")
    said = cli.run("trace", "--id", job_id, "-o", out)
    with open(out) as f:
        doc = json.load(f)
    meta = doc["metadata"]
    sources = sorted(s.split("-")[0] for s in meta["sources"])
    assert sources == ["client", "job", "ps", "scheduler"], meta
    assert len(meta["trace_ids"]) == 1 and meta["dropped_events"] == 0
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert all(e["args"].get("trace_id") == meta["trace_ids"][0]
               for e in spans)
    dispatch = [e["dur"] for e in spans if e["name"] == "dispatch"]
    assert len(dispatch) == CLI_EPOCHS * rounds, len(dispatch)

    preds = json.loads(cli.run("infer", "-n", job_id, "--datafile",
                               paths["infer"]))
    model = FunctionRegistry().resolve(CP_RESNET_FN)[0]()
    module = model.module_from_flax(load_checkpoint(job_id)[0],
                                    device="cuda")
    module.eval()
    want = model.infer(module, np.asarray(np.load(paths["infer"]).tolist()))
    assert preds == want.tolist(), (preds, want)

    ms = [1e3 * s / steps for s in hist["epoch_duration"]]
    warm = statistics.median(ms[1:])
    log(card, f"cli resnet18 job {job_id} through `kubeml train` ({VIS_B}x"
        f"{VIS_K}, N={VIS_N}, lr {VIS_LR}, 4 MB buckets, train stats on): "
        f"epoch-1 checkpoint equal bit for bit to phase 12's deployment job "
        f"(train loss {loss1!r} both); train loss "
        f"{[round(x, 4) for x in hist['train_loss']]}; ms per local step by "
        f"epoch {[round(x, 3) for x in ms]} (epoch 1 in a cold process); "
        f"warm median {warm:.3f} ms against phase 12's "
        f"{ref['ms_per_step']:.3f} ms = {warm / ref['ms_per_step']:.4f}x; "
        f"fused_merge launches per epoch {per_epoch} of "
        f"{planned['merge segments']} segments each (= {buckets} buckets x "
        f"{rounds} rounds); submit -> history {wall:.3f} s; unknown after "
        f"the finish; `kubeml logs` printed {len(lines)} epoch lines; "
        f"`kubeml trace --out`: {said.strip()!r}; {len(spans)} spans, "
        f"dispatch spans mean {np.mean(dispatch) / 1e3:.3f} ms; `kubeml "
        f"infer` of {CLI_INFER_N} images equals the model's infer on the "
        f"checkpoint")
    return {"job": job_id, "ms_per_step": ms, "warm_ms_per_step": warm,
            "phase12_ms_per_step": ref["ms_per_step"],
            "warm_over_phase12": warm / ref["ms_per_step"],
            "samples_per_s": [CIFAR_TRAIN / s
                              for s in hist["epoch_duration"]],
            "launches": per_epoch, "trace_sources": meta["sources"],
            "submit_to_history_s": wall}


def cli_gpt(card, cli, seed, tmp):
    """(d): phase 10's token windows and gpt-mini for one epoch at a static
    N=2 through `kubeml train`: the launches of the epoch are the plan."""
    import os

    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    rng = np.random.default_rng(seed + 12)        # phase 10's windows
    arrays = (token_windows(rng, JOB_TRAIN, TRAIN_T),
              np.zeros(JOB_TRAIN, np.int32),
              token_windows(rng, JOB_TEST, TRAIN_T),
              np.zeros(JOB_TEST, np.int32))
    paths = []
    for name, arr in zip(("xtr", "ytr", "xte", "yte"), arrays):
        paths.append(os.path.join(tmp, f"tok_{name}.npy"))
        np.save(paths[-1], arr)
    cli.run("fn", "create", "-n", CP_GPT_FN, "--code",
            os.path.join(tmp, f"{CP_GPT_FN}.py"))
    cli.run("dataset", "create", "-n", "tokens", "--traindata", paths[0],
            "--trainlabels", paths[1], "--testdata", paths[2],
            "--testlabels", paths[3])
    job_id = cli.run("train", "-f", CP_GPT_FN, "-d", "tokens", "-e", "1",
                     "-b", str(JOB_B), "--lr", str(JOB_LR), "-K", str(JOB_K),
                     "-p", str(JOB_N0), "--static", "--merge-bucket-mb",
                     str(MERGE_CAP_MB)).strip()
    cli_wait(cli, job_id)
    hist = json.loads(cli.run("history", "get", "--id", job_id))["data"]
    layers = GPT_CONFIGS["gpt-mini"]["layers"]
    steps, rounds, evals = _epoch_counts(JOB_N0, JOB_N0)
    want = {"forward": layers * (steps + evals), "dK/dV": layers * steps,
            "dQ": layers * steps, **merge_counts(JOB_BUCKETS, rounds)}
    launches = cli.launches(job_id)
    assert launches == [want], (launches, want)
    sec = hist["epoch_duration"][0]
    log(card, f"cli gpt-mini job {job_id} through `kubeml train` (N="
        f"{JOB_N0} static, B={JOB_B}, K={JOB_K}): train loss "
        f"{hist['train_loss'][0]:.4f}, {steps} local steps in {rounds} "
        f"rounds, epoch {sec:.4f} s = {1e3 * sec / steps:.3f} ms per local "
        f"step; launches {launches[0]} (= {layers} layers x {steps} steps "
        f"(+ {evals} eval steps), {JOB_BUCKETS} buckets x {rounds} rounds)")
    return launches


# ----------------------------------------------------------------- phase 14
PS_MODEL = "gpt-mini"
HOLD_TOKENS = 400        # a held stream's budget (saturation, hot-swap)
HOLD_PROMPT = 100        # the queued holders' prompt: the shed backlog
SWAP_SEED = 7            # the second checkpoint's weights: seed + 7


class GenStream:
    """One streaming POST /generate on its own connection, read on a
    thread: the status, the trace id header, the tokens of the ndjson
    lines, the terminal line, and the client-side time to the first token
    line. close() drops the connection (a client disconnect)."""

    def __init__(self, url, body):
        import http.client
        import threading

        host, port = url.split("//")[1].split(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=600)
        self.body = body
        self.tokens, self.last, self.status = [], None, None
        self.trace_id = self.retry_after = self.ttft = self.t_done = None
        self.first = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def _run(self):
        import http.client

        t0 = time.perf_counter()
        try:
            self.conn.request("POST", "/generate", json.dumps(self.body),
                              {"Content-Type": "application/json"})
            resp = self.conn.getresponse()
            self.status = resp.status
            self.trace_id = resp.getheader("X-KubeML-Trace-Id")
            self.retry_after = resp.getheader("Retry-After")
            if resp.status != 200:
                self.last = json.loads(resp.read())
                return
            for line in resp:
                ev = json.loads(line)
                if "token" in ev:
                    if self.ttft is None:
                        self.ttft = time.perf_counter() - t0
                        self.first.set()
                    self.tokens.append(ev["token"])
                else:
                    self.last = ev
        except (OSError, http.client.HTTPException):
            pass                  # shut down by close(): the client left
        finally:
            self.t_done = time.perf_counter()
            self.first.set()
            self.conn.close()

    def join(self, timeout=600.0):
        self.thread.join(timeout)
        assert not self.thread.is_alive(), "a /generate stream hung"
        return self

    def close(self):
        import socket

        sock = self.conn.sock
        if sock is not None:
            sock.shutdown(socket.SHUT_RDWR)


def gen_body(prompt, n, **extra):
    return {"model_id": PS_MODEL, "prompt": list(prompt),
            "max_new_tokens": n, **extra}


def wait_until(pred, what, timeout=120.0):
    deadline = time.perf_counter() + timeout
    while not pred():
        assert time.perf_counter() < deadline, f"timed out waiting: {what}"
        time.sleep(0.002)


def save_mini(seed):
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint(PS_MODEL, {"params": random_flax_params(
        **GPT_CONFIGS[PS_MODEL], seed=seed)},
        {"model": PS_MODEL, "function": PS_MODEL})


def direct_tokens(module, prompts, n, variables=None):
    """Greedy tokens of the prompts served directly (phase 3's
    ServeService over a DecodeEngine, no PS) with n new tokens each, on
    the module's weights or on ``variables`` (a state dict of it)."""
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.service import ServeService

    svc = ServeService("direct", DecodeEngine(
        module, variables, slots=8, page=16, prefill_chunk=16)).start()
    try:
        reqs = [svc.submit(p, max_new_tokens=n) for p in prompts]
        for r in reqs:
            assert r.wait(300) and r.outcome == "ok", (r.outcome, r.error)
        return [r.tokens for r in reqs]
    finally:
        svc.stop()


def phase_ps_serve(torch, card, seed, module, direct):
    """Serving through the PS on the card (see the module docstring, phase
    14); returns the paged kernel's launches of (a) by page type."""
    import os
    import tempfile

    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "home")
        try:
            return ps_run(torch, card, seed, module, direct)
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home


def ps_run(torch, card, seed, module, direct):
    from kubeml_tpu_torch.control.deployment import start_deployment

    prompts, shared = batch_prompts(seed, module.vocab_size)
    save_mini(seed)
    launches = {}
    # int8 first: the bf16 deployment ends with the hot-swap, which
    # replaces the checkpoint
    for pages, kv in (("int8", "int8"), ("bf16", "f32")):
        dep = start_deployment(serve_slots=8, serve_prefill_chunk=16,
                               serve_kv_dtype=kv, serve_prefix_cache=True)
        try:
            launches[pages], trace_ids = ps_batch(
                card, dep, prompts, shared, direct[pages], module.layers,
                pages)
            if pages == "bf16":
                ps_saturate(card, dep, seed, module.vocab_size)
                ps_observe(card, dep, trace_ids)
                ps_hot_swap(torch, card, dep, seed, module, prompts)
        finally:
            dep.stop()
    save_mini(seed)
    ps_fleet(card, seed, module, prompts, shared, direct["bf16"])
    return launches


def ps_batch(card, dep, prompts, shared, ref, layers, pages):
    """(a): phase 3's batch as 8 concurrent streams through POST
    /generate; returns the kernel's launches and the trace ids."""
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    url = dep.ps.url
    warm = GenStream(url, gen_body(prompts[0], 4)).start().join()
    assert warm.status == 200, warm.last          # builds the fleet
    (_, eng), = dep.ps._serve[PS_MODEL][1].engines()
    st0 = dict(eng.stats)
    paged_attention.launches = 0      # the main path's run starts here
    t0 = time.perf_counter()
    streams = [GenStream(url, gen_body(p, NEW_TOKENS)).start()
               for p in prompts]
    # the second copy of the shared prompt once the first one's pages are
    # registered: a prefix hit and a copy-on-write split, as in phase 3
    streams[prompts.index(shared)].first.wait(300)
    streams.append(GenStream(url, gen_body(shared, NEW_TOKENS)).start())
    for st in streams:
        st.join()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches    # ... and ends here
    assert all(st.status == 200 and st.last == {"done": True,
                                                "tokens": st.tokens}
               for st in streams), [(st.status, st.last) for st in streams]
    got = [st.tokens for st in streams]
    assert got == ref["tokens"], "PS tokens differ from phase 3's"
    d = {k: eng.stats[k] - st0[k] for k in ("dispatches",
                                           "prefill_dispatches",
                                           "prefix_hits", "cow_splits")}
    want = layers * (d["dispatches"] + d["prefill_dispatches"])
    assert launches == want, (launches, want, d)
    assert d["prefix_hits"] > 0 and d["cow_splits"] >= 1, d
    tokens = sum(len(t) for t in got)
    ttft = 1e3 * statistics.mean(st.ttft for st in streams)
    log(card, f"ps serve gpt-mini, {pages} KV pages: {len(streams)} "
        f"concurrent streaming POST /generate, {tokens} tokens in "
        f"{wall:.4f} s = {tokens / wall:.2f} tokens/s (phase 3 direct "
        f"{ref['tokens_per_s']:.2f}), client mean TTFT to the first ndjson "
        f"line {ttft:.3f} ms (phase 3 direct {ref['ttft_ms']:.3f} ms); "
        f"tokens equal phase 3's for all {len(streams)}; decode "
        f"dispatches {d['dispatches']}, prefill dispatches "
        f"{d['prefill_dispatches']}, prefix hits {d['prefix_hits']}, "
        f"kernel launches {launches} (= {layers} layers x "
        f"{d['dispatches'] + d['prefill_dispatches']} dispatches)")
    return launches, [st.trace_id for st in streams]


def ps_saturate(card, dep, seed, vocab):
    """(b): 8 held streams in the slots, 16 with 100-token prompts in the
    queue; then a request past capacity and one whose deadline the
    queued prompt backlog makes infeasible."""
    url = dep.ps.url
    fleet = dep.ps._serve[PS_MODEL][1]
    (_, eng), = fleet.engines()
    rng = np.random.default_rng(seed + 40)
    held = [GenStream(url, gen_body([int(rng.integers(1, vocab))],
                                    HOLD_TOKENS)).start() for _ in range(8)]
    wait_until(lambda: eng.active() == 8, "8 held streams attached")
    held += [GenStream(url, gen_body(rng.integers(1, vocab, HOLD_PROMPT)
                                     .tolist(), HOLD_TOKENS)).start()
             for _ in range(16)]
    svc = fleet.replicas()[0]
    wait_until(lambda: svc.inflight == 24, "slots + queue full")
    assert all(st.last is None for st in held), "a held stream ended early"
    probes = [GenStream(url, gen_body([5, 6], 4, **extra)).start().join()
              for extra in ({}, {"deadline_ms": 500})]
    for st in held:
        st.close()                       # disconnects cancel the streams
    for st in held:
        st.join()
    wait_until(lambda: svc.inflight == 0 and eng.active() == 0,
               "cancelled holders released")
    full, late = probes
    assert full.status == 429 and "capacity" in full.last["error"], \
        full.last
    assert late.status == 429 and "infeasible" in late.last["error"], \
        late.last
    assert int(full.retry_after) >= 1 and int(late.retry_after) >= 1
    log(card, f"ps saturation: 8 slots + 16 queued held, the 25th request "
        f"answers {full.status} with Retry-After {full.retry_after} "
        f"({full.last['error']!r}), a 500 ms deadline behind "
        f"{16 * (HOLD_PROMPT - 1)} queued prompt tokens answers "
        f"{late.status} with Retry-After {late.retry_after} "
        f"({late.last['error']!r}); the 24 holders disconnected and their "
        f"slots were released")


def ps_observe(card, dep, trace_ids):
    """(e): the observability routes of serve:gpt-mini."""
    from kubeml_tpu_torch.control.httpd import http_json

    url = dep.ps.url
    flight = http_json("GET", f"{url}/flight?id=serve:{PS_MODEL}")
    assert flight["replicas"] == [0] and flight["records"], flight
    trace = http_json("GET", f"{url}/trace?id=serve:{PS_MODEL}")
    for tid in trace_ids:
        mine = [e for e in trace["traceEvents"]
                if e.get("args", {}).get("trace_id") == tid]
        roots = [e for e in mine if e["name"] == "generate"]
        assert len(roots) == 1, (tid, len(roots))
        assert all(e["args"].get("parent") == "generate"
                   for e in mine if e is not roots[0]), tid
    verdict = http_json("GET", f"{url}/health?id=serve:{PS_MODEL}")
    assert verdict["state"] != "unknown", verdict
    text = urllib_get(f"{url}/metrics")
    families = sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE kubeml_serve_")})
    for fam in ("kubeml_serve_ttft_seconds", "kubeml_serve_tokens_total",
                "kubeml_serve_fleet_replicas", "kubeml_serve_slo_attainment"):
        assert fam in families, fam
    lat = verdict["latest"]
    log(card, f"ps observability: /flight {len(flight['records'])} records "
        f"of {flight['total_steps']} steps; /trace one generate tree for "
        f"each of the batch's {len(trace_ids)} trace ids; /health "
        f"{verdict['state']} (ttft p50 {1e3 * lat['serve_ttft_p50']:.3f} "
        f"ms, p99 {1e3 * lat['serve_ttft_p99']:.3f} ms); /metrics {len(families)} kubeml_serve_ families")


def urllib_get(url) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def ps_hot_swap(torch, card, dep, seed, module, prompts):
    """(c): a second checkpoint saved while 4 streams are in flight."""
    url = dep.ps.url
    fleet = dep.ps._serve[PS_MODEL][1]
    (_, eng), = fleet.engines()
    swap = [p for p in prompts if len(p) + HOLD_TOKENS <= module.max_len][:4]
    assert len(swap) == 4
    old_ref = direct_tokens(module, swap, HOLD_TOKENS)
    new_ref = direct_tokens(build_gpt(torch, PS_MODEL, seed + SWAP_SEED,
                                      torch.bfloat16, "cuda"), swap,
                            NEW_TOKENS)
    old = [GenStream(url, gen_body(p, HOLD_TOKENS)).start() for p in swap]
    for st in old:
        st.first.wait(300)
    save_mini(seed + SWAP_SEED)
    t_swap = time.perf_counter()
    new = [GenStream(url, gen_body(p, NEW_TOKENS)).start() for p in swap]
    for st in new + old:
        st.join()
    assert [st.tokens for st in old] == old_ref, "generation 1 changed"
    assert [st.tokens for st in new] == new_ref, "generation 2 differs"
    mid = sum(st.t_done > t_swap + st.ttft for st in old)
    assert mid >= 1, "every old stream ended before the swap"
    wait_until(lambda: eng.active_generations() == [2], "gen 1 retired")
    gauge = [ln for ln in urllib_get(f"{url}/metrics").splitlines()
             if ln.startswith("kubeml_serve_weight_generation{")]
    assert gauge == [f'kubeml_serve_weight_generation{{model="{PS_MODEL}"}}'
                     f' 2.0'], gauge
    assert eng.stats["generations_retired"] == 1, eng.stats
    log(card, f"ps hot-swap: a second checkpoint saved with 4 streams of "
        f"{HOLD_TOKENS} tokens in flight; {mid} of them still streaming "
        f"when the 4 requests after it had their first token; old streams "
        f"equal the direct run on the old weights, new ones the direct run "
        f"on the new weights; kubeml_serve_weight_generation 2, generation "
        f"1 retired")


def ps_fleet(card, seed, module, prompts, shared, ref):
    """(d): two replicas on the one card."""
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.faults import FleetFaultPlan, ServeFaultPlan
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.fleet import ServeFleet
    from kubeml_tpu_torch.serve.service import ServeService

    rng = np.random.default_rng(seed + 41)
    dep = start_deployment(serve_slots=8, serve_prefill_chunk=16,
                           serve_replicas_min=2, serve_replicas_max=2)
    try:
        url = dep.ps.url
        family = [shared + rng.integers(1, module.vocab_size, 16).tolist()
                  for _ in range(3)]
        head = GenStream(url, gen_body(family[0], 8)).start()
        head.join()
        rest = [GenStream(url, gen_body(p, 8)).start() for p in family[1:]]
        for st in rest:
            st.join()
        assert all(st.status == 200 for st in [head] + rest)
        stats = {i: dict(e.stats) for i, e in
                 dep.ps._serve[PS_MODEL][1].engines()}
        used = [i for i, st in stats.items() if st["generated_tokens"]]
        assert len(used) == 1, stats            # one replica took all three
        hits = stats[used[0]]["prefix_hits"]
        assert hits >= 2 * (len(shared) // 16), stats
    finally:
        dep.stop()

    def factory(index):
        eng = DecodeEngine(module, slots=8, page=16, prefill_chunk=16,
                           fault_plan=ServeFaultPlan.parse(
                               [{"kind": "serve_slow_step",
                                 "duration_s": 0.005}]))
        return ServeService(PS_MODEL, eng, supervise=False)

    fleet = ServeFleet(PS_MODEL, factory, replicas_min=2, replicas_max=2,
                       page_tokens=16, autoscale_interval_s=0.0).start()
    try:
        reqs = [fleet.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        reqs.append(fleet.submit(shared, max_new_tokens=NEW_TOKENS))
        homes = [r.fleet_replica for r in reqs]
        victim = max(set(homes), key=homes.count)
        fleet.fault_plan = FleetFaultPlan.parse(
            [{"kind": "fleet_replica_crash", "replica": victim}])
        actions = fleet.supervise_once()
        for r in reqs:
            assert r.wait(300) and r.outcome == "ok", (r.outcome, r.error)
        assert "eject" in actions, actions
        moved = sum(r.migrations for r in reqs)
        assert moved >= 1 and "failover_migrate" in actions, actions
        assert [r.tokens for r in reqs] == ref["tokens"], \
            "migrated tokens differ from phase 3's"
    finally:
        fleet.stop(grace_s=0.0)
    log(card, f"ps fleet: 2 replicas on the one card; 3 prompts sharing a "
        f"{len(shared)}-token prefix all routed to replica {used[0]} "
        f"({hits} prefix page hits); a fleet_replica_crash on replica "
        f"{victim} (holding {homes.count(victim)} of the batch's "
        f"{len(reqs)} streams) ejected it and migrated {moved} stream(s), "
        f"all finishing with phase 3's tokens ({actions})")


# ----------------------------------------------------------------- phase 15
CL_TRAIN, CL_TEST = JOB_TRAIN, JOB_TEST   # phase 10's windows
CL_LANES = 4
CL_TENANTS = ("prod=3:4", "batch=1")
CL_RESUME_EPOCHS = 3               # (c)'s job, killed after epoch 1
# The deployment child: `python -m kubeml_tpu_torch.cli serve --role all
# --standalone-jobs --cluster-lanes 4 ... --control-dir D` on the ports of
# the environment (a restart binds the same ones, so the surviving job
# children reach it), under phase 12's numerics. Two wrappers: each job
# server child runs through CL_JOB (argv[1]), which appends every epoch's
# flash and merge launches to argv[2] and zeroes them; and the PS answers
# GET /smoke/paged (the paged kernel's count and each replica's dispatch
# stats) and POST /smoke/paged/zero: the launches happen in those
# processes, where this script cannot read them.
CL_SERVE = r'''
import runpy, subprocess, sys
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from kubeml_tpu_torch.control import ps as ps_mod
from kubeml_tpu_torch.ops.paged_attention import paged_attention
job_wrapper, counts, control = sys.argv[1:4]


class Sub:
    TimeoutExpired = subprocess.TimeoutExpired

    @staticmethod
    def Popen(cmd, **kw):
        if cmd[1:3] == ["-m", "kubeml_tpu_torch.train.jobserver"]:
            cmd = [cmd[0], job_wrapper, counts] + cmd[3:]
        return subprocess.Popen(cmd, **kw)


ps_mod.subprocess = Sub
real_init = ps_mod.ParameterServer.__init__


def init(self, *a, **k):
    real_init(self, *a, **k)

    def paged(req):
        with self._serve_lock:
            fleets = dict(self._serve)
        return {"launches": paged_attention.launches, "engines": {
            m: [[i, dict(e.stats)] for i, e in f.engines()]
            for m, (_, f) in fleets.items()}}

    def zero(req):
        paged_attention.launches = 0
        return {"ok": True}
    self.route("GET", "/smoke/paged", paged)
    self.route("POST", "/smoke/paged/zero", zero)


ps_mod.ParameterServer.__init__ = init
sys.argv = ["kubeml", "serve", "--role", "all", "--standalone-jobs",
            "--cluster-lanes", "4", "--cluster-tenant", "prod=3:4",
            "--cluster-tenant", "batch=1", "--control-dir", control,
            "--serve-slots", "8", "--serve-prefill-chunk", "16",
            "--serve-kv-dtype", "f32", "--serve-prefix-cache", "on",
            "--serve-replicas-min", "0"]
runpy.run_module("kubeml_tpu_torch.cli", run_name="__main__",
                 alter_sys=True)
'''
# A job server child under phase 12's numerics: each epoch's launches and
# the fencing epoch its task holds go to argv[1] as one JSON line; while
# the file `hold` beside it exists, the job waits after its epoch's
# MetricUpdate (the kill in (c) lands there).
CL_JOB = r'''
import json, os, sys, time
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from kubeml_tpu_torch.ops import flash_attention as fa, fused_merge as fm
from kubeml_tpu_torch.train import jobserver
from kubeml_tpu_torch.train.jobserver import JobServer
class Segments:      # the merge's segment count as a `launches` counter
    launches = property(
        lambda self: fm.fused_merge_kernel.segments,
        lambda self, n: setattr(fm.fused_merge_kernel, "segments", n))
KERNELS = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
           "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
           "merge segments": Segments()}
counts = sys.argv[1]
hold = os.path.join(os.path.dirname(counts), "hold")
real = JobServer._publish_metrics


def publish(self, m):
    real(self, m)
    with open(counts, "a") as f:
        f.write(json.dumps({"job": m.job_id, "pid": os.getpid(),
                            "grant_epoch": self._job.task.grant_epoch, **{
            k: fn.launches for k, fn in KERNELS.items()}}) + "\n")
    for fn in KERNELS.values():
        fn.launches = 0
    deadline = time.monotonic() + 600
    while os.path.exists(hold) and time.monotonic() < deadline:
        time.sleep(0.05)


JobServer._publish_metrics = publish
jobserver.main(sys.argv[2:])
'''


class ClusterServe:
    """The deployment child of phase 15 on fixed ports; start() waits for
    its controller line, which it prints after any recovery."""

    def __init__(self, tmp):
        import os
        import socket

        def free_port():
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                return s.getsockname()[1]

        self.ports = {k: free_port() for k in ("CONTROLLER", "SCHEDULER",
                                               "PS", "STORAGE")}
        repo = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=repo + os.pathsep
                        + os.environ.get("PYTHONPATH", ""))
        self.env.pop("KUBEML_CONTROLLER_URL", None)
        self.env.update({f"KUBEML_{k}_PORT": str(v)
                         for k, v in self.ports.items()})
        self.cwd = repo
        self.job = os.path.join(tmp, "cl_job.py")
        with open(self.job, "w") as f:
            f.write(CL_JOB)
        self.counts = os.path.join(tmp, "launches.jsonl")
        self.hold = os.path.join(tmp, "hold")
        self.control = os.path.join(tmp, "control")
        self.url = f"http://127.0.0.1:{self.ports['CONTROLLER']}"
        self.ps = f"http://127.0.0.1:{self.ports['PS']}"
        self.sched = f"http://127.0.0.1:{self.ports['SCHEDULER']}"
        self.proc = None
        self.orphans = []     # job children of a killed serve child

    def start(self) -> float:
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", CL_SERVE, self.job, self.counts,
             self.control], env=self.env, cwd=self.cwd,
            stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()     # "controller: URL"
        if not line.startswith("controller:"):
            self.stop()
            raise RuntimeError(f"the serve child printed {line!r} (rc "
                               f"{self.proc.poll()})")
        return time.perf_counter() - t0

    def kill(self):
        import signal

        self.proc.send_signal(signal.SIGKILL)    # not its job children
        self.proc.wait(timeout=60)

    def stop(self):
        import signal

        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)  # stops its services
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def rows(self, job_id):
        with open(self.counts) as f:
            rows = [json.loads(line) for line in f]
        return [r for r in rows if r["job"] == job_id]

    def launches(self, job_id):
        return [{k: v for k, v in r.items()
                 if k not in ("job", "pid", "grant_epoch")}
                for r in self.rows(job_id)]

    def grants(self, job_id):
        """The fencing epoch the job child's task held at each epoch."""
        return [r["grant_epoch"] for r in self.rows(job_id)]

    def pids(self, job_id):
        with open(self.counts) as f:
            return {json.loads(line)["pid"] for line in f
                    if json.loads(line)["job"] == job_id}

    def get(self, path, base=None):
        from kubeml_tpu_torch.control.httpd import http_json

        return http_json("GET", (base or self.url) + path)

    def text(self, url) -> str:
        import urllib.request

        with urllib.request.urlopen(url, timeout=60) as r:
            return r.read().decode()


def poll(pred, what, timeout):
    """wait_until at 20 Hz: each probe is an HTTP round trip."""
    deadline = time.perf_counter() + timeout
    while not pred():
        assert time.perf_counter() < deadline, f"timed out waiting: {what}"
        time.sleep(0.05)


def cl_gangs(serve) -> dict:
    return {g["job_id"]: g for g in
            serve.get("/cluster")["cluster_running_gangs"]}


def cl_wait_job(serve, job_id, timeout=600.0):
    """Until the job has left the PS's task list; then its history."""
    deadline = time.perf_counter() + timeout
    while any(t["job_id"] == job_id for t in serve.get("/tasks")):
        assert time.perf_counter() < deadline, f"job {job_id} never ended"
        time.sleep(0.1)
    return serve.get(f"/history/{job_id}")["data"]   # 404: it failed


def cl_plan(n, layers):
    """The flash and merge launches of one epoch of a phase-15 job at a
    static N=n (validation at n workers)."""
    steps, rounds, evals = _epoch_counts(n, n, CL_TRAIN, CL_TEST)
    return {"forward": layers * (steps + evals), "dK/dV": layers * steps,
            "dQ": layers * steps, **merge_counts(JOB_BUCKETS, rounds)}


def cl_request(epochs, n, tenant, priority=0):
    req = cp_request(CP_GPT_FN, "tokens", epochs, JOB_B, JOB_LR, k=JOB_K,
                     default_parallelism=n, static_parallelism=True,
                     merge_bucket_mb=MERGE_CAP_MB)
    req.tenant, req.priority = tenant, priority
    return req


def cl_direct(torch, job_id, epochs, n):
    """The same task as a direct TrainJob in this process: what the
    deployment's checkpoint must equal bit for bit."""
    from kubeml_tpu_torch.api.types import TrainTask
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.train.job import TrainJob

    req = cl_request(epochs, n, "")
    TrainJob(TrainTask(job_id=job_id, parameters=req, parallelism=n),
             get_model("gpt-mini")(), token_dataset(), device="cuda").train()


def phase_cluster(torch, card, seed, module, direct):
    """The cluster allocator and the durable control plane on the card
    (see the module docstring, phase 15); returns the launches of each
    kernel through the cluster-mode deployment."""
    import ctypes
    import os
    import tempfile

    # orphans of the killed serve child re-parent to this process, which
    # reaps them: the adopted job server exits here, not as a zombie
    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    home = os.environ.get("KUBEML_TPU_HOME")
    det = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "home")
        torch.backends.cudnn.deterministic = True
        serve = ClusterServe(tmp)
        try:
            return cluster_run(torch, card, seed, module, direct, tmp,
                               serve)
        finally:
            if os.path.exists(serve.hold):
                os.remove(serve.hold)
            for pid in serve.orphans:        # a failed run's adopted job
                if os.path.exists(f"/proc/{pid}"):
                    os.kill(pid, 9)
                    reap(pid)
            serve.stop()
            torch.backends.cudnn.deterministic = det
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home


def cluster_run(torch, card, seed, module, direct, tmp, serve):
    import os

    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    layers = GPT_CONFIGS["gpt-mini"]["layers"]
    with open(os.path.join(tmp, f"{CP_GPT_FN}.py"), "w") as f:
        f.write(CP_FUNCTIONS[CP_GPT_FN])
    rng = np.random.default_rng(seed + 12)        # phase 10's windows
    arrays = (token_windows(rng, CL_TRAIN, TRAIN_T),
              np.zeros(CL_TRAIN, np.int32),
              token_windows(rng, CL_TEST, TRAIN_T),
              np.zeros(CL_TEST, np.int32))
    paths = []
    for name, arr in zip(("xtr", "ytr", "xte", "yte"), arrays):
        paths.append(os.path.join(tmp, f"cl_{name}.npy"))
        np.save(paths[-1], arr)
    save_mini(seed)                     # phase 3's weights, for /generate
    t_phase = time.perf_counter()
    ready = serve.start()
    client = KubemlClient(serve.url).v1()
    client.functions().create(CP_GPT_FN, os.path.join(tmp,
                                                      f"{CP_GPT_FN}.py"))
    client.datasets().create("tokens", *paths)
    log(card, f"cluster serve: `kubeml serve --role all --standalone-jobs "
        f"--cluster-lanes {CL_LANES} --cluster-tenant {CL_TENANTS[0]} "
        f"--cluster-tenant {CL_TENANTS[1]} --control-dir D` (a child on the "
        f"card) printed its controller {ready:.3f} s after spawn")
    flash = {"forward": 0, "dK/dV": 0, "dQ": 0, "fused_merge": 0,
             "merge segments": 0}

    def add(rows):
        for row in rows:
            for k in flash:
                flash[k] += row[k]

    add(cluster_gangs(torch, card, serve, client, layers))
    paged, arrival = cluster_serve(card, serve, client, seed, module,
                                   direct["bf16"], layers)
    add(serve.launches(arrival))
    add(cluster_recover(torch, card, serve, client, seed, module,
                        direct["bf16"], layers))
    log(card, f"cluster phase: {time.perf_counter() - t_phase:.3f} s; "
        f"launches through the cluster-mode deployment: paged {paged}, "
        f"{flash}")
    return dict(flash, paged=paged)


def cluster_gangs(torch, card, serve, client, layers):
    """(a): gang placement — N=2 places, N=3 parks until it finishes; both
    checkpoints equal direct jobs at the same N."""
    t0 = time.perf_counter()
    first = client.networks().train(cl_request(1, 2, "batch"))
    t1 = time.perf_counter()
    second = client.networks().train(cl_request(1, 3, "prod"))
    placed, parked_seen = {}, False
    while len(placed) < 2:
        snap = serve.get("/cluster")
        gangs = {g["job_id"] for g in snap["cluster_running_gangs"]}
        now = time.perf_counter()
        for job, sent in ((first, t0), (second, t1)):
            if job in gangs and job not in placed:
                placed[job] = now - sent
        if second not in gangs and first in gangs:
            parked_seen = parked_seen or snap["cluster_queue_depth"] == 1
        assert now - t0 < 600, "the parked gang never placed"
        time.sleep(0.05)
    assert parked_seen, "the N=3 gang never parked behind the N=2 one"
    hists = {job: cl_wait_job(serve, job) for job in (first, second)}
    rows = []
    for job, n in ((first, 2), (second, 3)):
        cl_direct(torch, f"direct-{job}", 1, n)
        assert equal_checkpoints(job, f"direct-{job}"), \
            f"the gang-placed N={n} job's checkpoint differs from a direct one"
        got = serve.launches(job)
        want = cl_plan(n, layers)
        assert got == [want], (job, got, want)
        rows += got
        behind = ("" if job == first else
                  f", of which {hists[first]['epoch_duration'][0]:.4f} s "
                  f"the N=2 job's epoch and the rest its child's start and "
                  f"end")
        log(card, f"cluster gang N={n} ({job}, tenant "
            f"{'batch' if n == 2 else 'prod'}): queue wait "
            f"{placed[job]:.3f} s (POST /train -> its gang on /cluster, "
            f"polled at 20 Hz{behind}); train loss "
            f"{hists[job]['train_loss'][0]:.4f}"
            f", epoch {hists[job]['epoch_duration'][0]:.4f} s; launches per "
            f"epoch {got} (= the plan); checkpoint equal bit for bit to a "
            f"direct TrainJob at N={n}")
    snap = serve.get("/cluster")
    assert snap["cluster_gang_placements_total"] == 2 and \
        snap["cluster_lanes_in_use"] == 0, snap
    return rows


def cl_batch(serve, prompts, shared):
    streams = [GenStream(serve.ps, gen_body(p, NEW_TOKENS)).start()
               for p in prompts]
    streams[prompts.index(shared)].first.wait(300)
    streams.append(GenStream(serve.ps, gen_body(shared, NEW_TOKENS)).start())
    for st in streams:
        st.join()
    assert all(st.status == 200 for st in streams), \
        [(st.status, st.last) for st in streams]
    return [st.tokens for st in streams]


def cl_dispatches(paged_doc):
    return sum(s["dispatches"] + s["prefill_dispatches"]
               for _, s in paged_doc["engines"].get(PS_MODEL, []))


def cluster_serve(card, serve, client, seed, module, ref, layers):
    """(b): serve-elastic — the cold start's gang through /serve/resize,
    phase 3's batch, then a priority-1 arrival that preempts the gang and
    a cold start with the same tokens. Returns (paged launches, the
    arrival's job id)."""
    prompts, shared = batch_prompts(seed, module.vocab_size)
    warm = GenStream(serve.ps, gen_body(prompts[0], 4)).start().join()
    assert warm.status == 200, warm.last         # a cold start: the gang
    gangs = cl_gangs(serve)
    assert gangs[f"serve:{PS_MODEL}"]["kind"] == "serving" and \
        gangs[f"serve:{PS_MODEL}"]["lanes"] == 1, gangs
    http_post(serve.ps + "/smoke/paged/zero")
    d0 = cl_dispatches(serve.get("/smoke/paged", serve.ps))
    t0 = time.perf_counter()
    got = cl_batch(serve, prompts, shared)
    wall = time.perf_counter() - t0
    doc = serve.get("/smoke/paged", serve.ps)
    dispatches = cl_dispatches(doc) - d0
    launches = doc["launches"]
    assert got == ref["tokens"], "cluster /generate tokens differ from phase 3"
    assert launches == layers * dispatches, (launches, dispatches)
    tokens = sum(len(t) for t in got)
    log(card, f"cluster serve-elastic: the cold start's replica placed a "
        f"serving gang of 1 lane through POST /serve/resize ({gangs}); "
        f"phase 3's batch through POST /generate: tokens equal phase 3's "
        f"for all {len(got)}, {tokens / wall:.2f} tokens/s, paged launches "
        f"{launches} (= {layers} layers x {dispatches} dispatches)")

    # a priority-1 arrival that needs every lane displaces the serving
    # gang (preempt-cheapest): the fleet drains to zero, the job places
    t1 = time.perf_counter()
    arrival = client.networks().train(cl_request(1, CL_LANES, "batch",
                                                 priority=1))
    poll(lambda: arrival in cl_gangs(serve), "the arrival's gang", 300)
    placed = time.perf_counter() - t1
    snap = serve.get("/cluster")
    assert snap["cluster_preemptions_total"] == 1, snap
    assert f"serve:{PS_MODEL}" not in cl_gangs(serve)
    poll(lambda: serve.get("/smoke/paged", serve.ps)["engines"].get(
        PS_MODEL) == [], "the fleet to drain to zero", 120)
    t2 = time.perf_counter()
    cold = GenStream(serve.ps, gen_body(prompts[0], NEW_TOKENS)).start()
    cold.join()
    assert cold.status == 200 and cold.tokens == ref["tokens"][0], \
        (cold.status, cold.last)
    cold_s = time.perf_counter() - t2
    hist = cl_wait_job(serve, arrival)
    got = serve.launches(arrival)
    assert got == [cl_plan(CL_LANES, layers)], got
    log(card, f"cluster preemption: a priority-1 N={CL_LANES} arrival "
        f"({arrival}) preempted serve:{PS_MODEL} (preempt-cheapest; "
        f"kubeml_cluster_preemptions_total 1) and placed "
        f"{placed:.3f} s after POST /train; the fleet drained to zero; the "
        f"next /generate cold-started in {cold_s:.3f} s (client TTFT "
        f"{cold.ttft:.3f} s) with phase 3's tokens; the arrival's epoch "
        f"{hist['epoch_duration'][0]:.4f} s, launches {got} (= the plan)")
    return launches, arrival


def reap(pid, timeout=60.0):
    """Wait for the adopted job server to exit, and reap it: orphaned by
    the killed serve child, it re-parented to this process."""
    import os

    deadline = time.perf_counter() + timeout
    while True:
        try:
            if os.waitpid(pid, os.WNOHANG) != (0, 0):
                return
        except ChildProcessError:   # not ours after all: poll its state
            if not os.path.exists(f"/proc/{pid}"):
                return
        assert time.perf_counter() < deadline, "the adopted child lingers"
        time.sleep(0.05)


def http_post(url, body=None):
    from kubeml_tpu_torch.control.httpd import http_json

    return http_json("POST", url, body or {})


def metric(text, name, role):
    for line in text.splitlines():
        if line.startswith(f'{name}{{role="{role}"}} '):
            return float(line.split()[-1])
    raise AssertionError(f"no {name}{{role={role}}} in /metrics")


def cluster_recover(torch, card, serve, client, seed, module, ref, layers):
    """(c): SIGKILL of the serve child after epoch 1 of a 3-epoch job in a
    standalone child; a second serve child on the same control dir
    re-adopts it. Returns the job's per-epoch launches."""
    import os

    from kubeml_tpu_torch.api.errors import KubeMLException

    prompts, shared = batch_prompts(seed, module.vocab_size)
    with open(serve.hold, "w"):
        pass                  # the job waits after each epoch's publish
    job = client.networks().train(cl_request(CL_RESUME_EPOCHS, 2, "batch"))
    poll(lambda: os.path.exists(serve.counts)
         and len(serve.launches(job)) == 1, "epoch 1 of the job", 600)
    (pid,) = serve.pids(job)
    epoch_before = serve.get("/cluster")["cluster_fencing_epoch"]
    assert cl_gangs(serve)[job]["epoch"] == epoch_before
    mem = [torch.cuda.mem_get_info()[0]]
    serve.kill()
    serve.orphans.append(pid)
    mem.append(torch.cuda.mem_get_info()[0])
    assert os.path.exists(f"/proc/{pid}"), "the job child died with the PS"
    restart = serve.start()
    mem.append(torch.cuda.mem_get_info()[0])
    snap = serve.get("/cluster")
    gang = cl_gangs(serve)[job]
    task = next(t for t in serve.get("/tasks") if t["job_id"] == job)
    assert snap["cluster_fencing_epoch"] == epoch_before + 1, snap
    assert gang["epoch"] == epoch_before + 1 and gang["lanes"] == 2, gang
    assert task["grant_epoch"] == epoch_before + 1, task
    assert task["restarts"] == 0, task
    stale = dict(task, grant_epoch=epoch_before)
    try:
        http_post(serve.sched + "/job", stale)
        raise AssertionError("a stale grant was accepted")
    except KubeMLException as e:
        assert e.status_code == 409, e
    replicas = serve.get("/smoke/paged", serve.ps)["engines"].get(PS_MODEL)
    assert replicas is not None and len(replicas) == 1, replicas
    got = cl_batch(serve, prompts, shared)
    assert got == ref["tokens"], "the rebuilt fleet's tokens differ"
    text = serve.text(serve.ps + "/metrics")
    rec = {role: metric(text, "kubeml_control_recovery_seconds_sum", role)
           for role in ("ps", "scheduler")}
    assert all(metric(text, "kubeml_control_recoveries_total", role) == 1
               for role in ("ps", "scheduler"))
    os.remove(serve.hold)     # epochs 2 and 3 run under the new PS
    hist = cl_wait_job(serve, job)
    assert serve.pids(job) == {pid}, "the job was started a second time"
    reap(pid)                 # its last epoch's row is written by now
    # the job may stop before its last epoch at its goal accuracy (100 %
    # by default), as the direct job below does; at least one epoch runs
    # under the new PS
    ran = len(hist["train_loss"])
    assert 2 <= ran <= CL_RESUME_EPOCHS, hist
    grants = serve.grants(job)
    assert grants == [epoch_before] + [epoch_before + 1] * (ran - 1), \
        ("the re-grant never reached the child", grants)
    got = serve.launches(job)
    assert got == [cl_plan(2, layers)] * ran, got
    cl_direct(torch, f"direct-{job}", CL_RESUME_EPOCHS, 2)
    assert equal_checkpoints(job, f"direct-{job}"), \
        "the re-adopted job's checkpoint differs from an uninterrupted one"
    log(card, f"cluster recovery: SIGKILL of the serve child after epoch 1 "
        f"of {job} (N=2, {CL_RESUME_EPOCHS} epochs asked, {ran} run before "
        f"its goal accuracy, pid {pid}); the second "
        f"serve child on the same --control-dir printed its controller "
        f"{restart:.3f} s after spawn: the child re-adopted (same pid, "
        f"restarts 0), fencing epoch {epoch_before} -> "
        f"{snap['cluster_fencing_epoch']}, the child's task held epochs "
        f"{grants} (the re-grant relayed through PS /update), /job with "
        f"epoch {epoch_before} answered 409; the fleet came back at {len(replicas)} replica with "
        f"phase 3's tokens; kubeml_control_recovery_seconds ps "
        f"{rec['ps']:.4f} s, scheduler {rec['scheduler']:.4f} s; the job "
        f"finished (train loss {hist['train_loss']}), its checkpoint equal "
        f"bit for bit to an uninterrupted direct job's; launches per epoch "
        f"{got[0]} (= the plan); free device memory (mem_get_info) "
        f"{mem[0] / 2**30:.2f} GiB before the kill, {mem[1] / 2**30:.2f} "
        f"after, {mem[2] / 2**30:.2f} after the restart")
    return got


# ----------------------------------------------------------------- phase 16
DG_N, DG_VICTIM_N = 4, 2
# (a)-(c)'s registry dataset: 32 windows a doc, so a round at N=4 is one
# doc of K=4 steps per worker and an epoch 8 rounds (at phase 10's 64 a
# round is 8 steps and an N=4 epoch 4 rounds); (d)-(f) upload through the
# client at the storage's 64 and run at N=2: 8 rounds of 8 steps
DG_SUBSET = 32
DG_FN = "gpt-mini-weighted"
# (a)-(c)'s function: phase 10's windows with a float per-sequence loss
# weight w (all ones, so the loss is gpt-mini's): token ids are integers,
# which a NaN burst leaves alone, so w is the float leaf it poisons
DG_FUNCTION = '''
import numpy as np
from kubeml_tpu_torch.models.base import KubeDataset
from kubeml_tpu_torch.models.gpt import GPTMini


class WeightedWindows(KubeDataset):
    def transform_train(self, data, labels):
        x = np.asarray(data).astype(np.int32)
        return {"x": x, "w": np.ones(len(x), np.float32)}

    def transform_test(self, data, labels):
        return {"x": np.asarray(data).astype(np.int32)}


class WeightedGPTMini(GPTMini):
    """gpt-mini whose per-sequence loss is scaled by the batch's w."""

    def loss(self, module, batch, generator, sample_mask):
        return super().loss(module, batch, generator, sample_mask) \\
            * batch["w"].to(module.device)
'''
DG_ABORT = ("aborting job {}: every contributing worker produced non-finite "
            "updates for 2 consecutive rounds (abort_after=2) — the model has "
            "diverged and no merge can move the weights")
DG_HEARTBEAT_S, DG_MISS_BUDGET = 0.25, 16    # the reaper's budget: 4 s
DG_SLOW_S = 1.5                              # (f)'s slow round


class JobWrapper:
    """The PS's subprocess module for an in-process deployment: job server
    children run through CL_JOB (phase 12's numerics, per-epoch launch
    rows), everything else as it is."""

    TimeoutExpired = subprocess.TimeoutExpired

    def __init__(self, script, counts):
        self.script, self.counts = script, counts

    def Popen(self, cmd, **kw):
        if cmd[1:3] == ["-m", "kubeml_tpu_torch.train.jobserver"]:
            cmd = [cmd[0], self.script, self.counts] + cmd[3:]
        return subprocess.Popen(cmd, **kw)


def dg_classes():
    ns = {}
    exec(DG_FUNCTION, ns)
    return ns["WeightedGPTMini"], ns["WeightedWindows"]


def dg_task(job_id, epochs, n, **opts):
    """Phase 10's job at a static N, no validation but the final one,
    never stopping at a goal accuracy."""
    return job_task(job_id, epochs, default_parallelism=n,
                    static_parallelism=True, k=JOB_K,
                    merge_bucket_mb=MERGE_CAP_MB, validate_every=0,
                    train_stats=False, goal_accuracy=200.0, **opts)


def dg_request(epochs, n, **opts):
    return cp_request(CP_GPT_FN, "tokens", epochs, JOB_B, JOB_LR, k=JOB_K,
                      default_parallelism=n, static_parallelism=True,
                      merge_bucket_mb=MERGE_CAP_MB, goal_accuracy=200.0,
                      **opts)


def dg_kernels():
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm

    return {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
            "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
            "merge segments": MergeSegments()}


def dg_counts(zero=False):
    kernels = dg_kernels()
    out = {k: fn.launches for k, fn in kernels.items()}
    if zero:
        for fn in kernels.values():
            fn.launches = 0
    return out


def dg_epoch(n, subset=DG_SUBSET):
    """(plan, local steps, rounds, eval slots) of one epoch at a static
    N=n over phase 10's windows stored ``subset`` to a doc."""
    from kubeml_tpu_torch.data.sharding import plan_epoch

    plan = plan_epoch(JOB_TRAIN, n, JOB_K, JOB_B, subset)
    test = plan_epoch(JOB_TEST, n, -1, JOB_B, subset)
    return (plan, plan.total_steps, len(plan.rounds),
            n * test.rounds[0].max_steps)


def dg_plan_launches(layers, steps, rounds, evals):
    return {"forward": layers * (steps + evals), "dK/dV": layers * steps,
            "dQ": layers * steps, **merge_counts(JOB_BUCKETS, rounds)}


def dg_add(total, counts):
    for k in total:
        total[k] += counts[k]


def phase_degraded(torch, card, seed):
    """Degraded-mode training and the preemption of training jobs on the
    card (see the module docstring, phase 16); returns each kernel's
    launches over the phase."""
    import os
    import tempfile

    from kubeml_tpu_torch.data.registry import DatasetRegistry

    home = os.environ.get("KUBEML_TPU_HOME")
    det = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "home")
        torch.backends.cudnn.deterministic = True
        try:
            rng = np.random.default_rng(seed + 12)     # phase 10's windows
            arrays = (token_windows(rng, JOB_TRAIN, TRAIN_T),
                      np.zeros(JOB_TRAIN, np.int32),
                      token_windows(rng, JOB_TEST, TRAIN_T),
                      np.zeros(JOB_TEST, np.int32))
            DatasetRegistry().create("tokens", *arrays,
                                     subset_size=DG_SUBSET)
            t0 = time.perf_counter()
            launches = dg_in_process(torch, card)
            # the children's own home: the client uploads the windows
            os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "children")
            dg_add(launches, dg_children(torch, card, tmp, arrays))
            log(card, f"degraded phase: {time.perf_counter() - t0:.3f} s; "
                f"launches over phase 16: {launches}")
            return launches
        finally:
            torch.backends.cudnn.deterministic = det
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home


def dg_job(torch, task, hook_for=None):
    """A TrainJob of the weighted gpt-mini on the card, with the round
    hook ``hook_for(job)`` gives; (job, record or the exception it
    raised, launches, wall seconds)."""
    from kubeml_tpu_torch.train.job import TrainJob

    model_cls, data_cls = dg_classes()
    job = TrainJob(task, model_cls(), data_cls("tokens"), device="cuda")
    if hook_for is not None:
        job.round_hook = hook_for(job)
    dg_counts(zero=True)
    t0 = time.perf_counter()
    try:
        out = job.train()
    except Exception as e:  # noqa: BLE001 — (b) expects the abort
        out = e
    torch.cuda.synchronize()
    return job, out, dg_counts(zero=True), time.perf_counter() - t0


def dg_state(job_id):
    from kubeml_tpu_torch.train.checkpoint import _flatten, load_checkpoint

    return _flatten(load_checkpoint(job_id)[0])


def dg_in_process(torch, card):
    """(a)-(c) and the cursor's cost: TrainJobs in this process."""
    import json

    from kubeml_tpu_torch.data.loader import RoundLoader
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    layers = GPT_CONFIGS["gpt-mini"]["layers"]
    plan, steps, rounds, evals = dg_epoch(DG_N)
    total = {"forward": 0, "dK/dV": 0, "dQ": 0, "fused_merge": 0,
             "merge segments": 0}

    # (a) a NaN burst on worker 1 at round 2 == its dropout there
    runs = {}
    for kind in ("nan", "dropout"):
        fault = json.dumps([{"kind": kind, "epoch": 0, "round": 2,
                             "worker": 1}])
        job, rec, counts, wall = dg_job(
            torch, dg_task(f"dg-{kind}", 1, DG_N, fault_plan=fault))
        assert not isinstance(rec, Exception), rec
        runs[kind] = (job, rec.data, counts, wall)
    lost = plan.rounds[2].chunks[1].num_steps
    want_nan = dg_plan_launches(layers, steps, rounds, evals)
    want_drop = dict(want_nan, **{k: want_nan[k] - layers * lost
                                  for k in ("forward", "dK/dV", "dQ")})
    assert runs["nan"][2] == want_nan, (runs["nan"][2], want_nan)
    assert runs["dropout"][2] == want_drop, (runs["dropout"][2], want_drop)
    assert runs["nan"][0]._fault_plan.injected["nan"] == 1
    assert runs["nan"][1].dropped_workers == [1.0], \
        runs["nan"][1].dropped_workers
    assert runs["dropout"][1].dropped_workers == [0.0]
    a, b = dg_state("dg-nan"), dg_state("dg-dropout")
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a), \
        "a NaN-dropped worker's weights differ from its dropout"
    dg_add(total, runs["nan"][2])
    dg_add(total, runs["dropout"][2])
    log(card, f"degraded (a) NaN drop: gpt-mini N={DG_N} K={JOB_K} B={JOB_B} "
        f"1 epoch, NaN in worker 1's loss weights at round 2: "
        f"dropped_workers {runs['nan'][1].dropped_workers}, final weights "
        f"equal bit for bit to the run with worker 1 dropped out there "
        f"({len(a)} tensors); walls {runs['nan'][3]:.3f} s (NaN) / "
        f"{runs['dropout'][3]:.3f} s (dropout); launches {runs['nan'][2]} "
        f"(= {layers} layers x ({steps} steps + {evals} eval), "
        f"{JOB_BUCKETS} x {rounds} rounds) and {runs['dropout'][2]} "
        f"(= the plan less worker 1's {lost} steps)")

    # (b) every worker NaN at rounds 2 and 3, abort_after 2: the weights
    # after an all-NaN round are those before it (kernel #5's ref select
    # at raw_count 0), and the job aborts with the diagnostic
    seen = {}   # round -> the weights its dispatch starts from

    def snap_for(job):
        def snap(rb):
            seen[rb.round_index] = {k: v.clone()
                                    for k, v in job.state.items()}
            return rb
        return snap

    fault = json.dumps([{"kind": "nan", "epoch": 0, "round": r}
                        for r in (2, 3)])
    job_b, err, counts_b, wall_b = dg_job(
        torch, dg_task("dg-abort", 1, DG_N, fault_plan=fault,
                       abort_after=2), snap_for)
    assert getattr(err, "status_code", None) == 500 and \
        str(err) == DG_ABORT.format("dg-abort"), repr(err)
    assert sorted(seen) == [0, 1, 2, 3], sorted(seen)
    assert all(torch.equal(seen[3][k], seen[2][k]) for k in seen[2]), \
        "an all-NaN round moved the weights"
    assert all(torch.equal(job_b.state[k], seen[2][k]) for k in seen[2])
    assert not all(torch.equal(seen[2][k], seen[1][k]) for k in seen[1])
    steps_b = sum(c.num_steps for r in plan.rounds[:4] for c in r.chunks
                  if c.active)
    want_b = dg_plan_launches(layers, steps_b, 4, 0)
    assert counts_b == want_b, (counts_b, want_b)
    dg_add(total, counts_b)
    log(card, f"degraded (b) all-NaN rounds: NaN on every worker at rounds "
        f"2 and 3: the weights after each equal those before round 2 bit "
        f"for bit (the fused merge's raw_count=0 select over "
        f"{2 * JOB_BUCKETS} buckets in 2 launches); abort_after=2 failed the "
        f"job after round 3 with the reference's diagnostic (500): "
        f"{str(err)!r}; wall {wall_b:.3f} s; launches {counts_b} (= the plan "
        f"of rounds 0-3)")

    # (c) quarantine_after 2 + reassignment, NaN on worker 2 at rounds 2-3
    guard_seen, rounds_seen = {}, []   # the guard's quarantine by round

    def watch_for(job):
        def watch(rb):
            rounds_seen.append(rb.round_index)
            g = job._guard
            guard_seen[rb.round_index] = \
                dict(g.quarantined_since) if g else {}
            return rb
        return watch

    fault = json.dumps([{"kind": "nan", "epoch": 0, "round": r, "worker": 2}
                        for r in (2, 3)])
    _, rec_c, counts_c, wall_c = dg_job(
        torch, dg_task("dg-quarantine", 1, DG_N, fault_plan=fault,
                       quarantine_after=2, reassign_on_quarantine=True),
        watch_for)
    assert not isinstance(rec_c, Exception), rec_c
    hist_c = rec_c.data
    assert guard_seen[3] == {} and guard_seen[4] == {2: 4}, guard_seen
    # the host's own makeup plan: what the job must have re-dealt
    loader = RoundLoader(DatasetRegistry().get("tokens"),
                         dg_classes()[1]("tokens"), n_lanes=1, seed=0)
    lplan = loader.plan(DG_N, JOB_K, JOB_B)
    makeup = list(loader.makeup_rounds(lplan, 0, {2: 4}, index_mode=True))
    redealt = int(sum(rb.step_mask.sum() for rb in makeup))
    cover = np.zeros(JOB_TRAIN, np.int64)
    for rb in list(loader.epoch_index_rounds(lplan, 0)) + makeup:
        for w in range(DG_N):
            if w == 2 and rb.round_index >= 4:
                continue
            np.add.at(cover, rb.batch["idx"][w][rb.sample_mask[w] > 0], 1)
    assert (cover == 1).all(), "the makeup rounds missed or repeated samples"
    assert hist_c.quarantined_workers == [1], hist_c.quarantined_workers
    assert hist_c.reassigned_batches == [redealt], \
        (hist_c.reassigned_batches, redealt)
    assert hist_c.dropped_workers == [2.0], hist_c.dropped_workers
    assert rounds_seen == list(range(rounds + len(makeup))), rounds_seen
    orphaned = sum(c.num_steps for r in plan.rounds[4:] for c in r.chunks
                   if c.worker == 2 and c.active)
    want_c = dg_plan_launches(layers, steps - orphaned + redealt,
                              rounds + len(makeup), evals)
    assert counts_c == want_c, (counts_c, want_c)
    dg_add(total, counts_c)
    log(card, f"degraded (c) quarantine + reassignment: NaN on worker 2 at "
        f"rounds 2-3, quarantine_after=2: worker 2 quarantined from round 4 "
        f"({orphaned} of its steps orphaned), {len(makeup)} makeup rounds "
        f"re-dealt {redealt} steps to the survivors, every one of the "
        f"{JOB_TRAIN} windows trained exactly once; quarantined_workers "
        f"{hist_c.quarantined_workers}, reassigned_batches "
        f"{hist_c.reassigned_batches} (= the host's makeup plan), "
        f"dropped {hist_c.dropped_workers}; wall {wall_c:.3f} s; launches "
        f"{counts_c} (= the plan)")

    # the cursor's cost: the same epoch with a round cursor every round
    ms = {}
    for name, opts in (("direct", {}), ("cursor",
                                        {"checkpoint_every_rounds": 1})):
        job, rec, counts, wall = dg_job(
            torch, dg_task(f"dg-{name}", 1, DG_N, **opts))
        assert not isinstance(rec, Exception), rec
        assert counts == dg_plan_launches(layers, steps, rounds, evals)
        dg_add(total, counts)
        ms[name] = 1e3 * rec.data.epoch_duration[0] / steps
    a, b = dg_state("dg-direct"), dg_state("dg-cursor")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    log(card, f"degraded cursor cost: one epoch (N={DG_N}, {steps} local "
        f"steps, {rounds} rounds) {ms['direct']:.3f} ms per local step "
        f"without a cursor, {ms['cursor']:.3f} with a cursor saved every "
        f"round (+{ms['cursor'] - ms['direct']:.3f} ms per local step, "
        f"{(ms['cursor'] - ms['direct']) * steps / rounds:.3f} ms per "
        f"round); same weights bit for bit")
    return total


def dg_children(torch, card, tmp, arrays):
    """(d)-(f): job server children on the card."""
    import os

    from kubeml_tpu_torch.control import ps as ps_mod

    paths = []
    for name, arr in zip(("xtr", "ytr", "xte", "yte"), arrays):
        paths.append(os.path.join(tmp, f"dg_{name}.npy"))
        np.save(paths[-1], arr)
    fn_path = os.path.join(tmp, f"{CP_GPT_FN}.py")
    with open(fn_path, "w") as f:
        f.write(CP_FUNCTIONS[CP_GPT_FN])
    script = os.path.join(tmp, "dg_job.py")
    with open(script, "w") as f:
        f.write(CL_JOB)
    counts = os.path.join(tmp, "dg_launches.jsonl")
    saved = {k: os.environ.get(k) for k in ("KUBEML_HEARTBEAT_INTERVAL",
                                            "KUBEML_HEARTBEAT_MISS_BUDGET")}
    os.environ["KUBEML_HEARTBEAT_INTERVAL"] = str(DG_HEARTBEAT_S)
    os.environ["KUBEML_HEARTBEAT_MISS_BUDGET"] = str(DG_MISS_BUDGET)
    real_sub = ps_mod.subprocess
    ps_mod.subprocess = JobWrapper(script, counts)
    try:
        return dg_standalone(torch, card, tmp, paths, fn_path, counts)
    finally:
        ps_mod.subprocess = real_sub
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dg_rows(counts, job_id):
    with open(counts) as f:
        rows = [json.loads(line) for line in f]
    return [{k: r[k] for k in ("forward", "dK/dV", "dQ", "fused_merge",
                               "merge segments")}
            for r in rows if r["job"] == job_id]


def dg_lifecycle(get, want):
    """The history's (restarts, preemptions) once the PS has stamped them:
    the job writes its history first and the PS stamps its counts just
    after it deregisters the job, so a read in between sees zeros. Waits
    up to a minute for ``want``, then returns what is there."""
    deadline = time.perf_counter() + 60
    while True:
        hist = get()
        got = (hist["restarts"], hist["preemptions"]) \
            if isinstance(hist, dict) else (hist.restarts, hist.preemptions)
        if got == want or time.perf_counter() > deadline:
            return got
        time.sleep(0.1)


def dg_direct(torch, job_id, req, n):
    from kubeml_tpu_torch.api.types import TrainTask
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.train.job import TrainJob

    dg_counts(zero=True)
    TrainJob(TrainTask(job_id=job_id, parameters=req, parallelism=n),
             get_model("gpt-mini")(), token_dataset(), device="cuda").train()
    return dg_counts(zero=True)


def dg_standalone(torch, card, tmp, paths, fn_path, counts):
    """(d) a crash event and (f) a wedged child, each in a job server
    child of an in-process deployment, restarted from its cursor, while
    (e) runs in phase 15's serve child beside them (each sub-phase is
    mostly cold child starts, so they overlap)."""
    import json
    import os
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment

    total = {"forward": 0, "dK/dV": 0, "dQ": 0, "fused_merge": 0,
             "merge segments": 0}
    dep = start_deployment(standalone_jobs=True)
    stopped = []
    n = DG_VICTIM_N
    beside = ThreadPoolExecutor(1)
    try:
        client = KubemlClient(dep.controller_url).v1()
        client.functions().create(CP_GPT_FN, fn_path)
        client.datasets().create("tokens", *paths)
        # the uninterrupted job (d), (e) and (f) must end equal to
        dg_add(total, dg_direct(torch, "dg-direct", dg_request(1, n), n))
        cluster = beside.submit(dg_cluster, torch, card, tmp)

        # (d) os._exit at round 5, restarted by the watchdog from its
        # cursor; (f) beside it, a child silenced mid-round (SIGSTOP in a
        # slow round) is reaped by the liveness reaper and restarted from
        # its cursor (a slow round alone keeps beating: heartbeats have
        # their own thread). The two children share the card.
        t0 = time.perf_counter()
        crash = json.dumps([{"kind": "crash", "epoch": 0, "round": 5}])
        slow = json.dumps([{"kind": "slow", "epoch": 0, "round": 5,
                            "duration_s": DG_SLOW_S}])
        job_d = client.networks().train(dg_request(
            1, n, fault_plan=crash, checkpoint_every_rounds=2))
        job_f = client.networks().train(dg_request(
            1, n, fault_plan=slow, checkpoint_every_rounds=2))

        def at_round5():
            with dep.ps._jobs_lock:
                rec = dep.ps.jobs.get(job_f)
                return rec is not None and rec.proc is not None and \
                    rec.heartbeat_progress == (0, 5) and rec
        poll(at_round5, "(f)'s child in its slow round 5", 600)
        rec = at_round5()
        pid = rec.proc.pid
        os.kill(pid, signal.SIGSTOP)
        stopped.append(pid)
        t_stop = time.perf_counter()
        poll(lambda: rec.proc is not None and rec.proc.pid != pid
             or job_f not in dep.ps.jobs, "the reaper's restart", 120)
        reaped = time.perf_counter() - t_stop
        stopped.remove(pid)     # killed and reaped: its pid is not ours
        cp_wait(client, dep, job_d)
        wall_d = time.perf_counter() - t0
        cp_wait(client, dep, job_f)
        wall_f = time.perf_counter() - t0
        for job in (job_d, job_f):
            got = dg_lifecycle(lambda: client.histories().get(job).data,
                               (1, 0))
            assert got == (1, 0), (job, got)
            assert equal_checkpoints(job, "dg-direct"), \
                f"{job}'s restart differs from the uninterrupted job"
        wedged = dep.ps.metrics.wedged_total.collect()
        assert 'kubeml_ps_wedged_kills_total{type="standalone"} 1' in wedged
        rows_d, rows_f = dg_rows(counts, job_d), dg_rows(counts, job_f)
        for row in rows_d + rows_f:
            dg_add(total, row)
        log(card, f"degraded (d) crash + resume: a job server child (N="
            f"{n}, checkpoint_every_rounds=2) died at round 5 "
            f"(os._exit(23)); the watchdog restarted it from the round-4 "
            f"cursor: restarts 1, final weights equal bit "
            f"for bit to the uninterrupted job; wall {wall_d:.3f} s (two "
            f"child starts, beside (f)); the restarted child's launches "
            f"{rows_d}")
        log(card, f"degraded (f) reaper: the child (pid {pid}) stopped "
            f"(SIGSTOP) in its slow round 5 at heartbeat (0, 5); the reaper "
            f"({DG_HEARTBEAT_S} s beats x {DG_MISS_BUDGET} misses) killed it "
            f"and the watchdog respawned it {reaped:.3f} s after the stop; "
            f"restarts 1, kubeml_ps_wedged_kills_total 1, "
            f"final weights equal bit for bit to the uninterrupted job; "
            f"wall {wall_f:.3f} s (beside (d)); the restarted child's "
            f"launches {rows_f}")
        dg_add(total, cluster.result())
    finally:
        for pid in stopped:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        beside.shutdown(wait=True)   # (e) stops its serve child itself
        dep.stop()
    return total


def dg_cluster(torch, card, tmp):
    """(e): a priority-1 arrival preempts a running N=2 job in phase 15's
    cluster-mode serve child (over the function, windows and direct job
    (d) left in this home); the victim drains, requeues, re-places and
    resumes from its cursor."""
    import json
    import os

    from kubeml_tpu_torch.control.client import KubemlClient

    total = {"forward": 0, "dK/dV": 0, "dQ": 0, "fused_merge": 0,
             "merge segments": 0}
    sub = os.path.join(tmp, "cluster")
    os.makedirs(sub)
    serve = ClusterServe(sub)
    serve.env.update({"KUBEML_HEARTBEAT_INTERVAL": str(DG_HEARTBEAT_S),
                      "KUBEML_HEARTBEAT_MISS_BUDGET": "1000"})
    try:
        t0 = time.perf_counter()
        serve.start()
        client = KubemlClient(serve.url).v1()
        # slow rounds from round 6 keep the victim mid-epoch long enough
        # for the arrival to find it there (no effect on the weights)
        slow = json.dumps([{"kind": "slow", "epoch": 0, "round": r,
                            "duration_s": 0.3} for r in range(6, 16)])
        victim_req = dg_request(1, DG_VICTIM_N, fault_plan=slow)
        victim_req.tenant = "batch"
        victim = client.networks().train(victim_req)

        def heartbeat_round():
            for line in serve.text(serve.ps + "/metrics").splitlines():
                if line.startswith("kubeml_job_heartbeat_round{jobid="
                                   f'"{victim}"}}'):
                    return float(line.split()[-1])
            return -1.0
        poll(lambda: heartbeat_round() >= 4, "the victim's round 4", 600)
        arrival_req = dg_request(1, CL_LANES)
        arrival_req.tenant, arrival_req.priority = "batch", 1
        t_arrive = time.perf_counter()
        arrival = client.networks().train(arrival_req)
        poll(lambda: arrival in cl_gangs(serve), "the arrival's gang", 300)
        t_requeued = time.perf_counter()   # placed on the victim's lanes
        poll(lambda: victim in cl_gangs(serve), "the victim's re-place",
             600)
        t_replaced = time.perf_counter()

        def history(job_id):
            from kubeml_tpu_torch.api.errors import KubeMLException
            try:
                return serve.get(f"/history/{job_id}")["data"]
            except KubeMLException as e:
                if e.status_code != 404:
                    raise
                return None
        # a requeued job leaves the PS's task list for a while: wait on
        # its history, not on the list
        poll(lambda: history(victim) is not None, "the victim's end", 600)
        t_done = time.perf_counter()
        poll(lambda: history(arrival) is not None, "the arrival's end", 600)
        got = dg_lifecycle(lambda: history(victim), (0, 1))
        assert got == (0, 1), (victim, got)
        hist_v, hist_a = history(victim), history(arrival)
        assert len(hist_v["train_loss"]) == 1
        assert len(hist_a["train_loss"]) == 1
        snap = serve.get("/cluster")
        assert snap["cluster_preemptions_total"] == 1, snap
        text = serve.text(serve.ps + "/metrics")
        assert 'kubeml_ps_preemptions_total{type="standalone"} 1' in text
        assert equal_checkpoints(victim, "dg-direct"), \
            "the preempted victim's weights differ from the uninterrupted job"
        rows = dg_rows(serve.counts, victim) + dg_rows(serve.counts, arrival)
        for row in rows:
            dg_add(total, row)
        log(card, f"degraded (e) preemption: in phase 15's cluster-mode "
            f"serve child ({CL_LANES} lanes) a priority-1 N={CL_LANES} "
            f"arrival preempted the running N={DG_VICTIM_N} job {victim} at "
            f"its round >= 4: SIGTERM -> drain at a round -> /preempted -> "
            f"/requeue in {t_requeued - t_arrive:.3f} s (arrival POST -> its "
            f"gang on the freed lanes); requeue -> re-place "
            f"{t_replaced - t_requeued:.3f} s (the arrival's run); re-place "
            f"-> done {t_done - t_replaced:.3f} s; restarts 0, preemptions 1, "
            f"kubeml_cluster_preemptions_total 1, the victim's final "
            f"weights equal bit for bit to the uninterrupted job; wall "
            f"{t_done - t0:.3f} s; launches of the published epochs {rows}")
    finally:
        serve.stop()
    return total


# ----------------------------------------------------------------- phase 17
COST_CASES = ("threaded", "child")


def phase_cost(torch, card, seed, module, job_ms=None):
    """The cost ledger and the runtime metrics on the card (see the module
    docstring, phase 17); returns each kernel's launches over (a) and
    (c)."""
    import os
    import tempfile

    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "home")
        try:
            t0 = time.perf_counter()
            launches, docs = cost_jobs(torch, card, seed, tmp, module,
                                       job_ms)
            launches["paged_attention"] = cost_serve(card, seed, module)
            a, b = ({k: v for k, v in d.items() if k != "id"}
                    for d in docs)
            assert a == b, "the child's /cost differs from the threaded job's"
            log(card, f"cost (b): the job-server child's /cost document "
                f"(posted through POST /metrics) equals the threaded job's "
                f"but for its id ({len(a['programs'])} programs)")
            log(card, f"cost phase: {time.perf_counter() - t0:.3f} s; "
                f"launches over phase 17: {launches}")
            return launches
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home


def cost_series(text, family, **labels):
    """The value of the one series of ``family`` carrying these label
    values in a Prometheus text (0.0 when it is absent)."""
    for line in text.splitlines():
        if line.startswith(family + "{") and all(
                f'{k}="{v}"' in line for k, v in labels.items()):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def cost_host_probe():
    """Time the ledger's and the tracker's host work in this process
    (the engine's per-dispatch accounting, the tracker's note, the job's
    snapshot and the watermark's sample); returns (seconds list,
    restore)."""
    from kubeml_tpu_torch.metrics.runtime import (HbmWatermark,
                                                  JitCompileTracker)
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine
    from kubeml_tpu_torch.train.job import TrainJob

    spent = [0.0]
    targets = ((KAvgEngine, "_account"), (JitCompileTracker, "note"),
               (TrainJob, "_cost_snapshot"), (HbmWatermark, "sample"))
    orig = {t: getattr(*t) for t in targets}

    def wrap(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t0
        return call

    for cls, name in targets:
        setattr(cls, name, wrap(orig[(cls, name)]))

    def restore():
        for (cls, name), fn in orig.items():
            setattr(cls, name, fn)
    return spent, restore


def cost_jobs(torch, card, seed, tmp, module, job_ms):
    """(a) one epoch of phase 10's task at static N=2 as a threaded job of
    an in-process deployment, (b) the same in a job-server child; returns
    (a)'s launches and both /cost documents."""
    import contextlib
    import io
    import os

    from kubeml_tpu_torch.cli.main import main as cli_main
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.models.base import module_state
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm
    from kubeml_tpu_torch.parallel.merge import merge_comm_proxy

    fn_path = os.path.join(tmp, f"{CP_GPT_FN}.py")
    with open(fn_path, "w") as f:
        f.write(CP_FUNCTIONS[CP_GPT_FN])
    rng = np.random.default_rng(seed + 12)        # phase 10's windows
    arrays = (token_windows(rng, JOB_TRAIN, TRAIN_T),
              np.zeros(JOB_TRAIN, np.int32),
              token_windows(rng, JOB_TEST, TRAIN_T),
              np.zeros(JOB_TEST, np.int32))
    paths = []
    for name, arr in zip(("xtr", "ytr", "xte", "yte"), arrays):
        paths.append(os.path.join(tmp, f"cost_{name}.npy"))
        np.save(paths[-1], arr)
    kernels = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
               "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
               "merge segments": MergeSegments()}
    req = cp_request(CP_GPT_FN, "tokens", 1, JOB_B, JOB_LR, k=JOB_K,
                     default_parallelism=JOB_N0, static_parallelism=True,
                     merge_bucket_mb=MERGE_CAP_MB)
    layers = module.layers
    steps, rounds, evals = _epoch_counts(JOB_N0, JOB_N0, JOB_TRAIN,
                                         JOB_TEST)
    proxy = merge_comm_proxy(module_state(module), None, MERGE_CAP_MB)
    docs, launches = [], None
    for case in COST_CASES:
        # each deployment its own home: datasets and functions are per home
        os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, case)
        dep = start_deployment(device=None,
                               standalone_jobs=case == "child")
        try:
            client = KubemlClient(dep.controller_url).v1()
            client.functions().create(CP_GPT_FN, fn_path)
            client.datasets().create("tokens", *paths)
            seen = []

            def hook(m):
                # the epoch's end, in the job's process: the watermark's
                # sample was the last device-side read before it
                seen.append((m, torch.cuda.max_memory_allocated(),
                             dep.ps.metrics.exposition(),
                             {k: fn.launches for k, fn in kernels.items()}))
            unhook = on_publish(dep.ps, hook)
            spent, unprobe = cost_host_probe()
            for fn in kernels.values():
                fn.launches = 0          # the main path's run starts here
            try:
                job_id = client.networks().train(req)
                hist = cp_wait(client, dep, job_id).data
            finally:
                unhook()
                unprobe()
            doc = http_json("GET", f"{dep.ps.url}/cost?id={job_id}")
            assert client.cost().get(job_id) == doc, "controller /cost"
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli_main(["--controller", dep.controller_url, "cost",
                          "--id", job_id, "--json"])
            assert json.loads(out.getvalue()) == doc, "kubeml cost --json"
            text = urllib_get(f"{dep.ps.url}/metrics")
        finally:
            dep.stop()
        progs = doc["programs"]
        train = {k: e for k, e in progs.items()
                 if k.startswith("kavg.train")}
        merge = progs["merge.bucketed"]
        assert sum(e["dispatches"] for e in train.values()) == rounds, \
            (train, rounds)
        assert sum(e["samples"] for e in train.values()) == JOB_TRAIN, train
        assert progs["kavg.eval"]["samples"] == JOB_TEST, progs["kavg.eval"]
        assert merge["hbm_bytes"] == proxy["merge_payload_bytes"], \
            (merge, proxy)
        assert merge["argument_bytes"] == proxy["buckets_per_round"] == \
            JOB_BUCKETS, merge
        for program, e in progs.items():
            for family, field_ in (
                    ("kubeml_cost_dispatches_total", "dispatches"),
                    ("kubeml_cost_flops_total", "flops_total"),
                    ("kubeml_cost_hbm_bytes_total", "hbm_bytes_total")):
                got = cost_series(text, family, program=program)
                assert got == e[field_], (program, family, got, e[field_])
        keys = sum(1 + e["recaptures"] for e in train.values())
        docs.append(doc)
        if case == "child":
            log(card, f"cost (b) child job {job_id}: /cost, the "
                f"controller's /cost/{{jobId}} and kubeml cost --json give "
                f"one document; kavg.train* dispatches {rounds}, samples "
                f"{JOB_TRAIN}; the kubeml_cost_* lines equal it; epoch "
                f"{hist.epoch_duration[0]:.4f} s in the child")
            continue
        (m, peak, expo, counts), = seen
        launches = counts
        want = {"forward": layers * (steps + evals), "dK/dV": layers * steps,
                "dQ": layers * steps,
                **merge_counts(merge["argument_bytes"], rounds)}
        assert counts == want, (counts, want)
        assert m.jit_compiles == keys == 1, (m.jit_compiles, keys)
        assert cost_series(expo, "kubeml_jit_compiles_total",
                           jobid=job_id) == keys
        # (d): the job's sampled peak is the allocator's, read here
        got_peak = cost_series(expo, "kubeml_device_hbm_bytes",
                               jobid=job_id, kind="peak")
        assert m.hbm_peak_bytes == got_peak == peak, \
            (m.hbm_peak_bytes, got_peak, peak)
        sec = hist.epoch_duration[0]
        att = doc["attributed"]["train"]
        phase10 = (f"{job_ms[0]:.3f} ms in phase 10's epoch 1 (the same "
                   f"task, N={JOB_N0})" if job_ms else "phase 10 not run")
        log(card, f"cost (a) threaded job {job_id}: {steps} local steps in "
            f"{rounds} rounds, epoch {sec:.4f} s = {1e3 * sec / steps:.3f} "
            f"ms per local step against {phase10}; the ledger and the "
            f"tracker's host work {1e6 * spent[0]:.1f} us over the epoch = "
            f"{1e6 * spent[0] / rounds:.2f} us per round")
        log(card, f"cost (a): /cost, /cost/{{jobId}} and kubeml cost --json "
            f"give one document: kavg.train* dispatches {rounds} = the "
            f"rounds, samples {JOB_TRAIN}; merge.bucketed {merge['hbm_bytes']:.0f}"
            f" B = comm_proxy, {merge['argument_bytes']} buckets a round; "
            f"launches {counts} = {layers} layers x {steps} steps (+ {evals} "
            f"eval slots), {merge['argument_bytes']} x {rounds} rounds; "
            f"jit_compiles {m.jit_compiles} = distinct round keys; "
            f"{att['flops_per_sample']:.6g} flops/sample, "
            f"{att['bytes_per_sample']:.6g} bytes/sample (closed form); "
            f"the kubeml_cost_* lines equal the document")
        log(card, f"cost (d): kubeml_device_hbm_bytes{{kind=peak}} "
            f"{got_peak:.0f} = torch.cuda.max_memory_allocated() {peak} at "
            f"the epoch's end ({peak / 2**20:.1f} MiB); in use "
            f"{m.hbm_in_use_bytes}")
    return launches, docs


def cost_serve(card, seed, module):
    """(c) phase 14's batch (its 7 prompts, then the shared prompt again
    once its first copy has a token) as 8 concurrent POST /generate
    streams on a 2-replica fleet, bf16 pages; returns the paged kernel's
    launches."""
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.metrics.ledger import merge_cost_snapshots
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    prompts, shared = batch_prompts(seed, module.vocab_size)
    save_mini(seed)
    dep = start_deployment(serve_slots=8, serve_prefill_chunk=16,
                           serve_kv_dtype="f32", serve_prefix_cache=True,
                           serve_replicas_min=2, serve_replicas_max=2)
    try:
        url = dep.ps.url
        paged_attention.launches = 0      # the main path's run starts here
        streams = [GenStream(url, gen_body(p, NEW_TOKENS)).start()
                   for p in prompts]
        streams[prompts.index(shared)].first.wait(300)
        streams.append(GenStream(url, gen_body(shared, NEW_TOKENS)).start())
        for st in streams:
            st.join()
        launches = paged_attention.launches     # ... and ends here
        assert all(st.status == 200 for st in streams), \
            [(st.status, st.last) for st in streams]
        doc = http_json("GET", f"{url}/cost?id=serve:{PS_MODEL}")
        engines = dep.ps._serve[PS_MODEL][1].engines()
        per = [eng.ledger.snapshot() for _, eng in engines]
        kv = [eng.slab.decode_bytes_per_token for _, eng in engines]
    finally:
        dep.stop()
    progs = doc["programs"]
    dec, pre = progs["serve.decode"], progs["serve.prefill"]
    dispatches = dec["dispatches"] + pre["dispatches"]
    assert module.layers * dispatches == launches, (launches, dispatches)
    tokens = sum(len(st.tokens) for st in streams)
    assert dec["tokens"] == tokens == len(streams) * NEW_TOKENS, \
        (dec["tokens"], tokens)
    assert len(per) == 2, len(per)
    merged = merge_cost_snapshots(per)
    for name, e in progs.items():
        for k in ("dispatches", "tokens", "samples", "flops_total",
                  "hbm_bytes_total"):
            assert e[k] == sum(p[name][k] for p in per if name in p) \
                == merged[name][k], (name, k)
    for b, snap in zip(kv, per):
        assert snap["pager.decode_kv"]["hbm_bytes"] == float(b), (snap, b)
    att = doc["attributed"]["serve"]
    log(card, f"cost (c): {len(streams)} concurrent POST /generate on 2 "
        f"replicas, bf16 pages: /cost?id=serve:{PS_MODEL} decode "
        f"{dec['dispatches']} + prefill {pre['dispatches']} dispatches, x "
        f"{module.layers} layers = {launches} paged-kernel launches; tokens "
        f"{tokens}; the fleet's totals = the sum over its replicas "
        f"({[p['serve.decode']['dispatches'] for p in per]} decode "
        f"dispatches); pager.decode_kv {progs['pager.decode_kv']['hbm_bytes']:.0f}"
        f" B = the slab's decode_bytes_per_token; "
        f"{att['flops_per_token']:.6g} flops/token, "
        f"{att['bytes_per_token']:.6g} bytes/token (closed form)")
    return launches


# ----------------------------------------------------------------- phase 18
CT_GENS = (256, 128, 128)   # token windows of generations 1, 2 and 3
CT_WINDOW = 2               # --window-generations: gen 3 slides gen 1 out
CT_WINDOWS = {1: 256, 2: 384, 3: 256}    # the window each generation trains
CT_PUBLISH = 1              # --publish-every-rounds (2-3 rounds an epoch)
CT_EPOCHS = 40              # -e: a cap; the phase stops the job after the
                            # first epoch that trains generation 3
CT_SHORT, CT_LONG = 16, 64  # new tokens of the serving client's streams
CT_PAUSE = 0.25             # seconds between one client thread's streams
CT_DIRECT = 6               # streams that spanned a swap, held to a direct run
CT_IMAGES, CT_TEST_IMAGES = 8192, 2048   # (b): images a generation, test
CT_VIS_EPOCHS = 4           # (b): gen 1; gens 1-2 twice; gens 2-3


def phase_continual(torch, card, seed):
    """The continual mode on the card (see the module docstring, phase
    18); returns each kernel's launches over (a) and (b)."""
    import os
    import tempfile

    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "home")
        try:
            t0 = time.perf_counter()
            launches = ct_serve_train(torch, card, seed, tmp)
            t1 = time.perf_counter()
            os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "vision")
            launches["fused_merge"] = {
                "gpt-mini": launches["fused_merge"],
                "resnet18": ct_vision(torch, card, seed)}
            log(card, f"continual phase: {time.perf_counter() - t0:.3f} s "
                f"((a) {t1 - t0:.3f} s); launches over phase 18: "
                f"{launches}")
            return launches
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home


class CtCli:
    """One `kubeml` process against the controller, run on a thread from
    construction: result() joins it and returns its stdout; ``exited`` is
    the perf_counter of its exit."""

    def __init__(self, url, *argv):
        import threading

        self.argv, self.out, self.error, self.exited = argv, None, None, None
        self.thread = threading.Thread(target=self._run, args=(url,),
                                       daemon=True)
        self.thread.start()

    def _run(self, url):
        import os

        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        p = subprocess.run(
            [sys.executable, "-m", "kubeml_tpu_torch.cli", "--controller",
             url, *self.argv], env=env, cwd=repo, capture_output=True,
            text=True, timeout=600)
        self.exited, self.out = time.perf_counter(), p.stdout
        if p.returncode != 0:
            self.error = (f"kubeml {' '.join(self.argv)} exited "
                          f"{p.returncode}: {p.stderr.strip()[-2000:]}")

    def result(self) -> str:
        self.thread.join(600)
        assert not self.thread.is_alive(), f"kubeml {self.argv} hung"
        if self.error:
            raise RuntimeError(self.error)
        return self.out


class CtClient:
    """Greedy POST /generate streams for one model on two threads until
    stop(), CT_PAUSE apart on a thread: each a fresh random prompt,
    alternately CT_SHORT and CT_LONG new tokens. The first stream runs
    alone, so one fleet is built."""

    def __init__(self, url, model, vocab, seed):
        import threading

        self.url, self.model, self.vocab, self.seed = url, model, vocab, seed
        self.done = threading.Event()
        self.streams = []            # (prompt, n, GenStream)
        self.threads = [threading.Thread(target=self._loop, args=(i,),
                                         daemon=True) for i in (0, 1)]

    def _one(self, rng, n):
        prompt = rng.integers(1, self.vocab,
                              int(rng.integers(8, 64))).tolist()
        st = GenStream(self.url, {"model_id": self.model, "prompt": prompt,
                                  "max_new_tokens": n}).start().join()
        assert st.status == 200 and len(st.tokens) == n, (st.status, st.last)
        self.streams.append((prompt, n, st))

    def first(self):
        """The first stream, alone: it builds the fleet."""
        self._one(np.random.default_rng(self.seed + 99), CT_SHORT)
        return self

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def _loop(self, i):
        rng = np.random.default_rng(self.seed + 100 + i)
        k = 0
        while not self.done.wait(CT_PAUSE):
            self._one(rng, CT_LONG if (k + i) % 2 else CT_SHORT)
            k += 1

    def stop(self):
        self.done.set()
        for t in self.threads:
            t.join(600)
            assert not t.is_alive(), "a serving client thread hung"


def ct_probe():
    """Record, in this process: each DecodeEngine's weights by generation
    (its construction's and each install's state dict), every attach's
    (prompt, generation, wall time), the prompts in flight at an install,
    the fleet's installed stamps, each registry commit's perf_counter by
    generation and each continual window slide (perf_counter, generation,
    the job's train samples and base, the registry's windowed handle's
    samples). Returns (record, restore)."""
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.fleet import ServeFleet
    from kubeml_tpu_torch.train.job import TrainJob

    rec = {"weights": {}, "attach": [], "spanning": set(), "stamps": [],
           "commits": {}, "slides": []}
    targets = ((DecodeEngine, "__init__"), (DecodeEngine, "attach"),
               (DecodeEngine, "install_weights"),
               (ServeFleet, "install_weights"),
               (DatasetRegistry, "append"), (TrainJob, "_continual_refresh"))
    real = {t: getattr(*t) for t in targets}

    def init(self, module, *a, **k):
        real[targets[0]](self, module, *a, **k)
        variables = k.get("variables", a[0] if a else None)
        rec["weights"][1] = (variables if variables is not None
                             else module.state_dict())

    def attach(self, req):
        s = real[targets[1]](self, req)
        rec["attach"].append((tuple(req.prompt), self._slots[s].gen,
                              time.time()))
        return s

    def install(self, variables):
        rec["spanning"].update(tuple(sl.req.prompt) for sl in self._slots
                               if sl is not None)
        gen = real[targets[2]](self, variables)
        rec["weights"][gen] = variables
        return gen

    def fleet_install(self, variables, stamp=None):
        rec["stamps"].append(stamp)
        return real[targets[3]](self, variables, stamp)

    def append(self, name, *a, **k):
        h = real[targets[4]](self, name, *a, **k)
        rec["commits"][h.generation] = time.perf_counter()
        return h

    def refresh(self, epoch):
        before = self._trained_generation
        real[targets[5]](self, epoch)
        if self._trained_generation != before:
            held = self.registry.get(
                self.req.dataset, window_generations=self._window_generations)
            rec["slides"].append((time.perf_counter(),
                                  self._trained_generation,
                                  self._handle.train_samples,
                                  self._handle.train_base,
                                  held.train_samples))

    for t, fn in zip(targets, (init, attach, install, fleet_install, append,
                               refresh)):
        setattr(*t, fn)

    def restore():
        for t, fn in real.items():
            setattr(*t, fn)
    return rec, restore


def ct_serve_train(torch, card, seed, tmp):
    """(a): gpt-mini through an in-process deployment driven by `kubeml`
    processes (dataset create, train --continual, two dataset appends
    while it trains) and a serving client on the job's published weights.
    Returns the kernels' launches."""
    import os

    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    fn_path = os.path.join(tmp, f"{CP_GPT_FN}.py")
    with open(fn_path, "w") as f:
        f.write(CP_FUNCTIONS[CP_GPT_FN])
    rng = np.random.default_rng(seed + 18)
    arrays = [token_windows(rng, n, TRAIN_T) for n in CT_GENS] \
        + [token_windows(rng, JOB_TEST, TRAIN_T)]
    paths = []
    for i, x in enumerate(arrays):
        for kind, a in (("x", x), ("y", np.zeros(len(x), np.int32))):
            paths.append(os.path.join(tmp, f"ct_{kind}{i}.npy"))
            np.save(paths[-1], a)
    # paths: x0 y0 x1 y1 x2 y2 (generations 1-3) xt yt (the test split)
    cfg = GPT_CONFIGS["gpt-mini"]
    kernels = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
               "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
               "merge segments": MergeSegments()}
    t0 = time.perf_counter()
    dep = start_deployment(device=None, serve_slots=8,
                           serve_prefill_chunk=16, serve_kv_dtype="f32",
                           serve_prefix_cache=True)
    rec, restore = ct_probe()
    epochs, appends, client, job = [], {}, None, {}
    try:
        url = dep.controller_url
        KubemlClient(url).v1().functions().create(CP_GPT_FN, fn_path)
        CtCli(url, "dataset", "create", "-n", "tokens", "--traindata",
              paths[0], "--trainlabels", paths[1], "--testdata", paths[6],
              "--testlabels", paths[7]).result()

        def hook(m):
            # the epoch's end, on the job's thread
            epochs.append((m.dataset_generation, m.data_lag_generations,
                           {k: fn.launches for k, fn in kernels.items()},
                           m.epoch_duration, m.train_loss))
            for fn in kernels.values():
                fn.launches = 0
            gen = m.dataset_generation
            if gen < len(CT_GENS) and gen + 1 not in appends:
                # the next generation, appended while the job trains on
                appends[gen + 1] = CtCli(
                    url, "dataset", "append", "-n", "tokens", "--traindata",
                    paths[2 * gen], "--trainlabels", paths[2 * gen + 1])
            if gen == len(CT_GENS):
                # the first epoch on generation 3: stop at its boundary
                http_json("DELETE", f"{url}/tasks/{m.job_id}")
        unhook = on_publish(dep.ps, hook)
        for fn in kernels.values():
            fn.launches = 0              # the main path's run starts here
        job_id = CtCli(
            url, "train", "-f", CP_GPT_FN, "-d", "tokens", "-e",
            str(CT_EPOCHS), "-b", str(JOB_B), "--lr", str(JOB_LR), "-K",
            str(JOB_K), "-p", str(JOB_N0), "--static", "--merge-bucket-mb",
            str(MERGE_CAP_MB), "--goal-accuracy", "200", "--continual",
            "--window-generations", str(CT_WINDOW),
            "--publish-every-rounds", str(CT_PUBLISH)).result().strip()
        wait_until(lambda: read_manifest(job_id) is not None,
                   "the job's first publish", timeout=600)
        paged_attention.launches = 0     # the serving run starts here
        client = CtClient(dep.ps.url, job_id, cfg["vocab_size"],
                          seed).first()
        job["stamp1"] = dep.ps._serve[job_id][0]      # generation 1's
        client.start()
        hist = cp_wait(KubemlClient(url).v1(), dep, job_id).data
        client.stop()
        job["paged"] = paged_attention.launches       # ... and ends here
        unhook()
        for a in appends.values():
            a.result()
        job["cost"] = http_json("GET", f"{dep.ps.url}/cost?id=serve:{job_id}")
        job["gauge"] = [
            ln for ln in urllib_get(f"{dep.ps.url}/metrics").splitlines()
            if ln.startswith("kubeml_serve_weight_generation{")]
        (_, job["engine"]), = dep.ps._serve[job_id][1].engines()
    finally:
        if client is not None:
            client.done.set()
        restore()
        dep.stop()
    job["seconds"] = time.perf_counter() - t0
    return ct_check(card, job_id, hist, epochs, appends, rec, client, job)


def ct_check(card, job_id, hist, epochs, appends, rec, client, job):
    """(a)'s checks and numbers; returns the kernels' launches."""
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    layers = GPT_CONFIGS["gpt-mini"]["layers"]
    gens = [e[0] for e in epochs]
    assert [(g, lag) for g, lag, *_ in epochs][-1] == (3, 0), epochs
    assert all(lag == 0 for _, lag, *_ in epochs), epochs
    assert gens == sorted(gens) and set(gens) == {1, 2, 3}, gens
    assert len(hist.train_loss) == len(epochs), (hist.train_loss, epochs)
    launches = {k: 0 for k in epochs[0][2]}
    for gen, _, counts, sec, loss in epochs:
        steps, rounds, evals = _epoch_counts(JOB_N0, JOB_N0, CT_WINDOWS[gen],
                                             JOB_TEST)
        want = {"forward": layers * (steps + evals),
                "dK/dV": layers * steps, "dQ": layers * steps,
                **merge_counts(JOB_BUCKETS, rounds)}
        assert counts == want, (gen, counts, want)
        for k, n in counts.items():
            launches[k] += n
    # each slide: the job's window is the registry's windowed handle
    slides = {g: (t, n, base, held) for t, g, n, base, held in rec["slides"]}
    assert sorted(slides) == [2, 3], rec["slides"]
    for g, (_, n, base, held) in slides.items():
        assert n == held == CT_WINDOWS[g], (g, n, held)
    assert slides[3][2] == CT_GENS[0], slides          # gen 1 slid out
    lat = {g: (slides[g][0] - appends[g].exited,
               slides[g][0] - rec["commits"][g]) for g in slides}
    by_gen = {}
    for g, _, _, sec, loss in epochs:
        by_gen.setdefault(g, []).append((sec, loss))
    for g, rows in by_gen.items():
        steps = _epoch_counts(JOB_N0, JOB_N0, CT_WINDOWS[g], JOB_TEST)[0]
        log(card, f"continual (a) generation {g}: {len(rows)} epoch(s) over "
            f"a window of {CT_WINDOWS[g]} windows of {TRAIN_T} tokens, "
            f"{steps} local steps each; epoch seconds "
            f"{[round(s, 4) for s, _ in rows]}, ms per local step "
            f"{[round(1e3 * s / steps, 3) for s, _ in rows]}, train loss "
            f"{[round(x, 4) for _, x in rows]}")
    for g, (after_exit, after_commit) in lat.items():
        log(card, f"continual (a) dataset append of generation {g}: its "
            f"window slid {after_exit:.4f} s after `kubeml dataset append` "
            f"exited ({after_commit:.4f} s after the storage service "
            f"committed it); the next epoch trained it")
    # serving: one generation per new stamp, the gauge, the tokens
    engine = job["engine"]
    stamps = [job["stamp1"]] + rec["stamps"]
    assert len(stamps) >= 3 and stamps == sorted(set(stamps)), stamps
    assert engine.weight_generation == len(stamps), \
        (engine.weight_generation, stamps)
    assert job["gauge"] == [
        f'kubeml_serve_weight_generation{{model="{job_id}"}} '
        f'{float(len(stamps))}'], job["gauge"]
    first = {}
    for prompt, gen, t in rec["attach"]:
        first.setdefault(gen, t)
    swap_s = [first[g] - stamps[g - 1] for g in range(2, len(stamps) + 1)
              if g in first]
    gen_of = {p: g for p, g, _ in rec["attach"]}
    spanning = [(p, n, st) for p, n, st in client.streams
                if tuple(p) in rec["spanning"]]
    assert spanning, "no stream was in flight at a swap"
    checked = spanning[:CT_DIRECT]
    for (p, n, st) in checked:
        g = gen_of[tuple(p)]
        want = direct_tokens(engine.module, [p], n,
                             variables=rec["weights"][g])[0]
        assert st.tokens == want, (g, st.tokens, want)
    progs = job["cost"]["programs"]
    dec, pre = progs["serve.decode"], progs["serve.prefill"]
    dispatches = dec["dispatches"] + pre["dispatches"]
    assert layers * dispatches == job["paged"], (job["paged"], dispatches)
    tokens = sum(len(st.tokens) for _, _, st in client.streams)
    assert dec["tokens"] == tokens, (dec["tokens"], tokens)
    log(card, f"continual (a) serving job {job_id}: {len(client.streams)} "
        f"greedy POST /generate streams ({tokens} tokens) on the job's "
        f"published weights while it trained; {len(stamps)} saved_at stamps "
        f"installed = kubeml_serve_weight_generation {len(stamps)} (one a "
        f"stamp, the same engine); {len(spanning)} stream(s) in flight at a "
        f"swap, {len(checked)} of them equal to a direct DecodeEngine on the "
        f"weights they attached under; publish -> first admission on it "
        f"{[round(s, 4) for s in swap_s]} s (min {min(swap_s):.4f}, median "
        f"{statistics.median(swap_s):.4f}, max {max(swap_s):.4f}); paged "
        f"kernel launches {job['paged']} = {layers} layers x ({dec['dispatches']}"
        f" decode + {pre['dispatches']} prefill dispatches)")
    log(card, f"continual (a) job {job_id} through `kubeml train --continual "
        f"-e {CT_EPOCHS} --window-generations {CT_WINDOW} "
        f"--publish-every-rounds {CT_PUBLISH} --goal-accuracy 200`: "
        f"{len(epochs)} epochs, "
        f"(dataset_generation, data_lag_generations) by epoch "
        f"{[(g, lag) for g, lag, *_ in epochs]}; flash and merge launches = "
        f"each epoch's plan, in all {launches}; (a) {job['seconds']:.3f} s")
    launches["paged_attention"] = job["paged"]
    return launches


def ct_vision(torch, card, seed):
    """(b): a direct continual ResNet-18 TrainJob from the sharded device
    cache over three CIFAR-shaped generations and a window of 2: after
    every epoch the cache's slabs equal a cold cache's of the same handle
    (torch.equal on the card). Returns the merge's launches."""
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    rng = np.random.default_rng(seed + 19)
    reg = DatasetRegistry()
    reg.create("cifar", *cifar_arrays(rng, CT_IMAGES),
               *cifar_arrays(rng, CT_TEST_IMAGES))
    buckets = resnet18_plan().n_buckets
    uploads, rows, holder = [], [], {}
    real_ensure = DeviceDatasetCache.ensure

    def ensure(self, plan=None, W=0):
        torch.cuda.synchronize()
        sent, t0 = self.stats["h2d_bytes"], time.perf_counter()
        moved = real_ensure(self, plan, W)
        torch.cuda.synchronize()
        if moved and self.incremental:
            uploads.append((self.stats["h2d_bytes"] - sent,
                            time.perf_counter() - t0, dict(self.stats)))
        return moved

    def publish(m):
        n = merge_count_now()
        merge_count_zero()
        job = holder["job"]
        cache = job._device_cache
        plan = job._loader.plan(VIS_N, VIS_K, VIS_B)
        W = job._loader.round_geometry(plan)[0]
        cold = DeviceDatasetCache(
            cache.handle, "cuda", n_lanes=cache.n_lanes, layout=cache.layout,
            device_transform=cache.device_transform,
            grow_quantum=cache.grow_quantum)
        cold.ensure(plan, W)
        equal = all(torch.equal(cache.arrays[k], cold.arrays[k])
                    for k in ("x", "y"))
        rows.append(dict(gen=m.dataset_generation,
                         samples=cache.handle.train_samples,
                         base=cache.handle.train_base, launches=n,
                         rounds=len(plan.rounds), steps=plan.total_steps,
                         sec=m.epoch_duration, equal=equal,
                         cold_h2d=cold.stats["h2d_bytes"],
                         jit=m.jit_compiles, loss=m.train_loss))
        del cold
        if len(rows) in (1, 3):      # grow after epoch 1, slide after 3
            reg.append("cifar", *cifar_arrays(rng, CT_IMAGES))

    task = vision_task("ct-vision", CT_VIS_EPOCHS, device_cache="on",
                       continual=True, window_generations=CT_WINDOW)
    DeviceDatasetCache.ensure = ensure
    try:
        holder["job"] = TrainJob(
            task, get_model("resnet18")(), cifar_dataset(), device="cuda",
            callbacks=JobCallbacks(publish_metrics=publish))
        merge_count_zero()                   # the main path's run starts
        hist = holder["job"].train().data
    finally:
        DeviceDatasetCache.ensure = real_ensure
    cache = holder["job"]._device_cache
    assert cache is not None and cache.layout == "sharded" \
        and cache.incremental, cache
    assert [(r["gen"], r["samples"], r["base"]) for r in rows] == [
        (1, CT_IMAGES, 0), (2, 2 * CT_IMAGES, 0), (2, 2 * CT_IMAGES, 0),
        (3, 2 * CT_IMAGES, CT_IMAGES)], rows
    assert all(r["equal"] for r in rows), "a refreshed slab differs"
    assert all(r["launches"] == merge_counts(buckets, r["rounds"])
               for r in rows), rows
    assert len(uploads) == 3, uploads          # first, grow, slide
    assert all(np.isfinite(hist.train_loss)), hist.train_loss
    for e, r in enumerate(rows):
        log(card, f"continual (b) resnet18 epoch {e + 1} on generation "
            f"{r['gen']}: window {r['samples']} images from absolute "
            f"{r['base']}, {r['steps']} local steps in {r['rounds']} rounds, "
            f"{r['sec']:.4f} s = {1e3 * r['sec'] / r['steps']:.3f} ms per "
            f"local step, train loss {r['loss']:.4f}; slabs == a cold "
            f"upload's (torch.equal); fused_merge "
            f"{r['launches']['fused_merge']} launches of "
            f"{r['launches']['merge segments']} segments (= {buckets} "
            f"buckets x {r['rounds']} rounds); jit_compiles "
            f"{r['jit']}")
    for (sent, sec, stats), what, cold in zip(
            uploads[1:], ("grow (append)", "slide (window)"),
            (rows[1]["cold_h2d"], rows[3]["cold_h2d"])):
        log(card, f"continual (b) incremental refresh, {what}: {sent} B host "
            f"to device in {1e3 * sec:.3f} ms against a cold upload's "
            f"{cold} B ({100 * sent / cold:.1f} %); lanes_reused "
            f"{stats['lanes_reused']}, lanes_refreshed "
            f"{stats['lanes_refreshed']} (cumulative)")
    before, after = rows[2], rows[3]
    log(card, f"continual (b) ms per local step: {1e3 * before['sec'] / before['steps']:.3f}"
        f" in the epoch before the slide (same window size, no refresh), "
        f"{1e3 * after['sec'] / after['steps']:.3f} in the epoch after it "
        f"(its incremental upload included)")
    return sum(r["launches"]["fused_merge"] for r in rows)


# ----------------------------------------------------------------- phase 19
SPEC_K = 4                  # decode steps of the multi-step program, and
                            # the proposals of a verify call
SPEC_DRAFT_SEED = 11        # the disagreeing draft: gpt-mini at seed + 11
SPEC_DRAFT_ID = "gpt-mini-draft"
SPEC_SAMPLED = ((1, 0.8, 5), (2, 1.1, 9))   # (prompt index, temp, seed)
SPEC_MODES = ("multi", "self-draft", "other-draft")
SPEC_PROFILED = 2           # steady-state steps profiled for readbacks


def spec_engine_kw(mode, module, other):
    if mode == "multi":
        return {"decode_steps": SPEC_K}
    draft = module if mode == "self-draft" else other
    return {"draft_module": draft, "draft_variables": draft.state_dict()}


def spec_sampled(torch, module, prompts, kv_dtype, **kw):
    """The two sampled requests on a DecodeEngine of phase 3's geometry:
    (tokens, host readbacks counted as the device's DtoH copies over the
    first SPEC_PROFILED steps once no prompt token is left to prefill,
    and the decode dispatches of those steps; (None, 0) when the
    profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    eng = DecodeEngine(module, slots=8, page=16, prefill_chunk=16,
                       kv_dtype=kv_dtype, **kw)
    reqs = [GenerateRequest(prompts[i], max_new_tokens=NEW_TOKENS,
                            temperature=t, seed=sd)
            for i, t, sd in SPEC_SAMPLED]
    for r in reqs:
        eng.attach(r)
    dtoh, disp, seen = 0, 0, False
    profiled = 0
    while eng.active():
        if profiled < SPEC_PROFILED and eng.prefill_backlog_tokens() == 0:
            d0 = eng.stats["dispatches"]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                eng.step()
                torch.cuda.synchronize()
            events = [ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA]
            seen = seen or bool(events)
            dtoh += sum(1 for ev in events if "DtoH" in ev.name)
            disp += eng.stats["dispatches"] - d0
            profiled += 1
        else:
            eng.step()
    assert all(r.outcome == "ok" and len(r.tokens) == NEW_TOKENS
               for r in reqs), [(r.outcome, r.error) for r in reqs]
    return [r.tokens for r in reqs], (dtoh if seen else None), disp


def spec_readbacks(dtoh, disp) -> str:
    return "not measured" if dtoh is None or not disp \
        else f"{dtoh / disp:g} ({dtoh} DtoH copies over {disp})"


def spec_plan(st, layers, draft_layers):
    """The kernels' launches a run's counters call for: the paged kernel
    once a layer per single decode step and prefill call, K times per
    multi-step call, 2(Kv+1) times per verify call; the flash forward
    once a draft layer per proposal."""
    single = st["dispatches"] - st["multi_step_dispatches"] \
        - st["verify_dispatches"]
    paged = layers * (single + st["prefill_dispatches"]
                      + SPEC_K * st["multi_step_dispatches"]
                      + 2 * (SPEC_K + 1) * st["verify_dispatches"])
    return paged, draft_layers * SPEC_K * st["verify_dispatches"]


def phase_spec(torch, card, seed, module, direct):
    """Multi-step and speculative decode on the card (see the module
    docstring, phase 19); returns the kernels' launches by page type and
    mode."""
    import os
    import tempfile

    t0 = time.perf_counter()
    other = build_gpt(torch, "gpt-mini", seed + SPEC_DRAFT_SEED,
                      torch.bfloat16, "cuda")
    out = {pages: spec_direct(torch, card, seed, module, other, kv,
                              direct[pages], pages)
           for pages, kv in (("bf16", "f32"), ("int8", "int8"))}
    spec_steady(torch, card, seed, module, other)
    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = os.path.join(tmp, "home")
        try:
            out["ps"] = spec_ps(card, seed, module, direct["bf16"])
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home
    log(card, f"spec phase: {time.perf_counter() - t0:.3f} s; launches: "
        f"{out}")
    return out


def spec_direct(torch, card, seed, module, other, kv_dtype, ref, pages):
    """(a) and (c) for one page type: phase 3's batch timed under the
    single step and each mode in turns — bf16 pages twice (A B C D D C B
    A), int8 pages once between two single-step runs (A B C D A): two
    calls land on different cards and this host's time spreads, so only
    runs of one process compare — then the sampled pair under each
    mode."""
    from kubeml_tpu_torch.ops.flash_attention import fa_fwd_kernel
    from kubeml_tpu_torch.ops.paged_attention import paged_attention
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.service import ServeService

    prompts, shared = batch_prompts(seed, module.vocab_size)
    launches, rates = {}, {}
    order = ("single",) + SPEC_MODES
    turns = order + (order[::-1] if pages == "bf16" else ("single",))
    for mode in turns:
        kw = {} if mode == "single" else spec_engine_kw(mode, module, other)
        svc = ServeService("gpt-mini", DecodeEngine(
            module, slots=8, page=16, prefill_chunk=16, kv_dtype=kv_dtype,
            **kw)).start()
        try:
            paged_attention.launches = 0     # the main path's run ...
            fa_fwd_kernel.launches = 0
            t0 = time.perf_counter()
            reqs = serve_batch(svc, prompts, shared)
            wall = time.perf_counter() - t0
            got = (paged_attention.launches,    # ... ends here
                   fa_fwd_kernel.launches)
        finally:
            svc.stop()
        eng = svc.engine
        st = eng.stats
        assert [r.tokens for r in reqs] == ref["tokens"], \
            f"{mode}: tokens differ from phase 3's"
        draft_layers = kw["draft_module"].layers if "draft_module" in kw \
            else 0
        plan = spec_plan(st, module.layers, draft_layers)
        assert got == plan, (mode, got, plan, st)
        tokens = sum(len(r.tokens) for r in reqs)
        ttft = 1e3 * statistics.mean(r.first_token_at - r.submitted_at
                                     for r in reqs)
        line = (f"spec {pages} pages, {mode}: {len(reqs)} requests, "
                f"{tokens} tokens in {wall:.4f} s = {tokens / wall:.2f} "
                f"tokens/s, mean TTFT {ttft:.3f} ms, dispatches per token "
                f"{eng.dispatches_per_token:.4f} ({st['dispatches']} "
                f"decode-lane: {st['multi_step_dispatches']} multi-step, "
                f"{st['verify_dispatches']} verify; "
                f"{st['prefill_dispatches']} prefill), launches paged "
                f"{got[0]} flash forward {got[1]} = the plan; tokens equal "
                f"phase 3's")
        rates.setdefault(mode, []).append(tokens / wall)
        if mode == "single":
            log(card, line)
            continue
        program = "serve.multi_step" if mode == "multi" \
            else "serve.spec_verify"
        lane = "multi_step_dispatches" if mode == "multi" \
            else "verify_dispatches"
        assert st[lane] > 0, (mode, st)
        assert eng.ledger.snapshot()[program]["dispatches"] == st[lane]
        launches.setdefault(mode, {"paged": got[0], "flash_forward": got[1]})
        if mode != "multi":
            # accepted counts every lane of a call; draft_tokens / K is
            # the lanes verified
            lanes = st["draft_tokens"] // SPEC_K
            line += (f"; accepted per verify dispatch "
                     f"{eng.accepted_per_dispatch:.4f} over "
                     f"{lanes / st['verify_dispatches']:.3f} lanes = "
                     f"{st['accepted_tokens'] / lanes:.4f} a lane (draft "
                     f"{st['draft_tokens']}, accepted "
                     f"{st['accepted_tokens']}, rejected "
                     f"{st['rejected_tokens']})")
        log(card, line)
    log(card, f"spec {pages} pages: tokens/s by mode, in turns: "
        + ", ".join(f"{m} " + " / ".join(f"{r:.2f}" for r in runs)
                    for m, runs in rates.items())
        + f" (phase 3 {ref['tokens_per_s']:.2f})")

    base, dtoh, disp = spec_sampled(torch, module, prompts, kv_dtype)
    log(card, f"spec {pages} pages, single step: host readbacks per "
        f"decode dispatch {spec_readbacks(dtoh, disp)} (sampled pair, "
        f"{SPEC_PROFILED} steady-state steps profiled)")
    for mode in SPEC_MODES:
        sampled, dtoh, disp = spec_sampled(
            torch, module, prompts, kv_dtype,
            **spec_engine_kw(mode, module, other))
        assert sampled == base, f"{mode}: sampled tokens differ"
        log(card, f"spec {pages} pages, {mode}: the sampled pair equals "
            f"the single step's bit for bit; host readbacks per decode "
            f"dispatch {spec_readbacks(dtoh, disp)}")
    return launches


def spec_steady(torch, card, seed, module, other):
    """The all-decode steady state alone: 8 one-token prompts (no prefill,
    so every decode round is the mode's own program), 32 new tokens each,
    bf16 pages, on a DecodeEngine driven directly (no serving thread),
    timed to a synchronize, single step, multi-step and the self-draft
    twice in turns."""
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    rng = np.random.default_rng(seed + 19)
    prompts = [[int(t)] for t in rng.integers(1, module.vocab_size, 8)]
    order = ("single", "multi", "self-draft")
    rates, toks = {}, {}
    for mode in order + order[::-1]:
        kw = {} if mode == "single" else spec_engine_kw(mode, module, other)
        eng = DecodeEngine(module, slots=8, page=16, prefill_chunk=16, **kw)
        reqs = [GenerateRequest(p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        for r in reqs:
            eng.attach(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.active():
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [r.tokens for r in reqs]
        assert toks.setdefault("single", got) == got, \
            f"{mode}: steady-state tokens differ from the single step's"
        st = eng.stats
        rates.setdefault(mode, []).append(
            (st["generated_tokens"] / wall, st["dispatches"],
             1e3 * wall / st["dispatches"]))
    log(card, "spec steady state (8 one-token prompts x 32 tokens, bf16 "
        "pages, engine driven directly): tokens/s, decode dispatches, ms "
        "per dispatch by mode, in turns: " + "; ".join(
            f"{m} " + " / ".join(f"{r:.2f} tok/s {d} disp {ms:.3f} ms"
                                 for r, d, ms in runs)
            for m, runs in rates.items()) + "; tokens equal across modes")


def spec_ps(card, seed, module, ref):
    """(b): phase 3's batch through POST /generate on a deployment started
    from `kubeml serve`'s own flags --serve-decode-steps 4
    --serve-draft-model <id> (the CLI's parser makes the kwargs)."""
    import urllib.request

    from kubeml_tpu_torch.cli.main import _serve_knobs, build_parser
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.ops.flash_attention import fa_fwd_kernel
    from kubeml_tpu_torch.ops.paged_attention import paged_attention
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    prompts, shared = batch_prompts(seed, module.vocab_size)
    save_mini(seed)
    save_checkpoint(SPEC_DRAFT_ID, {"params": random_flax_params(
        **GPT_CONFIGS[PS_MODEL], seed=seed + SPEC_DRAFT_SEED)},
        {"model": PS_MODEL, "function": PS_MODEL})
    args = build_parser().parse_args([
        "serve", "--serve-slots", "8", "--serve-prefill-chunk", "16",
        "--serve-decode-steps", str(SPEC_K), "--serve-draft-model",
        SPEC_DRAFT_ID])
    dep = start_deployment(**_serve_knobs(args))
    try:
        url = dep.ps.url
        warm = GenStream(url, gen_body(prompts[0], 4)).start().join()
        assert warm.status == 200, warm.last          # builds the fleet
        fleet = dep.ps._serve[PS_MODEL][1]
        (_, eng), = fleet.engines()
        assert (eng.decode_steps, eng.spec_steps, eng.spec_window) == \
            (SPEC_K, SPEC_K, 512)
        st0 = dict(eng.stats)
        paged_attention.launches = 0     # the main path's run starts here
        fa_fwd_kernel.launches = 0
        t0 = time.perf_counter()
        streams = [GenStream(url, gen_body(p, NEW_TOKENS)).start()
                   for p in prompts]
        streams[prompts.index(shared)].first.wait(300)
        streams.append(GenStream(url, gen_body(shared, NEW_TOKENS)).start())
        for stream in streams:
            stream.join()
        wall = time.perf_counter() - t0
        got = (paged_attention.launches, fa_fwd_kernel.launches)  # ends
        assert [stream.tokens for stream in streams] == ref["tokens"], \
            "POST /generate tokens differ from phase 3's"
        d = {k: eng.stats[k] - st0[k] for k in (
            "dispatches", "prefill_dispatches", "multi_step_dispatches",
            "verify_dispatches")}
        plan = spec_plan(d, module.layers, module.layers)
        assert got == plan, (got, plan, d)
        fams = ("draft", "accepted", "rejected")

        def scraped():
            text = urllib.request.urlopen(f"{url}/metrics").read().decode()
            vals = {}
            for line in text.splitlines():
                for f in fams:
                    head = (f'kubeml_serve_{f}_tokens_total'
                            f'{{model="{PS_MODEL}"}}')
                    if line.startswith(head + " "):
                        vals[f] = float(line.split()[-1])
            return vals

        want = {f: float(eng.stats[f"{f}_tokens"]) for f in fams}
        wait_until(lambda: scraped() == want, "the speculative counters "
                   "on /metrics")
        snap = fleet.snapshot()
        ratio = round(eng.stats["accepted_tokens"]
                      / eng.stats["verify_dispatches"], 6)
        assert snap["serve_accepted_per_dispatch"] == ratio, \
            (snap["serve_accepted_per_dispatch"], ratio)
        tokens = sum(len(stream.tokens) for stream in streams)
        log(card, f"spec through POST /generate (--serve-decode-steps "
            f"{SPEC_K} --serve-draft-model {SPEC_DRAFT_ID}, bf16 pages): "
            f"{len(streams)} streams, {tokens} tokens in {wall:.4f} s = "
            f"{tokens / wall:.2f} tokens/s, client mean TTFT "
            f"{1e3 * statistics.mean(s.ttft for s in streams):.3f} ms; "
            f"tokens equal phase 3's; {d['verify_dispatches']} verify, "
            f"{d['multi_step_dispatches']} multi-step dispatches; /metrics "
            f"draft/accepted/rejected {want} = the engine's; snapshot "
            f"accepted per dispatch {ratio}; launches paged {got[0]} flash "
            f"forward {got[1]} = the plan")
        return {"paged": got[0], "flash_forward": got[1]}
    finally:
        dep.stop()


# ----------------------------------------------------------------- phase 20
TEXT_EPOCHS = 2
TEXT_BUCKET_MB = 4.0
# bench_text.py's BASELINE configs at their published widths (B, T, K, N,
# vocab, classes); the datasets' sizes and the epochs are the cuts
# (bert-tiny's training set halved when phase 22 joined, to keep the smoke
# near 1000 s on a slow host; the LSTM's stays: at one round an epoch its
# loss barely falls)
TEXT_JOBS = {
    "bert-tiny": dict(B=32, T=64, K=16, N=4, vocab=30522, classes=2,
                      train=4096, test=1024, lr=1e-3),
    "lstm": dict(B=64, T=64, K=8, N=4, vocab=32000, classes=4,
                 train=4096, test=512, lr=1e-2),
}
TEXT_CHECK = dict(W=2, K=4, B=8, T=64)    # (a)/(b)'s card-vs-CPU round
NC_B, NC_H, NC_TS = 32, 2, (64, 128)      # (c): BERT-tiny's attention
RAGGED_G = (4, 12, 20)                    # (d): pages off the 8-token grid
RAGGED_CTX = 512                          # (d): gpt-mini's context


def text_arrays(rng, n, T, vocab, classes, B):
    """n band-structured sequences of T int32 ids (tests/test_models_text
    .py's task: class c's first 10 tokens fall in [10 + 20 c, 30 + 20 c),
    the rest uniform over the vocab) with ragged pad tails (lengths
    T/4..T), interior pads (3 ids zeroed in every fourth row) and one row
    in every B all padding; labels int32."""
    y = rng.integers(0, classes, n).astype(np.int32)
    x = rng.integers(10, vocab, (n, T)).astype(np.int32)
    x[:, :10] = 10 + 20 * y[:, None] + rng.integers(0, 20, (n, 10))
    lengths = rng.integers(T // 4, T + 1, n)
    x[np.arange(T)[None, :] >= lengths[:, None]] = 0
    rows = np.arange(0, n, 4)
    x[rows[:, None], 10 + rng.integers(0, T // 4 - 10, (len(rows), 3))] = 0
    x[B - 1::B] = 0
    return x, y


def phase_text(torch, card, seed):
    """The text classifiers on the card (see the module docstring, phase
    20); returns their kernels' launches, the non-causal flash rows and
    the ragged-page rows."""
    import os
    import tempfile

    t0 = time.perf_counter()
    out = {}
    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = tmp
        try:
            gen = torch.Generator(device="cuda").manual_seed(seed + 25)
            for name in TEXT_JOBS:
                out[name] = text_job(torch, card, seed, name)
                lengths = out[name]["bucket_lengths"]
                out[name]["merge"] = merge_kernel_rows(
                    torch, card, gen, lengths, cold=lengths,
                    label=f"text {name}'s 4 MB plan: fused_merge")
                text_round_check(torch, card, seed, name)
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home
    text_lstm_trace(torch, card, seed)
    out["noncausal"] = text_noncausal(torch, card, seed)
    out["ragged"] = text_ragged_kernel(torch, card, seed)
    module = build_gpt(torch, "gpt-mini", seed, torch.bfloat16, "cuda")
    out["ragged_engine"] = {pages: text_ragged_engine(torch, card, seed,
                                                      module, kv)
                            for pages, kv in (("bf16", "f32"),
                                              ("int8", "int8"))}
    log(card, f"text phase: {time.perf_counter() - t0:.3f} s")
    return out


def text_job(torch, card, seed, name):
    """(a)/(b): a TrainJob of the named model at its BASELINE config over
    a registry dataset of int32 token ids; per epoch the kernels'
    launches (zeroed before the job, read and zeroed at each epoch's
    publish) against the epoch plan."""
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm
    from kubeml_tpu_torch.parallel.merge import BucketedMerge
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    cfg = TEXT_JOBS[name]
    B, T, K, N = cfg["B"], cfg["T"], cfg["K"], cfg["N"]
    rng = np.random.default_rng(seed + 20)
    xtr, ytr = text_arrays(rng, cfg["train"], T, cfg["vocab"],
                           cfg["classes"], B)
    xte, yte = text_arrays(rng, cfg["test"], T, cfg["vocab"],
                           cfg["classes"], B)
    DatasetRegistry().create(f"text-{name}", xtr, ytr, xte, yte)
    kernels = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
               "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
               "merge segments": MergeSegments()}

    def zero():
        for fn in kernels.values():
            fn.launches = 0

    epochs = []

    def publish(m):
        epochs.append((m, {k: fn.launches for k, fn in kernels.items()}))
        zero()

    task = job_task(f"text-{name}", TEXT_EPOCHS, model=name, batch=B,
                    dataset=f"text-{name}", lr=cfg["lr"],
                    default_parallelism=N, static_parallelism=True, k=K,
                    merge_bucket_mb=TEXT_BUCKET_MB, validate_every=1,
                    train_stats=False)
    model = get_model(name)()
    job = TrainJob(task, model, KubeDataset(f"text-{name}"), device="cuda",
                   callbacks=JobCallbacks(publish_metrics=publish))
    zero()                                      # the main path's run starts
    t0 = time.perf_counter()
    hist = job.train().data
    wall = time.perf_counter() - t0
    assert job._device_cache is not None, "the job bypassed the cache"
    assert hist.train_loss[-1] < hist.train_loss[0], hist.train_loss
    assert all(np.isfinite(hist.validation_loss)), hist.validation_loss
    # the flash kernels run once a layer per step; the LSTM has none
    layers = getattr(job._engine.module, "layers", 0)
    lengths = [b.length for b in BucketedMerge(
        bucket_mb=TEXT_BUCKET_MB)._plan(job.state)[1].buckets]
    assert tuple(lengths) == MERGE_PLANS[name], (name, lengths)
    buckets = len(lengths)
    launches, ms = [], []
    for e, (m, counts) in enumerate(epochs):
        steps, rounds, evals = _epoch_counts(N, N, cfg["train"], cfg["test"],
                                             k=K, batch=B)
        want = {"forward": layers * (steps + evals), "dK/dV": layers * steps,
                "dQ": layers * steps, **merge_counts(buckets, rounds)}
        assert counts == want, (name, e, counts, want)
        launches.append(counts)
        sec = hist.epoch_duration[e]
        ms.append(1e3 * sec / steps)
        ph = {k: sum(v) for k, v in m.phase_times.items()}
        log(card, f"text {name} epoch {e + 1}/{TEXT_EPOCHS} (B={B} T={T} "
            f"K={K} N={N}, {cfg['train']} + {cfg['test']} sequences): train "
            f"loss {hist.train_loss[e]:.4f}, validation loss "
            f"{hist.validation_loss[e]:.4f}, accuracy "
            f"{hist.accuracy[e]:.2f}; {steps} local steps in {rounds} "
            f"rounds, wall {sec:.4f} s = {steps * B / sec:.2f} samples/s, "
            f"{1e3 * sec / steps:.3f} ms per local step; data_wait "
            f"{ph['data_wait']:.4f} s, dispatch {ph['dispatch']:.4f} s, "
            f"merge_wait {ph['merge_wait']:.4f} s; launches {counts} (= "
            f"{layers} layers x {steps} steps (+ {evals} eval slots), "
            f"{buckets} buckets x {rounds} rounds)")
    log(card, f"text {name} job: {wall:.3f} s for {TEXT_EPOCHS} epochs, "
        f"loss {hist.train_loss[0]:.4f} -> {hist.train_loss[-1]:.4f}, "
        f"ms per local step {', '.join(f'{x:.3f}' for x in ms)}")
    return {"launches": launches, "ms_per_step": ms,
            "bucket_lengths": lengths}


def text_round_check(torch, card, seed, name):
    """One round at the model's published widths in f32 (dropout 0), W
    workers on W lanes merged over the job's 4 MB bucket plan, on the
    card (its kernels: the fused merge once for the buckets, and
    bert-tiny's flash kernels) and on the CPU (their plain versions): merged
    parameters within the adaptive optimizer's 2 x K x lr (AdamW's or
    Adam's first steps divide each gradient element by its own
    magnitude), 99.5 % within 1e-5."""
    from kubeml_tpu_torch.models.bert import BertModule, BertTiny
    from kubeml_tpu_torch.models.lstm import LSTMClassifier
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine
    from kubeml_tpu_torch.parallel.merge import BucketedMerge

    class Bert0(BertTiny):
        def build(self, dtype=None, device=None):
            return BertModule(dropout=0.0, dtype=torch.float32,
                              device=device)

    model = (Bert0 if name == "bert-tiny" else LSTMClassifier)(
        dtype=torch.float32)
    cfg, c = TEXT_JOBS[name], TEXT_CHECK
    W, K, B, T = c["W"], c["K"], c["B"], c["T"]
    rng = np.random.default_rng(seed + 21)
    x, y = text_arrays(rng, W * K * B, T, cfg["vocab"], cfg["classes"], B)
    batch = {"x": x.reshape(W, K, B, T), "y": y.reshape(W, K, B)}
    ones = (np.ones((W, K, B), np.float32), np.ones((W, K), np.float32),
            np.ones(W, np.float32))
    rngs = rng.integers(0, 2 ** 32, (W, K, 2), dtype=np.uint32)
    init = model.init_module({"x": x[:B]},
                             torch.Generator().manual_seed(seed), "cpu")
    start = {k: v.detach().clone() for k, v in init.state_dict().items()}
    buckets = BucketedMerge(bucket_mb=TEXT_BUCKET_MB).comm_proxy(start)[
        "buckets_per_round"]
    out = {}
    for dev in ("cuda", "cpu"):
        engine = KAvgEngine(model.build(device=dev), model.loss,
                            model.metrics, model.configure_optimizers,
                            n_lanes=W, merge_bucket_mb=TEXT_BUCKET_MB)
        merge_count_zero()
        out[dev] = engine.train_round({k: v.to(dev, copy=True) for k, v in
                                       start.items()}, batch, *ones, rngs,
                                      cfg["lr"], 0)
        merges = merge_count_now()
        assert merges == (merge_counts(buckets, 1) if dev == "cuda"
                          else merge_counts(0, 0)), (dev, merges)
    (card_state, card_st), (cpu_state, cpu_st) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(card_st.loss_sum, cpu_st.loss_sum, rtol=1e-4)
    diffs = torch.cat([(card_state[n].cpu() - cpu_state[n]).abs().ravel()
                       for n in cpu_state])
    within = float((diffs <= 1e-5).float().mean())
    assert float(diffs.max()) <= 2 * K * cfg["lr"], float(diffs.max())
    assert within >= 0.995, within
    log(card, f"text {name} f32 round (W={W} lanes, K={K} B={B} T={T}, "
        f"{buckets} buckets at {TEXT_BUCKET_MB:g} MB: one fused merge "
        f"launch), card (kernels) vs CPU (plain): loss sums "
        f"{card_st.loss_sum.tolist()} "
        f"vs {cpu_st.loss_sum.tolist()}, merged params max|diff| "
        f"{float(diffs.max()):.3g} (bound {2 * K * cfg['lr']:g}), "
        f"{100 * within:.3f} % within 1e-5")


def text_lstm_trace(torch, card, seed):
    """(b) where an LSTM step's time goes: one round of one worker's K
    steps at the BASELINE shape, bf16, under torch.profiler (CUDA
    activity only): wall per local step, device busy and idle share,
    device activities per step."""
    from kubeml_tpu_torch.models.lstm import LSTMClassifier
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    cfg = TEXT_JOBS["lstm"]
    B, T, K = cfg["B"], cfg["T"], cfg["K"]
    rng = np.random.default_rng(seed + 22)
    x, y = text_arrays(rng, K * B, T, cfg["vocab"], cfg["classes"], B)
    batch = {"x": x.reshape(1, K, B, T), "y": y.reshape(1, K, B)}
    args = (batch, np.ones((1, K, B), np.float32),
            np.ones((1, K), np.float32), np.ones(1, np.float32),
            rng.integers(0, 2 ** 32, (1, K, 2), dtype=np.uint32))
    model = LSTMClassifier()
    module = model.init_module({"x": x[:B]},
                               torch.Generator().manual_seed(seed), "cuda")
    engine = KAvgEngine(module, model.loss, model.metrics,
                        model.configure_optimizers)
    state = {k: v.detach().clone() for k, v in module.state_dict().items()}
    wall_ms, by_name = _profiled_round(torch, engine, state, args,
                                       cfg["lr"])
    _log_profile(card, f"text lstm trace (one worker, {K} local steps, "
                 f"B={B} T={T}, bf16)", wall_ms, by_name, K)


def text_noncausal(torch, card, seed):
    """(c) the three flash kernels, not causal, at BERT-tiny's shapes
    (B=32, H=2, D=64, bf16, T = 64 and 128; padded tails and one fully
    padded sequence): each against its plain version within 2e-2, the
    fully padded rows finite and uniform (l = T, the output the mean of
    V), two launches equal bit for bit; times warm and L2-cold by graph
    replay against SDPA (forward; backward for dK/dV + dQ together) and
    the bytes bound."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 23)
    rows = {}
    shape = dict(B=NC_B, H=NC_H)
    for T in NC_TS:
        q, k, v, g, pad = flash_operands(torch, rng, "bf16", T, dev, **shape)
        tol = FLASH_TOL["bf16"]

        def check(got, ref):
            for a, b in zip(got, ref):
                torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                           atol=tol)
            return max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(got, ref))

        out, m, l = fa.fa_fwd_kernel(q, k, v, pad, False)
        again = fa.fa_fwd_kernel(q, k, v, pad, False)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip((out, m, l), again)), T
        ref_out, ref_m, ref_l = fa._fa_forward_plain(q, k, v, pad, False)
        check((m, l), (ref_m, ref_l))
        err_f = check((out,), (ref_out,))
        assert bool(out.isfinite().all())
        # the fully padded sequence: every key masked alike, so its rows
        # are uniform over all T keys
        torch.testing.assert_close(
            l.reshape(NC_B, NC_H, T)[-1],
            torch.full((NC_H, T), float(T), device=dev), rtol=1e-6, atol=0)
        torch.testing.assert_close(
            out[-1].float(), v[-1].float().mean(0, keepdim=True).expand(
                T, NC_H, FA_D), rtol=tol, atol=tol)
        delta = fa._delta(g, out)
        bwd = (q, k, v, pad, g, m, l, delta, False)
        dk, dv = fa.fa_bwd_dkv_kernel(*bwd)
        dq = fa.fa_bwd_dq_kernel(*bwd)
        torch.cuda.synchronize()
        err_kv = check((dk, dv), fa._fa_bwd_dkv_plain(*bwd))
        err_q = check((dq,), (fa._fa_bwd_dq_plain(*bwd),))
        assert all(bool(t.isfinite().all()) for t in (dk, dv, dq))
        dk2, dv2 = fa.fa_bwd_dkv_kernel(*bwd)
        dq2 = fa.fa_bwd_dq_kernel(*bwd)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in
                   ((dk, dk2), (dv, dv2), (dq, dq2))), T
        lib_f, lib_b = library_flash_ms(torch, q, k, v, g, pad, False)
        for kernel, err, fn, plain in (
                ("forward", err_f,
                 lambda: fa.fa_fwd_kernel(q, k, v, pad, False),
                 lambda: fa._fa_forward_plain(q, k, v, pad, False)),
                ("dK/dV", err_kv, lambda: fa.fa_bwd_dkv_kernel(*bwd),
                 lambda: fa._fa_bwd_dkv_plain(*bwd)),
                ("dQ", err_q, lambda: fa.fa_bwd_dq_kernel(*bwd),
                 lambda: fa._fa_bwd_dq_plain(*bwd))):
            ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
            cold = flash_cold_ms(torch, rng, "bf16", T, False, kernel, dev,
                                 **shape)
            b_ms, b_by = flash_bound(q, False, kernel)
            lib = lib_f if kernel == "forward" else lib_b
            rows[(T, kernel)] = dict(
                T=T, max_abs_err=err, ms=ms, cold_ms=cold, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            log(card, f"text non-causal flash {kernel} (B={NC_B} T={T} "
                f"H={NC_H} D={FA_D}, bf16): kernel {ms:.4f} ms (L2 cold "
                f"{cold:.4f} ms), plain {plain_ms:.4f} ms, library "
                f"{lib:.4f} ms ("
                + ("forward" if kernel == "forward"
                   else "backward, dQ+dK+dV") + "), "
                f"bound {b_ms:.5f} ms ({b_by}), {ms / b_ms:.1f}x bound, "
                f"max|err| {err:.3g} (tol {tol}); the fully padded rows "
                f"finite and uniform; two launches equal bit for bit")
    return rows


def text_ragged_kernel(torch, card, seed):
    """(d) the paged kernel at page sizes off its 8-token slices (G = 4,
    12, 20), bf16 and int8 pages, gpt-mini's heads, a context of about
    512 tokens: the decode call (S=8, T=1) and the prefill call (S=1,
    T=16) against the plain version (2e-2), two launches equal bit for
    bit, each slot alone equal to its batched output; times warm and
    L2-cold against page gather + SDPA, with the bytes bound."""
    from kubeml_tpu_torch.ops.paged_attention import _pa_plain, paged_attention

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 24)
    rows = {}
    for pages in ("bf16", "int8"):
        quant = pages == "int8"
        for g in RAGGED_G:
            geom = dict(G=g, PMAX=-(-RAGGED_CTX // g))
            for S, T in ((8, 1), (1, 16)):
                args, cdt = paged_operands(torch, rng, S, T, pages, dev,
                                           **geom)

                def call(*a):
                    return paged_attention(*a, quantized=quant,
                                           compute_dtype=cdt)

                out = call(*args)
                torch.cuda.synchronize()
                ref = _pa_plain(*args, quantized=quant, compute_dtype=cdt)
                torch.testing.assert_close(out.float(), ref.float(),
                                           rtol=TOL["bf16"],
                                           atol=TOL["bf16"])
                err = float((out.float() - ref.float()).abs().max())
                assert torch.equal(out, call(*args)), (pages, g, S, T)
                q, kp, vp, ks, vs, tables, bias = args
                for s in range(S if S > 1 else 0):
                    alone = call(q[s:s + 1], kp, vp, ks, vs, tables[s:s + 1],
                                 bias[s:s + 1])
                    assert torch.equal(alone, out[s:s + 1]), (pages, g, s)
                ms = time_ms(torch, lambda: call(*args))
                cold = paged_cold_ms(torch, rng, S, T, pages, dev, call,
                                     **geom)
                plain_ms = time_ms(torch, lambda: _pa_plain(
                    *args, quantized=quant, compute_dtype=cdt))
                lib_ms = time_ms(torch, lambda: library_attention(
                    torch, *args, quant, cdt))
                b_ms, b_by = bound(torch, q, kp, tables, bias, quant, "bf16")
                rows[(pages, g, S, T)] = dict(
                    G=g, S=S, T=T, max_abs_err=err, ms=ms, cold_ms=cold,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms)
                log(card, f"text ragged paged_attention pages={pages} G={g} "
                    f"Pmax={geom['PMAX']} S={S} T={T}: kernel {ms:.4f} ms "
                    f"(L2 cold {cold:.4f} ms), plain {plain_ms:.4f} ms, "
                    f"library {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
                    f"({b_by}), max|err| {err:.3g} (tol {TOL['bf16']}); two "
                    "launches equal bit for bit"
                    + (f", each of the {S} slots alone equals its batched "
                       "output" if S > 1 else ""))
    return rows


def text_ragged_engine(torch, card, seed, module, kv_dtype):
    """(d) ROADMAP C.3's page-size half: a gpt-mini engine at 12-token
    pages builds under attn_impl "auto" and "kernel" and serves phase
    3's batch (8 slots, 12-token prefill chunks, engine driven directly)
    through the paged kernel: launches = layers x (decode + prefill
    dispatches), and every one of the engine's calls is held against the
    plain version on the same CUDA operands (2e-2). The same requests
    through the plain version on the card (the models' paged_attention
    swapped for _pa_plain: no launch) give tokens compared request by
    request; a flip is reported with the top-2 logit margin of the dense
    forward at the flip."""
    from kubeml_tpu_torch.models import gpt as gpt_mod
    from kubeml_tpu_torch.ops.paged_attention import _pa_plain, paged_attention
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    prompts, shared = batch_prompts(seed, module.vocab_size)
    prompts = prompts + [shared]

    def serve(impl):
        eng = DecodeEngine(module, slots=8, page=12, prefill_chunk=12,
                           kv_dtype=kv_dtype, attn_impl=impl)
        reqs = [GenerateRequest(p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        for r in reqs:
            eng.attach(r)
        while eng.active():
            eng.step()
        torch.cuda.synchronize()
        return eng.stats, [r.tokens for r in reqs]

    def plain_call(*a, quantized=False, compute_dtype=None):
        return _pa_plain(*a, quantized=quantized,
                         compute_dtype=compute_dtype or a[0].dtype)

    diffs = []

    def held(*a, quantized=False, compute_dtype=None):
        got = paged_attention(*a, quantized=quantized,
                              compute_dtype=compute_dtype)
        ref = plain_call(*a, quantized=quantized, compute_dtype=compute_dtype)
        diffs.append(float((got.float() - ref.float()).abs().max()))
        return got

    def swapped(impl, call):
        gpt_mod.paged_attention = call
        try:
            return serve(impl)
        finally:
            gpt_mod.paged_attention = paged_attention

    serve("auto")                              # warm: first calls
    paged_attention.launches = 0               # the run starts here
    st, toks = swapped("kernel", held)
    launches = paged_attention.launches        # ... and ends here
    want = module.layers * (st["dispatches"] + st["prefill_dispatches"])
    assert launches == want == len(diffs), (launches, want, len(diffs), st)
    assert max(diffs) <= TOL["bf16"], max(diffs)
    assert all(len(t) == NEW_TOKENS for t in toks)

    _, plain = swapped("auto", plain_call)
    assert paged_attention.launches == launches, "the plain run launched"
    flips = []
    for i, (a, b) in enumerate(zip(toks, plain)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ctx = torch.tensor([prompts[i] + a[:j]], device="cuda")
        top2 = torch.topk(module(ctx)[0, -1], 2).values
        flips.append((i, j, float(top2[0] - top2[1])))
    pages = "bf16" if kv_dtype == "f32" else kv_dtype
    log(card, f"text C.3: gpt-mini at 12-token pages, {pages} KV pages, "
        f"built under 'auto' and 'kernel'; {len(prompts)} requests x "
        f"{NEW_TOKENS} tokens, decode dispatches {st['dispatches']}, "
        f"prefill dispatches {st['prefill_dispatches']}, kernel launches "
        f"{launches} (= {module.layers} layers x "
        f"{st['dispatches'] + st['prefill_dispatches']}), each call held "
        f"against the plain version on its operands: max|err| "
        f"{max(diffs):.3g} (tol {TOL['bf16']}); the plain version's run on "
        f"the card (no launch): {len(prompts) - len(flips)} of "
        f"{len(prompts)} requests' tokens equal"
        + "".join(f"; request {i} flips at token {j} (dense-forward top-2 "
                  f"logit margin {mg:.4g})" for i, j, mg in flips))
    return {"launches": launches, "max_abs_err": max(diffs), "flips": flips,
            "dispatches": st["dispatches"],
            "prefill_dispatches": st["prefill_dispatches"]}


# ----------------------------------------------------------------- phase 21
MOE_B, MOE_K, MOE_N, MOE_LR = JOB_B, JOB_K, JOB_N0, JOB_LR   # phase 10's
MOE_EPOCHS = 2
# examples/function_vgg11.py's `-b 128 --lr 0.05` and its CIFAR-100
# normalization; K and N as phase 11's job
VGG_B, VGG_K, VGG_N, VGG_LR, VGG_EPOCHS = 128, VIS_K, VIS_N, 0.05, 2
CIFAR100_MEAN = (0.5071, 0.4866, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
MV_BUCKET_MB = 4.0
MV_MODELS = ("gpt-moe-mini", "vgg11")
# (c): a gpt-moe-mini at gpt-nano's widths with 4 experts, f32, dropout 0
MOE_TINY = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
                ffn=64, n_experts=4)
MOE_CHECK = dict(W=2, K=2, B=4, T=64)
VGG_CHECK_HIDDEN = 64
# (e): the reference's refusal (kubeml_tpu/models/gpt.py:565-569)
MOE_DECODE_REFUSAL = ("paged decode serves dense GPT modules only (no MoE, "
                      "sequence-parallel, or manual-TP variants)")


def cifar100_arrays(rng, n):
    """n CIFAR-100-shaped u8 NHWC images and int32 labels 0..99: uniform
    noise in [0, 150), each channel of the whole image lifted by 25 x one
    base-5 digit of the label (y % 5, y // 5 % 5, y // 25)."""
    y = rng.integers(0, 100, n).astype(np.int32)
    x = rng.integers(0, 150, (n, CIFAR_HW, CIFAR_HW, 3), dtype=np.uint8)
    digits = np.stack([y % 5, y // 5 % 5, y // 25], axis=1)
    x += (25 * digits).astype(np.uint8)[:, None, None, :]
    return x, y


def cifar100_dataset():
    """examples/function_vgg11.py's normalization, u8 -> (x / 255 - mean)
    / std, on the host and on the card (transform_train_device), so the
    job runs from the device cache."""
    from kubeml_tpu_torch.models.base import KubeDataset

    mean = np.asarray(CIFAR100_MEAN, np.float32)
    std = np.asarray(CIFAR100_STD, np.float32)

    class Cifar100(KubeDataset):
        def transform_train(self, data, labels):
            x = np.asarray(data).astype(np.float32) / 255.0
            return {"x": (x - mean) / std, "y": np.asarray(labels)}

        transform_test = transform_train

        @staticmethod
        def transform_train_device(x, y):
            import torch

            m = torch.as_tensor(mean, device=x.device)
            s = torch.as_tensor(std, device=x.device)
            return {"x": (x.float() / 255.0 - m) / s, "y": y}

    return Cifar100("cifar100")


def phase_moe_vgg(torch, card, seed):
    """gpt-moe-mini and vgg11 on the card (see the module docstring,
    phase 21); returns their jobs' launches per epoch and #5's rows at
    both models' plans."""
    import os
    import tempfile

    from kubeml_tpu_torch.data.registry import DatasetRegistry

    t0 = time.perf_counter()
    out = {}
    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = tmp
        try:
            rng = np.random.default_rng(seed + 12)   # phase 10's windows
            DatasetRegistry().create(
                "tokens", token_windows(rng, JOB_TRAIN, TRAIN_T),
                np.zeros(JOB_TRAIN, np.int32),
                token_windows(rng, JOB_TEST, TRAIN_T),
                np.zeros(JOB_TEST, np.int32))
            out["gpt-moe-mini"] = mv_job(
                torch, card, "gpt-moe-mini", token_dataset(), "tokens",
                MOE_B, MOE_K, MOE_N, MOE_LR, MOE_EPOCHS, JOB_TRAIN,
                JOB_TEST)
            rng = np.random.default_rng(seed + 26)
            t1 = time.perf_counter()
            DatasetRegistry().create(
                "cifar100", *cifar100_arrays(rng, CIFAR_TRAIN),
                *cifar100_arrays(rng, CIFAR_TEST))
            log(card, f"moe-vgg dataset: {CIFAR_TRAIN} train and "
                f"{CIFAR_TEST} test u8 images 32x32x3, labels 0..99, "
                f"written in {time.perf_counter() - t1:.2f} s")
            out["vgg11"] = mv_job(
                torch, card, "vgg11", cifar100_dataset(), "cifar100", VGG_B,
                VGG_K, VGG_N, VGG_LR, VGG_EPOCHS, CIFAR_TRAIN, CIFAR_TEST)
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home
    moe_trace(torch, card, seed, out["gpt-moe-mini"].pop("job"))
    vgg_trace(torch, card, seed, out["vgg11"].pop("job"))
    moe_vgg_check(torch, card, seed)
    merge_sass_loads(card)
    gen = torch.Generator(device="cuda").manual_seed(seed + 27)
    for name in MV_MODELS:
        lengths = out[name]["bucket_lengths"]
        rows = merge_kernel_rows(torch, card, gen, lengths, cold=lengths,
                                 label=f"moe-vgg {name}'s 4 MB plan: "
                                 "fused_merge", timed=("avg",))
        out[name]["merge"] = rows
        tot = {k: sum(rows[n]["avg"][k] for n in lengths)
               for k in ("ms", "cold_ms", "plain_ms")}
        bound = merge_bound(sum(lengths), "avg")
        log(card, f"moe-vgg fused_merge at {name}'s {MV_BUCKET_MB:g} MB "
            f"plan: {len(lengths)} buckets, {sum(lengths)} f32 elements; "
            f"one launch a bucket, summed {tot['ms']:.4f} ms (L2 cold "
            f"{tot['cold_ms']:.4f} ms), plain {tot['plain_ms']:.4f} ms, "
            f"bound {bound:.5f} ms (bytes, 8 B an element), "
            f"{tot['cold_ms'] / bound:.2f}x bound L2-cold (phase 9 (a2) "
            f"times the grouped launch); largest bucket {max(lengths)}; "
            f"kernel == plain bit for bit at every length")
    moe_refusal(torch, card)
    log(card, f"moe-vgg phase: {time.perf_counter() - t0:.3f} s")
    return out


def mv_job(torch, card, name, dataset, dataset_name, B, K, N, lr, epochs,
           n_train, n_test):
    """(a)/(b): a TrainJob of the named model at its published widths over
    a registry dataset, static N; per epoch the
    kernels' launches (zeroed before the job, read and zeroed at each
    epoch's publish) against the epoch plan, the loss, ms per local
    step, samples/s and non-pad tokens/s."""
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm
    from kubeml_tpu_torch.parallel.merge import BucketedMerge
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    kernels = {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
               "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
               "merge segments": MergeSegments()}

    def zero():
        for fn in kernels.values():
            fn.launches = 0

    epochs_seen = []

    def publish(m):
        epochs_seen.append((m, {k: fn.launches for k, fn in kernels.items()}))
        zero()

    task = job_task(f"mv-{name}", epochs, model=name, batch=B,
                    dataset=dataset_name, lr=lr, default_parallelism=N,
                    static_parallelism=True, k=K,
                    merge_bucket_mb=MV_BUCKET_MB, validate_every=1,
                    train_stats=False)
    job = TrainJob(task, get_model(name)(), dataset, device="cuda",
                   callbacks=JobCallbacks(publish_metrics=publish))
    zero()                                      # the main path's run starts
    t0 = time.perf_counter()
    hist = job.train().data
    wall = time.perf_counter() - t0
    # phase 10's windows have a host transform and no device twin, so
    # the token job stages its rounds from the host; the images' rounds
    # come from the device cache
    cached = job._device_cache is not None
    assert cached == (name == "vgg11"), (name, cached)
    assert all(np.isfinite(hist.train_loss)), hist.train_loss
    assert all(np.isfinite(hist.validation_loss)), hist.validation_loss
    assert hist.train_loss[-1] < hist.train_loss[0], hist.train_loss
    module = job._engine.module
    layers = getattr(module, "layers", 0)      # vgg11 has no attention
    lengths = [b.length for b in BucketedMerge(
        bucket_mb=MV_BUCKET_MB)._plan(job.state)[1].buckets]
    assert tuple(lengths) == MERGE_PLANS[name], (name, lengths)
    tokens = 0                                 # non-pad tokens an epoch
    if layers:
        tokens = int((np.asarray(job._handle.train_arrays()[0]) != 0).sum())
    launches, ms = [], []
    for e, (m, counts) in enumerate(epochs_seen):
        steps, rounds, evals = _epoch_counts(N, N, n_train, n_test, k=K,
                                             batch=B)
        want = {"forward": layers * (steps + evals), "dK/dV": layers * steps,
                "dQ": layers * steps, **merge_counts(len(lengths), rounds)}
        assert counts == want, (name, e, counts, want)
        launches.append(counts)
        sec = hist.epoch_duration[e]
        ms.append(1e3 * sec / steps)
        ph = {k: sum(v) for k, v in m.phase_times.items()}
        rate = (f"{tokens / sec:.1f} tokens/s (non-pad)" if tokens
                else f"{n_train / sec:.2f} samples/s")
        log(card, f"moe-vgg {name} epoch {e + 1}/{epochs} (B={B} K={K} "
            f"N={N}, {n_train} + {n_test} samples): train loss "
            f"{hist.train_loss[e]:.4f}, validation loss "
            f"{hist.validation_loss[e]:.4f}, accuracy "
            f"{hist.accuracy[e]:.2f}; {steps} local steps in {rounds} "
            f"rounds, wall {sec:.4f} s = {steps * B / sec:.2f} samples/s, "
            f"{rate}, {1e3 * sec / steps:.3f} ms per local step; data_wait "
            f"{ph['data_wait']:.4f} s, dispatch {ph['dispatch']:.4f} s, "
            f"merge_wait {ph['merge_wait']:.4f} s; launches {counts} (= "
            f"{layers} layers x {steps} steps (+ {evals} eval slots), "
            f"{len(lengths)} buckets x {rounds} rounds); peak device memory "
            f"{m.hbm_peak_bytes / 2**20:.1f} MiB")
    log(card, f"moe-vgg {name} job: {wall:.3f} s for {epochs} epochs, loss "
        f"{hist.train_loss[0]:.4f} -> {hist.train_loss[-1]:.4f}, ms per "
        f"local step {', '.join(f'{v:.3f}' for v in ms)}; "
        f"{sum(t.numel() for t in job.state.values())} parameters in "
        f"{len(lengths)} buckets at {MV_BUCKET_MB:g} MB (largest "
        f"{max(lengths)})")
    return {"launches": launches, "ms_per_step": ms,
            "bucket_lengths": lengths, "job": job}


def moe_trace(torch, card, seed, job):
    """(a) where a gpt-moe-mini step's time goes: one worker's round of one
    local step (B=8, T=512, bf16, the job's weights) profiled, and the
    dispatch and combine einsums of one layer (forward and backward, f32,
    [B*T, E, C] = [4096, 8, 640]) timed alone at the step's shapes: their
    share of the step's device time for the 4 layers."""
    from kubeml_tpu_torch.models import gpt
    from kubeml_tpu_torch.parallel.ep import route_tokens

    engine, module = job._engine, job._engine.module
    state = {k: v.detach().clone() for k, v in job.state.items()}
    rng = np.random.default_rng(seed + 28)
    args = lm_round(rng, 1, 1, MOE_B, TRAIN_T)
    wall_ms, by_name = _profiled_round(torch, engine, state, args, MOE_LR)
    busy = _log_profile(card, f"moe-vgg gpt-moe-mini trace (one worker, 1 "
                        f"local step, B={MOE_B} T={TRAIN_T}, bf16)",
                        wall_ms, by_name, 1)
    dev = torch.device("cuda")
    T, D = MOE_B * TRAIN_T, module.hidden
    x = torch.randn(T, D, device=dev, requires_grad=True)
    router = torch.randn(D, module.n_experts, device=dev) / D ** 0.5
    with torch.no_grad():
        dispatch, combine, _ = route_tokens(
            router, x, k=gpt.MOE_K, capacity_factor=gpt.CAPACITY_FACTOR)
    combine = combine.clone().requires_grad_(True)
    E, C = dispatch.shape[1:]
    out = torch.randn(E, C, D, device=dev, requires_grad=True)
    g_in = torch.randn(E, C, D, device=dev)
    g_y = torch.randn(T, D, device=dev)

    def dispatch_combine():
        ein = torch.einsum("tec,td->ecd", dispatch, x)
        y = torch.einsum("tec,ecd->td", combine, out)
        torch.autograd.grad([ein, y], [x, combine, out], [g_in, g_y])

    one = event_ms(torch, dispatch_combine)
    per_step = module.layers * one
    share = (f"{100 * per_step / busy:.2f}% of the profiled step's device "
             f"time" if busy else "device time of the step not measured")
    log(card, f"moe-vgg gpt-moe-mini dispatch + combine einsums, forward "
        f"and backward, f32, [{T}, {E}, {C}] x [{T}, {D}]: {one:.4f} ms a "
        f"layer, {per_step:.4f} ms for {module.layers} layers = {share}")


def vgg_trace(torch, card, seed, job):
    """(b) one worker's round of one local step of vgg11 (B=128, bf16, the
    job's weights) profiled: ms per step and the device idle share."""
    state = {k: v.detach().clone() for k, v in job.state.items()}
    rng = np.random.default_rng(seed + 29)
    x, y = cifar100_arrays(rng, VGG_B)
    batch = cifar100_dataset().transform_train(x, y)
    batch = {k: v.reshape((1, 1) + v.shape) for k, v in batch.items()}
    args = (batch, np.ones((1, 1, VGG_B), np.float32),
            np.ones((1, 1), np.float32), np.ones(1, np.float32),
            rng.integers(0, 2 ** 32, (1, 1, 2), dtype=np.uint32))
    wall_ms, by_name = _profiled_round(torch, job._engine, state, args,
                                       VGG_LR)
    _log_profile(card, f"moe-vgg vgg11 trace (one worker, 1 local step, "
                 f"B={VGG_B}, bf16)", wall_ms, by_name, 1)


def moe_vgg_check(torch, card, seed):
    """(c) the card against the CPU: one f32 round of a gpt-moe-mini at
    gpt-nano's widths with 4 experts (dropout 0, AdamW, W=2 lanes through
    its 4 MB plan: the flash kernels in f32, one fused merge launch for
    its buckets) within 2 x K x lr, 99.5 % of the weights within 1e-5 (AdamW's
    first steps move every weight by about lr whatever the gradient, so
    the share is what catches a wrong kernel); a hidden-64 vgg11 (f32,
    dropout 0) forward within 1e-4 and one round (SGD with momentum)
    within 1e-4."""
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPTModule, GPTMoEMini
    from kubeml_tpu_torch.models.vgg import VGG11, VGGModule
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine
    from kubeml_tpu_torch.parallel.merge import BucketedMerge

    class TinyMoE(GPTMoEMini):
        def build(self, dtype=None, device=None):
            return GPTModule(**MOE_TINY, dropout=0.0, dtype=torch.float32,
                             device=device)

    class SmallVGG(VGG11):
        def build(self, dtype=None, device=None):
            return VGGModule(hidden=VGG_CHECK_HIDDEN, dropout=0.0,
                             features=self.features, dtype=torch.float32,
                             device=device)

    c = MOE_CHECK
    W, K = c["W"], c["K"]
    args = lm_round(np.random.default_rng(seed + 30), W, K, c["B"], c["T"])
    model = TinyMoE()
    start = params_from_flax(random_flax_params(**MOE_TINY, seed=seed))
    buckets = BucketedMerge(bucket_mb=MV_BUCKET_MB).comm_proxy(start)[
        "buckets_per_round"]
    out = {}
    for dev in ("cuda", "cpu"):
        engine = KAvgEngine(model.build(device=dev), model.loss,
                            model.metrics, model.configure_optimizers,
                            n_lanes=W, merge_bucket_mb=MV_BUCKET_MB)
        before = fa.fa_fwd_kernel.launches
        merge_count_zero()
        out[dev] = engine.train_round({k: v.to(dev, copy=True) for k, v in
                                       start.items()}, *args, MOE_LR, 0)
        flash = fa.fa_fwd_kernel.launches - before
        merges = merge_count_now()
        steps = int((args[2] * args[3][:, None]).sum())
        want = ((MOE_TINY["layers"] * steps, merge_counts(buckets, 1))
                if dev == "cuda" else (0, merge_counts(0, 0)))
        assert (flash, merges) == want, (dev, flash, merges, want)
    (card_state, card_st), (cpu_state, cpu_st) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(card_st.loss_sum, cpu_st.loss_sum, rtol=1e-4)
    diffs = torch.cat([(card_state[n].cpu() - cpu_state[n]).abs().ravel()
                       for n in cpu_state])
    within = float((diffs <= 1e-5).float().mean())
    assert float(diffs.max()) <= 2 * K * MOE_LR, float(diffs.max())
    assert within >= 0.995, within
    log(card, f"moe-vgg gpt-moe-mini f32 round at gpt-nano's widths with "
        f"{MOE_TINY['n_experts']} experts (W={W} lanes, K={K} B={c['B']} "
        f"T={c['T']}: {MOE_TINY['layers']} x {steps} flash forwards, "
        f"{buckets} buckets in one fused merge launch), card (kernels) vs "
        f"CPU (plain): "
        f"loss sums {card_st.loss_sum.tolist()} vs "
        f"{cpu_st.loss_sum.tolist()}, merged params max|diff| "
        f"{float(diffs.max()):.3g} (bound {2 * K * MOE_LR:g}), "
        f"{100 * within:.3f} % within 1e-5")

    rng = np.random.default_rng(seed + 31)
    vgg = SmallVGG()
    x = rng.standard_normal((4, CIFAR_HW, CIFAR_HW, 3)).astype(np.float32)
    cpu_mod = vgg.init_module({"x": x}, torch.Generator().manual_seed(seed),
                              "cpu")
    card_mod = vgg.build(device="cuda")
    card_mod.load_state_dict(cpu_mod.state_dict())
    with torch.no_grad():
        fwd = float((card_mod(torch.from_numpy(x).to("cuda")).cpu()
                     - cpu_mod(torch.from_numpy(x))).abs().max())
    assert fwd <= VIS_CPU_BOUND, fwd
    xs, ys = cifar100_arrays(rng, W * K * c["B"])
    batch = cifar100_dataset().transform_train(xs, ys)
    batch = {k: v.reshape((W, K, c["B"]) + v.shape[1:])
             for k, v in batch.items()}
    vargs = (batch, np.ones((W, K, c["B"]), np.float32),
             np.ones((W, K), np.float32), np.ones(W, np.float32),
             rng.integers(0, 2 ** 32, (W, K, 2), dtype=np.uint32))
    start = {k: v.detach().clone() for k, v in cpu_mod.state_dict().items()}
    res = {}
    for dev, mod in (("cuda", card_mod), ("cpu", cpu_mod)):
        engine = KAvgEngine(mod, vgg.loss, vgg.metrics,
                            vgg.configure_optimizers, n_lanes=W,
                            merge_bucket_mb=MV_BUCKET_MB)
        res[dev], _ = engine.train_round(
            {k: v.to(dev, copy=True) for k, v in start.items()}, *vargs,
            VGG_LR, 0)
    rnd = max(float((res["cuda"][k].cpu() - res["cpu"][k]).abs().max())
              for k in res["cpu"])
    assert rnd <= VIS_CPU_BOUND, rnd
    log(card, f"moe-vgg vgg11 at hidden {VGG_CHECK_HIDDEN}, f32 (cuDNN, no "
        f"TF32), card vs CPU: forward of 4 images max|diff| {fwd:.3g}, one "
        f"round (W={W} lanes, K={K} B={c['B']}, SGD momentum 0.9) merged "
        f"params max|diff| {rnd:.3g} (bound {VIS_CPU_BOUND:g})")


def moe_refusal(torch, card):
    """(e) a DecodeEngine over a gpt-moe-mini module on the card raises
    the reference's refusal."""
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.serve.engine import DecodeEngine

    module = get_model("gpt-moe-mini")().build(device="cuda")
    try:
        DecodeEngine(module, device="cuda")
    except ValueError as e:
        assert str(e) == MOE_DECODE_REFUSAL, str(e)
    else:
        raise AssertionError("DecodeEngine served an MoE module")
    log(card, f"moe-vgg refusal: DecodeEngine(gpt-moe-mini) on the card "
        f"raised ValueError({MOE_DECODE_REFUSAL!r}), the reference's")


# ----------------------------------------------------------------- phase 22
SYNC_W, SYNC_K, SYNC_B, SYNC_T = 2, 4, 8, 512   # G = W x B = 16 a step
SYNC_LANES, SYNC_DISPATCHES, SYNC_LR = 2, 2, 1e-3
SYNC_BUCKET_MB = 4.0
SYNC_STRATEGIES = (None, "bucketed", "ef_bf16", "ef_int8")
# (a)'s gpt-mini f32 dispatches: G = 2 sequences a step, cut from 16 for
# the CPU's plain run; (a2) holds #2-#4 at the bf16 path's G = 16
SYNC_CHECK = dict(W=2, K=4, B=1, T=512)
SYNC_JOB_TRAIN, SYNC_JOB_EPOCHS = 512, 2        # (e)'s windows and epochs
SYNC_FLASH = ("forward", "dK/dV", "dQ")


def sync_name(strategy) -> str:
    return strategy or "implicit"


def sync_setup(torch, name, seed, dtype, device, strategy, model=None,
               **knobs):
    """A registered GPT with weights from the seed (through convert.py),
    a SyncDPEngine over it on SYNC_LANES lanes with ``strategy``'s
    gradient merge (bucketed at SYNC_BUCKET_MB, EF at its default 4 MB)
    and the layout ``knobs`` (zero1, fsdp), and its initial state."""
    from kubeml_tpu_torch.convert import (flax_layout_shapes,
                                          params_from_flax,
                                          random_flax_params)
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    model = model or get_model(name)()
    module = model.build(dtype=dtype, device=device)
    params = random_flax_params(**GPT_CONFIGS[name], seed=seed)
    module.load_state_dict(params_from_flax(params))
    state = {n: p.detach().clone() for n, p in module.named_parameters()}
    engine = SyncDPEngine(
        module, model.loss, model.configure_optimizers, n_lanes=SYNC_LANES,
        merge_strategy=strategy,
        merge_bucket_mb=SYNC_BUCKET_MB if strategy == "bucketed" else 0.0,
        layout_shapes=flax_layout_shapes(state, {"params": params}), **knobs)
    return module, engine, engine.init_state(state)


def sync_dispatch(rng, W, K, B, T, extra=None):
    """One dispatch's global batches: phase 7's round (worker 1's step 2
    masked, so lane 1 of global step 2 holds no real sample) reflowed by
    the job's [W, S, B] -> [S, W*B]; ``extra(x)`` adds batch leaves.
    Returns (batch, sample mask, step keys, real global steps)."""
    from kubeml_tpu_torch.train.job import TrainJob

    batch, smask, step_mask, wmask, rngs = lm_round(rng, W, K, B, T)
    if extra is not None:
        batch.update(extra(batch["x"]))
    mask = TrainJob._to_global(smask * step_mask[:, :, None]
                               * wmask[:, None, None])
    return ({k: TrainJob._to_global(v) for k, v in batch.items()}, mask,
            rngs[0], int((mask.sum(axis=1) > 0).sum()))


def sync_kernels():
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm

    return {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
            "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
            "merge segments": MergeSegments()}


def sync_plan(layers, strategy, steps, lanes_run=SYNC_LANES) -> dict:
    """The launches ``steps`` real global steps call for: the flash kernels
    once a layer per backward pass (one a step on the implicit path, one
    a lane on the explicit one, every lane of a real step running), the
    fused merge once a step under the bucketed and EF merges (gpt-mini's
    5 buckets in one launch), never on the implicit path."""
    passes = steps * (lanes_run if strategy else 1)
    out = {k: layers * passes for k in SYNC_FLASH}
    out.update(merge_counts(JOB_BUCKETS, steps) if strategy
               else {"fused_merge": 0, "merge segments": 0})
    return out


def sync_launches(sync, kernel) -> dict:
    """One kernel's phase-22 launches for the kernels line: per gradient
    path per dispatch, the skipped dispatch, the job per epoch."""
    out = {name: [c[kernel] for c in row["launches"]]
           for name, row in sync["paths"].items()}
    out["skipped_dispatch"] = sync["skip"][kernel]
    out["job"] = [c[kernel] for c in sync["job"]["launches"]]
    return out


def phase_syncdp(torch, card, seed) -> dict:
    """Phase 22: the SyncDP engine on the card (see the module
    docstring): (b) each gradient path at gpt-mini's widths with its
    launches, (a) card vs CPU, (a2) #2-#4 at the path's shapes, (c) #5
    at the SyncDP call, (d) a skipped step, (e) a job. Returns the launches and rows for the kernels
    line."""
    t0 = time.perf_counter()
    out = {"paths": sync_paths(torch, card, seed)}
    sync_card_vs_cpu(torch, card, seed)
    out["flash"] = sync_flash(torch, card, seed)
    out["count1"] = sync_count1(torch, card, seed)
    out["skip"] = sync_skip(torch, card, seed)
    out["job"] = sync_job(torch, card, seed)
    log(card, f"syncdp phase 22: {time.perf_counter() - t0:.3f} s")
    return out


def sync_paths(torch, card, seed) -> dict:
    """(b): SYNC_DISPATCHES dispatches of SYNC_K global steps of G=16
    sequences of T=512 on the implicit path and under each explicit
    strategy, gpt-mini bf16 with dropout 0.1; the kernels' counts zeroed
    just before each dispatch and read just after, against the plan; the
    loss finite, no step skipped; ms per global step."""
    kernels = sync_kernels()
    rows = {}
    for strategy in SYNC_STRATEGIES:
        module, engine, state = sync_setup(torch, "gpt-mini", seed,
                                           torch.bfloat16, "cuda", strategy)
        rng = np.random.default_rng(seed + 22)
        counts, ms, losses = [], [], []
        for _ in range(SYNC_DISPATCHES):
            batch, mask, keys, steps = sync_dispatch(
                rng, SYNC_W, SYNC_K, SYNC_B, SYNC_T)
            torch.cuda.synchronize()
            for fn in kernels.values():        # the main path's run starts
                fn.launches = 0
            t = time.perf_counter()
            state, loss = engine.train_steps(state, batch, mask, keys,
                                             SYNC_LR, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = {k: fn.launches for k, fn in kernels.items()}  # ... ends
            want = sync_plan(module.layers, strategy, steps)
            assert got == want, (strategy, got, want)
            assert not engine.last_skipped_device.any(), strategy
            assert torch.isfinite(loss).all(), (strategy, loss)
            counts.append(got)
            ms.append(1e3 * wall / steps)
            losses.append(loss.float().mean().item())
        name = sync_name(strategy)
        rows[name] = {"launches": counts, "ms_per_step": ms}
        log(card, f"syncdp gpt-mini {name}: {SYNC_DISPATCHES} dispatches of "
            f"{steps} global steps of G={SYNC_W * SYNC_B} x T={SYNC_T} over "
            f"{SYNC_LANES} lanes, mean loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, ms per global step "
            + ", ".join(f"{x:.3f}" for x in ms)
            + f" (first dispatch warm-up included); launches {counts[-1]} "
            f"= plan (a layer per backward pass: "
            f"{'every lane of a' if strategy else 'one a'} step; merge "
            f"{'one launch of 5 segments a step' if strategy else 'none'}); "
            f"{engine.readbacks} guard readbacks over "
            f"{SYNC_DISPATCHES * steps} steps")
    return rows


def sync_card_vs_cpu(torch, card, seed) -> None:
    """(a): gpt-mini at its published widths in f32 (dropout 0),
    SYNC_DISPATCHES dispatches of SYNC_CHECK's global steps on each
    gradient path on the card (f32 flash kernels, the fused merge) and
    on the CPU (plain versions): the weights within AdamW's 2 x steps x
    lr, 99.5 % within 1e-5, the same steps skipped (none)."""
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS, GPTMini, GPTModule

    class MiniCheck(GPTMini):
        def build(self, dtype=None, device=None):
            return GPTModule(**GPT_CONFIGS["gpt-mini"], dropout=0.0,
                             dtype=torch.float32, device=device)

    c = SYNC_CHECK
    for strategy in SYNC_STRATEGIES:
        out, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t = time.perf_counter()
            _, engine, state = sync_setup(torch, "gpt-mini", seed,
                                          torch.float32, dev, strategy,
                                          model=MiniCheck())
            rng = np.random.default_rng(seed + 23)
            skipped, steps = [], 0
            for _ in range(SYNC_DISPATCHES):
                batch, mask, keys, n = sync_dispatch(rng, c["W"], c["K"],
                                                     c["B"], c["T"])
                state, _ = engine.train_steps(state, batch, mask, keys,
                                              SYNC_LR, 0)
                skipped += engine.last_skipped_device.cpu().tolist()
                steps += n
            out[dev] = ({k: v.cpu() for k, v in state["params"].items()},
                        skipped)
            secs[dev] = time.perf_counter() - t
        (card_p, card_skip), (cpu_p, cpu_skip) = out["cuda"], out["cpu"]
        assert card_skip == cpu_skip and not any(card_skip), strategy
        diffs = torch.cat([(card_p[k] - cpu_p[k]).abs().ravel()
                           for k in cpu_p])
        within = float((diffs <= 1e-5).float().mean())
        bound = 2 * steps * SYNC_LR
        assert float(diffs.max()) <= bound, (strategy, float(diffs.max()))
        assert within >= 0.995, (strategy, within)
        log(card, f"syncdp gpt-mini f32 {sync_name(strategy)}, card "
            f"(kernels) vs CPU (plain), {steps} global steps of G="
            f"{c['W'] * c['B']} x T={c['T']}: params max|diff| "
            f"{float(diffs.max()):.3g} (bound {bound:g}), "
            f"{100 * within:.3f} % within 1e-5; card {secs['cuda']:.3f} s, "
            f"CPU {secs['cpu']:.3f} s")


def sync_flash(torch, card, seed) -> dict:
    """(a2): #2-#4 in bf16 at the shapes the bf16 path hands them, the
    implicit path's global batch [16, 512] and the explicit path's lane
    [8, 512] (H=4, D=64, causal), the keep-mask of a dispatch's first
    global step (half the sequences ending in padding), q, k, v and dO
    ~ N(0, 1): each kernel against its plain version within the flash
    tolerance; warm times beside the plain version's, SDPA's and the
    bound. Rows by (shape, kernel)."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 26)
    batch, *_ = sync_dispatch(rng, SYNC_W, SYNC_K, SYNC_B, SYNC_T)
    x = torch.from_numpy(batch["x"][0]).to(dev)
    tol = FLASH_TOL["bf16"]
    rows = {}
    for path, B in (("implicit", SYNC_W * SYNC_B),
                    ("explicit lane", SYNC_W * SYNC_B // SYNC_LANES)):
        pad = (x[:B] != 0).float()
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (B, SYNC_T, FA_H, FA_D)).astype(np.float32)).to(dev,
                                                            torch.bfloat16)
            for _ in range(4))
        out, m, l = fa.fa_fwd_kernel(q, k, v, pad, True)
        ref_out, ref_m, ref_l = fa._fa_forward_plain(q, k, v, pad, True)
        bwd = (q, k, v, pad, g, m, l, fa._delta(g, out), True)
        dk, dv = fa.fa_bwd_dkv_kernel(*bwd)
        dq = fa.fa_bwd_dq_kernel(*bwd)
        torch.cuda.synchronize()
        errs = {}
        for kernel, got, ref in (
                ("forward", (out, m, l), (ref_out, ref_m, ref_l)),
                ("dK/dV", (dk, dv), fa._fa_bwd_dkv_plain(*bwd)),
                ("dQ", (dq,), (fa._fa_bwd_dq_plain(*bwd),))):
            for a, b in zip(got, ref):
                torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                           atol=tol)
            # the error of the outputs (m sits at NEG_INF scale)
            errs[kernel] = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got[:2 if kernel == "dK/dV"
                                                   else 1], ref))
        lib_f, lib_b = library_flash_ms(torch, q, k, v, g, pad, True)
        for kernel, fn, plain in (
                ("forward", lambda: fa.fa_fwd_kernel(q, k, v, pad, True),
                 lambda: fa._fa_forward_plain(q, k, v, pad, True)),
                ("dK/dV", lambda: fa.fa_bwd_dkv_kernel(*bwd),
                 lambda: fa._fa_bwd_dkv_plain(*bwd)),
                ("dQ", lambda: fa.fa_bwd_dq_kernel(*bwd),
                 lambda: fa._fa_bwd_dq_plain(*bwd))):
            b_ms, b_by = flash_bound(q, True, kernel)
            row = dict(shape=f"{path}: B={B} T={SYNC_T} H={FA_H} D={FA_D} "
                       f"causal, {int((pad[:, -1] == 0).sum())} of {B} "
                       "sequences ending in padding",
                       max_abs_err=errs[kernel], ms=time_ms(torch, fn),
                       plain_ms=time_ms(torch, plain), bound_ms=b_ms,
                       bound_by=b_by,
                       library_ms=lib_f if kernel == "forward" else lib_b)
            rows[(path, kernel)] = row
            log(card, f"syncdp flash {kernel} bf16 at the {row['shape']}: "
                f"kernel {row['ms']:.4f} ms (L2 warm), plain "
                f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
                f"ms, bound {b_ms:.5f} ms ({b_by}), {row['ms'] / b_ms:.1f}x "
                f"bound, max|err| {errs[kernel]:.3g} (tol {tol})")
    return rows


def sync_count1(torch, card, seed) -> dict:
    """(c): #5 as the SyncDP step calls it, avg mode at count 1 over a
    zero ref, one grouped launch of gpt-mini's 5 buckets: bit for bit
    against the plain version at raw_count 2 (the sum) and 0 (zeros);
    the launch timed L2-warm and L2-cold (operand sets cycled over
    COLD_BYTES, as phase 9 (a2)) against the plain version and the bytes
    bound (8 B an element: s read, out written), which the cold time is
    held to."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 24)

    def operands():
        return [(torch.randn(n, device=dev, generator=gen) * 3,
                 torch.zeros(n, device=dev)) for n in MERGE_BUCKETS]
    pairs = operands()
    one = torch.ones((), device=dev)
    for raw in (2.0, 0.0):
        raw_t = torch.tensor(raw, device=dev)
        before = fm.fused_merge_kernel.launches
        got = fm.fused_merge_apply("avg", pairs, one, raw_t)
        torch.cuda.synchronize()
        assert fm.fused_merge_kernel.launches == before + 1
        for (s, ref), g in zip(pairs, got):
            want = fm._apply_plain("avg", s, ref, one, raw_t, 0.0)
            assert torch.equal(g, want), (raw, s.numel())
            assert torch.equal(g, s if raw else ref), (raw, s.numel())
    raw_t = torch.tensor(2.0, device=dev)

    def merge(ps):
        return fm.fused_merge_apply("avg", ps, one, raw_t)

    n = sum(MERGE_BUCKETS)
    sets = [(pairs,)] + [(operands(),) for _ in range(
        max(2, -(-int(COLD_BYTES) // (8 * n))) - 1)]
    ms, cold_ms = time_ms(torch, lambda: merge(pairs)), time_ms_cold(
        torch, merge, sets)
    del sets
    plain_ms = time_ms(torch, lambda: [
        fm._apply_plain("avg", s, ref, one, raw_t, 0.0) for s, ref in pairs])
    row = {"n": n, "buckets": len(MERGE_BUCKETS), "max_abs_err": 0.0,
           "ms": ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
           "bound_ms": merge_bound(n, "avg"), "bound_by": "bytes",
           "library_ms": None}
    log(card, f"syncdp #5 at count 1 over a zero ref, gpt-mini's "
        f"{len(MERGE_BUCKETS)} buckets ({n} elements) in one launch: kernel "
        f"== plain bit for bit at raw_count 2 and 0; kernel L2-cold "
        f"{cold_ms:.4f} ms = {cold_ms / row['bound_ms']:.2f}x its bound "
        f"{row['bound_ms']:.5f} ms (bytes, 8 B an element); L2-warm "
        f"{ms:.4f} ms (43 MB inside the 50 MB L2, not comparable with the "
        f"bound); plain {plain_ms:.4f} ms")
    return row


def sync_skip(torch, card, seed) -> dict:
    """(d): phase 16's weighted gpt-mini (a float per-sequence weight w,
    the leaf a NaN burst poisons) under ef_bf16: one clean dispatch, then
    a FaultPlan nan event into worker 1 of round 0: every global step of
    that dispatch is skipped (lane 1 went non-finite), and parameters,
    Adam's moments and step counts equal the state before it bit for
    bit, the EF residuals are zero, the losses 0; the kernels still ran
    (the backward passes and one merge a step) and are counted."""
    from kubeml_tpu_torch.data.loader import RoundBatch
    from kubeml_tpu_torch.faults import FaultPlan
    from kubeml_tpu_torch.train.job import TrainJob

    model_cls, _ = dg_classes()
    module, engine, state = sync_setup(torch, "gpt-mini", seed,
                                       torch.bfloat16, "cuda", "ef_bf16",
                                       model=model_cls())
    rng = np.random.default_rng(seed + 25)

    def weights(x):
        return {"w": np.ones(x.shape[:3], np.float32)}

    batch, mask, keys, steps = sync_dispatch(rng, SYNC_W, SYNC_K, SYNC_B,
                                             SYNC_T, extra=weights)
    state, _ = engine.train_steps(state, batch, mask, keys, SYNC_LR, 0)
    assert not engine.last_skipped_device.any()
    opt = state["opt_state"]

    def snapshot():
        return ({k: v.clone() for k, v in state["params"].items()},
                [{k: v.clone() for k, v in opt.state[p].items()}
                 for p in opt.param_groups[0]["params"]])
    before = snapshot()
    assert any(bool(v.any()) for v in state["merge_resid"].values())
    raw, smask, step_mask, wmask, rngs = lm_round(rng, SYNC_W, SYNC_K,
                                                  SYNC_B, SYNC_T)
    raw.update(weights(raw["x"]))
    plan = FaultPlan.parse({"events": [{"kind": "nan", "epoch": 0,
                                        "round": 0, "worker": 1}]})
    plan.epoch = 0
    rb = plan.inject_batch(RoundBatch(raw, smask, step_mask, wmask, rngs,
                                      round_index=0, num_rounds=1))
    mask = TrainJob._to_global(rb.sample_mask * rb.step_mask[:, :, None]
                               * rb.worker_mask[:, None, None])
    steps = int((mask.sum(axis=1) > 0).sum())
    kernels = sync_kernels()
    for fn in kernels.values():
        fn.launches = 0
    state, loss = engine.train_steps(
        state, {k: TrainJob._to_global(v) for k, v in rb.batch.items()},
        mask, rngs[0], SYNC_LR, 0)
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in kernels.items()}
    want = sync_plan(module.layers, "ef_bf16", steps)
    assert got == want, (got, want)
    assert engine.last_skipped_device.tolist() == [1.0] * steps
    assert not loss.any(), loss
    params, moments = before
    assert all(torch.equal(state["params"][k], v) for k, v in params.items())
    for p, old in zip(opt.param_groups[0]["params"], moments):
        assert opt.state[p].keys() == old.keys()
        assert all(torch.equal(opt.state[p][k], v) for k, v in old.items())
    assert not any(bool(v.any()) for v in state["merge_resid"].values())
    step = int(next(iter(moments))["step"])
    log(card, f"syncdp skipped step: a nan event in worker 1 of round 0 "
        f"skipped all {steps} global steps of the dispatch (losses 0); "
        f"parameters, Adam's moments and step count ({step}) equal the "
        f"state before it bit for bit, EF residuals zero; launches {got} "
        f"(the backward passes and one merge a step still ran)")
    return got


def sync_epoch_plan(job, n, k, b):
    """(real global steps, real samples, eval slots) of one of the job's
    epochs at N=n: a round's global steps are its longest worker's."""
    plan = job._loader.plan(n, k, b)
    steps = sum(rp.max_steps for rp in plan.rounds)
    samples = sum(c.num_samples for rp in plan.rounds for c in rp.chunks)
    return steps, samples, _epoch_counts(n, n, n_train=SYNC_JOB_TRAIN,
                                         n_test=JOB_TEST, k=k, batch=b)[2]


def sync_job(torch, card, seed) -> dict:
    """(e): TrainJob(gpt-mini, engine='syncdp', merge_compress='bf16', N=2,
    K=4, B=8) over SYNC_JOB_TRAIN + JOB_TEST windows of T=512 (an identity
    transform: the batch is the int32 windows, which the device cache
    holds) from the replicated device cache, SYNC_JOB_EPOCHS epochs,
    validating each:
    launches per epoch against the plan, ms per global step, samples/s,
    the guard's host readbacks per step; one dispatch of the trained
    engine profiled (idle share, DtoH copies per step); then the K-avg
    job (phase 10's engine, no train_stats) over the same data for one
    epoch, its ms per local step from this run."""
    import os
    import tempfile

    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    kernels = sync_kernels()
    home = os.environ.get("KUBEML_TPU_HOME")
    with tempfile.TemporaryDirectory(prefix="kubeml_smoke_") as tmp:
        os.environ["KUBEML_TPU_HOME"] = tmp
        try:
            rng = np.random.default_rng(seed + 26)
            DatasetRegistry().create(
                "tokens", token_windows(rng, SYNC_JOB_TRAIN, SYNC_T),
                np.zeros(SYNC_JOB_TRAIN, np.int32),
                token_windows(rng, JOB_TEST, SYNC_T),
                np.zeros(JOB_TEST, np.int32))
            epochs = []

            def publish(m):
                epochs.append((m, {k: fn.launches
                                   for k, fn in kernels.items()}))
                for fn in kernels.values():
                    fn.launches = 0

            task = job_task("smoke-syncdp", SYNC_JOB_EPOCHS,
                            default_parallelism=SYNC_W,
                            static_parallelism=True, k=SYNC_K,
                            engine="syncdp", merge_compress="bf16",
                            device_cache="on", validate_every=1,
                            train_stats=False)
            job = TrainJob(task, get_model("gpt-mini")(),
                           KubeDataset("tokens"), device="cuda",
                           n_lanes=SYNC_LANES,
                           callbacks=JobCallbacks(publish_metrics=publish))
            for fn in kernels.values():
                fn.launches = 0
            record = job.train()
            hist = record.data
            assert job._device_cache.layout == "replicated"
            assert hist.train_loss[-1] < hist.train_loss[0], hist.train_loss
            assert hist.dropped_workers == [0.0] * SYNC_JOB_EPOCHS
            engine = job._sync_engine
            layers = engine.module.layers
            steps, samples, evals = sync_epoch_plan(job, SYNC_W, SYNC_K,
                                                    SYNC_B)
            launches, ms = [], []
            for e, (m, got) in enumerate(epochs):
                want = sync_plan(layers, "ef_bf16", steps)
                want["forward"] += layers * evals
                assert got == want, (e, got, want)
                assert "syncdp.train_indexed" in m.cost_programs
                launches.append(got)
                sec = hist.epoch_duration[e]
                ms.append(1e3 * sec / steps)
                log(card, f"syncdp job gpt-mini ef_bf16 epoch {e + 1}/"
                    f"{SYNC_JOB_EPOCHS}: train loss {hist.train_loss[e]:.4f}"
                    f", validation loss {hist.validation_loss[e]:.4f}, "
                    f"{steps} global steps of G={SYNC_W * SYNC_B} in {sec:.4f}"
                    f" s = {1e3 * sec / steps:.3f} ms per global step, "
                    f"{samples / sec:.2f} samples/s; launches {got} (= "
                    f"{layers} layers x {SYNC_LANES} lanes x {steps} steps "
                    f"(+ {evals} eval slots), 1 merge launch of 5 segments a "
                    f"step)")
            readbacks = engine.readbacks / (steps * SYNC_JOB_EPOCHS)
            assert readbacks == 1.0, readbacks
            idle, dtoh = sync_profile(torch, card, job)
            kavg_ms = sync_kavg_job(torch, card)
        finally:
            if home is None:
                os.environ.pop("KUBEML_TPU_HOME", None)
            else:
                os.environ["KUBEML_TPU_HOME"] = home
    log(card, f"syncdp job vs kavg job over the same {SYNC_JOB_TRAIN} "
        f"windows: {', '.join(f'{x:.3f}' for x in ms)} ms per global step "
        f"(G={SYNC_W * SYNC_B}, 2 lanes, ef_bf16) against the kavg job's "
        f"{kavg_ms:.3f} ms per local step (B={SYNC_B}, 4 MB bucketed merge "
        f"a round); guard readbacks {readbacks:g} per step, device DtoH "
        f"copies per step in the profiled dispatch {dtoh}, device idle "
        f"{idle}")
    return {"launches": launches, "ms_per_step": ms, "kavg_ms": kavg_ms,
            "idle": idle, "readbacks_per_step": readbacks, "dtoh": dtoh}


def sync_profile(torch, card, job):
    """One more dispatch of the trained job's engine (K global steps from
    the cache, replicated indices) under torch.profiler (CUDA activity):
    (device idle share of its wall time, DtoH copies per step), each
    "not measured" when the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    engine, state = job._sync_engine, job._sync_state
    rng = np.random.default_rng(0)
    idx = rng.integers(0, SYNC_JOB_TRAIN, (SYNC_K, SYNC_W * SYNC_B)).astype(
        np.int32)
    mask = np.ones(idx.shape, np.float32)
    keys = rng.integers(0, 2 ** 32, (SYNC_K, 2), dtype=np.uint32)
    cache = job._device_cache
    engine.train_steps_indexed(state, cache, idx, mask, keys, SYNC_LR, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_steps_indexed(state, cache, idx, mask, keys, SYNC_LR, 0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    by_name = device_events(torch, prof)
    if not by_name:
        return "not measured", "not measured"
    busy = sum(t for t, _ in by_name.values())
    _log_profile(card, "syncdp job dispatch (profiled, ef_bf16)",
                 wall_ms, by_name, SYNC_K)
    dtoh = sum(1 for ev in events if "DtoH" in ev.name) / SYNC_K
    return f"{100 * (1 - busy / wall_ms):.2f}%", f"{dtoh:g}"


def sync_kavg_job(torch, card) -> float:
    """The K-avg job over the registry's windows (N=2, K=4, B=8, the 4 MB
    bucketed merge, no train_stats, one epoch, from the device cache):
    ms per local step."""
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.job import TrainJob

    task = job_task("smoke-syncdp-kavg", 1, default_parallelism=SYNC_W,
                    static_parallelism=True, k=SYNC_K,
                    merge_bucket_mb=MERGE_CAP_MB, validate_every=0,
                    train_stats=False)
    job = TrainJob(task, get_model("gpt-mini")(), KubeDataset("tokens"),
                   device="cuda")
    hist = job.train().data
    steps = _epoch_counts(SYNC_W, SYNC_W, n_train=SYNC_JOB_TRAIN,
                          n_test=JOB_TEST, k=SYNC_K, batch=SYNC_B)[0]
    ms = 1e3 * hist.epoch_duration[0] / steps
    log(card, f"kavg job gpt-mini over the same windows: {steps} local "
        f"steps in {hist.epoch_duration[0]:.4f} s = {ms:.3f} ms per local "
        f"step")
    return ms


# ----------------------------------------------------------------- phase 23
DIST_STRATEGIES = (("bucketed", dict(merge_bucket_mb=MERGE_CAP_MB)),
                   ("ef_int8", dict(merge_compress="int8")))
DIST_LANES = 2            # lanes of every phase-23 run: 2 on one rank, or
                          # 1 on each of two
DIST_ROUNDS = 2           # round 1 warms up; round 2 is counted and timed
DIST_TIMEOUT = 120.0      # seconds: every join and collective of a rank
DIST_CHILD_S = 300.0      # seconds a launch of ranks may take
DIST_DUP_S = 60.0         # seconds a probe's join and collective may take
DIST_JOB_TRAIN, DIST_JOB_TEST = 128, 32    # (c): 2 rounds of 2 x 4 x 8
DIST_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "import chip_smoke; "
              "sys.exit(chip_smoke.dist_child(*sys.argv[2:]))")


def dist_kernels() -> dict:
    """#2-#5's counters (the merge's segments under its own name)."""
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops import fused_merge as fm

    return {"forward": fa.fa_fwd_kernel, "dK/dV": fa.fa_bwd_dkv_kernel,
            "dQ": fa.fa_bwd_dq_kernel, "fused_merge": fm.fused_merge_kernel,
            "merge segments": MergeSegments()}


def dist_collectives() -> dict:
    """The collective helpers' counters: each counts the collectives it
    issues (none without a group)."""
    from kubeml_tpu_torch.parallel import distributed as dl

    return {"all_reduce": dl.all_reduce, "all_gather": dl.all_gather_cat,
            "barrier": dl.barrier, "exchange": dl.exchange,
            "reduce_scatter": dl.reduce_scatter,
            "all_gather_into": dl.all_gather_into}


def dist_zero() -> None:
    for fn in dist_kernels().values():
        fn.launches = 0
    for fn in dist_collectives().values():
        fn.calls = 0


def dist_counts() -> tuple:
    return ({k: fn.launches for k, fn in dist_kernels().items()},
            {k: fn.calls for k, fn in dist_collectives().items()})


def dist_plan_collectives(name: str, buckets: int) -> dict:
    """A round's collectives over a group: one all-reduce of the count,
    one per bucket (two under ef_int8: the scale's MAX, then the sum),
    one all-gather of the per-worker rows."""
    per = 2 if name == "ef_int8" else 1
    return {"all_reduce": 1 + per * buckets, "all_gather": 1, "barrier": 0,
            "exchange": 0, "reduce_scatter": 0, "all_gather_into": 0}


def dist_rounds(torch, seed, name, knobs) -> dict:
    """DIST_ROUNDS rounds of phase 7's gpt-mini (bf16, dropout 0.1, W=2,
    K=4, B=8, T=512, worker 1's step 2 masked) at DIST_LANES lanes under
    the strategy, in this process's group or without one. The counters
    are zeroed just before the last round and read just after it."""
    module, engine, state = train_setup(torch, "gpt-mini", seed,
                                        torch.bfloat16, "cuda",
                                        n_lanes=DIST_LANES, **knobs)
    assert engine.merge_strategy == name, engine.merge_strategy
    to_device, copied = engine._to_device, []

    def counted(batch):
        # the batch bytes this rank's round copies to its card
        copied.append(sum(np.asarray(v).nbytes for v in batch.values()))
        return to_device(batch)

    engine._to_device = counted
    rng = np.random.default_rng(seed + 23)
    for r in range(DIST_ROUNDS):
        args = lm_round(rng, TRAIN_W, TRAIN_K, TRAIN_B, TRAIN_T)
        torch.cuda.synchronize()
        copied.clear()
        dist_zero()                          # the main path's run starts
        t0 = time.perf_counter()
        state, st = engine.train_round(state, *args, TRAIN_LR, 0)
        loss = st.loss_sum
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, calls = dist_counts()        # ... and ends here
    real = args[2] * args[3][:, None]
    mine = [w for w in range(TRAIN_W)
            if engine.layout.rank_of(w // (TRAIN_W // DIST_LANES))
            == engine.layout.rank]
    return {"state": {k: v.detach().cpu() for k, v in state.items()},
            "resid": {k: v.cpu() for k, v in (engine._ef_state or {}).items()},
            "counts": counts, "calls": calls, "ms": 1e3 * wall,
            "h2d_bytes": sum(copied),
            "loss": [float(v) for v in loss], "layers": module.layers,
            "steps": int(real[mine].sum()),
            "buckets": engine.merge_comm_proxy(state)["buckets_per_round"]}


def dist_job(torch, seed, outdir, rank, job_id="smoke-dist-job",
             **opts) -> dict:
    """(c): TrainJob(gpt-mini, ef_bf16, N=2, K=4, B=8, DIST_LANES lanes)
    for one epoch over DIST_JOB_TRAIN + DIST_JOB_TEST windows, in this
    process's group (``rank``) or without one (None), from a home of its
    own; ``opts`` (the engine, its merge or fsdp) replace ef_bf16, and
    ``f32=True`` among them computes in f32. Returns its history, its
    launches over the epoch (training and validation) and its wall."""
    import os

    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    f32 = opts.pop("f32", False)
    before = os.environ.get("KUBEML_TPU_HOME")
    os.environ["KUBEML_TPU_HOME"] = os.path.join(
        outdir, "single" if rank is None else f"p{rank}")
    try:
        rng = np.random.default_rng(seed + 24)
        DatasetRegistry().create(
            "tokens", token_windows(rng, DIST_JOB_TRAIN, TRAIN_T),
            np.zeros(DIST_JOB_TRAIN, np.int32),
            token_windows(rng, DIST_JOB_TEST, TRAIN_T),
            np.zeros(DIST_JOB_TEST, np.int32))
        published = []
        task = job_task(job_id, 1, default_parallelism=2,
                        static_parallelism=True, k=JOB_K, validate_every=1,
                        train_stats=False,
                        **(opts or dict(merge_compress="bf16")))
        job = TrainJob(task, get_model("gpt-mini")(
            dtype=torch.float32 if f32 else torch.bfloat16), token_dataset(),
                       device="cuda", n_lanes=DIST_LANES,
                       callbacks=JobCallbacks(publish_metrics=lambda m:
                                              published.append(
                                                  dist_counts())))
        torch.cuda.synchronize()
        dist_zero()                          # the main path's run starts
        hist = job.train().data
        counts, calls = published[0]         # ... and ends at the publish
    finally:
        if before is None:
            os.environ.pop("KUBEML_TPU_HOME", None)
        else:
            os.environ["KUBEML_TPU_HOME"] = before
    return {"history": {"train_loss": list(hist.train_loss),
                        "validation_loss": list(hist.validation_loss),
                        "accuracy": list(hist.accuracy),
                        "parallelism": list(hist.parallelism)},
            "counts": counts, "calls": calls,
            "seconds": float(hist.epoch_duration[0]),
            "layers": job._engine.module.layers,
            "state": {k: v.detach().cpu() for k, v in job.state.items()}}


def dist_worker_steps(n_train: int, n: int) -> list:
    """Each worker's local steps in one epoch of phase 10's plan (K, B)
    over ``n_train`` windows at N = ``n``."""
    from kubeml_tpu_torch.data.sharding import plan_epoch

    plan = plan_epoch(n_train, n, JOB_K, JOB_B)
    return [sum(r.chunks[w].num_steps for r in plan.rounds)
            for w in range(n)]


def gloo_cuda_probe(torch) -> dict:
    """Which collectives the gloo backend takes CUDA tensors for, tried
    directly (not through the port's helpers), each checked against its
    result: 'accepted' or the error's first line. The point-to-point pair
    is tried in processes of its own (mode 'gloo-p2p'): a failure there
    can abort the process."""
    import torch.distributed as dist

    rank = dist.get_rank()
    t = torch.full((4,), float(rank + 1), device="cuda")
    out = {}

    def gathered():
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        return torch.cat(parts)

    for name, fn, want in (
            ("all_reduce", lambda: _reduced(dist, t.clone()), [3.0] * 4),
            ("broadcast", lambda: _broadcast(dist, t.clone()), [1.0] * 4),
            ("all_gather", gathered, [1.0] * 4 + [2.0] * 4)):
        try:
            got = fn().cpu().tolist()
            out[name] = "accepted" if got == want else f"wrong: {got}"
        except Exception as e:  # noqa: BLE001 — the refusal is the answer
            out[name] = (f"refused: {type(e).__name__}: "
                         f"{(str(e).splitlines() or [''])[0][:240]}")
    return out


def _reduced(dist, t):
    dist.all_reduce(t)
    return t


def _broadcast(dist, t):
    dist.broadcast(t, 0)
    return t


def gloo_p2p_probe(torch) -> dict:
    """One isend/irecv pair of CUDA tensors between the two gloo ranks,
    directly: 'accepted' when the received tensor is the peer's."""
    import torch.distributed as dist

    rank = dist.get_rank()
    t = torch.full((4,), float(rank + 1), device="cuda")
    got = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, 1 - rank),
           dist.P2POp(dist.irecv, got, 1 - rank)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    ok = got.cpu().tolist() == [float(2 - rank)] * 4
    return {"error": None if ok else f"wrong: {got.cpu().tolist()}"}


def dist_ring(torch, seed) -> dict:
    """ring_psum over the two gloo ranks with a bf16 wire, of a CUDA
    leaf (its hops through the host, the helper's named path) and of the
    same values on the CPU: equal bit for bit, and within the bf16
    wire's tolerance of the plain sum."""
    import torch.distributed as dist

    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.parallel.collectives import ring_psum

    lanes = torch.from_numpy(np.random.default_rng(seed + 25).standard_normal(
        (2, 4099)).astype(np.float32))
    dl.exchange.calls = 0
    on_card = ring_psum(lanes[dist.get_rank()].cuda(), None, torch.bfloat16)
    on_host = ring_psum(lanes[dist.get_rank()], None, torch.bfloat16)
    total = lanes.sum(0)
    return {"equal": bool(torch.equal(on_card.cpu(), on_host)),
            "max_abs_err": float((on_host - total).abs().max()),
            "within": bool(torch.allclose(on_host, total, rtol=TOL["bf16"],
                                          atol=TOL["bf16"])),
            "exchanges": dl.exchange.calls, "n": int(total.numel())}


def dist_child(mode, outdir, seed) -> int:
    """A rank of phase 23, started by dist_launch with the KUBEML_*
    environment: 'nccl' (a): the rounds over NCCL; 'gloo' (b) + (c): the
    rounds, the job and the gloo probe; 'gloo-p2p': an isend/irecv pair
    of CUDA tensors over gloo; 'nccl-dup': two NCCL ranks on one card,
    the error NCCL gives. Writes its rows under ``outdir``."""
    import faulthandler
    import os

    import torch
    import torch.distributed as dist

    from kubeml_tpu_torch.parallel import distributed as dl

    faulthandler.dump_traceback_later(DIST_TIMEOUT, repeat=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(seed)
    if mode == "nccl-dup":
        rank = int(os.environ["KUBEML_PROCESS_ID"])
        rows = {}
        try:
            dl.initialize(timeout=DIST_DUP_S)
            dist.all_reduce(torch.ones(1, device="cuda"))
            torch.cuda.synchronize()
            rows["error"] = None
        except Exception as e:  # noqa: BLE001 — the error is the answer
            rows["error"] = f"{type(e).__name__}: {e}"[:2000]
        with open(os.path.join(outdir, f"{mode}_p{rank}.json"), "w") as f:
            json.dump(rows, f)
        os._exit(0)          # no teardown of a communicator that failed
    dl.initialize(backend=None if mode == "nccl" else "gloo",
                  timeout=DIST_TIMEOUT)
    rank = dl.rank()
    if mode == "gloo-p2p":
        with open(os.path.join(outdir, f"{mode}_p{rank}.json"), "w") as f:
            json.dump(gloo_p2p_probe(torch), f)
        dl.shutdown()
        return 0
    rows = {"world": dl.world_size(), "backend": dist.get_backend()}
    for name, knobs in DIST_STRATEGIES:
        out = dist_rounds(torch, seed, name, knobs)
        torch.save({"state": out.pop("state"), "resid": out.pop("resid")},
                   os.path.join(outdir, f"{mode}_{name}_p{rank}.pt"))
        rows[name] = out
    if mode == "gloo":
        job = dist_job(torch, seed, outdir, rank)
        torch.save(job.pop("state"), os.path.join(outdir, f"job_p{rank}.pt"))
        rows["job"] = job
        rows["ring"] = dist_ring(torch, seed)
        rows["probe"] = gloo_cuda_probe(torch)
    with open(os.path.join(outdir, f"{mode}_p{rank}.json"), "w") as f:
        json.dump(rows, f)
    dl.shutdown()
    return 0


def dist_launch(card, mode, world, outdir, seed, limit_s=DIST_CHILD_S,
                probe=False, child=DIST_CHILD) -> list:
    """``world`` ranks of dist_child(mode) (or the ``child`` code's) as
    children of this process, with the KUBEML_* environment of
    tools/launch_distributed.py; each must exit 0 within ``limit_s``
    (else all are killed and the phase fails; a ``probe`` records the
    silence as its answer). Returns each rank's rows."""
    return dist_collect(card, dist_spawn(mode, world, outdir, seed, limit_s,
                                         child), probe)


def store_port() -> int:
    """A free port for a launch's TCP store, below the kernel's ephemeral
    range where it has room, and never handed out twice by this process.
    A port the kernel picks for a bind to port 0 is an ephemeral one: by
    the time rank 0 listens on it, another launch's gloo connections may
    hold it (EADDRINUSE on the card)."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 0
    top = low if low > 20000 else 65536
    for _ in range(10000):
        port = random.randrange(10000, top)
        if port in store_port.given:
            continue
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        store_port.given.add(port)
        return port
    raise RuntimeError("no free port for a TCP store")


store_port.given = set()


def dist_spawn(mode, world, outdir, seed, limit_s=DIST_CHILD_S,
               child=DIST_CHILD) -> tuple:
    """Start dist_launch's ranks without waiting for them: (mode, world,
    outdir, limit_s, deadline, [(process, log file)])."""
    import os

    port = store_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(world):
        env = dict(os.environ, KUBEML_COORDINATOR_ADDRESS=f"localhost:{port}",
                   KUBEML_NUM_PROCESSES=str(world), KUBEML_PROCESS_ID=str(r))
        logf = open(os.path.join(outdir, f"{mode}_p{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", child, here, mode, outdir,
             str(seed)], env=env, stdout=logf, stderr=subprocess.STDOUT),
            logf))
    return mode, world, outdir, limit_s, time.monotonic() + limit_s, procs


def dist_collect(card, spawned, probe=False) -> list:
    """Wait for dist_spawn's ranks (see dist_launch) and read their
    rows."""
    import os

    mode, world, outdir, limit_s, deadline, procs = spawned
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, logf in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    codes = [proc.returncode for proc, _ in procs]
    if probe:
        rows = []
        for r in range(world):
            path = os.path.join(outdir, f"{mode}_p{r}.json")
            if codes[r] == 0 and os.path.exists(path):
                with open(path) as f:
                    rows.append(json.load(f))
            else:
                with open(os.path.join(outdir, f"{mode}_p{r}.log")) as f:
                    said = [ln.strip() for ln in f if ln.strip()
                            and "socket.cpp" not in ln]
                rows.append({"error": f"exit {codes[r]} (killed after "
                             f"{limit_s:g} s if -9): "
                             + " | ".join(said[-3:])[-600:]})
        return rows
    if any(codes):
        for r in range(world):
            with open(os.path.join(outdir, f"{mode}_p{r}.log")) as f:
                log(card, f"dist {mode} rank {r} exit {codes[r]}; log tail:"
                    f"\n{f.read()[-4000:]}")
        raise RuntimeError(f"{mode}: ranks exited {codes}")
    rows = []
    for r in range(world):
        with open(os.path.join(outdir, f"{mode}_p{r}.json")) as f:
            rows.append(json.load(f))
    return rows


def dist_equal(torch, a, b) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def phase_dist(torch, card, seed) -> dict:
    """Phase 23: data lanes as ranks (see the module docstring). The
    ranks are children of this process; this process joins no group and
    runs the one-process rounds and job they are held to. Returns the
    launches of (a)-(c) for the kernels line."""
    import os
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="kubeml_dist_") as tmp:
        ref = {name: dist_rounds(torch, seed, name, knobs)
               for name, knobs in DIST_STRATEGIES}
        layers = ref["bucketed"]["layers"]
        for name, r in ref.items():
            assert r["calls"] == dict.fromkeys(r["calls"], 0), r["calls"]
        # (a) one rank over NCCL, the 2 lanes on it
        (a,) = dist_launch(card, "nccl", 1, tmp, seed)
        assert (a["world"], a["backend"]) == (1, "nccl"), a
        # (b) + (c) two ranks on the one card over gloo, one lane each
        b = dist_launch(card, "gloo", 2, tmp, seed)
        assert all((x["world"], x["backend"]) == (2, "gloo") for x in b)
        for name, _ in DIST_STRATEGIES:
            want = ref[name]
            plan = merge_counts(want["buckets"], 1)
            one = torch.load(os.path.join(tmp, f"nccl_{name}_p0.pt"))
            assert dist_equal(torch, one["state"], want["state"]), name
            assert dist_equal(torch, one["resid"], want["resid"]), name
            assert a[name]["counts"] == {
                **{k: layers * want["steps"] for k in
                   ("forward", "dK/dV", "dQ")}, **plan}, a[name]["counts"]
            assert a[name]["calls"] == dist_plan_collectives(
                name, want["buckets"]), a[name]["calls"]
            assert a[name]["h2d_bytes"] == want["h2d_bytes"], name
            log(card, f"dist (a) gpt-mini {name}, 1 NCCL rank holding "
                f"{DIST_LANES} lanes: weights and EF residuals after "
                f"{DIST_ROUNDS} rounds equal the same rounds without a group "
                f"bit for bit ({len(want['state'])} tensors, "
                f"{len(want['resid'])} residuals); round {DIST_ROUNDS}: "
                f"launches {a[name]['counts']} (= {layers} layers x "
                f"{want['steps']} steps, {want['buckets']} buckets x 1 "
                f"merge), NCCL collectives {a[name]['calls']}; "
                f"{a[name]['ms']:.3f} ms a round against "
                f"{want['ms']:.3f} ms without a group")
            ranks = [torch.load(os.path.join(tmp, f"gloo_{name}_p{r}.pt"))
                     for r in range(2)]
            assert dist_equal(torch, ranks[0]["state"], ranks[1]["state"])
            assert dist_equal(torch, ranks[0]["state"], want["state"]), name
            for r, rk in enumerate(ranks):
                assert set(rk["resid"]) == set(want["resid"]), name
                for k, v in want["resid"].items():
                    assert torch.equal(rk["resid"][k],
                                       v.reshape(DIST_LANES, -1)[r]), (k, r)
            steps = [b[r][name]["steps"] for r in range(2)]
            assert sum(steps) == want["steps"], steps
            # a rank copies only its own lane's workers' batch rows
            assert [b[r][name]["h2d_bytes"] for r in range(2)] == [
                want["h2d_bytes"] // 2] * 2, (b[0][name], want["h2d_bytes"])
            for r in range(2):
                assert b[r][name]["counts"] == {
                    **{k: layers * steps[r] for k in
                       ("forward", "dK/dV", "dQ")}, **plan}, \
                    (r, b[r][name]["counts"])
                assert b[r][name]["calls"] == dist_plan_collectives(
                    name, want["buckets"]), b[r][name]["calls"]
                assert b[r][name]["loss"] == want["loss"], (r, name)
            log(card, f"dist (b) gpt-mini {name}, 2 gloo ranks on one card, "
                f"1 lane each: both ranks' weights equal each other and "
                f"the one-process {DIST_LANES}-lane rounds bit for bit, each "
                f"rank's EF residuals its lane's slice; round "
                f"{DIST_ROUNDS}: launches rank 0 {b[0][name]['counts']}, "
                f"rank 1 {b[1][name]['counts']} (#5 once a merge on each "
                f"rank), collectives {b[0][name]['calls']}; batch bytes "
                f"copied to the card a rank {b[0][name]['h2d_bytes']} "
                f"against {want['h2d_bytes']} in one process; ms a round "
                f"{b[0][name]['ms']:.3f} / {b[1][name]['ms']:.3f} (ranks 0 "
                f"/ 1) against {want['ms']:.3f} in one process")
            out[name] = {"nccl": a[name]["counts"],
                         "gloo": [b[r][name]["counts"] for r in range(2)],
                         "nccl_ms": a[name]["ms"],
                         "gloo_ms": [b[r][name]["ms"] for r in range(2)],
                         "one_process_ms": want["ms"]}
        # (c) the two-rank job against the one-process job
        single = dist_job(torch, seed, tmp, None)
        jobs = [b[r]["job"] for r in range(2)]
        assert jobs[0]["history"] == jobs[1]["history"], jobs
        assert jobs[0]["history"] == single["history"], (jobs, single)
        states = [torch.load(os.path.join(tmp, f"job_p{r}.pt"))
                  for r in range(2)]
        assert dist_equal(torch, states[0], states[1])
        assert dist_equal(torch, states[0], single["state"])
        steps, rounds, evals = _epoch_counts(
            2, 2, n_train=DIST_JOB_TRAIN, n_test=DIST_JOB_TEST, k=JOB_K,
            batch=JOB_B)
        plan = merge_counts(JOB_BUCKETS, rounds)
        # worker r (lane r) trains on rank r; every rank validates it all
        mine = dist_worker_steps(DIST_JOB_TRAIN, 2)
        assert sum(mine) == steps, (mine, steps)
        for r, job in enumerate(jobs):
            assert job["counts"] == {
                "forward": layers * (mine[r] + evals),
                "dK/dV": layers * mine[r], "dQ": layers * mine[r],
                **plan}, (r, job["counts"])
        assert single["counts"] == {
            "forward": layers * (steps + evals), "dK/dV": layers * steps,
            "dQ": layers * steps, **plan}, single["counts"]
        ms = [1e3 * j["seconds"] / steps for j in (*jobs, single)]
        log(card, f"dist (c) TrainJob gpt-mini ef_bf16 N=2, 1 epoch over "
            f"{DIST_JOB_TRAIN} + {DIST_JOB_TEST} windows, 2 gloo ranks of 1 "
            f"lane: both ranks' histories equal each other and the "
            f"one-process job's ({jobs[0]['history']['train_loss']}), "
            f"final weights bit for bit; launches rank 0 "
            f"{jobs[0]['counts']}, rank 1 {jobs[1]['counts']} (= {layers} "
            f"layers x ({mine} steps + {evals} eval slots), {JOB_BUCKETS} "
            f"buckets x {rounds} merges), one process {single['counts']}; "
            f"collectives a rank "
            f"{jobs[0]['calls']}; ms per local step {ms[0]:.3f} / "
            f"{ms[1]:.3f} (ranks 0 / 1, {steps} local steps between them) "
            f"against {ms[2]:.3f} in one process")
        out["job"] = {"gloo": [j["counts"] for j in jobs],
                      "one_process": single["counts"],
                      "ms_per_step": ms[:2], "one_process_ms": ms[2]}
        ring = [x["ring"] for x in b]
        assert all(x["equal"] and x["within"] for x in ring), ring
        assert ring[0]["exchanges"] == 2 * (2 - 1) * 2, ring
        log(card, f"dist ring_psum over the 2 gloo ranks, bf16 wire, "
            f"{ring[0]['n']} f32 elements: a CUDA leaf (each of its "
            f"{ring[0]['exchanges'] // 2} hops through the host) equals the "
            f"same values' ring on the CPU bit for bit on both ranks; "
            f"max|err| against the plain sum {ring[0]['max_abs_err']:.3g} "
            f"(within atol = rtol = {TOL['bf16']:g})")
        out["ring"] = ring[0]
        probe = b[0]["probe"]
        assert probe == b[1]["probe"], (probe, b[1]["probe"])
        p2p = dist_launch(card, "gloo-p2p", 2, tmp, seed,
                          limit_s=DIST_DUP_S, probe=True)
        probe["send/recv"] = [d["error"] or "accepted" for d in p2p]
        log(card, f"dist gloo with CUDA tensors (tried directly): {probe}")
        out["gloo_cuda"] = probe
        # NCCL and two ranks on one device: the error NCCL gives
        dup = dist_launch(card, "nccl-dup", 2, tmp, seed,
                          limit_s=2 * DIST_DUP_S, probe=True)
        log(card, f"dist NCCL with 2 ranks on one card: rank 0 "
            f"{dup[0]['error']!r}; rank 1 {dup[1]['error']!r}")
        out["nccl_two_ranks_one_card"] = [d["error"] for d in dup]
    log(card, f"dist phase 23: {time.perf_counter() - t0:.3f} s")
    return out


def dist_launches(dist, kernel) -> dict:
    """A kernel's phase-23 launches for the kernels line: (a) and (b) per
    strategy (round 2 of each run; (b) per rank), (c) per rank and in one
    process."""
    return {"rounds": {name: {"nccl_one_rank": dist[name]["nccl"][kernel],
                              "gloo_ranks": [c[kernel] for c in
                                             dist[name]["gloo"]]}
                       for name, _ in DIST_STRATEGIES},
            "job_ranks": [c[kernel] for c in dist["job"]["gloo"]],
            "job_one_process": dist["job"]["one_process"][kernel]}


SD_MODES = (("zero1", {}), ("replicated", dict(zero1=False)),
            ("fsdp", dict(fsdp=True)), ("bucketed", dict(strategy="bucketed")),
            ("ef_bf16", dict(strategy="ef_bf16")),
            ("ef_int8", dict(strategy="ef_int8")))
SD_IMPLICIT = ("zero1", "replicated", "fsdp")
# (b32), (g): the implicit paths and the fsdp job in f32 (gpt-mini's
# dropout 0.1, drawn alike by ranks and one process), where a rank's half
# batch and one process's whole batch differ only in f32 rounding: the
# weights' share within 1e-5, every step's loss (relative) and the first
# moments' relative L2 error are held to these limits. A rank that
# stepped on its own half-batch gradient misses all three by orders of
# magnitude (PERF.md §6: a mutant run on the card).
SD_F32_SHARE, SD_F32_LOSS, SD_F32_MU = 0.995, 1e-4, 1e-3
# (b) in bf16: the first moments' relative L2 error and every step's loss
# (relative), set at ten times what a right engine showed on the card and
# a twentieth of what that mutant showed (PERF.md §6)
SD_BF16_MU, SD_BF16_LOSS = 0.03, 1e-3
SD_DISPATCHES = 2         # dispatch 1 warms up; 2 is counted and timed
SD_JOBS = (("smoke-sd-ef", dict(engine="syncdp", merge_compress="bf16")),
           ("smoke-sd-fsdp", dict(engine="syncdp", fsdp=True, f32=True)))
SD_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "sys.exit(chip_smoke.sd_child(*sys.argv[2:]))")


def sd_held_bytes(engine, state) -> int:
    """The device bytes this process keeps for ``state`` between
    dispatches: the state's tensors, the optimizer's and the module's
    working parameters, each storage once."""
    seen, total = set(), 0
    for t in engine.held_tensors(state) + list(engine._params.values()):
        st = t.untyped_storage()
        if st.nbytes() and st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


def sd_plan_elements(seed, world, zero1) -> int:
    """The optimizer-state elements of one moment a rank holds under the
    ZeRO rule (dim 0 of the flax layout divisible by the 2 lanes: the
    leaf's 1/world), from gpt-mini's flax shapes."""
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    def leaves(node):
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in leaves(node[k])]
        return [node]

    return sum(a.size // world if zero1 and a.shape[0] % SYNC_LANES == 0
               else a.size
               for a in leaves(random_flax_params(**GPT_CONFIGS["gpt-mini"],
                                                  seed=seed)))


def sd_plan_collectives(name, steps, world) -> dict:
    """A dispatch's collectives over a group of ``world`` ranks: a step
    of the implicit path one reduce-scatter of the sharded gradients, one
    all-reduce (the replicated ones and the guard's scalars), one
    all-gather-into of the new shards (one all-reduce alone when nothing
    is sharded); of the explicit path one all-reduce of the lanes'
    scalars, one a bucket (two under ef_int8) and the all-gather-into.
    At world 1 the shards are the parameters: no all-gather-into."""
    sharded = steps if name != "replicated" else 0
    ag = sharded if world > 1 else 0
    if name in SD_IMPLICIT:
        rs, ar = sharded, steps
    else:
        rs = 0
        ar = steps * (1 + (2 if name == "ef_int8" else 1) * JOB_BUCKETS)
    return {"all_reduce": ar, "all_gather": 0, "barrier": 0, "exchange": 0,
            "reduce_scatter": rs, "all_gather_into": ag}


def sd_plan_launches(name, steps, layers, lanes) -> dict:
    """A rank's #2-#5 launches over ``steps`` real global steps: the flash
    kernels once a layer per backward pass (one a step on the implicit
    path, one a local lane on the explicit one), the fused merge once a
    step under the explicit merges."""
    explicit = name not in SD_IMPLICIT
    out = {k: layers * steps * (lanes if explicit else 1)
           for k in SYNC_FLASH}
    out.update(merge_counts(JOB_BUCKETS, steps) if explicit
               else {"fused_merge": 0, "merge segments": 0})
    return out


def sd_run(torch, seed, name, knobs, dtype=None) -> dict:
    """SD_DISPATCHES of phase 22's dispatches through a SyncDPEngine on
    path ``name`` (bf16 compute, or ``dtype``), in this process's group
    or without one. The counters are zeroed just before the last
    dispatch and read just after it."""
    knobs = dict(knobs)
    strategy = knobs.pop("strategy", None)
    module, engine, state = sync_setup(torch, "gpt-mini", seed,
                                       dtype or torch.bfloat16, "cuda",
                                       strategy, **knobs)
    to_device, copied = engine._to_device, []

    def counted(batch):
        # the batch bytes this rank's dispatch copies to its card
        copied.append(sum(np.asarray(v).nbytes for v in batch.values()))
        return to_device(batch)

    engine._to_device = counted
    rng = np.random.default_rng(seed + 24)
    losses = []
    for _ in range(SD_DISPATCHES):
        batch, mask, keys, steps = sync_dispatch(rng, SYNC_W, SYNC_K,
                                                 SYNC_B, SYNC_T)
        torch.cuda.synchronize()
        copied.clear()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dist_zero()                          # the main path's run starts
        t0 = time.perf_counter()
        state, loss = engine.train_steps(state, batch, mask, keys,
                                         SYNC_LR, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, calls = dist_counts()        # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        losses += loss.float().cpu().tolist()
    assert not engine.last_skipped_device.any(), name
    assert torch.isfinite(loss).all(), (name, loss)
    held = sd_held_bytes(engine, state)
    opt = state["opt_state"]
    tensors = [t for g in opt.param_groups for t in g["params"]]
    moments = {f"{k}/{n}": opt.state[t][k].reshape(-1).cpu()
               for n, t in zip(engine._params, tensors)
               for k in ("exp_avg", "exp_avg_sq")}
    step = {int(opt.state[t]["step"]) for t in tensors}
    return {"state": {k: v.detach().cpu()
                      for k, v in engine.variables(state).items()},
            "moments": moments,
            "resid": {k: v.cpu() for k, v in
                      (state.get("merge_resid") or {}).items()},
            "counts": counts, "calls": calls, "ms": 1e3 * wall / steps,
            "steps": steps, "opt_steps": sorted(step),
            "h2d_bytes": sum(copied), "losses": losses,
            "held_bytes": held, "peak_bytes": int(peak),
            "base_bytes": int(base),
            "moment_elems": sum(int(opt.state[t]["exp_avg"].numel())
                                for t in tensors),
            "param_elems": sum(int(t.numel())
                               for t in state["params"].values()),
            "shard_elems": sum(engine.shard_elements().values()),
            "readbacks": engine.readbacks, "layers": module.layers,
            "lanes": engine.layout.per_rank}


def sd_probe(torch, mode) -> dict:
    """(f): reduce_scatter_tensor ('sd-rs') or all_gather_into_tensor
    ('sd-ag') of CUDA tensors over the two gloo ranks, tried directly
    (not through the port's helpers), checked against its result."""
    import torch.distributed as dist

    r = dist.get_rank()
    try:
        if mode == "sd-rs":
            t = torch.arange(8.0, device="cuda") + r
            out = torch.empty(4, device="cuda")
            dist.reduce_scatter_tensor(out, t)
            want = (torch.arange(8.0) * 2 + 1)[4 * r:4 * r + 4]
        else:
            t = torch.full((4,), float(r + 1), device="cuda")
            out = torch.empty(8, device="cuda")
            dist.all_gather_into_tensor(out, t)
            want = torch.tensor([1.0] * 4 + [2.0] * 4)
        got = out.cpu()
        return {"error": None if torch.equal(got, want)
                else f"wrong: {got.tolist()}"}
    except Exception as e:  # noqa: BLE001 — the refusal is the answer
        return {"error": f"refused: {type(e).__name__}: "
                f"{(str(e).splitlines() or [''])[0][:240]}"}


def sd_child(mode, outdir, seed) -> int:
    """A rank of phase 24, started by dist_spawn with the KUBEML_*
    environment: 'sd-nccl' (a): every path over NCCL; 'sd-gloo' (b)-(e)
    and (g): every path and the two jobs over gloo; 'sd-rs' / 'sd-ag'
    (f): one collective of CUDA tensors over gloo. Writes its rows under
    ``outdir``."""
    import faulthandler
    import os

    import torch
    import torch.distributed as dist

    from kubeml_tpu_torch.parallel import distributed as dl

    faulthandler.dump_traceback_later(DIST_TIMEOUT, repeat=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(seed)
    dl.initialize(backend=None if mode == "sd-nccl" else "gloo",
                  timeout=DIST_TIMEOUT)
    rank = dl.rank()
    rows = {"world": dl.world_size(), "backend": dist.get_backend()}
    if mode in ("sd-rs", "sd-ag"):
        rows.update(sd_probe(torch, mode))
    else:
        for name, knobs in SD_MODES:
            out = sd_run(torch, seed, name, knobs)
            torch.save({k: out.pop(k) for k in ("state", "moments", "resid")},
                       os.path.join(outdir, f"{mode}_{name}_p{rank}.pt"))
            rows[name] = out
    if mode == "sd-gloo":
        for name in SD_IMPLICIT:
            out = sd_run(torch, seed, name, dict(SD_MODES)[name],
                         torch.float32)
            torch.save({k: out.pop(k) for k in ("state", "moments", "resid")},
                       os.path.join(outdir, f"{mode}_{name}-f32_p{rank}.pt"))
            rows[f"{name}-f32"] = out
        for job_id, opts in SD_JOBS:
            job = dist_job(torch, seed, os.path.join(outdir, job_id), rank,
                           job_id=job_id, **opts)
            torch.save(job.pop("state"),
                       os.path.join(outdir, f"{job_id}_p{rank}.pt"))
            rows[job_id] = job
    with open(os.path.join(outdir, f"{mode}_p{rank}.json"), "w") as f:
        json.dump(rows, f)
    dl.shutdown()
    return 0


def sd_gather(torch, ranks, whole) -> dict:
    """The ranks' moment shards as one process's flat moments: a leaf
    each rank holds part of, its parts in rank order; a whole one, rank
    0's."""
    out = {}
    for k, v in whole.items():
        parts = [rk["moments"][k] for rk in ranks]
        out[k] = parts[0] if parts[0].numel() == v.numel() \
            else torch.cat(parts)
    return out


def sd_within(torch, a, b) -> tuple:
    """(max |a - b|, the share of elements within 1e-5) over two weight
    dicts."""
    diffs = torch.cat([(a[k].float() - b[k].float()).abs().ravel()
                       for k in b])
    return float(diffs.max()), float((diffs <= 1e-5).float().mean())


def sd_rel_l2(torch, a, b, prefix="") -> float:
    """||a - b|| / ||b|| over the entries of two dicts whose keys start
    with ``prefix``."""
    keys = [k for k in b if k.startswith(prefix)]
    x = torch.cat([a[k].double().ravel() for k in keys])
    y = torch.cat([b[k].double().ravel() for k in keys])
    return float((x - y).norm() / y.norm())


def sd_loss_rel(got, want) -> float:
    """The largest relative difference of two lists of losses."""
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def phase_syncdp_dist(torch, card, seed, phase22=None) -> dict:
    """Phase 24: the SyncDP engine over ranks (see the module docstring).
    The ranks are children of this process; this process joins no group
    and runs the one-process dispatches and jobs they are held to.
    ``phase22`` holds phase 22's ms per global step by path when it ran.
    Returns the launches and numbers for the kernels line."""
    import os
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="kubeml_sd_") as tmp:
        # (a) and (f) start first; the one-process jobs run meanwhile
        nccl = dist_spawn("sd-nccl", 1, tmp, seed, child=SD_CHILD)
        probes = [dist_spawn(m, 2, tmp, seed, DIST_DUP_S, child=SD_CHILD)
                  for m in ("sd-rs", "sd-ag")]
        single_jobs = {job_id: dist_job(torch, seed,
                                        os.path.join(tmp, job_id), None,
                                        job_id=job_id, **opts)
                       for job_id, opts in SD_JOBS}
        (a,) = dist_collect(card, nccl)
        probe = {m: [d["error"] or "accepted"
                     for d in dist_collect(card, p, probe=True)]
                 for m, p in zip(("reduce_scatter_tensor",
                                  "all_gather_into_tensor"), probes)}
        log(card, f"syncdp-dist (f) gloo with CUDA tensors (tried directly, "
            f"each in 2 processes of its own), ranks 0 / 1: {probe}")
        assert all(v == ["accepted"] * 2 for v in probe.values()), probe
        out["gloo_cuda"] = probe
        # the one-process runs, alone on the card
        ref = {name: sd_run(torch, seed, name, knobs)
               for name, knobs in SD_MODES}
        ref32 = {name: sd_run(torch, seed, name, dict(SD_MODES)[name],
                              torch.float32) for name in SD_IMPLICIT}
        for name, r in ref.items():
            assert not any(r["calls"].values()), (name, r["calls"])
        # (b)-(e), (g): two gloo ranks on the one card, alone
        b = dist_launch(card, "sd-gloo", 2, tmp, seed, child=SD_CHILD)
        assert (a["world"], a["backend"]) == (1, "nccl"), a
        assert all((x["world"], x["backend"]) == (2, "gloo") for x in b)
        layers = ref["zero1"]["layers"]
        bound = 2 * SD_DISPATCHES * SYNC_K * SYNC_LR
        mem = {}
        # the tight checks' misses, raised together after (g)
        missed = []
        for name, _ in SD_MODES:
            want = ref[name]
            steps = want["steps"]
            one = torch.load(os.path.join(tmp, f"sd-nccl_{name}_p0.pt"))
            assert dist_equal(torch, one["state"], want["state"]), name
            assert dist_equal(torch, one["moments"], want["moments"]), name
            assert dist_equal(torch, one["resid"], want["resid"]), name
            assert a[name]["counts"] == sd_plan_launches(
                name, steps, layers, SYNC_LANES), (name, a[name]["counts"])
            assert a[name]["calls"] == sd_plan_collectives(name, steps, 1), \
                (name, a[name]["calls"])
            assert a[name]["h2d_bytes"] == want["h2d_bytes"], name
            log(card, f"syncdp-dist (a) gpt-mini {name}, 1 NCCL rank "
                f"holding {SYNC_LANES} lanes: weights, Adam's moments and "
                f"EF residuals after {SD_DISPATCHES} dispatches equal the "
                f"engine without a group bit for bit "
                f"({len(want['state'])} tensors, {len(want['resid'])} "
                f"residuals); dispatch {SD_DISPATCHES}: launches "
                f"{a[name]['counts']}, collectives {a[name]['calls']}; "
                f"{a[name]['ms']:.3f} ms a global step against "
                f"{want['ms']:.3f} without a group")
            ranks = [torch.load(os.path.join(tmp, f"sd-gloo_{name}_p{r}.pt"))
                     for r in range(2)]
            assert dist_equal(torch, ranks[0]["state"], ranks[1]["state"])
            gathered = sd_gather(torch, ranks, want["moments"])
            if name in SD_IMPLICIT:
                err, share = sd_within(torch, ranks[0]["state"],
                                       want["state"])
                assert err <= bound, (name, err, bound)
                mom, mshare = sd_within(torch, gathered, want["moments"])
                mu = sd_rel_l2(torch, gathered, want["moments"], "exp_avg/")
                lrel = sd_loss_rel(b[0][name]["losses"], want["losses"])
                for what, got, limit in (
                        ("first moments, relative L2", mu, SD_BF16_MU),
                        ("losses, relative", lrel, SD_BF16_LOSS)):
                    if got > limit:
                        missed.append((name, what, got, limit))
                held = (f"within AdamW's {bound:g} (max|diff| {err:.3g}, "
                        f"{100 * share:.3f} % within 1e-5; moments "
                        f"max|diff| {mom:.3g}, {100 * mshare:.3f} % within "
                        f"1e-5), the first moments within {mu:.3g} "
                        f"relative L2 (limit {SD_BF16_MU:g}), the "
                        f"{len(want['losses'])} steps' losses within "
                        f"{lrel:.3g} relative (limit {SD_BF16_LOSS:g})")
            else:
                assert dist_equal(torch, ranks[0]["state"], want["state"])
                assert dist_equal(torch, gathered, want["moments"]), name
                for r, rk in enumerate(ranks):
                    assert set(rk["resid"]) == set(want["resid"]), name
                    for k, v in want["resid"].items():
                        assert torch.equal(rk["resid"][k],
                                           v.reshape(SYNC_LANES, -1)[r]), \
                            (name, k, r)
                err, share = 0.0, 1.0
                held = ("bit for bit (weights, the gathered moments, each "
                        "rank's residuals its lane's slice)")
            plan = sd_plan_elements(seed, 2, name != "replicated")
            for r in range(2):
                got = b[r][name]
                assert got["steps"] == steps, (name, r, got["steps"])
                assert got["opt_steps"] == want["opt_steps"], (name, r)
                assert got["moment_elems"] == got["shard_elems"] == plan, \
                    (name, r, got["moment_elems"], plan)
                assert got["param_elems"] == (
                    plan if name == "fsdp" else want["param_elems"]), \
                    (name, r)
                assert got["counts"] == sd_plan_launches(
                    name, steps, layers, 1), (name, r, got["counts"])
                assert got["calls"] == sd_plan_collectives(name, steps, 2), \
                    (name, r, got["calls"])
                assert got["h2d_bytes"] * 2 == want["h2d_bytes"], (name, r)
            mem[name] = {
                "held": [b[r][name]["held_bytes"] for r in range(2)],
                "peak": [b[r][name]["peak_bytes"] for r in range(2)],
                "before": [b[r][name]["base_bytes"] for r in range(2)],
                "one_process_held": want["held_bytes"],
                "one_process_peak": want["peak_bytes"],
                "one_process_before": want["base_bytes"]}
            p22 = (phase22 or {}).get(
                "implicit" if name in SD_IMPLICIT else name)
            log(card, f"syncdp-dist (b) gpt-mini {name}, 2 gloo ranks on "
                f"one card, 1 lane each, against one process of "
                f"{SYNC_LANES} lanes after {SD_DISPATCHES} dispatches: "
                f"the ranks equal each other bit for bit, one process "
                f"{held}; (c) a rank's moment elements {plan} (= the plan; "
                f"one process {want['moment_elems']}), parameter elements "
                f"{b[0][name]['param_elems']}; bytes held between "
                f"dispatches {mem[name]['held']} (one process "
                f"{want['held_bytes']}), peak of a dispatch "
                f"{mem[name]['peak']} with {mem[name]['before']} allocated "
                f"before it (one process {want['peak_bytes']} with "
                f"{want['base_bytes']}); "
                f"(d) dispatch {SD_DISPATCHES}: launches rank 0 "
                f"{b[0][name]['counts']}, rank 1 {b[1][name]['counts']}, "
                f"collectives {b[0][name]['calls']} (= the plan), batch "
                f"bytes copied a rank {b[0][name]['h2d_bytes']} of "
                f"{want['h2d_bytes']}; (e) ms per global step, host clock, "
                f"ranks 0 / 1 {b[0][name]['ms']:.3f} / "
                f"{b[1][name]['ms']:.3f}, one process {want['ms']:.3f}"
                + (f", phase 22's {p22:.3f}" if p22 else ""))
            out[name] = {"nccl": a[name]["counts"],
                         "gloo": [b[r][name]["counts"] for r in range(2)],
                         "calls": b[0][name]["calls"],
                         "nccl_ms": a[name]["ms"],
                         "gloo_ms": [b[r][name]["ms"] for r in range(2)],
                         "one_process_ms": want["ms"],
                         "max_abs_err": err, "within_1e-5": share,
                         "memory": mem[name]}
        # (b32) the implicit paths in f32, held tightly
        for name in SD_IMPLICIT:
            want = ref32[name]
            key = f"{name}-f32"
            ranks = [torch.load(os.path.join(tmp, f"sd-gloo_{key}_p{r}.pt"))
                     for r in range(2)]
            assert dist_equal(torch, ranks[0]["state"], ranks[1]["state"])
            assert b[0][key]["losses"] == b[1][key]["losses"], key
            gathered = sd_gather(torch, ranks, want["moments"])
            err, share = sd_within(torch, ranks[0]["state"], want["state"])
            mu = sd_rel_l2(torch, gathered, want["moments"], "exp_avg/")
            lrel = sd_loss_rel(b[0][key]["losses"], want["losses"])
            for what, got, limit in (("weights within 1e-5", share,
                                      SD_F32_SHARE),
                                     ("losses, relative", lrel, SD_F32_LOSS),
                                     ("first moments, relative L2", mu,
                                      SD_F32_MU),
                                     ("weights max|diff|", err, bound)):
                if (got < limit if what == "weights within 1e-5"
                        else got > limit):
                    missed.append((key, what, got, limit))
            log(card, f"syncdp-dist (b32) gpt-mini {name} in f32, 2 gloo "
                f"ranks of 1 lane against one process of {SYNC_LANES} "
                f"lanes after {SD_DISPATCHES} dispatches: the ranks equal "
                f"each other bit for bit; one process: weights "
                f"{100 * share:.4f} % within 1e-5 (limit "
                f"{100 * SD_F32_SHARE:g} %), max|diff| {err:.3g} (limit "
                f"{bound:g}); the {len(want['losses'])} steps' losses "
                f"within {lrel:.3g} relative (limit {SD_F32_LOSS:g}); "
                f"first moments' relative L2 error {mu:.3g} (limit "
                f"{SD_F32_MU:g}); ms per global step, ranks 0 / 1 "
                f"{b[0][key]['ms']:.3f} / {b[1][key]['ms']:.3f}, one "
                f"process {want['ms']:.3f}")
            out[key] = {"max_abs_err": err, "within_1e-5": share,
                        "loss_rel": lrel, "mu_rel_l2": mu}
        # (g) the two-rank jobs against the one-process jobs
        for job_id, opts in SD_JOBS:
            single = single_jobs[job_id]
            jobs = [b[r][job_id] for r in range(2)]
            states = [torch.load(os.path.join(tmp, f"{job_id}_p{r}.pt"))
                      for r in range(2)]
            assert jobs[0]["history"] == jobs[1]["history"], jobs
            assert dist_equal(torch, states[0], states[1])
            if opts.get("fsdp"):
                # in f32: the ranks' half batches and one process's whole
                # batch differ by f32 rounding, held as (b32) is
                err, share = sd_within(torch, states[0], single["state"])
                hist = jobs[0]["history"]
                assert hist["parallelism"] == \
                    single["history"]["parallelism"]
                lrel = max(sd_loss_rel(hist[k], single["history"][k])
                           for k in ("train_loss", "validation_loss"))
                steps = DIST_JOB_TRAIN // (2 * JOB_B)   # global steps
                for what, got, limit in (
                        ("weights within 1e-5", share, SD_F32_SHARE),
                        ("losses, relative", lrel, SD_F32_LOSS),
                        ("weights max|diff|", err, 2 * steps * JOB_LR)):
                    if (got < limit if what == "weights within 1e-5"
                            else got > limit):
                        missed.append((job_id, what, got, limit))
                held = (f"histories within {lrel:.3g} relative (limit "
                        f"{SD_F32_LOSS:g}; train {hist['train_loss']} / "
                        f"{single['history']['train_loss']}, validation "
                        f"{hist['validation_loss']} / "
                        f"{single['history']['validation_loss']}), weights "
                        f"max|diff| {err:.3g} (AdamW's bound "
                        f"{2 * steps * JOB_LR:g}), {100 * share:.4f} % "
                        f"within 1e-5 (limit {100 * SD_F32_SHARE:g} %)")
            else:
                assert jobs[0]["history"] == single["history"], \
                    (jobs, single)
                assert dist_equal(torch, states[0], single["state"])
                held = (f"history ({jobs[0]['history']['train_loss']}) and "
                        f"weights bit for bit")
            ms = [1e3 * j["seconds"] for j in (*jobs, single)]
            log(card, f"syncdp-dist (g) TrainJob gpt-mini {opts}, N=2, 1 "
                f"epoch over {DIST_JOB_TRAIN} + {DIST_JOB_TEST} windows, 2 "
                f"gloo ranks of 1 lane against one process: both ranks "
                f"equal each other, one process {held}; launches rank 0 "
                f"{jobs[0]['counts']}, rank 1 {jobs[1]['counts']}, one "
                f"process {single['counts']}; collectives a rank "
                f"{jobs[0]['calls']}; epoch ms ranks 0 / 1 {ms[0]:.1f} / "
                f"{ms[1]:.1f}, one process {ms[2]:.1f}")
            out[job_id] = {"gloo": [j["counts"] for j in jobs],
                           "one_process": single["counts"],
                           "epoch_ms": ms[:2], "one_process_epoch_ms": ms[2]}
        assert not missed, f"phase 24's tight checks missed: {missed}"
    log(card, f"syncdp-dist phase 24: {time.perf_counter() - t0:.3f} s")
    return out


def sd_launches(sd, kernel) -> dict:
    """A kernel's phase-24 launches for the kernels line: the counted
    dispatch per path on the NCCL rank and per gloo rank, and the two-rank
    jobs per rank."""
    return {"dispatch": {name: {"nccl_one_rank": sd[name]["nccl"][kernel],
                                "gloo_ranks": [c[kernel] for c in
                                               sd[name]["gloo"]]}
                         for name, _ in SD_MODES},
            "jobs": {job_id: [c[kernel] for c in sd[job_id]["gloo"]]
                     for job_id, _ in SD_JOBS}}


# ------------------------------------------------------------------ phase 25
SEQ_N = 2                 # seq ranks: two gloo ranks on the one card
SEQ_W, SEQ_K, SEQ_B, SEQ_T = 1, 2, 8, 512   # one lane; the ring's block
                                            # is [8, 256]
SEQ_LR = 1e-2             # SGD, as the reference's SP-vs-dense round
SEQ_ROUNDS = 2            # round 1 warms up; round 2 is counted and timed
SEQ_IMPLS = ("ring", "ulysses")
SEQ_DTYPES = ("bf16", "f32")
# (rtol, atol) of the merged weights against the dense round: the
# reference's own SP-vs-dense bounds in bf16 (tests/test_parallel_tp_sp.py),
# and tighter in f32; the round's loss sum within (relative) ...
SEQ_W_TOL = {"bf16": (2e-2, 2e-3), "f32": (1e-4, 1e-5)}
SEQ_LOSS_TOL = {"bf16": 5e-3, "f32": 1e-5}
# ... and forward_seq_parallel's logits within this share of the dense
# logits' largest magnitude
SEQ_LOGIT_TOL = {"bf16": 2e-2, "f32": 1e-4}
SEQ_JOB_TRAIN, SEQ_JOB_TEST = 128, 32      # (d): 2 workers x 8 steps
SEQ_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "import chip_smoke; "
             "sys.exit(chip_smoke.seq_child(*sys.argv[2:]))")


def seq_collectives() -> dict:
    """Phase 23's collective counters and the all-to-all's."""
    from kubeml_tpu_torch.parallel import distributed as dl

    return {**dist_collectives(), "all_to_all": dl.all_to_all}


def seq_zero() -> None:
    dist_zero()
    from kubeml_tpu_torch.parallel import distributed as dl

    dl.all_to_all.calls = 0


def seq_counts() -> tuple:
    return ({k: fn.launches for k, fn in dist_kernels().items()},
            {k: fn.calls for k, fn in seq_collectives().items()})


def seq_plan(impl, layers, steps, n, buckets) -> dict:
    """A rank's launches over one round: the ring runs #2, #3 and #4 n
    times a layer a step (every visiting block, dropped ones included),
    Ulysses and the dense round once (impl None); #5 once a merge."""
    per = n if impl == "ring" else 1
    return {**{k: layers * steps * per for k in ("forward", "dK/dV", "dQ")},
            **merge_counts(buckets, 1)}


def seq_model(torch, seed, dtype, impl, device="cuda"):
    """gpt-mini at its widths (dropout 0.1) with weights from the seed,
    built sequence-parallel under ``impl`` (None: dense)."""
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    model = get_model("gpt-mini")(
        dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    if impl is not None:
        model.enable_seq_parallel(impl)
    module = model.build(device=device)
    module.load_state_dict(params_from_flax(
        random_flax_params(**GPT_CONFIGS["gpt-mini"], seed=seed)))
    return model, module


def seq_round(torch, seed, dtype, impl) -> dict:
    """SEQ_ROUNDS K-avg rounds of gpt-mini (W=1 lane, K=2, B=8, T=512,
    half the sequences ending in padding, SGD, dropout 0.1, the 4 MB
    bucketed merge), sequence-parallel over this process's two ranks
    under ``impl``, or dense without a group (None). The counters are
    zeroed just before the last round and read just after it."""
    import functools

    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    model, module = seq_model(torch, seed, dtype, impl)
    engine = KAvgEngine(
        module, model.loss, model.metrics,
        lambda lr, e: functools.partial(torch.optim.SGD, lr=lr),
        n_lanes=SEQ_W, merge_bucket_mb=MERGE_CAP_MB,
        n_seq=1 if impl is None else SEQ_N,
        batch_seq_dims=None if impl is None else model.seq_batch_dims)
    state = {n: p.detach().clone() for n, p in module.named_parameters()}
    rng = np.random.default_rng(seed + 30)
    for _ in range(SEQ_ROUNDS):
        args = lm_round(rng, SEQ_W, SEQ_K, SEQ_B, SEQ_T)
        torch.cuda.synchronize()
        seq_zero()                            # the main path's run starts
        t0 = time.perf_counter()
        state, st = engine.train_round(state, *args, SEQ_LR, 0)
        loss = st.loss_sum
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, calls = seq_counts()          # ... and ends here
    return {"state": {k: v.detach().cpu() for k, v in state.items()},
            "counts": counts, "calls": calls, "ms": 1e3 * wall,
            "loss": [float(v) for v in loss], "layers": module.layers,
            "steps": int(args[2].sum()),
            "buckets": engine.merge_comm_proxy(state)["buckets_per_round"]}


def seq_forward(torch, seed) -> dict:
    """(c): forward_seq_parallel's [B, T, vocab] logits against the dense
    forward's on the card, per dtype and impl: the largest difference
    over the dense logits' largest magnitude."""
    x = lm_round(np.random.default_rng(seed + 31), 1, 1, SEQ_B,
                 SEQ_T)[0]["x"][0, 0]
    out = {}
    for dtype in SEQ_DTYPES:
        model, module = seq_model(torch, seed, dtype, None)
        with torch.no_grad():
            dense = module.logits(torch.from_numpy(x).cuda())
        for impl in SEQ_IMPLS:
            got = model.forward_seq_parallel(module, x, impl=impl)
            assert got.shape == dense.shape, got.shape
            assert bool(torch.isfinite(got).all()), (dtype, impl)
            out[f"{dtype} {impl}"] = float(
                (got - dense).abs().max() / dense.abs().max().clamp_min(1.0))
    return out


def seq_job(torch, seed, outdir, rank) -> dict:
    """(d): TrainJob(gpt-mini bf16, n_seq=2 ring, one lane, N=2, K=4, B=8)
    for one epoch over SEQ_JOB_TRAIN + SEQ_JOB_TEST windows, from a home
    of this rank's own. Its history and its launches over the epoch."""
    import os

    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    os.environ["KUBEML_TPU_HOME"] = os.path.join(outdir, f"seq_p{rank}")
    rng = np.random.default_rng(seed + 32)
    DatasetRegistry().create(
        "tokens", token_windows(rng, SEQ_JOB_TRAIN, SEQ_T),
        np.zeros(SEQ_JOB_TRAIN, np.int32),
        token_windows(rng, SEQ_JOB_TEST, SEQ_T),
        np.zeros(SEQ_JOB_TEST, np.int32))
    published = []
    task = job_task("smoke-seq-job", 1, default_parallelism=2,
                    static_parallelism=True, k=JOB_K, validate_every=1,
                    train_stats=False, n_seq=SEQ_N, seq_impl="ring")
    job = TrainJob(task, get_model("gpt-mini")(), token_dataset(),
                   device="cuda", n_lanes=1, callbacks=JobCallbacks(
                       publish_metrics=lambda m: published.append(
                           seq_counts())))
    torch.cuda.synchronize()
    seq_zero()                                # the main path's run starts
    hist = job.train().data
    counts, calls = published[0]              # ... and ends at the publish
    return {"history": {"train_loss": list(hist.train_loss),
                        "validation_loss": list(hist.validation_loss),
                        "accuracy": list(hist.accuracy),
                        "parallelism": list(hist.parallelism)},
            "counts": counts, "calls": calls,
            "seconds": float(hist.epoch_duration[0]),
            "layers": job._engine.module.layers}


def seq_a2a_probe(torch) -> str:
    """(e): gloo's all_to_all_single of CUDA tensors, tried directly:
    'accepted' when every rank receives its chunks, else the error."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    t = torch.arange(world * 2, dtype=torch.float32, device="cuda") \
        + 100 * rank
    got = torch.empty_like(t)
    try:
        dist.all_to_all_single(got, t)
    except Exception as e:  # noqa: BLE001 — the refusal is the answer
        return f"refused: {type(e).__name__}: {str(e)[:240]}"
    want = [100.0 * s + 2 * rank + i for s in range(world) for i in range(2)]
    return "accepted" if got.cpu().tolist() == want \
        else f"wrong: {got.cpu().tolist()}"


def seq_child(mode, outdir, seed) -> int:
    """A seq rank of phase 25 (two gloo ranks on the one card, one lane
    group), started by dist_spawn with the KUBEML_* environment: (e) the
    all-to-all probe, (b) the rounds under each dtype and impl, (c) the
    forward, (d) the job. Writes its rows under ``outdir``."""
    import faulthandler
    import os

    import torch
    import torch.distributed as dist

    from kubeml_tpu_torch.parallel import distributed as dl

    faulthandler.dump_traceback_later(DIST_TIMEOUT, repeat=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(seed)
    dl.initialize(backend="gloo", timeout=DIST_TIMEOUT)
    rank = dl.rank()
    rows = {"world": dl.world_size(), "backend": dist.get_backend(),
            "a2a_cuda": seq_a2a_probe(torch)}
    for dtype in SEQ_DTYPES:
        for impl in SEQ_IMPLS:
            out = seq_round(torch, seed, dtype, impl)
            torch.save(out.pop("state"), os.path.join(
                outdir, f"{mode}_{dtype}_{impl}_p{rank}.pt"))
            rows[f"{dtype} {impl}"] = out
    rows["forward"] = seq_forward(torch, seed)
    rows["job"] = seq_job(torch, seed, outdir, rank)
    with open(os.path.join(outdir, f"{mode}_p{rank}.json"), "w") as f:
        json.dump(rows, f)
    dl.shutdown()
    return 0


def seq_block_operands(torch, seed):
    """(a)'s operands at the ring's block shapes (gpt-mini, B=8, T=512
    over two ranks: blocks of 256, H=4, D=64, bf16), as rank 1 of two
    meets them: its queries, its own K/V block and rank 0's, N(0, 1),
    dO, and phase 7's keep-mask (half the sequences ending in padding)
    cut into the two blocks."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 29)
    x = lm_round(rng, 1, 1, SEQ_B, SEQ_T)[0]["x"][0, 0]
    pad = torch.from_numpy((x != 0).astype(np.float32)).to(dev)
    Tl = SEQ_T // SEQ_N
    q, k0, v0, k1, v1, g = (torch.from_numpy(rng.standard_normal(
        (SEQ_B, Tl, FA_H, FA_D)).astype(np.float32)).to(dev, torch.bfloat16)
        for _ in range(6))
    return q, (k0, v0, pad[:, :Tl].contiguous()), \
        (k1, v1, pad[:, Tl:].contiguous()), g


def seq_kernels(torch, card, seed) -> dict:
    """(a): #2-#4 at the ring's block shapes, each against its plain
    version within the flash tolerance, with warm times beside the plain
    version's, SDPA's and the bound. The forward: the causal diagonal
    block, a visiting block, and an all-zero keep-mask (a dropped block:
    m = NEG_INF, l = T_k, finite out). The backward of each, fed the
    GLOBAL m and l merged from rank 1's two blocks and delta from the
    globally normalised out; the dropped block's gradients are zero.
    Rows by (case, kernel)."""
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.parallel.ring_attention import (_block_attn_flash,
                                                          _merge_partials)

    q, (k0, v0, m0), (k1, v1, m1), g = seq_block_operands(torch, seed)
    B, Tl = q.shape[:2]
    dropped = torch.zeros_like(m1)
    cases = (("diagonal", k1, v1, m1, True), ("visiting", k0, v0, m0, False),
             ("all-masked", k1, v1, dropped, False))
    # rank 1's merged global statistics and out (its diagonal, then
    # rank 0's visiting block), as the forward ring makes them
    acc, m, l = _block_attn_flash(q, k1, v1, m1, True)
    acc, m, l = _merge_partials(acc, m, l,
                                *_block_attn_flash(q, k0, v0, m0, False))
    out = (acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype)
    m_rows = m.reshape(B * FA_H, 1, Tl).contiguous()
    l_rows = l.reshape(B * FA_H, 1, Tl).contiguous()
    delta = fa._delta(g, out)
    tol = FLASH_TOL["bf16"]
    rows = {}
    for case, k, v, mask, causal in cases:
        fwd = (q, k, v, mask, causal)
        bwd = (q, k, v, mask, g, m_rows, l_rows, delta, causal)
        got_f = fa.fa_fwd_kernel(*fwd)
        got_kv = fa.fa_bwd_dkv_kernel(*bwd)
        got_q = (fa.fa_bwd_dq_kernel(*bwd),)
        torch.cuda.synchronize()
        errs = {}
        for kernel, got, ref in (
                ("forward", got_f, fa._fa_forward_plain(*fwd)),
                ("dK/dV", got_kv, fa._fa_bwd_dkv_plain(*bwd)),
                ("dQ", got_q, (fa._fa_bwd_dq_plain(*bwd),))):
            for a, b in zip(got, ref):
                torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                           atol=tol)
            errs[kernel] = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got[:2 if kernel == "dK/dV"
                                                   else 1], ref))
        if case == "all-masked":
            o, bm, bl = got_f
            assert bool(torch.isfinite(o).all())
            torch.testing.assert_close(bm, torch.full_like(bm, -1e9),
                                       rtol=1e-6, atol=0)
            assert bool((bl == Tl).all()), bl.unique()
            assert all(int(torch.count_nonzero(t)) == 0
                       for t in (*got_kv, *got_q)), "dropped block's grads"
        lib_f, lib_b = library_flash_ms(torch, q, k, v, g, mask, causal)
        for kernel, fn, plain in (
                ("forward", lambda: fa.fa_fwd_kernel(*fwd),
                 lambda: fa._fa_forward_plain(*fwd)),
                ("dK/dV", lambda: fa.fa_bwd_dkv_kernel(*bwd),
                 lambda: fa._fa_bwd_dkv_plain(*bwd)),
                ("dQ", lambda: fa.fa_bwd_dq_kernel(*bwd),
                 lambda: fa._fa_bwd_dq_plain(*bwd))):
            b_ms, b_by = flash_bound(q, causal, kernel)
            row = dict(shape=f"ring block, {case}{' (causal)' if causal else ''}"
                       f"{'' if kernel == 'forward' else ', global m/l'}: "
                       f"B={B} T={Tl} H={FA_H} D={FA_D} bf16",
                       max_abs_err=errs[kernel], ms=time_ms(torch, fn),
                       plain_ms=time_ms(torch, plain), bound_ms=b_ms,
                       bound_by=b_by,
                       library_ms=lib_f if kernel == "forward" else lib_b)
            rows[(case, kernel)] = row
            log(card, f"seq (a) flash {kernel}, {row['shape']}: kernel "
                f"{row['ms']:.4f} ms (L2 warm), plain {row['plain_ms']:.4f} "
                f"ms, library {row['library_ms']:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}), {row['ms'] / b_ms:.1f}x bound, "
                f"max|err| {errs[kernel]:.3g} (tol {tol})")
    return rows


def seq_within(torch, got, want, dtype) -> tuple:
    """(ok, max |diff|) of two state dicts at SEQ_W_TOL[dtype]."""
    rtol, atol = SEQ_W_TOL[dtype]
    ok = set(got) == set(want) and all(
        torch.allclose(got[k].float(), want[k].float(), rtol=rtol, atol=atol)
        for k in want)
    return ok, max(float((got[k].float() - want[k].float()).abs().max())
                   for k in want)


def phase_seq(torch, card, seed) -> dict:
    """Phase 25: sequence parallelism over ranks (see the module
    docstring). (a), then the dense rounds the seq ranks are held to,
    run alone on the card; then the two gloo seq ranks. Returns the rows
    and launches for the kernels line."""
    import os
    import tempfile

    t0 = time.perf_counter()
    shapes = seq_kernels(torch, card, seed)
    dense = {dtype: seq_round(torch, seed, dtype, None)
             for dtype in SEQ_DTYPES}
    with tempfile.TemporaryDirectory(prefix="kubeml_seq_") as tmp:
        ranks = dist_collect(card, dist_spawn("seq", SEQ_N, tmp, seed,
                                              child=SEQ_CHILD))
        assert all((r["world"], r["backend"]) == (SEQ_N, "gloo")
                   for r in ranks), ranks
        log(card, f"seq (e) gloo all_to_all_single of CUDA tensors: "
            f"{[r['a2a_cuda'] for r in ranks]}")
        assert all(r["a2a_cuda"] == "accepted" for r in ranks), ranks
        out = {"shapes": shapes, "dense": {}, "rounds": {}}
        misses = []
        for dtype in SEQ_DTYPES:
            want = dense[dtype]
            layers, steps = want["layers"], want["steps"]
            plan = seq_plan(None, layers, steps, 1, want["buckets"])
            assert want["counts"] == plan, (dtype, want["counts"])
            out["dense"][dtype] = want["counts"]
            for impl in SEQ_IMPLS:
                key = f"{dtype} {impl}"
                got = [torch.load(os.path.join(tmp, f"seq_{dtype}_{impl}_p{r}"
                                               ".pt")) for r in range(SEQ_N)]
                assert dist_equal(torch, got[0], got[1]), key
                ok, diff = seq_within(torch, got[0], want["state"], dtype)
                loss = ranks[0][key]["loss"]
                rel = abs(loss[0] - want["loss"][0]) / max(
                    1.0, abs(want["loss"][0]))
                plan = seq_plan(impl, layers, steps, SEQ_N, want["buckets"])
                counts = [r[key]["counts"] for r in ranks]
                log(card, f"seq (b) gpt-mini {key}, {SEQ_N} gloo seq ranks, "
                    f"1 lane (W={SEQ_W} K={SEQ_K} B={SEQ_B} T={SEQ_T}, SGD, "
                    f"{SEQ_ROUNDS} rounds): ranks equal bit for bit; "
                    f"against the dense rounds "
                    f"max|dw| {diff:.3g} (rtol, atol {SEQ_W_TOL[dtype]}), "
                    f"loss {loss[0]:.6f} vs {want['loss'][0]:.6f} (rel "
                    f"{rel:.3g}, tol {SEQ_LOSS_TOL[dtype]}); launches a rank "
                    f"{counts[0]} (plan {plan}); collectives a rank "
                    f"{ranks[0][key]['calls']}; round {SEQ_ROUNDS} "
                    f"{ranks[0][key]['ms']:.1f} / {ranks[1][key]['ms']:.1f} "
                    f"ms on ranks 0 / 1 against {want['ms']:.1f} ms dense")
                if not ok or rel > SEQ_LOSS_TOL[dtype]:
                    misses.append((key, diff, rel))
                if any(c != plan for c in counts):
                    misses.append((key, "launches", counts, plan))
                out["rounds"][key] = counts
        for key, rel in ranks[0]["forward"].items():
            log(card, f"seq (c) forward_seq_parallel {key}: max|logits - "
                f"dense| / max|dense| {rel:.3g} (tol "
                f"{SEQ_LOGIT_TOL[key.split()[0]]})")
            if not rel <= SEQ_LOGIT_TOL[key.split()[0]]:
                misses.append(("forward", key, rel))
        jobs = [r["job"] for r in ranks]
        h = jobs[0]["history"]
        steps = sum(dist_worker_steps(SEQ_JOB_TRAIN, 2))
        for r, j in enumerate(jobs):
            for k in ("dK/dV", "dQ"):
                if j["counts"][k] != j["layers"] * steps * SEQ_N:
                    misses.append(("job", r, k, j["counts"][k]))
        log(card, f"seq (d) gpt-mini job, n_seq={SEQ_N} ring, 1 lane, N=2: "
            f"histories equal {jobs[0]['history'] == jobs[1]['history']}, "
            f"train loss {h['train_loss']}, validation {h['validation_loss']}"
            f"; launches over the epoch a rank {[j['counts'] for j in jobs]} "
            f"(#3/#4 plan {jobs[0]['layers'] * steps * SEQ_N}); "
            f"{jobs[0]['seconds']:.2f} s")
        if jobs[0]["history"] != jobs[1]["history"] or not all(
                np.isfinite(h["train_loss"] + h["validation_loss"])):
            misses.append(("job history", jobs[0]["history"],
                           jobs[1]["history"]))
        out["job"] = [j["counts"] for j in jobs]
    log(card, f"seq phase 25: {time.perf_counter() - t0:.1f} s")
    if misses:
        raise AssertionError(f"phase 25 misses: {misses}")
    return out


def seq_launches(seq, kernel) -> dict:
    """A kernel's phase-25 launches for the kernels line: each round per
    rank (and the dense round in one process), the job per rank."""
    return {"rounds": {k: [c[kernel] for c in v]
                       for k, v in seq["rounds"].items()},
            "dense_one_process": {k: v[kernel]
                                  for k, v in seq["dense"].items()},
            "job": [c[kernel] for c in seq["job"]]}


# ----------------------------------------------------------------- phase 26
EP_N = 2                  # expert ranks: two gloo ranks on the one card
EP_W, EP_K, EP_B, EP_T = 1, 2, 8, 512   # (b): one lane; every MoE block
                                        # routes phase 21's [4096, 8, 640]
EP_SP_LANES = 2           # (c): two lanes (one a data rank of the seq round)
EP_LR = 1e-2              # SGD, as the reference's EP-vs-SP round
EP_ROUNDS = 2             # round 1 warms up; round 2 is counted and timed
EP_DTYPES = ("bf16", "f32")
EP_FFN_TOL = 1e-4         # (a): f32, rtol and atol
# (d) of phases 26 and 27: one epoch of 2 workers x 8 steps
RANK_JOB_TRAIN, RANK_JOB_TEST = 128, 32
EP_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "sys.exit(chip_smoke.ep_child(*sys.argv[2:]))")
# (d)'s job: what `kubeml train` submits for these flags, on each rank
EP_JOB_ARGV = ("train", "-f", "gpt-moe-mini", "-d", "tokens", "-e", "1",
               "-b", str(JOB_B), "-K", str(JOB_K), "-p", "2", "--static",
               "--lr", str(JOB_LR), "--merge-bucket-mb", str(MERGE_CAP_MB),
               "--expert-parallel", str(EP_N))


def ep_operands(torch, seed):
    """(a)'s operands at gpt-moe-mini's widths, f32 on the card: one MoE
    block's weights (flax layouts, from the seed through convert.py), its
    [B x T, 256] LayerNorm-scale input and the pad mask of phase 7's
    windows (B=8, T=512: a [4096, 8, 640] dispatch)."""
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPT_MOE_CONFIG

    state = params_from_flax(random_flax_params(**GPT_MOE_CONFIG,
                                                seed=seed))
    moe = {n: state[f"blocks.0.moe.{n}"].cuda()
           for n in ("router", "wi", "bi", "wo", "bo")}
    rng = np.random.default_rng(seed + 34)
    x = lm_round(rng, 1, 1, EP_B, EP_T)[0]["x"][0, 0]
    h = torch.from_numpy(rng.standard_normal(
        (EP_B * EP_T, GPT_MOE_CONFIG["hidden"])).astype(np.float32)).cuda()
    mask = torch.from_numpy((x != 0).astype(np.float32).ravel()).cuda()
    return moe, h, mask


def ep_ffn(torch, seed, ranks: bool) -> dict:
    """(a): the expert layer over ep_operands, split over this process's
    expert ranks (``ep_partial_ffn`` after ``route_tokens``) or whole in
    one process (``moe_apply``); its output and warm ms a call."""
    from kubeml_tpu_torch.models.gpt import CAPACITY_FACTOR, MOE_K
    from kubeml_tpu_torch.parallel.ep import moe_apply, route_tokens
    from kubeml_tpu_torch.parallel.manual import ep_partial_ffn

    moe, h, mask = ep_operands(torch, seed)

    def call():
        if not ranks:
            return moe_apply(moe, h, k=MOE_K, capacity_factor=CAPACITY_FACTOR,
                             token_mask=mask)[0]
        dispatch, combine, _ = route_tokens(
            moe["router"], h, k=MOE_K, capacity_factor=CAPACITY_FACTOR,
            token_mask=mask)
        assert tuple(dispatch.shape) == (EP_B * EP_T, 8, 640), dispatch.shape
        return ep_partial_ffn(moe["wi"], moe["bi"], moe["wo"], moe["bo"],
                              dispatch, combine, h, "expert",
                              dtype=torch.float32)

    with torch.no_grad():
        y = call()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    return {"y": y.cpu(), "ms": statistics.median(times)}


def ep_round(torch, seed, dtype, n_seq, n_expert, lanes) -> dict:
    """EP_ROUNDS K-avg rounds of gpt-moe-mini at its published widths
    (``lanes`` lanes, K=2, B=8, T=512, half the sequences ending in
    padding, SGD, dropout 0.1, the 4 MB bucketed merge), over this
    process's (n_seq x n_expert) rank grid, or in one process without a
    group (1 x 1). The counters are zeroed just before the last round and
    read just after it; every merge's grouped #5 output is held against
    its plain version bit for bit (``merge_plain``)."""
    import functools

    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.gpt import GPT_MOE_CONFIG
    from kubeml_tpu_torch.ops import fused_merge as fm
    from kubeml_tpu_torch.parallel import merge as merge_lib
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    model = get_model("gpt-moe-mini")(
        dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    if n_seq > 1:
        model.enable_seq_parallel("ring")
    if n_expert > 1:
        model.enable_expert_parallel()
    module = model.build(device="cuda")
    module.load_state_dict(params_from_flax(
        random_flax_params(**GPT_MOE_CONFIG, seed=seed)))
    engine = KAvgEngine(
        module, model.loss, model.metrics,
        lambda lr, e: functools.partial(torch.optim.SGD, lr=lr),
        n_lanes=lanes, merge_bucket_mb=MERGE_CAP_MB, n_seq=n_seq,
        batch_seq_dims=model.seq_batch_dims if n_seq > 1 else None,
        n_expert=n_expert)
    state = {n: p.detach().clone() for n, p in module.named_parameters()}
    rng = np.random.default_rng(seed + 35)
    apply, plain = merge_lib.fused_merge_apply, []

    def held(mode, pairs, count, raw_count, lr=0.0):
        pairs = list(pairs)
        outs = apply(mode, pairs, count, raw_count, lr)
        plain.append(all(torch.equal(o, fm._apply_plain(
            mode, s, r, count, raw_count, lr)) for o, (s, r) in
            zip(outs, pairs)))
        return outs

    merge_lib.fused_merge_apply = held
    try:
        for _ in range(EP_ROUNDS):
            args = lm_round(rng, lanes, EP_K, EP_B, EP_T)
            torch.cuda.synchronize()
            seq_zero()                        # the main path's run starts
            t0 = time.perf_counter()
            state, st = engine.train_round(state, *args, EP_LR, 0)
            loss = st.loss_sum
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, calls = seq_counts()      # ... and ends here
    finally:
        merge_lib.fused_merge_apply = apply
    grid = engine.grid
    mine = range(engine.layout.first_lane,
                 engine.layout.first_lane + engine.layout.per_rank)
    return {"state": {k: v.detach().cpu() for k, v in state.items()},
            "counts": counts, "calls": calls, "ms": 1e3 * wall,
            "loss": [float(v) for v in loss], "layers": module.layers,
            "steps": int(args[2][list(mine)].sum()),
            "merge_plain": plain, "seq": grid.n_seq,
            "buckets": engine.merge_comm_proxy(state)["buckets_per_round"]}


def rank_job_child(outdir, seed, argv, job_id, seed_offset) -> int:
    """(d) of phases 26 and 27: a rank of the ``kubeml train`` command
    ``argv`` started by tools.launch_distributed: the TrainRequest the CLI
    builds from it (``cli.main.train_request``) run as this rank's
    TrainJob of the named model (one lane over the ranks, one epoch over
    RANK_JOB_TRAIN + RANK_JOB_TEST windows drawn from seed +
    ``seed_offset``, a home of its own). Writes its history and its
    launches over the epoch."""
    import faulthandler
    import os

    import torch

    from kubeml_tpu_torch.api.types import TrainTask
    from kubeml_tpu_torch.cli.main import build_parser, train_request
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    faulthandler.dump_traceback_later(DIST_TIMEOUT, repeat=True)
    settings(torch)
    dl.initialize(backend="gloo", timeout=DIST_TIMEOUT)
    rank = dl.rank()
    os.environ["KUBEML_TPU_HOME"] = os.path.join(outdir, f"job_home_p{rank}")
    rng = np.random.default_rng(int(seed) + seed_offset)
    DatasetRegistry().create(
        "tokens", token_windows(rng, RANK_JOB_TRAIN, TRAIN_T),
        np.zeros(RANK_JOB_TRAIN, np.int32),
        token_windows(rng, RANK_JOB_TEST, TRAIN_T),
        np.zeros(RANK_JOB_TEST, np.int32))
    req = train_request(build_parser().parse_args(list(argv)))
    task = TrainTask(job_id=job_id, parameters=req,
                     parallelism=req.options.default_parallelism)
    published = []
    job = TrainJob(task, get_model(req.model_type)(), token_dataset(),
                   device="cuda", n_lanes=1, callbacks=JobCallbacks(
                       publish_metrics=lambda m: published.append(
                           seq_counts())))
    torch.cuda.synchronize()
    seq_zero()                                # the main path's run starts
    hist = job.train().data
    counts, calls = published[0]              # ... and ends at the publish
    grid = job._engine.grid
    with open(os.path.join(outdir, f"job_p{rank}.json"), "w") as f:
        json.dump({"history": {"train_loss": list(hist.train_loss),
                               "validation_loss": list(hist.validation_loss),
                               "accuracy": list(hist.accuracy),
                               "parallelism": list(hist.parallelism)},
                   "counts": counts, "calls": calls,
                   "world": dl.world_size(),
                   "grid": [grid.n_data, grid.n_model, grid.n_seq,
                            grid.n_expert],
                   "stage": grid.n_stage,
                   "microbatches": job.model._pp_microbatches,
                   "plan": job.model.tp_plan,
                   "seconds": float(hist.epoch_duration[0]),
                   "layers": job._engine.module.layers,
                   "buckets": job._engine.merge_comm_proxy(job.state)[
                       "buckets_per_round"]}, f)
    dl.shutdown()
    return 0


def ep_child(mode, outdir, seed) -> int:
    """A rank of phase 26 (gloo ranks on the one card), started by
    dist_spawn with the KUBEML_* environment: 'ep' (two ranks, data 1 x
    expert 2): (a) the expert layer, (b) the rounds per dtype; 'ep4'
    (four ranks): (c) the round at (seq 2 x expert 2) and at (data 2 x seq
    2); 'job': (d), started through tools.launch_distributed. Writes its
    rows under ``outdir``."""
    import faulthandler
    import os

    import torch

    from kubeml_tpu_torch.parallel import distributed as dl

    if mode == "job":
        return rank_job_child(outdir, seed, EP_JOB_ARGV, "smoke-ep-job", 36)
    faulthandler.dump_traceback_later(DIST_TIMEOUT, repeat=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(seed)
    dl.initialize(backend="gloo", timeout=DIST_TIMEOUT)
    rank = dl.rank()
    rows = {"world": dl.world_size()}
    if mode == "ep":
        dl.make_grid(1, EP_N)
        ffn = ep_ffn(torch, seed, True)
        torch.save(ffn.pop("y"), os.path.join(outdir, f"ffn_p{rank}.pt"))
        rows["ffn"] = ffn
        runs = [(f"{dtype} ep", dtype, 1, EP_N, EP_W)
                for dtype in EP_DTYPES]
    else:
        runs = [("f32 sp-ep", "f32", 2, EP_N, EP_SP_LANES),
                ("f32 sp", "f32", 2, 1, EP_SP_LANES)]
    for key, dtype, n_seq, n_expert, lanes in runs:
        out = ep_round(torch, seed, dtype, n_seq, n_expert, lanes)
        torch.save(out.pop("state"), os.path.join(
            outdir, f"{key.replace(' ', '_')}_p{rank}.pt"))
        rows[key] = out
    with open(os.path.join(outdir, f"{mode}_p{rank}.json"), "w") as f:
        json.dump(rows, f)
    dl.shutdown()
    return 0


def job_launch(outdir, seed, child, n=2) -> tuple:
    """(d)'s ``n`` ranks of phases 26 and 27 (``child``'s 'job' mode),
    each through ``python -m tools.launch_distributed --processes n
    --process-id R --coordinator ...`` (the launcher's multi-host mode:
    one rank an invocation, which imports nothing of the JAX package),
    started without waiting; dist_collect waits for them and reads their
    rows."""
    import os

    port = store_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(n):
        logf = open(os.path.join(outdir, f"job_p{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tools.launch_distributed", "--processes",
             str(n), "--process-id", str(r), "--coordinator",
             f"localhost:{port}", "--", sys.executable, "-c", child, here,
             "job", outdir, str(seed)], cwd=here, stdout=logf,
            stderr=subprocess.STDOUT), logf))
    return ("job", n, outdir, DIST_CHILD_S,
            time.monotonic() + DIST_CHILD_S, procs)


def phase_ep(torch, card, seed, mv=None) -> dict:
    """Phase 26: expert parallelism over ranks (see the module
    docstring). The ranks of (a)+(b), (c) and (d) start together; this
    process meanwhile runs the one-process layer and rounds they are held
    to. ``mv``: phase 21's result, whose one-process ms per local step
    (e) logs beside the ranks'. Returns the launches for the kernels
    line."""
    import os
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kubeml_ep_") as tmp:
        spawned = [dist_spawn("ep", EP_N, tmp, seed, child=EP_CHILD),
                   dist_spawn("ep4", 2 * EP_N, tmp, seed, child=EP_CHILD),
                   job_launch(tmp, seed, EP_CHILD, EP_N)]
        ffn = ep_ffn(torch, seed, False)
        one = {dtype: ep_round(torch, seed, dtype, 1, 1, EP_W)
               for dtype in EP_DTYPES}
        ranks = dist_collect(card, spawned[0])
        quad = dist_collect(card, spawned[1])
        jobs = dist_collect(card, spawned[2])
        misses = []
        # (a)
        ys = [torch.load(os.path.join(tmp, f"ffn_p{r}.pt"))
              for r in range(EP_N)]
        err = float((ys[0] - ffn["y"]).abs().max())
        ok = torch.equal(ys[0], ys[1]) and torch.allclose(
            ys[0], ffn["y"], rtol=EP_FFN_TOL, atol=EP_FFN_TOL)
        from kubeml_tpu_torch.models.gpt import GPT_MOE_CONFIG as cfg

        log(card, f"ep (a) ep_partial_ffn at gpt-moe-mini's widths (f32, "
            f"[4096, 8, 640] dispatch, D={cfg['hidden']}, F={cfg['ffn']}, "
            f"{cfg['n_experts'] // EP_N} of {cfg['n_experts']} experts a "
            f"rank) over {EP_N} gloo expert ranks vs one process's moe_apply: "
            f"ranks equal bit for bit {torch.equal(ys[0], ys[1])}, max|diff| "
            f"{err:.3g} (rtol, atol {EP_FFN_TOL}); "
            f"{ranks[0]['ffn']['ms']:.3f} / {ranks[1]['ffn']['ms']:.3f} ms a "
            f"call on ranks 0 / 1 (the all-reduce over gloo included) "
            f"against {ffn['ms']:.3f} ms in one process")
        if not ok:
            misses.append(("ffn", err))
        out = {"rounds": {}, "one_process": {}}
        # (b) and (c)
        for dtype in EP_DTYPES:
            plan = seq_plan(None, one[dtype]["layers"], one[dtype]["steps"],
                            1, one[dtype]["buckets"])
            if one[dtype]["counts"] != plan:
                misses.append(("one process", dtype, one[dtype]["counts"]))
            out["one_process"][dtype] = one[dtype]["counts"]
        checks = [(f"{d} ep", ranks, one[d]["state"], one[d]["loss"], d,
                   f"the one-process round ({one[d]['ms']:.1f} ms)")
                  for d in EP_DTYPES]
        for key, rows, want, want_loss, dtype, against in checks + [
                ("f32 sp-ep", quad, None, None, "f32", None)]:
            tag = key.replace(" ", "_")
            got = [torch.load(os.path.join(tmp, f"{tag}_p{r}.pt"))
                   for r in range(len(rows))]
            equal = all(dist_equal(torch, got[0], g) for g in got[1:])
            if want is None:      # (c): against (data 2 x seq 2)
                sp = [torch.load(os.path.join(tmp, f"f32_sp_p{r}.pt"))
                      for r in range(len(rows))]
                equal = equal and all(dist_equal(torch, sp[0], g)
                                      for g in sp[1:])
                want, want_loss = sp[0], rows[0]["f32 sp"]["loss"]
                against = ("(data 2 x seq 2) with replicated experts "
                           f"({rows[0]['f32 sp']['ms']:.1f} ms)")
            ok, diff = seq_within(torch, got[0], want, dtype)
            loss = rows[0][key]["loss"]
            rel = max(abs(a - b) / max(1.0, abs(b))
                      for a, b in zip(loss, want_loss))
            counts = [r[key]["counts"] for r in rows]
            plans = [seq_plan("ring" if r[key]["seq"] > 1 else None,
                              r[key]["layers"], r[key]["steps"],
                              r[key]["seq"], r[key]["buckets"])
                     for r in rows]
            plain = all(all(r[key]["merge_plain"]) for r in rows)
            log(card, f"ep ({'c' if 'sp' in key else 'b'}) gpt-moe-mini "
                f"{key}, {len(rows)} gloo ranks (lanes "
                f"{EP_SP_LANES if 'sp' in key else EP_W}, K={EP_K} B={EP_B} "
                f"T={EP_T}, SGD, dropout 0.1, {EP_ROUNDS} rounds): ranks "
                f"equal bit for bit {equal}; against {against}: max|dw| "
                f"{diff:.3g} (rtol, atol {SEQ_W_TOL[dtype]}), loss rel "
                f"{rel:.3g} (tol {SEQ_LOSS_TOL[dtype]}); launches a rank "
                f"{counts} (plan {plans}); #5 grouped == plain bit for bit "
                f"{plain}; collectives a rank {rows[0][key]['calls']}; round "
                f"{EP_ROUNDS} {[round(r[key]['ms'], 1) for r in rows]} ms on "
                f"the ranks")
            if not (equal and ok and plain) or rel > SEQ_LOSS_TOL[dtype]:
                misses.append((key, equal, diff, rel, plain))
            if counts != plans:
                misses.append((key, "launches", counts, plans))
            out["rounds"][key] = counts
        out["rounds"]["f32 sp"] = [r["f32 sp"]["counts"] for r in quad]
        # (d)
        h = jobs[0]["history"]
        steps = sum(dist_worker_steps(RANK_JOB_TRAIN, 2))
        from kubeml_tpu_torch.data.sharding import plan_epoch

        merges = len(plan_epoch(RANK_JOB_TRAIN, 2, JOB_K, JOB_B).rounds)
        for r, j in enumerate(jobs):
            want = {"dK/dV": j["layers"] * steps, "dQ": j["layers"] * steps,
                    **merge_counts(j["buckets"], merges)}
            if j["grid"] != [1, 1, 1, EP_N] or j["world"] != EP_N or any(
                    j["counts"][k] != v for k, v in want.items()):
                misses.append(("job", r, j["grid"], j["counts"], want))
        log(card, f"ep (d) `kubeml {' '.join(EP_JOB_ARGV)}` through "
            f"tools.launch_distributed, {EP_N} gloo ranks (grid data x model x "
            f"seq x expert {jobs[0]['grid']}): histories equal "
            f"{jobs[0]['history'] == jobs[1]['history']}, train loss "
            f"{h['train_loss']}, validation {h['validation_loss']}; launches "
            f"over the epoch a rank {[j['counts'] for j in jobs]} (#3/#4 "
            f"plan {jobs[0]['layers'] * steps}, #5 "
            f"{merge_counts(jobs[0]['buckets'], merges)}); "
            f"{jobs[0]['seconds']:.2f} s")
        if jobs[0]["history"] != jobs[1]["history"] or not all(
                np.isfinite(h["train_loss"] + h["validation_loss"])):
            misses.append(("job history", jobs[0]["history"],
                           jobs[1]["history"]))
        out["job"] = [j["counts"] for j in jobs]
        # (e)
        per_step = None if mv is None else \
            mv["gpt-moe-mini"]["ms_per_step"]
        log(card, f"ep (e) gpt-moe-mini ms a round (K={EP_K} local steps, "
            f"B={EP_B}, T={EP_T}, one lane): bf16 "
            f"{[round(r['bf16 ep']['ms'], 1) for r in ranks]} on the "
            f"{EP_N} expert ranks, {one['bf16']['ms']:.1f} in one process "
            f"here; f32 {[round(r['f32 ep']['ms'], 1) for r in ranks]} vs "
            f"{one['f32']['ms']:.1f}; phase 21's one-process job, ms per "
            f"local step by epoch: {per_step} (the ranks share the card and "
            f"its host with each other and the other lanes)")
    log(card, f"ep phase 26: {time.perf_counter() - t0:.1f} s")
    if misses:
        raise AssertionError(f"phase 26 misses: {misses}")
    return out


def ep_launches(ep, kernel) -> dict:
    """A kernel's phase-26 launches for the kernels line: each round per
    rank, the one-process rounds, the job per rank."""
    return {"rounds": {k: [c[kernel] for c in v]
                       for k, v in ep["rounds"].items()},
            "one_process": {k: v[kernel]
                            for k, v in ep["one_process"].items()},
            "job": [c[kernel] for c in ep["job"]]}


# ----------------------------------------------------------------- phase 27
TP_N = 2                  # model ranks: two gloo ranks on the one card
TP_W, TP_K, TP_LR = 1, 2, 1e-2          # (b): one lane, SGD as phase 26's
TP_SHAPES = {"gpt-mini": (8, 512), "bert-tiny": (32, 64)}   # (B, T) a step
TP_ROUNDS = 2             # round 1 warms up; round 2 is counted and timed
TP_DTYPES = ("bf16", "f32")
TP_BLOCK_TOL = {"f32": 1e-5, "bf16": 2e-2}   # (a): rtol and atol
# (b)/(c): the merged weights against one process, (rtol, atol): the
# reference's TP-against-dense bound in bf16 (tests/test_manual_tp.py),
# f32's as phase 25's; the round's loss sum within (relative to max(1,
# |loss|), the reference's form)
TP_W_TOL = SEQ_W_TOL
TP_LOSS_TOL = {"bf16": 2e-2, "f32": 1e-5}
# (a)'s kernel shapes: the local heads of gpt-mini's 4 and bert-tiny's 2
# heads over two model ranks: (case, B, T, H, causal)
TP_KERNEL_CASES = (("gpt-mini local heads", 8, 512, 2, True),
                   ("bert-tiny local head", 32, 64, 1, False))
TP_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "sys.exit(chip_smoke.tp_child(*sys.argv[2:]))")
# (d)'s job: what `kubeml train` submits for these flags, on each rank
TP_JOB_ARGV = ("train", "-f", "gpt-mini", "-d", "tokens", "-e", "1",
               "-b", str(JOB_B), "-K", str(JOB_K), "-p", "2", "--static",
               "--lr", str(JOB_LR), "--merge-bucket-mb", str(MERGE_CAP_MB),
               "--tensor-parallel", str(TP_N))


def tp_weights(torch, name, seed):
    """A model's f32 state from the seed (numpy, through convert.py; the
    biases nonzero, so the row layers' one bias add shows): gpt-mini's
    random_flax_params, bert-tiny's with a classifier."""
    from kubeml_tpu_torch.convert import (bert_params_from_flax,
                                          params_from_flax,
                                          random_flax_params)
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    if name == "gpt-mini":
        return params_from_flax(random_flax_params(
            **GPT_CONFIGS["gpt-mini"], seed=seed))
    tree = random_flax_params(vocab_size=30522, max_len=128, hidden=128,
                              layers=2, heads=2, ffn=512, seed=seed)
    rng = np.random.default_rng(seed + 38)
    tree["classifier"] = {
        "kernel": (rng.standard_normal((128, 2)) / np.sqrt(128)).astype(
            np.float32),
        "bias": (0.1 * rng.standard_normal(2)).astype(np.float32)}
    return bert_params_from_flax(tree)


def tp_model(torch, seed, name, dtype, tp=False, n_seq=1):
    """(model, module on the card with tp_weights) at the model's widths
    (dropout 0.1), built tensor-parallel (the manual route: every pair
    split over the current grid's model axis) with ``tp``, and with the
    seq axis's ring for n_seq > 1."""
    from kubeml_tpu_torch.models import get_model

    model = get_model(name)(
        dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    if tp:
        model.enable_tensor_parallel()
    if n_seq > 1:
        model.enable_seq_parallel("ring")
    module = model.build(device="cuda")
    module.load_state_dict(tp_weights(torch, name, seed))
    return model, module


def tp_round_inputs(rng, name):
    """One round's inputs at the model's (B, T): phase 7's token runs for
    gpt-mini, phase 20's band-structured sequences and labels for
    bert-tiny; every example and step real."""
    B, T = TP_SHAPES[name]
    if name == "gpt-mini":
        return lm_round(rng, TP_W, TP_K, B, T)
    x, y = text_arrays(rng, TP_W * TP_K * B, T, 30522, 2, B)
    return ({"x": x.reshape(TP_W, TP_K, B, T), "y": y.reshape(TP_W, TP_K, B)},
            np.ones((TP_W, TP_K, B), np.float32),
            np.ones((TP_W, TP_K), np.float32), np.ones(TP_W, np.float32),
            rng.integers(0, 2 ** 32, (TP_W, TP_K, 2), dtype=np.uint32))


def tp_round(torch, seed, name, dtype, n_model=1, n_seq=1,
             tp_alone=False) -> dict:
    """TP_ROUNDS K-avg rounds of the model (one lane, K=2, SGD 1e-2, the 4
    MB bucketed merge) over this process's (model x seq) rank grid, or in
    one process without a group (1 x 1; ``tp_alone``: the module built
    tensor-parallel anyway, its model axis of size 1). The counters are
    zeroed just before the last round and read just after it."""
    import functools

    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    model, module = tp_model(torch, seed, name, dtype,
                             n_model > 1 or tp_alone, n_seq)
    engine = KAvgEngine(
        module, model.loss, model.metrics,
        lambda lr, e: functools.partial(torch.optim.SGD, lr=lr),
        n_lanes=TP_W, merge_bucket_mb=MERGE_CAP_MB, n_seq=n_seq,
        batch_seq_dims=model.seq_batch_dims if n_seq > 1 else None,
        n_model=n_model, manual_inner=n_model > 1 or tp_alone)
    state = {n: p.detach().clone() for n, p in module.named_parameters()}
    rng = np.random.default_rng(seed + 37)
    for _ in range(TP_ROUNDS):
        args = tp_round_inputs(rng, name)
        torch.cuda.synchronize()
        seq_zero()                            # the main path's run starts
        t0 = time.perf_counter()
        state, st = engine.train_round(state, *args, TP_LR, 0)
        loss = st.loss_sum
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, calls = seq_counts()          # ... and ends here
    return {"state": {k: v.detach().cpu() for k, v in state.items()},
            "counts": counts, "calls": calls, "ms": 1e3 * wall,
            "loss": [float(v) for v in loss], "layers": module.layers,
            "steps": int(args[2].sum()), "seq": engine.grid.n_seq,
            "buckets": engine.merge_comm_proxy(state)["buckets_per_round"]}


def tp_block(torch, seed, dtype, ranks: bool) -> dict:
    """(a): gpt-mini's first block at B=8, T=512 (a [8, 512, 256] input
    from the seed, phase 7's keep-mask), through ``models/gpt._block``:
    over this process's model ranks (the Megatron layers, attention on 2
    of the 4 heads) or dense in one process. Its output and warm ms a
    call."""
    from kubeml_tpu_torch.models.gpt import _block, _param_tree
    from kubeml_tpu_torch.ops.attention import masked_attention

    _, module = tp_model(torch, seed, "gpt-mini", dtype, ranks)
    B, T = TP_SHAPES["gpt-mini"]
    rng = np.random.default_rng(seed + 39)
    x = lm_round(rng, 1, 1, B, T)[0]["x"][0, 0]
    pad = torch.from_numpy((x != 0).astype(np.float32)).cuda()
    h = torch.from_numpy(rng.standard_normal((B, T, module.hidden)).astype(
        np.float32)).cuda().to(module.dtype)
    named = dict(module.named_parameters())
    with torch.no_grad():
        lp = _param_tree(module, lambda n, dt: named[n].to(dt),
                         tp=ranks)["layers"][0]

        def call():
            return _block(lp, h, lambda q, k, v: masked_attention(
                q, k, v, pad, causal=True))

        y = call()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    return {"y": y.float().cpu(), "ms": statistics.median(times)}


def tp_kernels(torch, card, seed, cases=TP_KERNEL_CASES, tag="tp",
               offset=40) -> dict:
    """(a) of phases 27 and 28: #2-#4 at ``cases``' shapes (case, B, T, H,
    causal; bf16, D=64, a padded tail at spread lengths and a fully
    padded sequence), each against its plain version within the flash
    tolerance, a second launch equal to the first bit for bit; warm times
    beside the plain version's, SDPA's and the bound. Rows by (case,
    kernel)."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + offset)
    tol = FLASH_TOL["bf16"]
    rows = {}
    for case, B, T, H, causal in cases:
        q, k, v, g, pad = flash_operands(torch, rng, "bf16", T, dev, B=B,
                                         H=H)
        fwd = (q, k, v, pad, causal)
        out, m, l = fa.fa_fwd_kernel(*fwd)
        bwd = (q, k, v, pad, g, m, l, fa._delta(g, out), causal)
        got = {"forward": (out, m, l), "dK/dV": fa.fa_bwd_dkv_kernel(*bwd),
               "dQ": (fa.fa_bwd_dq_kernel(*bwd),)}
        again = {"forward": fa.fa_fwd_kernel(*fwd),
                 "dK/dV": fa.fa_bwd_dkv_kernel(*bwd),
                 "dQ": (fa.fa_bwd_dq_kernel(*bwd),)}
        torch.cuda.synchronize()
        plain = {"forward": (lambda: fa._fa_forward_plain(*fwd)),
                 "dK/dV": (lambda: fa._fa_bwd_dkv_plain(*bwd)),
                 "dQ": (lambda: (fa._fa_bwd_dq_plain(*bwd),))}
        kern = {"forward": lambda: fa.fa_fwd_kernel(*fwd),
                "dK/dV": lambda: fa.fa_bwd_dkv_kernel(*bwd),
                "dQ": lambda: fa.fa_bwd_dq_kernel(*bwd)}
        lib_f, lib_b = library_flash_ms(torch, q, k, v, g, pad, causal)
        for kernel in ("forward", "dK/dV", "dQ"):
            assert all(torch.equal(a, b) for a, b in
                       zip(got[kernel], again[kernel])), (case, kernel)
            ref = plain[kernel]()
            for a, b in zip(got[kernel], ref):
                torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                           atol=tol)
            n = 1 if kernel == "forward" else len(ref)  # m, l: checked
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got[kernel][:n], ref[:n]))
            b_ms, b_by = flash_bound(q, causal, kernel)
            row = dict(shape=f"{case}: B={B} T={T} H={H} D={FA_D} bf16"
                       f"{' causal' if causal else ''}", max_abs_err=err,
                       ms=time_ms(torch, kern[kernel]),
                       plain_ms=time_ms(torch, plain[kernel]),
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_f if kernel == "forward" else lib_b)
            rows[(case, kernel)] = row
            log(card, f"{tag} (a) flash {kernel}, {row['shape']}: kernel "
                f"{row['ms']:.4f} ms (L2 warm), plain {row['plain_ms']:.4f} "
                f"ms, library {row['library_ms']:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}), {row['ms'] / b_ms:.1f}x bound, "
                f"max|err| {err:.3g} (tol {tol}); two launches equal bit "
                f"for bit")
    return rows


def tp_child(mode, outdir, seed) -> int:
    """A rank of phase 27, started by dist_spawn with the KUBEML_*
    environment: 'tp' (two gloo ranks, data 1 x model 2): (a) the block
    per dtype, (b) the rounds per model and dtype; 'tp4' (four gloo
    ranks): (c) the f32 round at (model 2 x seq 2); 'nccl' (one NCCL
    rank): the tensor-parallel module's round at M = 1; 'job': (d),
    started through tools.launch_distributed. Writes its rows under
    ``outdir``."""
    import faulthandler
    import os

    import torch

    from kubeml_tpu_torch.parallel import distributed as dl

    if mode == "job":
        return rank_job_child(outdir, seed, TP_JOB_ARGV, "smoke-tp-job", 41)
    faulthandler.dump_traceback_later(DIST_TIMEOUT, repeat=True)
    settings(torch)
    seed = int(seed)
    dl.initialize(backend=None if mode == "nccl" else "gloo",
                  timeout=DIST_TIMEOUT)
    rank = dl.rank()
    rows = {"world": dl.world_size()}
    if mode == "tp":
        dl.make_grid(1, 1, TP_N)
        for dtype in TP_DTYPES:
            blk = tp_block(torch, seed, dtype, True)
            torch.save(blk.pop("y"), os.path.join(
                outdir, f"block_{dtype}_p{rank}.pt"))
            rows[f"block {dtype}"] = blk
        runs = [(f"{name} {dtype}", name, dtype, TP_N, 1)
                for name in TP_SHAPES for dtype in TP_DTYPES]
    elif mode == "tp4":
        runs = [("gpt-mini f32 tp-sp", "gpt-mini", "f32", TP_N, 2)]
    else:
        runs = [("gpt-mini bf16 nccl", "gpt-mini", "bf16", 1, 1)]
    for key, name, dtype, n_model, n_seq in runs:
        out = tp_round(torch, seed, name, dtype, n_model, n_seq,
                       tp_alone=mode == "nccl")
        torch.save(out.pop("state"), os.path.join(
            outdir, f"{key.replace(' ', '_')}_p{rank}.pt"))
        rows[key] = out
    with open(os.path.join(outdir, f"{mode}_p{rank}.json"), "w") as f:
        json.dump(rows, f)
    dl.shutdown()
    return 0


def tp_relative(loss, want) -> float:
    """The reference's loss measure: |a - b| / max(1, |b|), the largest
    over the lanes."""
    return max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(loss, want))


def phase_tp(torch, card, seed) -> dict:
    """Phase 27: tensor parallelism over ranks (see the module docstring).
    The ranks of (a)+(b), (c), the NCCL rank and (d) start together; this
    process meanwhile runs (a)'s kernel rows and the dense block, and the
    one-process rounds they are held to. Returns the rows and launches for
    the kernels line."""
    import os
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kubeml_tp_") as tmp:
        spawned = [dist_spawn("tp", TP_N, tmp, seed, child=TP_CHILD),
                   dist_spawn("tp4", 2 * TP_N, tmp, seed, child=TP_CHILD),
                   dist_spawn("nccl", 1, tmp, seed, child=TP_CHILD),
                   job_launch(tmp, seed, TP_CHILD, TP_N)]
        shapes = tp_kernels(torch, card, seed)
        dense = {dtype: tp_block(torch, seed, dtype, False)
                 for dtype in TP_DTYPES}
        one = {(name, dtype): tp_round(torch, seed, name, dtype)
               for name in TP_SHAPES for dtype in TP_DTYPES}
        alone = tp_round(torch, seed, "gpt-mini", "bf16", tp_alone=True)
        ranks = dist_collect(card, spawned[0])
        quad = dist_collect(card, spawned[1])
        nccl = dist_collect(card, spawned[2])[0]
        jobs = dist_collect(card, spawned[3])
        misses = []
        # (a)
        for dtype in TP_DTYPES:
            ys = [torch.load(os.path.join(tmp, f"block_{dtype}_p{r}.pt"))
                  for r in range(TP_N)]
            tol = TP_BLOCK_TOL[dtype]
            err = float((ys[0] - dense[dtype]["y"]).abs().max())
            equal = torch.equal(ys[0], ys[1])
            ok = equal and torch.allclose(ys[0], dense[dtype]["y"],
                                          rtol=tol, atol=tol)
            log(card, f"tp (a) gpt-mini's first block (B=8, T=512, {dtype}; "
                f"q/k/v on 2 of 4 heads a rank, attention through #2 on the "
                f"local heads, the out-projection and the FFN's second Dense "
                f"summed in f32 over {TP_N} gloo model ranks) vs the dense "
                f"block in one process: ranks equal bit for bit {equal}, "
                f"max|diff| {err:.3g} (rtol, atol {tol}); "
                f"{ranks[0]['block ' + dtype]['ms']:.3f} / "
                f"{ranks[1]['block ' + dtype]['ms']:.3f} ms a call on ranks "
                f"0 / 1 (two 4 MB f32 all-reduces over gloo included) "
                f"against {dense[dtype]['ms']:.3f} ms dense")
            if not ok:
                misses.append(("block", dtype, equal, err))
        out = {"shapes": shapes, "rounds": {}, "one_process": {}}
        # (b), (c) and the NCCL rank
        checks = [(f"{name} {dtype}", ranks, one[name, dtype], dtype, "b")
                  for name in TP_SHAPES for dtype in TP_DTYPES]
        checks += [("gpt-mini f32 tp-sp", quad, one["gpt-mini", "f32"],
                    "f32", "c")]
        for key, rows, want, dtype, part in checks:
            tag = key.replace(" ", "_")
            got = [torch.load(os.path.join(tmp, f"{tag}_p{r}.pt"))
                   for r in range(len(rows))]
            equal = all(dist_equal(torch, got[0], g) for g in got[1:])
            ok, diff = seq_within(torch, got[0], want["state"], dtype)
            rel = tp_relative(rows[0][key]["loss"], want["loss"])
            counts = [r[key]["counts"] for r in rows]
            plans = [seq_plan("ring" if r[key]["seq"] > 1 else None,
                              r[key]["layers"], r[key]["steps"],
                              r[key]["seq"], r[key]["buckets"])
                     for r in rows]
            log(card, f"tp ({part}) {key}, {len(rows)} gloo ranks "
                f"({'model 2 x seq 2' if part == 'c' else 'data 1 x model 2'}"
                f", 1 lane, K={TP_K} (B, T)={TP_SHAPES[key.split()[0]]}, SGD, "
                f"dropout 0.1, {TP_ROUNDS} rounds): ranks equal bit for bit "
                f"{equal}; against one process ({want['ms']:.1f} ms a round):"
                f" max|dw| {diff:.3g} (rtol, atol {TP_W_TOL[dtype]}), loss "
                f"rel {rel:.3g} (tol {TP_LOSS_TOL[dtype]}); launches a rank "
                f"{counts} (plan {plans}); collectives a rank "
                f"{rows[0][key]['calls']}; round {TP_ROUNDS} "
                f"{[round(r[key]['ms'], 1) for r in rows]} ms on the ranks")
            if not (equal and ok) or rel > TP_LOSS_TOL[dtype]:
                misses.append((key, equal, diff, rel))
            if counts != plans:
                misses.append((key, "launches", counts, plans))
            out["rounds"][key] = counts
        for (name, dtype), r in one.items():
            plan = seq_plan(None, r["layers"], r["steps"], 1, r["buckets"])
            if r["counts"] != plan:
                misses.append(("one process", name, dtype, r["counts"]))
            out["one_process"][f"{name} {dtype}"] = r["counts"]
        got = torch.load(os.path.join(tmp, "gpt-mini_bf16_nccl_p0.pt"))
        rank0 = nccl["gpt-mini bf16 nccl"]
        equal = dist_equal(torch, got, alone["state"]) \
            and rank0["loss"] == alone["loss"]
        log(card, f"tp one NCCL rank, gpt-mini built tensor-parallel at M = 1"
            f" (bf16, 1 lane, K={TP_K}): equal to the same round without a "
            f"group bit for bit {equal}; launches {rank0['counts']} against "
            f"{alone['counts']}; collectives {rank0['calls']}")
        if not equal or rank0["counts"] != alone["counts"]:
            misses.append(("nccl", equal))
        out["rounds"]["gpt-mini bf16 nccl"] = [rank0["counts"]]
        # (d)
        h = jobs[0]["history"]
        steps = sum(dist_worker_steps(RANK_JOB_TRAIN, 2))
        from kubeml_tpu_torch.data.sharding import plan_epoch

        merges = len(plan_epoch(RANK_JOB_TRAIN, 2, JOB_K, JOB_B).rounds)
        for r, j in enumerate(jobs):
            want = {"dK/dV": j["layers"] * steps, "dQ": j["layers"] * steps,
                    **merge_counts(j["buckets"], merges)}
            if j["grid"] != [1, TP_N, 1, 1] or j["world"] != TP_N or any(
                    j["counts"][k] != v for k, v in want.items()):
                misses.append(("job", r, j["grid"], j["counts"], want))
        log(card, f"tp (d) `kubeml {' '.join(TP_JOB_ARGV)}` through "
            f"tools.launch_distributed, {TP_N} gloo ranks (grid data x model "
            f"x seq x expert {jobs[0]['grid']}, the GSPMD route's plan "
            f"{jobs[0]['plan']}): histories equal "
            f"{jobs[0]['history'] == jobs[1]['history']}, train loss "
            f"{h['train_loss']}, validation {h['validation_loss']}; launches "
            f"over the epoch a rank {[j['counts'] for j in jobs]} (#3/#4 "
            f"plan {jobs[0]['layers'] * steps}, #5 "
            f"{merge_counts(jobs[0]['buckets'], merges)}); "
            f"{jobs[0]['seconds']:.2f} s")
        if jobs[0]["history"] != jobs[1]["history"] or not all(
                np.isfinite(h["train_loss"] + h["validation_loss"])):
            misses.append(("job history", jobs[0]["history"],
                           jobs[1]["history"]))
        out["job"] = [j["counts"] for j in jobs]
        # (e)
        log(card, "tp (e) ms a round (one lane, K=2) a model rank against "
            "one process: " + "; ".join(
                f"{name} {dtype} "
                f"{[round(r[f'{name} {dtype}']['ms'], 1) for r in ranks]} vs "
                f"{one[name, dtype]['ms']:.1f}"
                for name in TP_SHAPES for dtype in TP_DTYPES)
            + f"; (model 2 x seq 2) f32 "
            f"{[round(r['gpt-mini f32 tp-sp']['ms'], 1) for r in quad]} "
            f"(the ranks share the card and its host with each other and "
            f"the other lanes)")
    log(card, f"tp phase 27: {time.perf_counter() - t0:.1f} s")
    if misses:
        raise AssertionError(f"phase 27 misses: {misses}")
    return out


def tp_launches(tp, kernel) -> dict:
    """A kernel's phase-27 launches for the kernels line: each round per
    rank (and the NCCL rank's), the one-process rounds, the job per
    rank."""
    return {"rounds": {k: [c[kernel] for c in v]
                       for k, v in tp["rounds"].items()},
            "one_process": {k: v[kernel]
                            for k, v in tp["one_process"].items()},
            "job": [c[kernel] for c in tp["job"]]}


# ----------------------------------------------------------------- phase 28
PP_P, PP_M = 2, 4         # stage ranks (two gloo ranks on the one card),
                          # microbatches (the default 2 x stages)
PP_DTYPES = ("bf16", "f32")
# (b), (c): a stage rank's weights and loss against one process (rtol and
# atol; the loss relative to max(1, |loss|)): f32 within 1e-6 (rounding
# only: the same draws, the same microbatches), bf16 within 2e-2 (the
# flash tolerance: the reduction orders of the explicit backward differ)
PP_TOL = {"f32": 1e-6, "bf16": 2e-2}
PP_DENSE_TOL = 1e-5       # (b) at dropout 0, f32, against the dense round
PP_LOGIT_TOL = 1e-5       # (c) the two expert routes' f32 logits
# (c)'s forward at capacity factor E = 8: no expert can overflow, so the
# token-sharded route's per-shard routing equals the replicated one's
PP_CAPACITY = 8.0
# (a)'s kernel shapes: a microbatch of gpt-mini's B=8 and bert-tiny's B=32
# at M=4: (case, B/M, T, H, causal)
PP_KERNEL_CASES = (("gpt-mini microbatch", 2, 512, 4, True),
                   ("bert-tiny microbatch", 8, 64, 2, False))
PP_SHAPES = dict(TP_SHAPES, **{"gpt-moe-mini": (8, 512)})
PP_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "sys.exit(chip_smoke.pp_child(*sys.argv[2:]))")
# (d)'s job: what `kubeml train` submits for these flags, on each rank
PP_JOB_ARGV = ("train", "-f", "gpt-mini", "-d", "tokens", "-e", "1",
               "-b", str(JOB_B), "-K", str(JOB_K), "-p", "2", "--static",
               "--lr", str(JOB_LR), "--merge-bucket-mb", str(MERGE_CAP_MB),
               "--pipeline-parallel", str(PP_P))


def pp_weights(torch, name, seed):
    """A model's f32 state from the seed (numpy, through convert.py):
    phase 27's for gpt-mini and bert-tiny, random_flax_params for
    gpt-moe-mini."""
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPT_MOE_CONFIG

    if name == "gpt-moe-mini":
        return params_from_flax(random_flax_params(**GPT_MOE_CONFIG,
                                                   seed=seed))
    return tp_weights(torch, name, seed)


def pp_model(torch, seed, name, dtype, pp=PP_P, n_expert=1, dropout=None):
    """(model, module on the card with pp_weights) at the model's widths,
    its loss pipelined over ``pp`` stages in PP_M microbatches (0: the
    dense loss), its experts over the grid's expert axis for n_expert >
    1; ``dropout`` in place of the published rate (0.1) where given."""
    from kubeml_tpu_torch.models import get_model

    model = get_model(name)(
        dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    if n_expert > 1:
        model.enable_expert_parallel()
    if pp:
        model.enable_pipeline_parallel(pp, PP_M)
    module = model.build(device="cuda")
    module.load_state_dict(pp_weights(torch, name, seed))
    if dropout is not None:
        for m in module.modules():       # the module's and BERT's blocks'
            if isinstance(getattr(m, "dropout", None), float):
                m.dropout = dropout
    return model, module


def pp_round_inputs(rng, name):
    """One round's inputs at the model's PP_SHAPES: phase 27's."""
    if name == "bert-tiny":
        return tp_round_inputs(rng, name)
    B, T = PP_SHAPES[name]
    return lm_round(rng, TP_W, TP_K, B, T)


def pp_round(torch, seed, name, dtype, n_stage=1, n_expert=1, pp=PP_P,
             dropout=None) -> dict:
    """TP_ROUNDS K-avg rounds of the model (one lane, K=2, SGD 1e-2, the 4
    MB bucketed merge) over a (stage x expert) rank grid of this
    process's group, or in one process without a group (1 x 1: a
    pipelined loss then runs the sequential schedule). ``pp``: the
    stages the loss pipelines for (0: the dense loss). The counters are
    zeroed just before the last round and read just after it."""
    import functools

    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    model, module = pp_model(torch, seed, name, dtype, pp, n_expert, dropout)
    engine = KAvgEngine(
        module, model.loss, model.metrics,
        lambda lr, e: functools.partial(torch.optim.SGD, lr=lr),
        n_lanes=TP_W, merge_bucket_mb=MERGE_CAP_MB, n_stage=n_stage,
        n_expert=n_expert, manual_inner=bool(pp))
    state = {n: p.detach().clone() for n, p in module.named_parameters()}
    rng = np.random.default_rng(seed + 43)
    for _ in range(TP_ROUNDS):
        args = pp_round_inputs(rng, name)
        torch.cuda.synchronize()
        seq_zero()                            # the main path's run starts
        t0 = time.perf_counter()
        state, st = engine.train_round(state, *args, TP_LR, 0)
        loss = st.loss_sum
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, calls = seq_counts()          # ... and ends here
    return {"state": {k: v.detach().cpu() for k, v in state.items()},
            "counts": counts, "calls": calls, "ms": 1e3 * wall,
            "loss": [float(v) for v in loss], "layers": module.layers,
            "steps": int(args[2].sum()), "stages": n_stage, "pp": pp,
            "buckets": engine.merge_comm_proxy(state)["buckets_per_round"]}


def pp_plan(r) -> dict:
    """A rank's launches over one pp_round: #2-#4 M x L / P a step on a
    stage rank (M x L a step in one process's sequential schedule, L a
    step in the dense round); #5 once a merge."""
    per = r["layers"] * PP_M // r["stages"] if r["pp"] else r["layers"]
    return {**{k: per * r["steps"] for k in ("forward", "dK/dV", "dQ")},
            **merge_counts(r["buckets"], 1)}


def pp_exchanges(r) -> int:
    """A stage rank's hops over one pp_round: M + P - 2 each way a step."""
    return 2 * (PP_M + r["stages"] - 2) * r["steps"] if r["stages"] > 1 \
        else 0


def pp_forward(torch, seed, impl) -> dict:
    """(c): gpt-moe-mini's forward_pipelined (f32, B=8 pad-free token runs
    of T=512, M=4) over (stage 2 x expert 2) under ``impl``, at
    PP_CAPACITY: the logits and the aux."""
    from kubeml_tpu_torch.models import gpt
    from kubeml_tpu_torch.parallel import distributed as dl

    model, module = pp_model(torch, seed, "gpt-moe-mini", "f32", pp=0)
    module.ep_impl = impl
    B, T = PP_SHAPES["gpt-moe-mini"]
    x = np.maximum(lm_round(np.random.default_rng(seed + 44), 1, 1, B, T)[0][
        "x"][0, 0], 1)
    before, gpt.CAPACITY_FACTOR = gpt.CAPACITY_FACTOR, PP_CAPACITY
    try:
        logits, aux = model.forward_pipelined(
            module, x, grid=dl.make_grid(1, 2, 1, PP_P), microbatches=PP_M)
    finally:
        gpt.CAPACITY_FACTOR = before
    return {"logits": logits.cpu(), "aux": float(aux)}


def pp_lane(torch, seed) -> dict:
    """(c) on one NCCL rank (a stage axis of 1): gpt-mini's four blocks
    (bf16, dropout 0.1 drawn per microbatch and block, the model's
    pipelined stage function) as one stage over PP_M microbatches of a
    [8, 512, 256] activation, through pipeline_lane (the explicit
    schedule's forward and backward) and through sequential_apply
    (autograd): whether the outputs and the blocks' gradients are equal
    bit for bit, and their largest differences."""
    from kubeml_tpu_torch.models.gpt import _param_tree, pp_keys, pp_stage
    from kubeml_tpu_torch.parallel.pp import (pipeline_lane,
                                              sequential_apply,
                                              stack_stage_params)

    _, module = pp_model(torch, seed, "gpt-mini", "bf16", pp=0)
    B, T = PP_SHAPES["gpt-mini"]
    rng = np.random.default_rng(seed + 45)
    x = lm_round(rng, 1, 1, B, T)[0]["x"][0, 0]
    pad = torch.from_numpy((x != 0).astype(np.float32)).cuda()
    h = torch.from_numpy(rng.standard_normal((B, T, module.hidden)).astype(
        np.float32)).cuda().to(module.dtype)
    g = torch.from_numpy(rng.standard_normal((B, T, module.hidden)).astype(
        np.float32)).cuda().to(module.dtype)
    stage_fn = pp_stage(0.1, True, False)
    consts = (pad.reshape(PP_M, B // PP_M, T), pp_keys(
        torch.Generator(device="cuda").manual_seed(seed + 46), PP_M, 0.1))
    hm = h.reshape(PP_M, B // PP_M, T, module.hidden)
    outs = {}
    for name, run in (("lane", lambda ls: pipeline_lane(
            stage_fn, ls, hm, consts=consts)[0]),
            ("sequential", lambda ls: sequential_apply(
                stage_fn, stack_stage_params([ls]), hm, consts=consts))):
        module.zero_grad(set_to_none=True)
        named = dict(module.named_parameters())
        layers = _param_tree(module, lambda n, dt: named[n].to(dt))["layers"]
        ys = run(layers)
        (ys.float() * g.reshape(hm.shape).float()).sum().backward()
        torch.cuda.synchronize()
        outs[name] = (ys.detach(), {n: p.grad.detach().clone() for n, p in
                                    module.named_parameters()
                                    if p.grad is not None})
    (ya, ga), (yb, gb) = outs["lane"], outs["sequential"]
    return {"ys_equal": bool(torch.equal(ya, yb)),
            "ys_diff": float((ya.float() - yb.float()).abs().max()),
            "grads_equal": set(ga) == set(gb) and all(
                torch.equal(ga[k], gb[k]) for k in ga),
            "grad_diff": max(float((ga[k] - gb[k]).abs().max()) for k in ga),
            "grads": len(ga)}


def pp_child(mode, outdir, seed) -> int:
    """A rank of phase 28, started by dist_spawn with the KUBEML_*
    environment: 'pp' (two gloo ranks, data 1 x stage 2): (b) the rounds
    per model and dtype, at dropout 0 in f32, and gpt-moe-mini's f32
    round; 'pp4' (four gloo ranks): (c) gpt-mini's f32 round at stage 4,
    gpt-moe-mini's at stage 2 x expert 2 and its forward under both
    expert routes; 'nccl' (one NCCL rank): pp_lane; 'job': (d), started
    through tools.launch_distributed. Writes its rows under
    ``outdir``."""
    import faulthandler
    import os

    import torch

    from kubeml_tpu_torch.parallel import distributed as dl

    if mode == "job":
        return rank_job_child(outdir, seed, PP_JOB_ARGV, "smoke-pp-job", 42)
    faulthandler.dump_traceback_later(DIST_TIMEOUT, repeat=True)
    settings(torch)
    seed = int(seed)
    dl.initialize(backend=None if mode == "nccl" else "gloo",
                  timeout=DIST_TIMEOUT)
    rank = dl.rank()
    rows = {"world": dl.world_size()}
    runs = []              # (key, model, dtype, stages, experts, dropout)
    if mode == "pp":
        runs = [(f"{name} {dtype}", name, dtype, PP_P, 1, None)
                for name in TP_SHAPES for dtype in PP_DTYPES]
        runs += [(f"{name} f32 dropout 0", name, "f32", PP_P, 1, 0.0)
                 for name in TP_SHAPES]
        runs += [("gpt-moe-mini f32", "gpt-moe-mini", "f32", PP_P, 1, None)]
    elif mode == "pp4":
        runs = [("gpt-mini f32 stage 4", "gpt-mini", "f32", 4, 1, None),
                ("gpt-moe-mini f32 pp-ep", "gpt-moe-mini", "f32", PP_P, 2,
                 None)]
    else:
        rows["lane"] = pp_lane(torch, seed)
    for key, name, dtype, n_stage, n_expert, dropout in runs:
        out = pp_round(torch, seed, name, dtype, n_stage, n_expert, n_stage,
                       dropout)
        torch.save(out.pop("state"), os.path.join(
            outdir, f"{key.replace(' ', '_')}_p{rank}.pt"))
        rows[key] = out
    if mode == "pp4":
        for impl in ("replicated", "alltoall"):
            fwd = pp_forward(torch, seed, impl)
            torch.save(fwd.pop("logits"), os.path.join(
                outdir, f"fwd_{impl}_p{rank}.pt"))
            rows[f"fwd {impl}"] = fwd
    with open(os.path.join(outdir, f"{mode}_p{rank}.json"), "w") as f:
        json.dump(rows, f)
    dl.shutdown()
    return 0


def phase_pp(torch, card, seed) -> dict:
    """Phase 28: pipeline parallelism over ranks (see the module
    docstring). The ranks of (b), (c), the NCCL rank and (d) start
    together; this process meanwhile runs (a)'s kernel rows and the
    one-process rounds they are held to. Returns the rows and launches
    for the kernels line."""
    import os
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kubeml_pp_") as tmp:
        spawned = [dist_spawn("pp", PP_P, tmp, seed, child=PP_CHILD),
                   dist_spawn("pp4", 2 * PP_P, tmp, seed, child=PP_CHILD),
                   dist_spawn("nccl", 1, tmp, seed, child=PP_CHILD),
                   job_launch(tmp, seed, PP_CHILD, PP_P)]
        shapes = tp_kernels(torch, card, seed, PP_KERNEL_CASES, "pp", 42)
        # the sequential schedule (the pipelined loss without a stage
        # axis: the same microbatches and draws) and the dense rounds
        one = {(name, dtype): pp_round(torch, seed, name, dtype)
               for name in TP_SHAPES for dtype in PP_DTYPES}
        one["gpt-moe-mini", "f32"] = pp_round(torch, seed, "gpt-moe-mini",
                                              "f32")
        dense = {name: pp_round(torch, seed, name, "f32", pp=0, dropout=0.0)
                 for name in TP_SHAPES}
        ranks = dist_collect(card, spawned[0])
        quad = dist_collect(card, spawned[1])
        nccl = dist_collect(card, spawned[2])[0]
        jobs = dist_collect(card, spawned[3])
        misses = []
        out = {"shapes": shapes, "rounds": {}, "one_process": {}}

        def load(key, n):
            tag = key.replace(" ", "_")
            return [torch.load(os.path.join(tmp, f"{tag}_p{r}.pt"))
                    for r in range(n)]

        # (b) and (c): (key, rows, the run it is held to, tolerance, what)
        checks = [(f"{name} {dtype}", ranks, one[name, dtype],
                   PP_TOL[dtype], "b: against the sequential schedule")
                  for name, dtype in one]
        checks += [(f"{name} f32 dropout 0", ranks, dense[name],
                    PP_DENSE_TOL, "b: at dropout 0 against the dense round")
                   for name in TP_SHAPES]
        held = {"gpt-mini f32": load("gpt-mini f32", 1)[0],
                "gpt-moe-mini f32": load("gpt-moe-mini f32", 1)[0]}
        checks += [("gpt-mini f32 stage 4", quad, {
                        "state": held["gpt-mini f32"],
                        "loss": ranks[0]["gpt-mini f32"]["loss"]},
                    PP_TOL["f32"], "c: at stage 4 against stage 2"),
                   ("gpt-moe-mini f32 pp-ep", quad, {
                       "state": held["gpt-moe-mini f32"],
                       "loss": ranks[0]["gpt-moe-mini f32"]["loss"]},
                    PP_TOL["f32"], "c: at stage 2 x expert 2 against "
                    "stage 2, replicated experts")]
        for key, rows, want, tol, what in checks:
            got = load(key, len(rows))
            equal = all(dist_equal(torch, got[0], g) for g in got[1:])
            diff = max(float((got[0][k].float() - want["state"][k].float())
                             .abs().max()) for k in want["state"])
            ok = all(torch.allclose(got[0][k].float(), want["state"][k]
                                    .float(), rtol=tol, atol=tol)
                     for k in want["state"])
            rel = tp_relative(rows[0][key]["loss"], want["loss"])
            counts = [r[key]["counts"] for r in rows]
            plans = [pp_plan(r[key]) for r in rows]
            hops = [r[key]["calls"]["exchange"] for r in rows]
            hop_plan = [pp_exchanges(r[key]) for r in rows]
            log(card, f"pp ({what}) {key}, {len(rows)} gloo ranks (1 lane, "
                f"K={TP_K}, (B, T)={PP_SHAPES[key.split()[0]]}, M={PP_M}, "
                f"SGD, {TP_ROUNDS} rounds): ranks equal bit for bit {equal};"
                f" max|dw| {diff:.3g}, loss rel {rel:.3g} (tol {tol}); "
                f"launches a rank {counts} (plan {plans}); exchanges a rank "
                f"{hops} (plan {hop_plan}); collectives a rank "
                f"{rows[0][key]['calls']}; round {TP_ROUNDS} "
                f"{[round(r[key]['ms'], 1) for r in rows]} ms on the ranks")
            if not (equal and ok) or rel > tol:
                misses.append((key, equal, diff, rel))
            if counts != plans or hops != hop_plan:
                misses.append((key, "launches", counts, plans, hops))
            out["rounds"][key] = counts
        for key, r in [(f"{n} {d}", one[n, d]) for n, d in one] + [
                (f"{n} f32 dense", r) for n, r in dense.items()]:
            if r["counts"] != pp_plan(r):
                misses.append(("one process", key, r["counts"]))
            out["one_process"][key] = r["counts"]
        # (c) the expert routes' forward and the NCCL rank
        fwd = {impl: torch.load(os.path.join(tmp, f"fwd_{impl}_p0.pt"))
               for impl in ("replicated", "alltoall")}
        err = float((fwd["alltoall"] - fwd["replicated"]).abs().max())
        finite = bool(torch.isfinite(fwd["alltoall"]).all())
        log(card, f"pp (c) gpt-moe-mini forward_pipelined over stage 2 x "
            f"expert 2 (f32, B=8, T=512, M={PP_M}, capacity factor "
            f"{PP_CAPACITY:g}): ep_impl='alltoall' against 'replicated' "
            f"max|dlogit| {err:.3g} (tol {PP_LOGIT_TOL}) of max|logit| "
            f"{float(fwd['replicated'].abs().max()):.3g}; aux "
            f"{quad[0]['fwd alltoall']['aux']:.6f} (the shards' statistics "
            f"averaged) / {quad[0]['fwd replicated']['aux']:.6f}")
        if err > PP_LOGIT_TOL or not finite:
            misses.append(("forward routes", err, finite))
        lane = nccl["lane"]
        log(card, f"pp (c) one NCCL rank, gpt-mini's four blocks as one "
            f"stage (bf16, dropout 0.1, M={PP_M}): pipeline_lane against "
            f"sequential_apply, outputs equal bit for bit "
            f"{lane['ys_equal']} (max|diff| {lane['ys_diff']:.3g}), "
            f"{lane['grads']} gradients equal bit for bit "
            f"{lane['grads_equal']} (max|diff| {lane['grad_diff']:.3g})")
        if not lane["ys_equal"] or lane["grad_diff"] > FLASH_TOL["bf16"]:
            misses.append(("nccl lane", lane))
        # (d)
        h = jobs[0]["history"]
        steps = sum(dist_worker_steps(RANK_JOB_TRAIN, 2))
        from kubeml_tpu_torch.data.sharding import plan_epoch

        merges = len(plan_epoch(RANK_JOB_TRAIN, 2, JOB_K, JOB_B).rounds)
        for r, j in enumerate(jobs):
            per = j["layers"] * j["microbatches"] // j["stage"]
            want = {"dK/dV": per * steps, "dQ": per * steps,
                    **merge_counts(j["buckets"], merges)}
            if j["grid"] != [1, 1, 1, 1] or j["stage"] != PP_P or \
                    j["world"] != PP_P or any(j["counts"][k] != v
                                              for k, v in want.items()):
                misses.append(("job", r, j["grid"], j["counts"], want))
        log(card, f"pp (d) `kubeml {' '.join(PP_JOB_ARGV)}` through "
            f"tools.launch_distributed, {PP_P} gloo ranks (stage axis "
            f"{jobs[0]['stage']}, {jobs[0]['microbatches']} microbatches): "
            f"histories equal {jobs[0]['history'] == jobs[1]['history']}, "
            f"train loss {h['train_loss']}, validation "
            f"{h['validation_loss']}; launches over the epoch a rank "
            f"{[j['counts'] for j in jobs]} (#3/#4 plan "
            f"{jobs[0]['layers'] * PP_M // PP_P * steps}, #5 "
            f"{merge_counts(jobs[0]['buckets'], merges)}); exchanges "
            f"{[j['calls']['exchange'] for j in jobs]}; "
            f"{jobs[0]['seconds']:.2f} s")
        if jobs[0]["history"] != jobs[1]["history"] or not all(
                np.isfinite(h["train_loss"] + h["validation_loss"])):
            misses.append(("job history", jobs[0]["history"],
                           jobs[1]["history"]))
        out["job"] = [j["counts"] for j in jobs]
        # (e)
        log(card, "pp (e) ms a round (one lane, K=2) a stage rank against "
            "one process's sequential schedule: " + "; ".join(
                f"{name} {dtype} "
                f"{[round(r[f'{name} {dtype}']['ms'], 1) for r in ranks]} vs "
                f"{one[name, dtype]['ms']:.1f}" for name, dtype in one)
            + "; the dense round at dropout 0 (f32): " + "; ".join(
                f"{name} {dense[name]['ms']:.1f}" for name in TP_SHAPES)
            + f"; stage 4 (f32) "
            f"{[round(r['gpt-mini f32 stage 4']['ms'], 1) for r in quad]}; "
            f"stage 2 x expert 2 (gpt-moe-mini f32) "
            f"{[round(r['gpt-moe-mini f32 pp-ep']['ms'], 1) for r in quad]}"
            f" (the ranks share the card and its host with each other and "
            f"the other lanes)")
    log(card, f"pp phase 28: {time.perf_counter() - t0:.1f} s")
    if misses:
        raise AssertionError(f"phase 28 misses: {misses}")
    return out


def pp_launches(pp, kernel) -> dict:
    """A kernel's phase-28 launches for the kernels line: each round per
    rank, the one-process rounds, the job per rank."""
    return {"rounds": {k: [c[kernel] for c in v]
                       for k, v in pp["rounds"].items()},
            "one_process": {k: v[kernel]
                            for k, v in pp["one_process"].items()},
            "job": [c[kernel] for c in pp["job"]]}


def phase_merge_only(torch, card, seed) -> dict:
    """--merge-only: what two trees of the port are compared by, through
    calls every tree with the fused merge has: (a) the one-segment
    launch at every bucket length of every model's plan (avg, summed per
    plan); (b) lane_merge_cost."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 28)
    lengths = [n for plan in MERGE_PLANS.values() for n in plan]
    rows = merge_kernel_rows(torch, card, gen, lengths, cold=lengths,
                             timed=("avg",))
    out = {"per_bucket": {name: {k: sum(rows[n]["avg"][k] for n in plan)
                                 for k in ("ms", "cold_ms", "bound_ms")}
                          for name, plan in MERGE_PLANS.items()}}
    for name, row in out["per_bucket"].items():
        log(card, f"fused_merge one launch a bucket, {name}'s plan summed: "
            f"{row['ms']:.4f} ms (L2 cold {row['cold_ms']:.4f}), bound "
            f"{row['bound_ms']:.5f} ms")
    out["lane_merge"] = lane_merge_cost(torch, card, seed)
    return out


def lane_merge_cost(torch, card, seed, calls: int = 50) -> dict:
    """--merge-only (b): one BucketedMerge(4 MB).lane_merge over the
    variable tree of gpt-mini, ResNet-18, gpt-moe-mini and vgg11 built
    for bf16 (f32 leaves, random), with random f32 contributions of
    MERGE_LANES live lanes:
    its host microseconds (host_us over ``calls``) and the device memory
    it takes above what it was given, at its peak and in the merged tree
    it returns (torch.cuda.max_memory_allocated and memory_allocated less
    the allocation before the call). Rows by model."""
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import module_state
    from kubeml_tpu_torch.parallel.merge import BucketedMerge

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    raw = torch.tensor(float(MERGE_LANES), device=dev)
    alive = torch.ones(MERGE_LANES, dtype=torch.bool, device=dev)
    merger = BucketedMerge(bucket_mb=MERGE_CAP_MB)
    rows = {}
    for name in ("gpt-mini", "resnet18", "gpt-moe-mini", "vgg11"):
        ref = module_state(get_model(name)().build(dtype=torch.bfloat16,
                                                   device=dev))
        contrib = {n: torch.randn((MERGE_LANES, *v.shape), device=dev,
                                  generator=gen) for n, v in ref.items()}
        args = (contrib, ref, raw, raw.clamp_min(1.0), alive)
        host = host_us(torch, lambda: merger.lane_merge(*args), calls)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        merged, _ = merger.lane_merge(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        held = torch.cuda.memory_allocated() - before
        del merged, args, contrib, ref
        rows[name] = dict(buckets=len(MERGE_PLANS[name]), host_us=host,
                          peak_mib=peak / 2**20, held_mib=held / 2**20)
        log(card, f"lane_merge {name} ({len(MERGE_PLANS[name])} buckets at "
            f"{MERGE_CAP_MB:g} MB, f32 leaves, {MERGE_LANES} lanes): host "
            f"{host:.1f} us (median of {calls}); device memory above its "
            f"inputs {peak / 2**20:.1f} MiB at the peak, "
            f"{held / 2**20:.1f} MiB held by the merged tree")
    return rows


def merge_entry(rows, launches):
    """The kernels-line entry of the fused merge: one whole gpt-mini merge
    in one grouped launch, avg mode (every model's plan under "plans"),
    with the launches and segments of the ef_int8 run; the per-length
    rows under "buckets" and "ragged", and the sgd check under "sgd"
    (summed over the buckets)."""
    by_len, plan = rows["lengths"], rows["plans"]["gpt-mini"]

    def total(mode, key):
        return sum(by_len[n][mode][key] for n in MERGE_BUCKETS)

    return {
        "name": "fused_merge (avg)",
        "route": "cuda",
        "source": "kubeml_tpu_torch/ops/csrc/fused_merge.cu",
        "replaces": "kubeml_tpu/ops/pallas/fused_merge.py:51",
        "launches": launches["ef_int8"]["fused_merge"],
        "segments": launches["ef_int8"]["merge segments"],
        "launches_by_strategy": launches,
        "shape": (f"gpt-mini's {len(MERGE_BUCKETS)} buckets at "
                  f"{MERGE_CAP_MB:g} MB, {sum(MERGE_BUCKETS)} f32 elements "
                  "(one whole merge in one grouped launch)"),
        "max_abs_err": 0.0,
        "ms": plan["ms"],
        "cold_ms": plan["cold_ms"],
        "plain_ms": plan["plain_ms"],
        "bound_ms": plan["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "plans": rows["plans"],
        "buckets": [{"n": n, **by_len[n]["avg"]} for n in MERGE_BUCKETS],
        "ragged": [{"n": n, **by_len[n]["avg"]} for n in MERGE_RAGGED],
        "sgd": {"max_abs_err": 0.0, "ms": total("sgd", "ms"),
                "cold_ms": total("sgd", "cold_ms"),
                "plain_ms": total("sgd", "plain_ms"),
                "bound_ms": total("sgd", "bound_ms")},
    }


def settings(torch) -> str:
    """f32 products stay f32 (no TF32) in this process; returns the card
    line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card_line()


def start(torch, sources=None) -> str:
    """f32 products stay f32; then phase 1: every kernel source (or the
    named ones), one nvcc each, all started together, logging the build
    time and ptxas's register, shared-memory and spill lines. Returns the
    card line."""
    from kubeml_tpu_torch.ops import _build

    card = settings(torch)
    t0 = time.perf_counter()
    logs = _build.build(sources)
    log(card, f"build: {len(logs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(card, f"ptxas {name}: {line.strip()}")
    return card


# Phases 10-28 run in three processes of this script side by side: this
# one and two lanes (``--lane DIR``) it starts after phase 1, which get
# ready while phases 2-9 (the kernels' own rows and times) run here and
# then wait for them. Most of the wall time of phases 10-28 goes to
# starting child processes (job servers, serve children, ranks: seconds
# of imports and first CUDA calls each) and to waiting on them, which
# the host's cores do side by side.
HERE_PHASES = (15, 16, 14, 23)
LANES = ((10, 17, 11, 12, 13, 18, 25, 28), (22, 24, 19, 20, 21, 26, 27))
LANE_S = 1000.0           # seconds a lane may take from its spawn


def _ph10(torch, card, seed, ctx):
    ctx["job_launches"], ctx["job_ms"] = phase_job(torch, card, seed,
                                                   ctx["engine_ms"])


def _ph12(torch, card, seed, ctx):
    ctx["cp_resnet"], ctx["cp_gpt"], ctx["cli_ref"] = phase_control(
        torch, card, seed)


def _ph13(torch, card, seed, ctx):
    ctx["cli"] = phase_cli(torch, card, seed, ctx.pop("cli_ref"))


def _ph24(torch, card, seed, ctx):
    ctx["sd"] = phase_syncdp_dist(
        torch, card, seed, {name: row["ms_per_step"][-1]
                            for name, row in ctx["sync"]["paths"].items()})


def _ph(key, fn, *names):
    """A phase that stores fn(torch, card, seed, *ctx[names]) at key."""
    def phase(torch, card, seed, ctx):
        ctx[key] = fn(torch, card, seed, *(ctx[n] for n in names))
    return phase


# phase -> what it runs; each reads and writes the run's context: what
# phases 1-9 left (module, direct, engine_ms) and the other phases' results
PHASES = {
    10: _ph10,
    11: _ph("vision_launches", phase_vision),
    12: _ph12,
    13: _ph13,
    14: _ph("ps_launches", phase_ps_serve, "module", "direct"),
    15: _ph("cluster", phase_cluster, "module", "direct"),
    16: _ph("degraded", phase_degraded),
    17: _ph("cost", phase_cost, "module", "job_ms"),
    18: _ph("continual", phase_continual),
    19: _ph("spec", phase_spec, "module", "direct"),
    20: _ph("text", phase_text),
    21: _ph("mv", phase_moe_vgg),
    22: _ph("sync", phase_syncdp),
    23: _ph("dist", phase_dist),
    24: _ph24,
    25: _ph("seq", phase_seq),
    26: _ph("ep", phase_ep, "mv"),      # after 21 in its lane
    27: _ph("tp", phase_tp),
    28: _ph("pp", phase_pp),
}
LANE_GIVEN = ("direct", "engine_ms")     # what a lane reads of phases 1-9


def run_phases(torch, card, seed, phases, ctx, walls, between=None):
    """Run ``phases`` in order, each phase's wall time kept in walls."""
    for phase in phases:
        t0 = time.perf_counter()
        PHASES[phase](torch, card, seed, ctx)
        walls[phase] = time.perf_counter() - t0
        if between is not None:
            between()


def lane_spawn(seed, phases) -> dict:
    """Start a lane (``--lane DIR``) for ``phases``, in its own process
    group. It starts up (imports, CUDA, its gpt-mini) and then waits for
    lane_go's DIR/in.pkl."""
    import os
    import tempfile

    tmp = tempfile.mkdtemp(prefix="kubeml_lane_")
    files = (open(os.path.join(tmp, "out.log"), "w"),
             open(os.path.join(tmp, "err.log"), "w"))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--lane", tmp], stdout=files[0], stderr=files[1], process_group=0)
    return {"proc": proc, "dir": tmp, "files": files, "shown": False,
            "phases": phases, "deadline": time.monotonic() + LANE_S}


def lane_go(lane, given) -> None:
    """Let the lane run its phases, with phases 1-9's results it needs
    (written whole before the lane sees the file)."""
    import os
    import pickle

    path = os.path.join(lane["dir"], "in.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump({"phases": lane["phases"], "given": given}, f)
    os.replace(path + ".tmp", path)


def lane_name(lane) -> str:
    return "the lane of phases " + ", ".join(map(str, lane["phases"]))


def lane_show(lane) -> None:
    """Copy the lane's output and errors to this process's, once."""
    import os

    if lane["shown"]:
        return
    lane["shown"] = True
    for name, stream in (("out.log", sys.stdout), ("err.log", sys.stderr)):
        with open(os.path.join(lane["dir"], name)) as f:
            stream.write(f.read())
        stream.flush()


def lane_check(lane) -> None:
    """Fail now if the lane has failed."""
    code = lane["proc"].poll()
    if code not in (None, 0):
        lane_show(lane)
        raise RuntimeError(f"{lane_name(lane)} exited {code}")


def lane_join(lane) -> dict:
    """Wait for the lane, show its output, and return its phases'
    results (and their walls under "walls")."""
    import os
    import pickle

    try:
        code = lane["proc"].wait(
            timeout=max(1.0, lane["deadline"] - time.monotonic()))
    except subprocess.TimeoutExpired:
        lane_stop(lane)
        raise RuntimeError(f"{lane_name(lane)} did not end within "
                           f"{LANE_S:g} s")
    lane_show(lane)
    if code != 0:
        raise RuntimeError(f"{lane_name(lane)} exited {code}")
    with open(os.path.join(lane["dir"], "result.pkl"), "rb") as f:
        return pickle.load(f)


def lane_stop(lane) -> None:
    """Stop the lane and everything it started (its process group), and
    remove its directory."""
    import os
    import shutil
    import signal

    proc = lane["proc"]
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    lane_show(lane)
    for f in lane["files"]:
        f.close()
    shutil.rmtree(lane["dir"], ignore_errors=True)


def plain_data(x):
    """``x`` with every tensor moved to the host, for pickling."""
    if isinstance(x, dict):
        return {k: plain_data(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(plain_data(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(plain_data(v) for v in x)
    if hasattr(x, "detach"):
        return x.detach().cpu()
    return x


def lane_run(torch, seed, tmp) -> int:
    """A lane's process: started while phases 2-9 run, it gets ready and
    waits for DIR/in.pkl, then runs its phases on the card with the
    kernels phase 1 built and pickles their results to DIR/result.pkl. It
    ends its process group when the process that started it is gone."""
    import os
    import pickle
    import signal
    import threading

    parent = os.getppid()

    def orphaned():
        while os.getppid() == parent:
            time.sleep(1.0)
        os.killpg(0, signal.SIGKILL)

    threading.Thread(target=orphaned, daemon=True).start()
    card = settings(torch)
    module = build_gpt(torch, PS_MODEL, seed, torch.bfloat16, "cuda")
    import torch._dynamo  # noqa: F401 — torch.optim's first call imports it
    path = os.path.join(tmp, "in.pkl")
    while not os.path.exists(path):     # phases 1-9 still running
        time.sleep(0.1)
    with open(path, "rb") as f:
        spec = pickle.load(f)
    ctx = dict(spec["given"], module=module)
    walls = {}
    run_phases(torch, card, seed, spec["phases"], ctx, walls)
    out = {k: v for k, v in ctx.items() if k not in ("module", *spec["given"])}
    with open(os.path.join(tmp, "result.pkl"), "wb") as f:
        pickle.dump({"walls": walls, **plain_data(out)}, f)
    return 0


def run(torch, seed) -> list:
    t_run = time.perf_counter()
    clock = [t_run]
    walls = {}

    def timed(phase, fn, *args):
        """fn(*args), its wall time kept under the phase's number."""
        out = fn(*args)
        now = time.perf_counter()
        walls[phase] = walls.get(phase, 0.0) + now - clock[0]
        clock[0] = now
        return out

    card = timed(1, start, torch)
    # the lanes of phases 10-28 start up now and wait until phase 9 ends
    lanes = []
    try:
        for phases in LANES:
            lanes.append(lane_spawn(seed, phases))
        return run_rest(torch, seed, card, lanes, t_run, timed, walls)
    finally:
        for lane in lanes:
            lane_stop(lane)


def run_rest(torch, seed, card, lanes, t_run, timed, walls) -> list:
    """run() from phase 2 on, the lanes started."""
    rows = timed(2, phase_kernels, torch, card, seed)

    module = build_gpt(torch, "gpt-mini", seed, torch.bfloat16, "cuda")
    # the main paths: one batch served with bf16 KV pages ("f32" keeps the
    # module's dtype), one with int8 pages; each launches its own
    # instantiation of the kernel and is counted on its own
    direct = {pages: timed(3, phase_serve, torch, card, seed, module, kv)
              for pages, kv in (("bf16", "f32"), ("int8", "int8"))}
    launches = {pages: d["launches"] for pages, d in direct.items()}

    timed(4, phase_check, torch, card, seed)
    timed(5, phase_trace, torch, card, seed, module)

    flash = timed(6, phase_flash, torch, card, seed)
    train_launches, engine_ms = timed(7, phase_train, torch, card, seed)
    timed(7, phase_train_check, torch, card, seed)
    timed(8, phase_train_trace, torch, card, seed)

    merge_rows = timed(9, phase_merge_kernel, torch, card, seed)
    merge_launches, engines = timed(9, phase_merge_train, torch, card,
                                    seed)
    timed(9, phase_merge_check, torch, card, seed)
    timed(9, phase_merge_trace, torch, card, seed, engines)
    del engines
    # phases 10-28: these here, the rest in the two lanes beside them
    ctx = {"module": module, "direct": direct, "engine_ms": engine_ms}
    for lane in lanes:
        lane_check(lane)
        lane_go(lane, {k: ctx[k] for k in LANE_GIVEN})

    def check():
        for lane in lanes:
            lane_check(lane)
    here = {}
    run_phases(torch, card, seed, HERE_PHASES, ctx, here, check)
    t_here = time.perf_counter()
    got = [lane_join(lane) for lane in lanes]
    walls.update(here)
    waited = time.perf_counter() - t_here
    for g in got:
        walls.update(g.pop("walls"))
        ctx.update(g)
    (job_launches, vision_launches, cp_resnet, cp_gpt, cli, ps_launches,
     cluster, degraded, cost, continual, spec, text, mv, sync, dist, sd,
     seq, ep, tp, pp) = (ctx[k] for k in (
         "job_launches", "vision_launches", "cp_resnet", "cp_gpt", "cli",
         "ps_launches", "cluster", "degraded", "cost", "continual", "spec",
         "text", "mv", "sync", "dist", "sd", "seq", "ep", "tp", "pp"))
    log(card, "wall by phase (s), 10-28 in three processes side by side: "
        + ", ".join(f"{p}: {walls[p]:.3f}" for p in sorted(walls))
        + "; " + "; ".join(
            f"phases {', '.join(map(str, ph))}: "
            f"{sum(walls[p] for p in ph):.3f}"
            for ph in (HERE_PHASES, *LANES))
        + f"; this process waited {waited:.3f} for the lanes after its "
        f"own; the run {time.perf_counter() - t_run:.3f}")
    drafts = ("self-draft", "other-draft")

    paged = [{
        "name": f"paged_attention ({pages} pages)",
        "route": "cuda",
        "source": "kubeml_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "kubeml_tpu/ops/pallas/paged_attention.py:73",
        "launches": n,
        "ps_launches": ps_launches[pages],
        # phase 15 serves with bf16 pages only
        "cluster_launches": cluster["paged"] if pages == "bf16" else None,
        "degraded_launches": 0,      # phase 16 serves nothing
        # phase 17 serves with bf16 pages only
        "cost_launches": cost["paged_attention"] if pages == "bf16"
        else None,
        # phase 18 serves with bf16 pages only
        "continual_launches": continual["paged_attention"]
        if pages == "bf16" else None,
        # phase 19: the multi-step run, the two speculative runs, and
        # (bf16 pages only) the run through POST /generate
        "multi_launches": spec[pages]["multi"]["paged"],
        "spec_launches": sum(spec[pages][m]["paged"] for m in drafts),
        "spec_ps_launches": spec["ps"]["paged"] if pages == "bf16"
        else None,
        # phase 20 (d): the page-12 engine's run, and the kernel at page
        # sizes off its 8-token slices
        "text_launches": text["ragged_engine"][pages]["launches"],
        "ragged_pages": [r for (p, *_), r in text["ragged"].items()
                         if p == pages],
        "moe_vgg_launches": 0,       # phase 21 serves nothing
        "syncdp_launches": 0,        # phase 22 serves nothing
        "dist_launches": 0,          # phase 23 serves nothing
        "syncdp_dist_launches": 0,   # phase 24 serves nothing
        "seq_launches": 0,           # phase 25 serves nothing
        "ep_launches": 0,            # phase 26 serves nothing
        "tp_launches": 0,            # phase 27 serves nothing
        "pp_launches": 0,            # phase 28 serves nothing
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
        "cli_launches": [e[kernel] for e in cli["gpt_launches"]],
        "cluster_launches": cluster[kernel],
        "degraded_launches": degraded[kernel],
        "cost_launches": cost[kernel],
        "continual_launches": continual[kernel],
        # phase 19: the drafts' forwards (B=8, T=512) of both page types'
        # speculative runs, and of the run through POST /generate
        "spec_launches": sum(spec[p][m]["flash_forward"]
                             for p in ("bf16", "int8") for m in drafts)
        if kernel == "forward" else 0,
        "spec_ps_launches": spec["ps"]["flash_forward"]
        if kernel == "forward" else 0,
        # phase 20: bert-tiny's job per epoch, and the kernel not causal
        # at its shapes
        "text_launches": [e[kernel] for e in
                          text["bert-tiny"]["launches"]],
        "noncausal": [r for (_, k), r in text["noncausal"].items()
                      if k == kernel],
        # phase 21: gpt-moe-mini's job per epoch (vgg11 has no attention)
        "moe_vgg_launches": [e[kernel] for e in
                             mv["gpt-moe-mini"]["launches"]],
        # phase 22: each gradient path's dispatches, the skipped
        # dispatch, the syncdp job's epochs
        "syncdp_launches": sync_launches(sync, kernel),
        "syncdp_shapes": [r for (_, k), r in sync["flash"].items()
                          if k == kernel],
        # phase 23: the rounds over one NCCL rank and two gloo ranks, the
        # two-rank job per rank and in one process
        "dist_launches": dist_launches(dist, kernel),
        # phase 24: the counted dispatch per path over one NCCL rank and
        # two gloo ranks, the two-rank syncdp jobs per rank
        "syncdp_dist_launches": sd_launches(sd, kernel),
        # phase 25: the seq rounds per rank (ring, Ulysses; bf16, f32),
        # the dense round in one process, the two-rank seq job per rank;
        # and (a)'s rows at the ring's block shapes
        "seq_launches": seq_launches(seq, kernel),
        "seq_shapes": [r for (_, k), r in seq["shapes"].items()
                       if k == kernel],
        # phase 26: the expert ranks' rounds per rank (per dtype, and the
        # seq x expert and seq rounds), the one-process rounds, the
        # two-rank job per rank
        "ep_launches": ep_launches(ep, kernel),
        # phase 27: the model ranks' rounds per rank (per model and dtype,
        # the model x seq round, the NCCL rank's), the one-process
        # rounds, the two-rank job per rank; and (a)'s rows at the local
        # head counts
        "tp_launches": tp_launches(tp, kernel),
        "tp_shapes": [r for (_, k), r in tp["shapes"].items()
                      if k == kernel],
        # phase 28: the stage ranks' rounds per rank (per model and dtype,
        # at dropout 0, stage 4, stage x expert), the one-process rounds
        # (the sequential schedule and the dense round), the two-rank job
        # per rank; and (a)'s rows at the microbatch shapes
        "pp_launches": pp_launches(pp, kernel),
        "pp_shapes": [r for (_, k), r in pp["shapes"].items()
                      if k == kernel],
        "shape": f"B={FA_B} T={main[2]} H={FA_H} D={FA_D} causal",
        **flash[(main[0], kernel)],
    } for kernel, line in (("forward", 80), ("dK/dV", 228), ("dQ", 281))] \
        + [dict(merge_entry(merge_rows, merge_launches),
                job_launches=[e["fused_merge"] for e in job_launches],
                deployment_launches={
                    "gpt-mini": [e["fused_merge"] for e in cp_gpt],
                    "resnet18": cp_resnet},
                cli_launches={
                    "gpt-mini": [e["fused_merge"]
                                 for e in cli["gpt_launches"]],
                    "resnet18": cli["launches"]},
                cluster_launches=cluster["fused_merge"],
                degraded_launches=degraded["fused_merge"],
                cost_launches=cost["fused_merge"],
                continual_launches=sum(continual["fused_merge"].values()),
                continual_launches_by_model=continual["fused_merge"],
                spec_launches=0, spec_ps_launches=0,
                text_launches={name: [e["fused_merge"] for e in
                                      text[name]["launches"]]
                               for name in TEXT_JOBS},
                # phase 20: each text model's own 4 MB bucket plan
                text_buckets={name: [{"n": n, **text[name]["merge"][n]["avg"]}
                                     for n in text[name]["bucket_lengths"]]
                              for name in TEXT_JOBS},
                # phase 21: both models' jobs per epoch, and #5 at each
                # bucket length of their 4 MB plans
                moe_vgg_launches={name: [e["fused_merge"] for e in
                                         mv[name]["launches"]]
                                  for name in MV_MODELS},
                moe_vgg_buckets={name: [{"n": n, **mv[name]["merge"][n]["avg"]}
                                        for n in mv[name]["bucket_lengths"]]
                                 for name in MV_MODELS},
                # phase 22: launches and segments on each gradient path,
                # and the grouped launch at SyncDP's call (count 1)
                syncdp_launches=sync_launches(sync, "fused_merge"),
                syncdp_segments=sync_launches(sync, "merge segments"),
                syncdp_count1=sync["count1"],
                # phase 23: launches and segments of the ranks' rounds and
                # job (one launch a merge on every rank)
                dist_launches=dist_launches(dist, "fused_merge"),
                dist_segments=dist_launches(dist, "merge segments"),
                # phase 24: launches and segments of the SyncDP ranks'
                # explicit paths and jobs (one launch a step on each rank)
                syncdp_dist_launches=sd_launches(sd, "fused_merge"),
                syncdp_dist_segments=sd_launches(sd, "merge segments"),
                # phase 25: the seq ranks' merges (one lane group a data
                # rank: one launch a merge on each rank) and the job's
                seq_launches=seq_launches(seq, "fused_merge"),
                seq_segments=seq_launches(seq, "merge segments"),
                # phase 26: the expert ranks' merges (one launch a merge on
                # each rank) and the job's
                ep_launches=ep_launches(ep, "fused_merge"),
                ep_segments=ep_launches(ep, "merge segments"),
                # phase 27: the model ranks' merges (one launch a merge on
                # each rank) and the job's
                tp_launches=tp_launches(tp, "fused_merge"),
                tp_segments=tp_launches(tp, "merge segments"),
                # phase 28: the stage ranks' merges (one launch a merge on
                # each rank) and the job's
                pp_launches=pp_launches(pp, "fused_merge"),
                pp_segments=pp_launches(pp, "merge segments"),
                resnet18=dict(merge_rows["plans"]["resnet18"],
                              launches_per_epoch=vision_launches))], card


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    ap.add_argument("--paged-only", action="store_true",
                    help="build the kernels and run phase 2 alone, then "
                         "print its rows as one JSON line and no result "
                         "line (the paged twin of --flash-only)")
    ap.add_argument("--vision-job-only", action="store_true",
                    help="build the fused merge and run phase 11's "
                         "ResNet-18 job alone (two cached epochs, one "
                         "host-staged), printing its rows as one JSON line "
                         "and no result line (to time two trees' jobs in "
                         "one run, as --flash-only)")
    ap.add_argument("--serve-only", action="store_true",
                    help="build the paged kernel and run phases 3 and 14 "
                         "alone (serving direct and through the PS), "
                         "printing their numbers as one JSON line and no "
                         "result line")
    ap.add_argument("--cluster-only", action="store_true",
                    help="build the kernels and run phases 3 (bf16 pages) "
                         "and 15 alone (the cluster-mode deployment, its "
                         "kill and restart), printing the launches through "
                         "it as one JSON line and no result line")
    ap.add_argument("--degraded-only", action="store_true",
                    help="build the flash and merge kernels and run phase "
                         "16 alone (degraded-mode training and the "
                         "preemption of training jobs), printing its "
                         "launches as one JSON line and no result line")
    ap.add_argument("--cost-only", action="store_true",
                    help="build the kernels and run phase 17 alone (the "
                         "cost ledger and the runtime metrics through a "
                         "threaded job, a job-server child and a 2-replica "
                         "fleet), printing its launches as one JSON line "
                         "and no result line")
    ap.add_argument("--continual-only", action="store_true",
                    help="build the kernels and run phase 18 alone (the "
                         "continual mode: appends while a gpt-mini job "
                         "trains and publishes into a live fleet, and a "
                         "ResNet-18 job's incremental cache refresh), "
                         "printing its launches as one JSON line and no "
                         "result line")
    ap.add_argument("--spec-only", action="store_true",
                    help="build the kernels and run phases 3 and 19 alone "
                         "(multi-step and speculative decode, direct and "
                         "through POST /generate), printing their "
                         "launches as one JSON line and no result line")
    ap.add_argument("--text-only", action="store_true",
                    help="build the kernels and run phase 20 alone (the "
                         "text classifiers' jobs, the non-causal flash "
                         "kernels at BERT-tiny's shapes and the paged "
                         "kernel's ragged pages), printing its launches "
                         "as one JSON line and no result line")
    ap.add_argument("--moe-vgg-only", action="store_true",
                    help="build the kernels and run phase 21 alone "
                         "(gpt-moe-mini and vgg11 trained on the card, "
                         "the fused merge at their plans), printing its "
                         "launches as one JSON line and no result line")
    ap.add_argument("--syncdp-only", action="store_true",
                    help="build the flash and merge kernels and run phase "
                         "22 alone (the SyncDP engine: each gradient path "
                         "at gpt-mini's widths, card vs CPU, #5 at its "
                         "count-1 call, a skipped step, a job), printing "
                         "its launches and rows as one JSON line and no "
                         "result line")
    ap.add_argument("--dist-only", action="store_true",
                    help="build the flash and merge kernels and run phase "
                         "23 alone (data lanes as ranks: one NCCL rank, two "
                         "gloo ranks on the card, a two-rank job), printing "
                         "its launches and times as one JSON line and no "
                         "result line")
    ap.add_argument("--syncdp-dist-only", action="store_true",
                    help="build the flash and merge kernels and run phase "
                         "24 alone (the SyncDP engine over ranks: one NCCL "
                         "rank, two gloo ranks with ZeRO-1/FSDP shards, two "
                         "two-rank jobs, the gloo probes), printing its "
                         "launches and numbers as one JSON line and no "
                         "result line")
    ap.add_argument("--lane", metavar="DIR",
                    help="run the phases DIR/in.pkl names, with the "
                         "kernels already built, and pickle their results "
                         "to DIR/result.pkl (the full run starts two such "
                         "lanes itself after phase 1)")
    ap.add_argument("--seq-only", action="store_true",
                    help="build the flash and merge kernels and run phase "
                         "25 (sequence parallelism over two gloo ranks) "
                         "alone")
    ap.add_argument("--ep-only", action="store_true",
                    help="build the flash and merge kernels and run phase "
                         "26 (expert parallelism over two and four gloo "
                         "ranks) alone")
    ap.add_argument("--tp-only", action="store_true",
                    help="build the flash and merge kernels and run phase "
                         "27 (tensor parallelism over two and four gloo "
                         "ranks and one NCCL rank) alone")
    ap.add_argument("--pp-only", action="store_true",
                    help="build the flash and merge kernels and run phase "
                         "28 (pipeline parallelism over two and four gloo "
                         "ranks and one NCCL rank) alone")
    ap.add_argument("--merge-only", action="store_true",
                    help="build the fused merge and time, through calls "
                         "every tree of the port has, the one-segment "
                         "launch at every bucket length of every model's "
                         "plan and one lane_merge's host time and device "
                         "memory at four models' plans, printing the rows "
                         "as one JSON line and no result line (to compare "
                         "two trees' merges in one run, as --flash-only)")
    ap.add_argument("--step-only", action="store_true",
                    help="build the kernels and run phases 3 (bf16 pages) "
                         "and 7 alone, printing phase 3's tokens/s and "
                         "phase 7's ms per local step as one JSON line and "
                         "no result line (to time two trees' model code in "
                         "one run)")
    ap.add_argument("--flash-only", action="store_true",
                    help="build the kernels and run phase 6 alone, then "
                         "print its rows as one JSON line and no result "
                         "line (to compare two trees' flash kernels in one "
                         "session: copy this script into each tree and run "
                         "it there)")
    args = ap.parse_args(argv)
    import os

    # Python may run with PYTHONDONTWRITEBYTECODE beside a torch installed
    # without bytecode: then every process (this one and each job, serve
    # and CLI child) compiles torch's sources anew, at its import and at
    # its first optimizer's (torch._dynamo). The bytecode goes to a cache
    # beside this script instead, for this process and, through the
    # environment, for every child.
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    sys.dont_write_bytecode = False
    sys.pycache_prefix = cache
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
        if args.lane:
            return lane_run(torch, args.seed, args.lane)
        if args.paged_only:
            card = start(torch, ["paged_attention"])
            rows = phase_kernels(torch, card, args.seed)
            print(json.dumps({"card": card, "paged": [
                {"pages": p, "S": S, "T": T, **r}
                for (p, S, T), r in rows.items()]}))
            return 0
        if args.serve_only:
            card = start(torch, ["paged_attention"])
            module = build_gpt(torch, PS_MODEL, args.seed, torch.bfloat16,
                               "cuda")
            direct = {p: phase_serve(torch, card, args.seed, module, kv)
                      for p, kv in (("bf16", "f32"), ("int8", "int8"))}
            ps = phase_ps_serve(torch, card, args.seed, module, direct)
            print(json.dumps({"card": card, "serve": {
                p: {"launches": d["launches"], "ps_launches": ps[p],
                    "tokens_per_s": d["tokens_per_s"],
                    "ttft_ms": d["ttft_ms"]} for p, d in direct.items()}}))
            return 0
        if args.cluster_only:
            card = start(torch)
            module = build_gpt(torch, PS_MODEL, args.seed, torch.bfloat16,
                               "cuda")
            direct = {"bf16": phase_serve(torch, card, args.seed, module,
                                          "f32")}
            print(json.dumps({"card": card, "cluster": phase_cluster(
                torch, card, args.seed, module, direct)}))
            return 0
        if args.degraded_only:
            card = start(torch, ["flash_attention", "fused_merge"])
            print(json.dumps({"card": card, "degraded": phase_degraded(
                torch, card, args.seed)}))
            return 0
        if args.cost_only:
            card = start(torch)
            module = build_gpt(torch, PS_MODEL, args.seed, torch.bfloat16,
                               "cuda")
            print(json.dumps({"card": card, "cost": phase_cost(
                torch, card, args.seed, module)}))
            return 0
        if args.continual_only:
            card = start(torch)
            print(json.dumps({"card": card, "continual": phase_continual(
                torch, card, args.seed)}))
            return 0
        if args.spec_only:
            card = start(torch, ["paged_attention", "flash_attention"])
            module = build_gpt(torch, PS_MODEL, args.seed, torch.bfloat16,
                               "cuda")
            direct = {p: phase_serve(torch, card, args.seed, module, kv)
                      for p, kv in (("bf16", "f32"), ("int8", "int8"))}
            print(json.dumps({"card": card, "spec": phase_spec(
                torch, card, args.seed, module, direct)}))
            return 0
        if args.text_only:
            card = start(torch)
            text = phase_text(torch, card, args.seed)
            print(json.dumps({"card": card, "text": {
                "launches": {n: text[n]["launches"] for n in TEXT_JOBS},
                "ms_per_step": {n: text[n]["ms_per_step"]
                                for n in TEXT_JOBS},
                "ragged_engine": text["ragged_engine"],
                "noncausal": [dict(kernel=k, **r) for (_, k), r in
                              text["noncausal"].items()],
                "ragged": [dict(pages=p, **r) for (p, *_), r in
                           text["ragged"].items()]}}))
            return 0
        if args.moe_vgg_only:
            card = start(torch)
            mv = phase_moe_vgg(torch, card, args.seed)
            print(json.dumps({"card": card, "moe_vgg": {
                name: {"launches": mv[name]["launches"],
                       "ms_per_step": mv[name]["ms_per_step"],
                       "bucket_lengths": mv[name]["bucket_lengths"]}
                for name in MV_MODELS}}))
            return 0
        if args.syncdp_only:
            card = start(torch, ["flash_attention", "fused_merge"])
            sync = phase_syncdp(torch, card, args.seed)
            print(json.dumps({"card": card, "syncdp": {
                "launches": {k: sync_launches(sync, k)
                             for k in (*SYNC_FLASH, "fused_merge",
                                       "merge segments")},
                "ms_per_step": {n: r["ms_per_step"]
                                for n, r in sync["paths"].items()},
                "count1": sync["count1"],
                "flash": {f"{p} {k}": r for (p, k), r in
                          sync["flash"].items()},
                "job": {k: v for k, v in sync["job"].items()
                        if k != "launches"}}}))
            return 0
        if args.dist_only:
            card = start(torch, ["flash_attention", "fused_merge"])
            print(json.dumps({"card": card, "dist": phase_dist(
                torch, card, args.seed)}))
            return 0
        if args.syncdp_dist_only:
            card = start(torch, ["flash_attention", "fused_merge"])
            print(json.dumps({"card": card, "syncdp_dist": phase_syncdp_dist(
                torch, card, args.seed)}))
            return 0
        if args.seq_only:
            card = start(torch, ["flash_attention", "fused_merge"])
            seq = phase_seq(torch, card, args.seed)
            print(json.dumps({"card": card, "seq": {
                "shapes": [dict(case=c, kernel=k, **r) for (c, k), r in
                           seq["shapes"].items()],
                "launches": {k: seq_launches(seq, k) for k in
                             ("forward", "dK/dV", "dQ", "fused_merge",
                              "merge segments")}}}))
            return 0
        if args.ep_only:
            card = start(torch, ["flash_attention", "fused_merge"])
            ep = phase_ep(torch, card, args.seed)
            print(json.dumps({"card": card, "ep": {
                "launches": {k: ep_launches(ep, k) for k in
                             ("forward", "dK/dV", "dQ", "fused_merge",
                              "merge segments")}}}))
            return 0
        if args.tp_only:
            card = start(torch, ["flash_attention", "fused_merge"])
            tp = phase_tp(torch, card, args.seed)
            print(json.dumps({"card": card, "tp": {
                "shapes": [dict(case=c, kernel=k, **r) for (c, k), r in
                           tp["shapes"].items()],
                "launches": {k: tp_launches(tp, k) for k in
                             ("forward", "dK/dV", "dQ", "fused_merge",
                              "merge segments")}}}))
            return 0
        if args.pp_only:
            card = start(torch, ["flash_attention", "fused_merge"])
            pp = phase_pp(torch, card, args.seed)
            print(json.dumps({"card": card, "pp": {
                "shapes": [dict(case=c, kernel=k, **r) for (c, k), r in
                           pp["shapes"].items()],
                "launches": {k: pp_launches(pp, k) for k in
                             ("forward", "dK/dV", "dQ", "fused_merge",
                              "merge segments")}}}))
            return 0
        if args.vision_job_only:
            card = start(torch, ["fused_merge"])
            phase_vision(torch, card, args.seed, job_only=True)
            return 0
        if args.merge_only:
            card = start(torch, ["fused_merge"])
            print(json.dumps({"card": card, "merge": phase_merge_only(
                torch, card, args.seed)}))
            return 0
        if args.step_only:
            card = start(torch)
            module = build_gpt(torch, PS_MODEL, args.seed, torch.bfloat16,
                               "cuda")
            serve = phase_serve(torch, card, args.seed, module, "f32")
            _, engine_ms = phase_train(torch, card, args.seed)
            print(json.dumps({"card": card, "tokens_per_s":
                              serve["tokens_per_s"], "ms_per_step":
                              engine_ms}))
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
