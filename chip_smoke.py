#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``elasticdl_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — the card, its power limit, the CUDA toolkit.
2. build   — every kernel under ``elasticdl_tpu_torch/ops/csrc`` built
   from source with nvcc for sm_90a, all at once (the ptxas report kept
   beside each library is printed; a spill in a bf16 kernel, or a report
   that does not list them, fails).
3. kernels — each kernel against its plain PyTorch version on the card,
   at the listed shapes, with times, the bound and the library yardstick:
   flash_fwd, then flash_bwd_dq and flash_bwd_dkv (with and without an
   lse cotangent), each also at a ragged length and at Lq != Lk, two
   launches of each case bitwise equal; then a long-sequence check that
   the backward allocates no (L, L) buffer. Each output and gradient is
   held elementwise and by its relative L2 distance, and each case shows
   that a planted fault (a mask one tile off, a 10 % scale error) fails.
   Forward times are taken twice: CUDA events around 50 calls of the
   autograd wrapper, and the device time per call from torch.profiler
   (the kernel's own, even where the host's enqueue time per call nears
   it), both for SDPA too.
4. slice   — the transformer LM at bench.py's 110M widths cut to 6 layers
   (bf16, random weights from a seed)
   exported with its serving member (``torch.export`` of the module on
   the card, the flash forward a registered op in its graph), then
   served through the scorer's entry points (build_scorer ->
   ScorerServicer's instrumented handlers -> MicroBatcher -> Scorer ->
   the member) on concurrent 1024-token requests, behind a
   ``ScorerServer`` whose telemetry endpoint (``--scorer_telemetry_port
   0``) is scraped mid-round: ``/metrics`` shows the server's service
   histogram (``role="scorer"``, one count per request), the scorer's
   and the batcher's families, ``/healthz`` reads ``serving``; the same
   round with the telemetry plane off (``EDL_METRICS=0``'s switch)
   replies bitwise alike with the same launches. The graph holds 6
   flash op nodes; kernel
   launches are counted over the served requests alone (6 forward, 0
   backward per forward). The same requests go through a second scorer
   over a params-only artifact of the same weights (the module rebuilt
   from the manifest), the two in turns (member, rebuilt, rebuilt,
   member): p50 / p99 both ways, and each member reply held against the
   rebuilt one's. Replies are also checked against solo
   scoring and against the rebuilt model with attention swapped for the
   plain version. A small member (the LM at two layers) written on the
   CPU is served on the card, where it launches the kernel, and held
   against the same weights' member written on the card. Then a
   torch.profiler breakdown of one batched forward through the member.
5. train   — the same model trained through AllReduceTrainer.train_step
   (AdamW, 16 x 1024-token batches): finite losses, a finite, nonzero
   gradient for every parameter, 6 launches of each kernel per step;
   gradients against the plain-attention model and against
   plain_flash_bwd on the same forward; one rematerialized step; step
   time, tokens/s, MFU, peak memory and a profiler breakdown of one step.
6. moe     — the mixture-of-experts LM at Switch-Base-8's widths (d 768,
   d_ff 3072, 8 experts, top-1, capacity factor 2, balance loss 0.01; the
   slice's vocabulary, bf16 compute, 4 layers) on the card, its MLP the
   dense fallback: trained through AllReduceTrainer.train_step (AdamW,
   16 x 1024-token batches): finite losses and gradients, the balance
   loss in every block's ``aux_loss`` entry and in the loss, 4 launches
   of each kernel a step; the first step (from the seeded init) records
   its routing, and its gradient reaches every parameter and exactly the
   experts routed a token (an expert routed none gets exactly zero);
   from the seeded init the kernels' gradients against plain
   attention's, the plain forward routed as the kernels' was (5e-2
   relative L2 each; the freely routed comparison and the tokens whose
   top-1 expert bf16 rounding moved are reported); step time, tokens/s,
   peak memory. Then the trained weights' member served behind a
   ``ScorerServer`` on 16 one-row requests, 4 forward launches a
   forward, its replies within 0.1 of the module the scorer rebuilds
   from a params-only artifact of the same weights; p50 / p99.
7. ring    — the sequence axis: two ``--ring-rank`` processes, started
   before the moe phase so that they boot while it runs, share the
   card in a gloo world (a mesh of data 1 x seq 2); each runs the LM at
   SLICE_CFG's widths cut to 2 layers on its 1,024-token shard of B = 2
   x 2,048 (global rotary positions, the ring of flash kernels, the
   shifted next-token targets, the gradients summed over ``seq``): the
   counted step launches 1 forward a layer on rank 0 and 2 on rank 1,
   and as many of each backward kernel; the loss and every gradient,
   gathered, against this process on the whole 2,048 (the flash kernels,
   the same weights; 1e-2 and 5e-2); per rank, every block the kernels
   ran against its plain version on the same inputs and the kernel
   ring's out, dq, dk, dv against the plain ring's (2e-2 relative L2);
   in the same ranks, a 1-layer MoE LM with 2 experts routed over an
   ``expert`` group of the two against its dense fallback (logits 0.1,
   gradients 5e-2). Each rank's step time, and what its host staging
   (every K/V rotation and all-reduce through a host buffer: gloo
   moves no CUDA tensor between processes) costs in bytes and seconds,
   by kind of exchange. Then, in the same ranks and world, tensor
   parallelism: ``mesh_axes(2, tensor_parallel=2)`` -> a mesh of data 1
   x model 2 -> ``build_distributed_model`` / ``param_shardings`` ->
   ``AllReduceTrainer`` (the whole model drawn from the seed, each rank
   keeping its 6 heads, 1,536 hidden units and 16,384 vocabulary rows)
   on B 4 x 1,024 tokens: the counted AdamW step launches each kernel
   once a layer on each rank (at H = 6), its gathered gradients and
   loss against this process's whole model on the same weights and
   batch (5e-2 and 1e-2); 3 timed steps with their staging; each rank's
   parameter bytes (at most 0.55 of the whole's) and peak memory; the
   gathered logits against the whole model's forward on the card (0.1);
   both ranks' ``save_sharded``, which this process's
   ``load_sharded_to_host`` must read back bitwise the gathered state,
   and the whole model restored from it answering the batch through
   the flash forward (a launch a layer) within 0.1 of the TP logits.
   Then, in the same two ranks (their world left, a new one formed by
   ``ElasticDPTrainer.establish``), the collective plane's step:
   deepfm_edl at the zoo's widths (tables of 1,048,576 x 64 and x 1,
   f32) through ``build_collective_model`` on data 2, each rank holding
   half of each table drawn whole from the seed, PS_BATCH zipf records
   a rank (``_zipf_ids``, as the Z cells draw them): one counted SGD
   step (no flash launch: ``launches_by_path.collective_rank0/1``), its
   loss, the touched rows of both tables and the tower against this
   process's whole model stepped on both ranks' rows (1e-5 relative
   L2), the overflow count (0), the routed unique ids against their
   occurrences, then 3 timed steps with their staging by kind of
   exchange, each rank's table bytes and peak memory.
8. job     — bench.py's fused ResNet-50 step (b128, 224x224, bf16, SGD
   with momentum, data resident on the card): step time, examples/s,
   MFU, peak memory. Then the single-process ALLREDUCE job through the
   port's command line in this process (master -> task dispatcher ->
   AllReduceWorker -> RecordIO reader) on 896 synthetic ImageNet-shaped
   records from the seed: the dispatcher finishes at version 14, every
   loss and parameter finite, every batch statistic moved, the newest
   checkpoint restores bitwise into a fresh trainer, the export manifest
   exists, and its serving member, served on the card on 64 images from
   the seed, is within 1e-2 relative L2 of the direct forward of the
   newest checkpoint (its running statistics) and further than that from
   the export's parameters with fresh statistics (what a rebuild from
   ``model.chkpt`` would serve); the bf16 model held against the f32 one
   on one batch; the
   job's examples/s over its steps after the first and its ratio to the
   fused step; a torch.profiler breakdown of a few steps of a second run
   (idle share, top device ops, the largest device-idle gaps). ResNet-50
   launches none of the flash kernels: the kernels line says so
   (``launches_by_path.job`` = 0).
9. eval    — the evaluation plane on the same model and records, through
   the port's command line: the job again with 256 validation records
   from the seed and ``--evaluation_steps 4`` (three rounds, pinned to
   versions 4, 8 and 12, each over all 256 records and within 2/256 of
   a direct forward of its checkpoint restored into a fresh model; the
   job's examples/s against the job phase's, and the rounds' seconds);
   ``evaluate`` on the same images labelled from the final checkpoint's
   own predictions, half of them off by one, from the checkpoint (0.5
   within 2/256) and from the export (the direct fresh-statistics
   forward's accuracy); ``predict`` with a capturing processor (every
   record once, within 1e-2 relative L2 of the direct forward). The
   training job runs with ``--tensorboard_log_dir``: the rounds' metrics
   read back from the evaluation service's event file at their versions,
   and the registry's scalars from the exporter's ``*.telemetry`` file
   (``common/tb_events.read_events``). No flash kernel launches
   (``launches_by_path.eval`` = 0).
10. zoo     — the zoo models that need no PS fleet, each at its zoo width
   through the port's command line: mnist_functional_api,
   cifar10_subclass and cifar10_functional_api (b64, 1,024 training and
   256 validation records), resnet50_subclass (float32, b64, 256
   224x224 uint8 records, 128 validation records), deepfm_functional_api
   and deepfm_edl_embedding (its tables on the HBM plane) with 1,048,576 x
   64 tables (b1024 of 10 ids, a tenth of them 0; 16,384 training and
   4,096 validation records). Each trains with ``--validation_data``
   (a round and a checkpoint every 8 versions, every 2 for ResNet-50):
   the version equals the steps, every loss is finite, the newest
   checkpoint restores bitwise into a fresh model, each round is within
   2 records (accuracy) and 1e-2 relative L2 (outputs) of a direct
   forward of its checkpoint; each artifact carries the serving member
   (DeepFM-edl's too: on the HBM plane its rows are in the graph, and
   the reference's ALLREDUCE worker writes one for it as well);
   ``evaluate --checkpoint_dir`` reads the
   newest checkpoint's direct accuracy; ``predict`` with a capturing
   processor yields every record once within 1e-2 relative L2. Then
   each model's forward and one SGD step on the card against the CPU
   from one init and batch, dropout the identity (outputs and loss 1e-4,
   each parameter's update 1e-3, relative L2); DeepFM on the HBM plane
   ten steps on the card against ten on the CPU (rtol 2e-4, atol 2e-5),
   its table a CUDA parameter of 1,048,576 x 64, and a torch.profiler
   breakdown of three more steps (idle share, top device ops, the
   embedding backward's share); cifar10_subclass through the two-worker
   elastic job for one epoch on 2,304 records (every task once, equal
   final bits). Job examples/s after the first step, peak memory and the
   rounds' seconds are recorded. No flash kernel launches
   (``launches_by_path.zoo`` = 0).
11. ps      — the ParameterServerStrategy job on the master-held model
   through the port's command line with no strategy flag. P1: DeepFM at
   its zoo width with both tables on the PS plane (the master's store),
   b1024 on 16,384 training and 4,096 validation records (ids from
   1,048,576, a tenth 0), sync, a round and a checkpoint every 8
   versions, ``--output``, then ``evaluate`` from the export: every task
   done once, the version equal to the accepted gradients, finite losses,
   the store holding exactly the ids seen, the newest checkpoint restoring
   the held model and the tables bitwise, the export without a serving
   member (the elastic layers' rows are pulled outside the graph, as in
   the reference), ``evaluate`` reading the last round's metrics;
   examples/s after the first step, the step's split
   (``get_model``, plan, the rows' pull, compute with its CUDA-event
   time, ``report_gradient`` with the master's apply, the host's parse),
   the master's dense and sparse apply, the store's rows and bytes, peak
   memory, round seconds. The sync job on the card against the
   CPU from one init, tasks unshuffled (dense params and touched rows
   within 1e-4 relative L2); one batch through the PS plane against PR
   9's HBM plane from the same weights (outputs within 1e-5 relative L2,
   after one SGD step the touched rows within 1e-6, the untouched ones
   unchanged). P2: two worker processes, ``--use_async --get_model_steps
   2``, seven epochs, worker 1 SIGKILLed at version 8 and relaunched: every
   task done once an epoch, kill -> the relaunched worker's first
   accepted gradient (the workers' timelines). P3: mnist_functional_api
   b64 on 1,024 + 256 records. No flash kernel launches
   (``launches_by_path.ps`` = 0: this process's, and those that P2's
   worker processes report in their timelines' last event).
12. ps_fleet — the parameter-server fleet: ``python -m
   elasticdl_tpu_torch.master.main --num_ps_pods 2``, two ``python -m
   elasticdl_tpu_torch.ps.main`` shards and ``worker.main --ps_addrs``
   processes, all on the card under one LocalInstanceManager (the
   master, the shards and the workers it spawns; a shard or master it
   sees exit is relaunched at its address). F1: DeepFM at the ps
   phase's width and data, sync (``--grads_to_wait 1``), one worker,
   ``--validation_data --evaluation_steps 8 --checkpoint_steps 8
   --output`` (the fleet's master holds no model: as in the reference,
   no round or checkpoint fires), ``evaluate`` from the export; held
   against the held-model job of the same seed run here (dense model and
   rows within 1e-6 relative L2; bitwise reported), each shard holding
   exactly the ids ``id % 2`` gives it; examples/s beside the held job's
   in this call, the worker's step split (``pull_dense``, the rows'
   fan-out, compute with CUDA events, ``push_gradient``, the parse),
   each shard's dense and sparse apply, rows, bytes and peak, the
   worker's peak. F1 runs the telemetry plane (``--telemetry_port
   --telemetry_events_path``, each shard's ``--ps_telemetry_port``, the
   worker's ``--telemetry_report_secs 1`` with its task acks inline):
   mid-job the master's ``/metrics`` carries the worker's examples/s and
   the task-queue depth, each shard's its applies, its ``/trace`` the
   ``ps/apply`` spans; the master's ``/trace`` holds its report spans
   joined to the worker's ``task/ack`` spans (``_sctx``), and through the
   port's tracetool attributes at least 90 % of traced step time to
   named phases; the event file parses line by line. The telemetry
   plane's overhead, measured first in the phase: the reference's A/B
   harness (its telemetry and trace benches' first arm, at sixteen times
   its tasks, run serially), twelve arms with the plane engaged and
   twelve off, each a process of its own forked from one that imported
   and warmed it, all at once: the engaged arms' median process CPU less
   the off arms', over the off arms' median wall, below 2 %, with its
   noise (the bootstrap's) below 1 % and each side's spread, printed
   beside F1's examples/s (taken with the plane on and the task acks
   inline; ``--f1-order`` runs F1 in turns with and without the plane). F2: two async workers (``--get_model_steps 2``), shard
   snapshots every 8 versions, shard 1 SIGKILLed at version 8 (by
   ``tools/chaos.py``'s ``FleetChaos``, once a snapshot of version 8 or
   newer is published; the run holds its ``executed`` log): the
   relaunch restores ``snap_v8`` or newer under a new ``shard_epoch``,
   every task done once an epoch (the journal), finite losses; kill ->
   serving -> the first push it accepts; with every flight recorder
   armed (the master's beside its journal, the shards' beside their
   snapshots, the workers' by ``EDL_FLIGHT_RECORDER_DIR``), every
   postmortem parses line by line and one that ``ps_shard_failure``
   triggered holds recent spans. F3: F2 without snapshots: the
   shard comes back empty and the workers re-push the model. F4: the
   MNIST CNN across two shards against the held MNIST job (no dataset
   shuffle, deterministic cuDNN in both; 1e-6). F5: the held model's
   ported flags: the master SIGKILLed at version 4 (``tools/chaos.py``'s
   ``FleetChaos``, as F2/F3's shard kill) under
   ``--master_journal_dir`` (the worker's re-push, every task once);
   MNIST with ``--export_dir --export_every_versions 4 --export_keep
   2``, the newest artifact served by ``ModelDirectoryWatcher`` replying
   as the model of its version; F1 again over ``--wire_dtype
   bfloat16`` (within 2e-2 of F1; its fleet boots and runs beside the
   exports). Each fleet's worker processes start with its master and
   shards, importing and creating their CUDA context while those boot,
   and wait for them to answer before they run. No flash kernel launches
   (``launches_by_path.ps_fleet`` = 0, this process's and the worker
   processes').
13. ps_tiers — the three tiers of embedding-row residence on the fleet:
   F1's job (sync DeepFM b1024, two shard processes, one deterministic
   worker process) on 16,384 records of 10 ids drawn with weights
   1 / rank^1.05 from 262,144 ids permuted out of 1,048,576 (bench.py's
   tiered bench at the zoo's vocabulary). Z0 the host store; Z2
   ``--ps_device --ps_warm_rows 4096 --ps_spill_dir`` (the disk tier over
   one arena per table on the card), bitwise Z0, the
   disk tier used (summed ``ps_status`` ``tiered``: rows spilled and
   pulled back cold), each shard holding at least 4 x 4,096 distinct ids
   (counted from the written data); Z3 the host store with the worker's
   hot-row cache (65,536 rows, a window of one version): hits, and
   within (0, 5e-2] relative L2 of Z0 (a cache that never hits trains
   bitwise and fails). Each run's examples/s, step split, each shard's
   dense and sparse apply, peak and tier counters, the cache's hits,
   misses and hit rate. Then an arena on the card restored into a host
   table and back, bitwise. No flash kernel launches
   (``launches_by_path.ps_tiers`` = 0).
14. ps_hybrid — the hybrid trainer (``--embedding_plane hybrid``: the
   Dense layers and the ``id_bias`` table on the worker, the
   ``embedding`` table on the fleet, the next batch's rows pulled while
   the current one computes) on ps_tiers' data, DeepFM with a 1,048,576
   vocabulary, SGD 0.1, b1024. H0, in this process under torch's
   deterministic algorithms, the reference bench's equivalence pre-pass:
   a PS arm and a hybrid arm over two sync servicers each, from one
   initialization (the Dense layers copied, the hybrid ``id_bias`` rows
   of every id in the data minted by the store); one batch bitwise
   (logits, loss, Dense gradients, ``embedding`` row gradients and ids;
   the hybrid ``id_bias`` gradient against the PS arm's rows scattered
   into a zero table, bitwise or within 1e-6); 16 steps of each through
   ``Worker.run`` over an in-process master, the end states (dense
   model, the rows of every id in the data) within 1e-6 relative L2
   (bitwise reported); the hybrid arm again with its prefetch on: it
   serves every step but each round's first, drops none, and lies within
   5e-2 of the prefetch-off arm. H1, the bench's hybrid arm on F1's
   fleet (processes, async shards, one worker with ``--ps_push_inflight
   1``): every task done once, finite losses, no dense gradient on any
   shard (no dense apply; their dense model the worker's first push,
   bitwise), each shard exactly its ``id % 2`` rows of ``embedding`` and
   no ``id_bias`` table, the pipeline serving all steps but one a round.
   H2, the bench's PS-everything arm on
   the same fleet and data (``--get_model_steps 4 --ps_push_inflight
   1``). Each run's examples/s (and H1 / H2), the step split (the
   pull's tail, the background pull, compute, the push, the local
   update, the parse), each shard's applies, peaks. No flash kernel
   launches (``launches_by_path.ps_hybrid`` = 0).
15. ps_serve — serving's PS plane, scoring while the fleet trains: two
   ``ps.main`` shards (async, a snapshot every 8 versions) hold DeepFM's
   tables at zoo width (``embedding`` 64 wide, ``id_bias`` 1 wide, ids
   from 1,048,576); a PS-everything worker in this process
   (``--get_model_steps 4``) trains on ps_tiers' zipf records from a
   streaming dispatcher and exports every 8 versions (4 kept). Two
   scorers serve the exports with ``--ps_addrs``: a ``python -m
   elasticdl_tpu_torch.serving.main`` process over its socket transport,
   and a ``build_scorer`` stack in this process behind a socket
   ``ScorerServer`` (each with a window of 4 versions, a delta sync every
   0.25 s, micro-batching to 64 rows). One client thread per scorer sends
   32-row requests of 10 zipf ids, closed loop, for 20 s; shard 0 is
   SIGKILLed at 40 % of the drive and relaunched on its port. Checks:
   every reply issued outside [kill - 1 s, shard serving + 5 s] succeeds
   with finite logits; both scorers serve after recovery; each
   hot-swapped (its final version above its first); every staleness
   sample (``scorer_status``, 0.5 s apart) at most 4; the in-process
   client saw shard 0's relaunch and its sync re-tagged and dropped rows
   and invalidated no table; once the trainer has drained and one
   ``sync_once`` has run, a fixed 32-row batch scored in process within
   1e-6 relative L2 of the newest export's Dense layers on the card bound
   to rows read from the shards with no cache (bitwise reported), and
   the micro-batcher's reply to it bitwise the solo score's. Records
   requests/s, p50/p99 per scorer, the in-process request's split
   (capture and plan, pull, forward with sync; timed from here), the
   sync round's and ``refresh_table`` walk's seconds, its counters, the
   highest staleness, kill -> serving -> first good reply, the scorer
   process's peak memory. No flash kernel launches
   (``launches_by_path.ps_serve`` = 0, this process's). At its end, once
   the scorer process serves the newest export, 16 requests go to it on
   its socket and through a ``ShmChannel``, the path that goes first
   alternating: the replies bitwise equal, every one through the ring.
16. wire — the shared-memory wire (``rpc/shm_transport.py``) at F1's
   width: F1's sync job for one epoch (16 steps of b1024) across two
   ``ps.main`` shards, shard 1 with ``--ps_device`` (the writable slot
   views' import), the worker built in this process as ``worker.main``
   builds it, with Z's deterministic settings. W0 ``--ps_shm off
   --master_shm off``, W1 the default ``auto``: the shards' dense model
   and every touched row bitwise W0, every PS channel ``on`` with calls
   through the ring (a silent fallback fails), the master channel never
   off. W2 on W1's shard 0: 200 pulls of 2,048 ids x 64 f32 and 200
   pushes of as many rows below the shard's version (decoded, never
   applied) on a socket stub and on a ring stub, each warmed first, the
   two paths' calls interleaved with the first alternating, p50 / p99
   each. A frame written straight out of a CUDA tensor (the PS worker
   hands its dense gradients and parameters over on the card) equals
   the host-staged frame byte for byte, f32 and bf16, contiguous and
   strided. ``--wire-only --wire-order off,auto,auto,off`` runs W's arms
   in that order (an A/B in turns, each bitwise the first). Examples/s of
   the median step, the fan-out, ``push_gradient`` and ``pull_dense``
   medians, each channel's counts. No flash kernel launches
   (``launches_by_path.wire`` = 0). Every fleet phase above rides rings
   too (the workers' and scorers' ``--ps_shm``/``--master_shm`` default
   to ``auto``); at the start the run checks that ``/dev/shm`` holds the
   largest ring set a phase negotiates, and at its end that no ``edlw-``
   segment it made is left.
17. elastic — the multi-process elastic ALLREDUCE job through the port's
   command line with ``--num_workers 2``: the master in this process,
   two worker processes sharing the card in one process world (gloo:
   NCCL refuses two ranks on one device; on a host with a card for each
   worker they get one each and form an NCCL world), ResNet-50 at the
   job's width
   on 1,792 synthetic records, asynchronous checkpoints every 4 versions.
   First the pinned snapshot on the card: parameters updated in place
   right after an asynchronous ``save`` returns must not reach the
   checkpoint. Run A, clean: every task done once, both ranks' final
   state bits equal (digests in the workers' timelines), the final
   version equal to the steps with a live rank, the newest checkpoint
   restored bitwise into a fresh model, the export written with its
   serving member (each run's export, in a worker, traced on the card);
   examples/s,
   the step split into compute, the all-reduce and the rest (the
   stream's times between CUDA events of the step), and each
   checkpoint's stall on the step path and background write. Run B,
   longer: worker 1 SIGKILLed at version 4; the survivor's step breaks,
   the world re-forms, the relaunched worker joins with the survivor's
   state bits, every task is done once and the live ranks end equal;
   the seconds from the kill to the broken step and to the new world's
   first step, and the relaunch's cold start. Run C, master SIGKILL:
   the master runs as ``python -m elasticdl_tpu_torch.master.master``
   (a journal, a fixed port, ``--num_workers 0``) and the two workers
   dial it, all three under one LocalInstanceManager in its
   external-supervisor form; the master is SIGKILLed at version 4 and
   relaunched with the same argv. Neither worker exits during the
   outage, ``master_epoch`` advances, the journal counts every task done
   once (with its ``dup`` count), the version clock continues, the ranks
   end equal, the newest checkpoint restores bitwise; kill -> serving
   (replay seconds, records replayed), kill -> the re-formed world's
   first step, its broadcast's seconds. Run D, Run B with
   ``--num_standby_workers 1`` over one epoch (the survivor waits for
   the warmed standby and re-forms at full size, so it needs no longer
   job to be joined): the warmed standby is promoted (the pool
   refills), the survivor re-forms once at full size, Run B's checks;
   kill -> the promoted worker's join beside Run B's spawn -> join and
   cold start, what the standby warmed, each process's card memory
   before the kill. Run E, evaluation while training: 256 validation
   records, a round every 4 versions, checkpoints every 4 (all kept):
   rounds at versions > 0, every task done once, each report whose
   scored version has a checkpoint within 1e-2 relative L2 of that
   checkpoint's direct forward and each such round's accuracy within
   2/256; examples/s with rounds beside Run A's, the rounds' seconds,
   the other rank's lockstep stall while one rank scores. The workers
   report their flash launches, by run (``launches_by_path`` ``elastic``
   for A and B, ``elastic_master_kill``, ``elastic_standby`` and
   ``elastic_eval``, each 0).
18. elastic_tp — transformer_lm's tensor-parallel shards on the elastic
   plane: ``cli train --num_workers 3`` of the LM at the slice's widths
   cut to 2 layers with ``tensor_parallel=2`` (three worker processes on
   the card over gloo, ``--replica_refresh_steps 0``, a checkpoint every
   2 versions, all kept, a round every 4 over 8 validation records),
   the layout solver's budget below the whole model's state so each
   world of two is data 1 x model 2. The first world forms of workers 0
   and 1, worker 2 parks as a spare and hands back what it fetched;
   worker 1 is SIGKILLed once both ranks' ckpt_v4 manifests are on disk
   and the spare is promoted into a re-formed world of 2. Each rank's
   parts after the re-form bitwise the restored checkpoint's, the
   version continuing from it; every task done once; each round whose
   scored version has a checkpoint within 1e-2 relative L2 of that
   checkpoint's whole-model forward; each rank's final parts bitwise the
   newest checkpoint's; the SAVE_MODEL member within REPLY_ATOL of the
   whole model; each rank's share of the parameter bytes and its peak
   memory, kill -> the re-formed world's first step, the restore's
   seconds, tokens/s before and after the kill, the host staging's
   share of a step; no flash launch (``launches_by_path.elastic_tp``,
   64-token records) and no process left.
19. elastic_collective — deepfm_edl's vocabulary-split HBM tables on the
   elastic collective plane: ``cli train --num_workers 3`` of
   deepfm_edl at the zoo's widths (tables of 1,048,576 x 64 and x 1,
   f32) on PS_BATCH zipf records a rank a step, three worker processes
   on the card over gloo, ``--replica_refresh_steps 0``, a checkpoint
   every 2 versions, all kept, a round every 4 over PS_BATCH validation
   records. The first world of three pads each table to 1,048,578 rows
   (349,526 a rank); worker 1 is SIGKILLed once all three ranks'
   ckpt_v4 manifests are on disk, and the world re-forms at 2 (524,288
   rows a rank) from the newest checkpoint every rank can read, across
   the paddings. Each world's mesh and each rank's rows (the
   manifests); each rank's parts after the re-form bitwise the
   checkpoint's logical rows for its range, the version going on from
   it; every task done once; each round whose scored version has a
   checkpoint within 1e-5 relative L2 of the host twin's forward on that
   checkpoint's clipped tables, its accuracy and AUC equal; each rank's
   final parts bitwise the newest checkpoint's; the SAVE_MODEL member
   within REPLY_ATOL of the host twin; each rank's table bytes and peak
   at 3 ranks and at 2, kill -> first step, the restore's seconds,
   examples/s before and after the kill, a step's split (the routed
   exchanges, the tower's SUM, host copies, the rest), the routed
   unique ids against their occurrences; no overflow, no flash launch
   (``launches_by_path.elastic_collective``) and no process left.
20. summary — each phase's seconds with the serving-member exports it
   made (their count and seconds: this process's trace and save, a
   worker's whole SAVE_MODEL export), the kernels line, the card line,
   then the result line.

Without a CUDA card, or outside a checkout of the repository, it exits
non-zero and prints no result. ``--elastic-only`` runs phases 1 and 17
alone, ``--elastic-tp-only`` phases 1 and 18,
``--elastic-collective-only`` phases 1, 2 and 19, ``--zoo-only`` phases 1
and 10, ``--ps-only`` phases 1 and 11, ``--ps-fleet-only`` phases 1 and
12, ``--ps-tiers-only`` phases 1 and
13, ``--ps-hybrid-only`` phases 1 and 14, ``--ps-serve-only`` phases 1
and 15, ``--wire-only`` phases 1 and 16, ``--moe-only`` phases 1, 2 and
6, ``--ring-only`` phases 1, 2 and 7, and none of them prints the
result line. (``--ring-rank`` is the ring phase's rank process.)
"""

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BYTECODE_DIR = os.path.join(REPO, "_bytecode")

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, dense
# bf16 tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

KERNEL_SHAPES = [  # (B, H, D, L)
    (1, 12, 64, 1024),
    (8, 12, 64, 1024),
    (4, 16, 96, 1024),
    (2, 12, 64, 2048),
]
TRAIN_SHAPE = (16, 12, 64, 1024)  # the training slice's attention
# untimed cases of every kernel (B, H, D, Lq, Lk): a length below one tile
# of the kernels' owned rows (zero-filled copies, store masks, a tile that
# straddles the end) and Lq != Lk (the causal start and stop of the
# loops, at absolute positions)
EXTRA_CASES = [
    (2, 12, 64, 96, 96),
    (2, 12, 64, 512, 1024),
]
TIMED_LAUNCHES = 50  # kernels and SDPA, per timing
TOL = {  # dtype -> (rtol, atol) against the plain version in float32
    "float32": (2e-4, 2e-5),
    "bfloat16": (0.0, 2e-2),
}
# gradients: the reference's own tolerances (tests/test_flash_attention.py)
BWD_TOL = {"float32": (3e-4, 3e-4), "bfloat16": (0.1, 0.1)}
# Per tensor (out, dq, dk, dv), relative L2 distance from the plain
# version in float32. At L >= 1024 an output or a gradient of random
# inputs is ~0.05 per element, no larger than the elementwise limits
# above, so this is the gate that sees a wrong tile; each case also
# shows that a planted fault (a mask one tile off, a 10 % scale error)
# lies beyond it. PERF.md section 6 has the readings.
REL_L2 = {"float32": 1e-5, "bfloat16": 2e-2}
FAULT_TILE = 64  # the kernels' tile: the planted mask fault is one tile off
MEM_SHAPE = (1, 12, 64, 8192)  # the backward's no-(L, L) check, bf16

# The repo's headline transformer_lm width (bench.py's 110M config), its
# depth cut from 12 layers to 6 so that the every-phase run keeps inside
# its limit with the moe and ring phases (67.6M parameters).
SLICE_CFG = dict(
    vocab_size=32768, num_layers=6, num_heads=12, head_dim=64,
    embed_dim=768, mlp_dim=3072, dtype="bfloat16",
)
MODEL_DEF = "transformer_lm.transformer_lm.custom_model"
SEQ_LEN = 1024  # pick_causal_attention takes the kernel from L = 1024
N_REQUESTS = 32
MAX_BATCH = 8
REPLY_ATOL = 0.1  # bf16 logits: batched vs solo, kernel vs plain attention
SEED = 0
DEVICE = "cuda"

# training (bench.py's headline step: b16 x L1024, AdamW at 3e-3)
TRAIN_BATCH = 16
TRAIN_STEPS = 10  # timed, after one warm-up step
LR = 3e-3
GRAD_CHECK_BATCH = 4  # kernel vs plain-attention gradients
GRAD_REL_L2 = 5e-2  # per tensor, bf16 compute, from the seeded init
# (PERF.md says why; after training on random tokens the q/k gradients
# shrink until the reference's bf16 delta dominates them: reported only)
# Per tensor, the kernels against plain_flash_bwd's own formula (same
# forward, same delta, float32) from the seeded init and from the
# trained weights: what the backward kernels alone add (read 0.011 and
# 0.0046 on an H100, PERF.md section 6).
FORMULA_REL_L2 = 2e-2
REMAT_LOSS_RTOL = 1e-3

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "flash_fwd": (
        "elasticdl_tpu_torch/ops/csrc/flash_fwd.cu",
        "elasticdl_tpu/ops/flash_attention.py:39",
    ),
    "flash_bwd_dq": (
        "elasticdl_tpu_torch/ops/csrc/flash_bwd.cu",
        "elasticdl_tpu/ops/flash_attention.py:128",
    ),
    "flash_bwd_dkv": (
        "elasticdl_tpu_torch/ops/csrc/flash_bwd.cu",
        "elasticdl_tpu/ops/flash_attention.py:175",
    ),
}


# The seconds of each phase of the run, and of each serving-member export
# by phase: this process's timed around common/export's
# ``_export_serving_fn`` (the trace and its save), a worker process's from
# its timeline's ``export`` event (the whole SAVE_MODEL export there).
PHASE = ["device"]
PHASE_SECONDS = {}
MEMBER_EXPORTS = {}


def _note_export(seconds, where):
    MEMBER_EXPORTS.setdefault(PHASE[0], []).append(
        {"seconds": seconds, "in": where})


def _time_member_exports():
    from elasticdl_tpu_torch.common import export

    inner = export._export_serving_fn

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return inner(*args)
        finally:
            _note_export(time.perf_counter() - t0, "this process")

    export._export_serving_fn = timed


def _note_worker_exports(events_by_worker):
    for worker, events in events_by_worker.items():
        for e in events:
            if e["event"] == "export" and e.get("serving_member"):
                _note_export(e["seconds"], "worker %s" % worker)


def _run_phase(name, fn, *args):
    """``fn(*args)``, its seconds kept under ``name``. A process below
    this one that is still alive at its end, and that no later phase was
    handed (``HANDED_ON``), is kept in ALIVE_AFTER and stopped: left
    running, it would take the host's cores from the phases after."""
    PHASE[0] = name
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        alive = [p for p in _descendants()
                 if not _own_tracker(p) and p[0] not in HANDED_ON]
        if alive:
            ALIVE_AFTER[name] = alive
            print("chip_smoke: %d process(es) alive after the %s phase: %s"
                  % (len(alive), name, alive), file=sys.stderr)
            _stop([pid for pid, _ in alive])


# Every process this run starts ends before it does. The run is its
# processes' subreaper (PR_SET_CHILD_SUBREAPER, on this process only): a
# process orphaned below it (the child of a SIGKILLed shard or worker)
# is re-parented here and not to init, so the end of the run still finds
# it, stops it and names it.
PR_SET_CHILD_SUBREAPER = 36
ALIVE_AFTER = {}  # phase -> [[pid, command]] alive below this process
HANDED_ON = set()  # pids that live on past the phase that started them
LEFT_AT_END = []  # [[pid, command]] that the end of the run had to stop
STOP_GRACE_S = 10.0


def _bytecode_cache():
    """One cache of compiled bytecode for this process and every one it
    starts, in the checkout (BYTECODE_DIR, which git ignores).

    The card's machine runs Python with PYTHONDONTWRITEBYTECODE=1 and
    ships torch with no compiled bytecode, so each process compiled
    torch from source: ``import torch`` 6.5-8.7 s and the first
    optimizer step (torch._dynamo's import) 7.8-9.8 s, on every worker,
    shard, master and scorer this run starts. Here the first process to
    import a module writes its bytecode under PYTHONPYCACHEPREFIX (atomic
    writes; no file beside any source) and every later one reads it."""
    prefix = os.environ.setdefault("PYTHONPYCACHEPREFIX", BYTECODE_DIR)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


def _become_subreaper():
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    return libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0


def _command(pid):
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as f:
            argv = f.read().split(b"\0")
    except OSError:
        return ""
    return " ".join(a.decode(errors="replace") for a in argv if a)[:300]


def _descendants():
    """[[pid, command]] of every live process below this one, from
    /proc; a zombie has ended and is left out."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % entry) as f:
                stat = f.read()
        except OSError:
            continue
        # the command in stat is in parentheses and may hold spaces
        state, ppid = stat[stat.rfind(")") + 2:].split()[:2]
        children.setdefault(int(ppid), []).append((int(entry), state))
    found, todo = [], [os.getpid()]
    while todo:
        for pid, state in children.get(todo.pop(), []):
            todo.append(pid)
            if state != "Z":
                found.append([pid, _command(pid)])
    return found


def _own_tracker(proc):
    """This process's multiprocessing resource tracker: it lives as long
    as this process by design and ends with it (``_stop_processes``)."""
    pid, command = proc
    return "resource_tracker" in command and _ppid(pid) == os.getpid()


def _ppid(pid):
    try:
        with open("/proc/%d/stat" % pid) as f:
            stat = f.read()
    except OSError:
        return None
    return int(stat[stat.rfind(")") + 2:].split()[1])


def _reap_zombies():
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def _stop(pids):
    """SIGTERM each of ``pids`` and SIGKILL those alive STOP_GRACE_S
    later. What ends stays a zombie until ``_stop_processes`` reaps it:
    reaped here, a child's ``Popen`` would read a wrong exit code."""
    def alive():
        below = {pid for pid, _ in _descendants()}
        return [pid for pid in pids if pid in below]

    for sig, wait_s in ((signal.SIGTERM, STOP_GRACE_S),
                        (signal.SIGKILL, STOP_GRACE_S)):
        for pid in alive():
            try:
                os.kill(pid, sig)
            except OSError:
                pass
        deadline = time.monotonic() + wait_s
        while alive() and time.monotonic() < deadline:
            time.sleep(0.05)


def _stop_processes():
    """End every process still below this one: the resource tracker
    through its own stop, the rest by SIGTERM and, STOP_GRACE_S later,
    SIGKILL; each of the rest is kept in LEFT_AT_END. Returns them."""
    from multiprocessing import resource_tracker

    tracker = getattr(resource_tracker, "_resource_tracker", None)
    if tracker is not None and getattr(tracker, "_pid", None) is not None:
        try:
            tracker._stop()
        except OSError:  # ended already
            pass
    left = _descendants()
    _stop([pid for pid, _ in left])
    _reap_zombies()
    LEFT_AT_END.extend(left)
    if left:
        print("chip_smoke: stopped %d process(es) left at the end: %s"
              % (len(left), left), file=sys.stderr)
    return left


def timing_record():
    """Each phase's seconds and the serving-member exports it made, and
    the processes alive after each phase and stopped at the end."""
    return {
        "phase": "timing",
        "seconds": dict(PHASE_SECONDS),
        "total_s": sum(PHASE_SECONDS.values()),
        "processes": {"alive_after_phase": dict(ALIVE_AFTER),
                      "stopped_at_end": list(LEFT_AT_END)},
        "member_exports": {
            phase: {"count": len(each),
                    "seconds": sum(e["seconds"] for e in each),
                    "each": each}
            for phase, each in MEMBER_EXPORTS.items()
        },
        "member_exports_s": sum(e["seconds"] for each in
                                MEMBER_EXPORTS.values() for e in each),
    }


def emit(obj):
    print(json.dumps(obj, sort_keys=True), flush=True)


class PhaseError(RuntimeError):
    pass


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise PhaseError("%s failed: %s" % (cmd[0], proc.stderr[-2000:]))
    return proc.stdout.strip()


def phase_device(torch):
    smi = _run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ]
    ).splitlines()
    from elasticdl_tpu_torch.ops.build import find_nvcc

    nvcc = _run([find_nvcc(), "--version"]).splitlines()
    emit(
        {
            "phase": "device",
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[0] if smi else "",
            "torch": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "nvcc": next((l for l in nvcc if "release" in l), nvcc[-1]),
        }
    )
    return smi[0] if smi else ""


def ptxas_summary(log):
    """{kernel symbol: {"registers", "spill_bytes"}} from a ``-Xptxas
    -v`` report."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(
            r"(?:Compiling entry function '|Function properties for )"
            r"'?([\w$]+)", line
        )
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


# the bf16 kernels the spill gate holds, by source
BF16_KERNELS = {
    "flash_fwd.cu": ("flash_fwd_bf16",),
    "flash_bwd.cu": ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"),
}


def phase_build():
    """Every source built at once; fails on a spill in a bf16 kernel,
    read from the ptxas report kept beside each library (so a cached
    build is gated as a fresh one is)."""
    from elasticdl_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.build_all()
    reports = {s: build.ptxas_report(s) for s in built}
    summary = {s: ptxas_summary(log) for s, log in reports.items()}
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "libraries": {s: os.path.basename(p) for s, p in built.items()},
            "ptxas": summary,
        }
    )
    for source, log in sorted(reports.items()):
        print("ptxas report for %s:" % source)
        print(log.strip())
    spills = {}
    for source, kernels in BF16_KERNELS.items():
        bf16 = {
            sym: info for sym, info in summary[source].items()
            if "bf16" in sym
        }
        for kernel in kernels:
            if not any(kernel in sym and "spill_bytes" in info
                       for sym, info in bf16.items()):
                raise PhaseError(
                    "the ptxas report of %s gives no spill count for %s: %s"
                    % (source, kernel, sorted(bf16))
                )
        spills.update({sym: i["spill_bytes"] for sym, i in bf16.items()
                       if i.get("spill_bytes")})
    if spills:
        raise PhaseError("bf16 kernels spill: %s" % spills)


def time_ms(torch, fn, iters, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA
    events around the whole run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_rows(prof):
    """[(device us, kernel name, calls)] of a torch.profiler run, largest
    first: device-side events only (a CPU op's device total repeats the
    time of the kernels it launched)."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    return rows


def per_call_ms(torch, fn, iters):
    """(device ms, host ms) per call of ``fn()``: the device time of the
    kernels it launched, summed by torch.profiler over ``iters`` calls,
    and the host's time to issue one call (no sync, outside the
    profiler); both after a warm-up. None for the device time when the
    profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3 / iters if rows else None
    return device_ms, host_ms


def _pairs(lq, lk, causal):
    """Visible (query, key) pairs of one head."""
    if causal:
        return sum(min(i + 1, lk) for i in range(lq))
    return lq * lk


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def flash_bound(b, h, d, lq, lk, dtype, causal):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (q, k, v read once, out and lse written once) over HBM
    bandwidth and its two matrix products over the dtype's peak rate.
    Causal work counts only the visible (query, key) pairs."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * lq * h * d + 2 * b * lk * h * d) * elem + b * h * lq * 4
    ops = 4.0 * b * h * d * _pairs(lq, lk, causal)
    return _bound(nbytes, ops, dtype)


def bwd_bound(kernel, b, h, d, lq, lk, dtype, causal):
    """(bound_ms, bound_by) of one backward kernel. flash_bwd_dq reads q,
    k, v, dO and writes dq, and does three products (S, dP, dQ: 6 D
    operations per visible pair); flash_bwd_dkv reads q, k, v, dO and
    writes dk, dv, and does four (S, dP, dV, dK: 8 D). Both read lse and
    delta (float32, one per query row)."""
    elem = 2 if dtype == "bfloat16" else 4
    q_side, k_side = b * lq * h * d, b * lk * h * d
    if kernel == "flash_bwd_dq":
        tensors, per_pair = 3 * q_side + 2 * k_side, 6
    else:
        tensors, per_pair = 2 * q_side + 4 * k_side, 8
    nbytes = tensors * elem + 2 * b * h * lq * 4
    ops = float(per_pair) * b * h * d * _pairs(lq, lk, causal)
    return _bound(nbytes, ops, dtype)


def _rel_l2(torch, got, want):
    return float(
        torch.linalg.vector_norm(got.float() - want.float())
        / torch.linalg.vector_norm(want.float()).clamp_min(1e-30)
    )


def _fault_mask(torch, lq, lk, causal, device):
    """(Lq, Lk) visible pairs with one key tile wrong, as a kernel whose
    tile loop is off by one would see them: under causal masking, keys up
    to one tile past the diagonal; otherwise the last key tile dropped."""
    q_pos = torch.arange(lq, device=device)[:, None]
    k_pos = torch.arange(lk, device=device)[None, :]
    if causal:
        return k_pos <= q_pos + FAULT_TILE
    return (k_pos < lk - FAULT_TILE).expand(lq, lk)


def _masked_attention(torch, q, k, v, visible):
    """Softmax attention over ``visible`` pairs, in float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = (s * q.shape[-1] ** -0.5).masked_fill(~visible, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.float())


def _masked_bwd(torch, q, k, v, out, lse, g, g_lse, visible):
    """``plain_flash_bwd``'s formula over ``visible`` pairs, with the lse
    and delta of the correct forward -> (dq, dk, dv) in float32."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    delta = fa.flash_delta(out, g, g_lse)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~visible, 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
    return (
        torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale,
        torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale,
        torch.einsum("bhqk,bqhd->bkhd", p, gf),
    )


def check_flash_case(torch, b, h, d, lq, lk, dtype, causal, seed, timed):
    """The forward kernel against ``plain_flash_with_lse`` in float32 from
    the same inputs; a second launch must give bitwise the same out and
    lse. With ``timed``, times the kernel, the plain version and SDPA."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    tdtype = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (
        torch.randn(
            (b, length, h, d), generator=gen, device=DEVICE,
            dtype=torch.float32,
        ).to(tdtype)
        for length in (lq, lk, lk)
    )
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    again = fa.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    bitwise = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    del again
    ref_out, ref_lse = fa.plain_flash_with_lse(
        q.float(), k.float(), v.float(), causal
    )
    rtol, atol = TOL[dtype]
    err_out = (out.float() - ref_out).abs()
    err_lse = (lse - ref_lse).abs()
    rel = _rel_l2(torch, out, ref_out)
    faults = {
        "out*0.9": _rel_l2(torch, 0.9 * out.float(), ref_out),
        "mask one tile off": _rel_l2(
            torch,
            _masked_attention(
                torch, q, k, v, _fault_mask(torch, lq, lk, causal, q.device)
            ),
            ref_out,
        ),
    }
    limit = REL_L2[dtype]
    ok = bool(
        bitwise
        and torch.isfinite(out).all()
        and (err_out <= atol + rtol * ref_out.abs()).all()
        and (err_lse <= atol + rtol * ref_lse.abs()).all()
        and rel <= limit
    )
    bound_ms, bound_by = flash_bound(b, h, d, lq, lk, dtype, causal)
    rec = {
        "phase": "kernels",
        "kernel": "flash_fwd",
        "shape": [b, lq, h, d],
        "lk": lk,
        "dtype": dtype,
        "causal": causal,
        "bitwise_repeat": bitwise,
        "max_abs_err": float(err_out.max()),
        "max_abs_err_lse": float(err_lse.max()),
        "rtol": rtol,
        "atol": atol,
        "rel_l2": rel,
        "rel_l2_limit": limit,
        "fault_rel_l2": faults,
        "ok": ok,
        "bound_ms": bound_ms,
        "bound_us": bound_ms * 1e3,
        "bound_by": bound_by,
    }
    if timed:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def kernel():
            return fa.flash_attention_with_lse(q, k, v, causal)

        def library():
            return sdpa(qt, kt, vt, is_causal=causal)

        rec.update(
            kernel_ms=time_ms(torch, kernel, TIMED_LAUNCHES),
            plain_ms=time_ms(
                torch, lambda: fa.plain_flash_with_lse(q, k, v, causal), 5, 1
            ),
            library_ms=time_ms(torch, library, TIMED_LAUNCHES),
        )
        rec["kernel_device_ms"], rec["kernel_host_ms"] = per_call_ms(
            torch, kernel, TIMED_LAUNCHES
        )
        rec["library_device_ms"], rec["library_host_ms"] = per_call_ms(
            torch, library, TIMED_LAUNCHES
        )
    emit(rec)
    if not ok:
        raise PhaseError(
            "flash_fwd disagrees with its plain version (or with its own "
            "second launch: bitwise %s) at %s" % (bitwise, rec)
        )
    if min(faults.values()) <= limit:
        raise PhaseError(
            "the flash_fwd check cannot see a planted fault at %s" % rec
        )
    return rec


def phase_kernels(torch):
    """Every (shape, dtype, causal) case of the forward kernel, timed
    where the shape is square; returns the records."""
    records = []
    seed = 0
    cases = [(b, h, d, l, l)
             for b, h, d, l in KERNEL_SHAPES + [TRAIN_SHAPE, TP_SHAPE]]
    for b, h, d, lq, lk in cases + EXTRA_CASES:
        for dtype in ("float32", "bfloat16"):
            for causal in (False, True):
                seed += 1
                records.append(
                    check_flash_case(
                        torch, b, h, d, lq, lk, dtype, causal, seed,
                        timed=(b, h, d, lq, lk) in cases,
                    )
                )
    return records


def _bwd_inputs(torch, b, h, d, lq, lk, dtype, with_lse, seed):
    """Seeded q, k, v, dO (and an lse cotangent) on the card."""
    tdtype = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(length):
        return torch.randn(
            (b, length, h, d), generator=gen, device=DEVICE,
            dtype=torch.float32,
        ).to(tdtype)

    q, k, v, g = randn(lq), randn(lk), randn(lk), randn(lq)
    g_lse = (
        torch.randn((b, h, lq), generator=gen, device=DEVICE)
        if with_lse
        else None
    )
    return q, k, v, g, g_lse


def check_bwd_case(torch, b, h, d, lq, lk, dtype, causal, with_lse, seed,
                   timed):
    """Both backward kernels against ``plain_flash_bwd`` in float32 from
    the same inputs (the forward kernel's out and lse), with or without
    an lse cotangent; a second launch of each must give bitwise the same
    gradients. With ``timed``, times each kernel, the plain version and
    SDPA's backward. Returns one record per kernel."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    q, k, v, g, g_lse = _bwd_inputs(
        torch, b, h, d, lq, lk, dtype, with_lse, seed
    )
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    delta = fa.flash_delta(out, g, g_lse)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    again = (fa.flash_bwd_dq(q, k, v, g, lse, delta, causal),
             *fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal))
    torch.cuda.synchronize()
    bitwise = all(
        torch.equal(x, y) for x, y in zip((dq, dk, dv), again)
    )
    del again
    want = fa.plain_flash_bwd(
        q.float(), k.float(), v.float(), out.float(), lse, g.float(),
        causal, g_lse,
    )
    rtol, atol = BWD_TOL[dtype]
    limit = REL_L2[dtype]
    planted = _masked_bwd(
        torch, q, k, v, out, lse, g, g_lse,
        _fault_mask(torch, lq, lk, causal, q.device),
    )
    errs, rels, faults = {}, {}, {}
    ok = bitwise
    for name, got, ref, bad in zip(
        ("dq", "dk", "dv"), (dq, dk, dv), want, planted
    ):
        err = (got.float() - ref).abs()
        errs[name] = float(err.max())
        rels[name] = _rel_l2(torch, got, ref)
        faults[name] = {
            name + "*0.9": _rel_l2(torch, 0.9 * got.float(), ref),
            "mask one tile off": _rel_l2(torch, bad, ref),
        }
        ok = ok and bool(
            torch.isfinite(got).all()
            and (err <= atol + rtol * ref.abs()).all()
            and rels[name] <= limit
        )
    del planted
    timed_ms = {}
    if timed:
        timed_ms["flash_bwd_dq"] = time_ms(
            torch, lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal),
            TIMED_LAUNCHES,
        )
        timed_ms["flash_bwd_dkv"] = time_ms(
            torch, lambda: fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal),
            TIMED_LAUNCHES,
        )
        plain_ms = time_ms(
            torch,
            lambda: fa.plain_flash_bwd(q, k, v, out, lse, g, causal),
            3, 1,
        )
        sdpa_bwd = _sdpa_bwd_ms(torch, q, k, v, g, causal)
    records = []
    for kernel, names in (("flash_bwd_dq", ("dq",)),
                          ("flash_bwd_dkv", ("dk", "dv"))):
        bound_ms, bound_by = bwd_bound(kernel, b, h, d, lq, lk, dtype, causal)
        rec = {
            "phase": "kernels",
            "kernel": kernel,
            "shape": [b, lq, h, d],
            "lk": lk,
            "dtype": dtype,
            "causal": causal,
            "g_lse": with_lse,
            "bitwise_repeat": bitwise,
            "max_abs_err": max(errs[n] for n in names),
            "max_abs_err_by_grad": {n: errs[n] for n in names},
            "rtol": rtol,
            "atol": atol,
            "rel_l2": max(rels[n] for n in names),
            "rel_l2_by_grad": {n: rels[n] for n in names},
            "rel_l2_limit": limit,
            "fault_rel_l2": {n: faults[n] for n in names},
            "ok": ok,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        if timed_ms:
            rec.update(
                kernel_ms=timed_ms[kernel],
                plain_ms=plain_ms,  # both gradients, the whole function
                library_ms=sdpa_bwd,  # SDPA's backward: dq, dk and dv
            )
        emit(rec)
        records.append(rec)
    if not ok:
        raise PhaseError(
            "flash backward disagrees with its plain version (or with its "
            "own second launch: bitwise %s) at %s lk=%d %s causal=%s "
            "g_lse=%s: max abs %s, rel L2 %s" % (
                bitwise, [b, lq, h, d], lk, dtype, causal, with_lse, errs,
                rels,
            )
        )
    unseen = {
        n: f for n, f in faults.items() if min(f.values()) <= limit
    }
    if unseen:
        raise PhaseError(
            "the backward check cannot see a planted fault at %s lk=%d %s "
            "causal=%s: %s (limit %g)" % ([b, lq, h, d], lk, dtype, causal,
                                          unseen, limit)
        )
    return records


def _sdpa_bwd_ms(torch, q, k, v, g, causal):
    """SDPA's backward alone (dq, dk and dv from one retained forward of
    (B, H, L, D) views of the same inputs), per launch."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (
        x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)
    )
    out = sdpa(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2)
    return time_ms(
        torch,
        lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True),
        TIMED_LAUNCHES,
    )


def phase_bwd_kernels(torch):
    """Every (shape, dtype, causal, lse cotangent) case of both backward
    kernels, timed where there is no lse cotangent and the shape is
    square; returns the records."""
    records = []
    seed = 100
    cases = [(b, h, d, l, l)
             for b, h, d, l in KERNEL_SHAPES + [TRAIN_SHAPE, TP_SHAPE]]
    for b, h, d, lq, lk in cases + EXTRA_CASES:
        for dtype in ("float32", "bfloat16"):
            for causal in (False, True):
                for with_lse in (False, True):
                    seed += 1
                    records += check_bwd_case(
                        torch, b, h, d, lq, lk, dtype, causal, with_lse,
                        seed, timed=not with_lse and lq == lk,
                    )
    return records


def phase_bwd_memory(torch):
    """The backward at a long sequence (bf16, causal) allocates no
    (L, L) buffer: the rise of the allocator's peak over the backward
    stays below one head's (L, L) float32 scores. What it must allocate
    is dq, dk, dv, delta and one float32 copy of dO."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, h, d, l = MEM_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, g = (
        torch.randn((b, l, h, d), generator=gen, device="cuda").to(
            torch.bfloat16
        )
        for _ in range(4)
    )
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    out, _ = fa.flash_attention_with_lse(q, k, v, True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    one_head_scores = l * l * 4
    rec = {
        "phase": "bwd_memory",
        "shape": [b, l, h, d],
        "dtype": "bfloat16",
        "backward_peak_rise_bytes": int(rise),
        "one_head_LxL_f32_bytes": one_head_scores,
        "grads_bytes": int(sum(x.numel() * x.element_size() for x in grads)),
        "finite": all(bool(torch.isfinite(x).all()) for x in grads),
    }
    emit(rec)
    if not (rise < one_head_scores and rec["finite"]):
        raise PhaseError("backward memory check failed: %s" % rec)
    return rec


def _lm_weights(torch, cfg, device):
    """The LM of ``cfg`` with seeded random weights, on ``device``."""
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )

    with torch.device("meta"):
        model = zoo.custom_model(**cfg)
    model = model.to_empty(device=device)
    zoo.init_parameters(
        model, torch.Generator(device=device).manual_seed(SEED)
    )
    return model.eval()


def _lm_member(torch, model, cfg, export_dir):
    """``model``'s artifact at ``export_dir`` with its serving member,
    traced where the model lies over two SEQ_LEN-token rows; returns the
    seconds the artifact took."""
    import numpy as np

    from elasticdl_tpu_torch.common.convert import to_named
    from elasticdl_tpu_torch.common.export import (
        export_model,
        export_provenance,
        make_serving_module,
    )

    example = {"tokens": np.random.default_rng(SEED + 5).integers(
        0, cfg["vocab_size"], (2, SEQ_LEN), dtype=np.int32)}
    params = ",".join("%s=%r" % kv for kv in cfg.items())
    t0 = time.perf_counter()
    manifest = export_model(
        export_dir,
        to_named(model.state_dict(), cfg["num_heads"], cfg["head_dim"]),
        1,
        metadata=export_provenance("", MODEL_DEF, params),
        serving_module=make_serving_module(
            model, dict(model.named_parameters()), {}),
        example_features=example,
    )
    if not manifest["artifacts"]["torch_serving_fn"]:
        raise PhaseError("the LM's artifact at %s has no serving member"
                         % export_dir)
    return time.perf_counter() - t0


def _make_artifacts(torch, export_root, rebuild_root):
    """The slice's bf16 LM's artifacts, from seeded random weights through
    the port's ``export_model``: under ``export_root`` with the serving
    member traced from the module on the card, and under
    ``rebuild_root`` params-only (the scorer rebuilds that one). Returns
    the seconds of each."""
    from elasticdl_tpu_torch.common.convert import to_named
    from elasticdl_tpu_torch.common.export import (
        export_model,
        export_provenance,
    )

    model = _lm_weights(torch, SLICE_CFG, DEVICE)
    member_s = _lm_member(torch, model, SLICE_CFG,
                          os.path.join(export_root, "v1"))
    t0 = time.perf_counter()
    params = ",".join("%s=%r" % kv for kv in SLICE_CFG.items())
    export_model(
        os.path.join(rebuild_root, "v1"),
        to_named(model.state_dict(), SLICE_CFG["num_heads"],
                 SLICE_CFG["head_dim"]),
        1,
        metadata=export_provenance("", MODEL_DEF, params),
    )
    return {"member_artifact_s": member_s,
            "params_only_artifact_s": time.perf_counter() - t0}


def _counter(name):
    from elasticdl_tpu_torch.utils import profiling

    return profiling.metrics.counter(name, labels=("outcome",))


def _forward_seconds():
    """Summed time of the scorer's forwards so far (each ends in a
    device synchronize), from its request-latency histogram."""
    from elasticdl_tpu_torch.utils import profiling

    got = profiling.metrics.histogram(
        "edl_scorer_request_latency_seconds"
    ).data()
    return got[1] if got else 0.0


def _fire(score, requests):
    """Every request at once, one thread each, through ``score`` (the
    servicer's instrumented ``score`` handler) -> (replies, latencies in
    s, wall s from the first issue to the last reply)."""
    replies = [None] * len(requests)
    latency = [None] * len(requests)
    gate = threading.Barrier(len(requests) + 1)

    def one(i):
        gate.wait()
        t0 = time.perf_counter()
        replies[i] = score({"tokens": requests[i]})
        latency[i] = time.perf_counter() - t0

    threads = [
        threading.Thread(target=one, args=(i,), daemon=True)
        for i in range(len(requests))
    ]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise PhaseError("score requests still running after 300 s")
    return replies, latency, wall


def _check_reply(torch, reply, i):
    vocab = SLICE_CFG["vocab_size"]
    if "error" in reply:
        raise PhaseError("request %d failed: %s" % (i, reply["error"]))
    out = reply["output"]
    if not (
        isinstance(out, torch.Tensor)
        and out.dtype == torch.bfloat16
        and tuple(out.shape) == (1, SEQ_LEN, vocab)
        and bool(torch.isfinite(out).all())
    ):
        raise PhaseError(
            "request %d: expected finite bf16 logits (1, %d, %d), got %s %s"
            % (i, SEQ_LEN, vocab, getattr(out, "dtype", type(out)),
               tuple(getattr(out, "shape", ())))
        )
    if reply["model_version"] != 1:
        raise PhaseError(
            "request %d scored by v%s, expected v1"
            % (i, reply["model_version"])
        )


def _profile(torch, label, fn, **fields):
    """Device time by kernel over one call of ``fn`` (torch.profiler,
    after one unprofiled call); an empty breakdown says the profiler saw
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    rec = dict(
        fields,
        phase="profile",
        of=label,
        wall_ms=wall_ms,
        device_busy_ms=busy_ms,
        idle_share=(1 - busy_ms / wall_ms) if rows else None,
        top=[
            {"kernel": k[:90], "ms": us / 1e3, "calls": n}
            for us, k, n in rows[:15]
        ],
    )
    emit(rec)
    return rec


def _profile_forward(torch, forward, rows):
    _profile(torch, "forward", forward, rows=rows)


def _reset_counters():
    from elasticdl_tpu_torch.ops import flash_attention as fa

    for counter in (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches):
        counter.reset()


def _counts():
    from elasticdl_tpu_torch.ops import flash_attention as fa

    return {
        "flash_fwd": (fa.launches.count, fa.launches.shapes()),
        "flash_bwd_dq": (fa.bwd_dq_launches.count, fa.bwd_dq_launches.shapes()),
        "flash_bwd_dkv": (
            fa.bwd_dkv_launches.count, fa.bwd_dkv_launches.shapes()
        ),
    }


def _stack(torch, export_root, requests, telemetry=False):
    """The scorer's entry points over the artifact under ``export_root``
    (build_scorer -> ScorerServicer's instrumented handlers ->
    MicroBatcher), its v1 installed and warmed by MAX_BATCH requests;
    with ``telemetry`` behind a ``ScorerServer`` whose telemetry
    endpoint (``--scorer_telemetry_port 0``) serves this process's
    registry. Stop it with ``_stop_stack``."""
    from elasticdl_tpu_torch.common.args import parse_scorer_args
    from elasticdl_tpu_torch.serving.main import build_scorer
    from elasticdl_tpu_torch.serving.server import ScorerServer, ScorerServicer

    args = parse_scorer_args(
        [
            "--export_dir", export_root,
            "--device", DEVICE,
            "--serve_max_batch", str(MAX_BATCH),
            "--serve_batch_timeout_ms", "50",
        ] + (["--scorer_telemetry_port", "0"] if telemetry else [])
    )
    scorer, watcher, _, _, batcher = build_scorer(args)
    t0 = time.perf_counter()
    if watcher.poll_once() != 1:
        raise PhaseError("the watcher did not install the v1 artifact "
                         "under %s" % export_root)
    stack = {"scorer": scorer, "batcher": batcher, "server": None,
             "load_s": time.perf_counter() - t0}
    if telemetry:
        # the socket transport carries no request here: the rounds call
        # the server's handlers in this process, as the reference's
        # in-process path does, through the same instrumented dict
        server = ScorerServer(
            scorer, port=0, batcher=batcher, transport="socket",
            telemetry_port=args.scorer_telemetry_port)
        stack["server"] = server
        stack["url"] = "http://127.0.0.1:%d" % server.telemetry_port
        servicer = server.servicer
    else:
        servicer = ScorerServicer(scorer, batcher=batcher)
        batcher.start()
    stack["score"] = servicer.rpc_methods()["score"]
    # warm-up (not counted): allocator, cuBLAS handles, a first batch
    _, _, stack["warmup_s"] = _fire(stack["score"], requests[:MAX_BATCH])
    return stack


def _stop_stack(stack):
    if stack["server"] is not None:
        stack["server"].stop()  # drains and closes the batcher first
    else:
        stack["batcher"].stop(drain=True)
        stack["batcher"].close()


def _get(url, timeout=30):
    """(status, body text) of one GET; an HTTP error's status too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def _prom_value(text, sample):
    """The value of the exposition line that starts with ``sample``
    (its name and labels), or None."""
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


SCORE_COUNT = ('edl_rpc_server_latency_seconds_count{role="scorer",'
               'method="score"}')
SCORER_FAMILIES = (  # what a mid-round scrape of the scorer must show
    'edl_rpc_server_latency_seconds_bucket{role="scorer",method="score"',
    'edl_scorer_requests_total{outcome="ok"}',
    "edl_scorer_request_latency_seconds_bucket",
    "edl_scorer_batch_size_bucket",
    "edl_scorer_batches_total",
    "edl_scorer_queue_depth",
    "edl_scorer_queue_rows",
)


def _serve_round(torch, stack, requests, scrape_endpoint=True):
    """All of ``requests`` at once through ``stack``, the flash launches
    counted over them alone; returns what the checks read."""
    import numpy as np

    from elasticdl_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ok = _counter("edl_scorer_requests_total")
    forwards0 = ok.value(outcome="ok")
    forward_s0 = _forward_seconds()
    count0 = _score_count()
    _reset_counters()
    scrape = {}
    scraper = None
    if stack.get("url") and scrape_endpoint:
        # mid-round: once the first request has answered, while the
        # rest of the round is still queued or running
        def mid_round():
            deadline = time.monotonic() + 120
            while (_score_count() == count0
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            scrape["after_requests"] = _score_count() - count0
            scrape["metrics"] = _get(stack["url"] + "/metrics")
            scrape["healthz"] = _get(stack["url"] + "/healthz")

        scraper = threading.Thread(target=mid_round, daemon=True)
        scraper.start()
    replies, latency, wall = _fire(stack["score"], requests)
    if scraper is not None:
        scraper.join(timeout=120)
        scrape["final"] = _get(stack["url"] + "/metrics")
    out = {
        "score_counts": [count0, _score_count()],
        "wall_s": wall,
        "launches": fa.launches.count,
        "bwd_launches": fa.bwd_dq_launches.count + fa.bwd_dkv_launches.count,
        "counts": _counts(),
        "forwards": int(ok.value(outcome="ok") - forwards0),
        "forward_s": _forward_seconds() - forward_s0,
        "peak": torch.cuda.max_memory_allocated(),
    }
    for i, reply in enumerate(replies):
        _check_reply(torch, reply, i)
    out["replies"] = [r["output"] for r in replies]
    out["latency_ms"] = [x * 1e3 for x in latency]
    lat = np.asarray(out["latency_ms"])
    out["p50_ms"] = float(np.percentile(lat, 50))
    out["p99_ms"] = float(np.percentile(lat, 99))
    out["scrape"] = scrape
    return out


def _score_count():
    """Requests the scorer's instrumented ``score`` has answered in
    this process."""
    from elasticdl_tpu_torch.utils import profiling

    got = profiling.metrics.histogram(
        "edl_rpc_server_latency_seconds", labels=("role", "method")
    ).data(role="scorer", method="score")
    return got[2] if got else 0


def _scorer_telemetry(stack, rounds, requests):
    """The scorer's endpoint over the member's rounds, each scraped
    mid-round (once its first forward answered) and after it: the
    mid-round scrape shows every family and ``serving``, a ``score``
    count inside the round, and the scrape after it one count per
    request of the round; the events and the trace answer."""
    rec = {"rounds": []}
    bad = []
    for r in rounds:
        scrape = r["scrape"]
        status, text = scrape.get("metrics", (None, ""))
        health = scrape.get("healthz", (None, ""))
        c0, c1 = r["score_counts"]
        one = {
            "mid_round_after_requests": scrape.get("after_requests"),
            "mid_round_status": status,
            "missing": [f for f in SCORER_FAMILIES if f not in text],
            "mid_round_score_count": _prom_value(text, SCORE_COUNT),
            "healthz": [health[0], health[1].strip()],
            "score_count_before_after": [c0, c1],
            "scraped_after": _prom_value(
                scrape.get("final", (None, ""))[1], SCORE_COUNT),
        }
        rec["rounds"].append(one)
        mid = one["mid_round_score_count"]
        if (status != 200 or one["missing"]
                or one["healthz"] != [200, "serving"]
                or c1 - c0 != len(requests) or one["scraped_after"] != c1
                or mid is None or not c0 < mid <= c1):
            bad.append(one)
    rec["families"] = list(SCORER_FAMILIES)
    rec["events_status"] = _get(stack["url"] + "/events")[0]
    rec["trace_status"] = _get(stack["url"] + "/trace")[0]
    if bad or rec["events_status"] != 200 or rec["trace_status"] != 200:
        raise PhaseError("the scorer's telemetry endpoint: %s" % rec)
    return rec


def _arm_record(rounds, stack):
    """One way of serving, over its rounds."""
    import numpy as np

    lat = np.concatenate([r["latency_ms"] for r in rounds])
    forwards = sum(r["forwards"] for r in rounds)
    wall = sum(r["wall_s"] for r in rounds)
    return {
        "load_s": stack["load_s"],
        "warmup_s": stack["warmup_s"],
        "rounds": len(rounds),
        "round_p50_p99_ms": [[r["p50_ms"], r["p99_ms"]] for r in rounds],
        "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p99_ms": float(np.percentile(lat, 99)),
        "forwards": forwards,
        "forward_ms_mean": sum(r["forward_s"] for r in rounds)
        / max(forwards, 1) * 1e3,
        "flash_launches": [r["launches"] for r in rounds],
        "wall_s": wall,
        "tokens_per_s": len(rounds) * N_REQUESTS * SEQ_LEN / wall,
        "max_memory_allocated": max(int(r["peak"]) for r in rounds),
    }


def _flash_nodes(module):
    """The flash op's nodes in a serving member's graph."""
    return sum(1 for n in module.graph.nodes
               if str(n.target) == "edl_tpu_torch.flash_fwd.default")


def _member_across_devices(torch, tmp, requests):
    """One small member (the LM at two layers) written on the CPU and
    served on the card, held against the same weights' member written on
    the card: the moved graph (its parameters, constants and the devices
    written into it) launches the kernel and answers alike."""
    from elasticdl_tpu_torch.common.export import load_export
    from elasticdl_tpu_torch.ops import flash_attention as fa

    cfg = dict(SLICE_CFG, num_layers=2)
    cpu_model = _lm_weights(torch, cfg, "cpu")
    card_model = _lm_weights(torch, cfg, "cpu").to(DEVICE)
    rec = {"layers": cfg["num_layers"]}
    outs = {}
    for where, model in (("cpu", cpu_model), ("card", card_model)):
        d = os.path.join(tmp, "member-%s" % where)
        rec["%s_artifact_s" % where] = _lm_member(torch, model, cfg, d)
        exported = load_export(d)
        rec["%s_traced_on" % where] = exported.manifest["torch_serving"][
            "device"]
        tokens = {"tokens": requests[0]}
        exported.serve(tokens, DEVICE)  # loads (and moves) the member
        torch.cuda.synchronize()
        fa.launches.reset()
        outs[where] = exported.serve(
            {"tokens": requests[0].repeat(3, 0)}, DEVICE).float()
        torch.cuda.synchronize()
        rec["%s_launches" % where] = fa.launches.count
        rec["%s_output_device" % where] = str(outs[where].device)
    err = float((outs["cpu"] - outs["card"]).abs().max())
    rec.update(max_abs_err=err, bitwise=bool(torch.equal(
        outs["cpu"], outs["card"])), atol=REPLY_ATOL)
    if not (err <= REPLY_ATOL and rec["cpu_launches"] == cfg["num_layers"]
            and rec["card_launches"] == cfg["num_layers"]
            and rec["cpu_output_device"].startswith("cuda")):
        raise PhaseError("the member written on the CPU, served on the "
                         "card: %s" % rec)
    return rec


def phase_slice(torch, tmp):
    """Serve the slice's LM through the scorer's entry points, from the
    artifact's serving member (the main path) and, for the same
    requests, from the module the scorer rebuilds from a params-only
    artifact, in turns (member, rebuilt, rebuilt, member); returns
    {kernel: (launches over the member's first round of served
    requests, their launch shapes)}."""
    import numpy as np

    from elasticdl_tpu_torch.ops import flash_attention as fa

    export_root = os.path.join(tmp, "exports")
    rebuild_root = os.path.join(tmp, "exports-rebuild")
    export_s = _make_artifacts(torch, export_root, rebuild_root)
    rng = np.random.default_rng(SEED)
    requests = [
        rng.integers(0, SLICE_CFG["vocab_size"], (1, SEQ_LEN),
                     dtype=np.int32)
        for _ in range(N_REQUESTS)
    ]
    from elasticdl_tpu_torch.utils import profiling

    stacks = {}
    rounds = {"member": [], "rebuilt": []}
    try:
        stacks["member"] = _stack(torch, export_root, requests,
                                  telemetry=True)
        stacks["rebuilt"] = _stack(torch, rebuild_root, requests)
        for arm in ("member", "rebuilt", "rebuilt", "member"):
            rounds[arm].append(_serve_round(torch, stacks[arm], requests))
        telemetry = _scorer_telemetry(stacks["member"], rounds["member"],
                                      requests)
        # the same round with the plane off (EDL_METRICS=0's switch):
        # the replies and the launches do not move
        profiling.set_metrics_enabled(False)
        try:
            # nothing is counted with the plane off: no scrape waits
            off = _serve_round(torch, stacks["member"], requests,
                               scrape_endpoint=False)
        finally:
            profiling.set_metrics_enabled(True)
    finally:
        for stack in stacks.values():
            _stop_stack(stack)
    main_round = rounds["member"][0]
    bitwise = all(torch.equal(a, b) for a, b in zip(
        main_round["replies"], off["replies"]))
    telemetry["metrics_off"] = {
        "bitwise": bitwise,
        # the replies are host copies: a difference is read only when
        # there is one
        "max_abs_err": 0.0 if bitwise else max(
            float((a.float() - b.float()).abs().max())
            for a, b in zip(main_round["replies"], off["replies"])),
        "flash_launches": off["launches"],
        "latency_p50_ms": off["p50_ms"],
        "score_counts": off["score_counts"],
    }
    telemetry["metrics_on_latency_p50_ms"] = [
        r["p50_ms"] for r in rounds["member"]]
    if not (telemetry["metrics_off"]["bitwise"]
            and off["launches"] == main_round["launches"]
            and off["score_counts"][0] == off["score_counts"][1]):
        raise PhaseError("the member's round with the telemetry plane off "
                         "against it on: %s" % telemetry["metrics_off"])
    scorer = stacks["member"]["scorer"]
    served = scorer.model()
    rebuilt_model = stacks["rebuilt"]["scorer"].model()
    layers = SLICE_CFG["num_layers"]
    if not served.serves_member or _flash_nodes(served.module) != layers:
        raise PhaseError(
            "the scorer did not serve through the member's graph with %d "
            "flash_fwd op nodes (serves_member %s)"
            % (layers, served.serves_member))
    if rebuilt_model.serves_member:
        raise PhaseError("the params-only artifact served a member")
    for r in rounds["member"]:
        if (r["forwards"] < 1 or r["launches"] != layers * r["forwards"]
                or r["bwd_launches"]):
            raise PhaseError(
                "flash_fwd launched %d times over %d forwards (expected "
                "%d per forward), the backward kernels %d times (expected "
                "0)" % (r["launches"], r["forwards"], layers,
                        r["bwd_launches"]))
    main = rounds["member"][0]

    # checks (not counted): each reply against the rebuilt module's reply
    # to the same request, against its request scored solo, and against
    # the rebuilt model with attention swapped for the plain version
    rebuilt_err = max(
        float((a.float() - b.float()).abs().max())
        for m, r in zip(rounds["member"], rounds["rebuilt"])
        for a, b in zip(m["replies"], r["replies"]))
    solo_err = 0.0
    for i, req in enumerate(requests):
        solo, _ = scorer.score({"tokens": req})
        solo_err = max(
            solo_err,
            float((solo.float().cpu() - main["replies"][i].float())
                  .abs().max()),
        )

    def plain_attention(q, k, v):
        return fa.plain_flash_with_lse(q, k, v, True)[0]

    plain_err = 0.0
    module = rebuilt_model.module
    with torch.inference_mode():
        for s in range(0, N_REQUESTS, MAX_BATCH):
            chunk = np.concatenate(requests[s : s + MAX_BATCH])
            ref = module({"tokens": chunk}, attention_fn=plain_attention)
            got = torch.cat(main["replies"][s : s + MAX_BATCH])
            plain_err = max(
                plain_err,
                float((ref.float().cpu() - got.float()).abs().max()),
            )
    across = _member_across_devices(torch, tmp, requests)
    member = _arm_record(rounds["member"], stacks["member"])
    rec = {
        "phase": "slice",
        "model": dict(SLICE_CFG, params="float32"),
        "export_s": export_s,
        "served_through": "serving member (torch.export)",
        "member_flash_nodes": _flash_nodes(served.module),
        "requests": N_REQUESTS,
        "seq_len": SEQ_LEN,
        "order": ["member", "rebuilt", "rebuilt", "member"],
        "forwards": main["forwards"],
        "rows_per_forward": N_REQUESTS / main["forwards"],
        "flash_launches": main["launches"],
        "flash_launches_per_forward": main["launches"] / main["forwards"],
        "flash_bwd_launches": main["bwd_launches"],
        "member": member,
        "rebuilt": _arm_record(rounds["rebuilt"], stacks["rebuilt"]),
        "latency_p50_ms": member["latency_p50_ms"],
        "latency_p99_ms": member["latency_p99_ms"],
        "member_vs_rebuilt_max_abs_err": rebuilt_err,
        "solo_max_abs_err": solo_err,
        "plain_attention_max_abs_err": plain_err,
        "atol": REPLY_ATOL,
        "member_across_devices": across,
        "telemetry": telemetry,
    }
    emit(rec)
    if not (rebuilt_err <= REPLY_ATOL and solo_err <= REPLY_ATOL
            and plain_err <= REPLY_ATOL):
        raise PhaseError(
            "served logits disagree: the rebuilt module %.4g, solo %.4g, "
            "plain attention %.4g (atol %g)"
            % (rebuilt_err, solo_err, plain_err, REPLY_ATOL)
        )
    chunk = np.concatenate(requests[:MAX_BATCH])
    _profile_forward(torch, lambda: served.predict({"tokens": chunk}),
                     rows=MAX_BATCH)
    return main["counts"]


def _n_params(named):
    return sum(p.numel() for p in named.values())


def train_flops(n_params, batch, seq):
    """bench.py's model FLOPs of one step: 6 per parameter per token
    (forward and backward products; the tied head is inside n_params)
    plus causal attention, 3.5 x 2 b l^2 h d / 2 per layer."""
    cfg = SLICE_CFG
    attn = (
        3.5 * 2 * batch * seq * seq * cfg["num_heads"] * cfg["head_dim"] / 2
        * cfg["num_layers"]
    )
    return 6.0 * n_params * batch * seq + attn


def _clone_state(torch, ts, optimizer):
    """An independent copy of a train state (parameters and AdamW
    moments), for a check step that must not touch the trainer's."""
    import copy

    from elasticdl_tpu_torch.training.step import TrainState

    params = {
        n: p.detach().clone().requires_grad_(True)
        for n, p in ts.params.items()
    }
    opt = optimizer(list(params.values()))
    opt.load_state_dict(copy.deepcopy(ts.opt_state.state_dict()))
    return TrainState(params, dict(ts.state), opt, ts.version)


def _formula_attention(torch, f32_out=False):
    """Causal attention through the forward kernel, differentiated by
    ``plain_flash_bwd`` in float32 from the kernel's own out and lse: the
    function the backward kernels compute, without their bf16 products.
    With ``f32_out`` the backward takes delta from an output computed in
    float32 instead of the kernel's rounded one: what that rounding
    costs."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    class KernelFwdPlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = fa._flash_fwd_kernel(q, k, v, True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse = ctx.saved_tensors
            if f32_out:
                out = fa.plain_flash_with_lse(
                    q.float(), k.float(), v.float(), True
                )[0]
            return fa.plain_flash_bwd(q, k, v, out, lse, g, True)

    return KernelFwdPlainBwd.apply


def _grad_checks(torch, model, loss_fn, weights, tokens):
    """Gradients of one batch from ``weights`` through the kernels
    (``make_grad_fn``, the training path) against (1) the model with
    ``use_flash=False`` (plain attention) and (2) the same forward kernel
    with ``plain_flash_bwd`` as the backward; and (3) that backward with
    a float32 delta against plain attention. Per comparison, the losses
    and the worst and median per-tensor relative L2 difference."""
    from torch.func import functional_call

    from elasticdl_tpu_torch.training.step import make_grad_fn

    grad_fn = make_grad_fn(model, loss_fn)
    feats = {"tokens": tokens}
    kernel = grad_fn(weights, {}, feats, tokens)[:2]
    model.use_flash = False
    try:
        plain = grad_fn(weights, {}, feats, tokens)[:2]
    finally:
        model.use_flash = True

    def formula(f32_out):
        leaves = {
            n: w.detach().requires_grad_(True) for n, w in weights.items()
        }
        out = functional_call(
            model, leaves, (feats,),
            {"attention_fn": _formula_attention(torch, f32_out)},
        )
        loss = loss_fn(out, tokens)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def compare(a, b):
        (loss_a, grads_a), (loss_b, grads_b) = a, b
        rel = {n: _rel_l2(torch, grads_a[n], grads_b[n]) for n in grads_a}
        worst = max(rel, key=rel.get)
        return {
            "loss": float(loss_a),
            "loss_other": float(loss_b),
            "max_rel_l2": rel[worst],
            "worst_tensor": worst,
            "median_rel_l2": float(sorted(rel.values())[len(rel) // 2]),
        }

    return {
        "plain_attention": compare(kernel, plain),
        "plain_flash_bwd": compare(kernel, formula(False)),
        "f32_delta_vs_plain_attention": compare(formula(True), plain),
    }


def _check_counts(counts, want, what):
    got = {name: n for name, (n, _) in counts.items()}
    if got != want:
        raise PhaseError(
            "%s launched %s; expected %s" % (what, got, want)
        )


def phase_train(torch):
    """Train the slice's LM through ``AllReduceTrainer.train_step``; returns
    the launch counts of the timed steps (the main path)."""
    import numpy as np

    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
    from elasticdl_tpu_torch.training import step as tstep

    layers = SLICE_CFG["num_layers"]
    vocab = SLICE_CFG["vocab_size"]
    with torch.device("meta"):
        model = zoo.custom_model(**SLICE_CFG)
    optimizer = zoo.optimizer(LR)
    trainer = AllReduceTrainer(
        model, zoo.loss, optimizer, seed=SEED, device=DEVICE
    )
    rng = np.random.default_rng(SEED)
    batches = [
        rng.integers(0, vocab, (TRAIN_BATCH, SEQ_LEN), dtype=np.int32)
        for _ in range(1 + TRAIN_STEPS)
    ]

    def step(tokens):
        return trainer.train_step({"tokens": tokens}, tokens)

    t0 = time.perf_counter()
    trainer.init_from_batch(batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_weights = {
        n: p.detach().clone() for n, p in trainer.train_state.params.items()
    }
    t0 = time.perf_counter()
    warm_loss = float(step(batches[0]))  # warm-up, not timed
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    step_ms, losses = [], []
    for tokens in batches[1:]:
        t0 = time.perf_counter()
        losses.append(step(tokens))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [warm_loss] + [float(x) for x in losses]
    ts = trainer.train_state
    params = ts.params
    n_params = _n_params(params)

    # the main path's checks
    if not all(np.isfinite(losses)):
        raise PhaseError("non-finite training loss: %s" % losses)
    if trainer.version != 1 + TRAIN_STEPS:
        raise PhaseError(
            "version %d after %d steps" % (trainer.version, 1 + TRAIN_STEPS)
        )
    _check_counts(
        counts,
        {k: layers * TRAIN_STEPS for k in KERNELS},
        "%d train steps" % TRAIN_STEPS,
    )
    # the step leaves each parameter's gradient in .grad (a parameter
    # the loss does not reach gets zeros): every one finite and nonzero
    bad_grad = [
        n for n, p in params.items() if not bool(torch.isfinite(p.grad).all())
    ]
    zero_grad = [
        n for n, p in params.items() if not float(p.grad.abs().max()) > 0
    ]
    if bad_grad or zero_grad:
        raise PhaseError(
            "gradients: non-finite for %s, zero for %s" % (bad_grad, zero_grad)
        )

    # checks (not counted): kernel gradients against plain attention
    # (gated from the seeded init, reported from the trained weights) and
    # against plain_flash_bwd on the same forward (gated from both), then
    # one rematerialized step from the trained state, on one batch
    tokens = rng.integers(0, vocab, (GRAD_CHECK_BATCH, SEQ_LEN),
                          dtype=np.int32)
    init_check = _grad_checks(torch, model, zoo.loss, init_weights, tokens)
    del init_weights
    trained_check = _grad_checks(
        torch, model, zoo.loss,
        {n: p.detach() for n, p in params.items()}, tokens,
    )
    loss_k = trained_check["plain_attention"]["loss"]
    remat = {}
    for on in (False, True):
        clone = _clone_state(torch, ts, optimizer)
        check_step = tstep.make_train_step(model, zoo.loss, remat=on)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        loss = check_step(clone, {"tokens": tokens}, tokens)[1]
        remat[on] = {
            "loss": float(loss),
            "launches": {k: v[0] for k, v in _counts().items()},
            "peak_rise_bytes": int(
                torch.cuda.max_memory_allocated() - base
            ),
        }
        del clone
    for on, fwd in ((False, layers), (True, 2 * layers)):
        _check_counts(
            {k: (n, None) for k, n in remat[on]["launches"].items()},
            {"flash_fwd": fwd, "flash_bwd_dq": layers,
             "flash_bwd_dkv": layers},
            "one step with remat=%s" % on,
        )

    med = float(np.median(step_ms))
    tokens_per_step = TRAIN_BATCH * SEQ_LEN
    flops = train_flops(n_params, TRAIN_BATCH, SEQ_LEN)
    rec = {
        "phase": "train",
        "model": dict(SLICE_CFG, params="float32", n_params=n_params),
        "optimizer": "AdamW lr %g wd 1e-4" % LR,
        "batch": TRAIN_BATCH,
        "seq_len": SEQ_LEN,
        "steps_timed": TRAIN_STEPS,
        "init_s": init_s,
        "warmup_s": warm_s,
        "step_ms": step_ms,
        "step_ms_median": med,
        "tokens_per_s": tokens_per_step / med * 1e3,
        "flops_per_step": flops,
        "mfu": flops / (med / 1e3) / PEAK_OPS_PER_S["bfloat16"],
        "max_memory_allocated": int(peak),
        "losses": losses,
        "version": trainer.version,
        "launches": {k: v[0] for k, v in counts.items()},
        "grad_check": {
            "batch": GRAD_CHECK_BATCH,
            "vs_plain_attention": {
                "seeded_init": init_check["plain_attention"],
                "trained": trained_check["plain_attention"],
                "rel_l2_limit": GRAD_REL_L2,
                "gated": "seeded_init",
            },
            "vs_plain_flash_bwd": {
                "seeded_init": init_check["plain_flash_bwd"],
                "trained": trained_check["plain_flash_bwd"],
                "rel_l2_limit": FORMULA_REL_L2,
                "gated": "both",
            },
            "plain_flash_bwd_f32_delta_vs_plain_attention": {
                "seeded_init": init_check["f32_delta_vs_plain_attention"],
                "trained": trained_check["f32_delta_vs_plain_attention"],
                "gated": "neither (says what the bf16 delta costs)",
            },
            "trained_after_steps": 1 + TRAIN_STEPS,
        },
        "remat": dict(remat[True], batch=GRAD_CHECK_BATCH),
        "no_remat": dict(remat[False], batch=GRAD_CHECK_BATCH),
    }
    emit(rec)
    gated = [(init_check["plain_attention"], GRAD_REL_L2)] + [
        (check["plain_flash_bwd"], FORMULA_REL_L2)
        for check in (init_check, trained_check)
    ]
    for got, limit in gated:
        if got["max_rel_l2"] > limit or not np.isclose(
            got["loss"], got["loss_other"], rtol=limit
        ):
            raise PhaseError(
                "kernel gradients disagree: %s (limit %g)" % (got, limit)
            )
    for on in (False, True):
        if abs(remat[on]["loss"] - loss_k) > REMAT_LOSS_RTOL * abs(loss_k):
            raise PhaseError(
                "remat=%s step loss %r differs from %r"
                % (on, remat[on]["loss"], loss_k)
            )
    _profile(
        torch, "train_step", lambda: float(step(batches[-1])),
        batch=TRAIN_BATCH, seq_len=SEQ_LEN,
    )
    return counts


# ---------------------------------------------------------------------------
# the mixture of experts on one card, the sequence axis over two ranks
# ---------------------------------------------------------------------------

# Switch-Base-8's widths (Fedus et al., "Switch Transformers", 2021:
# d_model 768, d_ff 3072, 8 experts, top-1; the reference zoo's routing
# defaults) at the slice's vocabulary, cut to 4 layers for time
MOE_CFG = dict(
    SLICE_CFG, num_layers=4, num_experts=8, moe_num_selected=1,
    moe_capacity_factor=2.0, moe_aux_loss_coef=0.01,
)
MOE_TRAIN_STEPS = 3  # timed, after one warm-up step
MOE_REQUESTS = 16
# the ring: SLICE_CFG's widths at 2 layers, two ranks on one card (gloo),
# data 1 x seq 2, B = 2 at L = 2048: each shard 1024 long, the
# reference's flash threshold
RING_CFG = dict(SLICE_CFG, num_layers=2)
RING_RANKS = 2
RING_BATCH = 2
RING_LEN = 2048
RING_STEPS = 3  # timed per rank, after the counted step
# the ring's loss against the whole sequence's: that one is the zoo's
# loss on bf16 logits, a bf16 scalar (a step of 2^-8 to 2^-7 of its
# value), the ring's the float32 sum of its shards' terms
RING_LOSS_RTOL = 1e-2
RING_LIMIT_S = 420  # the ranks' processes, boot included
# in the same ranks: a 1-layer MoE LM with 2 experts over an expert group
# of 2 (capacity = every token: none overflows) against its dense fallback
RING_MOE_CFG = dict(SLICE_CFG, num_layers=1, num_experts=2,
                    moe_capacity_factor=2.0)
RING_MOE_TOKENS = (2, SEQ_LEN)
# and tensor parallelism: RING_CFG over a {"data": 1, "model": 2} mesh of
# the same two ranks (6 heads, 1,536 hidden units, 16,384 vocabulary rows
# a rank), B 4 x L 1,024 through mesh_axes / param_shardings /
# AllReduceTrainer: one counted AdamW step, then TP_STEPS timed ones
TP_BATCH = 4
TP_STEPS = 3
TP_BYTES_SHARE = 0.55  # a rank's parameter bytes, of the whole model's
TP_SHAPE = (TP_BATCH, RING_CFG["num_heads"] // RING_RANKS,
            RING_CFG["head_dim"], SEQ_LEN)  # a rank's attention (B, H, D, L)


class _Routing:
    """Records the expert choices of the MoE blocks' forwards (one
    ``parallel/expert.topk_gate`` call a block, in order) and, with
    ``replay`` set, hands recorded choices back in their place, with the
    gate probabilities of the current logits (so the gate's gradient
    flows as before): a forward routed as another one was."""

    def __init__(self, replay=None):
        from elasticdl_tpu_torch.parallel import expert

        self._expert = expert
        self._orig = expert.topk_gate
        self.replay = replay
        self.calls = []

    def __enter__(self):
        self._expert.topk_gate = self._gate
        return self

    def __exit__(self, *exc):
        self._expert.topk_gate = self._orig

    def _gate(self, logits, k):
        import torch

        if self.replay is None:
            idx, gate = self._orig(logits, k)
        else:
            idx = self.replay[len(self.calls)]
            gate = torch.softmax(logits.float(), dim=-1).gather(-1, idx)
            if k > 1:
                gate = gate / gate.sum(dim=-1, keepdim=True)
        self.calls.append(idx.detach())
        return idx, gate

    def histogram(self, n_experts):
        """Tokens routed to each expert, per block."""
        import torch

        return [torch.bincount(i.reshape(-1), minlength=n_experts).tolist()
                for i in self.calls]


def _moe_grad_check(torch, model, loss_fn, weights, tokens):
    """Gradients of one batch from ``weights`` through the kernels
    (``make_grad_fn``, with the balance loss) against the same model on
    plain attention: routed as the kernels' forward was (the gated
    comparison), and routed freely (reported: where bf16 rounding moves
    a token's top-1 expert, its whole contribution moves with it; the
    tokens that moved are counted). The losses, the aux terms, the worst
    and median per-tensor relative L2 difference."""
    from elasticdl_tpu_torch.training.step import aux_loss_total, make_grad_fn

    grad_fn = make_grad_fn(model, loss_fn)
    feats = {"tokens": tokens}
    with _Routing() as kernel_routes:
        kernel = grad_fn(weights, {}, feats, tokens)
    model.use_flash = False
    try:
        with _Routing(replay=kernel_routes.calls):
            pinned = grad_fn(weights, {}, feats, tokens)
        with _Routing() as free_routes:
            free = grad_fn(weights, {}, feats, tokens)
    finally:
        model.use_flash = True

    def compare(other):
        rel = {n: _rel_l2(torch, kernel[1][n], other[1][n])
               for n in kernel[1]}
        worst = max(rel, key=rel.get)
        return {
            "loss": float(kernel[0]),
            "loss_other": float(other[0]),
            "aux": float(aux_loss_total(kernel[2])),
            "aux_other": float(aux_loss_total(other[2])),
            "max_rel_l2": rel[worst],
            "worst_tensor": worst,
            "median_rel_l2": float(sorted(rel.values())[len(rel) // 2]),
        }

    return dict(
        compare(pinned),
        free_routing=dict(
            compare(free),
            tokens_rerouted_by_block=[
                int((a != b).any(dim=-1).sum())
                for a, b in zip(kernel_routes.calls, free_routes.calls)],
        ),
    )


def _moe_gradients_reach(torch, params, routed):
    """Names (an expert's with its index) whose gradient is wrong: not
    finite, or zero where it must move (every parameter but the expert
    stacks, and every expert's slice that ``routed`` (tokens per expert,
    per block) gave a token), or nonzero for an expert routed none."""
    bad = []
    for name, p in params.items():
        g = p.grad
        if not name.endswith(("experts_up", "experts_down")):
            if not (bool(torch.isfinite(g).all())
                    and float(g.abs().max()) > 0):
                bad.append(name)
            continue
        block = int(name.split(".")[1])
        for e in range(g.shape[0]):
            moved = float(g[e].abs().max())
            want = routed[block][e] > 0
            if not bool(torch.isfinite(g[e]).all()) or (moved > 0) != want:
                bad.append("%s[%d] (%d tokens, max |g| %g)"
                           % (name, e, routed[block][e], moved))
    return bad


def _moe_artifacts(torch, model, export_root, rebuild_root):
    """The trained MoE LM's artifacts: with the serving member under
    ``export_root``, params-only under ``rebuild_root``."""
    from elasticdl_tpu_torch.common.convert import to_named
    from elasticdl_tpu_torch.common.export import (
        export_model,
        export_provenance,
    )

    member_s = _lm_member(torch, model, MOE_CFG,
                          os.path.join(export_root, "v1"))
    t0 = time.perf_counter()
    export_model(
        os.path.join(rebuild_root, "v1"),
        to_named(model.state_dict(), MOE_CFG["num_heads"],
                 MOE_CFG["head_dim"]),
        1,
        metadata=export_provenance(
            "", MODEL_DEF, ",".join("%s=%r" % kv for kv in MOE_CFG.items())),
    )
    return {"member_artifact_s": member_s,
            "params_only_artifact_s": time.perf_counter() - t0}


def phase_moe(torch, tmp):
    """The MoE LM (MOE_CFG, the dense fallback) trained through
    ``AllReduceTrainer.train_step`` on TRAIN_BATCH x SEQ_LEN tokens, then
    served through its member behind the scorer's entry points; returns
    {"moe_train": launches of the timed steps, "moe_serve": launches of
    the member's round}."""
    import numpy as np

    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
    from elasticdl_tpu_torch.training.step import aux_loss_total

    layers, vocab = MOE_CFG["num_layers"], MOE_CFG["vocab_size"]
    with torch.device("meta"):
        model = zoo.custom_model(**MOE_CFG)
    trainer = AllReduceTrainer(model, zoo.loss, zoo.optimizer(LR), seed=SEED,
                               device=DEVICE)
    rng = np.random.default_rng(SEED + 11)
    batches = [
        rng.integers(0, vocab, (TRAIN_BATCH, SEQ_LEN), dtype=np.int32)
        for _ in range(1 + MOE_TRAIN_STEPS)
    ]
    trainer.init_from_batch(batches[0])
    # checks (not counted): the kernels' gradients against plain
    # attention's from the seeded init
    check_tokens = rng.integers(0, vocab, (GRAD_CHECK_BATCH, SEQ_LEN),
                                dtype=np.int32)
    grad_check = _moe_grad_check(
        torch, model, zoo.loss,
        {n: p.detach().clone() for n, p in trainer.train_state.params.items()},
        check_tokens,
    )
    # the first step, from the seeded init, routes as it is recorded:
    # its gradients reach exactly the experts that were given tokens
    t0 = time.perf_counter()
    with _Routing() as first_routes:
        warm_loss = float(trainer.train_step({"tokens": batches[0]},
                                             batches[0]))
    warm_s = time.perf_counter() - t0
    routed = first_routes.histogram(MOE_CFG["num_experts"])
    unreached = _moe_gradients_reach(torch, trainer.train_state.params,
                                     routed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    step_ms, losses, aux = [], [], []
    for tokens in batches[1:]:
        t0 = time.perf_counter()
        losses.append(trainer.train_step({"tokens": tokens}, tokens))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        aux.append(float(aux_loss_total(trainer.train_state.state)))
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [warm_loss] + [float(x) for x in losses]
    params = trainer.train_state.params
    aux_entries = sorted(n for n in trainer.train_state.state
                         if "aux_loss" in n.split("."))
    problems = []
    if not all(np.isfinite(losses)):
        problems.append("non-finite loss %s" % losses)
    try:
        _check_counts(counts, {k: layers * MOE_TRAIN_STEPS for k in KERNELS},
                      "%d MoE train steps" % MOE_TRAIN_STEPS)
    except PhaseError as e:
        problems.append(str(e))
    if unreached:
        problems.append("first step's gradients: %s" % unreached)
    nonfinite = [n for n, p in params.items()
                 if not bool(torch.isfinite(p.grad).all())]
    if nonfinite:
        problems.append("non-finite gradients: %s" % nonfinite)
    if len(aux_entries) != layers or not all(
            np.isfinite(a) and a > 0 for a in aux):
        problems.append("aux_loss entries %s, values %s" % (aux_entries, aux))
    if grad_check["max_rel_l2"] > GRAD_REL_L2 or not np.isclose(
            grad_check["loss"], grad_check["loss_other"], rtol=GRAD_REL_L2):
        problems.append("kernel gradients against plain attention: %s "
                        "(limit %g)" % (grad_check, GRAD_REL_L2))
    med = float(np.median(step_ms))
    train = {
        "step_ms": step_ms,
        "step_ms_median": med,
        "tokens_per_s": TRAIN_BATCH * SEQ_LEN / med * 1e3,
        "warmup_s": warm_s,
        "max_memory_allocated": int(peak),
        "losses": losses,
        "aux_loss": aux,
        "aux_loss_entries": aux_entries,
        "launches": {k: v[0] for k, v in counts.items()},
        "launches_per_step": {k: v[0] / MOE_TRAIN_STEPS
                              for k, v in counts.items()},
        "grad_check": dict(grad_check, batch=GRAD_CHECK_BATCH,
                           rel_l2_limit=GRAD_REL_L2,
                           gated="seeded_init, the kernels' routing"),
        "first_step_tokens_per_expert": routed,
        "n_params": _n_params(params),
    }

    # serving: the trained weights' member behind a ScorerServer, the
    # rebuilt module's replies to the same requests beside it
    export_root = os.path.join(tmp, "moe-exports")
    rebuild_root = os.path.join(tmp, "moe-exports-rebuild")
    export_s = _moe_artifacts(torch, model, export_root, rebuild_root)
    del trainer, params
    torch.cuda.empty_cache()
    requests = [
        rng.integers(0, vocab, (1, SEQ_LEN), dtype=np.int32)
        for _ in range(MOE_REQUESTS)
    ]
    stack = _stack(torch, export_root, requests, telemetry=True)
    try:
        main = _serve_round(torch, stack, requests, scrape_endpoint=False)
    finally:
        _stop_stack(stack)
    served = stack["scorer"].model()
    # the module the scorer rebuilds from the params-only artifact, on
    # the same requests in the batcher's batches
    from elasticdl_tpu_torch.serving.scorer import ScorerModel

    rebuilt = ScorerModel(os.path.join(rebuild_root, "v1"),
                          device=DEVICE).rebuild()
    with torch.inference_mode():
        rebuilt_replies = [
            rebuilt({"tokens": np.concatenate(requests[i:i + MAX_BATCH])})
            for i in range(0, len(requests), MAX_BATCH)
        ]
    rebuilt_replies = [r.float().cpu() for r in torch.cat(rebuilt_replies)]
    del rebuilt
    if not served.serves_member or _flash_nodes(served.module) != layers:
        problems.append("the MoE member is not served through %d flash "
                        "op nodes" % layers)
    if (main["forwards"] < 1 or main["launches"] != layers * main["forwards"]
            or main["bwd_launches"]):
        problems.append(
            "served: flash_fwd %d over %d forwards (want %d each), "
            "backward %d" % (main["launches"], main["forwards"], layers,
                             main["bwd_launches"]))
    rebuilt_err = max(
        float((a.float()[0] - b).abs().max())
        for a, b in zip(main["replies"], rebuilt_replies))
    if rebuilt_err > REPLY_ATOL:
        problems.append("member against rebuilt module: %.4g (atol %g)"
                        % (rebuilt_err, REPLY_ATOL))
    rec = {
        "phase": "moe",
        "model": dict(MOE_CFG, params="float32"),
        "source": "Switch-Base-8 widths (Fedus et al. 2021), 4 layers",
        "batch": TRAIN_BATCH,
        "seq_len": SEQ_LEN,
        "steps_timed": MOE_TRAIN_STEPS,
        "train": train,
        "export_s": export_s,
        "serve": {
            "requests": MOE_REQUESTS,
            "forwards": main["forwards"],
            "flash_launches": main["launches"],
            "flash_launches_per_forward": main["launches"]
            / max(1, main["forwards"]),
            "latency_p50_ms": main["p50_ms"],
            "latency_p99_ms": main["p99_ms"],
            "served_by": "ScorerServer -> MicroBatcher -> the member",
            "member_vs_rebuilt_max_abs_err": rebuilt_err,
            "atol": REPLY_ATOL,
            "peak": main["peak"],
        },
        "problems": problems,
    }
    emit(rec)
    if problems:
        raise PhaseError("moe: " + "; ".join(problems))
    return {"moe_train": counts, "moe_serve": main["counts"]}


def _ring_tokens(vocab):
    import numpy as np

    return np.random.default_rng(SEED + 21).integers(
        0, vocab, (RING_BATCH, RING_LEN), dtype=np.int32)


def _counts_json(counts):
    return {k: [n, [[list(key), c] for key, c in shapes.items()]]
            for k, (n, shapes) in counts.items()}


def _counts_from_json(counts):
    return {k: (n, {tuple(key): c for key, c in shapes})
            for k, (n, shapes) in counts.items()}


def _ring_block_checks(torch, axis):
    """The kernel ring against the plain ring (every block through
    ``plain_flash_with_lse``/``plain_flash_bwd``) on this rank's shards of
    seeded bf16 q, k, v (RING_BATCH x RING_LEN, SLICE_CFG's heads): each
    block the kernels run against its plain version on the same inputs,
    and the ring's out, dq, dk, dv against the plain ring's, by relative
    L2."""
    from elasticdl_tpu_torch.parallel import ring_attention as ra

    h, d = RING_CFG["num_heads"], RING_CFG["head_dim"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    full = [torch.randn((RING_BATCH, RING_LEN, h, d), device=DEVICE,
                        generator=gen, dtype=torch.bfloat16)
            for _ in range(4)]
    part = RING_LEN // axis.size
    mine = [t[:, axis.index * part:(axis.index + 1) * part].contiguous()
            for t in full]
    blocks = []
    fwd, bwd = ra._block_fwd, ra._block_bwd

    def checked_fwd(q, kk, vv, causal, plain):
        got = fwd(q, kk, vv, causal, plain)
        want = fwd(q, kk, vv, causal, True)
        blocks.append({"pass": "fwd", "causal": causal,
                       "out": _rel_l2(torch, got[0], want[0]),
                       "lse": _rel_l2(torch, got[1], want[1])})
        return got

    def checked_bwd(q, kk, vv, out, lse, g, delta, causal, plain):
        got = bwd(q, kk, vv, out, lse, g, delta, causal, plain)
        want = bwd(q, kk, vv, out, lse, g, delta, causal, True)
        blocks.append(dict(
            {"pass": "bwd", "causal": causal},
            **{n: _rel_l2(torch, a, b)
               for n, a, b in zip(("dq", "dk", "dv"), got, want)}))
        return got

    def ring(plain):
        q, k, v = (t.clone().requires_grad_(True) for t in mine[:3])
        out = ra.ring_flash_attention(q, k, v, axis, causal=True,
                                      plain=plain)
        out.backward(mine[3])
        return [out.detach(), q.grad, k.grad, v.grad]

    ra._block_fwd, ra._block_bwd = checked_fwd, checked_bwd
    try:
        kernel = ring(False)
    finally:
        ra._block_fwd, ra._block_bwd = fwd, bwd
    plain = ring(True)
    totals = {n: _rel_l2(torch, a, b)
              for n, a, b in zip(("out", "dq", "dk", "dv"), kernel, plain)}
    return blocks, totals


def _ring_moe_check(torch, mesh_shape):
    """The 1-layer MoE LM routed over an ``expert`` group of the ranks
    against its dense fallback from the same weights: the logits (max
    abs error) and every gradient (relative L2)."""
    import numpy as np

    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.training.step import make_grad_fn

    mesh = create_mesh(mesh_shape, devices=[DEVICE])
    tokens = np.random.default_rng(SEED + 41).integers(
        0, RING_MOE_CFG["vocab_size"], RING_MOE_TOKENS, dtype=np.int32)
    got = {}
    for arm, cfg, m in (("routed", dict(RING_MOE_CFG, mesh=mesh), mesh),
                        ("dense", RING_MOE_CFG, None)):
        model = _lm_weights(torch, cfg, DEVICE)
        got[arm] = make_grad_fn(model, zoo.loss, mesh=m)(
            dict(model.named_parameters()), dict(model.named_buffers()),
            {"tokens": tokens}, tokens)
        del model
    rel = {n: _rel_l2(torch, got["routed"][1][n], got["dense"][1][n])
           for n in got["dense"][1]}
    worst = max(rel, key=rel.get)
    return {
        "mesh": mesh_shape,
        "tokens": list(RING_MOE_TOKENS),
        "loss": float(got["routed"][0]),
        "loss_dense": float(got["dense"][0]),
        "logits_max_abs_err": float(
            (got["routed"][3].float() - got["dense"][3].float()).abs().max()),
        "grad_max_rel_l2": rel[worst],
        "worst_tensor": worst,
    }


def _tp_tokens(vocab):
    import numpy as np

    return np.random.default_rng(SEED + 51).integers(
        0, vocab, (TP_BATCH, SEQ_LEN), dtype=np.int32)


def _digest(t):
    import hashlib

    return hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _state_digests(params, opt_state, names):
    """{checkpoint leaf path: sha256 of its bytes} of host params and an
    optimizer state dict (``names``: the parameters in order)."""
    leaves = {"params/" + n: p for n, p in params.items()}
    for idx, slots in opt_state["state"].items():
        for slot, value in slots.items():
            leaves["opt_state/%s/%s" % (names[idx], slot)] = value
    return {path: _digest(t) for path, t in leaves.items()}


def _tp_trainer(torch, model, mesh=None, specs=None):
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    trainer = AllReduceTrainer(model, zoo.loss, zoo.optimizer(LR), seed=SEED,
                               mesh=mesh, param_specs=specs, device=DEVICE)
    tokens = _tp_tokens(RING_CFG["vocab_size"])
    trainer.init_from_batch(({"tokens": tokens}, tokens))
    return trainer, tokens


def _tp_rank(torch, rank, out):
    """The TP phase in one ring rank: ``mesh_axes`` -> a ``WorldMesh``
    {"data": 1, "model": RING_RANKS} over the ring's world ->
    ``build_distributed_model`` / ``param_shardings`` ->
    ``AllReduceTrainer`` drawing the whole model from SEED; the counted
    step's launches and gathered gradients (rank 0 writes them), the
    timed steps, the gathered logits against the whole model's on the
    card, each rank's ``save_sharded``, and rank 0's digests of the
    gathered host state. Returns the rank's record."""
    import numpy as np
    import torch.distributed as dist

    from elasticdl_tpu_torch.parallel.sharding import gather_part
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.parallel import collectives
    from elasticdl_tpu_torch.parallel.mesh import create_mesh, global_shape
    from elasticdl_tpu_torch.training.step import make_forward_fn

    t = RING_RANKS
    rec = {"problems": []}
    mesh = create_mesh(zoo.mesh_axes(t, tensor_parallel=t), devices=[DEVICE])
    model = zoo.build_distributed_model(mesh, tensor_parallel=t, **RING_CFG)
    trainer, tokens = _tp_trainer(
        torch, model, mesh, zoo.param_shardings(mesh, tensor_parallel=t))
    specs = trainer.param_specs
    params = trainer.train_state.params
    rec["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in params.values())
    rec["whole_param_bytes"] = sum(
        int(np.prod(global_shape(specs[n], tuple(p.shape), mesh)
                    if n in specs else p.shape)) * p.element_size()
        for n, p in params.items())
    rec["param_share"] = rec["param_bytes"] / rec["whole_param_bytes"]
    if rec["param_share"] > TP_BYTES_SHARE:
        rec["problems"].append("rank %d holds %.4f of the whole model's "
                               "parameter bytes" % (rank, rec["param_share"]))
    torch.cuda.reset_peak_memory_stats()
    # the main path: one counted AdamW step
    torch.cuda.synchronize()
    _reset_counters()
    loss = trainer.train_step({"tokens": tokens}, tokens)
    torch.cuda.synchronize()
    counts = _counts()
    rec["counts"] = _counts_json(counts)
    try:
        _check_counts(counts, {k: RING_CFG["num_layers"] for k in KERNELS},
                      "tp rank %d's step" % rank)
    except PhaseError as e:
        rec["problems"].append(str(e))
    rec["loss"] = float(loss)
    grads = {n: gather_part(p.grad, specs.get(n), mesh)
             for n, p in params.items()}
    if rank == 0:
        np.savez(os.path.join(out, "tp_grads.npz"), **{
            n: g.float().cpu().numpy() for n, g in grads.items()})
    del grads
    step_ms, staged = [], []
    for _ in range(TP_STEPS):
        collectives.staging.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step({"tokens": tokens}, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        staged.append(collectives.staging.snapshot())
    rec.update(step_ms=step_ms, staging=staged,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    # the trained parts: the gathered logits, the checkpoint
    ts = trainer.train_state
    local = make_forward_fn(model)(ts.params, ts.state, {"tokens": tokens})
    logits = collectives.all_gather(local, mesh.axis("model"), dim=-1)
    del local
    trainer.save_sharded(os.path.join(out, "tp_ckpt", "ckpt_v%d"
                                      % trainer.version))
    host = trainer.get_host_state()
    dist.barrier()
    rec["version"] = trainer.version
    if rank == 0:
        rec["digests"] = _state_digests(host.params, host.opt_state,
                                        list(host.params))
        np.save(os.path.join(out, "tp_logits.npy"),
                logits.cpu().view(torch.int16).numpy())
        whole = _lm_weights(torch, RING_CFG, DEVICE)
        whole.load_state_dict(host.params)
        want = make_forward_fn(whole)(dict(whole.named_parameters()), {},
                                      {"tokens": tokens})
        rec["logits_vs_whole_max_abs_err"] = float(
            (logits.float() - want.float()).abs().max())
        if rec["logits_vs_whole_max_abs_err"] > REPLY_ATOL:
            rec["problems"].append(
                "gathered TP logits against the whole model's: %.4g "
                "(limit %g)" % (rec["logits_vs_whole_max_abs_err"],
                                REPLY_ATOL))
    return rec


def _tp_whole(torch):
    """The whole model's counted step on the TP batch in this process,
    from the same seed: (model, trainer, loss, {name: gradient})."""
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )

    model = zoo.custom_model(**RING_CFG)
    trainer, tokens = _tp_trainer(torch, model)
    loss = float(trainer.train_step({"tokens": tokens}, tokens))
    grads = {n: p.grad.detach().clone()
             for n, p in trainer.train_state.params.items()}
    return model, trainer, loss, grads


def _tp_checks(torch, whole, ranks, out):
    """The TP ranks' records against the whole model in this process:
    the gathered gradients and the loss of the counted step, the
    checkpoint (``load_sharded_to_host`` against rank 0's digests of the
    gathered state, bitwise), and the whole model restored from it on
    the card answering the batch through the flash forward against the
    ranks' gathered logits. Returns (record, problems)."""
    import numpy as np

    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )
    from elasticdl_tpu_torch.training.step import make_forward_fn

    model, trainer, loss, grads = whole
    tps = [r["tp"] for r in ranks]
    problems = []
    gathered = dict(np.load(os.path.join(out, "tp_grads.npz")))
    rel = {n: _rel_l2(torch, torch.from_numpy(gathered[n]).to(DEVICE), g)
           for n, g in grads.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(tps[0]["loss"] - loss) / abs(loss)
    if rel[worst] > GRAD_REL_L2 or loss_rel > RING_LOSS_RTOL:
        problems.append(
            "TP against the whole model: loss %.6g / %.6g, gradients %.4g "
            "at %s (limits %g, %g)" % (tps[0]["loss"], loss, rel[worst],
                                       worst, RING_LOSS_RTOL, GRAD_REL_L2))
    directory = os.path.join(out, "tp_ckpt", "ckpt_v%d" % tps[0]["version"])
    _, leaves = load_sharded_to_host(directory)
    digests = {p: _digest(v) for p, v in leaves.items()
               if p.startswith(("params/", "opt_state/"))}
    if digests != tps[0]["digests"]:
        differ = sorted(set(digests.items()) ^ set(tps[0]["digests"].items()))
        problems.append("the TP checkpoint is not the gathered state "
                        "bitwise: %s" % differ[:4])
    trainer.restore_sharded(directory)
    tokens = _tp_tokens(RING_CFG["vocab_size"])
    ts = trainer.train_state
    torch.cuda.synchronize()
    _reset_counters()
    restored = make_forward_fn(model)(ts.params, ts.state,
                                      {"tokens": tokens})
    torch.cuda.synchronize()
    counts = _counts()
    tp_logits = torch.from_numpy(
        np.load(os.path.join(out, "tp_logits.npy"))).view(torch.bfloat16)
    err = float((restored.float().cpu() - tp_logits.float()).abs().max())
    if err > REPLY_ATOL or counts["flash_fwd"][0] != RING_CFG["num_layers"]:
        problems.append(
            "the restored whole model against the TP logits: %.4g (limit "
            "%g), %d flash forwards" % (err, REPLY_ATOL,
                                        counts["flash_fwd"][0]))
    rec = {
        "mesh": {"data": 1, "model": RING_RANKS},
        "batch": TP_BATCH,
        "seq_len": SEQ_LEN,
        "heads_per_rank": TP_SHAPE[1],
        "loss_tp": tps[0]["loss"],
        "loss_whole": loss,
        "loss_rel": loss_rel,
        "grad_max_rel_l2": rel[worst],
        "grad_worst_tensor": worst,
        "grad_median_rel_l2": float(sorted(rel.values())[len(rel) // 2]),
        "checkpoint_leaves": len(leaves),
        "checkpoint_bitwise": digests == tps[0]["digests"],
        "restored_vs_tp_logits_max_abs_err": err,
        "restored_flash_fwd": counts["flash_fwd"][0],
        "ranks": [{k: r["tp"].get(k) for k in (
            "param_bytes", "whole_param_bytes", "param_share",
            "max_memory_allocated", "step_ms", "staging",
            "logits_vs_whole_max_abs_err")} for r in ranks],
    }
    return rec, problems


# the collective step in the ring's ranks: deepfm_edl at the zoo's widths
# (tables of ZOO_VOCAB x 64 and ZOO_VOCAB x 1, f32) through
# build_collective_model on data RING_RANKS, PS_BATCH zipf records a rank
COLLECTIVE_PARAMS = "vocab_size=%d" % (1 << 20)
COLLECTIVE_STEPS = 3  # timed per rank, after the counted step
COLLECTIVE_REL_L2 = 1e-5  # f32: the ranks against the whole model


def _collective_batch(rank):
    """Rank ``rank``'s PS_BATCH records: 10 zipf ids each (as the Z
    cells draw them) and 0/1 labels."""
    ids, labels = _zipf_ids(PS_BATCH, SEED + 70 + rank)
    return {"feature": ids}, labels.reshape(-1, 1).astype("int32")


def _collective_trainer(torch):
    """The collective plane's trainer as the elastic worker builds it for
    deepfm_edl (``_collective_hooks``), on the card, from SEED."""
    from elasticdl_tpu_torch.common.model_utils import (
        get_dict_from_params_str,
    )
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as zoo,
    )
    from elasticdl_tpu_torch.parallel.elastic import ElasticDPTrainer
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    with torch.device("meta"):
        host = zoo.build_host_model(
            **get_dict_from_params_str(COLLECTIVE_PARAMS))
    return ElasticDPTrainer(
        host, zoo.loss, zoo.optimizer(), seed=SEED, device=DEVICE,
        **ElasticAllReduceWorker._collective_hooks(zoo, COLLECTIVE_PARAMS))


def _collective_rank(torch, rank, port, out):
    """The collective step in one ring rank, after its TP step: the
    ring's world is left and the trainer forms its own on ``port``
    (``ElasticDPTrainer.establish``: the mesh {"data": RING_RANKS}, each
    rank's half of the tables drawn whole from SEED); one counted step on
    the rank's PS_BATCH zipf records (its flash launches, loss, routed
    ids, overflow and staging), the touched rows and the tower written
    for the parent, then COLLECTIVE_STEPS timed steps, each rank's table
    bytes and peak. Returns the rank's record."""
    import numpy as np
    import torch.distributed as dist

    from elasticdl_tpu_torch.nn.hbm_embedding import a2a_overflow_total
    from elasticdl_tpu_torch.parallel.distributed import WorldSpec

    rec = {"problems": []}
    dist.destroy_process_group()  # the ring's; the trainer forms its own
    trainer = _collective_trainer(torch)
    batch = _collective_batch(rank)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.establish(WorldSpec("127.0.0.1:%d" % port, RING_RANKS, rank, 1),
                      example_batch=batch)
    rec["establish_s"] = time.perf_counter() - t0
    params = trainer.train_state.params
    tables = [n for n in params if n.endswith(".table")]
    rec["mesh"] = trainer.mesh_shape
    rec["table_rows"] = {n: params[n].shape[0] for n in tables}
    rec["table_bytes"] = sum(params[n].numel() * params[n].element_size()
                             for n in tables)
    # the main path: one counted step
    torch.cuda.synchronize()
    _reset_counters()
    loss, live, _ = trainer.train_step(batch[0], batch[1], PS_BATCH)
    torch.cuda.synchronize()
    counts = _counts()
    rec["counts"] = _counts_json(counts)
    try:
        _check_counts(counts, {k: 0 for k in KERNELS},
                      "collective rank %d's step" % rank)
    except PhaseError as e:
        rec["problems"].append(str(e))
    rec.update(loss=loss, live=live, routing=trainer.last_routing,
               overflow=a2a_overflow_total(trainer._module),
               staging_counted=trainer.last_staging)
    if live != RING_RANKS or rec["overflow"] != 0:
        rec["problems"].append("collective step: live %d, overflow %s"
                               % (live, rec["overflow"]))
    # the touched rows this rank holds, and rank 0 the tower
    ids = np.unique(np.concatenate([_collective_batch(r)[0]["feature"]
                                    for r in range(RING_RANKS)]))
    rows = params[tables[0]].shape[0]
    lo = rank * rows
    mine = ids[(ids >= lo) & (ids < lo + rows)]
    index = torch.as_tensor(mine - lo, device=DEVICE)
    np.savez(os.path.join(out, "collective-%d.npz" % rank), ids=mine, **{
        n: (params[n][index] if n in tables else params[n]).detach().cpu()
        .numpy() for n in params if n in tables or rank == 0})
    step_ms, staged, split = [], [], []
    for _ in range(COLLECTIVE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch[0], batch[1], PS_BATCH)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        staged.append(trainer.last_staging)
        split.append(trainer.step_times)
    rec.update(step_ms=step_ms, staging=staged, split=split,
               routing_timed=trainer.last_routing,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    trainer.leave()
    return rec


def _collective_whole(torch):
    """The whole deepfm_edl (the host twin, whole tables) on the card
    from SEED, one SGD step on the ranks' rows: (loss, {name: parameter
    after the step})."""
    import numpy as np

    from elasticdl_tpu_torch.common.model_utils import (
        get_dict_from_params_str,
    )
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    model = zoo.build_host_model(**get_dict_from_params_str(
        COLLECTIVE_PARAMS))
    trainer = AllReduceTrainer(model, zoo.loss, zoo.optimizer(), seed=SEED,
                               device=DEVICE)
    batches = [_collective_batch(r) for r in range(RING_RANKS)]
    features = {"feature": np.concatenate([b[0]["feature"]
                                           for b in batches])}
    labels = np.concatenate([b[1] for b in batches])
    trainer.init_from_batch((features, labels))
    loss = float(trainer.train_step(features, labels))
    return loss, trainer.train_state.params


def _collective_checks(torch, whole, ranks, out):
    """The ranks' collective step against the whole model in this
    process: the loss, the touched rows of both tables (each rank's own)
    and the tower, by relative L2 (COLLECTIVE_REL_L2). Returns (record,
    problems)."""
    import numpy as np

    loss, params = whole
    recs = [r["collective"] for r in ranks]
    problems = []
    got = [dict(np.load(os.path.join(out, "collective-%d.npz" % r)))
           for r in range(RING_RANKS)]
    rel = {}
    for name, p in params.items():
        if name.endswith(".table"):
            ids = np.concatenate([g["ids"] for g in got])
            mine = np.concatenate([g[name] for g in got])
            want = p.detach()[torch.as_tensor(ids, device=DEVICE)]
        else:
            mine, want = got[0][name], p.detach()
        rel[name] = _rel_l2(torch, torch.as_tensor(mine).to(DEVICE), want)
    loss_rel = abs(recs[0]["loss"] - loss) / abs(loss)
    worst = max(rel, key=rel.get)
    if rel[worst] > COLLECTIVE_REL_L2 or loss_rel > COLLECTIVE_REL_L2:
        problems.append(
            "the collective step against the whole model: loss %.8g / "
            "%.8g, %s %.4g (limit %g)" % (recs[0]["loss"], loss, worst,
                                          rel[worst], COLLECTIVE_REL_L2))
    rec = {
        "model": "deepfm_edl_embedding %s (f32), build_collective_model"
                 % COLLECTIVE_PARAMS,
        "mesh": {"data": RING_RANKS},
        "batch_per_rank": PS_BATCH,
        "loss_collective": recs[0]["loss"],
        "loss_whole": loss,
        "loss_rel": loss_rel,
        "rel_l2": rel,
        "rel_l2_limit": COLLECTIVE_REL_L2,
        "touched_rows": int(sum(len(g["ids"]) for g in got)),
        "ranks": [{k: r.get(k) for k in (
            "mesh", "table_rows", "table_bytes", "establish_s", "routing",
            "routing_timed", "overflow", "staging_counted", "step_ms",
            "staging", "split", "max_memory_allocated")} for r in recs],
    }
    return rec, problems


def ring_rank_main(torch, rank, port, out, collective_port):
    """One rank of the ring phase (``--ring-rank``): a gloo world of
    RING_RANKS on the card, the sequence-sharded LM's counted gradient
    step and RING_STEPS timed ones, the block checks, the routed MoE
    check, then the TP phase (``_tp_rank``) over the same world and the
    collective step (``_collective_rank``) in a world of its own on
    ``collective_port``; writes ``rank-<r>.json`` (and rank 0 its
    gradients) under ``out``. Returns the exit code."""
    import numpy as np
    import torch.distributed as dist

    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.parallel import collectives
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.training.step import make_grad_fn

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=RING_RANKS)
    rec = {"rank": rank, "problems": []}
    try:
        mesh = create_mesh({"data": 1, "seq": RING_RANKS}, devices=[DEVICE])
        layers = RING_CFG["num_layers"]
        model = _lm_weights(
            torch, dict(RING_CFG, mesh=mesh, seq_axis="seq"), DEVICE)
        tokens = _ring_tokens(RING_CFG["vocab_size"])
        grad_fn = make_grad_fn(model, zoo.loss, mesh=mesh, seq_axis="seq")
        params = dict(model.named_parameters())

        def step():
            return grad_fn(params, {}, {"tokens": tokens}, tokens)

        # booted (imports, the world, the model on the card): wait for
        # the phase to start
        go = os.path.join(out, "go")
        deadline = time.monotonic() + RING_LIMIT_S
        while not os.path.exists(go):
            if time.monotonic() > deadline:
                raise PhaseError("no go after %d s" % RING_LIMIT_S)
            time.sleep(0.05)

        # the main path: one counted gradient step of the ring
        torch.cuda.synchronize()
        _reset_counters()
        loss, grads, _, _ = step()
        torch.cuda.synchronize()
        counts = _counts()
        rec["counts"] = _counts_json(counts)
        want = layers * (mesh.axis("seq").index + 1)
        try:
            _check_counts(counts, {k: want for k in KERNELS},
                          "ring rank %d's step" % rank)
        except PhaseError as e:
            rec["problems"].append(str(e))
        rec["loss"] = float(loss)
        rec["grad_digest"] = float(sum(
            g.double().sum() for g in grads.values()))
        if rank == 0:
            np.savez(os.path.join(out, "grads.npz"), **{
                n: g.float().cpu().numpy() for n, g in grads.items()})
        del grads
        step_ms, staged = [], []
        for _ in range(RING_STEPS):
            collectives.staging.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            staged.append(collectives.staging.snapshot())
        rec.update(step_ms=step_ms, staging=staged)
        blocks, totals = _ring_block_checks(torch, mesh.axis("seq"))
        rec.update(blocks=blocks, ring_vs_plain_ring=totals)
        limit = REL_L2["bfloat16"]
        worst = max([v for b in blocks for k, v in b.items()
                     if k not in ("pass", "causal")] + list(totals.values()))
        rec["worst_rel_l2"] = worst
        if worst > limit:
            rec["problems"].append(
                "kernel ring against the plain ring: %.4g (limit %g)"
                % (worst, limit))
        fwd_blocks = sum(1 for b in blocks if b["pass"] == "fwd")
        if fwd_blocks != mesh.axis("seq").index + 1:
            rec["problems"].append("%d forward blocks" % fwd_blocks)
        rec["moe"] = _ring_moe_check(torch, {"expert": RING_RANKS})
        if (rec["moe"]["logits_max_abs_err"] > REPLY_ATOL
                or rec["moe"]["grad_max_rel_l2"] > GRAD_REL_L2):
            rec["problems"].append("routed MoE against dense: %s"
                                   % rec["moe"])
        t0 = time.perf_counter()
        rec["tp"] = _tp_rank(torch, rank, out)
        rec["tp"]["seconds"] = time.perf_counter() - t0
        rec["problems"] += rec["tp"].pop("problems")
        t0 = time.perf_counter()
        rec["collective"] = _collective_rank(torch, rank, collective_port,
                                             out)
        rec["collective"]["seconds"] = time.perf_counter() - t0
        rec["problems"] += rec["collective"].pop("problems")
    except Exception as err:  # noqa: BLE001 — reported to the parent
        import traceback

        traceback.print_exc()
        rec["problems"].append("raised %r" % err)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out, "rank-%d.json" % rank), "w") as f:
        json.dump(rec, f)
    return 1 if rec["problems"] else 0


class _RingRanks:
    """The ring phase's RING_RANKS processes of ``--ring-rank``, started
    before the phase: each boots (its imports, the gloo world, the model
    on the card) while the phase before it runs, then waits for
    :meth:`go` before its counted step. :meth:`stop` ends what is left."""

    def __init__(self, tmp):
        self.out = os.path.join(tmp, "ring")
        os.makedirs(self.out, exist_ok=True)
        port, collective_port = _free_port(), _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.started = time.perf_counter()
        self.procs = []
        for r in range(RING_RANKS):
            log = open(os.path.join(self.out, "rank-%d.log" % r), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ring-rank",
                 str(r), "--ring-port", str(port), "--ring-out", self.out,
                 "--collective-port", str(collective_port)],
                env=env, stdout=log, stderr=subprocess.STDOUT), log))
        # they boot while the phase before the ring's runs
        HANDED_ON.update(proc.pid for proc, _ in self.procs)

    def go(self):
        with open(os.path.join(self.out, "go"), "w"):
            pass
        return time.perf_counter()

    def wait(self):
        deadline = time.monotonic() + RING_LIMIT_S
        try:
            for proc, _ in self.procs:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.stop()

    def stop(self):
        for proc, log in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            HANDED_ON.discard(proc.pid)


def phase_ring(torch, ring_ranks):
    """The whole sequence in this process, then ``go`` to the
    ``_RingRanks`` (booted meanwhile) and their records, from the same
    weights; returns {"ring_rank<r>": the launches of rank r's counted
    step}."""
    import numpy as np

    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.training.step import make_grad_fn

    out = ring_ranks.out
    # the whole 2,048 in this process, the same weights, the flash
    # kernels, before the ranks step
    model = _lm_weights(torch, RING_CFG, DEVICE)
    tokens = _ring_tokens(RING_CFG["vocab_size"])
    loss, grads, _, _ = make_grad_fn(model, zoo.loss)(
        dict(model.named_parameters()), {}, {"tokens": tokens}, tokens)
    del model
    # and the whole model's step on the TP batch, and deepfm_edl's on
    # the collective step's
    tp_whole = _tp_whole(torch)
    collective_whole = _collective_whole(torch)
    torch.cuda.synchronize()
    t0 = ring_ranks.go()
    boot_s = t0 - ring_ranks.started
    ring_ranks.wait()
    ranks_s = time.perf_counter() - t0
    procs = ring_ranks.procs
    ranks, problems = [], []
    for r, (proc, _) in enumerate(procs):
        path = os.path.join(out, "rank-%d.json" % r)
        if not os.path.exists(path):
            with open(os.path.join(out, "rank-%d.log" % r)) as f:
                tail = f.read()[-3000:]
            raise PhaseError("ring rank %d exited %s with no record:\n%s"
                             % (r, proc.returncode, tail))
        with open(path) as f:
            ranks.append(json.load(f))
        problems += ["rank %d: %s" % (r, p) for p in ranks[-1]["problems"]]
    gathered = dict(np.load(os.path.join(out, "grads.npz")))
    rel = {n: _rel_l2(torch, torch.from_numpy(gathered[n]).to(DEVICE), g)
           for n, g in grads.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(ranks[0]["loss"] - float(loss)) / abs(float(loss))
    if sorted(gathered) != sorted(grads):
        problems.append("gathered gradients %s, the model's %s"
                        % (sorted(gathered), sorted(grads)))
    if rel[worst] > GRAD_REL_L2 or loss_rel > RING_LOSS_RTOL:
        problems.append(
            "the ring against the whole sequence: loss %.6g / %.6g, "
            "gradients %.4g at %s (limits %g, %g)"
            % (ranks[0]["loss"], float(loss), rel[worst], worst,
               RING_LOSS_RTOL, GRAD_REL_L2))
    if len({r["grad_digest"] for r in ranks}) != 1:
        problems.append("the ranks' reduced gradients differ: %s"
                        % [r["grad_digest"] for r in ranks])
    t_tp = time.perf_counter()
    tp, tp_problems = _tp_checks(torch, tp_whole, ranks, out)
    del tp_whole
    tp["checks_s"] = time.perf_counter() - t_tp
    tp["ranks_s"] = [r["tp"]["seconds"] for r in ranks]
    problems += tp_problems
    t_collective = time.perf_counter()
    collective, collective_problems = _collective_checks(
        torch, collective_whole, ranks, out)
    del collective_whole
    collective["checks_s"] = time.perf_counter() - t_collective
    collective["ranks_s"] = [r["collective"]["seconds"] for r in ranks]
    problems += collective_problems
    rec = {
        "phase": "ring",
        "model": dict(RING_CFG, params="float32"),
        "mesh": {"data": 1, "seq": RING_RANKS},
        "batch": RING_BATCH,
        "seq_len": RING_LEN,
        "shard_len": RING_LEN // RING_RANKS,
        "ranks_after_go_s": ranks_s,
        "ranks_started_before_go_s": boot_s,
        "loss_ring": ranks[0]["loss"],
        "loss_whole": float(loss),
        "loss_rel": loss_rel,
        "loss_rtol": RING_LOSS_RTOL,
        "grad_max_rel_l2": rel[worst],
        "grad_worst_tensor": worst,
        "grad_median_rel_l2": float(sorted(rel.values())[len(rel) // 2]),
        "grad_rel_l2_limit": GRAD_REL_L2,
        "ranks": [
            {k: r.get(k) for k in (
                "rank", "step_ms", "staging", "ring_vs_plain_ring",
                "worst_rel_l2", "moe", "blocks")}
            for r in ranks
        ],
        "launches_by_rank": [
            {k: v[0] for k, v in r.get("counts", {}).items()} for r in ranks
        ],
        "block_rel_l2_limit": REL_L2["bfloat16"],
        "tp": tp,
        "tp_launches_by_rank": [
            {k: v[0] for k, v in r["tp"]["counts"].items()} for r in ranks
        ],
        "collective": collective,
        "collective_launches_by_rank": [
            {k: v[0] for k, v in r["collective"]["counts"].items()}
            for r in ranks
        ],
        "problems": problems,
    }
    emit(rec)
    if problems:
        raise PhaseError("ring: " + "; ".join(problems))
    paths = {"ring_rank%d" % r["rank"]: _counts_from_json(r["counts"])
             for r in ranks}
    paths.update({"tp_rank%d" % r["rank"]: _counts_from_json(
        r["tp"]["counts"]) for r in ranks})
    paths.update({"collective_rank%d" % r["rank"]: _counts_from_json(
        r["collective"]["counts"]) for r in ranks})
    return paths


def _moe_ring_only(torch, which):
    """``--moe-only`` / ``--ring-only``: phases device, build and the one
    named, no result line."""
    try:
        card = phase_device(torch)
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            if which == "moe":
                got = phase_moe(torch, tmp)
            else:
                ring_ranks = _RingRanks(tmp)
                try:
                    got = phase_ring(torch, ring_ranks)
                finally:
                    ring_ranks.stop()
        emit({"phase": which + "_launches",
              "launches": {path: {k: v[0] for k, v in c.items()}
                           for path, c in got.items()}})
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


# ---------------------------------------------------------------------------
# the single-process ALLREDUCE job (ResNet-50)
# ---------------------------------------------------------------------------

JOB_MODEL_DEF = "imagenet_resnet50.imagenet_resnet50.custom_model"
JOB_RECORDS = 896  # synthetic ImageNet-shaped records (bench.py's shape)
JOB_IMAGE = 224
JOB_CLASSES = 1000
JOB_MODEL_PARAMS = ""  # the zoo's defaults (bf16) at JOB_CLASSES classes
JOB_BATCH = 64
JOB_MINIBATCHES_PER_TASK = 2
JOB_CKPT_STEPS = 4
# the profiled job's windows, steps [first, last) from 0: three steps
# between checkpoints, then the step before the v8 checkpoint, the
# checkpoint and the step after it (a window ends as its last step
# starts, so the checkpoint written before step 8 lies inside)
JOB_PROFILE_WINDOWS = {"steps": (4, 7), "checkpoint": (7, 9)}
FUSED_BATCH = 128  # bench.py's bench_resnet step
FUSED_STEPS = 20  # timed, after warm-up
FUSED_WARMUP = 3
# bf16 against f32 from one seeded init on one batch: the outputs by
# relative L2 and the first step's loss, relatively. bf16 keeps 8
# mantissa bits (2^-8 = 0.4 % per rounding) and the network rounds its
# activations at ~100 convolutions and norms; as independent errors that
# is ~4 %, so 5e-2 passes a sound bf16 path and fails a wrong one (a
# missing 1/255 or a swapped layout moves the outputs by O(1)).
BF16_OUT_REL_L2 = 5e-2
BF16_LOSS_RTOL = 1e-2


def write_job_records(torch, data_dir, n=None):
    """``n`` (default JOB_RECORDS) synthetic records from SEED (uint8
    images, labels 1..JOB_CLASSES) as one RecordIO file; returns the
    seconds it took."""
    import numpy as np

    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    os.makedirs(data_dir, exist_ok=True)
    with RecordIOWriter(os.path.join(data_dir, "train-0")) as w:
        for _ in range(n or JOB_RECORDS):
            w.write(
                encode_example(
                    {
                        "image": rng.integers(
                            0, 256, (JOB_IMAGE, JOB_IMAGE, 3), dtype=np.uint8
                        ),
                        "label": np.array(
                            [rng.integers(1, JOB_CLASSES + 1)], np.int64
                        ),
                    }
                )
            )
    return time.perf_counter() - t0


def job_argv(data_dir, ckpt_dir, out_dir=None):
    argv = [
        "train",
        "--job_name", "chip-smoke-resnet50",
        "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", "0",
        "--model_zoo", os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
        "--model_def", JOB_MODEL_DEF,
        "--model_params", JOB_MODEL_PARAMS or "num_classes=%d" % JOB_CLASSES,
        "--training_data", data_dir,
        "--minibatch_size", str(JOB_BATCH),
        "--num_minibatches_per_task", str(JOB_MINIBATCHES_PER_TASK),
        "--num_epochs", "1",
        "--checkpoint_dir", ckpt_dir,
        "--checkpoint_steps", str(JOB_CKPT_STEPS),
        "--device", DEVICE,
        "--log_level", "WARNING",
    ]
    if out_dir:
        argv += ["--output", out_dir]
    return argv


class _StepClock:
    """Times every ``AllReduceWorker._train_batch`` (a step ends in the
    worker's own ``float(loss)``, a device sync) while installed; calls
    ``on_step(i)`` before step i (from 0)."""

    def __init__(self, on_step=None):
        from elasticdl_tpu_torch.worker.allreduce_worker import (
            AllReduceWorker,
        )

        self._cls = AllReduceWorker
        self._orig = AllReduceWorker._train_batch
        self.spans = []  # (start, end) perf_counter seconds
        self._on_step = on_step

    def __enter__(self):
        clock, orig = self, self._orig

        def timed(worker, batch):
            if clock._on_step is not None:
                clock._on_step(len(clock.spans))
            t0 = time.perf_counter()
            try:
                return orig(worker, batch)
            finally:
                clock.spans.append((t0, time.perf_counter()))

        self._cls._train_batch = timed
        return self

    def __exit__(self, *exc):
        self._cls._train_batch = self._orig
        return False


def resnet_flops_per_image(torch, model):
    """Model FLOPs of one training image: 3 x the forward's
    multiply-adds x 2 over every convolution and the dense head (the
    backward does two products per forward product), from the layer
    shapes of one JOB_IMAGE forward."""
    from elasticdl_tpu_torch.nn.layers import Conv

    fwd = []

    def conv_hook(m, inputs, out):
        cout, cin, kh, kw = m.weight.shape
        fwd.append(2.0 * kh * kw * cin * cout * out.shape[2] * out.shape[3])

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            model.eval()
            model({"image": torch.zeros(
                (1, JOB_IMAGE, JOB_IMAGE, 3), dtype=torch.uint8,
                device=model.head.weight.device,
            )})
    finally:
        for h in hooks:
            h.remove()
    fwd.append(2.0 * model.head.in_features * model.head.out_features)
    return 3.0 * sum(fwd), sum(fwd)


def phase_fused_step(torch, card):
    """bench.py's fused ResNet-50 step: b128 at 224x224, uint8 images and
    labels resident on the card, bf16 compute, SGD with momentum, through
    ``AllReduceTrainer.train_step``; FUSED_STEPS timed after warm-up."""
    import numpy as np

    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    model = zoo.custom_model(num_classes=JOB_CLASSES)
    trainer = AllReduceTrainer(
        model, zoo.loss, zoo.optimizer(), seed=SEED, device=DEVICE
    )
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    images = torch.randint(
        0, 256, (FUSED_BATCH, JOB_IMAGE, JOB_IMAGE, 3), generator=gen,
        device=DEVICE, dtype=torch.uint8,
    )
    labels = torch.randint(
        0, JOB_CLASSES, (FUSED_BATCH, 1), generator=gen, device=DEVICE,
        dtype=torch.int32,
    )
    feats = {"image": images}
    trainer.init_from_batch((feats, labels))
    flops, fwd_flops = resnet_flops_per_image(torch, model)
    for _ in range(FUSED_WARMUP):
        trainer.train_step(feats, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(FUSED_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(feats, labels))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise PhaseError("fused step: non-finite loss %s" % losses)
    med = float(np.median(step_ms))
    rec = {
        "phase": "fused_step",
        "card": card,
        "model": "imagenet_resnet50 bf16 (params float32), %d classes"
        % JOB_CLASSES,
        "batch": FUSED_BATCH,
        "image": JOB_IMAGE,
        "optimizer": "SGD lr 0.02 momentum 0.9",
        "steps_timed": FUSED_STEPS,
        "step_ms": step_ms,
        "step_ms_median": med,
        "examples_per_s": FUSED_BATCH / med * 1e3,
        "model_flops_per_image": flops,
        "forward_flops_per_image": fwd_flops,
        "mfu": flops * FUSED_BATCH / (med / 1e3) / PEAK_OPS_PER_S["bfloat16"],
        "max_memory_allocated": int(peak),
        "losses": losses,
    }
    emit(rec)
    return rec


def _bf16_vs_f32(torch, data_dir):
    """One batch of the job's records through the bf16 and the f32 model
    from one seeded init: the eval outputs (relative L2) and the first
    training step's loss."""
    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.data.data_reader import create_data_reader
    from elasticdl_tpu_torch.data.dataset import create_dataset_from_tasks
    from elasticdl_tpu_torch.master.task_dispatcher import Task
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.nn.model_api import init_variables
    from elasticdl_tpu_torch.training.step import make_forward_fn, make_grad_fn

    reader = create_data_reader(data_dir)
    shard = next(iter(reader.create_shards()))
    ds = zoo.dataset_fn(
        create_dataset_from_tasks(
            [Task(shard, 0, JOB_BATCH, 0)], reader
        ),
        Mode.EVALUATION,
        None,
    )
    features, labels = next(iter(ds.batch(JOB_BATCH).device_prefetch(DEVICE)))
    out, loss = {}, {}
    weights = None
    for dtype in ("float32", "bfloat16"):
        model = zoo.custom_model(num_classes=JOB_CLASSES, dtype=dtype).to(
            DEVICE
        )
        if weights is None:
            variables = init_variables(model, SEED)
            weights = {k: v.detach().clone() for k, v in
                       {**variables["params"], **variables["state"]}.items()}
        params = {k: weights[k] for k, _ in model.named_parameters()}
        state = {k: weights[k] for k, _ in model.named_buffers()}
        out[dtype] = make_forward_fn(model)(params, state, features)
        loss[dtype] = float(
            make_grad_fn(model, zoo.loss)(params, state, features, labels)[0]
        )
    reader.close()
    rel = _rel_l2(torch, out["bfloat16"], out["float32"])
    loss_rel = abs(loss["bfloat16"] - loss["float32"]) / abs(loss["float32"])
    return {
        "batch": JOB_BATCH,
        "out_rel_l2": rel,
        "out_rel_l2_limit": BF16_OUT_REL_L2,
        "out_max_abs_err": float(
            (out["bfloat16"] - out["float32"]).abs().max()
        ),
        "loss_bf16": loss["bfloat16"],
        "loss_f32": loss["float32"],
        "loss_rel": loss_rel,
        "loss_rtol": BF16_LOSS_RTOL,
        "ok": rel <= BF16_OUT_REL_L2 and loss_rel <= BF16_LOSS_RTOL,
    }


def _device_intervals(prof):
    """[(start us, end us, name)] of the device's kernels and copies."""
    from torch.autograd import DeviceType

    out = []
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            out.append((evt.time_range.start, evt.time_range.end, evt.name))
    return sorted(out)


def _window_record(torch, prof, wall_ms):
    """Device busy (the union of kernel and copy intervals) against the
    host's wall, the top device ops and the largest device-idle gaps of
    one profiled window."""
    spans = _device_intervals(prof)
    busy_us, gaps, end = 0.0, [], None
    for start, stop, name in spans:
        if end is None or start > end:
            if end is not None:
                gaps.append(((start - end) / 1e3, name))
            busy_us += stop - start
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
    busy_ms = busy_us / 1e3
    gaps.sort(reverse=True)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if spans else None,
        "idle_share": (1 - busy_ms / wall_ms) if spans else None,
        "device_gap_ms_total": sum(g for g, _ in gaps),
        "largest_gaps": [{"ms": g, "before": n[:90]} for g, n in gaps[:8]],
        "top": [
            {"kernel": k[:90], "ms": us / 1e3, "calls": n}
            for us, k, n in _device_rows(prof)[:15]
        ],
    }


def _profile_job(torch, data_dir, ckpt_dir, card):
    """A second job run with torch.profiler on over each window of
    JOB_PROFILE_WINDOWS (from the start of its first step to the start
    of its last), one record each."""
    from torch.profiler import ProfilerActivity, profile

    from elasticdl_tpu_torch import cli

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    profs = {w: profile(activities=activities) for w in JOB_PROFILE_WINDOWS}
    marks = {}

    def on_step(i):
        for window, (first, last) in JOB_PROFILE_WINDOWS.items():
            if i in (first, last):
                torch.cuda.synchronize()
                marks[window, i] = time.perf_counter()
                if i == first:
                    profs[window].start()
                else:
                    profs[window].stop()

    with _StepClock(on_step):
        rc = cli.main(job_argv(data_dir, ckpt_dir))
    out = {}
    for window, (first, last) in JOB_PROFILE_WINDOWS.items():
        if rc != 0 or (window, last) not in marks:
            raise PhaseError("the profiled job ended rc=%s before step %d"
                             % (rc, last))
        wall_ms = (marks[window, last] - marks[window, first]) * 1e3
        out[window] = rec = dict(
            _window_record(torch, profs[window], wall_ms),
            phase="profile",
            of="job_%s" % window,
            steps=[first, last],
            batch=JOB_BATCH,
            card=card,
        )
        emit(rec)
    return out


def phase_job(torch, tmp, fused, card):
    """The single-process ALLREDUCE job through the port's command line
    in this process: master -> task dispatcher -> AllReduceWorker ->
    RecordIO reader, ResNet-50 (bf16, 1000 classes) on JOB_RECORDS
    synthetic records. Returns the flash kernels' launch counts of the
    job (ResNet-50 launches none)."""
    import glob

    import numpy as np

    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    data_dir = os.path.join(tmp, "job-data")
    ckpt_dir = os.path.join(tmp, "job-ckpt")
    out_dir = os.path.join(tmp, "job-export")
    write_s = write_job_records(torch, data_dir)
    jobs = []
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    with _StepClock() as clock:
        rc = cli.main(job_argv(data_dir, ckpt_dir, out_dir), jobs=jobs)
    job_s = time.perf_counter() - t0
    counts = _counts()
    job = jobs[0]
    trainer = job.worker.trainer
    steps = JOB_RECORDS // JOB_BATCH
    losses = job.losses or []

    # the job's outcome
    problems = []
    if rc != 0:
        problems.append("exit code %s" % rc)
    if not job.master.task_d.finished():
        problems.append("the dispatcher has tasks left")
    if trainer.version != steps:
        problems.append("version %d, expected %d" % (trainer.version, steps))
    if len(losses) != steps or not all(np.isfinite(losses)):
        problems.append("losses %s" % losses)
    ts = trainer.train_state
    bad = [n for n, p in ts.params.items()
           if not bool(torch.isfinite(p).all())]
    if bad:
        problems.append("non-finite params %s" % bad)
    moved = sum(
        1 for n, b in ts.state.items()
        if not torch.equal(
            b, torch.zeros_like(b) if n.endswith("mean") else
            torch.ones_like(b)
        )
    )
    if moved != len(ts.state):
        problems.append("%d of %d batch statistics never moved"
                        % (len(ts.state) - moved, len(ts.state)))
    ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_v*")))
    newest = max(ckpts, key=lambda d: int(d.rsplit("_v", 1)[1]),
                 default=None)
    restored_equal = False
    if newest is None:
        problems.append("no ckpt_v* directory")
    else:
        fresh = AllReduceTrainer(
            zoo.custom_model(num_classes=JOB_CLASSES), zoo.loss,
            zoo.optimizer(), seed=SEED + 1, device=DEVICE,
        )
        fresh.init_from_batch(None)
        version = fresh.restore_sharded(newest)
        rs = fresh.train_state
        restored_equal = (
            version == trainer.version
            and all(torch.equal(rs.params[n], p) for n, p in ts.params.items())
            and all(torch.equal(rs.state[n], b) for n, b in ts.state.items())
        )
        if not restored_equal:
            problems.append("restoring %s is not bitwise the final state"
                            % newest)
        del fresh, rs
    manifests = glob.glob(os.path.join(out_dir, "*", "MANIFEST.json"))
    member = None
    if not manifests:
        problems.append("no export manifest under %s" % out_dir)
    elif newest is not None:
        member = _job_member(torch, os.path.dirname(manifests[0]), newest)
        if not member["ok"]:
            problems.append("the artifact's serving member: %s" % member)
    bf16 = _bf16_vs_f32(torch, data_dir)
    if not bf16["ok"]:
        problems.append("bf16 against f32: %s" % bf16)

    # timed steps: the first excluded (it waits for the whole shuffle
    # buffer: the zoo shuffles 1024 records, more than the job has)
    spans = clock.spans
    timed_s = spans[-1][1] - spans[0][1] if len(spans) > 1 else float("nan")
    in_step_s = sum(e - s for s, e in spans[1:])
    job_eps = (len(spans) - 1) * JOB_BATCH / timed_s
    stats = job.worker.input_stats.snapshot()
    rec = {
        "phase": "job",
        "card": card,
        "model": JOB_MODEL_DEF + " (bf16, params float32)",
        "records": JOB_RECORDS,
        "image": JOB_IMAGE,
        "batch": JOB_BATCH,
        "records_per_task": JOB_BATCH * JOB_MINIBATCHES_PER_TASK,
        "checkpoint_steps": JOB_CKPT_STEPS,
        "write_records_s": write_s,
        "job_s": job_s,
        "first_step_end_s": spans[0][1] - t0 if spans else None,
        "steps": len(spans),
        "version": trainer.version,
        "losses": losses,
        "step_ms": [(e - s) * 1e3 for s, e in spans],
        "timed_steps": len(spans) - 1,
        "timed_s": timed_s,
        "timed_in_step_s": in_step_s,
        "timed_between_steps_s": timed_s - in_step_s,
        "examples_per_s": job_eps,
        "fused_examples_per_s": fused["examples_per_s"],
        "job_over_fused": job_eps / fused["examples_per_s"],
        "input_stats": stats,
        "checkpoints": [os.path.basename(d) for d in ckpts],
        "restore_bitwise": restored_equal,
        "export_manifests": len(manifests),
        "serving_member": member,
        "bf16_vs_f32": bf16,
        "launches": {k: v[0] for k, v in counts.items()},
    }
    emit(rec)
    if problems:
        raise PhaseError("job: " + "; ".join(problems))
    del job, trainer, ts, jobs
    _profile_job(
        torch, data_dir, os.path.join(tmp, "job-ckpt-profiled"), card
    )
    return counts, rec


# ---------------------------------------------------------------------------
# evaluation: interleaved rounds, evaluation-only and prediction-only jobs
# ---------------------------------------------------------------------------

EVAL_RECORDS = 256  # validation records: 4 batches, 2 tasks of 128
EVAL_STEPS = 4  # a round each time the version passes 4, 8, 12
# a round's accuracy against the direct forward of its checkpoint: at
# most 2 of the records may differ (cuDNN picks its algorithms per call,
# so a near-tie can flip)
EVAL_TOL_RECORDS = 2
# bf16 outputs of a round or of the predict job against the direct
# forward, by relative L2 (the same inputs and weights: only cuDNN's
# choices of algorithm may differ)
EVAL_REL_L2 = 1e-2


def write_records(data_dir, images, labels):
    """One RecordIO file of (image, label) records; returns seconds."""
    import numpy as np

    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    t0 = time.perf_counter()
    os.makedirs(data_dir, exist_ok=True)
    with RecordIOWriter(os.path.join(data_dir, "records-0")) as w:
        for image, label in zip(images, labels):
            w.write(encode_example(
                {"image": image, "label": np.array([label], np.int64)}
            ))
    return time.perf_counter() - t0


class _Timed:
    """Times every call of ``cls.name`` while installed: ``calls`` holds
    (``key(first argument)`` or None, seconds)."""

    def __init__(self, cls, name, key=None):
        self._cls, self._name, self._key = cls, name, key
        self._orig = getattr(cls, name)
        self.calls = []

    def __enter__(self):
        timer, orig, key = self, self._orig, self._key

        def timed(obj, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(obj, *args, **kwargs)
            finally:
                arg = key(args[0]) if key and args else None
                timer.calls.append((arg, time.perf_counter() - t0))

        setattr(self._cls, self._name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self._cls, self._name, self._orig)
        return False


class _EvalReports:
    """Every evaluation report's pinned version and outputs, in order,
    and its labels counted by version; ``reports`` keeps each whole:
    (pinned version, scored version, outputs, labels), and ``by_key``
    each report's outputs by key (a model may output a dict), with
    ``keyed`` the same four of every report, its outputs by key."""

    def __init__(self):
        from elasticdl_tpu_torch.master.servicer import MasterServicer

        self._cls = MasterServicer
        self._orig = MasterServicer.report_evaluation_metrics
        self.records = {}
        self.outputs = []  # (version, outputs of the report's task)
        self.reports = []
        self.by_key = []
        self.keyed = []

    def __enter__(self):
        reports, orig = self, self._orig

        def spy(servicer, version, outputs, labels, scored_version=None):
            reports.records[version] = (
                reports.records.get(version, 0) + len(labels)
            )
            reports.by_key.append(dict(outputs))
            reports.keyed.append(
                (version, scored_version, dict(outputs), labels))
            if "output" in outputs:
                reports.outputs.append((version, outputs["output"]))
                reports.reports.append(
                    (version, scored_version, outputs["output"], labels)
                )
            return orig(servicer, version, outputs, labels,
                        scored_version=scored_version)

        self._cls.report_evaluation_metrics = spy
        return self

    def __exit__(self, *exc):
        self._cls.report_evaluation_metrics = self._orig
        return False


def _checkpoint_weights(torch, directory):
    """(params, state) of a sharded checkpoint, on the card."""
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )

    _, leaves = load_sharded_to_host(directory)
    params, state = {}, {}
    for path, value in leaves.items():
        head, _, name = path.partition("/")
        if head in ("params", "state"):
            (params if head == "params" else state)[name] = value.to(DEVICE)
    return params, state


def _export_weights(torch, export_dir):
    """(params, fresh BatchNorm statistics) of an export artifact: the
    artifact carries parameters only."""
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.common.model_utils import (
        load_from_checkpoint_file,
    )

    _, named = load_from_checkpoint_file(export_dir)
    params = {k: v.to(DEVICE) for k, v in convert.to_state_dict(named).items()}
    state = {k: b.to(DEVICE) for k, b in job_model().named_buffers()}
    return params, state


def _has_member(export_dir):
    """Whether the artifact at ``export_dir`` lists a serving member."""
    with open(os.path.join(export_dir, "MANIFEST.json")) as f:
        return bool(json.load(f)["artifacts"].get("torch_serving_fn"))


def _job_member(torch, export_dir, newest):
    """The job's artifact served through its member on the card, against
    the direct forward of the newest checkpoint (its running statistics)
    and of the export's parameters with fresh statistics (what a rebuild
    from ``model.chkpt`` serves), on one batch of JOB_BATCH images from
    the seed."""
    import numpy as np

    from elasticdl_tpu_torch.common.export import load_export

    images = np.random.default_rng(SEED + 7).integers(
        0, 256, (JOB_BATCH, JOB_IMAGE, JOB_IMAGE, 3), dtype=np.uint8)
    exported = load_export(export_dir)
    if not exported.has_torch_serving_fn():
        return {"ok": False, "member": False}
    t0 = time.perf_counter()
    got = exported.serve({"image": images}, DEVICE).float()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    want = _direct_forward(torch, *_checkpoint_weights(torch, newest),
                           images)
    fresh = _direct_forward(torch, *_export_weights(torch, export_dir),
                            images)
    rel = _rel_l2(torch, got, want)
    rel_fresh = _rel_l2(torch, got, fresh)
    return {
        "ok": rel <= EVAL_REL_L2 < rel_fresh,
        "member": True,
        "traced_on": exported.manifest["torch_serving"]["device"],
        "images": JOB_BATCH,
        "first_serve_s": first_s,
        "rel_l2_vs_checkpoint": rel,
        "max_abs_err_vs_checkpoint": float((got - want).abs().max()),
        "bitwise_vs_checkpoint": bool(torch.equal(got, want)),
        "rel_l2_vs_fresh_statistics": rel_fresh,
        "tolerance": EVAL_REL_L2,
    }


def job_model():
    """The job's model, built from its --model_params."""
    from elasticdl_tpu_torch.common.model_utils import build_model

    return build_model(
        JOB_MODEL_DEF, JOB_MODEL_PARAMS or "num_classes=%d" % JOB_CLASSES
    )


def _direct_forward(torch, params, state, images):
    """The zoo model's inference forward (BatchNorm on running
    statistics) over ``images`` at JOB_BATCH: outputs as float32 on the
    card."""
    from elasticdl_tpu_torch.training.step import make_forward_fn

    fwd = make_forward_fn(job_model().to(DEVICE))
    out = []
    for i in range(0, len(images), JOB_BATCH):
        x = torch.from_numpy(images[i:i + JOB_BATCH]).to(DEVICE)
        out.append(fwd(params, state, {"image": x}).float())
    return torch.cat(out)


def _accuracy(torch, outputs, labels):
    """Share of rows whose argmax is the zoo's label (stored label - 1)."""
    want = torch.as_tensor(labels - 1, device=outputs.device)
    return float((outputs.argmax(1) == want).float().mean())


def serving_argv(verb, data_flag, data_dir, source_flag, source, zoo):
    return [
        verb,
        "--job_name", "chip-smoke-resnet50-" + verb,
        "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", "0",
        "--model_zoo", zoo,
        "--model_def", JOB_MODEL_DEF,
        "--model_params", JOB_MODEL_PARAMS or "num_classes=%d" % JOB_CLASSES,
        data_flag, data_dir,
        source_flag, source,
        "--minibatch_size", str(JOB_BATCH),
        "--num_minibatches_per_task", str(JOB_MINIBATCHES_PER_TASK),
        "--device", DEVICE,
        "--log_level", "WARNING",
    ]


def _scoring_job(torch, argv, what):
    """Run an evaluate or predict job; returns (job, wall seconds, the
    drain's run seconds, per-eval-task seconds)."""
    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    jobs = []
    t0 = time.perf_counter()
    with _Timed(ElasticAllReduceWorker, "run") as run, _Timed(
        ElasticAllReduceWorker, "_process_eval_task"
    ) as tasks:
        rc = cli.main(argv, jobs=jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0 or not jobs[0].master.task_d.finished():
        raise PhaseError("%s: exit code %s, tasks left %s" % (
            what, rc, jobs[0].master.task_d.queue_depths()))
    return jobs[0], wall, run.calls[0][1], [s for _, s in tasks.calls]


def _tensorboard_files(tb_dir, published):
    """The job's TensorBoard files read back with the port's reader:
    the evaluation service's holds one event per published round at its
    version with the round's metrics (float32), the registry exporter's
    (``*.telemetry``) the process's scalars under ``telemetry/``."""
    import glob

    import numpy as np

    from elasticdl_tpu_torch.common.tb_events import read_events

    rec = {"problems": []}
    files = sorted(glob.glob(os.path.join(tb_dir, "events.out.tfevents.*")))
    rounds = [f for f in files if not f.endswith(".telemetry")]
    exported = [f for f in files if f.endswith(".telemetry")]
    rec["files"] = [os.path.basename(f) for f in files]
    if len(rounds) != 1 or len(exported) != 1:
        rec["problems"].append("tensorboard files %s" % rec["files"])
        return rec
    events = read_events(rounds[0])[1:]  # after the file_version record
    rec["rounds"] = [(step, dict(scalars)) for _, step, scalars in events]
    want = [(r["version"], {k: float(np.float32(v))
                            for k, v in r["metrics"].items()})
            for r in published]
    if rec["rounds"] != want:
        rec["problems"].append("tensorboard rounds %s, published %s"
                               % (rec["rounds"], want))
    telemetry = read_events(exported[0])[1:]
    tags = {t for _, _, scalars in telemetry for t, _ in scalars}
    rec["telemetry_events"] = len(telemetry)
    rec["telemetry_tags"] = len(tags)
    if not telemetry or not all(t.startswith("telemetry/") for t in tags):
        rec["problems"].append("the telemetry exporter's file: %d events, "
                               "tags %s" % (len(telemetry), sorted(tags)))
    return rec


def phase_eval(torch, tmp, job_rec, card):
    """The evaluation plane through the port's command line, on
    ResNet-50 at the job phase's settings. Returns the flash kernels'
    launch counts over the phase (ResNet-50 launches none)."""
    import numpy as np

    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.worker.allreduce_worker import AllReduceWorker

    tol = EVAL_TOL_RECORDS / EVAL_RECORDS
    problems = []
    data_dir = os.path.join(tmp, "job-data")  # the job phase's records
    val_dir = os.path.join(tmp, "eval-val")
    ckpt_dir = os.path.join(tmp, "eval-ckpt")
    out_dir = os.path.join(tmp, "eval-export")
    rng = np.random.default_rng(SEED + 1)
    images = rng.integers(0, 256, (EVAL_RECORDS, JOB_IMAGE, JOB_IMAGE, 3),
                          dtype=np.uint8)
    labels = rng.integers(1, JOB_CLASSES + 1, EVAL_RECORDS)
    write_s = write_records(val_dir, images, labels)
    torch.cuda.synchronize()
    _reset_counters()

    # 1. training with interleaved rounds, and TensorBoard
    jobs = []
    tb_dir = os.path.join(tmp, "eval-tb")
    argv = job_argv(data_dir, ckpt_dir, out_dir) + [
        "--validation_data", val_dir, "--evaluation_steps", str(EVAL_STEPS),
        "--tensorboard_log_dir", tb_dir,
    ]
    t0 = time.perf_counter()
    with _StepClock() as clock, _EvalReports() as reports, _Timed(
        AllReduceWorker, "_process_eval_task",
        key=lambda task: (task.model_version, task.start),
    ) as eval_tasks:
        rc = cli.main(argv, jobs=jobs)
    job_s = time.perf_counter() - t0
    job = jobs[0]
    steps = JOB_RECORDS // JOB_BATCH
    want_rounds = list(range(EVAL_STEPS, steps + 1, EVAL_STEPS))
    published = job.master.evaluation_service.published
    if rc != 0 or job.worker.trainer.version != steps:
        problems.append("train with evaluation: exit code %s, version %d"
                        % (rc, job.worker.trainer.version))
    if [r["version"] for r in published] != want_rounds:
        problems.append("rounds at %s, expected %s"
                        % ([r["version"] for r in published], want_rounds))
    if reports.records != {v: EVAL_RECORDS for v in want_rounds}:
        problems.append("records scored per round %s" % reports.records)
    # each task reports once, in the order the tasks were scored
    scored = [(key, out) for (key, _), (_, out) in
              zip(eval_tasks.calls, reports.outputs)]
    rounds = []
    for r in published:
        v = r["version"]
        directory = os.path.join(ckpt_dir, "ckpt_v%d" % v)
        params, state = _checkpoint_weights(torch, directory)
        direct_out = _direct_forward(torch, params, state, images)
        direct = _accuracy(torch, direct_out, labels)
        got = r["metrics"]["accuracy"]
        rows = [out for _, out in sorted(
            ((k[1], o) for k, o in scored if k[0] == v),
            key=lambda start_out: start_out[0])]
        rel = (_rel_l2(torch, torch.from_numpy(np.concatenate(rows)).to(
            direct_out.device), direct_out) if rows else None)
        rounds.append({
            "version": v,
            "accuracy": got,
            "direct_accuracy": direct,
            "outputs_rel_l2": rel,
            "seconds": sum(sec for k, sec in eval_tasks.calls
                           if k[0] == v),
        })
        if abs(got - direct) > tol + 1e-12:
            problems.append("round v%d reads %s, its checkpoint's direct "
                            "forward %s" % (v, got, direct))
        if rel is None or rel > EVAL_REL_L2:
            problems.append("round v%d outputs %s from its checkpoint's "
                            "direct forward (relative L2)" % (v, rel))
    tensorboard = _tensorboard_files(tb_dir, published)
    if tensorboard["problems"]:
        problems += tensorboard["problems"]
    spans = clock.spans
    timed_s = spans[-1][1] - spans[0][1] if len(spans) > 1 else float("nan")
    eps = (len(spans) - 1) * JOB_BATCH / timed_s
    emit({
        "phase": "eval",
        "of": "train_with_evaluation",
        "tensorboard": tensorboard,
        "card": card,
        "model": JOB_MODEL_DEF + " (bf16, params float32)",
        "records": JOB_RECORDS,
        "eval_records": EVAL_RECORDS,
        "write_eval_records_s": write_s,
        "evaluation_steps": EVAL_STEPS,
        "job_s": job_s,
        "steps": len(spans),
        "timed_s": timed_s,
        "timed_in_step_s": sum(e - b for b, e in spans[1:]),
        "rounds": rounds,
        "round_s_total": sum(r["seconds"] for r in rounds),
        "round_tolerance": tol,
        "examples_per_s": eps,
        "examples_per_s_without_evaluation": job_rec["examples_per_s"],
        "with_over_without": eps / job_rec["examples_per_s"],
    })
    del job, jobs

    # 2. evaluation-only: labels planted from the final checkpoint's own
    # predictions (the first half right, the second half off by one)
    final = os.path.join(ckpt_dir, "ckpt_v%d" % steps)
    params, state = _checkpoint_weights(torch, final)
    direct_out = _direct_forward(torch, params, state, images)
    pred = direct_out.argmax(1).cpu().numpy()
    half = EVAL_RECORDS // 2
    planted = np.concatenate([pred[:half], (pred[half:] + 1) % JOB_CLASSES])
    planted_dir = os.path.join(tmp, "eval-planted")
    write_records(planted_dir, images, planted + 1)
    zoo_dir = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
    records = {}
    for source, flag, value in (
        ("checkpoint", "--checkpoint_dir", ckpt_dir),
        ("export", "--checkpoint_filename_for_init",
         os.path.join(out_dir, sorted(os.listdir(out_dir))[-1])),
    ):
        job, wall, run_s, task_s = _scoring_job(
            torch, serving_argv("evaluate", "--validation_data", planted_dir,
                                flag, value, zoo_dir),
            "evaluate from the " + source,
        )
        got = job.master.evaluation_service.published
        if source == "checkpoint":
            want = 0.5
        else:
            e_params, e_state = _export_weights(torch, value)
            want = _accuracy(torch, _direct_forward(
                torch, e_params, e_state, images), planted + 1)
        acc = got[0]["metrics"]["accuracy"] if len(got) == 1 else None
        if acc is None or abs(acc - want) > tol + 1e-12:
            problems.append("evaluate from the %s reads %s, expected %s"
                            % (source, got, want))
        records[source] = rec = {
            "phase": "eval",
            "of": "evaluate_" + source,
            "card": card,
            "accuracy": acc,
            "expected": want,
            "tolerance": tol,
            "scored_versions": got[0]["scored_versions"] if got else None,
            "job_s": wall,
            "worker_run_s": run_s,
            "task_s": task_s,
            "examples_per_s": EVAL_RECORDS / sum(task_s),
            "examples_per_s_job": EVAL_RECORDS / wall,
        }
        emit(rec)
        del job
    # the checkpoint's evaluation-only job once more, profiled: where its
    # wall goes (the load, the forwards, the drain's empty polls)
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        _scoring_job(
            torch, serving_argv("evaluate", "--validation_data", planted_dir,
                                "--checkpoint_dir", ckpt_dir, zoo_dir),
            "evaluate (profiled)",
        )
    emit(dict(
        _window_record(torch, prof, (time.perf_counter() - t0) * 1e3),
        phase="profile", of="evaluate_checkpoint", card=card,
    ))

    # 3. prediction-only with a capturing processor installed on the zoo
    # module (the job resolves it through the port's zoo package)
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
        BasePredictionOutputsProcessor,
    )

    class Capture(BasePredictionOutputsProcessor):
        def __init__(self):
            self.chunks = []

        def process(self, predictions, worker_id):
            self.chunks.append(np.asarray(predictions))

    capture = Capture()
    handed = []
    orig_get = MasterServicer.get_task

    def get_task(servicer, worker_id, task_type=None):
        res = orig_get(servicer, worker_id, task_type)
        if res.shard_name:
            handed.append((res.start, res.end))
        return res

    zoo.PredictionOutputsProcessor = capture
    MasterServicer.get_task = get_task
    try:
        job, wall, run_s, _ = _scoring_job(
            torch, serving_argv("predict", "--prediction_data", val_dir,
                                "--checkpoint_dir", ckpt_dir, ""),
            "predict",
        )
    finally:
        MasterServicer.get_task = orig_get
        del zoo.PredictionOutputsProcessor
    order = [i for start, end in handed for i in range(start, end)]
    got = np.concatenate(capture.chunks) if capture.chunks else np.zeros(0)
    once = sorted(order) == list(range(EVAL_RECORDS)) and len(got) == len(
        order)
    rel = None
    if once:
        want = direct_out[torch.as_tensor(order, device=direct_out.device)]
        rel = _rel_l2(torch, torch.from_numpy(got).to(want.device), want)
    if not once or rel > EVAL_REL_L2:
        problems.append("predict: records %s (%d rows), rel L2 %s"
                        % (handed, len(got), rel))
    emit({
        "phase": "eval",
        "of": "predict",
        "card": card,
        "records": len(got),
        "every_record_once": once,
        "rel_l2": rel,
        "rel_l2_limit": EVAL_REL_L2,
        "job_s": wall,
        "worker_run_s": run_s,
        "examples_per_s": EVAL_RECORDS / run_s,
        "examples_per_s_job": EVAL_RECORDS / wall,
    })
    counts = _counts()
    if problems:
        raise PhaseError("eval: " + "; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# zoo: the zoo models that need no PS fleet, through every job of the port
# ---------------------------------------------------------------------------

ZOO_VOCAB = 1 << 20  # bench.py's "deepfm_edl_embedding shape class"
ZOO_DEEPFM_ZEROS = 0.1  # the share of ids that are 0 (mask_zero's work)
# (name, model_def, --model_params, records kind, train records,
# validation records, batch, evaluation and checkpoint steps); every
# model at its zoo width, DeepFM's tables at ZOO_VOCAB x 64
ZOO_MODELS = (
    ("mnist_functional_api",
     "mnist_functional_api.mnist_functional_api.custom_model", "",
     "mnist", 1024, 256, 64, 8),
    ("cifar10_subclass", "cifar10_subclass.cifar10_subclass.CustomModel",
     "", "cifar", 1024, 256, 64, 8),
    ("cifar10_functional_api",
     "cifar10_functional_api.cifar10_functional_api.custom_model", "",
     "cifar", 1024, 256, 64, 8),
    ("resnet50_subclass", "resnet50_subclass.resnet50_subclass.CustomModel",
     "num_classes=10,dtype='float32'", "imagenet", 256, 128, 64, 2),
    ("deepfm_functional_api",
     "deepfm_functional_api.deepfm_functional_api.custom_model",
     "input_dim=%d" % ZOO_VOCAB, "frappe", 16384, 4096, 1024, 8),
    ("deepfm_edl_embedding",
     "deepfm_edl_embedding.deepfm_edl_embedding.custom_model",
     "vocab_size=%d" % ZOO_VOCAB, "frappe", 16384, 4096, 1024, 8),
)
# the reference's "cifar10_subclass (allreduce mode)": two workers, one
# epoch; over two 1024-record shuffle buffers, so both get data at once
ZOO_ELASTIC_RECORDS = 2304
# card against CPU, float32 with TF32 off, dropout the identity: the
# outputs and the loss by relative L2 / relative difference, each
# parameter's update (after - before) by relative L2. cuDNN and oneDNN sum
# in other orders (~1e-6 on the outputs); a wrong layout or scale moves
# them by O(1)
ZOO_CARD_CPU_TOL = {"outputs": 1e-4, "loss": 1e-4, "update": 1e-3}
ZOO_CARD_CPU_RESNET_BATCH = 8  # ResNet-50's CPU step at b64 takes minutes
ZOO_HBM_STEPS = 10  # DeepFM on the HBM plane, card against CPU
# the reference's bound for the HBM plane against the dense one
# (tests/test_hbm_deepfm.py): atomics order the card's scatter-add
ZOO_HBM_TOL = (2e-4, 2e-5)
ZOO_PROFILE_STEPS = 3


def _zoo_records(kind, n, seed):
    """``n`` encoded records of a kind, from ``seed``: MNIST and CIFAR-10
    float pixels in [0, 255), ImageNet-shaped uint8 images with labels
    1..10, frappe-shaped id rows (ZOO_DEEPFM_ZEROS of them 0) with 0/1
    labels."""
    import numpy as np

    from elasticdl_tpu_torch.data.example import encode_example

    rng = np.random.default_rng(seed)
    if kind == "frappe":
        ids = rng.integers(1, ZOO_VOCAB, (n, 10), dtype=np.int64)
        ids[rng.random((n, 10)) < ZOO_DEEPFM_ZEROS] = 0
        labels = rng.integers(0, 2, n)
        feats = [{"feature": row} for row in ids]
    elif kind == "imagenet":
        feats = [{"image": rng.integers(0, 256, (JOB_IMAGE, JOB_IMAGE, 3),
                                        dtype=np.uint8)} for _ in range(n)]
        labels = rng.integers(1, 11, n)
    else:
        pixels = 784 if kind == "mnist" else 32 * 32 * 3
        images = rng.random((n, pixels), dtype=np.float32) * 255
        feats = [{"image": image} for image in images]
        labels = rng.integers(0, 10, n)
    return [
        encode_example(dict(f, label=np.array([y], np.int64)))
        for f, y in zip(feats, labels)
    ]


def _write_encoded(data_dir, records):
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    os.makedirs(data_dir, exist_ok=True)
    with RecordIOWriter(os.path.join(data_dir, "records-0")) as w:
        for r in records:
            w.write(r)


def _zoo_argv(verb, model_def, params, batch, *extra):
    argv = [
        verb,
        "--job_name", "chip-smoke-zoo-" + verb,
        "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", "0",
        "--model_zoo", "",
        "--model_def", model_def,
        "--minibatch_size", str(batch),
        "--num_minibatches_per_task", "2",
        "--device", DEVICE,
        "--log_level", "WARNING",
    ] + list(extra)
    return argv + (["--model_params", params] if params else [])


def _zoo_batches(torch, zoo, records, batch, mode):
    """The zoo's own dataset_fn over ``records`` (no shuffle), batched."""
    from elasticdl_tpu_torch.data.dataset import Dataset

    ds = zoo.dataset_fn(Dataset.from_tensors(records), mode, None)
    return list(ds.batch(batch))


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zoo_model(model_def, params):
    """The model a direct forward scores: the host twin where the zoo has
    one, else ``model_def`` itself."""
    from elasticdl_tpu_torch.common.model_utils import (
        build_model,
        get_dict_from_params_str,
        load_zoo_module,
    )

    zoo = load_zoo_module(model_def)
    if hasattr(zoo, "build_host_model"):
        return zoo.build_host_model(**(get_dict_from_params_str(params)
                                       or {}))
    return build_model(model_def, params)


def _zoo_direct(torch, model, params, state, batches):
    """Inference forward of ``params`` over the feature batches: the
    outputs as {key: float32 rows on the card}."""
    from elasticdl_tpu_torch.training.step import make_forward_fn

    fwd = make_forward_fn(model.to(DEVICE))
    out = {}
    for features in batches:
        got = fwd(params, state, features)
        for k, v in (got if isinstance(got, dict) else {"output": got}
                     ).items():
            out.setdefault(k, []).append(v.float())
    return {k: torch.cat(v) for k, v in out.items()}


def _zoo_accuracy(torch, outputs, labels):
    """Accuracy as the zoo's metric computes it: argmax against the label
    (the model's labels, 0-based), or for DeepFM logit > 0."""
    want = torch.as_tensor(labels, device=DEVICE).reshape(-1)
    if "logits" in outputs:
        return float(((outputs["logits"].reshape(-1) > 0).long()
                      == want).float().mean())
    return float((outputs["output"].argmax(1) == want).float().mean())


def _zoo_rel(torch, got, want):
    """The largest relative L2 over the outputs' keys."""
    return max(_rel_l2(torch, got[k], want[k]) for k in want)


def _zoo_job(torch, tmp, card, entry):
    """One zoo model through ``train`` (with validation rounds and
    checkpoints), ``evaluate`` and ``predict``; returns (its record, the
    problems found)."""
    import numpy as np

    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.common.model_utils import load_zoo_module
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
    from elasticdl_tpu_torch.worker.allreduce_worker import AllReduceWorker
    from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
        BasePredictionOutputsProcessor,
    )

    name, model_def, params, kind, n_train, n_val, batch, every = entry
    problems = []
    root = os.path.join(tmp, "zoo-" + name)
    train_dir, val_dir = root + "-train", root + "-val"
    ckpt_dir, out_dir = root + "-ckpt", root + "-export"
    t0 = time.perf_counter()
    _write_encoded(train_dir, _zoo_records(kind, n_train, SEED + 10))
    val_records = _zoo_records(kind, n_val, SEED + 11)
    _write_encoded(val_dir, val_records)
    write_s = time.perf_counter() - t0
    zoo = load_zoo_module(model_def)
    val_batches = _zoo_batches(torch, zoo, val_records, batch,
                               Mode.EVALUATION)
    val_features = [f for f, _ in val_batches]
    val_labels = np.concatenate([np.asarray(lab).reshape(-1)
                                 for _, lab in val_batches])
    tol = EVAL_TOL_RECORDS / n_val
    steps = n_train // batch

    # 1. train, with rounds and checkpoints every ``every`` versions
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    jobs = []
    argv = _zoo_argv(
        "train", model_def, params, batch, "--training_data", train_dir,
        "--validation_data", val_dir, "--evaluation_steps", str(every),
        "--checkpoint_dir", ckpt_dir, "--checkpoint_steps", str(every),
        "--num_epochs", "1", "--output", out_dir,
    )
    t0 = time.perf_counter()
    with _StepClock() as clock, _EvalReports() as spy, _Timed(
        AllReduceWorker, "_process_eval_task",
        key=lambda task: (task.model_version, task.start),
    ) as eval_tasks:
        rc = cli.main(argv, jobs=jobs)
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    job = jobs[0]
    trainer = job.worker.trainer
    # every zoo model's artifact carries the serving member, DeepFM-edl's
    # too: on the HBM plane its rows are in the graph, and the
    # reference's ALLREDUCE worker writes one for it as well
    artifacts = os.listdir(out_dir) if os.path.isdir(out_dir) else []
    member = len(artifacts) == 1 and _has_member(
        os.path.join(out_dir, artifacts[0]))
    if not member:
        problems.append("train: artifacts %s, no serving member" % artifacts)
    if rc != 0 or trainer.version != steps:
        problems.append("train: exit code %s, version %d of %d"
                        % (rc, trainer.version, steps))
    if not job.losses or not all(np.isfinite(job.losses)):
        problems.append("train: losses %s" % job.losses[:4])
    spans = clock.spans
    timed_s = spans[-1][1] - spans[0][1] if len(spans) > 1 else float("nan")
    table = trainer.train_state.params.get("embedding.table",
                                           trainer.train_state.params.get(
                                               "embedding.weight"))
    if table is not None and (
            table.device.type != torch.device(DEVICE).type
            or tuple(table.shape) != (ZOO_VOCAB, 64)):
        problems.append("the embedding table is %s on %s"
                        % (tuple(table.shape), table.device))

    # the newest checkpoint restores bitwise into a fresh model
    fresh = AllReduceTrainer(_fresh_model(zoo, model_def, params),
                             zoo.loss, zoo.optimizer(), seed=SEED + 1,
                             device=DEVICE)
    fresh.init_from_batch(None)
    restored = fresh.restore_sharded(os.path.join(ckpt_dir,
                                                  "ckpt_v%d" % steps))
    unequal = [k for k, p in trainer.train_state.params.items()
               if not torch.equal(fresh.train_state.params[k], p)]
    if restored != steps or unequal:
        problems.append("restore: v%s, unequal %s" % (restored, unequal))
    del fresh

    # each round against a direct forward of its checkpoint
    model = _zoo_model(model_def, params)
    published = job.master.evaluation_service.published
    want_rounds = list(range(every, steps + 1, every))
    if [r["version"] for r in published] != want_rounds:
        problems.append("rounds at %s, expected %s"
                        % ([r["version"] for r in published], want_rounds))
    scored = [(key, out) for (key, _), out in
              zip(eval_tasks.calls, spy.by_key)]
    rounds = []
    for r in published:
        v = r["version"]
        w_params, w_state = _checkpoint_weights(
            torch, os.path.join(ckpt_dir, "ckpt_v%d" % v))
        direct = _zoo_direct(torch, model, w_params, w_state, val_features)
        rows = sorted(((k[1], o) for k, o in scored if k[0] == v),
                      key=lambda start_out: start_out[0])
        got = {k: torch.from_numpy(np.concatenate(
            [np.asarray(o[k]) for _, o in rows])).to(DEVICE)
            for k in direct} if rows else None
        rel = _zoo_rel(torch, got, direct) if got else None
        metrics = r["metrics"]
        acc = (metrics["logits"]["accuracy"] if "logits" in metrics
               else metrics["accuracy"])
        direct_acc = _zoo_accuracy(torch, direct, val_labels)
        rounds.append({
            "version": v, "accuracy": acc, "direct_accuracy": direct_acc,
            "auc": metrics.get("probs", {}).get("auc"),
            "outputs_rel_l2": rel,
            "seconds": sum(s for k, s in eval_tasks.calls if k[0] == v),
        })
        if abs(acc - direct_acc) > tol + 1e-12:
            problems.append("round v%d reads %s, its checkpoint's direct "
                            "forward %s" % (v, acc, direct_acc))
        if rel is None or rel > EVAL_REL_L2:
            problems.append("round v%d outputs %s from its checkpoint's "
                            "direct forward (relative L2)" % (v, rel))
    export = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    if not export:
        problems.append("no export under --output")
    rec = {
        "phase": "zoo",
        "of": name,
        "card": card,
        "model_def": model_def,
        "model_params": params,
        "records": n_train,
        "eval_records": n_val,
        "batch": batch,
        "write_records_s": write_s,
        "job_s": job_s,
        "serving_member": member,
        "steps": len(spans),
        "examples_per_s": (len(spans) - 1) * batch / timed_s,
        "examples_per_s_in_step": (len(spans) - 1) * batch / sum(
            e - b for b, e in spans[1:]),
        "peak_memory_mib": peak / 2 ** 20,
        "loss_first_last": [job.losses[0], job.losses[-1]],
        "rounds": rounds,
        "round_s_total": sum(r["seconds"] for r in rounds),
        "round_tolerance": tol,
    }
    if table is not None:
        rec["table"] = {"shape": list(table.shape),
                        "device": str(table.device)}
    del job, jobs, trainer

    # 2. evaluate the checkpoints: the newest, as a direct forward reads
    w_params, w_state = _checkpoint_weights(
        torch, os.path.join(ckpt_dir, "ckpt_v%d" % steps))
    direct = _zoo_direct(torch, model, w_params, w_state, val_features)
    direct_acc = _zoo_accuracy(torch, direct, val_labels)
    eval_job, wall, run_s, task_s = _scoring_job(
        torch, _zoo_argv("evaluate", model_def, params, batch,
                         "--validation_data", val_dir,
                         "--checkpoint_dir", ckpt_dir),
        "evaluate " + name,
    )
    got = eval_job.master.evaluation_service.published
    metrics = got[0]["metrics"] if len(got) == 1 else {}
    acc = (metrics.get("logits", {}).get("accuracy") if "logits" in metrics
           else metrics.get("accuracy"))
    if (acc is None or abs(acc - direct_acc) > tol + 1e-12
            or got[0]["scored_versions"] != [steps]):
        problems.append("evaluate reads %s, the direct forward %s"
                        % (got, direct_acc))
    rec["evaluate"] = {"accuracy": acc, "direct_accuracy": direct_acc,
                       "job_s": wall, "worker_run_s": run_s,
                       "examples_per_s": n_val / sum(task_s)}
    del eval_job

    # 3. predict with a capturing processor: every record once, as the
    # direct forward reads it
    class Capture(BasePredictionOutputsProcessor):
        def __init__(self):
            self.chunks = []

        def process(self, predictions, worker_id):
            self.chunks.append(predictions)

    capture, handed = Capture(), []
    orig_get = MasterServicer.get_task

    def get_task(servicer, worker_id, task_type=None):
        res = orig_get(servicer, worker_id, task_type)
        if res.shard_name:
            handed.append((res.start, res.end))
        return res

    had = getattr(zoo, "PredictionOutputsProcessor", None)
    zoo.PredictionOutputsProcessor = capture
    MasterServicer.get_task = get_task
    try:
        _, wall, run_s, _ = _scoring_job(
            torch, _zoo_argv("predict", model_def, params, batch,
                             "--prediction_data", val_dir,
                             "--checkpoint_dir", ckpt_dir),
            "predict " + name,
        )
    finally:
        MasterServicer.get_task = orig_get
        if had is None:
            del zoo.PredictionOutputsProcessor
        else:
            zoo.PredictionOutputsProcessor = had
    order = [i for start, end in handed for i in range(start, end)]
    chunks = [c if isinstance(c, dict) else {"output": c}
              for c in capture.chunks]
    got = {k: np.concatenate([c[k] for c in chunks]) for k in direct} \
        if chunks else {}
    once = sorted(order) == list(range(n_val)) and all(
        len(v) == len(order) for v in got.values())
    rel = None
    if once and got:
        idx = torch.as_tensor(order, device=DEVICE)
        rel = _zoo_rel(torch, {k: torch.from_numpy(v).to(DEVICE)
                               for k, v in got.items()},
                       {k: v[idx] for k, v in direct.items()})
    if not once or rel is None or rel > EVAL_REL_L2:
        problems.append("predict: %d of %d records, rel L2 %s"
                        % (len(order), n_val, rel))
    rec["predict"] = {"every_record_once": once, "rel_l2": rel,
                      "job_s": wall, "worker_run_s": run_s,
                      "examples_per_s": n_val / run_s}
    return rec, problems


def _fresh_model(zoo, model_def, params, device=None):
    """A new model as the job's worker built it: through the zoo's
    ``build_distributed_model`` hook on a one-device mesh (``device``,
    default the card) where it has one."""
    from elasticdl_tpu_torch.common.model_utils import (
        build_model,
        get_dict_from_params_str,
    )
    from elasticdl_tpu_torch.parallel.mesh import create_mesh

    if hasattr(zoo, "build_distributed_model"):
        return zoo.build_distributed_model(
            create_mesh(devices=[device or DEVICE]),
            **(get_dict_from_params_str(params) or {}))
    return build_model(model_def, params)


def _card_vs_cpu(torch, entry):
    """One model's forward and one SGD step on the card against the same
    on the CPU: the same weights (the seeded init, made on the CPU) and
    batch, dropout the identity. Returns the record (its readings against
    ZOO_CARD_CPU_TOL)."""
    import torch.nn.functional as F

    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.common.model_utils import load_zoo_module
    from elasticdl_tpu_torch.nn.model_api import (
        init_variables,
        split_variables,
    )
    from elasticdl_tpu_torch.parallel.trainer import place_module
    from elasticdl_tpu_torch.training.step import (
        TrainState,
        make_forward_fn,
        make_train_step,
    )

    name, model_def, params, kind, _, _, batch, _ = entry
    if name == "resnet50_subclass":
        batch = ZOO_CARD_CPU_RESNET_BATCH
    zoo = load_zoo_module(model_def)
    features, labels = _zoo_batches(
        torch, zoo, _zoo_records(kind, batch, SEED + 12), batch,
        Mode.EVALUATION)[0]
    init = None
    got = {}
    dropout = F.dropout
    F.dropout = lambda x, *args, **kwargs: x
    try:
        for device in ("cpu", DEVICE):
            model = _fresh_model(zoo, model_def, params, device)
            place_module(model, device)
            if init is None:
                init = split_variables(init_variables(model, SEED))
            p, s = ({k: v.detach().to(device).clone() for k, v in t.items()}
                    for t in init)
            out = make_forward_fn(model)(p, s, features)
            ts = TrainState.create(p, s, zoo.optimizer())
            ts, loss = make_train_step(model, zoo.loss)(ts, features, labels)
            got[device] = (
                _tree(lambda t: t.float().cpu(), out), float(loss),
                {k: (v.detach().cpu() - init[0][k].detach().cpu())
                 for k, v in ts.params.items()},
            )
            del model, ts
    finally:
        F.dropout = dropout
    (c_out, c_loss, c_upd), (g_out, g_loss, g_upd) = got["cpu"], got[DEVICE]
    if not isinstance(c_out, dict):
        c_out, g_out = {"output": c_out}, {"output": g_out}
    outputs = _zoo_rel(torch, g_out, c_out)
    loss = abs(g_loss - c_loss) / max(abs(c_loss), 1e-30)

    def update_rel(k):
        want, have = c_upd[k], g_upd[k]
        if not want.any():
            return 0.0 if not have.any() else float("inf")
        return _rel_l2(torch, have, want)

    updates = {k: update_rel(k) for k in c_upd}
    worst = max(updates, key=updates.get)
    return {
        "model": name,
        "batch": batch,
        "outputs_rel_l2": outputs,
        "loss_rel": loss,
        "worst_update": worst,
        "worst_update_rel_l2": updates[worst],
        "ok": (outputs <= ZOO_CARD_CPU_TOL["outputs"]
               and loss <= ZOO_CARD_CPU_TOL["loss"]
               and updates[worst] <= ZOO_CARD_CPU_TOL["update"]),
    }



def _hbm_card_vs_cpu(torch, card):
    """deepfm_edl_embedding on the HBM plane, ZOO_HBM_STEPS SGD steps on
    the card against as many on the CPU over one batch stream from the
    seed, from one init; then a torch.profiler breakdown of
    ZOO_PROFILE_STEPS more steps on the card. Returns (record, problems).
    """
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as zoo,
    )
    from elasticdl_tpu_torch.nn.model_api import (
        init_variables,
        split_variables,
    )
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import (
        AllReduceTrainer,
        place_module,
    )
    from elasticdl_tpu_torch.training.step import TrainState

    problems = []
    rng = np.random.default_rng(SEED + 13)
    batches = []
    for _ in range(ZOO_HBM_STEPS + ZOO_PROFILE_STEPS):
        ids = rng.integers(1, ZOO_VOCAB, (1024, 10), dtype=np.int64)
        ids[rng.random((1024, 10)) < ZOO_DEEPFM_ZEROS] = 0
        labels = rng.integers(0, 2, (1024, 1)).astype(np.int32)
        batches.append(({"feature": torch.from_numpy(ids)},
                        torch.from_numpy(labels)))
    trainers = {}
    init = None
    for device in (DEVICE, "cpu"):
        mesh = create_mesh(devices=[device])
        model = zoo.build_distributed_model(mesh, vocab_size=ZOO_VOCAB)
        place_module(model, "cpu")
        if init is None:
            # owned copies: the trainer moves the module's own tensors
            init = [{k: v.detach().clone() for k, v in part.items()}
                    for part in split_variables(init_variables(model, SEED))]
        trainer = AllReduceTrainer(
            model, zoo.loss, zoo.optimizer(), mesh=mesh,
            param_specs=zoo.param_shardings(mesh), device=device,
        )
        trainer.load_state(TrainState.create(
            {k: v.clone() for k, v in init[0].items()}, init[1],
            zoo.optimizer()))
        t0 = time.perf_counter()
        for features, labels in batches[:ZOO_HBM_STEPS]:
            trainer.train_step(features, labels)
        if device != "cpu":
            torch.cuda.synchronize()
        trainers[device] = (trainer, time.perf_counter() - t0)
    on_card, cpu = trainers[DEVICE][0], trainers["cpu"][0]
    steps_s = {str(d): t for d, (_, t) in trainers.items()}
    table = on_card.train_state.params["embedding.table"]
    if not (table.device.type == torch.device(DEVICE).type
            and tuple(table.shape) == (ZOO_VOCAB, 64)
            and table.requires_grad):
        problems.append("the embedding table is %s on %s"
                        % (tuple(table.shape), table.device))
    worst, worst_err = None, 0.0
    rtol, atol = ZOO_HBM_TOL
    for k, want in cpu.train_state.params.items():
        got = on_card.train_state.params[k].detach().cpu()
        want = want.detach()
        err = float(((got - want).abs() - rtol * want.abs()).max())
        if worst is None or err > worst_err:
            worst, worst_err = k, err
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            problems.append("HBM plane: %s differs card against CPU "
                            "(max abs %s)" % (k, float((got - want).abs()
                                                        .max())))
    untouched = torch.ones(ZOO_VOCAB, dtype=torch.bool)
    for features, _ in batches[:ZOO_HBM_STEPS]:
        untouched[features["feature"].reshape(-1)] = False
    untouched[0] = True  # mask_zero: row 0 gets no gradient
    moved = (on_card.train_state.params["embedding.table"].detach().cpu()
             [untouched] != init[0]["embedding.table"][untouched]).any()
    if moved:
        problems.append("HBM plane: rows no id touched moved")
    del cpu, trainers

    # where a step's device time goes: the steps timed, then the same
    # batches again under the profiler (whose own host work stretches
    # the wall, so the idle share is also read against the unprofiled
    # step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for features, labels in batches[ZOO_HBM_STEPS:]:
        on_card.train_step(features, labels)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / ZOO_PROFILE_STEPS
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        for features, labels in batches[ZOO_HBM_STEPS:]:
            on_card.train_step(features, labels)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    window = _window_record(torch, prof, wall_ms)

    def op_device_ms(key):
        total = 0.0
        for evt in prof.key_averages():
            if evt.key == key:
                total += getattr(evt, "device_time_total",
                                 getattr(evt, "cuda_time_total", 0.0))
        return total / 1e3

    emb_bwd = op_device_ms("aten::embedding_dense_backward")
    busy = window["device_busy_ms"]
    rec = dict(
        window,
        phase="zoo",
        of="deepfm_hbm_card_vs_cpu",
        card=card,
        vocab=ZOO_VOCAB,
        batch=1024,
        steps=ZOO_HBM_STEPS,
        tolerance=list(ZOO_HBM_TOL),
        worst_param=worst,
        worst_excess_over_rtol=worst_err,
        untouched_rows_unmoved=not moved,
        steps_s=steps_s,
        step_ms=step_ms,
        idle_share_unprofiled=(1 - busy / ZOO_PROFILE_STEPS / step_ms)
        if busy else None,
        profiled_steps=ZOO_PROFILE_STEPS,
        embedding_backward_device_ms=emb_bwd,
        embedding_backward_share=(emb_bwd / busy) if busy else None,
        optimizer_device_ms=op_device_ms("Optimizer.step#SGD.step"),
    )
    return rec, problems


def _zoo_elastic(torch, tmp, card):
    """cifar10_subclass through the two-worker elastic job, one epoch:
    every task done once, both ranks' final bits equal, the version equal
    to the live steps. Returns (record, problems, the workers' flash
    launches)."""
    name, model_def = ZOO_MODELS[1][:2]
    root = os.path.join(tmp, "zoo-elastic")
    _write_encoded(root + "-data",
                   _zoo_records("cifar", ZOO_ELASTIC_RECORDS, SEED + 14))
    batch = 64
    argv = _zoo_argv(
        "train", model_def, "", batch, "--training_data", root + "-data",
        "--num_epochs", "1", "--checkpoint_dir", root + "-ckpt",
        "--checkpoint_steps", "4", "--keep_checkpoint_max", "2",
        "--output", root + "-export", "--restart_policy", "Always",
    )
    argv[argv.index("--num_workers") + 1] = str(ELASTIC_WORKERS)
    argv[argv.index("--num_minibatches_per_task") + 1] = "1"
    t0 = time.perf_counter()
    rc, job, done, _ = _run_elastic_job(torch, argv, root + "-timeline")
    job_s = time.perf_counter() - t0
    events = _timeline_events(root + "-timeline")
    _note_worker_exports(events)
    first_epoch = min((e["epoch"] for ev in events.values()
                       for e in _of(ev, "established")), default=0)
    problems = []
    want_done = ZOO_ELASTIC_RECORDS // batch + 1  # + SAVE_MODEL
    if rc != 0 or not job.master.task_d.finished():
        problems.append("elastic %s: exit code %s" % (name, rc))
    if len(done) != want_done or len(set(done)) != len(done):
        problems.append("elastic %s: %d task completions (%d distinct), "
                        "expected %d once"
                        % (name, len(done), len(set(done)), want_done))
    finals = {w: _of(ev, "final") for w, ev in events.items()}
    live = [w for w, f in finals.items() if f]
    digests = {finals[w][0]["digest"] for w in live}
    if len(live) != ELASTIC_WORKERS or len(digests) != 1:
        problems.append("elastic %s: workers %s ended with %d distinct "
                        "digests" % (name, live, len(digests)))
    launches = {k: 0 for k in KERNELS}
    for w in live:
        for k, n in finals[w][0]["launches"].items():
            launches[k] += n
    steps = [e for e in _of(events.get(0, []), "step") if e["live"] > 0]
    version = finals[0][0]["version"] if finals.get(0) else None
    if version != len(steps):
        problems.append("elastic %s: version %s after %d live steps"
                        % (name, version, len(steps)))
    rec = {
        "phase": "zoo",
        "of": "elastic_" + name,
        "card": card,
        "workers": ELASTIC_WORKERS,
        "records": ZOO_ELASTIC_RECORDS,
        "batch_per_worker": batch,
        "job_s": job_s,
        "version": version,
        "tasks_done": len(done),
        "examples_per_s": _examples_per_s(events, first_epoch),
        "final_digests_equal": len(digests) == 1,
    }
    return rec, problems, launches


def phase_zoo(torch, tmp, card):
    """The zoo models that need no PS fleet, each at its zoo width
    (DeepFM's tables at ZOO_VOCAB x 64), through ``train`` with
    validation rounds and checkpoints, ``evaluate`` and ``predict``;
    cifar10_subclass through the two-worker elastic job; each model's
    forward and one step on the card against the CPU, and DeepFM on the
    HBM plane ten steps against the CPU with a profile of its step.
    Returns the flash kernels' launches over the phase (none)."""
    problems = []
    _reset_counters()
    for entry in ZOO_MODELS:
        rec, bad = _zoo_job(torch, tmp, card, entry)
        emit(rec)
        problems += ["%s: %s" % (entry[0], b) for b in bad]
        torch.cuda.empty_cache()
    held = []
    for entry in ZOO_MODELS:
        rec = _card_vs_cpu(torch, entry)
        held.append(rec)
        if not rec["ok"]:
            problems.append("card against CPU: %s" % rec)
    emit({"phase": "zoo", "of": "card_vs_cpu", "card": card,
          "tolerance": ZOO_CARD_CPU_TOL, "models": held})
    torch.cuda.empty_cache()
    rec, bad = _hbm_card_vs_cpu(torch, card)
    emit(rec)
    problems += bad
    torch.cuda.empty_cache()
    rec, bad, launches = _zoo_elastic(torch, tmp, card)
    emit(rec)
    problems += bad
    counts = {k: (n + launches[k], shapes)
              for k, (n, shapes) in _counts().items()}
    if problems:
        raise PhaseError("zoo: " + "; ".join(problems))
    return counts


def _zoo_only(torch):
    try:
        card = phase_device(torch)
        with tempfile.TemporaryDirectory() as tmp:
            counts = phase_zoo(torch, tmp, card)
        _check_counts(counts, {k: 0 for k in KERNELS}, "the zoo phase")
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


# ---------------------------------------------------------------------------
# ps: the ParameterServerStrategy job on the master-held model
# ---------------------------------------------------------------------------

PS_DEEPFM = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"
PS_MNIST = "mnist_functional_api.mnist_functional_api.custom_model"
PS_RECORDS = 16384  # DeepFM at its zoo width: 16 b1024 steps an epoch
PS_VAL_RECORDS = 4096
PS_BATCH = 1024
PS_EVAL_STEPS = 8  # a round and a checkpoint every 8 versions
PS_MNIST_RECORDS = (1024, 256, 64)  # train, validation, batch
PS_ASYNC_EPOCHS = 7  # Run P2: enough work left for the relaunch
PS_KILL_AT_VERSION = 8
PS_JOB_LIMIT_S = 240
PS_CARD_CPU_RECORDS = 4096  # the sync job on the card and on the CPU
PS_CARD_CPU_TOL = 1e-4  # relative L2, dense params and touched rows
PS_HBM_TOL = {"outputs": 1e-5, "rows": 1e-6, "dense": 1e-5}


def _frappe_ids(n, seed):
    """``n`` rows of 10 ids from ZOO_VOCAB (ZOO_DEEPFM_ZEROS of them 0)
    and their 0/1 labels, as ``_zoo_records`` draws them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, ZOO_VOCAB, (n, 10), dtype=np.int64)
    ids[rng.random((n, 10)) < ZOO_DEEPFM_ZEROS] = 0
    return ids, rng.integers(0, 2, n)


def _ps_argv(verb, model_def, batch, *extra):
    """A job of the ParameterServerStrategy: no strategy flag."""
    return [
        verb,
        "--job_name", "chip-smoke-ps-" + verb,
        "--model_zoo", "",
        "--model_def", model_def,
        "--minibatch_size", str(batch),
        "--num_minibatches_per_task", "2",
        "--device", DEVICE,
        "--log_level", "WARNING",
    ] + list(extra)


class _PsSpies:
    """While installed: the training tasks the dispatcher marks done, the
    servicer's accepted gradients, and each evaluation round's seconds
    (created -> published); each training minibatch's (start, end) lands
    in ``spans``."""

    def __init__(self):
        from elasticdl_tpu_torch.master import evaluation_service as es
        from elasticdl_tpu_torch.master import servicer as sv
        from elasticdl_tpu_torch.master import task_dispatcher as td
        from elasticdl_tpu_torch.worker import worker as wk

        self._patches = [
            (td.TaskDispatcher, "_mark_done_locked"),
            (sv.MasterServicer, "report_gradient"),
            (es.EvaluationService, "try_to_create_new_job"),
            (es.EvaluationService, "_publish_summary"),
            (wk.Worker, "_process_minibatch"),
        ]
        self._saved = [getattr(c, n) for c, n in self._patches]
        self.done, self.accepted, self.rounds, self.spans = [], [0], [], []
        self._round_t0 = []

    def __enter__(self):
        spies = self
        mark, report, create, publish, minibatch = self._saved

        def mark_done(d, task, meta):
            spies.done.append((task.shard_name, task.start, task.end,
                               int(task.type)))
            return mark(d, task, meta)

        def report_gradient(s, gradients, version):
            ok, v = report(s, gradients, version)
            spies.accepted[0] += bool(ok)
            return ok, v

        def try_create(e):
            created = create(e)
            if created:
                spies._round_t0.append(time.perf_counter())
            return created

        def published(e, round_):
            publish(e, round_)
            if spies._round_t0:
                spies.rounds.append(
                    time.perf_counter() - spies._round_t0.pop(0))

        def process(w, task_type, *args, **kwargs):
            from elasticdl_tpu_torch.common.constants import TaskType

            if task_type != TaskType.TRAINING:
                return minibatch(w, task_type, *args, **kwargs)
            t0 = time.perf_counter()
            try:
                return minibatch(w, task_type, *args, **kwargs)
            finally:
                spies.spans.append((t0, time.perf_counter()))

        for (cls, name), fn in zip(self._patches, (
                mark_done, report_gradient, try_create, published, process)):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for (cls, name), fn in zip(self._patches, self._saved):
            setattr(cls, name, fn)

    def training_done(self):
        from elasticdl_tpu_torch.common.constants import TaskType

        return [d for d in self.done if d[3] == int(TaskType.TRAINING)]


def _ps_split(worker):
    """Median seconds (ms) of each phase of the worker's accepted steps
    after the first, and the host parse per batch."""
    splits = worker.step_splits[1:]
    out = {}
    for key in ("get_model", "plan", "pull", "compute", "report"):
        out[key + "_ms"] = _median([s.get(key, 0.0) * 1e3 for s in splits])
    out["compute_device_ms"] = _median(
        [s["compute_device_ms"] for s in splits if "compute_device_ms" in s])
    stats = worker.input_stats.snapshot()
    if stats.get("batches"):
        out["parse_ms_per_batch"] = stats["parse_s"] * 1e3 / stats["batches"]
    return out


def _ps_examples_per_s(spans, rounds_s, batch):
    """Examples/s from the end of the first step to the end of the last,
    less the rounds run between them."""
    if len(spans) < 2:
        return None
    wall = spans[-1][1] - spans[0][1] - sum(rounds_s)
    return (len(spans) - 1) * batch / wall if wall > 0 else None


def _store_ids(master):
    store = master.master_servicer.embedding_store.embedding_params
    return {name: set(t.embedding_vectors) for name, t in store.items()}


def _ps_restore_check(torch, master, ckpt_dir):
    """The newest checkpoint restored into a fresh servicer: the held
    model and every table bitwise the live ones (a list of problems)."""
    import numpy as np

    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as zoo,
    )

    live = master.master_servicer
    files = sorted(
        (int(f[len("model_v"):-len(".chkpt")]), f)
        for f in os.listdir(ckpt_dir) if f.startswith("model_v")
    )
    version, newest = files[-1]
    if version != live.get_model_version():
        return ["the newest checkpoint is v%d, the job ended at v%d"
                % (version, live.get_model_version())]
    fresh = MasterServicer(
        1, PS_BATCH, zoo.optimizer(), TaskDispatcher({}, {}, {}, 1, 1),
        checkpoint_filename_for_init=os.path.join(ckpt_dir, newest),
        device=DEVICE,
    )
    problems = []
    _, got = fresh.get_model(version)
    _, want = live.get_model(version)
    if sorted(got) != sorted(want) or not all(
            np.array_equal(got[k], want[k]) for k in want):
        problems.append("restored dense params differ")
    for name, table in fresh.embedding_store.embedding_params.items():
        ids, rows = table.snapshot()
        if not np.array_equal(
                rows, live.embedding_store.get_embedding_param(name, ids)):
            problems.append("restored table %s differs" % name)
    if sorted(fresh.embedding_store.embedding_params) != sorted(
            live.embedding_store.embedding_params):
        problems.append("restored tables %s" % sorted(
            fresh.embedding_store.embedding_params))
    return problems


def _ps_in_process(torch, tmp, card):
    """Run P1: the DeepFM job in this process with no strategy flag (sync,
    grads_to_wait 1), a round and a checkpoint every PS_EVAL_STEPS
    versions, ``--output``; then ``evaluate`` from the export. Returns
    (record, problems)."""
    import numpy as np

    from elasticdl_tpu_torch import cli

    data, val = os.path.join(tmp, "ps-data"), os.path.join(tmp, "ps-val")
    ckpt, out = os.path.join(tmp, "ps-ckpt"), os.path.join(tmp, "ps-out")
    problems = []
    torch.cuda.reset_peak_memory_stats()
    # earlier phases' tensors that are still alive count in the peak
    base = torch.cuda.memory_allocated() / 2**20
    jobs = []
    t0 = time.perf_counter()
    with _PsSpies() as spies:
        rc = cli.main(_ps_argv(
            "train", PS_DEEPFM, PS_BATCH, "--training_data", data,
            "--validation_data", val, "--evaluation_steps",
            str(PS_EVAL_STEPS), "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(PS_EVAL_STEPS), "--output", out,
        ), jobs=jobs)
    job_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    job = jobs[0]
    master, worker = job.master, job.worker
    servicer = master.master_servicer
    steps = PS_RECORDS // PS_BATCH
    version = servicer.get_model_version()
    if rc != 0 or not master.task_d.finished():
        problems.append("train rc=%s finished=%s" % (
            rc, master.task_d.finished()))
    if version != steps or spies.accepted[0] != version:
        problems.append("version %d, accepted %d, steps %d" % (
            version, spies.accepted[0], steps))
    done = spies.training_done()
    if len(done) != len(set(done)) or len(done) != steps // 2:
        problems.append("training tasks done %d (%d distinct), want %d"
                        % (len(done), len(set(done)), steps // 2))
    losses = job.losses or []
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        problems.append("losses %s" % losses)
    # the store holds exactly the ids the job saw (training and rounds)
    seen = set()
    for n, seed in ((PS_RECORDS, SEED + 40), (PS_VAL_RECORDS, SEED + 41)):
        seen.update(np.unique(_frappe_ids(n, seed)[0]).tolist())
    ids = _store_ids(master)
    if ids != {"embedding": seen, "id_bias": seen}:
        problems.append("store ids %s, seen %d" % (
            {k: len(v) for k, v in ids.items()}, len(seen)))
    problems += _ps_restore_check(torch, master, ckpt)
    rounds = master.evaluation_service.published
    if [r["version"] for r in rounds] != list(
            range(PS_EVAL_STEPS, steps + 1, PS_EVAL_STEPS)) or not all(
            0.0 <= r["metrics"]["probs"]["auc"] <= 1.0 for r in rounds):
        problems.append("rounds %s" % rounds)
    # evaluate from the export: the final round's metrics
    export = os.path.join(out, sorted(os.listdir(out))[-1])
    # the elastic layers' rows are pulled outside the graph: no member,
    # as the reference's PS worker writes none
    member = _has_member(export)
    if member:
        problems.append("the PS plane's DeepFM artifact has a serving "
                        "member")
    ejobs = []
    t1 = time.perf_counter()
    erc = cli.main(_ps_argv(
        "evaluate", PS_DEEPFM, PS_BATCH, "--validation_data", val,
        "--checkpoint_filename_for_init", export), jobs=ejobs)
    eval_s = time.perf_counter() - t1
    scored = ejobs[0].master.evaluation_service.published if ejobs else []
    if erc != 0 or not scored or not rounds:
        problems.append("evaluate rc=%s %s" % (erc, scored))
    else:
        got, want = scored[0]["metrics"], rounds[-1]["metrics"]
        if (abs(got["logits"]["accuracy"] - want["logits"]["accuracy"])
                > 2.0 / PS_VAL_RECORDS
                or abs(got["probs"]["auc"] - want["probs"]["auc"]) > 1e-3):
            problems.append("evaluate %s against the last round %s"
                            % (got, want))
    store = servicer.embedding_store.embedding_params
    rows = sum(len(t) for t in store.values())
    rec = {
        "phase": "ps", "of": "in_process", "card": card,
        # the same calls with no input thread beside them (the job's
        # parse runs on the prefetch thread, under the same interpreter
        # lock)
        "alone_ms": _ps_alone_ms(torch, worker),
        "model": "deepfm_edl_embedding", "batch": PS_BATCH,
        "records": PS_RECORDS, "version": version, "job_s": job_s,
        "serving_member": member,
        "examples_per_s": _ps_examples_per_s(spies.spans, spies.rounds,
                                          PS_BATCH),
        "step_split": _ps_split(worker),
        "step_ms_median": _median(
            [(b - a) * 1e3 for a, b in spies.spans[1:]]),
        "master_apply_ms_median": {
            k: _median(list(v)) for k, v in servicer.apply_ms.items()},
        "store": {"rows": rows, "bytes": sum(
            len(t) * t.dim * 4 for t in store.values())},
        "peak_mib": peak, "peak_over_start_mib": peak - base,
        "rounds_s": spies.rounds,
        "round_metrics": [r["metrics"] for r in rounds],
        "evaluate_s": eval_s, "losses_first_last": [losses[0], losses[-1]]
        if losses else None,
    }
    return rec, problems


def _ps_alone_ms(torch, worker):
    """Median ms of ``get_model`` and of the plan-and-pull of one batch
    of seen ids, called from this thread with the job over."""
    from elasticdl_tpu_torch.common.constants import GetModelMethod

    ids, _ = _frappe_ids(PS_BATCH, SEED + 40)
    features = {"feature": ids}
    out = {}
    for name, fn in (
        ("get_model", lambda: worker.get_model(
            worker._model_version, GetModelMethod.MINIMUM)),
        ("plan_pull", lambda: worker._prepare_embedding_batch(features)),
    ):
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = _median(times)
    return out


def _ps_async_kill(torch, tmp, card):
    """Run P2: two worker processes, ``--use_async --get_model_steps 2``,
    worker 1 SIGKILLed at PS_KILL_AT_VERSION and relaunched. Returns
    (record, problems)."""
    import json as _json
    import threading as _threading

    from elasticdl_tpu_torch import cli

    data = os.path.join(tmp, "ps-data")
    timeline = os.path.join(tmp, "ps-timeline")
    os.environ["EDL_WORKER_TIMELINE_DIR"] = timeline
    problems, jobs, result = [], [], []
    with _PsSpies() as spies:
        def run():
            try:
                result.append(cli.main(_ps_argv(
                    "train", PS_DEEPFM, PS_BATCH, "--training_data", data,
                    "--num_epochs", str(PS_ASYNC_EPOCHS),
                    "--num_workers", "2", "--use_async", "true",
                    "--get_model_steps", "2", "--restart_policy", "Always",
                ), jobs=jobs))
            except Exception as err:  # noqa: BLE001 — checked below
                result.append(err)

        t0 = time.perf_counter()
        thread = _threading.Thread(target=run, daemon=True)
        thread.start()
        deadline = time.monotonic() + PS_JOB_LIMIT_S
        kill_t = None
        while thread.is_alive() and time.monotonic() < deadline:
            if jobs and kill_t is None and (
                    jobs[0].master.master_servicer.get_model_version()
                    >= PS_KILL_AT_VERSION):
                jobs[0].master.instance_manager.kill_worker(1)
                kill_t = time.time()
            time.sleep(0.01)
        if thread.is_alive():
            if jobs:
                jobs[0].master.request_stop()
            thread.join(30)
            raise PhaseError("the async ps job hung past %d s"
                             % PS_JOB_LIMIT_S)
        job_s = time.perf_counter() - t0
    os.environ.pop("EDL_WORKER_TIMELINE_DIR", None)
    master = jobs[0].master
    codes = master.instance_manager.exit_codes
    steps = PS_ASYNC_EPOCHS * PS_RECORDS // PS_BATCH
    version = master.master_servicer.get_model_version()
    done = spies.training_done()
    if result != [0] or not master.task_d.finished() or kill_t is None:
        problems.append("async job %s, finished %s, killed %s" % (
            result, master.task_d.finished(), kill_t is not None))
    if codes.get(1) != -9 or codes.get(0) != 0 or codes.get(2) != 0:
        problems.append("exit codes %s" % codes)
    tasks = PS_RECORDS // (2 * PS_BATCH)
    if len(set(done)) != tasks or any(
            done.count(t) != PS_ASYNC_EPOCHS for t in set(done)):
        problems.append("training tasks done %d (%d distinct), want %d "
                        "%d times each" % (len(done), len(set(done)), tasks,
                                           PS_ASYNC_EPOCHS))
    if version != spies.accepted[0] or version < steps:
        problems.append("version %d, accepted %d, steps %d" % (
            version, spies.accepted[0], steps))
    events = {}
    for name in sorted(os.listdir(timeline)) if os.path.isdir(timeline) \
            else []:
        with open(os.path.join(timeline, name)) as f:
            events[name] = [_json.loads(line) for line in f]
    relaunch = events.get("worker-2.jsonl", [])
    first_step = next((e["t"] for e in relaunch if e["event"] == "step"),
                      None)
    start = next((e["t"] for e in relaunch if e["event"] == "start"), None)
    if first_step is None:
        problems.append("the relaunched worker took no accepted step")
    steps_by = {n: sum(e["event"] == "step" for e in ev)
                for n, ev in events.items()}
    # each worker process's flash launches, as its last event counted them
    # (the killed worker's too, up to its last accepted step)
    launches = {k: 0 for k in KERNELS}
    for name in ("worker-0.jsonl", "worker-1.jsonl", "worker-2.jsonl"):
        last = [e["launches"] for e in events.get(name, [])
                if "launches" in e]
        if not last:
            problems.append("%s reported no launch counts" % name)
            continue
        for k, n in last[-1].items():
            launches[k] += n
    step_t = sorted(e["t"] for ev in events.values() for e in ev
                    if e["event"] == "step")
    rec = {
        "phase": "ps", "of": "async_two_workers_kill", "card": card,
        "epochs": PS_ASYNC_EPOCHS, "version": version,
        "accepted": spies.accepted[0], "job_s": job_s,
        # from the first accepted step (of either worker) to the last
        "examples_per_s": (len(step_t) - 1) * PS_BATCH
        / (step_t[-1] - step_t[0]) if len(step_t) > 1 else None,
        "exit_codes": {str(k): v for k, v in codes.items()},
        "kill_at_version": PS_KILL_AT_VERSION,
        "kill_to_relaunch_start_s": (start - kill_t) if start and kill_t
        else None,
        "kill_to_relaunch_first_accepted_s": (first_step - kill_t)
        if first_step and kill_t else None,
        "accepted_steps_by_worker": steps_by,
        "worker_flash_launches": launches,
        "master_apply_ms_median": {
            k: _median(list(v))
            for k, v in master.master_servicer.apply_ms.items()},
    }
    return rec, problems


def _ps_init_var(torch):
    """One set of dense weights for the PS-plane DeepFM (the port's seeded
    init, on the CPU), under the reference's names."""
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as zoo,
    )

    model = zoo.custom_model()
    model.init_parameters(torch.Generator().manual_seed(SEED))
    return {k: v.numpy() for k, v in convert.to_named(
        dict(model.named_parameters())).items()}


def _ps_direct_job(torch, data_dir, device, init_var):
    """The sync DeepFM job assembled by hand (dispatcher, servicer,
    worker) on ``device``, tasks unshuffled; returns the servicer."""
    from elasticdl_tpu_torch.common.constants import JobType
    from elasticdl_tpu_torch.master.master import _make_task_dispatcher
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as zoo,
    )
    from elasticdl_tpu_torch.worker.worker import Worker

    task_d = _make_task_dispatcher(data_dir, "", "", 2 * PS_BATCH, 1)
    master = MasterServicer(1, PS_BATCH, zoo.optimizer(), task_d,
                            init_var=init_var, device=device)
    Worker(0, JobType.TRAINING_ONLY, PS_BATCH, "", PS_DEEPFM, stub=master,
           device=device, loss_log_steps=0).run()
    if not task_d.finished():
        raise PhaseError("the hand-built ps job on %s did not finish"
                         % device)
    return master


def _ps_card_vs_cpu(torch, tmp):
    """The sync DeepFM job on the card and on the CPU from one init over
    PS_CARD_CPU_RECORDS records, tasks unshuffled: the dense params and
    the touched rows by relative L2. Returns (record, problems)."""
    import numpy as np

    from elasticdl_tpu_torch.data.dataset import Dataset

    data = os.path.join(tmp, "ps-card-cpu")
    ids, labels = _frappe_ids(PS_CARD_CPU_RECORDS, SEED + 42)
    _write_frappe(data, ids, labels)
    init_var = _ps_init_var(torch)
    shuffle = Dataset.shuffle
    os.environ["EDL_TASK_SHUFFLE_SEED"] = str(SEED)
    Dataset.shuffle = lambda self, *a, **k: self
    try:
        masters = {d: _ps_direct_job(torch, data, d, init_var)
                   for d in (DEVICE, "cpu")}
    finally:
        Dataset.shuffle = shuffle
        os.environ.pop("EDL_TASK_SHUFFLE_SEED", None)
    card, cpu = masters[DEVICE], masters["cpu"]
    rel = {}
    _, a = card.get_model(card.get_model_version())
    _, b = cpu.get_model(cpu.get_model_version())
    for k in b:
        rel[k] = _np_rel(a[k], b[k])
    for name in ("embedding", "id_bias"):
        touched = np.array(sorted(
            card.embedding_store.embedding_params[name].embedding_vectors))
        rel["rows:" + name] = _np_rel(
            card.pull_embedding_vectors(name, touched),
            cpu.pull_embedding_vectors(name, touched))
    ok = all(v <= PS_CARD_CPU_TOL for v in rel.values()) and (
        card.get_model_version() == cpu.get_model_version()
        == PS_CARD_CPU_RECORDS // PS_BATCH)
    rec = {"phase": "ps", "of": "card_vs_cpu", "rel_l2": rel,
           "tolerance": PS_CARD_CPU_TOL, "ok": ok}
    return rec, ([] if ok else ["card against CPU: %s" % rel])


def _np_rel(got, want):
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _write_frappe(data_dir, ids, labels):
    import numpy as np

    from elasticdl_tpu_torch.data.example import encode_example

    _write_encoded(data_dir, [
        encode_example({"feature": row, "label": np.array([y], np.int64)})
        for row, y in zip(ids, labels)])


def _ps_vs_hbm(torch, tmp):
    """One batch on the card through the PS plane (the master's store, the
    sync job) and through the HBM plane (PR 9's table on the card), from
    the same weights: the outputs, then after one SGD step the touched
    rows and the dense params; the untouched rows unchanged in both.
    Returns (record, problems)."""
    import numpy as np

    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as zoo,
    )
    from elasticdl_tpu_torch.nn.comm_plane import plan_lookup_multi
    from elasticdl_tpu_torch.nn.embedding import capture_embedding_ids
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.ps.embedding_table import _make_initializer
    from elasticdl_tpu_torch.training.step import (
        make_embedding_forward_fn,
        make_forward_fn,
    )

    ids, labels = _frappe_ids(PS_BATCH, SEED + 43)
    data = os.path.join(tmp, "ps-hbm")
    _write_frappe(data, ids, labels)
    features = {"feature": torch.from_numpy(ids)}
    init_var = _ps_init_var(torch)
    dense = {k: v.to(DEVICE) for k, v in convert.to_state_dict(
        init_var).items()}
    unique = np.unique(ids)
    minted = {name: _make_initializer("uniform")(unique, dim)
              for name, dim in (("embedding", 64), ("id_bias", 1))}

    # the PS plane's forward over the rows the store mints
    ps_model = zoo.custom_model().to(DEVICE)
    (u, (idx,)) = plan_lookup_multi(
        capture_embedding_ids(ps_model, dense, {}, features,
                              expected_count=2)["embedding"])
    rows = {name: torch.from_numpy(minted[name]).to(DEVICE)
            for name in ("embedding", "id_bias")}
    pos = torch.from_numpy(idx.astype(np.int64)).to(DEVICE)
    ps_out = make_embedding_forward_fn(ps_model)(
        dense, rows, {}, {"embedding": [pos], "id_bias": [pos]}, features)

    # the HBM plane: the table on the card, the touched rows the store's
    mesh = create_mesh(devices=[DEVICE])
    hbm = zoo.build_distributed_model(mesh, vocab_size=ZOO_VOCAB).to(DEVICE)
    hbm.init_parameters(torch.Generator(device=DEVICE).manual_seed(SEED))
    with torch.no_grad():
        for k, v in dense.items():
            dict(hbm.named_parameters())[k].copy_(v)
        for name in ("embedding", "id_bias"):
            table = getattr(hbm, name).table
            table[torch.from_numpy(unique).to(DEVICE)] = torch.from_numpy(
                minted[name]).to(DEVICE)
    before = {n: p.detach().clone() for n, p in hbm.named_parameters()}
    params = {n: p for n, p in hbm.named_parameters()}
    hbm_out = make_forward_fn(hbm)(params, {}, features)
    out_rel = max(_rel_l2(torch, ps_out[k].float(), hbm_out[k].float())
                  for k in ("logits", "probs"))

    # one SGD step on each plane
    master = _ps_direct_job(torch, data, DEVICE, init_var)
    opt = zoo.optimizer()(list(hbm.parameters()))
    hbm.train()
    loss = zoo.loss(hbm(features), torch.from_numpy(labels))
    loss.backward()
    opt.step()
    store = master.embedding_store.embedding_params
    rec = {"phase": "ps", "of": "ps_vs_hbm", "outputs_rel_l2": out_rel}
    problems = []
    uidx = torch.from_numpy(unique).to(DEVICE)
    row_diff = {}
    for name in ("embedding", "id_bias"):
        table = getattr(hbm, name).table.detach()
        got = master.pull_embedding_vectors(name, unique)
        row_diff[name] = float(np.abs(
            got - table[uidx].to("cpu").numpy()).max())
        if set(store[name].embedding_vectors) != set(unique.tolist()):
            problems.append("the store's %s holds other ids" % name)
        # untouched rows: the HBM table's unchanged bitwise; the store
        # minted none of them
        mask = torch.ones(ZOO_VOCAB, dtype=torch.bool, device=DEVICE)
        mask[uidx] = False
        if not torch.equal(table[mask],
                           before[name + ".table"][mask]):
            problems.append("untouched HBM %s rows moved" % name)
    rec["rows_max_abs"] = row_diff
    _, held = master.get_model(master.get_model_version())
    dense_rel = {}
    for k, v in convert.to_state_dict(held).items():
        dense_rel[k] = _rel_l2(torch, v.to(DEVICE),
                               dict(hbm.named_parameters())[k].detach())
    rec["dense_rel_l2"] = dense_rel
    if out_rel > PS_HBM_TOL["outputs"]:
        problems.append("outputs %.3g" % out_rel)
    if max(row_diff.values()) > PS_HBM_TOL["rows"]:
        problems.append("rows %s" % row_diff)
    if max(dense_rel.values()) > PS_HBM_TOL["dense"]:
        problems.append("dense %s" % dense_rel)
    rec["tolerance"] = PS_HBM_TOL
    rec["ok"] = not problems
    return rec, problems


def _ps_mnist(torch, tmp, card):
    """Run P3: mnist_functional_api in this process under the
    ParameterServerStrategy (b64, rounds every PS_EVAL_STEPS versions).
    Returns (record, problems)."""
    import numpy as np

    from elasticdl_tpu_torch import cli

    n_train, n_val, batch = PS_MNIST_RECORDS
    data = os.path.join(tmp, "ps-mnist")
    val = os.path.join(tmp, "ps-mnist-val")
    _write_encoded(data, _zoo_records("mnist", n_train, SEED + 44))
    _write_encoded(val, _zoo_records("mnist", n_val, SEED + 45))
    jobs = []
    t0 = time.perf_counter()
    with _PsSpies() as spies:
        rc = cli.main(_ps_argv(
            "train", PS_MNIST, batch, "--training_data", data,
            "--validation_data", val, "--evaluation_steps",
            str(PS_EVAL_STEPS)), jobs=jobs)
    job_s = time.perf_counter() - t0
    job = jobs[0]
    steps = n_train // batch
    version = job.master.master_servicer.get_model_version()
    rounds = job.master.evaluation_service.published
    problems = []
    if rc != 0 or version != steps or spies.accepted[0] != steps:
        problems.append("mnist rc=%s version %d accepted %d" % (
            rc, version, spies.accepted[0]))
    if len(job.losses) != steps or not np.all(np.isfinite(job.losses)):
        problems.append("mnist losses %s" % job.losses)
    if [r["version"] for r in rounds] != list(
            range(PS_EVAL_STEPS, steps + 1, PS_EVAL_STEPS)):
        problems.append("mnist rounds %s" % rounds)
    rec = {
        "phase": "ps", "of": "mnist_in_process", "card": card,
        "batch": batch, "version": version, "job_s": job_s,
        "examples_per_s": _ps_examples_per_s(spies.spans, spies.rounds, batch),
        "step_split": _ps_split(job.worker), "rounds_s": spies.rounds,
        "round_metrics": [r["metrics"] for r in rounds],
    }
    return rec, problems


def phase_ps(torch, tmp, card):
    """The ParameterServerStrategy job on the master-held model: DeepFM at
    its zoo width in process (P1), card against CPU and
    PS plane against HBM plane; two worker processes with a worker kill
    (P2); the MNIST model in process (P3). Returns the flash kernels'
    launches over the phase (none), this process's and P2's workers'."""
    t0 = time.perf_counter()
    ids, labels = _frappe_ids(PS_RECORDS, SEED + 40)
    _write_frappe(os.path.join(tmp, "ps-data"), ids, labels)
    ids, labels = _frappe_ids(PS_VAL_RECORDS, SEED + 41)
    _write_frappe(os.path.join(tmp, "ps-val"), ids, labels)
    problems = []
    worker_launches = {k: 0 for k in KERNELS}
    _reset_counters()
    for run in (
        lambda: _ps_in_process(torch, tmp, card),
        lambda: _ps_card_vs_cpu(torch, tmp),
        lambda: _ps_vs_hbm(torch, tmp),
        lambda: _ps_async_kill(torch, tmp, card),
        lambda: _ps_mnist(torch, tmp, card),
    ):
        rec, bad = run()
        emit(rec)
        problems += bad
        for k, n in rec.get("worker_flash_launches", {}).items():
            worker_launches[k] += n
        torch.cuda.empty_cache()
    counts = {k: (n + worker_launches[k], shapes)
              for k, (n, shapes) in _counts().items()}
    emit({"phase": "ps", "of": "summary", "seconds":
          time.perf_counter() - t0, "flash_launches":
          {k: n for k, (n, _) in counts.items()}})
    if problems:
        raise PhaseError("ps: " + "; ".join(problems))
    return counts


def _ps_only(torch):
    try:
        card = phase_device(torch)
        with tempfile.TemporaryDirectory() as tmp:
            counts = phase_ps(torch, tmp, card)
        _check_counts(counts, {k: 0 for k in KERNELS}, "the ps phase")
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


# ---------------------------------------------------------------------------
# ps_fleet: the parameter-server fleet, two shard processes on one card
# ---------------------------------------------------------------------------

FLEET_SHARDS = 2
FLEET_ASYNC_EPOCHS = 2  # Runs F2/F3: 16 steps an epoch over two workers
FLEET_KILL_AT_VERSION = 8
FLEET_SNAPSHOT_VERSIONS = 8
FLEET_JOB_LIMIT_S = 300  # a fleet run that hangs fails the phase
FLEET_TOL = 1e-6  # F1 and F4 against the held model, relative L2
FLEET_BF16_TOL = 2e-2  # F1 over the bf16 wire against F1, relative L2
FLEET_MNIST_RECORDS = (512, 64)  # F4: records, batch
FLEET_MASTER_KILL_AT_VERSION = 4  # F5: the held model's master SIGKILL
FLEET_EXPORT = (4, 2)  # F5: --export_every_versions, --export_keep
FLEET_EXPORT_RECORDS = 1024  # F5: MNIST b64, 16 versions
F1_REPORT_SECS = 1  # F1's workers: --telemetry_report_secs
# F1's /trace: the share of traced step time the tracetool must attribute
# to named phases (the reference's gate, bench.py's bench_trace)
TRACE_ATTRIBUTION = 0.90

# the worker of a deterministic run: no dataset shuffle and cuDNN's
# deterministic algorithms, then worker.main as the entry point runs it
_DETERMINISTIC_WORKER = (
    "import runpy, sys, torch; "
    "from elasticdl_tpu_torch.data.dataset import Dataset; "
    "Dataset.shuffle = lambda self, *a, **k: self; "
    "torch.backends.cudnn.deterministic = True; "
    "torch.backends.cudnn.benchmark = False; "
    "sys.argv = ['worker'] + %r; "
    "runpy.run_module('elasticdl_tpu_torch.worker.main', "
    "run_name='__main__')"
)
# the same with torch's deterministic algorithms on: the index_select
# backward that sums a batch's repeated ids into their unique rows adds
# with atomics on the card, in an order that varies between runs once the
# ids repeat (zipf traffic); cuBLAS then needs its fixed workspace
_DETERMINISTIC_ALGORITHMS_WORKER = (
    "import os; os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', "
    "':4096:8'); import torch; "
    "torch.use_deterministic_algorithms(True, warn_only=True); "
) + _DETERMINISTIC_WORKER


# A fleet's worker process starts with its master and shards: it imports
# the worker and creates its CUDA context while they boot, then waits
# until the master and each shard answer before it runs worker.main (the
# order the harness once kept by starting it only then). The probes use
# the socket transport with the wire off.
_FLEET_WORKER_WAITS = textwrap.dedent("""
    import time, torch
    torch.zeros(1, device=%(device)r)
    import elasticdl_tpu_torch.worker.worker
    from elasticdl_tpu_torch.master.rpc_service import MasterClient
    from elasticdl_tpu_torch.worker.ps_client import BoundPS

    def _answers(make, call):
        stub = make()
        try:
            call(stub)
            return True
        except Exception:
            return False
        finally:
            stub.close()

    _deadline = time.monotonic() + %(limit)r
    _probes = [(lambda: MasterClient("localhost:%(master)d"),
                lambda c: c.master_status())] + [
        (lambda p=p: BoundPS("localhost:%%d" %% p, deadline_s=2.0),
         lambda c: c.ps_status({})) for p in %(shards)r]
    for _make, _call in _probes:
        while not _answers(_make, _call) and time.monotonic() < _deadline:
            time.sleep(0.1)
""")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _until(probe, what, limit_s=120.0):
    """``probe()``'s first answer (it raises until the process serves)."""
    deadline = time.monotonic() + limit_s
    while True:
        try:
            return probe()
        except Exception as err:  # noqa: BLE001 — not serving yet
            if time.monotonic() > deadline:
                raise PhaseError("%s never served: %s" % (what, err))
            time.sleep(0.1)


def _ps_stub(port, deadline_s=10.0):
    from elasticdl_tpu_torch.worker.ps_client import BoundPS

    return BoundPS("localhost:%d" % port, deadline_s=deadline_s)


def _master_probe(port):
    from elasticdl_tpu_torch.master.rpc_service import MasterClient

    client = MasterClient("localhost:%d" % port)
    try:
        return client.master_status()
    finally:
        client.close()


class _Fleet:
    """One job on processes under a LocalInstanceManager: ``python -m
    elasticdl_tpu_torch.master.main`` (a journal, a fixed port), with
    ``shards`` > 0 that many ``python -m elasticdl_tpu_torch.ps.main``
    shards, and ``workers`` ``worker.main`` processes (``--ps_addrs``
    where there are shards). ``inline`` runs one more worker in this
    process instead. ``deterministic`` starts the workers with no
    dataset shuffle and cuDNN's deterministic algorithms (or through the
    wrapper it names). ``ps_by_shard`` maps a shard to flags of its
    own. ``worker_postmortem``: each worker's flight recorder is armed
    at ``<it>/worker-<id>`` (``EDL_FLIGHT_RECORDER_DIR``). ``env``:
    variables every process of the fleet gets."""

    def __init__(self, tmp, name, model_def, data, batch, shards=2,
                 workers=1, epochs=1, job=(), ps=(), worker=(),
                 deterministic=False, val=None, ps_by_shard=None,
                 worker_postmortem=None, env=None):
        from elasticdl_tpu_torch.master.local_instance_manager import (
            LocalInstanceManager,
        )

        self.root = os.path.join(tmp, name)
        os.makedirs(self.root, exist_ok=True)
        self.workers = workers
        self.journal = os.path.join(self.root, "journal")
        self.timeline = os.path.join(self.root, "timeline")
        self.batch = batch
        self.shards = shards
        self.master_port = _free_port()
        self.ps_ports = [_free_port() for _ in range(shards)]
        self.model_def = model_def
        self.telemetry = None  # F1's endpoints (_f1_fleet)
        common = ["--model_zoo", "", "--model_def", model_def,
                  "--device", DEVICE, "--log_level", "WARNING"]
        py = [sys.executable, "-m"]
        self.master_argv = py + [
            "elasticdl_tpu_torch.master.main", "--job_name", "fleet-" + name,
            "--training_data", data, "--minibatch_size", str(batch),
            "--num_minibatches_per_task", "2", "--num_epochs", str(epochs),
            "--num_ps_pods", str(shards), "--port", str(self.master_port),
            "--master_journal_dir", self.journal,
        ] + (["--validation_data", val] if val else []) + common + list(job)
        self.ps_argv = lambda i: py + [
            "elasticdl_tpu_torch.ps.main", "--ps_id", str(i),
            "--port", str(self.ps_ports[i]),
        ] + common + list(ps) + list((ps_by_shard or {}).get(i, ()))
        self.job_type = ("training_with_evaluation" if val
                         else "training_only")
        self.worker_flags = [
            "--job_type", self.job_type,
            "--master_addr", "localhost:%d" % self.master_port,
            "--minibatch_size", str(batch), "--master_failover_s", "120",
        ] + (["--ps_addrs", self.ps_addrs()] if shards else []) + common \
            + list(worker)

        waits = _FLEET_WORKER_WAITS % dict(
            device=DEVICE, limit=float(FLEET_JOB_LIMIT_S),
            master=self.master_port, shards=self.ps_ports)

        def worker_command(worker_id, device):
            flags = ["--worker_id", str(worker_id)] + self.worker_flags
            # a worker's flight recorder: armed by the environment, a
            # directory of its own (dumps are numbered per process)
            arm = ("import os; os.environ['EDL_FLIGHT_RECORDER_DIR'] = %r\n"
                   % os.path.join(worker_postmortem, "worker-%d" % worker_id)
                   if worker_postmortem else "")
            if deterministic:
                wrapper = deterministic if isinstance(
                    deterministic, str) else _DETERMINISTIC_WORKER
            else:
                wrapper = (
                    "import runpy, sys; sys.argv = ['worker'] + %r; "
                    "runpy.run_module('elasticdl_tpu_torch.worker.main', "
                    "run_name='__main__')")
            return [sys.executable, "-c", arm + waits + wrapper % (flags,)]

        fleet_env = dict(os.environ)
        fleet_env["PYTHONPATH"] = REPO + os.pathsep + fleet_env.get(
            "PYTHONPATH", "")
        # the master lingers one second past the last task, not three:
        # its worker processes learn "no more tasks" in milliseconds, and
        # each fleet run waits the linger out
        fleet_env.update(EDL_WORKER_TIMELINE_DIR=self.timeline,
                         EDL_MASTER_POLL_SECS="1",
                         EDL_MASTER_EXIT_GRACE_S="1",
                         EDL_TASK_SHUFFLE_SEED=str(SEED), **(env or {}))
        self.manager = LocalInstanceManager(
            None, workers, worker_command, [DEVICE] * workers,
            num_ps=shards, ps_command=self.ps_argv if shards else None,
            env=fleet_env, master_command=lambda: self.master_argv,
        )

    def ps_addrs(self):
        return ",".join("localhost:%d" % p for p in self.ps_ports)

    def status(self, i, deadline_s=10.0):
        stub = _ps_stub(self.ps_ports[i], deadline_s)
        try:
            return stub.ps_status({})
        finally:
            stub.close()

    def client(self):
        from elasticdl_tpu_torch.worker.ps_client import BoundPS, PSClient

        return PSClient([BoundPS("localhost:%d" % p, deadline_s=60)
                         for p in self.ps_ports])

    def start(self, workers=True):
        """Start the master, the shards and (unless ``inline`` will run
        the worker here) the workers, without waiting for them: all boot
        at once, each worker waiting for the master and the shards to
        answer. ``run`` then finds them started."""
        self.manager.start_master()
        self.manager.start_all_ps()
        if workers and self.workers:
            self.manager.start_workers()
        self.started = time.time()

    def run(self, on_poll=None, inline=None, inspect=None,
            after_workers=None):
        """Start the master, the shards and the workers; ``on_poll(self)``
        every 20 ms until the workers exit (``inline(self)`` runs in this
        thread instead where given, once the master and the shards
        answer); ``after_workers(self)`` once they exited, while the
        master lingers; ``inspect(self)`` with the shards still up.
        Returns the
        record's raw parts: ``job_s`` runs from the workers' start (the
        fleet's boot included) to their exit."""
        m = self.manager
        out = {}
        try:
            if not getattr(self, "started", None):
                self.start(workers=inline is None)
            t0 = out["t0"] = self.started
            if inline is not None:
                _until(lambda: _master_probe(self.master_port),
                       "the master")
                for i in range(self.shards):
                    _until(lambda i=i: self.status(i, 2.0), "shard %d" % i)
                t0 = out["t0"] = time.time()
                out["inline"] = inline(self)
            else:
                deadline = time.monotonic() + FLEET_JOB_LIMIT_S
                while m.live_workers():
                    if time.monotonic() > deadline:
                        raise PhaseError("fleet run %s ran past %d s" % (
                            os.path.basename(self.root), FLEET_JOB_LIMIT_S))
                    if on_poll is not None:
                        on_poll(self)
                    time.sleep(0.02)
            out["job_s"] = time.time() - t0
            if after_workers is not None:
                after_workers(self)
            deadline = time.monotonic() + 60
            while m.live_master() and time.monotonic() < deadline:
                time.sleep(0.1)
            if inspect is not None:
                out["inspect"] = inspect(self)
        finally:
            m.stop_relaunch_and_remove_all_pods()
        from elasticdl_tpu_torch.master.journal import MasterJournal

        state = MasterJournal(self.journal).replay()
        out["journal"] = {"done": state.counters["done"],
                          "pending": len(state.pending),
                          "dup": state.counters.get("dup", 0)}
        out["events"] = _timeline_events(self.timeline) \
            if os.path.isdir(self.timeline) else {}
        out["exit_codes"] = {str(k): v for k, v in m.exit_codes.items()}
        out["master_exit_codes"] = list(m.master_exit_codes)
        out["ps_exit_codes"] = {str(k): v for k, v in m.ps_exit_codes.items()}
        return out


def _fleet_steps(events):
    return sorted((e for ev in events.values() for e in _of(ev, "step")),
                  key=lambda e: e["t"])


def _fleet_split(events):
    """Medians over every worker's accepted steps after its first: host
    ms of each phase (``get_model`` is the fleet's ``pull_dense``,
    ``pull`` the rows' fan-out, ``report`` ``push_gradient``), the
    compute's CUDA-event ms, and the parse per batch on the prefetch
    thread (the workers' end events)."""
    splits = [s["split"] for ev in events.values()
              for s in _of(ev, "step")[1:] if s.get("split")]
    out = {k + "_ms": _median([s.get(k, 0.0) * 1e3 for s in splits])
           for k in ("get_model", "plan", "pull", "compute", "report")}
    out["compute_device_ms"] = _median(
        [s["compute_device_ms"] for s in splits if "compute_device_ms" in s])
    parse = [e["input_stats"] for ev in events.values()
             for e in _of(ev, "end") if e.get("input_stats", {}).get(
                 "batches")]
    out["parse_ms_per_batch"] = _median(
        [st["parse_s"] * 1e3 / st["batches"] for st in parse])
    return out


def _fleet_examples_per_s(events, batch):
    steps = _fleet_steps(events)
    if len(steps) < 2:
        return None
    return (len(steps) - 1) * batch / (steps[-1]["t"] - steps[0]["t"])


def _shard_record(status):
    apply_ms = status.get("apply_ms", {})
    return {
        "version": status["version"],
        "shard_epoch": status["shard_epoch"],
        "restored_version": status["restored_version"],
        "dense_apply_ms_median": _median(apply_ms.get("dense", [])),
        "sparse_apply_ms_median": _median(apply_ms.get("sparse", [])),
        "applies": len(apply_ms.get("sparse", []) or apply_ms.get(
            "dense", [])),
        # a fresh process's first apply also creates its CUDA context
        "first_apply_ms": {k: v[:1] for k, v in apply_ms.items()},
        "rows": status.get("tables"),
        "table_bytes": status.get("table_bytes"),
        "peak_mib": status.get("peak_mib"),
    }


def _worker_launches(events, problems):
    """The flash launches each worker process counted, from its last
    event that carries them."""
    launches = {k: 0 for k in KERNELS}
    for wid, ev in events.items():
        last = [e["launches"] for e in ev if "launches" in e]
        if not last:
            problems.append("worker %s reported no launch counts" % wid)
            continue
        for k, n in last[-1].items():
            launches[k] += n
    return launches


def _end_events(events):
    return [e for ev in events.values() for e in _of(ev, "end")]


def _fleet_state(fleet, ids_by_table):
    """The fleet's dense model and the rows of ``ids_by_table`` (pulled
    from each row's shard), and each shard's status; a shard's row count
    must not move under the pull (it held exactly those ids)."""
    statuses = [fleet.status(i) for i in range(fleet.shards)]
    client = fleet.client()
    try:
        ready, version, dense = client.pull_dense()
        rows = {name: client.pull_embedding_vectors(name, ids)
                for name, ids in ids_by_table.items()}
    finally:
        client.close()
    after = [fleet.status(i) for i in range(fleet.shards)]
    placement = {}
    for name, ids in ids_by_table.items():
        for i in range(fleet.shards):
            mine = int((ids % fleet.shards == i).sum())
            placement["%s@%d" % (name, i)] = (
                statuses[i]["tables"].get(name), after[i]["tables"].get(name),
                mine)
    return {"ready": ready, "version": version, "dense": dense,
            "rows": rows, "statuses": statuses, "placement": placement}


def _held_ids(master):
    import numpy as np

    store = master.embedding_store.embedding_params
    return {name: np.array(sorted(store[name].embedding_vectors), np.int64)
            for name in ("embedding", "id_bias")}


def _compare(fleet_state, dense, rows):
    """Relative L2 of each dense name and table against the held model's
    ``dense`` and ``rows``, and whether all are bitwise equal."""
    import numpy as np

    rel, bitwise = {}, True
    for k, v in dense.items():
        got = fleet_state["dense"].get(k)
        if got is None:
            rel[k] = float("inf")
            bitwise = False
            continue
        rel[k] = _np_rel(got, v)
        bitwise = bitwise and np.array_equal(got, v)
    for name, v in rows.items():
        rel["rows:" + name] = _np_rel(fleet_state["rows"][name], v)
        bitwise = bitwise and np.array_equal(fleet_state["rows"][name], v)
    return rel, bitwise


def _f1_paths(tmp, wire):
    """F1's (or the bf16 repeat's) name, validation data, export and
    checkpoint directories."""
    name = "f1" if wire is None else "f5-bf16"
    return (name, os.path.join(tmp, "ps-val"),
            os.path.join(tmp, name + "-out"),
            os.path.join(tmp, name + "-ckpt"))


# F1's telemetry plane, by arm (``--f1-order`` runs F1 once per arm, in
# turns): "on" as the every-phase run has it (the master's endpoint and
# event file, each shard's endpoint, the worker's snapshot every second
# with its task acks sent inline, so that each ack carries the snapshot
# due, the endpoints scraped); "acks" only the acks inline; "plain" no
# flag of the plane, as F1 ran before the plane (acks queued, sent at the
# end); "off" plain with EDL_METRICS=0 in every process of the fleet
F1_PLANES = ("on", "acks", "plain", "off")


def _f1_fleet(tmp, wire=None, plane="on"):
    """F1's fleet with its telemetry ``plane`` (one of F1_PLANES; the
    flags, the environment and the scraper go together), or F5's
    bf16-wire repeat's with ``wire`` (plain)."""
    name, val, out, ckpt = _f1_paths(tmp, wire)
    wire_flags = ["--wire_dtype", wire] if wire else []
    if wire is not None:
        plane = "plain"
    if plane not in F1_PLANES:
        raise PhaseError("F1's plane is one of %s, not %r"
                         % (F1_PLANES, plane))
    job, ps_by_shard, worker = [], None, []
    telemetry = None
    if plane == "on":
        telemetry = {
            "master": _free_port(),
            "shards": [_free_port() for _ in range(FLEET_SHARDS)],
            "events": os.path.join(tmp, name, "events.jsonl"),
        }
        job = ["--telemetry_port", str(telemetry["master"]),
               "--telemetry_events_path", telemetry["events"]]
        ps_by_shard = {i: ["--ps_telemetry_port", str(p)]
                       for i, p in enumerate(telemetry["shards"])}
        worker = ["--telemetry_report_secs", str(F1_REPORT_SECS)]
    if plane in ("on", "acks"):
        worker += ["--task_ack_queue", "0"]
    fleet = _Fleet(
        tmp, name, PS_DEEPFM, os.path.join(tmp, "ps-data"), PS_BATCH,
        val=val,
        job=["--grads_to_wait", "1", "--evaluation_steps",
             str(PS_EVAL_STEPS), "--checkpoint_steps", str(PS_EVAL_STEPS),
             "--checkpoint_dir", ckpt, "--output", out] + wire_flags + job,
        ps=["--grads_to_wait", "1"] + wire_flags, worker=wire_flags + worker,
        deterministic=True, ps_by_shard=ps_by_shard,
        env={"EDL_METRICS": "0"} if plane == "off" else None,
    )
    fleet.telemetry = telemetry
    fleet.plane = plane
    return fleet


class _Scraper:
    """F1's endpoints read during the job (``poll``, at most every
    SCRAPE_EVERY_S): the master's ``/metrics`` and ``/trace``, each
    shard's ``/metrics`` and ``/trace``. Keeps each endpoint's newest
    answer, and the master's first ``/metrics`` that carries every
    family the job must show."""

    SCRAPE_EVERY_S = 0.25

    def __init__(self, telemetry, workers):
        self.t = telemetry
        self.last = 0.0
        self.scrapes = 0
        self.newest = {}
        self.master_full = None
        self.required = ["edl_task_queue_depth"] + [
            'edl_worker_examples_per_sec{worker="%d"}' % w
            for w in range(workers)]

    def _read(self, key, url):
        try:
            status, body = _get(url, timeout=10)
        except OSError:
            return None
        if status == 200:
            self.newest[key] = body
            return body
        return None

    def poll(self, fleet=None, final=False):
        """One round of reads while the workers run; ``final``: the
        one after they exit (the master lingers), which sees the
        workers' last snapshot but counts as no mid-job read."""
        now = time.monotonic()
        if not final and now - self.last < self.SCRAPE_EVERY_S:
            return
        self.last = now
        self.scrapes += 1
        base = "http://127.0.0.1:%d"
        text = self._read("master", base % self.t["master"] + "/metrics")
        if text and not final and self.master_full is None and all(
                r in text for r in self.required):
            self.master_full = text
        self._read("master_trace", base % self.t["master"] + "/trace")
        for i, port in enumerate(self.t["shards"]):
            self._read("shard%d" % i, base % port + "/metrics")
            self._read("shard%d_trace" % i, base % port + "/trace")


def _f1_telemetry(scraper, shards):
    """F1's telemetry checks -> (record, problems): mid-job the
    master's ``/metrics`` carried each worker's examples/s and the queue
    depth; each shard's carried its applies (``push_gradient``'s service
    histogram) and its ``/trace`` the ``ps/apply`` spans; the master's
    ``/trace`` holds its ``rpc/report_task_result`` spans parented on
    the worker's ``task/ack`` spans (the ``_sctx`` the worker sent); the
    event file parses line by line; the tracetool attributes at least
    TRACE_ATTRIBUTION of the traced step time to named phases. (The
    shard's spans join no worker trace: a fan-out leg runs on the
    client's pool, whose threads carry no span context, as in the
    reference.)"""
    from elasticdl_tpu_torch.tools.tracetool import critical_path

    def spans_of(key):
        doc = json.loads(scraper.newest.get(key) or '{"traceEvents": []}')
        return doc, [e for e in doc["traceEvents"] if e.get("ph") == "X"]

    problems = []
    rec = {"scrapes": scraper.scrapes,
           "master_mid_job": scraper.master_full is not None}
    if scraper.master_full is None:
        problems.append("f1: no mid-job /metrics of the master carried %s"
                        % scraper.required)
    else:
        rec["master_examples_per_s"] = [
            _prom_value(scraper.master_full, r) for r in scraper.required
            if r.startswith("edl_worker_examples_per_sec")]
    applies = 'edl_rpc_server_latency_seconds_count{role="ps",' \
        'method="push_gradient"}'
    rec["shard_applies"] = []
    rec["shard_apply_spans"] = []
    for i in range(shards):
        n = _prom_value(scraper.newest.get("shard%d" % i, ""), applies)
        _, spans = spans_of("shard%d_trace" % i)
        n_spans = sum(1 for e in spans if e["name"] == "ps/apply")
        rec["shard_applies"].append(n)
        rec["shard_apply_spans"].append(n_spans)
        if not n or not n_spans:
            problems.append("f1 shard %d: %s applies in /metrics, %d "
                            "ps/apply spans in /trace" % (i, n, n_spans))
    doc, spans = spans_of("master_trace")
    by_span = {e["args"].get("span"): e for e in spans}
    joined = [e for e in spans if e["name"] == "rpc/report_task_result"
              and by_span.get(e["args"].get("parent"), {}).get("name")
              == "task/ack"]
    rec["master_spans_joined_to_worker_acks"] = len(joined)
    if not joined:
        problems.append("f1 /trace: no rpc/report_task_result span under "
                        "a worker's task/ack span")
    kinds = {}
    try:
        with open(scraper.t["events"]) as f:
            for line in f:
                kind = json.loads(line)["kind"]
                kinds[kind] = kinds.get(kind, 0) + 1
    except (OSError, ValueError) as err:
        problems.append("f1 event file: %s" % err)
    rec["events"] = kinds
    if not kinds.get("task_done"):
        problems.append("f1 event file holds no task_done: %s" % kinds)
    report = critical_path(doc)
    rec["trace"] = {
        "steps": report["steps"], "attribution": report["attribution"],
        "total_step_s": report["total_step_s"], "p99_s": report["p99_s"],
        "phases": report["phases"],
        "spans": len(spans),
    }
    if not report["steps"] or report["attribution"] < TRACE_ATTRIBUTION:
        problems.append("f1 /trace: %d steps, attribution %.4f (gate %.2f)"
                        % (report["steps"], report["attribution"],
                           TRACE_ATTRIBUTION))
    return rec, problems


def _fleet_f1(torch, tmp, card, wire=None, fleet=None):
    """Run F1 (or F5's bf16-wire repeat with ``wire``): the sync DeepFM
    job across two shards, one worker process, ``--grads_to_wait 1``,
    ``--validation_data --evaluation_steps 8 --checkpoint_steps 8
    --output``; then ``evaluate`` from the export. ``fleet``: the run's
    fleet, started already. Returns (record, problems, the fleet's final
    state)."""
    import numpy as np

    from elasticdl_tpu_torch import cli

    name, val, out, ckpt = _f1_paths(tmp, wire)
    if fleet is None:
        fleet = _f1_fleet(tmp, wire)
    seen = np.unique(_frappe_ids(PS_RECORDS, SEED + 40)[0])
    ids = {"embedding": seen, "id_bias": seen}
    scraper = (_Scraper(fleet.telemetry, fleet.workers)
               if fleet.telemetry else None)
    raw = fleet.run(
        on_poll=scraper.poll if scraper else None,
        after_workers=(lambda f: scraper.poll(final=True))
        if scraper else None,
        inspect=lambda f: _fleet_state(f, ids))
    state = raw["inspect"]
    steps = PS_RECORDS // PS_BATCH
    problems = []
    telemetry = None
    if scraper is not None:
        telemetry, bad = _f1_telemetry(scraper, fleet.shards)
        problems += bad
    events = raw["events"]
    ends = _end_events(events)
    if raw["exit_codes"] != {"0": 0} or raw["master_exit_codes"] != [0]:
        problems.append("%s exits %s, master %s" % (
            name, raw["exit_codes"], raw["master_exit_codes"]))
    # the training tasks and the SAVE_MODEL task
    if raw["journal"]["done"] != steps // 2 + 1 or raw["journal"]["pending"]:
        problems.append("%s journal %s" % (name, raw["journal"]))
    if not state["ready"] or state["version"] != steps:
        problems.append("%s fleet version %s" % (name, state["version"]))
    if len(_fleet_steps(events)) != steps or not ends or not all(
            e["losses_finite"] for e in ends):
        problems.append("%s steps %d, ends %s" % (
            name, len(_fleet_steps(events)), ends))
    for key, (before, after, mine) in state["placement"].items():
        if not before == after == mine:
            problems.append("%s shard rows %s: %s before, %s after, %d "
                            "with id %% %d" % (name, key, before, after,
                                               mine, FLEET_SHARDS))
    # under the fleet the master holds no model: as in the reference, its
    # version never moves, so no round and no checkpoint fires
    rounds = os.listdir(ckpt) if os.path.isdir(ckpt) else []
    export = os.path.join(out, sorted(os.listdir(out))[-1]) \
        if os.path.isdir(out) and os.listdir(out) else None
    eval_rec = None
    if export is None:
        problems.append("%s wrote no export" % name)
    elif wire is None:
        ejobs = []
        t1 = time.perf_counter()
        erc = cli.main(_ps_argv(
            "evaluate", PS_DEEPFM, PS_BATCH, "--validation_data", val,
            "--checkpoint_filename_for_init", export), jobs=ejobs)
        scored = ejobs[0].master.evaluation_service.published \
            if ejobs else []
        eval_rec = {"rc": erc, "seconds": time.perf_counter() - t1,
                    "metrics": scored[0]["metrics"] if scored else None}
        if erc != 0 or not scored or not all(
                np.isfinite(v) for m in scored[0]["metrics"].values()
                for v in m.values()):
            problems.append("%s evaluate %s" % (name, eval_rec))
    rec = {
        "phase": "ps_fleet", "of": name, "card": card,
        "model": "deepfm_edl_embedding", "batch": PS_BATCH,
        "records": PS_RECORDS, "shards": FLEET_SHARDS,
        "wire_dtype": wire or "float32", "version": state["version"],
        "job_s": raw["job_s"],
        "examples_per_s": _fleet_examples_per_s(events, PS_BATCH),
        "step_split": _fleet_split(events),
        "step_ms_median": _median(
            [(b["t"] - a["t"]) * 1e3 for a, b in zip(
                _fleet_steps(events), _fleet_steps(events)[1:])]),
        "shards_state": [_shard_record(s) for s in state["statuses"]],
        "worker_peak_mib": [e.get("peak_mib") for e in ends],
        "master_checkpoints": len(rounds), "journal": raw["journal"],
        "evaluate": eval_rec, "ps_exit_codes": raw["ps_exit_codes"],
        "losses_first_last": [e.get("losses_first_last") for e in ends],
        "wire": [e.get("wire") for e in ends],
        # the plane F1 ran with (F1_PLANES): "on" sends the task acks
        # inline, inside the steps that examples_per_s spans
        "telemetry_plane": fleet.plane,
        "telemetry": telemetry,
    }
    rec["worker_flash_launches"] = _worker_launches(events, problems)
    return rec, problems, state


# The telemetry plane's overhead A/B: the reference's arm 1 of its
# telemetry and trace benches (bench.py bench_telemetry, bench_trace), one
# harness: the task data service under an injected get_task round trip,
# per-record read latency and ack latency, with the worker's step spans,
# per-batch rate accounting, snapshots shipped every 0.25 s into a
# JobTelemetry, and the stub's handlers instrumented; against the same
# harness with the plane off (EDL_METRICS=0's switch). The harness sleeps
# most of its time, so the gate reads process CPU: the signed difference
# of the engaged arms' median CPU and the off arms', over the off arms'
# median wall. Each arm runs in a process of its own, forked from one
# that imported and warmed the harness (its CPU time is the harness's
# alone; this one's background threads of earlier phases would count
# too), all arms at once (every arm under the same load of the host), and
# serially: no task prefetch, no parse threads, no prefetch buffer. On
# the card host a short timed wait spins, so the reference's threads made
# the CPU of one arm vary by several times the plane's cost; serial,
# every wait is a sleep of 9.6 ms or more. The sleeps still cost CPU
# there, which varies from arm to arm: the noise of the reading (the
# bootstrap's standard deviation of the difference of medians) is
# reported beside it and must stay under half the gate.
OVERHEAD_TASKS, OVERHEAD_RECORDS = 160, 64  # tasks, records per task
OVERHEAD_WARM_TASKS = 8  # the warm-up run, in the process the arms fork
# the reader's injected latency, 0.3 ms a record as in the reference, is
# slept once for each group of this many records: the card host's sleeps
# under ~1 ms spin (a 0.3 ms one costs its wall in user CPU, the record's
# sleep_cpu), which would charge the harness's latency to its CPU basis
OVERHEAD_READ_GROUP = 32
# arms of each side, run at once, each in a process of its own
OVERHEAD_REPS = 12
OVERHEAD_GATE_PCT = 2.0
OVERHEAD_NOISE_PCT = OVERHEAD_GATE_PCT / 2  # the reading resolves its gate
OVERHEAD_BOOTSTRAP = 2000  # resamples of each side for the noise


def _overhead_arm(metrics_on, tasks):
    """One run of the harness over ``tasks`` tasks -> (examples/s,
    process CPU s, wall s, the aggregator's worker snapshots, (user,
    system) CPU s)."""
    import numpy as np

    from elasticdl_tpu_torch.common.constants import TaskType
    from elasticdl_tpu_torch.data.data_reader import Metadata
    from elasticdl_tpu_torch.master.servicer import TaskResponse
    from elasticdl_tpu_torch.master.telemetry import JobTelemetry
    from elasticdl_tpu_torch.utils import profiling
    from elasticdl_tpu_torch.worker.task_data_service import TaskDataService
    from elasticdl_tpu_torch.worker.telemetry import WorkerTelemetry

    rtt_s, read_s, ack_s, batch = 0.020, 0.0003, 0.010, 16

    class Stub:
        def __init__(self, telemetry):
            self._lock = threading.Lock()
            self._todo = [
                TaskResponse(shard_name="shard_%d" % i, start=0,
                             end=OVERHEAD_RECORDS, type=TaskType.TRAINING,
                             model_version=0,
                             extended_config={"trace_id": "t%06d" % i})
                for i in range(tasks)]
            self._next_id = 0
            self._telemetry = telemetry
            # the servicer's wrap: its service histograms and server
            # spans are part of the measured plane
            wrapped = profiling.instrument_service_methods(
                {"get_task": self._get_task,
                 "report_task_result": self._report}, role="bench")
            self.get_task = wrapped["get_task"]
            self._wrapped_report = wrapped["report_task_result"]

        def _get_task(self, task_type=None):
            time.sleep(rtt_s)
            with self._lock:
                if not self._todo:
                    return TaskResponse()
                task = self._todo.pop(0)
                self._next_id += 1
                task.task_id = self._next_id
                return task

        def _report(self, task_id, err_msg="", exec_counters=None):
            time.sleep(ack_s)

        def report_task_result(self, task_id, err_msg="",
                               exec_counters=None):
            return self._wrapped_report(task_id, err_msg, exec_counters)

        def report_telemetry(self, snapshot):
            self._telemetry.ingest(snapshot)

    class Reader:
        metadata = Metadata()

        def read_records(self, task):
            shard = int(task.shard_name.split("_")[1])
            for i in range(task.start, task.end):
                if (i - task.start) % OVERHEAD_READ_GROUP == 0:
                    time.sleep(read_s * OVERHEAD_READ_GROUP)
                yield np.int64(shard * OVERHEAD_RECORDS + i).tobytes()

        def create_shards(self):
            return {}

    def parse(record):
        seed = int(np.frombuffer(record[:8], np.int64)[0])
        x = np.random.default_rng(seed).standard_normal(128)
        return {"x": np.tanh(x).astype(np.float32), "y": np.int64(seed)}

    profiling.set_metrics_enabled(metrics_on)
    aggregator = JobTelemetry(registry=profiling.MetricsRegistry(),
                              event_log=profiling.EventLog(),
                              span_log=profiling.SpanLog())
    try:
        stub = Stub(aggregator)
        tds = TaskDataService(stub, False, data_reader=Reader(),
                              task_prefetch=0, ack_queue_size=8,
                              prefetch_warm_records=OVERHEAD_RECORDS)
        wt = WorkerTelemetry(0, stats=tds.stats, interval_s=0.25)
        n = 0
        t0, c0, u0 = time.perf_counter(), time.process_time(), os.times()
        while True:
            ds = tds.get_dataset()
            if ds is None:
                break
            ds = ds.map(parse).batch(batch, vectorized=True)
            for b in ds:
                count = int(b["y"].shape[0])
                n += count
                task = tds.get_current_task()
                trace = (task.extended_config or {}).get("trace_id") \
                    if task is not None else None
                # the worker's step spans, fully engaged
                with profiling.span("step", trace_id=trace, examples=count):
                    with profiling.span("step/compute"):
                        float(np.tanh(b["x"]).sum())
                    with profiling.span("step/grad_push"):
                        pass
                wt.on_batch(count)
                tds.report_record_done(count)
                wt.ship(stub)
            tds.drain_acks()
        wt.ship(stub, force=True)
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        u1 = os.times()
        split = (u1.user - u0.user, u1.system - u0.system)
    finally:
        profiling.set_metrics_enabled(True)
    if n != tasks * OVERHEAD_RECORDS:
        raise PhaseError("the overhead harness read %d records" % n)
    return n / wall, cpu, wall, aggregator.worker_snapshots(), split


def _overhead_forked(metrics_on, tasks, barrier, conn):
    """One arm, in a process forked from ``_overhead_arms``: once every
    arm is ready, the measured run, sent back over ``conn``."""
    try:
        barrier.wait(timeout=300)
        eps, cpu, wall, snaps, split = _overhead_arm(metrics_on, tasks)
        conn.send({"run": [eps, cpu, wall] + list(split),
                   "examples_total": snaps.get("0", {}).get(
                       "examples_total") if metrics_on else None})
    except Exception as err:  # noqa: BLE001 — sent to the parent
        conn.send({"error": repr(err)})
    finally:
        conn.close()


def _sleep_cpu():
    """What sleeps cost this host's CPU alone (user, system s): a
    record's 0.3 ms, and a read group's."""
    out = {}
    for seconds, n in ((0.0003, 2000), (0.0003 * OVERHEAD_READ_GROUP, 60)):
        u0 = os.times()
        for _ in range(n):
            time.sleep(seconds)
        u1 = os.times()
        out["%gx%d" % (seconds, n)] = [u1.user - u0.user,
                                       u1.system - u0.system]
    return out


def _overhead_arms(tasks, reps):
    """The A/B's arms, in the process ``_telemetry_overhead`` starts: the
    harness imported and warmed once here (both sides), ``reps`` arms
    engaged and as many off forked from it and measured at once, then the
    sleeps' CPU alone; one JSON line."""
    import multiprocessing

    _overhead_arm(True, OVERHEAD_WARM_TASKS)
    _overhead_arm(False, OVERHEAD_WARM_TASKS)
    ctx = multiprocessing.get_context("fork")
    barrier = ctx.Barrier(2 * reps)
    arms = []
    for i in range(2 * reps):
        receive, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_overhead_forked,
                           args=(i % 2 == 0, tasks, barrier, send))
        proc.start()
        send.close()
        arms.append((i % 2 == 0, proc, receive))
    runs = []
    for on, proc, receive in arms:
        try:
            got = receive.recv()
        except EOFError:
            got = {"error": "the arm exited without a result"}
        proc.join()
        if "error" in got:
            raise PhaseError("an overhead arm failed: %s" % got["error"])
        runs.append([on, got])
    print(json.dumps({"runs": runs, "sleep_cpu": _sleep_cpu()}),
          flush=True)


def _telemetry_overhead(tasks=OVERHEAD_TASKS, reps=OVERHEAD_REPS):
    """The A/B -> (record, problems): ``reps`` arms engaged and as many
    off, each in a process of its own, all measured at once; the signed
    difference of the engaged arms' median process CPU and the off arms',
    over the off arms' median wall, gated below OVERHEAD_GATE_PCT, with
    its noise (under OVERHEAD_NOISE_PCT) and each side's spread."""
    import numpy as np

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("EDL_METRICS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke._overhead_arms(%d, %d)" % (tasks, reps)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    if proc.returncode != 0:
        raise PhaseError("the overhead A/B exited %d: %s"
                         % (proc.returncode, err[-2000:]))
    got = json.loads(out.strip().splitlines()[-1])
    runs = got["runs"]
    on = np.array([r["run"] for is_on, r in runs if is_on])
    off = np.array([r["run"] for is_on, r in runs if not is_on])
    wall = float(np.median(off[:, 2]))

    def pct_of_wall(x):
        return float(x) / wall * 100.0

    pct = pct_of_wall(np.median(on[:, 1]) - np.median(off[:, 1]))
    rng = np.random.default_rng(SEED)
    boot = [np.median(rng.choice(on[:, 1], len(on)))
            - np.median(rng.choice(off[:, 1], len(off)))
            for _ in range(OVERHEAD_BOOTSTRAP)]
    noise = pct_of_wall(np.std(boot))

    def spread(cpu):
        # min, quartiles and max of one side's CPU, in % of the wall
        return [pct_of_wall(q) for q in np.percentile(
            cpu, [0, 25, 50, 75, 100])]

    rec = {
        "phase": "ps_fleet", "of": "telemetry_overhead",
        "basis": "median process CPU engaged less off, over the off "
                 "arms' median wall",
        "overhead_pct": pct, "noise_pct": noise,
        "gate_pct": OVERHEAD_GATE_PCT, "noise_gate_pct": OVERHEAD_NOISE_PCT,
        "tasks": tasks, "reps": reps,
        "cpu_spread_pct": {"on": spread(on[:, 1]), "off": spread(off[:, 1])},
        "arms": {"on": on.tolist(), "off": off.tolist()},
        "examples_per_s_on": float(np.median(on[:, 0])),
        "examples_per_s_off": float(np.median(off[:, 0])),
        "cpu_s_on": float(np.median(on[:, 1])),
        "cpu_s_off": float(np.median(off[:, 1])),
        "wall_s_off": wall,
        "user_s_on": float(np.median(on[:, 3])),
        "user_s_off": float(np.median(off[:, 3])),
        "system_s_on": float(np.median(on[:, 4])),
        "system_s_off": float(np.median(off[:, 4])),
        "sleep_cpu": got["sleep_cpu"],
    }
    problems = []
    if pct >= OVERHEAD_GATE_PCT:
        problems.append("the telemetry plane's overhead %.3f %% (gate %s %%)"
                        % (pct, OVERHEAD_GATE_PCT))
    if noise >= OVERHEAD_NOISE_PCT:
        problems.append("the overhead A/B's noise %.3f %% cannot resolve "
                        "its gate (under %s %%)" % (noise, OVERHEAD_NOISE_PCT))
    if not all(r["examples_total"] for is_on, r in runs if is_on):
        problems.append("an engaged arm aggregated no snapshot")
    return rec, problems


def _fleet_held_deepfm(torch, tmp, card):
    """The held-model job on F1's data and seed (the hand-built sync
    job, tasks in the seeded order): the model, the rows it touched and
    its examples/s, for F1 in the same call."""
    from elasticdl_tpu_torch.data.dataset import Dataset

    shuffle = Dataset.shuffle
    os.environ["EDL_TASK_SHUFFLE_SEED"] = str(SEED)
    Dataset.shuffle = lambda self, *a, **k: self
    try:
        with _PsSpies() as spies:
            master = _ps_direct_job(torch, os.path.join(tmp, "ps-data"),
                                    DEVICE, None)
    finally:
        Dataset.shuffle = shuffle
        os.environ.pop("EDL_TASK_SHUFFLE_SEED", None)
    ids = _held_ids(master)
    _, dense = master.get_model(master.get_model_version())
    rows = {k: master.pull_embedding_vectors(k, v) for k, v in ids.items()}
    rec = {
        "phase": "ps_fleet", "of": "held_same_seed", "card": card,
        "version": master.get_model_version(),
        "examples_per_s": _ps_examples_per_s(spies.spans, [], PS_BATCH),
        "step_ms_median": _median(
            [(b - a) * 1e3 for a, b in spies.spans[1:]]),
        "master_apply_ms_median": {
            k: _median(list(v)) for k, v in master.apply_ms.items()},
    }
    return rec, dense, rows


def _fleet_kill(torch, tmp, card, durable):
    """Runs F2 (``durable``: snapshots every FLEET_SNAPSHOT_VERSIONS) and
    F3 (none): two async workers, ``--get_model_steps 2``, shard 1
    SIGKILLed once its version reaches FLEET_KILL_AT_VERSION and
    relaunched by the instance manager at its address. F2 arms every
    flight recorder: the master's beside its journal, each shard's
    beside its snapshots, the workers' by the environment. Returns
    (record, problems)."""
    name = "f2" if durable else "f3"
    snap = os.path.join(tmp, name + "-snap")
    snap_flags = (["--ps_snapshot_versions", str(FLEET_SNAPSHOT_VERSIONS),
                   "--ps_snapshot_dir", snap] if durable else [])
    from elasticdl_tpu_torch.ps.snapshot import snapshot_versions

    worker_postmortem = (os.path.join(tmp, name, "postmortem")
                         if durable else None)
    fleet = _Fleet(
        tmp, name, PS_DEEPFM, os.path.join(tmp, "ps-data"), PS_BATCH,
        workers=2, epochs=FLEET_ASYNC_EPOCHS,
        job=["--use_async", "true", "--get_model_steps", "2"] + snap_flags,
        ps=["--use_async", "true"] + snap_flags,
        worker=["--get_model_steps", "2"],
        worker_postmortem=worker_postmortem,
    )
    from elasticdl_tpu_torch.tools.chaos import ChaosOp, FleetChaos

    marks = {}

    def trigger(shard):
        """Shard 1's status for the chaos poller: its version, or with
        snapshots the newest one it has published, so that the kill
        follows a snapshot of version >= the mark."""
        status = fleet.status(shard, 2.0)
        marks.setdefault("epoch0", status["shard_epoch"])
        published = snapshot_versions(os.path.join(snap, "ps-1")) \
            if durable else [status["version"]]
        marks["version_seen"] = status["version"]
        return {"version": max(published) if published else -1}

    chaos = FleetChaos(fleet.manager, trigger,
                       [ChaosOp("kill", 1, at_version=FLEET_KILL_AT_VERSION)],
                       poll_s=0.02)

    def on_poll(f):
        if "kill" not in marks:
            if chaos.executed:
                _, published, killed = chaos.executed[0]
                marks["published"] = published
                marks["kill"] = killed
                marks["killed_at_version"] = marks.get("version_seen")
            return
        if "first_accepted" in marks:
            return
        try:
            status = f.status(1, 1.0)
        except Exception:  # noqa: BLE001 — still down
            return
        if status["shard_epoch"] == marks.get("epoch0"):
            return
        if "serving" not in marks:
            marks["serving"] = time.time()
            marks["restored_version"] = status["restored_version"]
            marks["epoch"] = status["shard_epoch"]
            marks["version_at_serving"] = status["version"]
        if status["initialized"] and status["version"] > max(
                0, marks["version_at_serving"]):
            marks["first_accepted"] = time.time()

    chaos.start()
    try:
        raw = fleet.run(on_poll=on_poll, inspect=lambda f: [
            f.status(i) for i in range(f.shards)])
    finally:
        chaos.stop()
    events = raw["events"]
    problems = []
    if not chaos.done() or [(op.kind, op.shard) for op, _, _ in
                            chaos.executed] != [("kill", 1)]:
        problems.append("%s chaos executed %s" % (name, chaos.executed))
    tasks = PS_RECORDS // (2 * PS_BATCH)
    if raw["journal"]["done"] != tasks * FLEET_ASYNC_EPOCHS or (
            raw["journal"]["pending"]):
        problems.append("%s journal %s, want %d done" % (
            name, raw["journal"], tasks * FLEET_ASYNC_EPOCHS))
    if raw["exit_codes"] != {"0": 0, "1": 0}:
        problems.append("%s worker exits %s" % (name, raw["exit_codes"]))
    if "kill" not in marks or "first_accepted" not in marks:
        problems.append("%s kill marks %s" % (name, marks))
    if raw["ps_exit_codes"].get("1", [None])[0] != -9:
        problems.append("%s shard exits %s" % (name, raw["ps_exit_codes"]))
    restored = marks.get("restored_version", -1)
    if durable and restored < FLEET_SNAPSHOT_VERSIONS:
        problems.append("%s restored v%s" % (name, restored))
    if not durable and restored != -1:
        problems.append("%s restored v%s without snapshots" % (
            name, restored))
    repushes = [e for ev in events.values() for e in _of(ev, "repush")]
    failed = [e for ev in events.values() for e in _of(ev, "failed")]
    if not durable and not repushes:
        problems.append("f3: no worker re-pushed the model")
    ends = _end_events(events)
    if len(ends) != 2 or not all(e["losses_finite"] for e in ends):
        problems.append("%s ends %s" % (name, ends))
    final = raw["inspect"]
    if not all(s["initialized"] for s in final):
        problems.append("%s final shards %s" % (name, final))
    postmortems = None
    if durable:
        postmortems = _postmortems(
            [os.path.join(fleet.journal, "postmortem"), worker_postmortem]
            + [os.path.join(snap, "ps-%d" % i, "postmortem")
               for i in range(fleet.shards)], tmp)
        if postmortems["unparsed"] or not postmortems["shard_failure"]:
            problems.append("%s postmortems %s" % (name, postmortems))
    if final[1]["shard_epoch"] == marks.get("epoch0"):
        problems.append("%s shard 1 kept its epoch" % name)
    rec = {
        "phase": "ps_fleet", "of": name, "card": card,
        "snapshot_versions": FLEET_SNAPSHOT_VERSIONS if durable else 0,
        "epochs": FLEET_ASYNC_EPOCHS, "job_s": raw["job_s"],
        "examples_per_s": _fleet_examples_per_s(events, PS_BATCH),
        "step_split": _fleet_split(events),
        "killed_at_version": marks.get("killed_at_version"),
        "newest_snapshot_at_kill": marks.get("published"),
        "restored_version": restored,
        "shard_epochs": [marks.get("epoch0"), marks.get("epoch")],
        "kill_to_serving_s": marks["serving"] - marks["kill"]
        if "serving" in marks and "kill" in marks else None,
        "kill_to_first_accepted_s": marks["first_accepted"] - marks["kill"]
        if "first_accepted" in marks and "kill" in marks else None,
        "repush_events": len(repushes), "journal": raw["journal"],
        "examples_per_s_before_kill": _fleet_examples_per_s(
            {w: [e for e in ev if e["t"] < marks.get("kill", 0)]
             for w, ev in events.items()}, PS_BATCH),
        # the steady rate: from the relaunched shard's first accepted push
        "examples_per_s_after_recovery": _fleet_examples_per_s(
            {w: [e for e in ev
                 if e["t"] >= marks.get("first_accepted", float("inf"))]
             for w, ev in events.items()}, PS_BATCH),
        "failed_minibatches": len(failed),
        "kill_to_last_failure_s": max(e["t"] for e in failed)
        - marks["kill"] if failed and "kill" in marks else None,
        "kill_to_first_step_by_worker": {
            str(w): next((e["t"] - marks["kill"] for e in _of(ev, "step")
                          if e["t"] > marks.get("kill", 0)), None)
            for w, ev in events.items()},
        "shards_state": [_shard_record(s) for s in final],
        "worker_peak_mib": [e.get("peak_mib") for e in ends],
        "accepted_steps": len(_fleet_steps(events)),
        "ps_exit_codes": raw["ps_exit_codes"],
        "chaos_executed": [
            {"op": repr(op), "trigger": trigger_v, "t": t}
            for op, trigger_v, t in chaos.executed],
        # the relaunched shard answers the old ring with _shm_error: each
        # worker's channel to it goes off and resends inline
        "wire": [e.get("wire") for e in ends],
        "postmortems": postmortems,
    }
    rec["worker_flash_launches"] = _worker_launches(events, problems)
    return rec, problems


def _postmortems(directories, tmp):
    """The flight recorders' dumps under ``directories``: each file by
    its path under ``tmp``, with its trigger and its event and span
    lines; ``unparsed``, the lines that are no JSON object;
    ``shard_failure``, the dumps a ``ps_shard_failure`` triggered that
    hold recent spans."""
    import glob

    out = {"dumps": {}, "unparsed": [], "shard_failure": []}
    for d in directories:
        for path in sorted(glob.glob(os.path.join(d, "**", "*.jsonl"),
                                     recursive=True)):
            lines = []
            with open(path) as f:
                for n, line in enumerate(f):
                    try:
                        lines.append(json.loads(line))
                    except ValueError:
                        out["unparsed"].append("%s:%d" % (path, n + 1))
            if not lines or not isinstance(lines[0], dict):
                out["unparsed"].append(path)
                continue
            key = os.path.relpath(path, tmp)
            types = [ln.get("type") for ln in lines[1:]]
            out["dumps"][key] = {
                "trigger": lines[0].get("postmortem"),
                "proc": lines[0].get("proc"),
                "events": types.count("event"),
                "spans": types.count("span"),
            }
            if (lines[0].get("postmortem") == "ps_shard_failure"
                    and types.count("span")):
                out["shard_failure"].append(key)
    return out


def _fleet_mnist(torch, tmp, card):
    """Run F4: the MNIST CNN, dense only, across two shards, against the
    held MNIST job from the same seed (no dataset shuffle, cuDNN's
    deterministic algorithms in both). Returns (record, problems)."""
    from elasticdl_tpu_torch.common.constants import JobType
    from elasticdl_tpu_torch.common.hash_utils import string_to_id
    from elasticdl_tpu_torch.data.dataset import Dataset
    from elasticdl_tpu_torch.master.master import _make_task_dispatcher
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.model_zoo.mnist_functional_api import (
        mnist_functional_api as zoo,
    )
    from elasticdl_tpu_torch.worker.worker import Worker

    n, batch = FLEET_MNIST_RECORDS
    data = os.path.join(tmp, "fleet-mnist")
    _write_encoded(data, _zoo_records("mnist", n, SEED + 50))
    shuffle = Dataset.shuffle
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    os.environ["EDL_TASK_SHUFFLE_SEED"] = str(SEED)
    Dataset.shuffle = lambda self, *a, **k: self
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with _PsSpies() as spies:
            task_d = _make_task_dispatcher(data, "", "", 2 * batch, 1)
            held = MasterServicer(1, batch, zoo.optimizer(), task_d,
                                  device=DEVICE)
            Worker(0, JobType.TRAINING_ONLY, batch, "", PS_MNIST,
                   stub=held, device=DEVICE, loss_log_steps=0).run()
    finally:
        Dataset.shuffle = shuffle
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
        os.environ.pop("EDL_TASK_SHUFFLE_SEED", None)
    _, want = held.get_model(held.get_model_version())
    fleet = _Fleet(tmp, "f4", PS_MNIST, data, batch, deterministic=True)
    raw = fleet.run(inspect=lambda f: _fleet_state(f, {}))
    state = raw["inspect"]
    rel, bitwise = _compare(state, want, {})
    client_names = sorted(state["dense"])
    problems = []
    if raw["exit_codes"] != {"0": 0} or sorted(want) != client_names:
        problems.append("f4 exits %s names %s" % (
            raw["exit_codes"], client_names))
    if max(rel.values()) > FLEET_TOL:
        problems.append("f4 against the held MNIST: %s" % rel)
    if state["version"] != held.get_model_version() or not state["version"]:
        problems.append("f4 version %s held %s" % (
            state["version"], held.get_model_version()))
    events = raw["events"]
    rec = {
        "phase": "ps_fleet", "of": "f4_mnist", "card": card,
        "batch": batch, "records": n, "version": state["version"],
        "rel_l2_max": max(rel.values()), "bitwise": bitwise,
        "tolerance": FLEET_TOL,
        "dense_on_shard": {k: string_to_id(k, FLEET_SHARDS)
                           for k in client_names},
        "examples_per_s": _fleet_examples_per_s(events, batch),
        "held_examples_per_s": _ps_examples_per_s(spies.spans, [], batch),
        "step_split": _fleet_split(events),
        "shards_state": [_shard_record(s) for s in state["statuses"]],
    }
    rec["worker_flash_launches"] = _worker_launches(events, problems)
    return rec, problems


def _fleet_master_kill(torch, tmp, card):
    """F5's journal run: the held DeepFM model (``master.main
    --num_ps_pods 0 --master_journal_dir``) with one worker process, the
    master SIGKILLed at FLEET_MASTER_KILL_AT_VERSION and relaunched: the
    worker re-pushes its model to the new incarnation and every task is
    done once. Returns (record, problems)."""
    fleet = _Fleet(tmp, "f5-journal", PS_DEEPFM,
                   os.path.join(tmp, "ps-data"), PS_BATCH, shards=0,
                   epochs=2)
    from elasticdl_tpu_torch.tools.chaos import ChaosOp, FleetChaos

    marks = {}
    chaos = FleetChaos(
        fleet.manager, lambda shard: {},
        [ChaosOp("kill_master", -1,
                 at_version=FLEET_MASTER_KILL_AT_VERSION)],
        poll_s=0.02,
        master_status_fn=lambda: _master_probe(fleet.master_port),
    )

    def on_poll(f):
        if "kill" in marks:
            if "serving" not in marks:
                try:
                    _master_probe(f.master_port)
                    marks["serving"] = time.time()
                except Exception:  # noqa: BLE001 — still down
                    pass
            return
        if chaos.executed:
            _, version, killed = chaos.executed[0]
            marks["kill"] = killed
            marks["killed_at_version"] = version

    chaos.start()
    try:
        raw = fleet.run(on_poll=on_poll)
    finally:
        chaos.stop()
    events = raw["events"]
    problems = []
    if not chaos.done() or [op.kind for op, _, _ in chaos.executed] != [
            "kill_master"]:
        problems.append("f5 chaos executed %s" % chaos.executed)
    tasks = 2 * PS_RECORDS // (2 * PS_BATCH)
    if raw["journal"]["done"] != tasks or raw["journal"]["pending"]:
        problems.append("f5 journal %s, want %d" % (raw["journal"], tasks))
    if raw["master_exit_codes"] != [-9, 0] or raw["exit_codes"] != {"0": 0}:
        problems.append("f5 exits: master %s worker %s" % (
            raw["master_exit_codes"], raw["exit_codes"]))
    repush = [e for ev in events.values() for e in _of(ev, "repush")]
    after = [e for e in _fleet_steps(events)
             if "kill" in marks and e["t"] > marks["kill"]]
    if not repush or not after:
        problems.append("f5: re-push %s, steps after the kill %d" % (
            repush, len(after)))
    rec = {
        "phase": "ps_fleet", "of": "f5_master_kill", "card": card,
        "killed_at_version": marks.get("killed_at_version"),
        "kill_to_serving_s": marks["serving"] - marks["kill"]
        if "serving" in marks else None,
        "kill_to_repush_s": repush[0]["t"] - marks["kill"]
        if repush and "kill" in marks else None,
        "kill_to_first_accepted_s": after[0]["t"] - marks["kill"]
        if after else None,
        "failed_minibatches": sum(len(_of(ev, "failed"))
                                  for ev in events.values()),
        "journal": raw["journal"], "accepted_steps": len(
            _fleet_steps(events)),
        "chaos_executed": [
            {"op": repr(op), "trigger": trigger_v, "t": t}
            for op, trigger_v, t in chaos.executed],
    }
    rec["worker_flash_launches"] = _worker_launches(events, problems)
    return rec, problems


def _fleet_exports(torch, tmp, card):
    """F5's streaming exports: held MNIST in process with ``--export_dir
    --export_every_versions 4 --export_keep 2`` (and a checkpoint each
    version): the newest artifact, served by ``ModelDirectoryWatcher``
    on the card, replies as the model of its version. Returns (record,
    problems)."""
    import numpy as np

    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.common.constants import GetModelMethod
    from elasticdl_tpu_torch.common.convert import to_state_dict
    from elasticdl_tpu_torch.common.model_utils import build_model
    from elasticdl_tpu_torch.serving.scorer import (
        ModelDirectoryWatcher,
        Scorer,
    )

    every, keep = FLEET_EXPORT
    data = os.path.join(tmp, "fleet-export-data")
    _write_encoded(data, _zoo_records("mnist", FLEET_EXPORT_RECORDS,
                                      SEED + 51))
    export_root = os.path.join(tmp, "fleet-exports")
    jobs = []
    rc = cli.main(_ps_argv(
        "train", PS_MNIST, 64, "--training_data", data,
        "--checkpoint_dir", os.path.join(tmp, "fleet-export-ckpt"),
        "--checkpoint_steps", "1", "--export_dir", export_root,
        "--export_every_versions", str(every), "--export_keep", str(keep),
    ), jobs=jobs)
    job = jobs[0]
    exported = [v for v, _ in job.worker.exports]
    kept = sorted(os.listdir(export_root))
    problems = []
    want_versions = list(range(every - 1, FLEET_EXPORT_RECORDS // 64,
                               every))
    if rc != 0 or exported != want_versions or kept != [
            "v%010d" % v for v in want_versions[-keep:]]:
        problems.append("exports rc=%s %s kept %s" % (rc, exported, kept))
    scorer = Scorer()
    watcher = ModelDirectoryWatcher(export_root, scorer, device=DEVICE)
    newest = watcher.poll_once()
    images = np.random.default_rng(SEED + 52).random(
        (64, 28, 28), dtype=np.float32) * 255
    rel = None
    if newest is None:
        problems.append("the watcher loaded no export")
    else:
        got, version = scorer.score({"image": images})
        _, named = job.master.master_servicer.get_model(
            newest, GetModelMethod.FIXED)
        model = build_model(PS_MNIST).to(DEVICE)
        model.load_state_dict(to_state_dict(named))
        with torch.no_grad():
            want = model.eval()({"image": torch.from_numpy(images)})
        rel = _rel_l2(torch, got.float(), want.float())
        if version != newest or rel > FLEET_TOL:
            problems.append("the export of v%s scores %.3g off" % (
                version, rel))
    scorer.close()
    rec = {"phase": "ps_fleet", "of": "f5_exports", "card": card,
           "exported_versions": exported, "kept": kept,
           "served_version": newest, "reply_rel_l2": rel,
           "export_s": [s for _, s in job.worker.exports]}
    return rec, problems


def _write_ps_data(tmp):
    """The ps phase's DeepFM records (its seeds), where not written."""
    for name, n, seed in (("ps-data", PS_RECORDS, SEED + 40),
                          ("ps-val", PS_VAL_RECORDS, SEED + 41)):
        if not os.path.isdir(os.path.join(tmp, name)):
            ids, labels = _frappe_ids(n, seed)
            _write_frappe(os.path.join(tmp, name), ids, labels)


def phase_ps_fleet(torch, tmp, card):
    """The PS fleet: F1 sync DeepFM across two shards against the held
    job from the same seed, F2/F3 a shard SIGKILL with
    and without snapshots, F4 MNIST across two shards, F5 the held
    model's journal, streaming exports and the bf16 wire. Returns the
    flash kernels' launches over the phase (none)."""
    t0 = time.perf_counter()
    _write_ps_data(tmp)
    problems = []
    worker_launches = {k: 0 for k in KERNELS}
    _reset_counters()
    f1_state = {}

    def f1():
        held_rec, dense, rows = _fleet_held_deepfm(torch, tmp, card)
        emit(held_rec)
        rec, bad, state = _fleet_f1(torch, tmp, card)
        rel, bitwise = _compare(state, dense, rows)
        rec["against_held"] = {"rel_l2_max": max(rel.values()),
                               "bitwise": bitwise, "tolerance": FLEET_TOL}
        rec["held_examples_per_s"] = held_rec["examples_per_s"]
        if max(rel.values()) > FLEET_TOL:
            bad.append("f1 against the held job: %s" % rel)
        f1_state.update(state)
        f1_state["examples_per_s"] = rec["examples_per_s"]
        return rec, bad

    bf16_fleet = []

    def exports():
        # the bf16 repeat's fleet boots, and runs, beside F5's exports
        # (in this process): its state is held against F1's, and no rate
        # of it is kept
        bf16_fleet.append(_f1_fleet(tmp, "bfloat16"))
        bf16_fleet[0].start()
        return _fleet_exports(torch, tmp, card)

    def bf16():
        rec, bad, state = _fleet_f1(torch, tmp, card, wire="bfloat16",
                                    fleet=bf16_fleet[0])
        rel, _ = _compare(state, f1_state["dense"], f1_state["rows"])
        rec["against_f1"] = {"rel_l2_max": max(rel.values()),
                             "tolerance": FLEET_BF16_TOL}
        if max(rel.values()) > FLEET_BF16_TOL:
            bad.append("the bf16 wire against f1: %s" % rel)
        if max(rel.values()) == 0.0:
            # a wire that never narrowed trains bitwise like F1
            bad.append("the bf16 wire left every tensor float32")
        return rec, bad

    # the plane's overhead A/B first, on a host with no fleet running;
    # its record follows F1's, with F1's examples/s beside it
    overhead, overhead_bad = _telemetry_overhead()

    def overhead_record():
        return dict(overhead, f1_examples_per_s=f1_state.get(
            "examples_per_s")), overhead_bad

    for run in (
        f1,
        overhead_record,
        lambda: _fleet_kill(torch, tmp, card, durable=True),
        lambda: _fleet_kill(torch, tmp, card, durable=False),
        lambda: _fleet_mnist(torch, tmp, card),
        lambda: _fleet_master_kill(torch, tmp, card),
        exports,
        bf16,
    ):
        rec, bad = run()
        emit(rec)
        problems += bad
        for k, n in rec.get("worker_flash_launches", {}).items():
            worker_launches[k] += n
        torch.cuda.empty_cache()
    counts = {k: (n + worker_launches[k], shapes)
              for k, (n, shapes) in _counts().items()}
    emit({"phase": "ps_fleet", "of": "summary", "seconds":
          time.perf_counter() - t0, "flash_launches":
          {k: n for k, (n, _) in counts.items()}})
    if problems:
        raise PhaseError("ps_fleet: " + "; ".join(problems))
    return counts


def _ps_fleet_only(torch):
    try:
        card = phase_device(torch)
        with tempfile.TemporaryDirectory() as tmp:
            counts = phase_ps_fleet(torch, tmp, card)
        _check_counts(counts, {k: 0 for k in KERNELS}, "the ps_fleet phase")
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


def _f1_order(torch, order):
    """F1 once per arm of ``order`` (each one of F1_PLANES), in turns,
    on one copy of its data: a record per run (its examples/s, the median
    step and its split, its problems), then each arm's runs side by
    side. Exits non-zero if any run had a problem (only "on" runs the
    telemetry checks)."""
    try:
        card = phase_device(torch)
        by_arm = {}
        failed = []
        with tempfile.TemporaryDirectory() as tmp:
            _write_ps_data(tmp)
            for i, plane in enumerate(order):
                root = os.path.join(tmp, "run-%d" % i)
                os.makedirs(root)
                for d in ("ps-data", "ps-val"):
                    os.symlink(os.path.join(tmp, d), os.path.join(root, d))
                rec, bad, _ = _fleet_f1(torch, root, card,
                                        fleet=_f1_fleet(root, plane=plane))
                emit({"phase": "ps_fleet", "of": "f1_arm", "run": i,
                      "plane": plane, "card": card,
                      "examples_per_s": rec["examples_per_s"],
                      "step_ms_median": rec["step_ms_median"],
                      "step_split": rec["step_split"],
                      "shards_state": rec["shards_state"],
                      "job_s": rec["job_s"], "problems": bad})
                by_arm.setdefault(plane, []).append(rec["examples_per_s"])
                failed += bad
                torch.cuda.empty_cache()
        emit({"phase": "ps_fleet", "of": "f1_arms", "card": card,
              "order": list(order), "examples_per_s": by_arm})
        if failed:
            raise PhaseError("; ".join(failed))
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


# ---------------------------------------------------------------------------
# ps_tiers: the three tiers of row residence on the fleet, on zipf ids
# ---------------------------------------------------------------------------

Z_RECORDS = PS_RECORDS  # one epoch of b1024 steps
Z_POOL = 1 << 18  # the ids drawn, permuted out of ZOO_VOCAB
Z_ZIPF = 1.05  # each id's weight 1 / rank^Z_ZIPF (bench.py's tiered bench)
Z_WARM_ROWS = 4096  # Z2's --ps_warm_rows, per table and shard
Z_WARM_FACTOR = 4  # distinct ids per shard and table >= this x warm rows
Z_CACHE = (65536, 1)  # Z3's --hot_row_cache_rows, --hot_row_staleness_window
Z_CACHE_TOL = 5e-2  # Z3 against Z0, relative L2: (0, this]
Z_ROUND_TRIP_DIM = 64  # the arena round trip: DeepFM's embedding width


def _zipf_ids(n, seed):
    """``n`` records of 10 ids drawn with weights 1 / rank^Z_ZIPF from
    Z_POOL ids permuted out of ZOO_VOCAB, and their 0/1 labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = rng.permutation(ZOO_VOCAB)[:Z_POOL]
    weights = 1.0 / np.arange(1, Z_POOL + 1) ** Z_ZIPF
    ids = pool[rng.choice(Z_POOL, size=(n, 10), p=weights / weights.sum())]
    return ids.astype(np.int64), rng.integers(0, 2, n)


def _z_cache(events):
    """The workers' hot-row cache counters (their end events)."""
    caches = [e["hot_row_cache"] for e in _end_events(events)
              if e.get("hot_row_cache")]
    if not caches:
        return None
    hits = sum(c["hits"] for c in caches)
    misses = sum(c["misses"] for c in caches)
    return {"hits": hits, "misses": misses,
            "hit_rate": hits / (hits + misses) if hits + misses else None,
            "rows": sum(c["rows"] for c in caches),
            "tables": [c["tables"] for c in caches]}


def _dispatched_ranges(journal_dir):
    """The record ranges of the tasks the master handed out, in the order
    its journal's dispatch records give."""
    import glob

    out = []
    for path in sorted(glob.glob(os.path.join(journal_dir, "seg-*.jsonl"))):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("k") == "dispatch":
                    out.append(tuple(rec["key"][3:5]))
    return out


def _z_cache_recount(ids, ranges, batch, tables, max_rows, window):
    """The hits and misses per table that a correct hot-row cache scores
    on one sync worker's stream, counted from the written ids: the
    batches in dispatch order, each table probed once a step with the
    batch's distinct ids. At step s every shard's newest version is s
    (one apply a step), so a row pulled at step p serves at step s while
    p >= s - window, and a miss pulls it afresh. None where the LRU could
    evict a row that still serves (``max_rows`` under the distinct ids
    of window + 1 steps, all tables): then the count depends on its
    order."""
    import numpy as np

    pulled = {}  # id -> the step it was last pulled at
    hits = misses = 0
    sizes = []
    for start, end in ranges:
        for b in range(start, end, batch):
            s = len(sizes)
            uniq = np.unique(ids[b:min(b + batch, end)])
            sizes.append(len(uniq))
            if len(tables) * sum(sizes[-window - 1:]) > max_rows:
                return None
            for i in uniq.tolist():
                p = pulled.get(i)
                if p is not None and p >= s - window:
                    hits += 1
                else:
                    misses += 1
                    pulled[i] = s
    # every table is looked up with the same feature ids
    return {t: {"hits": hits, "misses": misses} for t in tables}


def _z_run(torch, tmp, card, name, seen, ps=(), worker=()):
    """One Z run: the sync DeepFM job on the zipf data across two shards,
    one worker process with torch's deterministic algorithms. Returns
    (record, problems, the fleet's final state)."""
    data = os.path.join(tmp, "z-data")
    fleet = _Fleet(tmp, name, PS_DEEPFM, data, PS_BATCH,
                   job=["--grads_to_wait", "1"],
                   ps=["--grads_to_wait", "1"] + list(ps),
                   worker=list(worker),
                   deterministic=_DETERMINISTIC_ALGORITHMS_WORKER)
    ids = {"embedding": seen, "id_bias": seen}
    raw = fleet.run(inspect=lambda f: _fleet_state(f, ids))
    state = raw["inspect"]
    steps = Z_RECORDS // PS_BATCH
    events = raw["events"]
    ends = _end_events(events)
    problems = []
    if raw["exit_codes"] != {"0": 0} or raw["master_exit_codes"] != [0]:
        problems.append("%s exits %s, master %s" % (
            name, raw["exit_codes"], raw["master_exit_codes"]))
    if raw["journal"]["done"] != steps // 2 or raw["journal"]["pending"]:
        problems.append("%s journal %s" % (name, raw["journal"]))
    if not state["ready"] or state["version"] != steps:
        problems.append("%s fleet version %s" % (name, state["version"]))
    if len(_fleet_steps(events)) != steps or not ends or not all(
            e["losses_finite"] for e in ends):
        problems.append("%s steps %d, ends %s" % (
            name, len(_fleet_steps(events)), ends))
    for key, (before, after, mine) in state["placement"].items():
        if not before == after == mine:
            problems.append("%s shard rows %s: %s before, %s after, %d "
                            "with id %% %d" % (name, key, before, after,
                                               mine, FLEET_SHARDS))
    tiered = [s.get("tiered") for s in state["statuses"]]
    rec = {
        "phase": "ps_tiers", "of": name, "card": card,
        "model": "deepfm_edl_embedding", "batch": PS_BATCH,
        "records": Z_RECORDS, "shards": FLEET_SHARDS,
        "ps_flags": list(ps), "worker_flags": list(worker),
        "version": state["version"], "job_s": raw["job_s"],
        "examples_per_s": _fleet_examples_per_s(events, PS_BATCH),
        "step_split": _fleet_split(events),
        "step_ms_median": _median(
            [(b["t"] - a["t"]) * 1e3 for a, b in zip(
                _fleet_steps(events), _fleet_steps(events)[1:])]),
        "shards_state": [_shard_record(s) for s in state["statuses"]],
        "tiered": tiered if any(tiered) else None,
        "hot_row_cache": _z_cache(events),
        "worker_peak_mib": [e.get("peak_mib") for e in ends],
        "journal": raw["journal"], "ps_exit_codes": raw["ps_exit_codes"],
        "losses_first_last": [e.get("losses_first_last") for e in ends],
        "dispatched": _dispatched_ranges(fleet.journal),
    }
    rec["worker_flash_launches"] = _worker_launches(events, problems)
    if any(rec["worker_flash_launches"].values()):
        problems.append("%s launched flash kernels: %s" % (
            name, rec["worker_flash_launches"]))
    return rec, problems, state


def _z_grouped_rel(state, base):
    """Relative L2 of the dense parameters taken together, and of each
    table's touched rows, against ``base`` (a zero-initialized bias alone
    moves so little in 16 steps that its own ratio says nothing)."""
    import numpy as np

    names = sorted(base["dense"])
    out = {"dense": _np_rel(
        np.concatenate([np.ravel(state["dense"][k]) for k in names]),
        np.concatenate([np.ravel(base["dense"][k]) for k in names]))}
    for table, rows in base["rows"].items():
        out["rows:" + table] = _np_rel(state["rows"][table], rows)
    return out


def _z_round_trip(torch, ids):
    """An arena on the card: its snapshot restored into a host table and
    the host table's into a fresh arena, bitwise, rows minted after each
    restore included."""
    import numpy as np

    from elasticdl_tpu_torch.ps.device_store import DeviceEmbeddingTable
    from elasticdl_tpu_torch.ps.embedding_table import EmbeddingTable

    rng = np.random.default_rng(SEED + 52)
    dim = Z_ROUND_TRIP_DIM
    arena = DeviceEmbeddingTable("embedding", dim, "uniform", device=DEVICE)
    arena.get(ids)
    written = ids[: len(ids) // 4]
    arena.set(written, rng.normal(size=(len(written), dim)).astype(
        np.float32))
    arena.evict_rows(ids[-len(ids) // 8:])  # slots on the free list
    host = EmbeddingTable("embedding", dim, "uniform")
    host.load_snapshot(*arena.snapshot())
    back = DeviceEmbeddingTable("embedding", dim, "uniform", device=DEVICE)
    back.load_snapshot(*host.snapshot())
    probe = np.concatenate([ids, rng.integers(0, ZOO_VOCAB, 512)])
    want = arena.get(probe)
    rec = {"phase": "ps_tiers", "of": "arena_round_trip", "rows": len(ids),
           "dim": dim, "arena_rows": arena.capacity,
           "arena_to_host_bitwise": bool(np.array_equal(host.get(probe),
                                                        want)),
           "host_to_arena_bitwise": bool(np.array_equal(back.get(probe),
                                                        want))}
    bad = [] if rec["arena_to_host_bitwise"] and rec[
        "host_to_arena_bitwise"] else ["the arena round trip: %s" % rec]
    return rec, bad


def _write_z_data(tmp):
    """Z's records, and each shard's distinct ids (one set for both
    tables: DeepFM looks every feature id up in both)."""
    import numpy as np

    ids, labels = _zipf_ids(Z_RECORDS, SEED + 50)
    _write_frappe(os.path.join(tmp, "z-data"), ids, labels)
    seen = np.unique(ids)
    return ids, seen, [int((seen % FLEET_SHARDS == s).sum())
                       for s in range(FLEET_SHARDS)]


def phase_ps_tiers(torch, tmp, card):
    """The three tiers of row residence on the fleet, DeepFM on zipf ids:
    Z0 the host store, Z2 ``--ps_device`` tiered (``--ps_warm_rows
    --ps_spill_dir``: the tier over the arena), Z3 the host store with
    the worker's hot-row cache; Z2 bitwise against Z0, Z3 within
    Z_CACHE_TOL of it and not bitwise, its cache's hits and misses those
    recounted from the written ids; an arena's snapshot round trip
    through a host table. Returns the flash kernels' launches over the
    phase (none)."""
    t0 = time.perf_counter()
    ids, seen, per_shard = _write_z_data(tmp)
    problems = []
    worker_launches = {k: 0 for k in KERNELS}
    _reset_counters()
    spill = os.path.join(tmp, "z-spill")
    # Z2's tier wraps the arena, so its run holds --ps_device to Z0 too
    # (a run of the arena alone was cut for the every-phase run's time)
    runs = (
        ("z0", (), ()),
        ("z2", ("--ps_device", "true", "--ps_warm_rows", str(Z_WARM_ROWS),
                "--ps_spill_dir", spill), ()),
        ("z3", (), ("--hot_row_cache_rows", str(Z_CACHE[0]),
                    "--hot_row_staleness_window", str(Z_CACHE[1]))),
    )
    base = None
    for name, ps, worker in runs:
        rec, bad, state = _z_run(torch, tmp, card, name, seen, ps, worker)
        if base is None:
            base = state
        else:
            rel, bitwise = _compare(state, base["dense"], base["rows"])
            rec["against_z0"] = {"rel_l2_max": max(rel.values()),
                                 "bitwise": bitwise}
            if name == "z2" and not bitwise:
                bad.append("%s is not bitwise Z0: %s" % (name, rel))
            if name == "z3":
                cache = rec["hot_row_cache"] or {}
                if not cache.get("hits"):
                    bad.append("z3's cache never hit: %s" % cache)
                # a cache that served rows past its window, or dropped
                # rows inside it, scores other counts than these
                want = _z_cache_recount(
                    ids, rec["dispatched"], PS_BATCH, ("embedding",
                                                       "id_bias"), *Z_CACHE)
                got = {t: {k: st[k] for k in ("hits", "misses")}
                       for tables in cache.get("tables", ())
                       for t, st in tables.items()}
                rec["hot_row_cache"]["recounted"] = want
                if want is None or got != want:
                    bad.append("z3's cache counted %s, the written ids give "
                               "%s" % (got, want))
                grouped = _z_grouped_rel(state, base)
                rec["against_z0"].update(per_tensor=rel, grouped=grouped,
                                         tolerance=Z_CACHE_TOL)
                if not all(0.0 < v <= Z_CACHE_TOL for v in grouped.values()):
                    bad.append("z3 against z0 %s, not in (0, %g]" % (
                        grouped, Z_CACHE_TOL))
        if name == "z2":
            summed = {}
            for shard in rec["tiered"] or ():
                for k, v in (shard or {}).items():
                    summed[k] = summed.get(k, 0) + v
            rec["tiered_summed"] = summed
            rec["distinct_ids_per_shard"] = per_shard
            rec["warm_rows"] = Z_WARM_ROWS
            if not (summed.get("spilled_rows", 0) > 0
                    and summed.get("cold_pull_rows", 0) > 0):
                bad.append("z2's disk tier went unused: %s" % summed)
            if min(per_shard) < Z_WARM_FACTOR * Z_WARM_ROWS:
                bad.append("z2's shards hold %s distinct ids, under %d x "
                           "%d" % (per_shard, Z_WARM_FACTOR, Z_WARM_ROWS))
        emit(rec)
        problems += bad
        for k, n in rec["worker_flash_launches"].items():
            worker_launches[k] += n
        torch.cuda.empty_cache()
    rec, bad = _z_round_trip(torch, seen[: min(len(seen), 16384)])
    emit(rec)
    problems += bad
    counts = {k: (n + worker_launches[k], shapes)
              for k, (n, shapes) in _counts().items()}
    emit({"phase": "ps_tiers", "of": "summary", "seconds":
          time.perf_counter() - t0, "flash_launches":
          {k: n for k, (n, _) in counts.items()}})
    if problems:
        raise PhaseError("ps_tiers: " + "; ".join(problems))
    return counts


def _ps_tiers_only(torch):
    try:
        card = phase_device(torch)
        with tempfile.TemporaryDirectory() as tmp:
            counts = phase_ps_tiers(torch, tmp, card)
        _check_counts(counts, {k: 0 for k in KERNELS}, "the ps_tiers phase")
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


# ---------------------------------------------------------------------------
# ps_hybrid: the hybrid trainer on the fleet, DeepFM on zipf ids
# ---------------------------------------------------------------------------

H_PREFETCH_TOL = 5e-2  # H0's prefetch arm against the prefetch-off arm
H_MAX_MISSED = 1  # pushes a staged pull may miss: the batch in flight's


def _h_params(plane):
    """The zoo DeepFM's params on ``plane``: the ids span ZOO_VOCAB, the
    size of the hybrid arm's ``id_bias`` table."""
    return "vocab_size=%d,embedding_plane='%s'" % (ZOO_VOCAB, plane)


def _h_arm(torch, plane, prefetch, data=None):
    """An H0 arm in this process: two fresh sync servicers on the card
    (the zoo's SGD 0.1), a client, and a worker on ``plane`` (the zoo's
    and the worker's); with ``data``, an in-process master handing out
    one epoch of it. Returns (worker, client, shards, dispatcher)."""
    from elasticdl_tpu_torch.common.constants import JobType
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
        deepfm_edl_embedding as zoo,
    )
    from elasticdl_tpu_torch.ps.parameters import Parameters
    from elasticdl_tpu_torch.ps.servicer import PserverServicer
    from elasticdl_tpu_torch.worker.ps_client import PSClient
    from elasticdl_tpu_torch.worker.worker import Worker

    shards = [PserverServicer(Parameters(), 1, zoo.optimizer(), DEVICE)
              for _ in range(FLEET_SHARDS)]
    client = PSClient(shards)
    task_d = master = None
    if data is not None:
        task_d = TaskDispatcher({data: (0, Z_RECORDS)}, {}, {},
                                2 * PS_BATCH, 1)
        master = MasterServicer(1, PS_BATCH, None, task_d,
                                coordinates_only=False, device=DEVICE)
    worker = Worker(
        worker_id=0, job_type=JobType.TRAINING_ONLY,
        minibatch_size=PS_BATCH, model_zoo="", model_def=PS_DEEPFM,
        model_params=_h_params(plane), stub=master, device=DEVICE,
        ps_client=client, embedding_plane=plane,
        embedding_prefetch=prefetch,
    )
    return worker, client, shards, task_d


def _h_init(torch, features, seen, pair):
    """Give both arms of ``pair`` (PS first, then hybrid) one
    initialization: both create their variables on ``features``, the
    hybrid arm takes the PS arm's Dense layers and, for every id in
    ``seen``, the ``id_bias`` rows the PS arm's store mints. Returns the
    hybrid arm's own first push (before the copy)."""
    (ps, ps_client), (hy, _) = pair
    ps._run_model_call_before_training(features)
    hy._run_model_call_before_training(features)
    # copies: on the CPU the wire arrays can be views of the parameters
    first_push = {k: v.copy() for k, v in hy._to_wire(hy._params).items()}
    bias = ps_client.pull_embedding_vectors("id_bias", seen)
    with torch.no_grad():
        for k, v in ps._params.items():
            hy._params[k].copy_(v)
        hy._params["id_bias.table"][torch.from_numpy(seen).to(DEVICE)] = (
            torch.from_numpy(bias).to(DEVICE))
    return first_push


def _h_staleness_probe(worker, shards):
    """Hold every staged pull of an in-process arm to one step of
    staleness. When the pipeline's thread starts a pull, the shards'
    versions are noted; when the worker consumes it for batch N+1, the
    steps it has computed (N) less the pushes those versions already
    hold is what the rows miss, and only batch N's push may be missing.
    A pull staged two batches ahead, or before the previous push was
    applied, or a push held back a step, misses two. Returns the list
    that gets one count per served step."""
    plane, pipe = worker._sparse_plane, worker._emb_pipeline
    pull, push, consume = plane.pull, plane.push, pipe.consume
    train = worker.training_process

    def versions():
        return tuple(s._parameters.version for s in shards)

    after = [versions()]  # before the first push, then after each
    started, missed, steps = {}, [], [0]

    def probe_pull(ids_by_table, **kwargs):
        at = versions()
        rows = pull(ids_by_table, **kwargs)
        if threading.current_thread().name.startswith("edl-emb-pull"):
            started[id(rows)] = at
        return rows

    def probe_push(sparse, version):
        out = push(sparse, version)
        after.append(versions())
        return out

    def probe_consume(key):
        got = consume(key)
        if got is not None:
            at = started.pop(id(got[1]))
            held = sum(1 for v in after[1:]
                       if all(a <= b for a, b in zip(v, at)))
            missed.append(steps[0] - held)
        return got

    def probe_train(features, labels):
        out = train(features, labels)
        steps[0] += 1
        return out

    plane.pull, plane.push, pipe.consume = probe_pull, probe_push, probe_consume
    worker.training_process = probe_train
    return missed


def _h_state(worker, client, seen):
    """An arm's end state: the dense model (the fleet's under PS, the
    worker's own under hybrid), the ``embedding`` rows of ``seen`` and
    the ``id_bias`` rows of ``seen``."""
    if worker._dense_local:
        dense = worker._to_wire(worker._params)
        bias = dense.pop("id_bias/table")[seen]
    else:
        ready, _, dense = client.pull_dense()
        if not ready:
            raise PhaseError("h0: the PS arm's shards hold no model")
        bias = client.pull_embedding_vectors("id_bias", seen)
    return {"dense": dense, "rows": {
        "embedding": client.pull_embedding_vectors("embedding", seen),
        "id_bias": bias}}


def _h_compare(got, want):
    """Per tensor relative L2 of ``got`` against ``want``, and whether
    every tensor is bitwise equal."""
    import numpy as np

    rel = {k: _np_rel(got["dense"][k], v) for k, v in want["dense"].items()}
    rel.update({"rows:" + k: _np_rel(got["rows"][k], v)
                for k, v in want["rows"].items()})
    bitwise = sorted(got["dense"]) == sorted(want["dense"]) and all(
        np.array_equal(got["dense"][k], v)
        for k, v in want["dense"].items()) and all(
        np.array_equal(got["rows"][k], v) for k, v in want["rows"].items())
    return rel, bitwise


def _h_one_batch(torch, ps, hy, features, labels):
    """One batch through both arms: logits, loss, the Dense gradients,
    the ``embedding`` row gradients and ids bitwise; the hybrid arm's
    dense ``id_bias`` gradient against the PS arm's rows scattered into a
    zero table (bitwise, or within FLEET_TOL where the card's two scatter
    paths add in other orders)."""
    import numpy as np

    from elasticdl_tpu_torch.common import convert

    def host(t):
        return t.detach().to("cpu").float().numpy()

    out = {}
    fp = host(ps.forward_process(features)["logits"])
    fh = host(hy.forward_process(features)["logits"])
    out["logits_bitwise"] = bool(np.array_equal(fp, fh))
    lp, gp, sp = ps.training_process(features, labels)
    lh, gh, sh = hy.training_process(features, labels)
    out["loss_bitwise"] = float(lp) == float(lh)
    gp = {k: host(v) for k, v in convert.to_named(gp).items()}
    gh = {k: host(v) for k, v in convert.to_named(gh).items()}
    out["dense_grads_bitwise"] = all(
        np.array_equal(gp[k], gh[k]) for k in gp)
    sp = {t.name: t for t in sp}
    sh = {t.name: t for t in sh}
    out["pushed_tables"] = {"ps": sorted(sp), "hybrid": sorted(sh)}
    out["embedding_rows_bitwise"] = bool(
        np.array_equal(sp["embedding"].values, sh["embedding"].values)
        and np.array_equal(sp["embedding"].indices,
                           sh["embedding"].indices))
    scattered = np.zeros((ZOO_VOCAB, 1), np.float32)
    scattered[sp["id_bias"].indices] = sp["id_bias"].values
    out["id_bias_bitwise"] = bool(
        np.array_equal(scattered, gh["id_bias/table"]))
    out["id_bias_rel_l2"] = _np_rel(gh["id_bias/table"], scattered)
    bad = [k for k in ("logits_bitwise", "loss_bitwise",
                       "dense_grads_bitwise", "embedding_rows_bitwise")
           if not out[k]]
    if out["pushed_tables"] != {"ps": ["embedding", "id_bias"],
                                "hybrid": ["embedding"]}:
        bad.append("pushed tables %s" % out["pushed_tables"])
    if out["id_bias_rel_l2"] > FLEET_TOL:
        bad.append("id_bias %g" % out["id_bias_rel_l2"])
    return out, bad


def _h0(torch, tmp, card, ids, labels, seen):
    """H0: the equivalence pre-pass in this process on the card (the
    reference bench's), then 16 steps of each arm through ``Worker.run``,
    then the hybrid arm with its prefetch on. Returns (record, problems,
    the hybrid arm's first push)."""
    import numpy as np

    from elasticdl_tpu_torch.data.dataset import Dataset

    t0 = time.perf_counter()
    data = os.path.join(tmp, "z-data", "records-0")
    features = {"feature": ids[:PS_BATCH]}
    batch_labels = labels[:PS_BATCH].reshape(-1, 1).astype(np.int32)
    problems = []
    rec = {"phase": "ps_hybrid", "of": "h0", "card": card,
           "model": "deepfm_edl_embedding", "batch": PS_BATCH,
           "records": Z_RECORDS, "shards": FLEET_SHARDS,
           "vocab": ZOO_VOCAB, "seen_ids": len(seen)}
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    shuffle = Dataset.shuffle
    seed_env = os.environ.get("EDL_TASK_SHUFFLE_SEED")
    torch.use_deterministic_algorithms(True, warn_only=True)
    Dataset.shuffle = lambda self, *a, **k: self
    os.environ["EDL_TASK_SHUFFLE_SEED"] = str(SEED)
    opened = []
    try:
        # the one-batch equivalence
        arms = [_h_arm(torch, plane, False) for plane in ("ps", "hybrid")]
        opened += [a[1] for a in arms]
        first_push = _h_init(torch, features, seen,
                             [(a[0], a[1]) for a in arms])
        rec["one_batch"], bad = _h_one_batch(
            torch, arms[0][0], arms[1][0], features, batch_labels)
        problems += ["h0 one batch: " + b for b in bad]

        # 16 steps of each arm, then the hybrid arm with its prefetch
        arms = [_h_arm(torch, plane, prefetch, data) for plane, prefetch in
                (("ps", False), ("hybrid", False), ("hybrid", True))]
        opened += [a[1] for a in arms]
        _h_init(torch, features, seen, [(a[0], a[1]) for a in arms[:2]])
        _h_init(torch, features, seen, [(a[0], a[1]) for a in arms[::2]])
        missed = _h_staleness_probe(arms[2][0], arms[2][2])
        states, runs = [], []
        for name, (worker, client, _, task_d) in zip(
                ("ps", "hybrid", "hybrid_prefetch"), arms):
            t1 = time.perf_counter()
            losses = worker.run()
            run = {"arm": name, "steps": len(losses),
                   "finished": task_d.finished(),
                   "losses_finite": bool(np.all(np.isfinite(losses))),
                   "seconds": time.perf_counter() - t1,
                   "rounds": worker.rounds,
                   "dense_tensors_pushed": worker.dense_tensors_pushed}
            if worker._emb_pipeline is not None:
                run["pipeline"] = {
                    "served": worker._emb_pipeline.served,
                    "dropped": worker._emb_pipeline.dropped,
                    "pull_s": worker._emb_pipeline.pull_s}
            runs.append(run)
            states.append(_h_state(worker, client, seen))
        rec["runs"] = runs
        steps = Z_RECORDS // PS_BATCH
        for run in runs:
            if run["steps"] != steps or not run["finished"] or not run[
                    "losses_finite"]:
                problems.append("h0 %s: %s" % (run["arm"], run))
        if runs[1]["dense_tensors_pushed"] or runs[2][
                "dense_tensors_pushed"]:
            problems.append("h0: a hybrid arm pushed dense tensors")
        rel, bitwise = _h_compare(states[1], states[0])
        rec["hybrid_vs_ps"] = {"rel_l2_max": max(rel.values()),
                               "per_tensor": rel, "bitwise": bitwise,
                               "tolerance": FLEET_TOL}
        if max(rel.values()) > FLEET_TOL:
            problems.append("h0 hybrid against ps: %s" % rel)
        pipe = runs[2]["pipeline"]
        want_served = runs[2]["steps"] - runs[2]["rounds"]
        if pipe["served"] != want_served or pipe["dropped"]:
            problems.append("h0 prefetch served %d (want %d), dropped %d"
                            % (pipe["served"], want_served, pipe["dropped"]))
        rec["prefetch_missed_pushes"] = {
            str(k): missed.count(k) for k in sorted(set(missed))}
        if len(missed) != pipe["served"] or max(missed, default=0) > (
                H_MAX_MISSED):
            problems.append("h0 prefetch: %d served steps, missed pushes %s "
                            "(at most %d)" % (len(missed), missed,
                                              H_MAX_MISSED))
        rel, bitwise = _h_compare(states[2], states[1])
        grouped = _z_grouped_rel(states[2], states[1])
        rec["prefetch_vs_inline"] = {
            "grouped": grouped, "rel_l2_max": max(rel.values()),
            "bitwise": bitwise, "tolerance": H_PREFETCH_TOL}
        if max(grouped.values()) > H_PREFETCH_TOL:
            problems.append("h0 prefetch against inline: %s" % grouped)
    finally:
        for client in opened:
            client.close()
        torch.use_deterministic_algorithms(was_deterministic)
        Dataset.shuffle = shuffle
        if seed_env is None:
            os.environ.pop("EDL_TASK_SHUFFLE_SEED", None)
        else:
            os.environ["EDL_TASK_SHUFFLE_SEED"] = seed_env
    rec["seconds"] = time.perf_counter() - t0
    return rec, problems, first_push


def _h_split(events):
    """The fleet split plus the hybrid trainer's phases: the background
    pull (``pull_bg``, on the pipeline's thread) and the local update;
    the pipelined steps' count and the workers' pipeline counters."""
    out = _fleet_split(events)
    splits = [s["split"] for ev in events.values()
              for s in _of(ev, "step")[1:] if s.get("split")]
    for k in ("pull_bg", "local_update"):
        out[k + "_ms"] = _median([s.get(k, 0.0) * 1e3 for s in splits])
    out["pipelined_steps"] = sum(
        1 for ev in events.values() for s in _of(ev, "step")
        if s.get("pipelined"))
    return out


def _h_fleet(torch, tmp, card, name, plane, seen, first_push=None):
    """H1 (``plane`` hybrid) or H2 (ps), the reference bench's two arms
    on F1's fleet and Z's data: async shards, one worker with a push
    window of one. Returns (record, problems)."""
    data = os.path.join(tmp, "z-data")
    params = ["--model_params", _h_params(plane)]
    if plane == "hybrid":
        job = ["--use_async", "true", "--embedding_plane", "hybrid"]
        worker = ["--embedding_plane", "hybrid", "--ps_push_inflight", "1"]
    else:
        job = ["--use_async", "true", "--get_model_steps", "4"]
        worker = ["--get_model_steps", "4", "--ps_push_inflight", "1"]
    fleet = _Fleet(tmp, name, PS_DEEPFM, data, PS_BATCH, job=job + params,
                   ps=["--use_async", "true"] + params,
                   worker=worker + params, deterministic=True)
    tables = {"embedding": seen} if plane == "hybrid" else {
        "embedding": seen, "id_bias": seen}
    raw = fleet.run(inspect=lambda f: _fleet_state(f, tables))
    state = raw["inspect"]
    events = raw["events"]
    ends = _end_events(events)
    steps = Z_RECORDS // PS_BATCH
    problems = []
    if raw["exit_codes"] != {"0": 0} or raw["master_exit_codes"] != [0]:
        problems.append("%s exits %s, master %s" % (
            name, raw["exit_codes"], raw["master_exit_codes"]))
    if raw["journal"]["done"] != steps // 2 or raw["journal"]["pending"]:
        problems.append("%s journal %s" % (name, raw["journal"]))
    if len(_fleet_steps(events)) != steps or len(ends) != 1 or not all(
            e["losses_finite"] for e in ends):
        problems.append("%s steps %d, ends %s" % (
            name, len(_fleet_steps(events)), ends))
    for key, (before, after, mine) in state["placement"].items():
        if not before == after == mine:
            problems.append("%s shard rows %s: %s before, %s after, %d "
                            "with id %% %d" % (name, key, before, after,
                                               mine, FLEET_SHARDS))
    shards = [_shard_record(s) for s in state["statuses"]]
    step_ms = _median([(b["t"] - a["t"]) * 1e3 for a, b in zip(
        _fleet_steps(events), _fleet_steps(events)[1:])])
    rec = {
        "phase": "ps_hybrid", "of": name, "card": card, "plane": plane,
        "model": "deepfm_edl_embedding", "batch": PS_BATCH,
        "records": Z_RECORDS, "shards": FLEET_SHARDS,
        "job_flags": job, "worker_flags": worker, "job_s": raw["job_s"],
        "examples_per_s": _fleet_examples_per_s(events, PS_BATCH),
        # the median step's rate; a one-time stall after the first step
        # would weigh on examples_per_s alone (the worker warms its
        # optimizer before the first task, so step_ms_max shows none)
        "examples_per_s_median_step": (
            PS_BATCH * 1e3 / step_ms if step_ms else None),
        "step_split": _h_split(events),
        "step_ms_median": step_ms,
        "step_ms_max": max([(b["t"] - a["t"]) * 1e3 for a, b in zip(
            _fleet_steps(events), _fleet_steps(events)[1:])], default=None),
        # every step: the ms since the one before and its split's ms
        "steps": [
            dict({k + "_ms": round(v * 1e3, 3) for k, v in s["split"].items()
                  if k not in ("t", "compute_device_ms")},
                 since_ms=round((s["t"] - p["t"]) * 1e3, 3) if p else None,
                 pipelined=s.get("pipelined"))
            for p, s in zip([None] + _fleet_steps(events),
                            _fleet_steps(events))],
        "shards_state": shards,
        "shard_tables": [sorted(s["tables"]) for s in state["statuses"]],
        "worker_peak_mib": [e.get("peak_mib") for e in ends],
        "journal": raw["journal"], "ps_exit_codes": raw["ps_exit_codes"],
        "losses_first_last": [e.get("losses_first_last") for e in ends],
        "pipeline": [e.get("pipeline") for e in ends],
        "rounds": [e.get("rounds") for e in ends],
        "dense_tensors_pushed": [e.get("dense_tensors_pushed")
                                 for e in ends],
    }
    if plane == "hybrid" and ends:
        end = ends[0]
        pipe = end.get("pipeline") or {}
        # every step but each round's first is served from the pipeline
        floor = steps - end["rounds"]
        if pipe.get("served", -1) < floor or pipe.get("dropped"):
            problems.append("%s pipeline %s over %d rounds" % (
                name, pipe, end["rounds"]))
        if end["dense_tensors_pushed"]:
            problems.append("%s pushed %d dense tensors" % (
                name, end["dense_tensors_pushed"]))
        if any(s["dense_apply_ms_median"] is not None for s in shards):
            problems.append("%s: a shard applied a dense gradient: %s" % (
                name, shards))
        if any("id_bias" in t for t in rec["shard_tables"]):
            problems.append("%s: a shard holds id_bias: %s" % (
                name, rec["shard_tables"]))
        if first_push is not None:
            import numpy as np

            differ = sorted(
                k for k in set(state["dense"]) | set(first_push)
                if k not in state["dense"] or k not in first_push
                or not np.array_equal(state["dense"][k], first_push[k]))
            rec["shards_dense_is_first_push"] = not differ
            if differ:
                problems.append("%s: the shards' dense model is not the "
                                "worker's first push: %s" % (name, differ))
    rec["worker_flash_launches"] = _worker_launches(events, problems)
    if any(rec["worker_flash_launches"].values()):
        problems.append("%s launched flash kernels: %s" % (
            name, rec["worker_flash_launches"]))
    return rec, problems


def phase_ps_hybrid(torch, tmp, card):
    """The hybrid trainer on Z's zipf data at zoo width: H0 in this
    process (PS against hybrid on one batch and over 16 steps, then the
    hybrid arm's prefetch), H1 the hybrid arm of the reference's bench on
    F1's fleet, H2 its PS-everything arm on the same fleet and data.
    Returns the flash kernels' launches over the phase (none)."""
    import numpy as np

    t0 = time.perf_counter()
    if not os.path.isdir(os.path.join(tmp, "z-data")):
        _write_z_data(tmp)
    ids, labels = _zipf_ids(Z_RECORDS, SEED + 50)
    seen = np.unique(ids)
    problems = []
    worker_launches = {k: 0 for k in KERNELS}
    _reset_counters()
    rec, bad, first_push = _h0(torch, tmp, card, ids, labels, seen)
    emit(rec)
    problems += bad
    torch.cuda.empty_cache()
    rates, steady, slowest = {}, {}, {}
    for name, plane in (("h1", "hybrid"), ("h2", "ps")):
        rec, bad = _h_fleet(torch, tmp, card, name, plane, seen,
                            first_push if plane == "hybrid" else None)
        rates[name] = rec["examples_per_s"]
        steady[name] = rec["examples_per_s_median_step"]
        slowest[name] = rec["step_ms_max"]
        emit(rec)
        problems += bad
        for k, n in rec["worker_flash_launches"].items():
            worker_launches[k] += n
        torch.cuda.empty_cache()
    counts = {k: (n + worker_launches[k], shapes)
              for k, (n, shapes) in _counts().items()}
    emit({"phase": "ps_hybrid", "of": "summary", "card": card,
          "examples_per_s": rates,
          "h1_over_h2": (rates["h1"] / rates["h2"]
                         if rates["h1"] and rates["h2"] else None),
          "examples_per_s_median_step": steady,
          "h1_over_h2_median_step": (steady["h1"] / steady["h2"]
                                     if steady["h1"] and steady["h2"]
                                     else None),
          # the slowest step after the first in each window: a stall in
          # one arm alone would make the first ratio unlike the second
          "step_ms_max": slowest,
          "seconds": time.perf_counter() - t0,
          "flash_launches": {k: n for k, (n, _) in counts.items()}})
    if problems:
        raise PhaseError("ps_hybrid: " + "; ".join(problems))
    return counts


def _ps_hybrid_only(torch):
    try:
        card = phase_device(torch)
        with tempfile.TemporaryDirectory() as tmp:
            counts = phase_ps_hybrid(torch, tmp, card)
        _check_counts(counts, {k: 0 for k in KERNELS}, "the ps_hybrid phase")
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


# ---------------------------------------------------------------------------
# ps_serve: serving's PS plane, scoring zipf DeepFM while the fleet trains
# ---------------------------------------------------------------------------

S_REQUEST_ROWS = 32  # the reference bench's request: 32 rows of 10 ids
S_DRIVE_S = 20.0  # the closed-loop drive
S_KILL_AT = 0.4  # shard 0 is SIGKILLed at this share of the drive
S_WINDOW = 4  # --serving_staleness_versions
S_SYNC_INTERVAL_S = 0.25
S_SNAPSHOT_VERSIONS = 8
S_EXPORT = (8, 4)  # --export_every_versions, --export_keep
S_GET_MODEL_STEPS = 4
S_OUTAGE = (1.0, 5.0)  # failures issued in [kill - 1 s, serving + 5 s] pass
S_SAMPLE_S = 0.5  # the staleness samples' cadence
S_TOL = 1e-6  # the drained scorer against the direct forward, relative L2
S_LIMIT_S = 240  # a boot, a first export or a drain that hangs fails


def _s_scorer_flags(export_root, addrs):
    return ["--export_dir", export_root, "--ps_addrs", addrs,
            "--device", DEVICE, "--scorer_transport", "socket",
            "--serving_staleness_versions", str(S_WINDOW),
            "--serving_sync_interval_s", str(S_SYNC_INTERVAL_S),
            "--watch_interval_s", "0.5", "--serve_max_batch", "64",
            "--serve_batch_timeout_ms", "2", "--serve_p99_slo_ms", "2000",
            "--log_level", "WARNING"]


def _s_sampler(seed):
    """Draws of ``S_REQUEST_ROWS`` x 10 ids from the trainer's zipf
    distribution (``_zipf_ids``'s pool and weights)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 50)
    pool = rng.permutation(ZOO_VOCAB)[:Z_POOL]
    cdf = np.cumsum(1.0 / np.arange(1, Z_POOL + 1) ** Z_ZIPF)
    cdf /= cdf[-1]
    draws = np.random.default_rng(seed)

    def sample(rows=S_REQUEST_ROWS):
        at = np.minimum(np.searchsorted(cdf, draws.random((rows, 10))),
                        Z_POOL - 1)
        return {"feature": pool[at].astype(np.int64)}

    return sample


class _STimer:
    """Times the in-process scorer's requests from outside the package:
    ``Scorer.score`` and its plane's ``pull`` (instance attributes
    wrapped), the sync's rounds, the cache's ``refresh_table`` walk and
    the request path's ``get_rows`` probe (both under the cache's
    lock)."""

    def __init__(self, scorer, sync, cache):
        self.requests = []  # (capture + plan, pull, forward with sync) s
        self.rounds = []  # seconds of each sync round
        self.walks = []  # (seconds, entries) of each refresh_table
        self.probes = []  # seconds of each get_rows
        self._tl = threading.local()
        self._mu = threading.Lock()
        score, pull = scorer.score, scorer._plane.pull
        sync_once, refresh = sync.sync_once, cache.refresh_table
        get_rows = cache.get_rows

        def timed_pull(*a, **k):
            t0 = time.perf_counter()
            try:
                return pull(*a, **k)
            finally:
                self._tl.pull = (t0, time.perf_counter())

        def timed_score(features):
            self._tl.pull = None
            t0 = time.perf_counter()
            out = score(features)
            t1 = time.perf_counter()
            if self._tl.pull is not None:
                p0, p1 = self._tl.pull
                with self._mu:
                    self.requests.append((p0 - t0, p1 - p0, t1 - p1))
            return out

        def timed_round():
            t0 = time.perf_counter()
            try:
                return sync_once()
            finally:
                with self._mu:
                    self.rounds.append(time.perf_counter() - t0)

        def timed_refresh(*a, **k):
            t0 = time.perf_counter()
            out = refresh(*a, **k)
            with self._mu:
                self.walks.append((time.perf_counter() - t0, len(cache)))
            return out

        def timed_probe(*a, **k):
            t0 = time.perf_counter()
            out = get_rows(*a, **k)
            with self._mu:
                self.probes.append(time.perf_counter() - t0)
            return out

        scorer.score, scorer._plane.pull = timed_score, timed_pull
        sync.sync_once, cache.refresh_table = timed_round, timed_refresh
        cache.get_rows = timed_probe

    def summary(self):
        def ms(values):
            values = sorted(values)
            if not values:
                return None
            return {"p50": values[len(values) // 2] * 1e3,
                    "p99": values[min(len(values) - 1,
                                      int(0.99 * len(values)))] * 1e3,
                    "max": values[-1] * 1e3, "n": len(values)}

        with self._mu:
            reqs, rounds = list(self.requests), list(self.rounds)
            walks, probes = list(self.walks), list(self.probes)
        return {
            "capture_and_plan_ms": ms([r[0] for r in reqs]),
            "pull_ms": ms([r[1] for r in reqs]),
            "forward_with_sync_ms": ms([r[2] for r in reqs]),
            "sync_round_ms": ms(rounds),
            "refresh_walk_ms": ms([w[0] for w in walks]),
            "refresh_walk_entries_max": max((w[1] for w in walks),
                                            default=None),
            "get_rows_ms": ms(probes),
        }


# the scorer process: serving.main as ``python -m`` runs it, writing its
# peaks to a file at exit: its resident set's largest reading (sampled
# every 0.1 s from /proc/self/statm; on the card's machine VmHWM is not in
# /proc/self/status, and getrusage's ru_maxrss after fork and exec counts
# the parent's pages) and the card allocator's (the CUDA context is not
# in it)
_S_SCORER_PROCESS = (
    "import atexit, json, os, runpy, sys, threading, time\n"
    "peak = [None]\n"
    "def _sample():\n"
    "    page = os.sysconf('SC_PAGE_SIZE')\n"
    "    while True:\n"
    "        with open('/proc/self/statm') as f:\n"
    "            rss = int(f.read().split()[1]) * page / 2**20\n"
    "        peak[0] = max(peak[0] or 0.0, rss)\n"
    "        time.sleep(0.1)\n"
    "threading.Thread(target=_sample, daemon=True).start()\n"
    "def _peaks():\n"
    "    import torch\n"
    "    card = torch.cuda.is_available() and torch.cuda.is_initialized()\n"
    "    with open(%r, 'w') as f:\n"
    "        json.dump({'host_rss_peak_mib': peak[0],\n"
    "            'card_allocated_peak_mib': torch.cuda.max_memory_allocated()"
    " / 2**20 if card else None,\n"
    "            'card_reserved_peak_mib': torch.cuda.max_memory_reserved()"
    " / 2**20 if card else None}, f)\n"
    "atexit.register(_peaks)\n"
    "sys.argv = ['scorer'] + %r\n"
    "runpy.run_module('elasticdl_tpu_torch.serving.main', "
    "run_name='__main__')\n"
)


def _s_direct(torch, export_dir, addrs, features):
    """The newest export's Dense layers on the card, bound to rows read
    straight from the shards (a client with no cache): the logits."""
    import numpy as np

    from elasticdl_tpu_torch.common.convert import to_state_dict
    from elasticdl_tpu_torch.common.export import load_export
    from elasticdl_tpu_torch.common.model_utils import build_model
    from elasticdl_tpu_torch.nn.comm_plane import plan_lookup_multi
    from elasticdl_tpu_torch.nn.embedding import (
        bind_rows,
        capture_embedding_ids,
    )
    from elasticdl_tpu_torch.worker.ps_client import BoundPS, PSClient

    exported = load_export(export_dir)
    model = build_model(PS_DEEPFM, exported.metadata.get("model_params")
                        or None, "")
    model.load_state_dict(to_state_dict(exported.named))
    model = model.to(DEVICE).eval()
    captured = capture_embedding_ids(model, {}, {}, features)
    lookups = {p: plan_lookup_multi(ids) for p, ids in captured.items()}
    client = PSClient([BoundPS(a, deadline_s=30) for a in addrs.split(",")])
    try:
        pulled = client.pull_embedding_vectors_multi(
            {p: unique for p, (unique, _) in lookups.items()})
    finally:
        client.close()
    rows = {p: torch.from_numpy(np.ascontiguousarray(pulled[p])).to(DEVICE)
            for p in lookups}
    idx = {p: [torch.from_numpy(i.astype(np.int64)).to(DEVICE)
               for i in lookups[p][1]] for p in lookups}
    with torch.inference_mode(), bind_rows(model, rows, idx):
        out = model(features)
    return out["logits"].float().cpu().numpy()


def _s_note_cost(torch, reps=200):
    """Microseconds of one ``DeltaLog.note`` of a b1024 batch's 10,240
    ids: from the numpy array a shard's apply hands it, and from a tensor
    on the card (one copy to the host)."""
    import numpy as np

    from elasticdl_tpu_torch.ps.delta_log import DeltaLog

    ids = np.random.default_rng(SEED).integers(0, ZOO_VOCAB, PS_BATCH * 10)
    out = {}
    for name, arg in (("numpy", ids),
                      ("card_tensor", torch.from_numpy(ids).to(DEVICE))):
        log = DeltaLog(keep_versions=reps + 1, max_rows=1 << 30)
        log.note("t", arg, 0)
        t0 = time.perf_counter()
        for v in range(1, reps + 1):
            log.note("t", arg, v)
        out[name + "_us"] = (time.perf_counter() - t0) / reps * 1e6
    return out


S_SHM_REQUESTS = 16  # the scorer process's ring against its socket


def _s_shm_arm(plain, port, version, problems):
    """The scorer process over a shared-memory ring: once it serves the
    newest export, ``S_SHM_REQUESTS`` requests each sent on its socket and
    through a ``ShmChannel``, the path that goes first alternating
    request by request (the second finds the request's rows cached); the
    replies must be bitwise equal, every one through the ring."""
    import numpy as np

    from elasticdl_tpu_torch.common.tensor import release_message
    from elasticdl_tpu_torch.rpc.shm_transport import ShmChannel
    from elasticdl_tpu_torch.rpc.socket_transport import Client

    def newest():
        got = plain.call("scorer_status")["model_version"]
        if got != version:
            raise RuntimeError("at v%s, not v%s" % (got, version))

    _until(newest, "the scorer process's newest export", S_LIMIT_S)
    ring_client = Client("localhost:%d" % port, deadline_s=60.0)
    chan = ShmChannel(ring_client, n_slots=SHM_SLOTS, slot_mb=SHM_SLOT_MB)
    sample = _s_sampler(SEED + 80)
    equal, ms = 0, {"socket": [], "shm": []}
    try:
        for i in range(S_SHM_REQUESTS):
            feats = sample()
            got = {}
            for path in (("socket", "shm") if i % 2 == 0
                         else ("shm", "socket")):
                t0 = time.perf_counter()
                got[path] = (plain if path == "socket" else chan).call(
                    "score", **feats)
                ms[path].append((time.perf_counter() - t0) * 1e3)
            a, b = got["socket"], got.pop("shm")
            equal += int(
                "error" not in a and "error" not in b
                and a["model_version"] == b["model_version"]
                and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                        for k in ("out:logits", "out:probs")))
            release_message(b)
            del b
        rec = {"requests": S_SHM_REQUESTS, "bitwise_equal": equal,
               "state": chan.state, "stats": dict(chan.stats),
               "socket_ms_median": _median(ms["socket"]),
               "shm_ms_median": _median(ms["shm"])}
    finally:
        chan.close()
        ring_client.close()
    if equal != S_SHM_REQUESTS or rec["state"] != "on" or (
            rec["stats"]["shm"] != S_SHM_REQUESTS):
        problems.append("the scorer's ring against its socket: %s" % rec)
    return rec


def phase_ps_serve(torch, tmp, card):
    """Serving's PS plane: two ``ps.main`` shards (async, snapshots every
    8 versions) train zipf DeepFM at zoo width under an in-process
    PS-everything worker on a streaming dispatcher that exports every 8
    versions; a ``serving.main --ps_addrs`` process and a
    ``build_scorer`` stack in this process score 32-row requests from
    the live fleet through their hot-row caches and delta syncs while
    shard 0 is SIGKILLed and relaunched. Returns the flash kernels'
    launches in this process (none)."""
    import numpy as np

    from elasticdl_tpu_torch.common.args import parse_scorer_args
    from elasticdl_tpu_torch.common.constants import JobType
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.rpc.socket_transport import Client
    from elasticdl_tpu_torch.serving.main import build_scorer
    from elasticdl_tpu_torch.serving.server import ScorerServer
    from elasticdl_tpu_torch.worker.ps_client import BoundPS, PSClient
    from elasticdl_tpu_torch.worker.worker import Worker

    t_phase = time.perf_counter()
    if not os.path.isdir(os.path.join(tmp, "z-data")):
        _write_z_data(tmp)
    root = os.path.join(tmp, "ps-serve")
    export_root = os.path.join(root, "exports")
    snap = os.path.join(root, "snap")
    os.makedirs(export_root, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    ps_ports = [_free_port() for _ in range(FLEET_SHARDS)]
    addrs = ",".join("localhost:%d" % p for p in ps_ports)
    ps_argv = [[
        sys.executable, "-m", "elasticdl_tpu_torch.ps.main", "--ps_id",
        str(i), "--port", str(ps_ports[i]), "--model_zoo", "",
        "--model_def", PS_DEEPFM, "--device", DEVICE, "--use_async", "true",
        "--ps_snapshot_versions", str(S_SNAPSHOT_VERSIONS),
        "--ps_snapshot_dir", snap, "--log_level", "WARNING",
    ] for i in range(FLEET_SHARDS)]
    logs = []

    def spawn(argv, name):
        log = open(os.path.join(root, name + ".log"), "ab")
        logs.append(log)
        return subprocess.Popen(argv, env=env, cwd=REPO,
                                stdout=subprocess.DEVNULL, stderr=log)

    def status(i, deadline_s=2.0):
        stub = _ps_stub(ps_ports[i], deadline_s)
        try:
            return stub.ps_status({})
        finally:
            stub.close()

    _reset_counters()
    problems = []
    rec = {"phase": "ps_serve", "card": card, "model": "deepfm_edl_embedding",
           "vocab": ZOO_VOCAB, "embedding_dim": 64, "train_batch": PS_BATCH,
           "request_rows": S_REQUEST_ROWS, "shards": FLEET_SHARDS,
           "staleness_window": S_WINDOW, "drive_s": S_DRIVE_S,
           "sync_interval_s": S_SYNC_INTERVAL_S}
    procs = {"ps0": spawn(ps_argv[0], "ps-0"), "ps1": spawn(ps_argv[1],
                                                            "ps-1")}
    task_d = trainer = None
    trainer_err, trainer_done = [], threading.Event()
    local = local_server = None
    clients = []
    try:
        for i in range(FLEET_SHARDS):
            _until(lambda i=i: status(i), "shard %d" % i)
        rec["fleet_boot_s"] = time.perf_counter() - t_phase

        # the streaming trainer, in this process, as the reference's bench
        task_d = TaskDispatcher(
            {os.path.join(tmp, "z-data", "records-0"): (0, Z_RECORDS)}, {},
            {}, 2 * PS_BATCH, 1, streaming=True)
        master = MasterServicer(1, PS_BATCH, None, task_d, use_async=True,
                                device=DEVICE)
        trainer_client = PSClient([BoundPS(a, deadline_s=20.0, retries=3)
                                   for a in addrs.split(",")])
        worker = Worker(
            worker_id=0, job_type=JobType.TRAINING_ONLY,
            minibatch_size=PS_BATCH, model_zoo="", model_def=PS_DEEPFM,
            stub=master, device=DEVICE, ps_client=trainer_client,
            get_model_steps=S_GET_MODEL_STEPS, export_dir=export_root,
            export_every_versions=S_EXPORT[0], export_keep=S_EXPORT[1])

        def train():
            try:
                worker.run()
            except Exception as err:  # noqa: BLE001 - reported below
                trainer_err.append(err)
            finally:
                trainer_done.set()

        trainer = threading.Thread(target=train, daemon=True,
                                   name="ps-serve-trainer")
        trainer.start()
        t_trainer = time.monotonic()

        # the scorer process and the stack in this process
        port = _free_port()
        peaks = os.path.join(root, "scorer-peaks.json")
        procs["scorer"] = spawn(
            [sys.executable, "-c", _S_SCORER_PROCESS % (
                peaks, ["--port", str(port)]
                + _s_scorer_flags(export_root, addrs))], "scorer")
        local = build_scorer(parse_scorer_args(
            _s_scorer_flags(export_root, addrs)))
        scorer, watcher, sync, bound, batcher = local
        cache = scorer._client.hot_row_cache
        timer = _STimer(scorer, sync, cache)
        local_server = ScorerServer(scorer, port=0, batcher=batcher,
                                    transport="socket")
        watcher.start()
        sync.start()
        clients = [Client("localhost:%d" % port, deadline_s=60.0),
                   Client("localhost:%d" % local_server.port,
                          deadline_s=60.0)]
        names = ("process", "in_process")

        def scorer_status(i):
            if procs["scorer"].poll() is not None:
                raise PhaseError("the scorer process exited %d" %
                                 procs["scorer"].returncode)
            if trainer_err:
                raise PhaseError("the trainer failed: %s" % trainer_err[0])
            return clients[i].call("scorer_status")

        def first_model(i):
            st = scorer_status(i)
            if st["model_version"] < 0:
                raise RuntimeError("no model yet")
            return st["model_version"]

        first_versions = [
            _until(lambda i=i: first_model(i),
                   "the %s scorer's first model" % names[i], S_LIMIT_S)
            for i in range(2)]
        rec["first_model_versions"] = first_versions
        rec["scorers_ready_s"] = time.perf_counter() - t_phase
        warm = _s_sampler(SEED + 60)
        for client in clients:
            for _ in range(3):
                reply = client.call("score", **warm())
                if "error" in reply:
                    raise PhaseError("warm score: %s" % reply["error"])

        # the drive, the samples and the kill
        records, records_mu = [], threading.Lock()  # (scorer, t, ok, s, v)
        samples = []  # (t, scorer, staleness, model version)
        stop = threading.Event()

        def drive(i):
            sample = _s_sampler(SEED + 70 + i)
            while not stop.is_set():
                feats = sample()
                t_issued = time.monotonic()
                t0 = time.perf_counter()
                version = None
                try:
                    reply = clients[i].call("score", **feats)
                    ok = "error" not in reply and bool(np.all(np.isfinite(
                        np.asarray(reply["out:logits"]))))
                    version = reply.get("model_version")
                except Exception:  # noqa: BLE001 - counted: the outage
                    ok = False
                with records_mu:
                    records.append((i, t_issued, ok,
                                    time.perf_counter() - t0, version))

        def sampler():
            while not stop.wait(S_SAMPLE_S):
                for i in range(2):
                    try:
                        st = (scorer.status() if i == 1
                              else clients[0].call("scorer_status"))
                        samples.append((time.monotonic(), i,
                                        st.get("staleness_versions"),
                                        st.get("model_version")))
                    except Exception as err:  # noqa: BLE001 - recorded
                        samples.append((time.monotonic(), i, None, str(err)))

        threads = [threading.Thread(target=drive, args=(i,), daemon=True)
                   for i in range(2)]
        threads.append(threading.Thread(target=sampler, daemon=True))
        timed_before = len(timer.requests)
        t_start = time.monotonic()
        for t in threads:
            t.start()
        time.sleep(S_DRIVE_S * S_KILL_AT)
        before = [status(i, 10.0) for i in range(FLEET_SHARDS)]
        kill_t = time.monotonic()
        procs["ps0"].kill()
        procs["ps0"].wait(timeout=30)
        procs["ps0"] = spawn(ps_argv[0], "ps-0")
        relaunched = _until(lambda: status(0), "the relaunched shard 0")
        serving_t = time.monotonic()
        time.sleep(max(0.0, S_DRIVE_S - (time.monotonic() - t_start)))
        stop.set()
        for t in threads:
            t.join(timeout=90)
        drive_s = time.monotonic() - t_start
        rec["drive_requests_timed"] = len(timer.requests) - timed_before

        # after the drive: both scorers serve, the trainer drains
        post = {}
        for i in range(2):
            reply = clients[i].call("score", **warm())
            post[names[i]] = "error" not in reply
            if "error" in reply:
                problems.append("%s scorer after recovery: %s" % (
                    names[i], reply["error"]))
        final_versions = [clients[0].call("scorer_status")["model_version"],
                          scorer.model_version]
        task_d.set_streaming(False)
        if not trainer_done.wait(S_LIMIT_S):
            raise PhaseError("the streaming trainer did not drain")
        if trainer_err:
            raise PhaseError("the trainer failed: %s" % trainer_err[0])
        trainer_client.close()

        # the drained scorer against the direct forward, then batched
        rounds = sync.sync_once()
        watcher.poll_once()
        newest, newest_version = watcher.newest_manifest()
        fixed = _s_sampler(SEED + 77)()
        out, version = scorer.score(fixed)
        got = out["logits"].float().cpu().numpy()
        want = _s_direct(torch, newest, addrs, fixed)
        rel = _np_rel(got, want)
        batched, _ = batcher.submit(fixed)
        batched_bitwise = all(torch.equal(out[k], batched[k]) for k in out)
        rec["shm_scorer"] = _s_shm_arm(clients[0], port, newest_version,
                                       problems)
        # the in-process scorer's channel to each shard, after shard 0's
        # relaunch
        rec["wire"] = {
            "ps%d" % i: dict(b.shm_channel.stats, state=b.shm_channel.state)
            for i, b in enumerate(bound) if b.shm_channel is not None}

        # classify by issue time, as the reference's bench
        lo, hi = kill_t - S_OUTAGE[0], serving_t + S_OUTAGE[1]
        per = {}
        for i, name in enumerate(names):
            mine = [r for r in records if r[0] == i]
            oks = sorted(r[3] for r in mine if r[2])
            bad = [r for r in mine if not r[2] and not lo <= r[1] <= hi]
            after = [r[1] for r in mine if r[2] and r[1] >= serving_t]
            failed_in = [r[1] for r in mine if not r[2]]
            per[name] = {
                "requests": len(mine), "ok": len(oks),
                "failed": len(mine) - len(oks),
                "failed_outside_outage": len(bad),
                "requests_per_s": len(oks) / drive_s,
                "p50_ms": oks[len(oks) // 2] * 1e3 if oks else None,
                "p99_ms": (oks[min(len(oks) - 1, int(0.99 * len(oks)))]
                           * 1e3 if oks else None),
                "first_ok_after_serving_s": (min(after) - kill_t
                                             if after else None),
                "last_failure_after_kill_s": (max(failed_in) - kill_t
                                              if failed_in else None),
                "model_versions_seen": sorted({r[4] for r in mine
                                               if r[4] is not None}),
            }
            if bad:
                problems.append("%s scorer: %d replies failed outside the "
                                "outage" % (name, len(bad)))
            if not oks:
                problems.append("%s scorer: no reply succeeded" % name)
        stale = [s for s in samples if s[2] is not None]
        missing = [s for s in samples if s[2] is None]
        over = [s for s in stale if s[2] > S_WINDOW]
        if over or not stale:
            problems.append("staleness over %d (or no sample): %s" % (
                S_WINDOW, over[:5]))
        if missing:
            problems.append("scorer_status failed in %d samples: %s" % (
                len(missing), missing[:3]))
        for i, name in enumerate(names):
            if not final_versions[i] > first_versions[i]:
                problems.append("%s scorer: no hot swap (%d -> %d)" % (
                    name, first_versions[i], final_versions[i]))
        client = scorer._client
        relaunches = [r[:4] for r in client.relaunches]
        if not any(r[0] == 0 for r in relaunches):
            problems.append("the in-process client saw no relaunch of "
                            "shard 0: %s" % relaunches)
        counters = {k: getattr(sync, k) for k in (
            "rounds", "rows_dropped", "rows_retagged", "rows_refreshed",
            "tables_invalidated")}
        if not (counters["rows_retagged"] > 0 and counters["rows_dropped"]
                > 0 and counters["tables_invalidated"] == 0):
            problems.append("delta sync counters %s" % counters)
        if version != newest_version or rel > S_TOL:
            problems.append("drained scorer v%d (newest export v%d) %.3g "
                            "from the direct forward" % (
                                version, newest_version, rel))
        if not batched_bitwise:
            problems.append("the micro-batcher's reply is not bitwise the "
                            "solo score's")
        probes = cache.hits + cache.misses
        rec.update({
            "kill_to_serving_s": serving_t - kill_t,
            "restored_version": relaunched.get("restored_version"),
            "shard_versions_at_kill": [s["version"] for s in before],
            "trainer_versions_per_s_to_kill": max(
                s["version"] for s in before) / (kill_t - t_trainer),
            "scorers": per,
            "first_model_versions": first_versions,
            "final_model_versions": final_versions,
            "hot_swaps_in_process": scorer.status()["swaps"],
            "staleness_max": max((s[2] for s in stale), default=None),
            "staleness_samples": len(stale),
            "post_recovery_ok": post,
            "sync": dict(counters, last_error=sync.last_error,
                         final_round=rounds),
            "relaunches": relaunches,
            "shard_epochs": client.shard_epochs,
            "cache": {"hits": cache.hits, "misses": cache.misses,
                      "hit_rate": cache.hits / probes if probes else None,
                      "rows": len(cache), "tables": cache.table_stats()},
            "in_process_split": timer.summary(),
            "drained": {"model_version": version,
                        "newest_export": newest_version,
                        "rel_l2": rel, "tolerance": S_TOL,
                        "bitwise": bool(np.array_equal(got, want)),
                        "batched_bitwise": batched_bitwise,
                        "sync_round": rounds},
            "trainer": {"steps": len(worker.losses),
                        "exports": len(worker.exports),
                "shard_versions_end": [status(i, 10.0)["version"]
                                       for i in range(FLEET_SHARDS)]},
            "delta_log_note": _s_note_cost(torch),
        })
    finally:
        if task_d is not None:
            task_d.set_streaming(False)
        for client in clients:
            client.close()
        if local_server is not None:
            local_server.stop()
        if local is not None:
            local[1].stop()
            local[2].stop()
            local[0].close()
            for channel in local[3]:
                channel.close()
        if trainer is not None:
            trainer_done.wait(60)
        for name in ("scorer", "ps0", "ps1"):
            proc = procs.get(name)
            if proc is not None and proc.poll() is None:
                proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        for log in logs:
            log.close()
    try:
        with open(os.path.join(root, "scorer-peaks.json")) as f:
            rec["scorer_process_peaks"] = json.load(f)
    except (OSError, ValueError):
        problems.append("the scorer process wrote no peaks at its exit")
    counts = _counts()
    rec["flash_launches"] = {k: n for k, (n, _) in counts.items()}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    if problems:
        for name in ("scorer", "ps-0", "ps-1"):
            path = os.path.join(root, name + ".log")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    tail = f.read()[-1500:].decode("utf-8", "replace")
                print("%s log tail:\n%s" % (name, tail), file=sys.stderr)
        raise PhaseError("ps_serve: " + "; ".join(problems))
    return counts


def _ps_serve_only(torch):
    try:
        card = phase_device(torch)
        with tempfile.TemporaryDirectory() as tmp:
            counts = phase_ps_serve(torch, tmp, card)
        _check_counts(counts, {k: 0 for k in KERNELS}, "the ps_serve phase")
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


# ---------------------------------------------------------------------------
# wire: the shared-memory wire under the fleet, against the socket path
# ---------------------------------------------------------------------------

W_STEPS = PS_RECORDS // PS_BATCH  # one epoch of F1's data
W2_CALLS = 200  # each of the wire-alone loops, on each path
W2_WARM = 20  # untimed calls of each kind on each path before them
W2_IDS = 2048  # ~0.5 MiB of 64-wide f32 rows: a shard's share of F1's pull
W_DIM = 64  # DeepFM's embedding width at the zoo's
SHM_SLOTS, SHM_SLOT_MB = 4, 8  # the ring every worker and scorer asks for
# the most rings each phase negotiates at once: (worker processes, shards,
# a master channel each, the scorers' rings)
SHM_RING_SETS = {
    "ps P2": (2, 0, 1, 0),
    "ps_fleet F2/F3": (2, 2, 1, 0),
    "ps_tiers / ps_hybrid": (1, 2, 1, 0),
    # the scorer process's and the in-process stack's channel to each
    # shard, and the wire arm's client of the process scorer
    "ps_serve": (0, 2, 0, 2 * 2 + 1),
    # W1's worker and W2's stub to shard 0
    "wire": (1, 2, 1, 1),
}


def _shm_ring_bytes():
    """One ring's size in ``/dev/shm``, as ``ShmChannel`` lays it out."""
    from elasticdl_tpu_torch.rpc.shm_transport import ShmChannel

    return ShmChannel(None, SHM_SLOTS, SHM_SLOT_MB).ring_bytes


def phase_shm_room():
    """``/dev/shm``'s size and free room, held against the largest ring
    set any phase negotiates: tmpfs allocates lazily, so a ring past its
    room is made without error and SIGBUSes the first process that
    writes past it. Returns the record."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError as err:
        raise PhaseError("/dev/shm is not there: %s" % err)
    ring = _shm_ring_bytes()
    need = {name: (w * (s + m) + sc) * ring
            for name, (w, s, m, sc) in SHM_RING_SETS.items()}
    worst = max(need, key=need.get)
    rec = {"phase": "device", "of": "dev_shm",
           "size_mib": st.f_blocks * st.f_frsize / 2**20,
           "free_mib": st.f_bavail * st.f_frsize / 2**20,
           "ring_mib": ring / 2**20,
           "need_mib": {k: v / 2**20 for k, v in need.items()},
           "largest": worst}
    emit(rec)
    if need[worst] > st.f_bavail * st.f_frsize:
        raise PhaseError(
            "/dev/shm has %.1f MiB free, but %s negotiates %.1f MiB of rings "
            "(%d slots of %d MiB each): give the machine a larger /dev/shm "
            "(docker run --shm-size)" % (
                rec["free_mib"], worst, need[worst] / 2**20, SHM_SLOTS,
                SHM_SLOT_MB))
    return rec


def shm_segments():
    """The wire's segment names in ``/dev/shm`` now."""
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith("edlw-")}
    except OSError:
        return set()


def _w_inline(torch, shm):
    """The inline worker of a W arm: ``worker.main``'s PS worker built in
    this process over ``--ps_shm``/``--master_shm`` ``shm``, with no
    dataset shuffle and torch's deterministic algorithms (the Z phases'
    worker); its channels are read before they close."""
    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.data.dataset import Dataset
    from elasticdl_tpu_torch.worker.main import (
        close_clients,
        make_ps_client,
        master_client,
        ps_worker,
    )

    def run(fleet):
        args = parse_worker_args(
            ["--worker_id", "0"] + fleet.worker_flags
            + ["--ps_shm", shm, "--master_shm", shm])
        saved = (Dataset.shuffle, torch.are_deterministic_algorithms_enabled(),
                 torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        Dataset.shuffle = lambda self, *a, **k: self
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        ps_client = make_ps_client(args)
        stub = master_client(args)
        try:
            worker = ps_worker(args, stub, ps_client)
            losses = worker.run()
            return {"losses": losses, "splits": list(worker.step_splits),
                    "wire": worker.wire_stats()}
        finally:
            close_clients(stub, ps_client)
            Dataset.shuffle = saved[0]
            torch.use_deterministic_algorithms(saved[1])
            torch.backends.cudnn.deterministic = saved[2]
            torch.backends.cudnn.benchmark = saved[3]

    return run


def _w2(fleet, seen):
    """W2, the wire alone, on shard 0 of a ring arm's fleet: a socket stub
    and a ring stub, each warmed with ``W2_WARM`` calls of each kind,
    then ``W2_CALLS`` pulls of ``W2_IDS`` rows and as many pushes of as
    many rows below the shard's version (answered after their decode,
    before any apply), the two stubs' calls interleaved and the one that
    goes first alternating call by call. p50/p99 in ms."""
    import numpy as np

    from elasticdl_tpu_torch.common.tensor import Tensor, release_message
    from elasticdl_tpu_torch.worker.ps_client import BoundPS

    ids = seen[seen % FLEET_SHARDS == 0][:W2_IDS]
    rows = np.random.default_rng(SEED + 90).standard_normal(
        (len(ids), W_DIM)).astype(np.float32)
    grad = [Tensor("embedding", rows, ids)]
    problems = []

    def pct(values, q):
        values = sorted(values)
        return values[min(len(values) - 1, int(q * len(values)))]

    def pull(stub):
        resp = stub.pull_embedding_vector({"name": "embedding", "ids": ids})
        shape = tuple(resp["rows"].shape)
        release_message(resp)
        return None if shape == (len(ids), W_DIM) else "pull shape %s" % (
            shape,)

    def push(stub):
        resp = stub.push_gradient({"model_version": 0, "gradients": grad})
        accepted = resp["accepted"]
        release_message(resp)
        return "a stale push was applied" if accepted else None

    stubs = {path: BoundPS("localhost:%d" % fleet.ps_ports[0], deadline_s=30,
                           shm=shm, shm_slots=SHM_SLOTS,
                           shm_slot_mb=SHM_SLOT_MB)
             for path, shm in (("socket", "off"), ("shm", "auto"))}
    ms = {(path, kind): [] for path in stubs for kind in ("pull", "push")}
    try:
        for kind, call in (("pull", pull), ("push", push)):
            for path, stub in stubs.items():
                for _ in range(W2_WARM):
                    call(stub)
            for i in range(W2_CALLS):
                for path in (("socket", "shm") if i % 2 == 0
                             else ("shm", "socket")):
                    t0 = time.perf_counter()
                    bad = call(stubs[path])
                    ms[(path, kind)].append((time.perf_counter() - t0) * 1e3)
                    if bad:
                        problems.append("W2 %s: %s" % (path, bad))
            if problems:
                break
        chan = stubs["shm"].shm_channel
        out = {path: {"%s_p%d_ms" % (kind, q): pct(ms[(path, kind)], q / 100)
                      for kind in ("pull", "push") for q in (50, 99)}
               for path in stubs}
        out["shm"]["channel"] = dict(chan.stats, state=chan.state)
    finally:
        for stub in stubs.values():
            stub.close()
    want = 2 * (W2_WARM + W2_CALLS)
    chan = out["shm"]["channel"]
    if chan["state"] != "on" or chan["shm"] != want:
        problems.append("W2's ring: %s (%d ring calls wanted)" % (chan, want))
    out["payload_mib"] = rows.nbytes / 2**20
    out["order"] = "interleaved, the first alternating"
    return out, problems


def _w_frames(torch):
    """The frame write's copy out of a CUDA tensor, held against the
    frame of the same values staged on the host first: byte for byte,
    float32 and narrowed to bf16 in the copy, contiguous and strided (a
    worker hands its dense gradients to the PS client on the card)."""
    from elasticdl_tpu_torch.common.tensor import Tensor, serialize_tensor

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 91)
    src = torch.randn(W2_IDS, W_DIM, device=DEVICE, generator=gen)
    cases, bad = {}, []
    for layout, t in (("contiguous", src), ("strided", src.T)):
        for mark in (None, "bfloat16"):
            card_t, host_t = (Tensor("g", t), Tensor("g", t.cpu().numpy()))
            card_t.wire_dtype = host_t.wire_dtype = mark
            t0 = time.perf_counter()
            got = serialize_tensor(card_t)
            ms = (time.perf_counter() - t0) * 1e3
            want = serialize_tensor(host_t)
            name = "%s %s" % (layout, mark or "float32")
            cases[name] = {"bytes": len(got), "equal": got == want,
                           "ms": ms}
            if got != want:
                bad.append(name)
    rec = {"phase": "wire", "of": "frames_from_the_card", "cases": cases}
    emit(rec)
    if bad:
        raise PhaseError("the frame write from the card differs from the "
                         "host-staged frame: %s" % bad)
    return rec


def _w_fleet(tmp, name):
    """A W arm's fleet: F1's sync job (``--grads_to_wait 1``) across two
    ``ps.main`` shards, shard 0 on the host store and shard 1 with
    ``--ps_device`` (the writable slot views' import), no worker
    process."""
    return _Fleet(
        tmp, name, PS_DEEPFM, os.path.join(tmp, "ps-data"), PS_BATCH,
        workers=0, job=["--grads_to_wait", "1"],
        # W2's stale pushes would log a warning each
        ps=["--grads_to_wait", "1", "--log_level", "ERROR"],
        ps_by_shard={1: ["--ps_device", "true"]},
    )


def _w_arm(torch, card, fleet, shm, seen, then=None):
    """One W arm: ``fleet``'s job for one epoch of b1024, the worker in
    this process over ``shm``. ``then(fleet)`` runs after the state is
    read, with the shards still up. Returns (record, problems, state,
    what ``then`` returned)."""
    name = os.path.basename(fleet.root)
    ids = {"embedding": seen, "id_bias": seen}

    def inspect(f):
        state = _fleet_state(f, ids)
        return state, (then(f) if then is not None else None)

    raw = fleet.run(inline=_w_inline(torch, shm), inspect=inspect)
    state, after = raw["inspect"]
    run = raw["inline"]
    problems = []
    splits = run["splits"]
    steps_t = [sp["t"] for sp in splits]
    step_ms = _median([(b - a) * 1e3 for a, b in zip(steps_t, steps_t[1:])])
    if len(run["losses"]) != W_STEPS or not all(
            math.isfinite(x) for x in run["losses"]):
        problems.append("%s losses %s" % (name, run["losses"]))
    if not state["ready"] or state["version"] != W_STEPS:
        problems.append("%s fleet version %s" % (name, state["version"]))
    if raw["master_exit_codes"] != [0] or raw["journal"]["pending"]:
        problems.append("%s master %s, journal %s" % (
            name, raw["master_exit_codes"], raw["journal"]))
    wire = run["wire"] or {}
    if shm == "off" and wire:
        problems.append("%s: channels with the wire off: %s" % (name, wire))
    if shm != "off":
        for key in ("ps%d" % i for i in range(FLEET_SHARDS)):
            chan = wire.get(key)
            # a silent fallback would hide the path this arm measures
            if not chan or chan["state"] != "on" or chan["shm"] <= 0:
                problems.append("%s channel %s: %s" % (name, key, chan))
        if (wire.get("master") or {}).get("state") == "off":
            problems.append("%s master channel off: %s" % (name, wire))
    rec = {
        "phase": "wire", "of": name, "card": card, "ps_shm": shm,
        "master_shm": shm, "model": "deepfm_edl_embedding",
        "batch": PS_BATCH, "steps": len(splits), "shards": FLEET_SHARDS,
        "shard_stores": ["host", "device"], "job_s": raw["job_s"],
        "step_ms_median": step_ms,
        "steps_ms": [(b - a) * 1e3 for a, b in zip(steps_t, steps_t[1:])],
        "examples_per_s_median_step": PS_BATCH * 1e3 / step_ms
        if step_ms else None,
        "step_split": {k + "_ms_median": _median(
            [sp.get(k, 0.0) * 1e3 for sp in splits[1:]])
            for k in ("get_model", "pull", "report", "compute")},
        "channels": wire,
        "shards_state": [_shard_record(s) for s in state["statuses"]],
    }
    return rec, problems, state, after


def phase_wire(torch, tmp, card, order=("off", "auto")):
    """The shared-memory wire at F1's width, one arm per entry of
    ``order`` (``--ps_shm``/``--master_shm`` ``off`` or ``auto``, run in
    that order on the card): by default W0 with the wire off and W1 with
    ``auto``, every arm bitwise the first (dense model and every touched
    row), every PS channel of an ``auto`` arm on; W2 the wire alone on
    the first ``auto`` arm's shards; the frame write out of a CUDA
    tensor against the host-staged frame. Returns the flash kernels'
    launches in this process (none)."""
    import numpy as np

    t0 = time.perf_counter()
    _write_ps_data(tmp)
    _reset_counters()
    _w_frames(torch)
    seen = np.unique(_frappe_ids(PS_RECORDS, SEED + 40)[0])
    # W0 and W1; an A/B in turns names its arms apart from W2
    fleets = [_w_fleet(tmp, ("w%d" if len(order) == 2 else "ab%02d") % i)
              for i in range(len(order))]
    problems, arms, w2 = [], [], None
    try:
        # one fleet boots ahead of the arm that runs: an arm's master and
        # shards wait behind the arm before it instead of booting after it
        fleets[0].start()
        for i, shm in enumerate(order):
            if i + 1 < len(fleets):
                fleets[i + 1].start()
            then = None
            if shm == "auto" and w2 is None:
                then = lambda f: _w2(f, seen)  # noqa: E731
            rec, bad, state, after = _w_arm(
                torch, card, fleets[i], shm, seen, then=then)
            problems += bad
            if after is not None:
                w2, bad2 = after
                problems += bad2
            if arms:
                rel, bitwise = _compare(
                    state, arms[0][1]["dense"], arms[0][1]["rows"])
                rec["against_w0"] = {"bitwise": bitwise,
                                     "rel_l2_max": max(rel.values())}
                if not bitwise:
                    problems.append("%s is not bitwise %s: %s" % (
                        rec["of"], arms[0][0]["of"], rel))
            emit(rec)
            arms.append((rec, state))
    finally:
        for fleet in fleets:
            fleet.manager.stop_relaunch_and_remove_all_pods()
    if w2 is not None:
        emit(dict(w2, phase="wire", of="w2", card=card, calls=W2_CALLS,
                  warm=W2_WARM, ids=W2_IDS, width=W_DIM))
    counts = _counts()
    emit({"phase": "wire", "of": "summary",
          "seconds": time.perf_counter() - t0,
          "arms": [[rec["ps_shm"], rec["step_ms_median"]]
                   for rec, _ in arms],
          "flash_launches": {k: n for k, (n, _) in counts.items()}})
    if problems:
        raise PhaseError("wire: " + "; ".join(problems))
    return counts


def _wire_only(torch, order):
    try:
        card = phase_device(torch)
        before = shm_segments()
        phase_shm_room()
        with tempfile.TemporaryDirectory() as tmp:
            counts = phase_wire(torch, tmp, card, order)
        _check_counts(counts, {k: 0 for k in KERNELS}, "the wire phase")
        _check_no_leaked_segments(before)
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


def _check_no_leaked_segments(before):
    """No ``edlw-`` segment the run made may outlive it: every process it
    started has exited and every channel of this one is closed."""
    left = sorted(shm_segments() - before)
    emit({"phase": "summary", "of": "dev_shm", "segments_left": left})
    if left:
        raise PhaseError("shared-memory segments left: %s" % left)


# ---------------------------------------------------------------------------
# elastic: the multi-process ALLREDUCE job, two worker processes on one card
# ---------------------------------------------------------------------------

ELASTIC_RECORDS = 1792  # 28 tasks of one b64 batch: ~14 lockstep steps
ELASTIC_WORKERS = 2
# Run B trains this many epochs, so that the job outlasts the relaunched
# worker's cold start: the survivor, alone, takes a task a step, and a
# joiner that finds no task left never joins
ELASTIC_KILL_EPOCHS = 4
# Run D: the promoted standby is warm and the survivor waits for it (it
# re-forms once, at full size), so one epoch (a kill at v4 of ~14 steps)
# leaves it work to join
ELASTIC_STANDBY_EPOCHS = 1
ELASTIC_KILL_AT_VERSION = 4
ELASTIC_JOB_LIMIT_S = 420  # a run that hangs fails the phase
SNAPSHOT_CHECK_SLEEP_CYCLES = 200_000_000  # keeps the stream busy ~0.1 s
# Run C: the master SIGKILLed once its version reaches this, in a job of
# this many epochs (about 10 lockstep steps left to take after the
# relaunch; the every-phase run's limit took the second epoch)
MASTER_KILL_AT_VERSION = 4
MASTER_KILL_EPOCHS = 1
MASTER_FAILOVER_S = 120  # the workers' outage budget (the default)
# Run E: one epoch, a round every 4 versions over 256 validation records
ELASTIC_EVAL_EPOCHS = 1


def elastic_argv(data_dir, ckpt_dir, out_dir, epochs):
    argv = job_argv(data_dir, ckpt_dir, out_dir)
    argv[argv.index("--num_workers") + 1] = str(ELASTIC_WORKERS)
    argv[argv.index("--num_minibatches_per_task") + 1] = "1"
    argv[argv.index("--num_epochs") + 1] = str(epochs)
    return argv + [
        "--job_name", "chip-smoke-elastic",
        "--keep_checkpoint_max", "2",
        "--restart_policy", "Always",
    ]


def _timeline_events(root):
    """{worker id: [event, ...]} of the workers' timelines."""
    import glob

    events = {}
    for path in glob.glob(os.path.join(root, "worker-*.jsonl")):
        wid = int(os.path.basename(path)[len("worker-"):-len(".jsonl")])
        with open(path) as f:
            events[wid] = [json.loads(line) for line in f]
    return events


def _of(events, kind):
    return [e for e in events if e["event"] == kind]


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def _run_elastic_job(torch, argv, timeline, kill_at=None):
    """``cli.main(argv)`` with ELASTIC_WORKERS worker processes, the
    master in a thread of this process; with ``kill_at``, worker 1 is
    SIGKILLed once the version reaches it. Returns (exit code, the job,
    successful task ids, the kill's wall time)."""
    from elasticdl_tpu_torch import cli

    os.environ["EDL_WORKER_TIMELINE_DIR"] = timeline
    jobs, rc, errors = [], [], []

    def run():
        try:
            rc.append(cli.main(argv, jobs=jobs))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    runner = threading.Thread(target=run, daemon=True)
    runner.start()
    while not jobs and runner.is_alive():
        time.sleep(0.01)
    if not jobs:
        raise PhaseError("elastic: the job did not start: %s" % errors)
    master = jobs[0].master
    done = []
    report = master.task_d.report

    def counting(task_id, success, exec_counters=None):
        if success:
            done.append(task_id)
        return report(task_id, success, exec_counters)

    master.task_d.report = counting
    killed_at = None
    deadline = time.time() + ELASTIC_JOB_LIMIT_S
    if kill_at is not None:
        while (master.master_servicer.get_model_version() < kill_at
               and runner.is_alive() and time.time() < deadline):
            time.sleep(0.01)
        killed_at = time.time()
        master.instance_manager.kill_worker(1)
    runner.join(max(1.0, deadline - time.time()))
    if runner.is_alive():
        master.request_stop()
        runner.join(30)
        raise PhaseError("elastic: the job ran past %d s" % ELASTIC_JOB_LIMIT_S)
    if errors:
        raise PhaseError("elastic: the job raised %r" % errors[0])
    return rc[0], jobs[0], done, killed_at


def _checkpoint_digest(torch, directory):
    """(version, digest) of a checkpoint restored into a fresh model on
    the card."""
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.parallel.elastic import state_digest
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    fresh = AllReduceTrainer(
        zoo.custom_model(num_classes=JOB_CLASSES), zoo.loss, zoo.optimizer(),
        seed=SEED + 1, device=DEVICE,
    )
    fresh.init_from_batch(None)
    version = fresh.restore_sharded(directory)
    return version, state_digest(fresh.train_state)


def _snapshot_check(torch):
    """The asynchronous manager's pinned snapshot on the card: with the
    stream kept busy before the save (so its copies land late), the
    parameters updated in place right after ``save`` returns, and the
    writer thread held until then, the checkpoint still holds the values
    of the save."""
    import tempfile as _tempfile

    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        ShardedCheckpointManager,
        load_sharded_to_host,
    )
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    trainer = AllReduceTrainer(
        zoo.custom_model(num_classes=JOB_CLASSES), zoo.loss, zoo.optimizer(),
        seed=SEED, device=DEVICE,
    )
    trainer.init_from_batch(None)
    ts = trainer.train_state
    want = {n: p.detach().to("cpu", copy=True) for n, p in ts.params.items()}
    with _tempfile.TemporaryDirectory() as tmp:
        mgr = ShardedCheckpointManager(tmp, 1, async_io=True)
        gate = threading.Event()
        mgr._async.submit(lambda: gate.wait(30))
        if DEVICE == "cuda":
            torch.cuda._sleep(SNAPSHOT_CHECK_SLEEP_CYCLES)
        t0 = time.perf_counter()
        directory = mgr.save(ts, 1)
        stall_s = time.perf_counter() - t0
        with torch.no_grad():
            for p in ts.params.values():
                p.add_(1.0)
        gate.set()
        mgr.close()
        _, leaves = load_sharded_to_host(directory)
    bad = [n for n, t in want.items()
           if not torch.equal(leaves["params/" + n], t)]
    return {"ok": not bad, "torn": bad[:5], "stall_s": stall_s,
            "write_s": mgr.write_seconds.get(1)}


def _splits(events):
    """{host step: its split} of one worker's step events; each event
    carries the stream-timed split of the step before it."""
    return {s["split"]["host_step"]: s["split"]
            for s in _of(events, "step") if s.get("split")}


def _step_split(steps, splits):
    """Medians over one rank's step events ``steps`` of the stream's
    times of compute, the all-reduce and the rest of the step, and of
    the card's idle per step: the host clock's period between two step
    ends less the stream's time of the later step."""
    timed = [splits[s["host_step"]] for s in steps
             if s["host_step"] in splits]
    idle = [b["t"] - a["t"] - splits[b["host_step"]]["step_s"]
            for a, b in zip(steps, steps[1:]) if b["host_step"] in splits]
    return {
        "timed_steps": len(timed),
        "step_ms": 1e3 * _median([s["step_s"] for s in timed]),
        "compute_ms": 1e3 * _median([s["compute_s"] for s in timed]),
        "allreduce_ms": 1e3 * _median([s["allreduce_s"] for s in timed]),
        "rest_ms": 1e3 * _median([s["rest_s"] for s in timed]),
        "device_idle_ms": 1e3 * (_median(idle) or 0.0),
    }


def _live_steps(events, epoch):
    """{worker: its steps of world ``epoch`` with a live rank}."""
    return {w: [s for s in _of(ev, "step")
                if s["epoch"] == epoch and s["live"] > 0]
            for w, ev in events.items()}


def _rank0(events, epoch):
    return next((w for w, ev in events.items()
                 if any(e["epoch"] == epoch and e["rank"] == 0
                        for e in _of(ev, "established"))), None)


def _examples_per_s(events, epoch):
    """Job examples/s of world ``epoch`` over its steps after the first
    (the steps with a live rank): every rank's true rows over the span
    of rank 0's step ends."""
    steps = _live_steps(events, epoch)
    lead = steps.get(_rank0(events, epoch), [])
    if len(lead) < 2:
        return None
    rows = sum(s["rows"] for st in steps.values() for s in st[1:])
    return rows / (lead[-1]["t"] - lead[0]["t"])


def _parked_context_mib(torch):
    """The card memory a parked standby holds: a process warmed as
    ``worker/main._warm`` warms a standby (the zoo module, the CUDA
    context, cuDNN and cuBLAS), measured as the card's free memory
    before it starts less while it parks; the warm's seconds too."""
    code = (
        "import json, sys, time, types\n"
        "sys.path.insert(0, %r)\n"
        "from elasticdl_tpu_torch.worker.main import _warm\n"
        "warmed = _warm(types.SimpleNamespace(model_def=%r, model_zoo=%r,"
        " device=%r))\n"
        "print(json.dumps(warmed), flush=True)\n"
        "time.sleep(120)\n"
    ) % (REPO, JOB_MODEL_DEF,
         os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"), DEVICE)
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info()
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        warmed = json.loads(proc.stdout.readline())
        time.sleep(0.5)
        free1, _ = torch.cuda.mem_get_info()
    finally:
        proc.kill()
        proc.wait()
    return {"mib": (free0 - free1) / 2**20, "card_mib": total / 2**20,
            "warmed": warmed}


def _eval_records(torch, val_dir):
    """EVAL_RECORDS validation records from SEED + 1, as phase_eval
    writes them; returns (images, labels, seconds)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    images = rng.integers(0, 256, (EVAL_RECORDS, JOB_IMAGE, JOB_IMAGE, 3),
                          dtype=np.uint8)
    labels = rng.integers(1, JOB_CLASSES + 1, EVAL_RECORDS)
    return images, labels, write_records(val_dir, images, labels)


def _hold_rounds(torch, reports, published, ckpt_dir, images, labels):
    """Each report whose scored version has a checkpoint, against a
    direct forward of that checkpoint: its rows found by their labels,
    within EVAL_REL_L2; each round all of whose reports scored one such
    version, its accuracy within EVAL_TOL_RECORDS of the direct one.
    Returns (per-round records, problems)."""
    import numpy as np

    direct = {}

    def forward(version):
        if version not in direct:
            directory = os.path.join(ckpt_dir, "ckpt_v%d" % version)
            if not os.path.isdir(directory):
                direct[version] = None
            else:
                params, state = _checkpoint_weights(torch, directory)
                direct[version] = _direct_forward(torch, params, state,
                                                  images)
        return direct[version]

    tol = EVAL_TOL_RECORDS / EVAL_RECORDS
    problems, rounds = [], []
    for r in published:
        v = r["version"]
        mine = [rep for rep in reports if rep[0] == v]
        held = []
        for _, scored, out, got_labels in mine:
            want_out = forward(scored) if scored is not None else None
            if want_out is None:
                continue
            n = len(got_labels)
            starts = [s for s in range(0, EVAL_RECORDS, n)
                      if np.array_equal(np.ravel(got_labels),
                                        labels[s:s + n] - 1)]
            if len(starts) != 1:
                problems.append("round v%d: a report's labels match %d "
                                "blocks" % (v, len(starts)))
                continue
            s = starts[0]
            rel = _rel_l2(torch, torch.from_numpy(np.asarray(out)).to(
                want_out.device).float(), want_out[s:s + n])
            held.append(rel)
            if rel > EVAL_REL_L2:
                problems.append("round v%d: outputs %s from ckpt_v%d's "
                                "direct forward" % (v, rel, scored))
        scored_set = sorted({rep[1] for rep in mine})
        rec = {"version": v, "scored_versions": scored_set,
               "accuracy": r["metrics"]["accuracy"],
               "reports": len(mine), "held_reports": len(held),
               "max_rel_l2": max(held) if held else None}
        if len(scored_set) == 1 and forward(scored_set[0]) is not None:
            acc = _accuracy(torch, forward(scored_set[0]), labels)
            rec["direct_accuracy"] = acc
            if abs(acc - rec["accuracy"]) > tol + 1e-12:
                problems.append("round v%d reads %s, ckpt_v%d's direct "
                                "forward %s" % (v, rec["accuracy"],
                                                scored_set[0], acc))
        rounds.append(rec)
    if not any(r["held_reports"] for r in rounds):
        problems.append("no round scored a version that has a checkpoint")
    return rounds, problems


def _peer_stalls(events):
    """Each step period of one rank that spans the end of an evaluation
    task the other rank scored, less that rank's median period (ms):
    the peer's lockstep stall while one rank scores."""
    periods = {}
    for w, ev in events.items():
        steps = [s["t"] for s in _of(ev, "step") if s["live"] > 0]
        periods[w] = list(zip(steps, steps[1:]))
    stalled = {}  # (peer, its step period) -> that period less its median
    for w, ev in events.items():
        for e in _of(ev, "eval"):
            for peer, spans in periods.items():
                if peer == w or not spans:
                    continue
                median = _median([b - a for a, b in spans])
                span = next(((a, b) for a, b in spans if b >= e["t"]), None)
                if span is not None and span[0] <= e["t"]:
                    stalled[peer, span] = 1e3 * (span[1] - span[0] - median)
    return [ms for _, ms in sorted(stalled.items())]


def phase_elastic(torch, tmp, job_rec, card):
    """The multi-process elastic ALLREDUCE job through the port's command
    line: the master in this process, ELASTIC_WORKERS worker processes
    sharing the card in one process world. Run A trains one epoch of
    ELASTIC_RECORDS; Run B kills worker 1 at version
    ELASTIC_KILL_AT_VERSION and finishes with its replacement; Run C
    SIGKILLs a master that runs as its own process (``_master_kill_run``);
    Run D is Run B with a warmed standby promoted in the dead worker's
    place; Run E evaluates while it trains. Returns the flash kernels'
    launches of each run, by path (the workers report theirs; ResNet-50
    launches none), and the runs' records."""
    from elasticdl_tpu_torch.parallel.distributed import (
        choose_backend,
        worker_devices,
    )

    problems = []
    torch.cuda.empty_cache()
    data_dir = os.path.join(tmp, "elastic-data")
    write_s = write_job_records(torch, data_dir, ELASTIC_RECORDS)
    val_dir = os.path.join(tmp, "elastic-val")
    images, labels, val_write_s = _eval_records(torch, val_dir)
    snapshot = _snapshot_check(torch)
    if not snapshot["ok"]:
        problems.append("the pinned snapshot is torn: %s" % snapshot["torn"])
    tasks = ELASTIC_RECORDS // JOB_BATCH
    expected_backend = choose_backend(
        torch.device(worker_devices(DEVICE, ELASTIC_WORKERS)[0])
    )
    paths = {}
    records = {}

    def add_launches(path, finals_by_worker):
        counts = paths.setdefault(path, {name: 0 for name in KERNELS})
        for finals in finals_by_worker:
            for name, n in finals[0]["launches"].items():
                counts[name] += n

    parked = _parked_context_mib(torch) if DEVICE == "cuda" else None

    runs = (
        ("A", 1, None, [], "elastic"),
        ("B", ELASTIC_KILL_EPOCHS, ELASTIC_KILL_AT_VERSION, [], "elastic"),
        ("C", MASTER_KILL_EPOCHS, None, None, "elastic_master_kill"),
        ("D", ELASTIC_STANDBY_EPOCHS, ELASTIC_KILL_AT_VERSION,
         ["--num_standby_workers", "1"], "elastic_standby"),
        ("E", ELASTIC_EVAL_EPOCHS, None,
         ["--validation_data", val_dir, "--evaluation_steps",
          str(EVAL_STEPS)], "elastic_eval"),
    )
    for run, epochs, kill_at, extra, path in runs:
        if extra is None:
            rec, bad, finals = _master_kill_run(
                torch, tmp, data_dir, epochs, card, records["B"]
            )
            add_launches(path, finals)
            emit(rec)
            records[run] = rec
            problems += ["run %s: %s" % (run, b) for b in bad]
            continue
        root = os.path.join(tmp, "elastic-%s" % run)
        ckpt_dir, out_dir = root + "-ckpt", root + "-export"
        argv = elastic_argv(data_dir, ckpt_dir, out_dir, epochs) + extra
        if run == "E":
            # every checkpoint stays: each round is held against its own
            argv[argv.index("--keep_checkpoint_max") + 1] = "0"
        t0 = time.perf_counter()
        with _EvalReports() as spy:
            rc, job, done, killed_at = _run_elastic_job(
                torch, argv, root + "-timeline", kill_at
            )
        job_s = time.perf_counter() - t0
        manager = job.master.instance_manager
        events = _timeline_events(root + "-timeline")
        _note_worker_exports(events)
        bad = []
        if rc != 0:
            bad.append("exit code %s" % rc)
        if not job.master.task_d.finished():
            bad.append("the dispatcher has tasks left")
        published = (job.master.evaluation_service.published
                     if job.master.evaluation_service else [])
        eval_tasks = EVAL_RECORDS // JOB_BATCH
        # + the SAVE_MODEL task, + each round's evaluation tasks
        want_done = tasks * epochs + 1 + eval_tasks * len(published)
        if len(done) != want_done or len(set(done)) != len(done):
            bad.append("%d task completions (%d distinct), expected %d once"
                       % (len(done), len(set(done)), want_done))
        finals = {w: _of(ev, "final") for w, ev in events.items()}
        live_workers = [w for w, f in finals.items() if f]
        digests = {finals[w][0]["digest"] for w in live_workers}
        if len(live_workers) != ELASTIC_WORKERS or len(digests) != 1:
            bad.append("final states of workers %s: %d distinct digests"
                       % (live_workers, len(digests)))
        add_launches(path, [finals[w] for w in live_workers])
        worlds = {w: _of(ev, "established") for w, ev in events.items()}
        backends = sorted({e["backend"] for ws in worlds.values()
                           for e in ws if e["size"] > 1})
        if backends != [expected_backend]:
            bad.append("backends %s, expected %s"
                       % (backends, expected_backend))
        lead = min(live_workers) if live_workers else 0
        steps = _of(events.get(lead, []), "step")
        lead_splits = _splits(events.get(lead, []))
        version = finals[lead][0]["version"] if live_workers else -1
        live_steps = sum(1 for s in steps if s["live"] > 0)
        if version != live_steps:
            bad.append("final version %d, %d steps with a live rank"
                       % (version, live_steps))
        ckpts = {c["version"]: c for c in _of(events.get(0, []),
                                               "checkpoint")}
        newest = max(ckpts) if ckpts else None
        restored = None
        if newest is None:
            bad.append("rank 0 wrote no checkpoint")
        else:
            got_v, digest = _checkpoint_digest(
                torch, os.path.join(ckpt_dir, "ckpt_v%d" % newest)
            )
            restored = got_v == newest and digest == ckpts[newest]["digest"]
            if not restored:
                bad.append("ckpt_v%d does not restore bitwise" % newest)
        import glob

        if not glob.glob(os.path.join(out_dir, "*", "MANIFEST.json")):
            bad.append("no export manifest under %s" % out_dir)
        writes = {}
        for ev in events.values():
            for e in _of(ev, "checkpoint_writes"):
                writes.update({int(k): v for k, v in e["write_s"].items()})
        first_epoch = min((e["epoch"] for ws in worlds.values() for e in ws),
                          default=0)
        live_by_worker = _live_steps(events, first_epoch)
        rec = {
            "phase": "elastic",
            "run": run,
            "card": card,
            "model": JOB_MODEL_DEF + " (bf16, params float32)",
            "workers": ELASTIC_WORKERS,
            "records": ELASTIC_RECORDS,
            "epochs": epochs,
            "batch": JOB_BATCH,
            "checkpoint_steps": JOB_CKPT_STEPS,
            "backend": backends,
            "write_records_s": write_s,
            "job_s": job_s,
            "exit_codes": {str(k): v for k, v in manager.exit_codes.items()},
            "tasks_done": len(done),
            "version": version,
            "steps": len(steps),
            "live_steps": live_steps,
            "final_digests_equal": len(digests) == 1,
            "newest_checkpoint": newest,
            "restore_bitwise": restored,
            "examples_per_s": _examples_per_s(events, first_epoch),
            "single_process_job_examples_per_s": job_rec["examples_per_s"],
            # per worker, over the first world's live steps after its
            # first: the all-reduce's time includes waiting for the
            # slower rank
            "step_split": {str(w): _step_split(st[1:],
                                               _splits(events[w]))
                           for w, st in live_by_worker.items()
                           if len(st) > 2},
            "lead_steps": [
                {"t_s": s["t"] - steps[0]["t"], "live": s["live"],
                 "rows": s["rows"],
                 "step_ms": 1e3 * lead_splits[s["host_step"]]["step_s"]
                 if s["host_step"] in lead_splits else None,
                 "allreduce_ms":
                 1e3 * lead_splits[s["host_step"]]["allreduce_s"]
                 if s["host_step"] in lead_splits else None}
                for s in steps[:40]
            ],
            "checkpoint_stall_ms": [1e3 * c["snapshot_s"]
                                    for _, c in sorted(ckpts.items())],
            "checkpoint_write_ms": [1e3 * v for _, v in sorted(writes.items())],
            "sync_checkpoint_s_pr5": "1.1-1.7 (PERF.md)",
        }
        # where a run's seconds go: each first worker's boot (spawn ->
        # its start event -> its first step), and the job's tail after
        # the last step
        rec["boot"] = {
            str(w): {
                "spawn_to_start_s": _of(ev, "start")[0]["t"]
                - manager.spawned_at[w]
                if _of(ev, "start") and w in manager.spawned_at else None,
                "start_to_first_step_s": _of(ev, "step")[0]["t"]
                - _of(ev, "start")[0]["t"]
                if _of(ev, "start") and _of(ev, "step") else None,
                "start_to_established_s": _of(ev, "established")[0]["t"]
                - _of(ev, "start")[0]["t"]
                if _of(ev, "start") and _of(ev, "established") else None,
                "establish": {k: v for k, v in (_of(ev, "established")
                                                or [{}])[0].items()
                              if k.endswith("_s")},
            }
            for w, ev in sorted(events.items()) if w < ELASTIC_WORKERS
        }
        rec["first_step_after_job_start_s"] = (
            steps[0]["t"] - (time.time() - (time.perf_counter() - t0))
            if steps else None)
        rec["last_step_to_job_end_s"] = (
            time.time() - steps[-1]["t"] - (time.perf_counter() - t0 - job_s)
            if steps else None)
        if run == "A":
            rec["snapshot_check"] = snapshot
            if manager.exit_codes != {0: 0, 1: 0}:
                bad.append("worker exits %s" % manager.exit_codes)
        elif run == "E":
            rounds, eval_bad = _hold_rounds(torch, spy.reports, published,
                                            ckpt_dir, images, labels)
            bad += eval_bad
            if not published or any(p["version"] <= 0 for p in published):
                bad.append("rounds published at %s"
                           % [p["version"] for p in published])
            scored = {}
            for ev in events.values():
                for e in _of(ev, "eval"):
                    key = e["version"]
                    scored[key] = scored.get(key, 0) + e["t"] - e["t0"]
            stalls = _peer_stalls(events)
            rec.update({
                "eval_records": EVAL_RECORDS,
                "write_eval_records_s": val_write_s,
                "evaluation_steps": EVAL_STEPS,
                "rounds": rounds,
                "round_s": {str(v): sec for v, sec in sorted(scored.items())},
                "examples_per_s_without_rounds_run_a":
                records["A"]["examples_per_s"],
                "peer_stall_ms": stalls,
                "peer_stall_ms_median": _median(stalls),
            })
        else:
            survivor = events.get(0, [])
            broken = [e for e in _of(survivor, "world_broken")
                      if e["t"] >= killed_at]
            later = [w for w in worlds.get(0, []) if w["t"] > killed_at]
            relaunched = sorted(w for w in events if w >= ELASTIC_WORKERS)
            joined = worlds.get(relaunched[0], []) if relaunched else []
            by_epoch = {w["epoch"]: w for w in worlds.get(0, [])}
            joined_equal = bool(joined) and all(
                w["epoch"] in by_epoch
                and w["digest"] == by_epoch[w["epoch"]]["digest"]
                for w in joined
            )
            if manager.exit_codes.get(1) != -9:
                bad.append("worker 1 exited %s, expected SIGKILL"
                           % manager.exit_codes.get(1))
            if not broken:
                bad.append("the survivor's step never broke")
            if not later:
                bad.append("the survivor never re-formed")
            if not joined_equal:
                bad.append("the relaunched worker did not join with the "
                           "survivor's state: %s / %s"
                           % ([w.get("digest") for w in joined],
                              sorted(by_epoch)))
            after = [s for s in steps if s["t"] > killed_at
                     and s["epoch"] > (broken[0]["epoch"] if broken else 0)]
            spawned = manager.spawned_at.get(relaunched[0]) if relaunched \
                else None
            start = _of(events.get(relaunched[0], []), "start") if \
                relaunched else []
            rec.update({
                "killed_at_version": kill_at,
                "kill_to_world_broken_s": (broken[0]["t"] - killed_at
                                           if broken else None),
                "kill_to_first_step_of_new_world_s": (
                    after[0]["t"] - killed_at if after else None),
                "worlds_of_survivor": [(w["epoch"], w["size"])
                                       for w in worlds.get(0, [])],
                "relaunched": relaunched,
                "relaunch_joined_bitwise": joined_equal,
                "survivor_alone_examples_per_s": _examples_per_s(
                    events, later[0]["epoch"]) if later else None,
                "rejoined_examples_per_s": _examples_per_s(
                    events, joined[0]["epoch"]) if joined else None,
            })
            rec.update({
                "joiner_start_to_join_s": (joined[0]["t"] - start[0]["t"]
                                           if joined and start else None),
                "joiner_world_s": joined[0]["world_s"] if joined else None,
                # the joiner's wait for its peers inside the broadcast
                "joiner_source_s": (joined[0].get("source_s")
                                    if joined else None),
                "joiner_broadcast_s": (joined[0]["broadcast_s"]
                                       if joined else None),
            })
            if run == "B":
                rec.update({
                    "relaunch_spawn_after_kill_s": (
                        spawned - killed_at if spawned else None),
                    "relaunch_cold_start_s": (start[0]["t"] - spawned
                                              if start and spawned else None),
                    "relaunch_spawn_to_join_s": (
                        joined[0]["t"] - spawned
                        if joined and spawned else None),
                })
            else:
                bad += _standby_checks(rec, manager, events, relaunched,
                                       joined, later, killed_at,
                                       records["B"], parked)
        emit(rec)
        records[run] = rec
        problems += ["run %s: %s" % (run, b) for b in bad]
    if problems:
        raise PhaseError("elastic: " + "; ".join(problems))
    return ({path: {name: (n, {}) for name, n in counts.items()}
             for path, counts in paths.items()}, records)


def _standby_checks(rec, manager, events, relaunched, joined, later,
                    killed_at, run_b, parked):
    """Run D: the warmed standby took the dead worker's place (no cold
    relaunch), the survivor re-formed once at full size, a fresh standby
    refilled the pool; records kill -> join beside Run B's relaunch, what
    the standby warmed while it parked, and (``parked``) the card memory
    such a parked process holds. Returns the problems."""
    bad = []
    promoted = [p[0] for p in manager.promotions]
    if not manager.promotions or manager.cold_relaunches:
        bad.append("no standby promotion (promotions %s, cold relaunches "
                   "%s)" % (manager.promotions, manager.cold_relaunches))
    if relaunched != promoted:
        bad.append("workers %s joined, the promoted ones are %s"
                   % (relaunched, promoted))
    if len(manager.standby_tokens) < 2:
        bad.append("the pool was not refilled: standbys %s"
                   % manager.standby_tokens)
    sizes = [w["size"] for w in later]
    if not sizes or any(n != ELASTIC_WORKERS for n in sizes):
        bad.append("the survivor re-formed at sizes %s, not once at full "
                   "size" % sizes)
    standby = _of(events.get(promoted[0], []), "standby") if promoted else []
    token = manager.promotions[0][1] if manager.promotions else None
    rec.update({
        "promotions": manager.promotions,
        "standby_tokens": manager.standby_tokens,
        "standby_warmed": standby[0]["warmed"] if standby else None,
        "standby_parked_s": (standby[0]["promoted_at"]
                             - standby[0]["parked_at"]) if standby else None,
        "standby_spawn_to_parked_s": (
            standby[0]["parked_at"] - manager.spawned_at[token]
            if standby and token in manager.spawned_at else None),
        "kill_to_promotion_s": (manager.promotions[0][2] - killed_at
                                if manager.promotions else None),
        "kill_to_promoted_join_s": (joined[0]["t"] - killed_at
                                    if joined else None),
        "run_b_relaunch_spawn_to_join_s": run_b.get(
            "relaunch_spawn_to_join_s"),
        "run_b_relaunch_cold_start_s": run_b.get("relaunch_cold_start_s"),
        "run_b_kill_to_first_step_of_new_world_s": run_b.get(
            "kill_to_first_step_of_new_world_s"),
        "promoted_start_after_promotion_s": (
            _of(events[promoted[0]], "start")[0]["t"]
            - manager.promotions[0][2]
            if promoted and _of(events.get(promoted[0], []), "start")
            else None),
        "run_b_joiner_start_to_join_s": run_b.get("joiner_start_to_join_s"),
        "parked_standby_card_mib": parked["mib"] if parked else
        "not measured",
        "parked_standby_warmed": parked["warmed"] if parked else None,
    })
    return bad


def _master_kill_run(torch, tmp, data_dir, epochs, card, run_b):
    """Run C: the master as ``python -m elasticdl_tpu_torch.master.master``
    (a journal, a fixed port, ``--num_workers 0``) and two worker
    processes dialling it, all supervised by one LocalInstanceManager in
    its external-supervisor form, which relaunches the master after its
    SIGKILL at MASTER_KILL_AT_VERSION. Returns (record, problems, the
    workers' final events)."""
    import socket

    from elasticdl_tpu_torch.common.args import (
        build_arguments_from_parsed_result,
        parse_master_args,
    )
    from elasticdl_tpu_torch.master.journal import MasterJournal
    from elasticdl_tpu_torch.master.local_instance_manager import (
        LocalInstanceManager,
    )
    from elasticdl_tpu_torch.master.rpc_service import MasterClient
    from elasticdl_tpu_torch.parallel.distributed import worker_devices

    root = os.path.join(tmp, "elastic-C")
    ckpt_dir, journal_dir, timeline = (root + "-ckpt", root + "-journal",
                                       root + "-timeline")
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    flags = elastic_argv(data_dir, ckpt_dir, None, epochs)[1:]
    flags[flags.index("--num_workers") + 1] = "0"
    flags += ["--port", str(port), "--master_journal_dir", journal_dir]
    master_argv = [sys.executable, "-m",
                   "elasticdl_tpu_torch.master.master"] + flags
    relay = build_arguments_from_parsed_result(
        parse_master_args(flags),
        filter_args={"port", "num_workers", "training_data",
                     "validation_data", "prediction_data", "job_name",
                     "device", "master_journal_dir"},
    )

    def worker_argv(worker_id, device):
        return [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
                "--worker_id", str(worker_id), "--job_type",
                "training_only", "--master_addr", "localhost:%d" % port,
                "--device", device, "--master_failover_s",
                str(MASTER_FAILOVER_S)] + relay

    env = dict(os.environ, PYTHONPATH=REPO, EDL_COMM_HOST="localhost",
               EDL_WORKER_TIMELINE_DIR=timeline, EDL_MASTER_POLL_SECS="1",
               EDL_MASTER_EXIT_GRACE_S="120")
    manager = LocalInstanceManager(
        None, ELASTIC_WORKERS, worker_argv,
        worker_devices(DEVICE, ELASTIC_WORKERS), env=env,
        master_command=lambda: master_argv,
    )

    def status():
        probe = MasterClient("localhost:%d" % port)
        try:
            return probe.master_status()
        except Exception:  # noqa: BLE001 — not serving (yet)
            return None
        finally:
            probe.close()

    bad = []
    t0 = time.perf_counter()
    deadline = time.time() + ELASTIC_JOB_LIMIT_S
    manager.start_master()
    try:
        before = None
        while before is None and time.time() < deadline:
            before = status()
            time.sleep(0.05)
        if before is None:
            raise PhaseError("elastic C: the master never served")
        manager.start_workers()
        at_kill = before
        while (at_kill or {}).get("version", 0) < MASTER_KILL_AT_VERSION:
            if time.time() > deadline or not manager.live_workers():
                raise PhaseError("elastic C: the job never reached v%d"
                                 % MASTER_KILL_AT_VERSION)
            at_kill = status() or at_kill
            time.sleep(0.02)
        live_at_kill = manager.live_workers()
        killed_at = time.time()
        manager.kill_master()
        after = None
        while time.time() < deadline:
            after = status()
            if after and after["master_epoch"] != before["master_epoch"]:
                break
            time.sleep(0.02)
        serving_at = time.time()
        live_after = manager.live_workers()
        if not manager.wait(timeout=max(1.0, deadline - time.time())):
            bad.append("the workers ran past %d s" % ELASTIC_JOB_LIMIT_S)
        while manager.live_master() and time.time() < deadline:
            time.sleep(0.1)
    finally:
        manager.stop_relaunch_and_remove_all_pods(grace_s=10)
    job_s = time.perf_counter() - t0
    events = _timeline_events(timeline)
    _note_worker_exports(events)
    state = MasterJournal(journal_dir).replay()
    tasks = ELASTIC_RECORDS // JOB_BATCH
    if live_at_kill != [0, 1] or live_after != [0, 1]:
        bad.append("workers live at the kill %s, at the relaunch %s"
                   % (live_at_kill, live_after))
    if manager.exit_codes != {0: 0, 1: 0}:
        bad.append("worker exits %s" % manager.exit_codes)
    if manager.master_exit_codes != [-9, 0]:
        bad.append("master exits %s" % manager.master_exit_codes)
    if not after or after["master_epoch"] != before["master_epoch"] + 1:
        bad.append("master_epoch %s -> %s" % (
            before["master_epoch"], after and after["master_epoch"]))
    if state.counters["done"] != tasks * epochs or state.pending:
        bad.append("the journal counts %d done (%d pending), expected %d"
                   % (state.counters["done"], len(state.pending),
                      tasks * epochs))
    finals = {w: _of(ev, "final") for w, ev in events.items()}
    digests = {f[0]["digest"] for f in finals.values() if f}
    if sorted(w for w, f in finals.items() if f) != [0, 1] or len(
            digests) != 1:
        bad.append("final states: %d distinct digests" % len(digests))
    relaunched = {w: [e for e in _of(ev, "established")
                      if e["t"] > killed_at] for w, ev in events.items()}
    reformed = [e for e in relaunched.get(0, [])]
    first_step = None
    if reformed:
        first_step = next((s["t"] for s in _of(events[0], "step")
                           if s["epoch"] == reformed[0]["epoch"]), None)
    else:
        bad.append("rank 0 never re-formed after the relaunch")
    old_epochs = [e["epoch"] for e in _of(events.get(0, []), "established")
                  if e["t"] <= killed_at]
    if reformed and old_epochs and reformed[0]["epoch"] <= max(old_epochs):
        bad.append("the new world's epoch %d is not past the old %d"
                   % (reformed[0]["epoch"], max(old_epochs)))
    final_version = finals[0][0]["version"] if finals.get(0) else -1
    if final_version < at_kill["version"] or (
            after and after["version"] < at_kill["version"]):
        bad.append("the version clock went back: %s at the kill, %s at "
                   "the relaunch, %s at the end"
                   % (at_kill["version"], after and after["version"],
                      final_version))
    ckpts = {c["version"]: c for c in _of(events.get(0, []), "checkpoint")}
    restored = None
    if ckpts:
        newest = max(ckpts)
        got_v, digest = _checkpoint_digest(
            torch, os.path.join(ckpt_dir, "ckpt_v%d" % newest))
        restored = got_v == newest and digest == ckpts[newest]["digest"]
        if not restored:
            bad.append("ckpt_v%d does not restore bitwise" % newest)
    else:
        bad.append("rank 0 wrote no checkpoint")
    recovery = (after or {}).get("recovery") or {}
    rec = {
        "phase": "elastic",
        "run": "C",
        "card": card,
        "model": JOB_MODEL_DEF + " (bf16, params float32)",
        "workers": ELASTIC_WORKERS,
        "records": ELASTIC_RECORDS,
        "epochs": epochs,
        "batch": JOB_BATCH,
        "job_s": job_s,
        "killed_at_version": at_kill["version"],
        "master_epochs": [before["master_epoch"],
                          after and after["master_epoch"]],
        "master_exit_codes": manager.master_exit_codes,
        "exit_codes": {str(k): v for k, v in manager.exit_codes.items()},
        "journal": dict(state.counters, pending=len(state.pending)),
        "journal_dup": state.counters["deduped"],
        "kill_to_serving_s": serving_at - killed_at,
        "replay_s": recovery.get("replay_s"),
        "records_replayed": recovery.get("records"),
        "requeued_at_boot": recovery.get("pending"),
        "kill_to_first_step_of_new_world_s": (
            first_step - killed_at if first_step else None),
        "reestablish_world_s": reformed[0]["world_s"] if reformed else None,
        "reestablish_broadcast_s": (reformed[0]["broadcast_s"]
                                    if reformed else None),
        "worlds_of_rank0": [(e["epoch"], e["size"]) for e in
                            _of(events.get(0, []), "established")],
        "final_version": final_version,
        "final_digests_equal": len(digests) == 1,
        "restore_bitwise": restored,
        "run_b_kill_to_first_step_of_new_world_s": run_b.get(
            "kill_to_first_step_of_new_world_s"),
    }
    return rec, bad, [f for f in finals.values() if f]


def _record_at(records, kernel, key):
    b, lq, lk, h, d, dtype, causal = key
    return next(
        r for r in records
        if r["kernel"] == kernel
        and r["shape"] == [b, lq, h, d]
        and r["lk"] == lk
        and r["dtype"] == dtype
        and r["causal"] == causal
        and "kernel_ms" in r
    )


# ---------------------------------------------------------------------------
# elastic_tp: transformer_lm's tensor-parallel shards on the elastic plane
# ---------------------------------------------------------------------------

# SLICE_CFG's widths (d 768, 12 heads of 64, d_ff 3072, vocabulary 32,768,
# bf16 compute) at 2 layers, tensor_parallel=2: the first world of two
# processes is data 1 x model 2, the third worker a spare
ELASTIC_TP_CFG = dict(SLICE_CFG, num_layers=2)
ELASTIC_TP_WORKERS = 3
ELASTIC_TP_BATCH = 16  # records a rank steps on: 16 x 64 tokens
# two ranks of ELASTIC_TP_BATCH a version; 16 versions read 42.8-45.8 s
# for the phase on slower hosts, over its 45 s budget, so 12
ELASTIC_TP_VERSIONS = 12
ELASTIC_TP_RECORDS = ELASTIC_TP_VERSIONS * 2 * ELASTIC_TP_BATCH
ELASTIC_TP_VAL_RECORDS = 8  # one evaluation task a round
ELASTIC_TP_CKPT_STEPS = 2
ELASTIC_TP_EVAL_STEPS = 4
ELASTIC_TP_KILL_AT = 4  # once both ranks' ckpt_v4 manifests are on disk
ELASTIC_TP_LIMIT_S = 240  # a run that hangs fails the phase
ELASTIC_TP_REL_L2 = 1e-2  # a round's outputs against its checkpoint's
# The zoo module the job names: the port's LM, its 64-token records parsed
# as the zoo parses them, without the training shuffle (with a
# 1,024-record buffer in each worker, the first worker to prime would
# take every task of a job of a few hundred records)
ELASTIC_TP_ZOO = textwrap.dedent(
    """
    from elasticdl_tpu_torch.model_zoo.transformer_lm.transformer_lm import *  # noqa
    from elasticdl_tpu_torch.model_zoo.transformer_lm.transformer_lm import (
        FixedLenFeature, Mode, np, parse_example)


    def dataset_fn(dataset, mode, _):
        def _parse_data(record):
            r = parse_example(
                record, {"tokens": FixedLenFeature([64], np.int64)})
            tokens = r["tokens"].astype(np.int32)
            if mode == Mode.PREDICTION:
                return {"tokens": tokens}
            return {"tokens": tokens}, tokens

        return dataset.map(_parse_data)
    """
)


def _tp_params():
    return ",".join("%s=%s" % (k, v) for k, v in ELASTIC_TP_CFG.items()) + (
        ",tensor_parallel=2")


def write_lm_records(data_dir, n, seed):
    """``n`` 64-token records from ``seed``; returns the tokens."""
    import numpy as np

    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    os.makedirs(data_dir, exist_ok=True)
    tokens = np.random.default_rng(seed).integers(
        0, ELASTIC_TP_CFG["vocab_size"], (n, 64)).astype(np.int64)
    with RecordIOWriter(os.path.join(data_dir, "f0")) as w:
        for row in tokens:
            w.write(encode_example({"tokens": row}))
    return tokens


def _tp_budget_mb():
    """(the layout solver's per-device budget, the model profile): the
    whole model's state (parameters and AdamW moments) does not fit, its
    two-way split does, so every world of two lays out data 1 x model 2.
    The profile is the pjit plane's, from the whole model on the meta
    device."""
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.parallel.elastic import (
        derive_model_profile,
        reference_state_leaves,
    )

    import torch

    params = dict(ELASTIC_TP_CFG, tensor_parallel=2)
    with torch.device("meta"):
        whole = zoo.custom_model(**ELASTIC_TP_CFG)
    profile = derive_model_profile(reference_state_leaves(
        whole, zoo.param_shardings(None, **params), zoo.optimizer()))
    budget = (profile.replicated_bytes + 0.75 * profile.tp_bytes) / 2 ** 20
    return budget, profile


def _tp_mesh(mesh_shape, rank):
    """A stand-in for ``rank``'s WorldMesh of ``mesh_shape`` (its axes'
    sizes and this rank's coordinates), without a process group."""
    import numpy as np

    from elasticdl_tpu_torch.parallel.mesh import Axis, WorldMesh

    class _Mesh(WorldMesh):
        def __init__(self):
            names = tuple(mesh_shape)
            sizes = tuple(mesh_shape[a] for a in names)
            self.axis_names = names
            self._axes = {a: Axis(a, n, c, (), None) for a, n, c in zip(
                names, sizes, np.unravel_index(rank, sizes))}

    return _Mesh()


def _tp_rank_params(leaves, rank, mesh_shape):
    """``rank``'s parts of a checkpoint's parameters (host tensors)."""
    from elasticdl_tpu_torch.parallel.mesh import shard_slices
    from elasticdl_tpu_torch.parallel.sharding import param_spec

    mesh = _tp_mesh(mesh_shape, rank)
    return {
        path[len("params/"):]: t[shard_slices(
            param_spec(path[len("params/"):], mesh), tuple(t.shape), mesh)]
        for path, t in leaves.items() if path.startswith("params/")
    }


def _tp_digest(leaves, rank, mesh_shape):
    from elasticdl_tpu_torch.parallel.elastic import state_digest
    from elasticdl_tpu_torch.training.step import TrainState

    return state_digest(TrainState(
        _tp_rank_params(leaves, rank, mesh_shape), {}, None))


class _TpCheckpoints:
    """The job's checkpoints as the checks read them: each one's
    parameters read once (``params/`` leaves only), and the whole LM
    built once, on the meta device, then placed on the card uninitialized
    (every forward is given its parameters)."""

    def __init__(self, torch, ckpt_dir):
        self._torch = torch
        self._dir = ckpt_dir
        self._params = {}
        self._forward = None

    def params(self, version):
        """{parameter path: host tensor} of ckpt_v{version}, or None
        when there is no such checkpoint."""
        from elasticdl_tpu_torch.common.sharded_checkpoint import (
            load_sharded_to_host,
        )

        if version not in self._params:
            directory = os.path.join(self._dir, "ckpt_v%d" % version)
            self._params[version] = (
                load_sharded_to_host(directory, prefix="params/")[1]
                if os.path.isdir(directory) else None)
        return self._params[version]

    def forward(self, version, tokens):
        """The whole LM's logits on the card from ckpt_v{version}."""
        import numpy as np

        from elasticdl_tpu_torch.model_zoo.transformer_lm import (
            transformer_lm as zoo,
        )
        from elasticdl_tpu_torch.parallel.trainer import (
            place_module,
            to_device,
        )
        from elasticdl_tpu_torch.training.step import make_forward_fn

        torch = self._torch
        if self._forward is None:
            with torch.device("meta"):
                model = zoo.custom_model(**ELASTIC_TP_CFG)
            place_module(model, DEVICE)
            self._forward = make_forward_fn(model)
        params = to_device({k[len("params/"):]: v for k, v in
                            self.params(version).items()}, DEVICE)
        return self._forward(params, {}, {"tokens": torch.as_tensor(
            np.asarray(tokens, np.int64)).to(DEVICE)})


def _run_elastic_tp_job(argv, timeline, ckpt_dir):
    """``cli.main(argv)``, the master in a thread of this process, worker
    1 SIGKILLed once both ranks' ckpt_v{ELASTIC_TP_KILL_AT} manifests are
    on disk. Returns (exit code, the job, successful task ids, the
    kill's wall time and the master's version then)."""
    import glob

    from elasticdl_tpu_torch import cli

    os.environ["EDL_WORKER_TIMELINE_DIR"] = timeline
    jobs, rc, errors = [], [], []

    def run():
        try:
            rc.append(cli.main(argv, jobs=jobs))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    runner = threading.Thread(target=run, daemon=True)
    runner.start()
    while not jobs and runner.is_alive():
        time.sleep(0.01)
    if not jobs:
        raise PhaseError("elastic_tp: the job did not start: %s" % errors)
    master = jobs[0].master
    done = []
    report = master.task_d.report

    def counting(task_id, success, exec_counters=None):
        if success:
            done.append(task_id)
        return report(task_id, success, exec_counters)

    master.task_d.report = counting
    deadline = time.time() + ELASTIC_TP_LIMIT_S
    manifests = os.path.join(ckpt_dir, "ckpt_v%d" % ELASTIC_TP_KILL_AT,
                             "manifest-*.json")
    while (len(glob.glob(manifests)) < 2 and runner.is_alive()
           and time.time() < deadline):
        time.sleep(0.005)
    killed = (time.time(), master.master_servicer.get_model_version())
    master.instance_manager.kill_worker(1)
    runner.join(max(1.0, deadline - time.time()))
    if runner.is_alive():
        master.request_stop()
        runner.join(30)
        raise PhaseError("elastic_tp: the job ran past %d s"
                         % ELASTIC_TP_LIMIT_S)
    if errors:
        raise PhaseError("elastic_tp: the job raised %r" % errors[0])
    return rc[0], jobs[0], done, killed


def _tp_staging_share(steps, key="copy_s"):
    """Median over a rank's live steps of the host staging's seconds
    (``copy_s``: the copies of the exchanges staged through the host;
    ``exchange_s``: the exchanges between the host buffers) over the
    host clock's step period."""
    shares = [b["staging"][key] / (b["t"] - a["t"])
              for a, b in zip(steps, steps[1:])
              if b.get("staging") and b["t"] > a["t"]]
    return _median(shares)


def phase_elastic_tp(torch, tmp, card):
    """transformer_lm's tensor-parallel shards on the elastic plane,
    through the port's command line: ``cli train --num_workers 3`` of the
    LM at ELASTIC_TP_CFG with ``tensor_parallel=2``, the master in this
    process and three worker processes on the card over gloo,
    ``--replica_refresh_steps 0``, a checkpoint every
    ELASTIC_TP_CKPT_STEPS versions (all kept) and an evaluation round
    every ELASTIC_TP_EVAL_STEPS. The layout solver's budget
    (``EDL_LAYOUT_MEM_BUDGET_MB``, below the whole model's state) makes
    every world of two data 1 x model 2. The first world forms of
    workers 0 and 1, worker 2 parks as a spare and hands its fetched
    tasks back; worker 1 is SIGKILLed once both ranks' ckpt_v4 manifests
    are on disk, the spare is promoted and the world re-forms at 2.

    Checks: each rank's parts after the re-form bitwise the restored
    checkpoint's, at its version; every task done once (none twice);
    each round whose scored version has a checkpoint within
    ELASTIC_TP_REL_L2 relative L2 of that checkpoint's whole-model
    forward on the card; each rank's final parts bitwise the newest
    checkpoint's; the SAVE_MODEL export's member within REPLY_ATOL of the
    whole model; no flash launch (64-token records: the plain attention)
    and no process left. Returns the launches by path."""
    import glob

    import numpy as np

    from elasticdl_tpu_torch.common.export import load_export

    problems = []
    torch.cuda.empty_cache()
    root = os.path.join(tmp, "elastic-tp")
    zoo_dir = os.path.join(root, "zoo", "lm_tp")
    os.makedirs(zoo_dir)
    with open(os.path.join(zoo_dir, "lm_tp.py"), "w") as f:
        f.write(ELASTIC_TP_ZOO)
    t0 = time.perf_counter()
    write_lm_records(os.path.join(root, "data"), ELASTIC_TP_RECORDS, SEED)
    val_tokens = write_lm_records(os.path.join(root, "val"),
                                  ELASTIC_TP_VAL_RECORDS, SEED + 1)
    write_s = time.perf_counter() - t0
    budget_mb, profile = _tp_budget_mb()
    ckpt_dir = os.path.join(root, "ckpt")
    argv = [
        "train", "--job_name", "chip-smoke-elastic-tp",
        "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", str(ELASTIC_TP_WORKERS),
        "--model_zoo", os.path.join(root, "zoo"),
        "--model_def", "lm_tp.lm_tp.custom_model",
        "--model_params", _tp_params(),
        "--training_data", os.path.join(root, "data"),
        "--validation_data", os.path.join(root, "val"),
        "--evaluation_steps", str(ELASTIC_TP_EVAL_STEPS),
        "--minibatch_size", str(ELASTIC_TP_BATCH),
        "--num_minibatches_per_task", "1", "--num_epochs", "1",
        "--checkpoint_dir", ckpt_dir,
        "--checkpoint_steps", str(ELASTIC_TP_CKPT_STEPS),
        "--keep_checkpoint_max", "0", "--replica_refresh_steps", "0",
        "--output", os.path.join(root, "export"),
        "--restart_policy", "Never", "--device", DEVICE,
        "--log_level", "WARNING",
    ]
    old_budget = os.environ.get("EDL_LAYOUT_MEM_BUDGET_MB")
    os.environ["EDL_LAYOUT_MEM_BUDGET_MB"] = repr(budget_mb)
    t0, wall0 = time.perf_counter(), time.time()
    try:
        with _EvalReports() as spy:
            rc, job, done, (killed_t, killed_v) = _run_elastic_tp_job(
                argv, os.path.join(root, "timeline"), ckpt_dir)
    finally:
        if old_budget is None:
            os.environ.pop("EDL_LAYOUT_MEM_BUDGET_MB", None)
        else:
            os.environ["EDL_LAYOUT_MEM_BUDGET_MB"] = old_budget
    job_s = time.perf_counter() - t0
    wall1 = time.time()
    events = _timeline_events(os.path.join(root, "timeline"))
    _note_worker_exports(events)
    manager = job.master.instance_manager
    if rc != 0:
        problems.append("exit code %s" % rc)
    if not job.master.task_d.finished():
        problems.append("the dispatcher has tasks left")
    exits = {str(k): v for k, v in manager.exit_codes.items()}
    if exits != {"0": 0, "1": -9, "2": 0}:
        problems.append("worker exits %s" % exits)
    published = job.master.evaluation_service.published
    training_tasks = ELASTIC_TP_RECORDS // ELASTIC_TP_BATCH
    want_done = training_tasks + 1 + len(published)
    dup = len(done) - len(set(done))
    if len(set(done)) != want_done or dup:
        problems.append("%d task completions (%d twice), expected %d once"
                        % (len(done), dup, want_done))
    alive = [p for p in _descendants() if not _own_tracker(p)]
    if alive:
        problems.append("processes alive after the job: %s" % alive)
    # the spare: parked, its fetched tasks handed back, then promoted
    spare = events.get(2, [])
    kinds = [e["event"] for e in spare]
    if "spare" not in kinds or "established" not in kinds or (
            kinds.index("spare") > kinds.index("established")):
        problems.append("worker 2 did not park as a spare before it joined:"
                        " %s" % kinds)
    first = [e for w in (0, 1) for e in _of(events.get(w, []),
                                             "established")
             if e["t"] < killed_t]
    reformed = [e for w in (0, 2) for e in _of(events.get(w, []),
                                                "established")
                if e["t"] >= killed_t]
    for e in first + reformed:
        if e["mesh"] != {"data": 1, "model": 2}:
            problems.append("world %d laid out %s" % (e["epoch"], e["mesh"]))
    ckpts = _TpCheckpoints(torch, ckpt_dir)
    checks_s = {}
    t0 = time.perf_counter()
    restore = {}
    if sorted(e["rank"] for e in reformed) != [0, 1]:
        problems.append("the re-formed world's ranks: %s"
                        % [(e["rank"], e["epoch"]) for e in reformed])
    else:
        directory = reformed[0]["restored_from"]
        version = int(os.path.basename(directory)[len("ckpt_v"):])
        bitwise = all(
            e["restored_from"] == directory
            and e["restored_version"] == version
            and e["digest"] == _tp_digest(ckpts.params(version), e["rank"],
                                          e["mesh"])
            for e in reformed)
        if version < ELASTIC_TP_KILL_AT or not bitwise:
            problems.append("the re-formed world restored %s, bitwise %s"
                            % (directory, bitwise))
        if any(e["version"] < version for e in reformed):
            problems.append("the version clock went back from v%d: %s"
                            % (version, [e["version"] for e in reformed]))
        reepoch = reformed[0]["epoch"]
        lead = [w for w in (0, 2) for e in _of(events.get(w, []),
                                                "established")
                if e["epoch"] == reepoch and e["rank"] == 0][0]
        after = [s for s in _of(events[lead], "step")
                 if s["epoch"] == reepoch]
        restore = {
            "restored_from": os.path.basename(directory),
            "restored_version": version,
            "version_after_reform": reformed[0]["version"],
            "bitwise": bitwise,
            "killed_at_master_version": killed_v,
            "establish": {str(e["rank"]): {
                k: v for k, v in e.items()
                if k.endswith("_s") and isinstance(v, float)}
                for e in reformed},
            "kill_to_first_step_s": (after[0]["t"] - killed_t
                                     if after else None),
        }
    checks_s["restore"] = time.perf_counter() - t0
    # evaluation: each round whose scored version has a checkpoint
    t0 = time.perf_counter()
    rounds = []
    for version, scored, out, labels in spy.reports:
        rec = {"version": version, "scored_version": scored,
               "rows": int(len(labels))}
        if ckpts.params(scored) is not None:
            want = ckpts.forward(scored, labels)
            rec["rel_l2"] = _rel_l2(torch, torch.as_tensor(
                np.asarray(out)).to(DEVICE), want)
            if rec["rel_l2"] > ELASTIC_TP_REL_L2:
                problems.append("round v%d: outputs %s from ckpt_v%d's "
                                "whole-model forward"
                                % (version, rec["rel_l2"], scored))
        rounds.append(rec)
    if not any("rel_l2" in r for r in rounds):
        problems.append("no round scored a version that has a checkpoint")
    if len(published) < 3:
        problems.append("%d rounds published" % len(published))
    checks_s["rounds"] = time.perf_counter() - t0
    # the final state and the export
    t0 = time.perf_counter()
    final_v = max(int(os.path.basename(d)[len("ckpt_v"):])
                  for d in glob.glob(os.path.join(ckpt_dir, "ckpt_v*")))
    final_params = ckpts.params(final_v)
    finals = {w: _of(events.get(w, []), "final") for w in (0, 2)}
    final_ok = all(finals[w] for w in finals)
    ranks = {w: [e for e in _of(events[w], "established")
                 if e["t"] >= killed_t] for w in finals}
    if final_ok:
        final_ok = all(
            finals[w][0]["version"] == final_v
            and finals[w][0]["digest"] == _tp_digest(
                final_params, ranks[w][-1]["rank"], ranks[w][-1]["mesh"])
            for w in finals)
    if not final_ok:
        problems.append("final parts are not ckpt_v%d's" % final_v)
    checks_s["final"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    exports = glob.glob(os.path.join(root, "export", "*", "MANIFEST.json"))
    export_rec = {}
    if len(exports) != 1:
        problems.append("%d export manifests" % len(exports))
    else:
        artifact = load_export(os.path.dirname(exports[0]))
        served = artifact.serve({"tokens": val_tokens.astype(np.int32)},
                                DEVICE).float()
        whole = ckpts.forward(final_v, val_tokens).float()
        err = float((served - whole).abs().max())
        export_rec = {"version": artifact.manifest.get("model_version"),
                      "serving_member": bool(
                          artifact.manifest["artifacts"]["torch_serving_fn"]),
                      "max_abs_err": err}
        if err > REPLY_ATOL or not export_rec["serving_member"]:
            problems.append("the export's member: %s" % export_rec)
    checks_s["export"] = time.perf_counter() - t0
    # records
    whole_bytes = sum(t.numel() * t.element_size()
                      for t in final_params.values())
    share = {}
    for rank in (0, 1):
        part = _tp_rank_params(final_params, rank, {"data": 1, "model": 2})
        share[str(rank)] = sum(t.numel() * t.element_size()
                               for t in part.values()) / whole_bytes
    first_epoch = min((e["epoch"] for e in first), default=None)
    launches = {name: 0 for name in KERNELS}
    for w, f in finals.items():
        for e in f:
            for name, n in e["launches"].items():
                launches[name] += n
    lead0 = [s for s in _of(events.get(0, []), "step")
             if s["live"] > 0 and s["epoch"] == first_epoch]
    steps_all = sorted(st["t"] for ev in events.values()
                       for st in _of(ev, "step"))
    # where the job's seconds go: each worker's boot to its first world,
    # the steps before and after the kill, the tail after the last step
    # (the final rounds, the export, the master's linger)
    seconds = {
        "boot_s": {str(w): _of(ev, "established")[0]["t"] - wall0
                   for w, ev in sorted(events.items())
                   if _of(ev, "established")},
        "first_world_establish": {
            str(e["rank"]): {k: v for k, v in e.items()
                             if k.endswith("_s") and isinstance(v, float)}
            for e in first},
        "first_step_s": steps_all[0] - wall0 if steps_all else None,
        "steps_before_kill_s": (killed_t - lead0[0]["t"]) if lead0 else None,
        "last_step_to_job_end_s": wall1 - steps_all[-1] if steps_all
        else None,
        "spare_warm_s": [e.get("warmed") for e in _of(spare, "spare")],
        "export_s": [e["seconds"] for ev in events.values()
                     for e in _of(ev, "export")],
    }
    rec = {
        "phase": "elastic_tp",
        "card": card,
        "model": "transformer_lm %s, tensor_parallel=2 (bf16 compute, "
                 "params float32)" % ELASTIC_TP_CFG,
        "workers": ELASTIC_TP_WORKERS,
        "records": ELASTIC_TP_RECORDS,
        "batch_per_rank": ELASTIC_TP_BATCH,
        "tokens_per_record": 64,
        "budget_mb": budget_mb,
        "profile": profile.__dict__,
        "write_records_s": write_s,
        "job_s": job_s,
        "job_seconds": seconds,
        "checks_s": checks_s,
        "exit_codes": exits,
        "tasks_done": len(done),
        "tasks_done_twice": dup,
        "rounds": rounds,
        "restore": restore,
        "final_version": final_v,
        "final_parts_bitwise": final_ok,
        "export": export_rec,
        "param_bytes_share_by_rank": share,
        "peak_mib_by_worker": {str(w): f[0].get("peak_mib")
                               for w, f in finals.items() if f},
        "tokens_per_s_before_kill": (
            _examples_per_s(events, first_epoch) or 0.0) * 64
        if first_epoch is not None else None,
        "tokens_per_s_after_kill": (
            (_examples_per_s(events, reformed[0]["epoch"]) or 0.0) * 64
            if reformed else None),
        "host_staging_share_of_step": _tp_staging_share(lead0),
        "host_exchange_share_of_step": _tp_staging_share(lead0,
                                                         "exchange_s"),
        "step_period_ms": 1e3 * (_median([b["t"] - a["t"] for a, b in
                                          zip(lead0, lead0[1:])]) or 0.0),
        "staging_bytes_per_step": _median(
            [s["staging"]["staged_bytes"] for s in lead0
             if s.get("staging")]),
        "flash_launches": launches,
    }
    emit(rec)
    if problems:
        raise PhaseError("elastic_tp: %s" % "; ".join(problems))
    return {"elastic_tp": {name: (n, []) for name, n in launches.items()}}


def _elastic_tp_only(torch):
    try:
        card = phase_device(torch)
        with tempfile.TemporaryDirectory() as tmp:
            paths = _run_phase("elastic_tp", phase_elastic_tp, torch, tmp,
                               card)
        for path, counts in paths.items():
            _check_counts(counts, {k: 0 for k in KERNELS}, path)
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    emit(timing_record())
    print(card)
    return 0


# ---------------------------------------------------------------------------
# elastic_collective: deepfm_edl's vocabulary-split tables on the elastic
# collective plane
# ---------------------------------------------------------------------------

# deepfm_edl at the zoo's widths (tables of ZOO_VOCAB x 64 and ZOO_VOCAB x
# 1, f32), three workers: the first world pads each table to 1,048,578
# rows (349,526 a rank), the re-formed world of two holds 524,288 a rank
ELASTIC_COLLECTIVE_WORKERS = 3
ELASTIC_COLLECTIVE_KILL_AT = 4  # once all three ranks' ckpt_v4 manifests
# 4 versions at three ranks before the kill (the steps past ckpt_v4 are
# lost with it, their tasks queued again), 4 at two after: 12 read
# 50.8 s for the phase on a slow host, over its 35 s budget
ELASTIC_COLLECTIVE_VERSIONS = 8
ELASTIC_COLLECTIVE_RECORDS = PS_BATCH * (
    3 * ELASTIC_COLLECTIVE_KILL_AT
    + 2 * (ELASTIC_COLLECTIVE_VERSIONS - ELASTIC_COLLECTIVE_KILL_AT))
ELASTIC_COLLECTIVE_VAL_RECORDS = PS_BATCH  # one evaluation task a round
ELASTIC_COLLECTIVE_CKPT_STEPS = 2
ELASTIC_COLLECTIVE_EVAL_STEPS = 4
ELASTIC_COLLECTIVE_LIMIT_S = 240  # a run that hangs fails the phase
ELASTIC_COLLECTIVE_REL_L2 = 1e-5  # f32: a round's logits against its ckpt
# The zoo module the job names: deepfm_edl, its records parsed as the zoo
# parses them, without the training shuffle (with a 1,024-record buffer
# in each worker, the first worker to prime would take every task)
ELASTIC_COLLECTIVE_ZOO = textwrap.dedent(
    """
    from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding.deepfm_edl_embedding import *  # noqa
    from elasticdl_tpu_torch.model_zoo.deepfm_functional_api.deepfm_functional_api import (  # noqa
        FixedLenFeature, Mode, np, parse_example)


    def dataset_fn(dataset, mode, _):
        spec = {"feature": FixedLenFeature([10], np.int64)}
        if mode != Mode.PREDICTION:
            spec["label"] = FixedLenFeature([1], np.int64)

        def _parse_data(record):
            r = parse_example(record, spec)
            features = {"feature": r["feature"].astype(np.int64)}
            if mode == Mode.PREDICTION:
                return features
            return features, r["label"].astype(np.int32)

        return dataset.map(_parse_data)
    """
)


def _collective_parts_digest(leaves, rank, n):
    """The state digest of ``rank``'s parameter parts in a world of
    ``n`` (the tables' logical rows padded to a multiple of ``n``), from
    a checkpoint's host leaves."""
    import torch

    from elasticdl_tpu_torch.parallel.elastic import state_digest
    from elasticdl_tpu_torch.training.step import TrainState

    params = {}
    for path, t in leaves.items():
        name = path[len("params/"):]
        if name.endswith(".table"):
            rows = -(-t.shape[0] // n)
            t = t[rank * rows:(rank + 1) * rows]
            if t.shape[0] < rows:  # the padding rows read zero
                t = torch.cat([t, t.new_zeros((rows - t.shape[0],)
                                              + tuple(t.shape[1:]))])
        params[name] = t
    return state_digest(TrainState(params, {}, None))


class _CollectiveCheckpoints:
    """The job's checkpoints as the checks read them: each one's
    parameters read once (clipped to the logical rows), and the host twin
    built once on the card (every forward is given its parameters)."""

    def __init__(self, torch, ckpt_dir):
        self._torch = torch
        self._dir = ckpt_dir
        self._params = {}
        self._forward = None

    def params(self, version):
        """{parameter path: host tensor} of ckpt_v{version}, or None
        when there is no such checkpoint."""
        from elasticdl_tpu_torch.common.sharded_checkpoint import (
            load_sharded_to_host,
        )

        if version not in self._params:
            directory = os.path.join(self._dir, "ckpt_v%d" % version)
            self._params[version] = (
                load_sharded_to_host(directory, prefix="params/")[1]
                if os.path.isdir(directory) else None)
        return self._params[version]

    def forward(self, version, features):
        """The host twin's outputs on the card from ckpt_v{version}."""
        from elasticdl_tpu_torch.common.model_utils import (
            get_dict_from_params_str,
        )
        from elasticdl_tpu_torch.model_zoo.deepfm_edl_embedding import (
            deepfm_edl_embedding as zoo,
        )
        from elasticdl_tpu_torch.parallel.trainer import (
            place_module,
            to_device,
        )
        from elasticdl_tpu_torch.training.step import make_forward_fn

        torch = self._torch
        if self._forward is None:
            with torch.device("meta"):
                model = zoo.build_host_model(
                    **get_dict_from_params_str(COLLECTIVE_PARAMS))
            place_module(model, DEVICE)
            self._forward = make_forward_fn(model)
        params = to_device({k[len("params/"):]: v for k, v in
                            self.params(version).items()}, DEVICE)
        return self._forward(params, {}, to_device(features, DEVICE))


def _write_collective_records(data_dir, n, seed):
    """``n`` zipf records (``_zipf_ids``) of 10 ids and a label; returns
    (ids, labels)."""
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    os.makedirs(data_dir, exist_ok=True)
    ids, labels = _zipf_ids(n, seed)
    with RecordIOWriter(os.path.join(data_dir, "f0")) as w:
        for row, label in zip(ids, labels):
            w.write(encode_example({"feature": row,
                                    "label": label.reshape(1)}))
    return ids, labels.reshape(-1, 1)


def _run_collective_job(argv, timeline, ckpt_dir):
    """``cli.main(argv)``, the master in a thread of this process, worker
    1 SIGKILLed once all three ranks' ckpt_v{ELASTIC_COLLECTIVE_KILL_AT}
    manifests are on disk. Returns (exit code, the job, successful task
    ids, the kill's wall time and the master's version then)."""
    import glob

    from elasticdl_tpu_torch import cli

    os.environ["EDL_WORKER_TIMELINE_DIR"] = timeline
    jobs, rc, errors = [], [], []

    def run():
        try:
            rc.append(cli.main(argv, jobs=jobs))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    runner = threading.Thread(target=run, daemon=True)
    runner.start()
    while not jobs and runner.is_alive():
        time.sleep(0.01)
    if not jobs:
        raise PhaseError("elastic_collective: the job did not start: %s"
                         % errors)
    master = jobs[0].master
    done = []
    report = master.task_d.report

    def counting(task_id, success, exec_counters=None):
        if success:
            done.append(task_id)
        return report(task_id, success, exec_counters)

    master.task_d.report = counting
    deadline = time.time() + ELASTIC_COLLECTIVE_LIMIT_S
    manifests = os.path.join(ckpt_dir, "ckpt_v%d" % ELASTIC_COLLECTIVE_KILL_AT,
                             "manifest-*.json")
    while (len(glob.glob(manifests)) < ELASTIC_COLLECTIVE_WORKERS
           and runner.is_alive() and time.time() < deadline):
        time.sleep(0.005)
    killed = (time.time(), master.master_servicer.get_model_version())
    master.instance_manager.kill_worker(1)
    runner.join(max(1.0, deadline - time.time()))
    if runner.is_alive():
        master.request_stop()
        runner.join(30)
        raise PhaseError("elastic_collective: the job ran past %d s"
                         % ELASTIC_COLLECTIVE_LIMIT_S)
    if errors:
        raise PhaseError("elastic_collective: the job raised %r" % errors[0])
    return rc[0], jobs[0], done, killed


def _manifest_parts(ckpt_dir, version):
    """{process: (stored rows, logical rows, its rows' slice)} of
    ckpt_v{version}'s embedding table, from the manifests."""
    import glob

    parts = {}
    for path in glob.glob(os.path.join(ckpt_dir, "ckpt_v%d" % version,
                                       "manifest-*.json")):
        with open(path) as f:
            entry = json.load(f)["leaves"]["params/embedding.table"]
        pid = int(os.path.basename(path)[len("manifest-"):-len(".json")])
        parts[pid] = (entry["shape"][0], entry.get("logical_dim0"),
                      entry["shards"][0]["slices"][0])
    return parts


def _collective_step_split(steps):
    """The median share of a rank's step period, over its live steps, of
    the routed exchanges (the lookups' all_to_all, host copies
    excluded), the tower's SUM (the flat all-reduce, its gloo exchange
    included), the host copies of every staged exchange, and the rest."""
    shares = {"routed_exchanges": [], "tower_sum": [], "host_copies": [],
              "rest": []}
    for a, b in zip(steps, steps[1:]):
        period = b["t"] - a["t"]
        staging, split = b.get("staging") or {}, b.get("split") or {}
        if period <= 0 or not staging or not split:
            continue
        routed = staging.get("by_kind", {}).get("all_to_all", {})
        parts = {"routed_exchanges": routed.get("exchange_s", 0.0),
                 "tower_sum": split.get("allreduce_s", 0.0),
                 "host_copies": staging.get("copy_s", 0.0)}
        parts["rest"] = period - sum(parts.values())
        for key, v in parts.items():
            shares[key].append(v / period)
    return {key: _median(v) for key, v in shares.items()}


def phase_elastic_collective(torch, tmp, card):
    """deepfm_edl's vocabulary-split HBM tables on the elastic collective
    plane, through the port's command line: ``cli train --num_workers 3``
    of deepfm_edl at the zoo's widths, the master in this process and
    three worker processes on the card over gloo,
    ``--replica_refresh_steps 0``, a checkpoint every
    ELASTIC_COLLECTIVE_CKPT_STEPS versions (all kept), a round every
    ELASTIC_COLLECTIVE_EVAL_STEPS over PS_BATCH validation records, on
    PS_BATCH zipf records a rank a step. The first world of three pads
    each table to 1,048,578 rows (349,526 a rank); worker 1 is SIGKILLed
    once all three ranks' ckpt_v4 manifests are on disk, and the world
    re-forms at 2 (524,288 rows a rank) from the newest checkpoint all
    can read, across the paddings.

    Checks: the first world's and the re-formed one's meshes and each
    rank's rows (the manifests); each rank's parts after the re-form
    bitwise the restored checkpoint's logical rows for its range, the
    version going on from it; every task done once (none twice); each
    round whose scored version has a checkpoint within
    ELASTIC_COLLECTIVE_REL_L2 of the host twin's forward on that
    checkpoint's clipped tables, its accuracy and AUC equal; each rank's
    final parts bitwise the newest checkpoint's; the SAVE_MODEL member
    within REPLY_ATOL of the host twin; no overflow, no flash launch and
    no process left. Returns the launches by path."""
    import glob

    import numpy as np

    from elasticdl_tpu_torch.common.export import load_export
    from elasticdl_tpu_torch.metrics import AUC

    problems = []
    torch.cuda.empty_cache()
    root = os.path.join(tmp, "elastic-collective")
    zoo_dir = os.path.join(root, "zoo", "edl")
    os.makedirs(zoo_dir)
    with open(os.path.join(zoo_dir, "edl.py"), "w") as f:
        f.write(ELASTIC_COLLECTIVE_ZOO)
    t0 = time.perf_counter()
    _write_collective_records(os.path.join(root, "data"),
                              ELASTIC_COLLECTIVE_RECORDS, SEED + 80)
    val_ids, val_labels = _write_collective_records(
        os.path.join(root, "val"), ELASTIC_COLLECTIVE_VAL_RECORDS, SEED + 81)
    write_s = time.perf_counter() - t0
    ckpt_dir = os.path.join(root, "ckpt")
    argv = [
        "train", "--job_name", "chip-smoke-elastic-collective",
        "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", str(ELASTIC_COLLECTIVE_WORKERS),
        "--model_zoo", os.path.join(root, "zoo"),
        "--model_def", "edl.edl.custom_model",
        "--model_params", COLLECTIVE_PARAMS,
        "--training_data", os.path.join(root, "data"),
        "--validation_data", os.path.join(root, "val"),
        "--evaluation_steps", str(ELASTIC_COLLECTIVE_EVAL_STEPS),
        "--minibatch_size", str(PS_BATCH),
        "--num_minibatches_per_task", "1", "--num_epochs", "1",
        "--checkpoint_dir", ckpt_dir,
        "--checkpoint_steps", str(ELASTIC_COLLECTIVE_CKPT_STEPS),
        "--keep_checkpoint_max", "0", "--replica_refresh_steps", "0",
        "--output", os.path.join(root, "export"),
        "--restart_policy", "Never", "--device", DEVICE,
        "--log_level", "WARNING",
    ]
    t0, wall0 = time.perf_counter(), time.time()
    with _EvalReports() as spy:
        rc, job, done, (killed_t, killed_v) = _run_collective_job(
            argv, os.path.join(root, "timeline"), ckpt_dir)
    job_s = time.perf_counter() - t0
    events = _timeline_events(os.path.join(root, "timeline"))
    _note_worker_exports(events)
    manager = job.master.instance_manager
    if rc != 0:
        problems.append("exit code %s" % rc)
    if not job.master.task_d.finished():
        problems.append("the dispatcher has tasks left")
    exits = {str(k): v for k, v in manager.exit_codes.items()}
    if exits != {"0": 0, "1": -9, "2": 0}:
        problems.append("worker exits %s" % exits)
    published = job.master.evaluation_service.published
    training_tasks = ELASTIC_COLLECTIVE_RECORDS // PS_BATCH
    want_done = training_tasks + 1 + len(published)
    dup = len(done) - len(set(done))
    if len(set(done)) != want_done or dup:
        problems.append("%d task completions (%d twice), expected %d once"
                        % (len(done), dup, want_done))
    alive = [p for p in _descendants() if not _own_tracker(p)]
    if alive:
        problems.append("processes alive after the job: %s" % alive)
    first = [e for w in (0, 1, 2) for e in _of(events.get(w, []),
                                                "established")
             if e["t"] < killed_t]
    reformed = [e for w in (0, 2) for e in _of(events.get(w, []),
                                                "established")
                if e["t"] >= killed_t]
    for e in first:
        if e["mesh"] != {"data": 3}:
            problems.append("world %d laid out %s" % (e["epoch"], e["mesh"]))
    for e in reformed:
        if e["mesh"] != {"data": 2}:
            problems.append("world %d laid out %s" % (e["epoch"], e["mesh"]))
    ckpts = _CollectiveCheckpoints(torch, ckpt_dir)
    checks_s = {}
    t0 = time.perf_counter()
    # each world's rows a rank, from the manifests the ranks wrote
    rows3 = -(-ZOO_VOCAB // 3)
    at3 = _manifest_parts(ckpt_dir, ELASTIC_COLLECTIVE_KILL_AT)
    layout = {"at_3": at3}
    if at3 != {r: (3 * rows3, ZOO_VOCAB, [r * rows3, (r + 1) * rows3])
               for r in range(3)}:
        problems.append("ckpt_v%d's table parts: %s"
                        % (ELASTIC_COLLECTIVE_KILL_AT, at3))
    restore = {}
    if sorted(e["rank"] for e in reformed) != [0, 1]:
        problems.append("the re-formed world's ranks: %s"
                        % [(e["rank"], e["epoch"]) for e in reformed])
    else:
        directory = reformed[0]["restored_from"]
        version = int(os.path.basename(directory)[len("ckpt_v"):])
        restored = ckpts.params(version)
        bitwise = all(
            e["restored_from"] == directory
            and e["restored_version"] == version
            and e["digest"] == _collective_parts_digest(restored, e["rank"],
                                                        2)
            for e in reformed)
        if version < ELASTIC_COLLECTIVE_KILL_AT or not bitwise:
            problems.append("the re-formed world restored %s, bitwise %s"
                            % (directory, bitwise))
        if any(e["version"] != version for e in reformed):
            problems.append("the version after the re-form: %s, not v%d"
                            % ([e["version"] for e in reformed], version))
        reepoch = reformed[0]["epoch"]
        lead = [w for w in (0, 2) for e in _of(events.get(w, []),
                                                "established")
                if e["epoch"] == reepoch and e["rank"] == 0][0]
        after = [s for s in _of(events[lead], "step")
                 if s["epoch"] == reepoch]
        final_v = max(int(os.path.basename(d)[len("ckpt_v"):])
                      for d in glob.glob(os.path.join(ckpt_dir, "ckpt_v*")))
        at2 = _manifest_parts(ckpt_dir, final_v)
        layout["at_2"] = at2
        if at2 != {r: (ZOO_VOCAB, None, [r * (ZOO_VOCAB // 2),
                                         (r + 1) * (ZOO_VOCAB // 2)])
                   for r in range(2)}:
            problems.append("ckpt_v%d's table parts: %s" % (final_v, at2))
        restore = {
            "restored_from": os.path.basename(directory),
            "restored_version": version,
            "versions_after_reform": [e["version"] for e in reformed],
            "bitwise": bitwise,
            "killed_at_master_version": killed_v,
            "establish": {str(e["rank"]): {
                k: v for k, v in e.items()
                if k.endswith("_s") and isinstance(v, float)}
                for e in reformed},
            "kill_to_first_step_s": (after[0]["t"] - killed_t
                                     if after else None),
        }
    checks_s["restore"] = time.perf_counter() - t0
    # evaluation: each round whose scored version has a checkpoint
    t0 = time.perf_counter()
    rounds = []
    features = {"feature": val_ids}
    for version, scored, out, labels in spy.keyed:
        rec = {"version": version, "scored_version": scored,
               "rows": int(len(labels))}
        if scored is not None and ckpts.params(scored) is not None:
            want = ckpts.forward(scored, features)
            rec["rel_l2"] = _rel_l2(torch, torch.as_tensor(
                np.asarray(out["logits"])).to(DEVICE), want["logits"])
            logits = want["logits"].cpu().numpy()
            rec["accuracy"] = float(np.mean(
                (logits > 0).astype(np.int32) == val_labels.reshape(-1)))
            auc = AUC()
            auc.update_state(val_labels, want["probs"].cpu().numpy())
            rec["auc"] = float(auc.result())
            (round_,) = [p for p in published if p["version"] == version]
            rec["published"] = round_["metrics"]
            if (rec["rel_l2"] > ELASTIC_COLLECTIVE_REL_L2
                    or round_["metrics"]["logits"]["accuracy"]
                    != rec["accuracy"]
                    or round_["metrics"]["probs"]["auc"] != rec["auc"]):
                problems.append("round v%d against ckpt_v%d's host twin: "
                                "%s" % (version, scored, rec))
        rounds.append(rec)
    if not any("rel_l2" in r for r in rounds):
        problems.append("no round scored a version that has a checkpoint")
    checks_s["rounds"] = time.perf_counter() - t0
    # the final state and the export
    t0 = time.perf_counter()
    final_v = max(int(os.path.basename(d)[len("ckpt_v"):])
                  for d in glob.glob(os.path.join(ckpt_dir, "ckpt_v*")))
    final_params = ckpts.params(final_v)
    finals = {w: _of(events.get(w, []), "final") for w in (0, 2)}
    final_ok = all(finals[w] for w in finals)
    ranks = {w: [e for e in _of(events[w], "established")
                 if e["t"] >= killed_t] for w in finals}
    if final_ok:
        final_ok = all(
            finals[w][0]["version"] == final_v
            and finals[w][0]["digest"] == _collective_parts_digest(
                final_params, ranks[w][-1]["rank"], 2)
            for w in finals)
    if not final_ok:
        problems.append("final parts are not ckpt_v%d's" % final_v)
    overflow = {str(w): f[0].get("overflow") for w, f in finals.items() if f}
    if any(v != 0 for v in overflow.values()):
        problems.append("overflowed ids: %s" % overflow)
    checks_s["final"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    exports = glob.glob(os.path.join(root, "export", "*", "MANIFEST.json"))
    export_rec = {}
    if len(exports) != 1:
        problems.append("%d export manifests" % len(exports))
    else:
        artifact = load_export(os.path.dirname(exports[0]))
        served = artifact.serve(features, DEVICE)
        whole = ckpts.forward(final_v, features)
        err = float((torch.as_tensor(served["logits"]).to(DEVICE).float()
                     - whole["logits"].float()).abs().max())
        export_rec = {"version": artifact.manifest.get("model_version"),
                      "serving_member": bool(
                          artifact.manifest["artifacts"]["torch_serving_fn"]),
                      "max_abs_err": err}
        if (err > REPLY_ATOL or not export_rec["serving_member"]
                or export_rec["version"] != final_v):
            problems.append("the export's member: %s" % export_rec)
    checks_s["export"] = time.perf_counter() - t0
    # records
    first_epoch = min((e["epoch"] for e in first), default=None)
    launches = {name: 0 for name in KERNELS}
    for w, f in finals.items():
        for e in f:
            for name, n in e["launches"].items():
                launches[name] += n
    steps = {w: [s for s in _of(ev, "step") if s["live"] > 0]
             for w, ev in events.items()}
    lead0 = [s for s in steps.get(0, []) if s["epoch"] == first_epoch]
    lead2 = ([s for s in steps.get(lead, []) if s["epoch"] == reepoch]
             if restore else [])
    routed = [s["routing"] for ev in steps.values() for s in ev
              if s.get("routing")]
    by_world = {}
    for name, world in (("at_3", first), ("at_2", reformed)):
        by_world[name] = {
            str(e["worker"]): {
                "split_bytes": e.get("split_bytes"),
                "peak_mib": max([s.get("peak_mib") or 0 for s in
                                 steps.get(e["worker"], [])
                                 if s["epoch"] == e["epoch"]] or [None]),
            } for e in world}
    steps_all = sorted(st["t"] for ev in events.values()
                       for st in _of(ev, "step"))
    seconds = {
        "boot_s": {str(w): _of(ev, "established")[0]["t"] - wall0
                   for w, ev in sorted(events.items())
                   if _of(ev, "established")},
        "first_world_establish": {
            str(e["rank"]): {k: v for k, v in e.items()
                             if k.endswith("_s") and isinstance(v, float)}
            for e in first},
        "first_step_s": steps_all[0] - wall0 if steps_all else None,
        "last_step_to_job_end_s": time.time() - steps_all[-1]
        if steps_all else None,
        "export_s": [e["seconds"] for ev in events.values()
                     for e in _of(ev, "export")],
    }
    rec = {
        "phase": "elastic_collective",
        "card": card,
        "model": "deepfm_edl_embedding %s (f32), build_collective_model"
                 % COLLECTIVE_PARAMS,
        "workers": ELASTIC_COLLECTIVE_WORKERS,
        "records": ELASTIC_COLLECTIVE_RECORDS,
        "batch_per_rank": PS_BATCH,
        "write_records_s": write_s,
        "job_s": job_s,
        "job_seconds": seconds,
        "checks_s": checks_s,
        "exit_codes": exits,
        "tasks_done": len(done),
        "tasks_done_twice": dup,
        "layout": {k: {str(p): v for p, v in parts.items()}
                   for k, parts in layout.items()},
        "rounds": rounds,
        "restore": restore,
        "final_version": final_v,
        "final_parts_bitwise": final_ok,
        "export": export_rec,
        "overflow_by_worker": overflow,
        "bytes_and_peak_by_world": by_world,
        "examples_per_s_before_kill": _examples_per_s(events, first_epoch)
        if first_epoch is not None else None,
        "examples_per_s_after_kill": (
            _examples_per_s(events, reformed[0]["epoch"])
            if reformed else None),
        "step_split_before_kill": _collective_step_split(lead0),
        "step_split_after_kill": _collective_step_split(lead2),
        "step_period_ms": 1e3 * (_median([b["t"] - a["t"] for a, b in
                                          zip(lead0, lead0[1:])]) or 0.0),
        "routed_ids": {
            "routed": sum(r["routed"] for r in routed),
            "occurrences": sum(r["occurrences"] for r in routed),
        },
        "flash_launches": launches,
    }
    emit(rec)
    if problems:
        raise PhaseError("elastic_collective: %s" % "; ".join(problems))
    return {"elastic_collective": {name: (n, []) for name, n in
                                   launches.items()}}


def _elastic_collective_only(torch):
    try:
        card = _run_phase("device", phase_device, torch)
        _run_phase("build", phase_build)
        with tempfile.TemporaryDirectory() as tmp:
            paths = _run_phase("elastic_collective",
                               phase_elastic_collective, torch, tmp, card)
        for path, counts in paths.items():
            _check_counts(counts, {k: 0 for k in KERNELS}, path)
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    emit(timing_record())
    print(card)
    return 0


def kernels_line(records, paths):
    """The contract line: each kernel with its launches summed over the
    main paths (``paths``: {path: counts}), at the shape those paths
    launched it at most, with that shape's checked record."""
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        by_path = {path: c[name][0] for path, c in paths.items()}
        shapes = {}
        for c in paths.values():
            for key, n in c[name][1].items():
                shapes[key] = shapes.get(key, 0) + n
        key = max(shapes, key=shapes.get)
        rec = _record_at(records, name, key)
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "shape": rec["shape"],
                "dtype": rec["dtype"],
                "causal": rec["causal"],
                "max_abs_err": rec["max_abs_err"],
                "rel_l2": rec["rel_l2"],
                "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                "device_ms": rec.get("kernel_device_ms"),
                "library_device_ms": rec.get("library_device_ms"),
                "checked_cases": sum(1 for r in records if r["kernel"] == name),
                "ok": True,
            }
        )
    return {"kernels": kernels}


def _elastic_only(torch):
    try:
        card = phase_device(torch)
        with tempfile.TemporaryDirectory() as tmp:
            elastic, _ = phase_elastic(torch, tmp, {"examples_per_s": None},
                                       card)
        for path, counts in elastic.items():
            _check_counts(counts, {k: 0 for k in KERNELS}, path)
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    print(card)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--elastic-only",
        action="store_true",
        help="drive only the elastic phase and print its records, not the "
        "result line: on a host with a card for each of its workers, they "
        "form an NCCL world",
    )
    parser.add_argument(
        "--elastic-tp-only",
        action="store_true",
        help="drive only the elastic_tp phase (transformer_lm's "
        "tensor-parallel shards on the elastic plane) and print its "
        "records, not the result line",
    )
    parser.add_argument(
        "--elastic-collective-only",
        action="store_true",
        help="drive only the elastic_collective phase (deepfm_edl's "
        "vocabulary-split tables on the elastic collective plane, after "
        "device and build) and print its records, not the result line",
    )
    parser.add_argument(
        "--zoo-only",
        action="store_true",
        help="drive only the zoo phase and print its records, not the "
        "result line",
    )
    parser.add_argument(
        "--ps-only",
        action="store_true",
        help="drive only the ps phase and print its records, not the "
        "result line",
    )
    parser.add_argument(
        "--ps-fleet-only",
        action="store_true",
        help="drive only the ps_fleet phase and print its records, not "
        "the result line",
    )
    parser.add_argument(
        "--ps-tiers-only",
        action="store_true",
        help="drive only the ps_tiers phase and print its records, not "
        "the result line",
    )
    parser.add_argument(
        "--ps-hybrid-only",
        action="store_true",
        help="drive only the ps_hybrid phase and print its records, not "
        "the result line",
    )
    parser.add_argument(
        "--ps-serve-only",
        action="store_true",
        help="drive only the ps_serve phase and print its records, not "
        "the result line",
    )
    parser.add_argument(
        "--wire-only",
        action="store_true",
        help="drive only the wire phase and print its records, not the "
        "result line",
    )
    parser.add_argument(
        "--overhead-only",
        action="store_true",
        help="run only the telemetry plane's overhead A/B and print its "
        "record, not the result line",
    )
    parser.add_argument(
        "--overhead-tasks", type=int, default=OVERHEAD_TASKS,
        help="with --overhead-only, each arm's tasks (sizing the A/B)",
    )
    parser.add_argument(
        "--overhead-reps", type=int, default=OVERHEAD_REPS,
        help="with --overhead-only, the arms of each side (sizing the A/B)",
    )
    parser.add_argument(
        "--f1-order",
        help="drive only the ps_fleet phase's F1, once per arm in this "
        "order (each of %s: the telemetry plane as F1 runs it, its task "
        "acks inline alone, F1 without the plane, and that with "
        "EDL_METRICS=0; an A/B in turns, e.g. on,plain,plain,on), and "
        "print its records, not the result line" % ",".join(F1_PLANES),
    )
    parser.add_argument(
        "--moe-only",
        action="store_true",
        help="drive only the moe phase (after device and build) and print "
        "its records, not the result line",
    )
    parser.add_argument(
        "--ring-only",
        action="store_true",
        help="drive only the ring phase and its TP phase (after device and "
        "build) and print their records, not the result line",
    )
    parser.add_argument("--ring-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--ring-port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--ring-out", help=argparse.SUPPRESS)
    parser.add_argument("--collective-port", type=int,
                        help=argparse.SUPPRESS)
    parser.add_argument(
        "--wire-order",
        default="off,auto",
        help="with --wire-only, the W arms' --ps_shm values in the order "
        "they run (each off or auto; an A/B in turns, e.g. "
        "off,auto,auto,off,off,auto)",
    )
    args = parser.parse_args(argv)
    order = tuple(args.wire_order.split(","))
    if set(order) - {"off", "auto"}:
        parser.error("each --wire-order arm is off or auto")
    f1_order = tuple(args.f1_order.split(",")) if args.f1_order else None
    if f1_order and set(f1_order) - set(F1_PLANES):
        parser.error("each --f1-order arm is one of %s" % (F1_PLANES,))
    return _checked(args, order, f1_order)


def _checked(args, order, f1_order):
    """``main`` past its arguments: a card and a checkout, then the
    phases, every process they start stopped at the end."""
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing to check",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "elasticdl_tpu_torch")):
        print(
            "chip_smoke: run from a checkout of the repository "
            "(elasticdl_tpu_torch/ not found beside this script)",
            file=sys.stderr,
        )
        return 2
    _bytecode_cache()
    sys.path.insert(0, REPO)
    if args.ring_rank is not None:
        return ring_rank_main(torch, args.ring_rank, args.ring_port,
                              args.ring_out, args.collective_port)
    _become_subreaper()
    # a stop from outside (SIGTERM) unwinds the phases, and this finally
    # still stops every process below this one
    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        return _main(torch, args, order, f1_order)
    finally:
        _stop_processes()


def _on_sigterm(signum, frame):
    raise SystemExit(128 + signum)


def _main(torch, args, order, f1_order):
    """``main`` past its checks: the phases that ``args`` ask for."""
    if args.moe_only:
        return _moe_ring_only(torch, "moe")
    if args.ring_only:
        return _moe_ring_only(torch, "ring")
    if args.elastic_only:
        return _elastic_only(torch)
    if args.elastic_tp_only:
        return _elastic_tp_only(torch)
    if args.elastic_collective_only:
        return _elastic_collective_only(torch)
    if args.zoo_only:
        return _zoo_only(torch)
    if args.ps_only:
        return _ps_only(torch)
    if args.ps_fleet_only:
        return _ps_fleet_only(torch)
    if args.ps_tiers_only:
        return _ps_tiers_only(torch)
    if args.ps_hybrid_only:
        return _ps_hybrid_only(torch)
    if args.ps_serve_only:
        return _ps_serve_only(torch)
    if args.wire_only:
        return _wire_only(torch, order)
    if f1_order:
        return _f1_order(torch, f1_order)
    if args.overhead_only:
        rec, problems = _telemetry_overhead(args.overhead_tasks,
                                            args.overhead_reps)
        emit(rec)
        if problems:
            print("chip_smoke: FAILED: %s" % "; ".join(problems),
                  file=sys.stderr)
            return 1
        return 0

    try:
        card = _run_phase("device", phase_device, torch)
        segments_before = shm_segments()
        _time_member_exports()
        _run_phase("shm_room", phase_shm_room)
        _run_phase("build", phase_build)
        records = _run_phase("kernels", phase_kernels, torch)
        records += _run_phase("bwd_kernels", phase_bwd_kernels, torch)
        _run_phase("bwd_memory", phase_bwd_memory, torch)
        with tempfile.TemporaryDirectory() as tmp:
            served = _run_phase("slice", phase_slice, torch, tmp)
        trained = _run_phase("train", phase_train, torch)
        with tempfile.TemporaryDirectory() as tmp:
            # the ring's ranks boot while the moe phase runs
            ring_ranks = _RingRanks(tmp)
            try:
                moe = _run_phase("moe", phase_moe, torch, tmp)
                ring = _run_phase("ring", phase_ring, torch, ring_ranks)
            finally:
                ring_ranks.stop()
        fused = _run_phase("fused", phase_fused_step, torch, card)
        with tempfile.TemporaryDirectory() as tmp:
            job, job_rec = _run_phase("job", phase_job, torch, tmp, fused,
                                      card)
            _check_counts(job, {k: 0 for k in KERNELS}, "the ResNet-50 job")
            evaluated = _run_phase("eval", phase_eval, torch, tmp, job_rec,
                                   card)
            _check_counts(evaluated, {k: 0 for k in KERNELS},
                          "the eval phase")
            zoo = _run_phase("zoo", phase_zoo, torch, tmp, card)
            _check_counts(zoo, {k: 0 for k in KERNELS}, "the zoo phase")
            ps = _run_phase("ps", phase_ps, torch, tmp, card)
            _check_counts(ps, {k: 0 for k in KERNELS}, "the ps phase")
            ps_fleet = _run_phase("ps_fleet", phase_ps_fleet, torch, tmp,
                                  card)
            _check_counts(ps_fleet, {k: 0 for k in KERNELS},
                          "the ps_fleet phase")
            ps_tiers = _run_phase("ps_tiers", phase_ps_tiers, torch, tmp,
                                  card)
            _check_counts(ps_tiers, {k: 0 for k in KERNELS},
                          "the ps_tiers phase")
            ps_hybrid = _run_phase("ps_hybrid", phase_ps_hybrid, torch, tmp,
                                   card)
            _check_counts(ps_hybrid, {k: 0 for k in KERNELS},
                          "the ps_hybrid phase")
            ps_serve = _run_phase("ps_serve", phase_ps_serve, torch, tmp,
                                  card)
            _check_counts(ps_serve, {k: 0 for k in KERNELS},
                          "the ps_serve phase")
            wire = _run_phase("wire", phase_wire, torch, tmp, card)
            _check_counts(wire, {k: 0 for k in KERNELS}, "the wire phase")
            _reset_counters()
            elastic, _ = _run_phase("elastic", phase_elastic, torch, tmp,
                                    job_rec, card)
            # launched in the workers (which report theirs, by run) or
            # here (counted with Run A's and B's path)
            here = _counts()
            elastic["elastic"] = {
                k: (n + here[k][0], here[k][1])
                for k, (n, _) in elastic["elastic"].items()
            }
            _reset_counters()
            elastic_tp = _run_phase("elastic_tp", phase_elastic_tp, torch,
                                    tmp, card)
            here = _counts()
            elastic_tp["elastic_tp"] = {
                k: (n + here[k][0], here[k][1])
                for k, (n, _) in elastic_tp["elastic_tp"].items()
            }
            _reset_counters()
            elastic_collective = _run_phase(
                "elastic_collective", phase_elastic_collective, torch, tmp,
                card)
            here = _counts()
            elastic_collective["elastic_collective"] = {
                k: (n + here[k][0], here[k][1])
                for k, (n, _) in
                elastic_collective["elastic_collective"].items()
            }
        for path, counts in dict(elastic, **elastic_tp,
                                 **elastic_collective).items():
            _check_counts(counts, {k: 0 for k in KERNELS}, path)
        _check_no_leaked_segments(segments_before)
        line = kernels_line(
            records,
            dict({"serve": served, "train": trained, "job": job,
                  "eval": evaluated, "zoo": zoo, "ps": ps,
                  "ps_fleet": ps_fleet, "ps_tiers": ps_tiers,
                  "ps_hybrid": ps_hybrid, "ps_serve": ps_serve,
                  "wire": wire},
                 **moe, **ring, **elastic, **elastic_tp,
                 **elastic_collective),
        )
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        _stop_processes()
        emit(timing_record())
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    _stop_processes()
    emit(timing_record())
    emit(line)
    print(card)
    # the result line, keys in the contract's order
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
