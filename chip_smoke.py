#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``veles_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's two main paths at the full width of AlexNet, serving
and training (resident, streamed, resumed, over uint8 pixels through
the ingest codec, and as a population-batched cohort), trains the
mnist7, cifar10, mnist_ae, wine, mnist_rbm and mnist_dbn models and the
Kohonen SOM at their published sizes (the MNIST and CIFAR-10 ones from
data files), profiles training supersteps, runs the GA and ensembles
through the CLI, learns online in the serving process and hands a GA
cohort to serving, serves from a fleet of hive replicas, trains data
parallel, serves and trains member-sharded over a mesh of two places
sharing the card, trains through the master--slave mode in one process,
and holds each hand-written kernel against its plain PyTorch version.  Every phase is fatal: the script
exits nonzero, printing no result line, when any check fails, when
there is no CUDA device, or when it is run without the repository
beside it.  A phase that fails, by a check or by any other exception, is
named on stdout (``phase NAME: FAIL: <type>: <message>``) with its
traceback on stderr, and the script exits 1; nothing is retried.  It
imports nothing of JAX and nothing of the JAX package.

1. Device: the card's name and power limit; build both LRN kernels from
   ``veles_tpu_torch/csrc/`` (one ``nvcc`` each, started together),
   print each kernel function's registers and spills as ptxas reports
   them, and fail on any spill; beside them build ``native/``'s C++
   runtime (``native.ensure_built``: the host compiler straight, into
   ``veles_tpu_torch/_build/``) and print the compiler, its version
   line and the seconds.
2. Kernels vs plain on the card, at AlexNet's two norm shapes.
   ``lrn_fwd`` at batch 64 (serving) and 128 (training), ``lrn_bwd`` at
   batch 128; n = 5 and 4, f32 and bf16; plus the edges of the kernels'
   design (``lrn_cases``).  Each case prints the kernel's, the plain
   version's and the library call's times (``torch.nn.functional.
   local_response_norm`` and, for the backward, autograd through it),
   each the mean of many launches back to back over rotated copies of
   the inputs with no host time in the window (``cuda_ms``), its memory
   bound, its share of the bound and the max abs error.
3. Serve: pack a 2-member full-width AlexNet ensemble (gaussian init at
   ``alexnet_layers``' stddevs from a numpy seed), publish it to the
   port's forge server (``forge.make_forge_server`` on 127.0.0.1, a free
   port, in a thread) and fetch it into a fresh directory
   (``forge.publish``, ``forge.fetch``): the fetched file's sha256 and
   manifest, and the manifest the server answered, the packed file's.
   Start ``python -m veles_tpu_torch --serve-models alexnet=FETCHED
   --max-batch 64`` on the card (beside its start, this process loads
   the same package and computes its CPU plain path's f32 answers), send concurrent requests of 1-16 rows, check every
   answer (rows_n, crc, probabilities summing to 1, agreement with the
   in-process engine at the same dtype), read the hive's stats (the
   serving path's kernel launches), shut it down (rc 0).  Then each norm
   layer of each member, in bf16 on a served batch, against the plain
   version to one bf16 ulp; and, once, the in-process engine in f32 on
   the card (TF32 off) against the CPU plain path in f32.
4. Train: full-width AlexNet (227x227x3, 1000 classes, minibatch 128,
   superstep 8, bf16) for 2 epochs through ``Launcher`` +
   ``drive_workflow`` on ``veles_tpu_torch/models/alexnet.py``, the path
   ``python -m veles_tpu_torch`` takes, in process, with the data set
   cut to 1024 train + 128 validation images, on cuDNN's deterministic
   algorithms (phase 6 holds its streamed run against this one).  The
   launch counts are zeroed just before and read just after; every
   training minibatch
   must have run ``lrn_bwd`` at both norm layers and every minibatch
   ``lrn_fwd``.  The run writes a metrics dir (``telemetry.configure``)
   and a ``logger.add_jsonl_sink`` file: its flushed snapshot's
   ``fused.dispatches``, ``fused.minibatches`` and ``fused.*_images``
   equal the run's own supersteps, minibatches and images; its journal
   holds ``fused.first_dispatch`` and ``fused.summary`` with an MFU; the
   sink the launcher's records.  Then one train superstep timed with
   CUDA events, each norm layer's backward at the activations and error
   of a real training minibatch, kernel vs plain, in bf16, and 9 + 9
   train supersteps alternately with telemetry on and off: the ratio of
   the medians within 1.15 (the hooks add no sync).  Last, the trained
   AlexNet is exported to VTPN (``export.export_model``, about 250 MB)
   and ``native/``'s runtime answers 2 validation rows, held against
   the port's f32 forward on the card (TF32 off), whose two ``lrn_fwd``
   launches are counted apart (``launches_by_path`` ``export``):
   probabilities within 1e-4, the argmax equal where the top two are
   more than 1e-3 apart; then each norm layer alone, ``native/``'s LRN
   against ``lrn_fwd`` on its tapped input and on a copy scaled so that
   the window makes at least 1e-2 of the output (one more ``lrn_fwd``
   a layer, counted in ``export``).  The run has the standard plotters
   attached (``Launcher(plotters=True)``; their events captured
   unrendered: the card's machine has no matplotlib) and a status
   reporter posting to an in-process web status page on a free localhost
   port over the phase's metrics dir: each plotter fired once an epoch,
   the last curve events are the decision's history, ``plt_weights`` is
   25 tiles of 11x11x3 equal to conv1's weights on the card tiled as the
   reference's ``_to_tiles`` does, ``/api/status`` holds the run's last
   epoch and error figures, ``/api/metrics`` the port's ``obs.load_dir``
   of the dir, and the launch counts are unchanged.  Last, ``python -m
   veles_tpu_torch -p`` on a cut mnist exits 2 naming matplotlib where
   it does not import (or, where it does, writes the four PNGs).
5. Card vs CPU: one train superstep (k = 2, dropout 0, f32, TF32 off)
   from the same params and indices on the card and through the port's
   CPU plain path, the CPU replaying the card's choices at every max
   pool (argmax) and ReLU (mask), each choice it would have made
   otherwise a near tie: every param's change agrees within 1e-3
   relative.
6. Stream: the training run of phase 4 once more with
   ``root.alexnet.loader.max_resident_bytes=0`` (every superstep
   assembled on the host and streamed in bf16 through the pinned
   double buffer), held against phase 4's run as the resident one, both
   drives on cuDNN's deterministic algorithms.  Every minibatch ran
   both kernels; the loader did not go resident; the streamed bytes are
   the bf16 samples and int64 labels of every minibatch; the streamed
   run equals the resident one (see ``same_run``).  Then streamed train
   supersteps timed with CUDA events (each right after a synchronised
   validation firing, so it includes whatever host assembly the
   prefetch thread had not finished; the resident superstep is phase
   4's), the host assembly, staging and H2D ms and bytes per superstep,
   the assembly's steps timed one by one.  ``save_workflow`` of the
   full-width workflow uncompressed and as ``.gz`` runs on a thread of
   its own beside phase 7 (file IO and zlib work off the GIL; a save
   writes no state of the process); after phase 7 each is loaded back
   with ``load_workflow`` on a thread beside phase 8, which draws from
   no prng stream, and held when joined after it (``stream_gz``), the
   loaded copy a snapshot with its params (the prng streams a load puts
   back are put back as they were: loaded beside phase 7's in-process
   run, they changed its draws).
7. Preempt-resume: a workflow file written to the scratch directory
   builds ``models/alexnet.py``'s workflow on 256 + 128 images for 2
   epochs (superstep 1, so that a TRAIN class spans two firings) and,
   on the supervisor's first
   attempt only, sends its own process SIGTERM after its second firing,
   in the middle of TRAIN.  ``python -m veles_tpu_torch --supervise``
   runs it on the card with a snapshotter: the child must exit 14
   after a final snapshot, the supervisor must resume it from that
   snapshot to rc 0, and the run must equal an uninterrupted run of
   the same file and seed in this process (``same_run``); the resumed
   child's launch counts must show both kernels on every minibatch it
   ran.  Then the fault matrix's device drills on the card (``python -m
   veles_tpu_torch.tools.chaos_drill --only device --json``):
   ``device.oom_on_put`` at the streamed upload (drained and retried
   once) and at the resident one (degraded to streaming), each run
   completing on CUDA tensors.
8. Data: the port's generators write the MNIST IDX files (60 000 +
   10 000 images) and the CIFAR-10 binary batches (50 000 + 10 000) into
   the scratch directory; its readers read them back equal to the
   generators' data, and a partial set is refused.  Bytes and seconds.
9. MNIST7 time-to-99% (BASELINE's secondary workload, as ``bench.py``
   times it): ``models/mnist7.py`` through the CLI's path with
   ``root.common.data_dir`` at those files, ``decision.max_epochs=40``,
   timed from the end of initialize to the first validation class end
   at most 1% error, capped at MNIST7_CAP_S; epochs, train img/s per
   epoch, the resident data set's bytes.  Every param and the data set
   must be on the card, and validation error must fall.  Then the
   trained model is exported to VTPN and ``native/`` answers 256
   validation rows against the port's f32 forward on the card, with
   phase 4's tolerance; the file's bytes, the export's seconds and
   native's rows/s.  The run has the standard plotters attached: the
   last ``plt_confusion`` event's matrix is the decision's validation
   confusion as the plotter read it, summing to 10 000.
10. CIFAR-10: ``models/cifar10.py`` at 50 000 + 10 000 images from the
   binary batches, 2 epochs; img/s, and the ``inv`` policy's rates by
   iteration checked on the last train superstep.
11. Quantized: full-width AlexNet over the phase-4 data set rounded to
   uint8 (``bench.py``'s rule), the loader's ``linear`` normalizer
   folded into the on-device dequantization, 2 epochs each under
   deterministic cuDNN: (a) streamed at 1 byte a pixel, (b) resident as
   uint8, (c) the same bytes with ``quantized_ingest=False`` streamed in
   bf16.  (a) equals (b) bitwise; (a) against (c) within the
   reference's bar (validation loss within 5e-3, n_err equal); every
   run launches both kernels on every minibatch; the wire and the
   resident set are exactly their bytes.  Superstep, host assembly,
   staging and H2D times per path.
12. MnistAE (BASELINE config #5): ``models/mnist_ae.py`` through the
   CLI's path on the phase-8 MNIST files, 60 000 + 10 000 images, the
   published 10 epochs, in f32; per epoch the train and validation MSE
   and the train img/s, the resident bytes of data and targets (the
   targets share the data's tensor), set-up seconds.  Validation MSE
   must fall, every class end count its images with n_err 0, and no LRN
   kernel launch.  Then the same files cut to 1 000 + 200 images, 2
   epochs, on the card and on the CPU, f32, TF32 off, deterministic
   cuDNN: every class end's MSE within 1e-3 relative.
13. Kohonen (BASELINE config #5): ``models/kohonen.py`` at its published
   DEFAULTS (5 000 samples of 8x8x1, an 8x8 map, 15 epochs, a whole
   class per firing) on the card, then on the CPU: the quantization
   error per epoch, the run's wall seconds and SOM steps per second; the
   last epoch's error under 0.9x the first; card and CPU within 1e-3
   relative at every epoch, and the samples whose winner on the two
   final maps differs, counted.
14. Layers: each layer type of the zoo's long tail (the five
   standalone activations, ``all2all_sigmoid``, the cutter, stochastic
   pooling in eval and in train mode) forward and backward on the card
   against the same unit on the CPU at small shapes in f32, the train
   mode on the CPU generator's uniforms on both (``prng.uniform``);
   and a ``resizable_all2all`` resized between two runs, on the card
   and on the CPU.  The worst relative error of each.  Then one small
   unit graph through the ported graph API (``workflow.py``,
   ``accelerated_units.py``, ``memory.py``): a Repeater loop of 4 turns
   around an AcceleratedUnit whose Vectors live on ``cuda:0``, gated
   off by a counter, to the EndPoint; each turn's ``map_read`` equal to
   the same graph's on the CPU, exactly, and the unit's output a CUDA
   tensor until it.
15. Wine: ``models/wine.py`` at its published DEFAULTS (30 epochs); the
   validation error per epoch and the final confusion matrices, whose
   rows must count each label of their class and whose trace must be
   the class's right answers.
16. MNIST RBM: ``models/mnist_rbm.py`` on the phase-8 MNIST files,
   60 000 + 10 000 images, the published 10 epochs, in f32; the
   reconstruction MSE and train img/s per epoch, the resident bytes;
   the validation MSE must fall below 0.9x the first epoch's (it climbs
   again later in the published run).  Then the cut set on the card and
   on the CPU, every draw from the CPU generator on both: every class
   end's MSE within 1e-3 relative.
17. MNIST DBN: ``models/mnist_dbn.py`` at its published DEFAULTS:
   pretraining [196, 64], 3 epochs a stage, chained on the card (the
   ``stats``: ``device_chain``, 0 bytes host-to-device between the
   stages, no host copy of a stage's set), then 10 fine-tuning epochs;
   the validation error per epoch, the final confusion matrix (checked
   as in 15), and the seconds of each part.
18. Profile: two train supersteps each of the mnist7 and mnist_ae
   workflows of phases 9 and 12 and one of phase 4's full-width AlexNet,
   resident, after one more to warm the card, timed (CUDA events, the
   host clock), then as many again under ``profiling.trace``
   (``torch.profiler``): the ten kernels and the ten operators with the
   most device time, the device's kernel time per minibatch and its
   busy share of the unprofiled wall time and of the profiled window,
   the host's own time per minibatch, kernels per minibatch; AlexNet's
   MFU from the analytic FLOPs at the train phase's and the timed
   superstep's img/s, against the datasheet's peak.
19. Cohort: ``PopulationTrainEngine`` over full-width AlexNet, P = 2
   learning rates (the model's, and half), one epoch of phase 4's cut
   set, in bf16 and then in f32.  The launch counts are those of ONE
   member's run (18 ``lrn_fwd``, 16 ``lrn_bwd``): the kernels' member
   rule folds the members into the rows; the first folded launches of
   each kernel against its plain version (one bf16 ulp); each member
   against a per-genome run of its rates (n_err at every class end, the
   model's params; in f32 also each param's change).  Then a warm bf16
   cohort under ``torch.profiler``, and each AlexNet convolution grouped
   (as ``vmap`` batches it) against a loop over the members.
20. SOM cohort: ``SOMPopulationEngine`` over ``models/kohonen.py``'s
   DEFAULTS with 4 genomes, against 4 per-member runs on the card.
21. GA: ``python -m veles_tpu_torch -b cuda --optimize 8:2 --ga-state``
   on ``models/mnist.py`` (BASELINE #1: 784-100-10, minibatch 60,
   60 000 + 10 000 images from the phase-8 IDX files) in f32, its two
   learning rates and the first weight decay as genes, 2 epochs a
   genome: the evaluator's hello names the card, one cohort a
   generation ([8], [6], [6]), no fallback; genomes/s and the cohort's
   ms per minibatch; two genomes of the last generation trained again
   per genome on the card, their fitness their cohort fitness.
22. Ensemble: ``--ensemble-train 2 --ensemble-test`` on
   ``models/mnist7.py`` at full width (1 epoch a member) through the
   CLI on the card, ``--ensemble-test --ensemble-device host`` on its
   file (the same error % within one image), and the members' mean
   probabilities on the card against the CPU.
23. Online: the served ensemble of phase 3's package, in this process,
   registered with a ``ResidencyManager`` and armed with an
   ``OnlineLearner`` (micro-batch 32, margin 0): the labeled stream
   (``request_rows()`` with a label a row) through its ``TrafficTap``;
   16 shadow steps with the launch counts zeroed just before and read
   just after (2 ``lrn_fwd`` and 2 ``lrn_bwd`` a step, the members folded
   into the rows), the first folded launches against the plain versions,
   ms a step; the offline replay of the (step, buffer version) history
   from the incumbent, bitwise under deterministic cuDNN; two f32 shadow
   steps on the card against the CPU (``ONLINE_CPU_RTOL``); a gate round
   that promotes, the served answers then bitwise a fresh engine's on
   the refreshed host members, the swap's ms and time to serve; peak
   device memory.  The GA handoff: an AlexNet cohort of 2 for one epoch
   of 256 + 128 images, its best member adopted into a pre-built serving
   engine, its answers bitwise a fresh engine's, no npz written.  Then
   ``--serve-models alexnet=PKG --online`` through ``HiveClient``: the
   labeled stream's first 12 requests one at a time with the learner
   suspended, then
   resumed, p50 and p99 of each, learner-on p99 within max(8 x off,
   off + 250 ms); the hive's launches over its life.  Last, drift through
   the CLI on the tier-1 hive test's small model, with a metrics dir and
   each request carrying a context from ``trace.mint()``: promoted with
   the shadow ahead by the margin, the answers after it better than the
   frozen ensemble's on the drifted truth, and the promotion's
   ``flightrec-<pid>-<n>-promote.json`` holding ``gate.promote`` with
   ``lineage_n`` > 0, every trace id of the promotion's lineage one the
   client minted.
24. Fleet: phase 3's package from an in-process ``FleetRouter`` of 2
   replicas on the card (``VELES_ONLINE=1``, ``--max-batch 64``, a
   16 GiB residency budget each), the learner rung engaged before any
   traffic, and a metrics dir: each replica's warm-up before its hello
   (one padded dispatch, its launches counted apart), spawn to hello and
   first answer (under 2 s after the warm-up); 48 one-row
   requests from 4 threads, every answer's crc checked and held against
   an in-process engine as in phase 3, each replica routed at least a
   quarter, its ``lrn_fwd`` launches (from ``op=stats``, before and
   after) 2 layers x 2 members a dispatch, p50 / p99, hedges, the hedge
   threshold.  The operator's fleet view of it through the port's report
   CLI (``python -m veles_tpu_torch.tools.obs_report DIR --fleet
   --json``): a row a replica with the live pid and, once each replica's
   periodic flush holds it, the replica's own ``op=stats`` request
   count, every replica's ``lrn_fwd`` 4 a dispatch over its life; the
   rendered table printed.  SIGKILL of replica 1 with 16 requests in
   flight: none lost, the victim's retried on the peer, the respawn's seconds and
   first answer (under 2 s), the card's memory before the fleet, at its
   peak, after the kill and after the respawn; before the kill, the
   victim's periodic flush holds every request it was sent.  The learner rung on labeled
   traffic: no step while engaged, ``lrn_bwd`` 2 a step after the
   release.  After shutdown each ``replica-<i>`` dir holds a snapshot
   for every pid that lived there (the killed one's from before the
   kill), each pid's ``serve.requests`` what the phase sent it, each
   cleanly shut-down pid's journal ``serve.ready`` and, last,
   ``serve.shutdown``, and the router's snapshot its ``fleet.*``
   counters at shutdown.  Traces, at ``$VELES_TRACE_SAMPLE`` 1 and read
   with ``veles_tpu_torch/obs.py`` only: every request of the burst one
   whole trace (``trace.request``, a ``trace.leg``, ``trace.serve``, a
   ``trace.batch`` that links it, events of two pids, all four
   critical-path components: their medians and maxima in ms), checked
   before the kill (the victim's trace lines reach its file with its
   periodic flush) and after shutdown; each retried request of the
   failover window one trace with legs on two replicas; the router's
   ``fleet.request_seconds`` exemplars naming traces that assemble; a
   ``sigterm`` dump for each replica pid that ended on a SIGTERM.  Then
   the tier-1 fleet model (6x6x1 -> 12 -> 3): a healthy
   fleet and one whose replica 0 is armed with ``hive.slow_dispatch``
   (6 dispatches of 1.5 s), driven side by side by the same closed-loop
   stream (4 clients each, 8 s after a 2 s ramp): on the slow one a
   hedge, an ejection and a reinstatement, and its p99 within 1.5x the
   healthy one's, and the ejection's ``flightrec-<pid>-<n>-ejection.json``
   in the router's dir with a ``sentinel.eject`` entry for replica 0;
   with the healthy fleet alone on the card, the reference's tracing
   overhead pair (one request at a time, a burn-in at trace rate 0, 11
   pairs of 8 s, their requests at rate 1 and 0 interleaved one by one in
   a seeded random order, the median per-pair p99 ratio within 1.05);
   then a 10 s open-loop day (``traffic.generate``) under
   ``FleetAutoscaler`` over 1-3 replicas with the reference's default
   thresholds, one outcome per arrival and no error, the replica count
   over time and every action with its pressure, the day's books
   balanced by the port's ``accountability_check`` (every arrival one
   outcome, no error, every crc its echo, every scale, ejection,
   retirement and death in the router's merged journals with its
   cause), and a ``sigterm`` dump for each retired replica; and
   a fleet whose replica 0 is armed with ``hive.garbage_response``, its
   replicas under the lock witness (``$VELES_LOCK_WITNESS``):
   integrity strikes, an ejection, every answer the in-process
   engine's, a ``lockwitness-<pid>.json`` from each replica whose edges
   hold no cycle, name only locks the port declares and lie within the
   port's locking law (``veles_tpu_torch/analysis/lock_order.json``).
25. Data parallel: ``python -m veles_tpu_torch --dp 2`` without
   ``$VELES_MESH_RANKS_PER_CARD`` exits 2 naming it (one card); with it
   set to 2 and ``$VELES_MESH_SHARD_DATA=always``, two ranks of
   full-width AlexNet share the card over gloo for 1 epoch of phase 4's
   data: each rank launches ``lrn_fwd`` and ``lrn_bwd`` on every
   minibatch (2 a norm layer; counts zeroed after ``initialize``, read
   after the run), holds the padded half of the data set, sums 8
   gradients a train minibatch (their ms a minibatch printed), and ends
   with the other rank's param CRC and history; its first epoch's rows
   agree with phase 4's within ``DP_LOSS_TOL`` and ``DP_NERR_FRAC``, and
   its params' change over the epoch with phase 4's first epoch's
   within ``DP_DELTA_RTOL`` (each param at ``DP_SAMPLE`` seeded
   positions, ``param_sample``).  Then, side by side: ``--multihost``
   with torchrun's variables for one rank over NCCL, one superstep of a
   cut AlexNet (both kernels on every minibatch); the fault matrix's
   ``multihost.peer_exit`` drill on the card (two ranks over gloo, rank
   1 dies, rank 0 exits 13 with a final snapshot that resumes); and the
   refusal.
26. Mesh (ROADMAP item 10b): one process's mesh of 2 places sharing
   the card (``$VELES_MESH_RANKS_PER_CARD=2``; no run covers a mesh over
   two cards).  A 3-member full-width AlexNet package and the tier-1
   model served by a ``--serve-models --mesh 2`` hive and a flat hive,
   side by side, at one budget a place (``MESH_BUDGET``: the padded half
   of the AlexNet stack fits, the whole stack does not): the mesh hive's
   hello advertises ``devices`` 2 and AlexNet sharded and resident, it
   answers 3 requests of 1-16 rows switching models with 0 spills
   where the flat hive spills at every switch, each answer the flat
   hive's (bitwise, else within the serve phase's card-vs-engine bar),
   and ``lrn_fwd`` launched 6 times an AlexNet dispatch (2 layers
   x 3 real members; the hives' own counts); an AlexNet cohort of 3
   (conv1's rate the gene; padded to 4, 2 a place; 256 + 128 images,
   bf16) through ``python -m veles_tpu_torch.genetics.worker --serve
   --dp 2`` and, in this process, the same cohort unsharded and sharded:
   the fitness rows equal, the sharded params within the cohort
   phase's bf16 bar of the unsharded (``MESH_PARAM_*`` says why), the
   LRN kernels launched 2 a layer a
   minibatch (once a place; the unsharded cohort once), the cohort cap 2
   places' worth of one place's budget; the SOM cohort of 3 over the 2
   places against its unsharded run.
27. Master--slave (ROADMAP item 10c): one ``server.MasterServer`` and
   one ``client.SlaveClient`` in this process over full-width AlexNet,
   2 epochs of 128 + 64 images at 64 a minibatch (``MS_*``): the master
   on the CPU (it computes nothing) in ``serve()`` on a thread, the
   slave on the card in its ``serve()``, joined by zmq on 127.0.0.1
   (the master binds a free port; every message pickled, protocol 4):
   6 jobs, 4 of them train, done and applied; ``lrn_fwd`` 2 a job and
   ``lrn_bwd`` 2 a train job (counts zeroed just before the loop, read
   just after); against a standalone
   run of the same config and seed on the card (superstep 8), both on
   deterministic cuDNN: every validation row's loss within
   ``MS_LOSS_TOL`` and ``n_err`` within ``MS_NERR_TOL``, the final
   params within ``MS_PARAM_ATOL`` (the reference's bars,
   ``tests/test_master_slave.py``), and each param's change from its
   start within 1e-3 relative (``same_run``: the rows stay near ln 1000
   at this depth).  The card's machine has zmq; the flags' refusal
   without it is held on the CPU (``tests/test_torch_import.py``).
28. Summary (a phase of its own): each phase's wall seconds on a
   ``phases`` line (each also printed as it ends), then ``serve``,
   ``train``, ``stream``, ``preempt``, ``data``, ``mnist7``,
   ``cifar10``, ``quantized``, ``mnist_ae``, ``kohonen``, ``layers``, ``wine``, ``mnist_rbm``, ``mnist_dbn``, ``profile``,
   ``cohort``, ``som_cohort``, ``ga``, ``ensemble``, ``online``,
   ``fleet``, ``dp``, ``mesh`` and ``master_slave`` JSON lines, each
   with its phase's ``seconds``, a ``scaling`` line (the scaling model,
   ``tools/scaling_model.py``, on phase 4's timed minibatch), the total
   minutes, the card line, the ``kernels`` line, then the device line
   last.

``python3 chip_smoke.py --only fleet`` (or ``serve``, ``preempt``,
``online``, ``dp``, ``mesh``, ``master_slave``, or a comma-separated
list of them) runs phase 1's build, phase 3's package and phase 24 (3,
7, 23, 25, 26, 27, those listed) alone, and prints their JSON lines and
no result lines (``dp`` then holds nothing against phase 4's epoch).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import traceback
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor flop/s
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
MAX_BATCH = 64
TRAIN_BATCH = 128
N_MEMBERS = 2
SAMPLE_SHAPE = (227, 227, 3)
N_CLASSES = 1000
#: the served burst: requests of 1-16 rows from N_THREADS client threads
N_REQUESTS = 16
N_THREADS = 8
#: the served package's synthetic data set (see build_package)
PACKAGE_N_TRAIN, PACKAGE_N_VALID = 64, 16
SEED = 20261016


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# -- phase 2: the kernel against its plain version ---------------------

#: inputs rotated in a timed run add up to at least this much, well over
#: the H100's 50 MB L2, so that each launch reads its own inputs cold
ROTATE_BYTES = 256 << 20
#: cycles of the sleep kernel queued ahead of a timed run (about 11 ms at
#: 1.75 GHz); doubled until the host has queued every launch before it
#: ends
SLEEP_CYCLES = 20_000_000


def cuda_ms(fn, inputs, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])`` over ``iters``
    launches back to back between two CUDA events.  ``inputs`` holds
    copies of the arguments (``rotations``), together well over the L2,
    so each launch reads its own inputs from device memory, and each
    output is written back once, as the bound counts; no flush leaves
    dirty lines for the timed kernel to write back.  A sleep kernel is
    queued ahead of the start event, and the host must queue every
    launch before it ends (else the sleep doubles and the run repeats),
    so the host's time per call never falls inside the window."""
    import torch
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    cycles = SLEEP_CYCLES
    for _ in range(7):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise SmokeFailure("cuda_ms: the host could not queue the launches "
                       "within a sleep of %d cycles" % cycles)


def rotations(*tensors, iters: int):
    """Copies of ``tensors`` for :func:`cuda_ms`: enough sets that they
    add up to ``ROTATE_BYTES``, at least 2, and no more than ``iters`` + 2
    (the timed and warm-up launches)."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = min(max(2, -(-ROTATE_BYTES // size)), iters + 2)
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def lrn_bound(shape, dtype, n_arrays: int, ops_per_elem: float):
    """(bound_ms, bound_by): each of ``n_arrays`` arrays of ``shape``
    read or written once, against ``ops_per_elem`` f32 operations per
    element."""
    import torch
    numel = int(np.prod(shape))
    item = torch.empty((), dtype=dtype).element_size()
    t_bytes = n_arrays * numel * item / HBM_BYTES_S * 1e3
    t_ops = ops_per_elem * numel / F32_FLOPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_one_ulp(y, ref, what: str) -> None:
    """bf16 ``y`` within one bf16 ulp of ``ref``: the kernel and the
    plain version round f32 values that differ only in the order of the
    window sum, so their bf16 results differ by one ulp at most, and
    one ulp is at most 2^-7 of the value."""
    err = (y.float() - ref.float()).abs()
    bad = err > 2.0 ** -7 * ref.float().abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} bf16 elements more than one ulp "
          f"off (max abs err {float(err.max()):.3g})")


def bwd_terms(x, err, n: int, k: float, alpha: float, beta: float = 0.75):
    """The two terms of the backward, ``|e*d|`` and ``|2*alpha*beta*x*wt|``,
    in f32 as the plain version forms them."""
    import torch

    from veles_tpu_torch.ops import lrn_cuda
    c = x.shape[-1]
    xr = x.reshape(-1, c)
    xf, ef = xr.float(), err.reshape(-1, c).float()
    s = (xr * xr).float() @ lrn_cuda._band_tensor(c, n, x.device,
                                                  torch.float32)
    d, d1 = lrn_cuda._powers(k + alpha * s, beta, need_d1=True)
    t = (ef * xf * d1).to(x.dtype).float()
    wt = t @ lrn_cuda._band_tensor(c, n, x.device, torch.float32,
                                   transpose=True)
    return ((ef * d).abs().reshape(x.shape),
            (2.0 * alpha * beta * xf * wt).abs().reshape(x.shape))


def check_bwd_bf16(out, ref, x, err, n: int, k: float, alpha: float,
                   what: str, beta: float = 0.75) -> None:
    """bf16 backward within one bf16 ulp (at most 2^-7 of the value) of
    the LARGER of its two terms, ``|e*d|`` and ``|2*alpha*beta*x*wt|``.
    The result is their difference: where they cancel, an ulp of the
    result alone is far smaller than the rounding either term carries
    (the kernel and the plain version may round t, or the result, on
    either side of a bf16 boundary when their f32 window sums differ in
    order), so the yardstick is the larger term's ulp."""
    import torch
    a, b = bwd_terms(x, err, n, k, alpha, beta)
    diff = (out.float() - ref.float()).abs()
    bad = diff > 2.0 ** -7 * torch.maximum(a, b)
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} bf16 elements more than one ulp of "
          f"the larger term off (max abs err {float(diff.max()):.3g})")


K_LRN, ALPHA_LRN = 2.0, 1e-4
#: kernel vs plain version, in the same dtype.  Forward: in f32 the two
#: differ only in the order of the <= n-term f32 window sum (den >= k =
#: 2, so relative errors stay near 1e-7); in bf16 that order can flip the
#: final rounding of y by one bf16 ulp (2^-8 relative), well inside 2e-2,
#: and bf16 is also held to one ulp (2e-2 alone would pass an alpha off
#: by 10%).  Backward: f32 at the tolerance of the reference's own Pallas
#: backward test (tests/test_ops.py); bf16 by check_bwd_bf16.
FWD_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 2e-2)}
BWD_TOL = (2e-4, 1e-5)
#: timed launches of a kernel, and of its plain version or library call
KERNEL_ITERS, REF_ITERS = 50, 10
#: the edge cases' rows: 4 x 13 x 17 = 884
EDGE = (4, 13, 17)


def lrn_cases():
    """(kernel, shape, n, dtype, role) of every kernel-phase case.  Roles:
    "serve" and "train" are the main paths' shapes (bf16, n = 5, at batch
    64 and 128); "check" the other n and dtypes there; the rest are edges
    of the kernels' design: a ragged row count, a row of 16 384 channels
    (the vector path) and one of 16 383 (the row path, with over 48 KiB
    of shared memory a block), C not a multiple of the 8-element vector
    (100) or under n (3), n = 1, n = 9 (past the vector path's widest
    window, 5), n = 19 (a halo wider than a neighbouring vector), and
    inputs whose data pointer is one element past a 16-byte boundary;
    "rows" times the row path at the training path's row count (C =
    100, bf16)."""
    cases = []
    for name, roles in (("lrn_fwd", (("serve", 64), ("train", 128))),
                        ("lrn_bwd", (("train", 128),))):
        for role, batch in roles:
            for hw, c in ((55, 96), (27, 256)):
                for n in (5, 4):
                    if name == "lrn_fwd" and role == "train" and n != 5:
                        continue
                    for dt in ("float32", "bfloat16"):
                        main = n == 5 and dt == "bfloat16"
                        cases.append((name, (batch, hw, hw, c), n, dt,
                                      role if main else "check"))
        cases.append((name, (3, 17, 19, 96), 5, "float32", "ragged"))
        if name == "lrn_bwd":
            cases.append((name, (3, 17, 19, 96), 4, "bfloat16", "ragged"))
        cases.append((name, (TRAIN_BATCH, 55, 55, 100), 5, "bfloat16",
                      "rows"))
        cases.append((name, (5, 16384), 5, "bfloat16", "wide"))
        cases.append((name, (5, 16383), 5, "bfloat16", "wide"))
        for dt in ("float32", "bfloat16"):
            for c, n in ((100, 5), (3, 5), (96, 1), (96, 9), (96, 19)):
                cases.append((name, EDGE + (c,), n, dt, "edge"))
            cases.append((name, EDGE + (96,), 5, dt, "unaligned"))
    return cases


def _misaligned(t):
    """A contiguous copy of ``t`` whose data pointer is one element into
    a buffer, so not 16-byte aligned."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    check(out.is_contiguous() and out.data_ptr() % 16 != 0,
          "could not make a misaligned input")
    return out


def lrn_case(case, gen, card: str) -> dict:
    """One kernel-phase case: the kernel against its plain version at the
    stated tolerance, then the kernel's, the plain version's and the
    library call's times (never called by the port: ``torch.nn.
    functional.local_response_norm`` on an NCHW view, and for the
    backward autograd through it), its memory bound and its share of the
    bound."""
    import torch
    import torch.nn.functional as F

    from veles_tpu_torch.ops import lrn_cuda
    name, shape, n, dt, role = case
    dtype = getattr(torch, dt)
    k, alpha = K_LRN, ALPHA_LRN
    # post-ReLU-scale activations: alpha * window sum is a sizable part of
    # den, so the power term is exercised
    x = (torch.randn(shape, generator=gen, device="cuda") * 30.0).to(dtype)
    e = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if role == "unaligned":
        x, e = _misaligned(x), _misaligned(e)
    row = {"kernel": name, "shape": list(shape), "n": n, "dtype": dt,
           "role": role}
    what = f"{name} {shape} n={n} {dt} {role}"
    if name == "lrn_fwd":
        args = (x,)
        kernel = lambda x: lrn_cuda.lrn_fwd(x, n, k, alpha)  # noqa: E731
        plain = lambda x: lrn_cuda.lrn_fwd_plain(x, n, k, alpha)  # noqa: E731
        got, ref = kernel(x), plain(x)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        rtol, atol = FWD_TOL[dt]
        bad = err > atol + rtol * ref.float().abs()
        check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements "
              f"off (max abs err {float(err.max()):.3g})")
        if dtype == torch.bfloat16:
            check_one_ulp(got, ref, what)
    else:
        args = (x, e)
        kernel = lambda x, e: lrn_cuda.lrn_bwd(x, e, n, k, alpha)  # noqa: E731
        plain = lambda x, e: lrn_cuda.lrn_bwd_plain(  # noqa: E731
            x, e, n, k, alpha)
        got, ref = kernel(x, e), plain(x, e)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if dtype == torch.bfloat16:
            check_bwd_bf16(got, ref, x, e, n, k, alpha, what)
        else:
            rtol, atol = BWD_TOL
            bad = err > atol + rtol * ref.abs()
            check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements "
                  f"off (max abs err {float(err.max()):.3g})")
    row["max_abs_err"] = float(err.max())
    if role == "unaligned":
        rot = [tuple(_misaligned(t) for t in args) for _ in range(2)]
    else:
        rot = rotations(*args, iters=KERNEL_ITERS)
    row["kernel_ms"] = cuda_ms(kernel, rot, KERNEL_ITERS)
    if name == "lrn_fwd":
        row["bound_ms"], row["bound_by"] = lrn_bound(shape, dtype, 2, n + 6)
    else:
        # x and e read once, the result written once; about 3n + 11 f32
        # operations an element (two window sums, the squares, den and
        # its powers, the products)
        row["bound_ms"], row["bound_by"] = lrn_bound(shape, dtype, 3,
                                                     3 * n + 11)
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row["plain_ms"] = cuda_ms(plain, rot, REF_ITERS)
    row["library_ms"] = None
    if len(shape) == 4 and name == "lrn_fwd":
        row["library_ms"] = cuda_ms(
            lambda x: F.local_response_norm(
                x.permute(0, 3, 1, 2), size=n, alpha=alpha * n, beta=0.75,
                k=k), rot, REF_ITERS)
    elif len(shape) == 4:
        # autograd through the library's forward, one graph recorded per
        # rotated input set
        graphs = []
        for xr, er in rot:
            xl = xr.permute(0, 3, 1, 2).detach().requires_grad_(True)
            graphs.append((xl, F.local_response_norm(
                xl, size=n, alpha=alpha * n, beta=0.75, k=k),
                er.permute(0, 3, 1, 2)))
        row["library_ms"] = cuda_ms(
            lambda xl, yl, el: torch.autograd.grad(yl, xl, el,
                                                   retain_graph=True),
            graphs, REF_ITERS)
        del graphs
    print(f"{name} " + json.dumps(row) + f"  [{card}]", flush=True)
    return row


def kernel_phase(card: str):
    """Both kernels against their plain versions, with times."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return [lrn_case(case, gen, card) for case in lrn_cases()]


def ptxas_table(log: str) -> list:
    """Per kernel function in ptxas's -v output: its registers and spill
    bytes."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None and "spill_stores" not in cur:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


# -- phase 3: the served ensemble --------------------------------------

class HiveProcess:
    """``python -m veles_tpu_torch --serve-models`` over pipes."""

    def __init__(self, pkg: str, workdir: str) -> None:
        self.stderr_path = os.path.join(workdir, "hive.stderr")
        self._stderr = open(self.stderr_path, "w")
        env = dict(os.environ)
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "--serve-models",
             f"alexnet={pkg}", "-b", "cuda", "--max-batch",
             str(MAX_BATCH), "--max-wait-ms", "20", "--install-dir",
             os.path.join(workdir, "hive_install"),
             "--heartbeat-every", "0"],
            cwd=HERE, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._stderr, text=True,
            bufsize=1)
        self._cond = threading.Condition()
        self._lines = {}
        self.hello = None
        self._wlock = threading.Lock()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            msg = json.loads(line)
            with self._cond:
                if msg.get("ready"):
                    self.hello = msg
                elif "id" in msg:
                    self._lines[msg["id"]] = msg
                self._cond.notify_all()
        with self._cond:
            self._cond.notify_all()

    def _wait(self, pred, timeout: float, what: str):
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                got = pred()
                if got is not None:
                    return got
                left = deadline - time.monotonic()
                check(left > 0 and self.proc.poll() is None,
                      f"hive: no {what} (rc={self.proc.poll()}); "
                      f"stderr tail:\n{self.stderr_tail()}")
                self._cond.wait(min(left, 0.5))

    def wait_hello(self, timeout: float = 600.0):
        return self._wait(lambda: self.hello, timeout, "hello")

    def send(self, obj) -> None:
        """One request line: a dict, or a line already serialized."""
        line = (obj if isinstance(obj, str) else json.dumps(obj)) + "\n"
        with self._wlock:
            self.proc.stdin.write(line)
            self.proc.stdin.flush()

    def result(self, jid, timeout: float = 300.0):
        return self._wait(lambda: self._lines.pop(jid, None), timeout,
                          f"answer to {jid!r}")

    def stderr_tail(self, n: int = 30) -> str:
        self._stderr.flush()
        with open(self.stderr_path) as f:
            return "".join(f.readlines()[-n:])

    def shutdown(self, timeout: float = 120.0) -> int:
        self.send({"op": "shutdown"})
        return self.proc.wait(timeout)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self._stderr.close()


def build_package(workdir: str, n_members: int = N_MEMBERS,
                  name: str = "alexnet") -> str:
    """A full-width AlexNet ensemble package of ``n_members``: members
    drawn with numpy from SEED + i at the stddevs ``alexnet_layers``
    declares, written in the framework-neutral (reference) layout.  The
    entry cuts the synthetic data set to PACKAGE_N_TRAIN +
    PACKAGE_N_VALID images:
    serving never loads it, and an ``--online`` hive loads it once on
    the host only for the codec's decision (``hive.attach_dequant``);
    the widths are the model's."""
    from veles_tpu_torch.convert import params_to_jax
    from veles_tpu_torch.ensemble.packaging import pack_ensemble
    from veles_tpu_torch.models import alexnet

    class FL:
        workflow = None

    entry = os.path.join(workdir, "alexnet_entry.py")
    with open(entry, "w") as f:
        f.write("from veles_tpu_torch.models import alexnet\n\n\n"
                "def create_workflow(launcher):\n"
                "    return alexnet.create_workflow(launcher, loader=dict(\n"
                "        alexnet.DEFAULTS['loader'], "
                f"n_train={PACKAGE_N_TRAIN}, n_valid={PACKAGE_N_VALID}))\n")
    w = alexnet.create_workflow(FL())
    w.initialize()
    members = []
    for i in range(n_members):
        gen = np.random.default_rng(SEED + i)
        params = {f.name: f.fill_params(gen) for f in w.forwards}
        members.append({"params": params_to_jax(params),
                        "seed": SEED + i, "valid_error": 0.0,
                        "forward_names": [f.name for f in w.forwards]})
    pkg = os.path.join(workdir, f"{name}.vpkg")
    pack_ensemble(pkg, name, members, entry)
    return pkg


def request_rows():
    """Integer pixel values, mean-subtracted, as 1-16 row requests."""
    gen = np.random.default_rng(SEED + 100)
    out = []
    for _ in range(N_REQUESTS):
        n = int(gen.integers(1, 17))
        out.append((gen.integers(0, 256, (n,) + SAMPLE_SHAPE)
                    - 128).astype(np.float32))
    return out


def agree(got: np.ndarray, want: np.ndarray, atol: float, rtol: float,
          spread_frac: float, what: str) -> dict:
    """Probabilities within atol/rtol, and log-probabilities within
    ``spread_frac`` of their spread across classes: with random weights
    the probabilities sit near uniform, so the second check is the one
    that sees a wrong answer."""
    diff = np.abs(got - want)
    check(np.all(diff <= atol + rtol * np.abs(want)),
          f"{what}: probs differ by up to {diff.max():.3g}")
    lg = np.log(np.maximum(got, 1e-30))
    lw = np.log(np.maximum(want, 1e-30))
    spread = float(np.std(lw, axis=-1).min())
    dlog = float(np.abs(lg - lw).max())
    check(dlog <= spread_frac * spread,
          f"{what}: log-probs differ by {dlog:.3g}, spread {spread:.3g}")
    return {"max_abs_err": float(diff.max()), "max_logp_err": dlog,
            "logp_spread": spread}


def norm_layers_in_situ(model, device, rows: np.ndarray) -> list:
    """Each member's forward in bf16 on the card, unit by unit as the
    engine runs it: at every norm layer the kernel's output against the
    plain version's on the same activations, to one bf16 ulp.  Returns,
    per layer, the mean share of the denominator that the alpha term
    makes (how far the layer's output could show an alpha error)."""
    import torch

    from veles_tpu_torch.ops import batching, lrn_cuda
    from veles_tpu_torch.ops.lrn import LRNormalizer

    cast = batching.make_caster(torch.bfloat16)
    params = cast(batching.stack_member_params(
        model.forwards, model.member_params, device))
    shares = []
    with torch.inference_mode():
        for i in range(N_MEMBERS):
            x = device.put(rows).to(torch.bfloat16)
            for f in model.forwards:
                y, _ = f.apply_fwd({p: t[i] for p, t in
                                    params[f.name].items()}, x,
                                   train=False)
                if isinstance(f, LRNormalizer):
                    xc = x.contiguous()
                    check_one_ulp(y, lrn_cuda.lrn_fwd_plain(
                        xc, f.n, f.k, f.alpha, f.beta),
                        f"member {i} {f.name} in situ")
                    c = xc.shape[-1]
                    band = torch.from_numpy(
                        lrn_cuda.band_matrix(c, f.n)).to(xc.device)
                    s = (xc * xc).float().reshape(-1, c) @ band
                    shares.append(float(
                        (f.alpha * s / (f.k + f.alpha * s)).mean()))
                x = y
    return shares


def serve_phase(card: str, workdir: str):
    import torch

    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    from veles_tpu_torch.ops.lrn import LRNormalizer
    from veles_tpu_torch.serve.hive import load_model_package

    t0 = time.perf_counter()
    pkg = build_package(workdir)
    print(f"serve: packed {N_MEMBERS}-member ensemble "
          f"({os.path.getsize(pkg) / 2**20:.1f} MiB) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    # the hive serves the copy fetched from the port's forge
    forge_res, pkg = forge_round_trip(pkg, workdir, card)

    hive = HiveProcess(pkg, workdir)

    def local_model():
        # beside the hive's start: the same package in this process, and
        # its CPU plain path's f32 answers to 4 rows
        device = make_device("cuda")
        model = load_model_package("alexnet", pkg, device,
                                   os.path.join(workdir, "local"),
                                   dict(root.__dict__))
        ecpu = EnsembleEvalEngine(model.forwards, model.member_params,
                                  make_device("cpu"))
        want = ecpu.predict_proba(np.concatenate(request_rows())[:4])
        ecpu.release()
        return device, model, want
    local = _Background(local_model)
    try:
        t0 = time.perf_counter()
        hello = hive.wait_hello()
        check(hello["models"]["alexnet"]["resident"],
              f"model not resident: {hello}")
        print(f"serve: hive ready in {time.perf_counter() - t0:.1f}s "
              f"(platform {hello['platform']})", flush=True)
        # the main path's counts are the hive's own: a fresh process
        # starts them at 0, read here just before the requests and
        # again just after them
        hive.send({"op": "stats", "id": "stats0"})
        stats0 = hive.result("stats0")["stats"]
        check(stats0["kernel_launches"] == {"lrn_fwd": 0}
              and stats0["dispatches"] == 0,
              f"hive counts not zero before the requests: {stats0}")
        reqs = request_rows()
        payloads = [json.dumps({"id": i, "model": "alexnet",
                                "rows": r.tolist()})
                    for i, r in enumerate(reqs)]
        answers, lat = {}, {}
        errors = []

        def worker(ids):
            try:
                for i in ids:
                    ts = time.perf_counter()
                    hive.send(payloads[i])
                    answers[i] = hive.result(i)
                    lat[i] = time.perf_counter() - ts
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=worker,
                                    args=(range(t, N_REQUESTS, N_THREADS),))
                   for t in range(N_THREADS)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t_start
        check(not errors and len(answers) == N_REQUESTS,
              f"requests failed: {errors[:3]}")
        hive.send({"op": "stats", "id": "stats"})
        stats = hive.result("stats")["stats"]
        rc = hive.shutdown()
        check(rc == 0, f"hive shutdown rc {rc}")
    finally:
        hive.kill()

    for i, r in enumerate(reqs):
        a = answers[i]
        check("probs" in a, f"request {i}: {a}")
        probs = np.asarray(a["probs"], np.float32)
        check(a["rows_n"] == len(r) and probs.shape == (len(r),
                                                        N_CLASSES),
              f"request {i}: rows_n {a['rows_n']} shape {probs.shape}")
        check(a["crc"] == zlib.crc32(probs.tobytes()),
              f"request {i}: crc mismatch")
        check(np.all(np.isfinite(probs)), f"request {i}: non-finite")
        check(np.allclose(probs.sum(-1), 1.0, atol=1e-3),
              f"request {i}: probs sum {probs.sum(-1)}")
    # the in-process engine on the card, same package, same dtype
    device, model, want32 = local.result()

    # every dispatch ran both LRN layers for every member on the card
    dispatches = int(stats["dispatches"])
    launches = int(stats["kernel_launches"]["lrn_fwd"])
    n_norm = sum(isinstance(f, LRNormalizer) for f in model.forwards)
    per_dispatch = n_norm * N_MEMBERS
    check(dispatches > 0 and launches == per_dispatch * dispatches,
          f"main path launched lrn_fwd {launches} times in {dispatches} "
          f"dispatches (want {per_dispatch} per dispatch)")

    engine = EnsembleEvalEngine(model.forwards, model.member_params,
                                device)
    # bf16 compute.  Each request runs here zero-padded to the hive's
    # batch shape, so the convolutions pick the algorithms they picked
    # there, but its neighbours in the hive's batch differ; 1e-3 abs on
    # probs, and 5% of the log-prob spread across classes
    worst = {"max_abs_err": 0.0, "max_logp_err": 0.0}
    for i, r in enumerate(reqs):
        xb = np.zeros((MAX_BATCH,) + r.shape[1:], np.float32)
        xb[:len(r)] = r
        res = agree(np.asarray(answers[i]["probs"], np.float32),
                    engine.predict_proba(xb)[:len(r)], 1e-3, 0.0, 0.05,
                    f"request {i} vs in-process engine")
        for key in worst:
            worst[key] = max(worst[key], res[key])

    # device-side dispatch time of the engine at the served batch
    rows64 = np.concatenate(reqs)[:MAX_BATCH]
    check(len(rows64) == MAX_BATCH, f"only {len(rows64)} request rows")
    xb = device.put(rows64)
    dispatch_ms = cuda_ms(engine.predict, [(xb,)], iters=10)
    engine.release()
    alpha_shares = norm_layers_in_situ(model, device, rows64)

    # f32 on the card (TF32 off) against the CPU plain path, 4 rows
    rows4 = np.concatenate(reqs)[:4]
    e32 = EnsembleEvalEngine(model.forwards, model.member_params, device,
                             compute_dtype=torch.float32)
    got = e32.predict_proba(rows4)
    e32.release()
    f32 = agree(got, want32, 0.0, 1e-3, 1e-3, "f32 card vs CPU plain path")

    lat_ms = sorted(v * 1e3 for v in lat.values())
    n_rows = sum(len(r) for r in reqs)
    serve = {"requests": N_REQUESTS, "rows": n_rows,
             "dispatches": dispatches,
             "max_batch_rows": stats["max_batch_rows"],
             "lrn_fwd_launches": launches,
             "launches_per_dispatch": launches / dispatches,
             "p50_ms": lat_ms[len(lat_ms) // 2], "p_max_ms": lat_ms[-1],
             "img_s": n_rows / wall, "wall_s": wall,
             "engine_dispatch_ms_b64": dispatch_ms,
             "engine_img_s_b64": MAX_BATCH / dispatch_ms * 1e3,
             "vs_engine_bf16": worst, "f32_card_vs_cpu": f32,
             "lrn_alpha_share_in_situ": alpha_shares,
             "prob_max": float(max(np.max(a["probs"])
                                   for a in answers.values())),
             "forge": forge_res, "card": card}
    return serve, launches


def forge_round_trip(pkg: str, workdir: str, card: str):
    """Publish ``pkg`` to the port's forge server (127.0.0.1, a free
    port, in a thread) and fetch it into a fresh directory: the fetched
    file's sha256 and manifest the packed file's.  Returns (the line's
    dict, the fetched path)."""
    import hashlib

    from veles_tpu_torch import forge

    def sha256(path):
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
        return h.hexdigest()

    t0 = time.perf_counter()
    server = forge.make_forge_server(os.path.join(workdir, "forge_store"),
                                     port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        published = forge.publish(pkg, url)
        t_pub = time.perf_counter() - t0
        dest = os.path.join(workdir, "forge_fetched")
        got = forge.fetch(published["name"], url, dest)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    seconds = time.perf_counter() - t0
    want = forge.ForgePackage.read_manifest(pkg)
    sums = {"packed": sha256(pkg), "fetched": sha256(got)}
    check(sums["packed"] == sums["fetched"] and os.listdir(dest) ==
          [os.path.basename(pkg)], f"forge: fetched {got} differs: {sums}")
    check(forge.ForgePackage.read_manifest(got) == want and
          {k: v for k, v in published.items() if k != "file"} == want,
          "forge: the fetched or published manifest is not the packed one")
    out = {"bytes": os.path.getsize(got), "sha256": sums["fetched"],
           "sha256_equal": True, "manifest_equal": True,
           "publish_s": t_pub, "publish_fetch_s": seconds}
    print(f"serve: forge published and fetched {out['bytes']} bytes over "
          f"{url} in {seconds:.1f} s (publish {t_pub:.1f} s), sha256 and "
          f"manifest equal the packed file's; the hive serves the fetched "
          f"copy  [{card}]", flush=True)
    return out, got


# -- phase 4: training ----------------------------------------------------

#: the data set cut of the training phase: host generation stays about
#: 20 s; widths and depth are the model's
TRAIN_OVERRIDES = ["root.alexnet.loader.n_train=1024",
                   "root.alexnet.loader.n_valid=128",
                   "root.alexnet.decision.max_epochs=2"]
N_TRAIN, N_VALID, N_EPOCHS, SUPERSTEP = 1024, 128, 2, 8


class _Capture:
    """Wraps a gradient unit's backward_from_saved to keep every
    (x, err) it is given, in order."""

    def __init__(self, gd) -> None:
        self.gd, self.got = gd, []
        self.inner = gd.backward_from_saved
        gd.backward_from_saved = self

    def __call__(self, params, saved, err, *args, **kwargs):
        self.got.append((saved[0].contiguous(), err.contiguous()))
        return self.inner(params, saved, err, *args, **kwargs)

    def restore(self) -> None:
        del self.gd.backward_from_saved


ALEXNET_FILE = os.path.join(HERE, "veles_tpu_torch", "models", "alexnet.py")
SAMPLE_NUMEL = int(np.prod(SAMPLE_SHAPE))


def _launches() -> dict:
    from veles_tpu_torch.ops import lrn_cuda
    return {"lrn_fwd": lrn_cuda.lrn_fwd.launches,
            "lrn_bwd": lrn_cuda.lrn_bwd.launches}


def _zero_launches() -> None:
    from veles_tpu_torch.ops import lrn_cuda
    lrn_cuda.lrn_fwd.launches = lrn_cuda.lrn_bwd.launches = 0


def _want_launches(train_mb: int, valid_mb: int) -> dict:
    """Both norm layers on every minibatch forward, on every train
    minibatch backward."""
    return {"lrn_fwd": 2 * (train_mb + valid_mb), "lrn_bwd": 2 * train_mb}


def _supersteps_per_epoch(n: int) -> int:
    """The loader's firings for one class of ``n`` images."""
    return -(-(-(-n // TRAIN_BATCH)) // SUPERSTEP)


def _read_journal(path: str) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def train_telemetry(metrics_dir: str, sink: str, train_mb: int,
                    valid_mb: int) -> dict:
    """The run's flushed snapshot holds exactly the run's own supersteps,
    minibatches and images; the journal its first dispatch and its
    summary with an MFU; the sink the launcher's log records."""
    from veles_tpu_torch import events, telemetry
    t0 = time.perf_counter()
    path = telemetry.flush()
    flush_ms = 1e3 * (time.perf_counter() - t0)
    check(path is not None, "train: no telemetry snapshot written")
    with open(path) as f:
        snap = json.load(f)
    c = snap["counters"]
    want = {"fused.dispatches": N_EPOCHS * (
                _supersteps_per_epoch(N_TRAIN) +
                _supersteps_per_epoch(N_VALID)),
            "fused.minibatches": train_mb + valid_mb,
            "fused.train_images": N_EPOCHS * N_TRAIN,
            "fused.eval_images": N_EPOCHS * N_VALID}
    got = {k: c.get(k) for k in want}
    check(got == want, f"train: snapshot counters {got}, want {want}")
    journal = _read_journal(os.path.join(
        metrics_dir, f"journal-{os.getpid()}.jsonl"))
    names = [e["event"] for e in journal]
    summary = [e for e in journal if e["event"] == events.EV_FUSED_SUMMARY]
    check(events.EV_FUSED_FIRST_DISPATCH in names and summary
          and summary[-1]["mfu"] is not None and 0 < summary[-1]["mfu"] < 1,
          f"train: journal events {names}, summary {summary}")
    sink_rows = _read_journal(sink)
    launcher_rows = [r for r in sink_rows if r["unit"] == "veles.launcher"]
    check(launcher_rows, f"train: no launcher record among the sink's "
          f"{len(sink_rows)} rows")
    return {"counters": got, "journal_events": len(journal),
            "first_dispatch_s": {e["kind"]: e["seconds"] for e in journal
                                 if e["event"] ==
                                 events.EV_FUSED_FIRST_DISPATCH},
            "summary": summary[-1], "flush_ms": flush_ms,
            "sink_rows": len(sink_rows),
            "launcher_rows": len(launcher_rows),
            "snapshot_bytes": os.path.getsize(path)}


#: the telemetry on/off superstep ratio bar: telemetry adds no sync.
#: A superstep's host-clock time moves 68-92 ms within one run on a busy
#: host, and 3 + 3 supersteps read 0.917, 1.226 and 0.982 in three runs
#: of one tree (NVIDIA H100 80GB HBM3, 700 W), so the medians are over
#: TELEMETRY_PAIRS a side (about 1 s more), the bar unchanged
TELEMETRY_RATIO_BAR, TELEMETRY_PAIRS = 1.15, 9


def telemetry_on_off(w) -> dict:
    """TELEMETRY_PAIRS + TELEMETRY_PAIRS train supersteps, alternately
    with telemetry on and off (each pair's order the other way round
    from the one before), each from an idle card to a synchronized one
    (host clock): the median on over the median off."""
    import torch

    from veles_tpu_torch import telemetry
    ms = {True: [], False: []}
    order = [(True, False), (False, True)] * (TELEMETRY_PAIRS // 2) + \
        [(True, False)] * (TELEMETRY_PAIRS % 2)
    try:
        for on in (side for pair in order for side in pair):
            telemetry.set_enabled(on)
            _next_train_superstep(w)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w.fused.run()
            torch.cuda.synchronize()
            ms[on].append(1e3 * (time.perf_counter() - t0))
            w.fused.take_class_metrics()
    finally:
        telemetry.set_enabled(True)
    ratio = float(np.median(ms[True]) / np.median(ms[False]))
    check(ratio <= TELEMETRY_RATIO_BAR,
          f"train: telemetry on/off superstep ratio {ratio:.3f} over "
          f"{TELEMETRY_RATIO_BAR} (on {ms[True]}, off {ms[False]} ms)")
    return {"on_ms": ms[True], "off_ms": ms[False], "ratio": ratio,
            "bar": TELEMETRY_RATIO_BAR}


def _plot_spy(on_event=None) -> list:
    """Every plot event the process's graphics server is handed, kept
    unrendered (the card's machine has no matplotlib); ``on_event(e)``,
    if given, runs at each."""
    from veles_tpu_torch import graphics_server
    graphics_server.shutdown_server()
    server = graphics_server.get_server()
    server.render = False
    events = []

    def enqueue(event):
        events.append(event)
        if on_event is not None:
            on_event(event)
    server.enqueue = enqueue
    return events


def _curves(history, field: str) -> dict:
    """The series a curve plotter builds from ``history``."""
    from veles_tpu_torch.loader.base import CLASS_NAMES
    out = {}
    for name in CLASS_NAMES:
        rows = [h for h in history if h["class"] == name]
        if rows:
            out[name] = ([h["epoch"] for h in rows],
                         [h[field] for h in rows])
    return out


def _check_plots(w, events, epochs: int, what: str) -> dict:
    """The plotters fired once per epoch each; the last curve events are
    the decision's history; plt_weights is the first forward's weights
    as the reference's ``_to_tiles`` makes them (a conv: one tile per
    output channel, HWC, scaled to [0, 1] over all of them), from the
    card's params here."""
    names = [p.name for p in w.plotters]
    per = {n: [e for e in events if e["plotter"] == n] for n in names}
    check(all(len(v) == epochs for v in per.values())
          and len(events) == epochs * len(names),
          f"{what}: plot events {[(n, len(v)) for n, v in per.items()]}, "
          f"{epochs} epochs")
    # the history as the last train class end left it (a run stopped at
    # a validation end has one row more)
    hist = w.decision.history
    hist = hist[:max(i for i, h in enumerate(hist)
                     if h["class"] == "train") + 1]
    for field, name in (("error_pct", "plt_error"), ("loss", "plt_loss")):
        last = per[name][-1]
        check(last["series"] == _curves(hist, field),
              f"{what}: {name}'s last series {last['series']}")
    f = w.forwards[0]
    wt = w.fused.device_params(f.name)["weights"]
    check(wt.dim() == 4 and "plt_weights" in per,
          f"{what}: {f.name}'s weights {tuple(wt.shape)}, plotters {names}")
    t = wt.float().cpu().numpy().transpose(0, 2, 3, 1)   # (O, H, W, I)
    if t.shape[-1] == 3:
        want = (t - t.min()) / max(float(t.max() - t.min()), 1e-12)
    else:
        want = t.mean(-1)
    want = want[:25]
    tiles = np.asarray(per["plt_weights"][-1]["tiles"])
    check(tiles.shape == want.shape,
          f"{what}: plt_weights tiles {tiles.shape}, want {want.shape}")
    err = float(np.abs(tiles - want).max())
    check(err <= 1e-6, f"{what}: plt_weights tiles differ from "
          f"{f.name}'s weights by {err:.3g}")
    return {"events": len(events), "names": names, "tiles": len(tiles),
            "tile_shape": list(tiles.shape[1:]), "tiles_max_abs_err": err}


class _StatusPage:
    """A port web status page on a free localhost port over the phase's
    metrics dir; ``attach`` hands its URL to a launcher with the
    plotters, so the run posts its status after every epoch."""

    def __init__(self, metrics_dir: str) -> None:
        from veles_tpu_torch.web_status import WebStatusServer
        self.server = WebStatusServer(port=0, host="127.0.0.1",
                                      metrics_dir=metrics_dir)
        self.server.start_background()
        self.url = f"http://127.0.0.1:{self.server.port}"
        self.metrics_dir = metrics_dir

    def attach(self, launcher) -> None:
        launcher.plotters = True
        launcher.status_server = self.url

    def _get(self, path: str):
        import urllib.request
        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            return json.loads(r.read())

    def check(self, w) -> dict:
        """``/api/status`` holds the run's last epoch and error figures,
        the decision's; ``/api/metrics`` is the port's ``obs.load_dir``
        of the dir."""
        from veles_tpu_torch import obs
        t0 = time.perf_counter()
        runs = self._get("/api/status")
        got = self._get("/api/metrics")
        ms = 1e3 * (time.perf_counter() - t0)
        d = w.decision
        check(len(runs) == 1, f"status page: runs {list(runs)}")
        (run,) = runs.values()
        want = {"epoch": w.loader.epoch_number,
                "train_error_pct": round(d.epoch_error_pct[2], 2),
                "valid_error_pct": round(d.epoch_error_pct[1], 2),
                "min_valid_error": d.min_valid_error, "complete": True}
        check({k: run.get(k) for k in want} == want,
              f"status page: {run} against the decision's {want}")
        reg, snaps, _journals, events = obs.load_dir(self.metrics_dir)
        merged = reg.snapshot()
        merged["snapshots"] = len(snaps)
        merged["journal_events"] = len(events)
        # a training dir's views: the arbiter's ledger (no fleet, no
        # learner there)
        arbiter = obs.arbiter_ledger(reg)
        if arbiter:
            merged["arbiter"] = arbiter
        check(not obs.fleet_rows(self.metrics_dir)
              and not obs.learner_rows(reg, events),
              "status page: a fleet or learner in the training dir")
        check(got == json.loads(json.dumps(merged)),
              f"status page: /api/metrics differs from obs.load_dir: "
              f"{sorted(got)} / {sorted(merged)}")
        return {"status": {k: run[k] for k in want}, "ms": ms,
                "metrics_keys": len(got)}

    def close(self) -> None:
        self.server.shutdown()


def _plot_cli() -> dict:
    """``python -m veles_tpu_torch -p`` on a cut mnist: where matplotlib
    does not import it must exit 2 naming it, before the card; where it
    does, the run writes the four PNGs."""
    import tempfile
    plots = tempfile.mkdtemp(prefix="smoke_plots_")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch", "-p",
             os.path.join(MODELS_DIR, "mnist.py"),
             "root.mnist.loader.n_train=1200",
             "root.mnist.loader.n_valid=300",
             "root.mnist.decision.max_epochs=1"], cwd=HERE,
            env=dict(os.environ, VELES_PLOTS_DIR=plots),
            capture_output=True, text=True, timeout=300)
        made = sorted(os.listdir(plots))
    finally:
        shutil.rmtree(plots, ignore_errors=True)
    import importlib.util
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if have_mpl:
        want = ["plt_confusion.png", "plt_error.png", "plt_loss.png",
                "plt_weights.png"]
        check(proc.returncode == 0 and made == want,
              f"CLI -p: rc {proc.returncode}, wrote {made}: "
              f"{proc.stderr[-2000:]}")
        outcome = f"rc 0, wrote {made}"
    else:
        check(proc.returncode == 2 and "matplotlib" in proc.stderr
              and not made, f"CLI -p without matplotlib: rc "
              f"{proc.returncode}, wrote {made}: {proc.stderr[-2000:]}")
        outcome = f"rc 2 without matplotlib: {proc.stderr.strip()}"
    return {"rc": proc.returncode, "matplotlib": have_mpl, "files": made,
            "outcome": outcome}


def train_phase(card: str, workdir: str, resident: dict):
    """Full-width AlexNet, 2 epochs, through the port's entry path, with
    a metrics dir and an event sink, on deterministic cuDNN: it is also
    the stream phase's resident run, whose history, params, launches and
    3 supersteps' ms (timed on deterministic cuDNN, as that phase times
    its streamed ones) go into ``resident``.  Returns the readings and the
    workflow (the profile phase goes on with it)."""
    import torch

    from veles_tpu_torch import telemetry
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.logger import add_jsonl_sink
    from veles_tpu_torch.ops import lrn_cuda
    from veles_tpu_torch.ops.lrn import GDLRNormalizer

    metrics_dir = os.path.join(workdir, "train_metrics")
    sink = os.path.join(workdir, "train_events.jsonl")
    telemetry.reset()
    telemetry.configure(metrics_dir)
    detach = add_jsonl_sink(sink)
    page = _StatusPage(metrics_dir)
    epoch1 = _EpochDelta()
    # deterministic cuDNN: this run is held against the streamed one
    torch.backends.cudnn.deterministic = True
    try:
        events = _plot_spy()
        with epoch1:
            launcher, launches, total_s = _drive(
                TRAIN_OVERRIDES, before=page.attach)
        w = launcher.workflow
        resident.update(history=list(w.decision.history),
                        params=w.fused.host_params(), launches=launches,
                        drive_s=total_s,
                        device_resident=w.loader.device_resident,
                        streaming=w.fused.streaming)
    except BaseException:
        page.close()
        raise
    finally:
        torch.backends.cudnn.deterministic = False
        detach()
    # the first epoch's sampled param change: phase 25 holds its
    # data-parallel run's against it
    np.savez(os.path.join(workdir, "dp_delta_train_0.npz"), **epoch1.delta())
    w = launcher.workflow
    plots = _check_plots(w, events, N_EPOCHS, "train")
    # the port's AlexNet accumulates the confusion matrix (the
    # reference's turns it off): its plotter fires too
    want = ["plt_error", "plt_loss"] + \
        ["plt_confusion"] * bool(w.evaluator.compute_confusion) + \
        ["plt_weights"]
    check(plots["names"] == want and plots["tiles"] == 25
          and plots["tile_shape"] == [11, 11, 3],
          f"train: plotters {plots['names']}, {plots['tiles']} tiles of "
          f"{plots['tile_shape']}")
    if "plt_confusion" in want:
        from veles_tpu_torch.loader.base import VALID
        matrix = np.asarray([e for e in events if e["plotter"] ==
                             "plt_confusion"][-1]["matrix"])
        check(np.array_equal(matrix, w.decision.confusion_per_class[VALID])
              and int(matrix.sum()) == N_VALID,
              f"train: plt_confusion's matrix (sum {int(matrix.sum())}) "
              f"is not the decision's validation confusion")
    ld, fused = w.loader, w.fused
    check(ld.max_minibatch_size == TRAIN_BATCH and
          w.superstep == SUPERSTEP and fused.compute_dtype ==
          torch.bfloat16, f"not the configured run: mb "
          f"{ld.max_minibatch_size}, superstep {w.superstep}, "
          f"{fused.compute_dtype}")
    n_norm = sum(isinstance(gd, GDLRNormalizer) for gd in w.gds)
    train_mb = N_EPOCHS * N_TRAIN // TRAIN_BATCH
    valid_mb = N_EPOCHS * -(-N_VALID // TRAIN_BATCH)
    check(n_norm == 2 and launches == _want_launches(train_mb, valid_mb),
          f"training path launches {launches} with {n_norm} norm layers, "
          f"{train_mb} train and {valid_mb} validation minibatches")
    hist = w.decision.history
    check([(r["class"], r["count"]) for r in hist] ==
          [("validation", N_VALID), ("train", N_TRAIN)] * N_EPOCHS,
          f"history {hist}")
    check(all(np.isfinite(r["loss"]) for r in hist),
          f"non-finite loss in {hist}")
    check(w.decision.complete, "decision did not complete")
    try:
        tel = train_telemetry(metrics_dir, sink, train_mb, valid_mb)
    finally:
        telemetry.configure(None)
    try:
        status = page.check(w)
    finally:
        page.close()
    cli = _plot_cli()

    # the stream phase's resident supersteps: timed as it times its
    # streamed ones, 3 of them on deterministic cuDNN as both drives ran
    torch.backends.cudnn.deterministic = True
    try:
        resident["superstep_ms"] = [
            t[0] for t in _time_train_supersteps(w, 3)]
    finally:
        torch.backends.cudnn.deterministic = False
    # one train superstep timed with CUDA events on cuDNN's default
    # algorithms, after one that sets them up, timed apart (the loader
    # goes on past the last epoch: a validation firing, then train)
    default_ms = []
    for _ in range(2):
        ld.run()
        ld.run()
        check(ld.minibatch_class == TRAIN and ld.superstep_k == SUPERSTEP,
              f"no full train superstep: class {ld.minibatch_class}, k "
              f"{ld.superstep_k}")
        w.lr_adjust.run()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        start.record()
        fused.run()
        end.record()
        torch.cuda.synchronize()
        default_ms.append(start.elapsed_time(end))
        fused.take_class_metrics()
    superstep_ms = default_ms[-1]

    # in situ: each norm layer's backward at a real training minibatch
    caps = [_Capture(gd) for gd in w.gds if isinstance(gd, GDLRNormalizer)]
    try:
        fused.run()
        torch.cuda.synchronize()
    finally:
        for cap in caps:
            cap.restore()
    fused.take_class_metrics()
    in_situ = []
    for cap in caps:
        f = cap.gd.forward
        x, err = cap.got[0]
        check(x.dtype == err.dtype == torch.bfloat16,
              f"{cap.gd.name}: saw {x.dtype} / {err.dtype}")
        out = lrn_cuda.lrn_bwd(x, err, f.n, f.k, f.alpha, f.beta)
        ref = lrn_cuda.lrn_bwd_plain(x, err, f.n, f.k, f.alpha, f.beta)
        torch.cuda.synchronize()
        check_bwd_bf16(out, ref, x, err, f.n, f.k, f.alpha,
                       f"{cap.gd.name} in situ", f.beta)
        a, b = bwd_terms(x, err, f.n, f.k, f.alpha, f.beta)
        in_situ.append({"layer": cap.gd.name, "shape": list(x.shape),
                        "max_abs_err": float((out.float() - ref.float())
                                             .abs().max()),
                        "window_term_share": float(
                            (b / (a + b).clamp(min=1e-30)).mean())})
    tel["on_off"] = telemetry_on_off(w)
    # the trained model exported and answered by native/
    off = ld.class_offset(1)   # the validation class
    nat = native_vs_card(w, ld.normalized_host_rows(
        slice(off, off + NATIVE_ALEXNET_ROWS)),
        os.path.join(workdir, "alexnet.vtpn"), "alexnet export")
    check(nat["launches"] == {"lrn_fwd": 4, "lrn_bwd": 0},
          f"alexnet export: the card's forward and the scaled norm "
          f"inputs launched {nat['launches']}")
    print(f"train: exported {nat['file_bytes']} bytes in "
          f"{nat['export_s']:.2f} s; native/ loaded it in "
          f"{nat['load_s']:.2f} s and answered {nat['rows']} rows in "
          f"{nat['native_s']:.2f} s, max abs {nat['max_abs_err']:.3g} from "
          f"the card's f32 forward (limit {NATIVE_ATOL}), "
          f"{nat['max_rel_err']:.3g} of its largest probability (limit "
          f"{NATIVE_REL}), argmax equal on {nat['decided_rows']} decided "
          f"rows, lrn_fwd {nat['launches']['lrn_fwd']}  [{card}]",
          flush=True)
    for r in nat["lrn_layers"]:
        print(f"train: {r['layer']} {r['shape']} alone, native's LRN vs "
              f"lrn_fwd: max abs {r['max_abs_err']:.3g}, "
              f"{r['max_rel_err']:.3g} of the largest output (limit "
              f"{NATIVE_LRN_REL}); the window's part "
              f"{r['window_part']:.3g}; scaled x{r['scale']:.4g} "
              f"(alpha * window sum / k {r['scaled_load']:.3g}): max abs "
              f"{r['scaled_max_abs_err']:.3g}, {r['scaled_max_rel_err']:.3g}"
              f" of the largest output, the window's part "
              f"{r['scaled_window_part']:.3g} (at least "
              f"{NATIVE_LRN_WINDOW_PART})  [{card}]", flush=True)
    print(f"train: plots {plots['events']} events ({plots['names']}), "
          f"plt_weights {plots['tiles']} tiles of {plots['tile_shape']} "
          f"equal to conv1's (max abs {plots['tiles_max_abs_err']:.3g}), "
          f"curves equal to the decision's history; status page "
          f"{status['status']}, /api/metrics equal to obs.load_dir "
          f"({status['metrics_keys']} keys) in {status['ms']:.1f} ms; "
          f"CLI -p: {cli['outcome']}  [{card}]", flush=True)
    print(f"train: telemetry {tel['counters']}, flush "
          f"{tel['flush_ms']:.2f} ms ({tel['snapshot_bytes']} bytes), MFU "
          f"{tel['summary']['mfu']} at {tel['summary']['images_per_sec_wall']}"
          f" img/s delivered, {tel['journal_events']} journal lines, "
          f"{tel['launcher_rows']} of {tel['sink_rows']} sink rows the "
          f"launcher's; superstep ms on {tel['on_off']['on_ms']} off "
          f"{tel['on_off']['off_ms']} (ratio {tel['on_off']['ratio']:.3f}, "
          f"bar {TELEMETRY_RATIO_BAR})  [{card}]", flush=True)
    images = N_EPOCHS * (N_TRAIN + N_VALID)
    return {"epochs": N_EPOCHS, "minibatch": TRAIN_BATCH,
            "superstep": SUPERSTEP, "dtype": "bfloat16",
            "train_minibatches": train_mb,
            "valid_minibatches": valid_mb, "launches": launches,
            "history": hist, "superstep_ms": superstep_ms,
            "first_default_superstep_ms": default_ms[0],
            "ms_per_train_minibatch": superstep_ms / SUPERSTEP,
            "train_img_s": SUPERSTEP * TRAIN_BATCH / superstep_ms * 1e3,
            "run_wall_s": w.wall_time, "run_img_s_wall":
            images / w.wall_time, "drive_wall_s": total_s,
            "lrn_bwd_in_situ": in_situ, "telemetry": tel,
            "export": nat, "plots": plots, "status_page": status,
            "plot_cli": cli, "card": card}, w


# -- phase 5: one step on the card against the CPU plain path -----------

class _Routed(_Capture):
    """A max-pool gradient unit whose choices are recorded and, given
    ``indices`` (per call, in order: the (N, C, OH, OW) flat H*W
    positions of ``F.max_pool2d(..., return_indices=True)``), replayed:
    it then scatters its error to the inputs they name, summing where
    windows overlap, as the pool's own backward does with its own
    argmax.  ``choices()``: per call, its own argmax and its input."""

    def __init__(self, gd, indices=None) -> None:
        super().__init__(gd)
        self.indices = indices

    def __call__(self, params, saved, err, *args, **kwargs):
        import torch
        if self.indices is None:
            return super().__call__(params, saved, err, *args, **kwargs)
        x = saved[0]
        self.got.append((x.contiguous(), err.contiguous()))
        n, h, w, c = x.shape
        idx = torch.from_numpy(self.indices[len(self.got) - 1]).to(x.device)
        g = torch.zeros(n, c, h * w, dtype=err.dtype, device=x.device)
        g.scatter_add_(2, idx.reshape(n, c, -1),
                       err.permute(0, 3, 1, 2).reshape(n, c, -1))
        return g.reshape(n, c, h, w).permute(0, 2, 3, 1), {}

    def choices(self):
        import torch.nn.functional as F
        f = self.gd.forward
        return [(F.max_pool2d(x.permute(0, 3, 1, 2), (f.ky, f.kx),
                              f.sliding, return_indices=True)[1]
                 .cpu().numpy(), x.cpu()) for x, _ in self.got]


class _Masked:
    """A ReLU gradient unit whose choices are recorded and, given
    ``masks`` (per call, in order: output > 0), replayed in place of its
    own.  ``choices()``: per call, its own mask and its output."""

    def __init__(self, gd, masks=None) -> None:
        self.gd, self.masks, self.got = gd, masks, []
        self.inner = gd.act_deriv
        gd.act_deriv = self

    def __call__(self, output, err_output):
        import torch
        self.got.append(output.detach().cpu())
        if self.masks is None:
            return self.inner(output, err_output)
        mask = torch.from_numpy(self.masks[len(self.got) - 1])
        return err_output * mask.to(output.device, output.dtype)

    def restore(self) -> None:
        del self.gd.act_deriv

    def choices(self):
        return [((y > 0).numpy(), y) for y in self.got]


def _one_f32_step(backend: str, replay=None):
    """One train superstep of k = 2 minibatches of 32, dropout 0, f32,
    from the SEED params and indices: (params before, after, metrics,
    indices, {gradient unit: its own choices}), the choices those of
    every max pool and every ReLU in each minibatch (``_Routed``,
    ``_Masked``).  With ``replay`` ({gradient unit: choices per
    minibatch}), each of those units makes the given choices instead."""
    import torch

    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.models import alexnet
    from veles_tpu_torch.ops.pooling import MaxPooling

    class FL:
        workflow = None

    prng.seed_all(SEED)
    loader = dict(alexnet.DEFAULTS["loader"], minibatch_size=32,
                  n_train=64, n_valid=0)
    w = alexnet.create_workflow(FL(), loader=loader, dropout=0.0)
    w.superstep = 2
    w.fused.compute_dtype = torch.float32
    w.initialize(device=make_device(backend), train=True)
    before = w.fused.host_params()
    w.loader.run()
    check(w.loader.minibatch_class == TRAIN and w.loader.superstep_k == 2,
          "card-vs-CPU step: no 2-minibatch train superstep")
    w.lr_adjust.run()
    replay = replay or {}
    caps = [_Routed(gd, replay.get(gd.name))
            if isinstance(gd.forward, MaxPooling) else
            _Masked(gd, replay.get(gd.name)) for gd in w.gds
            if isinstance(gd.forward, MaxPooling)
            or gd.forward.activation_mode == "relu"]
    try:
        w.fused.run()
    finally:
        for cap in caps:
            cap.restore()
    return before, w.fused.host_params(), w.fused.take_class_metrics(), \
        w.loader.superstep_indices, {cap.gd.name: cap.choices()
                                     for cap in caps}


#: the largest gap, relative, at which the card and the CPU may choose
#: apart at a max pool or a ReLU: f32 on the two devices disagrees by
#: about 1e-6 of a layer's scale
TIE = 1e-5


def _flip_gap(card, cpu) -> tuple:
    """(choices that differ, choices, the largest near-tie gap among
    them, how many of them lie in near-zero windows, the largest gap
    among those) of one unit over the step's minibatches.  A max pool's
    gap is how far apart, relative to the window's max, the CPU's inputs
    at the two chosen positions lie.  A window whose max is itself a
    near zero (within ``TIE`` of the layer's largest input, as where a
    ReLU below it chose near its tie in a window of zeros) has no scale
    of its own: its gap is taken relative to the layer's largest input,
    as a ReLU's is.  A ReLU's gap is the larger of the two devices'
    outputs there, relative to the layer's largest output."""
    import torch
    n_flip = n_all = n_zero = 0
    gap = zero_gap = 0.0
    for (c_dec, c_val), (own, val) in zip(card, cpu):
        n_all += own.size
        flip = c_dec != own
        n_flip += int(flip.sum())
        if not flip.any():
            continue
        at = torch.from_numpy(flip)
        top = val.abs().max().clamp(min=1e-30)
        if own.dtype == bool:             # a ReLU: mask and outputs
            g = torch.maximum(val[at].abs(), c_val[at].abs()).max() / top
            gap = max(gap, float(g))
            continue
        xf = val.permute(0, 3, 1, 2).flatten(2)   # a max pool: its inputs
        theirs, mine = [xf.gather(2, torch.from_numpy(i).flatten(2))
                        .reshape(i.shape)[at] for i in (c_dec, own)]
        zero = mine.abs() <= TIE * top
        d = (mine - theirs).abs()
        n_zero += int(zero.sum())
        if (~zero).any():
            gap = max(gap, float((d[~zero] / mine[~zero].abs()).max()))
        if zero.any():
            zero_gap = max(zero_gap, float(d[zero].max() / top))
    return n_flip, n_all, gap, n_zero, zero_gap


def _rel_delta_diff(before, after_a, after_b) -> dict:
    """Per param, ``|da - db| / |db|`` of the two steps' changes."""
    out = {}
    for fn, ps in before.items():
        for pn, b in ps.items():
            da, db = after_a[fn][pn] - b, after_b[fn][pn] - b
            out[f"{fn}.{pn}"] = float(np.linalg.norm(da - db)
                                      / max(np.linalg.norm(db), 1e-30))
    return out


def card_vs_cpu_phase() -> dict:
    """The card's f32 step against the CPU plain path's, every param's
    change within 1e-3 relative.  Where a max-pool window's two largest
    inputs, or a ReLU's input and zero, lie closer than the two devices'
    f32 disagreement (about 1e-6 relative), the two may choose apart,
    and one such choice moves the error of every layer below it by about
    1e-3 of its norm.  So the CPU step replays the card's choices at
    every max pool and ReLU, and each choice the CPU would have made
    otherwise must be a near tie (gap within ``TIE``, see ``_flip_gap``:
    a pool window whose max is a near zero is measured as a ReLU is) and
    such choices rare (under 1e-4 of all: a fault would flip far
    more)."""
    import torch
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    b_card, a_card, m_card, i_card, c_card = _one_f32_step("cuda")
    b_cpu, a_cpu, m_cpu, i_cpu, c_cpu = _one_f32_step(
        "cpu", {name: [dec for dec, _ in got]
                for name, got in c_card.items()})
    check(np.array_equal(i_card, i_cpu), "different minibatch indices")
    flips = {}
    for name, got in c_cpu.items():
        n_flip, n_all, gap, n_zero, zero_gap = _flip_gap(c_card[name], got)
        check(n_flip <= 1e-4 * n_all and gap <= TIE and zero_gap <= TIE,
              f"{name}: {n_flip} of {n_all} choices differ between card "
              f"and CPU, the widest {gap:.3g} apart (relative); "
              f"{n_zero} in near-zero windows, the widest {zero_gap:.3g} "
              f"apart (relative to the layer's largest input)")
        flips[name] = {"differ": n_flip, "of": n_all, "gap": gap,
                       "near_zero_windows": n_zero,
                       "near_zero_gap": zero_gap}
    for fn in b_cpu:
        for pn in b_cpu[fn]:
            check(np.array_equal(b_card[fn][pn], b_cpu[fn][pn]),
                  f"{fn}.{pn}: different initial params")
    rel = _rel_delta_diff(b_card, a_card, a_cpu)
    for pn, r in rel.items():
        check(r <= 1e-3, f"{pn}: the step's change differs by {r:.3g} "
              f"(relative, limit 1e-3) between card and CPU")
    check(m_card[0] == m_cpu[0] and m_card[2] == m_cpu[2],
          f"n_err/count differ: card {m_card}, cpu {m_cpu}")
    # for the record, not held to a limit: the CPU step on its own
    # choices, what the near ties alone move
    a_own = _one_f32_step("cpu")[1]
    return {"rel_delta_diff": rel, "near_tie_choices": flips,
            "rel_delta_diff_cpu_own_choices": _rel_delta_diff(
                b_card, a_card, a_own),
            "n_err": m_card[0], "count": m_card[2],
            "loss_card": m_card[1], "loss_cpu": m_cpu[1]}


# -- phases 6 and 7: streaming, preemption and resume ---------------------

def same_run(hist_a, params_a, hist_b, params_b, init) -> dict:
    """Two runs of one configuration on the card.  Bitwise (the history
    and every param equal) is reported; what is held is the card-vs-CPU
    phase's rule: the same classes and counts in the history, and every
    param's change from ``init`` within 1e-3 relative."""
    rows = [(r["epoch"], r["class"], r["count"]) for r in hist_a]
    check(rows == [(r["epoch"], r["class"], r["count"]) for r in hist_b],
          f"different histories: {hist_a} vs {hist_b}")
    rel = _rel_delta_diff(init, params_a, params_b)
    worst = max(rel.values())
    check(worst <= 1e-3, f"a param's change differs by {worst:.3g} "
          f"(relative, limit 1e-3) between the two runs: {rel}")
    bitwise = all(np.array_equal(params_a[f][p], params_b[f][p])
                  for f in params_a for p in params_a[f])
    return {"history_equal": hist_a == hist_b, "params_bitwise": bitwise,
            "max_rel_delta_diff": worst}


def _initial_params(w) -> dict:
    """The params the run started from: the ``"weights"`` stream drawn
    again from SEED, as the launcher's run drew it."""
    from veles_tpu_torch import prng
    prng.seed_all(SEED)
    return {f.name: f.fill_params() for f in w.forwards}


def param_sample(params, n: int) -> dict:
    """``{"fwd|param": f64 values}`` of each param at ``n`` positions
    drawn from a seed of its name (all of them where it has fewer):
    what two runs' param changes are compared at."""
    out = {}
    for f in sorted(params):
        for p in sorted(params[f]):
            a = np.asarray(params[f][p]).reshape(-1)
            rng = np.random.default_rng(zlib.crc32(f"{f}|{p}".encode()))
            idx = rng.choice(a.size, min(a.size, n), replace=False)
            out[f"{f}|{p}"] = a[np.sort(idx)].astype(np.float64)
    return out


class _EpochDelta:
    """Wraps ``FusedStepRunner.take_class_metrics`` for one run: samples
    (``param_sample``) the params at the first class end (the first
    epoch's validation, before any update) and at the first TRAIN class
    end; ``delta()`` is the first epoch's change there."""

    def __enter__(self):
        from veles_tpu_torch.loader.base import TRAIN
        from veles_tpu_torch.ops.fused import FusedStepRunner
        self.cls = FusedStepRunner
        self.take = FusedStepRunner.take_class_metrics
        self.samples = []
        take, samples = self.take, self.samples

        def taking(runner):
            out = take(runner)
            if not samples or (len(samples) == 1 and
                               runner.loader.minibatch_class == TRAIN):
                samples.append(param_sample(runner.host_params(),
                                            DP_SAMPLE))
            return out
        FusedStepRunner.take_class_metrics = taking
        return self

    def __exit__(self, *exc):
        self.cls.take_class_metrics = self.take

    def delta(self) -> dict:
        check(len(self.samples) == 2, f"{len(self.samples)} of the first "
              f"epoch's two class ends sampled")
        before, after = self.samples
        return {k: after[k] - before[k] for k in after}


def _drive(overrides, backend="cuda", workflow_file=ALEXNET_FILE,
           before=None):
    """One run through Launcher + drive_workflow with the config cut
    by ``overrides``; the launch counts zeroed just before, read just
    after; ``before(launcher)``, if given, is called first (to wrap the
    launcher's steps).  Returns (launcher, launches, seconds)."""
    import torch

    from veles_tpu_torch.config import parse_overrides, root
    from veles_tpu_torch.launcher import Launcher, drive_workflow
    # a deep copy: the overrides write into nodes (root.alexnet.loader)
    # that earlier phases created, and must not leak into later runs
    saved_root = copy.deepcopy(dict(root.__dict__))
    parse_overrides(overrides)
    try:
        launcher = Launcher(backend=backend, seed=SEED)
        if before is not None:
            before(launcher)
        _zero_launches()
        t0 = time.perf_counter()
        drive_workflow(launcher, workflow_file)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches()
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved_root)
    return launcher, launches, seconds


def _time_train_supersteps(w, n: int) -> list:
    """Per train firing (loader, lr_adjust, fused step), ``n`` of them,
    each started right after the validation firing before it has
    finished on the card: (ms between CUDA events around it, host ms
    spent staging and queueing its upload, host ms its assembly took).
    The last two are 0 on the resident path."""
    import torch

    from veles_tpu_torch.loader.base import TRAIN
    ld, fused = w.loader, w.fused
    out = []
    while len(out) < n:
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        stage_s, assemble_s = fused.stream_transfer_seconds, \
            ld.assemble_seconds
        start.record()
        ld.run()
        w.lr_adjust.run()
        fused.run()
        end.record()
        torch.cuda.synchronize()
        if ld.class_ended:
            fused.take_class_metrics()
        if ld.minibatch_class == TRAIN:
            check(ld.superstep_k == SUPERSTEP, f"train k {ld.superstep_k}")
            out.append((start.elapsed_time(end),
                        (fused.stream_transfer_seconds - stage_s) * 1e3,
                        (ld.assemble_seconds - assemble_s) * 1e3))
    ld.stop()
    return out


def _assembly_breakdown(ld) -> dict:
    """Host ms of each step of one train superstep's assembly, on the
    rows of the current epoch's first superstep: the gather as the
    loader does it (``index_select``) into a new tensor and into one
    already touched, numpy's ``take`` beside it, the bf16 cast into a new
    tensor and into a touched one, and the copy into a pinned buffer."""
    import torch

    from veles_tpu_torch.loader.base import TRAIN
    idx = ld._order[TRAIN][:SUPERSTEP * TRAIN_BATCH]
    host, tidx = torch.from_numpy(ld.host_data), torch.from_numpy(idx)
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        out[name] = (time.perf_counter() - t0) * 1e3
        return res
    rows = timed("gather_new", lambda: host.index_select(0, tidx))
    timed("gather_touched", lambda: torch.index_select(host, 0, tidx,
                                                       out=rows))
    timed("numpy_take_new", lambda: np.take(ld.host_data, idx, axis=0))
    bf = timed("cast_new", lambda: rows.to(torch.bfloat16))
    timed("cast_touched", lambda: bf.copy_(rows))
    pinned = torch.empty(bf.shape, dtype=bf.dtype, pin_memory=True)
    timed("stage_pinned", lambda: pinned.copy_(bf))
    out["threads"] = torch.get_num_threads()
    return out


def stream_phase(card: str, workdir: str, resident: dict) -> dict:
    """Full-width AlexNet streamed from the host, held against the
    resident run of the same cut data, config and seed: phase 4's
    (``resident``, its drive on deterministic cuDNN as this one's)."""
    import torch

    torch.backends.cudnn.deterministic = True
    try:
        launcher, launches, seconds = _drive(
            TRAIN_OVERRIDES + ["root.alexnet.loader.max_resident_bytes=0"])
        ws = launcher.workflow
        runs = {"resident": resident,
                "stream": {"w": ws, "launches": launches, "drive_s": seconds,
                           "history": list(ws.decision.history),
                           "params": ws.fused.host_params()}}
        ld, fused = ws.loader, ws.fused
        check(not ld.device_resident and ld.original_data is None
              and fused.streaming and ld.stream_dtype == torch.bfloat16
              and resident["device_resident"] and not resident["streaming"],
              "the stream phase's runs are not streamed and resident")
        train_mb = N_EPOCHS * N_TRAIN // TRAIN_BATCH
        valid_mb = N_EPOCHS * -(-N_VALID // TRAIN_BATCH)
        for path, run in runs.items():
            check(run["launches"] == _want_launches(train_mb, valid_mb),
                  f"{path} run launched {run['launches']} for {train_mb} "
                  f"train and {valid_mb} validation minibatches")
        check(ld.assembled_minibatches == train_mb + valid_mb,
              f"{ld.assembled_minibatches} minibatches streamed")
        row_bytes = SAMPLE_NUMEL * 2 + 8          # bf16 samples, int64 label
        want_bytes = (train_mb + valid_mb) * TRAIN_BATCH * row_bytes
        streamed_bytes = fused.stream_transfer_bytes
        check(streamed_bytes == want_bytes,
              f"streamed {streamed_bytes} bytes, want "
              f"{want_bytes} (bf16 samples and int64 labels)")
        init = _initial_params(ws)
        same = same_run(runs["stream"]["history"], runs["stream"]["params"],
                        runs["resident"]["history"],
                        runs["resident"]["params"], init)
        for r in runs["stream"]["history"]:
            check(np.isfinite(r["loss"]), f"non-finite loss {r}")

        streamed = _time_train_supersteps(ws, 3)
        h2d_ms = fused.last_copy_ms()
        breakdown = _assembly_breakdown(ld)
        assemble_ms = float(np.mean([t[2] for t in streamed]))
        stage_ms = float(np.mean([t[1] for t in streamed]))
        # the resident supersteps: phase 4's run's, timed there as these
        timed = {"stream": [t[0] for t in streamed],
                 "resident": resident["superstep_ms"]}

        # the snapshot saves (file IO and zlib, off the GIL) run beside
        # phase 7; the loads, which put back the process's prng streams,
        # come after it (``stream_gz``)
        from veles_tpu_torch import prng
        streams = prng.snapshot_state()
        snaps = _Background(lambda: {
            suffix: _snapshot_save(ws, streams, workdir, suffix)
            for suffix in (".pickle", ".pickle.gz")})
    finally:
        torch.backends.cudnn.deterministic = False
    out = {"epochs": N_EPOCHS, "minibatch": TRAIN_BATCH,
           "superstep": SUPERSTEP, "launches": runs["stream"]["launches"],
           "resident_launches": runs["resident"]["launches"],
           "same_run": same, "history": runs["stream"]["history"],
           "stream_transfer_bytes": streamed_bytes,
           "host_assembly_breakdown_ms": breakdown,
           "streamed_superstep_ms": timed["stream"],
           "resident_superstep_ms": timed["resident"],
           "host_assembly_ms_per_superstep": assemble_ms,
           "stage_and_queue_ms_per_superstep": stage_ms,
           "h2d_ms_per_superstep": h2d_ms,
           "h2d_bytes_per_superstep": SUPERSTEP * TRAIN_BATCH * row_bytes,
           "h2d_gb_s": SUPERSTEP * TRAIN_BATCH * row_bytes / h2d_ms / 1e6,
           "drive_s": {p: r["drive_s"] for p, r in runs.items()},
           "snapshot": snaps, "card": card}
    print(f"stream: superstep ms streamed {timed['stream']} resident "
          f"{timed['resident']}; host assembly {assemble_ms:.1f} ms, "
          f"stage+queue {stage_ms:.1f} ms, H2D {h2d_ms:.2f} ms for "
          f"{out['h2d_bytes_per_superstep']} bytes per superstep; assembly "
          f"steps {breakdown}  [{card}]", flush=True)
    return out


def _snapshot_save(w, streams: dict, workdir: str, suffix: str) -> dict:
    """``save_workflow`` of ``w`` with the prng ``streams`` taken on the
    main thread, as ``suffix`` (it reads no process state and writes
    none): the path, the bytes and the seconds."""
    from veles_tpu_torch.snapshotter import save_workflow
    path = os.path.join(workdir, "stream" + suffix)
    t0 = time.perf_counter()
    save_workflow(w, path, streams)
    return {"path": path, "bytes": os.path.getsize(path),
            "save_s": time.perf_counter() - t0}


def _snapshot_load(saved: dict, streams: dict, suffix: str) -> dict:
    """``load_workflow`` of a saved snapshot: the loaded copy must be a
    snapshot with its params and no partial class.  The prng streams it
    puts back are replaced by ``streams``, taken on the main thread (a
    later phase's draws are not the snapshot's)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.snapshotter import load_workflow
    path = saved.pop("path")
    try:
        t0 = time.perf_counter()
        back = load_workflow(path)
        saved["load_s"] = time.perf_counter() - t0
    finally:
        prng.restore_state(streams)
    check(back.fused.restored and back.fused._acc_carry is None,
          f"{suffix}: not a snapshot with params")
    os.remove(path)
    return saved


class _Background:
    """``fn(*args)`` on a thread of its own; :meth:`result` joins it and
    returns its value or raises its exception."""

    def __init__(self, fn, *args) -> None:
        self._out, self._err = None, None

        def run():
            try:
                self._out = fn(*args)
            except BaseException as e:  # noqa: BLE001 — raised on join
                self._err = e
        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def result(self, timeout: float = 600.0):
        self._t.join(timeout)
        check(not self._t.is_alive(), "a background check did not end")
        if self._err is not None:
            raise self._err
        return self._out


def stream_loads(stream: dict) -> None:
    """After phase 7: load phase 6's saved snapshots back, each held, on
    a thread beside phase 8, which must draw from no prng stream: the
    streams are taken here, put back after the loads, and held equal
    when they are joined (``stream_gz``)."""
    from veles_tpu_torch import prng
    saves = stream["snapshot"]
    streams = stream["streams_beside_loads"] = prng.snapshot_state()
    stream["snapshot"] = _Background(lambda: {
        suffix: _snapshot_load(saved, streams, suffix)
        for suffix, saved in saves.result().items()})


def stream_gz(stream: dict, card: str) -> dict:
    """Join phase 6's snapshot round trips into its line, and hold the
    prng streams as they were before the phase beside the loads."""
    from veles_tpu_torch import prng
    snap = stream["snapshot"] = stream["snapshot"].result()
    check(prng.snapshot_state() == stream.pop("streams_beside_loads"),
          "the phase beside the snapshot loads drew from a prng stream")
    print("stream: snapshots (saved beside phase 7, loaded beside 8) " +
          ", ".join(
        f"{k} {v['bytes']} bytes, save {v['save_s']:.1f} s, load "
        f"{v['load_s']:.1f} s" for k, v in snap.items()) + f"  [{card}]",
        flush=True)
    return snap


#: the preempt-resume phase's workflow: AlexNet with a superstep of 1, so
#: that TRAIN spans two firings, and on the supervisor's first attempt a
#: SIGTERM to its own process after the second firing (inside TRAIN)
PREEMPT_WORKFLOW = """
import json
import os
import signal

import numpy as np
import torch

from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.models import alexnet
from veles_tpu_torch.ops import lrn_cuda
from veles_tpu_torch.ops.fused import FusedStepRunner

# deterministic cuDNN: this run is held bitwise against another
torch.backends.cudnn.deterministic = True
HERE = os.path.dirname(os.path.abspath(__file__))
ATTEMPT = os.environ.get("VELES_SUPERVISE_ATTEMPT")
SUPERSTEP = %(superstep)d
STOP_AFTER = 2


def run(launcher):
    w = launcher.create_workflow(alexnet.create_workflow)
    if launcher.snapshot is None:
        w.superstep = SUPERSTEP
    launcher.initialize()
    if ATTEMPT == "0":
        fire, count = FusedStepRunner.run, [0]

        def preempting(runner):
            fire(runner)
            count[0] += 1
            ld = runner.loader
            if count[0] == STOP_AFTER:
                assert ld.minibatch_class == TRAIN and not ld.class_ended
                os.kill(os.getpid(), signal.SIGTERM)
        FusedStepRunner.run = preempting
    lrn_cuda.lrn_fwd.launches = lrn_cuda.lrn_bwd.launches = 0
    launcher.run()
    torch.cuda.synchronize()
    tag = ATTEMPT or "straight"
    params = w.fused.host_params()
    np.savez(os.path.join(HERE, f"result_{tag}.npz"),
             **{f"{f}|{p}": a for f, ps in params.items()
                for p, a in ps.items()})
    with open(os.path.join(HERE, f"result_{tag}.json"), "w") as f:
        json.dump({"history": w.decision.history,
                   "launches": {"lrn_fwd": lrn_cuda.lrn_fwd.launches,
                                "lrn_bwd": lrn_cuda.lrn_bwd.launches},
                   "snapshot": launcher.snapshot,
                   "snapshot_load_s": launcher.snapshot_load_seconds}, f)
"""
#: the preempt phase's data set and superstep: 2 train minibatches and
#: one validation minibatch an epoch, 2 epochs (1024 + 128 images at
#: superstep 4 before PR 18: the depth cut to make room for phase 25;
#: every check kept)
PREEMPT_TRAIN, PREEMPT_VALID, PREEMPT_SUPERSTEP = 256, 128, 1
PREEMPT_OVERRIDES = [f"root.alexnet.loader.n_train={PREEMPT_TRAIN}",
                     f"root.alexnet.loader.n_valid={PREEMPT_VALID}",
                     f"root.alexnet.decision.max_epochs={N_EPOCHS}"]


def _preempt_result(workdir: str, tag: str):
    with open(os.path.join(workdir, f"result_{tag}.json")) as f:
        meta = json.load(f)
    arrays = np.load(os.path.join(workdir, f"result_{tag}.npz"))
    params = {}
    for key in arrays.files:
        fn, pn = key.split("|")
        params.setdefault(fn, {})[pn] = arrays[key]
    return meta, params


def preempt_phase(card: str, workdir: str) -> dict:
    """SIGTERM in the middle of TRAIN, the final snapshot, exit 14, the
    supervisor's resume to rc 0, against an uninterrupted run."""
    import torch
    wf = os.path.join(workdir, "preempt_wf.py")
    with open(wf, "w") as f:
        f.write(PREEMPT_WORKFLOW % {"superstep": PREEMPT_SUPERSTEP})
    snaps = os.path.join(workdir, "preempt_snaps")
    overrides = PREEMPT_OVERRIDES + [
        "root.alexnet.snapshotter={'directory': %r, 'prefix': 'pr', "
        "'compression': '', 'keep': 1}" % snaps]
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    for key in ("VELES_SUPERVISE_ATTEMPT", "VELES_RESUME_MANIFEST",
                "VELES_PREEMPT_GRACE"):
        env.pop(key, None)
    err_path = os.path.join(workdir, "supervise.stderr")
    t0 = time.perf_counter()
    # the supervised run in its processes, beside it in this one the
    # uninterrupted run and then the device drills: each is held on its
    # own (deterministic cuDNN makes the two runs bitwise however they
    # share the card)
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "--supervise", "-b",
             "cuda", "-s", str(SEED), wf] + overrides, cwd=HERE, env=env,
            stdout=err, stderr=subprocess.STDOUT)
        try:
            launcher, launches, straight_s = _drive(overrides[:-1] + [
                overrides[-1].replace("preempt_snaps", "straight_snaps")],
                workflow_file=wf)
            torch.backends.cudnn.deterministic = False
            drills = _device_drills(workdir)
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                # SIGTERM first: the supervisor stops its child with it
                proc.terminate()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    supervise_s = time.perf_counter() - t0
    with open(err_path) as f:
        log = f.read()
    check(proc.returncode == 0, f"--supervise rc {proc.returncode}; log "
          f"tail:\n{log[-3000:]}")
    check("child exited 14 (preempt)" in log and log.count("restarting")
          == 1, f"no single preemption restart in the log:\n{log[-3000:]}")
    m = re.search(r"preempted: final snapshot (\S+) \(([0-9.]+)s\)", log)
    check(m is not None, f"no final snapshot in the log:\n{log[-3000:]}")
    final, final_s = m.group(1), float(m.group(2))
    check(os.path.basename(final).startswith("pr_final_preempt-SIGTERM_pid")
          and final.endswith(".pickle"), f"final snapshot {final}")
    check(not os.path.exists(os.path.join(workdir, "result_0.json")),
          "the first child ran to its end")
    meta, params = _preempt_result(workdir, "1")
    check(meta["snapshot"] == final, f"resumed from {meta['snapshot']}, "
          f"not the final snapshot {final}")
    # the resumed child: the second train firing of epoch 0, then epoch 1
    train_mb = N_EPOCHS * PREEMPT_TRAIN // TRAIN_BATCH - PREEMPT_SUPERSTEP
    valid_mb = N_EPOCHS * -(-PREEMPT_VALID // TRAIN_BATCH) - 1
    check(meta["launches"] == _want_launches(train_mb, valid_mb),
          f"resumed child launched {meta['launches']} for {train_mb} train "
          f"and {valid_mb} validation minibatches")

    smeta, sparams = _preempt_result(workdir, "straight")
    check(smeta["launches"] == _want_launches(
        N_EPOCHS * PREEMPT_TRAIN // TRAIN_BATCH,
        N_EPOCHS * -(-PREEMPT_VALID // TRAIN_BATCH)),
        f"straight run launched {smeta['launches']}")
    check([(r["class"], r["count"]) for r in smeta["history"]] ==
          [("validation", PREEMPT_VALID), ("train", PREEMPT_TRAIN)]
          * N_EPOCHS, f"straight history {smeta['history']}")
    same = same_run(meta["history"], params, smeta["history"], sparams,
                    _initial_params(launcher.workflow))
    out = {"device_drills": drills,
           "supervise_rc": proc.returncode, "supervise_s": supervise_s,
           "straight_s": straight_s, "final_snapshot_bytes":
           os.path.getsize(final), "final_snapshot_save_s": final_s,
           "final_snapshot_load_s": meta["snapshot_load_s"],
           "resumed_launches": meta["launches"], "same_run": same,
           "history": meta["history"], "card": card}
    print(f"preempt: child exit 14 after a final snapshot of "
          f"{out['final_snapshot_bytes']} bytes in {final_s:.2f}s, resumed "
          f"(load {meta['snapshot_load_s']:.2f}s) to rc 0; "
          f"same run: {same}  [{card}]", flush=True)
    done = [(r["fault"], r["ok"], r["device"], r["recovery_sec"])
            for r in drills["results"]]
    print(f"preempt: device drills {done} in {drills['seconds']:.1f} s  "
          f"[{card}]", flush=True)
    return out


def _device_drills(workdir: str) -> dict:
    """The fault matrix's device drills on the card (``python -m
    veles_tpu_torch.tools.chaos_drill --only device --json``, a process of
    its own): ``device.oom_on_put`` at the streamed upload (drained and
    retried once) and at the resident one (degraded to streaming), each
    run completing on CUDA tensors."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env["VELES_METRICS_DIR"] = os.path.join(workdir, "drill_metrics")
    env.pop("VELES_FAULTS", None)
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.tools.chaos_drill", "--only",
         "device", "--json"], cwd=HERE, env=env, capture_output=True,
        text=True, timeout=300)
    seconds = time.perf_counter() - t0
    check(p.returncode == 0, f"device drills: rc {p.returncode}: "
          f"{p.stdout[-1500:]} {p.stderr[-2500:]}")
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    results = rec["results"]
    check(rec["fault_drill_ok"] and rec["backend"] == "cuda"
          and [r["fault"] for r in results] == [
              "device.oom_on_put_stream", "device.oom_on_put_resident"]
          and all(r["ok"] and r["device"].startswith("cuda")
                  for r in results)
          and results[0]["oom_retries"] == 1
          and results[1]["degraded_to_streaming"],
          f"device drills: {rec}")
    return {"results": results, "seconds": seconds}


# -- phases 8-11: real data ----------------------------------------------

#: BASELINE's secondary workload (bench.py's rule): MNIST7 at its
#: published size until validation error <= 1%, at most 40 epochs
MNIST_SIZES, CIFAR_SIZES = (60000, 10000), (50000, 10000)
TARGET_ERROR_PCT = 1.0
MNIST7_MAX_EPOCHS = 40
#: the wall cap of the time-to-99% run, from the end of initialize
MNIST7_CAP_S = 240.0
CIFAR10_EPOCHS = 2
MODELS_DIR = os.path.join(HERE, "veles_tpu_torch", "models")


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def data_phase(card: str, data_dir: str) -> dict:
    """The port's generators write the MNIST IDX and CIFAR-10 binary
    files at their published sizes into ``data_dir``; its readers read
    them back equal to the generators' own data, and neither generator
    overwrites a partial set."""
    from veles_tpu_torch import datasets
    from veles_tpu_torch.config import root

    out = {}
    sets = (("mnist", datasets.generate_mnist_idx,
             datasets.try_load_real_mnist, os.path.join(data_dir, "mnist"),
             MNIST_SIZES, (28, 28, 1), {"seed": 28281}),
            ("cifar10", datasets.generate_cifar10_batches,
             datasets.try_load_real_cifar10,
             os.path.join(data_dir, "cifar10", "cifar-10-batches-bin"),
             CIFAR_SIZES, (32, 32, 3), {"noise": 0.5, "seed": 32323}))
    for name, gen, _, base, sizes, _, _ in sets:
        t0 = time.perf_counter()
        gen(base, *sizes)
        write_s = time.perf_counter() - t0
        files = sorted(os.listdir(base))
        out[name] = {"files": len(files), "bytes": sum(
            os.path.getsize(os.path.join(base, f)) for f in files),
            "write_s": write_s}
        # one file of a set alone is a partial set: never overwritten
        part = os.path.join(data_dir, "partial_" + name)
        os.makedirs(part)
        shutil.copy(os.path.join(base, files[0]), part)
        try:
            gen(part, 10, 10)
            refused = False
        except FileExistsError:
            refused = True
        check(refused and os.listdir(part) == [files[0]] and _same_file(
            os.path.join(part, files[0]), os.path.join(base, files[0])),
            f"{name}: a partial set was overwritten")
        shutil.rmtree(part)
    saved = root.__dict__.get("common")
    root.common.data_dir = data_dir
    try:
        for name, _, load, _, sizes, shape, kw in sets:
            t0 = time.perf_counter()
            real = load()
            out[name]["read_s"] = time.perf_counter() - t0
            check(real is not None, f"{name}: the files were not read")
            want = datasets.synthetic_classification(
                sizes[0], sizes[1], shape, n_classes=10, **kw)
            for (x, y), (wx, wy) in zip(real, want):
                # the files hold round(x * 255); the readers give /255
                wx = np.round(wx * 255.0).astype(np.uint8).astype(
                    np.float32) / np.float32(255.0)
                check(x.dtype == np.float32 and x.shape == wx.shape
                      and np.array_equal(x, wx) and np.array_equal(y, wy),
                      f"{name}: the files read back differ from the "
                      f"generator's data")
    finally:
        if saved is None:
            root.__dict__.pop("common", None)
        else:
            root.common = saved
    out["card"] = card
    print(f"data: {out}", flush=True)
    return out


class _ClassTimer:
    """Wraps a launcher's ``initialize``: from its end, the seconds of
    each epoch's TRAIN class (between the class ends before and after
    it; a class end fetches its metrics, so the card has finished), and,
    with ``target_pct``, the run stopped at the first validation class
    end whose error is at most ``target_pct`` (``reached_s``) or at the
    first class end past ``cap_s`` (``capped``), as ``bench.py``'s
    secondary metric stops it."""

    def __init__(self, target_pct=None, cap_s=None) -> None:
        self.target_pct, self.cap_s = target_pct, cap_s
        self.t0 = self._last = None
        self.train_s = []
        self.reached_s = None
        self.capped = False

    def __call__(self, launcher) -> None:
        init = launcher.initialize

        def initialize():
            import torch
            init()
            torch.cuda.synchronize()
            self.t0 = self._last = time.perf_counter()
            self._wrap(launcher.workflow)
        launcher.initialize = initialize

    def _wrap(self, w) -> None:
        from veles_tpu_torch.loader.base import TRAIN, VALID
        run = w.decision.run

        def decision_run():
            run()
            ld = w.loader
            if not ld.class_ended:
                return
            now = time.perf_counter()
            if ld.minibatch_class == TRAIN:
                self.train_s.append(now - self._last)
            self._last = now
            if self.target_pct is None:
                return
            if ld.minibatch_class == VALID and \
                    w.decision.history[-1]["error_pct"] <= self.target_pct:
                self.reached_s = now - self.t0
                w.decision.complete = True
            elif now - self.t0 > self.cap_s:
                self.capped = True
                w.decision.complete = True
        w.decision.run = decision_run


def _on_card(w) -> None:
    bad = [f"{fn}.{pn}" for fn, ps in w.fused._params.items()
           for pn, t in ps.items() if t.device.type != "cuda"]
    check(not bad, f"params not on the card: {bad}")
    ld = w.loader
    check(ld.device_resident and ld.original_data.device.type == "cuda",
          "the data set is not resident on the card")


#: an exported model answered by ``native/``'s C++ runtime against the
#: port's f32 forward on the card (TF32 off): the probabilities within
#: the reference's conv-net tolerance (``tests/test_native.py:92``) and
#: within NATIVE_REL of the largest probability, the argmax equal on
#: every row whose top two are more than NATIVE_MARGIN apart; mnist7's
#: and AlexNet's validation rows answered.  The relative limit is the
#: one that holds the AlexNet: trained 2 epochs on 1 024 images of 1 000
#: classes, it answers nearly uniform probabilities of about 1/1 000,
#: which NATIVE_ATOL alone would let a wrong LRN move by a tenth, and
#: whose top two may lie closer than NATIVE_MARGIN, so that no row of it
#: is decided (its line prints how many are).  Sound runs read a max abs
#: of 2.4e-7 (mnist7) and 4.7e-10 (AlexNet).  Where the small alpha
#: leaves the LRN close to a constant scale, a wrong window hardly moves
#: the probabilities at all, so each norm layer of the card's forward is
#: also held alone (:func:`native_lrn_vs_card`): ``native/``'s LRN on
#: that layer's input against ``lrn_fwd``'s output, within
#: NATIVE_LRN_REL of its largest value, with the part of the output the
#: window's sum makes printed beside it.  On the tapped rows that part is
#: under the limit itself (7.84e-06 and 6.43e-07 on an NVIDIA H100 80GB
#: HBM3 at 700 W), so a wrong
#: window would pass there: each layer is held again on a copy of its
#: input scaled so that alpha times the mean window sum of squares equals
#: k, where the window makes at least NATIVE_LRN_WINDOW_PART of the output
NATIVE_ATOL, NATIVE_REL, NATIVE_MARGIN = 1e-4, 1e-5, 1e-3
NATIVE_LRN_REL, NATIVE_LRN_WINDOW_PART = 1e-5, 1e-2
NATIVE_MNIST7_ROWS, NATIVE_ALEXNET_ROWS = 256, 2


def _card_forward_f32(w, x: np.ndarray, taps=None) -> np.ndarray:
    """The port's eval forward of host rows ``x`` on the card, in f32
    with ``w``'s live f32 params, flattened to (rows, -1).  ``taps``, a
    list, gets (unit, input, output) on the host for each norm layer."""
    import torch
    from veles_tpu_torch.ops.lrn import LRNormalizer
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    out = torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
    with torch.no_grad():
        for f in w.forwards:
            inp = out
            out, _ = f.apply_fwd(w.fused.device_params(f.name), out,
                                 rng=None, train=False)
            if taps is not None and isinstance(f, LRNormalizer):
                taps.append((f, inp.cpu().numpy(), out.cpu().numpy()))
    torch.cuda.synchronize()
    return out.reshape(len(x), -1).cpu().numpy()


def _native_lrn(f, x: np.ndarray, path: str) -> np.ndarray:
    """``native/``'s LRN of unit ``f`` on ``x``: the unit exported as a
    one-op VTPN file at ``path`` (removed after)."""
    from types import SimpleNamespace
    from veles_tpu_torch import export, native
    stub = SimpleNamespace(
        forwards=[f], fused=SimpleNamespace(host_params=lambda: {}))
    export.export_model(stub, path)
    try:
        model = native.NativeModel(path)
        got = model.run(x).reshape(x.shape)
        model.close()
    finally:
        os.remove(path)
    return got


def _lrn_rows(f, x, y, got):
    """(max abs error, its share of the largest output, the window's
    part: ``|y - x k^-beta|`` over ``max |y|``, which a wrong window
    would move)."""
    scale = float(np.abs(y).max())
    err = float(np.abs(got - y).max())
    part = float(np.abs(y - x * f.k ** -f.beta).max()) / scale
    return err, err / scale, part


def native_lrn_vs_card(taps, path: str, what: str) -> list:
    """Each norm layer alone: ``native/``'s LRN answering the layer's
    input from the card's forward, held against that forward's output
    (``lrn_fwd``'s) within NATIVE_LRN_REL of its largest value.  Then the
    same on a copy of the input scaled by ``sqrt(k / (alpha n
    mean(x^2)))``, so that alpha times the mean window sum of squares is
    k: ``lrn_fwd`` on the card (one launch a layer) against ``native/``
    within NATIVE_LRN_REL, and the window's part of the output at least
    NATIVE_LRN_WINDOW_PART there, so that a wrong window must fail."""
    import torch
    from veles_tpu_torch.ops import lrn_cuda
    rows = []
    for f, x, y in taps:
        got = _native_lrn(f, x, path)
        err, rel, part = _lrn_rows(f, x, y, got)
        check(np.isfinite(got).all() and rel <= NATIVE_LRN_REL,
              f"{what}: {f.name} {list(x.shape)}: native's LRN vs "
              f"lrn_fwd: max abs {err:.3g}, {rel:.3g} of the largest "
              f"output (limit {NATIVE_LRN_REL})")
        x64 = x.astype(np.float64)
        scale = float(np.sqrt(f.k / (f.alpha * f.n * np.mean(x64 ** 2))))
        xs = (x64 * scale).astype(np.float32)
        sq = np.pad(xs.astype(np.float64) ** 2,
                    [(0, 0)] * 3 + [(f.n // 2, (f.n - 1) // 2)])
        load = float(np.mean(sum(sq[..., i:i + xs.shape[-1]]
                                 for i in range(f.n)))) * f.alpha / f.k
        ys = lrn_cuda.lrn_fwd(torch.from_numpy(xs).cuda(), f.n, f.k,
                              f.alpha, f.beta).cpu().numpy()
        gots = _native_lrn(f, xs, path)
        serr, srel, spart = _lrn_rows(f, xs, ys, gots)
        check(np.isfinite(gots).all() and srel <= NATIVE_LRN_REL
              and spart >= NATIVE_LRN_WINDOW_PART,
              f"{what}: {f.name} {list(x.shape)} scaled x{scale:.4g}: "
              f"native's LRN vs lrn_fwd: max abs {serr:.3g}, {srel:.3g} "
              f"of the largest output (limit {NATIVE_LRN_REL}); the "
              f"window's part {spart:.3g} (at least "
              f"{NATIVE_LRN_WINDOW_PART})")
        rows.append({"layer": f.name, "shape": list(x.shape),
                     "max_abs_err": err, "max_rel_err": rel,
                     "window_part": part, "scale": scale,
                     "scaled_load": load, "scaled_max_abs_err": serr,
                     "scaled_max_rel_err": srel,
                     "scaled_window_part": spart})
    return rows


def native_vs_card(w, x: np.ndarray, path: str, what: str) -> dict:
    """Export ``w`` to ``path`` (VTPN), answer ``x`` with ``native/``'s
    runtime, and hold the answers against :func:`_card_forward_f32`; the
    kernel launches of that forward and of :func:`native_lrn_vs_card`'s
    scaled inputs counted apart.  The file is
    removed."""
    from veles_tpu_torch import export, native
    t0 = time.perf_counter()
    export.export_model(w, path)
    export_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    try:
        t0 = time.perf_counter()
        model = native.NativeModel(path)
        load_s = time.perf_counter() - t0
        check(model.input_shape == tuple(x.shape[1:]) and model.num_ops ==
              len(w.forwards), f"{what}: native model {model.input_shape} "
              f"with {model.num_ops} ops")
        t0 = time.perf_counter()
        got = model.run(x)
        native_s = time.perf_counter() - t0
        model.close()
    finally:
        os.remove(path)
    _zero_launches()
    taps: list = []
    want = _card_forward_f32(w, x, taps)
    lrn = native_lrn_vs_card(taps, path, what)
    launches = _launches()
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{what}: native answered {got.shape}, the card {want.shape}")
    err = float(np.abs(got - want).max())
    rel = err / float(np.abs(want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > NATIVE_MARGIN
    differ = int((got.argmax(1) != want.argmax(1))[decided].sum())
    check(err <= NATIVE_ATOL and rel <= NATIVE_REL and differ == 0,
          f"{what}: native vs the card's f32 forward: max abs "
          f"{err:.3g} (limit {NATIVE_ATOL}), {rel:.3g} of the largest "
          f"probability (limit {NATIVE_REL}), {differ} of "
          f"{int(decided.sum())} decided rows with another argmax")
    return {"file_bytes": size, "export_s": export_s, "load_s": load_s,
            "rows": len(x), "native_s": native_s,
            "native_rows_s": len(x) / native_s, "max_abs_err": err,
            "max_rel_err": rel, "atol": NATIVE_ATOL, "rtol": NATIVE_REL,
            "decided_rows": int(decided.sum()), "lrn_layers": lrn,
            "argmax_differ": differ, "launches": launches}


def mnist7_phase(card: str, data_dir: str):
    """BASELINE's secondary workload: ``models/mnist7.py`` through the
    path ``python -m veles_tpu_torch veles_tpu_torch/models/mnist7.py
    root.common.data_dir=DIR`` takes, on the card, at 60 000 + 10 000
    images from the IDX files, ``decision.max_epochs=40``; the time from
    the end of initialize to the first validation class end with error
    at most 1%, the run capped at MNIST7_CAP_S.  Returns the readings and
    the workflow."""
    from veles_tpu_torch.loader.base import VALID
    timer = _ClassTimer(TARGET_ERROR_PCT, MNIST7_CAP_S)
    held = {}

    def before(launcher):
        timer(launcher)
        launcher.plotters = True
        held["launcher"] = launcher

    def at_event(event):
        # the validation confusion the matrix plotter read, as it was
        if event["plotter"] == "plt_confusion":
            held["valid"] = held["launcher"].workflow.decision \
                .confusion_per_class[VALID].copy()
    events = _plot_spy(at_event)
    launcher, launches, drive_s = _drive(
        [f"root.common.data_dir={data_dir}",
         f"root.mnist7.decision.max_epochs={MNIST7_MAX_EPOCHS}"],
        workflow_file=os.path.join(MODELS_DIR, "mnist7.py"), before=before)
    w = launcher.workflow
    plots = _check_plots(w, events, len(timer.train_s), "mnist7")
    conf = [e for e in events if e["plotter"] == "plt_confusion"][-1]
    matrix = np.asarray(conf["matrix"])
    check(np.array_equal(matrix, held["valid"])
          and int(matrix.sum()) == MNIST_SIZES[1],
          f"mnist7: plt_confusion's matrix (sum {int(matrix.sum())}) is not "
          f"the decision's validation confusion")
    plots["confusion_sum"] = int(matrix.sum())
    ld = w.loader
    check(ld.class_lengths == [0, MNIST_SIZES[1], MNIST_SIZES[0]],
          f"mnist7 class lengths {ld.class_lengths}")
    _on_card(w)
    valid = [h["error_pct"] for h in w.decision.history
             if h["class"] == "validation"]
    check(len(valid) >= 2 and min(valid[1:]) < valid[0],
          f"mnist7: validation error did not fall: {valid}")
    check(timer.reached_s is not None or timer.capped
          or w.decision.complete, "mnist7 stopped early")
    od = ld.original_data
    out = {"time_to_99_s": timer.reached_s,
           "best_valid_error_pct": min(valid),
           "capped": timer.capped, "cap_s": MNIST7_CAP_S,
           "epochs": len(timer.train_s), "valid_error_pct": valid,
           "train_img_s_per_epoch": [MNIST_SIZES[0] / t
                                     for t in timer.train_s],
           "resident_data_bytes": od.numel() * od.element_size(),
           "resident_data_dtype": str(od.dtype),
           "launches": launches, "drive_s": drive_s,
           "setup_s": drive_s - w.wall_time, "plots": plots, "card": card}
    print(f"mnist7: plots {plots['events']} events ({plots['names']}), "
          f"the last plt_confusion the decision's validation confusion, "
          f"summing to {plots['confusion_sum']}  [{card}]", flush=True)
    print(f"mnist7: time to 99% {timer.reached_s} s in {out['epochs']} "
          f"epochs (validation error % {valid}); train img/s per epoch "
          f"{[round(v) for v in out['train_img_s_per_epoch']]}; resident "
          f"{out['resident_data_bytes']} bytes  [{card}]", flush=True)
    off = ld.class_offset(1)   # the validation class
    x = ld.normalized_host_rows(slice(off, off + NATIVE_MNIST7_ROWS))
    out["native"] = nat = native_vs_card(
        w, x, os.path.join(data_dir, "mnist7.vtpn"), "mnist7")
    print(f"mnist7: exported {nat['file_bytes']} bytes in "
          f"{nat['export_s']:.3f} s; native/ answered {nat['rows']} "
          f"validation rows at {nat['native_rows_s']:.0f} rows/s, max abs "
          f"{nat['max_abs_err']:.3g} from the card's f32 forward (limit "
          f"{NATIVE_ATOL}), {nat['max_rel_err']:.3g} of its largest "
          f"probability (limit {NATIVE_REL}), argmax equal on "
          f"{nat['decided_rows']} decided rows  [{card}]", flush=True)
    return out, w


def cifar10_phase(card: str, data_dir: str) -> dict:
    """``models/cifar10.py`` on the card at 50 000 + 10 000 images from
    the binary batches, 2 epochs; the ``inv`` policy by iteration must
    have given every minibatch of the last train superstep its rate."""
    from veles_tpu_torch.ops.lr_adjust import make_policy
    timer = _ClassTimer()
    launcher, launches, drive_s = _drive(
        [f"root.common.data_dir={data_dir}",
         f"root.cifar10.decision.max_epochs={CIFAR10_EPOCHS}"],
        workflow_file=os.path.join(MODELS_DIR, "cifar10.py"), before=timer)
    w = launcher.workflow
    ld, la = w.loader, w.lr_adjust
    check(ld.class_lengths == [0, CIFAR_SIZES[1], CIFAR_SIZES[0]],
          f"cifar10 class lengths {ld.class_lengths}")
    _on_card(w)
    hist = w.decision.history
    check([(r["class"], r["count"]) for r in hist] ==
          [("validation", CIFAR_SIZES[1]), ("train", CIFAR_SIZES[0])]
          * CIFAR10_EPOCHS and all(np.isfinite(r["loss"]) for r in hist),
          f"cifar10 history {hist}")
    # minibatch j of the last train superstep (k of them) is iteration
    # n_mb - k + j, and its rate base * (1 + gamma t)^-power
    n_mb = CIFAR10_EPOCHS * -(-CIFAR_SIZES[0] // ld.max_minibatch_size)
    check(la._iteration == n_mb and la.policy_name == "inv"
          and la.by == "iteration", f"lr_adjust at {la._iteration} of "
          f"{n_mb} train minibatches, {la.policy_name} by {la.by}")
    gamma, power = la.policy_kwargs["gamma"], la.policy_kwargs["power"]
    policy = make_policy("inv", gamma=gamma, power=power)
    rows = w.fused.lr_rates
    for j, row in enumerate(rows):
        t = n_mb - len(rows) + j
        for (bw, bb), (rw, rb) in zip(la._base_rates, row):
            want = bw * (1.0 + gamma * t) ** -power
            check(rw == policy(bw, t) == want and rb == policy(bb, t),
                  f"rate {rw} at iteration {t}, want {want}")
    od = ld.original_data
    out = {"epochs": CIFAR10_EPOCHS, "history": hist,
           "train_img_s_per_epoch": [CIFAR_SIZES[0] / t
                                     for t in timer.train_s],
           "run_img_s_wall": CIFAR10_EPOCHS * sum(CIFAR_SIZES)
           / w.wall_time, "inv_last_rate": rows[-1][0][0],
           "inv_last_iteration": n_mb - 1,
           "inv_base_rate": la._base_rates[0][0],
           "resident_data_bytes": od.numel() * od.element_size(),
           "launches": launches, "drive_s": drive_s,
           "setup_s": drive_s - w.wall_time, "card": card}
    print(f"cifar10: train img/s per epoch "
          f"{[round(v) for v in out['train_img_s_per_epoch']]}; inv rate "
          f"at iteration {n_mb - 1}: {rows[-1][0][0]:.6g} (base "
          f"{la._base_rates[0][0]})  [{card}]", flush=True)
    return out


#: the quantized phase's workflow: models/alexnet.py's, with its
#: synthetic set rounded to bytes as bench.py rounds its quantized set
QUANT_WORKFLOW = """
import numpy as np

from veles_tpu_torch.loader.synthetic import SyntheticClassificationLoader
from veles_tpu_torch.models import alexnet


class ByteLoader(SyntheticClassificationLoader):
    def load_data(self):
        super().load_data()
        self.host_data = np.round(np.clip(self.host_data, 0.0, 1.0)
                                  * 255.0).astype(np.uint8)


def create_workflow(launcher, **overrides):
    saved = alexnet.SyntheticClassificationLoader
    alexnet.SyntheticClassificationLoader = ByteLoader
    try:
        return alexnet.create_workflow(launcher, **overrides)
    finally:
        alexnet.SyntheticClassificationLoader = saved
"""
QUANT_OVERRIDES = TRAIN_OVERRIDES + [
    "root.alexnet.loader.normalization_type=linear",
    "root.alexnet.loader.normalization_parameters={'lo': 0.0, 'hi': 1.0}"]
#: the reference's bar for quantized against float ingest
#: (tests/test_ingest_quantized.py): validation loss per class end
QUANT_LOSS_ATOL = 5e-3


def quantized_phase(card: str, workdir: str) -> dict:
    """Full-width AlexNet over uint8 pixels, 2 epochs each, under
    deterministic cuDNN: (a) quantized and streamed, (b) quantized and
    resident, (c) the same bytes with ``quantized_ingest=False``,
    streamed as a bf16 wire."""
    import torch
    wf = os.path.join(workdir, "quant_wf.py")
    with open(wf, "w") as f:
        f.write(QUANT_WORKFLOW)
    stream = ["root.alexnet.loader.max_resident_bytes=0"]
    paths = (("stream", stream), ("resident", []),
             ("float", stream + ["root.alexnet.loader.quantized_ingest="
                                 "False"]))
    train_mb = N_EPOCHS * N_TRAIN // TRAIN_BATCH
    valid_mb = N_EPOCHS * -(-N_VALID // TRAIN_BATCH)
    rows = (train_mb + valid_mb) * TRAIN_BATCH
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for path, extra in paths:
            launcher, launches, seconds = _drive(QUANT_OVERRIDES + extra,
                                                 workflow_file=wf)
            w = launcher.workflow
            check(launches == _want_launches(train_mb, valid_mb),
                  f"quantized {path} run launched {launches}")
            runs[path] = {"w": w, "launches": launches, "drive_s": seconds,
                          "history": list(w.decision.history),
                          "params": w.fused.host_params()}
        ws, wr, wf32 = (runs[p]["w"] for p in ("stream", "resident",
                                                "float"))
        check(ws.loader.dequant is not None and not ws.loader.device_resident
              and ws.fused.streaming and ws.loader.host_data.dtype == np.uint8,
              "run (a) is not quantized and streamed")
        check(wr.loader.dequant is not None and wr.loader.device_resident
              and wr.loader.original_data.dtype == torch.uint8,
              "run (b) is not quantized and resident")
        check(wf32.loader.dequant is None and wf32.fused.streaming
              and wf32.loader.stream_dtype == torch.bfloat16,
              "run (c) is not a float run streamed in bf16")
        wire = {p: runs[p]["w"].fused.stream_transfer_bytes
                for p in ("stream", "float")}
        want_wire = {"stream": rows * (SAMPLE_NUMEL + 8),
                     "float": rows * (SAMPLE_NUMEL * 2 + 8)}
        check(wire == want_wire, f"wire bytes {wire}, want {want_wire}")
        od = wr.loader.original_data
        resident_bytes = od.numel() * od.element_size()
        check(resident_bytes == (N_TRAIN + N_VALID) * SAMPLE_NUMEL,
              f"resident uint8 set of {resident_bytes} bytes")
        init = _initial_params(ws)
        same = same_run(runs["stream"]["history"], runs["stream"]["params"],
                        runs["resident"]["history"],
                        runs["resident"]["params"], init)
        check(same["history_equal"] and same["params_bitwise"],
              f"streamed and resident quantized runs differ: {same}")
        vs_float = []
        for q, f in zip(runs["stream"]["history"], runs["float"]["history"]):
            check((q["epoch"], q["class"], q["count"]) ==
                  (f["epoch"], f["class"], f["count"]),
                  f"quantized vs float histories: {q} vs {f}")
            vs_float.append({"class": q["class"], "epoch": q["epoch"],
                             "n_err": [q["n_err"], f["n_err"]],
                             "loss_diff": abs(q["loss"] - f["loss"])})
            if q["class"] == "validation":
                check(q["n_err"] == f["n_err"] and
                      abs(q["loss"] - f["loss"]) < QUANT_LOSS_ATOL,
                      f"quantized vs float validation: {q} vs {f}")
        float_delta = _rel_delta_diff(init, runs["stream"]["params"],
                                      runs["float"]["params"])
        timed = {p: _time_train_supersteps(runs[p]["w"], 3)
                 for p in ("stream", "resident", "float")}
        h2d_ms = {p: runs[p]["w"].fused.last_copy_ms()
                  for p in ("stream", "float")}
    finally:
        torch.backends.cudnn.deterministic = False
    per_ss = SUPERSTEP * TRAIN_BATCH
    out = {"epochs": N_EPOCHS, "minibatch": TRAIN_BATCH,
           "superstep": SUPERSTEP,
           "launches": {p: r["launches"] for p, r in runs.items()},
           "wire_bytes": wire, "resident_bytes": resident_bytes,
           "resident_f32_bytes": resident_bytes * 4,
           "stream_vs_resident": same, "vs_float": vs_float,
           "max_rel_delta_diff_vs_float": max(float_delta.values()),
           "superstep_ms": {p: [t[0] for t in ts]
                            for p, ts in timed.items()},
           "host_assembly_ms_per_superstep": {
               p: float(np.mean([t[2] for t in timed[p]]))
               for p in ("stream", "float")},
           "stage_and_queue_ms_per_superstep": {
               p: float(np.mean([t[1] for t in timed[p]]))
               for p in ("stream", "float")},
           "h2d_ms_per_superstep": h2d_ms,
           "h2d_bytes_per_superstep": {
               "stream": per_ss * (SAMPLE_NUMEL + 8),
               "float": per_ss * (SAMPLE_NUMEL * 2 + 8)},
           "drive_s": {p: r["drive_s"] for p, r in runs.items()},
           "history": runs["stream"]["history"], "card": card}
    print(f"quantized: superstep ms {out['superstep_ms']}; host assembly "
          f"{out['host_assembly_ms_per_superstep']} ms, stage+queue "
          f"{out['stage_and_queue_ms_per_superstep']} ms, H2D {h2d_ms} ms; "
          f"wire {wire} bytes; resident uint8 {resident_bytes} bytes  "
          f"[{card}]", flush=True)
    del runs, ws, wr, wf32
    torch.cuda.empty_cache()
    return out


# -- phases 12 and 13: BASELINE config #5, MnistAE and the Kohonen SOM -----

MNIST_AE_EPOCHS = 10
#: the card-vs-CPU runs' cut: images from the same files, and epochs
AE_CUT, AE_CUT_EPOCHS = {"minibatch_size": 100, "n_train": 1000,
                         "n_valid": 200}, 2
#: the card-vs-CPU bar: relative agreement of every class end's loss
CARD_CPU_RTOL = 1e-3
KOHONEN_SIZES = (5000, 0)


def _in_f32(launcher) -> None:
    """Wraps a launcher's ``create_workflow``: the workflow it makes
    computes in f32 (the card's default is bf16)."""
    import torch
    create = launcher.create_workflow

    def create_workflow(factory, **kwargs):
        w = create(factory, **kwargs)
        w.fused.compute_dtype = torch.float32
        return w
    launcher.create_workflow = create_workflow


def _agree_by_class(card_hist, cpu_hist, what: str) -> float:
    """The largest relative loss difference over the two histories,
    which must have the same classes and counts and agree within
    CARD_CPU_RTOL at every class end."""
    check([(r["epoch"], r["class"], r["count"], r["n_err"])
           for r in card_hist] == [(r["epoch"], r["class"], r["count"],
                                    r["n_err"]) for r in cpu_hist],
          f"{what}: card and CPU histories differ: {card_hist} vs "
          f"{cpu_hist}")
    worst = max(abs(c["loss"] - p["loss"]) / max(abs(p["loss"]), 1e-30)
                for c, p in zip(card_hist, cpu_hist))
    check(worst <= CARD_CPU_RTOL, f"{what}: a class end's loss differs by "
          f"{worst:.3g} (relative, limit {CARD_CPU_RTOL}) between card "
          f"and CPU: {card_hist} vs {cpu_hist}")
    return worst


def mnist_ae_phase(card: str, data_dir: str):
    """``models/mnist_ae.py`` through the path ``python -m
    veles_tpu_torch veles_tpu_torch/models/mnist_ae.py
    root.common.data_dir=DIR`` takes, on the card in f32, at 60 000 +
    10 000 images from the IDX files, the published 10 epochs; then the
    same files cut to 1 000 + 200 images for 2 epochs on the card and on
    the CPU, in f32 with TF32 off and deterministic cuDNN.  Returns the
    readings and the published run's workflow."""
    import torch
    wf = os.path.join(MODELS_DIR, "mnist_ae.py")
    timer = _ClassTimer()
    launcher, launches, drive_s = _drive(
        [f"root.common.data_dir={data_dir}",
         f"root.mnist_ae.decision.max_epochs={MNIST_AE_EPOCHS}"],
        workflow_file=wf, before=lambda la: (timer(la), _in_f32(la)))
    w = launcher.workflow
    ld = w.loader
    check(w.fused.compute_dtype == torch.float32, "mnist_ae is not in f32")
    check(ld.class_lengths == [0, MNIST_SIZES[1], MNIST_SIZES[0]],
          f"mnist_ae class lengths {ld.class_lengths}")
    _on_card(w)
    check(not any(launches.values()), f"mnist_ae launched {launches}")
    hist = w.decision.history
    # each epoch validates (the params of the epoch before), then trains
    check([(r["class"], r["count"], r["n_err"]) for r in hist] ==
          [("validation", MNIST_SIZES[1], 0),
           ("train", MNIST_SIZES[0], 0)] * MNIST_AE_EPOCHS
          and all(np.isfinite(r["loss"]) for r in hist),
          f"mnist_ae history {hist}")
    valid = [r["loss"] for r in hist if r["class"] == "validation"]
    train = [r["loss"] for r in hist if r["class"] == "train"]
    check(valid[-1] < valid[0], f"mnist_ae: validation MSE did not fall: "
          f"{valid}")
    od, ot = ld.original_data, ld.original_targets
    data_bytes = od.numel() * od.element_size()
    check(data_bytes == sum(MNIST_SIZES) * 784 * 4,
          f"mnist_ae: resident data of {data_bytes} bytes")
    target_bytes = 0 if ot is od else ot.numel() * ot.element_size()
    # card against CPU on the cut set
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    cut = [f"root.common.data_dir={data_dir}",
           f"root.mnist_ae.loader={AE_CUT!r}",
           f"root.mnist_ae.decision.max_epochs={AE_CUT_EPOCHS}"]
    torch.backends.cudnn.deterministic = True
    try:
        hists, params = {}, {}
        for backend in ("cuda", "cpu"):
            la, _, _ = _drive(cut, backend=backend, workflow_file=wf,
                              before=_in_f32)
            check(la.workflow.loader.class_lengths ==
                  [0, AE_CUT["n_valid"], AE_CUT["n_train"]]
                  and la.workflow.device.platform == backend,
                  f"mnist_ae cut run on {backend}")
            hists[backend] = list(la.workflow.decision.history)
            params[backend] = la.workflow.fused.host_params()
    finally:
        torch.backends.cudnn.deterministic = False
    worst = _agree_by_class(hists["cuda"], hists["cpu"], "mnist_ae")
    # for the record, not held to a limit: how far the trained params are
    param_diff = max(float(np.abs(a - params["cpu"][f][p]).max())
                     for f, ps in params["cuda"].items()
                     for p, a in ps.items())
    out = {"epochs": len(timer.train_s), "compute_dtype": "float32",
           "train_mse": train, "valid_mse": valid,
           "train_img_s_per_epoch": [MNIST_SIZES[0] / t
                                     for t in timer.train_s],
           "resident_data_bytes": data_bytes,
           "resident_target_bytes_extra": target_bytes,
           "targets_share_data": ot is od,
           "launches": launches, "drive_s": drive_s,
           "setup_s": drive_s - w.wall_time,
           "card_vs_cpu": {"cut": AE_CUT, "epochs": AE_CUT_EPOCHS,
                           "max_rel_loss_diff": worst,
                           "max_abs_param_diff": param_diff,
                           "valid_mse_card": [
                               r["loss"] for r in hists["cuda"]
                               if r["class"] == "validation"],
                           "valid_mse_cpu": [
                               r["loss"] for r in hists["cpu"]
                               if r["class"] == "validation"]},
           "card": card}
    print(f"mnist_ae: {out['epochs']} epochs, train MSE {train}, "
          f"validation MSE {valid}; train img/s per epoch "
          f"{[round(v) for v in out['train_img_s_per_epoch']]}; resident "
          f"{data_bytes} + {target_bytes} bytes (targets share the data: "
          f"{ot is od}); set-up {out['setup_s']:.2f} s; card vs CPU at "
          f"{AE_CUT['n_train']} + {AE_CUT['n_valid']} images, worst "
          f"{worst:.3g} relative, params {param_diff:.3g} apart  "
          f"[{card}]", flush=True)
    return out, w


def _winners(w) -> np.ndarray:
    """Each sample's winner on the workflow's final map, on its device."""
    import torch
    dev = w.trainer.device
    x = dev.put(w.loader.normalized_host_rows(slice(None)))
    d2, _ = w.forward.apply_fwd({"weights": w.trainer.weights}, x)
    return dev.get(torch.argmin(d2, 1))


def kohonen_phase(card: str) -> dict:
    """``models/kohonen.py`` through the path ``python -m
    veles_tpu_torch veles_tpu_torch/models/kohonen.py`` takes, at its
    published DEFAULTS, on the card and then on the CPU."""
    wf = os.path.join(MODELS_DIR, "kohonen.py")
    runs = {}
    for backend in ("cuda", "cpu"):
        launcher, launches, drive_s = _drive([], backend=backend,
                                             workflow_file=wf)
        runs[backend] = (launcher.workflow, launches, drive_s)
    w, launches, drive_s = runs["cuda"]
    ld, tr = w.loader, w.trainer
    check(ld.class_lengths == [0, KOHONEN_SIZES[1], KOHONEN_SIZES[0]]
          and ld.device_resident and ld.original_data.device.type == "cuda"
          and tr.weights.device.type == "cuda",
          "the kohonen set or map is not on the card")
    check(not any(launches.values()), f"kohonen launched {launches}")
    qe = [r["loss"] for r in w.decision.history]
    epochs = w.decision.max_epochs
    check([(r["class"], r["count"]) for r in w.decision.history] ==
          [("train", KOHONEN_SIZES[0])] * epochs
          and tr.steps == epochs * KOHONEN_SIZES[0] // 100,
          f"kohonen ran {tr.steps} steps: {w.decision.history}")
    check(qe[-1] < 0.9 * qe[0], f"kohonen: quantization error {qe}")
    cpu = runs["cpu"][0]
    worst = _agree_by_class(w.decision.history, cpu.decision.history,
                            "kohonen")
    differ = int(np.sum(_winners(w) != _winners(cpu)))
    out = {"epochs": epochs, "som_shape": [tr.forward.sy, tr.forward.sx],
           "qe_per_epoch": qe, "run_wall_s": w.wall_time,
           "som_steps": tr.steps, "steps_per_s": tr.steps / w.wall_time,
           "launches": launches, "drive_s": drive_s,
           "setup_s": drive_s - w.wall_time,
           "card_vs_cpu": {"max_rel_qe_diff": worst,
                           "qe_cpu": [r["loss"]
                                      for r in cpu.decision.history],
                           "cpu_run_wall_s": cpu.wall_time,
                           "final_winners_differ": differ,
                           "samples": KOHONEN_SIZES[0]},
           "card": card}
    print(f"kohonen: quantization error per epoch {qe}; {tr.steps} SOM "
          f"steps in {w.wall_time:.3f} s ({out['steps_per_s']:.0f}/s); "
          f"card vs CPU worst {worst:.3g} relative, {differ} of "
          f"{KOHONEN_SIZES[0]} samples with another winner on the final "
          f"map  [{card}]", flush=True)
    return out


# -- phases 14-18: the zoo's long tail, and the profiler ---------------------

#: the layers phase's shapes: NHWC activations, and a dense layer's
LAYER_SHAPE, DENSE_SHAPE = (64, 14, 14, 32), (64, 256, 128)
#: card against CPU on one unit, f32 (TF32 off): the worst relative
#: error of its output, err_input and grads (the bar: summation order
#: and transcendental functions)
UNIT_RTOL = 1e-5
#: stochastic pooling: the share of windows whose sample may differ
#: between card and CPU on the same uniforms (a near tie of log|x| + g)
IDX_MISMATCH_SHARE = 1e-3
RESIZE_LAYERS = [
    {"type": "resizable_all2all", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.05}}]
RESIZE_LOADER = dict(minibatch_size=20, n_train=400, n_valid=100,
                     shape=(6, 6, 1), n_classes=4)
WINE_SIZES, WINE_EPOCHS, WINE_CLASSES = (140, 38), 30, 3
MNIST_RBM_EPOCHS = 10
#: mnist_rbm's card-vs-CPU cut, as mnist_ae's
RBM_CUT = dict(AE_CUT, targets_from_data=True)
DBN_HIDDEN, DBN_PRETRAIN_EPOCHS, DBN_EPOCHS = [196, 64], 3, 10
#: train supersteps profiled per small model, after one to warm
PROFILE_SUPERSTEPS = 2


def _rel(got, want) -> float:
    """max |got - want| over max |want|, in f64 on the host."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    return float((got - want).abs().max() /
                 want.abs().max().clamp(min=1e-30))


def _units(kind: str, **kw):
    """A forward unit of a registered layer type and its gradient
    unit."""
    from veles_tpu_torch.ops.registry import forward_registry, gd_registry
    f = forward_registry[kind](None, name=kind, **kw)
    return f, gd_registry[kind](None, forward=f)


def _on_both(f, gd, params, x, err, rngs=(None, None), train=True):
    """The unit's forward and backward on the card and on the CPU from
    the same host tensors: per device (output, saved, err_input,
    grads); no backward in eval mode."""
    out = []
    for dev, rng in zip(("cuda", "cpu"), rngs):
        p = {k: v.to(dev) for k, v in params.items()}
        y, saved = f.apply_fwd(p, x.to(dev), rng=rng, train=train)
        e_in, grads = gd.backward_from_saved(p, saved, err.to(dev)) \
            if train else (None, {})
        out.append((y, saved, e_in, grads))
    return out


def _worst(card, cpu) -> float:
    (y, _, e, g), (y0, _, e0, g0) = card, cpu
    worst = _rel(y, y0)
    if e is not None:
        worst = max(worst, _rel(e, e0))
    for k in g0:
        worst = max(worst, _rel(g[k], g0[k]))
    return worst


def _resize_run(backend: str):
    """The resize scenario on one device in f32: 2 epochs, widen the
    resizable layer 8 -> 12, refill the softmax, train to 4 epochs."""
    import torch

    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.loader.synthetic import \
        SyntheticClassificationLoader
    from veles_tpu_torch.ops.standard_workflow import StandardWorkflow
    prng.seed_all(SEED)
    w = StandardWorkflow(loader_factory=lambda wf: \
        SyntheticClassificationLoader(wf, name="loader", **RESIZE_LOADER),
        layers=RESIZE_LAYERS, decision_config={"max_epochs": 2},
        name="resize")
    w.fused.compute_dtype = torch.float32
    w.initialize(device=make_device(backend), train=True)
    w.run()
    w.forwards[0].resize(12)
    sm = w.forwards[1]
    sm.initialize((w.loader.max_minibatch_size, 12))
    params = w.fused.host_params()
    params[sm.name] = sm.fill_params()
    w.fused.set_host_params(params)
    w.decision.complete = False
    w.decision.max_epochs = 4
    w.run()
    return w


#: the unit graph: its loop's turns and its unit's (rows, features)
GRAPH_TURNS, GRAPH_SHAPE = 4, (256, 512)


def graph_run(device: str) -> dict:
    """One small graph through the ported graph API on ``device``:
    StartPoint -> Repeater -> an AcceleratedUnit (``acc = acc * 0.5 + x
    * w`` on the device, its Vectors on ``device``) -> a counter that
    reads ``acc`` on the host and gates the loop off after GRAPH_TURNS
    turns -> EndPoint.  Each turn's host read, and where ``acc`` lay
    just before it."""
    import torch

    from veles_tpu_torch.accelerated_units import AcceleratedUnit
    from veles_tpu_torch.memory import Vector
    from veles_tpu_torch.mutable import Bool
    from veles_tpu_torch.units import Unit
    from veles_tpu_torch.workflow import Repeater, Workflow

    gen = np.random.default_rng(SEED + 700)
    x0 = gen.standard_normal(GRAPH_SHAPE).astype(np.float32)
    w0 = gen.standard_normal(GRAPH_SHAPE[1:]).astype(np.float32)

    class Accumulate(AcceleratedUnit):
        def __init__(self, wf, **kw):
            super().__init__(wf, **kw)
            self.x = self.declare_input("x", Vector(x0, name="x"))
            self.w = Vector(w0, name="w")
            self.acc = self.declare_output(
                "acc", Vector(np.zeros_like(x0), name="acc"))

        def initialize(self, device=None, **kw):
            super().initialize(device=device, **kw)
            self.w.initialize(self.device)
            self.acc.unmap()

        def gather_params(self):
            return {"w": self.w.unmap()}

        def gather_inputs(self):
            return dict(super().gather_inputs(), acc=self.acc.unmap())

        def apply(self, params, inputs, rng=None):
            return {"acc": inputs["acc"] * 0.5 + inputs["x"] * params["w"]}

    class Counter(Unit):
        def __init__(self, wf, acc, **kw):
            super().__init__(wf, **kw)
            self.acc, self.complete, self.seen = acc, Bool(False), []

        def run(self):
            dev = self.acc.devmem
            self.seen.append((str(dev.device) if isinstance(
                dev, torch.Tensor) else None, self.acc._valid,
                self.acc.map_read().copy()))
            self.complete.set(len(self.seen) >= GRAPH_TURNS)

    wf = Workflow(name="graph")
    rpt = Repeater(wf, name="repeater")
    unit = Accumulate(wf, name="accumulate")
    cnt = Counter(wf, unit.acc, name="counter")
    rpt.link_from(wf.start_point, cnt)
    unit.link_from(rpt)
    cnt.link_from(unit)
    rpt.gate_block = cnt.complete
    wf.end_point.link_from(cnt)
    wf.end_point.gate_block = ~cnt.complete
    t0 = time.perf_counter()
    wf.initialize(device=torch.device(device))
    wf.run()
    return {"seconds": time.perf_counter() - t0,
            "fired": unit.run_count, "seen": cnt.seen}


def layers_phase(card: str) -> dict:
    """Each layer type this slice added, forward and backward on the card
    against the same unit on the CPU at small shapes, in f32."""
    import torch

    from veles_tpu_torch import prng
    gen = torch.Generator().manual_seed(SEED)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    x = rand(*LAYER_SHAPE, scale=2.0)
    err = rand(*LAYER_SHAPE)
    out = {}
    for kind in ("activation_tanh", "activation_sigmoid",
                 "activation_strict_relu", "activation_relu",
                 "activation_log"):
        f, gd = _units(kind)
        out[kind] = _worst(*_on_both(f, gd, {}, x, err))
    n, n_in, n_out = DENSE_SHAPE
    f, gd = _units("all2all_sigmoid", output_sample_shape=n_out)
    out["all2all_sigmoid"] = _worst(*_on_both(
        f, gd, {"weights": rand(n_in, n_out, scale=0.05),
                "bias": rand(n_out, scale=0.1)},
        rand(n, n_in), rand(n, n_out)))
    f, gd = _units("cutter", padding=(2, 1, 3, 2))
    out["cutter"] = _worst(*_on_both(
        f, gd, {}, x, rand(*f.output_shape_for(LAYER_SHAPE))))
    f, gd = _units("stochastic_pooling", kx=3, ky=3, sliding=2)
    yshape = f.output_shape_for(LAYER_SHAPE)
    on_card, on_cpu = _on_both(f, gd, {}, x, rand(*yshape), train=False)
    out["stochastic_pooling_eval"] = _rel(on_card[0], on_cpu[0])
    # train: both runs take the CPU generator's uniforms (prng.uniform
    # moves them to the card)
    rngs = [prng.torch_generator(SEED, 0, 1, torch.device("cpu"))
            for _ in range(2)]
    e = rand(*yshape)
    on_card, on_cpu = _on_both(f, gd, {}, x, e, rngs=rngs)
    idx, idx0 = on_card[1][1].cpu(), on_cpu[1][1]
    differ = int((idx != idx0).sum())
    check(differ <= IDX_MISMATCH_SHARE * idx0.numel(),
          f"stochastic pooling: {differ} of {idx0.numel()} windows sampled "
          f"another element on the card")
    same = idx == idx0
    # the routing from the card's samples, on both devices
    e_cpu, _ = gd.backward_from_saved({}, (x, idx), e)
    out["stochastic_pooling_train"] = max(
        _rel(on_card[0].cpu()[same], on_cpu[0][same]),
        _rel(on_card[2], e_cpu))
    out["stochastic_pooling_windows_sampled_differently"] = differ
    # resize between two runs, on the card and on the CPU
    runs = {b: _resize_run(b) for b in ("cuda", "cpu")}
    wc, w0 = runs["cuda"], runs["cpu"]
    check(wc.forwards[0].output_shape[1:] == (12,)
          and wc.fused.device_params(wc.forwards[0].name)["weights"].shape
          == (36, 12), "resize: the card's layer is not 12 wide")
    worst = _agree_by_class(wc.decision.history, w0.decision.history,
                            "resize")
    pc, p0 = wc.fused.host_params(), w0.fused.host_params()
    out["resizable_all2all"] = max(
        [worst] + [_rel(torch.from_numpy(pc[f][p]), torch.from_numpy(a))
                   for f, ps in p0.items() for p, a in ps.items()])
    bad = {k: v for k, v in out.items() if k.startswith(("activation",
           "all2all", "cutter")) and v > UNIT_RTOL}
    check(not bad, f"layers: card and CPU differ beyond {UNIT_RTOL}: {bad}")
    check(out["stochastic_pooling_eval"] <= UNIT_RTOL
          and out["stochastic_pooling_train"] <= UNIT_RTOL,
          f"stochastic pooling: card and CPU differ: {out}")
    check(out["resizable_all2all"] <= CARD_CPU_RTOL,
          f"resize: card and CPU differ: {out['resizable_all2all']}")
    # the unit graph on the card against the same graph on the CPU
    on_card, on_cpu = graph_run("cuda:0"), graph_run("cpu")
    where = [(d, v) for d, v, _ in on_card["seen"]]
    check(on_card["fired"] == on_cpu["fired"] == GRAPH_TURNS
          and where == [("cuda:0", 2)] * GRAPH_TURNS,
          f"graph: fired {on_card['fired']} / {on_cpu['fired']} times, "
          f"the output before each read {where}")
    same = all(np.array_equal(a[2], b[2])
               for a, b in zip(on_card["seen"], on_cpu["seen"]))
    check(same and len(on_card["seen"]) == len(on_cpu["seen"]),
          "graph: the card's reads differ from the CPU's")
    out["graph"] = {"turns": on_card["fired"], "equal_to_cpu": same,
                    "before_read": where,
                    "card_s": on_card["seconds"],
                    "cpu_s": on_cpu["seconds"]}
    out["card"] = card
    print(f"layers: worst relative error card vs CPU (f32) {out}",
          flush=True)
    return out


def _check_confusion(w, klass: int, what: str):
    """The decision's last confusion matrix of ``klass``: its rows count
    each label of the class, its trace the class's right answers."""
    from veles_tpu_torch.loader.base import CLASS_NAMES
    ld = w.loader
    conf = w.decision.confusion_per_class[klass]
    n = w.evaluator.n_classes
    off = ld.class_offset(klass)
    labels = ld.original_labels[off:off + ld.class_lengths[klass]]
    rows = np.bincount(labels.cpu().numpy(), minlength=n)
    last = [h for h in w.decision.history
            if h["class"] == CLASS_NAMES[klass]][-1]
    check(conf is not None and conf.shape == (n, n)
          and conf.dtype == np.int32
          and np.array_equal(conf.sum(axis=1), rows)
          and int(np.trace(conf)) == last["count"] - last["n_err"],
          f"{what}: confusion {conf} against label counts {rows} and "
          f"{last}")
    return conf


def wine_phase(card: str) -> dict:
    """``models/wine.py`` through the path ``python -m veles_tpu_torch
    veles_tpu_torch/models/wine.py`` takes, at its published DEFAULTS,
    on the card."""
    from veles_tpu_torch.loader.base import TRAIN, VALID
    launcher, launches, drive_s = _drive(
        [], workflow_file=os.path.join(MODELS_DIR, "wine.py"))
    w = launcher.workflow
    ld = w.loader
    check(ld.class_lengths == [0, WINE_SIZES[1], WINE_SIZES[0]],
          f"wine class lengths {ld.class_lengths}")
    _on_card(w)
    check(not any(launches.values()), f"wine launched {launches}")
    hist = w.decision.history
    check([(r["class"], r["count"]) for r in hist] ==
          [("validation", WINE_SIZES[1]), ("train", WINE_SIZES[0])]
          * WINE_EPOCHS, f"wine history {hist}")
    valid = [r["error_pct"] for r in hist if r["class"] == "validation"]
    conf = _check_confusion(w, VALID, "wine validation")
    _check_confusion(w, TRAIN, "wine train")
    out = {"epochs": WINE_EPOCHS, "valid_error_pct": valid,
           "final_valid_confusion": conf.tolist(), "launches": launches,
           "run_wall_s": w.wall_time, "drive_s": drive_s, "card": card}
    print(f"wine: validation error % per epoch {valid}; final validation "
          f"confusion {conf.tolist()} (rows: labels, columns: "
          f"predictions); {WINE_EPOCHS} epochs in {w.wall_time:.2f} s  "
          f"[{card}]", flush=True)
    return out


class _CpuDraws:
    """The draw seam for card-vs-CPU runs: every stochastic layer's
    generator made on the CPU, so ``prng.uniform`` draws the CPU
    generator's uniforms on both runs and moves them to the device
    (CUDA's Philox and the CPU's generator give other streams for one
    seed)."""

    def __enter__(self):
        import torch

        from veles_tpu_torch import prng
        self.make = make = prng.torch_generator
        prng.torch_generator = lambda seed, counter, layer, device: \
            make(seed, counter, layer, torch.device("cpu"))

    def __exit__(self, *exc):
        from veles_tpu_torch import prng
        prng.torch_generator = self.make


def mnist_rbm_phase(card: str, data_dir: str) -> dict:
    """``models/mnist_rbm.py`` through the path ``python -m
    veles_tpu_torch veles_tpu_torch/models/mnist_rbm.py
    root.common.data_dir=DIR`` takes, on the card in f32, at 60 000 +
    10 000 images from the IDX files, the published 10 epochs; then the
    cut set for 2 epochs on the card and on the CPU on the same draws."""
    import torch
    wf = os.path.join(MODELS_DIR, "mnist_rbm.py")
    timer = _ClassTimer()
    launcher, launches, drive_s = _drive(
        [f"root.common.data_dir={data_dir}"], workflow_file=wf,
        before=lambda la: (timer(la), _in_f32(la)))
    w = launcher.workflow
    ld = w.loader
    check(w.fused.compute_dtype == torch.float32 and
          ld.class_lengths == [0, MNIST_SIZES[1], MNIST_SIZES[0]],
          f"mnist_rbm: {w.fused.compute_dtype}, {ld.class_lengths}")
    _on_card(w)
    check(not any(launches.values()), f"mnist_rbm launched {launches}")
    hist = w.decision.history
    check([(r["class"], r["count"]) for r in hist] ==
          [("validation", MNIST_SIZES[1]), ("train", MNIST_SIZES[0])]
          * MNIST_RBM_EPOCHS and all(np.isfinite(r["loss"]) for r in hist),
          f"mnist_rbm history {hist}")
    valid = [r["loss"] for r in hist if r["class"] == "validation"]
    train = [r["loss"] for r in hist if r["class"] == "train"]
    # the published setup's curve falls to its least in the first
    # epochs, then climbs again (the reference's does on XLA:CPU too:
    # CD-1 learns the binarized digits, the MSE reads the grey ones)
    check(min(valid[1:]) < 0.9 * valid[0], f"mnist_rbm: validation MSE "
          f"did not fall after the first epoch: {valid}")
    od, ot = ld.original_data, ld.original_targets
    data_bytes = od.numel() * od.element_size()
    check(ot is od and data_bytes == sum(MNIST_SIZES) * 784 * 4,
          f"mnist_rbm: resident data of {data_bytes} bytes, targets "
          f"aliased: {ot is od}")
    cut = [f"root.common.data_dir={data_dir}",
           f"root.mnist_rbm.loader={RBM_CUT!r}",
           f"root.mnist_rbm.decision.max_epochs={AE_CUT_EPOCHS}"]
    hists = {}
    with _CpuDraws():
        for backend in ("cuda", "cpu"):
            la, _, _ = _drive(cut, backend=backend, workflow_file=wf,
                              before=_in_f32)
            hists[backend] = list(la.workflow.decision.history)
    worst = _agree_by_class(hists["cuda"], hists["cpu"], "mnist_rbm")
    out = {"epochs": len(timer.train_s), "compute_dtype": "float32",
           "train_mse": train, "valid_mse": valid,
           "train_img_s_per_epoch": [MNIST_SIZES[0] / t
                                     for t in timer.train_s],
           "resident_data_bytes": data_bytes, "targets_share_data": True,
           "launches": launches, "drive_s": drive_s,
           "setup_s": drive_s - w.wall_time,
           "card_vs_cpu": {"cut": RBM_CUT, "epochs": AE_CUT_EPOCHS,
                           "max_rel_loss_diff": worst},
           "card": card}
    print(f"mnist_rbm: {out['epochs']} epochs, reconstruction MSE train "
          f"{train}, validation {valid}; train img/s per epoch "
          f"{[round(v) for v in out['train_img_s_per_epoch']]}; resident "
          f"{data_bytes} bytes (targets share the data); card vs CPU at "
          f"{RBM_CUT['n_train']} + {RBM_CUT['n_valid']} images on the same "
          f"draws, worst {worst:.3g} relative  [{card}]", flush=True)
    return out


def mnist_dbn_phase(card: str, data_dir: str) -> dict:
    """``models/mnist_dbn.py`` through the path ``python -m
    veles_tpu_torch veles_tpu_torch/models/mnist_dbn.py
    root.common.data_dir=DIR`` takes, on the card, at its published
    DEFAULTS: pretraining chained on the device, then the fine-tune."""
    from veles_tpu_torch.loader.base import VALID
    timer = _ClassTimer()
    launcher, launches, drive_s = _drive(
        [f"root.common.data_dir={data_dir}"],
        workflow_file=os.path.join(MODELS_DIR, "mnist_dbn.py"),
        before=timer)
    w = launcher.workflow
    ld = w.loader
    check(ld.class_lengths == [0, MNIST_SIZES[1], MNIST_SIZES[0]],
          f"mnist_dbn class lengths {ld.class_lengths}")
    _on_card(w)
    check(not any(launches.values()), f"mnist_dbn launched {launches}")
    stats = w.pretrain_stats
    check(stats["device_chain"] and stats["interstage_h2d_bytes"] == 0
          and len(stats["stages"]) == len(DBN_HIDDEN) - 1
          and all(s["host_free"] and s["h2d_bytes"] == 0
                  for s in stats["stages"]),
          f"mnist_dbn: the stages did not chain on the card: {stats}")
    hist = w.decision.history
    check([(r["class"], r["count"]) for r in hist] ==
          [("validation", MNIST_SIZES[1]), ("train", MNIST_SIZES[0])]
          * DBN_EPOCHS, f"mnist_dbn history {hist}")
    valid = [r["error_pct"] for r in hist if r["class"] == "validation"]
    check(min(valid[1:]) < valid[0], f"mnist_dbn: validation error did "
          f"not fall: {valid}")
    conf = _check_confusion(w, VALID, "mnist_dbn validation")
    out = {"hidden": DBN_HIDDEN, "pretrain_epochs": DBN_PRETRAIN_EPOCHS,
           "epochs": DBN_EPOCHS, "pretrain_stats": stats,
           "pretrain_s": w.pretrain_seconds, "finetune_s": w.wall_time,
           "valid_error_pct": valid,
           "train_img_s_per_epoch": [MNIST_SIZES[0] / t
                                     for t in timer.train_s],
           "final_valid_confusion": conf.tolist(),
           "compute_dtype": str(w.fused.compute_dtype),
           "launches": launches, "drive_s": drive_s, "card": card}
    print(f"mnist_dbn: pretrain {stats} in {w.pretrain_seconds:.2f} s; "
          f"fine-tune {DBN_EPOCHS} epochs in {w.wall_time:.2f} s, "
          f"validation error % {valid}; final validation confusion "
          f"{conf.tolist()}  [{card}]", flush=True)
    return out


def _next_train_superstep(w) -> int:
    """Fire the loader until it hands out a full TRAIN superstep (the
    firings before it are skipped, not run), and set its rates.
    Returns its minibatches."""
    from veles_tpu_torch.loader.base import TRAIN
    ld = w.loader
    full = min(w.superstep,
               -(-ld.class_lengths[TRAIN] // ld.max_minibatch_size))
    for _ in range(100000):
        ld.run()
        if ld.minibatch_class == TRAIN and ld.superstep_k == full:
            break
    else:
        raise SmokeFailure(f"{w.name}: no full train superstep")
    if w.lr_adjust is not None:
        w.lr_adjust.run()
    return full


def _self_device_us(avg) -> float:
    v = getattr(avg, "self_device_time_total", None)
    if v is None:
        v = getattr(avg, "self_cuda_time_total", 0.0)
    return float(v)


def _timed_supersteps(w, n: int):
    """``n`` train supersteps: each one's ms between CUDA events, the
    host's own seconds in the fused step, the wall seconds and the
    minibatches."""
    import torch
    events, host_s, mbs = [], 0.0, 0
    t0 = time.perf_counter()
    for _ in range(n):
        mbs += _next_train_superstep(w)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        th = time.perf_counter()
        w.fused.run()
        host_s += time.perf_counter() - th
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    return [s.elapsed_time(e) for s, e in events], host_s, wall_s, mbs


def _top(avgs, n: int = 10) -> list:
    return [{"op": a.key, "ms": _self_device_us(a) / 1e3, "calls": a.count}
            for a in sorted(avgs, key=_self_device_us, reverse=True)[:n]
            if _self_device_us(a) > 0]


def _profiled(w, n: int, log_dir: str) -> dict:
    """A resident workflow's train supersteps on a warm card: ``n``
    unprofiled (CUDA events, host clock), then ``n`` under
    ``profiling.trace``: the device's kernel time and its busy share,
    of the profiled window and of the unprofiled wall time (the
    profiler slows the host), the ten kernels and the ten operators
    with the most device time."""
    import torch
    from torch.autograd import DeviceType

    from veles_tpu_torch import profiling
    check(w.loader.device_resident, f"{w.name}: not resident")
    _next_train_superstep(w)
    w.fused.run()
    torch.cuda.synchronize()
    ms, host_s, wall_s, mbs = _timed_supersteps(w, n)
    with profiling.trace(log_dir) as prof:
        pms, phost_s, pwall_s, pmbs = _timed_supersteps(w, n)
    w.fused.take_class_metrics()
    kernels = sorted((e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    check(kernels, f"{w.name}: torch.profiler saw no device activity")
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in kernels:       # the union of the kernels' intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    avgs = prof.key_averages()
    device_ms = busy_us / 1e3 / pmbs
    return {"supersteps": n, "minibatches": mbs,
            "superstep_ms": ms, "wall_ms_per_minibatch": wall_s * 1e3 / mbs,
            "host_ms_per_minibatch": host_s * 1e3 / mbs,
            "device_ms_per_minibatch": device_ms,
            "device_busy_share": device_ms / (wall_s * 1e3 / mbs),
            "profiled": {"superstep_ms": pms,
                         "wall_ms_per_minibatch": pwall_s * 1e3 / pmbs,
                         "host_ms_per_minibatch": phost_s * 1e3 / pmbs,
                         "device_busy_share": busy_us / (pwall_s * 1e6)},
            "kernels_per_minibatch": len(kernels) / pmbs,
            "top_kernels": _top([a for a in avgs if getattr(
                a, "device_type", None) == DeviceType.CUDA]),
            "top_ops": _top([a for a in avgs if getattr(
                a, "device_type", None) != DeviceType.CUDA])}


def _brief(top: list, width: int = 80) -> list:
    return [(t["op"][:width], round(t["ms"], 3), t["calls"]) for t in top]


def profile_phase(card: str, workdir: str, alexnet_w, train: dict,
                  mnist7_w, mnist_ae_w) -> dict:
    """``torch.profiler`` (through ``profiling.trace``) around
    PROFILE_SUPERSTEPS train supersteps each of mnist7 and mnist_ae at
    their published sizes and one of full-width AlexNet, each resident
    on a warm card, with the AlexNet MFU from the analytic FLOPs."""
    from veles_tpu_torch import profiling
    _zero_launches()
    out = {}
    for name, w, n in (("mnist7", mnist7_w, PROFILE_SUPERSTEPS),
                       ("mnist_ae", mnist_ae_w, PROFILE_SUPERSTEPS),
                       ("alexnet", alexnet_w, 1)):
        out[name] = _profiled(w, n, os.path.join(workdir, "profile", name))
    launches = _launches()
    # AlexNet's warm, timed and profiled supersteps; the small models
    # have no LRN layer
    check(launches == _want_launches(3 * SUPERSTEP, 0),
          f"profile path launches {launches}")
    a = out["alexnet"]
    flops = profiling.model_flops_per_sample(alexnet_w.forwards)["train"]
    peak = profiling.device_peak_flops(alexnet_w.device)
    check(peak is not None, f"no peak for this card: {card}")
    a["train_flops_per_image"] = flops
    a["peak_flops"] = peak
    a["mfu_train_phase"] = profiling.mfu(train["train_img_s"], flops,
                                         alexnet_w.device)
    a["mfu_timed"] = profiling.mfu(
        SUPERSTEP * TRAIN_BATCH / (a["superstep_ms"][0] / 1e3), flops,
        alexnet_w.device)
    out["launches"] = launches
    out["card"] = card
    for name in ("mnist7", "mnist_ae", "alexnet"):
        r = out[name]
        p = r["profiled"]
        print(f"profile {name}: per minibatch wall "
              f"{r['wall_ms_per_minibatch']:.3f} ms (host "
              f"{r['host_ms_per_minibatch']:.3f} ms in the step), device "
              f"{r['device_ms_per_minibatch']:.3f} ms in "
              f"{r['kernels_per_minibatch']:.1f} kernels: busy "
              f"{r['device_busy_share']:.3f} of the unprofiled wall, "
              f"{p['device_busy_share']:.3f} of the profiled window (wall "
              f"{p['wall_ms_per_minibatch']:.3f} ms); top kernels "
              f"{_brief(r['top_kernels'], 50)}; top operators "
              f"{_brief(r['top_ops'])}  [{card}]", flush=True)
    print(f"profile alexnet: MFU {a['mfu_train_phase']:.4f} at the train "
          f"phase's {train['train_img_s']:.0f} img/s, "
          f"{a['mfu_timed']:.4f} in the timed superstep; "
          f"{flops:.4g} train FLOPs an image against the datasheet's "
          f"{peak:.4g} FLOP/s (dense bf16)  [{card}]", flush=True)
    return out


# -- phase 19: summary -------------------------------------------------------

# -- phases 19-22: the GA, population-batched cohorts, ensembles --------------

#: the GA phase: BASELINE #1 (models/mnist.py at its DEFAULTS' widths and
#: minibatch) with liftable genes only, so each generation is one cohort
GA_POP, GA_GENS, GA_EPOCHS, GA_SEED = 8, 2, 2, 1234
#: the GA's fitness is an n_err count; a genome re-run per genome must
#: give its cohort fitness within the CPU tests' bar (tests/
#: test_torch_population.py)
GA_FITNESS_ATOL = 1e-3
GA_WORKFLOW = '''
import torch

from veles_tpu_torch.models import mnist


def create_workflow(launcher):
    # f32, so that the per-genome re-runs compare like with like
    w = mnist.create_workflow(launcher)
    w.fused.compute_dtype = torch.float32
    return w


def run(launcher):
    launcher.create_workflow(create_workflow)
    launcher.initialize()
    launcher.run()
'''
GA_CONFIG = '''
from veles_tpu_torch.config import root
from veles_tpu_torch.genetics import Tune

root.common.data_dir = {data_dir!r}
root.mnist.decision = {{"max_epochs": {epochs}, "fail_iterations": 50}}
root.mnist.layers = [
    {{"type": "all2all_tanh", "->": {{"output_sample_shape": 100}},
     "<-": {{"learning_rate": Tune(0.1, 0.01, 1.0),
            "weight_decay": Tune(0.0, 0.0, 0.001)}}}},
    {{"type": "softmax", "->": {{"output_sample_shape": 10}},
     "<-": {{"learning_rate": Tune(0.1, 0.01, 1.0),
            "weight_decay": 0.0}}}},
]
'''
#: the AlexNet cohort: P learning-rate factors on the model's own rates,
#: one epoch of the training phase's cut set; in bf16 (the card's
#: default, the kernels' main path) and again in f32 (TF32 off)
COHORT_LR_FACTORS = (1.0, 0.5)
COHORT_OVERRIDES = ["root.alexnet.loader.n_train=1024",
                    "root.alexnet.loader.n_valid=128",
                    "root.alexnet.decision.max_epochs=1"]
#: cohort against per-genome runs: each class end's n_err within 2% of
#: its count; the whole model's trained params within 1e-4 (bf16: a
#: grouped convolution rounds to bf16 elsewhere than a plain one) and
#: 1e-5 (f32) relative, L2 over every param; in f32 also each param's
#: trained CHANGE within 2e-2 relative (L2).  The changes of one epoch
#: at chance level are tiny, and a zero-initialized bias's change is a
#: sum over the batch and every pixel that mostly cancels: summed in
#: another order it moves by up to 1% (PERF.md); in bf16 by up to
#: 13%, so no bound on the bf16 changes
COHORT_NERR_SHARE = 0.02
COHORT_MODEL_RTOL = {"bfloat16": 1e-4, "float32": 1e-5}
COHORT_UPDATE_RTOL = {"bfloat16": None, "float32": 2e-2}
#: the SOM cohort: kohonen's DEFAULTS, P genomes (alpha0, alpha_min,
#: sigma0, sigma_min); against per-member runs on the card, the same f32
#: operations batched (bmm for mm): every fitness (the least mean
#: quantization error) within 1e-4 relative.  The maps are compared, not
#: bounded, as the kohonen phase compares card and CPU: a near-tie winner
#: that flips under another summation order moves other prototypes
#: (PERF.md)
SOM_GENOMES = ((0.3, 0.01, 4.0, 0.5), (0.5, 0.02, 4.0, 1.0),
               (0.1, 0.01, 3.0, 0.5), (0.3, 0.05, 2.0, 0.5))
SOM_FIT_RTOL = 1e-4
#: ensembles: mnist7 at full width, cut to one epoch a member
ENSEMBLE_MEMBERS, ENSEMBLE_EPOCHS = 2, 1
#: card (bf16 engine) against CPU (f32 member loop) on the same members:
#: mean probabilities within 2e-2 absolute, on the first ENSEMBLE_ROWS
#: validation images
ENSEMBLE_PROB_ATOL, ENSEMBLE_ROWS = 2e-2, 512


def _cli(args, timeout: float, env=None):
    """``python -m veles_tpu_torch ARGS`` from the repository root:
    (rc, stdout, stderr, seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "veles_tpu_torch", *args],
                         capture_output=True, text=True, cwd=HERE,
                         timeout=timeout, env=env)
    return res.returncode, res.stdout, res.stderr, \
        time.perf_counter() - t0


def _last_json(stdout: str) -> dict:
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    check(bool(lines), f"no JSON result line in {stdout[-500:]!r}")
    return json.loads(lines[-1])


def _per_genome_fitness(wf: str, cfg: str, values: dict, seed: int):
    """One genome trained on the card in process, as the one-shot worker
    does it: (fitness, train and validation minibatches, seconds)."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.genetics import substitute_tunes
    from veles_tpu_torch.launcher import (Launcher, apply_config_file,
                                          drive_workflow, workflow_fitness)
    import torch
    saved_root = copy.deepcopy(dict(root.__dict__))
    try:
        apply_config_file(cfg)
        substitute_tunes(root, values)
        launcher = Launcher(backend="cuda", seed=seed)
        t0 = time.perf_counter()
        drive_workflow(launcher, wf)
        torch.cuda.synchronize()
        w = launcher.workflow
        seconds = w.wall_time
        mb = sum(-(-h["count"] // w.loader.max_minibatch_size)
                 for h in w.decision.history)
        check(w.fused.compute_dtype == torch.float32,
              f"GA re-run in {w.fused.compute_dtype}")
        return workflow_fitness(w), mb, seconds, time.perf_counter() - t0
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved_root)


def ga_phase(card: str, workdir: str, data_dir: str) -> dict:
    """``python -m veles_tpu_torch -b cuda --optimize 8:2`` on
    ``models/mnist.py`` (BASELINE #1) from the IDX files, its two
    learning rates and the first layer's weight decay as genes (all
    liftable: one cohort a generation), 2 epochs a genome, in f32; then
    two genomes of the last generation trained per genome on the card."""
    gdir = os.path.join(workdir, "ga")
    os.makedirs(gdir, exist_ok=True)
    wf, cfg = os.path.join(gdir, "mnist_f32.py"), os.path.join(gdir,
                                                              "cfg.py")
    with open(wf, "w") as f:
        f.write(GA_WORKFLOW)
    with open(cfg, "w") as f:
        f.write(GA_CONFIG.format(data_dir=data_dir, epochs=GA_EPOCHS))
    state = os.path.join(gdir, "ga_state.json")
    rc, out, err, seconds = _cli(
        ["-b", "cuda", "--optimize", f"{GA_POP}:{GA_GENS}", "--ga-workers",
         "2", "--ga-state", state, "-s", str(GA_SEED), wf, cfg],
        timeout=600)
    check(rc == 0, f"--optimize exited {rc}: {err[-3000:]}")
    res = _last_json(out)
    ev = res.get("evaluator", {})
    name = card.split(",")[0].strip()
    check(np.isfinite(res["fitness"]), f"GA best fitness {res['fitness']}")
    check(ev.get("platform") == "cuda" and ev.get("device") == name,
          f"the evaluator's hello names {ev.get('device')!r} on "
          f"{ev.get('platform')!r}, not {name!r}")
    want_sizes = [[GA_POP]] + [[GA_POP - 2]] * GA_GENS
    check(res["cohort_sizes"] == want_sizes,
          f"cohort sizes {res['cohort_sizes']} (want {want_sizes}: one "
          f"cohort a generation; the 2 elites keep their fitness)")
    check(res["cohort_fallbacks"] == 0 and ev.get("fallbacks") == 0,
          f"fallbacks: GA {res['cohort_fallbacks']}, evaluator "
          f"{ev.get('fallbacks')}")
    stats = ev["cohort_stats"]
    check([s["members"] for s in stats] == [sz for g in want_sizes
                                            for sz in g],
          f"cohort path: trained chunks {stats}")
    with open(state) as f:
        final = json.load(f)["history"][-1]
    reruns = []
    for fit, values in final[:2]:
        got, mb, run_s, drive_s = _per_genome_fitness(wf, cfg, values,
                                                      GA_SEED)
        reruns.append({"values": values, "cohort_fitness": fit,
                       "per_genome_fitness": got,
                       "ms_per_minibatch": 1e3 * run_s / mb,
                       "minibatches": mb, "drive_s": drive_s})
        check(abs(got - fit) <= GA_FITNESS_ATOL,
              f"genome {values}: per genome {got}, cohort {fit}")
    cohort_ms = [1e3 * s["seconds"] / s["minibatches"] for s in stats]
    out = {"population": GA_POP, "generations": GA_GENS,
           "epochs": GA_EPOCHS, "dtype": "float32", "best": res["best"],
           "fitness": res["fitness"], "evaluations": res["evaluations"],
           "eval_seconds": res["eval_seconds"],
           "genomes_per_s": res["evaluations"] / res["eval_seconds"],
           "cohort_sizes": res["cohort_sizes"],
           "cohort_fallbacks": res["cohort_fallbacks"], "evaluator": ev,
           "cohort_ms_per_minibatch": cohort_ms, "reruns": reruns,
           "cli_s": seconds, "card": card}
    print(f"ga: best fitness {res['fitness']} of {res['evaluations']} "
          f"genomes in {res['eval_seconds']:.1f} s "
          f"({out['genomes_per_s']:.3f} genomes/s), cohorts "
          f"{res['cohort_sizes']}, 0 fallbacks; cohort ms per minibatch "
          f"{[round(v, 3) for v in cohort_ms]} for "
          f"{[s['members'] for s in stats]} members, one genome's "
          f"{[round(r['ms_per_minibatch'], 3) for r in reruns]}; re-runs "
          f"{[(r['cohort_fitness'], r['per_genome_fitness']) for r in reruns]}"
          f"  [{card}]", flush=True)
    return out


class _Folded:
    """Wraps ``lrn_cuda``'s kernel launches for one cohort run: keeps the
    first ``n`` (inputs, output) pairs of each kernel launched on a
    (members, N, H, W, C) tensor (the member rule's folded launches)."""

    def __init__(self, members: int, n: int) -> None:
        from veles_tpu_torch.ops import lrn_cuda
        self.mod, self.members, self.n = lrn_cuda, members, n
        self.fwd, self.bwd = [], []
        self.inner = (lrn_cuda._fwd_launch, lrn_cuda._bwd_launch)

        def fwd(x, *cfg):
            y = self.inner[0](x, *cfg)
            if len(self.fwd) < self.n and x.dim() == 5 and \
                    x.shape[0] == self.members:
                self.fwd.append((x.clone(), y.clone(), cfg))
            return y

        def bwd(x, e, *cfg):
            y = self.inner[1](x, e, *cfg)
            if len(self.bwd) < self.n and x.dim() == 5 and \
                    x.shape[0] == self.members:
                self.bwd.append((x.clone(), e.clone(), y.clone(), cfg))
            return y
        lrn_cuda._fwd_launch, lrn_cuda._bwd_launch = fwd, bwd

    def restore(self) -> None:
        self.mod._fwd_launch, self.mod._bwd_launch = self.inner


class _CachedSynthetic:
    """The synthetic set generated once for identical arguments while
    the phase runs (the cohort and its per-genome runs share one)."""

    def __init__(self) -> None:
        from veles_tpu_torch.loader import synthetic
        self.mod = synthetic.datasets
        self.inner = self.mod.synthetic_classification
        self.cache = {}

        def cached(*args, **kwargs):
            key = repr((args, sorted(kwargs.items())))
            if key not in self.cache:
                self.cache[key] = self.inner(*args, **kwargs)
            return copy.deepcopy(self.cache[key])
        self.mod.synthetic_classification = cached

    def restore(self) -> None:
        self.mod.synthetic_classification = self.inner


def _alexnet_for(rates=None, dtype=None):
    """A fresh AlexNet workflow of the cut set, seeded SEED, initialized
    on the card in ``dtype`` (None: the card's bf16); ``rates``
    (n_gd, 2) replaces its gradient units' base rates."""
    from veles_tpu_torch.config import parse_overrides, root
    from veles_tpu_torch.launcher import Launcher, load_workflow_module
    saved_root = copy.deepcopy(dict(root.__dict__))
    parse_overrides(COHORT_OVERRIDES)
    try:
        launcher = Launcher(backend="cuda", seed=SEED)
        create = load_workflow_module(ALEXNET_FILE).create_workflow
        launcher.create_workflow(create)
        if dtype is not None:
            launcher.workflow.fused.compute_dtype = dtype
        launcher.initialize()
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved_root)
    w = launcher.workflow
    if rates is not None:
        for gd, (lr, lrb) in zip(w.gds, rates):
            gd.learning_rate, gd.learning_rate_bias = float(lr), float(lrb)
    return w


def _norm(a) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def _rel_l2(got, want) -> float:
    return _norm(np.asarray(got, np.float64) - want) / max(_norm(want),
                                                           1e-30)


def _cohort_engine(dtype):
    """(workflow, engine) of an AlexNet cohort of the COHORT_LR_FACTORS
    in ``dtype``, and the members' rates."""
    from veles_tpu_torch.ops.fused import PopulationTrainEngine
    P = len(COHORT_LR_FACTORS)
    w = _alexnet_for(dtype=dtype)
    check(w.fused.compute_dtype == dtype, f"cohort in "
          f"{w.fused.compute_dtype}, not {dtype}")
    base = np.asarray([[gd.learning_rate, gd.learning_rate_bias]
                       for gd in w.gds], np.float32)
    rates = np.stack([base * f for f in COHORT_LR_FACTORS])
    decays = np.stack([np.asarray(
        [[gd.weight_decay, gd.weight_decay_bias] for gd in w.gds],
        np.float32)] * P)
    return w, PopulationTrainEngine(w, rates, decays), rates


def _cohort_profile(dtype) -> dict:
    """A whole cohort run under ``torch.profiler``: the device's kernel
    time per minibatch and the kernels and operators with the most of
    it."""
    import torch
    from torch.autograd import DeviceType
    w, engine, _ = _cohort_engine(dtype)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        engine.run()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    kernels = [a for a in avgs
               if getattr(a, "device_type", None) == DeviceType.CUDA]
    check(kernels, "cohort: torch.profiler saw no device activity")
    mb = engine.minibatches
    out = {"dtype": str(dtype).replace("torch.", ""),
           "wall_ms_per_minibatch": 1e3 * engine.seconds / mb,
           "device_ms_per_minibatch": sum(_self_device_us(a)
                                          for a in kernels) / 1e3 / mb,
           "top_kernels": _top(kernels, 8),
           "top_ops": _top([a for a in avgs if getattr(
               a, "device_type", None) != DeviceType.CUDA], 8)}
    engine.release()
    return out


def _check_folded(folded: _Folded, what: str) -> list:
    """Each folded launch ``folded`` kept (two a kernel) against its
    plain version on the same tensors: one bf16 ulp for the forward,
    ``check_bwd_bf16`` for the backward."""
    from veles_tpu_torch.ops import lrn_cuda
    rows = []
    for x, y, cfg in folded.fwd:
        ref = lrn_cuda.lrn_fwd_plain(x, *cfg)
        check_one_ulp(y, ref, f"{what} lrn_fwd {tuple(x.shape)}")
        rows.append({"kernel": "lrn_fwd", "shape": list(x.shape),
                     "max_abs_err": float((y.float() - ref.float())
                                          .abs().max())})
    for x, e, y, cfg in folded.bwd:
        ref = lrn_cuda.lrn_bwd_plain(x, e, *cfg)
        check_bwd_bf16(y, ref, x, e, *cfg[:3],
                       f"{what} lrn_bwd {tuple(x.shape)}", cfg[3])
        rows.append({"kernel": "lrn_bwd", "shape": list(x.shape),
                     "max_abs_err": float((y.float() - ref.float())
                                          .abs().max())})
    check(len(folded.fwd) == 2 and len(folded.bwd) == 2,
          f"{what}: folded launches seen: {len(folded.fwd)} fwd, "
          f"{len(folded.bwd)} bwd")
    return rows


def _cohort_run(dtype, folded_members: int = 0) -> dict:
    """One AlexNet cohort of the COHORT_LR_FACTORS in ``dtype``, and a
    per-genome run of each member's rates: the launches of the cohort
    run, its folded LRN launches (``folded_members`` > 0), and per member
    the n_err of every class end and each param's norms."""
    import torch
    P = len(COHORT_LR_FACTORS)
    w, engine, rates = _cohort_engine(dtype)
    init = w.fused.host_params()
    torch.cuda.reset_peak_memory_stats()
    folded = _Folded(P, 2) if folded_members else None
    _zero_launches()
    try:
        fits = engine.run()
        torch.cuda.synchronize()
    finally:
        if folded is not None:
            folded.restore()
    out = {"dtype": str(dtype).replace("torch.", ""),
           "launches": _launches(), "folded": folded,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "fitness": fits.tolist(), "cohort_s": engine.seconds,
           "cohort_minibatches": engine.minibatches}
    hist = [(e, k, a.tolist()) for e, k, a in engine.history]
    members = [engine.member_params(m) for m in range(P)]
    engine.release()
    del engine, w
    torch.cuda.empty_cache()
    out["members"] = []
    for m in range(P):
        wg = _alexnet_for(rates[m], dtype=dtype)
        wg.run()
        params = wg.fused.host_params()
        per_param = {f"{fn}.{pn}": {
            "norm": _norm(a), "update_norm": _norm(a - init[fn][pn]),
            "diff_norm": _norm(members[m][fn][pn] - a)}
            for fn, ps in params.items() for pn, a in ps.items()}
        total = sum(v["diff_norm"] ** 2 for v in per_param.values()) ** 0.5
        out["members"].append({
            "n_err_cohort": [row[2][m][0] for row in hist],
            "n_err": [h["n_err"] for h in wg.decision.history],
            "counts": [h["count"] for h in wg.decision.history],
            "model_rel_l2": total / max(sum(
                v["norm"] ** 2 for v in per_param.values()) ** 0.5, 1e-30),
            "worst_update_rel_l2": max(
                v["diff_norm"] / max(v["update_norm"], 1e-30)
                for v in per_param.values()),
            "params": per_param, "run_wall_s": wg.wall_time})
        del wg
        torch.cuda.empty_cache()
    return out


#: AlexNet's convolutions at batch 128 (NHWC input, OIHW weights,
#: stride, padding): what the cohort's grouped convolutions run
ALEXNET_CONVS = (((227, 227, 3), (96, 3, 11, 11), 4, 0),
                 ((27, 27, 96), (256, 96, 5, 5), 1, 2),
                 ((13, 13, 256), (384, 256, 3, 3), 1, 1),
                 ((13, 13, 384), (384, 384, 3, 3), 1, 1),
                 ((13, 13, 384), (256, 384, 3, 3), 1, 1))


def _conv_ms(fn, iters: int = 5) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after one warm call
    (CUDA events; the calls queue back to back)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def grouped_conv_times(members: int) -> list:
    """Per AlexNet convolution in bf16: ``torch.func.vmap`` over stacked
    weights (the cohort's path: one grouped convolution, its weight and
    input gradients) against a loop of one convolution per member, ms on
    warm shapes."""
    import torch
    import torch.nn.functional as F
    out = []
    for xs, ws, st, pad in ALEXNET_CONVS:
        x = torch.randn((members, TRAIN_BATCH) + xs, device="cuda",
                        dtype=torch.bfloat16)
        w = 0.01 * torch.randn((members,) + ws, device="cuda",
                               dtype=torch.bfloat16)

        def fwd(xx, ww):
            return F.conv2d(xx.permute(0, 3, 1, 2), ww, stride=st,
                            padding=pad).permute(0, 2, 3, 1)
        e = torch.randn((members,) + tuple(fwd(x[0], w[0]).shape),
                        device="cuda", dtype=torch.bfloat16)

        def wgrad(xx, ee, ww):
            return torch.nn.grad.conv2d_weight(
                xx.permute(0, 3, 1, 2), ww.shape, ee.permute(0, 3, 1, 2),
                stride=st, padding=pad)

        def dgrad(xx, ee, ww):
            return torch.nn.grad.conv2d_input(
                xx.permute(0, 3, 1, 2).shape, ww, ee.permute(0, 3, 1, 2),
                stride=st, padding=pad)
        row = {"input": list(xs), "weights": list(ws)}
        for name, fn, args in (("fwd", fwd, (x, w)),
                               ("wgrad", wgrad, (x, e, w)),
                               ("dgrad", dgrad, (x, e, w))):
            batched = torch.func.vmap(fn)
            row[f"{name}_grouped_ms"] = _conv_ms(lambda: batched(*args))
            row[f"{name}_loop_ms"] = _conv_ms(lambda: [
                fn(*(a[i] for a in args)) for i in range(members)])
        out.append(row)
    return out


def cohort_phase(card: str) -> dict:
    """``PopulationTrainEngine`` over full-width AlexNet, P = 2 learning
    rates, one epoch of 1024 + 128 images, in bf16: the launch counts
    (the member rule folds the members into one launch a layer), each
    kernel's folded output against its plain version, both members
    against per-genome runs; then the same in f32."""
    import torch

    P = len(COHORT_LR_FACTORS)
    cache = _CachedSynthetic()
    try:
        runs = [_cohort_run(torch.bfloat16, folded_members=P),
                _cohort_run(torch.float32)]
        profile = _cohort_profile(torch.bfloat16)
    finally:
        cache.restore()
    convs = grouped_conv_times(P)
    main = runs[0]
    launches = main["launches"]
    train_mb, valid_mb = N_TRAIN // TRAIN_BATCH, -(-N_VALID // TRAIN_BATCH)
    want = _want_launches(train_mb, valid_mb)
    for run in runs:
        check(run["launches"] == want,
              f"cohort of {P} in {run['dtype']}: launches "
              f"{run['launches']}, want {want} (one launch a layer for "
              f"all members)")
    folded = main.pop("folded")
    runs[1].pop("folded")
    kernels = _check_folded(folded, "cohort")
    del folded
    for run in runs:
        for m, mem in enumerate(run["members"]):
            check(len(mem["n_err"]) == len(mem["n_err_cohort"]) and all(
                abs(a - b) <= COHORT_NERR_SHARE * c for a, b, c in
                zip(mem["n_err_cohort"], mem["n_err"], mem["counts"])),
                f"{run['dtype']} member {m}: cohort n_err "
                f"{mem['n_err_cohort']}, per genome {mem['n_err']}")
            rtol = COHORT_MODEL_RTOL[run["dtype"]]
            check(rtol is None or mem["model_rel_l2"] <= rtol,
                  f"{run['dtype']} member {m}: params differ by "
                  f"{mem['model_rel_l2']} (relative L2 of the model)")
            rtol = COHORT_UPDATE_RTOL[run["dtype"]]
            check(rtol is None or mem["worst_update_rel_l2"] <= rtol,
                  f"{run['dtype']} member {m}: a param's change differs "
                  f"by {mem['worst_update_rel_l2']} (relative L2)")
        mb = run["cohort_minibatches"]
        run["cohort_ms_per_minibatch"] = 1e3 * run["cohort_s"] / mb
        run["per_genome_ms_per_minibatch"] = [
            1e3 * mem["run_wall_s"] / mb for mem in run["members"]]
    out = {"members": P, "lr_factors": list(COHORT_LR_FACTORS),
           "epochs": 1, "launches": launches, "folded_kernels": kernels,
           "runs": runs, "profile": profile, "grouped_convs": convs,
           "card": card}
    for run in runs:
        print(f"cohort: AlexNet P={P} {run['dtype']}, launches "
              f"{run['launches']}; {run['cohort_ms_per_minibatch']:.2f} ms "
              f"a minibatch for both members, one genome's "
              f"{[round(v, 2) for v in run['per_genome_ms_per_minibatch']]};"
              f" vs per genome: model rel L2 "
              f"{[m['model_rel_l2'] for m in run['members']]}, worst "
              f"update rel L2 "
              f"{[m['worst_update_rel_l2'] for m in run['members']]}; "
              f"peak {run['peak_memory_bytes']} bytes  [{card}]",
              flush=True)
    print(f"cohort: profiled {profile['dtype']} run: "
          f"{profile['wall_ms_per_minibatch']:.2f} ms wall, "
          f"{profile['device_ms_per_minibatch']:.2f} ms of kernels a "
          f"minibatch; top kernels {_brief(profile['top_kernels'])}; top "
          f"operators {_brief(profile['top_ops'])}  [{card}]", flush=True)
    print("cohort: bf16 convolutions, grouped (vmap) vs a loop of "
          f"{P}, ms fwd / wgrad / dgrad: " + "; ".join(
              f"{c['weights']}: " + " / ".join(
                  f"{c[k + '_grouped_ms']:.3f} vs {c[k + '_loop_ms']:.3f}"
                  for k in ("fwd", "wgrad", "dgrad")) for c in convs)
          + f"  [{card}]", flush=True)
    return out


def _som_winners(weights: np.ndarray, x) -> np.ndarray:
    """Each sample's winning prototype on a (N, D) host map."""
    import torch
    from veles_tpu_torch.ops.kohonen import sq_distances
    return sq_distances(torch.from_numpy(weights).to(x.device),
                        x.float()).argmin(1).cpu().numpy()


def som_cohort_phase(card: str) -> dict:
    """``SOMPopulationEngine`` over ``models/kohonen.py``'s DEFAULTS with
    the SOM_GENOMES, against one run per genome, all on the card."""
    import torch

    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher, load_workflow_module
    from veles_tpu_torch.ops.kohonen import SOMPopulationEngine
    create = load_workflow_module(
        os.path.join(MODELS_DIR, "kohonen.py")).create_workflow

    def build(hp):
        saved_root = copy.deepcopy(dict(root.__dict__))
        try:
            root.kohonen.trainer = {"alpha0": hp[0], "alpha_min": hp[1],
                                    "sigma0": hp[2], "sigma_min": hp[3]}
            launcher = Launcher(backend="cuda", seed=SEED)
            launcher.create_workflow(create)
            launcher.initialize()
        finally:
            root.__dict__.clear()
            root.__dict__.update(saved_root)
        return launcher.workflow

    w = build(SOM_GENOMES[0])
    engine = SOMPopulationEngine(w, np.asarray(SOM_GENOMES, np.float32))
    _zero_launches()
    t0 = time.perf_counter()
    fits = engine.run()
    torch.cuda.synchronize()
    cohort_s = time.perf_counter() - t0
    launches = _launches()
    maps = engine.weights.cpu().numpy()
    engine.release()
    x = w.loader.original_data.reshape(len(w.loader.original_data), -1)
    rows, per_s = [], []
    for m, hp in enumerate(SOM_GENOMES):
        wm = build(hp)
        t0 = time.perf_counter()
        wm.run()
        per_s.append(time.perf_counter() - t0)
        want = min(h["loss"] for h in wm.decision.history)
        rel_fit = abs(fits[m] - want) / max(abs(want), 1e-30)
        rel_map = _rel_l2(maps[m], wm.trainer.host_weights())
        check(rel_fit <= SOM_FIT_RTOL,
              f"SOM genome {hp}: fitness {fits[m]} vs {want}")
        differ = int((_som_winners(maps[m], x) != _som_winners(
            wm.trainer.host_weights(), x)).sum())
        rows.append({"genome": list(hp), "fitness": float(fits[m]),
                     "per_member_fitness": want, "rel_fitness": rel_fit,
                     "rel_map_l2": rel_map, "winners_differ": differ})
    check(not any(launches.values()), f"SOM cohort launched {launches}")
    out = {"members": len(SOM_GENOMES), "epochs": w.decision.max_epochs,
           "genomes": rows, "cohort_s": cohort_s, "per_member_s": per_s,
           "launches": launches, "card": card}
    print(f"som_cohort: {len(SOM_GENOMES)} genomes in {cohort_s:.3f} s, "
          f"per member {[round(s, 3) for s in per_s]} s; fitness "
          f"{[r['fitness'] for r in rows]}; worst rel fitness "
          f"{max(r['rel_fitness'] for r in rows):.3g}, map "
          f"{max(r['rel_map_l2'] for r in rows):.3g}; samples with another "
          f"winner {[r['winners_differ'] for r in rows]} of "
          f"{len(x)}  [{card}]", flush=True)
    return out


def ensemble_phase(card: str, workdir: str, data_dir: str) -> dict:
    """``--ensemble-train 2 --ensemble-test`` on ``models/mnist7.py``
    through the CLI on the card (the engine), ``--ensemble-test
    --ensemble-device host`` (the CPU member loop), and the same members'
    mean probabilities on the card against the CPU."""
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import parse_overrides, root
    from veles_tpu_torch.ensemble import EnsemblePredictor, load_members
    from veles_tpu_torch.launcher import load_workflow_module
    from veles_tpu_torch.loader.base import VALID
    wf = os.path.join(MODELS_DIR, "mnist7.py")
    path = os.path.join(workdir, "mnist7_members.npz")
    over = [f"root.common.data_dir={data_dir}",
            f"root.mnist7.decision.max_epochs={ENSEMBLE_EPOCHS}"]
    rc, out, err, train_s = _cli(
        ["-b", "cuda", "--ensemble-train", str(ENSEMBLE_MEMBERS),
         "--ensemble-test", "--ensemble-file", path, wf, *over],
        timeout=600)
    check(rc == 0, f"--ensemble-train exited {rc}: {err[-3000:]}")
    lines = [json.loads(ln) for ln in out.strip().splitlines()
             if ln.startswith("{")]
    check(len(lines) == 2 and lines[0]["members"] == ENSEMBLE_MEMBERS,
          f"--ensemble-train printed {lines}")
    trained, engine = lines
    rc, out, err, host_s = _cli(
        ["-b", "cuda", "--ensemble-test", "--ensemble-device", "host",
         "--ensemble-file", path, wf, *over], timeout=600)
    check(rc == 0, f"--ensemble-test host exited {rc}: {err[-3000:]}")
    host = _last_json(out)
    n_valid = MNIST_SIZES[1]
    check(engine["ensemble_eval_engine"] == "device"
          and host["ensemble_eval_engine"] == "host",
          f"engines {engine['ensemble_eval_engine']} / "
          f"{host['ensemble_eval_engine']}")
    gap = abs(engine["ensemble_valid_error_pct"]
              - host["ensemble_valid_error_pct"])
    check(gap <= 100.0 / n_valid + 1e-9,
          f"ensemble error % card {engine['ensemble_valid_error_pct']} vs "
          f"host {host['ensemble_valid_error_pct']}: more than one image")
    members = load_members(path)
    create = load_workflow_module(wf).create_workflow

    class _FL:
        workflow = None

    saved_root = copy.deepcopy(dict(root.__dict__))
    parse_overrides(over)
    try:
        preds = {b: EnsemblePredictor(lambda: create(_FL()),
                                      lambda b=b: make_device(b), members)
                 for b in ("cuda", "cpu")}
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved_root)
    ld = preds["cpu"].workflow.loader
    off = ld.class_offset(VALID)
    x = ld.normalized_host_rows(slice(off, off + ENSEMBLE_ROWS))
    _zero_launches()
    card_p = preds["cuda"].predict_proba(x)
    launches = _launches()
    cpu_p = preds["cpu"].predict_proba_host(x)
    worst = float(np.abs(card_p - cpu_p).max())
    check(worst <= ENSEMBLE_PROB_ATOL,
          f"ensemble probabilities card vs CPU differ by {worst}")
    out = {"members": ENSEMBLE_MEMBERS, "epochs": ENSEMBLE_EPOCHS,
           "member_valid_errors_pct": trained["member_valid_errors_pct"],
           "ensemble_valid_error_pct": engine["ensemble_valid_error_pct"],
           "host_ensemble_valid_error_pct":
               host["ensemble_valid_error_pct"],
           "card_vs_cpu_max_prob_diff": worst, "rows": ENSEMBLE_ROWS,
           "train_and_test_cli_s": train_s, "host_test_cli_s": host_s,
           "launches": launches, "card": card}
    print(f"ensemble: mnist7 x{ENSEMBLE_MEMBERS}, member valid error % "
          f"{trained['member_valid_errors_pct']}, ensemble "
          f"{engine['ensemble_valid_error_pct']} (engine) / "
          f"{host['ensemble_valid_error_pct']} (host); probabilities card "
          f"vs CPU within {worst:.3g}  [{card}]", flush=True)
    return out


# -- phase 23: online learning and the GA handoff --------------------------

#: the online phase's learner: micro-batch 32 (the reference's default),
#: a gate round every 8 steps, and margin 0, so the first round promotes
#: on equal error and the swap runs at full width
ONLINE_MB = 32
ONLINE_STEPS = 16
ONLINE_ENV = {"VELES_ONLINE_MICRO_BATCH": str(ONLINE_MB),
              "VELES_ONLINE_BUFFER_ROWS": "512",
              "VELES_ONLINE_MIN_STEPS": "8",
              "VELES_ONLINE_PROMOTE_MARGIN": "0",
              "VELES_ONLINE_HOLDOUT_EVERY": "8",
              "VELES_ONLINE_IDLE_MS": "1"}
#: the shadow's f32 step on the card against the CPU's, from the same
#: params on the same micro-batches (dropout 0): every param's change
#: over 2 steps within 1e-2 relative (L2).  Unlike phase 5 the step is
#: not replayed on the card's choices: a max-pool window's two largest
#: inputs, or a ReLU's input and zero, that lie closer than the two
#: devices' f32 disagreement choose apart, and the train phase's
#: unreplayed 64-image step has moved its changes by up to 2.2e-3 on an
#: H100 (PERF.md); each of the 64 member-rows here can flip such a
#: choice twice
ONLINE_CPU_RTOL = 1e-2
#: the learner-on p99 bound of the reference's tier-1 test
#: (tests/test_online.py): max(8 x learner-off p99, + 250 ms)
ONLINE_P99_FACTOR, ONLINE_P99_SLACK_MS = 8.0, 250.0
#: the reference's tier-1 learner settings for the drift run
#: (tests/test_online.py)
DRIFT_ENV = {"VELES_ONLINE_MICRO_BATCH": "8",
             "VELES_ONLINE_MIN_STEPS": "4",
             "VELES_ONLINE_LR_SCALE": "1.0",
             "VELES_ONLINE_PROMOTE_MARGIN": "5.0",
             "VELES_ONLINE_HOLDOUT_EVERY": "6",
             "VELES_ONLINE_IDLE_MS": "1"}
DRIFT_WORKFLOW = '''
from veles_tpu_torch import prng
from veles_tpu_torch.datasets import synthetic_classification
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow


def create_workflow(launcher):
    prng.seed_all(4242)
    train, valid, _ = synthetic_classification(
        64, 16, (6, 6, 1), n_classes=3, seed=5)
    return StandardWorkflow(
        loader_factory=lambda w: ArrayLoader(
            w, train=train, valid=valid, minibatch_size=16,
            name="loader"),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 12},
                 "<-": {"learning_rate": 0.1}},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": {"learning_rate": 0.1}}],
        decision_config={"max_epochs": 2}, name="hive_wf")
'''


def labeled_stream():
    """``request_rows()`` with a label per row, one of the 1000 classes
    drawn from SEED: truth the random-weight ensemble does not know."""
    gen = np.random.default_rng(SEED + 200)
    return [(r, gen.integers(0, N_CLASSES, len(r))) for r in request_rows()]


def _padded_answer(engine, rows: np.ndarray) -> np.ndarray:
    """``rows``' mean probabilities from a fresh engine, zero-padded to
    the hive's batch as the batcher pads them."""
    from veles_tpu_torch.ops import batching
    return engine.predict_proba(batching.pad_rows(rows, MAX_BATCH))[
        :len(rows)]


def _tree_equal(a, b) -> bool:
    import torch
    return all(torch.equal(t, b[fn][pn]) for fn, ps in a.items()
               for pn, t in ps.items())


def _shadow_card_vs_cpu(model, buf, lr_scale: float) -> dict:
    """Two f32 shadow steps (dropout 0) on the card and on the CPU from
    the model's members on the same micro-batches: each param's change
    within ONLINE_CPU_RTOL (L2, relative), the counts equal and n_err
    within 1 a member and step (an argmax near tie)."""
    import torch

    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.models import alexnet
    from veles_tpu_torch.online.trainer import ShadowTrainer
    from veles_tpu_torch.ops import batching

    class FL:
        workflow = None

    w = alexnet.create_workflow(FL(), dropout=0.0)
    w.initialize()
    card = make_device("cuda")
    card.compute_dtype = torch.float32
    out = {}
    for name, dev in (("card", card), ("cpu", make_device("cpu"))):
        tr = ShadowTrainer(w.forwards, w.gds, w.evaluator, dev,
                           batching.stack_member_params(
                               w.forwards, model.member_params, dev),
                           seed=SEED, lr_scale=lr_scale,
                           micro_batch=ONLINE_MB)
        mets = []
        for k in range(2):
            x, lb = buf.sample(ONLINE_MB, tr.sample_rng(k))
            mets.append(tr.step(x, lb, buf.version))
        out[name] = ({fn: {pn: dev.get(t) for pn, t in ps.items()}
                      for fn, ps in tr._params.items()}, np.stack(mets))
        del tr
    before = batching.stack_member_params(w.forwards, model.member_params,
                                          make_device("cpu"))
    before = {fn: {pn: t.numpy() for pn, t in ps.items()}
              for fn, ps in before.items()}
    rel = _rel_delta_diff(before, out["card"][0], out["cpu"][0])
    worst = max(rel.values())
    check(worst <= ONLINE_CPU_RTOL,
          f"online: f32 shadow steps card vs CPU differ by {worst:.3g} "
          f"(relative, limit {ONLINE_CPU_RTOL})")
    m_card, m_cpu = out["card"][1], out["cpu"][1]
    check(np.array_equal(m_card[..., 2], m_cpu[..., 2]) and np.all(
        np.abs(m_card[..., 0] - m_cpu[..., 0]) <= 1),
          f"online: n_err/count card {m_card.tolist()} cpu "
          f"{m_cpu.tolist()}")
    return {"worst_rel_delta_diff": worst, "rel_delta_diff": rel,
            "n_err_card": m_card[..., 0].tolist(),
            "n_err_cpu": m_cpu[..., 0].tolist()}


def _online_in_process(card: str, workdir: str, pkg: str) -> dict:
    """The learner's parts in this process on the served AlexNet: tap,
    16 counted shadow steps, the offline replay, f32 card vs CPU, and a
    gate round that promotes."""
    import torch

    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.online import OnlineLearner
    from veles_tpu_torch.online.buffer import ReplayBuffer
    from veles_tpu_torch.online.trainer import ShadowTrainer
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    from veles_tpu_torch.serve.hive import load_model_package
    from veles_tpu_torch.serve.residency import ResidencyManager

    device = make_device("cuda")
    model = load_model_package("alexnet", pkg, device,
                               os.path.join(workdir, "online_install"),
                               dict(root.__dict__))
    res = ResidencyManager(device, max_batch=MAX_BATCH, max_wait_s=0.02)
    res.register(model)
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated: the peak counts it too
    base = torch.cuda.memory_allocated()
    engine = res.ensure("alexnet")
    learner = OnlineLearner(res, environ=ONLINE_ENV)
    check(learner.arm_model("alexnet"), "online: AlexNet not armed")
    trainer = learner._trainers["alexnet"]
    gate = learner._gates["alexnet"]
    buf = learner.tap.buffers["alexnet"]
    stream = labeled_stream()
    t0 = time.perf_counter()
    for jid, (rows, labels) in enumerate(stream):
        learner.tap.tap("alexnet", jid, rows, labels)
    tap_s = time.perf_counter() - t0
    check(buf.train_rows >= ONLINE_MB and buf.holdout_rows >= 4,
          f"online: buffer {buf.train_rows} + {buf.holdout_rows} rows")
    incumbent = engine.stacked_params

    # the counted steps: the main path of the in-process online tier
    folded = _Folded(N_MEMBERS, 2)
    step_ms, sample_ms, mets = [], [], []
    _zero_launches()
    try:
        for _ in range(ONLINE_STEPS):
            t0 = time.perf_counter()
            x, lb = buf.sample(ONLINE_MB, trainer.sample_rng())
            t1 = time.perf_counter()
            mets.append(trainer.step(x, lb, buf.version))
            sample_ms.append(1e3 * (t1 - t0))
            step_ms.append(1e3 * (time.perf_counter() - t1))
            # the scavenger's mark: the time-to-serve clock starts here
            gate.last_step_ts = time.monotonic()
    finally:
        folded.restore()
    launches = _launches()
    want = {"lrn_fwd": 2 * ONLINE_STEPS, "lrn_bwd": 2 * ONLINE_STEPS}
    check(launches == want, f"online: {ONLINE_STEPS} shadow steps "
          f"launched {launches}, want {want} (one launch a norm layer "
          f"for both members)")
    kernels = _check_folded(folded, "online")
    del folded
    mets = np.stack(mets)
    check(np.all(np.isfinite(mets)) and np.all(mets[..., 2] == ONLINE_MB),
          f"online: step metrics {mets.tolist()}")

    # one gate round at margin 0 promotes; the served answers are then a
    # fresh engine's on the refreshed host members, bitwise
    check(gate.due(trainer.steps), "online: no gate round due")
    t0 = time.perf_counter()
    learner._gate_round("alexnet", trainer, buf, gate)
    gate_s = time.perf_counter() - t0
    check(gate.promotions == 1 and engine.stacked_params is not incumbent,
          f"online: the gate round did not promote (shadow "
          f"{gate.shadow_error_pct}%, incumbent "
          f"{gate.incumbent_error_pct}%)")
    rows = stream[0][0]
    served = engine.submit(rows).result(timeout=300)
    fresh = EnsembleEvalEngine(model.forwards,
                               res.models["alexnet"].member_params, device)
    check(np.array_equal(served, _padded_answer(fresh, rows)),
          "online: served answers after the promotion differ from a "
          "fresh engine on host_members()")
    fresh.release()
    check(gate.time_to_serve_ms is not None, "online: no time_to_serve")

    # the offline replay: the same adds, the recorded (step, version)
    # history, a fresh trainer from the old incumbent: bitwise the tree
    # the gate promoted
    rbuf = ReplayBuffer(buf.capacity, seed=trainer.seed,
                        holdout_every=buf.holdout_every)
    for rows, labels in stream:
        rbuf.add(rows, labels)
    replay = ShadowTrainer(trainer.forwards, trainer.gds,
                           trainer.evaluator, device, incumbent,
                           seed=trainer.seed, lr_scale=learner.lr_scale,
                           micro_batch=ONLINE_MB)
    for step, version in trainer.history:
        check(rbuf.version == version, "online: replay buffer version")
        x, lb = rbuf.sample(ONLINE_MB, replay.sample_rng(step))
        replay.step(x, lb, version)
    promoted = engine.stacked_params
    bitwise = _tree_equal(replay._params, promoted)
    worst = max(float((a - promoted[fn][pn]).abs().max())
                for fn, ps in replay._params.items()
                for pn, a in ps.items())
    check(bitwise, f"online: the offline replay differs by up to "
          f"{worst:.3g} from the online steps")
    del replay
    cpu = _shadow_card_vs_cpu(model, buf, learner.lr_scale)

    peak = torch.cuda.max_memory_allocated()
    out = {"members": N_MEMBERS, "micro_batch": ONLINE_MB,
           "steps": ONLINE_STEPS, "step_ms": step_ms,
           "step_ms_median": float(np.median(step_ms[1:])),
           "sample_ms": sample_ms, "tap_s": tap_s,
           "buffer_rows": buf.train_rows, "holdout_rows": buf.holdout_rows,
           "buffer_bytes": buf.nbytes, "buffer_quantized": buf.quantized,
           "launches": launches, "folded_kernels": kernels,
           "replay_bitwise": bitwise, "replay_max_abs_diff": worst,
           "f32_card_vs_cpu": cpu, "gate_s": gate_s,
           "shadow_error_pct": gate.shadow_error_pct,
           "incumbent_error_pct": gate.incumbent_error_pct,
           "swap_ms": gate.last_promotion["swap_ms"],
           "time_to_serve_ms": gate.time_to_serve_ms,
           "ledger": res.ledger(), "peak_memory_bytes": peak,
           "base_memory_bytes": base}
    res.close()
    return out


def _online_handoff(card: str, workdir: str) -> dict:
    """An AlexNet cohort of P = 2 (one epoch of 256 + 128 images), then
    its best member adopted into a pre-built serving engine: the served
    answers are a fresh engine's on that member's params, bitwise, and
    no npz is written on the way."""
    import glob

    import torch

    from veles_tpu_torch.config import parse_overrides, root
    from veles_tpu_torch.genetics import GAServingHandoff
    from veles_tpu_torch.launcher import Launcher, load_workflow_module
    from veles_tpu_torch.ops.fused import (EnsembleEvalEngine,
                                           PopulationTrainEngine)
    from veles_tpu_torch.serve.residency import ResidencyManager

    saved_root = copy.deepcopy(dict(root.__dict__))
    parse_overrides(["root.alexnet.loader.n_train=256",
                     "root.alexnet.loader.n_valid=128",
                     "root.alexnet.decision.max_epochs=1"])
    try:
        launcher = Launcher(backend="cuda", seed=SEED)
        launcher.create_workflow(
            load_workflow_module(ALEXNET_FILE).create_workflow)
        launcher.initialize()
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved_root)
    w = launcher.workflow
    base = np.asarray([[gd.learning_rate, gd.learning_rate_bias]
                       for gd in w.gds], np.float32)
    decays = np.asarray([[gd.weight_decay, gd.weight_decay_bias]
                         for gd in w.gds], np.float32)
    engine = PopulationTrainEngine(
        w, np.stack([base * f for f in COHORT_LR_FACTORS]),
        np.stack([decays] * len(COHORT_LR_FACTORS)))
    mgr = ResidencyManager(w.fused.device, max_batch=MAX_BATCH,
                           max_wait_s=0.02)
    ho = GAServingHandoff(mgr, "winner", w.fused.forwards,
                          [engine.member_params(0)],
                          sample_shape=SAMPLE_SHAPE)
    fits = engine.run()
    ho.prewarm(engine)
    npz_before = glob.glob(os.path.join(workdir, "**", "*.npz"),
                           recursive=True)
    keep = {f: getattr(np, f) for f in ("save", "savez",
                                        "savez_compressed")}

    def refuse(*a, **k):
        raise SmokeFailure("online: the GA handoff saved an npz")
    for f in keep:
        setattr(np, f, refuse)
    try:
        served_engine = ho.adopt_cohort(engine, fits)
    finally:
        for f, fn in keep.items():
            setattr(np, f, fn)
    best = int(ho.top_k(fits)[0])
    rows = request_rows()[0]
    served = served_engine.submit(rows).result(timeout=300)
    fresh = EnsembleEvalEngine(w.fused.forwards,
                               [engine.member_params(best)],
                               w.fused.device)
    check(np.array_equal(served, _padded_answer(fresh, rows)),
          "online: the adopted member's served answers differ from a "
          "fresh engine on its params")
    fresh.release()
    npz = glob.glob(os.path.join(workdir, "**", "*.npz"), recursive=True)
    check(npz == npz_before, f"online: npz files written by the handoff: "
          f"{sorted(set(npz) - set(npz_before))}")
    out = {"members": len(COHORT_LR_FACTORS), "k": 1,
           "fitness": fits.tolist(), "adopted": best,
           "cohort_minibatches": engine.minibatches,
           "adopt_ms": 1e3 * ho.adopt_seconds, "bitwise": True}
    engine.release()
    mgr.close()
    del engine, w, launcher
    torch.cuda.empty_cache()
    return out


def _timed_stream(client, stream) -> list:
    """The labeled stream sent one request at a time, a 10 ms pause after
    every 5 (live traffic has gaps: the scavenger's resource); each
    answer checked; per-request ms."""
    lat = []
    for i, (rows, labels) in enumerate(stream):
        t0 = time.perf_counter()
        a = client.request("alexnet", rows, timeout=300, label=labels)
        lat.append(1e3 * (time.perf_counter() - t0))
        check("probs" in a and a["rows_n"] == len(rows),
              f"online hive: request {i}: {str(a)[:200]}")
        if i % 5 == 4:
            time.sleep(0.01)
    return lat


#: the requests of each of the --online hive's two timed streams (cut from
#: the stream's 24, then 12 before PR 18, to keep a whole run inside its
#: time)
ONLINE_SERVE_REQUESTS = 6


def _start_online_hive(workdir: str, pkg: str):
    """``--serve-models alexnet=PKG --online`` on the card, up to its
    hello: (client, its stderr file, seconds to the hello)."""
    from veles_tpu_torch.serve.client import HiveClient

    err = open(os.path.join(workdir, "online_hive.stderr"), "w")
    t0 = time.perf_counter()
    try:
        client = HiveClient(
            {"alexnet": pkg}, backend="cuda", max_batch=MAX_BATCH,
            max_wait_ms=20, heartbeat_every=0,
            install_dir=os.path.join(workdir, "online_hive_install"),
            online=True, env=ONLINE_ENV, stderr=err, start_timeout=600)
    except BaseException:
        err.close()
        raise
    return client, err, time.perf_counter() - t0


def _online_serve(card: str, started) -> dict:
    """The started ``--online`` hive (``_start_online_hive``): three
    warm-up requests, then one labeled stream with the learner
    suspended, and again with it resumed (after its first step); p50 and
    p99 of each; the hive's launches over its whole life."""
    stream = labeled_stream()[:ONLINE_SERVE_REQUESTS]
    client, err, ready_s = started
    with err:
        try:
            check(client.hello.get("online") is True,
                  f"online hive: hello {client.hello}")
            st0 = client.stats()
            check(st0["kernel_launches"] == {"lrn_fwd": 0, "lrn_bwd": 0},
                  f"online hive: counts not zero at start: {st0}")
            check(client.learner_ctl(suspend=True) == {
                "online": True, "suspended": True}, "learner_ctl")
            # the serving dispatch's first use before either window
            # (unlabeled: these rows never reach the buffer)
            for rows, _ in stream[:3]:
                check("probs" in client.request("alexnet", rows,
                                                timeout=300),
                      "online hive: warm-up request failed")
            lat_off = _timed_stream(client, stream)
            st_off = client.stats()
            check(st_off["online"]["steps"] == 0,
                  f"online hive: steps while suspended: {st_off}")
            check(client.learner_ctl(suspend=False)["suspended"] is False,
                  "learner_ctl resume")
            # the first step (the grouped convolutions' first use) lands
            # before the timed window, as the reference's test warms it
            deadline = time.monotonic() + 120
            while client.stats()["online"]["steps"] == 0:
                check(time.monotonic() < deadline,
                      "online hive: the learner never stepped")
                time.sleep(0.1)
            st_warm = client.stats()
            lat_on = _timed_stream(client, stream)
            st1 = client.stats()
            learn = client.learn()["alexnet"]
        finally:
            client.close()
    p = {k: (float(np.percentile(v, 50)), float(np.percentile(v, 99)))
         for k, v in (("off", lat_off), ("on", lat_on))}
    bound = max(ONLINE_P99_FACTOR * p["off"][1],
                p["off"][1] + ONLINE_P99_SLACK_MS)
    check(p["on"][1] <= bound, f"online hive: learner-on p99 "
          f"{p['on'][1]:.1f} ms over the bound {bound:.1f} ms")
    on = st1["online"]
    launches = st1["kernel_launches"]
    check(on["steps"] > st_warm["online"]["steps"],
          f"online hive: no step during the timed stream: {on}")
    check(launches["lrn_bwd"] == 2 * on["steps"] and
          launches["lrn_fwd"] >= 2 * N_MEMBERS * st1["dispatches"]
          + 2 * on["steps"],
          f"online hive: launches {launches} for {st1['dispatches']} "
          f"dispatches and {on['steps']} steps")
    return {"ready_s": ready_s, "requests": len(stream),
            "p50_ms_off": p["off"][0], "p99_ms_off": p["off"][1],
            "p50_ms_on": p["on"][0], "p99_ms_on": p["on"][1],
            "p99_ratio": p["on"][1] / p["off"][1], "p99_bound_ms": bound,
            "steps": on["steps"], "steps_in_window":
            on["steps"] - st_warm["online"]["steps"],
            "gate_rounds": on["gate_rounds"],
            "gate_aborts": on["gate_aborts"],
            "steps_skipped_busy": on["steps_skipped_busy"],
            "step_ema_ms": on["step_ema_ms"], "learn": learn,
            "dispatches": st1["dispatches"], "launches": launches,
            "ledger": st1["ledger"]}


def _drift_package(workdir: str):
    """The tier-1 hive test's model (6x6x1 -> 12 tanh -> 3 softmax) as a
    3-member package: the workflow's initial params plus gaussian noise
    from numpy seed 11; and its data set's rows and labels."""
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.ensemble.packaging import pack_ensemble
    from veles_tpu_torch.launcher import load_workflow_module

    class FL:
        workflow = None

    entry = os.path.join(workdir, "drift_entry.py")
    with open(entry, "w") as f:
        f.write(DRIFT_WORKFLOW)
    w = load_workflow_module(entry).create_workflow(FL())
    w.initialize(device=make_device("cpu"), train=True)
    base = w.fused.host_params()
    rng = np.random.default_rng(11)
    members = [{"params": {fn: {pn: a + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32) for pn, a in ps.items()}
        for fn, ps in base.items()}, "seed": 11, "valid_error": 0.0,
        "forward_names": [f.name for f in w.forwards]} for _ in range(3)]
    pkg = pack_ensemble(os.path.join(workdir, "drift.vpkg"), "alpha",
                        members, entry)
    return pkg, w, members, w.loader.original_data.float().numpy(), \
        w.loader.original_labels.numpy()


def _promote_lineage(metrics_dir: str, pid: int, minted: set) -> dict:
    """The drift hive's promotion dump: ``flightrec-<pid>-<n>-promote.json``
    in its metrics dir, whose ring holds ``gate.promote`` with
    ``lineage_n`` > 0, and the journal's promotion events, whose lineage
    holds only trace ids the client minted."""
    import glob

    from veles_tpu_torch import obs
    dumps = sorted(glob.glob(os.path.join(
        metrics_dir, f"flightrec-{pid}-*-promote.json")))
    check(dumps, f"drift: no promote dump in {os.listdir(metrics_dir)}")
    with open(dumps[0]) as f:
        ring = json.load(f)["ring"]
    gate = [e for e in ring if e.get("ev") == "gate.promote"]
    check(gate and gate[0]["lineage_n"] > 0,
          f"drift: the promote dump's gate entries {gate}")
    _reg, _snaps, _journals, evs = obs.load_dir(metrics_dir)
    promoted = [e for e in evs if e["event"] == "online.promoted"]
    lineage = [t for e in promoted for t in e.get("lineage") or ()]
    check(promoted and len(promoted[0]["lineage"] or ()) ==
          gate[0]["lineage_n"] and lineage and set(lineage) <= minted,
          f"drift: promotion lineage {lineage[:4]}... ({len(lineage)}), "
          f"{len(set(lineage) - minted)} not minted by the client")
    return {"dumps": len(dumps), "lineage_n": gate[0]["lineage_n"],
            "promotions_journaled": len(promoted),
            "lineage_ids": len(set(lineage))}


def _online_drift(card: str, workdir: str) -> dict:
    """The tier-1 hive test's drift on the card through the CLI: labels
    rotated one class, so the frozen ensemble is consistently wrong; the
    learner must promote with the shadow ahead by the margin, and the
    answers after it must beat the frozen ensemble on the drifted
    truth.  Each request carries a context from ``trace.mint()``, and
    the promotion's dump carries the lineage of those trace ids."""
    from veles_tpu_torch import trace
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.convert import params_from_jax
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    from veles_tpu_torch.serve.client import HiveClient

    pkg, w, members, xs, ys = _drift_package(workdir)
    frozen = EnsembleEvalEngine(
        w.forwards, [params_from_jax(m["params"]) for m in members],
        make_device("cpu")).predict_proba(xs).argmax(-1)
    drifted = (ys + 1) % 3
    metrics_dir = os.path.join(workdir, "drift_metrics")
    minted = set()
    t0 = time.perf_counter()
    with open(os.path.join(workdir, "drift_hive.stderr"), "w") as err:
        client = HiveClient({"alpha": pkg}, backend="cuda", max_batch=8,
                            max_wait_ms=2, heartbeat_every=0, online=True,
                            env=DRIFT_ENV, stderr=err, start_timeout=300,
                            metrics_dir=metrics_dir)
        try:
            t_ready = time.perf_counter()
            i, row, first = 0, None, None
            while time.perf_counter() - t_ready < 60:
                for _ in range(8):
                    j = i % len(xs)
                    i += 1
                    ctx = trace.mint()
                    minted.add(ctx.trace_id)
                    a = client.request("alpha", xs[j][None],
                                       label=[int(drifted[j])], ctx=ctx)
                    check("probs" in a, f"drift: {a}")
                row = client.learn()["alpha"]
                if row["promotions"] >= 1 and first is None:
                    first = (row["steps"], time.perf_counter() - t_ready)
                if row["promotions"] >= 1 and \
                        row["incumbent_error_pct"] is not None and \
                        row["incumbent_error_pct"] <= 40.0:
                    break
                time.sleep(0.05)
            check(first is not None, f"drift: no promotion in 60 s: {row}")
            stats = client.stats()
            promo = stats["online"]["last_promotion"]["alpha"]
            right = sum(
                int(client.request("alpha", xs[j][None])["pred"][0]
                    == drifted[j]) for j in range(24))
        finally:
            client.close()
    lineage = _promote_lineage(metrics_dir, client.pid, minted)
    wrong_frozen = int(np.sum(frozen[:24] != drifted[:24]))
    check(promo["shadow_error_pct"] <= promo["incumbent_error_pct"]
          - float(DRIFT_ENV["VELES_ONLINE_PROMOTE_MARGIN"]),
          f"drift: the last promotion's round {promo}")
    check(right > 24 - wrong_frozen,
          f"drift: {right} of 24 right after the promotion, the frozen "
          f"ensemble {24 - wrong_frozen}")
    return {"steps_to_first_promotion": first[0],
            "seconds_to_first_promotion": first[1],
            "requests": i, "ready_s": t_ready - t0, "learn": row,
            "last_promotion": promo, "served_right_of_24": right,
            "frozen_right_of_24": 24 - wrong_frozen,
            "minted": len(minted), "lineage": lineage,
            "launches": stats["kernel_launches"]}


def online_phase(card: str, workdir: str) -> dict:
    """Phase 23: the online tier in process (under deterministic cuDNN,
    for the replay), the GA handoff, the ``--online`` hive's latency with
    the learner off and on, and drift learned through the CLI."""
    import torch
    t0 = time.perf_counter()
    pkg = os.path.join(workdir, "alexnet.vpkg")
    from concurrent.futures import ThreadPoolExecutor

    def timed_drift():
        t = time.perf_counter()
        return _online_drift(card, workdir), time.perf_counter() - t

    parts = {}
    # the --online hive comes up while this process runs the learner's
    # parts (the hive is a process of its own); drift's small hive runs
    # beside the timed streams, whose bar is 8x
    with ThreadPoolExecutor(2, thread_name_prefix="online") as pool:
        hive = pool.submit(_start_online_hive, workdir, pkg)
        torch.backends.cudnn.deterministic = True
        try:
            inproc = _online_in_process(card, workdir, pkg)
            parts["in_process"] = time.perf_counter() - t0
            handoff = _online_handoff(card, workdir)
            parts["handoff"] = time.perf_counter() - t0 - sum(parts.values())
        except BaseException:
            try:   # the phase has failed already: close what came up
                client, err, _ = hive.result()
                client.close()
                err.close()
            except Exception:  # noqa: BLE001 — the first failure is raised
                pass
            raise
        finally:
            torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()
        drifting = pool.submit(timed_drift)
        serve = _online_serve(card, hive.result())
        parts["serve"] = time.perf_counter() - t0 - sum(parts.values())
        drift, parts["drift_beside_serve"] = drifting.result()
    out = {"in_process": inproc, "handoff": handoff, "serve": serve,
           "drift": drift, "minutes": (time.perf_counter() - t0) / 60,
           "seconds_by_part": parts, "card": card}
    print(f"online: AlexNet x{N_MEMBERS} bf16, {ONLINE_STEPS} shadow steps "
          f"of {ONLINE_MB} rows: median {inproc['step_ms_median']:.2f} ms "
          f"a step (first {inproc['step_ms'][0]:.1f}), launches "
          f"{inproc['launches']} (2 + 2 a step); replay bitwise "
          f"{inproc['replay_bitwise']}; f32 card vs CPU worst "
          f"{inproc['f32_card_vs_cpu']['worst_rel_delta_diff']:.3g} "
          f"relative (limit {ONLINE_CPU_RTOL}); promoted at shadow "
          f"{inproc['shadow_error_pct']}% / incumbent "
          f"{inproc['incumbent_error_pct']}%, swap "
          f"{inproc['swap_ms']:.3f} ms, time to serve "
          f"{inproc['time_to_serve_ms']} ms, answers bitwise a fresh "
          f"engine's; peak {inproc['peak_memory_bytes']} bytes "
          f"({inproc['base_memory_bytes']} at the start)  [{card}]",
          flush=True)
    print(f"online: GA handoff, AlexNet cohort P=2 -> K=1 (member "
          f"{handoff['adopted']}), adopt {handoff['adopt_ms']:.3f} ms, "
          f"served bitwise, no npz  [{card}]", flush=True)
    print(f"online: hive, learner off p50 {serve['p50_ms_off']:.1f} / p99 "
          f"{serve['p99_ms_off']:.1f} ms, on p50 {serve['p50_ms_on']:.1f} "
          f"/ p99 {serve['p99_ms_on']:.1f} ms (ratio "
          f"{serve['p99_ratio']:.3f}, bound {serve['p99_bound_ms']:.1f} "
          f"ms); {serve['steps']} steps ({serve['steps_in_window']} in the "
          f"window), {serve['gate_rounds']} gate rounds, "
          f"{serve['learn']['promotions']} promotions; launches "
          f"{serve['launches']}  [{card}]", flush=True)
    print(f"online: drift promoted after {drift['steps_to_first_promotion']}"
          f" steps, {drift['seconds_to_first_promotion']:.2f} s: shadow "
          f"{drift['last_promotion']['shadow_error_pct']}% vs incumbent "
          f"{drift['last_promotion']['incumbent_error_pct']}%; served "
          f"{drift['served_right_of_24']} of 24 right, the frozen "
          f"ensemble {drift['frozen_right_of_24']}; promote dump lineage_n "
          f"{drift['lineage']['lineage_n']}, every id one of the "
          f"{drift['minted']} the client minted  [{card}]", flush=True)
    print(f"online: phase {out['minutes']:.2f} minutes, parts "
          f"{out['seconds_by_part']}", flush=True)
    return out


# -- phase 24: the serving fleet -------------------------------------------

#: the AlexNet fleet: replicas, the one-row burst and its client threads,
#: the requests in flight at the SIGKILL, each replica's residency budget
#: (two of them sum to well under the card's 80 GB)
FLEET_REPLICAS = 2
FLEET_REQUESTS, FLEET_THREADS = 48, 4
FLEET_KILL_INFLIGHT = 16
FLEET_HBM_BUDGET = 16 << 30
#: the gray drill on the small model (the reference's tier-1 drill and
#: its acceptance bar: fleet p99 within 1.5x a healthy fleet's on the
#: same closed-loop stream, the ramp discarded)
GRAY_FAULT = "hive.slow_dispatch@label=alpha&times=6&seconds=1.5"
GRAY_P99_FACTOR = 1.5
GRAY_CLIENTS, GRAY_WINDOW_S, GRAY_RAMP_S = 4, 8.0, 2.0
GRAY_KW = dict(deadline_ms=8000, hedge_min_ms=60, hedge_budget=1.0,
               probe_interval=0.2, probe_ok=2, probe_backoff_cap=0.4)
#: the tracing overhead pair on the healthy small fleet (the reference's
#: method and bar, ``bench.py`` trace phase): one request at a time,
#: TRACE_WINDOW_S of requests at trace rate 1 and as many at 0 a pair,
#: TRACE_PAIRS pairs, the median of the per-pair p99 ratios at most
#: TRACE_OVERHEAD_BAR.  A window's p99 (its fifth-slowest of ~530
#: requests on the card) is set by short stalls of the host and the
#: fleet's own periodic work, each holding up a few consecutive requests:
#: one window a side read per-pair ratios of 0.80-1.38 with no change to
#: tracing, and slices of 0.5 s interleaved no steadier.  So the two
#: sides are interleaved request by request, each two consecutive
#: requests one at each rate in a seeded random order, and each side's
#: p99 is taken over its requests of the pair; interleaved so, per-pair
#: ratios still spread 0.75-1.35 on a sound tree, a spread wider than the
#: bar's margin, so the pairs are 11 (more samples, as the method allows;
#: 13 ran a whole run past its time).  A pooled verdict, the p99 of every
#: traced request of the 11 pairs over every untraced one, was tried on
#: the card (NVIDIA H100 80GB HBM3, 700 W) and spread as wide as the
#: median (bootstrap 5-95% widths 0.13-0.17 against 0.14) while reading
#: closer to the bar (1.008-1.048 against 0.988-1.021), so the median
#: stays
TRACE_WINDOW_S = 4.0
TRACE_PAIRS, TRACE_OVERHEAD_BAR = 11, 1.05
#: the open-loop day on the small model (10 s: 20, then 14, ran whole
#: runs past their time)
OPEN_LOOP = dict(duration_s=10.0, peak_rps=150.0, swing=10.0,
                 burst_every_s=6.0, burst_len_s=2.0, burst_mult=2.0,
                 models=["alpha"])


def _card_used() -> int:
    """Bytes in use on the card by every process (``mem_get_info``), this
    process's cached blocks returned first."""
    import torch
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return int(total - free)


def _alexnet_rows(n: int, seed: int) -> list:
    gen = np.random.default_rng(seed)
    return [(gen.integers(0, 256, (1,) + SAMPLE_SHAPE) - 128)
            .astype(np.float32) for _ in range(n)]


def _check_crc(a: dict, n_rows: int, what: str) -> np.ndarray:
    """What a client received: probabilities whose row count and crc
    (the hive's, over its clean payload) check."""
    check("probs" in a, f"{what}: {str(a)[:300]}")
    probs = np.asarray(a["probs"], np.float32)
    check(len(probs) == n_rows == a["rows_n"]
          and zlib.crc32(probs.tobytes()) == a["crc"],
          f"{what}: rows_n/crc do not check")
    return probs


def _burst(router, model: str, rows: list, threads: int,
           timeout: float = 300.0) -> tuple:
    """Every row set as one request through ``router`` from ``threads``
    client threads; (answers by index, ms by index)."""
    answers, lat, errors = {}, {}, []

    def worker(ids):
        try:
            for i in ids:
                t0 = time.perf_counter()
                answers[i] = router.request(model, rows[i],
                                            timeout=timeout)
                lat[i] = 1e3 * (time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    ts = [threading.Thread(target=worker,
                           args=(range(t, len(rows), threads),))
          for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(900)
    check(not errors and len(answers) == len(rows),
          f"fleet: requests failed: {errors[:3]}")
    return answers, lat


#: a fresh or respawned replica's first answer, after its warm-up
FIRST_ANSWER_BAR_S = 2.0


def _snapshot(d: str, pid: int) -> dict:
    with open(os.path.join(d, f"metrics-{pid}.json")) as f:
        return json.load(f)


def _wait_flushed(d: str, pid: int, requests: int,
                  timeout: float = 30.0) -> dict:
    """The replica's periodic flush (a heartbeat, then at most
    ``telemetry.FLUSH_EVERY`` s) reaches ``requests`` on disk."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            snap = _snapshot(d, pid)
        except (OSError, ValueError):
            snap = {"counters": {}}
        if snap["counters"].get("serve.requests", 0) >= requests:
            return snap
        check(time.monotonic() < deadline,
              f"fleet: {d} pid {pid} flushed "
              f"{snap['counters'].get('serve.requests', 0)} requests, "
              f"want {requests}")
        time.sleep(0.2)


def _fleet_metrics(metrics_dir: str, pids: list, expect: dict,
                   killed: tuple, routed_fleet: dict) -> dict:
    """After shutdown: each replica dir holds a snapshot for every pid
    that lived there, the killed one's from before the kill; each pid's
    ``serve.requests`` is what the phase sent that pid (routed, and its
    own direct requests: ``expect[pid]``, a (low, high) range only for
    the killed pid, whose requests in flight at the kill came after its
    last flush at most); each cleanly shut-down pid's journal holds
    ``serve.ready`` and ends with ``serve.shutdown``; the router's
    snapshot holds its ``fleet.*`` counters as they stood at shutdown."""
    from veles_tpu_torch import events, telemetry
    kill_pid, kill_wall = killed
    per_replica = []
    for i, replica_pids in enumerate(pids):
        d = os.path.join(metrics_dir, f"replica-{i}")
        have = sorted(int(f[len("metrics-"):-len(".json")])
                      for f in os.listdir(d)
                      if f.startswith("metrics-") and f.endswith(".json"))
        check(have == sorted(replica_pids),
              f"fleet: {d} holds snapshots of {have}, want "
              f"{sorted(replica_pids)}")
        counts = {}
        for pid in replica_pids:
            snap = _snapshot(d, pid)
            counts[pid] = snap["counters"].get("serve.requests", 0)
            lo, hi = expect[pid]
            check(lo <= counts[pid] <= hi,
                  f"fleet: pid {pid} counted {counts[pid]} requests, the "
                  f"phase sent it {lo}-{hi}")
            if pid == kill_pid:
                check(snap["ts"] < kill_wall,
                      f"fleet: the killed pid's snapshot is from "
                      f"{snap['ts']}, the kill at {kill_wall}")
                continue
            evs = [e["event"] for e in _read_journal(
                os.path.join(d, f"journal-{pid}.jsonl"))]
            check(events.EV_SERVE_READY in evs and
                  evs[-1] == events.EV_SERVE_SHUTDOWN,
                  f"fleet: pid {pid}'s journal {evs}")
        per_replica.append({"pids": replica_pids, "requests": counts,
                            "sent": [expect[p] for p in replica_pids]})
    router = _snapshot(metrics_dir, os.getpid())
    on_disk = {k: v for k, v in router["counters"].items()
               if k.startswith("fleet.")}
    check(on_disk == routed_fleet,
          f"fleet: the router's snapshot {on_disk} against its counters "
          f"at shutdown {routed_fleet}")
    telemetry.configure(None)
    return {"replicas": per_replica,
            "router_fleet_counters": len(on_disk)}


def _fleet_view(router, metrics_dir: str, per_dispatch: int) -> dict:
    """The operator's fleet view of the live fleet, through the port's
    report CLI (``python -m veles_tpu_torch.tools.obs_report DIR --fleet
    --json``, a process of its own): one row a replica, its pid the live
    one, its requests the replica's own ``op=stats`` count (each replica's
    periodic flush awaited first), and every replica's ``lrn_fwd`` launches
    ``per_dispatch`` a dispatch over its life (the warm-up counted apart,
    the learner rung engaged).  The rendered table is printed."""
    from veles_tpu_torch import obs
    st = [r.client.stats() for r in router.replicas]
    for r, s in zip(router.replicas, st):
        _wait_flushed(os.path.join(metrics_dir, f"replica-{r.idx}"), r.pid,
                      s["requests"])
        n = s["kernel_launches"]["lrn_fwd"]
        check(n == per_dispatch * s["dispatches"],
              f"fleet view: replica {r.idx} launched lrn_fwd {n} times in "
              f"{s['dispatches']} dispatches, want {per_dispatch} a dispatch")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.tools.obs_report",
         metrics_dir, "--fleet", "--json"], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=120)
    cli_s = time.perf_counter() - t0
    check(p.returncode == 0, f"fleet view: obs_report rc {p.returncode}: "
          f"{p.stderr[-2000:]}")
    rows = json.loads(p.stdout.strip().splitlines()[-1])["fleet"]["replicas"]
    want = [(r.idx, r.pid, s["requests"])
            for r, s in zip(router.replicas, st)]
    got = [(r["replica"], r["pid"], r["requests"]) for r in rows]
    check(got == want, f"fleet view: rows (replica, pid, requests) {got}, "
          f"the live fleet's {want}")
    for line in obs.render_fleet(metrics_dir).splitlines():
        print(f"fleet view: {line}", flush=True)
    return {"rows": [{k: r[k] for k in ("replica", "pid", "requests", "qps",
                                         "p99_ms", "state")} for r in rows],
            "dispatches": [s["dispatches"] for s in st],
            "lrn_fwd": [s["kernel_launches"]["lrn_fwd"] for s in st],
            "cli_s": cli_s}


#: the four components a whole request's critical path splits into
TRACE_PARTS = ("pre_route_s", "wire_s", "batch_wait_s", "dispatch_s")


def _trace_ids(t0: float, t1: float) -> list:
    """Trace ids of the requests this process's router answered between
    the monotonic times ``t0`` and ``t1`` (its ``trace.request`` events
    in the in-memory ring)."""
    from veles_tpu_torch import events, telemetry
    return [e["trace"] for e in telemetry.recent_events(
        events.EV_TRACE_REQUEST) if t0 <= e["mono"] <= t1]


def _trace_gaps(tevs: list, tid: str) -> list:
    """What a request's assembled trace lacks: its ``trace.request``, a
    ``trace.leg``, a ``trace.serve``, a ``trace.batch`` that links it,
    events from two processes, a critical-path component.  Empty when
    the trace is whole."""
    from veles_tpu_torch import obs
    names = {e.get("event") for e in tevs}
    gaps = [n for n in ("trace.request", "trace.leg", "trace.serve")
            if n not in names]
    if not any(e.get("event") == "trace.batch" and tid in
               [lk.get("trace") for lk in e.get("links") or ()]
               for e in tevs):
        gaps.append("trace.batch")
    if len({e.get("_pid") for e in tevs}) < 2:
        gaps.append("two pids")
    cp = obs.critical_path(tevs) if tevs else {}
    return gaps + [k for k in TRACE_PARTS if cp.get(k) is None]


def _wait_traced(metrics_dir: str, tids: list,
                 timeout: float = 30.0) -> None:
    """Poll the fleet's merged journals until every trace of ``tids`` is
    whole: a replica's ``trace.*`` lines reach its file with its periodic
    flush (at most a heartbeat and ``telemetry.FLUSH_EVERY`` after)."""
    from veles_tpu_torch import obs, telemetry
    deadline = time.monotonic() + timeout
    while True:
        telemetry.flush()
        traces = obs.assemble_traces(obs.load_tree(metrics_dir)[1])
        gaps = {t: _trace_gaps(traces.get(t, []), t) for t in tids}
        missing = {t: g for t, g in gaps.items() if g}
        if not missing:
            return
        check(time.monotonic() < deadline,
              f"fleet: {len(missing)} of {len(tids)} traces incomplete "
              f"after {timeout} s, e.g. {list(missing.items())[:2]}")
        time.sleep(0.5)


def _sigterm_dumps(metrics_dir: str) -> dict:
    """Each replica pid whose journal ends its serving on a SIGTERM (a
    retired replica) left ``flightrec-<pid>-<n>-sigterm.json`` beside
    it."""
    import glob

    from veles_tpu_torch import obs
    pids = []
    for _idx, d in obs.fleet_replica_dirs(metrics_dir):
        _reg, _snaps, _journals, evs = obs.load_dir(d)
        for pid in sorted({e["_pid"] for e in evs}):
            downs = [e for e in evs if e["_pid"] == pid
                     and e["event"] == "serve.shutdown"]
            if downs and downs[-1].get("reason") == "SIGTERM":
                pids.append(pid)
                check(glob.glob(os.path.join(
                    d, f"flightrec-{pid}-*-sigterm.json")),
                      f"fleet: pid {pid} ended on a SIGTERM and left no "
                      f"sigterm dump in {d}")
    return {"sigterm_pids": len(pids)}


def _fleet_traces(metrics_dir: str, healthy: list, failover: list,
                  retried: int) -> dict:
    """After shutdown, the fleet's journals merged with the port's reader
    (``veles_tpu_torch/obs.py``): every request of the healthy burst a
    whole trace (:func:`_trace_gaps`) and its critical path's medians
    and maxima in ms; in the failover window, each retried request's
    trace holds its died leg and its winning leg on two replicas under
    one trace id; the router's ``fleet.request_seconds`` exemplars name
    traces that assemble; the SIGTERM dumps."""
    from veles_tpu_torch import obs
    reg, merged = obs.load_tree(metrics_dir)
    traces = obs.assemble_traces(merged)
    gaps = {t: _trace_gaps(traces.get(t, []), t) for t in healthy}
    bad = {t: g for t, g in gaps.items() if g}
    check(len(healthy) == FLEET_REQUESTS and not bad,
          f"fleet: {len(bad)} of {len(healthy)} healthy traces incomplete "
          f"after shutdown, e.g. {list(bad.items())[:2]}")
    cps = [obs.critical_path(traces[t]) for t in healthy]
    split = {}
    for k in TRACE_PARTS + ("total_s",):
        ms = [1e3 * cp[k] for cp in cps]
        split[k[:-2] + "_ms"] = {"median": float(np.median(ms)),
                                 "max": float(np.max(ms))}
    # a retried request: two routed attempts (legs that are not hedge
    # copies), the first died
    again = []
    for t in failover:
        legs = [e for e in traces.get(t, [])
                if e.get("event") == "trace.leg"]
        if sum(not e["hedge"] for e in legs) >= 2:
            again.append(legs)
    check(len(failover) == FLEET_KILL_INFLIGHT and len(again) == retried
          and all(len({e["replica"] for e in legs}) == 2
                  and any(e["verdict"] == "died" for e in legs)
                  and sum(bool(e["winner"]) for e in legs) == 1
                  for legs in again),
          f"fleet: {len(again)} failover traces with two attempts, "
          f"{retried} retried: "
          f"{[[(e['replica'], e['verdict']) for e in lg] for lg in again]}")
    ex = obs.tail_exemplars(reg, "fleet.request_seconds")
    named = [t for _e, t in ex if not _trace_gaps(traces.get(t, []), t)
             or t in failover]
    check(ex and named, f"fleet: tail exemplars {ex} name no trace that "
          f"assembles")
    return {"healthy_whole": len(healthy) - len(bad),
            "healthy": len(healthy),
            "pids": len({e.get("_pid") for e in merged}),
            "critical_path": split, "failover_retried": len(again),
            "tail_exemplars": len(ex), "tail_assembled": len(named),
            "sigterm": _sigterm_dumps(metrics_dir),
            "assembled": len(traces)}



def _fleet_alexnet(card: str, workdir: str, pkg: str) -> dict:
    """Steps 1-3: full-width AlexNet from 2 replicas on the card, with a
    metrics dir: spawn (each replica warms up before its hello), the
    first answers, the burst against an in-process engine with the
    launches read from each replica's stats, the SIGKILL failover with
    its respawn, the learner rung, and the dirs after shutdown."""
    from veles_tpu_torch import events, telemetry
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    from veles_tpu_torch.ops.lrn import LRNormalizer
    from veles_tpu_torch.serve.hive import load_model_package
    from veles_tpu_torch.serve.router import FleetRouter

    # this process is the fleet's router: its registry holds the router's
    # metrics alone, as a deployed router's does (see _fleet_small)
    telemetry.reset()
    used0 = _card_used()
    err = open(os.path.join(workdir, "fleet_alexnet.stderr"), "w")
    metrics_dir = os.path.join(workdir, "fleet_metrics")
    t0 = time.perf_counter()
    router = FleetRouter(
        {"alexnet": pkg}, FLEET_REPLICAS, backend="cuda",
        max_batch=MAX_BATCH, max_wait_ms=20, hbm_budget=FLEET_HBM_BUDGET,
        heartbeat_every=1.0, cwd=HERE, stderr=err, start_timeout=600,
        env=dict(ONLINE_ENV, VELES_ONLINE="1"), metrics_dir=metrics_dir)
    #: the requests the phase sent each replica directly
    direct = [0] * FLEET_REPLICAS
    try:
        up_s = time.perf_counter() - t0
        spawn_s = [r.spawn_seconds for r in router.replicas]
        pids = [[r.pid] for r in router.replicas]
        check(router.placement == {"alexnet": [0, 1]}
              and all(r.client.hello["online"] and r.capacity_bytes
                      == FLEET_HBM_BUDGET for r in router.replicas),
              f"fleet: placement {router.placement}, hellos "
              f"{[r.client.hello for r in router.replicas]}")
        # the learner rung engaged before any traffic: the shadow steps
        # stay out of step 1's counts
        router.apply_degradation("learner", True, cause="step 1")
        st = [r.client.stats() for r in router.replicas]
        check(all(s["online"]["suspended"] for s in st)
              and all(s["kernel_launches"] == {"lrn_fwd": 0, "lrn_bwd": 0}
                      for s in st),
              f"fleet: not suspended or counts not zero: "
              f"{[(s['online'], s['kernel_launches']) for s in st]}")
        # each replica's first answer, side by side: its first dispatch
        # (cuDNN's first use) in a fresh process
        warm = _alexnet_rows(1, SEED + 300)[0]
        first_s = [None] * FLEET_REPLICAS

        def first(r):
            ts = time.perf_counter()
            a = r.client.request("alexnet", warm, timeout=600)
            first_s[r.idx] = (time.perf_counter() - ts, a)
            direct[r.idx] += 1

        ts = [threading.Thread(target=first, args=(r,))
              for r in router.replicas]
        for t in ts:
            t.start()
        for t in ts:
            t.join(900)
        for r in router.replicas:
            check(first_s[r.idx] is not None,
                  f"fleet: replica {r.idx} gave no first answer")
            _check_crc(first_s[r.idx][1], 1,
                       f"fleet: replica {r.idx} first answer")
        first_s = [f[0] for f in first_s]
        st0 = [r.client.stats() for r in router.replicas]
        routed0 = router.routed_counts()
        hedges0 = telemetry.counter(events.CTR_FLEET_HEDGES).value
        rows = _alexnet_rows(FLEET_REQUESTS, SEED + 301)
        t_burst = time.perf_counter()
        m_burst = time.monotonic()
        answers, lat = _burst(router, "alexnet", rows, FLEET_THREADS)
        burst_s = time.perf_counter() - t_burst
        healthy_tids = _trace_ids(m_burst, time.monotonic())
        st1 = [r.client.stats() for r in router.replicas]
        routed = [b - a for a, b in zip(routed0, router.routed_counts())]
        hedges = telemetry.counter(events.CTR_FLEET_HEDGES).value - hedges0
        threshold_ms = router.sentinel.hedge_threshold_ms("alexnet")
        used_peak = _card_used()
        check(all(n >= FLEET_REQUESTS // 4 for n in routed),
              f"fleet: requests routed {routed}, want at least a quarter "
              f"each")
        # the in-process engine on the same package, same dtype
        device = make_device("cuda")
        model = load_model_package("alexnet", pkg, device,
                                   os.path.join(workdir, "fleet_local"),
                                   dict(root.__dict__))
        n_norm = sum(isinstance(f, LRNormalizer) for f in model.forwards)
        dispatches, launches = [], []
        for i, (a, b) in enumerate(zip(st0, st1)):
            d = b["dispatches"] - a["dispatches"]
            n = b["kernel_launches"]["lrn_fwd"] - \
                a["kernel_launches"]["lrn_fwd"]
            check(d > 0 and n == n_norm * N_MEMBERS * d and
                  b["kernel_launches"]["lrn_bwd"] == 0,
                  f"fleet: replica {i} launched lrn_fwd {n} times in {d} "
                  f"dispatches (want {n_norm * N_MEMBERS} a dispatch), "
                  f"lrn_bwd {b['kernel_launches']['lrn_bwd']}")
            dispatches.append(d)
            launches.append(n)
        engine = EnsembleEvalEngine(model.forwards, model.member_params,
                                    device)
        worst = {"max_abs_err": 0.0, "max_logp_err": 0.0}
        for i, r in enumerate(rows):
            got = _check_crc(answers[i], 1, f"fleet: request {i}")
            xb = np.zeros((MAX_BATCH,) + SAMPLE_SHAPE, np.float32)
            xb[:1] = r
            res = agree(got, engine.predict_proba(xb)[:1], 1e-3, 0.0,
                        0.05, f"fleet: request {i} vs in-process engine")
            for key in worst:
                worst[key] = max(worst[key], res[key])
        engine.release()
        del model, engine
        gauges = [s["gauges"].get("serve.first_dispatch_seconds")
                  for s in st1]
        warmups = [s["warmup"] for s in st0]
        check(all(w["dispatches"] == 1 and w["kernel_launches"] ==
                  {"lrn_fwd": n_norm * N_MEMBERS} for w in warmups),
              f"fleet: warm-ups {warmups}")
        check(all(f < FIRST_ANSWER_BAR_S for f in first_s),
              f"fleet: first answers {first_s} s after the warm-up, bar "
              f"{FIRST_ANSWER_BAR_S} s")
        view = _fleet_view(router, metrics_dir, n_norm * N_MEMBERS)

        # the victim's snapshot on disk holds every request sent so far
        # (its heartbeat's periodic flush) before the kill
        pre_kill = router.routed_counts()[1] + direct[1]
        _wait_flushed(os.path.join(metrics_dir, "replica-1"),
                      router.replicas[1].pid, pre_kill)
        # and its trace lines of the burst: a SIGKILL loses a buffer
        _wait_traced(metrics_dir, healthy_tids)

        # step 2: SIGKILL replica 1 with FLEET_KILL_INFLIGHT in flight
        retries0 = telemetry.counter(events.CTR_FLEET_RETRIES).value
        deaths0 = router.replicas[1].deaths
        pid1 = router.replicas[1].pid
        kill_rows = _alexnet_rows(FLEET_KILL_INFLIGHT, SEED + 302)
        got, errs = {}, []

        def one(i):
            try:
                got[i] = router.request("alexnet", kill_rows[i],
                                        timeout=300)
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(e)

        ts = [threading.Thread(target=one, args=(i,))
              for i in range(FLEET_KILL_INFLIGHT)]
        m_failover = time.monotonic()
        for t in ts:
            t.start()
        deadline = time.monotonic() + 60
        while router.replicas[1].inflight < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        on_victim = router.replicas[1].inflight
        t_kill = time.monotonic()
        router.replicas[1].client.proc.kill()
        # the wall clock once the signal is sent: ``Popen.kill`` polls
        # the child first and may lose the GIL to this phase's request
        # threads for tens of ms, in which the victim can still flush
        kill_wall = time.time()
        for t in ts:
            t.join(600)
        check(not errs and len(got) == FLEET_KILL_INFLIGHT,
              f"fleet: failover requests raised {errs[:3]}")
        failover_tids = _trace_ids(m_failover, time.monotonic())
        for i in range(FLEET_KILL_INFLIGHT):
            _check_crc(got[i], 1, f"fleet: failover request {i}")
        retried = telemetry.counter(events.CTR_FLEET_RETRIES).value - retries0
        check(on_victim >= 1 and 1 <= retried <= FLEET_KILL_INFLIGHT,
              f"fleet: {on_victim} in flight on the victim, {retried} "
              f"retried")
        deadline = time.monotonic() + 60
        while router.replicas[1].deaths == deaths0:
            check(time.monotonic() < deadline,
                  "fleet: the monitor saw no death")
            time.sleep(0.02)
        # the corpse reaped, the respawn not yet past its CUDA set-up
        used_killed = _card_used()
        deadline = time.monotonic() + 300
        while not (router.replicas[1].healthy
                   and router.replicas[1].pid != pid1):
            check(time.monotonic() < deadline,
                  "fleet: replica 1 was not respawned")
            time.sleep(0.1)
        respawn_s = time.monotonic() - t_kill
        check(router.replicas[1].deaths == deaths0 + 1,
              f"fleet: deaths {router.replicas[1].deaths}")
        pids[1].append(router.replicas[1].pid)
        # what replica 1 was sent before its respawn, and after
        at_respawn = [router.routed_counts()[1], direct[1]]
        ts0 = time.perf_counter()
        _check_crc(router.replicas[1].client.request(
            "alexnet", warm, timeout=600), 1,
            "fleet: the respawned replica's first answer")
        respawn_first_s = time.perf_counter() - ts0
        direct[1] += 1
        check(respawn_first_s < FIRST_ANSWER_BAR_S,
              f"fleet: the respawned replica's first answer took "
              f"{respawn_first_s:.2f} s, bar {FIRST_ANSWER_BAR_S} s")
        used_respawn = _card_used()

        # step 3: the learner rung on labeled traffic
        router.apply_degradation("learner", True, cause="step 3")
        stream = labeled_stream()[:8]
        lerrs = []

        def feed(r):
            try:
                for rows_l, labels in stream:
                    _check_crc(r.client.request(
                        "alexnet", rows_l, timeout=300, label=labels),
                        len(rows_l), f"fleet: labeled request to replica "
                        f"{r.idx}")
                    direct[r.idx] += 1
            except Exception as e:  # noqa: BLE001 — reported below
                lerrs.append(e)

        ts = [threading.Thread(target=feed, args=(r,))
              for r in router.replicas]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        check(not lerrs, f"fleet: labeled requests failed: {lerrs[:2]}")
        time.sleep(1.0)
        st_s = [r.client.stats() for r in router.replicas]
        check(all(s["online"]["suspended"] and s["online"]["steps"] == 0
                  for s in st_s),
              f"fleet: learner rung engaged, yet "
              f"{[s['online'] for s in st_s]}")
        bwd0 = [s["kernel_launches"]["lrn_bwd"] for s in st_s]
        router.apply_degradation("learner", False, cause="step 3")
        deadline = time.monotonic() + 120
        while True:
            st_r = [r.client.stats() for r in router.replicas]
            steps = [s["online"]["steps"] for s in st_r]
            if any(steps):
                break
            check(time.monotonic() < deadline,
                  "fleet: no shadow step after the rung was released")
            time.sleep(0.5)
        time.sleep(1.0)
        # the counts are read with the learners at rest: a step under way
        # has launched its kernels before it counts itself
        router.apply_degradation("learner", True, cause="step 3 count")
        time.sleep(1.0)
        st_r = [r.client.stats() for r in router.replicas]
        steps = [s["online"]["steps"] for s in st_r]
        grown = [s["kernel_launches"]["lrn_bwd"] - b
                 for s, b in zip(st_r, bwd0)]
        # a shadow step launches lrn_bwd once a norm layer, the members
        # folded into the rows
        check(grown == [n_norm * k for k in steps] and
              (n_norm == 0 or sum(grown) > 0),
              f"fleet: lrn_bwd grew {grown} in {steps} steps")
        router.apply_degradation("learner", False, cause="step 3 count")
        st_l = [r.client.stats() for r in router.replicas]
        check(not any(s["online"]["suspended"] for s in st_l),
              f"fleet: still suspended {[s['online'] for s in st_l]}")
        routed_final = router.routed_counts()
        # a probe of an ejected replica reaches it outside the routing
        probes = telemetry.counter(events.CTR_FLEET_PROBES).value
    finally:
        router.close()
        err.close()
    routed_fleet = {k: v for k, v in telemetry.snapshot()["counters"].items()
                    if k.startswith("fleet.")}
    sent0 = routed_final[0] + direct[0]
    sent_respawn = routed_final[1] - at_respawn[0] + direct[1] - \
        at_respawn[1]
    expect = {pids[0][0]: (sent0, sent0 + probes),
              pid1: (pre_kill, pre_kill + FLEET_KILL_INFLIGHT),
              pids[1][1]: (sent_respawn, sent_respawn + probes)}
    traces = _fleet_traces(metrics_dir, healthy_tids, failover_tids,
                           retried)
    metrics = _fleet_metrics(metrics_dir, pids, expect, (pid1, kill_wall),
                             routed_fleet)
    lat_ms = sorted(lat.values())
    return {
        "up_s": up_s, "spawn_to_hello_s": spawn_s,
        "first_answer_s": first_s,
        "first_dispatch_gauge_s": gauges, "warmup": warmups,
        "metrics": metrics, "traces": traces, "fleet_view": view,
        "requests": FLEET_REQUESTS, "threads": FLEET_THREADS,
        "burst_s": burst_s, "routed": routed, "dispatches": dispatches,
        "lrn_fwd_launches": launches,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "hedges": hedges, "hedge_threshold_ms": threshold_ms,
        "vs_engine_bf16": worst,
        "failover": {"inflight": FLEET_KILL_INFLIGHT,
                     "on_victim": on_victim, "retried": retried,
                     "respawn_s": respawn_s,
                     "respawn_spawn_to_hello_s":
                     router.replicas[1].spawn_seconds,
                     "respawn_first_answer_s": respawn_first_s},
        "card_used_bytes": {"before": used0, "peak": used_peak,
                            "after_kill": used_killed,
                            "after_respawn": used_respawn},
        "learner": {"lrn_bwd_grown": grown,
                    "steps": [s["online"]["steps"] for s in st_r]},
        "launches": {"lrn_fwd": sum(launches), "lrn_bwd": sum(grown)},
        "card": card}


def _small_fleet(pkg: str, workdir: str, tag: str, **kw):
    from veles_tpu_torch.serve.router import FleetRouter
    err = open(os.path.join(workdir, f"fleet_{tag}.stderr"), "w")
    try:
        return FleetRouter({"alpha": pkg}, 2, backend="cuda",
                           max_batch=16, max_wait_ms=5, cwd=HERE,
                           stderr=err, start_timeout=300, **kw), err
    except BaseException:
        err.close()
        raise


def _closed_loop(routers: list, engine, clients: int, window_s: float,
                 ramp_s: float, seed: int) -> list:
    """``clients`` closed-loop threads of one-row requests on EACH of
    ``routers`` at once, for ramp_s + window_s seconds: every router gets
    the same rows (the same seeds) at the same time, so a comparison of
    their latencies sees the same host.  The threads only send (the
    reference bench's closed loop); then every answer is checked, its crc
    and its probabilities against ``engine`` (the same model in process
    on the card) within 1e-3.  Per router: latencies after the ramp."""
    sent = [[] for _ in routers]
    lock = threading.Lock()
    t0 = time.monotonic()
    stop_at = t0 + ramp_s + window_s

    def loop(k, i):
        gen = np.random.default_rng(seed + i)
        mine = []
        while time.monotonic() < stop_at:
            x = gen.standard_normal((1, 6, 6, 1)).astype(np.float32)
            ts = time.monotonic()
            a = routers[k].request("alpha", x, timeout=30)
            mine.append((x, a, 1e3 * (time.monotonic() - ts),
                         ts - t0 >= ramp_s))
        with lock:
            sent[k].extend(mine)

    ts = [threading.Thread(target=loop, args=(k, i))
          for k in range(len(routers)) for i in range(clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    check(not any(t.is_alive() for t in ts), "fleet: a client hung")
    out = []
    for rows in sent:
        got = np.concatenate([_check_crc(a, 1, "fleet: small-model answer")
                              for _, a, _, _ in rows])
        xs = np.concatenate([x for x, _, _, _ in rows])
        for k in range(0, len(xs), 16):
            xb = np.zeros((16, 6, 6, 1), np.float32)
            xb[:len(xs[k:k + 16])] = xs[k:k + 16]
            want = engine.predict_proba(xb)[:len(xs[k:k + 16])]
            err = float(np.abs(got[k:k + 16] - want).max())
            check(err <= 1e-3, f"fleet: answers {k}-{k + 15} differ from "
                  f"the in-process engine's by {err:.3g}")
        lat = [dt for _, _, dt, measured in rows if measured]
        out.append({"n": len(lat), "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99))})
    return out


def _open_loop_day(router) -> dict:
    """An OPEN_LOOP day (``traffic.generate``) through ``OpenLoopDriver``
    under ``FleetAutoscaler`` over 1-3 replicas (the reference's thresholds):
    one outcome per arrival, no error; the replica count and pressure
    every 0.5 s, and every action with its cause."""
    from veles_tpu_torch.serve.autoscale import (FleetAutoscaler,
                                                 ScaleController)
    from veles_tpu_torch.serve.traffic import (OpenLoopDriver, TrafficSpec,
                                               generate)
    from veles_tpu_torch.tools.gauntlet import accountability_check

    arrivals = generate(TrafficSpec(seed=SEED, **OPEN_LOOP))
    ctl = ScaleController(min_replicas=1, max_replicas=3)
    scaler = FleetAutoscaler(router, controller=ctl)
    counts, stop = [], threading.Event()
    t_day = time.monotonic()

    def sample():
        while not stop.wait(0.5):
            counts.append((round(time.monotonic() - t_day, 2),
                           scaler.n_live(),
                           round(min(scaler.pressure_ms(), 1e9), 2)))

    def fire(a):
        x = np.random.default_rng(a.row_seed).standard_normal(
            (1, 6, 6, 1)).astype(np.float32)
        resp = router.request(a.model, x, timeout=30)
        if "probs" in resp:
            _check_crc(resp, 1, f"open loop arrival {a.i}")
        return resp

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    scaler.start()
    try:
        results = OpenLoopDriver(fire, workers=32).run(arrivals)
    finally:
        scaler.close()
        stop.set()
        sampler.join(5)
    check([r["i"] for r in results] == list(range(len(arrivals))),
          "open loop: not one outcome per arrival")
    statuses = [r["status"] for r in results]
    errors = [r["response"] for r in results if r["status"] == "error"]
    check(not errors, f"open loop: {len(errors)} errors, first "
          f"{errors[:3]}")
    # the day's books, balanced over the outcomes and the merged journals
    # of the router's dir (the gray fleet's too: one router process)
    acct = accountability_check(router.metrics_dir, [], arrivals, results)
    check(acct["accounted"] and acct["crc_checked"] ==
          statuses.count("ok"), f"open loop: the books do not balance: "
          f"{acct['unexplained'][:4]}")
    lat = [1e3 * r["latency_s"] for r in results if r["status"] == "ok"]
    return {"arrivals": len(arrivals), "ok": statuses.count("ok"),
            "accountability": {k: acct[k] for k in (
                "explained", "accounted", "lost", "errors", "crc_checked",
                "corrupt")},
            "shed": statuses.count("shed"), "errors": len(errors),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "replicas_over_time": counts, "actions": scaler.journal,
            "controller": {k: getattr(ctl, k) for k in (
                "min_replicas", "max_replicas", "up_ms", "down_ms",
                "up_sustain_s", "down_sustain_s", "cooldown_s")}}


def _trace_overhead(router) -> dict:
    """The reference's overhead pair on ``router`` alone on the card: one
    request at a time, a burn-in of TRACE_WINDOW_S at
    ``$VELES_TRACE_SAMPLE`` 0, then TRACE_PAIRS pairs of 2 x
    TRACE_WINDOW_S, their requests at rate 1 and 0 interleaved; the
    median of the per-pair p99 ratios within TRACE_OVERHEAD_BAR."""
    from veles_tpu_torch import knobs
    gen = np.random.default_rng(SEED + 600)
    row = gen.standard_normal((1, 6, 6, 1)).astype(np.float32)
    prev = os.environ.get(knobs.TRACE_SAMPLE)

    def one(rate) -> float:
        os.environ[knobs.TRACE_SAMPLE] = str(rate)
        t0 = time.perf_counter()
        a = router.request("alpha", row, timeout=30)
        dt = time.perf_counter() - t0
        check("probs" in a, f"trace overhead: {a}")
        return dt

    try:
        for _ in range(16):
            check("probs" in router.request("alpha", row, timeout=30),
                  "trace overhead: a warm request failed")
        t_end = time.perf_counter() + TRACE_WINDOW_S
        while time.perf_counter() < t_end:
            one(0)
        pairs, p50s = [], []
        for _ in range(TRACE_PAIRS):
            lats = {1: [], 0: []}
            t_end = time.perf_counter() + 2 * TRACE_WINDOW_S
            while time.perf_counter() < t_end:
                for rate in gen.permutation([1, 0]):
                    lats[int(rate)].append(one(rate))
            pairs.append((1e3 * float(np.percentile(lats[1], 99)),
                          1e3 * float(np.percentile(lats[0], 99)),
                          len(lats[1]), len(lats[0])))
            p50s.append((1e3 * float(np.median(lats[1])),
                         1e3 * float(np.median(lats[0]))))
    finally:
        if prev is None:
            os.environ.pop(knobs.TRACE_SAMPLE, None)
        else:
            os.environ[knobs.TRACE_SAMPLE] = prev
    ratio = float(np.median([p1 / p0 for p1, p0, _, _ in pairs]))
    check(ratio <= TRACE_OVERHEAD_BAR,
          f"trace overhead: p99 ratio on/off {ratio:.3f} over "
          f"{TRACE_OVERHEAD_BAR}: {pairs}")
    return {"p99_ratio": ratio, "pairs": pairs, "p50_ms": p50s,
            "window_s": TRACE_WINDOW_S, "interleave": "request"}


def _ejection_dump(metrics_dir: str, replica: int) -> dict:
    """This process's router left ``flightrec-<pid>-<n>-ejection.json``
    whose ring holds a ``sentinel.eject`` entry for ``replica``."""
    import glob
    dumps = sorted(glob.glob(os.path.join(
        metrics_dir, f"flightrec-{os.getpid()}-*-ejection.json")))
    hits = []
    for path in dumps:
        with open(path) as f:
            ring = json.load(f)["ring"]
        hits += [e for e in ring if e.get("ev") == "sentinel.eject"
                 and e.get("replica") == replica]
    check(hits, f"gray: no ejection dump with replica {replica}'s "
          f"sentinel.eject among {[os.path.basename(p) for p in dumps]}")
    return {"dumps": len(dumps), "entries": len(hits)}


def _witnessed(metrics_dir: str, pids: list) -> dict:
    """Each witnessed replica pid left ``lockwitness-<pid>.json``; the
    union of their edges has no cycle, every lock name in it is one the
    port declares (``witness.LOCK_NAMES``), and every edge is one the
    port's locking law declares
    (``veles_tpu_torch/analysis/lock_order.json``, which the port's
    veleslint derives from its source)."""
    from veles_tpu_torch import obs
    from veles_tpu_torch.analysis import flow, witness
    have = {f for _i, d in obs.fleet_replica_dirs(metrics_dir)
            for f in os.listdir(d) if f.startswith("lockwitness-")}
    check({f"lockwitness-{p}.json" for p in pids} <= have,
          f"witness: snapshots {sorted(have)}, replica pids {pids}")
    edges = witness.read_snapshots(metrics_dir)
    graph = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    state = {}

    def cyclic(n) -> bool:
        state[n] = 1
        for m in graph.get(n, ()):
            if state.get(m) == 1 or (m not in state and cyclic(m)):
                return True
        state[n] = 2
        return False

    names = {n for e in edges for n in e}
    check(edges and not any(n not in state and cyclic(n)
                            for n in list(graph)),
          f"witness: the edges {edges} hold a cycle (or none was seen)")
    check(names <= witness.LOCK_NAMES,
          f"witness: undeclared lock names {names - witness.LOCK_NAMES}")
    law = flow.declared_edges(flow.load_lock_order(flow.LAW_PATH))
    check(set(edges) <= law, f"witness: edges outside the port's law "
          f"{sorted(set(edges) - law)}")
    return {"snapshots": len(have), "edges": edges,
            "law_edges": len(law)}


def _fleet_small(card: str, workdir: str) -> dict:
    """Steps 4 and 5 on the tier-1 fleet model: a healthy fleet and one
    whose replica 0 dispatches slowly, driven side by side by the same
    closed-loop stream (p99 against p99), the slow one until its replica
    is reinstated; the open-loop day on the healthy fleet; the garbage
    drill."""
    from concurrent.futures import ThreadPoolExecutor

    from veles_tpu_torch import telemetry
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    from veles_tpu_torch.serve.hive import load_model_package

    sub = os.path.join(workdir, "fleet_small")
    os.makedirs(sub, exist_ok=True)
    # the small fleets' router is this process, whose registry holds every
    # earlier phase's metrics: each throttled flush (at most every 5 s, set
    # off by an event, so by the traced requests and not the untraced
    # ones) would write them all, holding the GIL longer than the serving
    # thread's tail, and charge that to tracing in the overhead pair.  A
    # deployed router's registry holds the router's own metrics: so does
    # this one's from here on
    telemetry.reset()
    #: the healthy and the gray fleet's (one router process: one dir)
    small_dir = os.path.join(sub, "metrics")
    pkg = _drift_package(sub)[0]
    device = make_device("cuda")
    model = load_model_package("alpha", pkg, device,
                               os.path.join(sub, "local"),
                               dict(root.__dict__))
    engine = EnsembleEvalEngine(model.forwards, model.member_params, device)
    ctr = telemetry.counter
    out = {}
    c0 = {k: ctr(k).value for k in (
        "fleet.hedge.issued", "fleet.hedge.wins", "fleet.eject.total",
        "fleet.eject.reinstated_total", "fleet.stale_response")}
    fleets = []
    try:
        with ThreadPoolExecutor(2) as tp:
            futs = [tp.submit(_small_fleet, pkg, sub, "healthy",
                              metrics_dir=small_dir),
                    tp.submit(_small_fleet, pkg, sub, "gray",
                              env_overrides={0: {"VELES_FAULTS":
                                                 GRAY_FAULT}},
                              metrics_dir=small_dir, **GRAY_KW)]
            for f in futs:
                try:
                    fleets.append(f.result())
                except Exception as e:  # noqa: BLE001 — reported below
                    fleets.append(e)
        for f in fleets:
            check(not isinstance(f, Exception), f"fleet: a small fleet did "
                  f"not come up: {f}")
        (healthy, _), (gray, _) = fleets
        out["spawn_to_hello_s"] = [r.spawn_seconds for r in
                                   healthy.replicas + gray.replicas]
        out["healthy"], g = _closed_loop([healthy, gray], engine,
                                         GRAY_CLIENTS, GRAY_WINDOW_S,
                                         GRAY_RAMP_S, SEED + 400)
        deadline = time.monotonic() + 60
        while ctr("fleet.eject.reinstated_total").value == \
                c0["fleet.eject.reinstated_total"]:
            check(time.monotonic() < deadline,
                  "gray: the slow replica was never reinstated")
            time.sleep(0.2)
        st = gray.sentinel.status(gray.replicas[0])
        d = {k: ctr(k).value - v for k, v in c0.items()}
        check(d["fleet.hedge.issued"] >= 1 and d["fleet.eject.total"] >= 1
              and d["fleet.eject.reinstated_total"] >= 1,
              f"gray: hedges/ejections/reinstatements {d}")
        bound = GRAY_P99_FACTOR * out["healthy"]["p99_ms"]
        check(g["p99_ms"] <= bound,
              f"gray: p99 {g['p99_ms']:.2f} ms over {GRAY_P99_FACTOR}x "
              f"the healthy fleet's {out['healthy']['p99_ms']:.2f} ms")
        out["gray"] = dict(g, counters=d, sentinel=st,
                           p99_ratio=g["p99_ms"] / out["healthy"]["p99_ms"],
                           ejection_dump=_ejection_dump(small_dir, 0))
        gray.close()
        # the healthy fleet alone on the card: tracing's cost
        out["trace_overhead"] = _trace_overhead(healthy)
        out["open_loop"] = _open_loop_day(healthy)
        healthy.close()
        out["sigterm"] = _sigterm_dumps(small_dir)
        # the corrupt replica
        s0 = ctr("fleet.integrity_strikes").value
        # its replicas run under the lock witness (no latency is judged)
        witness_dir = os.path.join(sub, "witness")
        fleets.append(_small_fleet(
            pkg, sub, "garbage", env_overrides={
                0: {"VELES_FAULTS": "hive.garbage_response@times=*"}},
            env={"VELES_LOCK_WITNESS": "1"}, metrics_dir=witness_dir,
            deadline_ms=8000, hedge_budget=0.0, probe_interval=0.25,
            probe_ok=2))
        router = fleets[-1][0]
        witness_pids = [r.pid for r in router.replicas]
        gen = np.random.default_rng(SEED + 500)
        for i in range(20):
            x = gen.standard_normal((2, 6, 6, 1)).astype(np.float32)
            got = _check_crc(router.request("alpha", x, timeout=30), 2,
                             f"garbage drill request {i}")
            xb = np.zeros((16, 6, 6, 1), np.float32)
            xb[:2] = x
            check(np.abs(got - engine.predict_proba(xb)[:2]).max()
                  <= 1e-3, f"garbage drill request {i}: a corrupt answer "
                  f"reached the client")
        st = router.sentinel.status(router.replicas[0])
        strikes = ctr("fleet.integrity_strikes").value - s0
        check(strikes >= 1 and st["state"] in ("ejected", "probing"),
              f"garbage: {strikes} integrity strikes, sentinel {st}")
        out["garbage"] = {"requests": 20, "integrity_strikes": strikes,
                          "sentinel": st}
        router.close()
        out["witness"] = _witnessed(witness_dir, witness_pids)
    finally:
        for f in fleets:
            if not isinstance(f, Exception):
                f[0].close()
                f[1].close()
        engine.release()
        telemetry.configure(None)
    out["card"] = card
    return out


def fleet_phase(card: str, workdir: str) -> dict:
    """Phase 24: the serving fleet on the card (see the module doc)."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    pkg = os.path.join(workdir, "alexnet.vpkg")
    alex = _fleet_alexnet(card, workdir, pkg)
    torch.cuda.empty_cache()
    small = _fleet_small(card, workdir)
    out = {"alexnet": alex, "small": small,
           "launches": alex["launches"],
           "minutes": (time.perf_counter() - t0) / 60, "card": card}
    fo = alex["failover"]
    mem = alex["card_used_bytes"]
    print(f"fleet: AlexNet x{N_MEMBERS} from {FLEET_REPLICAS} replicas, "
          f"spawn to hello {[round(s, 2) for s in alex['spawn_to_hello_s']]}"
          f" s, first answer {[round(s, 2) for s in alex['first_answer_s']]}"
          f" s (first dispatch {alex['first_dispatch_gauge_s']} s)  [{card}]",
          flush=True)
    print(f"fleet: warm-up before each hello "
          f"{[round(w['seconds'], 2) for w in alex['warmup']]} s, lrn_fwd "
          f"{[w['kernel_launches']['lrn_fwd'] for w in alex['warmup']]} "
          f"(counted apart); first answers after it "
          f"{[round(f, 3) for f in alex['first_answer_s']]} s fresh, "
          f"{fo['respawn_first_answer_s']:.3f} s respawned (bar "
          f"{FIRST_ANSWER_BAR_S}); metrics dirs: requests by pid "
          f"{[r['requests'] for r in alex['metrics']['replicas']]}  "
          f"[{card}]", flush=True)
    print(f"fleet: {FLEET_REQUESTS} one-row requests from "
          f"{FLEET_THREADS} threads, routed {alex['routed']}, p50 "
          f"{alex['p50_ms']:.1f} / p99 {alex['p99_ms']:.1f} ms, "
          f"{alex['hedges']} hedges (threshold "
          f"{alex['hedge_threshold_ms']:.1f} ms); lrn_fwd "
          f"{alex['lrn_fwd_launches']} in {alex['dispatches']} dispatches; "
          f"vs engine {alex['vs_engine_bf16']}  [{card}]", flush=True)
    print(f"fleet: SIGKILL with {fo['inflight']} in flight "
          f"({fo['on_victim']} on the victim): none lost, "
          f"{fo['retried']} retried; respawned in {fo['respawn_s']:.2f} s "
          f"(spawn to hello {fo['respawn_spawn_to_hello_s']:.2f} s), first "
          f"answer {fo['respawn_first_answer_s']:.2f} s; card memory used "
          f"{mem['before']} before the fleet, {mem['peak']} at its peak, "
          f"{mem['after_kill']} after the kill, {mem['after_respawn']} "
          f"after the respawn  [{card}]", flush=True)
    print(f"fleet: learner rung suspended both, released: lrn_bwd "
          f"{alex['learner']['lrn_bwd_grown']}, steps "
          f"{alex['learner']['steps']}  [{card}]", flush=True)
    g, ol = small["gray"], small["open_loop"]
    print(f"fleet: small model, healthy p99 {small['healthy']['p99_ms']:.2f}"
          f" ms, slow replica p99 {g['p99_ms']:.2f} ms (ratio "
          f"{g['p99_ratio']:.3f}, bar {GRAY_P99_FACTOR}); {g['counters']}; "
          f"garbage: {small['garbage']['integrity_strikes']} integrity "
          f"strikes, none reached a client  [{card}]", flush=True)
    print(f"fleet: open loop {ol['arrivals']} arrivals in "
          f"{OPEN_LOOP['duration_s']:.0f} s: {ol['ok']} ok, {ol['shed']} "
          f"shed, {ol['errors']} errors, p50 {ol['p50_ms']:.1f} / p99 "
          f"{ol['p99_ms']:.1f} ms; accountability {ol['accountability']}; "
          f"replicas over time "
          f"{[(t, n) for t, n, _ in ol['replicas_over_time']]}; actions "
          f"{[(a['action'], a.get('replica', a.get('rung')), a['pressure_ms']) for a in ol['actions']]}"
          f"  [{card}]", flush=True)
    tr, ov = alex["traces"], small["trace_overhead"]
    cp = tr["critical_path"]
    print(f"fleet: traces, healthy window {tr['healthy_whole']} of "
          f"{tr['healthy']} whole across {tr['pids']} pids; critical path "
          f"median / max ms: "
          + ", ".join(f"{k[:-3]} {v['median']:.2f} / {v['max']:.2f}"
                      for k, v in cp.items())
          + f"; failover {tr['failover_retried']} retried traces with legs "
          f"on 2 replicas; {tr['tail_exemplars']} tail exemplars, "
          f"{tr['tail_assembled']} assembled; SIGTERM dumps "
          f"{tr['sigterm']['sigterm_pids']} (AlexNet), "
          f"{small['sigterm']['sigterm_pids']} (small)  [{card}]",
          flush=True)
    pairs = [(round(a, 3), round(b, 3), c, d) for a, b, c, d in ov["pairs"]]
    print(f"fleet: trace overhead p99 ratio on/off {ov['p99_ratio']:.4f} "
          f"(bar {TRACE_OVERHEAD_BAR}), pairs (p99 ms on, off, n on, n "
          f"off) {pairs}"
          f"; ejection dumps {small['gray']['ejection_dump']}; witness "
          f"{small['witness']['snapshots']} snapshots, edges "
          f"{small['witness']['edges']}, no cycle, within the port's law "
          f"({small['witness']['law_edges']} edges)  [{card}]", flush=True)
    print(f"fleet: phase {out['minutes']:.2f} minutes", flush=True)
    return out


# -- phase 25: data parallel ---------------------------------------------

#: the data-parallel phase's workflow: models/alexnet.py at the train
#: phase's superstep, each rank's readings in dp_result_<tag>_<rank>.json
#: beside it: its launch counts (zeroed after initialize, read after the
#: run), history, param CRC, residency and collectives (it trains once
#: the file $DP_GO names exists, where that is set); and in
#: dp_delta_<tag>_<rank>.npz each param's change over the run at
#: DP_SAMPLE positions drawn from a seed of the param's name
#: (``param_sample``)
DP_WORKFLOW = """
import json
import os
import time
import zlib

import numpy as np

from chip_smoke import DP_SAMPLE, param_sample
from veles_tpu_torch.models import alexnet
from veles_tpu_torch.ops import lrn_cuda

HERE = os.path.dirname(os.path.abspath(__file__))


def run(launcher):
    w = launcher.create_workflow(alexnet.create_workflow)
    w.superstep = %(superstep)d
    t0 = time.perf_counter()
    launcher.initialize()
    init_s = time.perf_counter() - t0
    # $DP_GO: train once that file exists (the phase's side runs ended)
    while os.environ.get("DP_GO") and not os.path.exists(
            os.environ["DP_GO"]):
        time.sleep(0.05)
    before = param_sample(w.fused.host_params(), DP_SAMPLE)
    lrn_cuda.lrn_fwd.launches = lrn_cuda.lrn_bwd.launches = 0
    t0 = time.perf_counter()
    launcher.run()
    launcher.device.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_cuda.lrn_fwd.launches,
                "lrn_bwd": lrn_cuda.lrn_bwd.launches}
    group = launcher.group
    rank, world, backend = (0, 1, "none") if group is None else \
        (group.rank, group.world_size, group.backend)
    params = w.fused.host_params()
    crc = 0
    for f in sorted(params):
        for p in sorted(params[f]):
            crc = zlib.crc32(params[f][p].tobytes(), crc)
    after = param_sample(params, DP_SAMPLE)
    tag = "%%s_%%d" %% (os.environ["DP_TAG"], rank)
    np.savez(os.path.join(HERE, "dp_delta_" + tag + ".npz"),
             **{k: after[k] - before[k] for k in after})
    ld = w.loader
    path = os.path.join(HERE, "dp_result_" + tag + ".json")
    with open(path, "w") as f:
        json.dump({"rank": rank, "world": world, "backend": backend,
                   "device": str(launcher.device.device),
                   "launches": launches, "history": w.decision.history,
                   "crc": crc, "stats": {} if group is None
                   else group.stats,
                   "resident_bytes": ld.resident_bytes,
                   "shard_resident": ld.shard_resident,
                   "row_bytes": int(ld.sample_shape[0] * ld.sample_shape[1]
                                    * ld.sample_shape[2] * 4 + 8),
                   "init_s": init_s, "run_s": run_s}, f)
"""
#: the data-parallel runs: 1 epoch of the train phase's data
DP_OVERRIDES = TRAIN_OVERRIDES[:2] + ["root.alexnet.decision.max_epochs=1"]
DP_RANKS = 2
#: AlexNet's layers with params: 5 convolutions, 3 fully connected
DP_PARAM_LAYERS = 8
#: the first epoch's validation and train rows against the train
#: phase's: loss within DP_LOSS_TOL, n_err within DP_NERR_FRAC of the
#: class's rows.  Measured (NVIDIA H100 80GB HBM3, 700 W): the two ranks'
#: rows against one rank's of the same configuration and against two
#: more one-rank runs differ by 0.0 in both (the loss stays at ln 1000
#: for the first epoch), so the bars allow only f32 rounding of the
#: class sums (DP_LOSS_TOL about 200 ulps of 6.9) and one row in 100
DP_LOSS_TOL, DP_NERR_FRAC = 1e-4, 0.01
#: positions of each param whose change over the epoch is compared, and
#: the bar of max over params ||d_dp - d_train|| / ||d_train|| there.
#: Measured against one NCCL rank of the same configuration: 0.036 at
#: worst for a weight, 0.147 for a bias (conv1's, whose change sums
#: gradients that nearly cancel, in bf16, over 64 rows against 128);
#: two one-rank runs: 0.0.  A lost or doubled gradient reads 0.5 to 1
DP_SAMPLE, DP_DELTA_RTOL = 65536, 0.3
#: the one NCCL rank's net: models/alexnet.py cut (two conv + norm +
#: pool stages, a fully connected layer, softmax) on 67x67x3, one
#: superstep of 8 minibatches of 16 and one validation minibatch
DP_TINY_CONFIG = """
GD = {"learning_rate": 0.05, "weight_decay": 0.0005, "gradient_moment": 0.9}
NORM = {"type": "norm", "->": {"alpha": 1e-3, "beta": 0.75, "n": 5,
                               "k": 2.0}, "<-": {}}
POOL = {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2},
        "<-": {}}
root.alexnet.layers = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 11, "ky": 11,
                                 "sliding": 4}, "<-": GD}, NORM, POOL,
    {"type": "conv_relu", "->": {"n_kernels": 12, "kx": 5, "ky": 5,
                                 "padding": 2}, "<-": GD}, NORM, POOL,
    {"type": "all2all_relu", "->": {"output_sample_shape": 16}, "<-": GD},
    {"type": "softmax", "->": {"output_sample_shape": 5}, "<-": GD}]
root.alexnet.loader.shape = (67, 67, 3)
root.alexnet.loader.n_classes = 5
root.alexnet.loader.minibatch_size = 16
root.alexnet.loader.n_train = 128
root.alexnet.loader.n_valid = 16
root.alexnet.decision.max_epochs = 1
"""
DP_TINY_PARAM_LAYERS = 4


def _dp_results(workdir: str, tag: str, world: int) -> list:
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"dp_result_{tag}_{r}.json")) as f:
            out.append(json.load(f))
    return out


def _dp_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    for key in ("VELES_SUPERVISE_ATTEMPT", "VELES_RESUME_MANIFEST",
                "VELES_FAULTS", "VELES_MESH_RANKS_PER_CARD",
                "VELES_MESH_SHARD_DATA", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    env.update(extra)
    return env


def _epoch_gap(got: list, want: list) -> dict:
    """The first epoch's validation and train rows against ``want``'s:
    the largest loss gap, and the largest n_err gap as a share of the
    class's rows."""
    pairs = list(zip(got[:2], want[:2]))
    check([r["class"] for r, _ in pairs] == [w["class"] for _, w in pairs]
          == ["validation", "train"] and all(
              a["count"] == b["count"] for a, b in pairs),
          f"first epoch rows {got[:2]} against {want[:2]}")
    return {"loss": max(abs(a["loss"] - b["loss"]) for a, b in pairs),
            "n_err_frac": max(abs(a["n_err"] - b["n_err"]) / b["count"]
                              for a, b in pairs)}


def _delta_gap(workdir: str, tag: str, ref: str) -> dict:
    """Per param, ||d - d_ref|| / ||d_ref|| over the sampled positions of
    the run's param change (``DP_WORKFLOW``'s ``sample``)."""
    got = np.load(os.path.join(workdir, f"dp_delta_{tag}.npz"))
    want = np.load(os.path.join(workdir, f"dp_delta_{ref}.npz"))
    check(sorted(got.files) == sorted(want.files),
          f"{tag} and {ref} sampled other params")
    return {k: float(np.linalg.norm(got[k] - want[k]) /
                     max(np.linalg.norm(want[k]), 1e-30))
            for k in sorted(want.files)}


def dp_phase(card: str, workdir: str, train: dict = None) -> dict:
    """Phase 25: ``python -m veles_tpu_torch --dp 2`` on full-width
    AlexNet with two ranks sharing the card over gloo
    (``$VELES_MESH_RANKS_PER_CARD=2``) and the data row-sharded
    (``$VELES_MESH_SHARD_DATA=always``), held against ``train``'s first
    epoch (phase 4's; None: not held); beside it, ended before its
    ranks train: ``--dp 2`` refused without the knob, one
    ``--multihost`` rank over NCCL on a cut AlexNet, and the
    ``multihost.peer_exit`` drill on the card."""
    wf = os.path.join(workdir, "dp_wf.py")
    with open(wf, "w") as f:
        f.write(DP_WORKFLOW % {"superstep": SUPERSTEP})
    tiny = os.path.join(workdir, "dp_tiny.py")
    with open(tiny, "w") as f:
        f.write(DP_TINY_CONFIG)
    cmd = [sys.executable, "-m", "veles_tpu_torch", "-b", "cuda", "-s",
           str(SEED)]
    # the side runs go beside the ranks' start and data generation; the
    # ranks train once the side runs have ended ($DP_GO), so the
    # collectives are timed alone on the card
    go = os.path.join(workdir, "dp_go")
    t0 = time.perf_counter()
    runs = {
        "refusal": (cmd + ["--dp", str(DP_RANKS), wf] + DP_OVERRIDES,
                    _dp_env()),
        "nccl": (cmd + ["--multihost", wf, tiny],
                 _dp_env(MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(_free_port()), WORLD_SIZE="1",
                         RANK="0", LOCAL_RANK="0", DP_TAG="nccl")),
        "drill": ([sys.executable, "-m", "veles_tpu_torch.tools.chaos_drill",
                   "--only", "peer_exit", "--json"],
                  _dp_env(VELES_METRICS_DIR=os.path.join(workdir,
                                                         "dp_drill")))}
    side = {}
    outs = {}

    def read(path: str) -> str:
        with open(path) as f:
            return f.read()
    runs["gloo"] = (cmd + ["--dp", str(DP_RANKS), wf] + DP_OVERRIDES,
                    _dp_env(VELES_MESH_RANKS_PER_CARD=str(DP_RANKS),
                            VELES_MESH_SHARD_DATA="always", DP_TAG="gloo",
                            DP_GO=go))
    try:
        for name, (argv, env) in runs.items():
            # files, not pipes: nothing reads them until the runs end
            with open(os.path.join(workdir, f"dp_{name}.out"), "w") as o, \
                    open(os.path.join(workdir, f"dp_{name}.err"), "w") as e:
                side[name] = subprocess.Popen(argv, cwd=HERE, env=env,
                                              stdout=o, stderr=e)
        for name, proc in side.items():
            if name == "gloo":
                with open(go, "w"):
                    pass
                gloo_t0 = time.perf_counter()
            proc.wait(timeout=600)
            outs[name] = (read(os.path.join(workdir, f"dp_{name}.out")),
                          read(os.path.join(workdir, f"dp_{name}.err")),
                          proc.returncode)
        dp_s = time.perf_counter() - gloo_t0
    finally:
        for proc in side.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    _, err_g, rc_g = outs["gloo"]
    check(rc_g == 0, f"--dp {DP_RANKS}: rc {rc_g}: {err_g[-3000:]}")

    out_r, err_r, rc_r = outs["refusal"]
    check(rc_r == 2 and "VELES_MESH_RANKS_PER_CARD" in err_r,
          f"--dp {DP_RANKS} on one card without the share knob: rc {rc_r}:"
          f" {err_r[-1500:]}")
    ranks = _dp_results(workdir, "gloo", DP_RANKS)
    train_mb, valid_mb = N_TRAIN // TRAIN_BATCH, -(-N_VALID // TRAIN_BATCH)
    want = _want_launches(train_mb, valid_mb)
    rows = (N_TRAIN + N_VALID) // DP_RANKS
    for r in ranks:
        check(r["world"] == DP_RANKS and r["backend"] == "gloo"
              and r["device"] == "cuda:0", f"rank {r['rank']}: {r['world']} "
              f"ranks over {r['backend']} on {r['device']}")
        check(r["launches"] == want, f"rank {r['rank']} launched "
              f"{r['launches']}, want {want} for {train_mb} train and "
              f"{valid_mb} validation minibatches")
        check(r["shard_resident"] and r["resident_bytes"] ==
              rows * r["row_bytes"], f"rank {r['rank']}: resident "
              f"{r['resident_bytes']} bytes (sharded {r['shard_resident']}),"
              f" want the padded half, {rows} rows of {r['row_bytes']}")
        check(r["stats"]["grads"][0] == DP_PARAM_LAYERS * train_mb,
              f"rank {r['rank']}: {r['stats']['grads'][0]} gradient sums "
              f"for {train_mb} train minibatches")
        check([(h["class"], h["count"]) for h in r["history"]] ==
              [("validation", N_VALID), ("train", N_TRAIN)]
              and all(np.isfinite(h["loss"]) for h in r["history"]),
              f"rank {r['rank']} history {r['history']}")
    check(len({r["crc"] for r in ranks}) == 1 and
          ranks[0]["history"] == ranks[1]["history"],
          f"the ranks' params or histories differ: crc "
          f"{[r['crc'] for r in ranks]}")
    grads = ranks[0]["stats"]["grads"]

    _, err_n, rc_n = outs["nccl"]
    check(rc_n == 0, f"--multihost over NCCL: rc {rc_n}: {err_n[-3000:]}")
    (nccl,) = _dp_results(workdir, "nccl", 1)
    # the cut net: 8 train minibatches and one validation minibatch too
    check(nccl["backend"] == "nccl" and nccl["launches"] == want
          and nccl["stats"]["grads"][0] == DP_TINY_PARAM_LAYERS * train_mb
          and all(np.isfinite(h["loss"]) for h in nccl["history"]),
          f"one NCCL rank: {nccl['backend']}, launches {nccl['launches']}, "
          f"stats {nccl['stats']}, history {nccl['history']}")
    gap = delta = worst_delta = None
    if train is not None:
        gap = _epoch_gap(ranks[0]["history"], train["history"])
        check(gap["loss"] <= DP_LOSS_TOL and gap["n_err_frac"] <=
              DP_NERR_FRAC, f"--dp {DP_RANKS}'s first epoch against the "
              f"train phase's: {gap} (limits {DP_LOSS_TOL}, {DP_NERR_FRAC})")
        delta = {f"rank{r}": _delta_gap(workdir, f"gloo_{r}", "train_0")
                 for r in range(DP_RANKS)}
        worst_delta = max(max(d.values()) for d in delta.values())
        check(worst_delta <= DP_DELTA_RTOL, f"the params' change in --dp "
              f"{DP_RANKS}'s epoch against the train phase's first: "
              f"{delta} (limit {DP_DELTA_RTOL})")

    out_d, err_d, rc_d = outs["drill"]
    check(rc_d == 0, f"peer_exit drill: rc {rc_d}: {out_d[-1500:]} "
          f"{err_d[-2500:]}")
    rec = json.loads(out_d.strip().splitlines()[-1])
    (drill,) = rec["results"]
    check(rec["fault_drill_ok"] and rec["backend"] == "cuda"
          and drill["fault"] == "multihost.peer_exit" and drill["ok"]
          and drill["survivor_exit"] == 13 and drill["peer_exit"] == 17,
          f"peer_exit drill: {rec}")
    out = {"ranks": [{k: r[k] for k in ("rank", "launches", "crc",
                                        "resident_bytes", "stats", "init_s",
                                        "run_s")} for r in ranks],
           "history": ranks[0]["history"],
           "all_reduce_per_minibatch": grads[0] / train_mb,
           "all_reduce_ms_per_minibatch": 1e3 * grads[1] / train_mb,
           "epoch_gap_vs_train": gap, "delta_gap_vs_train": delta,
           "worst_delta_gap": worst_delta,
           "nccl": {k: nccl[k] for k in ("launches", "stats", "history",
                                         "init_s", "run_s")},
           "drill": drill, "seconds_by_part": {
               "side_runs": gloo_t0 - t0, "ranks_after_them": dp_s},
           "launches": {"lrn_fwd": [r["launches"]["lrn_fwd"] for r in ranks],
                        "lrn_bwd": [r["launches"]["lrn_bwd"] for r in ranks]},
           "card": card}
    print(f"dp: AlexNet --dp {DP_RANKS} on one card over gloo, row-sharded "
          f"{ranks[0]['resident_bytes']} bytes a rank; launches a rank "
          f"{[r['launches'] for r in ranks]}; {grads[0] / train_mb:.0f} "
          f"gradient all-reduces a minibatch, "
          f"{1e3 * grads[1] / train_mb:.1f} ms a minibatch; params crc "
          f"{[r['crc'] for r in ranks]}; first epoch against the train "
          f"phase's {gap} (limits {DP_LOSS_TOL}, {DP_NERR_FRAC}), the "
          f"params' change worst {worst_delta} (limit {DP_DELTA_RTOL})  "
          f"[{card}]", flush=True)
    print(f"dp: --dp {DP_RANKS} without the share knob refused (rc 2); one "
          f"NCCL rank (cut AlexNet): launches {nccl['launches']}, "
          f"{nccl['stats']}; "
          f"peer_exit drill: survivor exit {drill['survivor_exit']} "
          f"{drill['survivor_after_peer_sec']} s after the peer, snapshot "
          f"{drill['final_snapshot']} resumed; parts "
          f"{out['seconds_by_part']}  [{card}]", flush=True)
    return out


# -- phase 26: member-sharded cohorts and mesh serving -------------------

#: phase 26: one process's mesh of 2 places, both on the one card
#: ($VELES_MESH_RANKS_PER_CARD=2); no run covers a mesh over two cards
MESH_PLACES = 2
#: the served ensemble: 3 full-width AlexNet members (f32 stack 731.6 MB,
#: padded to 4, 487.8 MB a place) beside the tier-1 model; a budget a
#: place that the padded half fits and the whole stack does not
MESH_MEMBERS = 3
MESH_BUDGET = 640 << 20
#: the requests, 1-16 rows, switching models so that a hive that cannot
#: hold both spills at every switch
MESH_REQUESTS = ("alexnet3", "small", "alexnet3")
#: the cohort: conv1's learning rate as the one gene, P = 3 (padded to
#: 4 over the 2 places), one epoch of 256 + 128 images
MESH_COHORT_LRS = (0.01, 0.005, 0.02)
MESH_COHORT_OVERRIDES = ["root.alexnet.loader.n_train=256",
                         "root.alexnet.loader.n_valid=128",
                         "root.alexnet.decision.max_epochs=1"]
#: its minibatches of 128: 2 train, 1 validation
MESH_COHORT_MB = {"train": 2, "valid": 1}
#: the sharded cohort's params against the unsharded cohort's: in bf16 a
#: grouped convolution over a place's 2 members rounds otherwise than one
#: over all 3, so the bar is the cohort phase's for bf16 (the whole
#: model's relative L2, COHORT_MODEL_RTOL); the share of elements outside
#: tests/test_torch_population.py's f32 bar (which the tier-1 test holds
#: on the CPU) is reported.  The model's norm is mostly fc6's and fc7's,
#: so each member's change from its start is held leaf by leaf as well,
#: at phase 25's bar (DP_DELTA_RTOL), and the evaluator's change norms
#: against this process's
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 1e-4, 5e-6
MESH_COHORT_CONFIG = '''
from veles_tpu_torch.config import root
from veles_tpu_torch.genetics import Tune
from veles_tpu_torch.models import alexnet

layers = alexnet.alexnet_layers()
layers[0] = dict(layers[0], **{"<-": dict(
    layers[0]["<-"], learning_rate=Tune(0.01, 0.001, 0.1))})
root.alexnet.layers = layers
'''


def _mesh_hives(pkgs: dict, workdir: str, hives: dict,
                errors: list) -> list:
    """Start a ``--mesh 2`` hive and a flat hive on the same packages and
    budget, side by side, each in a thread of its own filling ``hives``
    ({"mesh": client, "flat": client}) or ``errors``; returns the
    threads."""
    from veles_tpu_torch.serve.client import HiveClient

    def start(kind: str) -> None:
        try:
            hives[kind] = HiveClient(
                pkgs, backend="cuda", max_batch=MAX_BATCH,
                max_wait_ms=5, hbm_budget=MESH_BUDGET,
                heartbeat_every=0,
                install_dir=os.path.join(workdir, f"mesh_{kind}_install"),
                env={"VELES_MESH_RANKS_PER_CARD": str(MESH_PLACES),
                     "VELES_SERVE_MESH_SHARD": "auto"},
                cwd=HERE, mesh=MESH_PLACES if kind == "mesh" else 0,
                stderr=open(os.path.join(workdir, f"mesh_{kind}.stderr"),
                            "w"), start_timeout=300)
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(f"{kind} hive: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=start, args=(k,))
               for k in ("mesh", "flat")]
    for t in threads:
        t.start()
    return threads


def _mesh_serve(hives: dict, small_rows: np.ndarray) -> dict:
    """The requests through both hives, one at a time; their answers,
    stats and spills."""
    gen = np.random.default_rng(SEED + 200)
    out = {}
    answers = {k: [] for k in hives}
    stats0 = {k: h.stats() for k, h in hives.items()}
    for k, st in stats0.items():
        check(st["kernel_launches"]["lrn_fwd"] == 0 and st["dispatches"]
              == 0, f"mesh: {k} hive's counts not zero before the "
              f"requests: {st['kernel_launches']}")
    rows = []
    for model in MESH_REQUESTS:
        if model == "small":
            rows.append(small_rows[:int(gen.integers(1, 5))])
        else:
            n = int(gen.integers(1, 17))
            rows.append((gen.integers(0, 256, (n,) + SAMPLE_SHAPE)
                         - 128).astype(np.float32))
    def drive(kind: str, h) -> None:
        t0 = time.perf_counter()
        for model, x in zip(MESH_REQUESTS, rows):
            a = h.request(model, x, timeout=300)
            check("probs" in a, f"mesh: {kind} hive, {model}: {a}")
            probs = np.asarray(a["probs"], np.float32)
            check(probs.shape[0] == len(x) and a["crc"] ==
                  zlib.crc32(probs.tobytes()) and np.all(np.isfinite(probs)),
                  f"mesh: {kind} hive, {model}: a bad answer")
            answers[kind].append(probs)
        out[kind] = {"requests_s": time.perf_counter() - t0,
                     "stats": h.stats()}
        print(f"mesh: the {kind} hive answered {len(rows)} requests in "
              f"{out[kind]['requests_s']:.1f} s", flush=True)

    # the two hives answer side by side, each its requests one at a time
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as tp:
        for f in [tp.submit(drive, k, h) for k, h in hives.items()]:
            f.result()
    return {"answers": answers, "rows": rows, **out}


def _mesh_cohort_setup(cfg: str, values: list, mesh):
    """The GA evaluator's cohort set-up (``genetics/worker.py``
    ``_evaluate_cohort`` and ``_train_cohort_chunk``) in this process:
    each member's rates and decays read off its own workflow, the
    cohort's workflow built on the card; returns (workflow, engine)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.genetics import worker
    from veles_tpu_torch.launcher import Launcher, load_workflow_module
    from veles_tpu_torch.ops.fused import PopulationTrainEngine

    class FL:
        workflow = None

    create = load_workflow_module(ALEXNET_FILE).create_workflow
    saved = copy.deepcopy(dict(root.__dict__))
    try:
        rates, decays = [], []
        for v in values:
            worker._rebuild_root(saved, [cfg], MESH_COHORT_OVERRIDES, v)
            prng.seed_all(SEED)
            w = create(FL())
            rates.append([[gd.learning_rate, gd.learning_rate_bias]
                          if gd is not None else [0.0, 0.0]
                          for gd in w.gds])
            decays.append([[gd.weight_decay, gd.weight_decay_bias]
                           if gd is not None else [0.0, 0.0]
                           for gd in w.gds])
        worker._rebuild_root(saved, [cfg], MESH_COHORT_OVERRIDES, values[0])
        launcher = Launcher(backend="cuda", seed=SEED)
        launcher.create_workflow(create)
        launcher.initialize()
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved)
    w = launcher.workflow
    return w, PopulationTrainEngine(w, np.asarray(rates, np.float32),
                                    np.asarray(decays, np.float32),
                                    mesh=mesh)


def _mesh_cohorts(cfg: str, values: list, mesh) -> dict:
    """The AlexNet cohort unsharded and sharded over ``mesh``, in this
    process: fitness, launches and params of each, and the cohort caps."""
    import torch

    from veles_tpu_torch.genetics.worker import _hbm_cohort_cap
    runs = {}
    for kind, m in (("flat", None), ("sharded", mesh)):
        t0 = time.perf_counter()
        w, engine = _mesh_cohort_setup(cfg, values, m)
        setup_s = time.perf_counter() - t0
        check(engine.member_sharded == (m is not None),
              f"mesh: the {kind} cohort's placement")
        if m is not None:
            for tile, place in zip(engine._tiles, m.places):
                check(all(t.device == place for ps in tile.values()
                          for t in ps.values()),
                      f"mesh: a tile off its place {place}")
        _zero_launches()
        fits = engine.run()
        torch.cuda.synchronize()
        runs[kind] = {
            "fitness": fits.tolist(), "launches": _launches(),
            "minibatches": engine.minibatches,
            "seconds": engine.seconds,
            "stacked": engine._n_stacked,
            "start": w.fused.host_params(),
            "params": [engine.member_params(i) for i in range(len(values))],
            "change_norms": engine.change_norms(),
            "cap": _hbm_cohort_cap(w, 0, m), "setup_s": setup_s}
        print(f"mesh: the {kind} cohort set up in {setup_s:.1f} s, ran in "
              f"{engine.seconds:.1f} s", flush=True)
        if m is not None:
            # one place's cap: the same budget a place, not N of them
            os.environ["VELES_MESH_SHARD_MEMBERS"] = "never"
            try:
                runs["place_cap"] = _hbm_cohort_cap(w, 0, m)
            finally:
                os.environ.pop("VELES_MESH_SHARD_MEMBERS", None)
        engine.release()
        del engine, w
        torch.cuda.empty_cache()
    return runs


def _member_deltas(sharded: dict, flat: dict) -> dict:
    """Each member's change from its start (``d``), leaf by leaf: the
    sharded cohort's against the unsharded's, ``||d - d_flat|| /
    ||d_flat||`` at worst; and the power of that check, the least
    ``||d_i - d_j|| / ||d_j||`` between two unsharded members on the
    gene's leaf (the first forward's first param, conv1's weights)."""
    def change(run, i, fn, pn):
        return run["params"][i][fn][pn] - run["start"][fn][pn]

    worst, worst_leaf = 0.0, None
    for i, ps in enumerate(flat["params"]):
        for fn, leaves in ps.items():
            for pn in leaves:
                want = change(flat, i, fn, pn)
                gap = float(np.linalg.norm(change(sharded, i, fn, pn) -
                                           want) /
                            max(np.linalg.norm(want), 1e-30))
                if gap >= worst:
                    worst, worst_leaf = gap, f"member {i} {fn}.{pn}"
    fn = next(iter(flat["start"]))
    pn = next(iter(flat["start"][fn]))
    n = len(flat["params"])
    apart = min(float(np.linalg.norm(change(flat, i, fn, pn) -
                                     change(flat, j, fn, pn)) /
                      max(np.linalg.norm(change(flat, j, fn, pn)), 1e-30))
                for i in range(n) for j in range(n) if i != j)
    return {"worst": worst, "worst_leaf": worst_leaf,
            "gene_leaf": f"{fn}.{pn}", "members_apart": apart}


def _mesh_som(mesh) -> dict:
    """The SOM cohort of the first three SOM_GENOMES (padded to 4 over
    the 2 places) against its unsharded run."""
    import torch

    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher, load_workflow_module
    from veles_tpu_torch.ops.kohonen import SOMPopulationEngine
    create = load_workflow_module(
        os.path.join(MODELS_DIR, "kohonen.py")).create_workflow
    genomes = np.asarray(SOM_GENOMES[:3], np.float32)
    out = {}
    for kind, m in (("flat", None), ("sharded", mesh)):
        saved = copy.deepcopy(dict(root.__dict__))
        try:
            hp = genomes[0]
            root.kohonen.trainer = {"alpha0": hp[0], "alpha_min": hp[1],
                                    "sigma0": hp[2], "sigma_min": hp[3]}
            launcher = Launcher(backend="cuda", seed=SEED)
            launcher.create_workflow(create)
            launcher.initialize()
        finally:
            root.__dict__.clear()
            root.__dict__.update(saved)
        engine = SOMPopulationEngine(launcher.workflow, genomes, mesh=m)
        check(engine._n_stacked == (4 if m is not None else 3),
              f"mesh: SOM cohort stacked {engine._n_stacked}")
        _zero_launches()
        out[kind] = {"fitness": engine.run().tolist(),
                     "launches": _launches()}
        torch.cuda.synchronize()
        out[kind]["maps"] = engine.weights.cpu().numpy()
        engine.release()
    return out


def mesh_phase(card: str, workdir: str) -> dict:
    """Phase 26: ROADMAP item 10b on the one card, a mesh of 2 places
    sharing it (``$VELES_MESH_RANKS_PER_CARD=2``).  Serving: a 3-member
    full-width AlexNet and the tier-1 model from a ``--serve-models
    --mesh 2`` hive and a flat hive at one budget a place
    (MESH_BUDGET): the mesh hive holds AlexNet member-sharded and
    resident with 0 spills where the flat one spills, and answers as the
    flat one does.  Training: an AlexNet cohort of 3 through ``python -m
    veles_tpu_torch.genetics.worker --serve --dp 2`` (one job) beside the
    same cohort unsharded and sharded in this process; the SOM cohort of
    3 over the 2 places against its unsharded run."""
    import torch

    from veles_tpu_torch import knobs
    from veles_tpu_torch.config import root
    from veles_tpu_torch.genetics.core import find_tunes
    from veles_tpu_torch.launcher import apply_config_file
    from veles_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    steps = {}

    def step(name: str) -> None:
        steps[name] = time.perf_counter() - t0
        print(f"mesh: {name} at {steps[name]:.1f} s", flush=True)

    sub = os.path.join(workdir, "mesh")
    os.makedirs(sub, exist_ok=True)
    cfg = os.path.join(sub, "mesh_cohort_cfg.py")
    with open(cfg, "w") as f:
        f.write(MESH_COHORT_CONFIG)
    saved = copy.deepcopy(dict(root.__dict__))
    try:
        apply_config_file(cfg)
        (gene,) = find_tunes(root)
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved)
    values = [{gene: lr} for lr in MESH_COHORT_LRS]
    # the evaluator starts first, its one job sent at once; the package
    # is packed beside its start, then the hives start beside this
    # process's cohorts
    env = _dp_env(VELES_MESH_RANKS_PER_CARD=str(MESH_PLACES))
    with open(os.path.join(sub, "worker.stderr"), "w") as err:
        worker = subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch.genetics.worker",
             "--serve", ALEXNET_FILE, cfg] + MESH_COHORT_OVERRIDES +
            ["-b", "cuda", "-s", str(SEED), "--dp", str(MESH_PLACES),
             "--heartbeat-every", "0"], cwd=HERE, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
            text=True)
    worker.stdin.write(json.dumps({"id": 1, "members": values,
                                   "seed": SEED}) + "\n")
    worker.stdin.close()
    worker_lines = []
    reader = threading.Thread(
        target=lambda: worker_lines.extend(worker.stdout), daemon=True)
    reader.start()
    hives, errors, threads = {}, [], []
    saved_env = os.environ.get(knobs.MESH_RANKS_PER_CARD)
    os.environ[knobs.MESH_RANKS_PER_CARD] = str(MESH_PLACES)
    cache = None
    try:
        # packing draws from the process's streams and reads its config:
        # it runs alone, then the hives start beside this process's
        # cohorts
        pkg = build_package(sub, MESH_MEMBERS, "alexnet3")
        small_pkg, _, _, small_rows, _ = _drift_package(sub)
        step("packed")
        # the tier-1 model first: the flat hive then admits AlexNet over
        # its budget alone by spilling it, and warms AlexNet up before
        # its hello as the mesh hive does
        threads = _mesh_hives({"small": small_pkg, "alexnet3": pkg}, sub,
                              hives, errors)
        cache = _CachedSynthetic()
        mesh = make_mesh(MESH_PLACES, "cuda")
        check(list(mesh.places) == [torch.device("cuda", 0)] * MESH_PLACES,
              f"mesh: places {mesh.places}")
        cohorts = _mesh_cohorts(cfg, values, mesh)
        step("cohorts")
        som = _mesh_som(mesh)
        step("som")
        for t in threads:
            t.join(400)
        check(not errors and len(hives) == 2, "; ".join(errors) or
              "mesh: a hive did not start")
        step("hives")
        hellos = {k: h.hello for k, h in hives.items()}
        serve = _mesh_serve(hives, small_rows)
        closers = [threading.Thread(target=h.close) for h in hives.values()]
        for t in closers:
            t.start()
        for t in closers:
            t.join(60)
        for h in hives.values():
            check(h.proc.poll() == 0, f"mesh: a hive's shutdown rc "
                  f"{h.proc.poll()}")
        hives = {}
        step("served")
        worker.wait(timeout=300)
        reader.join(60)
        step("evaluator")
    finally:
        if cache is not None:
            cache.restore()
        for t in threads:
            t.join(400)
        for h in hives.values():
            h.close(kill=True)
        if worker.poll() is None:
            worker.kill()
            worker.wait()
        if saved_env is None:
            os.environ.pop(knobs.MESH_RANKS_PER_CARD, None)
        else:
            os.environ[knobs.MESH_RANKS_PER_CARD] = saved_env
    check(worker.returncode == 0,
          f"mesh: the evaluator exited {worker.returncode}")
    lines = [json.loads(ln) for ln in worker_lines if ln.strip()]
    hello = next(m for m in lines if m.get("ready"))
    (job,) = [m for m in lines if m.get("id") == 1]
    check("fitnesses" in job and job["fallbacks"] == 0,
          f"mesh: the evaluator's job: {job}")

    # -- serving: placement, spills, answers, launches
    hm, hf = hellos["mesh"], hellos["flat"]
    check(hm["devices"] == MESH_PLACES and hf["devices"] == 1,
          f"mesh: hellos advertise devices {hm['devices']} / "
          f"{hf['devices']}")
    check(hm["models"]["alexnet3"]["sharded"] is True
          and hm["models"]["alexnet3"]["resident"]
          and hf["models"]["alexnet3"]["sharded"] is False,
          f"mesh: hello models {hm['models']} / {hf['models']}")
    sm, sf = serve["mesh"]["stats"], serve["flat"]["stats"]
    check(sm["models"]["alexnet3"]["sharded"] is True and all(
        r["resident"] for r in sm["models"].values()) and sm["spills"] == 0,
        f"mesh: the mesh hive's stats {sm['models']}, spills "
        f"{sm['spills']}")
    check(sf["spills"] >= 2, f"mesh: the flat hive spilled {sf['spills']} "
          f"times at the budget that the mesh holds both models in")
    check(sm["gauges"]["serve.mesh_devices"] == MESH_PLACES,
          "mesh: the serve.mesh_devices gauge")
    n_norm = 2
    launches = {}
    for kind, st in (("mesh", sm), ("flat", sf)):
        d = st["models"]["alexnet3"]["dispatches"]
        launches[kind] = st["kernel_launches"]["lrn_fwd"]
        check(d == MESH_REQUESTS.count("alexnet3") and launches[kind] ==
              n_norm * MESH_MEMBERS * d,
              f"mesh: the {kind} hive launched lrn_fwd {launches[kind]} "
              f"times in {d} AlexNet dispatches (want {n_norm} layers x "
              f"{MESH_MEMBERS} real members a dispatch)")
    bitwise = all(np.array_equal(a, b) for a, b in
                  zip(serve["answers"]["mesh"], serve["answers"]["flat"]))
    answers = [agree(a, b, 1e-3, 0.0, 0.05, f"mesh request {i} vs flat")
               for i, (a, b) in enumerate(zip(serve["answers"]["mesh"],
                                              serve["answers"]["flat"]))]
    stack = hm["models"]["alexnet3"]["param_bytes"]
    want_place = stack // MESH_MEMBERS * 4 // MESH_PLACES
    per_place = sm["ledger"]["serve"]
    check(want_place <= per_place <= MESH_BUDGET < stack,
          f"mesh: {per_place} bytes a place for a {stack}-byte stack "
          f"(padded half {want_place}) at a budget of {MESH_BUDGET}")

    # -- the cohorts
    flat, sharded = cohorts["flat"], cohorts["sharded"]
    check(job["fitnesses"] == flat["fitness"] == sharded["fitness"],
          f"mesh: cohort fitness: evaluator --dp {job['fitnesses']}, "
          f"sharded {sharded['fitness']}, unsharded {flat['fitness']}")
    (chunk,) = job["stats"]
    train_mb = MESH_COHORT_MB["train"]
    valid_mb = MESH_COHORT_MB["valid"]
    want_sharded = {"lrn_fwd": n_norm * MESH_PLACES * (train_mb + valid_mb),
                    "lrn_bwd": n_norm * MESH_PLACES * train_mb}
    want_flat = {k: v // MESH_PLACES for k, v in want_sharded.items()}
    check(chunk["kernel_launches"] == sharded["launches"] == want_sharded
          and flat["launches"] == want_flat and chunk["places"] ==
          MESH_PLACES, f"mesh: cohort launches: evaluator "
          f"{chunk['kernel_launches']}, sharded {sharded['launches']} "
          f"(want {want_sharded}), unsharded {flat['launches']} (want "
          f"{want_flat})")
    place_cap = cohorts["place_cap"]
    check(chunk["cap"] == sharded["cap"] and abs(
        chunk["cap"] - MESH_PLACES * place_cap) <= MESH_PLACES,
        f"mesh: cohort caps: evaluator {chunk['cap']}, in process "
        f"{sharded['cap']}, one place's {place_cap}")
    worst = {"abs": 0.0, "model_rel_l2": 0.0, "outside_f32_bar": 0}
    for a_m, b_m in zip(sharded["params"], flat["params"]):
        diff = norm = 0.0
        for fn, ps in b_m.items():
            for pn, b in ps.items():
                err = np.abs(a_m[fn][pn] - b)
                worst["abs"] = max(worst["abs"], float(err.max()))
                worst["outside_f32_bar"] += int(np.sum(
                    err > MESH_PARAM_ATOL + MESH_PARAM_RTOL * np.abs(b)))
                diff += _norm(err) ** 2
                norm += _norm(b) ** 2
        worst["model_rel_l2"] = max(worst["model_rel_l2"],
                                    diff ** 0.5 / max(norm ** 0.5, 1e-30))
    check(worst["model_rel_l2"] <= COHORT_MODEL_RTOL["bfloat16"],
          f"mesh: the sharded cohort's params differ from the unsharded's "
          f"by {worst['model_rel_l2']:.3g} (relative L2 of the model)")
    # each member's change from its start, leaf by leaf, as phase 25
    # holds its ranks': a tile trained at another member's rates moves
    # the gene's leaf (conv1's weights) by another distance
    delta = _member_deltas(sharded, flat)
    check(delta["worst"] <= DP_DELTA_RTOL and delta["members_apart"] >
          DP_DELTA_RTOL, f"mesh: the sharded members' change from their "
          f"start against the unsharded's: worst leaf {delta['worst']:.3g}"
          f" ({delta['worst_leaf']}), limit {DP_DELTA_RTOL}; the "
          f"unsharded members' {delta['gene_leaf']} changes "
          f"{delta['members_apart']:.3g} apart at the least (a misplaced "
          f"member must show above the limit)")
    # the evaluator's members moved as this process's did
    norms = np.asarray(chunk["change_norms"])
    norms_gap = {kind: float(np.max(np.abs(norms - run["change_norms"]) /
                                    np.maximum(run["change_norms"], 1e-30)))
                 for kind, run in (("sharded", sharded), ("flat", flat))}
    check(norms.shape == flat["change_norms"].shape and
          max(norms_gap.values()) <= DP_DELTA_RTOL,
          f"mesh: the evaluator's change norms {norms.shape} against this "
          f"process's cohorts: relative gap {norms_gap} (limit "
          f"{DP_DELTA_RTOL})")
    # the SOM cohort
    check(not any(som["sharded"]["launches"].values()),
          f"mesh: SOM cohort launched {som['sharded']['launches']}")
    som_rel = float(np.max(np.abs(np.asarray(som["sharded"]["fitness"]) -
                                  som["flat"]["fitness"]) /
                           np.abs(som["flat"]["fitness"])))
    check(som_rel <= SOM_FIT_RTOL, f"mesh: SOM cohort fitness "
          f"{som['sharded']['fitness']} vs {som['flat']['fitness']}")
    out = {
        "places": MESH_PLACES, "cards": 1, "budget_bytes": MESH_BUDGET,
        "steps_s": steps,
        "serve": {
            "hello_devices": [hm["devices"], hf["devices"]],
            "sharded": hm["models"]["alexnet3"]["sharded"],
            "mesh_spills": sm["spills"], "flat_spills": sf["spills"],
            "stack_bytes": stack, "serve_bytes_a_place": per_place,
            "padded_half_bytes": want_place,
            "requests": len(MESH_REQUESTS),
            "alexnet_dispatches": MESH_REQUESTS.count("alexnet3"),
            "lrn_fwd_launches": launches, "answers_bitwise": bitwise,
            "max_abs_err": max(a["max_abs_err"] for a in answers),
            "requests_s": {k: serve[k]["requests_s"]
                           for k in ("mesh", "flat")}},
        "cohort": {
            "members": len(values), "lrs": list(MESH_COHORT_LRS),
            "fitness": job["fitnesses"], "stacked": sharded["stacked"],
            "launches": chunk["kernel_launches"],
            "launches_unsharded": flat["launches"],
            "cap": chunk["cap"], "cap_one_place": place_cap,
            "cap_unsharded_card": flat["cap"],
            "setup_s": [flat["setup_s"], sharded["setup_s"]],
            "params_max_abs_err": worst["abs"],
            "params_model_rel_l2": worst["model_rel_l2"],
            "params_outside_f32_bar": worst["outside_f32_bar"],
            "change_gap_worst": delta["worst"],
            "change_gap_worst_leaf": delta["worst_leaf"],
            "gene_leaf": delta["gene_leaf"],
            "members_apart": delta["members_apart"],
            "evaluator_norms_gap": norms_gap,
            "minibatches": sharded["minibatches"],
            "evaluator_places": hello.get("places"),
            "evaluator_s": chunk["seconds"],
            "sharded_s": sharded["seconds"], "unsharded_s": flat["seconds"]},
        "som": {"fitness": som["sharded"]["fitness"],
                "launches": som["sharded"]["launches"],
                "unsharded_fitness": som["flat"]["fitness"],
                "rel_fitness": som_rel,
                "bitwise": som["sharded"]["fitness"] ==
                som["flat"]["fitness"]},
        "card": card}
    print(f"mesh: 2 places on one card; served AlexNet x{MESH_MEMBERS} "
          f"sharded, {per_place} bytes a place (budget {MESH_BUDGET}), "
          f"spills mesh {sm['spills']} / flat {sf['spills']}, answers "
          f"bitwise {bitwise}, lrn_fwd {launches}; cohort fitness "
          f"{job['fitnesses']}, launches {chunk['kernel_launches']} "
          f"(unsharded {flat['launches']}), cap {chunk['cap']} vs one "
          f"place's {place_cap}, params rel L2 "
          f"{worst['model_rel_l2']:.3g} (max abs {worst['abs']:.3g}), "
          f"change gap {delta['worst']:.3g} ({delta['worst_leaf']}) with "
          f"members {delta['members_apart']:.3g} apart on "
          f"{delta['gene_leaf']}, evaluator norms gap "
          f"{max(norms_gap.values()):.3g}; SOM rel {som_rel:.3g}  [{card}]",
          flush=True)
    return out


# -- phase 27: the master--slave mode ----------------------------------------

#: the phase's cut: 2 epochs of 128 + 64 images at 64 a minibatch, so 6
#: one-minibatch jobs, 4 of them train; widths and depth are the model's
MS_TRAIN, MS_VALID, MS_MB = 128, 64, 64
MS_OVERRIDES = [f"root.alexnet.loader.n_train={MS_TRAIN}",
                f"root.alexnet.loader.n_valid={MS_VALID}",
                f"root.alexnet.loader.minibatch_size={MS_MB}",
                f"root.alexnet.decision.max_epochs={N_EPOCHS}"]
MS_TRAIN_JOBS = N_EPOCHS * MS_TRAIN // MS_MB
MS_JOBS = MS_TRAIN_JOBS + N_EPOCHS * MS_VALID // MS_MB
#: the reference's bars (``tests/test_master_slave.py``): one slave
#: against the standalone run
MS_LOSS_TOL, MS_NERR_TOL, MS_PARAM_ATOL = 1e-4, 1, 1e-4


def _ms_workflow(backend: str):
    """The phase's AlexNet (the cut set, seeded SEED) initialized for
    training on ``backend``."""
    from veles_tpu_torch.config import parse_overrides, root
    from veles_tpu_torch.launcher import Launcher, load_workflow_module
    saved_root = copy.deepcopy(dict(root.__dict__))
    parse_overrides(MS_OVERRIDES)
    try:
        launcher = Launcher(backend=backend, seed=SEED)
        launcher.create_workflow(
            load_workflow_module(ALEXNET_FILE).create_workflow)
        launcher.initialize()
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved_root)
    return launcher.workflow


def _zmq_state():
    """(whether zmq imports here, a sentence saying so)."""
    try:
        import zmq
    except ImportError as e:
        return False, f"zmq does not import on this machine ({e})"
    return True, f"zmq {zmq.__version__} imports on this machine"


def master_slave_phase(card: str, workdir: str) -> dict:
    """One ``MasterServer`` and one ``SlaveClient`` in this process over
    full-width AlexNet, joined by zmq on 127.0.0.1 through their
    ``serve()``: the master on the CPU (it computes nothing) on a thread,
    the slave on the card; held against a standalone run of the same
    config and seed on the card, both under deterministic cuDNN."""
    import torch

    from veles_tpu_torch.client import SlaveClient
    from veles_tpu_torch.server import MasterServer

    zmq_ok, zmq_state = _zmq_state()
    check(zmq_ok, f"master_slave: {zmq_state}")
    cache = _CachedSynthetic()
    torch.backends.cudnn.deterministic = True
    try:
        try:
            t0 = time.perf_counter()
            alone = _ms_workflow("cuda")
            setup_s = time.perf_counter() - t0
            _zero_launches()
            t0 = time.perf_counter()
            alone.run()
            torch.cuda.synchronize()
            alone_s = time.perf_counter() - t0
            alone_launches = _launches()
            want_hist = list(alone.decision.history)
            want = alone.fused.host_params()
            del alone
            # the slave first: the master's loader then draws its later
            # epochs' shuffles from the stream as the standalone run did
            slave_w = _ms_workflow("cuda")
            master_w = _ms_workflow("cpu")
        finally:
            cache.restore()
        server = MasterServer(master_w, "tcp://127.0.0.1:*", linger_s=0.5)
        master = _Background(server.serve)
        check(server.bound.wait(60), "master_slave: the master did not bind")
        client = SlaveClient(slave_w, server.endpoint)
        _zero_launches()
        t0 = time.perf_counter()
        client.serve()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches = _launches()
        master.result(120)
        total_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    check(client.jobs_done == server._applied == MS_JOBS
          and master_w.decision.complete,
          f"{client.jobs_done} jobs done, {server._applied} applied, "
          f"want {MS_JOBS}")
    want_launches = _want_launches(MS_TRAIN_JOBS, MS_JOBS - MS_TRAIN_JOBS)
    check(launches == want_launches == alone_launches,
          f"the slave launched {launches}, the standalone run "
          f"{alone_launches}, want {want_launches} (2 a job, 2 more a "
          f"train job)")
    got_hist = list(master_w.decision.history)
    check([(r["class"], r["count"]) for r in got_hist] ==
          [(r["class"], r["count"]) for r in want_hist] ==
          [("validation", MS_VALID), ("train", MS_TRAIN)] * N_EPOCHS,
          f"histories {got_hist} / {want_hist}")
    gaps = [{"loss": abs(a["loss"] - b["loss"]),
             "n_err": abs(a["n_err"] - b["n_err"])}
            for a, b in zip(got_hist, want_hist)
            if a["class"] == "validation"]
    for a in got_hist:
        check(np.isfinite(a["loss"]), f"non-finite loss {a}")
    check(all(g["loss"] <= MS_LOSS_TOL and g["n_err"] <= MS_NERR_TOL
              for g in gaps), f"validation rows against the standalone "
          f"run: {gaps} (bars {MS_LOSS_TOL}, {MS_NERR_TOL})")
    got = master_w.fused.host_params()
    worst = max(float(np.abs(got[f][p] - a).max())
                for f, ps in want.items() for p, a in ps.items())
    check(worst <= MS_PARAM_ATOL, f"final params differ from the "
          f"standalone run's by {worst:.3g} (bar {MS_PARAM_ATOL})")
    # the rows stay near ln(1000) at this depth: each param's change from
    # its start is what sees a lost or doubled job (``same_run``)
    init = _initial_params(slave_w)
    same = same_run(got_hist, got, want_hist, want, init)
    moved = max(float(np.abs(got[f][p] - a).max())
                for f, ps in init.items() for p, a in ps.items())
    out = {"transport": "zmq REQ/ROUTER", "endpoint": server.endpoint,
           "zmq": zmq_state,
           "jobs": MS_JOBS, "train_jobs": MS_TRAIN_JOBS,
           "jobs_done": client.jobs_done, "applied": server._applied,
           "launches": launches, "standalone_launches": alone_launches,
           "validation_gaps": gaps, "params_max_abs_gap": worst,
           "same_run": same, "params_moved_max_abs": moved,
           "bars": {"loss": MS_LOSS_TOL, "n_err": MS_NERR_TOL,
                    "params": MS_PARAM_ATOL},
           "history": got_hist, "setup_s": setup_s,
           "standalone_s": alone_s, "loop_s": loop_s, "total_s": total_s,
           "s_per_job": loop_s / MS_JOBS, "card": card}
    print(f"master_slave: {MS_JOBS} jobs ({MS_TRAIN_JOBS} train) of "
          f"{MS_MB} rows from a CPU master to a slave on the card over "
          f"zmq at {server.endpoint} ({zmq_state}), "
          f"{loop_s:.1f} s ({loop_s / MS_JOBS:.2f} s a job); launches "
          f"{launches}; against the standalone run: validation {gaps}, "
          f"params max abs {worst:.3g} (moved up to {moved:.3g} from the "
          f"start), {same}  [{card}]", flush=True)
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _data_launches(name: str, mnist7: dict, cifar10: dict,
                   quantized: dict, mnist_ae: dict, kohonen: dict,
                   wine: dict, mnist_rbm: dict, mnist_dbn: dict,
                   profile: dict) -> dict:
    """A kernel's launches on the real-data phases' paths, the zoo's and
    the profiled supersteps'."""
    q = quantized["launches"]
    return {"mnist7": mnist7["launches"][name],
            "cifar10": cifar10["launches"][name],
            "quantized_stream": q["stream"][name],
            "quantized_resident": q["resident"][name],
            "quantized_float": q["float"][name],
            "mnist_ae": mnist_ae["launches"][name],
            "kohonen": kohonen["launches"][name],
            "wine": wine["launches"][name],
            "mnist_rbm": mnist_rbm["launches"][name],
            "mnist_dbn": mnist_dbn["launches"][name],
            "profile": profile["launches"][name]}


def _cohort_launches(name: str, cohort: dict, som_cohort: dict,
                     ensemble: dict) -> dict:
    """A kernel's launches on the cohort paths (the AlexNet cohort in
    bf16, the kernels' main path, and in f32), the SOM cohort and the
    ensemble's prediction on the card.  The GA's evaluator is a process
    of its own; mnist has no LRN layer."""
    return {"cohort": cohort["launches"][name],
            "cohort_f32": cohort["runs"][1]["launches"][name],
            "som_cohort": som_cohort["launches"][name],
            "ensemble": ensemble["launches"][name]}


def _online_launches(name: str, online: dict) -> dict:
    """A kernel's launches on the online phase's two paths: the counted
    shadow steps in this process, and the ``--online`` hive's whole
    life (serving dispatches, steps and gate rounds)."""
    return {"online": online["in_process"]["launches"][name],
            "online_serve": online["serve"]["launches"][name]}


def summary_kernel(name: str, replaces: str, rows, launches: dict,
                   card: str) -> dict:
    """The kernels-line entry: times summed over the training path's two
    shapes (batch 128, bf16, n = 5); ``launches`` is the training path's
    count, ``launches_by_path`` that of each main path that reads it
    (serving runs no backward and reports only ``lrn_fwd``)."""
    main = [r for r in rows if r["kernel"] == name and r["role"] == "train"]
    lib = [r["library_ms"] for r in main]
    entry = {"name": name, "route": "cuda",
             "source": f"veles_tpu_torch/csrc/{name}.cu",
             "replaces": replaces,
             "launches": launches["train"],
             "launches_by_path": launches,
             "max_abs_err": max(r["max_abs_err"] for r in main),
             "ms": sum(r["kernel_ms"] for r in main),
             "plain_ms": sum(r["plain_ms"] for r in main),
             "bound_ms": sum(r["bound_ms"] for r in main),
             "share_of_bound": sum(r["bound_ms"] for r in main)
             / sum(r["kernel_ms"] for r in main),
             "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                        for r in main) else "operations",
             "library_ms": sum(lib) if None not in lib else None,
             "shapes": [r["shape"] for r in main], "card": card}
    serve = [r for r in rows if r["kernel"] == name and r["role"] == "serve"]
    if serve:
        entry["serve_ms"] = sum(r["kernel_ms"] for r in serve)
        entry["serve_shapes"] = [r["shape"] for r in serve]
    return entry


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False; "
              "this script needs one CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from veles_tpu_torch import native
        from veles_tpu_torch.backends import make_device
        from veles_tpu_torch.ops import lrn_cuda
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")

    t_start = time.perf_counter()
    workdir = os.path.join(HERE, "_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    phases = {}

    def timed(name, fn, *args):
        """Run one phase, keeping (and printing) its wall seconds.  Any
        exception of the phase is named on stdout (``phase NAME: FAIL:
        <type>: <message>``) with its traceback on stderr, then raised
        on: nothing is retried and no later phase runs."""
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception as e:
            print(f"phase {name}: FAIL: {type(e).__name__}: {e}",
                  flush=True)
            traceback.print_exc()
            sys.stderr.flush()
            raise
        phases[name] = time.perf_counter() - t0
        print(f"phase {name}: {phases[name]:.1f} s", flush=True)
        return out

    only = {"preempt": preempt_phase, "online": online_phase,
            "fleet": fleet_phase, "dp": dp_phase, "mesh": mesh_phase,
            "master_slave": master_slave_phase,
            "serve": lambda c, w: serve_phase(c, w)[0]}
    if len(sys.argv) == 3 and sys.argv[1] == "--only" \
            and set(sys.argv[2].split(",")) <= set(only):
        # development: phase 1's build, the served package and phases 3,
        # 7, 23, 24, 25, 26 and / or 27 alone; no result lines
        try:
            timed("build", lrn_cuda.build)
            timed("package", build_package, workdir)
            for name in sys.argv[2].split(","):
                res = timed(name, only[name], card_line(), workdir)
                res["seconds"] = phases[name]
                print(f"{name} " + json.dumps(res))
            print("phases " + json.dumps(phases))
        except Exception:   # named by timed()
            return 1
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0

    def device_and_build():
        make_device("auto")
        print(f"device: {torch.cuda.get_device_name(0)} "
              f"x{torch.cuda.device_count()}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        t0 = time.perf_counter()
        native_err = []

        def build_native():
            try:
                native.ensure_built()
            except Exception as e:  # noqa: BLE001 — raised below
                native_err.append(e)
        # native/'s host build runs beside the two nvcc processes
        nb = threading.Thread(target=build_native)
        nb.start()
        lrn_cuda.build()
        print(f"build: lrn_fwd and lrn_bwd in {time.perf_counter() - t0:.1f}"
              f"s", flush=True)
        nb.join()
        if native_err:
            raise native_err[0]
        info = native.build_info
        print(f"build: native/ with {info.get('compiler')} "
              f"({info.get('version')}) in {info.get('seconds', 0.0):.1f}s "
              f"({native.ensure_built()})" if info else
              f"build: native/ built by an earlier process "
              f"({native.ensure_built()})", flush=True)
        for kname, info in lrn_cuda.build_info.items():
            print(f"build: {kname} {info['seconds']:.1f}s "
                  f"({info['path']})", flush=True)
            if not info["log"]:
                print(f"ptxas: {kname}: built by an earlier process, "
                      f"no report")
                continue
            table = ptxas_table(info["log"])
            for fn in table:
                print(f"ptxas: {kname}: " + json.dumps(fn))
            spilled = [fn["function"] for fn in table
                       if fn.get("spill_stores") or fn.get("spill_loads")]
            check(table and not spilled,
                  f"{kname}: ptxas reports spills in {spilled}")

    try:
        # phase 1: device and build
        timed("build", device_and_build)
        name = torch.cuda.get_device_name(0)
        card = card_line()
        # phase 2: every kernel against its plain version
        rows = timed("kernels", kernel_phase, card)
        # phase 3: the serving path
        serve, serve_launches = timed("serve", serve_phase, card, workdir)
        # phases 4 and 5: the training path
        # phase 4's run is also phase 6's resident run
        resident = {}
        train, alexnet_w = timed("train", train_phase, card, workdir,
                                 resident)
        train["f32_card_vs_cpu"] = timed("card_vs_cpu", card_vs_cpu_phase)
        train["f32_card_vs_cpu"]["seconds"] = phases["card_vs_cpu"]
        # phases 6 and 7: streaming, and preemption with resume
        stream = timed("stream", stream_phase, card, workdir, resident)
        del resident
        preempt = timed("preempt", preempt_phase, card, workdir)
        # phases 8-11: real data, the three small models, uint8 ingest
        data_dir = os.path.join(workdir, "data")
        stream_loads(stream)
        data = timed("data", data_phase, card, data_dir)
        timed("stream_gz", stream_gz, stream, card)
        mnist7, mnist7_w = timed("mnist7", mnist7_phase, card, data_dir)
        cifar10 = timed("cifar10", cifar10_phase, card, data_dir)
        quantized = timed("quantized", quantized_phase, card, workdir)
        # phases 12 and 13: BASELINE config #5
        mnist_ae, mnist_ae_w = timed("mnist_ae", mnist_ae_phase, card,
                                     data_dir)
        kohonen = timed("kohonen", kohonen_phase, card)
        # phases 14-18: the zoo's long tail, and the profiler
        layers = timed("layers", layers_phase, card)
        wine = timed("wine", wine_phase, card)
        mnist_rbm = timed("mnist_rbm", mnist_rbm_phase, card, data_dir)
        mnist_dbn = timed("mnist_dbn", mnist_dbn_phase, card, data_dir)
        profile = timed("profile", profile_phase, card, workdir, alexnet_w,
                        train, mnist7_w, mnist_ae_w)
        del alexnet_w, mnist7_w, mnist_ae_w
        torch.cuda.empty_cache()
        # phases 19-22: population-batched cohorts, the GA, ensembles
        cohort = timed("cohort", cohort_phase, card)
        som_cohort = timed("som_cohort", som_cohort_phase, card)
        ga = timed("ga", ga_phase, card, workdir, data_dir)
        ensemble = timed("ensemble", ensemble_phase, card, workdir,
                         data_dir)
        # phase 23: online learning on the served ensemble, the handoff
        online = timed("online", online_phase, card, workdir)
        # phase 24: the serving fleet
        fleet = timed("fleet", fleet_phase, card, workdir)
        # phase 25: data parallel
        dp = timed("dp", dp_phase, card, workdir, train)
        # phase 26: member-sharded cohorts and mesh serving
        mesh = timed("mesh", mesh_phase, card, workdir)
        # phase 27: the master--slave mode
        master_slave = timed("master_slave", master_slave_phase, card,
                             workdir)
        results = {"serve": serve, "train": train, "stream": stream,
                   "preempt": preempt, "data": data, "mnist7": mnist7,
                   "cifar10": cifar10, "quantized": quantized,
                   "mnist_ae": mnist_ae, "kohonen": kohonen,
                   "layers": layers, "wine": wine, "mnist_rbm": mnist_rbm,
                   "mnist_dbn": mnist_dbn, "profile": profile,
                   "cohort": cohort, "som_cohort": som_cohort, "ga": ga,
                   "ensemble": ensemble, "online": online, "fleet": fleet,
                   "dp": dp, "mesh": mesh, "master_slave": master_slave}
        # phase 28: the summary
        kernels = timed("summary", summary, rows, serve_launches, results,
                        dict(phases), card)
    except Exception:   # named by timed()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"total: {(time.perf_counter() - t_start) / 60:.2f} minutes")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def summary(rows, serve_launches, res: dict, phases: dict,
            card: str) -> list:
    """Print the ``phases`` line and each phase's JSON line (with its
    ``seconds``); the ``kernels`` line's entries."""
    launches = {}
    for k in ("lrn_fwd", "lrn_bwd"):
        launches[k] = {
            "train": res["train"]["launches"][k],
            "stream": res["stream"]["launches"][k],
            "resume": res["preempt"]["resumed_launches"][k],
            **_data_launches(k, res["mnist7"], res["cifar10"],
                             res["quantized"], res["mnist_ae"],
                             res["kohonen"], res["wine"], res["mnist_rbm"],
                             res["mnist_dbn"], res["profile"]),
            **_cohort_launches(k, res["cohort"], res["som_cohort"],
                               res["ensemble"]),
            **_online_launches(k, res["online"]),
            "fleet": res["fleet"]["launches"][k],
            "dp_rank0": res["dp"]["launches"][k][0],
            "dp_rank1": res["dp"]["launches"][k][1],
            "dp_nccl": res["dp"]["nccl"]["launches"][k],
            "mesh_cohort": res["mesh"]["cohort"]["launches"][k],
            "mesh_som": res["mesh"]["som"]["launches"][k],
            "master_slave": res["master_slave"]["launches"][k]}
    launches["lrn_fwd"] = dict(
        launches["lrn_fwd"], serve=serve_launches,
        export=res["train"]["export"]["launches"]["lrn_fwd"],
        mesh_serve=res["mesh"]["serve"]["lrn_fwd_launches"]["mesh"])
    kernels = [
        summary_kernel("lrn_fwd", "veles_tpu/ops/lrn_pallas.py:132", rows,
                       launches["lrn_fwd"], card),
        summary_kernel("lrn_bwd", "veles_tpu/ops/lrn_pallas.py:151", rows,
                       launches["lrn_bwd"], card)]
    for phase, r in res.items():
        r["seconds"] = phases[phase]
    # the scaling model (veles_tpu_torch/tools/scaling_model.py) on phase
    # 4's timed minibatch; its link rates are spec values
    from veles_tpu_torch.tools import scaling_model
    res["scaling"] = scaling_model.model(
        res["train"]["ms_per_train_minibatch"], card, TRAIN_BATCH)
    res["scaling"]["seconds"] = 0.0
    print("phases " + json.dumps(phases))
    for phase, r in res.items():
        print(f"{phase} " + json.dumps(r))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
