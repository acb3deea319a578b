#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA Hopper
card and check it. Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --serve-ab DIR`` instead serves the dense and
paged mixes of phases 6 and 6a with the port imported from DIR, a
checkout of another commit, and prints one JSON line: see ``serve_ab``.)

Phases, one line each; any failure raises and exits non-zero:

1. env     -- the card's name and power limit, torch and CUDA versions.
2. build   -- nvcc builds every kernel source under
              ``ray_tpu_torch/ops/csrc`` for sm_90a (one process per
              source, all started together); the compiler's register and
              spill report is printed per kernel, and the bf16 B1, B2 and
              B3 (tensor cores) must not spill and must fit two blocks on
              an SM. Every instantiation of C2, C4, C5 and C6 is printed
              with its registers, spills and resident blocks, and must not
              spill.
3. kernels -- each kernel against its plain PyTorch version on the card,
              in bf16 and f32, at the shapes the serving and training
              paths give it, with its time, the plain version's, the
              least time the card could take (bound) and one PyTorch
              library call's as a yardstick: B1 (flash forward; its and
              SDPA's device time from a CUDA graph of 50 calls, beside the
              wrapper's time per call with its host time), B2 (flash
              backward dK/dV) and B3 (flash backward dQ), each with its
              TFLOP/s; then B1-B3 at head dims 64 and 16
              (padded to 128 by the wrappers) and with the full mask at
              S=256; then B1 at the draft prefill's shapes (4 heads of 16,
              S 128, 256 and 512, f32 and bf16).
4. serve   -- Llama-3-8B at full width and 6 of its 32 layers
              (``SERVE_LAYERS``: the script's time limit; random
              weights from a seed, int8 weight-only,
              ``attn_impl="flash"``) answers 12
              requests from 4 client threads through ``LLMServer``; every
              prefill must have launched B1 once per layer.
5. parity  -- for 3 of those prompts the engine's greedy tokens equal the
              port's own ``generate`` on the same params.
6. profile -- device time by kernel over 8 more requests (torch.profiler),
              and the device's idle share of that window. Then the dense
              server takes the paged serve's traffic mix (below) without
              its prompts over 512 tokens, for figures beside the paged
              run's. One weight tree (seed 0) serves phases 4-6a, one
              server at a time, each quantizing it to int8.
6a. paged  -- the paged server at the same width and depth (block 16, a
              pool of 96 blocks against the dense equivalent's 512, prefix
              cache, host KV tier, preemption with no hold): 8 requests on
              a 256-token shared prefix, then two batch decodes and two
              chunked prompts of 700-900 tokens, then 8 more on the
              prefix, from four client threads. stats() must show prefix
              hits on every repeat, a prompt prefilled in two or more
              chunks, an admission queued for blocks, a spill to and a
              promote from the host tier, and a preemption; tok/s, TTFT
              and TPOT p50 beside the dense run's; the agreement with the
              dense run's tokens (and the top-2 logit gap at a first
              divergence); a profile window, with the indexing kernels'
              share of it (the pool gather's upper bound).
6b. spec   -- the mix's third-phase requests on a fresh paged server
              without a draft, then on a fresh one with the default
              random draft (2 layers, dim 64, head dim 16), spec_k 4, each
              after the same warm-up: tok/s of both, acceptance, B1
              launches = draft layers x draft prefills (none without the
              draft), also inside a profile window; then B1 on the q, k
              and v of real draft prefills at every bucket against its
              plain version.
6c. paged bitwise -- 4 layers at Llama-3-8B widths, bf16: paged decode =
              dense decode on the same contents at batch 8 (logits and
              rows), export -> adopt, preempt -> resume and tier promote
              -> in-pool history and tokens, each bit for bit.
6d. paged tokens -- the same widths in f32: the paged engine's greedy
              tokens equal the dense engine's and generate's (prefix
              hits, a chunked prompt, preempted and promoted requests),
              and the speculative server's equal the plain paged one's;
              B1 on that f32 draft's real prefills against its plain
              version.
6e. disagg -- a PrefillServer and a DecodeServer at full width and depth
              (int8, the paged server's engine config each) sharing the
              card in one process. Bitwise: 12 requests (8 on a 256-token
              shared prefix, 2 chunked prompts of 700-900 tokens, 2 short
              ones of 64-128), one at a time, all two-hop (prefill, export,
              adopt, decode), give the greedy tokens of a fresh monolithic
              paged server. Then the same mix from four client threads on
              a fresh pair, prompts of 256 tokens or more two-hop (each
              under its own trace_root), the rest to the decode server:
              tok/s, TTFT and TPOT p50, export and adopt ms and bytes per
              migration; gated: the token counter against the cost meters
              (each migrated first token counted on both hops, as in the
              reference), one tenant-ledger row per request, the importer's
              blocks and bytes, every two-hop span tree. A profile window
              over each server (half a second mix, split by hop). A speculative
              decode server adopting from the prefill server: B1 launches
              = draft layers x draft prefills, then B1 on an adopted
              request's real draft q/k/v. A fresh monolithic server on the
              same mix (tok/s, TTFT, TPOT, token agreement), which then
              donates a prompt's prefix chain to a fresh receiver: every
              exported block promoted, only the suffix prefilled, the
              donor's tokens. Last, the hooks' cost: HOOK_PAIRS (2) pairs
              of fresh servers with the cost meters on and off
              (serve_accounting_instrumentation), alternating which runs
              first, on the same mix: tok/s of each and their ratios.
6f. disagg gates -- 4 layers at Llama-3-8B widths: two-hop equal to one
              paged engine bit for bit in bf16, and in f32 also equal to
              generate; a speculative decode server adopting the prefill
              server's f32 checkpoints gives the paged engine's tokens; B1
              on that draft's real prefills.
6g. runtime -- the port's runtime: ``ray_tpu_torch.init()`` with no
              resource arguments must detect the card (GPU: 1, GPU-H100);
              the node must spawn only ``ray_tpu_torch.`` processes; a
              ``num_gpus=1, max_concurrency=8`` actor builds the serve
              phase's int8 server on its leased card (gpu ids [0],
              CUDA_VISIBLE_DEVICES "0", an H100, neither JAX nor the JAX
              package loaded) beside the same server in this process:
              equal weight fingerprints; the actor's greedy tokens for
              the 12 serve requests one at a time equal the serve phase's
              in-process tokens (6h holds its replicas to the same); the
              12-request mix from 4
              client threads in-process, actor, actor, in-process (tok/s,
              TTFT, TPOT, client latency; the actor's ratios); B1 in the
              actor = 32 x 12 over one mix; a second num_gpus=1 actor
              waits 3 s for the card and runs after the kill; a 64 MiB
              bf16 CUDA tensor round-trips through a GPU actor bit for
              bit; two num_gpus=0.5 tasks share id 0; a 1 GiB f32 CPU
              tensor's get lies over the store's memory; after shutdown no
              cluster process is left and the card's memory is back
              within 1 GiB.
6h. serve-app -- Serve on the port's runtime, on a fresh cluster (no
              resource arguments): ``build_routed_llm_app``, two Llama-3-8B
              int8 replicas of 0.5 GPU each behind the LLM router: the 12
              serve requests one at a time through the
              ``DeploymentHandle`` give the serve phase's tokens, then the
              mix from 4 client threads (tok/s, TTFT, TPOT, client latency
              as ratios to 6g's in-process and actor runs and the serve
              phase); B1 in the replicas = 32 x prefills (read through the
              controller's replica handles), both replicas routed,
              ``serve_replicas`` 2, and a span tree serve.request >
              serve.replica_call > llm.server_call > llm.request read back
              from the GCS. ``build_disagg_llm_app`` (a prefill and a
              decode replica, 6e's engine config): 6e's mix one at a time
              gives 6e's monolithic tokens, prompts of 256 tokens or more
              two-hop through the object store; the mix from 4 clients;
              its migrations' own store put (the prefill replica's
              return) and get (the decode replica's);
              redeployed with a speculative decode pool, B1 in it = draft
              layers x draft prefills. At 4 layers, bf16, paged: both
              replicas in the GCS prefix index, a repeat routed "scored" to
              the holder, a peer pull from a busy holder (every pulled
              block promoted, only the suffix prefilled, the holder's
              tokens), and a host tier smaller than a block demoting to
              the store and promoting back, a chain evicted whole (all
              of it promoted) and one evicted in part (its head run
              promoted, as in the reference), each with the tokens of a
              run without the tier at the same depth. The ingress, on
              the routed app's two replicas before its delete: the 12
              requests over HTTP through ``serve.start()``'s proxy, one
              at a time and from 4 clients, give the serve phase's
              tokens, B1 in the replicas = 16 x their prefills; one gRPC ``PREDICT`` gives
              the same tokens; ``/-/healthz``, ``/-/routes`` and a 404
              answer; neither proxy's process is listed by
              ``nvidia-smi`` or maps ``libcuda``; a stream toy's chunks
              come in order and a ``@serve.batch`` toy forms batches
              under 4 HTTP clients; HTTP against handle latency and
              tok/s are printed. After shutdown no cluster process is
              left (the proxies included) and the card's memory is back
              within 1 GiB.
6i. trainer -- (run after zero quant) Train on the port's runtime.
              First, in this process, ``run_pod_training`` at
              Llama-3-8B widths, 4 layers, bf16, flash attention,
              ``remat="dots"``, ZeRO
              (``weight_update="sharded"``) over 4 virtual ranks, batch
              4 x 1024 targets, 3 timed steps after the warmup step.
              Then a cluster (``init(num_gpus=1)``) and
              ``CudaTrainer(pod_train_loop, ScalingConfig(num_workers=1,
              use_gpu=True), CudaConfig(weight_update="sharded",
              mesh_axes={"data": 4}))`` with the same arguments, the
              worker's loop reporting beside the summary what it read in
              its process. Gates: the worker holds the GPU lease (gpu ids
              [0], CUDA_VISIBLE_DEVICES "0" from the raylet); its
              per-step losses equal the in-process ones bit for bit; its
              launch counts of B1, B2, B3, C2 and C3 equal the
              in-process call's and the step arithmetic's, none 0; the
              summary has its goodput block; the GCS step matrix holds
              one row per timed step for the worker and no stall; a
              ``tiny()`` bf16 train state on the card comes back through
              ``Checkpoint.from_pytree`` / ``to_pytree(device="cuda")``
              bit for bit and on the card; after shutdown no cluster
              process is left and the card's memory is back within
              1 GiB. Printed: cluster start, worker ready and fit wall
              seconds; tokens/s and MFU through the trainer and in
              process, and their ratio; the goodput ratio and the phase
              sums. Before step 0 the first batch's token min and max
              against the vocabulary; a failed in-process run prints its
              error's text, a failed ``fit()`` every worker's whole
              stderr, and either fails the phase as it was (nothing
              retries).
6j. collective -- (run after phase 10, qring) collectives across
              processes through ``util.collective``'s ``cuda`` backend: a
              cluster (``init(num_gpus=1)``) and two actors of 0.5 GPU,
              then four of 0.25 GPU (leases [0], CUDA_VISIBLE_DEVICES "0",
              no JAX module), joined by ``create_collective_group(...,
              backend="cuda")``; each rank launches its own part of C2,
              C3, C4 and C6 (``ring_rank_launch``) against its peers'
              memory opened through CUDA IPC, its stream ordered on their
              flag words. Gates: at 65536 rows a rank, n 2 and 4, f32 and
              bf16, every op, C2, C3, C4 and C6 bit for bit equal to the
              in-process kernel (a ``RingGroup`` in the rank's process)
              and the plain version on the stacked inputs; the split-phase
              rank calls of C1 (f32, bf16: one hop, the caller's block
              read where it lies into the right neighbour's staging) and
              C5 in place (f32, every hop of a reduce-scatter, two
              launches a hop: send, then receive after the peers' done
              words; its carry column) the same way; the host-level
              API on the card (allreduce, reducescatter held to C4 then
              the split, allgather, broadcast, reduce, barrier, send/recv)
              equal to its CPU path for the same seeds, every call counted
              on ``rtpu_collective_ops_total{op,backend="cuda",dtype}``;
              50 back-to-back calls alternating the four kinds, no result
              differing; exact rank-form launch counts. At full size (the
              ZeRO cell's flat bf16 gradient, 4 layers, per rank, C3 on
              its shard; C6 at the quantized ZeRO size, f32) a fixed
              sample of rows against the plain fold over them,
              regenerated from each rank's seed (C6: within the int8
              ring's error bound of the exact sum), and each kind's
              kernel time (CUDA events in rank 0), the call's wall and the
              staged bytes beside the in-process kernel's time and the
              library's (gloo's allreduce, allgather or reduce_scatter of
              the card tensors over the group's process group); one overlap
              chunk of each split-phase kind at full size (C1: a hop's
              block of the ZeRO cell, 939,026 rows of 128 bf16; C5: a
              reduce-scatter of the quantized cell's chunk, 619,526 rows
              of 128 f32 a hop), each hop's kernel time in rank 0, its
              call's wall and the staged bytes, a sample of rows held (C1
              equal to the left neighbour's, C5 within the int8 ring's
              bound of the exact sum), and C1's library call (gloo's send
              and receive of pinned host copies of the block). Then a
              stalled peer (one rank makes no second call) and a dead
              peer (its actor killed between two calls): every other rank
              raises within 10 s naming it; and a peer stalled inside C6
              past the ring's wait: every rank raises within 10 s, the
              stalled one finding the call voided by the others' expiry
              (no rank returns what the released streams left). The card's
              compute mode and the
              transport are printed; after shutdown no cluster process is
              left and the card's memory is back within 1 GiB.
6k. zero gang -- (run last, after 6i) ZeRO with one rank per process:
              ``parallel.zero`` over the gang's ``cuda`` collective group,
              each rank a ``CudaTrainer`` worker on a fraction of the card.
              First, in this process, the virtual-rank runs each gang
              route is held to. Then a cluster and
              ``CudaTrainer(ScalingConfig(num_workers=4, use_gpu=True,
              resources_per_worker={"CPU": 1, "GPU": 0.25}),
              CudaConfig(weight_update="sharded", mesh_axes={"data":
              4}))`` at 6i's arguments but 2 layers (``GANG_LAYERS``: four
              ranks at 4 layers do not fit the card): the monolithic route
              (C2 + C3) then ``overlap=True`` (C1 per hop) through
              ``run_pod_training``, from the same params in the same
              workers; then two workers of 0.5 GPU: the monolithic route
              at 4 layers, and at 1 layer ``quantized_grads`` (C6 + C3),
              ``error_feedback`` and the quantized overlap (C5 in place +
              C1), whose steps the loop builds over the gang's group.
              Gates: every rank's per-step losses and grad norms equal the
              in-process virtual ranks' bit for bit, every rank's final
              params fingerprint equal to theirs; each worker's launches
              of B1, B2, B3, C1, C2, C3, C5 and C6 equal the step
              arithmetic; each worker holds its fractional lease (gpu ids
              [0], CUDA_VISIBLE_DEVICES "0") and no JAX module; the GCS
              step matrix holds every worker's timed steps, no stall;
              after shutdown no cluster process is left and the card's
              memory is back within 1 GiB. Printed: step walls and
              tokens/s through the gang against in process, each rank's
              peak memory (torch's peak plus the ring's workspace) against
              the prediction, and the staging's share of a step (the rank
              forms' staged bytes and the host's time in the ring's calls,
              against the step wall). A failed ``fit()`` prints every
              worker's stderr.
6l. jobs    -- (run last, after 6k) the operator's plane: a cluster
              with the dashboard (``init(include_dashboard=True)``; its
              URL must be set and in the KV). A job submitted over HTTP
              (``JobSubmissionClient(dashboard_url)``) with a
              ``working_dir`` (an entrypoint, a helper module it imports
              and its inputs) and ``env_vars`` (depth, seed, and a
              ``CUDA_VISIBLE_DEVICES`` the raylet must undo) serves
              Llama-3-8B at 4 of 32 layers (``JOB_LAYERS``; int8, flash,
              buckets 128/256/512, seed 0) from a ``num_gpus=1`` actor: the
              first 4 of the serve phase's requests, one at a time. Gates:
              the job SUCCEEDED; its log over HTTP holds the tokens; they
              equal an in-process server's of the same depth and seed,
              built after the job let the card go; B1 launched once per
              layer and prefill in the actor; the dashboard head, the
              supervisor and the job's driver hold no CUDA context (not
              among nvidia-smi's compute apps, no libcuda mapped,
              ``CUDA_VISIBLE_DEVICES=""``) while the actor is listed.
              Then a second job's actor in a one-bundle placement group
              ({"CPU": 1, "GPU": 1}) serves without pause while the state
              views (jobs, tasks, placement groups, actors, memory,
              objects) and the dashboard (/api/cluster and /api/nodes GPU
              1, /metrics, /api/logs?actor_id=, /api/stacks, a 2 s
              /api/profile of the actor's worker) must show it;
              ``stop_job`` must kill the entrypoint's tree, read STOPPED
              and give the GPU back within 60 s, the actor's pid gone from
              the compute apps. Last, a ``num_gpus=1`` task in a pip env
              (a wheel built in the phase) runs B1 once at (1, 512, 32,
              128) bf16 causal within B1's limits, twice, from one venv
              under the manager's ``pip/`` with CUDA available. Printed:
              submit to SUCCEEDED, the job actor's first token, the venv's
              creation, stop to GPU free, the phase's time.
6m. transports -- (run last, after 6l) the driver's transports on one
              cluster (8 CPUs, the card) with a client server in it, each
              leg driving 6l's model (4 of 32 layers, int8, flash, seed
              0) on 6l's first 4 requests, its tokens held to 6l's
              in-process server's. (a) A thin client, a process with
              ``CUDA_VISIBLE_DEVICES=""``, connects with
              ``init(address="ray_tpu_torch://...")``, makes a
              ``num_gpus=1`` serving actor, sends the requests one at a
              time, kills the actor and exits. Gates: equal tokens; B1 16
              in the actor; the client maps no libcuda; the server holds
              no pin of it afterwards and the GPU is back within 60 s.
              (b) tokenize -> serve on a ``num_gpus=1`` actor ->
              detokenize as a DAG of three actors' methods, interpreted
              and compiled over shared-memory channels. Gates: equal
              tokens each way; B1 16 a pass; ``teardown()`` gives each
              stage's iterations; the GPU actor answers ``.remote()``
              after it; a stage that raises comes back as its error and
              the next execution succeeds. (c) The unchanged ``cpp/``
              demo, built with make into a temporary directory, against
              the client server with the reference's fixtures registered.
              Gates: exit 0, at least 14 lines, all PASS, the five
              ``cpp_*`` probes. (d) A three-step workflow whose middle
              step leases the card and runs B1 once at (1, 512, 32, 128)
              bf16; its last step fails on its first run, ``resume``
              ends it. Gates: the output equals a direct call of the
              three functions; the status goes RUNNING, FAILED, RUNNING,
              SUCCEEDED; one B1 launch across run and resume. Printed:
              the client's first-request latency and the p50 of the
              rest against 6l's in-process ones, the compiled and the
              interpreted DAG's p50 a one-token execution, each leg's
              seconds.
6n. autoscaler -- (run last, after 6m) ``python -m ray_tpu_torch up`` of a
              cluster YAML (the ``subprocess`` provider; a head type of 8
              CPUs and no GPU; a node type ``gpu.h100`` of
              ``node_config: {gpu: H100-1}``, 0 to 1 of it; idle timeout
              6 s) as a subprocess: the monitor and the head. The driver
              joins it, sees no GPU, and makes a ``num_gpus=1`` actor that
              serves 6l's model on 6l's 4 requests one at a time; its
              demand makes the autoscaler launch one GPU node on the card.
              Gates: exactly one node launched, labelled
              ``autoscaler-node-type: gpu.h100``, and the actor on it;
              tokens equal to 6l's in-process server's; B1 16 in the
              actor; the actor maps libcuda, the head's GCS and raylet and
              the monitor do not; once the actor is killed, the node is
              terminated within 60 s, ``GPU`` leaves the cluster, the
              card's memory is back and no process of the session is a
              compute app; ``python -m ray_tpu_torch down`` leaves no
              process of the session. The head runs with a lease deadline
              of 3 s (``worker_lease_timeout_ms``), below the node's join:
              the actor waits past it while the monitor reads its demand,
              with one ACTOR_PENDING warning. Printed: demand to launch,
              to join and to the actor ready, the first request and the
              later p50, kill to scale-down, the phase's time.
6o. device observability -- in process, on phase 4's dense server after
              its traffic (``phase_programs``): one tick trace, one insert
              trace per bucket its inserts used, ``trace_count`` within the
              reference's bound; the tick and insert rows name spec
              ``h100`` and measurement ``gpu``; the insert's counted FLOPs
              at bucket 128 within 1% of the analytic count (matmuls plus
              B1's formula plus the lm-head row); a sampled tick's MFU and
              MBU in (0, 1.05], printed with its verdict. Then (run last,
              after 6n) a cluster (8 CPUs, the card, the dashboard) with a
              ``num_gpus=1`` actor serving the serve phase's model (6 of
              32 layers, int8, flash, seed 0): four requests, the third
              wholly inside ``util.state.tpu_profile(actor_id=...,
              duration=3)``. Gates: the Chrome trace holds as many B1
              kernel events as the actor's ``flash_fwd_cuda.launches``
              rose for that request; ``xla_summary()`` and
              ``/api/programs`` list the actor's engine programs
              (``gpu``); its ``device_hbm_used_bytes`` on ``/metrics``
              within 5% of its allocator's in-use bytes and
              ``device_hbm_total_bytes`` the card's total; the head's GCS,
              raylet and dashboard map no libcuda. Last, with the actor
              gone, a ``num_gpus=1`` task in a ``container`` env through a
              stand-in runtime (``RAY_TPU_CONTAINER_RUNTIME``) runs B1 once
              at (1, 512, 32, 128) bf16 within B1's limits, its command
              passing ``-e CUDA_VISIBLE_DEVICES=0`` and ``--gpus all``.
7. train   -- f32 checks first: flash against plain attention at dim
              256 (head dim 128) and at ``LlamaConfig.tiny()`` (head dim
              16), which also trains one step with exact B1-B3 counts.
              Llama-3-8B widths at 4 layers (bf16 params, flash
              attention, ``remat="dots"``, fused loss, AdamW) trains 6
              steps of batch 4 x 1024 tokens through ``build_train_step``,
              then one step with ``grad_accum=2``: finite losses and grad
              norms, and launch counts of B1 (twice per layer and
              micro-step: forward and remat), B2 and B3 (once each).
              Step time, tokens/s, MFU, peak memory and the device time
              of one profiled step by kernel group. Before the steps,
              flash against plain attention on the initial params and the
              first batch: the loss and every gradient leaf within a
              relative L2 tolerance.
8. ring    -- (run after phase 3) the ring collectives C1-C4
              (``ring.cu``) bitwise against their plain versions at ring
              sizes 2, 4 and 8, f32, bf16, f16 and int32, sum and max,
              ragged and large per-rank blocks, and the split-phase forms
              (C1 per hop) against C2 and C3; C3 also at 16 ranks, into a
              caller's ``out`` and with each shard already lying in its
              place of ``out``; C4 at 16 ranks with every op (sum, max,
              min, prod) and type; the same at the ZeRO path's
              size (the 4-layer flat parameter vector, 4 ranks, bf16),
              and the four kernels' times beside their plain versions',
              bounds and one library call's; C2 must leave its input as
              it was.
9. zero    -- f32 at dim 256: ZeRO at 2 ranks bitwise equal to plain
              data parallelism through C4, ZeRO at 4 ranks against the
              one-device step. Then Llama-3-8B widths at 4 layers through
              ``build_zero_train_step`` over 4 virtual ranks (batch 4 x
              1024, one row per rank): 3 monolithic steps (C2 + C3, one
              launch each per step), one profiled step, then 3 steps with
              ``overlap=True`` (C1, 24 launches per step) from the same
              params: finite losses and grad norms, exact launch counts,
              every rank's copy equal to rank 0's, overlap within bf16
              re-association of monolithic; step time, tokens/s, peak
              memory and the ring kernels' share of a profiled step.
10. qring  -- (run after phase 8) the int8 ring C5 and C6 (``ring.cu``)
              bitwise against their plain versions at ring sizes 2, 4 and
              8, f32, for a ragged block, exactly 1024 elements and a large
              block per rank, each with random data, an all-zero chunk
              (the 1e-30 scale floor) and a chunk whose max sits in one
              block (the per-rank barrier): C6 through
              ``quantized_ring_allreduce``, C5 alone and through the
              split-phase int8 reduce-scatter. C5's in-place form (the
              split-phase hop, its scale carried from the hop before)
              hop by hop against its plain version, buffer and carry
              table, at ring sizes 2, 3, 4, 8 and 16; two reduce-scatters
              interleaved as the overlap path issues them; a missing carry
              stops the kernel and the group raises. The fallback ladder
              (f64, a small call, ``precision="bf16"``) takes C4, not C6.
              At the quantized ZeRO size (the 1-layer flat vector, 4
              ranks, f32) C6 in place, C5 on one overlap hop and C5 in
              place on one overlap chunk bitwise, and the kernels' times
              beside their plain versions', bounds and yardsticks
              (``x.sum(0)``, ``torch.roll``, and for the in-place form
              the split-phase hop as tensor ops around C5).
11. zero quantized -- f32 at dim 256, 2 and 4 ranks: the int8 ZeRO step
              (monolithic, overlap, error feedback) through C5 / C6 equal
              to the same steps through the plain versions bit for bit.
              Then Llama-3-8B widths at 1 layer over 4 virtual ranks with
              ``quantized_grads=True``: 3 monolithic steps (C6 + C3), 3
              with ``error_feedback=True``, 3 with ``overlap=True`` (C5
              and C1 per hop), each from the same params and followed by
              one profiled step: finite losses and grad norms, the first
              loss equal to the exact step's, exact launch counts, every
              rank's copy equal to rank 0's, ``ef`` finite, f32 and
              non-zero. Recorded, not gated: step time, tokens/s, peak
              memory, C5/C6's share of a profiled step, and the first
              step's int8 gradient shard against the exact reduce-scatter
              (relative L2, share of elements sent as 0).

Every profiled window (serve, train, each ZeRO route) is one
torch.profiler window with no schedule that must hold every event: it
fails if the profiler warns that it cleared or dropped events, if the
device was occupied (the union of its kernels' intervals, which kernels
on two streams overlap) longer than the window's wall time, or if the
trace holds
another number of launches of a hand-written kernel than its wrapper
counted. Each window opens with 2000 marker kernels that take the
profiler's loss of a window's first device records (a number that grows
over the run) and must not all be lost.

Then one JSON line of per-kernel numbers, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero before printing any result. It needs nothing but
the repository (no network) and stops every process it starts.
"""

from __future__ import annotations

import dataclasses
import gc
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its operations over the tensor-core rate of its type and its
# bytes over the memory rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# Kernel B1 against its plain version on the same inputs, at every shape.
# bf16 O: the two round P to bf16 at different points (the kernel per
# 64-key tile against a running max, the plain version against the row's
# final max) and both round O to bf16, so an element may land one bf16
# ulp apart, and one ulp is at most 2**-7 of the value. So each element is
# held to TOL_O_BF16_ABS + 2**-7 * |plain|. The card read a max abs error
# of 0.0039 at every shape, one ulp for |O| in [0.5, 1), against a limit
# there of 0.008 to 0.012; a typical |O| of a late row at S = 512 is about
# 0.07 to 0.1 for randn inputs, where the limit is about 0.0045.
# f32 O: nothing is rounded to a narrower type, so only summation order
# differs (the card read 4.8e-7). The f32 instantiation runs the same
# template code, so this limit holds the P.V product and the
# normalisation tightly at every shape.
# LSE is f32 on both sides (the card read at most 9.5e-7).
TOL_O_BF16_ABS, TOL_O_BF16_REL = 4e-3, 2.0 ** -7
TOL_O_F32 = 1e-4
TOL_LSE = 1e-4

# Kernels B2 and B3 against flash_attention_bwd_plain on the same inputs.
# Each gradient element is held to A * max|plain| + R * |plain|, with the
# scale of the gradient (which grows with S) taken from the plain result.
# bf16: the kernels and the plain version round P and dS to bf16 at the
# same places, but their f32 sums run in different orders, so a P or dS
# element near a rounding boundary may land one bf16 ulp apart, and the
# outputs are rounded to bf16 (one ulp is at most 2**-7 of the value):
# A = 2**-8, R = 2**-7, the bound the CPU tests hold the port's plain
# version to against the JAX package's kernels. f32: nothing is rounded
# to a narrower type and the f32 kernels run full f32 FMAs, so only
# summation order differs: A = 1e-5, R = 0 (the card read at most 1e-6).
TOL_BWD = {torch.bfloat16: (2.0 ** -8, 2.0 ** -7), torch.float32: (1e-5, 0.0)}

N_HEADS, HEAD_DIM = 32, 128
# (batch, S, causal): B1 at the serving path's prefill buckets, a ragged
# length, a full mask, the ZeRO path's per-rank shape, a long ragged
# length, and the training shape.
KERNEL_SHAPES = [(1, 128, True), (1, 256, True), (1, 512, True),
                 (1, 200, True), (1, 256, False), (1, 1024, True),
                 (1, 1000, True), (4, 1024, True)]
# (batch, S) for B2 and B3, causal: B = 1 at short, mid and training
# length and one ragged length, then the training shape itself.
BWD_SHAPES = [(1, 128), (1, 512), (1, 1024), (1, 1000), (4, 1024)]
# Head dims below the kernels' 128, which the wrappers pad (LlamaConfig.tiny
# has 16), checked at (1, PADDED_SEQ) through B1, B2 and B3, causal; and
# the full mask at 128 (flash_attention takes it at S % 128 == 0).
PADDED_HEAD_DIMS, PADDED_SEQ = (64, 16), 256
# The train phase: Llama-3-8B widths at the depth of the reference's own
# training geometry (bench.py: 4 layers, batch x 1024, bf16 params,
# flash, remat "dots"), fused loss, optax.adamw(1e-4)'s settings. Token
# rows are SEQ + 1 long so the model sees SEQ positions after the shift.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4, 1024, 6
# Flash against plain attention at those widths, both in bf16: plain
# attention rounds its scores to bf16 before the softmax and the kernels
# keep them in f32, so the two differ at bf16 rounding. Each gradient
# leaf is held to a relative L2 distance of 5e-2 and the loss to 1e-2.
TOL_PARITY_GRAD, TOL_PARITY_LOSS = 5e-2, 1e-2
# The same comparison in f32 at a narrow width: only summation order.
TOL_PARITY_F32 = 1e-4
ENGINE = {"num_slots": 8, "max_seq_len": 1024,
          "prefill_buckets": (128, 256, 512)}
N_REQUESTS, N_CLIENTS, N_PARITY = 12, 4, 3
# The served model's depth (of Llama-3-8B's 32): every serving phase
# (4-6h) runs it, so it sets most of the script's time, which must stay
# within its limit (1200 s with the build).
SERVE_LAYERS = 6


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after warm-up, from CUDA events."""
    for _ in range(3):
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


# How B1's times are taken, stated in its row of the kernels line.
TIMED_BY_GRAPH = ("ms and library_ms: device time of one call, from a CUDA "
                  "graph of 50 calls, no host time (graph_ms); call_ms: CUDA "
                  "events around 50 back-to-back calls, host time included, "
                  "as every other kernel's ms (time_ms)")


def graph_ms(fn, iters: int) -> float:
    """Mean device time of one ``fn`` call, from CUDA events around one
    replay of a CUDA graph that holds ``iters`` calls: the host's time per
    call (Python, ctypes, allocation) stays out of it, so a kernel shorter
    than its caller's overhead is timed by the device's work. Capturing
    runs the wrappers, so each captured call adds one to its wrapper's
    launch count; the replays add nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def attention_flops(B, S, H, D, causal):
    """The operations of one attention forward: two products of 2 * D
    flops per visible (query, key) pair (causal: S(S+1)/2 per head)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4.0 * B * H * D * pairs


def attention_bound(B, S, H, D, causal, dtype):
    """(bound_ms, bound_by) for one attention forward: each input read
    once, O and LSE written once; the products this input needs
    (``attention_flops``)."""
    flops = attention_flops(B, S, H, D, causal)
    nbytes = 4 * B * S * H * D * torch.finfo(dtype).bits // 8 + 4 * B * H * S
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ptxas_kernels(report: str) -> dict:
    """{mangled kernel name: {"registers", "spill_bytes"}} from an
    ``nvcc -Xptxas -v`` report (spill bytes: stores plus loads)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$.]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": None, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


# The tensor-core (bf16) flash kernels: (name in the compiler's report,
# blocks_per_sm's key). Each must not spill and must fit 2 blocks per SM.
TC_KERNELS = (("flash_fwd_kernel", "fwd"), ("flash_bwd_dkv_kernel", "dkv"),
              ("flash_bwd_dq_kernel", "dq"))


def phase_build():
    """Build every kernel source; print and return each kernel's
    registers and spills from the compiler's report. Fails if a
    tensor-core flash kernel spills or fits fewer than 2 blocks per SM."""
    from ray_tpu_torch.ops import _build

    names = _build.all_kernels()
    t0 = time.perf_counter()
    _build.build(names)
    log("build", f"nvcc sm_90a {names} in {time.perf_counter() - t0:.1f} s")
    kernels = {}
    for name in names:
        found = ptxas_kernels(_build.build_log(name))
        kernels.update(found)
        regs = sorted({k["registers"] for k in found.values()
                       if k["registers"] is not None})
        spills = {n: k["spill_bytes"] for n, k in found.items()
                  if k["spill_bytes"]}
        log("build", f"{name}: {len(found)} kernels, registers {regs}, "
            f"spills {spills or 'none'}")
    for name, key in TC_KERNELS:
        report = kernel_report(kernels, name)
        blocks = blocks_per_sm(key, torch.bfloat16)
        log("build", f"{name} (bf16): {report['registers']} registers, "
            f"{report['spill_bytes']} spill bytes, {blocks} blocks per SM")
        check(report["spill_bytes"] == 0 and blocks >= 2,
              f"{name} (bf16): {report['spill_bytes']} spill bytes, "
              f"{blocks} blocks per SM")
    return kernels


def kernel_report(kernels: dict, name: str) -> dict:
    """The report of the one kernel whose mangled name holds ``name``."""
    hits = [v for k, v in kernels.items() if name in k]
    check(len(hits) == 1, f"{len(hits)} kernels named {name} in the "
          f"compiler's report")
    return hits[0]


def blocks_per_sm(kernel: str, dtype) -> int:
    """Blocks of B1 ("fwd"), B2 ("dkv") or B3 ("dq") resident on one SM
    at once, from the CUDA runtime's occupancy calculator."""
    import ctypes

    from ray_tpu_torch.ops import _build

    code = 0 if dtype == torch.float32 else 1
    n = ctypes.c_int(0)
    if kernel == "fwd":
        fn = _build.load("flash_fwd").flash_fwd_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        args = (code, ctypes.byref(n))
    else:
        fn = _build.load("flash_bwd").flash_bwd_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        args = (0 if kernel == "dkv" else 1, code, ctypes.byref(n))
    fn.restype = ctypes.c_int
    err = fn(*args)
    check(err == 0, f"occupancy query failed ({err})")
    return n.value


# The ring kernels whose every instantiation the build phase reports
# (registers, spills, resident blocks) and holds free of spills: (ID,
# name in the compiler's report, ring.cu's kind code). C2 and C4 have one
# per element type and op (16), C5 and C6 one each.
RING_REPORTED = (("C2", "ring_reduce_scatter_kernel", 1),
                 ("C4", "ring_allreduce_kernel", 3),
                 ("C5", "ring_qhop_kernel", 4),
                 ("C6", "ring_qallreduce_kernel", 5))
# Template arguments in a mangled ring kernel name: element type (as the
# compiler mangles it) -> (label, ring.cu's dtype code); op digit -> op.
_MANGLED_TYPES = {"f": ("f32", 0), "13__nv_bfloat16": ("bf16", 1),
                  "6__half": ("f16", 2), "i": ("int32", 3)}
_RING_OP_NAMES = ("sum", "max", "min", "prod")


def ring_instances(kernels: dict) -> dict:
    """{ID: [{"dtype", "op", "registers", "spill_bytes", "blocks_per_sm",
    "resident_blocks"}, ...]} for every instantiation of the kernels of
    RING_REPORTED in the compiler's report; resident blocks are blocks per
    SM (the runtime's occupancy calculator, as ring_launch asks it) times
    the SMs, the most blocks one cooperative launch of n ranks may hold."""
    import ctypes

    from ray_tpu_torch.util.collective import ring as R

    lib = R._lib()
    lib.ring_blocks_per_sm.restype = ctypes.c_int
    lib.ring_blocks_per_sm.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for key, name, kind in RING_REPORTED:
        rows = []
        for mangled, rep in kernels.items():
            if name not in mangled or rep["registers"] is None:
                continue      # another kernel, or a device function
            m = re.search(name + r"I(\w+?)Li(\d)E", mangled)
            dtype, code = _MANGLED_TYPES[m.group(1)] if m else ("f32", 0)
            op = int(m.group(2)) if m else 0
            per_sm = ctypes.c_int(0)
            err = lib.ring_blocks_per_sm(kind, op, code, ctypes.byref(per_sm))
            check(err == 0, f"{key} occupancy query failed ({err})")
            rows.append({"dtype": dtype, "op": _RING_OP_NAMES[op],
                         "registers": rep["registers"],
                         "spill_bytes": rep["spill_bytes"],
                         "blocks_per_sm": per_sm.value,
                         "resident_blocks": per_sm.value * sms})
        out[key] = sorted(rows, key=lambda r: (r["dtype"], r["op"]))
    return out


def phase_ring_build(kernels: dict) -> dict:
    """Print the registers, spills and resident blocks of every C2, C4, C5
    and C6 instantiation; fail if one spills, or if C2 or C4 has not one
    per element type and op (16) or C5 or C6 not exactly one. Also fail
    unless C1-C4 ask for no comm slots and the int8 ring (C5 in both
    forms, C6) for two int8 chunks and two f32 scales a block, per rank
    (``ring.cu``'s ``ring_slot_bytes``)."""
    from ray_tpu_torch.util.collective import ring as R

    lib, chunk = R._lib(), 4096
    for n in (2, ZERO_N, R.MAX_RANKS):
        for code, kind in enumerate(R.KINDS):
            want = (n * (2 * chunk + 2 * R.MAX_BLOCKS_PER_RANK * 4)
                    if kind in ("qhop", "qallreduce", "qrs_hop") else 0)
            got = lib.ring_slot_bytes(code, n, chunk)
            check(got == want, f"{kind} asks for {got} bytes of comm slots "
                  f"at n={n}, {chunk} elements a chunk; want {want}")
    log("build", f"comm slots: C1-C4 ask for none; the int8 ring for two "
        f"int8 chunks and {2 * R.MAX_BLOCKS_PER_RANK} f32 scales a rank")
    found = ring_instances(kernels)
    for key, rows in found.items():
        for r in rows:
            log("build", f"{key} {r['dtype']} {r['op']}: {r['registers']} "
                f"registers, {r['spill_bytes']} spill bytes, "
                f"{r['blocks_per_sm']} blocks per SM, {r['resident_blocks']} "
                f"resident blocks")
        spills = [r for r in rows if r["spill_bytes"]]
        check(not spills, f"{key} spills: {spills}")
        check(len(rows) == (16 if key in ("C2", "C4") else 1),
              f"{len(rows)} instantiations of {key} in the compiler's report")
    return found


def ring_build_fields(rows: list) -> dict:
    """The build numbers of a ring kernel's row of the kernels line."""
    return {"registers": max(r["registers"] for r in rows),
            "spills": max(r["spill_bytes"] for r in rows),
            "blocks_per_sm": min(r["blocks_per_sm"] for r in rows),
            "resident_blocks": min(r["resident_blocks"] for r in rows),
            "instances": rows}


def phase_kernels(dev):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def qkv(B, S, dtype):
        return [torch.randn((B, S, N_HEADS, HEAD_DIM), generator=gen,
                            device=dev, dtype=dtype) for _ in range(3)]

    rows = []
    for B, S, causal in KERNEL_SHAPES:
        q, k, v = qkv(B, S, torch.float32)
        o, lse = attention.flash_fwd_cuda(q, k, v, causal)
        po, plse = attention.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err_f32 = (o - po).abs().max().item()
        err_lse_f32 = (lse - plse).abs().max().item()
        check(err_f32 <= TOL_O_F32 and err_lse_f32 <= TOL_LSE,
              f"flash_fwd f32 S={S} causal={causal}: O err {err_f32}, "
              f"LSE err {err_lse_f32}")

        q, k, v = qkv(B, S, torch.bfloat16)
        o, lse = attention.flash_fwd_cuda(q, k, v, causal)
        po, plse = attention.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        diff = (o.float() - po.float()).abs()
        err_o = diff.max().item()
        # Share of the elementwise limit used by the worst element (<= 1).
        used = (diff / (TOL_O_BF16_ABS + TOL_O_BF16_REL
                        * po.float().abs())).max().item()
        err_lse = (lse - plse).abs().max().item()
        check(bool(torch.isfinite(o.float()).all()), "non-finite O")
        check(used <= 1.0 and err_lse <= TOL_LSE,
              f"flash_fwd S={S} causal={causal}: O err {err_o} "
              f"({used:.2f} of the limit), LSE err {err_lse}")
        # The kernel's and SDPA's device time from a CUDA graph: at the
        # serving shapes the wrapper's host time per call (call_ms) is
        # longer than the kernel, so back-to-back calls would time the host.
        ms = graph_ms(lambda: attention.flash_fwd_cuda(q, k, v, causal), 50)
        call_ms = time_ms(lambda: attention.flash_fwd_cuda(q, k, v, causal),
                          50)
        plain_ms = time_ms(
            lambda: attention.flash_attention_plain(q, k, v, causal), 20)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 50)
        bound_ms, bound_by = attention_bound(B, S, N_HEADS, HEAD_DIM,
                                             causal, torch.bfloat16)
        tflops = attention_flops(B, S, N_HEADS, HEAD_DIM, causal) / ms / 1e9
        rows.append({"B": B, "S": S, "causal": causal, "max_abs_err": err_o,
                     "lse_max_abs_err": err_lse, "tol_used": used,
                     "f32_max_abs_err": err_f32,
                     "f32_lse_max_abs_err": err_lse_f32, "ms": ms,
                     "tflops": tflops, "call_ms": call_ms,
                     "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})
        log("kernels", f"flash_fwd bf16 B={B} H={N_HEADS} D={HEAD_DIM} S={S} "
            f"{'causal' if causal else 'full'}: O err {err_o:.3g} "
            f"({used:.2f} of tol {TOL_O_BF16_ABS} + 2^-7 |plain|), LSE err {err_lse:.3g} (tol {TOL_LSE}), "
            f"f32 O err {err_f32:.3g} (tol {TOL_O_F32}), f32 LSE err "
            f"{err_lse_f32:.3g}; "
            f"kernel {ms:.5f} ms = {tflops:.1f} TFLOP/s (a call "
            f"{call_ms:.4f} ms with its host time), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}), sdpa "
            f"{lib_ms:.5f} ms")
    check(attention.flash_fwd_cuda.launches > 0, "flash_fwd never launched")
    return rows


def bwd_flops(B, S, H, D, products):
    """The operations of one causal backward kernel: ``products`` products
    of 2 * D flops per visible (query, key) pair, S(S+1)/2 per head."""
    return 2.0 * D * products * B * H * (S * (S + 1) // 2)


def bwd_bound(B, S, H, D, dtype, products, n_out):
    """(bound_ms, bound_by) for one causal backward kernel: its
    operations (``bwd_flops``); bytes of q, k, v, dO read once, LSE and
    delta (f32) read once and ``n_out`` gradients written once."""
    flops = bwd_flops(B, S, H, D, products)
    elem = torch.finfo(dtype).bits // 8
    nbytes = (4 + n_out) * B * S * H * D * elem + 2 * B * H * S * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def held(got, want, dtype):
    """(max abs error, share of the elementwise limit A * max|want| +
    R * |want| that the worst element uses) for one gradient."""
    a, r = TOL_BWD[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    limit = a * w.abs().max() + r * w.abs()
    return diff.max().item(), (diff / limit).max().item()


def phase_bwd_kernels(dev):
    """B2 and B3 against flash_attention_bwd_plain on the card, in bf16
    and f32, on the O and LSE that B1 gives for random q, k, v and a
    random dO; then the time of each kernel, of the plain backward (which
    computes dQ, dK and dV together), and of SDPA's backward (its dQ, dK
    and dV from torch.autograd.grad of an SDPA output, forward excluded),
    in bf16."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for B, S in BWD_SHAPES:
        row = {"B": B, "S": S, "causal": True}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = [torch.randn((B, S, N_HEADS, HEAD_DIM),
                                       generator=gen, device=dev,
                                       dtype=dtype) for _ in range(4)]
            o, lse = attention.flash_fwd_cuda(q, k, v, True)
            delta = attention.attention_delta(o, do)
            dk, dv = attention.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
            dq = attention.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
            pdq, pdk, pdv = attention.flash_attention_bwd_plain(
                q, k, v, o, lse, do)
            torch.cuda.synchronize()
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            for g, w, what in ((dk, pdk, "dk"), (dv, pdv, "dv"),
                               (dq, pdq, "dq")):
                check(bool(torch.isfinite(g.float()).all()),
                      f"non-finite {what} at B={B} S={S} {name}")
                err, used = held(g, w, dtype)
                row[f"{name}_{what}_err"], row[f"{name}_{what}_used"] = (
                    err, used)
                check(used <= 1.0, f"flash backward {what} {name} B={B} "
                      f"S={S}: max abs err {err:.3g}, {used:.2f} of the "
                      f"limit {TOL_BWD[dtype]}")
        # bf16 q, k, v, dO, O, LSE from the last pass of the loop.
        ms_dkv = time_ms(lambda: attention.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta), 20)
        ms_dq = time_ms(lambda: attention.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta), 20)
        plain_ms = time_ms(lambda: attention.flash_attention_bwd_plain(
            q, k, v, o, lse, do), 5)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 20)
        b2 = bwd_bound(B, S, N_HEADS, HEAD_DIM, torch.bfloat16, 4, 2)
        b3 = bwd_bound(B, S, N_HEADS, HEAD_DIM, torch.bfloat16, 3, 1)
        tf2 = bwd_flops(B, S, N_HEADS, HEAD_DIM, 4) / ms_dkv / 1e9
        tf3 = bwd_flops(B, S, N_HEADS, HEAD_DIM, 3) / ms_dq / 1e9
        row.update({"dkv_ms": ms_dkv, "dq_ms": ms_dq, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "dkv_bound_ms": b2[0],
                    "dkv_bound_by": b2[1], "dq_bound_ms": b3[0],
                    "dq_bound_by": b3[1], "dkv_tflops": tf2,
                    "dq_tflops": tf3})
        rows.append(row)
        log("kernels", f"flash_bwd B={B} H={N_HEADS} D={HEAD_DIM} S={S} "
            f"causal: bf16 err dk {row['bf16_dk_err']:.3g} "
            f"({row['bf16_dk_used']:.2f} of limit), dv "
            f"{row['bf16_dv_err']:.3g} ({row['bf16_dv_used']:.2f}), dq "
            f"{row['bf16_dq_err']:.3g} ({row['bf16_dq_used']:.2f}); f32 "
            f"err dk {row['f32_dk_err']:.3g} ({row['f32_dk_used']:.2f}), "
            f"dv {row['f32_dv_err']:.3g} ({row['f32_dv_used']:.2f}), dq "
            f"{row['f32_dq_err']:.3g} ({row['f32_dq_used']:.2f}); B2 "
            f"{ms_dkv:.4f} ms = {tf2:.1f} TFLOP/s (bound "
            f"{b2[0] * 1e3:.2f} us, {b2[1]}), B3 {ms_dq:.4f} ms = "
            f"{tf3:.1f} TFLOP/s (bound {b3[0] * 1e3:.2f} us, {b3[1]}), "
            f"plain backward {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} "
            f"ms")

    # The gradient that reaches attention may be a strided view: through
    # the autograd Function it must give what its contiguous copy gives.
    B, S = 1, 512
    q, k, v = (torch.randn((B, S, N_HEADS, HEAD_DIM), generator=gen,
                           device=dev, dtype=torch.bfloat16
                           ).requires_grad_(True) for _ in range(3))
    out = attention.flash_attention(q, k, v, causal=True)
    g = torch.randn((B, N_HEADS, S, HEAD_DIM), generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    strided = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    dense = torch.autograd.grad(out, (q, k, v), g.contiguous())
    check(not g.is_contiguous()
          and all(torch.equal(a, b) for a, b in zip(strided, dense)),
          "a strided dO gave other gradients than its contiguous copy")
    log("kernels", "flash_bwd: a strided dO gives the gradients of its "
        "contiguous copy, bit for bit")
    return rows


def b1_used(o, lse, po, plse, dtype):
    """The shares of B1's limits that O and LSE use against the plain
    version's: O to TOL_O_F32 in f32, to TOL_O_BF16_ABS + TOL_O_BF16_REL
    |plain| in bf16; LSE to TOL_LSE."""
    diff = (o.float() - po.float()).abs()
    if dtype == torch.float32:
        used_o = diff.max().item() / TOL_O_F32
    else:
        used_o = (diff / (TOL_O_BF16_ABS + TOL_O_BF16_REL
                          * po.float().abs())).max().item()
    return used_o, (lse - plse).abs().max().item() / TOL_LSE


def phase_head_dims(dev):
    """B1, B2 and B3 at head dims below 128 (the wrappers pad them with
    zeros and scale by the unpadded 1/sqrt(D)), causal, and at 128 with
    the full mask, against the plain versions, in f32 and bf16, to the
    limits of the full-width checks. Returns {case: the largest share of
    its limit any output used}."""
    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    used_by_dim = {}
    cases = [(D, True) for D in PADDED_HEAD_DIMS] + [(HEAD_DIM, False)]
    for D, causal in cases:
        worst = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = [torch.randn((1, PADDED_SEQ, N_HEADS, D),
                                       generator=gen, device=dev,
                                       dtype=dtype) for _ in range(4)]
            o, lse = attention.flash_fwd_cuda(q, k, v, causal)
            po, plse = attention.flash_attention_plain(q, k, v, causal)
            delta = attention.attention_delta(o, do)
            dk, dv = attention.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                  causal)
            dq = attention.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                             causal)
            pdq, pdk, pdv = attention.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            check(o.shape == q.shape and dq.shape == q.shape
                  and dk.shape == k.shape and dv.shape == v.shape,
                  f"head dim {D}: outputs not sliced back to D")
            used = list(b1_used(o, lse, po, plse, dtype)) + [
                held(g, w, dtype)[1]
                for g, w in ((dq, pdq), (dk, pdk), (dv, pdv))]
            mask = "causal" if causal else "full"
            check(max(used) <= 1.0, f"head dim {D} {mask} {dtype}: shares "
                  f"of the limits (O, LSE, dQ, dK, dV) {used}")
            worst = max(worst, max(used))
        used_by_dim[f"{D} {mask}"] = worst
        log("kernels", f"head dim {D}"
            + (" (padded to 128)" if D < HEAD_DIM else "")
            + f", B=1 S={PADDED_SEQ} {mask}, f32 and bf16: B1 O and LSE, "
            f"B2 dK dV, B3 dQ within their limits (at most {worst:.2f} of "
            f"one)")
    return used_by_dim


def phase_draft_b1(dev):
    """B1 at the draft prefill's shapes, [1, Pb, heads, head dim] of the
    default draft (``draft_config_for`` of the served model: 4 heads of
    16, padded to 128), causal, at every prefill bucket Pb, in f32 (the
    f32 token gate's draft) and bf16 (the full-width draft), against the
    plain version to the limits of the full-width checks. Returns
    {case: the larger share of its limit O or LSE used}."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm.disagg.spec import draft_config_for

    dc = draft_config_for(serve_config())
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    used = {}
    for Pb in ENGINE["prefill_buckets"]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = [torch.randn((1, Pb, dc.n_heads, dc.head_dim),
                                   generator=gen, device=dev, dtype=dtype)
                       for _ in range(3)]
            o, lse = attention.flash_fwd_cuda(q, k, v, True)
            po, plse = attention.flash_attention_plain(q, k, v, True)
            torch.cuda.synchronize()
            case = f"{Pb} {str(dtype).rsplit('.', 1)[-1]}"
            shares = b1_used(o, lse, po, plse, dtype)
            check(o.shape == q.shape and max(shares) <= 1.0,
                  f"B1 at the draft's shape, S {case}: shares of the "
                  f"limits (O, LSE) {shares}")
            used[case] = max(shares)
    log("kernels", f"B1 at the draft prefill's shapes (B=1 H={dc.n_heads} "
        f"D={dc.head_dim} padded to 128, causal, S "
        f"{ENGINE['prefill_buckets']}, f32 and bf16): O and LSE within "
        f"their limits (at most {max(used.values()):.2f} of one)")
    return used


def serve_config():
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama3_8b(n_layers=SERVE_LAYERS, attn_impl="flash",
                                 param_dtype=torch.bfloat16)


def serve_requests(cfg):
    """The serve phase's 12 requests (numpy seed 0): 100-500 prompt
    tokens, 16-48 new."""
    rng = np.random.RandomState(0)
    return [{"prompt": rng.randint(0, cfg.vocab_size,
                                   int(rng.randint(100, 501))).tolist(),
             "max_tokens": int(rng.randint(16, 49))}
            for _ in range(N_REQUESTS)]


def phase_serve(dev, cfg, loader, mix, card):
    """The dense server: 12 requests with B1's launch count, parity with
    ``generate`` and a profile window, then the paged serve's traffic mix
    without its prompts over 512 tokens (the dense layout cannot take
    them), for its figures beside the paged run's."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import LLMServer

    t0 = time.perf_counter()
    server = LLMServer(model_config=cfg, engine_config=dict(ENGINE),
                       params_loader=loader, device=dev)
    # The buckets the engine's inserts use, for 6o's trace gate.
    buckets_used = set()
    bucket_for = server._engine._bucket_for

    def _bucket(n):
        buckets_used.add(bucket_for(n))
        return bucket_for(n)

    server._engine._bucket_for = _bucket
    torch.cuda.synchronize()
    log("serve", f"Llama-3-8B (L={cfg.n_layers}, kv heads "
        f"{cfg.n_kv_heads}, vocab {cfg.vocab_size}) int8 built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    try:
        # One warm request (cuBLAS handles, first launches) outside the
        # measured window.
        server({"prompt": [1] * 128, "max_tokens": 2})
        reqs = serve_requests(cfg)
        results = [None] * N_REQUESTS
        errors = []

        def client(i):
            try:
                for j in range(i, N_REQUESTS, N_CLIENTS):
                    results[j] = server(reqs[j])
            except BaseException as e:       # relayed to the main thread
                errors.append(e)

        prefills0 = server.stats()["prefills"]
        attention.flash_fwd_cuda.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        launches = attention.flash_fwd_cuda.launches
        prefills = server.stats()["prefills"] - prefills0
        if errors:
            raise errors[0]
        check(all(not t.is_alive() for t in threads), "clients hung")
        for r, res in zip(reqs, results):
            check(res is not None and res["finish_reason"] == "length"
                  and res["num_tokens"] == r["max_tokens"]
                  and all(0 <= t < cfg.vocab_size for t in res["tokens"]),
                  f"bad result {res}")
        n_tok = sum(res["num_tokens"] for res in results)
        ttft = float(np.median([res["ttft_s"] for res in results]))
        figures = {"tok_s": n_tok / wall, "ttft_p50_ms": 1e3 * ttft,
                   "tpot_p50_ms": 1e3 * float(np.median(
                       [res["tpot_s"] for res in results]))}
        log("serve", f"{len(results)}/{N_REQUESTS} completed, {n_tok} "
            f"tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s, TTFT p50 "
            f"{ttft * 1e3:.1f} ms, flash launches {launches} for "
            f"{prefills} prefills (x{cfg.n_layers} layers)")
        check(prefills == N_REQUESTS
              and launches == cfg.n_layers * prefills,
              f"flash launches {launches} != {cfg.n_layers} x {prefills}")
        phase_parity(server, cfg, reqs, results, dev)
        profile = phase_profile(server, cfg)
        dense_mix = run_mix(server, mix, "serve", card, long_prompts=False)
        tokens = [res["tokens"] for res in results]
        programs = phase_programs(server, cfg, buckets_used, card)
        return launches, profile, dense_mix, tokens, figures, programs
    finally:
        server.shutdown()


def insert_flops(cfg, P):
    """The analytic FLOPs of one dense insert at bucket P: the layers'
    weight matmuls (q, k, v, o, and the three of the MLP), B1's formula
    (two products of 2 * head_dim flops per visible pair and head), and
    the first token's lm-head row."""
    D, H, KV, hd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = (2 * P * D * (H * hd + 2 * KV * hd) + 2 * P * H * hd * D
                 + 3 * 2 * P * D * cfg.hidden_dim
                 + 4.0 * hd * H * P * (P + 1) // 2)
    return cfg.n_layers * per_layer + 2 * D * cfg.vocab_size


def phase_programs(server, cfg, buckets_used, card):
    """6o, in process: the dense server's tracked engine programs after
    phase 4's traffic. Gates: one tick trace, one insert trace per bucket
    the inserts used, ``trace_count`` within the reference's bound; the
    tick and insert rows name the H100 spec and a GPU measurement; the
    insert's counted FLOPs at bucket 128 within 1% of ``insert_flops``;
    a sampled tick's MFU and MBU in (0, 1.05]."""
    from ray_tpu_torch.observability import xla

    st = server.stats()
    traces, n_buckets = st["traces"], len(ENGINE["prefill_buckets"])
    check(traces["tick"] == 1 and traces["insert"] == len(buckets_used)
          and st["trace_count"] <= n_buckets + 1,
          f"engine traces {traces} (trace_count {st['trace_count']}), "
          f"buckets used {sorted(buckets_used)}")
    rows = [r for r in xla.local_programs()
            if r["fn"] in ("llm_engine_tick", "llm_engine_insert")]
    check(all(r["spec"] == "h100" and r["measurement"] == "gpu"
              for r in rows) and len(rows) == traces["tick"]
          + traces["insert"], f"program rows {rows}")
    ins = next(r for r in rows if r["fn"] == "llm_engine_insert"
               and r["signature"].startswith("(int64[128],"))
    want = insert_flops(cfg, 128)
    tick = next(r for r in rows if r["fn"] == "llm_engine_tick")
    out = {"traces": traces, "trace_count": st["trace_count"],
           "buckets_used": sorted(buckets_used),
           "insert128_flops": ins["flops"], "insert128_analytic": want,
           "rows": [{k: r[k] for k in (
               "fn", "signature", "flops", "bytes_accessed",
               "transcendentals", "peak_hbm_bytes", "compile_seconds",
               "calls", "samples", "wall_s", "mfu", "mbu", "verdict",
               "lost_roofline_s_per_call", "spec", "measurement")}
               for r in rows], "card": card}
    for r in rows:
        log("programs", f"{r['fn']} {r['signature']}: {r['flops']:.4g} "
            f"flops, {r['bytes_accessed']:.4g} B, peak "
            f"{(r['peak_hbm_bytes'] or 0) / 2**30:.2f} GiB, first call "
            f"{r['compile_seconds'] * 1e3:.1f} ms, {r['samples']} samples"
            + (f", wall {r['wall_s'] * 1e3:.3f} ms, MFU {r['mfu']:.4f}, "
               f"MBU {r['mbu']:.4f}, {r['verdict']}"
               if r["samples"] else "") + f"; {card}")
    check(abs(ins["flops"] - want) <= 0.01 * want,
          f"insert at bucket 128 counted {ins['flops']:.6g} flops, the "
          f"analytic count is {want:.6g}")
    check(tick["samples"] > 0 and 0 < tick["mfu"] <= 1.05
          and 0 < tick["mbu"] <= 1.05,
          f"the tick's sampled MFU/MBU: {tick}")
    log("programs", f"traces {traces}, trace_count {st['trace_count']} "
        f"(buckets used {sorted(buckets_used)}); insert at 128: "
        f"{ins['flops']:.6g} flops counted, {want:.6g} analytic; the tick "
        f"MFU {tick['mfu']:.4f}, MBU {tick['mbu']:.4f}, {tick['verdict']}")
    return out


def phase_parity(server, cfg, reqs, results, dev):
    """Engine greedy tokens against the port's ``generate``, run at the
    engine's batch width (the prompt in every one of ``num_slots`` rows):
    same shapes, so the same bits, and the tokens must be equal. At
    batch 1 cuBLAS may choose another algorithm for the final f32
    logits product (4.8e-6 apart on the H100), so a near-tie could break
    the other way there; that comparison is printed, not required."""
    from ray_tpu_torch.models.llama import generate

    # Prompts of at least 128 tokens: below that the reference's rule
    # sends generate's exact-length prefill to plain attention while the
    # engine's 128 bucket goes through the kernel, and in bf16 the two
    # round P at different places (normalised vs. not).
    params = server._engine.params
    width = server._engine.config.num_slots
    pairs = [(r, res) for r, res in zip(reqs, results)
             if len(r["prompt"]) >= 128][:N_PARITY]
    check(len(pairs) == N_PARITY, "too few prompts of >= 128 tokens")
    for r, res in pairs:
        prompt, got = r["prompt"], res["tokens"]
        rows = generate(params, torch.tensor([prompt] * width, device=dev),
                        cfg, max_new_tokens=len(got)).tolist()
        ref1 = generate(params, torch.tensor([prompt], device=dev), cfg,
                        max_new_tokens=len(got))[0].tolist()
        same = rows[0] == got and all(row == rows[0] for row in rows)
        msg = (f"prompt len {len(prompt)}: engine == generate (batch "
               f"{width}) for {len(got)} tokens: {same}")
        first = next((i for i, (a, b) in enumerate(zip(ref1, got))
                      if a != b), None)
        msg += ("; == generate (batch 1): True" if first is None else
                f"; generate (batch 1) first differs at token {first}")
        log("parity", msg)
        check(same, "engine greedy tokens differ from generate")


# Kernel groups of a profile, by a substring of the kernel's name: the
# hand-written kernels first (ring_q before ring_), then the libraries'.
_GROUPS = (("flash_fwd", "flash_fwd"), ("flash_bwd_dkv", "flash_bwd_dkv"),
           ("flash_bwd_dq", "flash_bwd_dq"), ("ring_q", "ring C5/C6"),
           ("ring_", "ring C1-C4"))


def _kernel_group(name: str) -> str:
    low = name.lower()
    for key, group in _GROUPS:
        if key in low:
            return group
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                              "splitk")):
        return "matmul"
    return "elementwise/other"


def _is_index(name: str) -> bool:
    """An indexing kernel of elementwise/other (gather, index, index-put,
    index_add; not ``elementwise_kernel_with_index``, arange's), reported
    as a part of that group."""
    low = name.lower()
    return (_kernel_group(name) == "elementwise/other"
            and any(k in low for k in ("gather", "index_", "indexfunc")))


def _traced_kernels():
    """(wrapper, a substring of its kernel's name) for every hand-written
    kernel: a profile window must see as many launches of each as its
    wrapper counted."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    names = ("ring_permute_kernel", "ring_reduce_scatter_kernel",
             "ring_allgather_kernel", "ring_allreduce_kernel",
             "ring_qhop_kernel", "ring_qallreduce_kernel")
    return [(attention.flash_fwd_cuda, "flash_fwd"),
            (attention.flash_bwd_dkv_cuda, "flash_bwd_dkv"),
            (attention.flash_bwd_dq_cuda, "flash_bwd_dq")] + list(
                zip(R.KERNELS + Q.KERNELS, names))


# The profiler loses the first records of device activity in a window, a
# number that grows over a process's life (tens, late in this script's
# run), and the window's first kernels then fall out of its trace. So a
# window opens with MARKER_LAUNCHES launches of torch.cuda._sleep's spin
# kernel, which take that loss, and fails unless some of them reach the
# trace: the loss is a prefix, so then every record of fn() is there.
MARKER_LAUNCHES, MARKER_KERNEL = 2000, "spin_kernel"


def profile_window(phase: str, fn, card: str = ""):
    """Run fn() once under one torch.profiler window that keeps every event
    (no schedule; ``acc_events`` where this torch has it), after
    MARKER_LAUNCHES marker kernels, and return {wall_ms, busy_ms (the sum
    of kernel times), occupied_ms (the time at least one kernel ran: the
    union of their intervals, which kernels on two streams overlap),
    groups: {group: device ms}, top: [(ms, count, name)],
    lead_records_lost}; the markers count in none of them but the last.
    Fails if the profiler warns that it cleared or dropped events, if no
    marker reached the trace, if the device was occupied longer than the
    wall time, or if the trace holds another number of launches of a
    hand-written kernel than its wrapper counted in the window."""
    import inspect
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    traced = _traced_kernels()
    before = [w.launches for w, _ in traced]
    kw = ({"acc_events": True}
          if "acc_events" in inspect.signature(profile).parameters else {})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **kw) as prof:
            for _ in range(MARKER_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.device_time_total > 0
                  # user annotations span kernels counted already
                  and not getattr(e, "is_user_annotation", False)]
        spans = [(MARKER_KERNEL in e.name, e.time_range.start,
                  e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
    markers = sum(e.count for e in device if MARKER_KERNEL in e.key)
    events = [e for e in device if MARKER_KERNEL not in e.key]
    # fn()'s kernels start after the markers end (a synchronize lies
    # between), whatever start a record of them may carry.
    end = max((hi for m, _, hi in spans if m), default=float("-inf"))
    occupied = 0.0
    for lo, hi in sorted((lo, hi) for m, lo, hi in spans if not m):
        occupied += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    occupied /= 1e3
    lost = [str(w.message) for w in caught
            if re.search(r"clears? events|drop|lost|overflow",
                         str(w.message), re.I)]
    check(not lost, f"{phase}: the profiler warned {lost}")
    check(markers > 0, f"{phase}: none of {MARKER_LAUNCHES} marker kernels "
          f"reached the trace, so the window's first kernels may not have")
    check(bool(events), f"{phase}: the profiler recorded no device time")
    busy = sum(e.device_time_total for e in events) / 1e3
    check(occupied <= wall_ms, f"{phase}: device occupied {occupied:.1f} "
          f"ms exceeds the window's wall time {wall_ms:.1f} ms")
    short = []
    for (w, name), b in zip(traced, before):
        seen = sum(e.count for e in events if name in e.key)
        if seen != w.launches - b:
            short.append((name, seen, w.launches - b))
    check(not short, f"{phase}: the trace and the wrappers disagree on "
          f"launches (kernel, traced, launched): {short}")
    groups = {}
    for e in events:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.device_time_total / 1e3
    index = sorted(((e.device_time_total / 1e3, e.count, e.key)
                    for e in events if _is_index(e.key)), reverse=True)
    index_ms = sum(ms for ms, _, _ in index)
    top = sorted(((e.device_time_total / 1e3, e.count, e.key)
                  for e in events), reverse=True)
    log(phase, f"profiled: {wall_ms:.1f} ms wall, device busy {busy:.1f} "
        f"ms of kernel time, occupied {occupied:.1f} ms (idle "
        f"{100 * (1 - occupied / wall_ms):.1f}%); "
        + ", ".join(f"{g} {ms:.1f} ms ({100 * ms / busy:.1f}%)"
                    for g, ms in sorted(groups.items(),
                                        key=lambda kv: -kv[1]))
        + f"; of elementwise/other, indexing kernels {index_ms:.1f} ms "
        f"({100 * index_ms / busy:.1f}%)"
        + "; every hand-written kernel's launches in the trace (the "
        f"profiler lost the first {MARKER_LAUNCHES - markers} device records, "
        "markers)" + (f"; {card}" if card else ""))
    for ms, count, name in top[:8]:
        log(phase, f"  {ms:8.2f} ms {count:6d}x  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "occupied_ms": occupied,
            "groups": groups,
            "index_ms": index_ms, "index_top": [list(t) for t in index[:4]],
            "top": [list(t) for t in top[:8]],
            "lead_records_lost": MARKER_LAUNCHES - markers}


def phase_profile(server, cfg, phase="profile", card=""):
    """Where the serving time goes: device time by kernel over 8 requests
    (prompts of 100-500 tokens, 32 new tokens each) under torch.profiler,
    against the host's wall time for the same window."""
    rng = np.random.RandomState(1)
    reqs = [{"prompt": rng.randint(0, cfg.vocab_size,
                                   int(rng.randint(100, 501))).tolist(),
             "max_tokens": 32} for _ in range(8)]

    def run():
        threads = [threading.Thread(target=server, args=(r,))
                   for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(all(not t.is_alive() for t in threads), "requests hung")

    return profile_window(phase, run, card)


# ---------------------------------------------------------------------------
# The paged serving slice: paged KV, prefix cache, chunked prefill, the host
# KV tier, preemption and speculative decoding.
# ---------------------------------------------------------------------------

# The paged server: the dense server's geometry at block size 16, with a
# pool of PAGED_BLOCKS blocks, 19% of the dense equivalent (8 x 1024 / 16 =
# 512). Four shared-prefix requests in flight (16 shared blocks, up to 18
# own each) fit; in phase 2 two batch decodes (up to 29 blocks each) and a
# long prompt (58 blocks) do not, so the long prompts' admissions queue
# for blocks and preempt the batch decodes, and every entry phase 1 left
# in the prefix cache, the shared prefix included, is evicted into the
# host tier. The tier is sized (1 GiB, 512 blocks of 2 MiB) to keep every
# spilled block, so phase 3's first shared-prefix request finds the
# prefix there and promotes it (16 blocks: 3.6 ms by the cost model's
# defaults against 12.8 ms of recompute), and the others hit the pool.
PAGED_BLOCKS = 96
PAGED_ENGINE = {**ENGINE, "kv_layout": "paged", "kv_block_size": 16,
                "num_kv_blocks": PAGED_BLOCKS, "prefix_cache": True,
                "kv_spill": True, "kv_host_tier_bytes": 1 << 30,
                "preempt_hold_s": 0.0, "preempt_cooldown_s": 0.0}
SYS_PREFIX, SPEC_K, GATE_LAYERS = 256, 4, 4
# Pairs of fresh servers, accounting on and off, that price the hooks
# (two, one each way round; PRs 11-12 ran four).
HOOK_PAIRS = 2


def paged_mix(vocab):
    """The paged serve's traffic, from numpy seed 0, in three phases:
    (1) 8 interactive requests sharing a 256-token system prefix with
    50-250 tokens of their own (16-32 new); (2) two batch requests
    (150-250 prompt tokens, 200 new), then two interactive prompts of
    700-900 tokens with chunked_prefill (16 new); (3) 8 more requests on
    the shared prefix, after phase 2 evicted it from the pool."""
    rng = np.random.RandomState(0)

    def toks(n):
        return rng.randint(0, vocab, int(n)).tolist()

    sys_prefix = toks(SYS_PREFIX)

    def shared():
        return {"prompt": sys_prefix + toks(rng.randint(50, 251)),
                "max_tokens": int(rng.randint(16, 33))}

    batch = [{"prompt": toks(rng.randint(150, 251)), "max_tokens": 200,
              "slo": "batch"} for _ in range(2)]
    first = [shared() for _ in range(8)]
    long = [{"prompt": toks(rng.randint(700, 901)), "max_tokens": 16,
             "chunked_prefill": True} for _ in range(2)]
    second = [shared() for _ in range(8)]
    return {"batch": batch, "first": first, "long": long, "second": second,
            "sys_prefix": sys_prefix}


def warm(server, cfg):
    """One request per prefill bucket through the server (its scheduler
    thread owns the engine), distinct random prompts, outside any
    measured window."""
    rng = np.random.RandomState(99)
    for b in ENGINE["prefill_buckets"]:
        server({"prompt": rng.randint(0, cfg.vocab_size, b).tolist(),
                "max_tokens": 2})


def _clients(server, reqs, errors, n=N_CLIENTS):
    """Start n client threads that send ``reqs`` round-robin; returns
    (threads, results)."""
    results = [None] * len(reqs)

    def client(i):
        try:
            for j in range(i, len(reqs), n):
                results[j] = server(reqs[j])
        except BaseException as e:           # relayed to the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(min(n, len(reqs)))]
    for t in threads:
        t.start()
    return threads, results


def _join(threads, errors):
    for t in threads:
        t.join(600)
    if errors:
        raise errors[0]
    check(all(not t.is_alive() for t in threads), "clients hung")


def run_mix(server, mix, phase, card, long_prompts=True):
    """Send the mix through ``server`` with four client threads, phase by
    phase: (1) the first shared-prefix requests; (2) two clients start
    the batch requests and, once both decode, the two others the long
    prompts (skipped on the dense server); (3) the second shared-prefix
    requests. Every request must end at its max_tokens. Returns
    {"results": [(request, result)], tok/s, TTFT and TPOT p50 over all
    requests}."""
    errors = []
    t0 = time.perf_counter()
    threads, res = _clients(server, mix["first"], errors)
    _join(threads, errors)
    done = list(zip(mix["first"], res))
    threads, res = _clients(server, mix["batch"], errors)
    deadline = time.monotonic() + 120
    while server.load()["active_slots"] < len(mix["batch"]) and not errors:
        check(time.monotonic() < deadline, "batch requests never admitted")
        time.sleep(0.005)
    if long_prompts:
        more, res2 = _clients(server, mix["long"], errors)
        _join(more, errors)
        done += list(zip(mix["long"], res2))
    _join(threads, errors)
    done += list(zip(mix["batch"], res))
    threads, res = _clients(server, mix["second"], errors)
    _join(threads, errors)
    done += list(zip(mix["second"], res))
    wall = time.perf_counter() - t0
    for r, res in done:
        check(res is not None and res["finish_reason"] == "length"
              and res["num_tokens"] == r["max_tokens"],
              f"{phase}: a request for {r['max_tokens']} tokens ended "
              f"{res and (res['finish_reason'], res['num_tokens'])}")
    n_tok = sum(res["num_tokens"] for _, res in done)
    out = {"requests": len(done), "tokens": n_tok, "wall_s": wall,
           "tok_s": n_tok / wall,
           "ttft_p50_ms": 1e3 * float(np.median([res["ttft_s"]
                                                 for _, res in done])),
           "tpot_p50_ms": 1e3 * float(np.median([res["tpot_s"]
                                                 for _, res in done])),
           "results": done}
    log(phase, f"mix{'' if long_prompts else ' without prompts over 512'}: "
        f"{len(done)} requests, {n_tok} tokens in {wall:.2f} s = "
        f"{out['tok_s']:.1f} tok/s, TTFT p50 {out['ttft_p50_ms']:.1f} ms, "
        f"TPOT p50 {out['tpot_p50_ms']:.2f} ms; {card}")
    return out


def _top2_gap(params, cfg, prompt, tokens, i, dev):
    """The top-2 logit gap of the port's forward at generated token i."""
    from ray_tpu_torch.models.llama import forward

    with torch.no_grad():
        logits = forward(params, torch.tensor([prompt + tokens[:i]],
                                              device=dev), cfg)[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def _agreement(phase, paged, dense, params, cfg, dev):
    """Requests of the paged run whose tokens equal the dense run's, and
    for the others the first divergence and the top-2 logit gap there
    (printed, not required: bf16/int8 at the served depth, other
    shapes)."""
    by_prompt = {tuple(r["prompt"]): res["tokens"] for r, res in dense}
    same, diffs = 0, []
    for r, res in paged:
        want = by_prompt.get(tuple(r["prompt"]))
        if want is None:
            continue
        if res["tokens"] == want:
            same += 1
            continue
        i = next(k for k, (a, b) in enumerate(zip(res["tokens"], want))
                 if a != b)
        diffs.append((len(r["prompt"]), i, _top2_gap(
            params, cfg, list(r["prompt"]), res["tokens"], i, dev)))
    log(phase, f"paged == dense tokens for {same} of {same + len(diffs)} "
        f"requests" + "".join(
            f"; prompt {p}: first differs at token {i}, top-2 gap there "
            f"{g:.4g}" for p, i, g in diffs))
    return {"equal": same, "compared": same + len(diffs),
            "first_divergence": [{"prompt_len": p, "token": i,
                                  "top2_gap": g} for p, i, g in diffs]}


def phase_paged_serve(dev, cfg, loader, mix, dense_mix, card):
    """The paged server at full width and depth (int8, flash): the mix,
    every stats() event it must cause, its figures beside the dense
    server's, the agreement with the dense server's tokens, a profile
    window, with the indexing kernels' share of it (the pool gather's
    upper bound)."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import LLMServer

    server = LLMServer(model_config=cfg, engine_config=dict(PAGED_ENGINE),
                       params_loader=loader, device=dev)
    try:
        warm(server, cfg)
        log("paged", f"pool of {PAGED_BLOCKS} blocks of 16 rows (dense "
            f"equivalent {ENGINE['num_slots'] * ENGINE['max_seq_len'] // 16}"
            f"), {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        s0 = server.stats()
        attention.flash_fwd_cuda.launches = 0
        out = run_mix(server, mix, "paged", card)
        launches = attention.flash_fwd_cuda.launches
        st = server.stats()
        pc, tiers = st["prefix_cache"], st["kv_tiers"]
        hits = pc["hits"] - s0["prefix_cache"]["hits"]
        hit_tokens = pc["hit_tokens"] - s0["prefix_cache"]["hit_tokens"]
        events = {
            "prefix_hits": hits, "prefix_hit_tokens": hit_tokens,
            "chunked_prompts": st["chunked_prefill"]["prompts"],
            "chunks": st["chunked_prefill"]["chunks"],
            "admission_waits": st["kv"]["admission_waits"],
            "evictions": pc["evictions"], "spilled": pc["spilled"],
            "promoted_blocks": tiers["promoted_blocks"],
            "promote_skips": tiers["promote_skips"],
            "preempted": st["preempted"],
            "adopted_blocks": st["migration"]["blocks"],
            "dropped_blocks": tiers["dropped_blocks"]}
        log("paged", "stats: " + ", ".join(f"{k} {v}"
                                           for k, v in events.items()))
        # Every shared-prefix request but the first of each round hits
        # the pool (the first of round 2 promotes the prefix from the
        # tier).
        repeats = len(mix["first"]) + len(mix["second"]) - 2
        check(hits >= repeats and hit_tokens >= repeats * SYS_PREFIX,
              f"prefix hits {hits} / hit tokens {hit_tokens}: fewer than "
              f"the shared prefix's {repeats} repeats")
        check(events["chunked_prompts"] >= 1 and events["chunks"] >= 2,
              "no prompt was prefilled in two chunks")
        check(events["admission_waits"] >= 1, "no admission queued for "
              "blocks")
        check(events["spilled"] >= 1 and events["promoted_blocks"] >= 1,
              "no spill to the host tier, or no promote from it")
        check(events["preempted"] >= 1, "no preemption")
        check(st["kv"]["used_blocks"] == pc["entries"],
              "blocks held outside the prefix cache after the run")
        check(launches == 0, f"the paged path launched B1 {launches} times "
              f"(its prefill is plain attention)")
        log("paged", f"paged {out['tok_s']:.1f} tok/s, TTFT p50 "
            f"{out['ttft_p50_ms']:.1f} ms, TPOT p50 "
            f"{out['tpot_p50_ms']:.2f} ms; dense (same mix without the two "
            f"long prompts) {dense_mix['tok_s']:.1f} tok/s, TTFT p50 "
            f"{dense_mix['ttft_p50_ms']:.1f} ms, TPOT p50 "
            f"{dense_mix['tpot_p50_ms']:.2f} ms; {card}")
        agree = _agreement("paged", out["results"], dense_mix["results"],
                           server._engine.params, cfg, dev)
        profile = phase_profile(server, cfg, "paged profile", card)
        log("paged", f"indexing kernels (the pool gather, the KV writes, "
            f"the embedding lookup): {profile['index_ms']:.1f} of "
            f"{profile['busy_ms']:.1f} ms busy in the paged profile window "
            f"({100 * profile['index_ms'] / profile['busy_ms']:.1f}%); "
            + "; ".join(f"{ms:.1f} ms {n}x {name[:60]}"
                        for ms, n, name in profile["index_top"])
            + f"; {card}")
        return {"events": events, "agreement": agree, "profile": profile,
                **{k: v for k, v in out.items() if k != "results"},
                "dense": {k: v for k, v in dense_mix.items()
                          if k != "results"}}
    finally:
        server.shutdown()


def phase_spec_serve(dev, cfg, loader, mix, card):
    """Speculative decoding at full width: the default draft
    (``draft_config_for``: 2 layers, dim 64, head dim 16, random weights
    from seed 0) on the paged server, spec_k 4. The third phase's
    shared-prefix requests go through a fresh paged server without a
    draft and then a fresh speculative one, each after the same warm-up,
    so both start from the same state; then four more requests on the
    speculative server in a profile window. B1 launches = draft layers x
    draft prefills, all at buckets of 128 and more (none without the
    draft). Last, B1 on the q, k and v of real draft prefills at every
    bucket, against its plain version."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import LLMServer

    reqs = mix["second"]

    def serve(server):
        warm(server, cfg)
        s0 = server.stats()
        attention.flash_fwd_cuda.launches = 0
        errors = []
        t0 = time.perf_counter()
        threads, res = _clients(server, reqs, errors)
        _join(threads, errors)
        wall = time.perf_counter() - t0
        for r, x in zip(reqs, res):
            check(x["finish_reason"] == "length"
                  and x["num_tokens"] == r["max_tokens"], f"bad result {x}")
        return res, wall, s0, attention.flash_fwd_cuda.launches

    server = LLMServer(model_config=cfg, engine_config=dict(PAGED_ENGINE),
                       params_loader=loader, device=dev)
    try:
        plain, plain_wall, _, plain_launches = serve(server)
    finally:
        server.shutdown()
    check(plain_launches == 0, f"the paged server without a draft "
          f"launched B1 {plain_launches} times")
    del server
    gc.collect()
    torch.cuda.empty_cache()

    server = LLMServer(model_config=cfg, engine_config=dict(
        PAGED_ENGINE, spec_k=SPEC_K), params_loader=loader,
        speculative={"draft_seed": 0}, device=dev)
    try:
        eng = server._engine
        dc = eng.draft_config
        check((dc.n_layers, dc.dim, dc.head_dim, dc.vocab_size)
              == (2, 64, 16, cfg.vocab_size), f"draft config {dc}")
        res, wall, s0, launches = serve(server)
        s0 = s0["spec"]
        spec = server.stats()["spec"]
        prefills = spec["draft_prefills"] - s0["draft_prefills"]
        check(prefills == len(reqs) and launches == dc.n_layers * prefills,
              f"B1 launches {launches} != {dc.n_layers} draft layers x "
              f"{prefills} draft prefills ({len(reqs)} requests)")
        n_tok = sum(x["num_tokens"] for x in res)
        same = sum(x["tokens"] == y["tokens"] for x, y in zip(res, plain))
        accepted = spec["accepted"] - s0["accepted"]
        proposed = spec["proposed"] - s0["proposed"]
        out = {"requests": len(reqs), "tokens": n_tok, "wall_s": wall,
               "tok_s": n_tok / wall, "paged_wall_s": plain_wall,
               "paged_tok_s": n_tok / plain_wall,
               "accept_ratio": accepted / max(proposed, 1),
               "accepted": accepted, "proposed": proposed,
               "rounds": spec["rounds"] - s0["rounds"],
               "draft_prefills": prefills, "b1_launches": launches,
               "equal_to_paged": same}
        log("spec", f"{len(reqs)} requests, {n_tok} tokens in {wall:.2f} s "
            f"= {out['tok_s']:.1f} tok/s; the same requests on a fresh "
            f"paged server without a draft, after the same warm-up: "
            f"{plain_wall:.2f} s = {out['paged_tok_s']:.1f} tok/s "
            f"({out['tok_s'] / out['paged_tok_s']:.3f}x); "
            f"acceptance {accepted}/{proposed} = "
            f"{100 * out['accept_ratio']:.2f}% (a random draft: near zero "
            f"by construction), {out['rounds']} rounds; B1 launches "
            f"{launches} = {dc.n_layers} x {prefills} draft prefills; "
            f"tokens equal to the server's without a draft for {same} of "
            f"{len(reqs)} (bf16/int8, printed, not required); {card}")
        more = [dict(r, max_tokens=16) for r in mix["first"][:4]]
        before = attention.flash_fwd_cuda.launches
        p0 = server.stats()["spec"]["draft_prefills"]

        def run():
            errs = []
            th, _ = _clients(server, more, errs)
            _join(th, errs)

        out["profile"] = profile_window("spec profile", run, card)
        n = server.stats()["spec"]["draft_prefills"] - p0
        check(attention.flash_fwd_cuda.launches - before
              == dc.n_layers * n == dc.n_layers * len(more),
              "profiled B1 launches != draft layers x draft prefills")
        out["b1_launches"] += attention.flash_fwd_cuda.launches - before
    finally:
        server.shutdown()
    # Comparison launches, after every count of the path was read.
    out["draft_b1_tol_used"] = check_draft_b1(eng, reqs[0]["prompt"],
                                              "spec")
    return out


def check_draft_b1(eng, prompt, phase):
    """B1 on the q, k and v of real draft prefills: the engine's draft
    prefills ``prompt`` cut to fill each prefill bucket that launches B1
    (the whole prompt in the largest), zero-padded as the engine pads it;
    every layer's attention call is captured on its way to B1, and B1's O
    and LSE on those inputs (made contiguous, as the path makes them) are held against the plain version's to the
    limits of the full-width checks. Returns the largest share of a limit
    used."""
    from ray_tpu_torch.models.llama import prefill_kv
    from ray_tpu_torch.ops import attention

    dc = eng.draft_config
    check(dc.attn_impl == "flash", f"the draft's attention is "
          f"{dc.attn_impl!r}, not B1")
    lens = sorted({min(len(prompt), b) for b in eng.config.prefill_buckets
                   if b >= attention.MIN_KERNEL_SEQ})
    worst, shapes = 0.0, []
    for n in lens:
        calls = []

        def capture(q, k, v, causal=True):
            calls.append((q, k, v, causal))
            return attention.flash_attention(q, k, v, causal=causal)

        padded = np.zeros((eng._bucket_for(n),), np.int64)
        padded[:n] = prompt[:n]
        tokens = torch.from_numpy(padded).to(eng.device)[None]
        with torch.no_grad():
            prefill_kv(eng._draft, tokens, dc, attn_impl=capture)
            for i, (q, k, v, causal) in enumerate(calls):
                check(q.shape == (1, padded.shape[0], dc.n_heads,
                                  dc.head_dim) and causal,
                      f"{phase}: draft layer {i} attends {tuple(q.shape)}")
                q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
                o, lse = attention.flash_fwd_cuda(q, k, v, causal)
                po, plse = attention.flash_attention_plain(q, k, v, causal)
                used = b1_used(o, lse, po, plse, q.dtype)
                check(max(used) <= 1.0, f"{phase}: B1 on draft layer {i}'s "
                      f"prefill of {n} tokens (bucket {padded.shape[0]}, "
                      f"{q.dtype}): shares of the limits (O, LSE) {used}")
                worst = max(worst, max(used))
        check(len(calls) == dc.n_layers, f"{phase}: {len(calls)} draft "
              f"attention calls for {dc.n_layers} layers")
        shapes.append(f"{n} tokens in bucket {padded.shape[0]}")
    log(phase, f"B1 on the q, k and v of real draft prefills "
        f"({', '.join(shapes)}; {dc.n_layers} layers, {dc.n_heads} heads of "
        f"{dc.head_dim}, {dc.dtype}): O and LSE within their limits against "
        f"the plain version (at most {worst:.2f} of one)")
    return worst


def _gate_cfg(dtype):
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama3_8b(n_layers=GATE_LAYERS, attn_impl="flash",
                                 dtype=dtype, param_dtype=dtype)


def phase_paged_bitwise(dev, card):
    """Bitwise gates at Llama-3-8B widths, 4 layers, bf16: (1)
    decode_step_paged against decode_step on the same KV contents at
    batch 8 (logits and written rows); (2) export -> adopt round trip;
    (3) a preempted request's tokens equal its tokens without preemption;
    (4) a tier-promoted request's tokens equal the same prompt's with its
    prefix still in the pool."""
    from ray_tpu_torch.models.llama import (_paged_view, decode_step,
                                            decode_step_paged,
                                            init_paged_kv_cache,
                                            init_params)
    from ray_tpu_torch.serve.llm.engine import (EngineConfig, LLMEngine,
                                                Request)

    cfg = _gate_cfg(torch.bfloat16)
    params = init_params(cfg, 3, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    B, bs, mb = 8, 16, 64
    pools = init_paged_kv_cache(cfg, B * mb, bs, device=dev)
    for t in pools.values():
        t.normal_(generator=gen)
    tables = torch.randperm(B * mb, generator=gen, device=dev).reshape(B, mb)
    dense = {n: torch.stack([_paged_view(pools[n][i], tables)
                             for i in range(cfg.n_layers)])
             for n in ("k", "v")}
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev)
    pos = torch.randint(0, mb * bs, (B,), generator=gen, device=dev)
    with torch.no_grad():
        pl, pools = decode_step_paged(params, pools, tables, tok, pos, cfg)
        dl, dense = decode_step(params, dense, tok, pos, cfg)
    rows_equal = all(torch.equal(torch.stack(
        [_paged_view(pools[n][i], tables) for i in range(cfg.n_layers)]),
        dense[n]) for n in ("k", "v"))
    check(torch.equal(pl, dl) and rows_equal,
          "decode_step_paged != decode_step on the same contents")
    del pools, dense

    rng = np.random.RandomState(11)
    sys_p = rng.randint(0, cfg.vocab_size, 160).tolist()
    prompt = sys_p + rng.randint(0, cfg.vocab_size, 60).tolist()
    geo = dict(num_slots=8, max_seq_len=1024,
               prefill_buckets=(128, 256, 512), kv_layout="paged",
               kv_block_size=bs, kv_prefill_cost_per_token_ms=50.0)

    def engine():
        return LLMEngine(params, cfg, EngineConfig(**geo), device=dev)

    def run(eng, p, n):
        h = eng.submit(Request(prompt=p, max_tokens=n))
        eng.drain()
        return h.tokens

    with torch.no_grad():
        plain = run(engine(), prompt, 24)
        eng = engine()
        h = eng.submit(Request(prompt=prompt, max_tokens=24, slo="batch"))
        for _ in range(6):
            eng.step()
        slot = next(s for s in range(8) if eng._slots[s].handle is h)
        n_valid = -(-int(eng._pos[slot]) // bs)
        ids = eng._tables[slot, :n_valid].tolist()
        rows = (eng._cache["k"][:, ids].cpu(), eng._cache["v"][:, ids].cpu())
        eng.preempt(slot)
        st = h.kv_state
        exported = (torch.equal(st.k_blocks, rows[0])
                    and torch.equal(st.v_blocks, rows[1]))
        eng._admit()
        slot = next(s for s in range(8) if eng._slots[s].handle is h)
        ids = eng._tables[slot, :n_valid].tolist()
        adopted = (torch.equal(eng._cache["k"][:, ids].cpu(), st.k_blocks)
                   and torch.equal(eng._cache["v"][:, ids].cpu(),
                                   st.v_blocks))
        eng.drain()
        check(exported and adopted, f"export -> adopt not bitwise "
              f"(export {exported}, adopt {adopted})")
        check(h.tokens == plain, "preempted tokens differ from the run "
              "without preemption")

        eng = engine()
        other = sys_p + rng.randint(0, cfg.vocab_size, 40).tolist()
        run(eng, prompt, 4)                 # the shared blocks in the pool
        run(eng, other, 4)                  # other's own full blocks too
        hit = eng._prefix.match(other)
        rows = (eng._cache["k"][:, hit].cpu(), eng._cache["v"][:, hit].cpu())
        eng._allocator.free(hit)
        in_pool = run(eng, other, 16)       # every full block a pool hit
        n = len(eng._prefix)
        check(eng._prefix.evict(n) == n, "evict")
        promoted = run(eng, other, 16)      # the same blocks promoted
        st = eng.stats()["kv_tiers"]
        check(st["promoted_blocks"] == len(hit), f"promote: {st}")
        back = eng._prefix.match(other)
        check(torch.equal(eng._cache["k"][:, back].cpu(), rows[0])
              and torch.equal(eng._cache["v"][:, back].cpu(), rows[1]),
              "the promoted history differs from the pool history")
        eng._allocator.free(back)
        check(promoted == in_pool, "promoted tokens differ from the "
              "in-pool prefix's")
    log("paged bitwise", f"Llama-3-8B widths, {GATE_LAYERS} layers, bf16: "
        f"decode_step_paged == decode_step at batch {B} (logits and "
        f"rows); export -> adopt bitwise ({n_valid} blocks); preempted "
        f"tokens == unpreempted ({len(plain)}); promoted "
        f"({st['promoted_blocks']} blocks) tokens == in-pool ({len(in_pool)}"
        f"); {card}")
    del params
    return {"decode_batch": B, "round_trip_blocks": n_valid,
            "promoted_blocks": st["promoted_blocks"]}


def phase_paged_tokens(dev, card):
    """Token gates in f32 at Llama-3-8B widths, 4 layers: the paged
    engine's greedy tokens equal the dense engine's and generate's for
    every request (prefix hits, a chunked prompt, preempted and promoted
    requests), and LLMServer(speculative=True) at spec_k 4 equals the
    same paged server without a draft; then B1 on the q, k and v of that
    f32 draft's real prefills."""
    from ray_tpu_torch.models.llama import generate, init_params
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.serve.llm.engine import (EngineConfig, LLMEngine,
                                                Request)

    cfg = _gate_cfg(torch.float32)
    params = init_params(cfg, 4, dev)
    rng = np.random.RandomState(12)

    def toks(n):
        return rng.randint(0, cfg.vocab_size, n).tolist()

    sys_p = toks(SYS_PREFIX)
    geo = dict(num_slots=4, max_seq_len=1024,
               prefill_buckets=(128, 256, 512))
    paged = LLMEngine(params, cfg, EngineConfig(
        **geo, kv_layout="paged", kv_block_size=16,
        kv_prefill_cost_per_token_ms=50.0, preempt_hold_s=0.0,
        preempt_cooldown_s=0.0), device=dev)
    dense = LLMEngine(params, cfg, EngineConfig(**geo), device=dev)
    n_new = 8
    cases = []
    with torch.no_grad():
        # Prefix miss, then hits; a chunked prompt (paged only).
        for p in (sys_p + toks(40), sys_p + toks(90)):
            cases.append(("prefix", p, paged.submit(Request(
                prompt=p, max_tokens=n_new))))
            paged.drain()
        p = toks(700)
        cases.append(("chunked", p, paged.submit(Request(
            prompt=p, max_tokens=n_new, chunked_prefill=True))))
        paged.drain()
        # Batch decodes in every slot; an interactive arrival preempts.
        batch = [toks(150) for _ in range(4)]
        hb = [paged.submit(Request(prompt=p, max_tokens=n_new, slo="batch"))
              for p in batch]
        paged.step()
        p = sys_p + toks(30)
        cases.append(("interactive", p, paged.submit(Request(
            prompt=p, max_tokens=n_new))))
        paged.drain()
        cases += [("batch", p, h) for p, h in zip(batch, hb)]
        # Spill the cache, then a prompt on the spilled prefix.
        paged._prefix.evict(len(paged._prefix))
        p = sys_p + toks(50)
        cases.append(("promoted", p, paged.submit(Request(
            prompt=p, max_tokens=n_new))))
        paged.drain()
        st = paged.stats()
        check(st["preempted"] >= 1 and st["kv_tiers"]["promoted_blocks"]
              >= SYS_PREFIX // 16 and st["prefix_cache"]["hits"] >= 2
              and st["chunked_prefill"]["prompts"] == 1,
              f"f32 gate: events missing {st}")
        bad = []
        for kind, p, h in cases:
            ref = generate(params, torch.tensor([p], device=dev), cfg,
                           max_new_tokens=n_new)[0].tolist()
            want = [ref]
            if len(p) <= geo["prefill_buckets"][-1]:
                hd = dense.submit(Request(prompt=p, max_tokens=n_new))
                dense.drain()
                want.append(hd.tokens)
            if any(h.tokens != w for w in want):
                bad.append((kind, len(p)))
        check(not bad, f"f32: paged tokens differ from dense/generate: "
              f"{bad}")
        del paged, dense
        reqs = [{"prompt": sys_p + toks(int(rng.randint(20, 200))),
                 "max_tokens": 12} for _ in range(4)]
        outs = []
        for spec in (None, True):
            server = LLMServer(model_config=cfg, engine_config=dict(
                geo, kv_layout="paged", kv_block_size=16, spec_k=SPEC_K),
                params_loader=lambda: params, quantize="bf16",
                speculative=spec, device=dev)
            try:
                outs.append([server(r)["tokens"] for r in reqs])
                rounds = server.stats().get("spec", {}).get("rounds", 0)
            finally:
                server.shutdown()
        check(rounds > 0, "the speculative server ran no round")
        check(outs[0] == outs[1], "speculative tokens differ from the "
              "paged server's without a draft")
    draft_used = check_draft_b1(server._engine, reqs[0]["prompt"],
                                "paged tokens")
    log("paged tokens", f"Llama-3-8B widths, {GATE_LAYERS} layers, f32: "
        f"paged == dense == generate for {len(cases)} requests (prefix "
        f"hits, a chunked 700-token prompt, a preempting interactive and "
        f"4 batch requests, {st['preempted']} preempted, a promoted "
        f"prefix); speculative (spec_k {SPEC_K}, {rounds} rounds) == plain "
        f"paged for {len(reqs)} requests; {card}")
    del params
    return {"requests": len(cases), "preempted": st["preempted"],
            "spec_rounds": rounds, "draft_b1_tol_used": draft_used}


# ---------------------------------------------------------------------------
# The disaggregated serving slice: a prefill server and a decode server
# sharing the card in one process, KV migration between them, the peer
# prefix pull, and the engine's metrics, spans and cost meters.
# ---------------------------------------------------------------------------

# Prompts of at least this many tokens take the two-hop path (prefill, then
# adopt), the reference's prefill_threshold default (disagg/app.py); the
# others go straight to the decode server.
PREFILL_THRESHOLD = 256


def disagg_mix(vocab, seed=0):
    """The disagg phase's traffic, from numpy ``seed``: 8 requests on a
    256-token shared prefix with 50-250 own tokens (16-32 new), 2
    interactive prompts of 700-900 tokens with chunked_prefill (16 new),
    2 short prompts of 64-128 tokens (16-32 new). In submission order,
    each with a tenant of three."""
    rng = np.random.RandomState(seed)

    def toks(n):
        return rng.randint(0, vocab, int(n)).tolist()

    sys_prefix = toks(SYS_PREFIX)
    shared = [{"prompt": sys_prefix + toks(rng.randint(50, 251)),
               "max_tokens": int(rng.randint(16, 33))} for _ in range(8)]
    long = [{"prompt": toks(rng.randint(700, 901)), "max_tokens": 16,
             "chunked_prefill": True} for _ in range(2)]
    short = [{"prompt": toks(rng.randint(64, 129)),
              "max_tokens": int(rng.randint(16, 33))} for _ in range(2)]
    reqs = shared[:4] + long[:1] + short[:1] + shared[4:] + long[1:] + \
        short[1:]
    return [dict(r, tenant=f"tenant-{i % 3}") for i, r in enumerate(reqs)]


def _two_hop(pre, dec, r):
    """Prefill on ``pre``, adopt on ``dec``; (response, prefill result)."""
    res = pre.prefill(r)
    return dec.adopt(res, r), res


class _DisaggClient:
    """Routes requests as the reference's router does: two hops for
    prompts of PREFILL_THRESHOLD tokens or more, each under its own
    trace_root, the rest to the decode server. Keeps every two-hop
    request's trace id and exported state."""

    def __init__(self, pre, dec):
        self.pre, self.dec = pre, dec
        self.traces, self.states = [], []

    def __call__(self, r):
        from ray_tpu_torch.util import tracing

        if len(r["prompt"]) < PREFILL_THRESHOLD:
            return self.dec(r)
        with tracing.trace_root("disagg.request") as tc:
            out, res = _two_hop(self.pre, self.dec, r)
        self.traces.append(tc.trace_id)
        self.states.append(res["kv_state"])
        return out


def _concurrent(route, reqs, phase, card):
    """Send ``reqs`` through ``route`` from N_CLIENTS threads; every
    request must end at its max_tokens. Returns tok/s, TTFT and TPOT p50
    and the results in request order."""
    errors = []
    t0 = time.perf_counter()
    threads, res = _clients(route, reqs, errors)
    _join(threads, errors)
    wall = time.perf_counter() - t0
    for r, x in zip(reqs, res):
        check(x is not None and x["finish_reason"] == "length"
              and x["num_tokens"] == r["max_tokens"],
              f"{phase}: a request for {r['max_tokens']} tokens ended "
              f"{x and (x['finish_reason'], x['num_tokens'])}")
    n_tok = sum(x["num_tokens"] for x in res)
    out = {"requests": len(reqs), "tokens": n_tok, "wall_s": wall,
           "tok_s": n_tok / wall,
           "ttft_p50_ms": 1e3 * float(np.median([x["ttft_s"] for x in res])),
           "tpot_p50_ms": 1e3 * float(np.median([x["tpot_s"] for x in res])),
           "results": res}
    log(phase, f"{len(reqs)} requests from {N_CLIENTS} clients, {n_tok} "
        f"tokens in {wall:.2f} s = {out['tok_s']:.1f} tok/s, TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms, TPOT p50 {out['tpot_p50_ms']:.2f} "
        f"ms; {card}")
    return out


def _free(*servers):
    for s in servers:
        s.shutdown()
    gc.collect()
    torch.cuda.empty_cache()


def _ledger_requests():
    from ray_tpu_torch.observability.accounting import tenant_ledger

    return sum(t["requests"] for t in tenant_ledger().snapshot().values())


def _tree_ok(trace_id):
    """The span tree of one two-hop request: llm.disagg_prefill and
    llm.disagg_decode under the root, each over its engine's llm.request,
    kv.migrate under the decode side's, nothing orphaned."""
    from ray_tpu_torch.util import tracing

    tree = tracing.build_trace_tree(tracing.span_events(trace_id))
    root = tree["root"]
    if root is None or tree["orphans"]:
        return False
    kids = {c["name"]: c for c in root["children"]}
    if set(kids) != {"llm.disagg_prefill", "llm.disagg_decode"}:
        return False
    reqs = [c for c in kids["llm.disagg_decode"]["children"]
            if c["name"] == "llm.request"]
    pre = [c for c in kids["llm.disagg_prefill"]["children"]
           if c["name"] == "llm.request"]
    return (len(reqs) == 1 and len(pre) == 1
            and "kv.migrate" in {c["name"] for c in reqs[0]["children"]}
            and pre[0]["attrs"].get("finish_reason") == "prefill")


def phase_disagg(dev, cfg, loader, card):
    """The disaggregated tier at Llama-3-8B full width and depth (int8,
    the paged phase's engine config on every server), two servers on the
    one card in one process.

    (1) Bitwise: the mix one request at a time, all two-hop, through a
    fresh PrefillServer/DecodeServer pair, then in the same order through
    a fresh monolithic paged server: equal greedy tokens for every
    request. (2) The mix from four client threads on a fresh warmed pair,
    the reference router's split: tok/s, TTFT and TPOT p50, migration
    cost per two-hop request (export: the gather and device-to-host copy;
    adopt: the kv.migrate span; bytes); gates: the token counter against
    the meters, one ledger row per request, KVImporter's blocks and bytes
    against the adopted states', every two-hop span tree. Then one
    profile window over the prefill server and one over the decode
    server, on half a second mix (seed 1) split by hop. (3) A speculative
    decode server (the default random draft) adopting from the prefill
    server: B1 launches = draft layers x draft prefills, then B1 on an
    adopted request's real draft q/k/v. (4) A fresh monolithic server on
    the same mix from the same state (tok/s, TTFT, TPOT, agreement), then
    the peer pull: it donates a 256-token-prefix prompt's chain to a
    fresh receiver, which promotes every exported block, prefills only
    the suffix and decodes what the donor does on a pool hit of the same
    depth. (5) The hooks' host cost: HOOK_PAIRS pairs of fresh servers
    with serve_accounting_instrumentation on and off, alternating which
    runs first, each on the same mix after the same warm-up."""
    from ray_tpu_torch.observability.accounting import TokenReconciler
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import (DecodeServer, KVImporter,
                                         LLMServer, PrefillServer)
    from ray_tpu_torch.serve.llm.engine import Request
    from ray_tpu_torch.util import tracing

    reqs = disagg_mix(cfg.vocab_size)
    two = [r for r in reqs if len(r["prompt"]) >= PREFILL_THRESHOLD]

    def server(cls, **kw):
        return cls(model_config=cfg, engine_config=dict(PAGED_ENGINE),
                   params_loader=loader, device=dev, **kw)

    # (1) Bitwise, one request at a time.
    pre, dec = server(PrefillServer), server(DecodeServer)
    hop = [_two_hop(pre, dec, r)[0]["tokens"] for r in reqs]
    _free(pre, dec)
    del pre, dec
    mono = server(LLMServer)
    whole_one = [mono(r)["tokens"] for r in reqs]
    _free(mono)
    del mono
    same = sum(a == b for a, b in zip(hop, whole_one))
    log("disagg", f"bitwise: two-hop == monolithic greedy tokens for "
        f"{same} of {len(reqs)} requests, one at a time (int8, "
        f"{cfg.n_layers} layers); {card}")
    check(same == len(reqs), "two-hop tokens differ from the monolithic "
          "server's")

    # (2) The concurrent mix on a fresh warmed pair.
    pre, dec = server(PrefillServer), server(DecodeServer)
    warm(pre, cfg)
    warm(dec, cfg)
    exports = []
    export_state = pre._engine._export_state

    def timed_export(slot):
        t0 = time.perf_counter()
        st = export_state(slot)
        exports.append(time.perf_counter() - t0)
        return st

    pre._engine._export_state = timed_export
    importer = KVImporter(dec._engine)
    route = _DisaggClient(pre, dec)
    rows0, mig0 = _ledger_requests(), importer.stats()
    with TokenReconciler() as rec:
        pair = _concurrent(route, reqs, "disagg", card)
    rows = _ledger_requests() - rows0
    mig = {k: v - mig0[k] for k, v in importer.stats().items()}
    states = route.states
    check(len(states) == len(two) and len(route.traces) == len(two),
          f"{len(states)} two-hop requests, expected {len(two)}")
    check(rec.meter_sum == sum(x["num_tokens"] for x in pair["results"])
          and rec.counter_delta - rec.meter_sum == len(two),
          f"token counter against the meters: {rec.detail()} (expected "
          f"the counter {len(two)} ahead: each two-hop request's first "
          f"token is counted on both hops)")
    check(rows == len(reqs) and len(rec._rows) == len(reqs),
          f"{rows} ledger rows ({len(rec._rows)} folded) for "
          f"{len(reqs)} requests")
    want = {"blocks": sum(s.n_blocks for s in states),
            "bytes": sum(s.payload_bytes for s in states)}
    check(mig == want, f"KVImporter {mig} != the adopted states' {want}")
    bad = [t for t in route.traces if not _tree_ok(t)]
    check(not bad, f"{len(bad)} two-hop span trees malformed")
    spans = {t: tracing.span_events(t) for t in route.traces}
    adopt_ms = [1e3 * e["dur"] for ev in spans.values() for e in ev
                if e["name"] == "kv.migrate"]
    migration = {
        "export_ms_p50": 1e3 * float(np.median(exports)),
        "export_ms_max": 1e3 * max(exports),
        "adopt_ms_p50": float(np.median(adopt_ms)),
        "adopt_ms_max": max(adopt_ms),
        "mib_p50": float(np.median([s.payload_bytes for s in states]))
        / 2**20,
        "blocks": want["blocks"], "bytes": want["bytes"],
        "requests": len(states)}
    log("disagg", f"migration per two-hop request ({len(states)}): export "
        f"(gather + pageable device-to-host copy) p50 "
        f"{migration['export_ms_p50']:.2f} ms, max "
        f"{migration['export_ms_max']:.2f}; adopt (kv.migrate) p50 "
        f"{migration['adopt_ms_p50']:.2f} ms, max "
        f"{migration['adopt_ms_max']:.2f}; payload p50 "
        f"{migration['mib_p50']:.1f} MiB ({want['blocks']} blocks, "
        f"{want['bytes'] / 2**20:.0f} MiB in all); token counter "
        f"{rec.counter_delta:.0f} = meters {rec.meter_sum:.0f} + "
        f"{len(two)} migrated first tokens; {rows} ledger rows; "
        f"{len(route.traces)} span trees whole; {card}")

    # Profiles: the first half of a second mix (its first six requests:
    # four on the shared prefix, a long and a short prompt; half, to leave
    # the run's time to the Serve phase), each hop in a window of its own.
    prof = disagg_mix(cfg.vocab_size, seed=1)[:6]
    ptwo = [r for r in prof if len(r["prompt"]) >= PREFILL_THRESHOLD]
    pshort = [r for r in prof if len(r["prompt"]) < PREFILL_THRESHOLD]
    results = [None] * len(ptwo)

    def prefill_all():
        errs = []
        th, res = _clients(pre.prefill, ptwo, errs)
        _join(th, errs)
        results[:] = res

    def decode_all():
        errs = []
        jobs = [("adopt", x, r) for x, r in zip(results, ptwo)] + \
            [("call", None, r) for r in pshort]

        def run(job):
            kind, res, r = job
            return dec.adopt(res, r) if kind == "adopt" else dec(r)

        th, _ = _clients(run, jobs, errs)
        _join(th, errs)

    profiles = {"prefill": profile_window("disagg prefill profile",
                                          prefill_all, card),
                "decode": profile_window("disagg decode profile",
                                         decode_all, card)}
    _free(dec)
    del dec

    # (3) A speculative decode server adopting from the prefill server.
    spec = server(DecodeServer, speculative={"draft_seed": 0})
    eng = spec._engine
    dc = eng.draft_config
    warm(spec, cfg)
    p0 = eng.stats()["spec"]["draft_prefills"]
    attention.flash_fwd_cuda.launches = 0
    spec_route = _DisaggClient(pre, spec)
    spec_out = _concurrent(spec_route, two, "disagg spec", card)
    b1 = attention.flash_fwd_cuda.launches
    prefills = eng.stats()["spec"]["draft_prefills"] - p0
    fits = sum(len(r["prompt"]) <= ENGINE["prefill_buckets"][-1]
               for r in two)
    check(prefills == fits and b1 == dc.n_layers * prefills and b1 > 0,
          f"B1 launches {b1} != {dc.n_layers} draft layers x {prefills} "
          f"draft prefills ({fits} adopted prompts fit a bucket)")
    agree = sum(a["tokens"] == b["tokens"] for a, b in
                zip(spec_out["results"],
                    [x for r, x in zip(reqs, pair["results"])
                     if len(r["prompt"]) >= PREFILL_THRESHOLD]))
    log("disagg spec", f"a speculative decode server (draft {dc.n_layers} "
        f"layers, head dim {dc.head_dim}) adopted {len(two)} checkpoints: "
        f"B1 launches {b1} = {dc.n_layers} x {prefills} draft prefills "
        f"(the {len(two) - fits} longer than the largest bucket decode "
        f"without a draft); tokens equal to the plain decode server's for "
        f"{agree} of {len(two)} (bf16/int8, printed, not required); {card}")
    _free(pre, spec)
    del pre
    draft_used = check_draft_b1(eng, next(
        r["prompt"] for r in two
        if len(r["prompt"]) <= ENGINE["prefill_buckets"][-1]), "disagg spec")
    del spec, eng

    # (4) The monolithic server on the same mix from the same state, then
    # the peer pull from it to a fresh receiver.
    mono = server(LLMServer)
    warm(mono, cfg)
    whole = _concurrent(mono, reqs, "disagg monolithic", card)
    agree_mono = sum(a["tokens"] == b["tokens"]
                     for a, b in zip(pair["results"], whole["results"]))
    log("disagg", f"two-hop pair {pair['tok_s']:.1f} tok/s, TTFT p50 "
        f"{pair['ttft_p50_ms']:.1f} ms, TPOT p50 {pair['tpot_p50_ms']:.2f} "
        f"ms; monolithic {whole['tok_s']:.1f} tok/s, TTFT p50 "
        f"{whole['ttft_p50_ms']:.1f} ms, TPOT p50 "
        f"{whole['tpot_p50_ms']:.2f} ms ({pair['tok_s'] / whole['tok_s']:.3f}"
        f"x); tokens equal for {agree_mono} of {len(reqs)} requests "
        f"(concurrent: printed, not required); {card}")
    rng = np.random.RandomState(5)
    prompt = reqs[0]["prompt"][:SYS_PREFIX]
    while len(prompt) % 16 == 0 or len(prompt) == SYS_PREFIX:
        prompt = reqs[0]["prompt"][:SYS_PREFIX] + rng.randint(
            0, cfg.vocab_size, int(rng.randint(60, 200))).tolist()

    def serve(s):
        h = s._engine.submit(Request(prompt=prompt, max_tokens=16))
        h.result(timeout=300)
        return h

    serve(mono)
    donor = serve(mono)
    links = mono.export_prefix(prompt)
    recv = server(LLMServer)
    t0 = recv.stats()["kv_tiers"]
    imported = recv.import_prefix(links)
    got = serve(recv)
    t1 = recv.stats()["kv_tiers"]
    promoted = t1["promoted_blocks"] - t0["promoted_blocks"]
    suffix = len(prompt) - len(links) * 16
    check(imported == len(links) == len(prompt) // 16 and
          promoted == len(links),
          f"peer pull: {len(links)} links exported, {imported} imported, "
          f"{promoted} promoted")
    check(got.prefilled_tokens == suffix == donor.prefilled_tokens,
          f"peer pull: the receiver prefilled {got.prefilled_tokens} "
          f"tokens, the donor {donor.prefilled_tokens}, the suffix is "
          f"{suffix}")
    check(got.tokens == donor.tokens, "peer pull: the receiver's tokens "
          "differ from the donor's pool hit")
    log("disagg", f"peer pull: a {len(prompt)}-token prompt's {len(links)} "
        f"blocks ({sum(x.payload_bytes for x in links) / 2**20:.0f} MiB) "
        f"exported, imported and promoted; {suffix} suffix tokens "
        f"prefilled; tokens == the donor's pool hit ({len(got.tokens)}); "
        f"{card}")
    _free(mono, recv)
    del mono, recv

    # (5) The hooks' host cost: HOOK_PAIRS pairs of fresh servers, the
    # accounting knob (latched at engine init) on and off, alternating
    # which side runs first, on the same mix from the same state.
    hooks = {"on": [], "off": []}
    for i in range(HOOK_PAIRS):
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            os.environ["RAY_TPU_serve_accounting_instrumentation"] = \
                "1" if side == "on" else "0"
            try:
                s = server(LLMServer)
            finally:
                os.environ.pop("RAY_TPU_serve_accounting_instrumentation")
            check(s._engine._acct is (side == "on"),
                  f"accounting not {side} on a server built with it {side}")
            warm(s, cfg)
            hooks[side].append(_concurrent(
                s, reqs, f"disagg accounting {side} ({i + 1})", card))
            _free(s)
            del s
    ratios = [a["tok_s"] / b["tok_s"]
              for a, b in zip(hooks["on"], hooks["off"])]

    def med(side, key):
        return float(np.median([r[key] for r in hooks[side]]))

    hooks_cost = {
        "pairs": HOOK_PAIRS, "tok_s_ratio": ratios,
        "tok_s_ratio_median": float(np.median(ratios)),
        **{f"{side}_{key}": [r[key] for r in hooks[side]]
           for side in hooks for key in ("tok_s", "ttft_p50_ms",
                                         "tpot_p50_ms")}}
    log("disagg", f"accounting on/off tok/s over {HOOK_PAIRS} alternating "
        f"pairs: " + ", ".join(f"{r:.3f}x" for r in ratios)
        + f" (median {hooks_cost['tok_s_ratio_median']:.3f}x); median on "
        f"{med('on', 'tok_s'):.1f} tok/s, TTFT p50 "
        f"{med('on', 'ttft_p50_ms'):.1f} ms, TPOT p50 "
        f"{med('on', 'tpot_p50_ms'):.2f} ms; off {med('off', 'tok_s'):.1f}"
        f" tok/s, TTFT p50 {med('off', 'ttft_p50_ms'):.1f} ms, TPOT p50 "
        f"{med('off', 'tpot_p50_ms'):.2f} ms; {card}")

    def strip(d):
        return {k: v for k, v in d.items() if k != "results"}

    return {"bitwise_requests": len(reqs), "monolithic_tokens": whole_one,
            "pair": strip(pair),
            "monolithic": strip(whole), "agreement": agree_mono,
            "migration": migration, "profiles": profiles,
            "spec": {"b1_launches": b1, "draft_prefills": prefills,
                     "agreement": agree, "tok_s": spec_out["tok_s"],
                     "draft_b1_tol_used": draft_used},
            "peer_pull": {"blocks": len(links), "promoted": promoted,
                          "suffix_tokens": suffix},
            "hooks_cost": hooks_cost}


def phase_disagg_gates(dev, card):
    """At Llama-3-8B widths, 4 layers: two-hop (prefill engine, then
    submit_adopted on a decode engine) equal to one paged engine, bit for
    bit in bf16 and token for token in f32, where both also equal
    ``generate``; then a PrefillServer feeding a
    DecodeServer(speculative=True) in f32 gives the plain paged engine's
    tokens for every request, and B1 on that draft's real prefills."""
    from ray_tpu_torch.models.llama import generate, init_params
    from ray_tpu_torch.serve.llm import DecodeServer, PrefillServer
    from ray_tpu_torch.serve.llm.engine import (EngineConfig, LLMEngine,
                                                Request)

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = _gate_cfg(dtype)
        params = init_params(cfg, 6, dev)
        rng = np.random.RandomState(13)

        def toks(n):
            return rng.randint(0, cfg.vocab_size, n).tolist()

        sys_p = toks(SYS_PREFIX)
        reqs = [(sys_p + toks(40), 10), (sys_p + toks(120), 10),
                (toks(700), 8), (toks(100), 10)]
        geo = dict(PAGED_ENGINE, num_slots=4)

        def engine():
            return LLMEngine(params, cfg, EngineConfig(**geo), device=dev)

        pe, de, mono = engine(), engine(), engine()
        hop, whole = [], []
        with torch.no_grad():
            for p, n in reqs:
                chunk = len(p) > ENGINE["prefill_buckets"][-1]
                h = pe.submit(Request(prompt=p, max_tokens=n,
                                      prefill_only=True,
                                      chunked_prefill=chunk))
                pe.drain()
                h2 = de.submit_adopted(Request(prompt=p, max_tokens=n),
                                       h.kv_state)
                de.drain()
                hop.append(h2.tokens)
                h3 = mono.submit(Request(prompt=p, max_tokens=n,
                                         chunked_prefill=chunk))
                mono.drain()
                whole.append(h3.tokens)
            check(hop == whole, f"{dtype}: two-hop tokens differ from the "
                  f"paged engine's")
            name = str(dtype).rsplit(".", 1)[-1]
            if dtype == torch.float32:
                ref = [generate(params, torch.tensor([p], device=dev), cfg,
                                max_new_tokens=n)[0].tolist()
                       for p, n in reqs]
                check(hop == ref, "f32: two-hop tokens differ from "
                      "generate")
                servers = [PrefillServer(
                    model_config=cfg, engine_config=geo,
                    params_loader=lambda: params, quantize="bf16",
                    device=dev), DecodeServer(
                    model_config=cfg, engine_config=dict(geo, spec_k=SPEC_K),
                    params_loader=lambda: params, quantize="bf16",
                    speculative=True, device=dev)]
                try:
                    spec = [servers[1].adopt(servers[0].prefill(
                        {"prompt": p, "max_tokens": n}),
                        {"prompt": p, "max_tokens": n})["tokens"]
                        for p, n in reqs]
                    rounds = servers[1].stats()["spec"]["rounds"]
                finally:
                    for s in servers:
                        s.shutdown()
                check(rounds > 0, "the speculative decode server ran no "
                      "round")
                check(spec == whole, "f32: the speculative decode server's "
                      "tokens differ from the paged engine's")
                out["draft_b1_tol_used"] = check_draft_b1(
                    servers[1]._engine, reqs[0][0], "disagg gates")
                out["spec_rounds"] = rounds
                del servers
            out[name] = len(reqs)
        del pe, de, mono, params
        gc.collect()
        torch.cuda.empty_cache()
    log("disagg gates", f"Llama-3-8B widths, {GATE_LAYERS} layers: two-hop "
        f"== paged engine bit for bit in bf16 ({out['bfloat16']} requests: "
        f"prefix hits, a chunked 700-token prompt, a short one); f32: "
        f"two-hop == paged == generate, and a speculative decode server "
        f"({out['spec_rounds']} rounds) adopting the prefill server's "
        f"checkpoints == paged for {out['float32']}; {card}")
    return out


RUNTIME_CONCURRENCY = 8          # covers every client thread
RUNTIME_PEND_S = 3.0             # a second whole-GPU actor must wait this
RUNTIME_CUDA_MIB, RUNTIME_HOST_MIB = 64, 1024
# Per weight: the stacked layers the fingerprint reads (first and last).
FINGERPRINT = ("wq", "wo", "w_down")


def weight_fingerprint(params):
    """Sum and hash of the int8 weights and scales of the first and last
    layer and of the embedding: equal trees give equal fingerprints."""
    import hashlib

    layers, last = params["layers"], params["layers"]["wq_q"].shape[0] - 1
    tensors = {"embed": params["embed"]}
    for name in FINGERPRINT:
        for part in ("_q", "_s"):
            for i in (0, last):
                tensors[f"{name}{part}[{i}]"] = layers[name + part][i]
    out = {}
    for key, t in sorted(tensors.items()):
        host = t.detach().contiguous().cpu()
        raw = host.view(torch.uint8).numpy().tobytes()
        out[key] = (float(host.double().sum()),
                    hashlib.blake2b(raw, digest_size=16).hexdigest())
    return out


def _cluster_pids():
    """Every live process below this one, with its command line (the
    runtime's GCS, raylet and workers)."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if fields[0] != "Z":
            children.setdefault(int(fields[1]), []).append(int(entry))
    out, todo = {}, [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), []):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    out[pid] = [a.decode() for a in f.read().split(b"\0")
                                if a]
            except OSError:
                continue
            todo.append(pid)
    return out


def _alive(pid, cmd):
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            now = [a.decode() for a in f.read().split(b"\0") if a]
    except (OSError, IndexError):
        return False
    return state != "Z" and now == cmd


def gpu_memory_used_mib() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def _actor_classes(rt):
    """The runtime phase's actors (defined here so that the script's
    import of the port is the workers' too)."""

    @rt.remote(num_gpus=1, max_concurrency=RUNTIME_CONCURRENCY)
    class ServeActor:
        """``LLMServer`` at the serve phase's config on the leased card;
        built without ``device=``, so it raises where there is none."""

        def __init__(self, cfg, engine):
            from ray_tpu_torch.serve.llm import LLMServer

            t0 = time.perf_counter()
            self.server = LLMServer(cfg, dict(engine),
                                    init_seed=0, quantize="int8")
            self.build_s = time.perf_counter() - t0
            self._prefills0 = 0

        def info(self):
            import ray_tpu_torch

            return {"gpu_ids": ray_tpu_torch.get_gpu_ids(),
                    "cuda_visible_devices":
                        os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device_name": torch.cuda.get_device_name(),
                    "foreign_modules": sorted(
                        m for m in sys.modules
                        if m.split(".")[0] in ("jax", "ray_tpu")),
                    "build_s": self.build_s, "pid": os.getpid()}

        def fingerprint(self):
            return weight_fingerprint(self.server._engine.params)

        def serve(self, request):
            return self.server(request)

        def reset_counts(self):
            from ray_tpu_torch.ops import attention

            self._prefills0 = self.server.stats()["prefills"]
            attention.flash_fwd_cuda.launches = 0

        def counts(self):
            from ray_tpu_torch.ops import attention

            return {"b1_launches": attention.flash_fwd_cuda.launches,
                    "prefills": self.server.stats()["prefills"]
                    - self._prefills0}

    @rt.remote(num_gpus=1)
    class CardProbe:
        def devices(self):
            """The lease; also makes this process's CUDA context, so that
            the timed get below does not pay for it."""
            import ray_tpu_torch

            torch.zeros(1, device="cuda")
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    ray_tpu_torch.get_gpu_ids())

        def roundtrip(self, refs):
            """get() a tensor put by the driver (refs nested, so the get
            is this actor's) and hand it back."""
            import ray_tpu_torch

            t0 = time.perf_counter()
            t = ray_tpu_torch.get(refs[0], timeout=120)
            torch.cuda.synchronize()
            return {"tensor": t, "get_s": time.perf_counter() - t0,
                    "device": str(t.device)}

    @rt.remote(num_gpus=0.5)
    def half_gpu():
        import ray_tpu_torch

        time.sleep(1.0)
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                ray_tpu_torch.get_gpu_ids())

    return ServeActor, CardProbe, half_gpu


def _timed_mix(call, reqs, label, card, phase="runtime"):
    """The 12 requests from 4 client threads through ``call``: tok/s,
    TTFT and TPOT p50 (the engine's), and the client's latency p50."""
    lat = {}

    def timed(r):
        t0 = time.perf_counter()
        res = call(r)
        lat[id(r)] = time.perf_counter() - t0
        return res

    errors = []
    t0 = time.perf_counter()
    threads, results = _clients(timed, reqs, errors)
    _join(threads, errors)
    wall = time.perf_counter() - t0
    for r, res in zip(reqs, results):
        check(res is not None and res["num_tokens"] == r["max_tokens"],
              f"{label}: a request ended {res and res['finish_reason']}")
    n_tok = sum(res["num_tokens"] for res in results)
    out = {"tok_s": n_tok / wall, "wall_s": wall, "tokens": n_tok,
           "ttft_p50_ms": 1e3 * float(np.median([r["ttft_s"]
                                                 for r in results])),
           "tpot_p50_ms": 1e3 * float(np.median([r["tpot_s"]
                                                 for r in results])),
           "latency_p50_ms": 1e3 * float(np.median(list(lat.values())))}
    log(phase, f"{label}: {len(reqs)} requests, {n_tok} tokens in "
        f"{wall:.2f} s = {out['tok_s']:.1f} tok/s, TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms, TPOT p50 {out['tpot_p50_ms']:.2f} "
        f"ms, client latency p50 {out['latency_p50_ms']:.0f} ms; {card}")
    return out


def _bits_equal(a, b):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()])))


def _put_stages(value):
    """One put of ``value`` into the node's store, each stage of the
    driver's ``_plasma_put`` timed on its own (ms): serialize (a CUDA
    tensor's copy to the host included), the raylet's create, mapping
    the extent into this process (its pages faulted in), the copy into
    it, and the seal, with the extent's offset in the arena (MiB). It
    first waits for room, so that no spill or eviction runs inside the
    timed create; the object is deleted after."""
    from ray_tpu_torch._private import worker as rt_worker
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import WritableObject

    w = rt_worker.global_worker()
    need = value.numel() * value.element_size() + (1 << 20)
    deadline = time.monotonic() + 60
    while True:
        gc.collect()
        w.drain_releases()
        st = w.raylet.call("store_stats")
        if st["used"] + need <= st["capacity"]:
            break
        check(time.monotonic() < deadline, f"no room in the store for a "
              f"{need >> 20} MiB put: {st}")
        time.sleep(0.2)
    oid = ObjectID.from_random().binary()
    marks = [time.perf_counter()]
    sobj = w.serialization.serialize(value)
    marks.append(time.perf_counter())
    reply = w.raylet.call("create_object", object_id=oid,
                          size=sobj.total_size)
    marks.append(time.perf_counter())
    wobj = WritableObject(reply["path"], sobj.total_size,
                          reply.get("offset", 0))
    marks.append(time.perf_counter())
    try:
        sobj.write_into(wobj.view)
    finally:
        wobj.close()
    marks.append(time.perf_counter())
    w.raylet.call("seal_object", object_id=oid, pin=True)
    marks.append(time.perf_counter())
    w.raylet.call("delete_objects", object_ids=[oid])
    after = w.raylet.call("store_stats")
    check((after["num_spills"], after["num_evictions"])
          == (st["num_spills"], st["num_evictions"]),
          "the store spilled or evicted during a timed put")
    stages = {stage: 1e3 * (b - a) for stage, a, b in zip(
        ("serialize", "create", "map", "copy", "seal"), marks, marks[1:])}
    return dict(stages, offset_mib=reply.get("offset", 0) / 2**20)


def _stages_text(st):
    return (", ".join(f"{k} {st[k]:.1f}" for k in
                      ("serialize", "create", "map", "copy", "seal"))
            + f" ms, at {st['offset_mib']:.1f} MiB in the arena")


def phase_runtime(dev, card, serve_tokens):
    """Llama-3-8B served from a GPU actor of the port's runtime: start a
    cluster with no resource arguments (the card detected as GPU: 1 and
    GPU-H100), check that it spawned only the port's processes, build
    the serve phase's int8 server in a num_gpus=1 actor and the same
    server in this process, compare their weights, hold the actor's
    greedy tokens one request at a time to the serve phase's in-process
    tokens (``serve_tokens``), time the 12-request mix from 4 client
    threads through each (in-process, actor, actor, in-process), count
    B1 in the actor, check that a second GPU actor waits for the card,
    move tensors through the object store, and tear down."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.llm import LLMServer

    cfg = serve_config()
    mem0 = gpu_memory_used_mib()
    out = {"card": card}
    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    rt.init()
    out["start_s"] = time.perf_counter() - t0
    try:
        res = rt.cluster_resources()
        out["resources"] = res
        log("runtime", f"cluster up in {out['start_s']:.2f} s: {res}")
        check(res.get("GPU") == 1 and res.get("GPU-H100", 0) > 0,
              f"the card was not detected as GPU 1 / GPU-H100: {res}")
        ServeActor, CardProbe, half_gpu = _actor_classes(rt)

        t0 = time.perf_counter()
        actor = ServeActor.remote(cfg, ENGINE)
        info = rt.get(actor.info.remote(), timeout=600)
        out["actor_ready_s"] = time.perf_counter() - t0
        out["actor_build_s"] = info["build_s"]
        procs = _cluster_pids()
        foreign = {p: c for p, c in procs.items()
                   if "-m" not in c
                   or not c[c.index("-m") + 1].startswith("ray_tpu_torch.")}
        log("runtime", f"actor ready in {out['actor_ready_s']:.1f} s "
            f"(server built in {info['build_s']:.1f} s); gpu ids "
            f"{info['gpu_ids']}, CUDA_VISIBLE_DEVICES="
            f"{info['cuda_visible_devices']!r}, {info['device_name']}; "
            f"{len(procs)} cluster processes, all ray_tpu_torch.: "
            f"{not foreign}")
        check(len(procs) >= 3 and not foreign,
              f"processes that are not the port's: {foreign}")
        check(info["foreign_modules"] == [],
              f"the actor loaded {info['foreign_modules']}")
        check(info["gpu_ids"] == [0]
              and info["cuda_visible_devices"] == "0",
              f"the actor's lease: {info}")
        check("H100" in info["device_name"],
              f"the actor's card is {info['device_name']}")

        t0 = time.perf_counter()
        local = LLMServer(cfg, dict(ENGINE), init_seed=0, quantize="int8",
                          device=dev)
        out["local_build_s"] = time.perf_counter() - t0
        try:
            mine = weight_fingerprint(local._engine.params)
            theirs = rt.get(actor.fingerprint.remote(), timeout=600)
            check(mine == theirs, "the actor's weights differ from the "
                  "in-process server's")
            out["fingerprint_tensors"] = len(mine)
            warm_req = {"prompt": [1] * 128, "max_tokens": 2}
            local(warm_req)
            rt.get(actor.serve.remote(warm_req), timeout=600)
            reqs = serve_requests(cfg)
            # The in-process side's tokens are the serve phase's (the same
            # server config, weights and requests), as 6h's are.
            same = 0
            for r, want in zip(reqs, serve_tokens):
                a = rt.get(actor.serve.remote(r), timeout=600)["tokens"]
                same += a == want
            out["tokens_equal"] = f"{same}/{len(reqs)}"
            log("runtime", f"{len(mine)} weight tensors equal; greedy "
                f"tokens one at a time, actor == the serve phase's "
                f"in-process tokens: {out['tokens_equal']}")
            check(same == len(reqs), f"actor tokens differ: "
                  f"{out['tokens_equal']}")

            def through_actor(r):
                return rt.get(actor.serve.remote(r), timeout=600)

            runs = []
            for i, side in enumerate(("in-process", "actor", "actor",
                                      "in-process")):
                if side == "actor" and i == 1:
                    rt.get(actor.reset_counts.remote(), timeout=60)
                call = through_actor if side == "actor" else local
                runs.append((side, _timed_mix(call, reqs, f"mix {i + 1} "
                                              f"({side})", card)))
                if side == "actor" and i == 1:
                    counts = rt.get(actor.counts.remote(), timeout=60)
            del call                     # it may hold the in-process server
            out["mix"] = runs
            for key in ("tok_s", "ttft_p50_ms", "tpot_p50_ms",
                        "latency_p50_ms"):
                a = np.mean([m[key] for s, m in runs if s == "actor"])
                b = np.mean([m[key] for s, m in runs if s == "in-process"])
                out[f"actor_over_local_{key}"] = float(a / b)
            out["b1_launches"] = counts["b1_launches"]
            log("runtime", f"actor / in-process: tok/s "
                f"{out['actor_over_local_tok_s']:.3f}, TTFT p50 "
                f"{out['actor_over_local_ttft_p50_ms']:.3f}, TPOT p50 "
                f"{out['actor_over_local_tpot_p50_ms']:.3f}; B1 launches "
                f"in the actor {counts['b1_launches']} for "
                f"{counts['prefills']} prefills")
            check(counts["prefills"] == len(reqs)
                  and counts["b1_launches"] == cfg.n_layers * len(reqs),
                  f"B1 in the actor: {counts}, want {cfg.n_layers} x "
                  f"{len(reqs)}")
        finally:
            local.shutdown()
            del local
            gc.collect()
            torch.cuda.empty_cache()

        probe = CardProbe.remote()
        pending = probe.devices.remote()
        ready, _ = rt.wait([pending], timeout=RUNTIME_PEND_S)
        check(ready == [], "a second num_gpus=1 actor started while the "
              "serving actor held the card")
        rt.kill(actor)
        got = rt.get(pending, timeout=300)
        log("runtime", f"second GPU actor pended {RUNTIME_PEND_S:.0f} s, "
            f"then ran after the kill with {got}")
        check(got == ("0", [0]), f"the second actor's lease: {got}")

        n = RUNTIME_CUDA_MIB << 19                   # bf16 elements
        x = torch.randn(n // 4096, 4096, device=dev).to(torch.bfloat16)
        # Each tensor is put twice by stage before its timed put, so
        # that the first lands on arena pages no put has touched.
        out["cuda_put_stages"] = [_put_stages(x) for _ in range(2)]
        t0 = time.perf_counter()
        ref = rt.put(x)
        out["cuda_put_ms"] = 1e3 * (time.perf_counter() - t0)
        back = rt.get(probe.roundtrip.remote([ref]), timeout=300)
        out["cuda_get_in_actor_ms"] = 1e3 * back["get_s"]
        check(back["device"].startswith("cuda"), f"the tensor came back "
              f"on {back['device']}")
        check(_bits_equal(back["tensor"], x), "the CUDA tensor changed "
              "on its way through the store")
        rt.kill(probe)
        del back, ref, x

        deadline = time.monotonic() + 60
        while rt.available_resources().get("GPU", 0) < 1:
            check(time.monotonic() < deadline, "the GPU was not released")
            time.sleep(0.1)
        halves = rt.get([half_gpu.remote(), half_gpu.remote()], timeout=120)
        check(halves == [("0", [0]), ("0", [0])],
              f"two num_gpus=0.5 tasks: {halves}")

        from ray_tpu_torch._private import object_store
        import ctypes

        y = torch.rand(RUNTIME_HOST_MIB << 18)        # f32 elements
        out["host_put_stages"] = [_put_stages(y) for _ in range(2)]
        t0 = time.perf_counter()
        ref = rt.put(y)
        out["host_put_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        z = rt.get(ref, timeout=300)
        out["host_get_ms"] = 1e3 * (time.perf_counter() - t0)
        spans = [(ctypes.addressof(ctypes.c_char.from_buffer(m)), len(m))
                 for m in object_store._client_arenas.values()]
        ptr, nbytes = z.data_ptr(), z.numel() * 4
        check(any(lo <= ptr and ptr + nbytes <= lo + size
                  for lo, size in spans), "the host tensor's get was copied")
        check(_bits_equal(z, y), "the host tensor changed in the store")
        del z, ref, y
        log("runtime", f"objects: {RUNTIME_CUDA_MIB} MiB bf16 CUDA tensor "
            f"put {out['cuda_put_ms']:.1f} ms, get in a GPU actor "
            f"{out['cuda_get_in_actor_ms']:.1f} ms, back on CUDA bit for "
            f"bit; {RUNTIME_HOST_MIB} MiB f32 CPU tensor put "
            f"{out['host_put_ms']:.1f} ms, get {out['host_get_ms']:.2f} ms "
            f"over the store's memory; two 0.5-GPU tasks on id 0")
        for name in ("cuda", "host"):
            for i, st in enumerate(out[f"{name}_put_stages"]):
                log("runtime", f"{name} put by stage, put {i + 1}: "
                    f"{_stages_text(st)}; {card}")
    finally:
        procs = _cluster_pids()
        rt.shutdown()
    # Workers live in sessions of their own: once the raylet is gone they
    # are nobody's children here, so each recorded pid is looked up.
    deadline = time.monotonic() + 30
    while True:
        left = {p: c for p, c in procs.items() if _alive(p, c)}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"processes left after shutdown: {left}")
    gc.collect()
    torch.cuda.empty_cache()
    out["memory_before_mib"] = mem0
    out["memory_after_mib"] = gpu_memory_used_mib()
    check(abs(out["memory_after_mib"] - mem0) < 1024,
          f"card memory {mem0:.0f} MiB before the phase, "
          f"{out['memory_after_mib']:.0f} MiB after")
    out["phase_s"] = time.perf_counter() - phase_t0
    log("runtime", f"shut down: no cluster process left, card memory "
        f"{mem0:.0f} -> {out['memory_after_mib']:.0f} MiB; the phase took "
        f"{out['phase_s']:.1f} s; {card}")
    return out


SERVE_APP_GPUS = 0.5             # each engine replica's share of the card
GATE_APP_GPUS = 0.25             # the same at 4 layers: four replicas at once
# The cluster of phase 6h: cache affinity only breaks ties (a busy holder
# loses the pick, so the peer pull runs), the prefix index and the
# metrics published often, and every trace kept.
SERVE_APP_SYSTEM = {"serve_router_cache_weight": 0.01,
                    "serve_prefix_index_publish_interval_s": 0.5,
                    "metrics_report_interval_s": 0.5,
                    "trace_sample_rate": 1.0}
# The cache-aware gates (4 layers): a 256-token shared prefix, the
# holder kept busy by a request of this many new tokens.
APP_BUSY_TOKENS = 300
# The store-tier gates: a host tier smaller than one block, so every
# block the pool evicts demotes to the object store. Prompts of 300
# tokens (a chain of 18 blocks), each a 512-bucket prefill of 32 blocks.
# Whole chain: a pool of exactly 32 blocks, so the second prompt evicts
# all 18 cached blocks of the first, whose repeat promotes its whole
# chain. Partial: a pool of 34, so the second prompt evicts only the 16
# coldest, the chain's head (the prefix cache evicts in insertion order,
# as the reference's does); the repeat matches no pool block from the
# head, promotes the 16 links and leaves the 2 still in the pool unused
# (the reference's rule: the tier continues the pool's run from the head).
TIER_PROMPT, TIER_CHAIN = 300, 300 // 16
TIER_ENGINE = {**PAGED_ENGINE, "num_kv_blocks": 32, "kv_host_tier_bytes": 1}
PARTIAL_ENGINE = {**TIER_ENGINE, "num_kv_blocks": 34}
PARTIAL_HEAD = 32 - (34 - TIER_CHAIN)          # the links the pool evicts


def _serve_app_classes():
    """The apps' servers, each with methods that read its process (B1's
    count, the lease) and, for the two-hop timing, the served
    migrations' own store put (the prefill replica's return) and get (the
    decode replica's resolution of the forwarded ref). Defined in a
    function, so that cloudpickle ships them by value and a replica needs
    only the port."""
    from ray_tpu_torch.serve.llm import DecodeServer, LLMServer, PrefillServer

    class Counted:
        def b1(self):
            import ray_tpu_torch
            from ray_tpu_torch.ops import attention

            st = self.stats()
            return {"launches": attention.flash_fwd_cuda.launches,
                    "prefills": st["prefills"],
                    "draft_prefills": st.get("spec", {}).get(
                        "draft_prefills", 0),
                    "pid": os.getpid(),
                    "gpu_ids": ray_tpu_torch.get_gpu_ids(),
                    "cuda_visible_devices":
                        os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(self._engine.device),
                    "foreign": sorted(m for m in sys.modules
                                      if m.split(".")[0]
                                      in ("jax", "ray_tpu"))}

    class AppServer(Counted, LLMServer):
        pass

    def timed(fn, moves, result, before=None):
        """``fn`` timed, after ``before(args)`` if given: one (ms, payload
        bytes) in ``moves`` per call whose ``result(args, out)`` is a dict
        holding a KV checkpoint."""
        def call(*args, **kwargs):
            if before is not None:
                before(args)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            ms = 1e3 * (time.perf_counter() - t0)
            res = result(args, out)
            st = res.get("kv_state") if isinstance(res, dict) else None
            if st is not None:
                moves.append((ms, st.payload_bytes))
            return out
        return call

    class AppPrefill(Counted, PrefillServer):
        def __init__(self, *args, **kwargs):
            """Time this worker's store put of each ``prefill`` return
            (serialize, create, copy, seal): the first hop's migration."""
            from ray_tpu_torch._private.worker import global_worker

            super().__init__(*args, **kwargs)
            self._moves = []
            w = global_worker()
            w._store_returns = timed(w._store_returns, self._moves,
                                     lambda args, out: args[1])

        def migrations(self):
            return list(self._moves)

    class AppDecode(Counted, DecodeServer):
        def __init__(self, *args, **kwargs):
            """Time the replica's get of each forwarded prefill result
            (``Replica.handle_request`` resolves it through
            ``ray_tpu_torch.get``): the second hop's migration. The ref
            arrives before the prefill has ended, so the get is timed
            from the moment the result is in the store."""
            import ray_tpu_torch

            def ready(args):
                if isinstance(args[0], ray_tpu_torch.ObjectRef):
                    wait([args[0]], timeout=300)

            super().__init__(*args, **kwargs)
            self._moves = []
            wait = ray_tpu_torch.wait
            ray_tpu_torch.get = timed(ray_tpu_torch.get, self._moves,
                                      lambda args, out: out, ready)

        def migrations(self):
            return list(self._moves)

    return AppServer, AppPrefill, AppDecode


def _swap(app, cls):
    """Serve ``app``'s deployment with ``cls`` in place of its class."""
    app.deployment = app.deployment.options(func_or_class=cls)
    return app


def _app_replicas(rt, app, deployment, n=1, old=()):
    """The controller's handles on a deployment's replicas, once it has
    ``n`` of them that are not in ``old``."""
    from ray_tpu_torch.serve._private.controller import (
        get_or_create_controller,
    )

    deadline = time.monotonic() + 300
    while True:
        _, reps = rt.get(get_or_create_controller().get_replicas.remote(
            app, deployment), timeout=60)
        reps = [r for r in reps if r._actor_id not in old]
        if len(reps) == n:
            return reps
        check(time.monotonic() < deadline,
              f"{app}/{deployment}: {len(reps)} replicas, want {n}")
        time.sleep(0.2)


def _rcall(rt, replica, method, *args, timeout=900):
    return rt.get(replica.handle_request.remote(method, args, {}),
                  timeout=timeout)


def _poll(fn, timeout=60.0, period=0.1):
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out or time.monotonic() > deadline:
            return out
        time.sleep(period)


def _check_lease(info, what):
    check(info["foreign"] == [], f"{what} loaded {info['foreign']}")
    check(info["gpu_ids"] == [0] and info["cuda_visible_devices"] == "0"
          and info["device"].startswith("cuda"), f"{what}'s lease: {info}")


def _trace_names(node):
    return {node["name"]}.union(*[_trace_names(c)
                                  for c in node["children"]])


def _serve_trace(trace_id, want=("serve.request", "serve.replica_call",
                                 "llm.server_call", "llm.request")):
    """One routed request's span tree from the GCS trace store, once its
    root and ``want`` arrived; None after 60 s."""
    from ray_tpu_torch.util import state

    def tree():
        t = state.get_trace(trace_id)
        return t if (t and t.get("complete") and t.get("root")
                     and set(want) <= _trace_names(t["root"])) else None

    return _poll(tree, timeout=60, period=0.2)


def _ratios(ours, theirs, keys=("tok_s", "ttft_p50_ms", "tpot_p50_ms",
                                "latency_p50_ms")):
    return {k: ours[k] / theirs[k] for k in keys
            if theirs.get(k) and ours.get(k) is not None}


def _ratio_text(r):
    return ", ".join(f"{k} {v:.3f}x" for k, v in r.items())


def _http(port, path, payload=None, timeout=900):
    """(status, decoded JSON body) of one call to the HTTP ingress; a
    payload is sent as a JSON body (a POST), none makes a GET."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _actor_pid(name):
    """The pid of the live named actor's worker process."""
    from ray_tpu_torch.util import state

    wid = next(a["worker_id"] for a in state.list_actors()
               if a["name"] == name and a["state"] != "DEAD")
    return next(int(w["pid"]) for w in state.list_workers()
                if w["worker_id"] == wid)


def _compute_app_pids():
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {int(x) for x in out.stdout.split() if x.strip().isdigit()}


def _off_cuda(pid):
    """What the process of an ingress proxy holds of the card: whether
    ``nvidia-smi`` lists it, whether it maps ``libcuda`` (a CUDA context
    needs it) and its ``CUDA_VISIBLE_DEVICES`` (empty for a worker that
    leases no GPU)."""
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    with open(f"/proc/{pid}/environ", "rb") as f:
        env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                   if b"=" in kv)
    return {"listed": pid in _compute_app_pids(),
            "libcuda": "libcuda" in maps,
            "cuda_visible_devices":
                env.get(b"CUDA_VISIBLE_DEVICES", b"unset").decode()}


def _ingress_toys(rt, serve, port, card):
    """A ``stream=True`` deployment's chunks over HTTP, in order and each
    its own chunk, and an ``@serve.batch`` deployment under 4 HTTP
    clients forming batches larger than 1."""
    import urllib.request

    @serve.deployment(stream=True, num_cpus=0.1, name="Chunks")
    class Chunks:
        def __call__(self, n=4):
            for i in range(int(n)):
                time.sleep(0.05)
                yield f"chunk {i}\n"

    @serve.deployment(num_cpus=0.1, max_ongoing_requests=16, name="Batcher")
    class Batcher:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def handle(self, items):
            self.sizes.append(len(items))
            return [x + 1000 for x in items]

        def __call__(self, x):
            return self.handle(x)

        def batch_sizes(self):
            return self.sizes

    serve.run(Chunks.bind(), name="chunks")
    batcher = serve.run(Batcher.bind(), name="batcher")
    proxy = rt.get_actor("SERVE_PROXY")
    check(_poll(lambda: {"chunks", "batcher"} <= set(rt.get(
        proxy.stats.remote(), timeout=60)["routes"]), timeout=30),
        "the proxy's routes never named the toy apps")
    req = urllib.request.Request(f"http://127.0.0.1:{port}/chunks",
                                 data=b"6")
    t0 = time.perf_counter()
    lines, at = [], []
    with urllib.request.urlopen(req, timeout=120) as resp:
        chunked = resp.headers.get("Transfer-Encoding") == "chunked"
        for line in resp:
            lines.append(line.decode())
            at.append(1e3 * (time.perf_counter() - t0))
    check(chunked and lines == [f"chunk {i}\n" for i in range(6)],
          f"streamed chunks over HTTP: {lines} (chunked {chunked})")
    errors = []
    got = [None] * 16

    def post(i):
        got[i] = _http(port, "/batcher", i, timeout=120)

    threads, _ = _clients(post, list(range(16)), errors)
    _join(threads, errors)
    sizes = batcher.batch_sizes.remote().result(timeout=60)
    check(got == [(200, {"result": i + 1000}) for i in range(16)]
          and sum(sizes) == 16 and max(sizes) > 1,
          f"@serve.batch over HTTP: batches {sizes}, replies {got}")
    log("serve-app", f"ingress toys: 6 chunks of a stream=True deployment "
        f"in order over HTTP, line i read at "
        f"{', '.join(f'{t:.0f}' for t in at)} ms (each chunk flushed as "
        f"it came); @serve.batch under 4 HTTP clients formed batches "
        f"{sizes}; {card}")
    serve.delete("chunks")
    serve.delete("batcher")
    return {"chunk_ms": at, "batch_sizes": sizes}


def _serve_ingress(rt, serve, reqs, reps, serve_tokens, cfg, lat_handle,
                   card):
    """6h's ingress step, on the routed app's two loaded replicas: the 12
    serve requests over HTTP through ``serve.start()``'s proxy, one at a
    time and from 4 client threads, each giving the serve phase's tokens;
    B1 in the replicas grows by the layers times the prefills they ran;
    ``/-/healthz``, ``/-/routes`` and a 404; the proxy (and the gRPC
    proxy, whose one ``PREDICT`` gives the same tokens) holds no CUDA
    context and leases no GPU; the stream and batch toys. The HTTP and
    handle latencies and tok/s are printed, not gated: ``lat_handle`` are
    part (1)'s times of the same requests one at a time through the
    handle (its first pass, the HTTP one comes after it)."""
    from ray_tpu_torch.serve.grpc_util import ServeGrpcClient

    t_step = time.perf_counter()
    proxy = serve.start()
    port = rt.get(proxy.get_port.remote(), timeout=60)
    check(_poll(lambda: _http(port, "/-/routes", timeout=60)[1].get(
        "routed") == "/routed", timeout=30),
        f"/-/routes never named routed: {_http(port, '/-/routes')}")
    health = _http(port, "/-/healthz", timeout=60)
    missing = _http(port, "/no-such-app", {"prompt": [1]}, timeout=60)
    check(health == (200, {"ok": True}), f"/-/healthz answered {health}")
    check(missing == (404, {"error": "no application 'no-such-app'"}),
          f"an unknown app answered {missing}")

    before = [_rcall(rt, r, "b1") for r in reps]
    lat_http, one = [], []
    for r in reqs:
        t0 = time.perf_counter()
        status, body = _http(port, "/routed", r)
        lat_http.append(1e3 * (time.perf_counter() - t0))
        check(status == 200, f"HTTP {status}: {body}")
        one.append(body["result"])
    same = sum(o["tokens"] == t for o, t in zip(one, serve_tokens))
    check(same == len(reqs), f"HTTP tokens one at a time == the serve "
          f"phase's for {same}/{len(reqs)}")
    check(all(isinstance(o["x-trace-id"], str) for o in one),
          "an HTTP reply without a string x-trace-id")
    got = {}

    def over_http(r):
        status, body = _http(port, "/routed", r)
        check(status == 200, f"HTTP {status}: {body}")
        got[id(r)] = body["result"]
        return body["result"]

    mix = _timed_mix(over_http, reqs, "routed app mix over HTTP", card,
                     phase="serve-app")
    same_mix = sum(got[id(r)]["tokens"] == t
                   for r, t in zip(reqs, serve_tokens))
    check(same_mix == len(reqs), f"HTTP tokens from 4 clients == the "
          f"serve phase's for {same_mix}/{len(reqs)}")
    after = [_rcall(rt, r, "b1") for r in reps]
    launches = sum(a["launches"] - b["launches"]
                   for a, b in zip(after, before))
    prefills = sum(a["prefills"] - b["prefills"]
                   for a, b in zip(after, before))
    check(prefills == 2 * len(reqs)
          and launches == cfg.n_layers * prefills,
          f"B1 in the replicas over HTTP {launches} != {cfg.n_layers} x "
          f"{prefills} prefills")

    gproxy = serve.start_grpc()
    gport = rt.get(gproxy.get_port.remote(), timeout=60)
    client = ServeGrpcClient(f"127.0.0.1:{gport}")
    try:
        grpc_out = json.loads(client.predict(reqs[0], application="routed",
                                             timeout=900))
    finally:
        client.close()
    check(grpc_out["tokens"] == serve_tokens[0], "the gRPC PREDICT's "
          "tokens differ from the serve phase's")

    pids = {"http": _actor_pid("SERVE_PROXY"),
            "grpc": _actor_pid("SERVE_GRPC_PROXY")}
    cmds = _cluster_pids()
    check(all(pid in cmds for pid in pids.values()),
          f"the proxies {pids} are not processes of this cluster")
    held = {k: _off_cuda(pid) for k, pid in pids.items()}
    listed = _compute_app_pids()
    replicas_listed = sum(b["pid"] in listed for b in after)
    for k, h in held.items():
        check(not h["listed"] and not h["libcuda"]
              and h["cuda_visible_devices"] == "",
              f"the {k} proxy (pid {pids[k]}) holds the card: {h}")
    toys = _ingress_toys(rt, serve, port, card)
    stats = rt.get(proxy.stats.remote(), timeout=60)
    step_s = time.perf_counter() - t_step
    out = {"serial_http_ms_p50": float(np.median(lat_http)),
           "serial_handle_ms_p50": float(np.median(lat_handle)),
           "mix": mix, "b1_launches": launches, "prefills": prefills,
           "requests_served": stats["requests_served"],
           "proxy_pids": pids, "proxies_off_cuda": held,
           "proxy_cmds": {pid: cmds[pid] for pid in pids.values()},
           "replicas_listed_by_nvidia_smi": replicas_listed,
           "grpc_tokens_equal": True, "toys": toys, "step_s": step_s}
    log("serve-app", f"ingress: the 12 serve requests over HTTP through "
        f"serve.start()'s proxy one at a time and from 4 clients, tokens "
        f"== the serve phase's {same}/{len(reqs)} and "
        f"{same_mix}/{len(reqs)}; one gRPC PREDICT's tokens equal too; B1 "
        f"in the replicas {launches} = {cfg.n_layers} x {prefills} "
        f"prefills; the proxies' processes {pids} hold no CUDA context "
        f"(not listed by nvidia-smi, which lists {replicas_listed} of the "
        f"2 replicas; no libcuda mapped; CUDA_VISIBLE_DEVICES empty); "
        f"the proxy served {stats['requests_served']} requests; {card}")
    log("serve-app", f"ingress latency, one at a time: HTTP p50 "
        f"{out['serial_http_ms_p50']:.1f} ms, handle p50 "
        f"{out['serial_handle_ms_p50']:.1f} ms "
        f"({out['serial_http_ms_p50'] / out['serial_handle_ms_p50']:.3f}x)"
        f"; from 4 clients over HTTP {mix['tok_s']:.1f} tok/s, client "
        f"latency p50 {mix['latency_p50_ms']:.0f} ms (the handle's mix "
        f"above is the comparison); {card}")
    log("serve-app", f"[time] ingress step took {step_s:.1f} s")
    return out


def phase_serve_app(dev, card, serve_tokens, serve_fig, runtime,
                    disagg_tokens, disagg):
    """Serve on the port's runtime: (1) ``build_routed_llm_app``, two
    Llama-3-8B int8 replicas of half the card each behind the LLM
    router, the 12 serve requests one at a time through the handle (the
    serve phase's tokens) and from 4 client threads; B1 in the replicas
    = 32 x prefills, read through the controller's replica handles; the
    router's counts, ``serve_replicas`` and a span tree from the GCS.
    (2) ``build_disagg_llm_app``, a prefill and a decode replica: 6e's
    mix one at a time (6e's monolithic tokens, prompts of 256 tokens or
    more two-hop through the store) and from 4 clients; the mix's own
    migrations' store put and get; then a speculative decode pool: B1 =
    draft layers x draft prefills. (3) 4 layers, bf16, paged: the prefix
    index, a cache-aware pick, a peer pull from a busy holder and the
    store tier's demote and promote after a whole and a partial
    eviction. (4) Teardown: no cluster process left, the card's memory
    back."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.serve.llm import (build_disagg_llm_app,
                                         build_llm_app, build_routed_llm_app)
    from ray_tpu_torch.serve.llm.disagg.spec import draft_config_for
    from ray_tpu_torch.serve.llm.kv_cache import stable_hash_prefix
    from ray_tpu_torch.util import metrics, state

    cfg = serve_config()
    AppServer, AppPrefill, AppDecode = _serve_app_classes()
    common = dict(model_config=cfg, num_gpus=SERVE_APP_GPUS,
                  quantize="int8", init_seed=0, device=None)
    mem0 = gpu_memory_used_mib()
    out = {"card": card, "steps_s": {}}
    phase_t0 = time.perf_counter()

    def mark(step):
        """The phase's wall time after each of its steps."""
        out["steps_s"][step] = time.perf_counter() - phase_t0
        log("serve-app", f"[time] {step} done at "
            f"{out['steps_s'][step]:.1f} s of the phase")

    rt.init(_system_config=dict(SERVE_APP_SYSTEM))
    try:
        # (1) The routed app at full width, dense.
        t0 = time.perf_counter()
        app = build_routed_llm_app(engine_config=dict(ENGINE),
                                   num_replicas=2, **common)
        _swap(app.init_args[0], AppServer)
        handle = serve.run(app, name="routed")
        reps = _app_replicas(rt, "routed", "llm", n=2)
        infos = [_rcall(rt, r, "b1") for r in reps]
        out["routed_ready_s"] = time.perf_counter() - t0
        for info in infos:
            _check_lease(info, "a routed replica")
        check(len({i["pid"] for i in infos}) == 2,
              "the two replicas share a process")
        log("serve-app", f"routed app: 2 replicas of {SERVE_APP_GPUS} GPU "
            f"ready in {out['routed_ready_s']:.1f} s (pids "
            f"{[i['pid'] for i in infos]}, gpu ids "
            f"{[i['gpu_ids'] for i in infos]}); {card}")
        mark("routed ready")
        before = [_rcall(rt, r, "b1") for r in reps]
        reqs = serve_requests(cfg)
        one, lat_handle = [], []
        for r in reqs:
            t0 = time.perf_counter()
            one.append(handle.remote(r).result(timeout=900))
            lat_handle.append(1e3 * (time.perf_counter() - t0))
        same = sum(o["tokens"] == t for o, t in zip(one, serve_tokens))
        out["routed_tokens_equal"] = f"{same}/{len(reqs)}"
        log("serve-app", f"greedy tokens one at a time through the handle "
            f"== the serve phase's in-process tokens: "
            f"{out['routed_tokens_equal']}")
        check(same == len(reqs), "routed tokens differ from the serve "
              "phase's")
        mark("routed one at a time")

        def through_handle(r):
            return handle.remote(r).result(timeout=900)

        routed = _timed_mix(through_handle, reqs, "routed app mix", card,
                            phase="serve-app")
        mark("routed mix")
        after = [_rcall(rt, r, "b1") for r in reps]
        launches = sum(a["launches"] - b["launches"]
                       for a, b in zip(after, before))
        prefills = sum(a["prefills"] - b["prefills"]
                       for a, b in zip(after, before))
        by_replica = [a["launches"] - b["launches"]
                      for a, b in zip(after, before)]
        st = handle.stats.remote().result(timeout=60)
        log("serve-app", f"B1 launches in the replicas {by_replica} = "
            f"{launches} for {prefills} prefills; router: "
            f"{st['replicas']} replicas, routed {st['routed']}")
        check(prefills == 2 * len(reqs)
              and launches == cfg.n_layers * prefills,
              f"B1 in the replicas {launches} != {cfg.n_layers} x "
              f"{prefills}")
        check(st["replicas"] == 2 and len(st["routed"]) == 2
              and sum(st["routed"].values()) == 2 * len(reqs),
              f"router stats {st}")
        n_rep = _poll(lambda: metrics.query(
            "serve_replicas", labels={"deployment": "routed/llm"}).latest
            == 2.0, timeout=30)
        check(n_rep, "serve_replicas did not read 2")
        check(all("x-trace-id" in o for o in one), "a response without "
              "x-trace-id")
        tree = _serve_trace(one[0]["x-trace-id"])
        check(tree is not None, "no span tree for a routed request")
        root = tree["root"]
        hop = next(c for c in root["children"]
                   if c["name"] == "serve.replica_call")
        call = next(c for c in hop["children"]
                    if c["name"] == "llm.server_call")
        req = next(c for c in call["children"]
                   if c["name"] == "llm.request")
        check(hop["parent_span_id"] == root["span_id"]
              and call["parent_span_id"] == hop["span_id"]
              and req["parent_span_id"] == call["span_id"],
              "span parents of a routed request")
        in_proc = {k: float(np.mean([m[k] for s, m in runtime["mix"]
                                     if s == "in-process"]))
                   for k in routed if k != "wall_s" and k != "tokens"}
        actor = {k: float(np.mean([m[k] for s, m in runtime["mix"]
                                   if s == "actor"]))
                 for k in in_proc}
        out["routed"] = {
            "mix": routed, "b1_launches": launches, "prefills": prefills,
            "b1_by_replica": by_replica, "routed": st["routed"],
            "over_runtime_in_process": _ratios(routed, in_proc),
            "over_runtime_actor": _ratios(routed, actor),
            "over_serve_phase": _ratios(routed, serve_fig)}
        log("serve-app", f"routed app / 6g in-process: "
            f"{_ratio_text(out['routed']['over_runtime_in_process'])}; / 6g "
            f"actor: {_ratio_text(out['routed']['over_runtime_actor'])}; / "
            f"serve phase: {_ratio_text(out['routed']['over_serve_phase'])}"
            f"; the trace serve.request > serve.replica_call > "
            f"llm.server_call > llm.request read back; {card}")
        mark("routed checks")
        # The ingress, on the same two loaded replicas.
        out["ingress"] = _serve_ingress(rt, serve, reqs, reps, serve_tokens,
                                        cfg, lat_handle, card)
        out["ingress"]["over_handle_mix"] = _ratios(out["ingress"]["mix"],
                                                    routed)
        log("serve-app", f"routed app mix over HTTP / through the handle: "
            f"{_ratio_text(out['ingress']['over_handle_mix'])}; {card}")
        mark("ingress")
        serve.delete("routed")
        mark("routed delete")

        # (2) The disaggregated app at full width, paged.
        t0 = time.perf_counter()

        def disagg_app(**kw):
            app = build_disagg_llm_app(
                engine_config=dict(PAGED_ENGINE), prefill_replicas=1,
                decode_replicas=1, prefill_threshold=PREFILL_THRESHOLD,
                **common, **kw)
            _swap(app.init_args[0], AppDecode)
            _swap(app.init_kwargs["prefill_handle"], AppPrefill)
            return app

        handle = serve.run(disagg_app(), name="disagg")
        (pre,) = _app_replicas(rt, "disagg", "llm-prefill")
        (dec,) = _app_replicas(rt, "disagg", "llm-decode")
        for r, what in ((pre, "the prefill replica"),
                        (dec, "the decode replica")):
            _check_lease(_rcall(rt, r, "b1"), what)
        out["disagg_ready_s"] = time.perf_counter() - t0
        mark("disagg ready")
        reqs = disagg_mix(cfg.vocab_size)
        two = [r for r in reqs if len(r["prompt"]) >= PREFILL_THRESHOLD]
        m0 = _rcall(rt, dec, "stats")["migration"]["blocks"]
        one = [handle.remote(r).result(timeout=900) for r in reqs]
        m1 = _rcall(rt, dec, "stats")["migration"]["blocks"]
        same = sum(o["tokens"] == t for o, t in zip(one, disagg_tokens))
        st = handle.stats.remote().result(timeout=60)
        out["disagg_tokens_equal"] = f"{same}/{len(reqs)}"
        log("serve-app", f"disagg app ready in {out['disagg_ready_s']:.1f} "
            f"s; 6e's mix one at a time: tokens == 6e's monolithic paged "
            f"server's for {out['disagg_tokens_equal']}; lanes "
            f"{st['lanes']}; the decode replica adopted {m1 - m0} blocks")
        check(same == len(reqs), "disagg app tokens differ from the "
              "monolithic paged server's")
        check(st["lanes"].get("interactive/prefill") == len(two)
              and st["lanes"].get("interactive/decode")
              == len(reqs) - len(two) and m1 > m0,
              f"two-hop split: {st['lanes']}, adopted {m1 - m0} blocks")
        mark("disagg one at a time")
        puts0 = len(_rcall(rt, pre, "migrations"))
        gets0 = len(_rcall(rt, dec, "migrations"))
        pair = _timed_mix(through_handle, reqs, "disagg app mix", card,
                          phase="serve-app")
        mark("disagg mix")
        # The mix's own migrations: the prefill replica's put of each
        # result it returned, the decode replica's get of each it adopted.
        puts = _rcall(rt, pre, "migrations")[puts0:]
        gets = _rcall(rt, dec, "migrations")[gets0:]
        check(len(puts) == len(gets) == len(two)
              and sorted(b for _, b in puts) == sorted(b for _, b in gets)
              and all(b > 0 for _, b in puts),
              f"{len(puts)} puts and {len(gets)} gets of KV checkpoints "
              f"in the mix, {len(two)} two-hop requests")
        store = {"put_ms_p50": float(np.median([m for m, _ in puts])),
                 "put_ms_max": max(m for m, _ in puts),
                 "get_ms_p50": float(np.median([m for m, _ in gets])),
                 "get_ms_max": max(m for m, _ in gets),
                 "mib_p50": float(np.median([b for _, b in puts])) / 2**20,
                 "migrations": len(puts)}
        mig = disagg["migration"]
        out["disagg"] = {"mix": pair, "store": store,
                         "over_6e_pair": _ratios(pair, disagg["pair"]),
                         "adopted_blocks": m1 - m0}
        log("serve-app", f"disagg app / 6e in-process pair: "
            f"{_ratio_text(out['disagg']['over_6e_pair'])}; per migration "
            f"of the mix ({len(puts)}): the prefill replica's store put "
            f"of its return p50 {store['put_ms_p50']:.2f} ms "
            f"(max {store['put_ms_max']:.2f}), the decode replica's get "
            f"p50 "
            f"{store['get_ms_p50']:.2f} ms (max {store['get_ms_max']:.2f}),"
            f" payload p50 {store['mib_p50']:.1f} MiB; 6e in-process: "
            f"export p50 {mig['export_ms_p50']:.2f} ms, adopt p50 "
            f"{mig['adopt_ms_p50']:.2f} ms; {card}")

        # The speculative decode pool, by redeploying the app.
        old = {dec._actor_id}
        handle = serve.run(disagg_app(speculative={"draft_seed": 0}),
                           name="disagg")
        (dec,) = _app_replicas(rt, "disagg", "llm-decode", old=old)
        d0 = _rcall(rt, dec, "b1")
        _check_lease(d0, "the speculative replica")
        errors = []
        # B1's count depends on the draft's prefills, not on how long
        # each request decodes.
        threads, _ = _clients(through_handle,
                              [dict(r, max_tokens=2) for r in two], errors)
        _join(threads, errors)
        d1 = _rcall(rt, dec, "b1")
        dc = draft_config_for(cfg)
        b1 = d1["launches"] - d0["launches"]
        drafts = d1["draft_prefills"] - d0["draft_prefills"]
        fits = sum(len(r["prompt"]) <= ENGINE["prefill_buckets"][-1]
                   for r in two)
        out["spec"] = {"b1_launches": b1, "draft_prefills": drafts}
        log("serve-app", f"speculative decode replica: B1 launches {b1} = "
            f"{dc.n_layers} draft layers x {drafts} draft prefills over "
            f"{len(two)} two-hop requests ({fits} fit a bucket); {card}")
        check(drafts == fits and b1 == dc.n_layers * drafts and b1 > 0,
              f"B1 in the speculative replica {b1} != {dc.n_layers} x "
              f"{drafts} ({fits} fit a bucket)")
        serve.delete("disagg")
        mark("speculative decode pool and delete")

        # (3) 4 layers: the prefix index, the cache-aware pick, the peer
        # pull and the store tier. The three apps start together, a
        # quarter of the card each replica.
        cfg4 = _gate_cfg(torch.bfloat16)
        gate = dict(common, model_config=cfg4, quantize="bf16",
                    num_gpus=GATE_APP_GPUS)
        handle = serve.run(build_routed_llm_app(
            engine_config=dict(PAGED_ENGINE), num_replicas=2,
            probe_interval_s=0.05, **gate), name="cached")
        tier = serve.run(build_llm_app(engine_config=dict(TIER_ENGINE),
                                       name="tier", **gate), name="tier")
        partial = serve.run(build_llm_app(
            engine_config=dict(PARTIAL_ENGINE), name="partial", **gate),
            name="partial")
        reps = _app_replicas(rt, "cached", "llm", n=2)
        rng = np.random.RandomState(7)

        def toks(n):
            return rng.randint(0, cfg4.vocab_size, int(n)).tolist()

        shared = toks(SYS_PREFIX)
        first, busy, second = (shared + toks(n) for n in (40, 8, 50))
        n_pull = SYS_PREFIX // PAGED_ENGINE["kv_block_size"]

        def ask(prompt, n):
            return handle.remote({"prompt": prompt, "max_tokens": n})

        def settled():
            """The router sees both replicas idle (its probed depths lag
            a request's end by up to a probe period)."""
            st = handle.stats.remote().result(timeout=60)
            return (st["inflight"] == 0 and len(st["depth"]) == 2
                    and not any(st["depth"].values()))

        ask(first, 8).result(timeout=300)
        st = handle.stats.remote().result(timeout=60)
        (holder,) = st["routed"]
        head = stable_hash_prefix(shared)

        # The index also holds the tier apps' replicas: read this app's.
        ids = {_rcall(rt, r, "load")["index_id"] for r in reps}

        def indexed():
            idx = global_worker().gcs.call("lookup_prefix_index",
                                           timeout=10)
            held = [k for k in ids & set(idx)
                    if head in {int(h) for h, _ in idx[k]["heads"]}]
            return idx if ids <= set(idx) and len(held) == 1 else None

        check(_poll(indexed, timeout=30), "the prefix index does not show "
              "both replicas, one of them holding the prefix")
        time.sleep(0.6)          # the router's index catches up
        check(_poll(settled, timeout=30), "the replicas never read idle")
        ask(first, 8).result(timeout=300)
        st = handle.stats.remote().result(timeout=60)
        check(st["routed"].get(holder) == 2
              and st["cache_index"]["outcomes"]["scored"] >= 1,
              f"the repeat was not routed scored to the holder: {st}")
        check(_poll(settled, timeout=30), "the replicas never read idle")
        long_req = ask(busy, APP_BUSY_TOKENS)
        check(_poll(lambda: handle.stats.remote().result(
            timeout=60)["inflight"] == 1, timeout=30, period=0.01),
            "the busy request never reached the router")
        st = handle.stats.remote().result(timeout=60)
        check(st["routed"].get(holder) == 3, f"the busy request did not "
              f"go to the holder: {st['routed']}")
        pulled = ask(second, 16).result(timeout=300)
        st = handle.stats.remote().result(timeout=60)
        other = [k for k in st["routed"] if k != holder]
        check(len(other) == 1 and st["cache_index"]["outcomes"]["pulled"]
              == 1, f"no peer pull to the other replica: {st}")
        rep = {r._actor_id.hex(): r for r in reps}
        tiers = _rcall(rt, rep[other[0]], "stats")["kv_tiers"]
        rows = _poll(lambda: state.list_serve_accounting(
            trace_id=pulled["x-trace-id"]), timeout=30)
        tree = _serve_trace(pulled["x-trace-id"],
                            want=("serve.request", "kv.peer_pull"))
        pull = next(c for c in tree["root"]["children"]
                    if c["name"] == "kv.peer_pull")
        long_req.result(timeout=900)
        donor = _rcall(rt, rep[holder], "__call__",
                       {"prompt": second, "max_tokens": 16})
        out["cache"] = {"pulled_blocks": pull["attrs"]["blocks"],
                        "promoted": tiers["promoted_blocks"],
                        "avoided": rows[0]["prefill_tokens_avoided"],
                        "pull_ms": 1e3 * pull["dur"],
                        "outcomes": st["cache_index"]["outcomes"]}
        log("serve-app", f"4 layers: both replicas in the prefix index; "
            f"the repeat routed scored to the holder; with the holder "
            f"busy the next prompt went to the other replica, which "
            f"pulled {pull['attrs']['blocks']} blocks in "
            f"{1e3 * pull['dur']:.1f} ms (kv.peer_pull), promoted "
            f"{tiers['promoted_blocks']} and prefilled "
            f"{rows[0]['prefill_tokens_computed']} of {len(second)} tokens;"
            f" tokens == the holder's: {pulled['tokens'] == donor['tokens']}"
            f"; {card}")
        check(pull["attrs"]["blocks"] == n_pull
              and tiers["promoted_blocks"] == n_pull
              and rows[0]["prefill_tokens_avoided"] == SYS_PREFIX
              and rows[0]["prefill_tokens_computed"]
              == len(second) - SYS_PREFIX,
              f"peer pull: {out['cache']}, row {rows[0]}")
        check(pulled["tokens"] == donor["tokens"], "the pulling replica's "
              "tokens differ from the holder's")
        mark("4-layer apps, prefix index, pick and peer pull")

        # The store tier. The run without it is the holder's: the paged
        # cell's pool and host tier, where none of these prompts is
        # evicted, and as many slots as the tier apps (equal batch widths,
        # so a pool hit and a promote of the same depth give equal bits).
        plain = rep[holder]

        def run(h, prompt, n=16):
            return h.remote({"prompt": prompt, "max_tokens": n}).result(
                timeout=300)["tokens"]

        def run_plain(prompt, n=16):
            return _rcall(rt, plain, "__call__",
                          {"prompt": prompt, "max_tokens": n})["tokens"]

        def stats_of(h):
            st = h.stats.remote().result(timeout=60)
            return {**st["kv_tiers"],
                    "pool_hit_tokens": st["prefix_cache"]["hit_tokens"]}

        # Whole chain: b evicts every cached block of a; a's repeat
        # promotes the chain and prefills what a full pool hit does.
        a, b = toks(TIER_PROMPT), toks(TIER_PROMPT)
        got, want, stats = [], [], []
        for p in (a, b, a):
            got.append(run(tier, p))
            want.append(run_plain(p))
            stats.append(stats_of(tier))
        demoted, back = stats[1]["store"], stats[2]["store"]
        out["store_tier"] = {"demoted_blocks": demoted["blocks"],
                             "promoted_from_store": back["promotes"],
                             "dropped": stats[2]["dropped_blocks"]}
        log("serve-app", f"store tier, whole chain: {demoted['blocks']} "
            f"blocks demoted to the object store (host tier "
            f"{TIER_ENGINE['kv_host_tier_bytes']} byte), {back['promotes']}"
            f" promoted back from it; tokens == the run without the tier: "
            f"{[x == y for x, y in zip(got, want)]}; {card}")
        check(demoted["blocks"] == TIER_CHAIN
              and stats[1]["host"]["blocks"] == 0
              and back["promotes"] == TIER_CHAIN
              and stats[2]["promoted_blocks"] == TIER_CHAIN
              and stats[2]["dropped_blocks"] == 0,
              f"store tier: {TIER_CHAIN} blocks should demote and promote: "
              f"{stats}")
        check(got == want, "tokens with the store tier differ from the "
              "run without it")

        # Partial: d evicts only the head of c's chain. c's repeat hits no
        # pool block from the head, promotes the PARTIAL_HEAD links from
        # the store and recomputes the rest: the pool hit plus the
        # promoted run is PARTIAL_HEAD of the chain's TIER_CHAIN, as the
        # reference's engine gives (tests/test_torch_paged.py holds both
        # packages to it). The run without the tier holds exactly those
        # links in its pool (a prompt of their length first), so both
        # prefill the same suffix.
        c, d = toks(TIER_PROMPT), toks(TIER_PROMPT)
        p0 = stats_of(partial)
        run(partial, c)
        run(partial, d)
        p1 = stats_of(partial)
        again = run(partial, c)
        p2 = stats_of(partial)
        run_plain(c[:PARTIAL_HEAD * PAGED_ENGINE["kv_block_size"] + 1], 1)
        want_c = run_plain(c)
        part = {"demoted": p1["store"]["blocks"] - p0["store"]["blocks"],
                "pool_hit_blocks": (p2["pool_hit_tokens"]
                                    - p1["pool_hit_tokens"])
                // PAGED_ENGINE["kv_block_size"],
                "promoted": p2["promoted_blocks"] - p1["promoted_blocks"],
                "from_store": p2["store"]["promotes"]
                - p1["store"]["promotes"],
                "dropped": p2["dropped_blocks"], "chain": TIER_CHAIN}
        out["store_tier_partial"] = part
        log("serve-app", f"store tier, partial eviction: {part['demoted']} "
            f"of the chain's {TIER_CHAIN} blocks demoted (its head); the "
            f"repeat hit {part['pool_hit_blocks']} pool blocks and promoted "
            f"{part['promoted']} ({part['from_store']} from the store), so "
            f"{TIER_CHAIN - part['pool_hit_blocks'] - part['promoted']} "
            f"links still in the pool went unused, as in the reference; "
            f"tokens == a run with a {part['promoted']}-block pool hit: "
            f"{again == want_c}; {card}")
        check(part["demoted"] == part["promoted"] == part["from_store"]
              == PARTIAL_HEAD and part["pool_hit_blocks"] == 0
              and p1["host"]["blocks"] == 0 and part["dropped"] == 0,
              f"partial eviction: {part}, want {PARTIAL_HEAD} demoted and "
              f"promoted, no pool hit")
        check(again == want_c, "tokens after a partial promote differ from "
              "a pool hit of the same depth")
        mark("store tier")
    finally:
        try:
            serve.shutdown()
        finally:
            procs = _cluster_pids()
            rt.shutdown()
    deadline = time.monotonic() + 30
    while True:
        left = {p: c for p, c in procs.items() if _alive(p, c)}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"processes left after shutdown: {left}")
    proxies = out.get("ingress", {}).pop("proxy_cmds", {})
    left = {p: c for p, c in proxies.items() if _alive(p, c)}
    check(len(proxies) == 2 and not left,
          f"ingress proxies left after shutdown: {left} of {proxies}")
    gc.collect()
    torch.cuda.empty_cache()
    out["memory_before_mib"] = mem0
    out["memory_after_mib"] = gpu_memory_used_mib()
    check(abs(out["memory_after_mib"] - mem0) < 1024,
          f"card memory {mem0:.0f} MiB before the phase, "
          f"{out['memory_after_mib']:.0f} MiB after")
    out["phase_s"] = time.perf_counter() - phase_t0
    log("serve-app", f"shut down: no cluster process left (the HTTP and "
        f"gRPC proxies' included), card memory "
        f"{mem0:.0f} -> {out['memory_after_mib']:.0f} MiB; the phase took "
        f"{out['phase_s']:.1f} s; {card}")
    return out


def _grads(cfg, params, batch, impl):
    from ray_tpu_torch.models.llama import loss_fn

    leaves = torch.utils._pytree.tree_leaves(params)
    loss = loss_fn(params, batch, cfg, attn_impl=impl)
    return loss.item(), torch.autograd.grad(loss, leaves)


def _rel_l2(got, want):
    return [((a.float() - b.float()).norm() / b.float().norm()).item()
            for a, b in zip(got, want)]


def phase_train_parity(cfg, params, batch, card):
    """Flash against plain attention on the same params and batch, both
    in bf16 (the gate), and each of them against the same model computed
    in f32 with plain attention (printed: how much of their distance is
    the bf16 rounding of either)."""
    lf, gf = _grads(cfg, params, batch, "flash")
    lx, gx = _grads(cfg, params, batch, "xla")
    rel = _rel_l2(gf, gx)
    loss_rel = abs(lf - lx) / abs(lx)
    l32, g32 = _grads(dataclasses.replace(cfg, dtype=torch.float32), params,
                      batch, "xla")
    rf, rx = _rel_l2(gf, g32), _rel_l2(gx, g32)
    del gf, gx, g32
    log("train", f"flash vs plain attention (bf16): loss {lf:.5f} vs "
        f"{lx:.5f} (rel {loss_rel:.2e}, tol {TOL_PARITY_LOSS}); grad "
        f"leaves' relative L2 max {max(rel):.3e}, median "
        f"{np.median(rel):.3e} over {len(rel)} leaves (tol "
        f"{TOL_PARITY_GRAD}). Against f32 compute (loss {l32:.5f}): flash "
        f"max {max(rf):.3e} median {np.median(rf):.3e}, plain max "
        f"{max(rx):.3e} median {np.median(rx):.3e}; {card}")
    check(loss_rel <= TOL_PARITY_LOSS and max(rel) <= TOL_PARITY_GRAD,
          "flash and plain attention disagree on the loss or a gradient")
    return rel, loss_rel


def phase_train_f32(dev):
    """The training path in f32 at a narrow width with head dim 128 (the
    kernels' width): flash and plain attention must then agree to f32
    summation order, which holds B1, B2, B3, the autograd Function, GQA,
    remat and the fused loss to each other far more tightly than bf16
    can. f32 products on the card run in full f32 (TF32 off)."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the f32 check needs full f32")
    cfg = LlamaConfig(vocab_size=1000, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, hidden_dim=512, max_seq_len=512,
                      dtype=torch.float32, param_dtype=torch.float32,
                      attn_impl="flash", remat="dots")
    params = init_params(cfg, seed=1, device=dev)
    for t in torch.utils._pytree.tree_leaves(params):
        t.requires_grad_(True)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 301))
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    lf, gf = _grads(cfg, params, batch, "flash")
    lx, gx = _grads(cfg, params, batch, "xla")
    rel = _rel_l2(gf, gx)
    loss_rel = abs(lf - lx) / abs(lx)
    log("train", f"f32, dim 256, head dim 128, 2 layers, 2 x 300 "
        f"positions: flash vs plain attention loss rel {loss_rel:.2e}, "
        f"grad leaves' relative L2 max {max(rel):.3e} (tol "
        f"{TOL_PARITY_F32})")
    check(loss_rel <= TOL_PARITY_F32 and max(rel) <= TOL_PARITY_F32,
          "f32 flash and plain attention disagree")
    return max(rel)


def phase_train_tiny(dev):
    """LlamaConfig.tiny() (head dim 16, which the kernel wrappers pad to
    128) under attn_impl="flash" on the card, in f32 at 2 x 128
    positions: the loss and every gradient leaf against plain attention
    (TOL_PARITY_F32), then one build_train_step step with B1 launched
    twice per layer (forward and remat) and B2, B3 once."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import build_train_step, create_train_state

    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                           attn_impl="flash", remat="dots")
    L = cfg.n_layers
    state = create_train_state(init_params(cfg, seed=2, device=dev),
                               device=dev)
    toks = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, cfg.max_seq_len + 1)).astype(np.int64)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    lf, gf = _grads(cfg, state.params, batch, "flash")
    lx, gx = _grads(cfg, state.params, batch, "xla")
    rel = _rel_l2(gf, gx)
    loss_rel = abs(lf - lx) / abs(lx)
    check(loss_rel <= TOL_PARITY_F32 and max(rel) <= TOL_PARITY_F32,
          f"tiny (head dim {cfg.head_dim}): flash and plain attention "
          f"disagree: loss rel {loss_rel}, grad rel L2 max {max(rel)}")
    kernels = (attention.flash_fwd_cuda, attention.flash_bwd_dkv_cuda,
               attention.flash_bwd_dq_cuda)
    for fn in kernels:
        fn.launches = 0
    step = build_train_step(lambda p, b: loss_fn(p, b, cfg), device=dev)
    state, m = step(state, batch)
    got, want = tuple(fn.launches for fn in kernels), (2 * L, L, L)
    check(np.isfinite(m["loss"].item()) and got == want,
          f"tiny flash step: loss {m['loss'].item()}, launches (B1, B2, "
          f"B3) {got} != {want}")
    log("train", f"LlamaConfig.tiny (head dim {cfg.head_dim}, padded to "
        f"128), f32, flash vs plain attention: loss rel {loss_rel:.2e}, "
        f"grad leaves' relative L2 max {max(rel):.3e} (tol "
        f"{TOL_PARITY_F32}); one step, loss {m['loss'].item():.4f}, "
        f"launches B1 {got[0]}, B2 {got[1]}, B3 {got[2]} (expected {want})")
    return {"head_dim": cfg.head_dim, "loss_rel": loss_rel,
            "grad_rel_l2_max": max(rel), "launches_b1_b3": list(got)}


def phase_train(dev, card):
    """Llama-3-8B widths at TRAIN_LAYERS layers through the port's
    build_train_step; see the module docstring."""
    from ray_tpu_torch.models.llama import (
        LlamaConfig, flops_per_token, init_params, loss_fn)
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import build_train_step, create_train_state

    f32_rel = phase_train_f32(dev)
    tiny = phase_train_tiny(dev)

    kernels = (attention.flash_fwd_cuda, attention.flash_bwd_dkv_cuda,
               attention.flash_bwd_dq_cuda)

    def reset():
        for fn in kernels:
            fn.launches = 0

    def counts():
        return tuple(fn.launches for fn in kernels)

    cfg = LlamaConfig.llama3_8b(
        n_layers=TRAIN_LAYERS, max_seq_len=TRAIN_SEQ, attn_impl="flash",
        remat="dots", param_dtype=torch.bfloat16)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = create_train_state(init_params(cfg, seed=0, device=dev),
                               device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in
                   torch.utils._pytree.tree_leaves(state.params))
    log("train", f"Llama-3-8B widths, {L} layers, {n_params / 1e9:.3f} B "
        f"params (bf16) built in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; {card}")
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size,
                           (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int64)
               for _ in range(TRAIN_STEPS + 2)]

    # Flash against plain attention: the initial params, the first batch.
    batch = {"tokens": torch.as_tensor(batches[0], device=dev)}
    rel, loss_rel = phase_train_parity(cfg, state.params, batch, card)

    # The main path: TRAIN_STEPS steps, counts from 0.
    step = build_train_step(lambda p, b: loss_fn(p, b, cfg), device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset()
    losses, norms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": batches[i]})
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        times.append(time.perf_counter() - t0)
    got = counts()
    want = (2 * L * TRAIN_STEPS, L * TRAIN_STEPS, L * TRAIN_STEPS)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(got == want, f"launches (B1, B2, B3) {got} != {want} for "
          f"{TRAIN_STEPS} steps of {L} layers under remat")
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = flops_per_token(cfg, TRAIN_SEQ) * tokens / step_s / PEAK_FLOPS[
        torch.bfloat16]
    log("train", "losses " + ", ".join(f"{x:.4f}" for x in losses)
        + "; grad norms " + ", ".join(f"{x:.3f}" for x in norms))
    log("train", f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens: step times " + ", ".join(f"{x:.3f}" for x in times)
        + f" s; median after the first {step_s:.4f} s = "
        f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% "
        f"(flops_per_token over 989 TFLOP/s); peak memory "
        f"{peak / 2**30:.2f} GiB; launches B1 {got[0]}, B2 {got[1]}, B3 "
        f"{got[2]} (expected {want}); {card}")

    # One step with grad_accum=2: two micro-batches of TRAIN_BATCH / 2.
    step2 = build_train_step(lambda p, b: loss_fn(p, b, cfg), grad_accum=2,
                             device=dev)
    reset()
    state, m = step2(state, {"tokens": batches[TRAIN_STEPS]})
    got2, want2 = counts(), (2 * L * 2, L * 2, L * 2)
    loss2, norm2 = m["loss"].item(), m["grad_norm"].item()
    check(np.isfinite(loss2) and np.isfinite(norm2),
          f"grad_accum=2: non-finite loss {loss2} or grad norm {norm2}")
    check(got2 == want2, f"grad_accum=2 launches {got2} != {want2}")
    log("train", f"grad_accum=2 step {m['step']}: loss {loss2:.4f}, grad "
        f"norm {norm2:.3f}, launches B1 {got2[0]}, B2 {got2[1]}, B3 "
        f"{got2[2]} (expected {want2})")
    launches = tuple(a + b for a, b in zip(got, got2))

    # Device time of one profiled step by kernel group.
    def one_step():
        _, m = step(state, {"tokens": batches[TRAIN_STEPS + 1]})
        m["loss"].item()

    prof = profile_window("train", one_step, card)
    del state
    return {"launches": launches, "step_s": step_s,
            "tokens_per_s": tokens / step_s, "mfu": mfu,
            "peak_gib": peak / 2**30, "losses": losses,
            "grad_rel_l2_max": max(rel), "loss_rel": loss_rel,
            "f32_grad_rel_l2_max": f32_rel, "tiny_flash": tiny,
            "profiled": prof}


# The ring collectives C1-C4 against their plain versions: ring sizes,
# types, ops, and per-rank blocks (rows x 128 elements, or a ragged shape
# whose per-rank and per-slab element counts are not multiples of 128, so
# every padding path runs). n = 4 and 8 reuse comm slots (hop t >= 2); n = 2
# never does. Every case must be bitwise: the kernels run the plain
# versions' hop schedule and round each combine once, as torch does.
RING_NS = (2, 4, 8)
# C3 is also held at the kernels' largest ring (ring.cu's MAX_RANKS).
RING_MAX_N = 16
RING_SHAPES = ((8, 128), (1000, 125), (65536, 128))
RING_OPS = ("sum", "max")
# The block types C1-C4 take; int32 blocks span the whole int32 range, so
# sums wrap around 2**32 as torch's do.
RING_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)
# The ZeRO phase: ranks, steps per route, chunks under overlap, and the
# f32 checks' config (the train phase's narrow one) and steps.
ZERO_N, ZERO_STEPS, ZERO_CHUNKS = 4, 3, 4
ZERO_F32_STEPS = 3
# Peak memory (GiB) two routes read on an NVIDIA H100 80GB HBM3 at 700 W
# while C2 still ran its hops through two chunks of comm slots a rank,
# which the group keeps for its life (ZeRO monolithic), and the int8
# overlap hop was tensor ops around C5's standalone form (its gathers and
# sum as whole tensors). Earlier runs' readings: logged in the text beside
# this run's peaks, never put in the kernels line.
PEAK_GIB_BEFORE = {"monolithic": 54.13, "int8 overlap": 42.4}
# ZeRO against the one-device step in f32: the summed gradients differ only
# in summation order, and each param is held to TOL_ZERO_F32 after the
# steps. Except where a gradient element sums to almost nothing (below
# TOL_ZERO_F32_G but not 0 at some step, from cancelling terms): AdamW
# divides each element by its own magnitude plus eps (1e-8), so there f32
# rounding noise of about 1e-9 changes the update direction itself, and
# such a param is held to the most AdamW can move it apart, 2 lr per step.
# (The card read 1.3e-5 on one such lm_head element, whose first gradient
# was about 4e-9.)
TOL_ZERO_F32 = 1e-5
TOL_ZERO_F32_G = 1e-7
TOL_ZERO_F32_NZ = 2 * 1e-4 * ZERO_F32_STEPS
# Overlap against monolithic in bf16, after ZERO_STEPS AdamW steps from the
# same params: the chunked rings sum each gradient element in another order
# (each hop rounds to bf16), which moves AdamW's normalised update by a
# few parts in 2**8 and flips the bf16 rounding of some params by one ulp.
# Gate: the relative L2 distance of the two runs' params, measured against
# the distance they moved from the initial params, at most 0.2; the first
# step's loss equal (same params, same batch).
TOL_ZERO_OVERLAP = 0.2


def _ring_input(n, shape, dtype, gen, dev):
    """Rank-major random data; int32 spans the whole int32 range."""
    if dtype == torch.int32:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,) + shape,
                             generator=gen, device=dev, dtype=dtype)
    return torch.randn((n,) + shape, generator=gen, device=dev, dtype=dtype)


def _allgather_cases(gen, dev):
    """C3 against its plain version, bit for bit, on [n, rows, 128]
    shards of every type: at RING_MAX_N ranks (small blocks), and at
    every RING_NS size into a caller's ``out`` and with each shard a view
    of its own place in ``out`` (rank r's shard at out[r, r * rows]), as
    an allgather in place. Returns the number of cases."""
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import ring as R

    checked = 0
    for n in RING_NS + (RING_MAX_N,):
        group = RingGroup(n, dev)
        shapes = RING_SHAPES[:2] if n == RING_MAX_N else RING_SHAPES
        for dtype in RING_DTYPES:
            for shape in shapes:
                x = _ring_input(n, shape, dtype, gen, dev)
                xb = x.reshape(n, -1)
                rows = -(-xb.shape[1] // 128)
                xb = torch.nn.functional.pad(
                    xb, (0, rows * 128 - xb.shape[1])).view(n, rows, 128)
                want = R.ring_allgather_plain(xb)
                cases = [("C3", R.ring_allgather_cuda(xb, group=group))]
                if n != RING_MAX_N:
                    out = torch.full_like(want, 7)
                    got = R.ring_allgather_cuda(xb, group=group, out=out)
                    cases.append(("C3 into out", got))
                    out = torch.zeros_like(want)
                    o4 = out.view(n, n, rows, 128)
                    for r in range(n):
                        o4[r, r] = xb[r]
                    inplace = out.as_strided(
                        (n, rows, 128), ((n + 1) * rows * 128, 128, 1))
                    got = R.ring_allgather_cuda(inplace, group=group,
                                                out=out)
                    cases.append(("C3 in place", got))
                for name, got in cases:
                    check(got.shape == want.shape and torch.equal(got, want),
                          f"{name} n={n} {dtype} {shape}: differs from its "
                          f"plain version")
                    checked += 1
        group.check()
        del group
    return checked


# C4 at the kernels' largest ring, every op: sixteen loads a vector, and
# the min and prod instantiations that RING_OPS leaves out. prod takes
# factors near 1 (int32: -3 .. 3), so products of 16 stay finite.
RING_ALL_OPS = ("sum", "max", "min", "prod")


def _allreduce_cases(gen, dev):
    """C4 against its plain version, bit for bit, at RING_MAX_N ranks, every
    type and op of RING_DTYPES and RING_ALL_OPS, per-rank blocks
    RING_SHAPES[:2]. Returns the number of cases."""
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import ring as R

    n, checked = RING_MAX_N, 0
    group = RingGroup(n, dev)
    for dtype in RING_DTYPES:
        for shape in RING_SHAPES[:2]:
            for op in RING_ALL_OPS:
                if op != "prod":
                    x = _ring_input(n, shape, dtype, gen, dev)
                elif dtype == torch.int32:
                    x = torch.randint(-3, 4, (n,) + shape, generator=gen,
                                      device=dev, dtype=dtype)
                else:
                    x = (1 + 0.1 * torch.randn((n,) + shape, generator=gen,
                                               device=dev)).to(dtype)
                want = R.ring_allreduce(x, op, impl="plain")
                got = R.ring_allreduce(x, op, impl="cuda", group=group)
                check(got.shape == want.shape and torch.equal(got, want),
                      f"C4 allreduce n={n} {dtype} {shape} op={op}: differs "
                      f"from its plain version")
                checked += 1
    group.check()
    return checked


def ring_bound(in_bytes, out_bytes):
    """(bound_ms, "bytes"): each input read once, each output written
    once, at the card's memory rate; a ring does no arithmetic to speak
    of (one combine per element and hop)."""
    return (in_bytes + out_bytes) / PEAK_BYTES * 1e3, "bytes"


def _ring_cases(x, group, op, shards=None, hop=None):
    """Yield (name, kernel result, plain result) for every ring kernel:
    C4 and C2 on the rank-major x [n, L] (L divisible by n), C3 on
    ``shards`` and C1 on ``hop`` (both x unless given), and the split-phase
    forms (one C1 launch per hop) against the monolithic kernels. Each
    plain result is computed first and each pair dropped after use, to
    keep the ZeRO size within the card's memory."""
    from ray_tpu_torch.util.collective import ring as R

    shards = x if shards is None else shards
    hop = x if hop is None else hop
    cuda = dict(impl="cuda", group=group)
    want = R.ring_allreduce(x, op, impl="plain")
    yield "C4 allreduce", R.ring_allreduce(x, op, **cuda), want
    want = None
    want = R.ring_reduce_scatter(x, op, impl="plain")
    rs = R.ring_reduce_scatter(x, op, **cuda)
    yield "C2 reduce_scatter", rs, want
    want = None
    yield "C1 split reduce_scatter vs C2", R.wait_ring_reduce_scatter(
        R.start_ring_reduce_scatter(x, op, **cuda)), rs
    rs = None
    want = R.ring_allgather(shards, impl="plain")
    ag = R.ring_allgather(shards, **cuda)
    yield "C3 allgather", ag, want
    want = None
    yield "C1 split allgather vs C3", R.wait_ring_allgather(
        R.start_ring_allgather(shards, **cuda)), ag
    ag = None
    want = R.wait_ring_permute(R.start_ring_permute(hop, impl="plain"))
    yield "C1 permute", R.wait_ring_permute(
        R.start_ring_permute(hop, **cuda)), want


def _ring_times(group, n, rows, gen, dev):
    """Kernel, plain, bound and library times of C1-C4 in bf16, sum, at
    per-rank blocks of ``rows`` x 128 (C4, C2: the rank's whole block;
    C3: its shard of rows / n; C1: one hop of the overlap path, rows /
    (n * ZERO_CHUNKS))."""
    from ray_tpu_torch.util.collective import ring as R

    dtype = torch.bfloat16
    e = torch.finfo(dtype).bits // 8
    c, h = rows // n, rows // (n * ZERO_CHUNKS)
    x = torch.randn((n, rows, 128), generator=gen, device=dev, dtype=dtype)
    full, part, one = n * rows * 128 * e, n * c * 128 * e, n * h * 128 * e
    iters = 5 if full > 2**30 else 20
    out = {}
    out["C4"] = dict(
        ms=time_ms(lambda: R.ring_allreduce_cuda(x, group=group), iters),
        plain_ms=time_ms(lambda: R.ring_allreduce_plain(x), iters),
        library_ms=time_ms(lambda: x.sum(0), iters),
        library_computes="x.sum(0)", bound=ring_bound(full, full))
    # C2 with donate=True, as the ZeRO path calls it: the kernel reads x
    # and writes only its result, so x must come out as it went in. Then x
    # is scratch: the plain version accumulates in it.
    before = x.clone()
    c2_ms = time_ms(lambda: R.ring_reduce_scatter_cuda(
        x, group=group, donate=True), iters)
    check(torch.equal(x, before), "C2 changed its input")
    del before
    out["C2"] = dict(
        ms=c2_ms, input_unchanged=True,
        plain_ms=time_ms(lambda: R.ring_reduce_scatter_plain(
            x, donate=True), iters),
        library_ms=time_ms(lambda: x.view(n, n, c, 128).sum(0), iters),
        library_computes="x.view(n, n, c, 128).sum(0)",
        bound=ring_bound(full, part))
    shard = torch.randn((n, c, 128), generator=gen, device=dev, dtype=dtype)
    del x
    out["C3"] = dict(
        ms=time_ms(lambda: R.ring_allgather_cuda(shard, group=group), iters),
        plain_ms=time_ms(lambda: R.ring_allgather_plain(shard), iters),
        library_ms=time_ms(lambda: shard.reshape(1, -1, 128).expand(
            n, -1, -1).contiguous(), iters),
        library_computes="x.reshape(1, -1, 128).expand(n, -1, -1)"
                         ".contiguous()",
        bound=ring_bound(part, full))
    block = shard[:, :h].contiguous()
    del shard
    out["C1"] = dict(
        ms=time_ms(lambda: R.ring_permute_cuda(block, group=group), 20),
        plain_ms=time_ms(lambda: R.ring_permute_plain(block), 20),
        library_ms=time_ms(lambda: torch.roll(block, 1, 0), 20),
        library_computes="torch.roll(x, 1, 0)",
        bound=ring_bound(one, one))
    del block
    gc.collect()
    torch.cuda.empty_cache()
    shapes = {"C4": rows, "C2": rows, "C3": c, "C1": h}
    for k, row in out.items():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        row.update({"n": n, "rows": shapes[k], "dtype": "bf16"})
    return out


def phase_ring_kernels(dev, card, zero_rows=None):
    """C1-C4 against their plain versions on the card, bit for bit, at
    every ring size, type, op and block of RING_*; then, at ``zero_rows``
    (the ZeRO path's flat parameter vector, in 128-lane rows, n = 4, bf16,
    sum), the same checks and the four kernels' times beside their plain
    versions', their bounds and one library call's; and the times at
    65536 rows per rank."""
    from ray_tpu_torch.util.collective import RingGroup

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    checked = 0
    for n in RING_NS:
        group = RingGroup(n, dev)
        for dtype in RING_DTYPES:
            for shape in RING_SHAPES:
                x = _ring_input(n, shape, dtype, gen, dev)
                for op in RING_OPS:
                    for name, got, want in _ring_cases(x, group, op):
                        check(got.shape == want.shape
                              and torch.equal(got, want),
                              f"{name} n={n} {dtype} {shape} op={op}: "
                              f"differs from its plain version (max abs "
                              f"{(got.float() - want.float()).abs().max()})")
                        checked += 1
        group.check()
        del group
    log("ring", f"C1-C4 bitwise equal to their plain versions in {checked} "
        f"cases: n {RING_NS}, {[str(d)[6:] for d in RING_DTYPES]}, ops "
        f"{RING_OPS}, per-rank blocks {RING_SHAPES}; split-phase "
        f"reduce-scatter and allgather (C1 per hop) bitwise equal to C2 "
        f"and C3")
    checked = _allgather_cases(gen, dev)
    log("ring", f"C3 bitwise equal to its plain version in {checked} more "
        f"cases: n {RING_NS + (RING_MAX_N,)} (n {RING_MAX_N} at per-rank "
        f"blocks {RING_SHAPES[:2]}), every type; into a caller's out and "
        f"with each shard already in its place of out")
    checked = _allreduce_cases(gen, dev)
    log("ring", f"C4 bitwise equal to its plain version in {checked} more "
        f"cases: n {RING_MAX_N}, every type, ops {RING_ALL_OPS}, per-rank "
        f"blocks {RING_SHAPES[:2]}")
    timings = []
    group = RingGroup(ZERO_N, dev)
    if zero_rows:
        x = torch.randn((ZERO_N, zero_rows * 128), generator=gen,
                        device=dev, dtype=torch.bfloat16)
        c = zero_rows // ZERO_N
        shards = x[:, :c * 128].contiguous()
        hop = x[:, :c * 128 // ZERO_CHUNKS].contiguous()
        for name, got, want in _ring_cases(x, group, "sum", shards, hop):
            check(torch.equal(got, want), f"{name} at the ZeRO size differs "
                  f"from its plain version")
            del got, want
        del x, shards, hop
        gc.collect()
        torch.cuda.empty_cache()
        log("ring", f"ZeRO size ({ZERO_N} ranks x {zero_rows} x 128 bf16, "
            f"sum; C3 on its {c}-row shards, C1 on one overlap hop of "
            f"{c // ZERO_CHUNKS} rows): C1-C4 and the split-phase forms "
            f"bitwise equal to their plain versions")
        timings.append(_ring_times(group, ZERO_N, zero_rows, gen, dev))
    timings.append(_ring_times(group, ZERO_N, 65536, gen, dev))
    group.check()
    del group
    gc.collect()
    torch.cuda.empty_cache()
    for t in timings:
        for k, row in t.items():
            log("ring", f"{k} n={row['n']} {row['rows']} rows bf16: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['library_computes']} {row['library_ms']:.4f} ms; "
                f"{card}")
    return timings


def _zero_f32_cfg():
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=1000, dim=256, n_layers=2, n_heads=2,
                       n_kv_heads=1, hidden_dim=512, max_seq_len=512,
                       dtype=torch.float32, param_dtype=torch.float32,
                       attn_impl="flash", remat="dots")


def phase_zero_f32(dev):
    """The ZeRO step in f32 at dim 256 (the train phase's f32 config):
    (1) at n = 2, bitwise equal to plain data parallelism whose summed
    gradient goes through C4 (``build_replicated_train_step``); the
    embedding's backward sums with ``index_add_``, whose CUDA atomics add
    in a varying order, so both steps run under
    ``torch.use_deterministic_algorithms`` (index_add_ then sums in a fixed
    order); (2) monolithic at n = 4 against the one-device
    ``build_train_step`` on the same global batch, its loss scaled by n to
    match ZeRO's summed gradients (only summation order differs), to
    TOL_ZERO_F32 (see there). Returns C4's launches in (1) and the largest
    param difference of (2) outside the near-zero gradients."""
    import functools
    import warnings

    from ray_tpu_torch.models.llama import init_params, loss_fn
    from ray_tpu_torch.parallel import (
        build_replicated_train_step, build_train_step,
        build_zero_train_step, create_train_state, create_zero_state)
    from ray_tpu_torch.parallel.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import ring as R

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the f32 check needs full f32")
    cfg = _zero_f32_cfg()
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    rng = np.random.RandomState(3)
    toks = [rng.randint(0, cfg.vocab_size, (ZERO_N, 301))
            for _ in range(ZERO_F32_STEPS)]

    def run(make_step, n, **kw):
        group = RingGroup(n, dev)
        state = create_zero_state(init_params(cfg, seed=1, device=dev), opt,
                                  group)
        step = make_step(lambda p, b: loss_fn(p, b, cfg), opt, group, **kw)
        for t in toks:
            state, m = step(state, {"tokens": t[:n]})
        group.check()
        return state, m["loss"].item()

    prev = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            zero, zl = run(build_zero_train_step, 2)
            for k in R.KERNELS:
                k.launches = 0
            rep, rl = run(build_replicated_train_step, 2)
            c4 = R.ring_allreduce_cuda.launches
        finally:
            torch.use_deterministic_algorithms(prev)
    check(c4 == ZERO_F32_STEPS, f"replicated step: C4 launches {c4} != "
          f"{ZERO_F32_STEPS}")
    check(torch.equal(zero.flat, rep.flat) and zl == rl,
          "ZeRO (n = 2) and the replicated C4 step differ")
    log("zero", f"f32 dim 256, n=2, {ZERO_F32_STEPS} AdamW steps: ZeRO "
        f"(C2 + C3) bitwise equal to the replicated step through C4 "
        f"({c4} launches); every rank's copy equal")
    del zero, rep

    zero, zl = run(build_zero_train_step, ZERO_N)
    one = create_train_state(init_params(cfg, seed=1, device=dev),
                             device=dev)
    init = _flat_of(one.params)
    step = build_train_step(lambda p, b: ZERO_N * loss_fn(p, b, cfg),
                            device=dev)
    near_zero = torch.zeros_like(init, dtype=torch.bool)
    for t in toks:
        one, m = step(one, {"tokens": t})
        g = _flat_of(one.params, grad=True).abs()
        near_zero |= (g > 0) & (g < TOL_ZERO_F32_G)
    want = _flat_of(one.params)
    diff = (_flat_of(zero.params) - want).abs()
    err = diff[~near_zero].max().item()
    err_nz = diff[near_zero].max().item() if near_zero.any() else 0.0
    moved = (want - init).norm().item()
    rel = diff.norm().item() / moved
    loss_err = abs(ZERO_N * zl - m["loss"].item())
    log("zero", f"f32 dim 256, n={ZERO_N}, {ZERO_F32_STEPS} AdamW steps: "
        f"ZeRO vs the one-device build_train_step (loss x {ZERO_N}): max abs "
        f"param difference {err:.3g} (tol {TOL_ZERO_F32}) over "
        f"{int((~near_zero).sum())} params; the {int(near_zero.sum())} "
        f"whose gradient fell below {TOL_ZERO_F32_G} (not 0) at some step "
        f"{err_nz:.3g} (tol {TOL_ZERO_F32_NZ:.3g}); L2 distance "
        f"{rel:.3g} of the distance moved; loss {loss_err:.3g}")
    check(err <= TOL_ZERO_F32 and err_nz <= TOL_ZERO_F32_NZ,
          f"ZeRO n={ZERO_N} vs one-device step: params differ by {err} "
          f"(near-zero gradients: {err_nz})")
    return c4, err


def _flat_of(tree, grad=False):
    """A param tree (or its gradients) as one f32 vector, leaves in name
    order."""
    return torch.cat([(t.grad if grad else t).detach().float().reshape(-1)
                      for _, t in sorted(_flat_leaves(tree))])


def _flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _sq_dist(a, b, chunk=1 << 27):
    """sum((a - b)^2) in f32 over two equal flat tensors, in chunks."""
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    for i in range(0, a.numel(), chunk):
        d = a[i:i + chunk].float() - b[i:i + chunk].float()
        total += d.square().sum()
    return total.item()


def _profile_step(phase, step, state, batch, card):
    """profile_window over one step on ``batch``."""
    def one_step():
        _, m = step(state, {"tokens": batch})
        m["loss"].item()

    return profile_window(phase, one_step, card)


def phase_zero_train(dev, card):
    """Llama-3-8B widths at TRAIN_LAYERS layers through
    ``build_zero_train_step`` over ZERO_N virtual ranks: ZERO_STEPS
    monolithic steps (C2 + C3) and one profiled step, then the same with
    ``overlap=True`` (C1 per hop) from the same initial params. See the
    module docstring for the gates."""
    import functools

    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import build_zero_train_step, create_zero_state
    from ray_tpu_torch.parallel.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import ring as R

    cfg = LlamaConfig.llama3_8b(
        n_layers=TRAIN_LAYERS, max_seq_len=TRAIN_SEQ, attn_impl="flash",
        remat="dots", param_dtype=torch.bfloat16)
    L = cfg.n_layers
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size,
                           (ZERO_N, TRAIN_SEQ + 1)).astype(np.int64)
               for _ in range(ZERO_STEPS + 1)]
    tokens = ZERO_N * TRAIN_SEQ
    kernels = R.KERNELS + (attention.flash_fwd_cuda,
                           attention.flash_bwd_dkv_cuda,
                           attention.flash_bwd_dq_cuda)

    def run(overlap):
        name = "overlap" if overlap else "monolithic"
        group = RingGroup(ZERO_N, dev)
        torch.cuda.reset_peak_memory_stats()
        state = create_zero_state(init_params(cfg, seed=0, device=dev), opt,
                                  group)
        step = build_zero_train_step(
            lambda p, b: loss_fn(p, b, cfg), opt, group, overlap=overlap,
            n_chunks=ZERO_CHUNKS)
        for k in kernels:
            k.launches = 0
        losses, norms, times = [], [], []
        for i in range(ZERO_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": batches[i]})
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            times.append(time.perf_counter() - t0)
        group.check()
        ring = [k.launches for k in kernels[:4]]
        b = [k.launches for k in kernels[4:]]
        n_c = len(state.layout) - 1
        want = ([2 * (ZERO_N - 1) * n_c * ZERO_STEPS, 0, 0, 0] if overlap
                else [0, ZERO_STEPS, ZERO_STEPS, 0])
        want_b = [2 * L * ZERO_N * ZERO_STEPS, L * ZERO_N * ZERO_STEPS,
                  L * ZERO_N * ZERO_STEPS]
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"{name}: non-finite loss or grad norm {losses} {norms}")
        check(ring == want, f"{name}: launches (C1, C2, C3, C4) {ring} != "
              f"{want}")
        check(b == want_b, f"{name}: launches (B1, B2, B3) {b} != {want_b}")
        check(all(torch.equal(state.flat[r], state.flat[0])
                  for r in range(ZERO_N)),
              f"{name}: a rank's parameter copy differs from rank 0's")
        peak = torch.cuda.max_memory_allocated()
        before = PEAK_GIB_BEFORE.get(name)
        step_s = float(np.median(times[1:]))
        log("zero", f"{name}: losses " + ", ".join(f"{x:.4f}" for x in losses)
            + "; grad norms " + ", ".join(f"{x:.3f}" for x in norms))
        log("zero", f"{name}: {ZERO_STEPS} steps of {ZERO_N} ranks x "
            f"{TRAIN_SEQ} tokens: step times "
            + ", ".join(f"{x:.3f}" for x in times) + f" s; median after the "
            f"first {step_s:.4f} s = {tokens / step_s:.0f} tokens/s; peak "
            f"memory {peak / 2**30:.2f} GiB"
            + (f" (before C2 dropped its slots: {before} GiB)" if before
               else "") + f"; launches C1-C4 {ring} (expected "
            f"{want}), B1-B3 {b}; every rank's copy equal to rank 0's; {card}")
        rec = {"losses": losses, "grad_norms": norms, "step_times_s": times,
               "step_s": step_s, "tokens_per_s": tokens / step_s,
               "peak_gib": peak / 2**30, "launches_c1_c4": ring,
               "launches_b1_b3": b, "chunks": n_c}
        return group, state, step, rec

    def profiled(name, step, state, rec):
        log("zero", f"{name}: one profiled step")
        prof = _profile_step("zero", step, state, batches[ZERO_STEPS], card)
        busy = prof["busy_ms"]
        ring_ms = prof["groups"].get("ring C1-C4", 0.0)
        rec.update({"profiled_wall_ms": prof["wall_ms"],
                    "profiled_busy_ms": busy, "ring_ms": ring_ms,
                    "ring_share": ring_ms / busy,
                    "profiled_groups": prof["groups"]})

    n_params = cfg.num_params()
    log("zero", f"Llama-3-8B widths, {L} layers, {n_params / 1e9:.3f} B "
        f"params (bf16), {ZERO_N} virtual ranks, AdamW (optax.adamw(1e-4)'s "
        f"settings), batch {ZERO_N} x {TRAIN_SEQ}; {card}")
    group, state, step, mono = run(False)
    mono_final = state.flat[0].clone()
    spec = state.spec
    profiled("monolithic", step, state, mono)
    del group, state, step
    gc.collect()
    torch.cuda.empty_cache()
    # The initial params as one flat vector, in the state's layout.
    init = torch.zeros_like(mono_final)
    p0 = init_params(cfg, seed=0, device=dev)
    for path, shape, off in spec:
        leaf = p0
        for key in path:
            leaf = leaf[key]
        init[off:off + shape.numel()] = leaf.reshape(-1)
    del p0

    group, state, step, over = run(True)
    moved = _sq_dist(mono_final, init) ** 0.5
    rel = _sq_dist(state.flat[0], mono_final) ** 0.5 / moved
    loss0 = abs(over["losses"][0] - mono["losses"][0]) / abs(mono["losses"][0])
    log("zero", f"overlap vs monolithic after {ZERO_STEPS} steps: params' "
        f"L2 distance {rel:.3e} of the distance moved from the initial "
        f"params (tol {TOL_ZERO_OVERLAP}); first-step loss rel diff "
        f"{loss0:.2e}")
    check(loss0 <= 1e-6, "overlap and monolithic disagree on the first "
          "step's loss (same params, same batch)")
    check(rel <= TOL_ZERO_OVERLAP, "overlap and monolithic params differ "
          "beyond bf16 re-association")
    profiled("overlap", step, state, over)
    del group, state, step, mono_final, init
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": L, "params": n_params, "monolithic": mono,
            "overlap": over, "overlap_vs_mono_rel_l2": rel}


# The int8 ring C5, C6 against their plain versions: ring sizes, per-rank
# shapes (a ragged one, exactly _MIN_QUANT_ELEMS elements, a large block)
# and three data variants: randn; one chunk all zero (every hop of it
# takes the 1e-30 scale floor); one element 1e3 (a chunk's max sits in
# one block, so the per-rank barrier decides every scale of that chunk).
# Every case bitwise: the kernels and the plain versions take the same
# scales, codes and roundings.
QRING_SHAPES = ((1000, 125), (1024,), (65536, 128))
QRING_VARIANTS = ("randn", "zero_chunk", "one_block_max")
# C5's in-place form hop by hop: ring sizes (3 and 16 beside RING_NS: an
# odd ring and the kernels' largest), on the same shapes and variants;
# and QRS_INTERLEAVED reduce-scatters of ZERO_N ranks in flight together.
QRS_NS = (2, 3, 4, 8, 16)
QRS_INTERLEAVED = 3
# The quantized ZeRO phase: Llama-3-8B widths at QZERO_LAYERS layers (the
# f32 carry and the error-feedback buffer are 4 bytes per param per rank
# each: 66 GiB before activations at 1 layer, 100 GiB at 4), ZERO_N ranks,
# ZERO_STEPS steps per route, ZERO_CHUNKS chunks under overlap.
QZERO_LAYERS = 1


def _qring_input(n, shape, variant, gen, dev):
    x = torch.randn((n,) + shape, generator=gen, device=dev)
    flat = x.view(n, -1)
    size = flat.shape[1]
    chunk = -(-size // (n * 128)) * 128
    if variant == "zero_chunk":
        flat[:, :min(chunk, size)] = 0.0
    elif variant == "one_block_max":
        flat[n - 1, min(size - 1, chunk + chunk // 2 + 3)] = 1e3
    return x


def _qring_cases(x, group):
    """(name, kernel result, plain result) for C6 through
    quantized_ring_allreduce, C5 alone on the padded block, and the
    split-phase int8 reduce-scatter (C5 per hop)."""
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    cuda = dict(impl="cuda", group=group)
    n = x.shape[0]
    yield ("C6 quantized_ring_allreduce",
           Q.quantized_ring_allreduce(x, **cuda),
           Q.quantized_ring_allreduce(x, impl="plain"))
    block = R._to_block(x, n)[0]
    yield ("C5 qhop", Q.ring_qhop_cuda(block, group=group),
           Q.ring_qhop_plain(block))
    yield ("C5 split-phase int8 reduce_scatter",
           Q.wait_quantized_ring_reduce_scatter(
               Q.start_quantized_ring_reduce_scatter(block, **cuda)),
           Q.wait_quantized_ring_reduce_scatter(
               Q.start_quantized_ring_reduce_scatter(block, impl="plain")))


def _qrs_hops(got, want, group):
    """C5's in-place form against its plain version over a whole int8
    reduce-scatter, hop by hop: got and want [n, n * c, 128] f32 hold the
    same values (got may be a view with a wider rank stride, as the ZeRO
    path's chunk of its gradient buffer); after each hop t the two buffers
    and the two carry tables must be equal bit for bit. The kernel's table
    starts as one an earlier reduce-scatter left, every word tagged with
    its row's hop and holding the largest finite max: hop 0 must clear it,
    or atomicMax keeps those maxes. Returns the hops checked."""
    from ray_tpu_torch.util.collective import quantized as Q

    n = got.shape[0]
    carry_want = torch.zeros((n - 1, n), dtype=torch.int64, device=got.device)
    carry_got = (torch.arange(n - 1, device=got.device) << 32).view(-1, 1) \
        + torch.full_like(carry_want, 0x7f7fffff)
    for t in range(n - 1):
        Q.ring_qrs_hop_cuda(got, t, carry_got, group=group)
        Q.ring_qrs_hop_plain(want, t, carry_want)
        check(torch.equal(got, want) and torch.equal(carry_got, carry_want),
              f"C5 in place n={n} rows={got.shape[1]} hop {t}: the buffer "
              f"or the carried max differs from the plain version's")
    return n - 1


def _qrs_interleaved(xs, **kw):
    """Int8 reduce-scatters of xs, issued as the overlap path issues them
    (``parallel/zero.py``): chunk c + 1's first hop before chunk c's wait.
    Returns the results in order."""
    from ray_tpu_torch.util.collective import quantized as Q

    hs = [Q.start_quantized_ring_reduce_scatter(xs[0], **kw)]
    out = []
    for c in range(len(xs)):
        if c + 1 < len(xs):
            hs.append(Q.start_quantized_ring_reduce_scatter(xs[c + 1], **kw))
        out.append(Q.wait_quantized_ring_reduce_scatter(hs[c]))
    return out


def _qrs_cases(gen, dev):
    """C5's in-place form bit for bit against its plain version: hop by
    hop (_qrs_hops) at every ring size of QRS_NS, shape of QRING_SHAPES and
    variant of QRING_VARIANTS; QRS_INTERLEAVED reduce-scatters interleaved
    against the same through the plain version and through the kernel one
    after another; and a hop whose carry no hop before filled stops the
    kernel and the group raises. Returns (hops checked, interleaved
    reduce-scatters checked)."""
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    hops = 0
    for n in QRS_NS:
        group = RingGroup(n, dev)
        for shape in QRING_SHAPES:
            for variant in QRING_VARIANTS:
                block = R._to_block(_qring_input(n, shape, variant, gen, dev),
                                    n)[0]
                hops += _qrs_hops(block.clone(), block, group)
        group.check()
        del group
    group = RingGroup(ZERO_N, dev)
    xs = [torch.randn((ZERO_N, ZERO_N * rows, 128), generator=gen, device=dev)
          for rows in (4096, 2048, 1000)]
    got = _qrs_interleaved(xs, impl="cuda", group=group)
    want = _qrs_interleaved(xs, impl="plain")
    alone = [Q.wait_quantized_ring_reduce_scatter(
        Q.start_quantized_ring_reduce_scatter(x, impl="cuda", group=group))
        for x in xs]
    group.check()
    for c, (g, w, a) in enumerate(zip(got, want, alone)):
        check(torch.equal(g, w) and torch.equal(g, a),
              f"C5 in place, interleaved reduce-scatter {c}: differs from "
              f"the plain version's or from the same alone")
    del group
    # A carry that no hop before filled: the kernel stops, the group
    # raises, and no max pass stands in.
    group = RingGroup(ZERO_N, dev)
    x = torch.randn((ZERO_N, ZERO_N * 8, 128), generator=gen, device=dev)
    Q.ring_qrs_hop_cuda(x, 1, torch.zeros((ZERO_N - 1, ZERO_N),
                                          dtype=torch.int64, device=dev),
                        group=group)
    try:
        group.check()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    check("carried" in raised, f"C5 in place with an empty carry did not "
          f"raise ({raised!r})")
    del group
    return hops, len(xs)


def _qring_times(group, n, elems, gen, dev, x=None):
    """Kernel, plain, bound and yardstick times of C6 (in place on the
    rank-major f32 block of ``elems`` per rank) and C5 (one overlap
    chunk: elems / ZERO_CHUNKS per rank). No library call requantizes per
    hop, so each has a yardstick, not the same function: x.sum(0) for C6.
    C5's row is its in-place form, the one the overlap path launches: hop
    1 (``ms``, scale carried from hop 0) and hop 0 (``hop0_ms``, max pass
    and barrier), its plain version, its bound (read the send and the
    receiving chunk, write the latter) and, as the yardstick, the
    split-phase hop as tensor ops around the standalone form, the route
    it replaces. The standalone form (one hop of a ring chunk, n of which
    make the overlap chunk) sits under ``standalone``, with torch.roll as
    its yardstick."""
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    if x is None:
        x = torch.randn((n, elems), generator=gen, device=dev)
    xb = x.view(n, -1, 128)
    full = n * elems * 4
    iters = 3 if full > 2**30 else 20
    out = {"C6": dict(
        ms=time_ms(lambda: Q.ring_qallreduce_cuda(xb, group=group, out=xb),
                   iters),
        plain_ms=time_ms(lambda: Q.ring_qallreduce_plain(xb, out=xb),
                         1 if full > 2**30 else 5),
        yardstick_ms=time_ms(lambda: x.sum(0), iters),
        yardstick_computes="x.sum(0), the exact sum (yardstick)",
        bound=ring_bound(full, full), rows=elems // 128)}
    h = elems // (n * ZERO_CHUNKS * 128) * 128
    hop = torch.randn((n, h // 128, 128), generator=gen, device=dev)
    del x, xb
    standalone = dict(
        ms=time_ms(lambda: Q.ring_qhop_cuda(hop, group=group), 20),
        plain_ms=time_ms(lambda: Q.ring_qhop_plain(hop), 5),
        yardstick_ms=time_ms(lambda: torch.roll(hop, 1, 0), 20),
        yardstick_computes="torch.roll(x, 1, 0), the exact hop (yardstick)",
        rows=h // 128)
    standalone["bound_ms"], standalone["bound_by"] = ring_bound(
        n * h * 4, n * h * 4)
    del hop
    b = torch.randn((n, n * h // 128, 128), generator=gen, device=dev)
    carry = torch.zeros((n - 1, n), dtype=torch.int64, device=dev)
    b4 = b.view(n, n, -1, 128)
    # Each run of hop 0 clears the carry and fills row 1, which every run
    # of hop 1 reads.
    out["C5"] = dict(
        form="in place (qrs_hop): ms is hop 1, its scale carried from hop 0",
        hop0_ms=time_ms(lambda: Q.ring_qrs_hop_cuda(b, 0, carry, group=group),
                        20),
        ms=time_ms(lambda: Q.ring_qrs_hop_cuda(b, 1, carry, group=group), 20),
        plain_ms=time_ms(lambda: Q.ring_qrs_hop_plain(b, 1), 3),
        yardstick_ms=time_ms(lambda: R._rs_hop(
            b4, 1, "sum", lambda v: Q.ring_qhop_cuda(v, group=group)), 5),
        yardstick_computes="gather of the send chunks, C5 standalone, gather"
                           " of the receiving chunks, add, index-put: the "
                           "route the in-place form replaced (yardstick)",
        bound=ring_bound(2 * n * h * 4, n * h * 4), rows=n * h // 128,
        standalone=standalone)
    del b, b4, carry
    gc.collect()
    torch.cuda.empty_cache()
    for row in out.values():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        row.update({"n": n, "dtype": "f32", "library_ms": None})
    return out


def phase_qring_kernels(dev, card, zero_elems=None):
    """C5 and C6 against their plain versions on the card, bit for bit, at
    every ring size, shape and variant of QRING_*; the ladder (a bf16 call
    and a call below _MIN_QUANT_ELEMS take C4, not C6); then at
    ``zero_elems`` per rank (the quantized ZeRO path's flat vector, n = 4)
    the same checks in place, and the two kernels' times beside their
    plain versions', bounds and yardsticks; and the times at 65536 rows
    per rank."""
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    checked = 0
    for n in RING_NS:
        group = RingGroup(n, dev)
        for shape in QRING_SHAPES:
            for variant in QRING_VARIANTS:
                x = _qring_input(n, shape, variant, gen, dev)
                for name, got, want in _qring_cases(x, group):
                    check(got.shape == want.shape and torch.equal(got, want),
                          f"{name} n={n} {shape} {variant}: differs from "
                          f"its plain version (max abs "
                          f"{(got - want).abs().max()})")
                    checked += 1
        group.check()
        del group
    log("ring", f"C5, C6 bitwise equal to their plain versions in {checked} "
        f"cases: n {RING_NS}, f32, per-rank shapes {QRING_SHAPES}, "
        f"{QRING_VARIANTS}")
    hops, interleaved = _qrs_cases(gen, dev)
    log("ring", f"C5 in place bitwise equal to its plain version (buffer and "
        f"carried max) in {hops} hops: n {QRS_NS}, per-rank shapes "
        f"{QRING_SHAPES}, {QRING_VARIANTS}; {interleaved} reduce-scatters "
        f"interleaved as the overlap path issues them equal the plain "
        f"version's and the same alone; an empty carry stops the kernel "
        f"and the group raises")

    group = RingGroup(ZERO_N, dev)
    kernels = (R.KERNELS[3], Q.KERNELS[1])     # C4, C6
    for name, x, kw in (
            ("f64", torch.randn((ZERO_N, 4096), generator=gen, device=dev,
                                dtype=torch.float64), {}),
            ("small", torch.randn((ZERO_N, 100), generator=gen, device=dev),
             {}),
            ("precision=bf16", torch.randn((ZERO_N, 4096), generator=gen,
                                           device=dev),
             {"precision": "bf16"})):
        before = [k.launches for k in kernels]
        got = Q.quantized_ring_allreduce(x, group=group, **kw)
        want = R.ring_allreduce(x.to(torch.bfloat16), impl="plain").to(
            x.dtype)
        moved = [k.launches - b for k, b in zip(kernels, before)]
        check(moved == [1, 0] and torch.equal(got, want),
              f"ladder, {name}: launches (C4, C6) {moved} != [1, 0] or the "
              f"bf16 ring's result differs")
    log("ring", "ladder: f64 input, 100 elements per rank and "
        "precision='bf16' each took C4 once (C6 not at all) and equal the "
        "plain bf16 ring")

    timings = []
    if zero_elems:
        x = torch.randn((ZERO_N, zero_elems), generator=gen, device=dev)
        y = x.clone()
        Q.ring_qallreduce_cuda(x.view(ZERO_N, -1, 128), group=group,
                               out=x.view(ZERO_N, -1, 128))
        Q.ring_qallreduce_plain(y.view(ZERO_N, -1, 128),
                                out=y.view(ZERO_N, -1, 128))
        check(torch.equal(x, y), "C6 at the quantized ZeRO size differs from "
              "its plain version")
        del y
        h = zero_elems // (ZERO_N * ZERO_CHUNKS * 128) * 128
        hop = x[:, :h].reshape(ZERO_N, -1, 128)
        check(torch.equal(Q.ring_qhop_cuda(hop, group=group),
                          Q.ring_qhop_plain(hop)),
              "C5 at the quantized ZeRO hop differs from its plain version")
        del hop
        # C5 in place on one overlap chunk (n ring chunks of h a rank), in
        # x itself (a view with x's rank stride, as the ZeRO path's chunk
        # of its gradient buffer) against a contiguous copy.
        got = x[:, :ZERO_N * h].view(ZERO_N, -1, 128)
        _qrs_hops(got, got.clone(), group)
        del got
        log("ring", f"quantized ZeRO size ({ZERO_N} ranks x {zero_elems} f32,"
            f" C6 in place; C5 on one overlap hop of {h}; C5 in place on one "
            f"overlap chunk of {ZERO_N * h}, hop by hop): bitwise equal to "
            f"the plain versions")
        timings.append(_qring_times(group, ZERO_N, zero_elems, gen, dev, x))
        del x
    timings.append(_qring_times(group, ZERO_N, 65536 * 128, gen, dev))
    group.check()
    del group
    gc.collect()
    torch.cuda.empty_cache()
    for t in timings:
        for k, row in t.items():
            log("ring", f"{k} n={row['n']} {row['rows']} rows f32: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['yardstick_computes']} {row['yardstick_ms']:.4f} ms; "
                f"{card}")
        c5, sa = t["C5"], t["C5"]["standalone"]
        log("ring", f"C5 in place, hop 0 (max pass) {c5['hop0_ms']:.4f} ms; "
            f"C5 standalone n={c5['n']} {sa['rows']} rows f32: kernel "
            f"{sa['ms']:.4f} ms, plain {sa['plain_ms']:.4f} ms, bound "
            f"{sa['bound_ms']:.4f} ms ({sa['bound_by']}), "
            f"{sa['yardstick_computes']} {sa['yardstick_ms']:.4f} ms; {card}")
    return timings


def phase_zero_quant_f32(dev):
    """The int8 exchange in f32 at dim 256 (the train phase's f32 config),
    at n = 2 and ZERO_N, monolithic (C6), overlap (C5 per hop) and with
    error feedback: ZERO_F32_STEPS AdamW steps through the kernels equal
    the same steps through the plain versions bit for bit (params, ef and
    loss), with exact C5 / C6 launch counts. Under
    ``torch.use_deterministic_algorithms``, as phase_zero_f32 (index_add_).
    Returns the number of bitwise comparisons."""
    import functools
    import warnings

    from ray_tpu_torch.models.llama import init_params, loss_fn
    from ray_tpu_torch.parallel import build_zero_train_step, create_zero_state
    from ray_tpu_torch.parallel.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q

    cfg = _zero_f32_cfg()
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    rng = np.random.RandomState(4)
    toks = [rng.randint(0, cfg.vocab_size, (ZERO_N, 301))
            for _ in range(ZERO_F32_STEPS)]

    def run(n, collective, **kw):
        group = RingGroup(n, dev)
        ef = kw.get("error_feedback", False)
        state = create_zero_state(init_params(cfg, seed=1, device=dev), opt,
                                  group, error_feedback=ef)
        step = build_zero_train_step(lambda p, b: loss_fn(p, b, cfg), opt,
                                     group, collective=collective,
                                     quantized_grads=True, **kw)
        for t in toks:
            state, m = step(state, {"tokens": t[:n]})
        group.check()
        return state, m["loss"].item()

    routes = (("monolithic", {}),
              ("overlap", {"overlap": True, "n_chunks": ZERO_CHUNKS}),
              ("error feedback", {"error_feedback": True}))
    checked = 0
    prev = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for n in (2, ZERO_N):
                for name, kw in routes:
                    for k in Q.KERNELS:
                        k.launches = 0
                    got, gl = run(n, "cuda", **kw)
                    launches = [k.launches for k in Q.KERNELS]
                    want, wl = run(n, "plain", **kw)
                    n_c = len(got.layout) - 1
                    expect = ([(n - 1) * n_c * ZERO_F32_STEPS, 0]
                              if kw.get("overlap") else [0, ZERO_F32_STEPS])
                    check(launches == expect, f"int8 ZeRO f32 n={n} {name}: "
                          f"launches (C5, C6) {launches} != {expect}")
                    same = torch.equal(got.flat, want.flat) and gl == wl
                    if got.ef is not None:
                        same = same and torch.equal(got.ef, want.ef)
                    check(same, f"int8 ZeRO f32 n={n} {name}: the kernels' "
                          f"steps differ from the plain versions'")
                    checked += 1
                    del got, want
        finally:
            torch.use_deterministic_algorithms(prev)
    log("zero", f"int8 exchange, f32 dim 256, n = 2 and {ZERO_N}, "
        f"{ZERO_F32_STEPS} AdamW steps, monolithic (C6), overlap (C5 per "
        f"hop, {ZERO_CHUNKS} chunks) and error feedback: {checked} runs "
        f"bitwise equal to the plain versions (params, ef, loss), launches "
        f"exact")
    return checked


def _int8_first_grad(cfg, opt, batch, n, dev):
    """The first step's gradient of ``cfg`` over n ranks through the
    exact reduce-scatter (C2) and through the int8 ring (C6): (loss, the
    int8 shards' relative L2 distance from the exact ones, the share of
    shard elements sent as 0, the share sent as 0 where the exact sum is
    not 0). Everything it allocates is freed on return."""
    from ray_tpu_torch.models.llama import init_params, loss_fn
    from ray_tpu_torch.parallel import create_zero_state
    from ray_tpu_torch.parallel import zero as Z
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    group = RingGroup(n, dev)
    state = create_zero_state(init_params(cfg, seed=0, device=dev), opt,
                              group)
    loss, _ = Z._local_grads(state, lambda p, b: loss_fn(p, b, cfg), batch)
    s = state.flat.shape[1] // n
    with torch.no_grad():
        g = state.grads.clone()
        exact = R.ring_reduce_scatter(g.view(n, -1, 128), group=group,
                                      donate=True)
        del g
        full = Q.quantized_ring_allreduce(state.grads, group=group,
                                          donate=True)
        diff = ref = 0.0
        zeros = zeros_nz = 0
        step_e = 1 << 26
        for r in range(n):
            q, e = full[r, r * s:(r + 1) * s], exact[r].view(-1)
            for i in range(0, s, step_e):
                qi, ei = q[i:i + step_e], e[i:i + step_e].float()
                diff += (qi - ei).square().sum().item()
                ref += ei.square().sum().item()
                zeros += (qi == 0).sum().item()
                zeros_nz += ((qi == 0) & (ei != 0)).sum().item()
    group.check()
    return (loss.item(), (diff / ref) ** 0.5, zeros / (n * s),
            zeros_nz / (n * s))


def phase_zero_quant(dev, card):
    """Llama-3-8B widths at QZERO_LAYERS layers through
    ``build_zero_train_step(quantized_grads=True)`` over ZERO_N virtual
    ranks, from the same initial params: ZERO_STEPS monolithic steps (C6 +
    C3), ZERO_STEPS with ``error_feedback=True``, and ZERO_STEPS with
    ``overlap=True`` (C5 per reduce-scatter hop, C1 per allgather hop),
    each followed by one profiled step. Before them the first step's
    gradient through the exact reduce-scatter (C2) and through the int8
    ring (C6): the relative L2 distance of the shards and the share of
    elements the int8 exchange sends as 0. See the module docstring for
    the gates."""
    import functools

    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import build_zero_train_step, create_zero_state
    from ray_tpu_torch.parallel.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.util.collective import RingGroup
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    f32_checked = phase_zero_quant_f32(dev)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = LlamaConfig.llama3_8b(
        n_layers=QZERO_LAYERS, max_seq_len=TRAIN_SEQ, attn_impl="flash",
        remat="dots", param_dtype=torch.bfloat16)
    L, n = cfg.n_layers, ZERO_N
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size,
                           (n, TRAIN_SEQ + 1)).astype(np.int64)
               for _ in range(ZERO_STEPS + 1)]
    tokens = n * TRAIN_SEQ
    ring_kernels = R.KERNELS + Q.KERNELS
    b_kernels = (attention.flash_fwd_cuda, attention.flash_bwd_dkv_cuda,
                 attention.flash_bwd_dq_cuda)
    n_params = cfg.num_params()
    log("zero", f"int8 exchange: Llama-3-8B widths, {L} layer, "
        f"{n_params / 1e9:.3f} B params (bf16), {n} virtual ranks, AdamW, "
        f"batch {n} x {TRAIN_SEQ}; {card}")

    # The first step's gradient, exact and through the int8 ring.
    loss0, grad_rel, zero_share, zero_share_nz = _int8_first_grad(
        cfg, opt, {"tokens": batches[0]}, n, dev)
    log("zero", f"int8 exchange of the first step's gradient against the "
        f"exact reduce-scatter (C2, bf16): shards' relative L2 distance "
        f"{grad_rel:.4f}; {100 * zero_share:.2f}% of shard elements sent as "
        f"0 ({100 * zero_share_nz:.2f}% where the exact sum is not 0)")
    gc.collect()
    torch.cuda.empty_cache()

    def run(name, **kw):
        group = RingGroup(n, dev)
        torch.cuda.reset_peak_memory_stats()
        ef = kw.get("error_feedback", False)
        state = create_zero_state(init_params(cfg, seed=0, device=dev), opt,
                                  group, error_feedback=ef)
        step = build_zero_train_step(
            lambda p, b: loss_fn(p, b, cfg), opt, group, quantized_grads=True,
            n_chunks=ZERO_CHUNKS, **kw)
        for k in ring_kernels + b_kernels:
            k.launches = 0
        losses, norms, times = [], [], []
        for i in range(ZERO_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": batches[i]})
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            times.append(time.perf_counter() - t0)
        group.check()
        ring = [k.launches for k in ring_kernels]
        b = [k.launches for k in b_kernels]
        n_c = len(state.layout) - 1
        hops = (n - 1) * n_c * ZERO_STEPS
        want = ([hops, 0, 0, 0, hops, 0] if kw.get("overlap")
                else [0, 0, ZERO_STEPS, 0, 0, ZERO_STEPS])
        want_b = [2 * L * n * ZERO_STEPS, L * n * ZERO_STEPS,
                  L * n * ZERO_STEPS]
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"int8 {name}: non-finite loss or grad norm {losses} {norms}")
        loss_rel = abs(losses[0] - loss0) / abs(loss0)
        check(loss_rel <= 1e-6, f"int8 {name}: first loss {losses[0]} is not "
              f"the exact step's {loss0}")
        check(ring == want, f"int8 {name}: launches (C1-C6) {ring} != {want}")
        check(b == want_b, f"int8 {name}: launches (B1-B3) {b} != {want_b}")
        check(all(torch.equal(state.flat[r], state.flat[0])
                  for r in range(n)),
              f"int8 {name}: a rank's parameter copy differs from rank 0's")
        rec = {}
        if ef:
            # max|ef| as a reduction (no copy of the 19 GiB buffer); a
            # NaN or an inf anywhere makes it non-finite.
            ef_max = torch.linalg.vector_norm(state.ef, float("inf")).item()
            check(state.ef.dtype == torch.float32 and np.isfinite(ef_max)
                  and ef_max > 0,
                  f"int8 {name}: ef is not finite, f32 and non-zero")
            rec["ef_abs_max"] = ef_max
        peak = torch.cuda.max_memory_allocated()
        before = PEAK_GIB_BEFORE.get(f"int8 {name}")
        step_s = float(np.median(times[1:]))
        log("zero", f"int8 {name}: losses "
            + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
            + ", ".join(f"{x:.3f}" for x in norms))
        log("zero", f"int8 {name}: {ZERO_STEPS} steps of {n} ranks x "
            f"{TRAIN_SEQ} tokens: step times "
            + ", ".join(f"{x:.3f}" for x in times) + f" s; median after the "
            f"first {step_s:.4f} s = {tokens / step_s:.0f} tokens/s; peak "
            f"memory {peak / 2**30:.2f} GiB"
            + (f" (before the hop ran in place: {before} GiB)" if before
               else "") + f"; launches C1-C6 {ring} (expected "
            f"{want}), B1-B3 {b}; every rank's copy equal; {card}")
        log("zero", f"int8 {name}: one profiled step")
        prof = _profile_step("zero", step, state, batches[ZERO_STEPS], card)
        wall, busy, groups = prof["wall_ms"], prof["busy_ms"], prof["groups"]
        q_ms = groups.get("ring C5/C6", 0.0)
        ring_ms = q_ms + groups.get("ring C1-C4", 0.0)
        rec.update({"profiled_groups": groups,
            "losses": losses, "grad_norms": norms, "step_times_s": times,
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "peak_gib": peak / 2**30, "launches_c1_c6": ring,
            "launches_b1_b3": b, "chunks": n_c, "first_loss_rel": loss_rel,
            "profiled_wall_ms": wall, "profiled_busy_ms": busy,
            "q_ms": q_ms, "ring_ms": ring_ms, "q_share": q_ms / busy})
        del state, step, group
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    out = {"layers": L, "params": n_params, "first_loss": loss0,
           "first_grad_rel_l2": grad_rel, "first_grad_zero_share": zero_share,
           "first_grad_zero_share_nonzero_exact": zero_share_nz,
           "f32_bitwise_runs": f32_checked}
    out["monolithic"] = run("monolithic")
    out["error_feedback"] = run("error feedback", error_feedback=True)
    out["overlap"] = run("overlap", overlap=True)
    return out


# Phase 6i: the trainer on the card. Timed steps after the warmup step;
# the model, batch and ranks are the ZeRO phase's.
TRAINER_STEPS = 3


def _trainer_loop(config):
    """``pod_train_loop`` in the trainer's worker, with what 6i reads
    there reported beside its summary: the lease, the per-step losses
    (``run_pod_training``'s ``report`` hook, which ``pod_train_loop``
    leaves unset, given here as the driver's in-process call is given
    it) and the kernels' launch counts over the run."""
    import os
    import time

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.train import cuda_backend
    from ray_tpu_torch.util.collective import ring as R

    entered = time.time()
    kernels = (attention.flash_fwd_cuda, attention.flash_bwd_dkv_cuda,
               attention.flash_bwd_dq_cuda, R.KERNELS[1], R.KERNELS[2])
    for k in kernels:
        k.launches = 0
    losses = []
    run = cuda_backend.run_pod_training

    def with_losses(**kw):
        return run(**dict(kw, report=lambda m: losses.append(m["loss"])))

    cuda_backend.run_pod_training = with_losses
    try:
        cuda_backend.pod_train_loop(config)
    finally:
        cuda_backend.run_pod_training = run
    train.report({
        "losses": losses, "launches": [k.launches for k in kernels],
        "gpu_ids": ray_tpu_torch.get_gpu_ids(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "device_name": torch.cuda.get_device_name(0),
        "entered": entered, "pid": os.getpid()})


def _tree_cuda_equal(got, want):
    """Every tensor of ``got`` on the card and bit-equal to ``want``'s."""
    if isinstance(want, dict):
        return list(got) == list(want) and all(
            _tree_cuda_equal(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(
            _tree_cuda_equal(g, w) for g, w in zip(got, want))
    if isinstance(want, torch.Tensor):
        return (got.is_cuda and got.dtype == want.dtype
                and got.shape == want.shape
                and _bits_equal(got, want))
    return got == want


def _print_worker_stderr(logs_dir):
    """Print every worker's stderr log of the session, whole."""
    for path in sorted(glob.glob(os.path.join(logs_dir, "worker-*.err"))):
        with open(path, errors="replace") as f:
            text = f.read()
        print(f"[trainer] ---- {os.path.basename(path)}, {len(text)} "
              f"characters, whole ----\n{text}\n[trainer] ---- end of "
              f"{os.path.basename(path)} ----", flush=True)


def phase_trainer(dev, card):
    """Train on the port's runtime; see the module docstring (6i)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models.llama import (
        LlamaConfig, flops_per_token, init_params, loss_fn)
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import build_train_step, create_train_state
    from ray_tpu_torch.parallel.train_step import _leaves
    from ray_tpu_torch.train import (
        Checkpoint, CudaConfig, CudaTrainer, RunConfig, ScalingConfig)
    from ray_tpu_torch.train.cuda_backend import run_pod_training
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.collective import ring as R

    phase_t0 = time.perf_counter()
    cfg = LlamaConfig.llama3_8b(
        n_layers=TRAIN_LAYERS, max_seq_len=TRAIN_SEQ, attn_impl="flash",
        remat="dots", param_dtype=torch.bfloat16)
    L, n = cfg.n_layers, ZERO_N
    args = dict(model_config=cfg, mesh_axes={"data": n},
                steps=TRAINER_STEPS, batch_size=TRAIN_BATCH,
                seq_len=TRAIN_SEQ + 1, weight_update="sharded", seed=0)
    kernels = (attention.flash_fwd_cuda, attention.flash_bwd_dkv_cuda,
               attention.flash_bwd_dq_cuda, R.KERNELS[1], R.KERNELS[2])
    names = ("B1", "B2", "B3", "C2", "C3")
    runs = TRAINER_STEPS + 1                     # the warmup step too
    want = [2 * L * n * runs, L * n * runs, L * n * runs, runs, runs]
    out = {"card": card, "steps": TRAINER_STEPS, "ranks": n}
    log("trainer", f"Llama-3-8B widths, {L} layers, bf16, flash, "
        f"remat='dots', ZeRO over {n} virtual ranks, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} targets, {TRAINER_STEPS} timed steps after the "
        f"warmup step; {card}")

    # The first batch, as run_pod_training makes it (seed 0; the same in
    # the worker): its tokens must index the embedding.
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype("int32")
    log("trainer", f"first batch {tokens.shape}: token min {tokens.min()}, "
        f"max {tokens.max()}, vocabulary {cfg.vocab_size}")
    check(0 <= tokens.min() and tokens.max() < cfg.vocab_size,
          "the first batch's tokens lie outside the vocabulary")

    # In process, before any cluster: the rows it would publish go
    # nowhere, so the step matrix below holds the worker's alone. A CUDA
    # error fails the phase with its text (nothing retries).
    for k in kernels:
        k.launches = 0
    losses, norms, prints = [], [], []
    t0 = time.perf_counter()
    try:
        local = run_pod_training(
            **args, device=dev,
            report=lambda m: (losses.append(m["loss"]),
                              norms.append(m["grad_norm"])),
            on_finish=lambda st: prints.append(_flat_fingerprint(
                st.flat[0])))
        torch.cuda.synchronize(dev)
    except Exception as e:
        log("trainer", f"the in-process run failed: {type(e).__name__}: "
            f"{e}")
        raise
    out["in_process_s"] = time.perf_counter() - t0
    local_counts = [k.launches for k in kernels]
    gc.collect()
    torch.cuda.empty_cache()
    check(len(losses) == TRAINER_STEPS and all(np.isfinite(losses)),
          f"in-process losses {losses}")
    check(local_counts == want, f"in-process launches "
          f"{dict(zip(names, local_counts))} != {dict(zip(names, want))}")

    mem0 = gpu_memory_used_mib()
    t0 = time.perf_counter()
    session = rt.init(num_gpus=1)["session_dir"]
    out["cluster_start_s"] = time.perf_counter() - t0
    storage = tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_")
    try:
        t_fit = time.time()
        t0 = time.perf_counter()
        try:
            result = CudaTrainer(
                _trainer_loop, train_loop_config=dict(
                    model_config=cfg, steps=TRAINER_STEPS,
                    batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ + 1, seed=0),
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                cuda_config=CudaConfig(weight_update="sharded",
                                       mesh_axes={"data": n}),
                run_config=RunConfig(name="trainer",
                                     storage_path=storage.name)).fit()
        except Exception as e:
            # The worker's whole stderr (a device-side assert prints its
            # text there), then the failure as it was.
            _print_worker_stderr(os.path.join(session, "logs"))
            log("trainer", f"fit() failed: {type(e).__name__}: {e}")
            raise
        out["fit_s"] = time.perf_counter() - t0
        summary, seen = result.metrics_dataframe[0], result.metrics
        out["worker_ready_s"] = seen["entered"] - t_fit
        log("trainer", f"cluster up in {out['cluster_start_s']:.2f} s; the "
            f"worker's loop began {out['worker_ready_s']:.2f} s into fit(), "
            f"which took {out['fit_s']:.2f} s; the worker: gpu ids "
            f"{seen['gpu_ids']}, CUDA_VISIBLE_DEVICES="
            f"{seen['cuda_visible_devices']!r}, {seen['device_name']}; "
            f"{card}")
        check(seen["gpu_ids"] == [0]
              and seen["cuda_visible_devices"] == "0",
              f"the worker's lease: {seen}")
        check(seen["pid"] != os.getpid(), "the loop ran in the driver")
        check("H100" in seen["device_name"],
              f"the worker's card is {seen['device_name']}")
        check(seen["losses"] == losses, f"the worker's losses "
              f"{seen['losses']} differ from the in-process {losses}")
        check(seen["launches"] == local_counts and all(seen["launches"]),
              f"the worker's launches {dict(zip(names, seen['launches']))}"
              f" != in-process {dict(zip(names, local_counts))}")
        log("trainer", "losses, worker == in-process bit for bit: "
            + ", ".join(f"{x:.6f}" for x in losses) + "; launches in the "
            "worker " + ", ".join(f"{a} {b}" for a, b in
                                  zip(names, seen["launches"]))
            + f" (in process the same; {runs} steps of {L} layers x {n} "
            f"ranks)")

        g = summary.get("goodput")
        check(isinstance(g, dict) and 0 < g["goodput_ratio"] <= 1
              and g["lost_s"]["recompiling"] > 0
              and len(summary["step_walls"]) == TRAINER_STEPS,
              f"the summary's goodput block: {g}")

        def matrix():
            info = next((r for r in state.train_summary()["workers"]
                         if r["worker"] == "train-0"), None)
            return info if info and info["done"] else None

        info = _poll(matrix, timeout=30)
        rows = state.list_train_steps(worker="train-0")
        summ = state.train_summary()
        check(info is not None and [r["step"] for r in rows]
              == list(range(TRAINER_STEPS))
              and all("compute" in r["phases"] for r in rows),
              f"the GCS step matrix: {rows}, {info}")
        check(not info["stalled"] and summ["stalled"] == [],
              f"the GCS reads a stall: {summ}")
        log("trainer", f"summary goodput ratio {g['goodput_ratio']:.4f} "
            f"(productive {g['productive_s']:.3f} s of "
            f"{g['accounted_s']:.3f} s; lost "
            + ", ".join(f"{k} {v:.3f}" for k, v in g["lost_s"].items())
            + " s); phase sums over the timed steps "
            + ", ".join(f"{k} {v:.4f}" for k, v in
                        summary["phase_seconds"].items())
            + f" s; {len(rows)} step rows for train-0 in the GCS, done, "
            f"no stall; in process: goodput ratio "
            f"{local['goodput']['goodput_ratio']:.4f}, warmup step "
            f"(recompiling) {local['goodput']['lost_s']['recompiling']:.3f}"
            f" s; {card}")

        fpt = flops_per_token(cfg, TRAIN_SEQ)
        for side, s in (("trainer", summary), ("in_process", local)):
            out[f"{side}_tok_s"] = s["tokens_per_sec"]
            out[f"{side}_mfu"] = fpt * s["tokens_per_sec"] / PEAK_FLOPS[
                torch.bfloat16]
        out["tok_s_ratio"] = out["trainer_tok_s"] / out["in_process_tok_s"]
        out.update(losses=losses, grad_norms=norms, fingerprint=prints[0],
                   launches=dict(zip(names, local_counts)),
                   worker_launches=dict(zip(names, seen["launches"])),
                   goodput=g, phase_seconds=summary["phase_seconds"],
                   step_walls=summary["step_walls"],
                   in_process_goodput=local["goodput"])
        log("trainer", f"tokens/s through the trainer "
            f"{out['trainer_tok_s']:.0f} (MFU {100 * out['trainer_mfu']:.2f}"
            f"%), in process {out['in_process_tok_s']:.0f} (MFU "
            f"{100 * out['in_process_mfu']:.2f}%): ratio "
            f"{out['tok_s_ratio']:.4f}; step walls "
            + ", ".join(f"{x:.4f}" for x in summary["step_walls"])
            + f" s; {card}")
        procs = _cluster_pids()
    finally:
        rt.shutdown()
        storage.cleanup()
    deadline = time.monotonic() + 30
    while True:
        left = {p: c for p, c in procs.items() if _alive(p, c)}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"processes left after shutdown: {left}")
    gc.collect()
    torch.cuda.empty_cache()
    out["memory_before_mib"] = mem0
    out["memory_after_mib"] = gpu_memory_used_mib()
    check(abs(out["memory_after_mib"] - mem0) < 1024,
          f"card memory {mem0:.0f} MiB before the cluster, "
          f"{out['memory_after_mib']:.0f} MiB after")

    # A tiny() bf16 train state on the card through a checkpoint.
    tcfg = LlamaConfig.tiny(param_dtype=torch.bfloat16)
    st = create_train_state(init_params(tcfg, 0, dev), device=dev)
    step = build_train_step(lambda p, b: loss_fn(p, b, tcfg), device=dev)
    st, _ = step(st, {"tokens": np.random.RandomState(0).randint(
        0, tcfg.vocab_size, (2, 33))})
    leaves = _leaves(st.params)
    tree = {"params": st.params, "step": st.step,
            "moments": [(st.optimizer.state[p]["exp_avg"],
                         st.optimizer.state[p]["exp_avg_sq"])
                        for p in leaves]}
    back = Checkpoint.from_pytree(tree).to_pytree(device="cuda")
    check(_tree_cuda_equal(back, tree), "the tiny() bf16 train state did "
          "not come back from its checkpoint bit for bit on the card")
    out["checkpoint_tensors"] = 3 * len(leaves)
    out["phase_s"] = time.perf_counter() - phase_t0
    log("trainer", f"tiny() bf16 train state ({3 * len(leaves)} tensors: "
        f"params and AdamW moments) through Checkpoint.from_pytree / "
        f"to_pytree(device='cuda'): bit for bit, on the card; shut down: "
        f"no cluster process left, card memory {mem0:.0f} -> "
        f"{out['memory_after_mib']:.0f} MiB; the phase took "
        f"{out['phase_s']:.1f} s; {card}")
    del st, back, tree
    return out


# ---------------------------------------------------------------------------
# 6k: the ZeRO gang -- parallel.zero with one rank per process.
# ---------------------------------------------------------------------------

# The four-worker gang's depth: at 4 layers four ranks' state, workspaces
# and contexts do not fit the card's 80 GB (PERF.md §4).
GANG_LAYERS = 2
# Per gang size: (route, layers, how, step keyword arguments), run in this
# order in the same workers, each from seed 0's params. "pod" runs
# run_pod_training (the entry point a CudaTrainer loop calls); "zero"
# builds parallel.zero's step over the gang's group (run_pod_training,
# as the reference's, has no int8 exchange).
GANG_ROUTES = {
    4: (("monolithic", GANG_LAYERS, "pod", {}),
        ("overlap", GANG_LAYERS, "pod", {"overlap": True})),
    2: (("monolithic", TRAIN_LAYERS, "pod", {}),
        ("quantized", QZERO_LAYERS, "zero", {"quantized_grads": True}),
        ("error feedback", QZERO_LAYERS, "zero",
         {"quantized_grads": True, "error_feedback": True}),
        ("quantized overlap", QZERO_LAYERS, "zero",
         {"quantized_grads": True, "overlap": True,
          "n_chunks": ZERO_CHUNKS})),
}
# Each rank's predicted peak (GB: torch's peak allocation plus the ring's
# workspace), per gang size and depth (PERF.md's prediction for
# the gradients streamed into the buffer).
GANG_PREDICTED_GB = {(4, GANG_LAYERS): 15.5, (2, TRAIN_LAYERS): 21.5,
                     (2, QZERO_LAYERS): 20.5}
GANG_KERNELS = ("B1", "B2", "B3", "C1", "C2", "C3", "C5", "C6")


def _gang_cfg(layers):
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama3_8b(
        n_layers=layers, max_seq_len=TRAIN_SEQ, attn_impl="flash",
        remat="dots", param_dtype=torch.bfloat16)


_ARANGE = {}


def _flat_fingerprint(row):
    """Two integers that equal parameter rows share: the sum of the row's
    16-bit words and their sum weighted by position (mod 65521, plus 1),
    taken on the device a piece at a time."""
    words = row.detach().reshape(-1).view(torch.int16)
    piece = 1 << 24
    w = _ARANGE.get(words.device)
    if w is None:
        w = _ARANGE[words.device] = (torch.arange(
            piece, device=words.device, dtype=torch.int64) % 65521) + 1
    total = weighted = 0
    for i in range(0, words.numel(), piece):
        v = words[i:i + piece].to(torch.int64)
        total += int(v.sum())
        weighted += int((v * w[:v.numel()]).sum()) * (i // piece + 1)
    return [total, weighted]


def _zero_steps(cfg, group, kw, dev):
    """``parallel.zero``'s step over ``group`` (a RingGroup in this
    process, or the gang's CudaGroup) with run_pod_training's arguments:
    seed 0's params and batch, AdamW at 1e-3, the warmup step, then
    TRAINER_STEPS timed steps. Returns the timed steps' losses, grad
    norms and walls, and the first held rank's fingerprint."""
    import functools

    from ray_tpu_torch.models.llama import init_params, loss_fn
    from ray_tpu_torch.parallel import (
        build_zero_train_step, create_zero_state)
    from ray_tpu_torch.parallel.train_step import WEIGHT_DECAY

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    opt = functools.partial(torch.optim.AdamW, lr=1e-3,
                            weight_decay=WEIGHT_DECAY)
    state = create_zero_state(init_params(cfg, 0, device=dev), opt, group,
                              error_feedback=kw.get("error_feedback",
                                                    False))
    step = build_zero_train_step(lambda p, b: loss_fn(p, b, cfg), opt,
                                 group, **kw)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype("int32")
    batch = {"tokens": torch.from_numpy(tokens).to(dev, torch.int64)}
    losses, norms, walls = [], [], []
    for i in range(1 + TRAINER_STEPS):
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync()
        if i:
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    fp = _flat_fingerprint(state.flat[0])
    del state, step
    return losses, norms, walls, fp


def _gang_loop(config):
    """CudaTrainer's loop in 6k's workers: every route of ``routes`` in
    turn, each from seed 0's params, with the per-step losses and grad
    norms, the final params' fingerprint, the kernels' launch counts, the
    step walls, the peak memory and the ring's staging (bytes and host
    time in its calls) read in this process; rank 0 reports every rank's
    record (gathered over the gang's process group)."""
    import os
    import sys
    import time

    import torch
    import torch.distributed as dist

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.train import cuda_backend
    from ray_tpu_torch.util.collective import process_ring as PR

    entered = time.time()
    group = cuda_backend.gang_group(config["device"])
    dev, ring = group.device, group.ring
    on_card = dev.type == "cuda"
    kernels = dict(zip(GANG_KERNELS, (
        attention.flash_fwd_cuda, attention.flash_bwd_dkv_cuda,
        attention.flash_bwd_dq_cuda, PR.ring_permute_rank_cuda,
        PR.ring_reduce_scatter_rank_cuda, PR.ring_allgather_rank_cuda,
        PR.ring_qrs_hop_rank_cuda, PR.ring_qallreduce_rank_cuda)))
    in_ring = [0.0]

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                in_ring[0] += time.perf_counter() - t0
        return call

    # A whole call is an enqueue and a finish: the host's time in both.
    if ring is not None:
        ring._enqueue = timed(ring._enqueue)
        ring.finish = timed(ring.finish)
    runs = {}
    for name, layers, how, kw in config["routes"]:
        cfg = _gang_cfg(layers)
        for k in kernels.values():
            k.launches = 0
        staged0 = ring.staged_bytes if on_card else 0
        in_ring[0] = 0.0
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        losses, norms, prints = [], [], []
        t0 = time.perf_counter()
        if how == "pod":
            summary = cuda_backend.run_pod_training(
                model_config=cfg, mesh_axes=config["mesh_axes"],
                steps=TRAINER_STEPS, batch_size=TRAIN_BATCH,
                seq_len=TRAIN_SEQ + 1, weight_update="sharded", seed=0,
                device=config["device"],
                report=lambda m: (losses.append(m["loss"]),
                                  norms.append(m["grad_norm"])),
                on_finish=lambda st: prints.append(_flat_fingerprint(
                    st.flat[0])), **kw)
            walls, tok_s = summary["step_walls"], summary["tokens_per_sec"]
        else:
            losses, norms, walls, fp = _zero_steps(cfg, group, kw, dev)
            prints.append(fp)
            tok_s = TRAIN_BATCH * TRAIN_SEQ * len(walls) / sum(walls)
        runs[name] = {
            "losses": losses, "grad_norms": norms, "fingerprint": prints[0],
            "launches": {k: f.launches for k, f in kernels.items()},
            "step_walls": walls, "tok_s": tok_s,
            "route_s": time.perf_counter() - t0,
            "peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9
            if on_card else 0.0,
            "workspace_gb": ring._data_bytes / 1e9 if on_card else 0.0,
            "staged_bytes": ring.staged_bytes - staged0 if on_card else 0,
            "ring_host_s": in_ring[0]}
        gc.collect()
        torch.cuda.empty_cache()
    mine = {"rank": group.rank, "pid": os.getpid(), "entered": entered,
            "runs": runs, "gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_name": torch.cuda.get_device_name(0) if on_card
            else str(dev),
            "jax_modules": sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax", "ray_tpu"))}
    every = [None] * group.world_size
    dist.all_gather_object(every, mine)
    train.report({"workers": every})


def _gang_launches(n, layers, how, kw):
    """Each worker's launches over one route's 1 + TRAINER_STEPS steps:
    one rank's forward and backward (B1 twice a layer under remat="dots"),
    and its exchanges' rank forms."""
    from ray_tpu_torch.parallel.zero import _chunks, _padded_len

    runs = 1 + TRAINER_STEPS
    padded = _padded_len(_gang_cfg(layers).num_params(), n)
    chunks = len(_chunks(padded, n, kw.get("n_chunks", 4)))
    want = dict.fromkeys(GANG_KERNELS, 0)
    want.update(B1=2 * layers * runs, B2=layers * runs, B3=layers * runs)
    if kw.get("quantized_grads") and kw.get("overlap"):
        want.update(C5=2 * (n - 1) * chunks * runs,
                    C1=(n - 1) * chunks * runs)
    elif kw.get("quantized_grads"):
        want.update(C6=(2 * (n - 1) + 1) * runs, C3=runs)
    elif kw.get("overlap"):
        want.update(C1=2 * (n - 1) * chunks * runs)
    else:
        want.update(C2=runs, C3=runs)
    return want


def phase_zero_gang(dev, card, trainer):
    """ZeRO with one rank per process; see the module docstring (6k)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (
        CudaConfig, CudaTrainer, RunConfig, ScalingConfig)
    from ray_tpu_torch.train.cuda_backend import run_pod_training
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.collective import RingGroup

    phase_t0 = time.perf_counter()
    out = {"card": card, "gangs": {}}
    # The workers' device: the card each lease names (a CPU rehearsal
    # passes the CPU).
    device = None if dev.type == "cuda" else str(dev)
    # In this process first, before any cluster: the virtual-rank run each
    # gang route is held to. The four-rank monolithic run is 6i's.
    ref = {}
    t0 = time.perf_counter()
    for n, routes in GANG_ROUTES.items():
        for name, layers, how, kw in routes:
            if (n, name, layers) == (ZERO_N, "monolithic", TRAIN_LAYERS):
                ref[n, name] = {"losses": trainer["losses"],
                                "grad_norms": trainer["grad_norms"],
                                "fingerprint": trainer["fingerprint"],
                                "tok_s": trainer["in_process_tok_s"],
                                "step_walls": None}
                continue
            cfg = _gang_cfg(layers)
            if how == "pod":
                losses, norms, prints = [], [], []
                res = run_pod_training(
                    model_config=cfg, mesh_axes={"data": n},
                    steps=TRAINER_STEPS, batch_size=TRAIN_BATCH,
                    seq_len=TRAIN_SEQ + 1, weight_update="sharded", seed=0,
                    device=dev,
                    report=lambda m: (losses.append(m["loss"]),
                                      norms.append(m["grad_norm"])),
                    on_finish=lambda st: prints.append(_flat_fingerprint(
                        st.flat[0])), **kw)
                ref[n, name] = {"losses": losses, "grad_norms": norms,
                                "fingerprint": prints[0],
                                "tok_s": res["tokens_per_sec"],
                                "step_walls": res["step_walls"]}
            else:
                losses, norms, walls, fp = _zero_steps(
                    cfg, RingGroup(n, dev), kw, dev)
                ref[n, name] = {"losses": losses, "grad_norms": norms,
                                "fingerprint": fp, "step_walls": walls,
                                "tok_s": TRAIN_BATCH * TRAIN_SEQ
                                * len(walls) / sum(walls)}
            gc.collect()
            torch.cuda.empty_cache()
            check(all(np.isfinite(ref[n, name]["losses"])),
                  f"in-process {name} at n={n}: {ref[n, name]}")
    out["in_process_s"] = time.perf_counter() - t0
    log("gang", f"in process: the virtual-rank runs the gangs are held "
        f"to, {len(ref) - 1} new ({out['in_process_s']:.1f} s; the "
        f"four-rank monolithic run is 6i's); {card}")

    mem0 = gpu_memory_used_mib()
    t0 = time.perf_counter()
    session = rt.init(num_gpus=1)["session_dir"]
    out["cluster_start_s"] = time.perf_counter() - t0
    storage = tempfile.TemporaryDirectory(prefix="chip_smoke_gang_")
    procs = {}
    try:
        for n, routes in GANG_ROUTES.items():
            t_fit, t0 = time.time(), time.perf_counter()
            try:
                result = CudaTrainer(
                    _gang_loop, train_loop_config=dict(
                        routes=routes, mesh_axes={"data": n},
                        device=device),
                    scaling_config=ScalingConfig(
                        num_workers=n, use_gpu=True,
                        resources_per_worker={"CPU": 1, "GPU": 1.0 / n}),
                    cuda_config=CudaConfig(
                        device=device, weight_update="sharded",
                        mesh_axes={"data": n}),
                    run_config=RunConfig(name=f"gang{n}",
                                         storage_path=storage.name)).fit()
            except Exception as e:
                _print_worker_stderr(os.path.join(session, "logs"))
                log("gang", f"n={n}: fit() failed: {type(e).__name__}: {e}")
                raise
            fit_s = time.perf_counter() - t0
            workers = sorted(result.metrics["workers"],
                             key=lambda w: w["rank"])
            check([w["rank"] for w in workers] == list(range(n)),
                  f"n={n}: the workers' ranks {[w['rank'] for w in workers]}")
            check(all(w["gpu_ids"] == [0] and w["cuda_visible_devices"]
                      == "0" and "H100" in w["device_name"]
                      and not w["jax_modules"] and w["pid"] != os.getpid()
                      for w in workers),
                  f"n={n}: the workers' leases and modules: " + str(
                      [{k: v for k, v in w.items() if k != "runs"}
                       for w in workers]))
            gang = {"fit_s": fit_s, "routes": {},
                    "worker_ready_s": max(w["entered"] for w in workers)
                    - t_fit}
            for name, layers, how, kw in routes:
                want = ref[n, name]
                got = [w["runs"][name] for w in workers]
                for r, g in enumerate(got):
                    check(g["losses"] == want["losses"]
                          and g["grad_norms"] == want["grad_norms"],
                          f"n={n} {name}: rank {r}'s losses {g['losses']} "
                          f"and grad norms {g['grad_norms']} differ from "
                          f"the in-process virtual ranks' "
                          f"{want['losses']}, {want['grad_norms']}")
                    check(g["fingerprint"] == want["fingerprint"],
                          f"n={n} {name}: rank {r}'s params fingerprint "
                          f"{g['fingerprint']} != in process "
                          f"{want['fingerprint']}")
                    lw = _gang_launches(n, layers, how, kw)
                    check(g["launches"] == lw,
                          f"n={n} {name}: rank {r}'s launches "
                          f"{g['launches']} != {lw}")
                walls = [float(np.mean(g["step_walls"])) for g in got]
                wall = max(walls)
                peak = [g["peak_allocated_gb"] + g["workspace_gb"]
                        for g in got]
                row = {
                    "layers": layers, "losses": want["losses"],
                    "grad_norms": want["grad_norms"],
                    "launches_per_worker": got[0]["launches"],
                    "step_wall_s": walls, "tok_s": got[0]["tok_s"],
                    "in_process_tok_s": want["tok_s"],
                    "tok_s_ratio": got[0]["tok_s"] / want["tok_s"],
                    "peak_gb": peak,
                    "predicted_peak_gb": GANG_PREDICTED_GB.get((n, layers)),
                    "staged_gb_per_step": [g["staged_bytes"] / 1e9
                                           / (1 + TRAINER_STEPS)
                                           for g in got],
                    "ring_host_s_per_step": [g["ring_host_s"]
                                             / (1 + TRAINER_STEPS)
                                             for g in got],
                    "route_s": max(g["route_s"] for g in got)}
                row["ring_share_of_step"] = (
                    max(row["ring_host_s_per_step"]) / wall)
                gang["routes"][name] = row
                log("gang", f"n={n} {name} ({layers} layers): every rank's "
                    f"losses and grad norms bit for bit the in-process "
                    f"virtual ranks' ("
                    + ", ".join(f"{x:.6f}" for x in want["losses"])
                    + f"), every rank's params fingerprint equal to theirs; "
                    f"launches a worker {got[0]['launches']}; step walls "
                    + ", ".join(f"{x:.4f}" for x in walls)
                    + f" s by rank; tok/s {row['tok_s']:.0f} through the "
                    f"gang, {want['tok_s']:.0f} in process (ratio "
                    f"{row['tok_s_ratio']:.4f}); peak GB a rank (torch + "
                    f"workspace) " + ", ".join(f"{x:.2f}" for x in peak)
                    + f" (predicted {row['predicted_peak_gb']}); staged "
                    f"{row['staged_gb_per_step'][0]:.3f} GB a step, the "
                    f"ring's host time {max(row['ring_host_s_per_step']):.4f}"
                    f" s a step ({100 * row['ring_share_of_step']:.1f}% of "
                    f"the step wall); {card}")

            def matrix():
                rows = {r: state.list_train_steps(worker=f"train-{r}")
                        for r in range(n)}
                done = all({x["step"] for x in rs} == set(
                    range(TRAINER_STEPS)) for rs in rows.values())
                return rows if done else None

            rows = _poll(matrix, timeout=30)
            summ = state.train_summary()
            check(rows is not None and all(
                "compute" in x["phases"] for rs in rows.values()
                for x in rs), f"n={n}: the GCS step matrix: {rows}")
            check(summ["stalled"] == [], f"n={n}: a stall: {summ}")
            out["gangs"][n] = gang
            log("gang", f"n={n}: {n} workers of {1.0 / n} GPU (leases [0], "
                f"CUDA_VISIBLE_DEVICES 0, no JAX module), loops began "
                f"{gang['worker_ready_s']:.2f} s into fit(), which took "
                f"{fit_s:.2f} s; the GCS step matrix holds every worker's "
                f"timed steps, no stall; {card}")
        procs = _cluster_pids()
    finally:
        rt.shutdown()
        storage.cleanup()
    deadline = time.monotonic() + 30
    while True:
        left = {p: c for p, c in procs.items() if _alive(p, c)}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"processes left after shutdown: {left}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    while True:
        out["memory_after_mib"] = gpu_memory_used_mib()
        if abs(out["memory_after_mib"] - mem0) < 1024 or \
                time.monotonic() - t0 > 60:
            break
        time.sleep(0.5)
    out["memory_before_mib"] = mem0
    out["memory_back_s"] = time.monotonic() - t0
    check(abs(out["memory_after_mib"] - mem0) < 1024,
          f"card memory {mem0:.0f} MiB before the cluster, "
          f"{out['memory_after_mib']:.0f} MiB 60 s after")
    out["phase_s"] = time.perf_counter() - phase_t0
    log("gang", f"cluster up in {out['cluster_start_s']:.2f} s; shut down: "
        f"no cluster process left, card memory {mem0:.0f} -> "
        f"{out['memory_after_mib']:.0f} MiB; the phase took "
        f"{out['phase_s']:.1f} s; {card}")
    return out


# ---------------------------------------------------------------------------
# 6j: collectives across processes (util.collective's cuda backend).
# ---------------------------------------------------------------------------

COLLECTIVE_NS = (2, 4)           # ranks: 2 at 0.5 GPU (gates), 4 at 0.25
COLLECTIVE_GATE_ROWS = 65536     # rows of 128 a rank at the bitwise gates
COLLECTIVE_API_ROWS = 4096       # the host-level API and b2b calls
COLLECTIVE_B2B = 50              # back-to-back calls, alternating kinds
COLLECTIVE_TIMED = 3             # timed calls of a kind at full size
COLLECTIVE_WAIT_S = 2.0          # the ring's wait deadline, failure cases
COLLECTIVE_DEADLINE_S = 10.0     # a stalled or dead peer: the others raise
COLLECTIVE_STALL_S = 3.0         # a peer's sleep inside C6 (past the wait)
COLLECTIVE_ROUND_S = 60.0        # the groups' coordinator and gloo rounds
COLLECTIVE_OPS = ("sum", "max", "min", "prod")
# The rank form's kernels, in process_ring.KERNELS' order, with the
# in-process key, the name in the kernels line and the line it replaces.
COLLECTIVE_KERNELS = (
    ("allreduce", "C4", "ring_allreduce_rank",
     "ray_tpu/util/collective/pallas/ring.py:107"),
    ("reducescatter", "C2", "ring_reduce_scatter_rank",
     "ray_tpu/util/collective/pallas/ring.py:169"),
    ("allgather", "C3", "ring_allgather_rank",
     "ray_tpu/util/collective/pallas/ring.py:146"),
    ("quantized_allreduce", "C6", "ring_qallreduce_rank",
     "ray_tpu/util/collective/pallas/quantized.py:49"),
    ("permute", "C1", "ring_permute_rank",
     "ray_tpu/util/collective/pallas/ring.py:378"),
    ("qrs_hop", "C5", "ring_qrs_hop_rank",
     "ray_tpu/util/collective/pallas/quantized.py:121"))


def _collective_member(rt):
    """A rank of 6j's groups: a GPU actor implementing the
    ``_init_collective`` protocol (defined here so that the script's
    import of the port is the workers' too). Inputs are made on the card
    from a seed, in seeded pieces, so any rank can regenerate any rank's
    rows without the whole stack."""

    @rt.remote(num_gpus=0.25)
    class Member:
        PIECE = 1 << 24              # elements of one seeded piece

        def __init__(self):
            self.options = {}

        def ready(self):
            import os as _os
            import sys as _sys

            from ray_tpu_torch.util.collective import process_ring

            torch.zeros(1, device="cuda")
            process_ring._lib()          # the ring library, built already
            with open("/proc/self/cmdline", "rb") as f:
                cmdline = [a.decode() for a in f.read().split(b"\0") if a]
            return {"pid": _os.getpid(), "cmdline": cmdline,
                    "gpu_ids": rt.get_gpu_ids(),
                    "cuda_visible_devices":
                        _os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device_name": torch.cuda.get_device_name(0),
                    "jax_modules": sorted(
                        m for m in _sys.modules
                        if m.split(".")[0] in ("jax", "ray_tpu"))}

        def set_options(self, options):
            self.options = dict(options)
            return True

        def _init_collective(self, world_size, rank, backend, group_name):
            from ray_tpu_torch.util import collective as col

            col.init_collective_group(world_size, rank, backend=backend,
                                      group_name=group_name, **self.options)
            return True

        def destroy(self, g):
            from ray_tpu_torch.util import collective as col

            col.destroy_collective_group(g)
            gc.collect()
            torch.cuda.empty_cache()
            return True

        def transport(self, g):
            from ray_tpu_torch.util.collective.collective import _group_mgr

            return _group_mgr.get_group(g).ring.transport

        def reset_counts(self):
            from ray_tpu_torch.util.collective import process_ring

            for k in process_ring.KERNELS:
                k.launches = 0
            return True

        def counts(self):
            from ray_tpu_torch.util.collective import process_ring

            return [k.launches for k in process_ring.KERNELS]

        @staticmethod
        def _group(g):
            from ray_tpu_torch.util.collective.collective import _group_mgr

            grp = _group_mgr.get_group(g)
            return grp, grp.world_size, grp.rank, grp.device

        @classmethod
        def _piece(cls, dev, seed, rank, i, dtype):
            gen = torch.Generator(device=dev)
            gen.manual_seed((seed * 64 + rank) * 100003 + i)
            return torch.randn(cls.PIECE, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)

        @classmethod
        def _input(cls, dev, seed, rank, elems, dtype, lo=0, hi=None):
            """Elements [lo, hi) of rank's input (default: all of it)."""
            hi = elems if hi is None else hi
            out = torch.empty(hi - lo, dtype=dtype, device=dev)
            for i in range(lo // cls.PIECE, -(-hi // cls.PIECE)):
                a, b = max(lo, i * cls.PIECE), min(hi, (i + 1) * cls.PIECE)
                out[a - lo:b - lo] = cls._piece(dev, seed, rank, i, dtype)[
                    a - i * cls.PIECE:b - i * cls.PIECE]
            return out

        def gates(self, g, rows):
            """C2, C3, C4 (f32, bf16, every op) and C6 (f32) across the
            processes, each against the in-process kernel (a RingGroup of n
            virtual ranks in this process) and the plain version on the
            stacked inputs, bit for bit."""
            from ray_tpu_torch.util.collective import RingGroup
            from ray_tpu_torch.util.collective import quantized as Q
            from ray_tpu_torch.util.collective import ring as R
            from ray_tpu_torch.util.collective.types import ReduceOp

            grp, n, r, dev = self._group(g)
            ref = RingGroup(n, dev)
            ops = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
                   "min": ReduceOp.MIN, "prod": ReduceOp.PRODUCT}
            bad, names = [], []

            def stack(seed, rows_, dtype):
                return torch.stack([
                    self._input(dev, seed, p, rows_ * 128, dtype)
                    for p in range(n)]).view(n, rows_, 128)

            def hold(name, got, kernel, plain):
                names.append(name)
                if got.shape != kernel.shape:
                    bad.append(f"{name}: shape {tuple(got.shape)}")
                elif not (torch.equal(got, kernel)
                          and torch.equal(got, plain)):
                    to_k = (got.float() - kernel.float()).abs().max()
                    to_p = (got.float() - plain.float()).abs().max()
                    bad.append(f"{name}: max abs diff to the in-process "
                               f"kernel {to_k.item()}, to the plain "
                               f"version {to_p.item()}")

            seed = 100
            for dtype in (torch.float32, torch.bfloat16):
                for op in COLLECTIVE_OPS:
                    seed += 1
                    s = stack(seed, rows, dtype)
                    hold(f"C4 {dtype} {op}",
                         grp.ring_collective("allreduce", s[r], ops[op]),
                         R.ring_allreduce(s, op, group=ref)[r],
                         R.ring_allreduce(s, op, impl="plain")[r])
                    hold(f"C2 {dtype} {op}",
                         grp.ring_collective("reducescatter", s[r], ops[op]),
                         R.ring_reduce_scatter(s, op, group=ref)[r],
                         R.ring_reduce_scatter(s, op, impl="plain")[r])
                    del s
                seed += 1
                s = stack(seed, rows // n, dtype)
                hold(f"C3 {dtype}", grp.ring_collective("allgather", s[r]),
                     R.ring_allgather(s, group=ref)[r],
                     R.ring_allgather(s, impl="plain")[r])
                del s
            s = stack(seed + 1, rows, torch.float32)
            hold("C6 f32", grp.ring_collective("quantized_allreduce", s[r]),
                 Q.quantized_ring_allreduce(s, group=ref)[r],
                 Q.quantized_ring_allreduce(s, impl="plain")[r])
            del s
            ref.check()
            del ref
            gc.collect()
            torch.cuda.empty_cache()
            return {"cases": names, "bad": bad}

        def api(self, g, g_cpu, rows):
            """The host-level API on the card against its CPU path (a
            ``device="cpu"`` group of the same ranks) for the same seeds;
            barrier, send / recv; the op counter."""
            from ray_tpu_torch.observability.collective import \
                collective_metrics
            from ray_tpu_torch.util import collective as col

            grp, n, r, dev = self._group(g)
            x = self._input(dev, 900, r, rows * 128,
                            torch.float32).view(rows, 128)
            # (the counter by key: an attribute named "ops" beside torch
            # makes cloudpickle ship torch.ops, which cannot be pickled)
            def counted_ops():
                return dict(vars(collective_metrics())["ops"]._snapshot()[
                    "data"])

            calls = (
                ("allreduce", lambda gg, t: col.allreduce(t, gg)),
                ("reducescatter", lambda gg, t: col.reducescatter(t, gg)),
                ("allgather", lambda gg, t: torch.stack(col.allgather(t, gg))),
                ("broadcast", lambda gg, t: col.broadcast(t, n - 1, gg)),
                ("reduce", lambda gg, t: col.reduce(t, 0, gg)))
            # The CPU path first: its group is of the cuda backend too,
            # and the counter below holds the card's calls alone.
            cpu = {name: fn(g_cpu, x.cpu()) for name, fn in calls}
            before = counted_ops()
            bad, card = [], {}
            for name, fn in calls:
                card[name] = fn(g, x)
                if not (card[name].is_cuda
                        and torch.equal(card[name].cpu(), cpu[name])):
                    bad.append(name)
            if not torch.equal(card["reducescatter"], torch.tensor_split(
                    card["allreduce"], n, dim=0)[r]):
                bad.append("reducescatter is not C4 then the split")
            col.barrier(g)
            want = {f"{op},cuda,float32": 1.0 for op, _ in calls}
            want["barrier,cuda,unknown"] = 1.0
            if r == 0:
                col.send(x, n - 1, g)
                want["send,cuda,float32"] = 1.0
            if r == n - 1:
                got = col.recv(0, g)
                want["recv,cuda,unknown"] = 1.0
                if not (got.is_cuda and torch.equal(got, self._input(
                        dev, 900, 0, rows * 128, torch.float32).view(
                            rows, 128))):
                    bad.append("send/recv")
            after = counted_ops()
            counted = {k: v - before.get(k, 0.0) for k, v in after.items()
                       if k.split(",")[1] == "cuda"
                       and v != before.get(k, 0.0)}
            if counted != want:
                bad.append(f"rtpu_collective_ops_total {counted} != {want}")
            return {"bad": bad, "counted": counted}

        def back_to_back(self, g, rows, calls):
            """calls alternating C4, C2, C3 and C6 on the same input: every
            result of a kind equal to its first."""
            grp, n, r, dev = self._group(g)
            x = self._input(dev, 950, r, rows * 128,
                            torch.float32).view(rows, 128)
            kinds = ("allreduce", "reducescatter", "allgather",
                     "quantized_allreduce")
            first, differ = {}, []
            t0 = time.perf_counter()
            for i in range(calls):
                y = grp.ring_collective(kinds[i % 4], x)
                if kinds[i % 4] not in first:
                    first[kinds[i % 4]] = y
                elif not torch.equal(y, first[kinds[i % 4]]):
                    differ.append(i)
            return {"differ": differ, "wall_s": time.perf_counter() - t0}

        def full(self, g, kind, elems, seed, timed):
            """One kind at the full size: a warm call, then ``timed`` calls
            (the kernels' device time from CUDA events in this rank, the
            call's wall, the staged bytes); then a fixed sample of the
            result's rows (8 at each end of each chunk) against the plain
            fold over those rows, regenerated from every rank's seed (C6:
            against the exact sum, within the int8 ring's error bound)."""
            from ray_tpu_torch.util.collective import ring as R

            grp, n, r, dev = self._group(g)
            dtype = torch.float32 if kind == "quantized_allreduce" \
                else torch.bfloat16
            x = self._input(dev, seed, r, elems, dtype)
            # max |x| a piece at a time: a temporary of x's size would not
            # fit beside four ranks' inputs, results and workspaces.
            m = max(float(p.abs().max()) for p in x.split(self.PIECE))
            ring = grp.ring
            launches, events, staged = ring._launches, [], []

            def timed_launches(kind_, op, dtype_, lay):
                """The ring's launches between two CUDA events on its
                stream: the call's stream waits and copies fall outside."""
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record(ring.stream)
                launches(kind_, op, dtype_, lay)
                t1.record(ring.stream)
                events.append((t0, t1))
                staged.append(lay.staged_bytes)

            ring._launches = timed_launches
            walls = []
            try:
                for i in range(1 + timed):
                    y = None
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y = grp.ring_collective(kind, x)
                    wall = (time.perf_counter() - t0) * 1e3
                    if i:
                        walls.append(wall)
            finally:
                del ring._launches
            kernel = [a.elapsed_time(b) for a, b in events[1:]]
            del x
            y = y.reshape(-1)
            add = R._COMBINE["sum"]
            span = 8 * 128
            errs = []
            if kind == "allgather":
                for p in range(n):
                    for lo in (0, elems - span):
                        want = self._input(dev, seed, p, elems, dtype, lo,
                                           lo + span)
                        errs.append(0.0 if torch.equal(
                            y[p * elems + lo:p * elems + lo + span], want)
                            else float("inf"))
            else:
                c = elems // n
                chunks = [r] if kind == "reducescatter" else range(n)
                maxes = grp._gather_tensors(torch.tensor([m])).reshape(-1)
                for ch in chunks:
                    for lo in (ch * c, (ch + 1) * c - span):
                        xs = [self._input(dev, seed, p, elems, dtype, lo,
                                          lo + span) for p in range(n)]
                        at = lo - ch * c if kind == "reducescatter" else lo
                        got = y[at:at + span]
                        if kind == "quantized_allreduce":
                            # The int8 ring rounds a value to half a step
                            # (max |sent| / 254) once a hop that sums:
                            # the reduce-scatter's partial sums of 1 ..
                            # n - 1 ranks, then the allgather's first hop
                            # the sum of n; the later hops re-send those
                            # int8 values (exact up to f32 rounding). A
                            # sum of t ranks is bounded by the t largest
                            # maxes; 1% covers the earlier hops' rounding
                            # in the later maxes and f32's.
                            mx = sorted(maxes.tolist(), reverse=True)
                            tol = sum(sum(mx[:t]) for t in range(1, n + 1)) \
                                / 254 * 1.01
                            exact = torch.stack(xs).double().sum(0)
                            err = float((got.double() - exact).abs().max())
                            errs.append(err if err <= tol else float("inf"))
                            continue
                        first = ch if kind == "allreduce" else (ch + 1) % n
                        acc = xs[first]
                        for j in range(1, n):
                            acc = add(xs[(first + j) % n], acc)
                        errs.append(0.0 if torch.equal(got, acc)
                                    else float("inf"))
            del y
            gc.collect()
            torch.cuda.empty_cache()
            return {"kernel_ms": kernel, "call_ms": walls,
                    "staged_bytes": staged[-1], "samples": len(errs),
                    "sample_max_err": max(errs)}

        def library(self, g, kind, elems, seed):
            """One torch call computing the kind's function on the input
            ``full`` made (the same seed): gloo's allreduce (C4, in
            place), allgather (C3, into the [n, ...] rows of one tensor)
            or reduce_scatter (C2) of this rank's card tensor, over the
            process group of g, a ``torch`` group of the same ranks,
            bracketed as the ring's call. gloo stages a CUDA tensor
            through pinned host buffers of torch's caching host
            allocator: buffers of the sizes it takes are pinned and freed
            first, as a warm call would leave them, and the timed call's
            new pinnings are counted. C6's int8 ring has no torch
            counterpart."""
            from ray_tpu_torch.util.collective.collective import _group_mgr

            if kind == "quantized_allreduce":
                return {"library_ms": None, "library_computes":
                        "none: no torch call computes the int8 ring's sum"}
            grp = _group_mgr.get_group(g)
            n, r, pg = grp.world_size, grp.rank, grp._pg
            dev = torch.device("cuda", 0)
            x = self._input(dev, seed, r, elems, torch.bfloat16)
            es = x.element_size()
            if kind == "allreduce":
                name, fn, args = "allreduce", pg.allreduce, ([x],)
                pins = [elems * es]
            elif kind == "allgather":
                out = torch.empty((n, elems), dtype=x.dtype, device=dev)
                name, fn, args = "allgather", pg.allgather, (
                    [list(out.unbind(0))], [x])
                pins = [elems * es] * (n + 1)
            else:
                out = torch.empty(elems // n, dtype=x.dtype, device=dev)
                name, fn, args = "reduce_scatter", pg.reduce_scatter, (
                    [out], [list(x.chunk(n))])
                pins = [elems // n * es] * (n + 1) + [elems * es]
            bufs = [torch.empty(b, dtype=torch.uint8, pin_memory=True)
                    for b in pins]
            del bufs

            def pinned():
                return torch.cuda.host_memory_stats().get("num_host_alloc")

            before = pinned()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args).wait()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = pinned()
            del x, args
            gc.collect()
            torch.cuda.empty_cache()
            return {"library_ms": ms,
                    "library_pinned_in_call": None if before is None
                    else after - before,
                    "library_computes": f"gloo's {name} of the CUDA tensors "
                                        f"(ProcessGroupGloo: host copies, "
                                        f"{n} processes, one call)"}

        def qstall(self, g, rows, stalled, at_hop, sleep_s):
            """Two C6 calls; in the second, rank ``stalled`` sleeps on the
            host for sleep_s before it enqueues phase ``at_hop``, so its
            neighbours' streams stop at that hop's words. Raises what the
            group raises."""
            grp, n, r, dev = self._group(g)
            x = self._input(dev, 995, r, rows * 128, torch.float32)
            grp.ring_collective("quantized_allreduce", x)
            ring = grp.ring
            if r == stalled:
                launch = ring._launch

                def slow(kind, op, dtype, lay, base=0, hop=0):
                    if hop == at_hop:
                        time.sleep(sleep_s)
                    launch(kind, op, dtype, lay, base=base, hop=hop)

                ring._launch = slow
            try:
                grp.ring_collective("quantized_allreduce", x)
            finally:
                if r == stalled:
                    del ring._launch
            return True

        def rank_hops(self, g, rows):
            """The split-phase rank calls, hop by hop: C1 (f32, bf16) on
            this rank's block and every hop of C5 in place (f32) on its
            buffer of n chunks, each against the in-process kernel (a
            ``RingGroup`` of n virtual ranks in this process, C5 with its
            own carry table) and the plain version on the stacked inputs,
            bit for bit; C5's carry column too."""
            from ray_tpu_torch.util.collective import RingGroup
            from ray_tpu_torch.util.collective import quantized as Q
            from ray_tpu_torch.util.collective import ring as R

            grp, n, r, dev = self._group(g)
            ref = RingGroup(n, dev)
            bad, names = [], []

            def stack(seed, rows_, dtype):
                return torch.stack([
                    self._input(dev, seed, p, rows_ * 128, dtype)
                    for p in range(n)]).view(n, rows_, 128)

            def hold(name, got, kernel, plain):
                names.append(name)
                if not (torch.equal(got, kernel) and torch.equal(got, plain)):
                    to_k = (got.float() - kernel.float()).abs().max()
                    to_p = (got.float() - plain.float()).abs().max()
                    bad.append(f"{name}: max abs diff to the in-process "
                               f"kernel {to_k.item()}, to the plain "
                               f"version {to_p.item()}")

            for seed, dtype in ((300, torch.float32), (301, torch.bfloat16)):
                s = stack(seed, rows, dtype)
                hop = grp.start_hop("permute", s[r].clone())
                grp.finish_hops([hop])
                hold(f"C1 {dtype}", hop.result,
                     R.ring_permute_cuda(s, group=ref)[r],
                     R.ring_permute_plain(s)[r])
                del s, hop
            rows = rows // n * n
            s = stack(302, rows, torch.float32)
            s[1 % n, :rows // n] = 0.0        # a chunk at the scale floor
            mine = s[r].clone()
            kern, plain = s.clone(), s
            carry = torch.full((n - 1, n), -1, dtype=torch.int64,
                               device=dev)
            carry_k = torch.empty((n - 1, n), dtype=torch.int64, device=dev)
            carry_p = torch.zeros((n - 1, n), dtype=torch.int64, device=dev)
            for t in range(n - 1):
                grp.finish_hops([grp.start_hop("qrs_hop", mine, t=t,
                                               carry=carry)])
                Q.ring_qrs_hop_cuda(kern, t, carry_k, group=ref)
                Q.ring_qrs_hop_plain(plain, t, carry_p)
                hold(f"C5 in place hop {t}", mine, kern[r], plain[r])
                # Rows 1 .. t + 1 filled (hop u fills row u + 1), row 0
                # and the rest zero since hop 0 zeroed the table.
                names.append(f"C5 carry hop {t}")
                if not (torch.equal(carry[:, r], carry_p[:, r])
                        and torch.equal(carry_k[:, r], carry_p[:, r])):
                    bad.append(f"C5 carry after hop {t}: rank form "
                               f"{carry[:, r].tolist()}, in process "
                               f"{carry_k[:, r].tolist()}, plain "
                               f"{carry_p[:, r].tolist()}")
            ref.check()
            del ref, s, kern, plain, mine
            gc.collect()
            torch.cuda.empty_cache()
            return {"cases": names, "bad": bad}

        def hop_full(self, g, kind, rows, seed, timed):
            """One overlap chunk at full size, ``1 + timed`` times: C1
            (bf16) one hop of this rank's [rows, 128] block; C5 (f32) the
            whole split-phase int8 reduce-scatter of a [n * rows, 128]
            chunk, hop by hop. Each hop's launches between CUDA events on
            the ring's stream (rank 0's are the kernel times), each call's
            host wall, the staged bytes; then a fixed sample of rows: C1
            equal to the left neighbour's regenerated rows, C5's reduced
            chunk within the int8 ring's error bound of the exact sum."""
            grp, n, r, dev = self._group(g)
            ring = grp.ring
            dtype = torch.bfloat16 if kind == "permute" else torch.float32
            elems = rows * 128 * (1 if kind == "permute" else n)
            launch, events = ring._launch, []

            def timed_launch(*a, **kw):
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record(ring.stream)
                launch(*a, **kw)
                t1.record(ring.stream)
                events.append((t0, t1))

            ring._launch = timed_launch
            walls, staged = [], []
            try:
                for i in range(1 + timed):
                    x = self._input(dev, seed, r, elems, dtype).view(-1, 128)
                    m = max(float(p.abs().max())
                            for p in x.view(-1).split(self.PIECE))
                    carry = torch.empty((n - 1, n), dtype=torch.int64,
                                        device=dev)
                    events.clear()
                    st0 = ring.staged_bytes
                    hops = 1 if kind == "permute" else n - 1
                    call_walls = []
                    for t in range(hops):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        if kind == "permute":
                            hop = grp.start_hop("permute", x)
                        else:
                            hop = grp.start_hop("qrs_hop", x, t=t,
                                                carry=carry)
                        grp.finish_hops([hop])
                        call_walls.append((time.perf_counter() - t0) * 1e3)
                    if i:
                        walls.append(call_walls)
                        kernel = [a.elapsed_time(b) for a, b in events]
                        if kind == "qrs_hop":
                            # two launches a hop: send, receive
                            kernel = [kernel[2 * t] + kernel[2 * t + 1]
                                      for t in range(hops)]
                        staged.append((ring.staged_bytes - st0, kernel))
            finally:
                del ring._launch
            span = 8 * 128
            errs = []
            if kind == "permute":
                got = hop.result.view(-1)
                for lo in (0, elems - span):
                    want = self._input(dev, seed, (r - 1) % n, elems, dtype,
                                       lo, lo + span)
                    errs.append(0.0 if torch.equal(got[lo:lo + span], want)
                                else float("inf"))
            else:
                c = elems // n
                got = x.view(-1)[r * c:(r + 1) * c]
                maxes = grp._gather_tensors(torch.tensor([m])).reshape(-1)
                mx = sorted(maxes.tolist(), reverse=True)
                tol = sum(sum(mx[:t]) for t in range(1, n)) / 254 * 1.01
                for lo in (0, c - span):
                    exact = torch.stack([self._input(
                        dev, seed, p, elems, dtype, r * c + lo,
                        r * c + lo + span) for p in range(n)]).double().sum(0)
                    err = float((got[lo:lo + span].double() - exact)
                                .abs().max())
                    errs.append(err if err <= tol else float("inf"))
            del x, got, hop
            gc.collect()
            torch.cuda.empty_cache()
            return {"kernel_ms": [k for _, k in staged],
                    "call_ms": walls, "staged_bytes": staged[-1][0],
                    "samples": len(errs), "sample_max_err": max(errs)}

        def hop_library(self, g, rows, seed):
            """C1's function through the library: gloo's send to the right
            neighbour and receive from the left of this rank's bf16 block
            (``hop_full``'s input), over the process group of g, a
            ``torch`` group of the same ranks. gloo moves host memory, so
            the call copies the block to pinned host memory, sends and
            receives there, and copies the result back to the card, as
            gloo's collectives stage a CUDA tensor."""
            from ray_tpu_torch.util.collective.collective import _group_mgr

            grp = _group_mgr.get_group(g)
            n, r, pg = grp.world_size, grp.rank, grp._pg
            dev = torch.device("cuda", 0)
            x = self._input(dev, seed, r, rows * 128, torch.bfloat16)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            back = torch.empty_like(host)
            out = torch.empty_like(x)
            grp.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host.copy_(x)
            works = [pg.send([host], (r + 1) % n, 7),
                     pg.recv([back], (r - 1) % n, 7)]
            for w in works:
                w.wait()
            out.copy_(back)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            ok = torch.equal(out[:1024], self._input(
                dev, seed, (r - 1) % n, rows * 128, torch.bfloat16, 0, 1024))
            del x, host, back, out
            gc.collect()
            torch.cuda.empty_cache()
            return {"library_ms": ms, "library_ok": ok,
                    "library_computes": f"gloo's send to the right and "
                                        f"receive from the left "
                                        f"(ProcessGroupGloo send/recv of "
                                        f"pinned host copies, {n} "
                                        f"processes), the copies to and "
                                        f"from the card included"}

        def call(self, g, rows):
            """One allreduce on the card; raises what the group raises."""
            grp, n, r, dev = self._group(g)
            x = self._input(dev, 990, r, rows * 128, torch.float32)
            t0 = time.perf_counter()
            grp.ring_collective("allreduce", x)
            return time.perf_counter() - t0

    return Member


def _overlap_rows(elems, n):
    """Rows of 128 a rank sends at one hop of the first overlap chunk of a
    flat vector of ``elems`` (``parallel.zero._chunks``' first chunk, over
    n ranks)."""
    groups = elems // (n * 128)
    return -(-groups // min(ZERO_CHUNKS, groups))


def _collective_group(rt, actors, name, backend="cuda", **options):
    from ray_tpu_torch.util import collective as col

    rt.get([a.set_options.remote(options) for a in actors], timeout=120)
    t0 = time.perf_counter()
    col.create_collective_group(actors, len(actors),
                                list(range(len(actors))), backend=backend,
                                group_name=name)
    return time.perf_counter() - t0


def _must_raise(rt, refs, deadline, want):
    """Every ref must raise within the deadline, its text holding each of
    ``want``: the elapsed seconds and the texts."""
    t0 = time.monotonic()
    out = []
    for ref in refs:
        left = max(0.1, deadline - (time.monotonic() - t0))
        try:
            rt.get(ref, timeout=left)
        except rt.exceptions.GetTimeoutError:
            raise AssertionError(f"a rank hung past {deadline} s")
        except Exception as e:      # the rank's own error, re-raised here
            text = str(e)
            check(all(w in text for w in want),
                  f"a rank raised without naming {want}: {text[-400:]}")
            out.append((time.monotonic() - t0, text))
            continue
        raise AssertionError("a rank returned after its peer failed")
    return out


def _median(xs):
    return float(np.median(xs))


def phase_collective(dev, card, built, zero_rows, q_elems, ring_rows,
                     qring_rows):
    """Collectives across processes; see the module docstring (6j)."""
    import ray_tpu_torch as rt

    phase_t0 = time.perf_counter()
    # C5's and C6's rank forms are kernels of their own (C1-C4's are
    # their one-process bodies): they must not spill either.
    rank_c6 = kernel_report(built, "ring_qallreduce_rank_kernel")
    rank_c5 = kernel_report(built, "ring_qrs_hop_rank_kernel")
    for key, rep in (("C5", rank_c5), ("C6", rank_c6)):
        check(rep["spill_bytes"] == 0, f"{key}'s rank form spills: {rep}")
        log("collective", f"{key} rank form: {rep['registers']} registers, "
            f"{rep['spill_bytes']} spill bytes")
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    mem0 = gpu_memory_used_mib()
    out = {"card": card, "compute_mode": mode, "c6_rank_build": rank_c6,
           "c5_rank_build": rank_c5}
    t0 = time.perf_counter()
    rt.init(num_gpus=1)
    out["cluster_start_s"] = time.perf_counter() - t0
    Member = _collective_member(rt)
    procs = {}
    try:
        gates = {}
        for n in COLLECTIVE_NS:
            t0 = time.perf_counter()
            actors = [Member.options(num_gpus=1.0 / n).remote()
                      for _ in range(n)]
            info = rt.get([a.ready.remote() for a in actors], timeout=300)
            start_s = time.perf_counter() - t0
            check(all(i["gpu_ids"] == [0] and i["cuda_visible_devices"]
                      == "0" and "H100" in i["device_name"]
                      and not i["jax_modules"] for i in info),
                  f"the ranks' leases and modules: {info}")
            name = f"gates{n}"
            join_s = _collective_group(rt, actors, name,
                                       timeout_s=COLLECTIVE_ROUND_S)
            transport = rt.get(actors[0].transport.remote(name), timeout=60)
            t0 = time.perf_counter()
            res = rt.get([a.gates.remote(name, COLLECTIVE_GATE_ROWS)
                          for a in actors], timeout=600)
            bad = [b for x in res for b in x["bad"]]
            check(not bad, f"n={n} gates: {bad}")
            hops = rt.get([a.rank_hops.remote(name, COLLECTIVE_GATE_ROWS)
                           for a in actors], timeout=600)
            bad = [b for x in hops for b in x["bad"]]
            check(not bad, f"n={n} C1 and C5 rank-form gates: {bad}")
            gates[n] = {"actor_start_s": start_s, "group_s": join_s,
                        "gates_s": time.perf_counter() - t0,
                        "cases": len(res[0]["cases"]) * n,
                        "hop_cases": len(hops[0]["cases"]) * n}
            log("collective", f"n={n}: C1 (f32, bf16) and C5 in place "
                f"(f32, every hop, its carry column) in rank form at "
                f"{COLLECTIVE_GATE_ROWS} rows a rank: bit for bit equal to "
                f"the in-process kernel and the plain version in "
                f"{gates[n]['hop_cases']} rank-cases")
            log("collective", f"n={n}: {n} actors of {1.0 / n} GPU up in "
                f"{start_s:.2f} s (leases [0], CUDA_VISIBLE_DEVICES 0, "
                f"an H100, no JAX module), group formed in {join_s:.2f} s, "
                f"ordered by {transport}; compute mode {mode}. C2, C3, C4 "
                f"(f32, bf16; {', '.join(COLLECTIVE_OPS)}) and C6 (f32) "
                f"across the processes at {COLLECTIVE_GATE_ROWS} rows a "
                f"rank: bit for bit equal to the in-process kernel and the "
                f"plain version in {gates[n]['cases']} rank-cases "
                f"({gates[n]['gates_s']:.2f} s)")
            if n != COLLECTIVE_NS[-1]:
                rt.get([a.destroy.remote(name) for a in actors], timeout=120)
                for a in actors:
                    rt.kill(a)
                del actors
        out.update(gates=gates, transport=transport,
                   actor_start_s=gates[COLLECTIVE_NS[-1]]["actor_start_s"])
        n = COLLECTIVE_NS[-1]
        name = f"gates{n}"
        _collective_group(rt, actors, "cpu", device="cpu",
                          timeout_s=COLLECTIVE_ROUND_S)
        rt.get([a.reset_counts.remote() for a in actors], timeout=60)
        api = rt.get([a.api.remote(name, "cpu", COLLECTIVE_API_ROWS)
                      for a in actors], timeout=300)
        check(not [b for x in api for b in x["bad"]],
              f"host-level API on the card vs its CPU path: {api}")
        b2b = rt.get([a.back_to_back.remote(name, COLLECTIVE_API_ROWS,
                                            COLLECTIVE_B2B)
                      for a in actors], timeout=300)
        check(all(not x["differ"] for x in b2b),
              f"back-to-back calls that differ: {b2b}")
        log("collective", f"n={n}: allreduce, reducescatter (C4 then the "
            f"split), allgather, broadcast, reduce on the card equal to the "
            f"CPU path for the same seeds; barrier; send/recv bit for bit; "
            f"rtpu_collective_ops_total{{op,backend=cuda,dtype}} counted "
            f"every call ({api[0]['counted']}); {COLLECTIVE_B2B} "
            f"back-to-back calls alternating C4, C2, C3, C6 on every rank: "
            f"no timeout, no result differs (wall "
            f"{max(x['wall_s'] for x in b2b):.2f} s)")

        # Full size: C6 first (its workspace is the smaller), then the
        # ZeRO cell's flat bf16 gradient through C4, C2 and C3.
        sizes = {"quantized_allreduce": q_elems,
                 "allreduce": zero_rows * 128,
                 "reducescatter": zero_rows * 128,
                 "allgather": zero_rows // n * 128}
        full = {}
        t0 = time.perf_counter()
        for kind in ("quantized_allreduce", "allreduce", "reducescatter",
                     "allgather"):
            res = rt.get([a.full.remote(name, kind, sizes[kind], 7,
                                        COLLECTIVE_TIMED)
                          for a in actors], timeout=600)
            check(all(x["sample_max_err"] != float("inf") for x in res),
                  f"{kind} at full size: a sampled row differs from the "
                  f"plain fold: {res}")
            full[kind] = res
        # One overlap chunk at full size: C1 on a hop's block of the ZeRO
        # cell (bf16), C5 in place on a chunk of the quantized cell (f32).
        hop_rows = {"permute": _overlap_rows(zero_rows * 128, n),
                    "qrs_hop": _overlap_rows(q_elems, n)}
        for kind in ("permute", "qrs_hop"):
            res = rt.get([a.hop_full.remote(name, kind, hop_rows[kind], 8,
                                            COLLECTIVE_TIMED)
                          for a in actors], timeout=600)
            check(all(x["sample_max_err"] != float("inf") for x in res),
                  f"{kind} rank form at full size: a sampled row is off: "
                  f"{res}")
            full[kind] = res
        out["full_size_s"] = time.perf_counter() - t0
        counts = rt.get([a.counts.remote() for a in actors], timeout=60)
        calls = 1 + COLLECTIVE_TIMED
        b2b_each = [len(range(i, COLLECTIVE_B2B, 4)) for i in range(4)]
        want = [3 + b2b_each[0] + calls, b2b_each[1] + calls,
                2 + b2b_each[2] + calls,
                (b2b_each[3] + calls) * (2 * n - 1),
                calls, calls * 2 * (n - 1)]
        check(all(c == want for c in counts),
              f"rank-form launches {counts} != {want} a rank")
        out["launches"] = [sum(c[i] for c in counts)
                           for i in range(len(want))]
        # The library's call on the same inputs, in a torch group of the
        # same ranks once the ring's workspaces are freed (gloo's staging
        # would not fit beside them).
        rt.get([a.destroy.remote(name) for a in actors], timeout=120)
        _collective_group(rt, actors, "library", backend="torch",
                          timeout_s=COLLECTIVE_ROUND_S)
        t0 = time.perf_counter()
        library = {}
        for kind in ("reducescatter", "allgather", "allreduce",
                     "quantized_allreduce"):
            library[kind] = rt.get([a.library.remote("library", kind,
                                                     sizes[kind], 7)
                                    for a in actors], timeout=600)
        library["permute"] = rt.get([a.hop_library.remote(
            "library", hop_rows["permute"], 8) for a in actors], timeout=600)
        check(all(x["library_ok"] for x in library["permute"]),
              "gloo's send/recv did not deliver the left neighbour's block")
        library["qrs_hop"] = [{"library_ms": None, "library_computes":
                               "none: no torch call is the int8 hop"}] * n
        out["library_s"] = time.perf_counter() - t0
        rt.get([a.destroy.remote("library") for a in actors], timeout=120)

        # A stalled peer: after one call on every rank, rank n - 1 makes
        # no second call; the others wait for its ready word of epoch 2.
        _collective_group(rt, actors, "stall",
                          wait_timeout_s=COLLECTIVE_WAIT_S)
        rt.get([a.call.remote("stall", 1024) for a in actors], timeout=120)
        raised = _must_raise(rt, [a.call.remote("stall", 1024)
                                  for a in actors[:-1]],
                             COLLECTIVE_DEADLINE_S,
                             (f"peer rank {n - 1} at 1", "epoch 2"))
        out["stalled_peer_s"] = max(t for t, _ in raised)
        rt.get([a.destroy.remote("stall") for a in actors], timeout=120)
        # A peer stalled inside C6: rank n - 1 sleeps past the ring's wait
        # before its phase 3 of the second call. The ranks whose waits
        # expire void the call on every rank before their streams run on,
        # so the stalled rank, once it wakes and finds its words written,
        # raises too instead of returning what the released streams left.
        _collective_group(rt, actors, "qstall",
                          wait_timeout_s=COLLECTIVE_WAIT_S)
        raised = _must_raise(
            rt, [a.qstall.remote("qstall", 1024, n - 1, 3,
                                 COLLECTIVE_STALL_S) for a in actors],
            COLLECTIVE_DEADLINE_S, ("epoch 2", "cannot be used again"))
        check("expired during the call of epoch 2" in raised[-1][1],
              f"the stalled rank did not find the C6 call voided: "
              f"{raised[-1][1][-300:]}")
        out["c6_stalled_peer_s"] = max(t for t, _ in raised)
        rt.get([a.destroy.remote("qstall") for a in actors], timeout=120)
        # A dead peer: rank n - 1's actor killed between two calls.
        _collective_group(rt, actors, "dead",
                          wait_timeout_s=COLLECTIVE_WAIT_S)
        rt.get([a.call.remote("dead", 1024) for a in actors], timeout=120)
        victim = info[-1]["pid"]
        rt.kill(actors[-1])
        deadline = time.monotonic() + COLLECTIVE_DEADLINE_S
        while _alive(victim, info[-1]["cmdline"]) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        raised = _must_raise(rt, [a.call.remote("dead", 1024)
                                  for a in actors[:-1]],
                             COLLECTIVE_DEADLINE_S,
                             (f"peer rank(s) [{n - 1}]", "exited"))
        out["dead_peer_s"] = max(t for t, _ in raised)
        rt.get([a.destroy.remote("dead") for a in actors[:-1]], timeout=120)
        log("collective", f"a stalled peer (rank {n - 1} makes no second "
            f"call): "
            f"every other rank raised within {out['stalled_peer_s']:.2f} s "
            f"naming it and the epoch; a peer stalled {COLLECTIVE_STALL_S} "
            f"s inside C6 (before its phase 3): every rank raised within "
            f"{out['c6_stalled_peer_s']:.2f} s, the stalled one finding "
            f"the call voided; a dead peer (rank {n - 1}'s actor "
            f"killed between two calls): every other rank raised within "
            f"{out['dead_peer_s']:.2f} s naming it (deadline "
            f"{COLLECTIVE_DEADLINE_S} s; the ring's wait "
            f"{COLLECTIVE_WAIT_S} s)")
        procs = _cluster_pids()
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while True:
        left = {p: c for p, c in procs.items() if _alive(p, c)}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"processes left after shutdown: {left}")
    gc.collect()
    torch.cuda.empty_cache()
    # A rank's process leaves /proc's command line while the CUDA driver still
    # tears down its context (16 GB at full size): wait for the memory.
    t0 = time.monotonic()
    while True:
        out["memory_after_mib"] = gpu_memory_used_mib()
        if abs(out["memory_after_mib"] - mem0) < 1024 or \
                time.monotonic() - t0 > 60:
            break
        time.sleep(0.5)
    out["memory_back_s"] = time.monotonic() - t0
    out["memory_before_mib"] = mem0
    check(abs(out["memory_after_mib"] - mem0) < 1024,
          f"card memory {mem0:.0f} MiB before the cluster, "
          f"{out['memory_after_mib']:.0f} MiB 60 s after")

    rows = {}
    in_process = {"C4": ring_rows[0]["C4"], "C2": ring_rows[0]["C2"],
                  "C3": ring_rows[0]["C3"], "C6": qring_rows[0]["C6"]}
    for kind, key, kname, _ in COLLECTIVE_KERNELS[:4]:
        res = full[kind]
        e = 4 if kind == "quantized_allreduce" else 2
        elems = sizes[kind]
        # One rank's launch moves (reads + writes, once each): C4 a chunk
        # of every rank's input and it to every rank's output; C2 a chunk
        # of every input, one chunk out; C3 its shard, n shards out; C6
        # its block in and out (the int8 ring's bound, as in process).
        moved = {"allreduce": 2 * elems, "reducescatter": elems + elems // n,
                 "allgather": (1 + n) * elems,
                 "quantized_allreduce": 2 * elems}[kind] * e
        bound_ms, bound_by = ring_bound(moved, 0)
        ip = in_process[key]
        rows[key] = {
            "n": n, "elems_per_rank": elems,
            "dtype": "f32" if e == 4 else "bf16",
            "ms": _median(res[0]["kernel_ms"]),
            "ms_ranks": [_median(x["kernel_ms"]) for x in res],
            "call_ms": _median(res[0]["call_ms"]),
            "call_ms_ranks": [_median(x["call_ms"]) for x in res],
            "staged_bytes": res[0]["staged_bytes"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "in_process_ms": ip["ms"], "in_process_bound_ms": ip["bound_ms"],
            "plain_ms": ip["plain_ms"],
            "library_ms": library[kind][0]["library_ms"],
            "library_ms_ranks": [x["library_ms"] for x in library[kind]],
            "library_pinned_in_call": [x.get("library_pinned_in_call")
                                       for x in library[kind]],
            "library_computes": library[kind][0]["library_computes"],
            "sample_rows": res[0]["samples"] * 8,
            "sample_max_err": max(x["sample_max_err"] for x in res)}
        log("collective", f"{key} across {n} processes, {elems} "
            f"{rows[key]['dtype']} a rank: kernel {rows[key]['ms']:.4f} ms "
            f"in rank 0 (CUDA events; ranks "
            + ", ".join(f"{v:.4f}" for v in rows[key]["ms_ranks"])
            + f"), the call {rows[key]['call_ms']:.3f} ms (waits and "
            f"staging), staged {rows[key]['staged_bytes']} bytes; one "
            f"rank's bound {bound_ms:.4f} ms ({bound_by}); in process (all "
            f"{n} ranks, one launch) {ip['ms']:.4f} ms, bound "
            f"{ip['bound_ms']:.4f} ms; library "
            + (f"{rows[key]['library_ms']:.3f} ms in rank 0 ("
               f"host buffers pinned inside the timed call "
               f"{rows[key]['library_pinned_in_call']}; "
               if rows[key]["library_ms"] is not None else "none (")
            + f"{rows[key]['library_computes']}); sampled rows held "
            f"({rows[key]['sample_rows']} rows of 128, max err "
            f"{rows[key]['sample_max_err']:.3g}); {card}")
    hop_in_process = {"C1": ring_rows[0]["C1"], "C5": qring_rows[0]["C5"]}
    for kind, key in (("permute", "C1"), ("qrs_hop", "C5")):
        res = full[kind]
        hop_rows_ = hop_rows[kind]
        # One hop of one rank moves (reads + writes, once each): C1 its
        # block in and into the neighbour's staging, C5 in place its send
        # chunk, and its receive chunk in and out (f32; the int8 payload
        # is the wire format's price).
        blk = hop_rows_ * 128
        moved = 2 * blk * 2 if kind == "permute" else 3 * blk * 4
        bound_ms, bound_by = ring_bound(moved, 0)
        per_hop = [_median([k[t] for k in res[0]["kernel_ms"]])
                   for t in range(len(res[0]["kernel_ms"][0]))]
        calls_ = [_median([w[t] for w in res[0]["call_ms"]])
                  for t in range(len(res[0]["call_ms"][0]))]
        ip = hop_in_process[key]
        rows[key] = {
            "n": n, "rows_per_hop": hop_rows_,
            "elems_per_rank": blk * (1 if kind == "permute" else n),
            "dtype": "bf16" if kind == "permute" else "f32",
            "ms": per_hop[0], "ms_per_hop": per_hop,
            "ms_ranks": [_median([k[0] for k in x["kernel_ms"]])
                         for x in res],
            "call_ms": calls_[0], "call_ms_per_hop": calls_,
            "staged_bytes": res[0]["staged_bytes"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "in_process_ms": ip.get("hop0_ms", ip["ms"]),
            "in_process_bound_ms": ip["bound_ms"],
            "plain_ms": ip["plain_ms"],
            "library_ms": library[kind][0]["library_ms"],
            "library_ms_ranks": [x["library_ms"] for x in library[kind]],
            "library_pinned_in_call": None,
            "library_computes": library[kind][0]["library_computes"],
            "sample_rows": res[0]["samples"] * 8,
            "sample_max_err": max(x["sample_max_err"] for x in res)}
        log("collective", f"{key} rank form, one overlap chunk, {n} "
            f"processes, {hop_rows_} rows of 128 {rows[key]['dtype']} a "
            f"hop: kernel per hop "
            + ", ".join(f"{v:.4f}" for v in per_hop)
            + f" ms in rank 0 (CUDA events; hop 0 in ranks "
            + ", ".join(f"{v:.4f}" for v in rows[key]["ms_ranks"])
            + "), the calls " + ", ".join(f"{v:.3f}" for v in calls_)
            + f" ms, staged {rows[key]['staged_bytes']} bytes; one rank's "
            f"bound {bound_ms:.4f} ms ({bound_by}); in process (all ranks, "
            f"one launch) {rows[key]['in_process_ms']:.4f} ms; library "
            + (f"{rows[key]['library_ms']:.3f} ms in rank 0 ("
               if rows[key]["library_ms"] is not None else "none (")
            + f"{rows[key]['library_computes']}); sampled rows held (max "
            f"err {rows[key]['sample_max_err']:.3g}); {card}")
    out["rows"] = rows
    out["phase_s"] = time.perf_counter() - phase_t0
    log("collective", f"full size: {out['full_size_s']:.2f} s for the "
        f"four kinds (inputs made, {1 + COLLECTIVE_TIMED} calls each, the "
        f"sample checked); the library's calls {out['library_s']:.2f} s")
    log("collective", f"cluster up in {out['cluster_start_s']:.2f} s; shut "
        f"down: no cluster process left, card memory {mem0:.0f} -> "
        f"{out['memory_after_mib']:.0f} MiB ({out['memory_back_s']:.1f} s "
        f"after the processes left); the phase took "
        f"{out['phase_s']:.1f} s; {card}")
    return out


# 6l: jobs -- runtime_env, job submission, the dashboard head and the
# state views, with a job serving Llama-3-8B from a GPU actor.
JOB_LAYERS = 4                   # the served job's depth (of 32)
JOB_REQUESTS = 4                 # the first of the serve phase's requests
JOB_CPUS = 8
JOB_MODEL = {"preset": "llama3_8b", "attn_impl": "flash"}
JOB_DEVICE = None                # the lease's card (a CPU rehearsal: "cpu")
JOB_WAIT_S = 600.0               # any one wait of the phase
JOB_FREE_S = 60.0                # stop_job to the GPU back in the cluster
JOB_OBJECT_MIB = 16              # an object the state views must show

# The served job's working dir: a helper module (its actor) and an
# entrypoint that imports it, so the job runs only if the dir was
# packaged, shipped through the GCS and unpacked as its cwd.
JOB_HELPER = '''"""The served job's helper: its GPU actor and its inputs."""
import json
import os
import time

import ray_tpu_torch as rt


def load():
    with open("job.json") as f:            # the unpacked working dir
        return json.load(f)


@rt.remote(num_gpus=1)
class JobServer:
    """LLMServer on the leased card: int8, flash, the job's depth and
    seed; built without device=, so it raises where there is no card."""

    def __init__(self, model, layers, seed, engine, device):
        import torch

        from ray_tpu_torch.models.llama import LlamaConfig
        from ray_tpu_torch.serve.llm import LLMServer

        kw = {"device": device} if device else {}
        cfg = getattr(LlamaConfig, model["preset"])(
            n_layers=layers, attn_impl=model["attn_impl"],
            param_dtype=torch.bfloat16)
        engine = dict(engine, prefill_buckets=tuple(engine["prefill_buckets"]))
        t0 = time.perf_counter()
        self.server = LLMServer(cfg, engine, init_seed=seed,
                                quantize="int8", **kw)
        self.build_s = time.perf_counter() - t0
        self._prefills0 = 0
        self.served = 0

    def info(self):
        import sys

        import torch

        return {"pid": os.getpid(), "build_s": self.build_s,
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "cuda_bytes": (torch.cuda.memory_allocated()
                               if torch.cuda.is_initialized() else 0),
                "foreign_modules": sorted(
                    m for m in sys.modules
                    if m.split(".")[0] in ("jax", "ray_tpu"))}

    def reset_counts(self):
        from ray_tpu_torch.ops import attention

        self._prefills0 = self.server.stats()["prefills"]
        attention.flash_fwd_cuda.launches = 0

    def counts(self):
        from ray_tpu_torch.ops import attention

        return {"b1_launches": attention.flash_fwd_cuda.launches,
                "prefills": self.server.stats()["prefills"] - self._prefills0}

    def serve(self, request):
        out = self.server(request)
        self.served += 1
        print(f"job actor served request {self.served}: "
              f"{out['num_tokens']} tokens", flush=True)
        return out
'''

JOB_ENTRY = '''"""The served job: a GPU actor answers the requests, one at a time."""
import json
import os
import sys
import time

import jobhelper
import ray_tpu_torch as rt

rt.init(address=os.environ["RAY_TPU_ADDRESS"])
job = jobhelper.load()
t0 = time.perf_counter()
actor = jobhelper.JobServer.remote(
    job["model"], int(os.environ["JOB_LAYERS"]), int(os.environ["JOB_SEED"]),
    job["engine"], job["device"])
info = rt.get(actor.info.remote(), timeout=600)
ready_s = time.perf_counter() - t0
rt.get(actor.reset_counts.remote(), timeout=60)
results = [rt.get(actor.serve.remote(r), timeout=600)
           for r in job["requests"]]
counts = rt.get(actor.counts.remote(), timeout=60)
print("JOB_RESULT " + json.dumps({
    "tokens": [r["tokens"] for r in results],
    "ttft_s": [r["ttft_s"] for r in results],
    "counts": counts, "actor": info, "actor_ready_s": ready_s,
    "driver_pid": os.getpid(), "cwd": os.getcwd(),
    "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
    "foreign_modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "ray_tpu",
                                                     "torch"))}), flush=True)
# Hold the card until the caller has read this job's processes.
deadline = time.monotonic() + 600
while not os.path.exists(os.environ["JOB_GATE"]):
    if time.monotonic() > deadline:
        sys.exit("the gate never opened")
    time.sleep(0.1)
rt.shutdown()
'''

BUSY_ENTRY = '''"""The second job: its GPU actor in a placement group serves until the
job is stopped."""
import json
import os

import jobhelper
import ray_tpu_torch as rt
from ray_tpu_torch.util.placement_group import placement_group
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy,
)

rt.init(address=os.environ["RAY_TPU_ADDRESS"])
job = jobhelper.load()
pg = placement_group([{"CPU": 1, "GPU": 1}])
rt.get(pg.ready(), timeout=600)
actor = jobhelper.JobServer.options(
    num_cpus=1, scheduling_strategy=PlacementGroupSchedulingStrategy(
        pg, placement_group_bundle_index=0)).remote(
    job["model"], int(os.environ["JOB_LAYERS"]), int(os.environ["JOB_SEED"]),
    job["engine"], job["device"])
info = rt.get(actor.info.remote(), timeout=600)
print("BUSY_READY " + json.dumps({
    "actor_id": actor._actor_id.hex(), "actor_pid": info["pid"],
    "driver_pid": os.getpid()}), flush=True)
while True:
    rt.get(actor.serve.remote(job["busy_request"]), timeout=600)
'''

JOB_WHEEL_MODULE = '''"""A wheel installed into a job's pip env: B1's inputs."""


def qkv(seq, seed, device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn((1, seq, 32, 128), generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(3)]
'''


def _make_wheel(dirname, name, module_text, version="0.1"):
    """A minimal wheel of one module, built by hand (no network)."""
    import zipfile

    whl = os.path.join(dirname, f"{name}-{version}-py3-none-any.whl")
    with zipfile.ZipFile(whl, "w") as z:
        z.writestr(f"{name}/__init__.py", module_text)
        z.writestr(f"{name}-{version}.dist-info/METADATA",
                   f"Metadata-Version: 2.1\nName: {name}\n"
                   f"Version: {version}\n")
        z.writestr(f"{name}-{version}.dist-info/WHEEL",
                   "Wheel-Version: 1.0\nGenerator: chip_smoke\n"
                   "Root-Is-Purelib: true\nTag: py3-none-any\n")
        z.writestr(f"{name}-{version}.dist-info/RECORD", "")
    return whl


def _pip_b1(seq, device):
    """In a pip env's worker: B1 once at (1, seq, 32, 128) bf16 causal on
    the wheel's inputs, against its plain version."""
    import rtpu_jobwheel

    from ray_tpu_torch.ops import attention

    q, k, v = rtpu_jobwheel.qkv(seq, 0, device)
    po, plse = attention.flash_attention_plain(q, k, v, True)
    if device == "cpu":                  # a rehearsal: no kernel to launch
        o, lse = po, plse
    else:
        o, lse = attention.flash_fwd_cuda(q, k, v, True)
        torch.cuda.synchronize()
    used_o, used_lse = b1_used(o, lse, po, plse, torch.bfloat16)
    return {"executable": sys.executable,
            "cuda_available": torch.cuda.is_available(),
            "used_o": used_o, "used_lse": used_lse,
            "max_abs_err": (o.float() - po.float()).abs().max().item(),
            "wheel": rtpu_jobwheel.__file__}


def _job_logs(client, sid, marker, timeout=JOB_WAIT_S):
    """The JSON that follows ``marker`` on a line of the job's log,
    fetched over HTTP, once the log holds it."""
    deadline = time.monotonic() + timeout
    while True:
        text = client.get_job_logs(sid)
        for line in text.splitlines():
            if line.startswith(marker + " "):
                return json.loads(line[len(marker) + 1:])
        status = client.get_job_status(sid)
        check(status in ("PENDING", "RUNNING") and time.monotonic() < deadline,
              f"job {sid} is {status} without {marker}; its log:\n{text}")
        time.sleep(0.2)


def _gone(pid, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return True
        except (OSError, IndexError):
            return True
        time.sleep(0.1)
    return False


def _gpu_free(rt, timeout):
    """Seconds until the cluster's available GPU is back to 1."""
    t0 = time.perf_counter()
    while rt.available_resources().get("GPU", 0) < 1:
        check(time.perf_counter() - t0 < timeout,
              f"the GPU was not back within {timeout:.0f} s: "
              f"{rt.available_resources()}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _card_released(pid, mem_before, timeout=30.0):
    """Whether the process ``pid`` has exited and the card's used memory
    is back within 1 GiB of ``mem_before`` (MiB) within ``timeout``.
    nvidia-smi on the card's machine lists no compute apps, so its list
    cannot say which process holds the card."""
    if not _gone(pid, timeout):
        return False
    deadline = time.monotonic() + timeout
    while gpu_memory_used_mib() - mem_before >= 1024:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.2)
    return True


def _http_get(base, path, timeout=120):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=timeout) as resp:
        body = resp.read()
        if resp.headers.get_content_type() == "application/json":
            return json.loads(body)
        return body.decode()


def phase_jobs(dev, card):
    """Jobs on the port's runtime; see the module docstring (6l)."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.util import state

    phase_t0 = time.perf_counter()
    out = {"card": card}
    cfg = getattr(LlamaConfig, JOB_MODEL["preset"])(
        n_layers=JOB_LAYERS, attn_impl=JOB_MODEL["attn_impl"],
        param_dtype=torch.bfloat16)
    reqs = serve_requests(cfg)[:JOB_REQUESTS]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_jobs_")
    wd = os.path.join(tmp, "job")
    os.makedirs(wd)
    for name, text in (("jobhelper.py", JOB_HELPER),
                       ("serve_job.py", JOB_ENTRY),
                       ("busy_job.py", BUSY_ENTRY)):
        with open(os.path.join(wd, name), "w") as f:
            f.write(text)
    with open(os.path.join(wd, "job.json"), "w") as f:
        json.dump({"model": JOB_MODEL, "engine": ENGINE, "device": JOB_DEVICE,
                   "requests": reqs,
                   "busy_request": {"prompt": reqs[0]["prompt"],
                                    "max_tokens": 64}}, f)
    gate = os.path.join(tmp, "gate")
    env_vars = {"JOB_LAYERS": str(JOB_LAYERS), "JOB_SEED": "0",
                "JOB_GATE": gate,
                # An env cannot make a card visible: the raylet sets it
                # back to "" after the env's variables.
                "CUDA_VISIBLE_DEVICES": "0"}
    mem0 = gpu_memory_used_mib() if JOB_DEVICE is None else 0.0
    t0 = time.perf_counter()
    info = rt.init(num_cpus=JOB_CPUS, num_gpus=1, include_dashboard=True)
    out["start_s"] = time.perf_counter() - t0
    try:
        url = info["dashboard_url"]
        check(url is not None, "init(include_dashboard=True) started no "
              "dashboard (see the session's logs/dashboard.err)")
        kv = global_worker().gcs.call("kv_get", namespace="dashboard",
                                      key="dashboard_url", timeout=10)
        check(kv is not None and kv.decode() == url,
              f"the KV's dashboard_url {kv!r} is not {url}")
        head = [p for p, c in _cluster_pids().items()
                if "ray_tpu_torch.dashboard.head" in c]
        check(len(head) == 1, f"dashboard head processes: {head}")
        log("jobs", f"cluster with the dashboard at {url} up in "
            f"{out['start_s']:.2f} s (head pid {head[0]})")
        client = JobSubmissionClient(url)

        # --- (2) the serving job ------------------------------------------
        t_submit = time.perf_counter()
        sid = client.submit_job(
            entrypoint=f"{sys.executable} serve_job.py",
            runtime_env={"working_dir": wd, "env_vars": env_vars})
        res = _job_logs(client, sid, "JOB_RESULT")
        out["submit_to_result_s"] = time.perf_counter() - t_submit
        record = client.get_job_info(sid)
        check(record["runtime_env"]["working_dir"].startswith("gcs://"),
              f"the working dir was not packaged: {record['runtime_env']}")
        check(res["cwd"] != wd and "runtime_envs" in res["cwd"],
              f"the job ran in {res['cwd']}, not the unpacked package")
        pids = {"dashboard head": head[0], "supervisor": record["pid"],
                "job driver": res["driver_pid"]}
        if JOB_DEVICE is None:
            held = {name: _off_cuda(pid) for name, pid in pids.items()}
            actor_held = _off_cuda(res["actor"]["pid"])
            log("jobs", f"while the job's actor holds the card: "
                f"{held}; the actor: {actor_held}, its lease's "
                f"CUDA_VISIBLE_DEVICES {res['actor']['cuda_visible_devices']!r}"
                f", {res['actor']['cuda_bytes']} B allocated by torch")
            for name, h in held.items():
                check(not h["listed"] and not h["libcuda"]
                      and h["cuda_visible_devices"] == "",
                      f"the {name} holds the card: {h}")
            # nvidia-smi lists no compute apps here: libcuda mapped and
            # memory allocated on the leased card say the actor holds it.
            check(actor_held["libcuda"] and res["actor"]["cuda_bytes"] > 0,
                  f"the job's actor holds no CUDA context: {actor_held}, "
                  f"{res['actor']}")
        check(res["cuda_visible_devices"] == "",
              f"the job's driver sees CUDA_VISIBLE_DEVICES="
              f"{res['cuda_visible_devices']!r}")
        check(res["foreign_modules"] == [] and
              res["actor"]["foreign_modules"] == [],
              f"the job's driver loaded {res['foreign_modules']}, its "
              f"actor {res['actor']['foreign_modules']}")
        check(res["actor"]["cuda_visible_devices"] == "0"
              or JOB_DEVICE is not None,
              f"the job's actor's lease: {res['actor']}")
        with open(gate, "w") as f:
            f.write("open")
        status = client.wait_until_finished(sid, timeout=JOB_WAIT_S)
        out["submit_to_succeeded_s"] = time.perf_counter() - t_submit
        check(status == "SUCCEEDED", f"the serving job {status}: "
              f"{client.get_job_logs(sid)}")
        logs = client.get_job_logs(sid)
        check(json.dumps(res["tokens"]) in logs,
              "the tokens are not in the job's log as fetched over HTTP")
        counts = res["counts"]
        out["b1_launches"] = counts["b1_launches"]
        out["job_prefills"] = counts["prefills"]
        out["first_token_s"] = res["ttft_s"][0]
        out["later_ttft_p50_s"] = float(np.median(res["ttft_s"][1:]))
        out["actor_ready_s"] = res["actor_ready_s"]
        out["actor_build_s"] = res["actor"]["build_s"]
        check(counts["prefills"] == len(reqs)
              and counts["b1_launches"] == cfg.n_layers * len(reqs)
              or JOB_DEVICE is not None,
              f"B1 in the job's actor: {counts}, want {cfg.n_layers} x "
              f"{len(reqs)}")
        # The in-process server is built once the job has let go of the
        # card: its driver ended, and its actor with it.
        out["release_s"] = _gpu_free(rt, JOB_FREE_S)
        if JOB_DEVICE is None:
            check(_card_released(res["actor"]["pid"], mem0),
                  "the served job's actor still holds the card")
        kw = {"device": dev}
        local = LLMServer(cfg, dict(ENGINE), init_seed=0, quantize="int8",
                          **kw)
        try:
            want, local_s = [], []
            for r in reqs:
                t0 = time.perf_counter()
                want.append(local(r)["tokens"])
                local_s.append(time.perf_counter() - t0)
        finally:
            local.shutdown()
            del local
            gc.collect()
            if JOB_DEVICE is None:
                torch.cuda.empty_cache()
        same = sum(a == b for a, b in zip(res["tokens"], want))
        out["tokens_equal"] = f"{same}/{len(reqs)}"
        out["local_tokens"], out["local_latency_s"] = want, local_s
        log("jobs", f"served job {sid}: SUCCEEDED {out['submit_to_succeeded_s']:.1f} "
            f"s after its submit (results in its log after "
            f"{out['submit_to_result_s']:.1f} s; the rest held at the gate "
            f"for the process checks); actor ready in "
            f"{out['actor_ready_s']:.1f} s (server built in "
            f"{out['actor_build_s']:.1f} s), first token "
            f"{1e3 * out['first_token_s']:.1f} ms (the later requests' TTFT "
            f"p50 {1e3 * out['later_ttft_p50_s']:.1f} ms); B1 launches in "
            f"the actor "
            f"{counts['b1_launches']} for {counts['prefills']} prefills; "
            f"greedy tokens, job actor == in-process server: "
            f"{out['tokens_equal']}; card released {out['release_s']:.2f} s "
            f"after SUCCEEDED; {card}")
        check(same == len(reqs), f"the job's tokens differ from the "
              f"in-process server's: {out['tokens_equal']}")

        # --- (3) state and the dashboard while a second job holds the card
        mem1 = gpu_memory_used_mib() if JOB_DEVICE is None else 0.0
        obj = rt.put(torch.zeros(JOB_OBJECT_MIB << 18))      # f32 elements
        obj_bytes = JOB_OBJECT_MIB << 20
        sid2 = client.submit_job(
            entrypoint=f"{sys.executable} busy_job.py",
            runtime_env={"working_dir": wd, "env_vars": env_vars})
        busy = _job_logs(client, sid2, "BUSY_READY")
        record2 = client.get_job_info(sid2)
        aid, apid = busy["actor_id"], busy["actor_pid"]
        wid = next(a["worker_id"] for a in state.list_actors()
                   if a["actor_id"] == aid)
        jobs = state.list_jobs()
        running = [j for j in jobs if j["state"] == "RUNNING"
                   and "runtime_envs" in j["metadata"].get("cwd", "")]
        finished = [j for j in jobs if j["state"] == "FINISHED"
                    and "runtime_envs" in j["metadata"].get("cwd", "")]
        check(len(running) == 1 and len(finished) == 1,
              f"list_jobs: {jobs}")
        tasks = state.list_tasks()
        # The second job's placement group's readiness task.
        check(any(t["name"] == "_pg_ready_waiter" and t["state"] == "FINISHED"
                  for t in tasks),
              f"list_tasks: {sorted({t['name'] for t in tasks})}")
        pgs = [p for p in state.list_placement_groups()
               if p["state"] == "CREATED"]
        check(len(pgs) == 1 and pgs[0]["bundles"] == [{"CPU": 1, "GPU": 1}],
              f"list_placement_groups: {pgs}")
        actors = {r["class"]: r for r in state.summary_actors()}
        check(actors.get("JobServer", {}).get("ALIVE") == 1
              and actors.get("JobSupervisor", {}).get("ALIVE", 0) >= 1,
              f"summary_actors: {actors}")
        mem = state.memory_summary(top_n=5)
        top = mem["top_objects"][0] if mem["top_objects"] else {}
        check(top.get("object_id") == obj.hex() and
              top.get("size", 0) >= obj_bytes and top["reference"] == "owned",
              f"memory_summary's largest object: {top}")
        objects = state.list_objects()
        check(sum(o.get("num_objects", 0) for o in objects) >= 1
              and sum(o.get("used", 0) for o in objects) >= obj_bytes,
              f"list_objects: {objects}")
        cluster = _http_get(url, "/api/cluster")
        nodes = _http_get(url, "/api/nodes")
        check(cluster["total"].get("GPU") == 1
              and [n["total"].get("GPU") for n in nodes] == [1],
              f"/api/cluster {cluster}, /api/nodes {nodes}")
        deadline = time.monotonic() + 60
        while True:
            metrics = _http_get(url, "/metrics")
            # The GCS labels each series node="...",resource="...".
            missing = [m for m in (r'rtpu_resource_capacity\{[^}]*'
                                   r'resource="GPU"\} 1\.0\b',
                                   r"rtpu_node_cpu_percent\{",
                                   r"rtpu_node_gpus_free\{",
                                   r"rtpu_node_workers\{")
                       if not re.search(m, metrics)]
            if not missing or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        check(not missing, f"/metrics lacks {missing}")
        deadline = time.monotonic() + 60
        while True:
            lines = _http_get(url, f"/api/logs?actor_id={aid}&tail=50")
            if any("job actor served" in ln for ln in lines["lines"]) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        check(any("job actor served" in ln for ln in lines["lines"]),
              f"/api/logs?actor_id= gave {lines}")
        stacks = _http_get(url, "/api/stacks")
        check(wid in stacks and "MainThread" in stacks[wid].get("stacks", ""),
              f"/api/stacks lacks the actor's worker {wid}: {sorted(stacks)}")
        prof = _http_get(url, f"/api/profile?duration=2&worker={wid}")
        folded = prof.get(wid, {}).get("folded", "")
        samples = prof.get(wid, {}).get("samples", 0)
        check(samples > 0 and "serve" in folded,
              f"/api/profile: {samples} samples, serve in the stacks: "
              f"{'serve' in folded}")
        log("jobs", f"state while job {sid2}'s actor holds the card: "
            f"{len(jobs)} jobs, {len(tasks)} tasks, {len(pgs)} placement "
            f"group, actors {sorted(actors)}, the largest object "
            f"{top['size']} B (owned); /api/cluster and /api/nodes GPU 1, "
            f"/metrics with the GPU capacity and the node gauges, "
            f"{len(lines['lines'])} log lines of the actor, stacks of "
            f"{len(stacks)} workers, a 2 s profile of the actor's worker "
            f"with {samples} samples in serve")
        del obj

        # --- (4) stop ------------------------------------------------------
        tree = [record2["child_pid"], busy["driver_pid"]]
        t_stop = time.perf_counter()
        check(client.stop_job(sid2), "stop_job refused")
        stop_call_s = time.perf_counter() - t_stop
        _gpu_free(rt, JOB_FREE_S - stop_call_s)
        out["stop_to_free_s"] = time.perf_counter() - t_stop
        status2 = client.get_job_status(sid2)
        gone = {pid: _gone(pid) for pid in tree}
        left = (_card_released(apid, mem1) if JOB_DEVICE is None
                else _gone(apid))
        log("jobs", f"stop_job: the job reads {status2}, its process tree "
            f"gone {gone}, the GPU back in the cluster "
            f"{out['stop_to_free_s']:.2f} s after the stop (the stop call "
            f"{stop_call_s:.2f} s of it), the actor's process gone and "
            f"the card's memory back: {left}; {card}")
        check(status2 == "STOPPED" and all(gone.values()) and left,
              f"stop: {status2}, {gone}, {left}")

        # --- (5) a pip env on the card ---------------------------------------
        whl = _make_wheel(tmp, "rtpu_jobwheel", JOB_WHEEL_MODULE)
        pip_task = rt.remote(num_gpus=1, runtime_env={"pip": [whl]})(_pip_b1)
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append(rt.get(pip_task.remote(512, JOB_DEVICE or "cuda"),
                               timeout=JOB_WAIT_S))
            runs[-1]["call_s"] = time.perf_counter() - t0
        stats = global_worker().raylet.call("runtime_env_stats", timeout=30)
        pip_uris = [u for u in stats["cached_uris"] if u.startswith("pip:")]
        pip_root = os.path.join(info["session_dir"], "runtime_envs", "pip")
        first = runs[0]
        out["venv_create_s"] = stats["create_seconds"][pip_uris[0]] \
            if pip_uris else None
        out["pip_calls_s"] = [r["call_s"] for r in runs]
        out["pip_b1"] = {k: first[k] for k in ("used_o", "used_lse",
                                               "max_abs_err")}
        log("jobs", f"pip env: venv made in {out['venv_create_s']:.2f} s, "
            f"first task {runs[0]['call_s']:.2f} s, second "
            f"{runs[1]['call_s']:.2f} s, both under {first['executable']}; "
            f"CUDA there {first['cuda_available']}; B1 at (1, 512, 32, 128) "
            f"bf16 causal: O err {first['max_abs_err']:.3g} "
            f"({first['used_o']:.2f} of the limit), LSE "
            f"{first['used_lse']:.2f} of the limit; {card}")
        check(all(r["executable"].startswith(pip_root + os.sep)
                  for r in runs) and runs[0]["executable"]
              == runs[1]["executable"] and len(pip_uris) == 1,
              f"pip env: {runs}, {stats}")
        check(all(r["cuda_available"] for r in runs)
              or JOB_DEVICE is not None, "no CUDA in the pip env")
        check(all(r["used_o"] <= 1.0 and r["used_lse"] <= 1.0 for r in runs),
              f"B1 in the pip env: {runs}")
    finally:
        # A job's entrypoint runs in a session of its own: one a failed
        # gate left running is stopped before the cluster goes.
        try:
            with open(gate, "w") as f:
                f.write("open")
            for job in (client.list_jobs() if "client" in locals() else []):
                if job.get("status") in ("PENDING", "RUNNING"):
                    client.stop_job(job["submission_id"])
        finally:
            procs = _cluster_pids()
            rt.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.monotonic() + 30
    while True:
        left = {p: c for p, c in procs.items() if _alive(p, c)}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"processes left after shutdown: {left}")
    if JOB_DEVICE is None:
        gc.collect()
        torch.cuda.empty_cache()
        out["memory_before_mib"] = mem0
        out["memory_after_mib"] = gpu_memory_used_mib()
        check(abs(out["memory_after_mib"] - mem0) < 1024,
              f"card memory {mem0:.0f} MiB before the phase, "
              f"{out['memory_after_mib']:.0f} MiB after")
    out["phase_s"] = time.perf_counter() - phase_t0
    log("time", f"jobs: submit to results {out['submit_to_result_s']:.1f} s"
        f" and to SUCCEEDED {out['submit_to_succeeded_s']:.1f} "
        f"s, the job actor's first token {1e3 * out['first_token_s']:.1f} ms, "
        f"venv made in {out['venv_create_s']:.2f} s, stop to GPU free "
        f"{out['stop_to_free_s']:.2f} s, the phase {out['phase_s']:.1f} s; "
        f"{card}")
    return out


# 6m: the driver's transports -- the thin client, a compiled DAG around
# the GPU actor, the C++ frontend and a workflow's resume, each driving
# 6l's model on 6l's first requests.
XPORT_HOP_RUNS = 20              # one-token executions a DAG route, timed
XPORT_HOP_PROMPT = 16            # the one-token request's prompt tokens
XPORT_B1_SEQ = 512               # the workflow's B1 call: (1, S, 32, 128)
XPORT_CPP_PROBES = ("cpp_to_cpp_task", "cpp_to_cpp_actor",
                    "cpp_actor_ndarray", "cpp_actor_survives_error",
                    "cpp_named_actor_lookup")

# The thin client: a process that sees no card. It makes 6l's job actor
# class (``jobhelper.JobServer``, shipped by value) through the client
# server, serves the requests one at a time and, once the caller has read
# its process, kills the actor and disconnects.
XPORT_CLIENT = '''"""A thin client of the port: no card; its GPU actor serves."""
import json
import os
import sys
import time

import cloudpickle

import jobhelper
import ray_tpu_torch as rt

cloudpickle.register_pickle_by_value(jobhelper)
with open(sys.argv[2]) as f:
    spec = json.load(f)
rt.init(address="ray_tpu_torch://127.0.0.1:" + sys.argv[1])
t0 = time.perf_counter()
actor = jobhelper.JobServer.remote(spec["model"], spec["layers"], 0,
                                   spec["engine"], spec["device"])
info = rt.get(actor.info.remote(), timeout=600)
ready_s = time.perf_counter() - t0
rt.get(actor.reset_counts.remote(), timeout=60)
tokens, latency_s = [], []
for r in spec["requests"]:
    t = time.perf_counter()
    tokens.append(rt.get(actor.serve.remote(r), timeout=600)["tokens"])
    latency_s.append(time.perf_counter() - t)
counts = rt.get(actor.counts.remote(), timeout=60)
with open(spec["result"] + ".tmp", "w") as f:
    json.dump({
        "tokens": tokens, "latency_s": latency_s, "counts": counts,
        "actor": info, "actor_ready_s": ready_s, "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "modules": sorted(m for m in sys.modules if m.split(".")[0]
                          in ("jax", "ray_tpu", "torch"))}, f)
os.replace(spec["result"] + ".tmp", spec["result"])
deadline = time.monotonic() + 600
while not os.path.exists(spec["gate"]):
    if time.monotonic() > deadline:
        sys.exit("the gate never opened")
    time.sleep(0.05)
rt.kill(actor)
rt.shutdown()
'''


def _transport_classes(rt):
    """The compiled DAG's CPU stages around 6l's job actor (the GPU
    stage): tokenize and detokenize."""

    @rt.remote
    class Tok:
        def encode(self, request):
            if "prompt" not in request:
                raise ValueError("tokenize: a request without a prompt")
            return {"prompt": list(request["prompt"]),
                    "max_tokens": int(request["max_tokens"])}

    @rt.remote
    class Detok:
        def decode(self, out):
            return {"tokens": out["tokens"], "ttft_s": out["ttft_s"]}

    return Tok, Detok


# The workflow's three steps (module level: cloudpickle ships them by
# value from ``__main__``).
def _wf_inputs(seed):
    """q, k, v of B1's serving shape, bf16, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((1, XPORT_B1_SEQ, N_HEADS, HEAD_DIM), generator=gen,
                        dtype=torch.bfloat16) for _ in range(3)]


def _wf_attend(qkv, marks, device):
    """The GPU step: B1 once on the lease's card (counted), O to the CPU;
    each execution leaves a file in ``marks`` with its launches."""
    from ray_tpu_torch.ops import attention

    dev = torch.device(device or "cuda")
    q, k, v = (t.to(dev) for t in qkv)
    before = attention.flash_fwd_cuda.launches
    o = attention.flash_attention(q, k, v, causal=True)
    launches = attention.flash_fwd_cuda.launches - before
    with open(os.path.join(marks, f"attend_{time.time_ns()}.json"),
              "w") as f:
        json.dump({"launches": launches, "pid": os.getpid(),
                   "cuda_visible_devices":
                       os.environ.get("CUDA_VISIBLE_DEVICES")}, f)
    return o.cpu()


def _wf_finish(o, marks, status_path):
    """The last step: records the workflow's status as it runs, fails
    until ``marks/ok`` exists."""
    status = None
    if os.path.exists(status_path):
        with open(status_path) as f:
            status = json.load(f)["status"]
    with open(os.path.join(marks, "finish_statuses"), "a") as f:
        f.write(f"{status}\n")
    if not os.path.exists(os.path.join(marks, "ok")):
        raise RuntimeError("the workflow's last step fails on its first run")
    return {"o": o, "checksum": float(o.double().sum())}


def _xport_fixtures(lib):
    """The reference's cross-language fixtures
    (``tests/test_cpp_client.py``), the matmul on torch."""
    from ray_tpu_torch import cross_language

    def matmul_t(m):
        t = torch.tensor(m)
        return (t @ t.T).numpy()

    def square(x):
        return x * x

    def boom():
        raise RuntimeError("boom from the cluster")

    for name, fn in (("xlang_matmul_t", matmul_t), ("xlang_square", square),
                     ("xlang_boom", boom),
                     ("cpp_fib", cross_language.cpp_function(lib, "fib")),
                     ("CppCounter",
                      cross_language.cpp_actor_class(lib, "Counter"))):
        cross_language.register(name, fn)


def phase_transports(dev, card, local_tokens, local_latency_s):
    """The driver's transports on the port; see the module docstring
    (6m)."""
    import shutil

    import cloudpickle

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.client import serve as client_serve
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models.llama import LlamaConfig

    phase_t0 = time.perf_counter()
    out = {"card": card}
    rehearsal = JOB_DEVICE is not None
    cfg = getattr(LlamaConfig, JOB_MODEL["preset"])(
        n_layers=JOB_LAYERS, attn_impl=JOB_MODEL["attn_impl"],
        param_dtype=torch.bfloat16)
    reqs = serve_requests(cfg)[:JOB_REQUESTS]
    b1_per_pass = cfg.n_layers * len(reqs)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_transports_")
    # The C++ demo builds while the thin client runs.
    cpp_out = os.path.join(tmp, "cpp")
    cpp_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
    t_make = time.perf_counter()
    make = subprocess.Popen(["make", "-s", f"BUILD={cpp_out}"], cwd=cpp_dir,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    t0 = time.perf_counter()
    rt.init(num_cpus=JOB_CPUS, num_gpus=1)
    out["start_s"] = time.perf_counter() - t0
    srv = client = client_log = None
    try:
        srv = client_serve(0, host="127.0.0.1")
        log("transports", f"cluster up in {out['start_s']:.2f} s, client "
            f"server on port {srv.port}")

        # --- (a) the thin client -------------------------------------------
        t_leg = time.perf_counter()
        for name, text in (("jobhelper.py", JOB_HELPER),
                           ("client.py", XPORT_CLIENT)):
            with open(os.path.join(tmp, name), "w") as f:
                f.write(text)
        gate, result = os.path.join(tmp, "gate"), os.path.join(tmp, "res")
        spec = os.path.join(tmp, "client.json")
        with open(spec, "w") as f:
            json.dump({"model": JOB_MODEL, "layers": JOB_LAYERS,
                       "engine": ENGINE, "device": JOB_DEVICE,
                       "requests": reqs, "gate": gate, "result": result}, f)
        root = os.path.dirname(os.path.abspath(__file__))
        client_log = open(os.path.join(tmp, "client.log"), "w+")
        client = subprocess.Popen(
            [sys.executable, "client.py", str(srv.port), spec], cwd=tmp,
            stdout=client_log, stderr=subprocess.STDOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                 "PYTHONPATH": os.pathsep.join(
                     [root] + [p for p in os.environ.get(
                         "PYTHONPATH", "").split(os.pathsep) if p])})

        def client_tail():
            client_log.seek(0)
            return client_log.read()[-3000:]

        deadline = time.monotonic() + JOB_WAIT_S
        while not os.path.exists(result):
            check(client.poll() is None and time.monotonic() < deadline,
                  f"the thin client ended ({client.poll()}) or is late "
                  f"without a result:\n{client_tail()}")
            time.sleep(0.05)
        with open(result) as f:
            res = json.load(f)
        held = _off_cuda(res["pid"])
        with open(gate, "w") as f:
            f.write("open")
        check(client.wait(timeout=120) == 0,
              f"the thin client exited {client.returncode}:\n"
              f"{client_tail()}")
        pins = {"objects": len(srv._refs), "actors": len(srv._actors)}
        out["client_release_s"] = _gpu_free(rt, JOB_FREE_S)
        counts = res["counts"]
        out["client"] = {
            "first_request_s": res["latency_s"][0],
            "later_p50_s": float(np.median(res["latency_s"][1:])),
            "in_process_first_s": local_latency_s[0],
            "in_process_later_p50_s": float(np.median(local_latency_s[1:])),
            "actor_ready_s": res["actor_ready_s"],
            "b1_launches": counts["b1_launches"],
            "prefills": counts["prefills"], "pins_after_exit": pins,
            "release_s": out["client_release_s"],
            "libcuda": held["libcuda"],
            "leg_s": time.perf_counter() - t_leg}
        c = out["client"]
        log("transports", f"(a) thin client (CUDA_VISIBLE_DEVICES="
            f"{held['cuda_visible_devices']!r}, libcuda mapped: "
            f"{held['libcuda']}, modules {res['modules']}): actor ready in "
            f"{c['actor_ready_s']:.1f} s, first request "
            f"{1e3 * c['first_request_s']:.1f} ms (in process "
            f"{1e3 * c['in_process_first_s']:.1f}), later p50 "
            f"{1e3 * c['later_p50_s']:.1f} ms (in process "
            f"{1e3 * c['in_process_later_p50_s']:.1f}); B1 "
            f"{c['b1_launches']} for {c['prefills']} prefills; server pins "
            f"after the client: {pins}; the GPU back "
            f"{c['release_s']:.2f} s after; {card}")
        check(res["tokens"] == local_tokens,
              "the thin client's tokens differ from 6l's in-process ones")
        check(counts["prefills"] == len(reqs) and (
            counts["b1_launches"] == b1_per_pass or rehearsal),
              f"B1 in the thin client's actor: {counts}, want "
              f"{b1_per_pass}")
        check(not held["libcuda"] and held["cuda_visible_devices"] == ""
              and res["cuda_visible_devices"] == ""
              and res["modules"] == [],
              f"the thin client holds or loads CUDA: {held}, "
              f"{res['modules']}")
        check(pins == {"objects": 0, "actors": 0},
              f"the server still pins for the client: {pins}")

        # --- (b) the compiled DAG ------------------------------------------
        t_leg = time.perf_counter()
        # The GPU stage is (a)'s actor class, shipped by value.
        sys.path.insert(0, tmp)
        import jobhelper
        sys.path.remove(tmp)
        cloudpickle.register_pickle_by_value(jobhelper)
        Tok, Detok = _transport_classes(rt)
        t0 = time.perf_counter()
        tok, serve, det = (Tok.remote(), jobhelper.JobServer.remote(
            JOB_MODEL, JOB_LAYERS, 0, ENGINE, JOB_DEVICE), Detok.remote())
        serve_pid = rt.get(serve.info.remote(), timeout=JOB_WAIT_S)["pid"]
        dag_ready_s = time.perf_counter() - t0
        with InputNode() as inp:
            dag = det.decode.bind(serve.serve.bind(tok.encode.bind(inp)))
        hop = {"prompt": reqs[0]["prompt"][:XPORT_HOP_PROMPT],
               "max_tokens": 1}

        def one_pass(run):
            rt.get(serve.reset_counts.remote(), timeout=60)
            tokens = [run(r)["tokens"] for r in reqs]
            return tokens, rt.get(serve.counts.remote(), timeout=60)

        def hop_p50(run):
            """The p50 wall of a one-token execution, and its tokens."""
            walls, tokens = [], set()
            for _ in range(XPORT_HOP_RUNS):
                t = time.perf_counter()
                tokens.add(tuple(run(hop)["tokens"]))
                walls.append(time.perf_counter() - t)
            return float(np.median(walls)), tokens

        def interp(r):
            return rt.get(dag.execute(r), timeout=JOB_WAIT_S)

        i_tokens, i_counts = one_pass(interp)
        i_hop, i_hop_tokens = hop_p50(interp)
        # One compiled DAG for a pass of the requests, whose teardown
        # frees the actor for the count; a second for the hop timing and
        # a stage that raises, then an execution after it.
        rt.get(serve.reset_counts.remote(), timeout=60)
        compiled = dag.experimental_compile()
        try:
            c_tokens = [compiled.execute(r).get(timeout=JOB_WAIT_S)["tokens"]
                        for r in reqs]
        finally:
            c_stages = compiled.teardown()
        c_counts = rt.get(serve.counts.remote(), timeout=60)
        compiled = dag.experimental_compile()
        try:
            c_hop, c_hop_tokens = hop_p50(
                lambda r: compiled.execute(r).get(timeout=JOB_WAIT_S))
            raised = None
            try:
                compiled.execute({"max_tokens": 1}).get(timeout=JOB_WAIT_S)
            except ValueError as e:
                raised = str(e)
            after = compiled.execute(hop).get(timeout=JOB_WAIT_S)
        finally:
            t_stages = compiled.teardown()
        answered = rt.get(serve.info.remote(), timeout=60)["pid"] == serve_pid
        for a in (tok, serve, det):
            rt.kill(a)
        out["dag"] = {
            "interpreted_hop_p50_ms": 1e3 * i_hop,
            "compiled_hop_p50_ms": 1e3 * c_hop,
            "b1_launches": {"interpreted": i_counts["b1_launches"],
                            "compiled": c_counts["b1_launches"]},
            "stages": c_stages, "timing_stages": t_stages,
            "actors_ready_s": dag_ready_s,
            "leg_s": time.perf_counter() - t_leg}
        d = out["dag"]
        log("transports", f"(b) DAG tokenize -> serve (pid {serve_pid}) -> "
            f"detokenize: actors ready in {dag_ready_s:.1f} s; tokens equal "
            f"to 6l's interpreted {i_tokens == local_tokens}, compiled "
            f"{c_tokens == local_tokens}; B1 a pass {d['b1_launches']}; "
            f"teardown {c_stages}; a one-token execution's p50 compiled "
            f"{d['compiled_hop_p50_ms']:.2f} ms, interpreted "
            f"{d['interpreted_hop_p50_ms']:.2f} ms "
            f"({XPORT_HOP_RUNS} each; prompt {XPORT_HOP_PROMPT} tokens); "
            f"the raising stage: {raised!r}; {card}")
        check(i_tokens == local_tokens and c_tokens == local_tokens,
              "the DAG's tokens differ from 6l's in-process ones")
        check(i_counts["prefills"] == len(reqs)
              and c_counts["prefills"] == len(reqs)
              and (rehearsal or i_counts["b1_launches"] == b1_per_pass
                   == c_counts["b1_launches"]),
              f"B1 in the DAG's GPU actor: {i_counts}, {c_counts}, want "
              f"{b1_per_pass} a pass")
        check(c_stages == [{"iterations": len(reqs)}] * 3
              and t_stages == [{"iterations": XPORT_HOP_RUNS + 2}] * 3,
              f"teardown: {c_stages}, {t_stages}")
        check(answered, "the GPU actor did not answer after teardown")
        check(i_hop_tokens == c_hop_tokens == {tuple(after["tokens"])}
              and len(after["tokens"]) == 1,
              f"one-token executions: interpreted {i_hop_tokens}, compiled "
              f"{c_hop_tokens}, after the error {after}")
        check(raised is not None and "without a prompt" in raised,
              f"the raising stage came back as {raised!r}")
        out["dag_release_s"] = _gpu_free(rt, JOB_FREE_S)

        # --- (c) the C++ frontend ------------------------------------------
        t_leg = time.perf_counter()
        made = make.communicate(timeout=600)[0]
        out["cpp_build_s"] = time.perf_counter() - t_make
        check(make.returncode == 0, f"make of cpp/ failed: {made[-3000:]}")
        _xport_fixtures(os.path.join(cpp_out, "libtasks.so"))
        demo = subprocess.run(
            [os.path.join(cpp_out, "xlang_demo"), str(srv.port),
             "with_cpp_tasks"], capture_output=True, text=True, timeout=300)
        lines = [ln for ln in demo.stdout.splitlines() if ln.strip()]
        out["cpp"] = {"lines": len(lines),
                      "passed": sum(ln.startswith("PASS") for ln in lines),
                      "leg_s": time.perf_counter() - t_leg}
        log("transports", f"(c) cpp/'s xlang_demo (built in "
            f"{out['cpp_build_s']:.1f} s, beside (a) and (b)): exit "
            f"{demo.returncode}, {out['cpp']['passed']} of {len(lines)} "
            f"lines PASS")
        check(demo.returncode == 0 and len(lines) >= 14
              and all(ln.startswith("PASS") for ln in lines)
              and all(any(p in ln for ln in lines)
                      for p in XPORT_CPP_PROBES),
              f"xlang_demo exited {demo.returncode}:\n{demo.stdout}\n"
              f"{demo.stderr[-3000:]}")

        # --- (d) the workflow ----------------------------------------------
        t_leg = time.perf_counter()
        marks = os.path.join(tmp, "marks")
        os.makedirs(marks)
        workflow.init(os.path.join(tmp, "wf"))
        wf_id = "transports"
        status_path = os.path.join(tmp, "wf", wf_id, "status.json")
        wf = workflow.step(_wf_finish).step(
            workflow.step(_wf_attend).options(num_gpus=1).step(
                workflow.step(_wf_inputs).step(0), marks, JOB_DEVICE),
            marks, status_path)
        try:
            wf.run(wf_id)
            first_error = None
        except Exception as e:        # the last step's planned failure
            first_error = str(e)
        after_run = workflow.get_status(wf_id)
        with open(os.path.join(marks, "ok"), "w") as f:
            f.write("ok")
        result = workflow.resume(wf_id)
        after_resume = workflow.get_status(wf_id)
        with open(os.path.join(marks, "finish_statuses")) as f:
            seen = f.read().split()
        runs = []
        for name in sorted(os.listdir(marks)):
            if name.startswith("attend_"):
                with open(os.path.join(marks, name)) as f:
                    runs.append(json.load(f))
        direct_marks = os.path.join(tmp, "direct")
        os.makedirs(direct_marks)
        with open(os.path.join(direct_marks, "ok"), "w") as f:
            f.write("ok")
        direct = _wf_finish(_wf_attend(_wf_inputs(0), direct_marks,
                                       JOB_DEVICE or dev),
                            direct_marks, status_path)
        wf_b1 = sum(r["launches"] for r in runs)
        out["workflow"] = {"statuses": [seen[0], after_run, seen[-1],
                                        after_resume],
                           "gpu_step_runs": len(runs), "b1_launches": wf_b1,
                           "leg_s": time.perf_counter() - t_leg}
        log("transports", f"(d) workflow: the last step raised "
            f"{(first_error or '').splitlines()[:1]}; statuses "
            f"{out['workflow']['statuses']}; the GPU step ran {len(runs)} "
            f"time(s) (lease "
            f"{[r['cuda_visible_devices'] for r in runs]}), B1 {wf_b1} "
            f"across run and resume; output equal to a direct call: "
            f"{torch.equal(result['o'], direct['o'])}; {card}")
        check(first_error is not None and "first run" in first_error,
              f"the workflow's first run: {first_error!r}")
        check(out["workflow"]["statuses"] == ["RUNNING", "FAILED",
                                              "RUNNING", "SUCCEEDED"]
              and seen == ["RUNNING", "RUNNING"],
              f"workflow statuses: {out['workflow']['statuses']}, seen by "
              f"the last step {seen}")
        check(len(runs) == 1 and (wf_b1 == 1 or rehearsal),
              f"the GPU step's runs: {runs}")
        check(torch.equal(result["o"], direct["o"])
              and result["checksum"] == direct["checksum"]
              and workflow.get_output(wf_id)["checksum"]
              == direct["checksum"],
              "the workflow's output differs from a direct call")
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait()
        if client_log is not None:
            client_log.close()
        if srv is not None:
            srv.stop()
        if make.poll() is None:
            make.kill()
            make.wait()
        # The channels' resource tracker is this process's own helper
        # (it unlinks what a crash would leave) and ends with it.
        procs = {p: c for p, c in _cluster_pids().items()
                 if "multiprocessing.resource_tracker" not in " ".join(c)}
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.monotonic() + 30
    while True:
        left = {p: c for p, c in procs.items() if _alive(p, c)}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"processes left after shutdown: {left}")
    out["b1_launches"] = (out["client"]["b1_launches"]
                          + sum(out["dag"]["b1_launches"].values())
                          + out["workflow"]["b1_launches"])
    out["phase_s"] = time.perf_counter() - phase_t0
    log("time", f"transports: (a) {out['client']['leg_s']:.1f} s, (b) "
        f"{out['dag']['leg_s']:.1f} s, (c) {out['cpp']['leg_s']:.1f} s "
        f"(make {out['cpp_build_s']:.1f} s in the background), (d) "
        f"{out['workflow']['leg_s']:.1f} s, the phase {out['phase_s']:.1f} "
        f"s; {card}")
    return out


# 6n: the autoscaler -- `python -m ray_tpu_torch up` of a cluster whose
# head has no GPU; a GPU actor's demand launches a GPU node on the card,
# which serves 6l's model on 6l's requests and goes once the actor does.
AUTOSCALE_IDLE_MIN = 0.1         # the GPU node type's idle timeout (6 s)
# The head's lease deadline, below the GPU node's join (5.9-6.2 s on the
# H100 machine): the actor must wait past it while the monitor reads its
# demand, and serve.
AUTOSCALE_LEASE_MS = 3000
AUTOSCALE_DOWN_S = 60.0          # the actor's kill to the node's end
AUTOSCALE_YAML = """cluster_name: {name}
max_workers: 1
provider:
  type: subprocess
available_node_types:
  cpu.head:
    resources: {{CPU: 8}}
  gpu.h100:
    node_config: {{gpu: H100-1}}
    min_workers: 0
    max_workers: 1
head_node_type: cpu.head
idle_timeout_minutes: {idle}
"""
_MONITOR_LINE = re.compile(
    r"autoscaler: launched (\d+) terminated (\d+) at ([0-9.]+)")


def _monitor_events(lines, launched):
    """(count, wall time) of each pass the monitor printed that launched
    (or, with ``launched`` false, terminated) nodes."""
    out = []
    for line in list(lines):
        m = _MONITOR_LINE.match(line)
        if m and int(m.group(1 if launched else 2)):
            out.append((int(m.group(1 if launched else 2)),
                        float(m.group(3))))
    return out


def _session_pids(session_dir):
    """Live processes whose command line names ``session_dir``."""
    out = subprocess.run(["pgrep", "-f", session_dir], capture_output=True,
                         text=True, timeout=60)
    return {int(p) for p in out.stdout.split()
            if _alive(int(p), _cmdline(int(p)))}


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return [a.decode() for a in f.read().split(b"\0") if a]
    except OSError:
        return None


def phase_autoscaler(dev, card, local_tokens):
    """The autoscaler on the port; see the module docstring (6n)."""
    import shutil

    import cloudpickle

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.util import state

    phase_t0 = time.perf_counter()
    out = {"card": card}
    rehearsal = JOB_DEVICE is not None
    cfg = getattr(LlamaConfig, JOB_MODEL["preset"])(
        n_layers=JOB_LAYERS, attn_impl=JOB_MODEL["attn_impl"],
        param_dtype=torch.bfloat16)
    reqs = serve_requests(cfg)[:JOB_REQUESTS]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autoscaler_")
    yaml_path = os.path.join(tmp, "cluster.yaml")
    with open(yaml_path, "w") as f:
        f.write(AUTOSCALE_YAML.format(name=f"smoke-{os.getpid()}",
                                      idle=AUTOSCALE_IDLE_MIN))
    with open(os.path.join(tmp, "jobhelper.py"), "w") as f:
        f.write(JOB_HELPER)
    root = os.path.dirname(os.path.abspath(__file__))
    # The launcher's state file and the session go under the phase's dir.
    env = {**os.environ, "TMPDIR": tmp, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]),
           "RAY_TPU_worker_lease_timeout_ms": str(AUTOSCALE_LEASE_MS)}
    mem0 = 0.0 if rehearsal else gpu_memory_used_mib()
    lines, session, actor, driver = [], None, None, False

    def read():
        for line in up.stdout:
            lines.append(line)

    t0 = time.perf_counter()
    up = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", "up",
                           yaml_path], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, env=env)
    threading.Thread(target=read, daemon=True).start()

    def tail():
        return "".join(lines)[-3000:]

    try:
        deadline = time.monotonic() + JOB_WAIT_S
        while not any(ln.startswith("session dir:") for ln in list(lines)):
            check(up.poll() is None and time.monotonic() < deadline,
                  f"`up` exited ({up.poll()}) or is late:\n{tail()}")
            time.sleep(0.05)
        text = "".join(lines)
        addr = text.split("address:")[1].split()[0]
        session = text.split("session dir:")[1].split()[0]
        out["up_s"] = time.perf_counter() - t0
        rt.init(address=addr)
        driver = True
        heads = rt.nodes()
        check(len(heads) == 1 and "GPU" not in rt.cluster_resources(),
              f"the cluster `up` started: {heads}")
        head_id = heads[0]["NodeID"]
        log("autoscaler", f"`python -m ray_tpu_torch up` gave {addr} in "
            f"{out['up_s']:.2f} s: one node, {rt.cluster_resources()}")

        # --- the demand, the launch, the join, the actor -----------------
        sys.modules.pop("jobhelper", None)
        sys.path.insert(0, tmp)
        import jobhelper
        sys.path.remove(tmp)
        cloudpickle.register_pickle_by_value(jobhelper)
        t_demand, tp = time.time(), time.perf_counter()
        actor = jobhelper.JobServer.remote(JOB_MODEL, JOB_LAYERS, 0, ENGINE,
                                           JOB_DEVICE)
        ref = actor.info.remote()
        join_s = None
        while not rt.wait([ref], timeout=0.05)[0]:
            if join_s is None and any(
                    n["Alive"] and n["Labels"].get("autoscaler-node-type")
                    == "gpu.h100" for n in rt.nodes()):
                join_s = time.perf_counter() - tp
            check(up.poll() is None and time.perf_counter() - tp < JOB_WAIT_S,
                  f"no actor after {time.perf_counter() - tp:.0f} s "
                  f"(`up` {up.poll()}):\n{tail()}")
        info = rt.get(ref, timeout=60)
        out["actor_ready_s"] = time.perf_counter() - tp
        launches = _monitor_events(lines, True)
        gpu_nodes = [n for n in rt.nodes()
                     if n["Labels"].get("autoscaler-node-type") == "gpu.h100"]
        row = next(a for a in state.list_actors()
                   if a["actor_id"] == actor._actor_id.hex())
        check(sum(n for n, _ in launches) == 1 and len(gpu_nodes) == 1
              and row["node_id"] == gpu_nodes[0]["NodeID"] != head_id,
              f"launches {launches}, GPU nodes {gpu_nodes}, the actor on "
              f"{row['node_id']}:\n{tail()}")
        node = gpu_nodes[0]
        check(node["Resources"].get("GPU") == 1
              and node["Resources"].get("GPU-H100", 1) == 1,
              f"the GPU node's resources: {node['Resources']}")
        out["demand_to_launch_s"] = launches[0][1] - t_demand
        out["demand_to_join_s"] = join_s if join_s is not None else \
            out["actor_ready_s"]
        # The actor outlived its lease deadline waiting for the node: one
        # ACTOR_PENDING warning names it (none if the node beat it).
        pending = [e for e in state.list_cluster_events(
            event_type="ACTOR_PENDING")
            if e.get("actor_id") == actor._actor_id.hex()]
        out["lease_timeout_ms"] = AUTOSCALE_LEASE_MS
        out["actor_pending_events"] = len(pending)
        waited = out["demand_to_join_s"] > AUTOSCALE_LEASE_MS / 1e3 + 0.5
        log("autoscaler", f"lease deadline {AUTOSCALE_LEASE_MS} ms, the "
            f"node joined {out['demand_to_join_s']:.2f} s after the demand:"
            f" ACTOR_PENDING events for the actor {len(pending)}")
        check(len(pending) <= 1 and (len(pending) == 1 or not waited),
              f"the actor waited past its deadline ({waited}) with "
              f"ACTOR_PENDING events {pending}")
        log("autoscaler", f"demand to launch {out['demand_to_launch_s']:.2f}"
            f" s, to the join {out['demand_to_join_s']:.2f} s, to the actor "
            f"ready {out['actor_ready_s']:.2f} s (server built in "
            f"{info['build_s']:.2f} s) on node {node['NodeID'][:12]} "
            f"({node['Resources'].get('GPU')} GPU, labels {node['Labels']})")

        # --- the requests ---------------------------------------------------
        rt.get(actor.reset_counts.remote(), timeout=60)
        results, latency = [], []
        for r in reqs:
            t = time.perf_counter()
            results.append(rt.get(actor.serve.remote(r), timeout=JOB_WAIT_S))
            latency.append(time.perf_counter() - t)
        counts = rt.get(actor.counts.remote(), timeout=60)
        tokens = [r["tokens"] for r in results]
        out["first_request_s"] = latency[0]
        out["later_p50_s"] = float(np.median(latency[1:]))
        out["b1_launches"] = counts["b1_launches"]
        same = sum(a == b for a, b in zip(tokens, local_tokens))
        out["tokens_equal"] = f"{same}/{len(reqs)}"
        procs = _cluster_pids()
        head = {"monitor": up.pid}
        for pid, cmd in procs.items():
            if "ray_tpu_torch._private.gcs_server" in cmd:
                head["head GCS"] = pid
            elif ("ray_tpu_torch._private.raylet" in cmd
                  and cmd[cmd.index("--node-id") + 1] == head_id):
                head["head raylet"] = pid
        check(len(head) == 3, f"the head's processes: {head}")
        if not rehearsal:
            held = {name: _off_cuda(pid) for name, pid in head.items()}
            actor_held = _off_cuda(info["pid"])
            log("autoscaler", f"while the actor holds the card: {held}; "
                f"the actor: {actor_held}, {info['cuda_bytes']} B "
                f"allocated by torch")
            for name, h in held.items():
                check(not h["listed"] and not h["libcuda"],
                      f"the {name} holds the card: {h}")
            check(actor_held["libcuda"] and info["cuda_bytes"] > 0,
                  f"the actor holds no CUDA context: {actor_held}, {info}")
        check(info["foreign_modules"] == [],
              f"the actor loaded {info['foreign_modules']}")
        log("autoscaler", f"the actor served {len(reqs)} requests: first "
            f"{1e3 * out['first_request_s']:.1f} ms, later p50 "
            f"{1e3 * out['later_p50_s']:.1f} ms; B1 {counts['b1_launches']}"
            f" for {counts['prefills']} prefills; greedy tokens, autoscaled "
            f"actor == 6l's in-process server: {out['tokens_equal']}; {card}")
        check(same == len(reqs), f"the autoscaled actor's tokens differ from "
              f"6l's in-process server's: {out['tokens_equal']}")
        check(counts["prefills"] == len(reqs) and (
            counts["b1_launches"] == cfg.n_layers * len(reqs) or rehearsal),
              f"B1 in the autoscaled actor: {counts}, want {cfg.n_layers} x "
              f"{len(reqs)}")

        # --- the scale-down -----------------------------------------------
        t_kill, tk = time.time(), time.perf_counter()
        rt.kill(actor)
        actor = None
        while True:
            ended = _monitor_events(lines, False)
            if ended and "GPU" not in rt.cluster_resources():
                break
            check(time.perf_counter() - tk < AUTOSCALE_DOWN_S,
                  f"{AUTOSCALE_DOWN_S:.0f} s after the kill: terminations "
                  f"{ended}, {rt.cluster_resources()}:\n{tail()}")
            time.sleep(0.1)
        out["kill_to_terminated_s"] = ended[0][1] - t_kill
        out["kill_to_gpu_gone_s"] = time.perf_counter() - tk
        left = max(1.0, AUTOSCALE_DOWN_S - (time.perf_counter() - tk))
        if rehearsal:
            released = _gone(info["pid"], left)
        else:
            released = _card_released(info["pid"], mem0, left)
            listed = _compute_app_pids() & _session_pids(session)
            check(not listed, f"session processes on the card: {listed}")
        out["kill_to_card_free_s"] = time.perf_counter() - tk
        alive = [n for n in rt.nodes()
                 if n["NodeID"] == node["NodeID"] and n["Alive"]]
        log("autoscaler", f"the actor killed: the node terminated "
            f"{out['kill_to_terminated_s']:.2f} s after (the monitor's "
            f"line), GPU out of cluster_resources() after "
            f"{out['kill_to_gpu_gone_s']:.2f} s, the actor's process gone "
            f"and the card's memory back: {released} "
            f"({out['kill_to_card_free_s']:.2f} s); the node alive in the "
            f"GCS: {bool(alive)}; {card}")
        check(released and not alive and
              out["kill_to_card_free_s"] <= AUTOSCALE_DOWN_S,
              "the GPU node or its card was not freed within "
              f"{AUTOSCALE_DOWN_S:.0f} s of the kill")

        # --- down ----------------------------------------------------------
        rt.shutdown()
        driver = False
        td = time.perf_counter()
        down = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "down",
                               yaml_path], capture_output=True, text=True,
                              timeout=180, env=env)
        check(down.returncode == 0, f"`down` exited {down.returncode}: "
              f"{down.stdout}{down.stderr}")
        check(up.wait(timeout=60) == 0,
              f"`up` exited {up.returncode}:\n{tail()}")
        deadline = time.monotonic() + 15
        while _session_pids(session) and time.monotonic() < deadline:
            time.sleep(0.2)
        rest = {p: _cmdline(p) for p in _session_pids(session)}
        out["down_s"] = time.perf_counter() - td
        log("autoscaler", f"`python -m ray_tpu_torch down` in "
            f"{out['down_s']:.2f} s; processes of the session left: {rest}")
        check(not rest, f"processes of the session left after down: {rest}")
    finally:
        try:
            if actor is not None:
                rt.kill(actor)
        finally:
            if driver:
                rt.shutdown()
            if up.poll() is None:
                up.terminate()
                try:
                    up.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    up.kill()
                    up.wait()
            if session:
                subprocess.run(["pkill", "-9", "-f", session],
                               capture_output=True, timeout=60)
            shutil.rmtree(tmp, ignore_errors=True)
    if not rehearsal:
        gc.collect()
        torch.cuda.empty_cache()
        out["memory_before_mib"] = mem0
        out["memory_after_mib"] = gpu_memory_used_mib()
        check(abs(out["memory_after_mib"] - mem0) < 1024,
              f"card memory {mem0:.0f} MiB before the phase, "
              f"{out['memory_after_mib']:.0f} MiB after")
    out["phase_s"] = time.perf_counter() - phase_t0
    log("time", f"autoscaler: demand to launch "
        f"{out['demand_to_launch_s']:.2f} s, to the join "
        f"{out['demand_to_join_s']:.2f} s, to the actor ready "
        f"{out['actor_ready_s']:.2f} s, first request "
        f"{1e3 * out['first_request_s']:.1f} ms, later p50 "
        f"{1e3 * out['later_p50_s']:.1f} ms, kill to scale-down "
        f"{out['kill_to_terminated_s']:.2f} s, the phase "
        f"{out['phase_s']:.1f} s; {card}")
    return out


# 6o: device observability -- a GPU actor serving the serve phase's model
# inside a torch.profiler bracket, its programs in the GCS ring, its HBM
# gauges on /metrics, and a container task through a stand-in runtime.
DEVICE_OBS_PROFILE_S = 3.0       # util.state.tpu_profile's window
DEVICE_OBS_IMAGE = "rtpu-standin:latest"
DEVICE_OBS_HBM_TOL = 0.05        # the gauge against the allocator
DEVICE_OBS_DEVICE = None         # the lease's card (a CPU rehearsal: "cpu")
# A stand-in for a container runtime (the card's machine has none): it
# records its arguments, drops ``run ... <image>``, applies the ``-e``
# flags to the environment as a container would, and execs the rest with
# this interpreter as the image's ``python3``.
DEVICE_OBS_STANDIN = """#!{python}
import json, os, sys
args = sys.argv[1:]
with open(os.environ["RTPU_STANDIN_LOG"], "a") as f:
    f.write(json.dumps(sys.argv) + "\\n")
image = args.index({image!r})
env = dict(os.environ)
i = 1
while i < image:
    if args[i] == "-e":
        key, _, value = args[i + 1].partition("=")
        env[key] = value
        i += 2
    elif args[i] in ("-v", "--gpus"):
        i += 2
    else:
        i += 1
cmd = args[image + 1:]
if cmd[0] == "python3":
    cmd[0] = sys.executable
os.execve(cmd[0], cmd, env)
"""


def _device_obs_classes(rt):
    @rt.remote(num_gpus=1)
    class ProgramServer:
        """``LLMServer`` at the serve phase's config on the leased card,
        with probes of its own process."""

        def __init__(self, cfg, engine, device):
            from ray_tpu_torch.serve.llm import LLMServer

            self.server = LLMServer(cfg, dict(engine), init_seed=0,
                                    quantize="int8", device=device)
            self.cuda = device is None

        def serve(self, request):
            return self.server(request)

        def pid(self):
            return os.getpid()

        def b1_launches(self):
            from ray_tpu_torch.ops import attention

            return attention.flash_fwd_cuda.launches

        def bracket_open(self):
            from ray_tpu_torch.observability import profiling

            return profiling.window_open.is_set()

        def markers(self):
            """Spin kernels ahead of the profiled request: the profiler
            loses a window's first device records (see profile_window)."""
            for _ in range(MARKER_LAUNCHES if self.cuda else 0):
                torch.cuda._sleep(1)
            if self.cuda:
                torch.cuda.synchronize()
            return MARKER_LAUNCHES

        def memory(self):
            """Flush this process's metrics (the device sampler runs
            first), then read what the gauges were set from."""
            from ray_tpu_torch.util import metrics

            if not self.cuda:
                return {"flushed": metrics.flush()}
            torch.cuda.synchronize()
            flushed = metrics.flush()
            return {"flushed": flushed,
                    "allocated": torch.cuda.memory_allocated(),
                    "total": torch.cuda.mem_get_info()[1]}

    @rt.remote(num_gpus=1, runtime_env={"container": {
        "image": DEVICE_OBS_IMAGE, "run_options": ["--gpus", "all"]}})
    def b1_in_container(device):
        """B1 once at (1, 512, 32, 128) bf16 causal in a container worker,
        against its plain version (a CPU rehearsal: the plain version
        twice)."""
        import ray_tpu_torch
        from ray_tpu_torch.ops import attention

        dev = device or "cuda"
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn((1, 512, N_HEADS, HEAD_DIM), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        kernel = (attention.flash_attention_plain if device
                  else attention.flash_fwd_cuda)
        got, _ = kernel(q, k, v, True)
        want, _ = attention.flash_attention_plain(q, k, v, True)
        diff = (got.float() - want.float()).abs()
        used = (diff / (TOL_O_BF16_ABS + TOL_O_BF16_REL
                        * want.float().abs())).max().item()
        return {"max_abs_err": diff.max().item(), "tol_used": used,
                "launches": attention.flash_fwd_cuda.launches,
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                "gpu_ids": ray_tpu_torch.get_gpu_ids(), "pid": os.getpid()}

    return ProgramServer, b1_in_container


def _hbm_gauge(text, pid):
    """The device_hbm_{used,total}_bytes of process ``pid`` in a
    Prometheus text."""
    out = {}
    for line in text.splitlines():
        for key in ("used", "total"):
            if line.startswith(f"rtpu_device_hbm_{key}_bytes{{") \
                    and f'pid="{pid}@' in line:
                out[key] = float(line.rsplit(" ", 1)[1])
    return out


def phase_device_obs(dev, card):
    """6o, on a cluster: see the module docstring."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch.observability import profiling
    from ray_tpu_torch.util import state

    phase_t0 = time.perf_counter()
    out = {"card": card}
    rehearsal = DEVICE_OBS_DEVICE is not None
    cfg = serve_config()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_device_obs_")
    standin, standin_log = (os.path.join(tmp, "runtime"),
                            os.path.join(tmp, "calls.jsonl"))
    with open(standin, "w") as f:
        f.write(DEVICE_OBS_STANDIN.format(python=sys.executable,
                                          image=DEVICE_OBS_IMAGE))
    os.chmod(standin, 0o755)
    # The node's processes take these from their start.
    env = {"RAY_TPU_CONTAINER_RUNTIME": standin,
           "RTPU_STANDIN_LOG": standin_log,
           "RAY_TPU_tpu_profile_dir": os.path.join(tmp, "traces")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    mem0 = 0.0 if rehearsal else gpu_memory_used_mib()
    actor = None
    try:
        info = rt.init(num_cpus=8, num_gpus=1, include_dashboard=True)
        base = info["dashboard_url"]
        ProgramServer, b1_in_container = _device_obs_classes(rt)
        t0 = time.perf_counter()
        actor = ProgramServer.remote(cfg, ENGINE, DEVICE_OBS_DEVICE)
        pid = rt.get(actor.pid.remote(), timeout=JOB_WAIT_S)
        aid = actor._actor_id.hex()
        reqs = serve_requests(cfg)[:3]
        for r in reqs[:2]:
            rt.get(actor.serve.remote(r), timeout=JOB_WAIT_S)
        out["actor_ready_and_two_requests_s"] = time.perf_counter() - t0
        launches0 = rt.get(actor.b1_launches.remote(), timeout=60)

        # --- one request wholly inside a device-trace window --------------
        box = {}

        def bracket():
            box.update(state.tpu_profile(actor_id=aid,
                                         duration=DEVICE_OBS_PROFILE_S))

        th = threading.Thread(target=bracket, daemon=True)
        tb = time.perf_counter()
        th.start()
        while not rt.get(actor.bracket_open.remote(), timeout=60):
            if rehearsal and not th.is_alive():
                break                       # skipped: no context
            check(time.perf_counter() - tb < 60 and th.is_alive(),
                  f"the bracket never opened: {box}")
            time.sleep(0.02)
        t_open = time.perf_counter()
        time.sleep(0.5)
        rt.get(actor.markers.remote(), timeout=60)
        b0 = rt.get(actor.b1_launches.remote(), timeout=60)
        profiled = {"prompt": reqs[2]["prompt"][:200], "max_tokens": 8}
        res = rt.get(actor.serve.remote(profiled), timeout=60)
        b1 = rt.get(actor.b1_launches.remote(), timeout=60)
        inside_s = time.perf_counter() - t_open
        th.join(DEVICE_OBS_PROFILE_S + 120)
        if rehearsal:
            # No CUDA context in the actor: the bracket skips, and the
            # trace gates below count the plain version's launches (0).
            check("skipped" in box, f"tpu_profile replied {box}")
            box = {"artifact": os.path.join(tmp, "empty.json"),
                   "kernel_events": 0}
            with open(box["artifact"], "w") as f:
                f.write('{"traceEvents": [{"ph": "X", "cat": "kernel", '
                        f'"name": "{MARKER_KERNEL}"}}]}}')
        check(not th.is_alive() and "artifact" in box,
              f"tpu_profile replied {box}")
        events = profiling.trace_kernel_events(box["artifact"], "flash_fwd")
        markers = profiling.trace_kernel_events(box["artifact"],
                                                MARKER_KERNEL)
        out["profile"] = {"artifact_bytes": os.path.getsize(box["artifact"]),
                          "kernel_events": box["kernel_events"],
                          "primed_s": box.get("primed_s"),
                          "b1_events": len(events),
                          "b1_launches": b1 - b0,
                          "marker_events": len(markers),
                          "request_end_s_into_window": inside_s,
                          "bracket_s": time.perf_counter() - tb}
        log("device_obs", f"tpu_profile of the actor ({DEVICE_OBS_PROFILE_S}"
            f" s, CUPTI primed in {box.get('primed_s') or 0:.2f} s): "
            f"{box['kernel_events']} kernel events, {len(markers)} of "
            f"{MARKER_LAUNCHES} markers, B1 {len(events)} traced for "
            f"{b1 - b0} launched by the profiled request (ended "
            f"{inside_s:.2f} s after the bracket opened); {card}")
        check(res["num_tokens"] == 8
              and b1 - b0 == (0 if rehearsal else cfg.n_layers),
              f"the profiled request: {res['num_tokens']} tokens, B1 "
              f"{b1 - b0}")
        check(inside_s < DEVICE_OBS_PROFILE_S and markers
              and len(events) == b1 - b0,
              f"the trace holds {len(events)} B1 events for {b1 - b0} "
              f"launches ({len(markers)} markers, the request ended "
              f"{inside_s:.2f} s into the window)")
        rt.get(actor.serve.remote(reqs[0]), timeout=JOB_WAIT_S)
        out["b1_launches"] = rt.get(actor.b1_launches.remote(), timeout=60)

        # --- the actor's programs in the GCS ring and /api/programs --------
        summary = state.xla_summary()
        mine = {fn: [r for r in state.list_xla_programs(fn=fn)
                     if r["pid"] == pid]
                for fn in ("llm_engine_tick", "llm_engine_insert")}
        api = _http_get(base, "/api/programs?fn=llm_engine_insert&limit=50")
        want = ("cpu", "cpu") if rehearsal else ("gpu", "h100")
        check(all(mine.values()) and all(
            (r["measurement"], r["spec"]) == want
            for rows in mine.values() for r in rows)
              and summary["measurements"].get(want[0], 0) >= 2
              and any(r["pid"] == pid for r in api["programs"]),
              f"the actor's programs in the ring: {mine}, summary "
              f"{summary['measurements']}, /api/programs "
              f"{[r['pid'] for r in api['programs']]}")
        out["programs"] = {"summary_programs": summary["programs"],
                           "measurements": summary["measurements"],
                           "verdicts": summary["verdicts"],
                           "actor_rows": {fn: len(rows)
                                          for fn, rows in mine.items()}}
        log("device_obs", f"xla_summary: {summary['programs']} programs, "
            f"measurements {summary['measurements']}, verdicts "
            f"{summary['verdicts']}; the actor's rows "
            f"{out['programs']['actor_rows']}, in /api/programs too")

        # --- the HBM gauges -------------------------------------------------
        mem = rt.get(actor.memory.remote(), timeout=60)
        gauge = _hbm_gauge(_http_get(base, "/metrics"), pid)
        if rehearsal:
            # No context, no gauges: the sampler reads nothing.
            check(mem["flushed"] and not gauge, f"gauges {gauge}")
            gauge = {"used": 1, "total": 1}
            mem = {"allocated": 1, "total": 1, "flushed": True}
        check(mem["flushed"] and set(gauge) == {"used", "total"},
              f"the actor's device gauges on /metrics: {gauge}, {mem}")
        out["hbm"] = {"gauge_used": gauge["used"],
                      "allocated": mem["allocated"],
                      "gauge_total": gauge["total"], "total": mem["total"]}
        log("device_obs", f"device_hbm_used_bytes {gauge['used']:.0f} "
            f"against the allocator's {mem['allocated']}, "
            f"device_hbm_total_bytes {gauge['total']:.0f} against "
            f"{mem['total']}; {card}")
        check(abs(gauge["used"] - mem["allocated"])
              <= DEVICE_OBS_HBM_TOL * mem["allocated"]
              and gauge["total"] == mem["total"],
              f"the gauges against the actor's allocator: {out['hbm']}")

        # --- the head holds no card ----------------------------------------
        head = {}
        for p, cmd in _cluster_pids().items():
            text = " ".join(cmd)
            for name, mod in (("GCS", "_private.gcs_server"),
                              ("raylet", "_private.raylet"),
                              ("dashboard", "dashboard.head")):
                if f"ray_tpu_torch.{mod}" in text:
                    head[name] = p
        check(set(head) == {"GCS", "raylet", "dashboard"},
              f"the head's processes: {head}")
        held = {name: _off_cuda(p) for name, p in head.items()}
        check(all(not h["libcuda"] and not h["listed"]
                  for h in held.values()),
              f"a head process holds the card: {held}")
        rt.kill(actor)
        actor = None
        out["gpu_free_s"] = _gpu_free(rt, 60)

        # --- a container task on the card -----------------------------------
        tc = time.perf_counter()
        got = rt.get(b1_in_container.remote(DEVICE_OBS_DEVICE),
                     timeout=JOB_WAIT_S)
        out["container_s"] = time.perf_counter() - tc
        with open(standin_log) as f:
            calls = [json.loads(line) for line in f]
        argv = next(c for c in calls if DEVICE_OBS_IMAGE in c)
        flags = [argv[i + 1] for i in range(len(argv) - 1)
                 if argv[i] == "-e"]
        out["container"] = dict(got, run_options=argv[6:8],
                                env_flags=sorted(f.split("=")[0]
                                                 for f in flags))
        log("device_obs", f"the container task: B1 max abs err "
            f"{got['max_abs_err']:.3g} ({got['tol_used']:.2f} of B1's bf16 "
            f"tolerance), {got['launches']} launch, CUDA_VISIBLE_DEVICES "
            f"{got['cuda_visible_devices']!r}; the runtime's argv "
            f"{argv[1:8]} ... {argv[argv.index(DEVICE_OBS_IMAGE):][:4]} in "
            f"{out['container_s']:.2f} s; {card}")
        check("CUDA_VISIBLE_DEVICES=0" in flags and argv[6:8] == [
            "--gpus", "all"] and got["cuda_visible_devices"] == "0"
              and got["launches"] == (0 if rehearsal else 1)
              and got["tol_used"] <= 1.0,
              f"the container task: {out['container']}, flags {flags}")
        for name, h in held.items():
            out.setdefault("head_libcuda", {})[name] = h["libcuda"]
    finally:
        try:
            if actor is not None:
                rt.kill(actor)
        finally:
            rt.shutdown()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            shutil.rmtree(tmp, ignore_errors=True)
    if not rehearsal:
        gc.collect()
        torch.cuda.empty_cache()
    out["memory_before_mib"] = mem0
    out["memory_after_mib"] = 0.0 if rehearsal else gpu_memory_used_mib()
    check(abs(out["memory_after_mib"] - mem0) < 1024,
          f"card memory {mem0:.0f} MiB before the phase, "
          f"{out['memory_after_mib']:.0f} MiB after")
    out["phase_s"] = time.perf_counter() - phase_t0
    log("time", f"device_obs: the actor and two requests "
        f"{out['actor_ready_and_two_requests_s']:.1f} s, the bracket "
        f"{out['profile']['bracket_s']:.1f} s, the container task "
        f"{out['container_s']:.1f} s, the phase {out['phase_s']:.1f} s; "
        f"{card}")
    return out


def serve_ab(tree: str) -> int:
    """``--serve-ab DIR``: the paged mix without its prompts over 512 on a
    dense server, then the whole mix on a paged server, each fresh and
    warmed, at Llama-3-8B full width and depth (int8, weights from seed
    0), with ``ray_tpu_torch`` imported from DIR (a checkout of another
    commit). Compares two commits on one card: run parent, change,
    change, parent, one process each, in one call. Prints one JSON
    line."""
    sys.path.insert(0, os.path.abspath(tree))
    import ray_tpu_torch
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.serve.llm import LLMServer

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    cfg = serve_config()
    params = init_params(cfg, 0, dev)
    mix = paged_mix(cfg.vocab_size)
    out = {"package": os.path.dirname(os.path.abspath(
        ray_tpu_torch.__file__)), "card": card}
    for name, engine, long_prompts in (("dense", ENGINE, False),
                                       ("paged", PAGED_ENGINE, True)):
        server = LLMServer(model_config=cfg, engine_config=dict(engine),
                           params_loader=lambda: params, device=dev)
        try:
            warm(server, cfg)
            res = run_mix(server, mix, f"serve-ab {name}", card,
                          long_prompts=long_prompts)
        finally:
            server.shutdown()
        out[name] = {k: v for k, v in res.items() if k != "results"}
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--serve-ab"] and len(sys.argv) == 3:
        return serve_ab(sys.argv[2])
    from ray_tpu_torch.models.llama import LlamaConfig

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    t_run = time.perf_counter()

    def lap(phase):
        """The wall time since the script started, after each phase."""
        log("time", f"{phase} done at {time.perf_counter() - t_run:.1f} s")

    log("env", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    built = phase_build()
    lap("build")
    ring_built = phase_ring_build(built)
    lap("ring_build")
    rows = phase_kernels(dev)
    lap("kernels")
    bwd_rows = phase_bwd_kernels(dev)
    lap("bwd_kernels")
    head_dims = phase_head_dims(dev)
    lap("head_dims")
    draft_b1 = phase_draft_b1(dev)
    lap("draft_b1")
    n_params = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS).num_params()
    group = ZERO_N * 128
    zero_rows = -(-n_params // group) * group // 128
    ring_rows = phase_ring_kernels(dev, card, zero_rows)
    lap("ring_kernels")
    q_params = LlamaConfig.llama3_8b(n_layers=QZERO_LAYERS).num_params()
    q_elems = -(-q_params // group) * group
    qring_rows = phase_qring_kernels(dev, card, q_elems)
    lap("qring_kernels")
    collective = phase_collective(dev, card, built, zero_rows, q_elems,
                                  ring_rows, qring_rows)
    lap("collective")
    gc.collect()
    torch.cuda.empty_cache()
    from ray_tpu_torch.models.llama import init_params

    # One weight tree (bf16, seed 0) behind the dense, paged and
    # speculative servers, one server at a time; each quantizes it to int8.
    serve_cfg = serve_config()
    serve_params = init_params(serve_cfg, 0, dev)
    mix = paged_mix(serve_cfg.vocab_size)
    (serve_launches, serve_profile, dense_mix, serve_tokens, serve_fig,
     serve_programs) = phase_serve(dev, serve_cfg, lambda: serve_params,
                                   mix, card)
    lap("serve")
    gc.collect()
    torch.cuda.empty_cache()
    paged = phase_paged_serve(dev, serve_cfg, lambda: serve_params, mix,
                              dense_mix, card)
    lap("paged_serve")
    gc.collect()
    torch.cuda.empty_cache()
    spec = phase_spec_serve(dev, serve_cfg, lambda: serve_params, mix, card)
    lap("spec_serve")
    gc.collect()
    torch.cuda.empty_cache()
    disagg = phase_disagg(dev, serve_cfg, lambda: serve_params, card)
    lap("disagg")
    del serve_params, dense_mix
    gc.collect()
    torch.cuda.empty_cache()
    paged_bitwise = phase_paged_bitwise(dev, card)
    lap("paged_bitwise")
    gc.collect()
    torch.cuda.empty_cache()
    paged_tokens = phase_paged_tokens(dev, card)
    lap("paged_tokens")
    gc.collect()
    torch.cuda.empty_cache()
    disagg_gates = phase_disagg_gates(dev, card)
    lap("disagg_gates")
    gc.collect()
    torch.cuda.empty_cache()
    runtime = phase_runtime(dev, card, serve_tokens)
    lap("runtime")
    gc.collect()
    torch.cuda.empty_cache()
    serve_app = phase_serve_app(dev, card, serve_tokens, serve_fig, runtime,
                                disagg.pop("monolithic_tokens"), disagg)
    lap("serve_app")
    ingress_b1 = serve_app["ingress"]["b1_launches"]
    app_b1 = serve_app["routed"]["b1_launches"] + \
        serve_app["spec"]["b1_launches"]
    print(json.dumps({"serve_app": serve_app}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(dev, card)
    lap("train")
    gc.collect()
    torch.cuda.empty_cache()
    c4_launches, zero_f32_err = phase_zero_f32(dev)
    lap("zero_f32")
    gc.collect()
    torch.cuda.empty_cache()
    zero = phase_zero_train(dev, card)
    lap("zero_train")
    mono, over = zero["monolithic"], zero["overlap"]
    gc.collect()
    torch.cuda.empty_cache()
    zq = phase_zero_quant(dev, card)
    lap("zero_quant")
    gc.collect()
    torch.cuda.empty_cache()
    trainer = phase_trainer(dev, card)
    lap("trainer")
    gc.collect()
    torch.cuda.empty_cache()
    gang = phase_zero_gang(dev, card, trainer)
    lap("zero_gang")
    gc.collect()
    torch.cuda.empty_cache()
    jobs = phase_jobs(dev, card)
    lap("jobs")
    gc.collect()
    torch.cuda.empty_cache()
    local_tokens = jobs.pop("local_tokens")
    transports = phase_transports(dev, card, local_tokens,
                                  jobs["local_latency_s"])
    lap("transports")
    gc.collect()
    torch.cuda.empty_cache()
    autoscaler = phase_autoscaler(dev, card, local_tokens)
    lap("autoscaler")
    gc.collect()
    torch.cuda.empty_cache()
    device_obs = phase_device_obs(dev, card)
    lap("device_obs")
    # Launches in the gangs' workers, every worker and route.
    gang_launches = {k: sum(row["launches_per_worker"][k] * n
                            for n, g in gang["gangs"].items()
                            for row in g["routes"].values())
                     for k in GANG_KERNELS}
    tr = trainer["worker_launches"]
    qmono, qef, qover = zq["monolithic"], zq["error_feedback"], zq["overlap"]
    qruns = (qmono, qef, qover)
    zero_b = [a + b for a, b in zip(mono["launches_b1_b3"],
                                    over["launches_b1_b3"])]
    zq_b = [sum(r["launches_b1_b3"][i] for r in qruns) for i in range(3)]

    main_row = next(r for r in rows if r["S"] == 512 and r["causal"])
    fwd_report = kernel_report(built, "flash_fwd_kernel")
    fwd_f32_report = kernel_report(built, "flash_fwd_f32_kernel")
    bwd_main = next(r for r in bwd_rows
                    if (r["B"], r["S"]) == (TRAIN_BATCH, TRAIN_SEQ))
    bwd_shape = (f"B={TRAIN_BATCH} H={N_HEADS} S={TRAIN_SEQ} D={HEAD_DIM} "
                 f"causal bf16")

    def bwd_kernel(name, key, outs, replaces, train_launches, zero_launches,
                   zq_launches, trainer_launches, gang_workers):
        report = kernel_report(built, f"{name}_kernel")
        f32_report = kernel_report(built, f"{name}_f32_kernel")
        return {
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": replaces,
            "launches": (train_launches + zero_launches + zq_launches
                         + trainer_launches + gang_workers),
            "launches_by_path": {"train": train_launches,
                                 "zero_train": zero_launches,
                                 "zero_quant": zq_launches,
                                 "trainer_worker": trainer_launches,
                                 "zero_gang_workers": gang_workers},
            "max_abs_err": max(r[f"bf16_{o}_err"] for r in bwd_rows
                               for o in outs),
            "f32_max_abs_err": max(r[f"f32_{o}_err"] for r in bwd_rows
                                   for o in outs),
            "tol_used_max": max(r[f"{t}_{o}_used"] for r in bwd_rows
                                for o in outs for t in ("bf16", "f32")),
            "ms": bwd_main[f"{key}_ms"],
            "plain_ms": bwd_main["plain_ms"],
            "plain_computes": "dQ, dK and dV",
            "bound_ms": bwd_main[f"{key}_bound_ms"],
            "bound_by": bwd_main[f"{key}_bound_by"],
            "library_ms": bwd_main["library_ms"],
            "library_computes": "SDPA backward: dQ, dK and dV",
            "tflops": bwd_main[f"{key}_tflops"],
            "registers": report["registers"],
            "spills": report["spill_bytes"],
            "blocks_per_sm": blocks_per_sm(key, torch.bfloat16),
            "f32_registers": f32_report["registers"],
            "f32_spills": f32_report["spill_bytes"],
            "f32_blocks_per_sm": blocks_per_sm(key, torch.float32),
            "head_dims_and_full_mask_tol_used": head_dims,
            "shape": bwd_shape, "per_shape": bwd_rows}

    def ring_kernel(key, name, line, by_path):
        main = ring_rows[0][key]
        build = ring_build_fields(ring_built[key]) if key in ring_built \
            else {}
        return {
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/ring.cu",
            "replaces": f"ray_tpu/util/collective/pallas/ring.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": 0.0,
            "tolerance": "bitwise: torch.equal with the plain version",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_computes": main["library_computes"],
            "shape": f"n={main['n']} ranks x {main['rows']} x 128 bf16 sum",
            "per_shape": [t[key] for t in ring_rows], **build}

    def qring_kernel(key, name, line, by_path):
        main = qring_rows[0][key]
        return {
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/ring.cu",
            "replaces": f"ray_tpu/util/collective/pallas/quantized.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": 0.0,
            "tolerance": "bitwise: torch.equal with the plain version",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "yardstick_ms": main["yardstick_ms"],
            "yardstick_computes": main["yardstick_computes"],
            "shape": f"n={main['n']} ranks x {main['rows']} x 128 f32",
            "per_shape": [t[key] for t in qring_rows],
            **{k: main[k] for k in ("form", "hop0_ms", "standalone")
               if k in main},
            **ring_build_fields(ring_built[key])}

    def rank_kernel(i, kind, key, name, replaces):
        row = collective["rows"][key]
        return {
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/ring.cu",
            "replaces": replaces,
            "form": f"{key} across processes: one rank's launch in each of "
                    f"{row['n']} GPU actors, peers through CUDA IPC, "
                    f"ordered by {collective['transport']}",
            "launches": (collective["launches"][i]
                         + gang_launches.get(key, 0)),
            "launches_by_path": {"collective_api_b2b_full_size":
                                 collective["launches"][i],
                                 "zero_gang_workers":
                                     gang_launches.get(key, 0)},
            "max_abs_err": 0.0,
            "tolerance": "bitwise: torch.equal with the in-process kernel "
                         "and the plain version at the gates (n 2 and 4)"
                         + ("; the full-size sample within the int8 "
                            "ring's error bound of the exact sum"
                            if key in ("C5", "C6") else
                            "; the full-size sample equal to the plain "
                            "fold over its rows"),
            "sample_max_err": row["sample_max_err"],
            "ms": row["ms"], "timed_by": "CUDA events around rank 0's "
                                         "launches, median of "
                                         f"{COLLECTIVE_TIMED} calls"
                                         + ("; hop 0 of one overlap chunk "
                                            "(C5: its send and receive "
                                            "launches)" if key in
                                            ("C1", "C5") else ""),
            "ms_ranks": row["ms_ranks"], "call_ms": row["call_ms"],
            "staged_bytes": row["staged_bytes"],
            "plain_ms": row["plain_ms"],
            "plain_computes": "the plain version on all n ranks' stacked "
                              "inputs (phase 8 / 10, this run)",
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_of": "one rank's launch: its bytes read and written once",
            "in_process_ms": row["in_process_ms"],
            "in_process_bound_ms": row["in_process_bound_ms"],
            "library_ms": row["library_ms"],
            "library_ms_ranks": row["library_ms_ranks"],
            "library_pinned_in_call": row["library_pinned_in_call"],
            "library_computes": row["library_computes"],
            "shape": f"n={row['n']} ranks x {row['elems_per_rank']} "
                     f"{row['dtype']} a rank",
            "compute_mode": collective["compute_mode"]}

    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:47",
        "launches": (serve_launches + spec["b1_launches"]
                     + disagg["spec"]["b1_launches"]
                     + runtime["b1_launches"] + app_b1 + ingress_b1
                     + train["launches"][0] + zero_b[0] + zq_b[0]
                     + tr["B1"] + gang_launches["B1"]
                     + jobs["b1_launches"] + transports["b1_launches"]
                     + autoscaler["b1_launches"]
                     + device_obs["b1_launches"]
                     + device_obs["container"]["launches"]),
        "launches_by_path": {"serve": serve_launches, "paged_serve": 0,
                             "spec_serve_draft": spec["b1_launches"],
                             "disagg_spec_decode_draft":
                                 disagg["spec"]["b1_launches"],
                             "runtime_gpu_actor": runtime["b1_launches"],
                             "serve_app": app_b1,
                             "serve_ingress": ingress_b1,
                             "train": train["launches"][0],
                             "zero_train": zero_b[0], "zero_quant": zq_b[0],
                             "trainer_worker": tr["B1"],
                             "zero_gang_workers": gang_launches["B1"],
                             "jobs_gpu_actor": jobs["b1_launches"],
                             "transports_thin_client_actor":
                                 transports["client"]["b1_launches"],
                             "transports_dag_actor":
                                 sum(transports["dag"]["b1_launches"]
                                     .values()),
                             "transports_workflow_gpu_step":
                                 transports["workflow"]["b1_launches"],
                             "autoscaler_gpu_node_actor":
                                 autoscaler["b1_launches"],
                             "device_obs_profiled_gpu_actor":
                                 device_obs["b1_launches"],
                             "device_obs_container_task":
                                 device_obs["container"]["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "timed_by": TIMED_BY_GRAPH,
        "call_ms": main_row["call_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "tflops": main_row["tflops"],
        "f32_max_abs_err": max(r["f32_max_abs_err"] for r in rows),
        "tol_used_max": max(r["tol_used"] for r in rows),
        "draft_shapes_tol_used": draft_b1,
        "draft_prefill_tol_used": {
            "bf16 full width": spec["draft_b1_tol_used"],
            "f32 gate": paged_tokens["draft_b1_tol_used"],
            "bf16 disagg decode": disagg["spec"]["draft_b1_tol_used"],
            "f32 disagg gate": disagg_gates["draft_b1_tol_used"]},
        "registers": fwd_report["registers"],
        "spills": fwd_report["spill_bytes"],
        "blocks_per_sm": blocks_per_sm("fwd", torch.bfloat16),
        "f32_registers": fwd_f32_report["registers"],
        "f32_spills": fwd_f32_report["spill_bytes"],
        "f32_blocks_per_sm": blocks_per_sm("fwd", torch.float32),
        "shape": f"B=1 H={N_HEADS} S=512 D={HEAD_DIM} causal bf16",
        "per_shape": rows,
    }, bwd_kernel("flash_bwd_dkv", "dkv", ("dk", "dv"),
                  "ray_tpu/ops/attention.py:149", train["launches"][1],
                  zero_b[1], zq_b[1], tr["B2"], gang_launches["B2"]),
        bwd_kernel("flash_bwd_dq", "dq", ("dq",),
                   "ray_tpu/ops/attention.py:211", train["launches"][2],
                   zero_b[2], zq_b[2], tr["B3"], gang_launches["B3"]),
        ring_kernel("C1", "ring_permute", 378,
                    {"zero_train_overlap": over["launches_c1_c4"][0],
                     "zero_quant_overlap": qover["launches_c1_c6"][0]}),
        ring_kernel("C2", "ring_reduce_scatter", 169,
                    {"zero_train": mono["launches_c1_c4"][1],
                     "trainer_worker": tr["C2"]}),
        ring_kernel("C3", "ring_allgather", 146,
                    {"zero_train": mono["launches_c1_c4"][2],
                     "zero_quant": qmono["launches_c1_c6"][2]
                     + qef["launches_c1_c6"][2],
                     "trainer_worker": tr["C3"]}),
        ring_kernel("C4", "ring_allreduce", 107,
                    {"zero_replicated_f32": c4_launches}),
        qring_kernel("C5", "ring_qhop", 121,
                     {"zero_quant_overlap": qover["launches_c1_c6"][4]}),
        qring_kernel("C6", "ring_qallreduce", 49,
                     {"zero_quant_monolithic": qmono["launches_c1_c6"][5],
                      "zero_quant_error_feedback":
                          qef["launches_c1_c6"][5]})]
        + [rank_kernel(i, *k) for i, k in enumerate(COLLECTIVE_KERNELS)],
        "serve_profile": serve_profile, "paged_serve": paged,
        "spec_serve": spec, "paged_bitwise": paged_bitwise,
        "paged_tokens": paged_tokens, "disagg": disagg,
        "disagg_gates": disagg_gates, "runtime": runtime,
        "train": {k: v for k, v in train.items() if k != "launches"},
        "zero_train": zero, "zero_f32_max_abs_err": zero_f32_err,
        "zero_quant": zq, "trainer": trainer, "zero_gang": gang,
        "jobs": jobs, "transports": transports, "autoscaler": autoscaler,
        "serve_programs": serve_programs, "device_obs": device_obs,
        "collective": {k: v for k, v in collective.items() if k != "rows"}}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
