#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main paths — synchronous training at the paper's width
(2 layers, hidden 128, fanouts (25, 10), 1024 targets per batch) on a
Reddit-shaped graph of 2^18 vertices (602 features, 41 classes), under
DistDGL and P3, GraphSAGE, GIN and GAT — through
their normal entry points, ``SyncGNNTrainer.run_iteration`` and
``run_epoch`` (sequential, pipelined, and with sampler worker processes),
and the kernel entry points of ``repro_torch.kernels.ops``, and holds
every CUDA kernel of those paths against its plain PyTorch version. The
paths: GraphSAGE on
``aggregate_backend="pallas_edges"`` (the ``aggregate_edges`` kernel, then
the update matmul), GraphSAGE on ``"pallas_fused"`` (``aggregate_fused``
forward, ``fused_bwd`` and ``aggregate_edges`` backward), GIN on
``"pallas_fused"`` at 128 targets, whose last layer has one destination
block and so takes ``fused_bwd_merged``, GraphSAGE on ``"pallas"`` (dense
tiles densified on the card, then ``aggregate_blockcsr``, then the update
matmul), and ``ops.update`` / ``ops.aggregate`` / ``ops.aggregate_update``
(``update_mlp``, ``aggregate_blockcsr``, ``aggregate_fused`` and, unfused,
``aggregate_edges``). It then serves the LM zoo's ported models at
their published widths and depths through ``models.registry.build``,
``ModelBundle.init_params`` and ``launch.steps.make_prefill_step`` /
``make_decode_step``: Llama-3-8B, MiniCPM-2B, StarCoder2-7B, Yi-9B, the
MoE models OLMoE-1B-7B and Grok-1 and the VLM backbone LLaVA-NeXT-34B with
its patch-embedding prefix (prefill through ``flash_attention_fwd``; Grok
cut to 2 layers) and RWKV-6-3B (prefill through ``wkv6_chunk``), in bf16
from a seeded init, and trains Llama-3-8B, RWKV-6-3B, OLMoE-1B-7B and
LLaVA-NeXT-34B at their published widths, 2 layers deep, through
``launch.steps.make_train_step`` (the flash forward and the hand-written
``flash_attention_bwd``; ``wkv6_chunk`` and the hand-written
``wkv6_chunk_bwd``). Before the LM zoo it serves GraphSAGE and GAT requests through
``core.serving.ServingRuntime`` (one CUDA graph a bucket), then runs the
paper's Table 2 API (``core.abstraction.HitGNN``): its DSE, one epoch
through ``Start_training`` and the simulator beside what the card
measured. Phases, each of which exits non-zero on failure:

  1. device report: the card's name, its name and power limit as
     ``nvidia-smi`` gives them, and its max SM clock;
  2. build: every kernel source in ``src/repro_torch/kernels/csrc`` goes
     through ``nvcc`` (one process per source, all started together), and
     the compiler's register and spill report is printed;
  3. kernel vs plain, at the shapes the main paths give each kernel: one
     paper-shape batch for ``aggregate_edges`` (layer-0 forward, layer-1
     forward, layer-1 backward over A^T), ``aggregate_fused`` and
     ``fused_bwd`` (layers 0 and 1, no self term), and one 128-target GIN
     batch for ``aggregate_fused`` and ``fused_bwd`` with a self term
     ``s`` (layers 0 and 1) and ``fused_bwd_merged`` (its layer 1);
     ``aggregate_blockcsr`` over the paper batch's dense tiles (layer-0
     forward, layer-1 forward, layer-1 backward over A^T), walking only
     the real slots that ``real_slot_counts`` finds, as the trainer runs
     it, with the times of ``densify_tiles`` and of the counts on their
     own; and ``update_mlp`` at the update
     stage's shapes. Each launch is held against its plain version on
     the card within rtol 1e-5 and atol 1e-6 times the largest magnitude
     of the plain result (at least 1e-6): fp32 sums are taken in another
     order, and the products contract up to 602 features, 26,624 rows or
     1,280 tiles of 128 columns, so an element that cancels towards zero
     keeps an absolute error of about sqrt(K)·eps of its terms' size. Times
     by CUDA events after warm-up, with the launches queued behind a busy
     card so they time the device: the kernel, its plain version, and
     yardsticks the port never calls — ``torch.sparse.mm`` on a CSR of the
     same edges for ``aggregate_edges``, on a BSR of the tiles that hold
     an edge for ``aggregate_blockcsr`` (a CSR of the edges where the
     installed PyTorch has no fp32 BSR product on CUDA; the line says
     which), ``torch.addmm`` for ``update_mlp`` (``torch.addmm(b, x,
     w).relu_()`` for its relu launch); for the fused kernels, which no
     single PyTorch call computes, the port's unfused composition (the
     ``aggregate_edges`` kernel and ``torch.matmul``) and ``torch.sparse.mm``
     with ``torch.matmul``. Beside them the bound: the larger of the bytes
     the launch must move over 3.35 TB/s and its flops over the 67 TFLOP/s
     fp32 rate (published H100 SXM peaks). ``aggregate_edges``' lines
     give its shape (``groups`` of ``rows_a_group`` rows, ``slab``: the
     columns a warp walks at once, ``vec``: the floats a lane loads at
     once, ``ctas``, ``real_blocks``: the destination blocks that hold an
     edge, ``busy_ctas``) and the build report's registers and spill bytes
     of the launch's instantiation; two launches must give the same bits.
     ``fused_bwd``'s lines also
     give its plan (``real_blocks``, ``groups``, ``slab``, ``ctas``,
     ``partial_bytes``, held under 8 MiB), the device times of its dw
     kernel, its reduce and its plan's PyTorch ops apart
     (``torch.profiler``), and the build report's registers and spill
     bytes; two launches must give bitwise the same dw (and db).
     ``fused_bwd_merged``'s line gives its shape (``dh_groups``,
     ``dw_groups``: the dw cluster's ranks, ``ctas``, ``vec``), the build
     report's registers, spill bytes and static shared memory of the
     launch's instantiation beside its dynamic shared memory, and its
     device split, which must hold one kernel a call; two launches must
     give the same bits, and dh must equal the ``aggregate_edges`` kernel
     over A^T bit for bit.
     ``aggregate_fused``'s lines give its shape (``slab``, ``cluster``,
     ``rounds``, ``ctas``, ``max_active_clusters``: the clusters the card
     runs at once, ``real_blocks``: the destination blocks that hold an
     edge), its device split by kernel and the build report's registers
     and spill bytes (of the launch's instantiation, and of each under
     ``build``); two launches must give the same bits. The
     fused kernels' update flops are counted over the destination rows
     that hold an edge or a self term (``flops``), and over all padded
     rows as ``flops_all_rows``;
     without a bias the backward reads ``g`` over the same rows, since a
     row whose z is zero adds nothing to dw. ``aggregate_blockcsr``'s
     flops are 2*128*128*F per slot that holds an edge, over the 495
     TFLOP/s TF32 tensor-core rate, the fastest the card multiplies fp32
     inputs (its 3xTF32 split does three TF32 products per product); its
     bytes count the tiles of the slots it walks (``real_slots_walked``),
     the h rows they name and the output, each once; the line gives the
     achieved fp32-product rate (``tflops``). ``update_mlp``'s products
     run on the tensor cores too (3xTF32), so its bound takes them at the
     TF32 rate as well; its lines name the route, the tile plan, the
     shared memory and the build report's registers and spill bytes, and
     keep the earlier all-fp32 bound as ``bound_fp32_ms``. Each line names
     its ``op_rate`` (``op_rates`` where the work runs on several units).
     The ``kernels`` line sums
     each kernel's times and bounds over the launches this phase checked;
  4. training, each path with every launch count set to 0 just before it
     and read just after: five iterations of GraphSAGE on
     ``"pallas_edges"`` (3 ``aggregate_edges`` launches each), five on
     ``"pallas_fused"`` (2 ``aggregate_fused``, 2 ``fused_bwd`` and 1
     ``aggregate_edges`` each), two of GIN on ``"pallas_fused"`` at 128
     targets (2 ``aggregate_fused``, 1 ``fused_bwd`` and 1
     ``fused_bwd_merged`` each), three of GraphSAGE on ``"pallas"`` (3
     ``aggregate_blockcsr`` each: layer 0's input features need no
     gradient, so layer 0's A^T is never densified); any other count
     fails. Losses must be finite, and each path's first loss must match
     ``aggregate_backend="reference"`` (plain segment sums on the card)
     from the same parameters and batch within rtol 1e-4. The reference
     datapath runs that iteration twice, from the same parameters and
     batch, and its two losses and updated parameters must be bitwise
     equal. The peak device memory of each backend's run is printed
     beside the aggregate and dense-tile bytes the trainer says it keeps
     in device memory. Beside each GraphSAGE run, the same iterations
     from the same parameters under ``data_parallel=True`` (the resident
     feature path: the shard uploaded once, the layer-0 block assembled on
     the card by ``assemble_device_feats``), whose launch counts must be
     the host-gather run's and whose first loss must be its first loss
     bit for bit; then two iterations at p = 4 on ``"pallas_fused"``,
     host gather and resident, with four times the counts, the same first
     loss, miss rows shipped, beta below 1 and the same per-device
     accounting. Iteration lines carry ``gather_s``, ``upload_s``,
     ``step_s``, ``wall_s``, ``nvtps``, ``beta`` and, resident,
     ``shard_upload_s`` and ``miss_rows``. ``assemble_device_feats`` at
     the paper batch (p = 1, and each device at p = 4) must equal
     ``FeatureStore.gather`` on the card bit for bit; its launch lines
     give its ms by CUDA events beside its bytes bound (the valid rows
     read, the block written, the positions). Then P3 at p = 4 (hash
     partition, every device a 151-feature slice of every row) on
     ``"pallas_fused"`` and ``"pallas_edges"``, two iterations each, host
     gather (``gather_p3_full``) and resident (the (4, V, 151) slice
     matrix on the card, the block assembled by ``assemble_p3_feats``):
     four times the p = 1 counts, the same first loss on both feature
     paths bit for bit, beta exactly 1, no miss row and the same
     per-device accounting; ``assemble_p3_feats`` at the paper batch must
     equal ``gather_p3_full`` on the card bit for bit, its line giving its
     ms by CUDA events beside its bytes bound (each valid row's slices
     read, the block written, the positions). ``peak_memory_resident``
     gives each resident run's peak beside its host-gather run's and its
     shard's bytes. Last, GAT (no kernel on any backend: its attention
     weights are computed on the card) at the paper width, five
     iterations on the host gather, resident and configured
     ``"pallas_fused"``, each with every count 0; finite losses; its
     first iteration twice from the same parameters and batch, bitwise;
     the resident and ``"pallas_fused"`` runs' losses and final
     parameters bitwise the host gather's; the first loss within rtol
     1e-4 of the same iteration run by the port on the CPU;
  5. the host runtime (``SyncGNNTrainer.run_epoch``): the machine's CPU
     count and affinity and ``/dev/shm``'s free bytes, which must hold the
     shared graph and the largest ring a pool here may take (else the
     phase fails); the host milliseconds of one paper batch's trip
     through the pool's ring (``pool_codec``: encode, decode and CRC32
     alone); then, from phase 4's initial parameters, two full epochs a
     run (26 iterations each) on the resident path at p = 1 for
     ``"pallas_fused"`` and ``"pallas_edges"``: sequential
     (``pipeline=False``, the twin), pipelined with in-process sampling,
     and pipelined with 2, 4 and min(8, usable CPUs - 2) sampler workers;
     one pooled epoch (2 workers) on ``"pallas_fused"`` with a worker
     killed at batch 13 of the first epoch, which must be respawned; the
     host gather on ``"pallas_fused"``, sequential against pipelined, one
     epoch each;
     p = 4 on ``"pallas_fused"`` with the ``"load"`` policy,
     sequential against 4 workers that gather the miss rows (which must
     cross the ring); P3 at p = 4 on ``"pallas_fused"``, resident,
     sequential against 2 workers that sample only (gathering, they would
     ship every valid row's full 602 features); and GAT at p = 1,
     resident, sequential against 4 workers; then the feature cache at
     p = 4, round-robin, with a quarter of the smallest DistDGL static
     share (printed) as the rows a device: resident
     with epoch-boundary refresh, 3 epochs sequential (bitwise its
     cache-off twin) and with 4 workers that gather (bitwise the cached
     sequential run in every cache key too; epoch 3's miss bytes an
     iteration below epoch 1's and its hit rate above), and the host
     gather refreshed every 4 iterations, 1 epoch sequential against 4
     workers that gather (the generation handshake under real process
     timing: equal refreshes and generation, both above 0); one
     ``cache`` line a run gives the capacity, refreshes, generation, each
     epoch's hit rate, miss bytes an iteration, beta, admissions,
     evictions and refresh bytes with its ``iteration_s`` beside the
     cache-off twin's, each shard re-upload's seconds, the host ms of
     installing admitted sets, of ranking and of waiting for the ranking
     thread, and the card. Each run's epoch loss and acc, and its parameters
     after its last epoch, must equal its twin's bit for bit, and its
     launch counts must be its iterations times phase 4's counts per
     iteration (times p). Each ``epoch`` line gives ``epoch_time_s``,
     ``iteration_s``, ``nvtps``, the host seconds (``host_produce_s``:
     the prefetch thread preparing groups; ``host_wait_s``: the main
     thread waiting for one; ``host_fetch_s``: pulling payloads from the
     pool; ``host_gather_s``; ``host_issue_s``: the main thread launching
     steps), ``ring_bytes_per_iter`` and the ``pool_*`` counters; the
     last epoch of a run is traced on the device alone
     (``torch.profiler`` with CUDA activity only, which keeps it off the
     host's path) for its kernels, busy milliseconds (the union of the
     kernels' and copies' intervals) and idle share;
  5b. checkpoints (``checkpoint.checkpointing.Checkpointer``,
     ``SyncGNNTrainer(checkpointer=, checkpoint_every=)``): the cache
     family's resident configuration (GraphSAGE on ``"pallas_fused"``,
     p = 4, round-robin, epoch-boundary refresh) for 2 sequential epochs
     saved every 2 iterations (the twin), then a fresh trainer that
     restores epoch 2's second-iteration checkpoint
     (``restore_checkpoint``) and finishes the epoch
     (``run_epoch(resume=True)``), sequentially and with 4 workers that
     gather; each must end bitwise the twin in parameters, optimizer
     state, the cache's counter, resident sets, generation and counters,
     launch its iterations times phase 4's counts (times p), and the
     pooled run's shared segment must hold the restored generation.
     ``checkpoint`` lines give the twin's saves (the main thread's
     snapshot seconds, the write thread's seconds, of which waiting for
     the card's copies, and the bytes on disk) and each resumed run's
     ``restore_s`` and seconds an iteration beside the twin's. Then three
     iterations of GraphSAGE on ``"pallas_fused"`` at p = 1 with
     ``optimizer_name="sgdm"``: phase 4's counts an iteration, its first
     loss within rtol 1e-4 of ``"reference"``, and every loss, the
     momentum and each parameter's update (beside the parameter's
     rounding, an ulp a step) within rtol 1e-4 of the same iterations
     run by the port on the CPU;
  6. data parallelism over ranks (``SyncGNNTrainer(mesh=...)``, one
     process a rank, started by ``distributed.launch.spawn_data_parallel``
     with the graph attached from shared memory): GraphSAGE on
     ``"pallas_fused"``, resident, from phase 4's initial parameters; NCCL
     at p = 1 (DistDGL: three ``run_iteration`` calls, then one pipelined
     epoch) and gloo at p = 2 with both ranks on the one card (NCCL
     refuses two ranks on one card; DistDGL likewise, and P3 three
     iterations, its layer-1 exchange an ``all_to_all_single``). The same
     jobs run first in this process on the one-process
     ``data_parallel=True`` trainer. Every rank's losses, final parameters
     and epoch (each key that holds no time, the accounting among them)
     must equal that run's bit for bit, and each rank must launch the
     per-slot counts (2 ``aggregate_fused``, 2 ``fused_bwd``, 1
     ``aggregate_edges`` an iteration) where that run launches p times
     them. ``mesh_rank`` lines give each rank's seconds an iteration, the
     pipelined epoch's seconds an iteration, peak device memory and each
     collective's calls, bytes and ms (host clock with the card
     synchronized before and after, so the wait for the slower rank
     counts); ``mesh_one_process`` lines give the yardstick. A gloo p = 2
     job runs two epochs with the feature cache (``MESH_CACHE_EPOCHS``)
     and
     must equal the one-process run in the cache's keys, its counter and
     resident sets too; a gloo p = 2 checkpoint job runs phase 5b's twin
     and resume at p = 2 (rank 0 writes the arrays, each rank its own
     manifest) and every rank's resumed parameters must equal its
     uninterrupted ones and the one-process run's, bit for bit. Two ranks
     on one card share its SMs and memory: their times say nothing of two
     cards;
  6b. GNN serving (``core.serving.ServingRuntime``, one CUDA graph a
     bucket), with every launch count set to 0 just before and still 0
     after: serving builds no kernel layout, so every model runs the plain
     segment sums, as the reference's serving does. GraphSAGE at the
     paper width (configured ``"pallas_fused"``) from phase 4's
     parameters over the default ladder (8, 32, 128, 512, 1024 targets):
     one eager forward under ``torch.cuda.set_sync_debug_mode("error")``
     (an op that waits for the host cannot be captured); ``warmup()``
     captures exactly 5 graphs, and ``predict`` at 1, 5, 8, 20, 33, 200,
     1,024 and 1,500 ids (chunked) captures none more; the 33- and
     1,024-id requests equal the eager forward over their batch (the same
     request id, the bucket's cyclic pad) bit for bit, and every bucket's
     replay the eager forward over its buffers; the 33-id request
     replayed by a ``device="cpu"`` runtime is within rtol 1e-5 and atol
     1e-6 x its largest |logit| (the models' parity tolerance); a runtime
     with 2 pool workers, and one whose first task's worker is killed
     (one respawn, not degraded), answer the same requests bit for bit;
     GAT at 8 and 1,024 ids, bitwise its eager forward; closed-loop load
     at 1, 2 and 4 clients x 100 one-id requests, after a discarded
     window of 20 (the coalescer's estimate settles), no error and no new
     graph.
     ``serve_bucket`` lines give each bucket's N_0 and, as medians over 9
     requests of the bucket's size, the request latency and its host
     sample, gather, upload and forward ms; the replay and the eager
     forward ms by CUDA events (device time) and on the host clock (a
     synchronize after each call: what a request waits for, launches
     included); the static buffers' bytes, what the capture added to the
     shared graph pool and the eager forward's peak. ``serve_load`` lines
     give the offered requests a second, p50 and p99 ms and the SLO
     (50 ms) miss rate. Misses are results, not failures;
  6c. the paper's API (``core.abstraction.HitGNN``), its DSE and the
     simulator: the Listing-1 calls at the paper configuration (GraphSAGE,
     2 layers, hidden 128, fanouts (25, 10), 1,024 targets, ``metis_like``
     at p = 4, DistDGL), ``Generate_Design`` at Reddit's Table 4 stats
     (``design`` line: the FPGA model's (n, m) and the H100 design's slab
     and cluster); ``H100DSE.smem_bytes`` must equal the built kernel's
     ``aggregate_fused_smem_bytes`` for every slab the search considered
     (``design_smem``); the ``design_h100`` line gives the DSE's (slab,
     cluster, t_agg) at phase 3's paper batch beside, layer by layer, the
     shape ``aggregate_fused_shape`` picked, its measured ms and the
     model's ms at either shape. Then ``LoadInputGraph`` and
     ``Start_training(epochs=1)`` from phase 4's parameters, resident on
     ``"pallas_fused"`` at p = 4 with a checkpoint under ``build/``: it
     must launch its iterations times p times phase 4's counts, and its
     epoch (every key that holds no time) and parameters must equal a
     directly built ``SyncGNNTrainer``'s bit for bit; ``Save_model``'s npz
     must hold the trainer's parameters, one array each (``api_epoch``
     line: s an iteration and NVTPS). Last, the simulator calibrated from
     the p = 1 resident ``"pallas_fused"`` runs (``t_sampling``,
     ``t_layout``, ``t_gather``: medians of phase 4's ``run_iteration``
     stages; the layout's host-to-device bytes; ``t_ipc``: a 2-epoch
     1-worker pool run here, bitwise phase 5's sequential twin, less the
     in-process pipelined epoch, a second an iteration, at least 0), at
     the smoke graph's own statistics: ``simulator`` lines give the
     modelled pipelined/sequential speedup beside phase 5's, the modelled
     speedups at 2 and 4 workers beside phase 5's pooled epochs (against
     the in-process one: the model's single worker pays no IPC toll), and
     the model's ``t_host`` and ``t_gnn`` (the paper's FPGA device model)
     beside the prefetch thread's ms and the traced device-busy ms an
     iteration. A wide gap is a finding; a non-finite or non-positive
     value fails;
  7. the kernel entry points: ``ops.update``, ``ops.aggregate`` and
     ``ops.aggregate_update`` (fused, and with ``use_pallas=False``) on
     the layer-1 operands, with the counts set to 0 just before and read
     just after (one launch of each of the four kernels), each result
     held against its plain version;
  8. the LM kernels vs their plain versions, at the models' shapes:
     ``flash_attention_fwd`` at Llama-3-8B's prefill (4 x 4,096 tokens,
     32 query and 8 kv heads of 128, bf16, causal), in fp32 at 1 x 1,024,
     non-causal with Sq 1,000 != Sk 1,537 (bf16), at OLMoE-1B-7B's
     and Grok-1's prefills (16 heads over 16, 48 over 8), at phase 9b's
     (``vlm_dense_flash_launches``: LLaVA-NeXT-34B's one request of 4,096
     positions, 56 heads over 8, a GQA group of 7; MiniCPM-2B's 36 over 36
     of 64, StarCoder2-7B's 36 over 4 and Yi-9B's 32 over 4 at 4 x 4,096)
     and at LLaVA's shape in fp32; ``wkv6_chunk`` at
     RWKV-6-3B's prefill (4 x 4,096 tokens, 40 heads of 64, bf16 r/k/v and
     fp32 log-decays, y and the final state), in fp32 at 1 x 512, and at a
     ragged 1,007 tokens from a given state. fp32 launches are held at the
     reference's own kernel-test tolerances (flash rtol 1e-4 / atol 2e-4,
     wkv6 1e-4 / 1e-4, each atol times the plain result's largest
     magnitude, at least 1). bf16 launches get rtol 1e-2, which covers one
     bf16 rounding of the output on each side (2 x 2^-8 of its value), and
     an absolute term for what else the kernel does: flash rounds each p
     to bf16 before the PV product as the TPU kernel does (the plain
     version keeps fp32 p), which moves an output by at most 2^-8 (P|v|)
     for that element, so its atol is 4e-3 x (P|v|), element by element,
     with P|v| the plain version run on |v|; wkv6 rounds nothing inside,
     so its atol stays the fp32 one. The state is held at 1e-4. Each
     launch line gives the plain result's largest and mean magnitude and
     the largest share of its allowance an element used (``tol_used``).
     Each flash line names its route (``wgmma`` for bf16: both products
     on the tensor cores on TMA-fed tiles; ``fma`` for fp32) and its
     achieved rate (``tflops``, the unmasked pairs' 4 D flops per pair).
     Yardstick: ``scaled_dot_product_attention`` for flash (k
     and v repeated to 32 heads outside the timing); none computes wkv6.
     Bounds: flash's bytes (q, k, v, out once; k and v unrepeated) and its
     flops over the unmasked pairs (4 D per pair) at the bf16 tensor-core
     rate (989 TFLOP/s) for bf16 launches and 67 TFLOP/s for fp32; wkv6's
     bytes, and its work per chunk (``wkv6_flops``) on three units, the
     largest time counting: the products (r~ S, A v, k~^T v) at the TF32
     rate (its products run on the tensor cores, 3xTF32), the elementwise
     and pairwise flops at 67 TFLOP/s, the exponentials at the SFU's 16 a
     clock per SM on 132 SMs at ``nvidia-smi``'s max SM clock; beside it
     ``bound_fp32_ms``, every flop at 67 TFLOP/s as before. wkv6 lines
     name the route, the heads per thread block, the thread blocks, the
     shared memory and the build report's registers and spill bytes. Only
     the main-path launches enter the ``kernels`` line's times;
  9. serving, each model with every launch count set to 0 just before and
     read just after each prefill and each decode step: a 256-token
     warm-up prefill, the prefill of 4 prompts of 4,096 numpy-seeded
     tokens, the KV cache grown by 16 slots (``examples/lm_serve.py``),
     16 greedy decode steps, then the last step once more under
     ``torch.profiler`` (device busy time and kernel count). Llama-3-8B,
     RWKV-6-3B and OLMoE-1B-7B at full depth, Grok-1 at its published
     widths cut to 2 of 64 layers (``SERVE_LAYERS``). Exactly one launch
     of the model's kernel a layer per prefill (``flash_attention_fwd``
     for the dense and MoE models, ``wkv6_chunk`` for RWKV) and none per
     decode step; finite logits over the padded vocab. Printed: init,
     prefill and decode times, tokens/s, the peak device memory of the
     init and of serving; a MoE model's line adds the prefill's (token,
     slot) pairs dropped at capacity, layer by layer. Then one OLMoE MoE
     layer split into its parts (``moe`` line, ``moe_parts``): each part's
     device ms at the prefill's shape and a decode step's, the kept and
     dropped pairs, and the experts', the dispatch's and the combine's
     bounds;
  9b. the same serving at full depth for LLaVA-NeXT-34B (60 layers, 34.39
     B parameters, ~68.8 GB in bf16, so one request: ``SERVE_BATCH``) and
     for MiniCPM-2B, StarCoder2-7B and Yi-9B (4 prompts). LLaVA's request
     is 2,880 patch rows, numpy-seeded on the host as the reference's
     input spec draws them (the vision tower is a stub there too), and
     1,216 text tokens; both cross the bus in one copy through the pinned
     staging ring (``core.staging.upload_tensors``), inside the prefill's
     time, and decoding goes on at position 4,096. Each line adds its
     stages' seconds (``stage_s``);
  10. prefill/decode consistency in fp32 (TF32 off) at full width and 2
     layers (Grok-1 at 1): the last logits of a 1,024-token prefill against
     a 1,023-token prefill and one decode step (LLaVA-NeXT-34B's behind its
     2,880 seeded patch rows, the decode step at position 3,903), within
     rtol 1e-4 and atol
     1e-4 times the largest logit of the real vocab (fp32 sums over up to
     6,144 features and 1,024 positions taken in another order by the two
     paths). The MoE models run at capacity_factor E / K, so that C = S and
     no pair can drop: a prefill that drops one of the last token's pairs
     differs from a decode step by the reference's own semantics;
  11. the LM training step. ``flash_attention_bwd`` against its plain
     version at Llama-3-8B's training shape (1 x 4,096 tokens, 32 query
     and 8 kv heads of 128, causal) in bf16 (the main path's launch) and
     fp32, at a ragged causal shape (2 x 1,000 tokens, 4 and 2 heads of
     64) and a non-causal one (2 x 512, 8 and 2 heads of 128), each in
     bf16 and fp32, and at Whisper large's cross-attention in bf16 (2 x
     448 queries over 1,500 keys, 20 heads of 64, non-causal: Sq != Sk),
     from the forward's output and log-sum-exp: the lse is
     held against the plain one at flash's fp32 tolerance (both routes sum
     l in fp32), the forward's output must be bitwise the same with and
     without it, two backward launches must give the same bits, and dq,
     dk and dv are held in fp32 at flash's fp32 tolerance and in bf16 at
     rtol 1e-2 with an atol of 8e-3 (one bf16 ulp, 2^-7, of a rounded p or
     ds that a last-bit difference before the rounding can flip) times
     each element's sum of |rounded factor| x |other factor| (|ds| |k|,
     |ds|^T |q|, |p|^T |dout|) plus the fp32 allowance. Each line gives
     the route (``fa.ROUTES``: bf16 on ``wgmma``, every product on the
     tensor cores from TMA-fed tiles; fp32 on ``fma``, every product on
     fp32 FMA from shared-memory tiles), each pass's registers, spills and
     dynamic shared memory under its kernel's name (``build_usage``), the
     kernel's ms (CUDA events), its plain version's, the yardstick's
     (``scaled_dot_product_attention``'s backward alone, k and v repeated
     outside the timing) and the bound: q, k, v, out, dout, lse, dq, dk
     and dv moved once over 3.35 TB/s against 5 products of 2 D flops per
     unmasked pair at the card's rate for the operands' type (989 TFLOP/s
     bf16, 67 fp32). The bf16 lines also hold the kernel's rounding points:
     its relative Frobenius error against the plain version must stay
     under 2^-11, and against the plain version with p's or ds's rounding
     to bf16 removed must exceed it (``rounding``). Then the step at full
     width (``train``
     line): Llama-3-8B's widths (d 4,096, 32 / 8 heads, d_ff 14,336,
     vocab 128,256), 2 layers (the 32 with fp32 moments would need ~128
     GB), bf16 parameters from ``ModelBundle.init_params``, remat
     ``"full"``, ``grad_accum`` 2 over 2 x 4,096 numpy-seeded tokens, 3
     steps of the reference's AdamW on a cosine schedule; every count set
     to 0 before each step and read after it: exactly 8
     ``flash_attention_fwd`` (2 layers x 2 micro-batches x the forward and
     remat's recompute) and 4 ``flash_attention_bwd``, nothing else;
     finite losses and gradient norms. It prints s a step and tokens/s
     (medians of steps 2-3), the peak device memory, and step 1 run again
     from the same parameters and batch under ``torch.profiler`` (warmed
     first): the flash kernels' share of the device's busy time, null
     unless the trace saw every launch the counts saw
     (``trace_complete``), and whether the loss, gradient norm and
     parameters came out bitwise the same (printed, not failed). The bf16
     logits of 512 seeded hidden states are held against the fp32 product
     of the same values at rtol / atol 1e-4 x the largest |logit| (the
     line's ``logits``). Last, one fp32 micro-step (TF32 off) of the same 2-layer
     model at 1 x 128 tokens: the loss and every gradient leaf on the card
     within rtol 1e-4 and atol 1e-4 times the leaf's largest magnitude of
     the port on the CPU (``train_vs_cpu`` line, with the CPU's seconds);
  11b. RWKV-6's training step. ``wkv6_chunk_bwd`` against its plain
     version at RWKV-6-3B's training shape (1 x 4,096 tokens, 40 heads of
     64, bf16 r, k, v and dy, fp32 log-decays, no initial state and no
     final-state cotangent: the main path's launch), in fp32 at 1 x 512
     tokens and in bf16 at a ragged 1,007, both with an initial state and
     a final-state cotangent. Two launches must give the same bits. fp32
     gradients are held at wkv6's fp32 tolerance (rtol 1e-4, atol 1e-4
     times the plain result's largest magnitude, at least 1); in bf16,
     dr, dk and dv, which both round to bf16 once, at rtol 1e-2 with that
     atol, and dlw, du and ds0 (fp32 from the same bf16 inputs) at the
     fp32 tolerance. Each line gives the route (``mma.sync 3xTF32``), each
     pass's registers, spills, thread blocks and shared memory (the walks'
     and the span pass's dynamic shared memory, and how many blocks of
     each the runtime fits on an SM), the kernel's ms (CUDA events), its plain
     version's, no yardstick (no single PyTorch call computes the
     gradient), the bound (``wkv6_bwd_flops``: bytes of r, k, v, dy and lw
     read and dr, dk, dv and dlw written, the products at the TF32 rate,
     the pairwise flops at 67 TFLOP/s, the exponentials at the SFU's) and
     the share of its allowance each gradient used; the main-path line
     adds its device split by kernel. Then the step (``train`` line,
     ``"arch": "rwkv6-3b"``) as phase 11's: the published widths (d 2,560,
     40 heads of 64, d_ff 8,960, vocab 65,536), 2 layers (the 32 with fp32
     moments and AdamW's new moments beside the old would need ~74 GB
     before activations), bf16, remat ``"full"``, grad_accum 2 over 2 x
     4,096 tokens, 3 AdamW steps: exactly 8 ``wkv6_chunk`` and 4
     ``wkv6_chunk_bwd`` a step, nothing else; the wkv6 kernels' share of
     busy time (null unless the trace saw every launch); and its fp32
     micro-step against the CPU (``train_vs_cpu``);
  11c. OLMoE-1B-7B's training step: ``flash_attention_bwd`` against its
     plain version at its training shape (1 x 4,096 tokens, 16 heads over
     16 of 128, bf16), then phase 11's step (``train`` line, ``"arch":
     "olmoe-1b-7b"``) at the published widths (d 2,048, 64 experts of
     1,024, top 8, vocab 50,304), 2 of 16 layers (1.045 B parameters; the
     16 at ~16 B a parameter would need ~111 GB), bf16, remat ``"full"``,
     grad_accum 2 over 2 x 4,096 tokens, 3 AdamW steps: exactly 8
     ``flash_attention_fwd`` and 4 ``flash_attention_bwd`` a step, nothing
     else, and its repeat bitwise or not; and the fp32 micro-step against
     the CPU (``train_vs_cpu``) with the routing's smallest margin between
     the K-th and (K+1)-th router probability, each token whose experts
     differ between the card and the CPU printed first. Grok-1's step does
     not run here (one layer at full width is 6.53 B parameters, ~65 GB
     of state even with bf16 moments);
  11d. LLaVA-NeXT-34B's training step: ``flash_attention_bwd`` against
     its plain version at its training shape (1 x 4,096 positions, 56
     heads over 8 of 128, bf16, with the rounding readings), then phase
     11's step (``train`` line, ``"arch": "llava-next-34b"``) at the
     published widths (d 7,168, d_ff 20,480, vocab 64,000), 2 of 60 layers
     (2.03 B parameters; the 60 at ~16 B a parameter would need ~550 GB),
     bf16, remat ``"full"``, grad_accum 2 over 2 sequences of 2,880
     numpy-seeded patch rows and 1,216 text tokens (the prefix's positions
     unsupervised), 3 AdamW steps: exactly 8 ``flash_attention_fwd`` and 4
     ``flash_attention_bwd`` a step, nothing else; and the fp32
     micro-step against the CPU (``train_vs_cpu``) at 64 patch rows and 64
     text tokens;
  12. summary: one ``{"kernels": [...]}`` line, then the last line
     ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    # the sampler pool's workers are spawned processes that import this
    # file as __mp_main__, and a worker must not load torch
    import torch

SCALE = 18          # 2^18 vertices, Reddit's 602 features and 41 classes
ITERATIONS = 5
BLOCKCSR_ITERATIONS = 3
MERGED_TARGETS = 128    # one destination block at the last layer
MERGED_ITERATIONS = 2
RESIDENT_P4 = 4         # simulated devices of the resident run with misses
RESIDENT_P4_ITERATIONS = 2
P3_DEVICES, P3_ITERATIONS = 4, 2    # P3: every device a feature slice
GAT_ITERATIONS = 5
# the host runtime phase: two epochs a run, the resident path at p = 1 on
# these backends, p = 4 with the "load" policy, and a worker killed at
# partition 0's batch 13 of the first epoch (epoch 1: every epoch starts
# with a reset)
HOST_EPOCHS = 2
# ... but one epoch for the host gather's pipelined twin (17-24 s an epoch
# on a slow host; its twin check holds within an epoch), cut from 2 for
# the script's time limit
HOST_GATHER_EPOCHS = 1
HOST_BACKENDS = ("pallas_fused", "pallas_edges")
HOST_P4 = 4
HOST_FAULT = "kill@0.1.13"
# the mesh phase: one process a rank under torch.distributed, GraphSAGE on
# "pallas_fused", resident; (backend, ranks, {job: (algorithm, kind)}),
# kind "iterations" (MESH_ITERATIONS of them), "epoch" (those, then one
# epoch), "cache" (MESH_CACHE_EPOCHS epochs with the feature cache) or
# "checkpoint" (2 epochs saved every CKPT_EVERY iterations, then
# a fresh trainer resumed from epoch 2's second iteration):
# NCCL at p = 1, and gloo at p = 2 with both ranks on the one card (NCCL
# refuses two ranks on one card)
MESH_ITERATIONS = 3
MESH_RUNS = (("nccl", 1, {"distdgl": ("distdgl", "epoch")}),
             ("gloo", 2, {"distdgl": ("distdgl", "epoch"),
                          "p3": ("p3", "iterations"),
                          "distdgl/cache": ("distdgl", "cache"),
                          "distdgl/checkpoint": ("distdgl", "checkpoint")}))
MESH_EPOCH_KEYS = ("loss", "acc", "lr", "grad_norm", "batches",
                   "iterations", "utilization", "mesh_devices",
                   "fill_slots", "vertices_traversed", "beta",
                   "load_imbalance", "ring_bytes", "cache_hit_rate",
                   "miss_bytes", "miss_bytes_per_iter", "cache_enabled",
                   "cache_admissions", "cache_evictions",
                   "cache_refresh_bytes")
# the mesh's cached job: two epochs, epoch-boundary refresh, a quarter of
# the smallest DistDGL static share of a device at p = 2
MESH_CACHE_EPOCHS = 2
# the feature cache in the host runtime phase: p = 4, round-robin, a
# quarter of the smallest static share of a device under DistDGL;
# resident runs refresh at epoch boundaries over 3 epochs, the host
# gather every 4 iterations over 1 (its 7 iterations refresh once; cut
# from 2 for the script's time limit)
CACHE_P = 4
CACHE_EPOCHS = 3
CACHE_K = 4
CACHE_K_EPOCHS = 1
# the checkpoint phase: the cache family's resident configuration (p = 4,
# round-robin, epoch-boundary refresh), two sequential epochs saved every
# CKPT_EVERY iterations, resumed from epoch 2's second iteration
# sequentially and with CKPT_WORKERS workers that gather; then
# SGDM_ITERATIONS iterations with SGDM at p = 1
CKPT_EVERY = 2
CKPT_WORKERS = 4
SGDM_ITERATIONS = 3
# the GNN serving phase: GraphSAGE at the paper width from phase 4's
# parameters over the default ladder (8, 32, 128, 512, 1024 targets);
# predict at these sizes (1,500 chunked through the largest bucket), the
# eager forward held against two of them and the CPU against one; each
# bucket's stages the medians over 9 full requests, and its replay and
# eager forward timed 20 times on the host clock; a pool of 2 workers and
# one with a worker killed at its first task answering the same requests;
# GAT at two sizes; closed-loop load points of 100 one-id requests a
# client, after a discarded window of 20 at the first point (halved from
# 200 for the script's time limit once the LM zoo grew; no check dropped)
SERVE_SIZES = (1, 5, 8, 20, 33, 200, 1024, 1500)
SERVE_BUCKETS = 5
SERVE_EAGER = (33, 1024)
SERVE_CPU = 33
SERVE_BUCKET_REQUESTS = 9
SERVE_HOST_ITERS = 20
SERVE_WORKERS = 2
SERVE_FAULT = "kill#1"
SERVE_GAT_SIZES = (8, 1024)
SERVE_CLIENTS = (1, 2, 4)
SERVE_LOAD_WARMUP = 20
SERVE_LOAD_REQUESTS = 100
# the paper's API phase: the Listing-1 design at the paper configuration
# (GraphSAGE, 2 layers, hidden 128, fanouts (25, 10), 1,024 targets,
# metis_like at p = 4, DistDGL), one epoch through Start_training beside a
# directly built trainer (resident, "pallas_fused"), and the simulator
# calibrated from phase 4's and phase 5's p = 1 runs and one 2-epoch run
# of a 1-worker pool
API_P = 4
API_WORKER_EPOCHS = 2
CACHE_KEYS = ("cache_enabled", "cache_hit_rate", "miss_bytes",
              "miss_bytes_per_iter", "beta", "cache_admissions",
              "cache_evictions", "cache_refresh_bytes")
SEED = 0
RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-4
BWD_PARTIAL_CAP = 8 << 20   # fused_bwd's dw partials stay under this
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
# exponentials (ex2 on the special-function units): 16 a clock per SM on
# 132 SMs, at the clock ``nvidia-smi --query-gpu=clocks.max.sm`` reports
# (set in phase 1)
SFU_EXP_PER_CLOCK_PER_SM, H100_SMS = 16, 132
SFU_EXP_PER_S = None
# the LM zoo's serving paths: 4 prompts of 4,096 tokens, the cache grown by
# 16 slots, 16 greedy decode steps; a 256-token prefill first warms cuBLAS
# and the allocator; prefill/decode consistency in fp32 at 2 layers
LM_ARCHS = ("llama3-8b", "rwkv6-3b", "olmoe-1b-7b", "grok-1-314b")
LM_BATCH, LM_PROMPT, LM_WARM_PROMPT, LM_DECODE = 4, 4096, 256, 16
# phase 9b: the VLM backbone and the other dense configs at full depth;
# LLaVA-NeXT-34B serves one request (34.39 B parameters are ~68.8 GB in
# bf16): its 2,880 patch rows and 1,216 text tokens fill LM_PROMPT, the
# patch rows fetched on the host and uploaded with the tokens through
# the pinned staging ring, one copy a request
VLM_ARCH = "llava-next-34b"
DENSE_ARCHS = ("minicpm-2b", "starcoder2-7b", "yi-9b")
SERVE_BATCH = {VLM_ARCH: 1}
CONSIST_LAYERS, CONSIST_BATCH, CONSIST_PROMPT = 2, 2, 1024
CONSIST_TOL = 1e-4
# depth cuts, where the published depth does not fit the card: Grok-1
# serves 2 of its 64 layers (11.45 B parameters, ~22.9 GB in bf16; all 64
# would need ~633 GB) and runs the fp32 consistency check at 1 (6.53 B
# parameters, ~26 GB)
SERVE_LAYERS = {"grok-1-314b": 2}
CONSIST_LAYERS_BY_ARCH = {"grok-1-314b": 1}
# kernel vs plain on the card: fp32 at the reference's own kernel-test
# tolerances; bf16 at rtol 1e-2 (one bf16 rounding of the output on each
# side) with flash's atol 4e-3 x (P|v|) element-wise (each p rounded to
# bf16 once: 2^-8, plus fp32 sums) and wkv6's the fp32 one
FLASH_TOL = dict(rtol=1e-4, atol=2e-4)
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_RTOL = 1e-2
FLASH_BF16_P_ATOL = 4e-3
# the flash backward in bf16: the kernel and the plain version both round p
# and ds to bf16, so a last-bit difference in an fp32 value before the
# rounding can move it by one bf16 ulp (2^-7 of it at most): atol 8e-3 x
# the sum of |rounded factor| x |other factor| of each output element, plus
# the fp32 allowance
FLASH_BWD_BF16_ATOL = 8e-3
# ... and whether it rounds where the plain version does: the relative
# Frobenius error of each of dq, dk and dv against the plain version must
# stay under BWD_ROUNDING_LIMIT, and against the plain version with p's (for
# dv) or ds's (for dq, dk) rounding removed must exceed it. A kernel that
# rounds there differs from the plain version only where an fp32 last-bit
# difference moves a bf16 rounding (~3e-5 to 1.2e-4 in a CPU simulation);
# one that skips a rounding is off by ~2^-9 in every term (~2.5e-3)
BWD_ROUNDING_LIMIT = 2.0 ** -11
# the LM training phase: Llama-3-8B (and RWKV-6-3B, OLMoE-1B-7B) at its
# published widths, TRAIN_LAYERS deep (Llama's 32 layers with fp32 moments
# would need ~128 GB, OLMoE's 16 ~111 GB), bf16, remat
# "full", grad_accum 2 over a batch of 2 x 4,096 numpy-seeded tokens,
# TRAIN_STEPS AdamW steps on a cosine schedule; then one fp32 micro-step
# of 1 x TRAIN_CPU_SEQ tokens on the card against the CPU
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 2, 2, 4096
TRAIN_ACCUM, TRAIN_STEPS, TRAIN_CPU_SEQ = 2, 3, 128
# the VLM's fp32 micro-step against the CPU takes 64 patch rows and 64
# text tokens (its 2,880 patch rows would not fit TRAIN_CPU_SEQ)
TRAIN_CPU_PATCHES = 64
# each trained model's kernels: {launch count's name: (launches a layer and
# micro-batch, trace label, substring of its device kernels' names, device
# kernels a launch)}
_FLASH_TRAIN = {"flash_attention_fwd": (2, "flash_fwd", "flash_fwd", 1),
                "flash_attention_bwd": (1, "flash_bwd", "flash_bwd", 3)}
TRAIN_KERNELS = {
    "llama3-8b": _FLASH_TRAIN,
    "olmoe-1b-7b": _FLASH_TRAIN,
    VLM_ARCH: _FLASH_TRAIN,
    "rwkv6-3b": {"wkv6_chunk": (2, "wkv6_fwd", "wkv6_chunk_kernel", 1),
                 "wkv6_chunk_bwd": (1, "wkv6_bwd", "wkv6_bwd_", 3)}}
FWD = ("tile_off", "val", "tile_seg", "cols")
BWD = ("tile_off_t", "val_t", "tile_seg_t", "cols_t")
COMPACT = ("tile_id", "tile_off", "val", "cols")
COMPACT_T = ("tile_id_t", "tile_off_t", "val", "cols_t")
KERNEL_SOURCES = {
    "aggregate_blockcsr": (
        "src/repro_torch/kernels/csrc/aggregate_blockcsr.cu",
        "src/repro/kernels/aggregate.py:83"),
    "aggregate_edges": ("src/repro_torch/kernels/csrc/aggregate_edges.cu",
                        "src/repro/kernels/aggregate.py:275"),
    "aggregate_fused": ("src/repro_torch/kernels/csrc/aggregate_fused.cu",
                        "src/repro/kernels/aggregate.py:526"),
    "fused_bwd": ("src/repro_torch/kernels/csrc/aggregate_fused_bwd.cu",
                  "src/repro/kernels/aggregate.py:558"),
    "fused_bwd_merged": (
        "src/repro_torch/kernels/csrc/aggregate_fused_bwd.cu",
        "src/repro/kernels/aggregate.py:818"),
    "update_mlp": ("src/repro_torch/kernels/csrc/update_mlp.cu",
                   "src/repro/kernels/update_mlp.py:38"),
    "flash_attention_fwd": (
        "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention.py:22"),
    "wkv6_chunk": ("src/repro_torch/kernels/csrc/wkv6_chunk.cu",
                   "src/repro/kernels/wkv6.py:20"),
    # no TPU kernel: the counterparts of the reference's plain-JAX backwards
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/nn/attention.py:104"),
    "wkv6_chunk_bwd": ("src/repro_torch/kernels/csrc/wkv6_chunk_bwd.cu",
                       "src/repro/nn/rwkv6.py:79"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls.
    The card first spins for ~10 ms so that the host queues every call
    before the first runs: the events then time the device, not the host's
    launch rate (a small launch takes less time on the card than in
    Python). A call that syncs with the host keeps its host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, what: str, out, ref, rtol: float = RTOL,
                atol: float = ATOL) -> float:
    """Fails unless ``out`` matches ``ref`` within ``rtol`` and ``atol``
    times the largest magnitude of ``ref`` (at least 1; see the module
    docstring for the tolerances); returns the max abs error."""
    if out is None or ref is None:
        if out is not None or ref is not None:
            fail(f"{name}: {what} is {out} on the kernel, {ref} plain")
        return 0.0
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    return check_within(name, what, out, ref, rtol,
                        atol * scale)["max_abs_err"]


def check_within(name: str, what: str, out, ref, rtol: float,
                 atol) -> dict:
    """Fails unless ``out`` is finite, of ``ref``'s shape and within
    ``rtol`` |ref| + ``atol`` of ``ref`` element by element (``atol`` a
    number or a tensor of ``ref``'s shape). Returns the max abs error,
    the largest share of its allowance an element used, and the largest
    and mean magnitude of ``ref``, so the margin shows on the line."""
    if out.shape != ref.shape:
        fail(f"{name}: {what} has shape {tuple(out.shape)}, plain "
             f"{tuple(ref.shape)}")
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite {what}")
    if not out.numel():
        return {"max_abs_err": 0.0, "tol_used": 0.0}
    err = (out - ref).abs()
    allowed = rtol * ref.abs() + atol
    used = err / allowed.clamp_min(torch.finfo(torch.float32).tiny)
    worst = int(used.argmax())
    row = {"max_abs_err": float(err.max()), "tol_used": float(used.max()),
           "ref_max_abs": float(ref.abs().max()),
           "ref_mean_abs": float(ref.abs().mean())}
    if not bool((err <= allowed).all()):
        fail(f"{name}: {what} of the kernel disagrees with the plain "
             f"version: {int((err > allowed).sum())} of {err.numel()} "
             f"elements past their allowance; worst at flat index {worst}: "
             f"kernel {float(out.flatten()[worst])}, plain "
             f"{float(ref.flatten()[worst])}, allowed "
             f"{float(allowed.flatten()[worst])} ({row})")
    return row


def edge_coords(lay: dict, keys) -> tuple:
    """(dst row, src row, weight) of every valid edge of one launch's
    segments, on the host — for the CSR yardstick and the bound."""
    tile_off, val, seg, cols = (lay[k] for k in keys)
    n = int(seg[-1])
    max_blk = cols.shape[1]
    t = np.searchsorted(seg, np.arange(n), side="right") - 1
    i, k = t // max_blk, t % max_blk
    off = tile_off[:n].astype(np.int64)
    return (i * 128 + off // 128, cols[i, k].astype(np.int64) * 128
            + off % 128, val[:n])


def csr(lay: dict, keys, n_out: int, n_in: int) -> torch.Tensor:
    """The launch's A (or A^T) as a CSR on the card, for
    ``torch.sparse.mm``."""
    dst, src, w = edge_coords(lay, keys)
    with warnings.catch_warnings():  # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([dst, src])),
            torch.from_numpy(w.astype(np.float32)), (n_out, n_in),
            check_invariants=True).coalesce().to_sparse_csr().cuda()


def sparse_mm(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse.mm(a, h)


def segment_bytes(lay: dict, keys) -> int:
    """Bytes of a launch's valid edges (tile_off + val), seg and cols."""
    return (8 * int(lay[keys[2]][-1])
            + 4 * (len(lay[keys[2]]) + lay[keys[3]].size))


def bound(bytes_moved: int, flops: int, rate: float = FP32_FLOPS) -> dict:
    """The least time of a launch: its bytes over the memory rate or its
    flops over ``rate`` (the fp32 rate unless the launch's type has
    another), whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bytes": bytes_moved, "flops": flops, "op_rate": rate,
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bound_parts(bytes_moved: int, parts: dict, flops_fp32: int) -> dict:
    """The least time of a launch whose work runs on several units: the
    largest of its bytes over the memory rate and each part's count over
    its unit's rate (``parts``: {name: (count, rate)}; products at the TF32
    rate, elementwise flops at the fp32 rate, exponentials at the SFU's).
    ``bound_fp32_ms`` keeps the earlier bound, every flop (``flops_fp32``)
    at the fp32 rate, so rows stay comparable with it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_parts = {name: n / rate * 1e3 for name, (n, rate) in parts.items()}
    t_ops = max(t_parts.values())
    return {"bytes": bytes_moved,
            **{f"{name}": n for name, (n, _) in parts.items()},
            "op_rates": {name: rate for name, (_, rate) in parts.items()},
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            **{f"{name}_ms": t for name, t in t_parts.items()},
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fp32_ms": bound(bytes_moved, flops_fp32)["bound_ms"]}


def ptxas_usage(report: str) -> dict:
    """{kernel function: {registers, spill_bytes}} from ``nvcc -Xptxas
    -v``'s report (spill bytes: stores plus loads)."""
    usage, fn = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            usage[fn] = {"registers": None, "spill_bytes": 0,
                         "smem_bytes": 0}
        elif fn and "spill stores" in line:
            words = line.replace(",", "").split()
            usage[fn]["spill_bytes"] = (int(words[words.index("spill") - 2])
                                        + int(words[-4]))
        elif fn and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            usage[fn]["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                usage[fn]["smem_bytes"] = int(words[words.index("smem") - 2])
    return usage


def build_usage(usage: dict, key: str) -> dict:
    """The largest registers and spill bytes over the functions whose name
    holds ``key`` (one kernel's instantiations)."""
    hits = [u for fn, u in usage.items() if key in fn]
    if not hits:
        fail(f"no kernel function matching {key!r} in the build report")
    return {"registers": max(u["registers"] or 0 for u in hits),
            "spill_bytes": max(u["spill_bytes"] for u in hits),
            "build_functions": len(hits)}


def on_card(lay: dict, keys) -> list:
    return [torch.from_numpy(np.ascontiguousarray(lay[k])).cuda()
            for k in keys]


def report(row: dict) -> dict:
    print("launch " + json.dumps(row), flush=True)
    return row


def check_edges_launch(name, agg, lay, keys, h, n_out, usage):
    """aggregate_edges vs plain on the card, twice, bitwise equal; its
    shape (row groups, rows a group, columns a warp walks at once, load
    width, thread blocks, busy destination blocks), build (registers,
    spills of the launch's instantiation), times and bound for one
    launch."""
    args = on_card(lay, keys)
    out = agg.aggregate_edges(*args, h)
    again = agg.aggregate_edges(*args, h)
    ref = agg.aggregate_edges_plain(*args, h)
    torch.cuda.synchronize()
    max_abs = check_close(name, "out", out, ref)
    if not torch.equal(out, again):
        fail(f"{name}: two launches gave different bits")
    err = (out - ref).abs()
    max_rel = float((err / ref.abs().clamp_min(ATOL)).max())
    a = csr(lay, keys, n_out, h.shape[0])
    lib_err = float((sparse_mm(a, h) - ref).abs().max())
    dst, src, _ = edge_coords(lay, keys)
    F = h.shape[1]
    n_dstb, max_blk = lay[keys[3]].shape
    groups = agg.aggregate_edges_shape(
        n_dstb, F, torch.cuda.get_device_properties(0).multi_processor_count)
    vec = agg.aggregate_edges_vec(h)
    busy = int((np.diff(lay[keys[2]][::max_blk]) > 0).sum())
    row = {"kernel": "aggregate_edges", "launch": name, "edges": len(dst),
           "src_rows": len(np.unique(src)), "h": list(h.shape),
           "out": [n_out, F], "groups": groups, "rows_a_group": 128 // groups,
           "slab": 128, "vec": vec, "ctas": groups * n_dstb,
           "real_blocks": busy, "busy_ctas": groups * busy,
           **build_usage(usage, f"aggregate_edges_kernelILi{vec}E"),
           "max_abs_err": max_abs, "max_rel_err": max_rel,
           "bitwise_repeat": True, "library_max_abs_err": lib_err,
           "ms": time_ms(lambda: agg.aggregate_edges(*args, h)),
           "plain_ms": time_ms(lambda: agg.aggregate_edges_plain(*args, h)),
           "library_ms": time_ms(lambda: sparse_mm(a, h))}
    row.update(bound(segment_bytes(lay, keys)
                     + 4 * F * (row["src_rows"] + n_out),
                     2 * len(dst) * F))
    return report(row)


def update_rows(lay: dict, s) -> int:
    """Destination rows that hold an edge or a (nonzero) self term."""
    rows = set(edge_coords(lay, FWD)[0].tolist())
    if s is not None:
        rows |= set(torch.nonzero(s.abs().sum(1)).flatten().tolist())
    return len(rows)


def fused_shapes(lay: dict, h, w, s) -> dict:
    dst, src, _ = edge_coords(lay, FWD)
    n_dst_pad = lay["cols"].shape[0] * 128
    return {"edges": len(dst), "src_rows": len(np.unique(src)),
            "update_rows": update_rows(lay, s), "n_dst_pad": n_dst_pad,
            "h": list(h.shape), "w": list(w.shape), "self_term": s is not None}


def check_fused_fwd(name, agg, lay, h, w, usage, s=None):
    """aggregate_fused vs plain on the card, twice, bitwise equal; its
    shape (slab, cluster, rounds, thread blocks, busy destination blocks),
    build (registers, spills), device split, times, yardsticks and bound
    for one launch (no bias and no activation: the models keep those
    outside the kernel)."""
    args = on_card(lay, FWD)
    out = agg.aggregate_fused(*args, h, w, None, s)
    again = agg.aggregate_fused(*args, h, w, None, s)
    ref = agg.aggregate_fused_plain(*args, h, w, None, s)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        fail(f"{name}: two launches gave different bits")
    F, N = w.shape
    n_dstb = lay["cols"].shape[0]
    slab, cluster, rounds = agg.aggregate_fused_shape(
        n_dstb, F, N, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    seg = lay["tile_seg"][::lay["cols"].shape[1]]
    row = {"kernel": "aggregate_fused", "launch": name,
           **fused_shapes(lay, h, w, s),
           "smem_bytes": agg.aggregate_fused_smem_bytes(slab),
           "real_blocks": int((np.diff(seg) > 0).sum()), "n_dstb": n_dstb,
           "slab": slab, "cluster": cluster, "rounds": rounds,
           "ctas": cluster * n_dstb * -(-N // 128),
           "max_active_clusters": agg.aggregate_fused_max_clusters(
               slab, cluster),
           # the h rows the walk gathers, an edge's row once for each edge
           "gather_bytes": 4 * F * int(lay["tile_seg"][-1]),
           "max_abs_err": check_close(name, "out", out, ref),
           "bitwise_repeat": True,
           # this launch's instantiation: slab S, one or several rounds
           **build_usage(usage, f"aggregate_fused_kernelILi{slab}ELb"
                                f"{int(rounds > 1)}E"),
           "build": {fn[fn.index("aggregate_fused_kernel"):][:34]: u
                     for fn, u in usage.items()
                     if "aggregate_fused_kernel" in fn},
           "device_kernels": device_split(
               lambda: agg.aggregate_fused(*args, h, w, None, s))}
    n_dst_pad = row["n_dst_pad"]
    a = csr(lay, FWD, n_dst_pad, h.shape[0])

    def unfused():
        z = agg.aggregate_edges(*args, h)
        return (z if s is None else z + s) @ w

    def sparse():
        z = sparse_mm(a, h)
        return (z if s is None else z + s) @ w

    row.update(ms=time_ms(lambda: agg.aggregate_fused(*args, h, w, None, s)),
               plain_ms=time_ms(lambda: agg.aggregate_fused_plain(
                   *args, h, w, None, s)),
               library_ms=None, unfused_ms=time_ms(unfused),
               sparse_ms=time_ms(sparse))
    agg_flops = 2 * row["edges"] * F
    row.update(bound(segment_bytes(lay, FWD) + 4 * F * row["src_rows"]
                     + 4 * F * N + (4 * n_dst_pad * F if s is not None else 0)
                     + 4 * n_dst_pad * N,
                     agg_flops + 2 * row["update_rows"] * F * N))
    row["flops_all_rows"] = agg_flops + 2 * n_dst_pad * F * N
    return report(row)


def device_split(fn, calls: int = 10, counts: dict | None = None) -> dict:
    """Device milliseconds per call of ``fn`` by kernel, from
    ``torch.profiler`` over ``calls`` calls: {kernel name: ms}; with
    ``counts``, also fills it with each kernel's launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name.replace("(anonymous namespace)::", "")
            key = key.replace("void ", "").split("(")[0][-80:]
            split[key] = (split.get(key, 0.0)
                          + e.time_range.elapsed_us() / 1e3 / calls)
            if counts is not None:
                counts[key] = counts.get(key, 0) + 1
    if counts is not None:
        for key in counts:
            counts[key] /= calls
    return split


def check_fused_bwd(name, agg, lay, h, w, g, usage, s=None):
    """fused_bwd vs plain on the card (act none: dw only), twice, bitwise
    equal; its plan (real blocks, groups, slab, partial bytes), times
    (the whole call, and the dw kernel, the reduce and the plan's PyTorch
    ops apart, by the profiler), yardsticks and bound."""
    args = on_card(lay, FWD)
    got = agg.fused_bwd(*args, h, g, w, None, s)
    again = agg.fused_bwd(*args, h, g, w, None, s)
    want = agg.fused_bwd_plain(*args, h, g, w, None, s)
    torch.cuda.synchronize()
    err = max(check_close(name, what, a, b)
              for what, a, b in zip(("dw", "db", "dy"), got, want))
    if not torch.equal(got[0], again[0]):
        fail(f"{name}: two launches gave different dw bits")
    if got[1] is not None and not torch.equal(got[1], again[1]):
        fail(f"{name}: two launches gave different db bits")
    F, N = w.shape
    n_dstb = lay["cols"].shape[0]
    slab, groups = agg.fused_bwd_shape(n_dstb, F, N, torch.cuda
                                       .get_device_properties(0)
                                       .multi_processor_count)
    seg = lay["tile_seg"][::lay["cols"].shape[1]]
    split = device_split(lambda: agg.fused_bwd(*args, h, g, w, None, s))
    dw_ms = sum(t for k, t in split.items() if "fused_dw" in k)
    reduce_ms = sum(t for k, t in split.items() if "fused_reduce" in k)
    row = {"kernel": "fused_bwd", "launch": name,
           **fused_shapes(lay, h, w, s),
           "smem_bytes": agg.fused_bwd_smem_bytes(args[3].shape[1], slab),
           "real_blocks": int((np.diff(seg) > 0).sum()),
           # the h rows the walk gathers, an edge's row once for each edge
           "gather_bytes": 4 * F * int(lay["tile_seg"][-1]),
           "n_dstb": n_dstb, "groups": groups, "slab": slab,
           "ctas": groups * -(-F // slab) * -(-N // 128),
           "partial_bytes": groups * F * N * 4, "max_abs_err": err,
           "dw_bitwise_repeat": True,
           **build_usage(usage, "fused_dw"),
           "dw_kernel_ms": dw_ms, "reduce_ms": reduce_ms,
           "plan_ms": sum(split.values()) - dw_ms - reduce_ms,
           "device_kernels": split}
    if row["partial_bytes"] > BWD_PARTIAL_CAP:
        fail(f"{name}: {row['partial_bytes']} B of dw partials, over the "
             f"{BWD_PARTIAL_CAP} B cap")
    n_dst_pad = row["n_dst_pad"]
    a = csr(lay, FWD, n_dst_pad, h.shape[0])

    def unfused():
        z = agg.aggregate_edges(*args, h)
        return (z if s is None else z + s).T @ g

    def sparse():
        z = sparse_mm(a, h)
        return (z if s is None else z + s).T @ g

    row.update(ms=time_ms(lambda: agg.fused_bwd(*args, h, g, w, None, s)),
               plain_ms=time_ms(lambda: agg.fused_bwd_plain(
                   *args, h, g, w, None, s)),
               library_ms=None, unfused_ms=time_ms(unfused),
               sparse_ms=time_ms(sparse))
    agg_flops = 2 * row["edges"] * F
    row.update(bound(segment_bytes(lay, FWD) + 4 * F * row["src_rows"]
                     + 4 * row["update_rows"] * N  # g; no bias, no db
                     + (4 * n_dst_pad * F if s is not None else 0)
                     + 4 * F * N,
                     agg_flops + 2 * row["update_rows"] * F * N))
    row["flops_all_rows"] = agg_flops + 2 * n_dst_pad * F * N
    return report(row)


def check_merged(name, agg, lay, h, w, g, s, usage):
    """fused_bwd_merged vs plain on the card (one destination block, act
    none), twice, bitwise equal, and dh bitwise equal to the
    ``aggregate_edges`` kernel over A^T (the unfused branch's dh); its shape
    (dh row groups, dw row groups, thread blocks, load width), build
    (registers, spills, static and dynamic shared memory of the launch's
    instantiation), device split (one kernel a call), times, yardsticks and
    bound."""
    args = on_card(lay, FWD + BWD)
    dz = (g @ w.T).contiguous()
    got = agg.fused_bwd_merged(*args, h, g, dz, s)
    again = agg.fused_bwd_merged(*args, h, g, dz, s)
    want = agg.fused_bwd_merged_plain(*args, h, g, dz, s)
    dh_edges = agg.aggregate_edges(*args[4:], dz)
    torch.cuda.synchronize()
    err = max(check_close(name, what, a, b)
              for what, a, b in zip(("dw", "db", "dh"), got, want))
    for what, a, b in zip(("dw", "db", "dh"), got, again):
        if a is not None and not torch.equal(a, b):
            fail(f"{name}: two launches gave different {what} bits")
    if not torch.equal(got[2], dh_edges):
        fail(f"{name}: dh differs from the aggregate_edges kernel over A^T "
             f"in {int((got[2] != dh_edges).sum())} elements")
    F, N = w.shape
    n_srcb = lay["cols_t"].shape[0]
    dh_groups, dw_groups, ctas = agg.fused_bwd_merged_shape(
        n_srcb, F, N, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    vec = min(agg.aggregate_edges_vec(h), agg.aggregate_edges_vec(dz))
    key = f"fused_bwd_merged_kernelILi{vec}E"
    counts = {}
    split = device_split(lambda: agg.fused_bwd_merged(*args, h, g, dz, s),
                         counts=counts)
    if sum(counts.values()) != 1.0:
        fail(f"{name}: {counts} device kernels a call, expected one")
    row = {"kernel": "fused_bwd_merged", "launch": name,
           **fused_shapes(lay, h, w, s),
           "edges_t": int(lay["tile_seg_t"][-1]), "n_srcb": n_srcb,
           "dh_groups": dh_groups, "dw_groups": dw_groups, "ctas": ctas,
           "vec": vec, **build_usage(usage, key),
           "static_smem_bytes": max(u["smem_bytes"] for fn, u in usage.items()
                                    if key in fn),
           "dynamic_smem_bytes": agg.fused_bwd_merged_smem_bytes(
               F, dw_groups),
           "max_abs_err": err, "bitwise_repeat": True,
           "dh_equals_aggregate_edges": True,
           "device_kernels": split, "device_launches_a_call": counts}
    n_src = h.shape[0]
    a = csr(lay, FWD, 128, n_src)
    at = csr(lay, BWD, n_src, 128)

    def unfused():
        z = agg.aggregate_edges(*args[:4], h) + s
        return z.T @ g, agg.aggregate_edges(*args[4:], dz)

    def sparse():
        z = sparse_mm(a, h) + s
        return z.T @ g, sparse_mm(at, dz)

    row.update(ms=time_ms(lambda: agg.fused_bwd_merged(*args, h, g, dz, s)),
               plain_ms=time_ms(lambda: agg.fused_bwd_merged_plain(
                   *args, h, g, dz, s)),
               library_ms=None, unfused_ms=time_ms(unfused),
               sparse_ms=time_ms(sparse))
    agg_flops = 2 * (row["edges"] + row["edges_t"]) * F
    row.update(bound(segment_bytes(lay, FWD) + segment_bytes(lay, BWD)
                     + 4 * F * row["src_rows"] + 4 * row["update_rows"] * N
                     + 4 * 128 * 2 * F
                     + 4 * F * N + 4 * n_src * F,
                     agg_flops + 2 * row["update_rows"] * F * N))
    row["flops_all_rows"] = agg_flops + 2 * 128 * F * N
    return report(row)


def blockcsr_library(tiles, cols: np.ndarray, slots: np.ndarray,
                     n_in: int, lay: dict, keys) -> tuple:
    """(name, A) of the yardstick for one ``aggregate_blockcsr`` launch:
    a BSR tensor of the tiles that hold an edge (blocksize 128) where the
    installed PyTorch multiplies fp32 BSR on CUDA, else a CSR of the same
    edges from the launch's edge segments."""
    n_dstb, max_blk = cols.shape
    rows = slots // max_blk
    crow = np.zeros(n_dstb + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_dstb), out=crow[1:])
    with warnings.catch_warnings():  # BSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_bsr_tensor(
            torch.from_numpy(crow).cuda(),
            torch.from_numpy(cols[rows, slots % max_blk].astype(
                np.int64)).cuda(),
            tiles.view(-1, 128, 128)[torch.from_numpy(slots).cuda()],
            size=(n_dstb * 128, n_in))
        try:
            sparse_mm(a, torch.zeros((n_in, 1), device="cuda"))
            return "bsr", a
        except (RuntimeError, NotImplementedError) as e:
            print(f"no fp32 BSR product on CUDA here ({e}); the "
                  f"aggregate_blockcsr yardstick is a CSR", flush=True)
    return "csr", csr(lay, keys, n_dstb * 128, n_in)


def check_blockcsr_launch(name, agg, lay_c, keys, lay_e, keys_e, h,
                          iters: int = 20):
    """densify_tiles and aggregate_blockcsr on one launch's compact
    triples, as ``AggregateCompact`` runs them: the kernel walking only the
    real slots (``real_slot_counts``) vs the plain version on the card,
    the times (``densify_ms`` and ``counts_ms`` on their own), the BSR (or
    CSR) yardstick and the bound. ``lay_e`` / ``keys_e`` are the same
    launch's edge segments, for the CSR."""
    tile_id, tile_off, val, cols = (lay_c[k] for k in keys)
    dens = on_card(lay_c, keys)
    tiles = agg.densify_tiles(*dens[:3], *cols.shape)
    cols_d = dens[3]
    nblk = agg.real_slot_counts(dens[0], *cols.shape)
    out = agg.aggregate_blockcsr(tiles, cols_d, h, nblk)
    ref = agg.aggregate_blockcsr_plain(tiles, cols_d, h, nblk)
    torch.cuda.synchronize()
    n_dstb, max_blk = cols.shape
    F = h.shape[1]
    slots = np.unique(tile_id[val != 0]).astype(np.int64)
    counts = nblk.cpu().numpy()
    walked = np.concatenate([i * max_blk + np.arange(c)
                             for i, c in enumerate(counts)]).astype(np.int64)
    lib_name, a = blockcsr_library(tiles, cols, slots, h.shape[0], lay_e,
                                   keys_e)
    row = {"kernel": "aggregate_blockcsr", "launch": name,
           "dst_blocks": n_dstb, "slots": n_dstb * max_blk,
           "real_slots": len(slots), "real_slots_walked": len(walked),
           "max_real_slots": int(counts.max()), "h": list(h.shape),
           "out": [n_dstb * 128, F], "tile_bytes": tiles.numel() * 4,
           "smem_bytes": agg.aggregate_blockcsr_smem_bytes(),
           "max_abs_err": check_close(name, "out", out, ref),
           "library": lib_name,
           "library_max_abs_err": float((sparse_mm(a, h) - ref).abs().max())}
    short = dict(iters=iters, warmup=1 if iters < 5 else 3)
    row.update(
        densify_ms=time_ms(lambda: agg.densify_tiles(*dens[:3],
                                                     *cols.shape), **short),
        counts_ms=time_ms(lambda: agg.real_slot_counts(dens[0],
                                                       *cols.shape)),
        ms=time_ms(lambda: agg.aggregate_blockcsr(tiles, cols_d, h, nblk)),
        plain_ms=time_ms(lambda: agg.aggregate_blockcsr_plain(
            tiles, cols_d, h, nblk), **short),
        library_ms=time_ms(lambda: sparse_mm(a, h), **short))
    # the bytes the walk must move: the walked tiles and their cols, the
    # counts, the h rows of the source blocks they name, the output; the
    # real slots' flops at the TF32 rate, the fastest the card multiplies
    # fp32 inputs (the kernel's 3xTF32 split does three TF32 products per
    # product, so its own ceiling is a third of it)
    src_blocks = len(np.unique(cols.reshape(-1)[walked]))
    bytes_moved = (4 * len(walked) * (128 * 128 + 1) + 4 * n_dstb
                   + 4 * 128 * F * (src_blocks + n_dstb))
    row.update(bound(bytes_moved, 2 * 128 * 128 * F * len(slots),
                     TF32_FLOPS))
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    del tiles, a
    return report(row)


def check_update_launch(name, um, x, w, b, act, usage):
    """update_mlp vs plain on the card, its times, the ``torch.addmm``
    yardstick (``.relu_()`` after it for the relu launch) and the bound:
    the products at the TF32 rate, the fastest the card multiplies fp32
    inputs (the kernel's 3xTF32 split does three TF32 products per
    product), beside the earlier fp32-rate bound."""
    out = um.update_mlp(x, w, b, act)
    ref = um.update_mlp_plain(x, w, b, act)
    torch.cuda.synchronize()
    (M, K), N = x.shape, w.shape[1]
    if act == "none":
        def lib():
            return torch.addmm(b, x, w)
    elif act == "relu":
        def lib():
            return torch.addmm(b, x, w).relu_()
    else:
        fail(f"{name}: no yardstick for act {act!r}")
    tiles = um.plan(M, N, torch.cuda.get_device_properties(0)
                    .multi_processor_count)
    bm, bn = um.TILES[tiles]
    row = {"kernel": "update_mlp", "launch": name, "x": [M, K],
           "w": [K, N], "act": act, "route": "mma.sync 3xTF32",
           "tiles": [bm, bn], "thread_blocks": -(-M // bm) * -(-N // bn),
           "smem_bytes": um.update_mlp_smem_bytes(tiles),
           **build_usage(usage, f"TileILi{bm}ELi{bn}E"),
           "max_abs_err": check_close(name, "out", out, ref),
           "library": "torch.addmm" + (".relu_" if act == "relu" else ""),
           "ms": time_ms(lambda: um.update_mlp(x, w, b, act)),
           "plain_ms": time_ms(lambda: um.update_mlp_plain(x, w, b, act)),
           "library_ms": time_ms(lib)}
    flops = 2 * M * K * N
    row.update(bound_parts(4 * (M * K + K * N + N + M * N),
                           {"products_tf32": (flops, TF32_FLOPS)}, flops))
    row["tflops"] = flops / row["ms"] / 1e9
    return report(row)


def run_path(label, trainer, groups, expected, agg) -> dict:
    """Drive one path through ``run_iteration`` with every launch count set
    to 0 just before and read just after; fails on any other count per
    iteration than ``expected`` or on a non-finite loss. Each iteration
    line carries the store's running ``beta``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    agg.reset_launch_counts()
    steps = []
    for it, group in enumerate(groups):
        before = dict(agg.launch_counts)
        t0 = time.perf_counter()
        m = trainer.run_iteration(group)
        wall = time.perf_counter() - t0
        got = {k: agg.launch_counts[k] - before[k] for k in before}
        m.update(path=label, iteration=it, wall_s=wall, launches=got,
                 nvtps=m["vertices_traversed"] / wall,
                 beta=trainer.store.beta())
        print("iteration " + json.dumps(m), flush=True)
        if got != expected:
            fail(f"{label}: iteration {it} launched {got}, expected "
                 f"{expected}")
        if not np.isfinite(m["loss"]):
            fail(f"{label}: iteration {it} loss is {m['loss']}")
        steps.append(m)
    torch.cuda.synchronize()
    return {"steps": steps, "launches": dict(agg.launch_counts),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "aggregate_intermediate_bytes":
                trainer.aggregate_intermediate_bytes(),
            "densified_hbm_bytes": trainer.densified_hbm_bytes()}


def reference_loss(trainer_cls, graph, cfg, params, group,
                   flatten=None) -> tuple:
    """First loss of ``aggregate_backend="reference"`` from the same
    parameters and batch, and the peak device memory of that iteration.
    Given ``flatten`` (``repro_torch.nn.param.flatten``) the iteration
    runs twice, in two trainers, and must give bitwise the same loss and
    updated parameters."""
    repeat = flatten is not None
    runs = []
    for _ in range(2 if repeat else 1):
        ref = trainer_cls(graph, dataclasses.replace(
            cfg, aggregate_backend="reference"), num_devices=1,
            algorithm="distdgl", seed=SEED, device="cuda", params=params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = ref.run_iteration(group)["loss"]
        torch.cuda.synchronize()
        runs.append((loss, torch.cuda.max_memory_allocated(),
                     [p.detach().cpu() for p in flatten(ref.params)]
                     if repeat else None))
        del ref
    if repeat:
        (l0, _, p0), (l1, _, p1) = runs
        same = l0 == l1 and all(torch.equal(a, b) for a, b in zip(p0, p1))
        print(f"reference datapath twice from the same parameters and "
              f"batch: losses {l0!r} and {l1!r}, parameters "
              f"{'bitwise equal' if same else 'DIFFERENT'}", flush=True)
        if not same:
            fail("the reference datapath does not repeat its bits")
    return runs[0][0], runs[0][1]


def check_resident(label, run, host_run) -> None:
    """A ``data_parallel`` run against the host-gather run of the same
    backend and batches: the same first loss bit for bit, the shard
    uploaded at the first step and never again."""
    first, host_first = run["steps"][0]["loss"], host_run["steps"][0]["loss"]
    if first != host_first:
        fail(f"{label}: first loss {first!r}, host-gather run "
             f"{host_first!r}")
    uploads = [m["shard_upload_s"] for m in run["steps"]]
    if not uploads[0] > 0 or any(uploads[1:]):
        fail(f"{label}: shard_upload_s {uploads}: one upload, at the first "
             f"step")
    print(f"{label}: first loss {first!r}, bitwise the host-gather run's",
          flush=True)


def check_assembly(name, assemble, payload, store, features, mb,
                   dev) -> dict:
    """``assemble_device_feats`` at one batch on the card against
    ``FeatureStore.gather`` (bit for bit), from the trainer's index payload
    (``payload``: ``core.trainer.resident_payload``), timed by CUDA events.
    Its bound counts the bytes it must move: the valid rows read (from the
    shard or the shipped miss rows), the (N_0, f) block written and the
    index arrays."""
    ids = np.asarray(mb.nodes[0])
    valid = np.asarray(mb.node_mask[0], bool)
    idx = payload(store.core, dev, ids, valid)
    shard = torch.from_numpy(store.build_shard_matrix()[dev]).cuda()
    batch = {k: torch.from_numpy(a).cuda() for k, a in idx.items()}
    batch["miss_rows"] = torch.from_numpy(
        features[ids[idx["miss_pos"]]]).cuda()
    batch["node_mask"] = [torch.from_numpy(valid).cuda()]
    got = assemble(shard, batch)
    want = torch.from_numpy(store.gather(dev, ids, valid)).cuda()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"{name}: the block assembled on the card differs from "
             f"FeatureStore.gather")
    del got, want
    n, f = ids.shape[0], features.shape[1]
    n_valid = int(valid.sum())
    moved = n_valid * f * 4 + n * f * 4 + sum(a.nbytes for a in idx.values())
    b = bound(moved, 0)
    row = {"name": name, "kernel": "assemble_device_feats",
           "route": "pytorch", "device": dev, "rows": n,
           "valid_rows": n_valid, "hit_rows": len(idx["hit_idx"]),
           "miss_rows": len(idx["miss_pos"]), "shard_rows": shard.shape[0],
           "bitwise_equal_gather": True,
           "ms": time_ms(lambda: assemble(shard, batch)), **b}
    del shard, batch
    torch.cuda.empty_cache()
    return report(row)


def check_p3_assembly(name, assemble, payload, store, features,
                      mb) -> dict:
    """``assemble_p3_feats`` at one batch on the card against
    ``FeatureStore.gather_p3_full`` (bit for bit), from the trainer's index
    payload and the (p, V, chunk) slice matrix, timed by CUDA events. Its
    bound counts the bytes it must move: each valid row's p slices read,
    the (N_0, f) block written and the index arrays."""
    ids = np.asarray(mb.nodes[0])
    valid = np.asarray(mb.node_mask[0], bool)
    idx = payload(store.core, 0, ids, valid)
    keys = ("hit_idx", "hit_pos")
    shards = torch.from_numpy(store.build_shard_matrix()).cuda()
    batch = {k: torch.from_numpy(idx[k]).cuda() for k in keys}
    batch["node_mask"] = [torch.from_numpy(valid).cuda()]
    f = features.shape[1]
    got = assemble(shards, batch, f)
    want = torch.from_numpy(store.gather_p3_full(ids, valid)).cuda()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"{name}: the block assembled on the card differs from "
             f"FeatureStore.gather_p3_full")
    del got, want
    p, _, chunk = shards.shape
    n, n_valid = ids.shape[0], int(valid.sum())
    moved = (n_valid * p * chunk * 4 + n * f * 4
             + sum(idx[k].nbytes for k in keys))
    row = {"name": name, "kernel": "assemble_p3_feats", "route": "pytorch",
           "devices": p, "chunk": chunk, "rows": n, "valid_rows": n_valid,
           "shard_bytes": shards.numel() * 4,
           "bitwise_equal_gather_p3_full": True,
           "ms": time_ms(lambda: assemble(shards, batch, f)),
           **bound(moved, 0)}
    del shards, batch
    torch.cuda.empty_cache()
    return report(row)


def p3_paths(SyncGNNTrainer, sched, graph, cfg, params0, per_iter, runs,
             resident, agg) -> None:
    """P3 at p = 4 on each backend of ``per_iter`` ({backend: the p = 1
    path's launches an iteration}), host gather and resident: each count
    p times the p = 1 one, the same first loss on both feature paths bit
    for bit, beta exactly 1, no miss row shipped and the same per-device
    accounting."""
    p = P3_DEVICES
    for backend, counts in per_iter.items():
        stats = {}
        for dp in (False, True):
            key = f"p3_{backend}" + ("_resident" if dp else "")
            tr = SyncGNNTrainer(
                graph, dataclasses.replace(cfg, aggregate_backend=backend),
                num_devices=p, algorithm="p3", seed=SEED, device="cuda",
                params=params0, data_parallel=dp)
            groups = list(sched.iterations(
                tr.epoch_schedule()))[:P3_ITERATIONS]
            runs[key] = run_path(
                f"graphsage/{backend}/p3/p{p}" + ("/resident" if dp else ""),
                tr, groups, {k: p * v for k, v in counts.items()}, agg)
            stats[dp] = [dataclasses.astuple(st) for st in tr.store.stats]
            if tr.store.beta() != 1.0:
                fail(f"{key}: beta {tr.store.beta()!r}, P3 misses nothing")
            if dp:
                resident[key] = tr.store
            del tr
        label = f"graphsage/{backend}/p3/p{p}/resident"
        check_resident(label, runs[f"p3_{backend}_resident"],
                       runs[f"p3_{backend}"])
        shipped = sum(m["miss_rows"]
                      for m in runs[f"p3_{backend}_resident"]["steps"])
        if shipped:
            fail(f"{label}: {shipped} miss rows shipped, P3 ships none")
        if stats[True] != stats[False]:
            fail(f"{label}: resident accounting {stats[True]} differs from "
                 f"the host gather's {stats[False]}")
        print(f"{label}: beta 1.0, no miss row, accounting (local rows and "
              f"bytes per device) equal to the host gather's", flush=True)
        torch.cuda.empty_cache()


def gat_paths(SyncGNNTrainer, sched, graph, cfg, none, runs, agg, flatten,
              params_to_numpy) -> dict:
    """GAT at the paper width, p = 1: ``GAT_ITERATIONS`` iterations on the
    host gather and resident, and configured ``"pallas_fused"``, each with
    no launch; finite losses; the first iteration twice from the same
    parameters and batch, bitwise; the resident and the ``"pallas_fused"``
    runs bitwise the host gather's (every loss, and the parameters after);
    the first loss within rtol 1e-4 of the same iteration on the CPU.
    Returns its initial parameters (numpy), for phase 5."""
    cfg_g = dataclasses.replace(cfg, name="gat", aggregate_backend=
                                "reference")
    tr = SyncGNNTrainer(graph, cfg_g, num_devices=1, algorithm="distdgl",
                        seed=SEED, device="cuda")
    params0 = params_to_numpy(tr.params)
    groups = list(sched.iterations(tr.epoch_schedule()))[:GAT_ITERATIONS]
    first, _ = reference_loss(SyncGNNTrainer, graph, cfg_g, params0,
                              groups[0], flatten)
    runs["gat"] = run_path("gat/reference", tr, groups, none, agg)
    final = [q.detach().cpu() for q in flatten(tr.params)]
    del tr
    if runs["gat"]["steps"][0]["loss"] != first:
        fail(f"gat: first loss {runs['gat']['steps'][0]['loss']!r}, the "
             f"repeated iteration's {first!r}")
    for key, kw in (("gat_resident", dict(data_parallel=True)),
                    ("gat_pallas_fused", dict(cfg=dataclasses.replace(
                        cfg_g, aggregate_backend="pallas_fused")))):
        tr = SyncGNNTrainer(graph, kw.pop("cfg", cfg_g), num_devices=1,
                            algorithm="distdgl", seed=SEED, device="cuda",
                            params=params0, **kw)
        if tr._blk_caps:
            fail(f"{key}: GAT built a kernel layout")
        runs[key] = run_path(f"gat/{key[4:]}", tr, groups, none, agg)
        got = [m["loss"] for m in runs[key]["steps"]]
        want = [m["loss"] for m in runs["gat"]["steps"]]
        same = all(torch.equal(q.detach().cpu(), r)
                   for q, r in zip(flatten(tr.params), final))
        del tr
        if got != want or not same:
            fail(f"{key}: losses {got}, host gather {want}; parameters "
                 f"{'equal' if same else 'different'}")
        print(f"gat/{key[4:]}: {len(got)} losses and the parameters after "
              f"bitwise the host-gather run's, no launch", flush=True)
    check_resident("gat/resident", runs["gat_resident"], runs["gat"])
    cpu = SyncGNNTrainer(graph, cfg_g, num_devices=1, algorithm="distdgl",
                         seed=SEED, device="cpu", params=params0)
    cpu_loss = cpu.run_iteration(groups[0])["loss"]
    del cpu
    check_first_loss("gat (card vs the port on the CPU)", runs["gat"],
                     cpu_loss)
    torch.cuda.empty_cache()
    return params0


def check_first_loss(label, run, ref_loss) -> None:
    first = run["steps"][0]["loss"]
    if not np.isclose(first, ref_loss, rtol=LOSS_RTOL, atol=0):
        fail(f"{label}: first loss {first} vs reference backend {ref_loss}")
    print(f"{label}: first loss {first!r} vs reference backend "
          f"{ref_loss!r}", flush=True)


def kernel_entry(name, rows, launches_by_path) -> dict:
    """One kernel's entry of the ``kernels`` line: times and bounds summed
    over the checked launches at the main paths' shapes (``main_path``,
    default true), the largest error over every checked launch."""
    src, replaces = KERNEL_SOURCES[name]
    main = [r for r in rows if r.get("main_path", True)]
    t_bytes = sum(r["bytes_ms"] for r in main)
    t_ops = sum(r["ops_ms"] for r in main)

    def total(key):
        vals = [r[key] for r in main]
        return None if None in vals else sum(vals)

    entry = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces,
             "launches": sum(launches_by_path.values()),
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": total("ms"), "plain_ms": total("plain_ms"),
             "bound_ms": total("bound_ms"),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": total("library_ms"),
             "launches_by_path": launches_by_path}
    if "unfused_ms" in rows[0]:
        entry.update(unfused_ms=total("unfused_ms"),
                     sparse_ms=total("sparse_ms"))
    entry["per_launch"] = rows
    return entry

# ---------------------------------------------------------------------------
# the LM zoo: flash_attention_fwd and wkv6_chunk, and serving
# ---------------------------------------------------------------------------

def check_flash_launch(name, fa, B, Sq, Sk, H, KH, D, dtype, causal,
                       main_path, iters=5):
    """flash_attention_fwd vs its plain version on the card at (B, S, H, D)
    with KH kv heads, its times, the SDPA yardstick (k and v repeated to H
    heads beforehand, outside the timing) and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((B, S, h, D), device="cuda", generator=gen
                           ).to(dtype)
               for S, h in ((Sq, H), (Sk, KH), (Sk, KH)))
    out = fa.flash_attention_fwd(q, k, v, causal)
    ref = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        tol = check_within(name, "out", out, ref, FLASH_TOL["rtol"],
                           FLASH_TOL["atol"] * max(1.0, float(
                               ref.abs().max())))
    else:
        # the kernel rounds each p to bf16 (relative 2^-8) before PV: an
        # output moves by at most 2^-8 (P|v|), P|v| from the plain version
        p_abs_v = fa.flash_attention_plain(q.float(), k.float(),
                                           v.float().abs(), causal)
        tol = check_within(name, "out", out, ref, BF16_RTOL,
                           FLASH_BF16_P_ATOL * p_abs_v)
        tol["p_abs_v_mean"] = float(p_abs_v.mean())
        del p_abs_v
    del ref
    G = H // KH
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
    lib_err = float((sdpa().transpose(1, 2).float() - out.float())
                    .abs().max())
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    elt = q.element_size()
    row = {"kernel": "flash_attention_fwd", "launch": name,
           "main_path": main_path, "q": [B, Sq, H, D], "kv": [B, Sk, KH, D],
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "route": fa.ROUTES[dtype],
           "smem_bytes": fa.flash_attention_fwd_smem_bytes(D, dtype), **tol,
           "library": "scaled_dot_product_attention",
           "library_vs_kernel_max_abs": lib_err,
           "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal),
                         iters=iters, warmup=1),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(
               q, k, v, causal), iters=2, warmup=1),
           "library_ms": time_ms(sdpa, iters=10)}
    row.update(bound(elt * (2 * B * Sq * H * D + 2 * B * Sk * KH * D),
                     4 * D * pairs * B * H,
                     FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS))
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    del q, k, v, qt, kt, vt, out
    torch.cuda.empty_cache()
    return report(row)


def vlm_dense_flash_launches(fa) -> list:
    """flash_attention_fwd against its plain version at the prefills of
    phase 9b (the main path's launches): LLaVA-NeXT-34B's one request of
    4,096 positions (56 query heads over 8: a GQA group of 7), MiniCPM-2B
    (36 over 36 of 64), StarCoder2-7B (36 over 4: G 9) and Yi-9B (32 over
    4: G 8) at 4 x 4,096; and LLaVA's shape on the fp32 (FMA) route."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        check_flash_launch("llava_next_34b_prefill", fa,
                           SERVE_BATCH[VLM_ARCH], LM_PROMPT, LM_PROMPT, 56,
                           8, 128, bf16, True, True),
        check_flash_launch("llava_next_34b_prefill_fp32", fa,
                           SERVE_BATCH[VLM_ARCH], LM_PROMPT, LM_PROMPT, 56,
                           8, 128, f32, True, False),
        check_flash_launch("minicpm_2b_prefill", fa, LM_BATCH, LM_PROMPT,
                           LM_PROMPT, 36, 36, 64, bf16, True, True),
        check_flash_launch("starcoder2_7b_prefill", fa, LM_BATCH, LM_PROMPT,
                           LM_PROMPT, 36, 4, 128, bf16, True, True),
        check_flash_launch("yi_9b_prefill", fa, LM_BATCH, LM_PROMPT,
                           LM_PROMPT, 32, 4, 128, bf16, True, True)]


def wkv6_flops(S: int, K: int, chunk: int = 16) -> tuple:
    """(products, elementwise flops, exponentials) of the chunked WKV6
    recurrence over S tokens of one head (K = V): per chunk of L tokens the
    products r~ S (2 L K K), A v over the L(L-1)/2 pairs and the diagonal
    (2 (pairs + L) K) and k~^T v (2 L K K); the pairwise sums of A (a
    multiply and a multiply-add per pair and channel, and the difference
    of exponents), the bonus, the decayed rows, the cumsums and the state's
    decay (2 K K); the pairs' exponentials and the 2 L K + K of the decayed
    rows and exp(c_last)."""
    products = elementwise = exps = 0
    for t0 in range(0, S, chunk):
        L = min(chunk, S - t0)
        pairs = L * (L - 1) // 2
        products += 2 * L * K * K + 2 * (pairs + L) * K + 2 * L * K * K
        elementwise += (6 * pairs * K + 3 * L * K + 2 * L * K + 2 * K * K
                        + L * K)
        exps += pairs * K + 2 * L * K + K
    return products, elementwise, exps


def check_wkv6_launch(name, wk, B, S, H, K, dtype, with_state, main_path,
                      usage, iters=10):
    """wkv6_chunk vs its plain version on the card (y and the final state),
    its times and the bound (products at the TF32 rate, elementwise flops
    at the fp32 rate, exponentials at the SFU's, beside the earlier
    fp32-rate bound); no single PyTorch call computes it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale
    r, k, v = (randn(B, S, H, K, scale=0.5).to(dtype) for _ in range(3))
    lw = -randn(B, S, H, K).exp()
    u = randn(H, K, scale=0.5).to(dtype)
    s0 = randn(B, H, K, K) if with_state else None
    y, st = wk.wkv6_chunk(r, k, v, lw, u, s0)
    y_p, st_p = wk.wkv6_chunk_plain(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    scale = max(1.0, float(y_p.abs().max()))
    tol = check_within(name, "y", y, y_p, WKV_TOL["rtol"]
                       if dtype == torch.float32 else BF16_RTOL,
                       WKV_TOL["atol"] * scale)
    tol_s = check_within(name, "state", st, st_p, WKV_TOL["rtol"],
                         WKV_TOL["atol"] * max(1.0, float(
                             st_p.abs().max())))
    tol.update(max_abs_err=max(tol["max_abs_err"], tol_s["max_abs_err"]),
               state_tol_used=tol_s["tol_used"])
    products, elementwise, exps = (n * B * H for n in wkv6_flops(S, K))
    hpb = wk.heads_per_block(B * H, torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    elt = r.element_size()
    row = {"kernel": "wkv6_chunk", "launch": name, "main_path": main_path,
           "r": [B, S, H, K], "dtype": str(dtype).replace("torch.", ""),
           "initial_state": with_state, "route": "mma.sync 3xTF32",
           "heads_per_block": hpb, "thread_blocks": -(-B * H // hpb),
           "smem_bytes": wk.wkv6_chunk_smem_bytes(K, dtype, hpb),
           **build_usage(usage, "wkv6_chunk_kernelI" + (
               "f" if dtype == torch.float32 else "13__nv_bfloat16")
               + f"Li{K}ELi{hpb}E"), **tol,
           "ms": time_ms(lambda: wk.wkv6_chunk(r, k, v, lw, u, s0),
                         iters=iters),
           "plain_ms": time_ms(lambda: wk.wkv6_chunk_plain(
               r, k, v, lw, u, s0), iters=2, warmup=1),
           "library_ms": None}
    row.update(bound_parts(
        elt * (4 * B * S * H * K + H * K) + 4 * B * S * H * K
        + 4 * B * H * K * K * (2 if with_state else 1),
        {"products_tf32": (products, TF32_FLOPS),
         "elementwise_fp32": (elementwise, FP32_FLOPS),
         "exponentials": (exps, SFU_EXP_PER_S)},
        products + elementwise))
    row["tflops"] = (products + elementwise) / row["ms"] / 1e9
    del r, k, v, lw, y, y_p
    torch.cuda.empty_cache()
    return report(row)


def wkv6_bwd_flops(S: int, K: int, chunk: int = 16) -> tuple:
    """(products, elementwise flops, exponentials) of the WKV6 backward
    over S tokens of one head (K = V), counted as ``wkv6_flops`` counts the
    forward: per chunk of L tokens the products S dy, dS v and k~ dS and
    the two walks' rank-L updates of the state and of its cotangent (2 L K
    K each); the pairs' work for A (a difference of exponents, two
    multiplies and an add a channel), G, dr', dk' (four a channel each) and
    dv's pairs; the bonus terms, cumsums, decayed rows, du and dlw's scan
    (20 L K) and its rowsum (2 K K); the exponentials each pair and token
    needs once (the kernel forms each pair's once, too)."""
    products = elementwise = exps = 0
    for t0 in range(0, S, chunk):
        L = min(chunk, S - t0)
        pairs = L * (L - 1) // 2
        products += 5 * 2 * L * K * K
        elementwise += (12 * pairs * K + 4 * (pairs + L) * K + 20 * L * K
                        + 2 * K * K)
        exps += pairs * K + 2 * L * K + K
    return products, elementwise, exps


def check_wkv6_bwd_launch(name, wk, B, S, H, K, dtype, with_state,
                          main_path, usage, iters=10):
    """wkv6_chunk_bwd vs its plain version on the card (dr, dk, dv, dlw,
    du and, with a state, ds0; ``with_state`` also gives the final state a
    cotangent), two launches bitwise alike, its times and the bound (as
    ``check_wkv6_launch``'s); no single PyTorch call computes it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale
    r, k, v = (randn(B, S, H, K, scale=0.5).to(dtype) for _ in range(3))
    lw = -randn(B, S, H, K).exp()
    u = randn(H, K, scale=0.5).to(dtype)
    dy = randn(B, S, H, K).to(dtype)
    s0, ds = ((randn(B, H, K, K), randn(B, H, K, K)) if with_state
              else (None, None))
    args = (r, k, v, lw, u, s0, dy, ds)
    got = wk.wkv6_chunk_bwd(*args)
    again = wk.wkv6_chunk_bwd(*args)
    plain = wk.wkv6_chunk_bwd_plain(*args)
    torch.cuda.synchronize()
    if not all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, again)):
        fail(f"{name}: two wkv6_chunk_bwd launches gave different bits")
    used, err = {}, 0.0
    for what, g, w in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), got,
                          plain):
        if w is None or g is None:
            if g is not None or w is not None:
                fail(f"{name}: {what} is {g} on the kernel, {w} plain")
            continue
        rtol = (BF16_RTOL if what in ("dr", "dk", "dv")
                and dtype != torch.float32 else WKV_TOL["rtol"])
        tol = check_within(name, what, g, w, rtol, WKV_TOL["atol"] * max(
            1.0, float(w.abs().max())))
        used[what] = tol["tol_used"]
        err = max(err, tol["max_abs_err"])
    products, elementwise, exps = (n * B * H for n in wkv6_bwd_flops(S, K))
    t = "f" if dtype == torch.float32 else "13__nv_bfloat16"

    def pass_usage(key):   # the build report's, static shared memory too
        return {**build_usage(usage, key), "static_smem_bytes": max(
            u["smem_bytes"] for fn, u in usage.items() if key in fn)}
    smem = wk.wkv6_chunk_bwd_smem_bytes(K, dtype)
    fits = wk.wkv6_chunk_bwd_blocks_per_sm(K, dtype)   # the runtime's count
    passes = {
        "walk": {**pass_usage(f"wkv6_bwd_walkI{t}Li{K}E"),
                 "thread_blocks": 2 * B * H * K // 16,
                 "smem_bytes": smem["walk"], "blocks_per_sm": fits["walk"]},
        "span": {**pass_usage(f"wkv6_bwd_spanI{t}Li{K}E"),
                 "thread_blocks": B * H * -(-S // wk.SPAN),
                 "smem_bytes": smem["span"], "blocks_per_sm": fits["span"]},
        "du": pass_usage("wkv6_bwd_du")}
    elt = r.element_size()
    row = {"kernel": "wkv6_chunk_bwd", "launch": name,
           "main_path": main_path, "r": [B, S, H, K],
           "dtype": str(dtype).replace("torch.", ""),
           "initial_state": with_state, "final_cotangent": with_state,
           "route": "mma.sync 3xTF32", "passes": passes,
           "max_abs_err": err,
           "tol_used": max(used.values()), "tol_used_by_grad": used,
           "repeat_bitwise": True,
           "ms": time_ms(lambda: wk.wkv6_chunk_bwd(*args), iters=iters),
           "plain_ms": time_ms(lambda: wk.wkv6_chunk_bwd_plain(*args),
                               iters=2, warmup=1),
           "library_ms": None, "yardstick": None}
    if main_path:   # by pass; a first trace this late can come back empty
        traced(lambda: torch.ones(1, device="cuda").add_(1))
        row["device_split"] = device_split(
            lambda: wk.wkv6_chunk_bwd(*args), calls=5)
    row.update(bound_parts(
        elt * (7 * B * S * H * K + H * K) + 4 * (2 * B * S * H * K + H * K)
        + 4 * B * H * K * K * (3 if with_state else 0),
        {"products_tf32": (products, TF32_FLOPS),
         "elementwise_fp32": (elementwise, FP32_FLOPS),
         "exponentials": (exps, SFU_EXP_PER_S)},
        products + elementwise))
    row["tflops"] = (products + elementwise) / row["ms"] / 1e9
    del args, got, again, plain, r, k, v, lw, dy, s0, ds
    torch.cuda.empty_cache()
    return report(row)


def wkv6_bwd_launches(wk, usage) -> list:
    """Phase 11b's checked launches of wkv6_chunk_bwd: RWKV-6-3B's training
    shape (the main path), fp32 with both states, and a ragged length."""
    return [
        check_wkv6_bwd_launch("rwkv6_3b_train", wk, 1, TRAIN_SEQ, 40, 64,
                              torch.bfloat16, False, True, usage),
        check_wkv6_bwd_launch("fp32_with_states", wk, 1, 512, 40, 64,
                              torch.float32, True, False, usage),
        check_wkv6_bwd_launch("ragged_with_states", wk, 1, 1007, 40, 64,
                              torch.bfloat16, True, False, usage)]


def traced(fn, cpu: bool = True, match: dict | None = None,
           top: int = 0) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (to a
    synchronize), the device kernels it ran, the time the device was busy
    (the union of their intervals, so kernels and copies that overlap on
    two streams count once) and the device's idle share of the wall time.
    ``cpu=False`` traces the device alone, which keeps the profiler off the
    host's critical path. ``match`` ({label: substring}) adds, for each
    label, the count and device ms of the kernels whose name holds the
    substring; ``top`` > 0 adds the ``top`` kernel names with the most
    device ms (names cut to 80 characters), with their ms and count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                            else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    busy_ms = busy_us / 1e3
    row = {"wall_ms": wall_ms, "device_kernels": len(kernels),
           "device_busy_ms": busy_ms,
           "device_idle_share": (1 - busy_ms / wall_ms) if kernels
           else None}
    for label, key in (match or {}).items():
        hits = [e for e in kernels if key in e.name]
        row[f"{label}_kernels"] = len(hits)
        row[f"{label}_ms"] = sum(e.time_range.end - e.time_range.start
                                 for e in hits) / 1e3
    if top:
        by_name = {}
        for e in kernels:
            ms, n = by_name.get(e.name[:80], (0.0, 0))
            by_name[e.name[:80]] = (
                ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
        row["top_kernels"] = sorted(
            ([name, ms, n] for name, (ms, n) in by_name.items()),
            key=lambda r: -r[1])[:top]
    return row


@contextlib.contextmanager
def recording_ranks(out: list):
    """While active, each call of ``nn.moe.rank`` appends (its kept pairs,
    a count on the card, and its pairs) to ``out``: one entry a MoE layer
    a forward. Reading the counts waits for the card, so the caller reads
    them after its timing."""
    from repro_torch.nn import moe
    rank = moe.rank

    def recording(experts, m, C):
        slots = rank(experts, m, C)
        out.append((slots.keep.sum(), slots.keep.numel()))
        return slots
    moe.rank = recording
    try:
        yield out
    finally:
        moe.rank = rank


def drop_shares(kept: list) -> dict:
    """The (token, slot) pairs dropped at capacity, layer by layer, from a
    forward's ``recording_ranks`` entries."""
    pairs = [n for _, n in kept]
    dropped = [n - int(k) for k, n in kept]
    return {"pairs_per_layer": pairs[0] if pairs else 0,
            "dropped_pairs_by_layer": dropped,
            "drop_share_by_layer": [d / n for d, n in zip(dropped, pairs)],
            "drop_share": sum(dropped) / max(1, sum(pairs))}


def serve(arch) -> dict:
    """One model at its published width and depth through the serving
    entry points, in bf16 from a seeded init: a warm-up prefill, the
    prefill of LM_BATCH prompts of LM_PROMPT numpy-seeded tokens, the cache
    grown by LM_DECODE slots (``examples/lm_serve.py``), then LM_DECODE
    greedy decode steps. Launch counts are zeroed before and read after
    each prefill and each decode step: exactly one launch of the model's
    kernel per layer and prefill, none per decode step. A VLM serves
    SERVE_BATCH requests: the warm-up is text alone; the prefill's P patch
    rows (numpy-seeded on the host, ``models.registry.sample_inputs``) and
    LM_PROMPT - P text tokens cross the bus in one copy a request through
    the pinned staging ring (``core.staging.upload_tensors``), inside the
    prefill's time, and decoding goes on at position LM_PROMPT."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.core.staging import StagingRing, upload_tensors
    from repro_torch.kernels import build as build_mod
    from repro_torch.launch import steps
    from repro_torch.models.registry import build, sample_inputs
    from repro_torch.nn.layers import pad_vocab
    from repro_torch.nn.moe import capacity
    from repro_torch.nn.param import flatten
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=SERVE_LAYERS.get(arch, cfg.n_layers))
    B = SERVE_BATCH.get(arch, LM_BATCH)
    vocab = pad_vocab(cfg.vocab_size)  # -1e30 past the real vocab
    kernel = {"dense": "flash_attention_fwd", "moe": "flash_attention_fwd",
              "vlm": "flash_attention_fwd", "ssm": "wkv6_chunk"}[cfg.family]
    bundle = build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = bundle.init_params(SEED, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    weight_bytes = sum(t.numel() * t.element_size() for t in flatten(params))
    prefill = steps.make_prefill_step(bundle)
    decode = steps.make_decode_step(bundle)
    rng = np.random.default_rng(SEED)
    launches = {kernel: 0}
    none = {k: 0 for k in build_mod.launch_counts}
    upload, stage_s = {}, {}
    for label, S in (("warmup", LM_WARM_PROMPT), ("prefill", LM_PROMPT)):
        t_in = time.perf_counter()
        if cfg.family == "vlm" and label == "prefill":
            host = sample_inputs(cfg, ShapeSpec("serve", S, B, "prefill"),
                                 rng, "cpu")
            ring = StagingRing(1, torch.device("cuda"))
        else:
            host = None
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()}
        torch.cuda.synchronize()
        build_mod.reset_launch_counts()
        kept = []
        t0 = time.perf_counter()
        if host is not None:  # the request's one copy, then its prefill
            batch = upload_tensors(ring, host)
            torch.cuda.synchronize()
            upload = {"upload_s": time.perf_counter() - t0,
                      "upload_bytes": sum(v.numel() * v.element_size()
                                          for v in host.values()),
                      "prefix_rows": host["patch_embeds"].shape[1],
                      "text_tokens": host["tokens"].shape[1]}
        with recording_ranks(kept):
            logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stage_s[f"{label}_inputs"] = t0 - t_in
        stage_s[label] = wall
        got = dict(build_mod.launch_counts)
        if got != {**none, kernel: cfg.n_layers}:
            fail(f"{arch}: {label} launched {got}, expected "
                 f"{cfg.n_layers} {kernel} and nothing else")
        launches[kernel] += got[kernel]
        if tuple(logits.shape) != (B, 1, vocab) \
                or not torch.isfinite(logits).all():
            fail(f"{arch}: {label} logits {tuple(logits.shape)} are not "
                 f"finite of shape ({B}, 1, {vocab})")
    if cfg.family != "ssm":  # grow the KV capacity as lm_serve does
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, LM_DECODE))
                 for k, v in cache.items()}
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_DECODE):
        build_mod.reset_launch_counts()
        logits, cache = decode(params, cache, {"tokens": tok,
                                               "pos": LM_PROMPT + i})
        if dict(build_mod.launch_counts) != none:
            fail(f"{arch}: decode step {i} launched "
                 f"{dict(build_mod.launch_counts)}, expected no kernel")
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
        if i == 0:  # the first step meets new shapes; time it apart
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not torch.isfinite(logits).all():
        fail(f"{arch}: decode logits are not finite")
    # the last step once more under the profiler: device busy time and
    # kernel count of one decode step (the result is dropped)
    t0 = time.perf_counter()
    profile = traced(lambda: decode(params, cache, {
        "tokens": tok, "pos": LM_PROMPT + LM_DECODE - 1}))
    stage_s["profile"] = time.perf_counter() - t0
    run = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": B, "prompt": LM_PROMPT, "dtype": "bfloat16",
           **upload,
           "weight_bytes": weight_bytes, "allocated_before_bytes": before,
           "init_s": init_s, "init_peak_bytes": init_peak,
           "prefill_s": wall, "prefill_tokens_per_s": B * LM_PROMPT
           / wall, "decode_steps": LM_DECODE, "decode_s": decode_s,
           "decode_first_step_s": first_s,
           "decode_tokens_per_s": B * LM_DECODE / decode_s,
           "decode_steady_tokens_per_s": B * (LM_DECODE - 1)
           / (decode_s - first_s),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "decode_step_profile": profile, "kernel": kernel,
           "launches_per_prefill": cfg.n_layers,
           "launches_per_decode_step": 0, "launches": launches,
           "stage_s": stage_s}
    run.update(published_layers=get_config(arch).n_layers,
               params=sum(t.numel() for t in flatten(params)))
    if cfg.moe is not None:  # the prefill's pairs dropped at capacity
        run.update(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                   capacity_per_row=capacity(LM_PROMPT, cfg.moe),
                   **drop_shares(kept))
    print("serve " + json.dumps(run), flush=True)
    del params, cache, logits
    torch.cuda.empty_cache()
    return run


def moe_parts(card, arch: str = "olmoe-1b-7b") -> dict:
    """One MoE layer of ``arch`` in bf16 (a stack of 1 drawn by the model's
    init laws from the seed: the layer-0 laws) on seeded unit-RMS tokens,
    at the serving prefill's shape (LM_BATCH x LM_PROMPT) and a decode
    step's (LM_BATCH x 1), without autograd. Each part's device ms by CUDA
    events: route (the router's product, softmax, top-k, aux), rank and
    dispatch, the expert products, the combine, and the whole layer; the
    parts composed must give the layer's bits. Kept and dropped pairs.
    Bounds: the experts' FLOPs at capacity (every buffer row) at 989
    TFLOP/s bf16 against their bytes (weights, buffer read, output written)
    at 3.35 TB/s, the larger; the route's, the dispatch's (tokens read
    once, the whole buffer written) and the combine's (the kept rows read,
    the weights, the output written) bytes at 3.35 TB/s. Also the bytes of
    the reference's layout (the repeated tokens, a (B, E, C + 1) buffer,
    the gathered rows) and of the port's (no repeated copy, an (E, B, C)
    buffer and its ``OVERFLOW_ROWS``, the gathered rows)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.nn import moe
    from repro_torch.nn.param import materialize, stack_layers
    cfg = get_config(arch)
    m, d = cfg.moe, cfg.d_model
    E, K = m.num_experts, m.top_k
    f = m.expert_d_ff or cfg.d_ff
    stack = materialize(stack_layers(moe.moe_spec(d, cfg.d_ff, m), 1), SEED,
                        torch.bfloat16, "cuda")
    p = {k: v[0] for k, v in stack.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    row = {"arch": arch, "d_model": d, "experts": E, "top_k": K,
           "expert_d_ff": f, "dtype": "bfloat16"}
    el = 2
    w_bytes = 3 * E * d * f * el
    with torch.no_grad():
        for label, S in (("prefill", LM_PROMPT), ("decode", 1)):
            B, N = LM_BATCH, LM_BATCH * S
            x = torch.randn((B, S, d), device="cuda", generator=gen
                            ).bfloat16()
            C = moe.capacity(S, m)
            weights, experts, _ = moe.route(p["router"], x.view(N, d), m)
            slots = moe.rank(experts.view(B, S, K), m, C)
            buf = moe.dispatch(x, slots, E)
            out_buf = moe.expert_ffn(p, buf)
            got = moe.combine(out_buf, weights.view(B, S, K), slots)
            whole, _ = moe.moe_ffn(p, x, m)
            if not torch.equal(got, whole):
                fail(f"moe/{label}: the parts composed differ from moe_ffn")
            kept = int(slots.keep.sum())
            rows = E * B * C
            parts = {
                "route": time_ms(lambda: moe.route(p["router"], x.view(N, d),
                                                   m)),
                "rank_dispatch": time_ms(lambda: moe.dispatch(
                    x, moe.rank(experts.view(B, S, K), m, C), E)),
                "experts": time_ms(lambda: moe.expert_ffn(p, buf)),
                "combine": time_ms(lambda: moe.combine(
                    out_buf, weights.view(B, S, K), slots)),
                "layer": time_ms(lambda: moe.moe_ffn(p, x, m))}
            flops = 6 * rows * d * f
            bounds = {
                "route": bound(N * d * el + d * E * el + N * K * 12, 2 * N
                               * d * E, BF16_FLOPS),
                "rank_dispatch": bound(N * d * el + rows * d * el
                                       + N * K * 8, 0),
                "experts": bound(w_bytes + 2 * rows * d * el, flops,
                                 BF16_FLOPS),
                "combine": bound(kept * d * el + N * K * 4 + N * d * el, 0)}
            row[label] = {
                "batch": B, "seq": S, "capacity_per_row": C,
                "pairs": N * K, "kept_pairs": kept,
                "dropped_pairs": N * K - kept, "buffer_rows": rows,
                "ms": parts, "parts_sum_ms": sum(
                    v for k, v in parts.items() if k != "layer"),
                "expert_flops_at_capacity": flops,
                "expert_flops_kept": 6 * kept * d * f,
                "bound_ms": {k: v["bound_ms"] for k, v in bounds.items()},
                "bound_by": {k: v["bound_by"] for k, v in bounds.items()},
                "layout_bytes": {
                    "reference": {"repeated_tokens": N * K * d * el,
                                  "buffer": B * E * (C + 1) * d * el,
                                  "gathered": N * K * d * el},
                    "port": {"repeated_tokens": 0,
                             "buffer": (rows + moe.OVERFLOW_ROWS) * d
                             * el,
                             "gathered": N * K * d * el}}}
            del x, weights, experts, slots, buf, out_buf, got, whole
    row["card"] = card
    print("moe " + json.dumps(row), flush=True)
    del p, stack
    torch.cuda.empty_cache()
    return row


def consistency(arch) -> dict:
    """Prefilling all CONSIST_PROMPT tokens and taking the last logits
    must match prefilling all but the last token and decoding it: the
    kernel path (flash or wkv6) against the plain decode path
    (``decode_attention``, ``wkv6_recurrent``), in fp32 with TF32 off, at
    full width and CONSIST_LAYERS layers (``CONSIST_LAYERS_BY_ARCH``
    where that does not fit), within rtol CONSIST_TOL and atol
    CONSIST_TOL times the largest logit (at least 1). A VLM puts its
    patch rows (numpy-seeded, bf16) ahead of both prompts and decodes at
    position P + CONSIST_PROMPT - 1. A MoE model runs at
    capacity_factor E / K, so that C = S and no pair can drop: a prefill
    that drops one of the last token's pairs differs from a decode step
    (C = 8, nothing dropped) by the reference's own semantics."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models.registry import build
    from repro_torch.nn.moe import capacity
    layers = CONSIST_LAYERS_BY_ARCH.get(arch, CONSIST_LAYERS)
    cfg = get_config(arch).replace(n_layers=layers)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    bundle = build(cfg)
    params = bundle.init_params(SEED + 1, torch.float32, "cuda")
    prefill = steps.make_prefill_step(bundle)
    decode = steps.make_decode_step(bundle)
    S = CONSIST_PROMPT
    rng = np.random.default_rng(SEED + 1)
    pre, P = {}, 0
    if cfg.family == "vlm":  # the prefix's rows, then S text tokens
        P = cfg.vlm.num_patches
        pre = {"patch_embeds": torch.from_numpy(rng.standard_normal(
            (CONSIST_BATCH, P, cfg.d_model))).to("cuda", torch.bfloat16)}
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (CONSIST_BATCH, S)).astype(np.int32)).cuda()
    full, _ = prefill(params, {**pre, "tokens": tokens})
    _, cache = prefill(params, {**pre, "tokens": tokens[:, :-1]})
    if cfg.family != "ssm":
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
                 for k, v in cache.items()}
    last, _ = decode(params, cache, {"tokens": tokens[:, -1:],
                                     "pos": P + S - 1})
    torch.cuda.synchronize()
    # the real vocab only: past it both hold -1e30 (a padded vocab)
    last, full = last[..., :cfg.vocab_size], full[..., :cfg.vocab_size]
    err = check_close(f"{arch}/consistency", "last logits", last, full,
                      rtol=CONSIST_TOL, atol=CONSIST_TOL)
    row = {"arch": arch, "layers": layers, "batch": CONSIST_BATCH,
           "prompt": S, "prefix_rows": P, "dtype": "float32",
           "max_abs_err": err,
           "max_abs_logit": float(full.abs().max()),
           "same_argmax": bool(torch.equal(full.argmax(-1),
                                           last.argmax(-1)))}
    if cfg.moe is not None:
        row.update(capacity_factor=cfg.moe.capacity_factor,
                   capacity_per_row=capacity(S, cfg.moe))
    print("consistency " + json.dumps(row), flush=True)
    del params, cache
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the LM training step: flash_attention_bwd, and a step at full width
# ---------------------------------------------------------------------------

def flash_bwd_abs(fa, q, k, v, o, lse, do, causal) -> tuple:
    """The bf16 allowance's sums for (dq, dk, dv): |ds| |k|, |ds|^T |q| and
    |p|^T |do| (dk's and dv's summed over each kv head's G query heads),
    with p and ds as the plain backward forms them."""
    p, ds = fa.flash_attention_bwd_terms(q, k, v, o, lse, do, causal)
    return fa.flash_attention_bwd_products(p.abs_(), ds.abs_(), q.abs(),
                                           k.abs(), do.abs())


def rel_frobenius(out, ref) -> float:
    """||out - ref|| / ||ref|| over every element, in fp64."""
    out, ref = out.double(), ref.double()
    return float((out - ref).norm() / ref.norm().clamp_min(1e-300))


def check_bwd_rounding(name, fa, got, q, k, v, o, lse, do, causal) -> dict:
    """Holds bf16 (dq, dk, dv) ``got`` of the kernel against the plain
    version, and against it with p's or ds's rounding to bf16 removed, by
    BWD_ROUNDING_LIMIT: fails if the kernel is not within it of the plain
    version, or if it is within it of an unrounded one (the check could not
    see a missing rounding there). Returns every reading."""
    p, ds = fa.flash_attention_bwd_terms(q, k, v, o, lse, do, causal)
    pr, dsr = p.to(do.dtype).float(), ds.to(k.dtype).float()
    whats = ("dq", "dk", "dv")

    def reading(pp, dd, keep):
        want = fa.flash_attention_bwd_products(pp, dd, q, k, do)
        return {w: rel_frobenius(g, r.to(g.dtype)) for w, g, r
                in zip(whats, got, want) if w in keep}
    row = {"limit": BWD_ROUNDING_LIMIT,
           "rounded": reading(pr, dsr, whats),
           "p_unrounded": reading(p, dsr, ("dv",)),
           "ds_unrounded": reading(pr, ds, ("dq", "dk"))}
    del p, ds, pr, dsr
    for what, err in row["rounded"].items():
        if not err < BWD_ROUNDING_LIMIT:
            fail(f"{name}: {what} is {err} (relative) from the plain "
                 f"version, past {BWD_ROUNDING_LIMIT}: {row}")
    for key in ("p_unrounded", "ds_unrounded"):
        for what, err in row[key].items():
            if not err > BWD_ROUNDING_LIMIT:
                fail(f"{name}: {what} is within {BWD_ROUNDING_LIMIT} of the "
                     f"plain version without its rounding ({key}), so the "
                     f"check cannot see that rounding: {row}")
    return row


def check_flash_bwd_launch(name, fa, B, Sq, Sk, H, KH, D, dtype, causal,
                           main_path, usage, iters=5, rounding=False):
    """flash_attention_bwd vs its plain version on the card at q (B, Sq, H,
    D) and k, v (B, Sk, KH, D), from the forward's output and lse (the lse
    held against the plain one, and the output bitwise the forward's
    without it), twice with the same bits; its times, the yardstick (SDPA's
    backward alone, k and v repeated to H heads outside the timing) and the
    bound: the larger of q, k, v, out, dout, lse, dq, dk and dv moved once
    over the memory rate and 5 products of 2 D flops per unmasked pair at
    the card's rate for the operands' type (bf16 on the tensor cores, where
    the wgmma route runs 7 products a pair; fp32 FMA). Each pass's
    registers, spills and shared memory are reported under its kernel's
    name. ``rounding`` (bf16) adds ``check_bwd_rounding``'s readings."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn((B, S, h, D), device="cuda", generator=gen
                               ).to(dtype)
                   for S, h in ((Sq, H), (Sk, KH), (Sk, KH), (Sq, H)))
    o, lse = fa.flash_attention_fwd(q, k, v, causal, return_lse=True)
    out = fa.flash_attention_fwd(q, k, v, causal)
    _, lse_plain = fa.flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    if not torch.equal(o, out):
        fail(f"{name}: the forward's output changed when its lse was asked "
             f"for")
    lse_row = check_within(name, "lse", lse, lse_plain, FLASH_TOL["rtol"],
                           FLASH_TOL["atol"] * max(
                               1.0, float(lse_plain.abs().max())))
    del out, lse_plain
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for what, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            fail(f"{name}: two launches gave different {what}")
    del again
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    terms = (None if dtype == torch.float32
             else flash_bwd_abs(fa, q, k, v, o, lse, do, causal))
    errs = {}
    for i, (what, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
        atol = FLASH_TOL["atol"] * max(1.0, float(w.abs().max()))
        if terms is None:
            errs[what] = check_within(name, what, g, w, FLASH_TOL["rtol"],
                                      atol)
        else:
            errs[what] = check_within(name, what, g, w, BF16_RTOL,
                                      FLASH_BWD_BF16_ATOL * terms[i] + atol)
    del want, terms
    rounding_row = (check_bwd_rounding(name, fa, got, q, k, v, o, lse, do,
                                       causal) if rounding else None)
    del got
    G = H // KH
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
              .requires_grad_() for t in (k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                   retain_graph=True)
    m = min(Sq, Sk)
    pairs = m * (m + 1) // 2 + (Sq - m) * Sk if causal else Sq * Sk
    elt = q.element_size()
    route = fa.ROUTES[dtype]
    passes = fa.flash_attention_bwd_smem_bytes(D, dtype)
    prefix = "flash_bwd_wg_" if route == "wgmma" else "flash_bwd_"
    row = {"kernel": "flash_attention_bwd", "launch": name,
           "main_path": main_path, "q": [B, Sq, H, D], "kv": [B, Sk, KH, D],
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "route": route,
           "build_usage": {prefix + p: {**build_usage(usage, prefix + p),
                                        "smem_bytes": passes[p]}
                           for p in ("dkdv", "dq")},
           "lse": lse_row, **{f"{k}_err": e for k, e in errs.items()},
           **({"rounding": rounding_row} if rounding_row else {}),
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "library": "scaled_dot_product_attention backward",
           "ms": time_ms(lambda: fa.flash_attention_bwd(
               q, k, v, o, lse, do, causal), iters=iters, warmup=1),
           "plain_ms": time_ms(lambda: fa.flash_attention_bwd_plain(
               q, k, v, o, lse, do, causal), iters=2, warmup=1),
           "library_ms": time_ms(sdpa_bwd, iters=10)}
    row.update(bound(elt * (4 * B * Sq * H * D + 4 * B * Sk * KH * D)
                     + 4 * B * H * Sq, 10 * D * pairs * B * H,
                     FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS))
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    del q, k, v, do, o, lse, qt, kt, vt, sdpa_out, dot
    torch.cuda.empty_cache()
    return report(row)


def flash_bwd_launches(fa, bwd_usage) -> list:
    """Phase 11's checked launches of flash_attention_bwd: the Llama-3-8B
    training shape (the main path) and smaller shapes that exercise G,
    ragged S, D 64, Sq != Sk and both routes."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        check_flash_bwd_launch("llama3_8b_train", fa, 1, TRAIN_SEQ,
                               TRAIN_SEQ, 32, 8, 128, bf16, True, True,
                               bwd_usage, rounding=True),
        check_flash_bwd_launch("fp32_llama3_8b_train", fa, 1, TRAIN_SEQ,
                               TRAIN_SEQ, 32, 8, 128, f32, True, False,
                               bwd_usage, iters=2),
        check_flash_bwd_launch("ragged_causal", fa, 2, 1000, 1000, 4, 2, 64,
                               bf16, True, False, bwd_usage, rounding=True),
        check_flash_bwd_launch("fp32_ragged_causal", fa, 2, 1000, 1000, 4, 2,
                               64, f32, True, False, bwd_usage),
        check_flash_bwd_launch("noncausal", fa, 2, 512, 512, 8, 2, 128, bf16,
                               False, False, bwd_usage, rounding=True),
        # Whisper large's cross-attention: 448 decoder tokens over 1,500
        # encoder frames, 20 heads of 64
        check_flash_bwd_launch("noncausal_cross", fa, 2, 448, 1500, 20, 20,
                               64, bf16, False, False, bwd_usage,
                               rounding=True),
        check_flash_bwd_launch("fp32_noncausal", fa, 2, 512, 512, 8, 2, 128,
                               f32, False, False, bwd_usage)]


def check_train_logits(embed, cfg, tokens: int = 512) -> dict:
    """bf16 logits of ``tokens`` seeded hidden states through the model's
    unembedding (``nn.layers.logits_fn``) against the fp32 product of the
    same bf16 values (TF32 off: exact products, fp32 sums), within rtol and
    atol CONSIST_TOL times the largest |logit|: a result rounded to bf16
    would be off by ~2^-9 of each logit."""
    from repro_torch.nn.layers import logits_fn
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((1, tokens, cfg.d_model), device="cuda",
                    generator=gen).bfloat16()
    with torch.no_grad():
        got = logits_fn(embed, x, cfg.vocab_size)
        table = embed.get("unembed")
        want = x.float() @ (embed["table"].T if table is None
                            else table).float()
    if got.dtype != torch.float32:
        fail(f"train logits are {got.dtype}, not float32")
    want[..., cfg.vocab_size:] += -1e30
    row = check_within("train_logits", "bf16 logits", got, want,
                       CONSIST_TOL,
                       CONSIST_TOL * float(want[..., :cfg.vocab_size]
                                           .abs().max()))
    del got, want, x
    return row


def lm_train(card, arch: str = "llama3-8b") -> dict:
    """``arch``'s training step at its published widths, TRAIN_LAYERS deep,
    in bf16 from a seeded init, through ``launch.steps.make_train_step``
    (remat "full", grad_accum TRAIN_ACCUM) and AdamW on a cosine schedule,
    TRAIN_STEPS steps over batches of TRAIN_BATCH x TRAIN_SEQ numpy-seeded
    tokens. Each step's launch counts are zeroed before and read after:
    exactly 2 x layers x micro-batches of the model's forward kernel (the
    forward and remat's recompute) and layers x micro-batches of its
    backward (``TRAIN_KERNELS``), nothing else. The first step then runs
    again from the same parameters and batch, under ``torch.profiler``,
    and its loss, gradient norm and parameters are compared bit for bit
    with the first run's (printed: a difference is a finding, not a
    failure)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build as build_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build, sample_inputs
    from repro_torch.nn.param import flatten
    from repro_torch.optim.adam import AdamW
    from repro_torch.optim.schedules import get_schedule
    cfg = get_config(arch).replace(n_layers=TRAIN_LAYERS,
                                   grad_accum=TRAIN_ACCUM)
    bundle = build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params0 = bundle.init_params(SEED, torch.bfloat16, "cuda")
    n_params = sum(t.numel() for t in flatten(params0))
    opt = AdamW(get_schedule("cosine", 3e-4, 10, TRAIN_STEPS))
    step = make_train_step(bundle, opt)
    rng = np.random.default_rng(SEED)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batches = [sample_inputs(cfg, shape, rng, "cuda")
               for _ in range(TRAIN_STEPS)]
    micro = TRAIN_ACCUM
    kernels = TRAIN_KERNELS[arch]
    per_step = {name: per_layer * TRAIN_LAYERS * micro
                for name, (per_layer, *_) in kernels.items()}
    want = {**{k: 0 for k in build_mod.launch_counts}, **per_step}
    launches = {k: 0 for k in per_step}
    params, state = params0, opt.init(flatten(params0))
    steps, first = [], None
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        build_mod.reset_launch_counts()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batches[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(build_mod.launch_counts)
        if got != want:
            fail(f"{arch} train step {i + 1} launched {got}, expected "
                 f"{per_step} and nothing else")
        for k in launches:
            launches[k] += got[k]
        vals = {k: float(v) for k, v in met.items()}
        if not all(np.isfinite(x) for x in vals.values()):
            fail(f"{arch} train step {i + 1}: non-finite metrics {vals}")
        steps.append({"step": i + 1, "s": wall, **vals})
        if i == 0:
            first = (params, met)
    peak = torch.cuda.max_memory_allocated()
    del state
    params = None
    torch.cuda.empty_cache()
    s_step = float(np.median([r["s"] for r in steps[1:]]))
    logits_row = check_train_logits(params0["embed"], cfg)
    out = {}
    state0 = opt.init(flatten(params0))
    traced(lambda: torch.ones(1, device="cuda").add_(1))  # warms CUPTI
    prof = traced(lambda: out.update(run=step(params0, state0, batches[0])),
                  match={label: key for _, label, key, _ in kernels.values()},
                  top=12)
    # a share is read only from a trace that saw every launch (a backward
    # launch runs three kernels: flash's delta, dk/dv and dq passes, wkv6's
    # walks, chunks and du)
    complete = all(prof[f"{label}_kernels"] == n * per_step[name]
                   for name, (_, label, _, n) in kernels.items())
    p_again, _, met_again = out.pop("run")
    same = {"loss": bool(torch.equal(met_again["loss"], first[1]["loss"])),
            "grad_norm": bool(torch.equal(met_again["grad_norm"],
                                          first[1]["grad_norm"])),
            "params": all(torch.equal(a, b) for a, b in
                          zip(flatten(p_again), flatten(first[0])))}
    busy = prof["device_busy_ms"]
    run = {"arch": arch, "layers": TRAIN_LAYERS,
           "d_model": cfg.d_model, "params": n_params, "dtype": "bfloat16",
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "prefix_rows": cfg.vlm.num_patches if cfg.vlm else 0,
           "grad_accum": micro,
           "remat": cfg.remat, "steps": steps, "s_per_step": s_step,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / s_step,
           "peak_bytes": peak, "launches_per_step": per_step,
           "launches": launches, "repeat_bitwise": same,
           "logits": logits_row, "profiled_step": prof,
           "trace_complete": complete,
           **{f"{label}_share_of_busy": (prof[f"{label}_ms"] / busy
                                         if complete else None)
              for _, label, _, _ in kernels.values()},
           "card": card}
    print("train " + json.dumps(run), flush=True)
    del params0, state0, first, p_again, out
    torch.cuda.empty_cache()
    return run


@contextlib.contextmanager
def recording_routes(out: list, K: int):
    """While active, each call of ``nn.moe.ranked_probs`` (one a MoE
    layer a forward, remat's recompute included) appends to ``out`` its
    top ``K`` experts, as ``route`` takes them, and the smallest margin
    over its tokens between the K-th and the (K+1)-th probability."""
    from repro_torch.nn import moe
    ranked = moe.ranked_probs

    def recording(router_w, x):
        probs, top = ranked(router_w, x)
        with torch.no_grad():
            margin = (top.values[:, K - 1] - top.values[:, K]).min()
        out.append((top.indices[:, :K].detach().clone(), margin))
        return probs, top
    moe.ranked_probs = recording
    try:
        yield out
    finally:
        moe.ranked_probs = ranked


def routing_row(card_routes: list, cpu_routes: list) -> dict:
    """The card's expert choices against the CPU's, call by call: the
    smallest K-th / (K+1)-th margin over every call (the CPU's), and each
    token whose experts differ, with its margins on both sides."""
    flips = []
    for i, ((e_card, m_card), (e_cpu, m_cpu)) in enumerate(
            zip(card_routes, cpu_routes)):
        diff = (e_card.cpu() != e_cpu).any(-1).nonzero().flatten().tolist()
        flips += [{"call": i, "token": t, "card": e_card[t].tolist(),
                   "cpu": e_cpu[t].tolist(), "margin_card": float(m_card),
                   "margin_cpu": float(m_cpu)} for t in diff]
    return {"calls": len(cpu_routes),
            "min_margin": min(float(m) for _, m in cpu_routes),
            "min_margin_card": min(float(m) for _, m in card_routes),
            "flips": flips}


def lm_train_vs_cpu(card, arch: str = "llama3-8b") -> dict:
    """One fp32 micro-step (TF32 off) of ``arch``'s TRAIN_LAYERS-deep model
    at full width, 1 x TRAIN_CPU_SEQ tokens: the loss and every gradient
    leaf on the card (flash's FMA route or wkv6's fp32 kernels, cuBLAS in
    fp32) against the port on the CPU (the plain versions) from the same
    parameters, within rtol CONSIST_TOL and atol CONSIST_TOL times the
    leaf's largest magnitude (fp32 sums over up to 20,480 terms and 128
    positions, taken in another order). A VLM's 128 positions are
    TRAIN_CPU_PATCHES patch rows and the text tokens. A MoE model's line
    adds its routing (``routing_row``): the smallest margin between the
    K-th and the (K+1)-th router probability over its tokens and layers,
    and every token whose experts differ between the card and the CPU,
    printed with its margins before the gradients are judged."""
    from repro_torch.checkpoint.checkpointing import flatten_with_paths
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.models.registry import build, sample_inputs
    from repro_torch.nn.param import flatten, unflatten
    cfg = get_config(arch).replace(n_layers=TRAIN_LAYERS)
    if cfg.vlm is not None:
        cfg = cfg.replace(vlm=dataclasses.replace(
            cfg.vlm, num_patches=TRAIN_CPU_PATCHES))
    bundle = build(cfg)
    params = bundle.init_params(SEED + 2, torch.float32, "cuda")
    batch = sample_inputs(cfg, ShapeSpec("cpu", TRAIN_CPU_SEQ, 1, "train"),
                          np.random.default_rng(SEED + 2), "cuda")

    def loss_and_grads(p, b, routes):
        with (recording_routes(routes, cfg.moe.top_k) if cfg.moe
              else contextlib.nullcontext()):
            loss, _, grads = _loss_and_grads(bundle, p, flatten(p), b)
        return loss, grads
    routes_card, routes_cpu = [], []
    loss_card, grads_card = loss_and_grads(params, batch, routes_card)
    torch.cuda.synchronize()
    params_cpu = unflatten(params, [t.cpu() for t in flatten(params)])
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = loss_and_grads(
        params_cpu, {k: v.cpu() for k, v in batch.items()}, routes_cpu)
    cpu_s = time.perf_counter() - t0
    routing = routing_row(routes_card, routes_cpu) if routes_cpu else None
    if routing and routing["flips"]:  # printed before the checks judge
        print("train_vs_cpu_routing " + json.dumps(routing), flush=True)
    names = list(flatten_with_paths(params_cpu))
    row = check_within("train_fp32", "loss", loss_card.cpu(), loss_cpu,
                       CONSIST_TOL, CONSIST_TOL * float(loss_cpu.abs()))
    errs, worst = {"loss": row["max_abs_err"]}, row["tol_used"]
    for name, g, w in zip(names, grads_card, grads_cpu):
        w = w.cuda()
        row = check_within("train_fp32", f"gradient {name}", g, w,
                           CONSIST_TOL, CONSIST_TOL * float(w.abs().max()))
        worst = max(worst, row["tol_used"])
        errs[name] = row["max_abs_err"]
    row = {"arch": arch, "layers": TRAIN_LAYERS, "dtype": "float32",
           "tokens": TRAIN_CPU_SEQ,
           "prefix_rows": cfg.vlm.num_patches if cfg.vlm else 0,
           "loss_card": float(loss_card),
           "loss_cpu": float(loss_cpu), "leaves": len(names),
           "worst_tol_used": worst, "max_abs_err": errs, "cpu_s": cpu_s,
           "card": card}
    if routing is not None:
        row["routing"] = routing
    print("train_vs_cpu " + json.dumps(row), flush=True)
    del grads_card, grads_cpu, params_cpu
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the host runtime: the prefetch pipeline and the sampler pool
# ---------------------------------------------------------------------------

EPOCH_KEYS = ("loss", "acc", "iterations", "epoch_time_s", "nvtps",
              "host_produce_s", "host_wait_s", "host_gather_s",
              "host_issue_s", "host_fetch_s", "ring_bytes_per_iter",
              "pool_respawns", "pool_resubmissions", "pool_speculative_hits",
              "pool_speculative_launched", "pool_stale_results",
              "pool_crc_failures", "pool_degraded_batches",
              "pool_recovery_s", "pool_degraded", "beta", "pipeline",
              "sampler_workers", "balance_policy", "gather_in_workers")


def machine_facts(graph, cfg, workers, p_max, layer_capacities,
                  PayloadCodec, blk_caps) -> dict:
    """The host's CPUs and ``/dev/shm``, which must hold the shared graph
    and the largest ring (slots of the worst-case payload: every layer-0
    row shipped) of any pool this phase starts; fails if it cannot."""
    import os
    from repro_torch.core.sampler_pool import FeatureShipSpec
    aff = sorted(os.sched_getaffinity(0))
    shm = shutil.disk_usage("/dev/shm")
    graph_bytes = sum(getattr(graph, f).nbytes for f in
                      ("indptr", "indices", "features", "labels",
                       "train_ids"))
    rows = layer_capacities(cfg)[0][0]
    codec = PayloadCodec(cfg, blk_caps, FeatureShipSpec(
        rows, graph.features.shape[1]))
    ring_bytes = (2 * max(workers) + 2) * codec.nbytes
    facts = {"cpu_count": os.cpu_count(), "affinity": aff,
             "dev_shm": {"total": shm.total, "used": shm.used,
                         "free": shm.free},
             "graph_bytes": graph_bytes,
             "largest_ring_bytes_worst_case": ring_bytes,
             "workers": list(workers), "max_devices": p_max}
    print("machine " + json.dumps(facts), flush=True)
    if shm.free < graph_bytes + ring_bytes:
        fail(f"/dev/shm has {shm.free} bytes free; the sampler pool needs "
             f"{graph_bytes} for the graph and up to {ring_bytes} for its "
             f"ring")
    return facts


def codec_cost(graph, cfg, NeighborSampler, PayloadCodec, blk_caps,
               build_layer_layouts) -> dict:
    """Host milliseconds of one paper batch's trip through the sampler
    pool's ring (``PayloadCodec``, no gathered rows): the worker's encode
    (copies and the CRC32 stamp) and the consumer's decode (one copy out
    of the slot and the CRC32 check), and the CRC32 alone; medians of 5."""
    import statistics
    import zlib
    mb = NeighborSampler(graph, cfg, graph.train_ids, 0, SEED).batch_at(1, 0)
    lay = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                              blk_caps, "mean", edge_stream=True)
    codec = PayloadCodec(cfg, blk_caps, None)
    buf = bytearray(codec.nbytes)

    def median_ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    row = {"slot_bytes": codec.nbytes,
           "encode_ms": median_ms(lambda: codec.encode(mb, lay, None, buf,
                                                       0)),
           "decode_ms": median_ms(lambda: codec.decode(buf, 0, 0, 0)),
           "crc32_ms": median_ms(lambda: zlib.crc32(buf))}
    print("pool_codec " + json.dumps(row), flush=True)
    return row


def epoch_run(label, make, epochs, per_iter, agg, flatten) -> dict:
    """Train ``epochs`` epochs with the trainer ``make()`` builds, every
    launch count set to 0 just before and read just after, the last epoch
    traced on the device (busy time and idle share). Fails unless the
    counts are the epochs' iterations times ``per_iter``. Prints one
    ``epoch`` line an epoch; returns the metrics, the parameters after
    each epoch (on the host) and the counts."""
    tr = make()
    metrics, params = [], []
    try:
        torch.cuda.synchronize()
        agg.reset_launch_counts()
        trace = None
        for e in range(epochs):
            if e == epochs - 1:
                trace = traced(lambda: metrics.append(tr.run_epoch()),
                               cpu=False)
            else:
                metrics.append(tr.run_epoch())
            params.append([q.detach().cpu() for q in flatten(tr.params)])
        torch.cuda.synchronize()
        launches = dict(agg.launch_counts)
    finally:
        tr.close()
        del tr
        torch.cuda.empty_cache()
    for e, m in enumerate(metrics):
        line = {"path": label, "epoch": e,
                **{k: m[k] for k in EPOCH_KEYS},
                "iteration_s": m["epoch_time_s"] / m["iterations"]}
        if e == epochs - 1:
            line.update(trace)
        print("epoch " + json.dumps(line), flush=True)
        if not np.isfinite(m["loss"]):
            fail(f"{label}: epoch {e} loss is {m['loss']}")
    iters = sum(m["iterations"] for m in metrics)
    want = {k: iters * v for k, v in per_iter.items()}
    if launches != want:
        fail(f"{label}: {iters} iterations launched {launches}, expected "
             f"{want}")
    return {"metrics": metrics, "params": params, "launches": launches,
            "trace": trace}


def check_twin(label, run, twin) -> None:
    """A pipelined or pooled run against its sequential twin: each epoch's
    loss and acc, and the parameters after its last epoch, bit for bit."""
    n = len(run["metrics"])
    for e, (m, t) in enumerate(zip(run["metrics"], twin["metrics"])):
        if (m["loss"], m["acc"]) != (t["loss"], t["acc"]):
            fail(f"{label}: epoch {e} loss/acc {m['loss']!r}/{m['acc']!r}, "
                 f"sequential twin {t['loss']!r}/{t['acc']!r}")
    same = all(torch.equal(a, b)
               for a, b in zip(run["params"][-1], twin["params"][n - 1]))
    if not same:
        fail(f"{label}: parameters after {n} epoch(s) differ from the "
             f"sequential twin's")
    print(f"{label}: {n} epoch(s), loss/acc and parameters bitwise the "
          f"sequential twin's", flush=True)


def probe_cache(tr, probe: dict) -> None:
    """Keep, for a run's ``cache`` line, the trainer's cache (it outlives
    the trainer's close) and the seconds of each shard upload: the first,
    and each re-upload after a refresh."""
    upload = tr._upload_shards
    probe["uploads"] = []

    def logged():
        secs = upload()
        probe["uploads"].append(secs)
        return secs
    tr._upload_shards = logged
    probe["cache"] = tr.cache


def check_cache_twin(label, run, twin) -> None:
    """A cached run against its sequential cached twin: every cache key of
    every epoch, the refreshes, the generation, the counter and the
    resident sets, exactly."""
    for e, (m, t) in enumerate(zip(run["metrics"], twin["metrics"])):
        for k in CACHE_KEYS:
            if m[k] != t[k]:
                fail(f"{label}: epoch {e} {k} {m[k]!r}, sequential twin "
                     f"{t[k]!r}")
    a, b = run["probe"]["cache"], twin["probe"]["cache"]
    if (a.refreshes, a.generation) != (b.refreshes, b.generation):
        fail(f"{label}: {a.refreshes} refreshes to generation "
             f"{a.generation}, sequential twin {b.refreshes} to "
             f"{b.generation}")
    if not (np.array_equal(a.freq, b.freq) and all(
            np.array_equal(a.core.resident_ids(d), b.core.resident_ids(d))
            for d in range(a.core.num_devices))):
        fail(f"{label}: the counter or the resident sets differ from the "
             f"sequential twin's")
    print(f"{label}: every cache key, {a.refreshes} refreshes, generation "
          f"{a.generation}, the counter and the resident sets equal the "
          f"sequential twin's", flush=True)


def cache_line(label, run, off, card) -> None:
    """One ``cache`` line: the cache's capacity, refreshes and generation,
    each epoch's cache keys and ``iteration_s`` beside the cache-off
    twin's ``iteration_s`` and hit rate (``off``; None where the run has
    none), each shard upload's seconds and the host ms of installing,
    ranking and waiting."""
    c = run["probe"]["cache"]
    print("cache " + json.dumps({
        "path": label, "card": card, "capacity": c.capacity,
        "refresh_every": c.refresh_every, "refreshes": c.refreshes,
        "generation": c.generation,
        "epochs": [{**{k: m[k] for k in CACHE_KEYS},
                    "iteration_s": m["epoch_time_s"] / m["iterations"],
                    "cache_off_iteration_s": (
                        None if off is None else
                        off["metrics"][e]["epoch_time_s"]
                        / off["metrics"][e]["iterations"]),
                    "cache_off_hit_rate": (
                        None if off is None
                        else off["metrics"][e]["cache_hit_rate"])}
                   for e, m in enumerate(run["metrics"])],
        "shard_upload_s": run["probe"]["uploads"],
        "apply_ms": c.apply_s * 1e3, "rank_ms": c.rank_s * 1e3,
        "wait_ms": c.wait_s * 1e3}), flush=True)


def host_runtime(SyncGNNTrainer, graph, cfg, params0, counts, agg, flatten,
                 layer_capacities, PayloadCodec, block_capacities,
                 NeighborSampler, build_layer_layouts, card) -> dict:
    """Phase 5: the pipelined and pooled epochs against their sequential
    twins, from the same initial parameters (``params0``: {model: numpy
    parameters}; the resident path at p = 1 on ``"pallas_fused"`` and
    ``"pallas_edges"``, the host gather on ``"pallas_fused"``, p = 4 with
    the ``"load"`` policy and the gather in the workers, a worker killed
    mid-epoch, P3 at p = 4 resident against 2 workers that do not gather,
    GAT resident against 4 workers, and the feature cache at p = 4)."""
    import os
    workers = sorted({2, 4, min(8, len(os.sched_getaffinity(0)) - 2)})
    machine_facts(graph, cfg, workers, HOST_P4, layer_capacities,
                  PayloadCodec, block_capacities(cfg))
    codec_cost(graph, cfg, NeighborSampler, PayloadCodec,
               block_capacities(cfg), build_layer_layouts)
    runs = {}

    def run(key, backend, epochs=HOST_EPOCHS, p=1, algorithm="distdgl",
            model="graphsage", probe=None, **kw):
        kw.setdefault("data_parallel", True)

        def make():
            tr = SyncGNNTrainer(
                graph, dataclasses.replace(cfg, name=model,
                                           aggregate_backend=backend),
                num_devices=p, algorithm=algorithm, seed=SEED,
                device="cuda", params=params0[model], **kw)
            if probe is not None:
                probe_cache(tr, probe)
            return tr
        runs[key] = epoch_run(key, make, epochs,
                              {k: p * v for k, v in counts[backend].items()},
                              agg, flatten)
        runs[key]["probe"] = probe
        return runs[key]

    for backend in HOST_BACKENDS:
        twin = run(f"{backend}/sequential", backend, pipeline=False)
        check_twin(f"{backend}/pipelined",
                   run(f"{backend}/pipelined", backend), twin)
        for n in workers:
            key = f"{backend}/pipelined/{n}_workers"
            check_twin(key, run(key, backend, num_sampler_workers=n), twin)
        if backend == "pallas_fused":
            # a worker killed mid-epoch: respawned, its task re-run
            key = f"{backend}/2_workers/killed"
            fault = run(key, backend, epochs=1, num_sampler_workers=2,
                        fault_spec=HOST_FAULT)
            check_twin(key, fault, twin)
            if not fault["metrics"][0]["pool_respawns"] >= 1:
                fail(f"{key}: no worker was respawned "
                     f"({fault['metrics'][0]})")
    twin = run("pallas_fused/host_gather/sequential", "pallas_fused",
               HOST_GATHER_EPOCHS, pipeline=False, data_parallel=False)
    check_twin("pallas_fused/host_gather/pipelined",
               run("pallas_fused/host_gather/pipelined", "pallas_fused",
                   HOST_GATHER_EPOCHS, data_parallel=False), twin)
    p4 = dict(p=HOST_P4, balance_policy="load")
    twin = run(f"pallas_fused/p{HOST_P4}/load/sequential", "pallas_fused",
               pipeline=False, **p4)
    key = f"pallas_fused/p{HOST_P4}/load/pipelined/4_workers/gather"
    check_twin(key, run(key, "pallas_fused", num_sampler_workers=4,
                        gather_in_workers=True, **p4), twin)
    if not runs[key]["metrics"][0]["ring_bytes_per_iter"] > 0:
        fail(f"{key}: no bytes crossed the workers' ring")
    # P3's workers sample only: gathering they would ship every valid row
    p3 = dict(p=P3_DEVICES, algorithm="p3")
    twin = run(f"pallas_fused/p3/p{P3_DEVICES}/sequential", "pallas_fused",
               pipeline=False, **p3)
    key = f"pallas_fused/p3/p{P3_DEVICES}/pipelined/2_workers"
    check_twin(key, run(key, "pallas_fused", num_sampler_workers=2, **p3),
               twin)
    for m in runs[key]["metrics"]:
        if m["beta"] != 1.0:
            fail(f"{key}: beta {m['beta']!r}, P3 misses nothing")
    gat = dict(model="gat")
    twin = run("gat/sequential", "reference", pipeline=False, **gat)
    check_twin("gat/pipelined/4_workers",
               run("gat/pipelined/4_workers", "reference",
                   num_sampler_workers=4, **gat), twin)
    cache_family(run, graph, card)
    return runs


def cache_family(run, graph, card) -> None:
    """The feature cache in phase 5 (``run``: host_runtime's): at p = 4,
    round-robin, resident with epoch-boundary refresh (bitwise the
    cache-off twin; 4 workers that gather bitwise the sequential run, and
    epoch 3's miss bytes an iteration below epoch 1's, its hit rate above),
    then the host gather refreshed every ``CACHE_K`` iterations (4
    workers that gather bitwise sequential, after equal refreshes > 0)."""
    from repro_torch.core.feature_store import FeatureStore
    from repro_torch.core.partition import get_partitioner
    store = FeatureStore(graph, get_partitioner("metis_like")(
        graph, CACHE_P, SEED), "distdgl")
    shares = [store.num_resident(d) for d in range(CACHE_P)]
    capacity = min(shares) // 4
    print(f"cache: capacity {capacity} rows a device at p = "
          f"{CACHE_P}, a quarter of the smallest DistDGL static share "
          f"({shares})", flush=True)
    base = f"pallas_fused/p{CACHE_P}"
    rr = dict(p=CACHE_P, epochs=CACHE_EPOCHS)
    off = run(f"{base}/cache_off/sequential", "pallas_fused",
              pipeline=False, **rr)
    cached = dict(rr, cache_capacity=capacity, cache_refresh_every=0)
    key = f"{base}/cache/sequential"
    seq = run(key, "pallas_fused", pipeline=False, probe={}, **cached)
    check_twin(key, seq, off)
    cache_line(key, seq, off, card)
    key = f"{base}/cache/pipelined/4_workers/gather"
    pooled = run(key, "pallas_fused", num_sampler_workers=4,
                 gather_in_workers=True, probe={}, **cached)
    check_twin(key, pooled, seq)
    check_cache_twin(key, pooled, seq)
    cache_line(key, pooled, off, card)
    first, last = pooled["metrics"][0], pooled["metrics"][-1]
    if not (last["miss_bytes_per_iter"] < first["miss_bytes_per_iter"]
            and last["cache_hit_rate"] > first["cache_hit_rate"]):
        fail(f"{key}: epoch {CACHE_EPOCHS} missed "
             f"{last['miss_bytes_per_iter']!r} bytes an iteration at hit "
             f"rate {last['cache_hit_rate']!r}, epoch 1 "
             f"{first['miss_bytes_per_iter']!r} at "
             f"{first['cache_hit_rate']!r}")
    hg = dict(p=CACHE_P, epochs=CACHE_K_EPOCHS, data_parallel=False,
              cache_capacity=capacity, cache_refresh_every=CACHE_K)
    key = f"{base}/cache_k{CACHE_K}/host_gather/sequential"
    twin = run(key, "pallas_fused", pipeline=False, probe={}, **hg)
    cache_line(key, twin, None, card)
    key = f"{base}/cache_k{CACHE_K}/host_gather/pipelined/4_workers/gather"
    pooled = run(key, "pallas_fused", num_sampler_workers=4,
                 gather_in_workers=True, probe={}, **hg)
    check_twin(key, pooled, twin)
    check_cache_twin(key, pooled, twin)
    cache_line(key, pooled, None, card)
    if not pooled["probe"]["cache"].generation > 0:
        fail(f"{key}: no refresh in {CACHE_K_EPOCHS} epochs")


# ---------------------------------------------------------------------------
# checkpoints and mid-epoch resume; SGDM
# ---------------------------------------------------------------------------

def checkpoint_dir(name: str) -> Path:
    """A fresh directory for one run's checkpoints, under the checkout's
    ``build/`` (git-ignored; the phase removes it)."""
    d = Path(__file__).resolve().parent / "build" / "checkpoints" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def trainer_state(tr, flatten) -> dict:
    """What a resumed run must match bit for bit: parameters, optimizer
    state and, with a cache, its counter, resident sets, generation and
    counters; on the host."""
    state = {"params": [q.detach().cpu() for q in flatten(tr.params)],
             "opt": {k: (v if k == "step" else [q.cpu() for q in v])
                     for k, v in tr.opt_state.items()}}
    c = tr.cache
    if c is not None:
        state["cache"] = {
            "freq": c.freq.copy(), "generation": c.generation,
            "resident": [c.core.resident_ids(d).copy()
                         for d in range(c.core.num_devices)],
            "counters": (c.admissions_total, c.evictions_total,
                         c.refresh_bytes_total, c.refreshes,
                         c.admissions_epoch, c.evictions_epoch,
                         c.refresh_bytes_epoch, c._epochs_run)}
    return state


def same_state(a: dict, b: dict) -> bool:
    def same(x, y):
        if isinstance(x, torch.Tensor):
            return x.dtype == y.dtype and torch.equal(x, y)
        if isinstance(x, np.ndarray):
            return np.array_equal(x, y)
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y
    return same(a, b)


def checkpoint_phase(SyncGNNTrainer, Checkpointer, graph, cfg, params0,
                     groups, ref_loss, fused_counts, agg, flatten, card,
                     runs) -> None:
    """Phase 5b: the cache family's resident configuration (GraphSAGE,
    ``"pallas_fused"``, p = 4, round-robin, a quarter of the smallest
    DistDGL static share cached a device, refreshed at epoch boundaries)
    through ``torch_mesh_jobs.checkpointed_twin`` and ``resume``: 2
    sequential epochs saved
    every ``CKPT_EVERY`` iterations (the twin); a fresh trainer restores
    epoch 2's second-iteration checkpoint and finishes the epoch
    sequentially, and another with ``CKPT_WORKERS`` workers that gather:
    each must end bitwise the twin in parameters, optimizer state, the
    cache's counter, resident sets, generation and counters, with the
    launch counts of its iterations, and the pooled one's shared segment
    at the restored generation. Then ``SGDM_ITERATIONS`` iterations of
    GraphSAGE on ``"pallas_fused"`` at p = 1 with
    ``optimizer_name="sgdm"``: phase 4's counts an iteration, its first
    loss within rtol 1e-4 of ``"reference"``, and every loss, the
    momentum and the parameters' update within rtol 1e-4 of the same run
    on the CPU (``sgdm_path``). One ``checkpoint`` line a run."""
    from repro_torch.core.feature_store import FeatureStore
    from repro_torch.core.partition import get_partitioner
    from torch_mesh_jobs import checkpointed_twin, resume
    store = FeatureStore(graph, get_partitioner("metis_like")(
        graph, CACHE_P, SEED), "distdgl")
    capacity = min(store.num_resident(d) for d in range(CACHE_P)) // 4
    del store
    per_iter = {k: CACHE_P * v for k, v in fused_counts.items()}
    cfg_f = dataclasses.replace(cfg, aggregate_backend="pallas_fused")
    d = checkpoint_dir("phase5b")

    def state(tr):
        out = trainer_state(tr, flatten)
        out["pool_generation"] = (None if tr._pool is None else int(
            tr.store.core._shared_mirror._meta[0]))
        return out

    def timed_for(label):
        def timed(run, fn):
            torch.cuda.synchronize()
            agg.reset_launch_counts()
            out = fn()
            torch.cuda.synchronize()
            launches = dict(agg.launch_counts)
            iterations = (sum(m["iterations"] for m in out) if run == "twin"
                          else out["iterations"] - 2)
            want = {k: iterations * v for k, v in per_iter.items()}
            if launches != want:
                fail(f"{label}: {iterations} iterations launched "
                     f"{launches}, expected {want}")
            runs[label] = {"launches": launches}
            return out
        return timed

    def maker(**kw):
        return lambda **extra: SyncGNNTrainer(
            graph, cfg_f, num_devices=CACHE_P, algorithm="distdgl",
            seed=SEED, device="cuda", params=params0, data_parallel=True,
            cache_capacity=capacity, cache_refresh_every=0,
            checkpointer=Checkpointer(str(d), keep=1000), **kw, **extra)

    label = f"checkpoint/pallas_fused/p{CACHE_P}/twin"
    twin = checkpointed_twin(maker(pipeline=False), str(d), state,
                             every=CKPT_EVERY, timed=timed_for(label))
    torch.cuda.empty_cache()
    ms = twin["epochs"]
    saves = sorted(twin["saves"], key=lambda x: x["step"])
    print("checkpoint " + json.dumps({
        "path": label, "card": card, "capacity": capacity,
        "checkpoint_every": CKPT_EVERY,
        "epoch_iteration_s": [m["epoch_time_s"] / m["iterations"]
                              for m in ms],
        "saves": len(saves),
        "snapshot_s": [x["snapshot_s"] for x in saves],
        "write_s": [x["write_s"] for x in saves],
        "copy_wait_s": [x["copy_wait_s"] for x in saves],
        "bytes": [x["bytes"] for x in saves],
        "launches": nonzero(runs[label]["launches"])}), flush=True)
    want = dict(twin["twin"])
    want.pop("pool_generation")
    for name, kw in (("sequential", dict(pipeline=False)),
                     (f"pipelined/{CKPT_WORKERS}_workers/gather",
                      dict(num_sampler_workers=CKPT_WORKERS,
                           gather_in_workers=True))):
        label = f"checkpoint/pallas_fused/p{CACHE_P}/resume/{name}"
        r = resume(maker(**kw), twin["step"], state, timed_for(label))
        torch.cuda.empty_cache()
        got = dict(r["resumed"])
        shared = got.pop("pool_generation")
        if shared is not None and shared != got["cache"]["generation"]:
            fail(f"{label}: the pool's shared segment holds generation "
                 f"{shared}, the cache {got['cache']['generation']}")
        if not same_state(got, want):
            fail(f"{label}: parameters, optimizer state or cache state "
                 f"differ from the uninterrupted twin's")
        print(f"{label}: parameters, optimizer state (step "
              f"{got['opt']['step']}), the cache's counter, resident "
              f"sets, generation {got['cache']['generation']} and "
              f"counters bitwise the uninterrupted twin's", flush=True)
        m = r["resumed_epoch"]
        left = m["iterations"] - 2
        print("checkpoint " + json.dumps({
            "path": label, "card": card, "step": twin["step"],
            "restore_s": r["restore_s"], "iterations": left,
            "iteration_s": m["epoch_time_s"] / left,
            "twin_iteration_s": ms[1]["epoch_time_s"] / ms[1]["iterations"],
            "pool_generation": shared,
            "launches": nonzero(runs[label]["launches"])}), flush=True)
    shutil.rmtree(d, ignore_errors=True)
    sgdm_path(SyncGNNTrainer, graph, cfg_f, params0, groups, ref_loss,
              fused_counts, agg, flatten, card, runs)


def sgdm_path(SyncGNNTrainer, graph, cfg_f, params0, groups, ref_loss,
              fused_counts, agg, flatten, card, runs) -> None:
    """``SGDM_ITERATIONS`` iterations of GraphSAGE on ``"pallas_fused"``
    at p = 1 with ``optimizer_name="sgdm"`` on the card and, from the same
    parameters over the same batches, on the CPU (the plain versions):
    phase 4's launch counts an iteration, the first loss within
    ``LOSS_RTOL`` of ``"reference"``; every loss, each momentum leaf and
    each leaf's update (final parameters less the initial ones) within
    ``LOSS_RTOL`` of the CPU run's, as a largest absolute error over the
    leaf's largest magnitude. The update also has the rounding of the
    parameter at each step: a layer-0 weight's update is a few thousand
    ulps of the weight, so each iteration may round it one ulp apart, at
    most ``eps`` times the leaf's largest parameter. A momentum, rate or
    dtype gone wrong on the card moves both by far more."""
    label = "graphsage/pallas_fused/sgdm"
    sgdm = {}
    for device in ("cuda", "cpu"):
        tr = SyncGNNTrainer(graph, cfg_f, num_devices=1,
                            algorithm="distdgl", seed=SEED, device=device,
                            params=params0, optimizer_name="sgdm")
        p0 = [q.detach().cpu().clone() for q in flatten(tr.params)]
        t0 = time.perf_counter()
        if device == "cuda":
            runs[label] = run_path(label, tr, groups[:SGDM_ITERATIONS],
                                   fused_counts, agg)
            steps = runs[label]["steps"]
        else:
            steps = [tr.run_iteration(g) for g in groups[:SGDM_ITERATIONS]]
        sgdm[device] = {
            "s": time.perf_counter() - t0,
            "losses": [m["loss"] for m in steps],
            "lrs": [m["lr"] for m in steps],
            "has_grad_norm": "grad_norm" in steps[0],
            "update": [q.detach().cpu() - a
                       for q, a in zip(flatten(tr.params), p0)],
            "p_max": [max(float(q.detach().abs().max()),
                          float(a.abs().max()))
                      for q, a in zip(flatten(tr.params), p0)],
            "m": [q.detach().cpu() for q in tr.opt_state["m"]],
            "step": tr.opt_state["step"]}
        del tr
    torch.cuda.empty_cache()
    check_first_loss(label, runs[label], ref_loss)
    card_run, cpu_run = sgdm["cuda"], sgdm["cpu"]
    if not np.allclose(card_run["losses"], cpu_run["losses"],
                       rtol=LOSS_RTOL, atol=0):
        fail(f"{label}: losses {card_run['losses']} on the card, "
             f"{cpu_run['losses']} on the CPU")
    if card_run["has_grad_norm"] or card_run["step"] != cpu_run["step"]:
        fail(f"{label}: SGDM reported a gradient norm or stepped "
             f"{card_run['step']} times ({cpu_run['step']} on the CPU)")
    eps = torch.finfo(torch.float32).eps
    err = {}
    for key in ("m", "update"):
        rel = []
        for a, b, p_max in zip(card_run[key], cpu_run[key],
                               cpu_run["p_max"]):
            scale = float(b.abs().max())
            e = float((a - b).abs().max())
            rounding = SGDM_ITERATIONS * eps * p_max if key == "update" \
                else 0.0
            if e > LOSS_RTOL * scale + rounding:
                fail(f"{label}: {key} leaf of shape {tuple(b.shape)} off "
                     f"the CPU run's by {e} (largest magnitude {scale}, "
                     f"the parameter's rounding {rounding})")
            rel.append(e / scale if scale else 0.0)
        err[key] = max(rel)
    print(f"{label}: {SGDM_ITERATIONS} losses, the momentum and the "
          f"updates (beside the parameters' rounding) within rtol "
          f"{LOSS_RTOL} of the CPU run's (largest errors over the leaf's "
          f"largest magnitude {err})", flush=True)
    print("checkpoint " + json.dumps({
        "path": label, "card": card, "losses": card_run["losses"],
        "cpu_losses": cpu_run["losses"], "lrs": card_run["lrs"],
        "has_grad_norm": card_run["has_grad_norm"],
        "max_rel_err": err, "cpu_s": cpu_run["s"],
        "launches": nonzero(runs[label]["launches"])}), flush=True)


# ---------------------------------------------------------------------------
# data parallelism over ranks: one process a slot under torch.distributed
# ---------------------------------------------------------------------------

def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def mesh_job(job, graph, cfg, params0, device, mesh=None) -> dict:
    """One mesh-phase job (``job``: algorithm, p, kind, and the cache's
    capacity for kind ``"cache"``) on ``device``: a trainer over ``mesh``
    (this process one rank) or, without one, the one-process
    ``data_parallel=True`` trainer of the p slots; ``MESH_ITERATIONS``
    iterations of the epoch's first groups, then one pipelined epoch if
    asked, with the launch counts of each, the losses, the seconds of each
    iteration (host clock, ending in the metrics' read) and of its host
    stages, the epoch's keys that hold no time and its host seconds (this
    process's), the final parameters and the peak device memory. Kind
    ``"cache"`` runs ``MESH_CACHE_EPOCHS`` pipelined epochs alone, with
    the cache refreshed at their boundary, and returns each epoch's keys
    and losses, their launches, and the cache's counter, resident sets
    and generation. Module-level, with its imports inside: a spawned rank
    runs it."""
    import torch
    from repro_torch.core import scheduler as sched
    from repro_torch.core.trainer import SyncGNNTrainer
    from repro_torch.kernels import aggregate as agg
    from repro_torch.nn.param import flatten
    if job["kind"] == "checkpoint":
        return mesh_checkpoint_job(job, graph, cfg, params0, device, mesh)
    cuda = torch.device(device).type == "cuda"
    cache = (dict(cache_capacity=job["capacity"], cache_refresh_every=0)
             if job["kind"] == "cache" else {})
    tr = SyncGNNTrainer(graph, cfg, num_devices=job["p"],
                        algorithm=job["algo"], seed=SEED, device=str(device),
                        params=params0, mesh=mesh,
                        data_parallel=mesh is None, **cache)
    try:
        if cache:
            sync(device)
            agg.reset_launch_counts()
            ms = tr.train(MESH_CACHE_EPOCHS)
            sync(device)
            return {"losses": [m["loss"] for m in ms],
                    "epochs": [{k: m[k] for k in MESH_EPOCH_KEYS}
                               for m in ms],
                    "epoch_iteration_s": [m["epoch_time_s"] / m["iterations"]
                                          for m in ms],
                    "iterations": sum(m["iterations"] for m in ms),
                    "launches": dict(agg.launch_counts),
                    "cache": {"freq": tr.cache.freq.copy(),
                              "generation": tr.cache.generation,
                              "resident": [tr.store.core.resident_ids(d).copy()
                                           for d in range(job["p"])]},
                    "params": [q.detach().cpu().numpy()
                               for q in flatten(tr.params)]}
        groups = list(sched.iterations(
            tr.epoch_schedule()))[:MESH_ITERATIONS]
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        agg.reset_launch_counts()
        losses, walls, stages = [], [], []
        for g in groups:
            t0 = time.perf_counter()
            m = tr.run_iteration(g)
            walls.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            stages.append({k: m[k] for k in (
                "sample_s", "layout_s", "gather_s", "upload_s", "step_s",
                "miss_rows")})
        res = {"losses": losses, "iteration_s": walls, "stages": stages,
               "iterations": len(groups), "launches": dict(agg.launch_counts)}
        if job["kind"] == "epoch":
            agg.reset_launch_counts()
            m = tr.run_epoch()
            res.update(epoch={k: m[k] for k in MESH_EPOCH_KEYS},
                       epoch_time_s=m["epoch_time_s"],
                       epoch_host={k: m[k] for k in (
                           "host_produce_s", "host_wait_s", "host_issue_s",
                           "host_gather_s")},
                       epoch_launches=dict(agg.launch_counts))
        res["params"] = [q.detach().cpu().numpy() for q in flatten(tr.params)]
        res["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                             if cuda else None)
        return res
    finally:
        tr.close()


def mesh_checkpoint_job(job, graph, cfg, params0, device, mesh=None) -> dict:
    """Kind ``"checkpoint"`` of ``mesh_job``: ``torch_mesh_jobs
    .kill_and_resume`` over pipelined epochs with the feature cache
    (``job["capacity"]`` rows, refreshed at the epoch boundary), saved
    every ``CKPT_EVERY`` iterations into a directory under ``job["dir"]``
    (one for the one-process run, one that the ranks share). Returns the
    three epochs' losses and keys, the launches and iterations of both
    trainers together, the resumed (``params``) and uninterrupted
    (``full_params``) parameters, the resumed cache's counter, resident
    sets and generation, the restore's seconds and the saves' records."""
    from repro_torch.checkpoint.checkpointing import Checkpointer
    from repro_torch.core.trainer import SyncGNNTrainer
    from repro_torch.kernels import aggregate as agg
    from repro_torch.nn.param import flatten
    from torch_mesh_jobs import kill_and_resume
    d = Path(job["dir"]) / ("one" if mesh is None else "mesh")

    def make(**kw):
        return SyncGNNTrainer(
            graph, cfg, num_devices=job["p"], algorithm=job["algo"],
            seed=SEED, device=str(device), params=params0, mesh=mesh,
            data_parallel=mesh is None,
            checkpointer=Checkpointer(str(d), keep=1000),
            cache_capacity=job["capacity"], cache_refresh_every=0, **kw)

    def state(tr):
        sync(device)
        return {"params": [q.detach().cpu().numpy()
                           for q in flatten(tr.params)],
                "cache": {"freq": tr.cache.freq.copy(),
                          "generation": tr.cache.generation,
                          "resident": [tr.store.core.resident_ids(i).copy()
                                       for i in range(job["p"])]}}

    sync(device)
    agg.reset_launch_counts()
    r = kill_and_resume(make, str(d), state, every=CKPT_EVERY)
    ms = r["epochs"] + [r["resumed_epoch"]]
    return {"losses": [m["loss"] for m in ms],
            "epochs": [{k: m[k] for k in MESH_EPOCH_KEYS} for m in ms],
            "epoch_iteration_s": [m["epoch_time_s"] / m["iterations"]
                                  for m in ms],
            "iterations": sum(m["iterations"] for m in ms) - 2,
            "launches": dict(agg.launch_counts),
            "params": r["resumed"]["params"],
            "full_params": r["twin"]["params"],
            "cache": r["resumed"]["cache"], "step": r["step"],
            "restore_s": r["restore_s"],
            "saves": [{k: x[k] for k in ("step", "snapshot_s", "write_s",
                                         "bytes")} for x in r["saves"]]}


def mesh_rank(rank, mesh, device, graph_spec, cfg, params0, jobs) -> dict:
    """One rank of a mesh run (``spawn_data_parallel``'s function): the
    graph attached from the parent's shared memory, TF32 off as in the
    parent, and each of ``jobs`` through ``mesh_job`` with every
    all-gather, ``all_to_all_single`` and ``all_reduce`` (the epoch's
    counters; with a cache, its access counts) timed: host clock,
    the device synchronized before and after, so a call's time includes
    waiting for the slower rank. Returns {job: result with its
    ``collectives``: calls, bytes a call (what the rank receives) and ms,
    by collective and size}."""
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch.data.graphs import Graph
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    graph = Graph.from_shared(graph_spec)
    log = []

    def timed(name, fn):
        # each collective's first argument is its output (all_reduce's
        # tensor is both)
        def call(out, *args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            work = fn(out, *args, **kwargs)
            sync(device)
            log.append((name, out.numel() * out.element_size(),
                        (time.perf_counter() - t0) * 1e3))
            return work
        return call

    # the all-gather is all_gather_single, or all_gather_into_tensor in a
    # PyTorch before 2.13 (``distributed.sharding.all_gather_flat``)
    for name, label in (("all_gather_single", "all_gather"),
                        ("all_gather_into_tensor", "all_gather"),
                        ("all_to_all_single", "all_to_all"),
                        ("all_reduce", "all_reduce")):
        if hasattr(dist, name):
            setattr(dist, name, timed(label, getattr(dist, name)))
    out = {}
    for key, job in jobs.items():
        log.clear()
        res = mesh_job(job, graph, cfg, params0, device, mesh)
        coll = {}
        for name, nbytes, ms in log:
            coll.setdefault(f"{name}/{nbytes}", []).append(ms)
        res["collectives"] = {
            k: {"calls": len(v), "bytes": int(k.split("/")[1]),
                "ms_median": statistics.median(v), "ms_min": min(v),
                "ms_max": max(v)} for k, v in coll.items()}
        out[key] = res
    return out


def mesh_phase(graph, cfg, params0, per_slot, runs, device="cuda:0"
               ) -> None:
    """The mesh phase: for each of ``MESH_RUNS``, its jobs in one process
    (``data_parallel=True``, the p slots in turn) and over p spawned ranks
    (``spawn_data_parallel``, every rank on ``device``), from the same
    initial parameters. Every rank's losses, final parameters and epoch
    (every key that holds no time) must equal the one-process run's bit
    for bit, and each rank must launch ``per_slot`` kernels an iteration
    where the one-process run launches p times that. Prints one
    ``mesh_one_process`` line a job and one ``mesh_rank`` line a rank and
    job; adds each rank's launches to ``runs``. A cached job must also
    equal it in the cache's counter, resident sets and generation, after a
    refresh that admitted rows."""
    import functools
    from repro_torch.core.feature_store import FeatureStore
    from repro_torch.core.partition import get_partitioner
    from repro_torch.distributed.launch import spawn_data_parallel
    with graph.to_shared() as shared:
        for backend, p, spec in MESH_RUNS:
            run = f"{backend}/p{p}"
            jobs = {key: {"algo": algo, "p": p, "kind": kind}
                    for key, (algo, kind) in spec.items()}
            for key, job in jobs.items():
                if job["kind"] == "checkpoint":
                    job["dir"] = str(checkpoint_dir(
                        f"mesh_{run}_{key}".replace("/", "_")))
                if job["kind"] in ("cache", "checkpoint"):
                    store = FeatureStore(graph, get_partitioner(
                        "metis_like")(graph, p, SEED), "distdgl")
                    job["capacity"] = min(store.num_resident(d)
                                          for d in range(p)) // 4
            one = {k: mesh_job(j, graph, cfg, params0, device)
                   for k, j in jobs.items()}
            t0 = time.perf_counter()
            ranks = spawn_data_parallel(
                functools.partial(mesh_rank, graph_spec=shared.spec,
                                  cfg=cfg, params0=params0, jobs=jobs),
                p, backend=backend, devices=[device] * p)
            launch_s = time.perf_counter() - t0
            for job in jobs.values():
                if "dir" in job:
                    shutil.rmtree(job["dir"], ignore_errors=True)
            for key, want in one.items():
                print("mesh_one_process " + json.dumps({
                    "run": run, "job": key,
                    "cache_capacity": jobs[key].get("capacity"), **{
                        k: want.get(k) for k in (
                            "losses", "iteration_s", "stages",
                            "epoch_time_s", "epoch_host", "peak_bytes",
                            "launches", "epochs", "epoch_iteration_s",
                            "step", "restore_s", "saves")}}),
                    flush=True)
            for rank, res in enumerate(ranks):
                for key, want in one.items():
                    got = res[key]
                    line = {"run": run, "rank": rank, "job": key,
                            "backend": backend, "ranks": p,
                            "launch_s": launch_s, **{
                                k: got.get(k) for k in (
                                    "losses", "iteration_s", "stages",
                                    "epoch_time_s", "epoch_host",
                                    "peak_bytes", "launches",
                                    "epoch_launches", "collectives",
                                    "epochs", "epoch_iteration_s", "step",
                                    "restore_s", "saves")}}
                    if got.get("epoch_time_s") is not None:
                        line["epoch_iteration_s"] = (
                            got["epoch_time_s"] / got["epoch"]["iterations"])
                    print("mesh_rank " + json.dumps(line), flush=True)
                    label = f"mesh/{run}/rank{rank}/{key}"
                    runs[label] = {"launches": {
                        k: got["launches"].get(k, 0)
                        + got.get("epoch_launches", {}).get(k, 0)
                        for k in got["launches"]}}
                    if got["losses"] != want["losses"]:
                        fail(f"{label}: losses {got['losses']} against the "
                             f"one-process run's {want['losses']}")
                    if not all(np.array_equal(a.view(np.uint32),
                                              b.view(np.uint32))
                               for a, b in zip(got["params"],
                                               want["params"])):
                        fail(f"{label}: final parameters differ from the "
                             f"one-process run's")
                    for k in ("epoch", "epochs"):
                        if got.get(k) != want.get(k):
                            fail(f"{label}: {k} {got.get(k)} against the "
                                 f"one-process run's {want.get(k)}")
                    if "full_params" in want:
                        if not all(np.array_equal(a.view(np.uint32),
                                                  b.view(np.uint32))
                                   for r in (got, want) for a, b in zip(
                                       r["params"], r["full_params"])):
                            fail(f"{label}: the resumed parameters differ "
                                 f"from the uninterrupted run's")
                        if got["step"] != want["step"]:
                            fail(f"{label}: resumed from step "
                                 f"{got['step']}, the one-process run "
                                 f"from {want['step']}")
                    if "cache" in want:
                        gc, wc = got["cache"], want["cache"]
                        if not (np.array_equal(gc["freq"], wc["freq"])
                                and gc["generation"] == wc["generation"]
                                and all(np.array_equal(a, b) for a, b in zip(
                                    gc["resident"], wc["resident"]))):
                            fail(f"{label}: the cache's counter, resident "
                                 f"sets or generation differ from the "
                                 f"one-process run's")
                        if not (wc["generation"] == MESH_CACHE_EPOCHS - 1
                                and want["epochs"][-1]["cache_admissions"]):
                            fail(f"{label}: no refresh admitted a row "
                                 f"({want['epochs']})")
                    n = got["iterations"]
                    counts = [(got["launches"], want["launches"], n)]
                    if "epoch" in got:
                        counts.append((got["epoch_launches"],
                                       want["epoch_launches"],
                                       got["epoch"]["iterations"]))
                    for mine, theirs, iters in counts:
                        # a rank imports fewer kernel modules: compare the
                        # kernels that launched
                        if (nonzero(mine) != nonzero({
                                k: iters * v for k, v in per_slot.items()})
                                or nonzero(theirs) != nonzero({
                                    k: p * iters * v
                                    for k, v in per_slot.items()})):
                            fail(f"{label}: launched {mine} over {iters} "
                                 f"iterations, the one-process run "
                                 f"{theirs}; expected {nonzero(per_slot)} "
                                 f"a slot "
                                 f"and iteration")
                    print(f"{label}: losses, parameters"
                          + (", epoch" if "epoch" in got else "")
                          + (", cached epochs, counter, resident sets"
                             if "cache" in got else "")
                          + " bitwise the one-process run's"
                          + ("; the resumed run's parameters bitwise the "
                             "uninterrupted run's" if "full_params" in got
                             else "")
                          + f"; launches {nonzero(per_slot)} a slot and "
                          f"iteration", flush=True)


# ---------------------------------------------------------------------------
# 6b. GNN serving
# ---------------------------------------------------------------------------

def same_bits(label: str, got: np.ndarray, want: np.ndarray) -> None:
    """Fails unless two float32 arrays are equal bit for bit."""
    if got.shape != want.shape or not np.array_equal(
            np.ascontiguousarray(got).view(np.uint32),
            np.ascontiguousarray(want).view(np.uint32)):
        diff = (float(np.abs(got - want).max()) if got.shape == want.shape
                else f"shapes {got.shape} and {want.shape}")
        fail(f"{label}: not bitwise equal (max abs difference {diff})")


def host_ms(fn, iters: int) -> float:
    """Median milliseconds on the host clock of ``fn()`` followed by a
    synchronize: what a request waits for the call, launches included."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def serve_bucket_line(rt, b, eager, latency_ms, card) -> None:
    """Bucket ``b``'s ``serve_bucket`` line: a replay must equal the
    eager forward over the bucket's buffers bit for bit; both timed by
    CUDA events (device time) and on the host clock (each call then a
    synchronize), beside the median request latency ``latency_ms`` and
    stages of the bucket's requests, its bytes and the eager forward's
    peak."""
    fwd = rt._fwd[b]
    if not torch.equal(fwd.replay().clone(), eager(rt, fwd.batch)):
        fail(f"serve/bucket {b}: a replay differs from the eager forward "
             f"over the same buffers")
    replay_ms = time_ms(fwd.replay, iters=10, warmup=1)
    eager_ms = time_ms(lambda: eager(rt, fwd.batch), iters=10, warmup=1)
    replay_host_ms = host_ms(fwd.replay, SERVE_HOST_ITERS)
    eager_host_ms = host_ms(lambda: eager(rt, fwd.batch), SERVE_HOST_ITERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager(rt, fwd.batch)
    torch.cuda.synchronize()
    print("serve_bucket " + json.dumps({
        "bucket": b, "latency_ms": latency_ms, **rt.bucket_stats()[b],
        "replay_ms": replay_ms, "eager_ms": eager_ms,
        "replay_host_ms": replay_host_ms, "eager_host_ms": eager_host_ms,
        "replay_bitwise_eager": True, "allocated_bytes": base,
        "eager_peak_bytes": torch.cuda.max_memory_allocated(),
        "card": card}), flush=True)


def serving_phase(graph, cfg, params0, params_gat, agg, card) -> dict:
    """Phase 6b: ``ServingRuntime`` on the card at the paper width (the
    docstring's list). Returns the launch counts of the phase, all 0."""
    from repro_torch.core.serving import (ServeConfig, ServingRuntime,
                                          closed_loop_load)
    # the serving tests' ground truth: request ``rid``'s batch built
    # without the runtime, and the eager forward over it
    from torch_serving_truth import (eager_forward as eager, ground_truth,
                                     request_arrays)

    def host_sync_free(label, rt, batch) -> None:
        """One eager forward with every host wait an error: an op that
        waits for the host cannot be captured in a CUDA graph."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager(rt, batch)
        except RuntimeError as e:
            fail(f"{label}: the forward waits for the host, so it cannot "
                 f"be captured: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"{label}: one eager forward under "
              f"set_sync_debug_mode('error'): no host wait", flush=True)

    def check_eager(label, rt, ids, rid, got) -> None:
        same_bits(label, got, ground_truth(rt, ids, rid))

    cfg_s = dataclasses.replace(cfg, aggregate_backend="pallas_fused")
    rng = np.random.default_rng(SEED)
    requests = [rng.choice(graph.train_ids, m).astype(np.int32)
                for m in SERVE_SIZES]
    anchor = int(graph.train_ids[0])
    agg.reset_launch_counts()
    torch.cuda.synchronize()
    allocated0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rt = ServingRuntime(graph, cfg_s, params0, device="cuda")
    store = rt.store
    host_sync_free("serve/graphsage", rt,
                   request_arrays(rt, np.full(8, anchor, np.int32), 0))
    t0 = time.perf_counter()
    n = rt.warmup()
    warm_s = time.perf_counter() - t0
    warm_peak = torch.cuda.max_memory_allocated()
    if n != SERVE_BUCKETS or len(rt.buckets) != SERVE_BUCKETS:
        fail(f"serve: warm-up built {n} graphs over the buckets "
             f"{rt.buckets}, expected {SERVE_BUCKETS}")
    answers, rids, latency = [], [], []
    for ids in requests:
        rids.append(rt._next_rid)
        t0 = time.perf_counter()
        out = rt.predict(ids)
        latency.append(time.perf_counter() - t0)
        if out.shape != (len(ids), graph.num_classes) \
                or not np.isfinite(out).all():
            fail(f"serve: predict of {len(ids)} ids gave {out.shape}, "
                 f"finite {bool(np.isfinite(out).all())}")
        answers.append(out)
    if rt.forward_compiles != SERVE_BUCKETS:
        fail(f"serve: {rt.forward_compiles} graphs after the requests, "
             f"{SERVE_BUCKETS} after warm-up")
    for m in SERVE_EAGER:
        i = SERVE_SIZES.index(m)
        check_eager(f"serve/graphsage/{m}_ids", rt, requests[i], rids[i],
                    answers[i])
    print("serve: graphsage (configured pallas_fused; serving builds no "
          "kernel layout and runs the plain segment sums, as the "
          f"reference), buckets {list(rt.buckets)}, {n} CUDA graphs after "
          f"warm-up ({warm_s:.3f} s, peak {warm_peak} B) and after "
          f"predict at {list(SERVE_SIZES)} ids "
          f"({[round(s, 4) for s in latency]} s); the {list(SERVE_EAGER)}-id"
          f" requests bitwise the eager forward over their batch; card: "
          f"{card}", flush=True)
    rt.reset_stats()
    rng_b = np.random.default_rng((SEED, 1))
    for b in rt.buckets:
        latency_ms = []
        for _ in range(SERVE_BUCKET_REQUESTS):
            ids = rng_b.choice(graph.train_ids, b).astype(np.int32)
            t0 = time.perf_counter()
            rt.predict(ids)
            latency_ms.append((time.perf_counter() - t0) * 1e3)
        serve_bucket_line(rt, b, eager, float(np.median(latency_ms)), card)
    i = SERVE_SIZES.index(SERVE_CPU)
    with ServingRuntime(graph, cfg_s, params0, store=store,
                        device="cpu") as cpu:
        cpu._next_rid = rids[i]  # the same request: its id and its pad
        want = cpu.predict(requests[i])
    scale = float(np.abs(want).max())
    row = check_within(f"serve/cpu/{SERVE_CPU}_ids", "logits",
                       torch.from_numpy(answers[i]), torch.from_numpy(want),
                       RTOL, ATOL * scale)
    print(f"serve/cpu: the {SERVE_CPU}-id request replayed by a CPU runtime,"
          f" within rtol {RTOL} and atol {ATOL} x {scale}: "
          + json.dumps(row), flush=True)
    # a discarded window first: the coalescer's estimate for the 8 bucket
    # still holds its capture (0.7^12 of it after the requests above) and
    # settles here; the points after it find it settled
    closed_loop_load(rt, graph.train_ids, clients=SERVE_CLIENTS[0],
                     requests_per_client=SERVE_LOAD_WARMUP, seed=SEED + 1)
    for clients in SERVE_CLIENTS:
        pt = closed_loop_load(rt, graph.train_ids, clients=clients,
                              requests_per_client=SERVE_LOAD_REQUESTS,
                              seed=SEED)
        if pt["requests"] != clients * SERVE_LOAD_REQUESTS \
                or rt.forward_compiles != SERVE_BUCKETS:
            fail(f"serve/load: {pt}, {rt.forward_compiles} graphs")
        print("serve_load " + json.dumps({**pt, "slo_ms": rt.slo_s * 1e3,
                                          "graphs": rt.forward_compiles,
                                          "card": card}), flush=True)
    rt.close()
    del rt
    for label, fault in (("pool", None), ("pool/kill", SERVE_FAULT)):
        cfg_p = dataclasses.replace(cfg_s, fault=dataclasses.replace(
            cfg_s.fault, fault_spec=fault))
        t0 = time.perf_counter()
        with ServingRuntime(graph, cfg_p, params0, store=store,
                            serve_cfg=ServeConfig(num_workers=SERVE_WORKERS),
                            device="cuda") as rp:
            rp.warmup()
            got = [rp.predict(ids) for ids in requests]
            st = rp.stats()
        for m, a, b in zip(SERVE_SIZES, got, answers):
            same_bits(f"serve/{label}/{m}_ids", a, b)
        if fault is not None and (st["pool"]["respawns"] != 1
                                  or st["pool_degraded"]):
            fail(f"serve/{label}: pool {st['pool']}, degraded "
                 f"{st['pool_degraded']}")
        print(f"serve/{label}: {SERVE_WORKERS} workers"
              + (f", fault {fault!r}" if fault else "")
              + f": every answer bitwise the in-process runtime's; "
              f"respawns {st['pool']['respawns']}, degraded "
              f"{st['pool_degraded']}, {time.perf_counter() - t0:.1f} s",
              flush=True)
    cfg_g = dataclasses.replace(cfg_s, name="gat")
    with ServingRuntime(graph, cfg_g, params_gat, store=store,
                        device="cuda") as rg:
        host_sync_free("serve/gat", rg, request_arrays(
            rg, np.full(8, anchor, np.int32), 0))
        for m in SERVE_GAT_SIZES:
            ids = rng.choice(graph.train_ids, m).astype(np.int32)
            rid = rg._next_rid
            check_eager(f"serve/gat/{m}_ids", rg, ids, rid, rg.predict(ids))
        if rg.forward_compiles != len(SERVE_GAT_SIZES):
            fail(f"serve/gat: {rg.forward_compiles} graphs")
    print(f"serve/gat: {len(SERVE_GAT_SIZES)} CUDA graphs, requests of "
          f"{list(SERVE_GAT_SIZES)} ids bitwise the eager forward",
          flush=True)
    torch.cuda.synchronize()
    counts = dict(agg.launch_counts)
    if any(counts.values()):
        fail(f"serve: launched {nonzero(counts)}; serving runs no kernel")
    print(f"serve: launch counts {counts} (every one 0: the plain path); "
          f"device memory left allocated after the runtimes closed: "
          f"{torch.cuda.memory_allocated() - allocated0} B (cuBLAS keeps a "
          f"workspace for the card's one capture stream)", flush=True)
    torch.cuda.empty_cache()
    return {"launches": counts}


# epoch keys that time the host: they differ between two runs of one epoch
API_TIMED = ("epoch_time_s", "nvtps", "host_produce_s", "host_wait_s",
             "host_gather_s", "host_issue_s", "host_fetch_s",
             "pool_recovery_s")


def iteration_s(run: dict) -> float:
    """Seconds an iteration of a run's last (steady) epoch."""
    m = run["metrics"][-1]
    return m["epoch_time_s"] / m["iterations"]


def check_model_values(label: str, values: dict) -> None:
    """Every number the simulator or the DSE gave must be finite and
    positive."""
    bad = {k: v for k, v in values.items()
           if not (np.isfinite(v) and v > 0)}
    if bad:
        fail(f"{label}: non-finite or non-positive values {bad}")


def api_phase(graph, cfg, params0, fused_rows, fused_counts, runs, agg,
              flatten, card) -> dict:
    """Phase 6c: the paper's API (``core.abstraction.HitGNN``), its DSE and
    the simulator on the card (the docstring's list). ``fused_rows``: phase
    3's two ``aggregate_fused`` launches at the paper batch; ``runs``:
    phase 4's and phase 5's. Returns the launch counts of the facade's
    epoch."""
    from repro_torch.checkpoint.checkpointing import (Checkpointer,
                                                      flatten_with_paths)
    from repro_torch.configs.gnn import DATASETS, GraphDatasetConfig
    from repro_torch.core.abstraction import HitGNN
    from repro_torch.core.dse import H100_SLABS, H100DSE, MiniBatchShape
    from repro_torch.core.simulator import (SimConfig, pipeline_speedup,
                                            sampler_worker_curve)
    from repro_torch.core.trainer import SyncGNNTrainer

    # (a) the design: Listing 1 at the paper configuration
    hit = HitGNN()
    hit.Graph_Partition("metis_like", p=API_P)
    hit.Feature_Storing("distdgl")
    hit.GNN_Computation(cfg.name)
    hit.GNN_Parameters(L=cfg.num_layers, hidden=[cfg.hidden],
                       fanouts=cfg.fanouts, batch_targets=cfg.batch_targets)
    hit.Platform_Metadata(num_devices=API_P)
    design = hit.Generate_Design(DATASETS["reddit"])
    print("design " + json.dumps({"dataset": "reddit", "beta": 0.8,
                                  **design}), flush=True)
    dse = H100DSE()
    considered = [s for s in H100_SLABS
                  if dse.smem_bytes(s) <= dse.meta.smem_bytes]
    smem = {s: {"dse": dse.smem_bytes(s),
                "kernel": agg.aggregate_fused_smem_bytes(s)}
            for s in considered}
    print("design_smem " + json.dumps({str(s): v for s, v in smem.items()}),
          flush=True)
    if any(v["dse"] != v["kernel"] for v in smem.values()):
        fail(f"H100DSE.smem_bytes differs from the built kernel's: {smem}")
    if design["h100"]["slab"] not in considered:
        fail(f"the design's slab {design['h100']} is not one it considered")
    # the paper batch as phase 3 launched it: the rows each layer reads and
    # the destination rows that hold an edge or a self term, its edges
    r0, r1 = fused_rows
    beta = runs["pallas_fused/sequential"]["metrics"][-1]["beta"]
    mb = MiniBatchShape(v=[r0["src_rows"], r0["update_rows"],
                           r1["update_rows"]],
                        a=[r0["edges"], r1["edges"]],
                        f=[r0["w"][0], r0["w"][1], r1["w"][1]])
    best = dse.search(mb, beta)
    layers = []
    for l, r in enumerate(fused_rows):
        shape = (mb.v[l], mb.v[l + 1], mb.a[l], mb.f[l], mb.f[l + 1], beta)
        layers.append({
            "layer": l, "kernel_slab": r["slab"],
            "kernel_cluster": r["cluster"], "kernel_ms": r["ms"],
            "model_ms_at_kernel_shape": 1e3 * dse.agg_layer_time(
                r["slab"], r["cluster"], *shape),
            "model_ms_at_dse_shape": 1e3 * dse.agg_layer_time(
                best["slab"], best["cluster"], *shape)})
    print("design_h100 " + json.dumps({
        "card": card, "beta": beta, "batch": dataclasses.asdict(mb),
        "dse": best, "layers": layers}), flush=True)
    check_model_values("design", {"t_agg": best["t_agg"],
                                  "fpga_throughput":
                                      design["fpga"]["throughput"]})

    # (b) training through Start_training beside a direct trainer
    d = checkpoint_dir("phase6c")
    kw = dict(aggregate_backend="pallas_fused", data_parallel=True,
              device="cuda", params=params0, seed=SEED)
    hit.LoadInputGraph(graph)
    torch.cuda.synchronize()
    agg.reset_launch_counts()
    got = hit.Start_training(epochs=1, checkpoint_dir=str(d), **kw)[0]
    torch.cuda.synchronize()
    launches = dict(agg.launch_counts)
    facade = hit._trainer
    direct = SyncGNNTrainer(graph, hit.GNN_Model(), API_P,
                            algorithm="distdgl", **kw)
    want = direct.run_epoch()
    expected = {k: got["iterations"] * API_P * v
                for k, v in fused_counts.items()}
    if launches != expected:
        fail(f"Start_training: {got['iterations']} iterations launched "
             f"{launches}, expected {expected}")
    differ = {k: (got[k], want[k]) for k in want
              if k not in API_TIMED and got.get(k) != want[k]}
    if differ or set(got) != set(want):
        fail(f"Start_training's epoch differs from a direct trainer's: "
             f"{differ}")
    if not all(torch.equal(a, b) for a, b in zip(flatten(facade.params),
                                                   flatten(direct.params))):
        fail("Start_training's parameters differ from a direct trainer's")
    saved = np.load(hit.Save_model(str(d / "model.npz")))
    leaves = list(flatten_with_paths(facade.params).values())
    if len(saved.files) != len(leaves) or not all(
            np.array_equal(saved[str(i)], q.detach().cpu().numpy())
            for i, q in enumerate(leaves)):
        fail(f"Save_model wrote {len(saved.files)} arrays, not the "
             f"trainer's {len(leaves)} parameters")
    step = Checkpointer(str(d)).latest_step()
    if step != facade.step_no:
        fail(f"Start_training's checkpoint is at step {step}, the trainer "
             f"at {facade.step_no}")
    h2d = direct.aggregate_h2d_bytes("edges")
    facade.close()
    direct.close()
    del hit, facade, direct
    shutil.rmtree(d)
    torch.cuda.empty_cache()
    print("api_epoch " + json.dumps({
        "card": card, "p": API_P, "iterations": got["iterations"],
        "iteration_s": got["epoch_time_s"] / got["iterations"],
        "nvtps": got["nvtps"], "loss": got["loss"],
        "direct_iteration_s": want["epoch_time_s"] / want["iterations"],
        "direct_nvtps": want["nvtps"], "launches": nonzero(launches),
        "bitwise_direct": True, "checkpoint_step": step,
        "saved_arrays": len(saved.files)}), flush=True)

    # (c) the simulator, calibrated from the p = 1 resident runs: phase 4's
    # run_iteration stages, phase 5's epochs, and a 1-worker pool here
    def make():
        return SyncGNNTrainer(
            graph, dataclasses.replace(cfg, aggregate_backend="pallas_fused"),
            num_devices=1, algorithm="distdgl", seed=SEED, device="cuda",
            params=params0, data_parallel=True, num_sampler_workers=1)
    one = epoch_run("pallas_fused/pipelined/1_worker", make,
                    API_WORKER_EPOCHS, fused_counts, agg, flatten)
    check_twin("pallas_fused/pipelined/1_worker", one,
               runs["pallas_fused/sequential"])
    seq, pipe = runs["pallas_fused/sequential"], runs["pallas_fused/pipelined"]
    pooled = {n: runs[f"pallas_fused/pipelined/{n}_workers"] for n in (2, 4)}
    steps = runs["pallas_fused_resident"]["steps"]

    def median(key):
        return float(np.median([m[key] for m in steps]))
    ipc_s = iteration_s(one) - iteration_s(pipe)
    sim = SimConfig(t_sampling=median("sample_s"),
                    t_layout=median("layout_s"), t_gather=median("gather_s"),
                    h2d_layout_bytes=float(h2d), t_ipc=max(0.0, ipc_s))
    ds = GraphDatasetConfig(graph.name, graph.num_vertices, graph.num_edges,
                            graph.features.shape[1], cfg.hidden,
                            graph.num_classes)
    model = dataclasses.replace(cfg, aggregate_backend="pallas_fused")
    ps = pipeline_speedup(model, ds, 1, beta, sim)
    curve = {r["workers"]: r for r in sampler_worker_curve(
        model, ds, 1, beta, sim, worker_counts=(1, 2, 4))}
    last = pipe["metrics"][-1]
    calib = {"t_sampling": sim.t_sampling, "t_layout": sim.t_layout,
             "t_gather": sim.t_gather,
             "h2d_layout_bytes": sim.h2d_layout_bytes,
             "t_ipc": sim.t_ipc, "one_worker_minus_in_process_s": ipc_s,
             "beta": beta, "dataset": dataclasses.asdict(ds)}
    lines = {
        "pipeline": {"modelled_speedup": ps["speedup"],
                     "measured_speedup": iteration_s(seq)
                     / iteration_s(pipe),
                     "modelled_epoch_s": ps["pipelined"]["epoch_time_s"],
                     "measured_epoch_s": last["epoch_time_s"]},
        # the model's one worker is the in-process host (no IPC toll)
        "workers": {"modelled_speedup_vs_1": {
                        n: curve[n]["speedup_vs_1"] for n in (2, 4)},
                    "measured_speedup_vs_in_process": {
                        n: iteration_s(pipe) / iteration_s(pooled[n])
                        for n in (2, 4)},
                    "measured_iteration_s": {
                        "in_process": iteration_s(pipe),
                        "1": iteration_s(one),
                        **{str(n): iteration_s(pooled[n]) for n in (2, 4)}}},
        "times": {"model_t_host_ms": 1e3 * ps["pipelined"]["t_host"],
                  "model_t_gnn_ms": 1e3 * ps["pipelined"]["t_gnn"],
                  "measured_host_ms": 1e3 * last["host_produce_s"]
                  / last["iterations"],
                  "measured_device_busy_ms": pipe["trace"]["device_busy_ms"]
                  / last["iterations"]}}
    print("simulator " + json.dumps({"line": "calibration", "card": card,
                                     **calib}), flush=True)
    for name, line in lines.items():
        print("simulator " + json.dumps({"line": name, "card": card,
                                         **line}), flush=True)
    check_model_values("simulator", {
        "modelled_speedup": ps["speedup"],
        "measured_speedup": lines["pipeline"]["measured_speedup"],
        **{f"modelled_w{n}": v for n, v in
           lines["workers"]["modelled_speedup_vs_1"].items()},
        **{f"measured_w{n}": v for n, v in
           lines["workers"]["measured_speedup_vs_in_process"].items()},
        **lines["times"]})
    return {"launches": launches}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    # the killed-and-resumed run is the checkpoint tests' helper
    sys.path.insert(0, str(root / "tests"))
    try:
        from repro_torch.checkpoint.checkpointing import Checkpointer
        from repro_torch.configs.gnn import GNNModelConfig
        from repro_torch.core import scheduler as sched
        from repro_torch.core.sampler import (NeighborSampler,
                                              layer_capacities)
        from repro_torch.core.sampler_pool import PayloadCodec
        from repro_torch.core.trainer import SyncGNNTrainer, resident_payload
        from repro_torch.data.graphs import scaled_dataset
        from repro_torch.gnn.models import (AGG_KIND, assemble_device_feats,
                                            assemble_p3_feats)
        from repro_torch.kernels import aggregate as agg
        from repro_torch.kernels import build
        from repro_torch.kernels.layout import (block_capacities,
                                                build_layer_layouts)
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ops
        from repro_torch.kernels import update_mlp as um
        from repro_torch.kernels import wkv6 as wk
        from repro_torch.nn.param import flatten, params_to_numpy
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device report
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        max_sm_mhz = float(clk.stdout.strip().splitlines()[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no max SM clock: {clk.stdout!r} "
             f"{clk.stderr.strip()}")
    global SFU_EXP_PER_S
    SFU_EXP_PER_S = SFU_EXP_PER_CLOCK_PER_SM * H100_SMS * max_sm_mhz * 1e6
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(f"card: {card}", flush=True)
    print(f"max SM clock: {max_sm_mhz} MHz; exponential bound rate "
          f"{SFU_EXP_PER_S:.4g}/s", flush=True)

    # 2. build every kernel source, all nvcc processes at once
    t0 = time.perf_counter()
    try:
        reports = build.build(build.sources())
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    usage = {name: ptxas_usage(rep) for name, rep in reports.items()}
    print(f"build: {len(reports)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if ("ptxas info" in line and ("Used" in line
                                          or "Compiling" in line)) \
                    or "spill" in line or "warning" in line.lower():
                print(f"  {name}: {line.strip()}", flush=True)

    # 3. every launch of the main paths, kernel vs plain
    t0 = time.perf_counter()
    graph = scaled_dataset("reddit", scale=SCALE, seed=SEED)
    print(f"graph: {graph.name}, {graph.num_vertices} vertices, "
          f"{graph.num_edges} edges, {graph.features.shape[1]} features, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = GNNModelConfig("graphsage", num_layers=2, hidden=128,
                         fanouts=(25, 10), batch_targets=1024,
                         aggregate_backend="pallas_edges")
    mb = NeighborSampler(graph, cfg, graph.train_ids, 0, SEED).batch_at(0, 0)
    lay = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                              block_capacities(cfg), "mean", edge_stream=True)
    layers = [{k[4:]: v[l] for k, v in lay.items()} for l in range(2)]
    pad = [layers[l]["cols_t"].shape[0] * 128 for l in range(2)]
    out_rows = [layers[l]["cols"].shape[0] * 128 for l in range(2)]
    feats = graph.features[mb.nodes[0]] * mb.node_mask[0][:, None]
    f0, hid, n_cls = feats.shape[1], cfg.hidden, graph.num_classes
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale

    h0 = torch.zeros((pad[0], f0), device="cuda")
    h0[:len(feats)] = torch.from_numpy(feats).cuda()
    h1, g1 = randn(pad[1], hid), randn(out_rows[1], hid)
    rows = {"aggregate_edges": [
        check_edges_launch("layer0_fwd", agg, layers[0], FWD, h0,
                           out_rows[0], usage["aggregate_edges"]),
        check_edges_launch("layer1_fwd", agg, layers[1], FWD, h1,
                           out_rows[1], usage["aggregate_edges"]),
        check_edges_launch("layer1_bwd", agg, layers[1], BWD, g1, pad[1],
                           usage["aggregate_edges"])]}
    w0, w1 = randn(f0, hid, scale=f0 ** -0.5), randn(hid, n_cls,
                                                     scale=hid ** -0.5)
    rows["aggregate_fused"] = [
        check_fused_fwd("layer0_fused_fwd", agg, layers[0], h0, w0,
                        usage["aggregate_fused"]),
        check_fused_fwd("layer1_fused_fwd", agg, layers[1], h1, w1,
                        usage["aggregate_fused"])]
    rows["fused_bwd"] = [
        check_fused_bwd("layer0_fused_bwd", agg, layers[0], h0, w0,
                        randn(out_rows[0], hid), usage["aggregate_fused_bwd"]),
        check_fused_bwd("layer1_fused_bwd", agg, layers[1], h1, w1,
                        randn(out_rows[1], n_cls),
                        usage["aggregate_fused_bwd"])]
    cfg_m = dataclasses.replace(cfg, name="gin", aggregate_backend=
                                "pallas_fused", batch_targets=MERGED_TARGETS)
    mb_m = NeighborSampler(graph, cfg_m, graph.train_ids, 0,
                           SEED).batch_at(0, 0)
    lay_m = build_layer_layouts(mb_m.edge_src, mb_m.edge_dst,
                                mb_m.edge_mask, block_capacities(cfg_m),
                                AGG_KIND["gin"], edge_stream=True)
    lay_m0, lay_m1 = ({k[4:]: v[l] for k, v in lay_m.items()}
                      for l in range(2))
    if lay_m1["cols"].shape[0] != 1:
        fail(f"the {MERGED_TARGETS}-target batch's layer 1 has "
             f"{lay_m1['cols'].shape[0]} destination blocks, not 1")
    # GIN's launches carry the self term s = (1 + eps) h_self
    feats_m = graph.features[mb_m.nodes[0]] * mb_m.node_mask[0][:, None]
    hm0 = torch.zeros((lay_m0["cols_t"].shape[0] * 128, f0), device="cuda")
    hm0[:len(feats_m)] = torch.from_numpy(feats_m).cuda()
    hm1 = randn(lay_m1["cols_t"].shape[0] * 128, hid)
    dst_m = [lay_m0["cols"].shape[0] * 128, 128]
    for l, (lay_l, h_l, w_l) in enumerate((
            (lay_m0, hm0, randn(f0, hid, scale=f0 ** -0.5)),
            (lay_m1, hm1, randn(hid, n_cls, scale=hid ** -0.5)))):
        s_l = randn(dst_m[l], h_l.shape[1])
        rows["aggregate_fused"].append(check_fused_fwd(
            f"gin{MERGED_TARGETS}_layer{l}_fused_fwd", agg, lay_l, h_l, w_l,
            usage["aggregate_fused"], s_l))
        rows["fused_bwd"].append(check_fused_bwd(
            f"gin{MERGED_TARGETS}_layer{l}_fused_bwd", agg, lay_l, h_l, w_l,
            randn(dst_m[l], w_l.shape[1]), usage["aggregate_fused_bwd"],
            s_l))
    rows["fused_bwd_merged"] = [check_merged(
        "layer1_merged_bwd", agg, lay_m1,
        randn(lay_m1["cols_t"].shape[0] * 128, hid),
        randn(hid, n_cls, scale=hid ** -0.5), randn(128, n_cls),
        randn(128, hid), usage["aggregate_fused_bwd"])]
    del hm0, hm1
    lay_c = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                                block_capacities(cfg), "mean")
    compact = [{k[4:]: v[l] for k, v in lay_c.items()} for l in range(2)]
    torch.cuda.empty_cache()
    rows["aggregate_blockcsr"] = [
        check_blockcsr_launch("layer0_blockcsr_fwd", agg, compact[0],
                              COMPACT, layers[0], FWD, h0, iters=2),
        check_blockcsr_launch("layer1_blockcsr_fwd", agg, compact[1],
                              COMPACT, layers[1], FWD, h1),
        check_blockcsr_launch("layer1_blockcsr_bwd", agg, compact[1],
                              COMPACT_T, layers[1], BWD, g1)]
    torch.cuda.empty_cache()
    b0, b1 = randn(hid), randn(n_cls)
    x0 = randn(out_rows[0], f0)
    rows["update_mlp"] = [
        check_update_launch("layer0_update_relu", um, x0, w0, b0, "relu",
                            usage["update_mlp"]),
        check_update_launch("layer0_update", um, x0, w0, b0, "none",
                            usage["update_mlp"]),
        check_update_launch("layer1_update", um, randn(out_rows[1], hid),
                            w1, b1, "none", usage["update_mlp"])]
    del h0, g1, w0, x0
    torch.cuda.empty_cache()

    # 4. the main paths: training steps through the trainer's entry point
    t0 = time.perf_counter()
    runs, peaks = {}, {}
    edges_tr = SyncGNNTrainer(graph, cfg, num_devices=1, algorithm="distdgl",
                              seed=SEED, device="cuda")
    params0 = params_to_numpy(edges_tr.params)
    groups = list(sched.iterations(edges_tr.epoch_schedule()))[:ITERATIONS]
    ref_loss, peaks["reference"] = reference_loss(
        SyncGNNTrainer, graph, cfg, params0, groups[0], flatten)
    print(f"trainers built in {time.perf_counter() - t0:.1f} s", flush=True)
    none = {k: 0 for k in agg.launch_counts}
    runs["pallas_edges"] = run_path(
        "graphsage/pallas_edges", edges_tr, groups,
        {**none, "aggregate_edges": 3}, agg)
    check_first_loss("graphsage/pallas_edges", runs["pallas_edges"],
                     ref_loss)
    del edges_tr
    # the resident feature path (data_parallel) beside each host-gather run
    resident = {}

    def run_resident(backend, label, n_iter, expected) -> None:
        tr = SyncGNNTrainer(
            graph, dataclasses.replace(cfg, aggregate_backend=backend),
            num_devices=1, algorithm="distdgl", seed=SEED, device="cuda",
            params=params0, data_parallel=True)
        key = f"{backend}_resident"
        runs[key] = run_path(f"{label}/resident", tr, groups[:n_iter],
                             expected, agg)
        check_resident(f"{label}/resident", runs[key], runs[backend])
        resident[key] = tr.store

    run_resident("pallas_edges", "graphsage/pallas_edges", ITERATIONS,
                 {**none, "aggregate_edges": 3})
    check_assembly("paper_batch_p1", assemble_device_feats, resident_payload,
                   resident["pallas_edges_resident"], graph.features, mb, 0)
    fused_tr = SyncGNNTrainer(
        graph, dataclasses.replace(cfg, aggregate_backend="pallas_fused"),
        num_devices=1, algorithm="distdgl", seed=SEED, device="cuda",
        params=params0)
    runs["pallas_fused"] = run_path(
        "graphsage/pallas_fused", fused_tr, groups,
        {**none, "aggregate_fused": 2, "fused_bwd": 2, "aggregate_edges": 1},
        agg)
    check_first_loss("graphsage/pallas_fused", runs["pallas_fused"],
                     ref_loss)
    del fused_tr
    fused_counts = {**none, "aggregate_fused": 2, "fused_bwd": 2,
                    "aggregate_edges": 1}
    run_resident("pallas_fused", "graphsage/pallas_fused", ITERATIONS,
                 fused_counts)
    # p = 4: real miss rows cross the bus; every slot runs a batch (idle
    # ones at weight 0), so each count is p times the p = 1 count
    p4 = RESIDENT_P4
    cfg_f = dataclasses.replace(cfg, aggregate_backend="pallas_fused")
    p4_stats = {}
    for key, dp in (("pallas_fused_p4", False),
                    ("pallas_fused_p4_resident", True)):
        tr = SyncGNNTrainer(graph, cfg_f, num_devices=p4,
                            algorithm="distdgl", seed=SEED, device="cuda",
                            params=params0, data_parallel=dp)
        groups4 = list(sched.iterations(
            tr.epoch_schedule()))[:RESIDENT_P4_ITERATIONS]
        runs[key] = run_path(f"graphsage/pallas_fused/p{p4}"
                             + ("/resident" if dp else ""), tr, groups4,
                             {k: p4 * v for k, v in fused_counts.items()},
                             agg)
        p4_stats[key] = [dataclasses.astuple(st) for st in tr.store.stats]
        if dp:
            resident[key] = tr.store
        del tr
    check_resident(f"graphsage/pallas_fused/p{p4}/resident",
                   runs["pallas_fused_p4_resident"], runs["pallas_fused_p4"])
    store4 = resident["pallas_fused_p4_resident"]
    shipped = sum(m["miss_rows"]
                  for m in runs["pallas_fused_p4_resident"]["steps"])
    if p4_stats["pallas_fused_p4_resident"] != p4_stats["pallas_fused_p4"]:
        fail(f"p{p4}: resident accounting {p4_stats} differs from the "
             f"host gather's")
    if not shipped or not store4.beta() < 1.0:
        fail(f"p{p4}: the resident run shipped {shipped} miss rows at beta "
             f"{store4.beta()}")
    print(f"graphsage/pallas_fused/p{p4}/resident: {shipped} miss rows "
          f"shipped, beta {store4.beta()!r}, accounting (local/host rows "
          f"and bytes per device) equal to the host gather's", flush=True)
    for dev in range(p4):
        check_assembly(f"paper_batch_p{p4}", assemble_device_feats,
                       resident_payload, store4, graph.features, mb, dev)
    blockcsr_tr = SyncGNNTrainer(
        graph, dataclasses.replace(cfg, aggregate_backend="pallas"),
        num_devices=1, algorithm="distdgl", seed=SEED, device="cuda",
        params=params0)
    runs["pallas"] = run_path(
        "graphsage/pallas", blockcsr_tr, groups[:BLOCKCSR_ITERATIONS],
        {**none, "aggregate_blockcsr": 3}, agg)
    check_first_loss("graphsage/pallas", runs["pallas"], ref_loss)
    del blockcsr_tr
    run_resident("pallas", "graphsage/pallas", BLOCKCSR_ITERATIONS,
                 {**none, "aggregate_blockcsr": 3})
    p3_paths(SyncGNNTrainer, sched, graph, cfg, params0,
             {"pallas_fused": fused_counts,
              "pallas_edges": {**none, "aggregate_edges": 3}},
             runs, resident, agg)
    check_p3_assembly(f"paper_batch_p3_p{P3_DEVICES}", assemble_p3_feats,
                      resident_payload, resident["p3_pallas_fused_resident"],
                      graph.features, mb)
    memory = {be: {"peak_bytes": runs[be]["peak_bytes"] if be in runs
                   else peaks[be]}
              | {key: runs[be][key] if be in runs else 0
                 for key in ("aggregate_intermediate_bytes",
                             "densified_hbm_bytes")}
              for be in ("reference", "pallas", "pallas_edges",
                         "pallas_fused")}
    print("peak_memory " + json.dumps(memory), flush=True)
    print("peak_memory_resident " + json.dumps({
        key: {"peak_bytes": runs[key]["peak_bytes"],
              "host_gather_peak_bytes":
                  runs[key.replace("_resident", "")]["peak_bytes"],
              "shard_bytes": st.p * st.shard_rows() * st.shard_width() * 4}
        for key, st in resident.items()}),
        flush=True)
    del resident, store4

    merged_tr = SyncGNNTrainer(graph, cfg_m, num_devices=1,
                               algorithm="distdgl", seed=SEED, device="cuda")
    groups_m = list(sched.iterations(
        merged_tr.epoch_schedule()))[:MERGED_ITERATIONS]
    ref_loss_m, _ = reference_loss(SyncGNNTrainer, graph, cfg_m,
                                   params_to_numpy(merged_tr.params),
                                   groups_m[0])
    runs["merged"] = run_path(
        f"gin/pallas_fused/{MERGED_TARGETS}_targets", merged_tr, groups_m,
        {**none, "aggregate_fused": 2, "fused_bwd": 1,
         "fused_bwd_merged": 1}, agg)
    check_first_loss(f"gin/pallas_fused/{MERGED_TARGETS}_targets",
                     runs["merged"], ref_loss_m)
    del merged_tr
    torch.cuda.empty_cache()
    params_gat = gat_paths(SyncGNNTrainer, sched, graph, cfg, none, runs,
                           agg, flatten, params_to_numpy)

    # 5. the host runtime: pipelined and pooled epochs against their twins
    t0 = time.perf_counter()
    runs.update(host_runtime(
        SyncGNNTrainer, graph, cfg, {"graphsage": params0, "gat": params_gat},
        {"pallas_edges": {**none, "aggregate_edges": 3},
         "pallas_fused": fused_counts, "reference": none}, agg, flatten,
        layer_capacities, PayloadCodec, block_capacities, NeighborSampler,
        build_layer_layouts, card))
    print(f"host runtime phase: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 5b. checkpoints and mid-epoch resume, against the uninterrupted twin;
    # SGDM
    t0 = time.perf_counter()
    checkpoint_phase(SyncGNNTrainer, Checkpointer, graph, cfg, params0,
                     groups, ref_loss, fused_counts, agg, flatten, card,
                     runs)
    print(f"checkpoint phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 6. data parallelism over ranks, against the one-process runs
    t0 = time.perf_counter()
    print(f"card: {card}", flush=True)
    mesh_phase(graph, dataclasses.replace(cfg, aggregate_backend=
                                          "pallas_fused"),
               params0, fused_counts, runs)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 6b. GNN serving: one CUDA graph a bucket over the plain path
    t0 = time.perf_counter()
    runs["gnn_serving"] = serving_phase(graph, cfg, params0, params_gat, agg,
                                        card)
    print(f"gnn serving phase: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 6c. the paper's API, its DSE and the simulator
    t0 = time.perf_counter()
    runs["api"] = api_phase(graph, cfg, params0, rows["aggregate_fused"][:2],
                            fused_counts, runs, agg, flatten, card)
    print(f"api phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 7. the kernel entry points, on the layer-1 operands
    seg1 = on_card(layers[1], FWD)
    cols1 = torch.from_numpy(compact[1]["cols"]).cuda()
    blocks1 = agg.densify_tiles(*on_card(compact[1], COMPACT)[:3],
                                *compact[1]["cols"].shape)
    x1 = randn(out_rows[1], hid)
    torch.cuda.synchronize()
    agg.reset_launch_counts()
    got = {"update": ops.update(x1, w1, b1, act="relu"),
           "aggregate": ops.aggregate(blocks1, cols1, h1),
           "aggregate_update": ops.aggregate_update(*seg1, h1, w1),
           "aggregate_update_unfused": ops.aggregate_update(
               *seg1, h1, w1, use_pallas=False)}
    torch.cuda.synchronize()
    runs["ops"] = {"launches": dict(agg.launch_counts)}
    want_counts = {**none, "update_mlp": 1, "aggregate_blockcsr": 1,
                   "aggregate_fused": 1, "aggregate_edges": 1}
    if runs["ops"]["launches"] != want_counts:
        fail(f"ops launched {runs['ops']['launches']}, expected "
             f"{want_counts}")
    fused_plain = agg.aggregate_fused_plain(*seg1, h1, w1)
    want = {"update": um.update_mlp_plain(x1, w1, b1, "relu"),
            "aggregate": agg.aggregate_blockcsr_plain(blocks1, cols1, h1),
            "aggregate_update": fused_plain,
            "aggregate_update_unfused": fused_plain}
    errs = {k: check_close(f"ops.{k}", "out", got[k], want[k]) for k in got}
    print("ops " + json.dumps({"launches": runs["ops"]["launches"],
                               "max_abs_err": errs}), flush=True)

    # 8. the LM zoo's kernels vs plain, at the models' shapes
    del seg1, cols1, blocks1, x1, got, want, fused_plain, h1, w1, b0, b1
    torch.cuda.empty_cache()
    bf16, f32 = torch.bfloat16, torch.float32
    rows["flash_attention_fwd"] = [
        check_flash_launch("llama3_8b_prefill", fa, LM_BATCH, LM_PROMPT,
                           LM_PROMPT, 32, 8, 128, bf16, True, True),
        check_flash_launch("fp32_causal", fa, 1, 1024, 1024, 32, 8, 128,
                           f32, True, False),
        check_flash_launch("noncausal_ragged", fa, 2, 1000, 1537, 8, 2, 128,
                           bf16, False, False),
        # the MoE models' prefills: OLMoE's 16 heads over 16, Grok's 48
        # over 8
        check_flash_launch("olmoe_1b_7b_prefill", fa, LM_BATCH, LM_PROMPT,
                           LM_PROMPT, 16, 16, 128, bf16, True, True),
        check_flash_launch("grok_1_314b_prefill", fa, LM_BATCH, LM_PROMPT,
                           LM_PROMPT, 48, 8, 128, bf16, True, True)
        ] + vlm_dense_flash_launches(fa)
    rows["wkv6_chunk"] = [
        check_wkv6_launch("rwkv6_3b_prefill", wk, LM_BATCH, LM_PROMPT, 40, 64,
                          bf16, False, True, usage["wkv6_chunk"]),
        check_wkv6_launch("fp32", wk, 1, 512, 40, 64, f32, False, False,
                          usage["wkv6_chunk"]),
        check_wkv6_launch("ragged_with_state", wk, 2, 1007, 40, 64, bf16,
                          True, False, usage["wkv6_chunk"])]

    # 9. serving at the published widths and depths (Grok-1 cut to 2
    # layers), then one MoE layer split into its parts
    for arch in LM_ARCHS:
        t0 = time.perf_counter()
        runs[arch] = serve(arch)
        print(f"serving {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    moe_parts(card)
    print(f"moe parts: {time.perf_counter() - t0:.1f} s", flush=True)

    # 9b. the VLM backbone at full depth, one request with its patch rows,
    # and the other dense configs at full depth
    for arch in (VLM_ARCH,) + DENSE_ARCHS:
        t0 = time.perf_counter()
        runs[arch] = serve(arch)
        print(f"serving {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)

    # 10. prefill/decode consistency in fp32 (TF32 is off since the start)
    for arch in LM_ARCHS + (VLM_ARCH,) + DENSE_ARCHS:
        t0 = time.perf_counter()
        consistency(arch)
        print(f"consistency {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)

    # 11. the LM training step: the flash backward against its plain
    # version, the step at full width, and fp32 against the CPU
    t0 = time.perf_counter()
    rows["flash_attention_bwd"] = flash_bwd_launches(
        fa, usage["flash_attention_bwd"])
    runs["llama3_8b_train"] = lm_train(card)
    lm_train_vs_cpu(card)
    print(f"lm training phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 11b. RWKV-6's training step: the WKV6 backward against its plain
    # version, the step at full width, and fp32 against the CPU
    t0 = time.perf_counter()
    rows["wkv6_chunk_bwd"] = wkv6_bwd_launches(wk, usage["wkv6_chunk_bwd"])
    runs["rwkv6_3b_train"] = lm_train(card, "rwkv6-3b")
    lm_train_vs_cpu(card, "rwkv6-3b")
    print(f"rwkv training phase: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 11c. OLMoE-1B-7B's training step (the same flash kernels): the
    # backward at its shape, the step at full width, fp32 against the CPU
    t0 = time.perf_counter()
    rows["flash_attention_bwd"].append(check_flash_bwd_launch(
        "olmoe_1b_7b_train", fa, 1, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 128,
        torch.bfloat16, True, True, usage["flash_attention_bwd"]))
    runs["olmoe_1b_7b_train"] = lm_train(card, "olmoe-1b-7b")
    lm_train_vs_cpu(card, "olmoe-1b-7b")
    print(f"moe training phase: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 11d. LLaVA-NeXT-34B's training step (the same flash kernels at a GQA
    # group of 7): the backward at its shape, the step at full width with
    # the patch rows as the prefix, fp32 against the CPU
    t0 = time.perf_counter()
    rows["flash_attention_bwd"].append(check_flash_bwd_launch(
        "llava_next_34b_train", fa, 1, TRAIN_SEQ, TRAIN_SEQ, 56, 8, 128,
        torch.bfloat16, True, True, usage["flash_attention_bwd"],
        rounding=True))
    runs["llava_next_34b_train"] = lm_train(card, VLM_ARCH)
    lm_train_vs_cpu(card, VLM_ARCH)
    print(f"vlm training phase: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 12. summary
    kernels = [kernel_entry(name, rows[name], {
        path: run["launches"].get(name, 0) for path, run in runs.items()})
        for name in KERNEL_SOURCES]
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} was launched no time on the main paths")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
