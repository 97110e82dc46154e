#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: the DLRM training step of
``bench.py main()``, the unsharded authoring path of the same model
(``EmbeddingBagCollection`` -> ``DLRM`` -> ``DLRMTrain``), the bucketed
training pipeline on the dedup kernels, MLPerf DLRM-v2 (``DLRM_DCN``)
training on the per-id kernels, BERT4Rec training through
``SequenceModelParallel``, the other model families (``DLRM_Transformer``,
DeepFM, the two-tower model and its KNN, the position-weighted EBC), the
planner-driven DLRM application (``examples/dlrm/dlrm_main.py``),
quantized DLRM serving, the serving tier (native queue, TCP and HTTP
front ends, bucketed dedup programs, the replica mesh, FP16/BF16 tables),
serving with no Python in the request path (``export_native``, the
AOTInductor package, the ``trt::`` operators, the C++ executor loop),
and the multi-rank sharded train step (4 gloo
ranks on the card, 1 NCCL rank) with 2D parallelism (``DMPCollection``),
the split steps, qcomms, the sharded ``EmbeddingCollection``, chunked
all-to-alls, the sharded sequence step and ring attention.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and fails (non-zero exit, no result line)
without one, or when the ``torchrec_tpu_torch`` package is not beside it.
``python3 chip_smoke.py --phases dynamic`` runs the kernels' build and the
``dynamic`` phase alone (``--phases`` takes any of ``DEV_PHASES``).
``python3 chip_smoke.py --one-device-gap`` runs only the study of
:func:`one_device_gap` (why a sharded run's tables part from the plain
one-device step's); ``--build-study`` only :func:`build_study` (the
backward sources' build in parts against one unit with and without
``nvcc --split-compile``).

Phases, one JSON line each on stdout; any failure raises:

1. device — the card, its power limit, and the nvcc builds of the
   kernels (``torchrec_tpu_torch/csrc/{tbe_float,tbe_backward,tbe_quant,
   tbe_dedup,tbe_dedup_backward}.cu``, one nvcc per source, started
   together with the g++ builds of ``csrc/torch_ops.cpp`` and
   ``csrc/host/aoti_executor.cpp``) from source, and the registers of every B1, B2 and B6
   instantiation (``registers``: at most 128 for D <= 128 for B2/B6);
2. kernel — each quantized lookup kernel against its plain PyTorch version
   on the card (``torch.equal``) at D=128, S=4096 segments with the MLPerf
   DLRM-v2 multi-hot lengths, a 1M-row table, uniform and Zipf ids; with
   its time, its plain version's, ``F.embedding_bag`` over the
   pre-dequantized float32 table as a yardstick, and the memory bound;
   the kernel's and the yardstick's times both with the host's launch
   work in (``kernel_ms``, ``library_ms``) and of the card alone
   (``kernel_device_ms``, ``library_device_ms``);
   Then the ``planner`` records: the port's sharding planner with its
   H100 profile over the bench tables at world 1 and 4 and over the
   MLPerf DLRM-v2 tables at world 1 (no run);
3. train — the training main path: ``DistributedModelParallel`` at the
   configuration of ``bench.py main()`` (26 tables of 100,000 x 128, SUM,
   float32, one table-wise group, the planner's plan at world 1; B=4096 from ``RandomRecDataset`` with
   one id per feature at most; DLRM 13 -> 512-256-128, over arch
   1024-1024-512-256-1 in bfloat16 with a float32 logit layer; BCE;
   rowwise Adagrad lr 0.05 and optax-style dense Adagrad 0.05).  First
   ``train_kernel``: the float pooled lookup (B1) and the fused backward +
   rowwise Adagrad (B2) against their plain versions at the path's shapes
   (every B1 row through both entries: the slot regions the main paths
   pass, checked for host syncs and held to its output plus the lengths'
   running ends in memory, and the sorted stream)
   (the ``[2,600,000, 128]`` stack, V = S = 106,496 slots of a bench
   batch), float32 and bfloat16 stacks, the batch's uniform ids and
   Zipf(1.1) ids, with the same times and bounds as above (B2 in place,
   its touched rows restored after every call, bfloat16 with stochastic
   rounding); then a path check on the first batch (B1's output, and B2's
   updated stack and momentum from the step's real gradient,
   ``torch.equal`` to the plain versions on the touched rows, nothing
   written elsewhere); then 1 warm-up and 20 timed
   steps over 4 batches (samples/s, every loss finite, one B1 and one B2
   launch per step), three steps under ``torch.profiler``, and 3 steps of
   the bfloat16-table arm with stochastic rounding (its path check also
   holds the rounded stack apart from round-to-nearest);
4. ebc — the unsharded authoring path at the same width: an
   ``EmbeddingBagCollection`` of the 26 float32 tables on the card (drawn
   from a seeded generator), ``DLRM(embedding_bag_collection=...)`` in
   bfloat16 as in phase 3, ``DLRMTrain``, the same ``RandomRecDataset``
   batches.  First ``ebc_kernel``: B1 and B4 against their plain versions
   at the path's shapes (one table's lookup, V = S = 4,096); then
   ``ebc_check``: one forward launches 26 B1s and no other pooled kernel
   (the wrappers' counts and a profile), and with ``kernel="dedup"`` 26
   B4s with the same KeyedTensor (``torch.equal``); the KeyedTensor
   ``torch.equal`` to the one-device DMP's sharded one from a stack filled
   with the EBC's weights; two backward calls on one weighted batch give
   ``torch.equal`` table and weight gradients; ``EmbeddingCollection``
   over the same rows equal to a row gather; ``DLRM_DCN`` (3 layers,
   rank 512) and ``DLRM_Projection`` (both branches 512-256) through the
   same collection give finite logits.  Then 1 warm-up and 20 timed
   ``DLRMTrain`` steps with autograd and the port's dense Adagrad over
   every parameter, tables included (samples/s, losses finite, 26 B1
   launches a step and nothing else, the looked-up rows changed and the
   rows no batch looked up unchanged, peak memory) and three profiled
   steps;
5. train_dedup — the bucketed training pipeline on the dedup kernels:
   the DLRM of phase 3 through ``BucketedTrainPipeline`` (ladder floor 8,
   growth 2, at most 8 signatures; ``kernels`` dedup for the lookup and
   the update) over a stream of up to 64 ids per feature per example
   with Zipf(1.2) lengths from 1 and Zipf(1.0) ids (full caps 262,144
   ids per feature).  First ``dedup_kernel``: the ragged dedup lookup
   (B4) over the float32 stack and its bfloat16 cast (with its card-alone
   time, its wrapper's peak memory, a check that the wrapper makes no host
   sync, and B1 on the same slots), and the dedup fused
   update (B6) for each of its eight optimizers on float32 and rowwise
   Adagrad on bfloat16 with stochastic rounding, each against its plain
   version (``torch.equal``) on the first bucketed batch's slots, with
   times (B4 and B6 also of the card alone), bounds, registers and grid, and
   B6's runs arm (one run each of 1 to 10,000 slots, then the sentinel,
   ``runs_slots``); then the path check on that batch (B4's output
   equal to B1's, B6's update from the step's real gradient equal to its
   plain version's, and the state after one bucketed step equal to the
   state after the same step at full caps); then 1 warm-up and 20 timed
   rowwise-Adagrad steps (samples/s, every loss finite, one B4 and one
   B6 launch per step and nothing else, the signatures dispatched and
   the padding ratios), three profiled steps, and 3 steps of each other
   optimizer and of the bfloat16-table arm;
6. train_dcn — MLPerf DLRM-v2 training (mlcommons/training
   ``recommendation_v2/torchrec_dlrm``) on the per-id kernels:
   ``DistributedModelParallel(DLRM_DCN, table_wise_plan,
   lookup_kernel="tbe", update_kernel="tbe")`` over 26 tables of D=128,
   SUM, float32, at ``min(MLPerf DLRM-v2 rows, 5,000,000)`` rows (one
   table-wise group ``[29,184,588, 128]``: a 14.9 GB stack and a 14.9 GB
   per-element Adagrad state); ``RandomRecDataset`` with the fixed
   multi-hot lengths (214 ids per example; min = max), uniform ids, seed
   0; B=8192 per card (the recipe's 65,536 over 8 GPUs), so the slot
   stream holds 1,753,088 ids in 21,299,200 slots (the table-wise
   layout's uniform per-slot capacity) over S = 212,992 segments; dense
   arch 13 -> 512-256-128 and over arch 1024-1024-512-256-1 in bfloat16
   with a float32 logit layer, ``LowRankCrossNet`` 3 layers at rank 512
   over the 3,456-wide concat in float32 (TF32 off); BCE; per-element
   Adagrad (``EmbOptimType.ADAGRAD``, lr 0.004, eps 1e-8) on the tables
   and optax-style dense Adagrad 0.004.  First ``dcn_kernel``: B1 and B2
   (Adagrad) against their plain versions at the path's shapes (the
   stack, the first batch's slots, its uniform ids and Zipf(1.1) ids per
   table) and B2's runs arm (``runs_slots``), then B2 for the other seven
   optimizers on float32 and all eight on bfloat16 with stochastic
   rounding at the same batch shapes over a stack of ``min(MLPerf rows,
   1,000,000)`` rows (7,116,632 rows); each with kernel (also of the card
   alone), wrapper and plain times, bound, registers and grid, the stack
   and states restored on the touched rows only between calls;
   then the path check on the first batch (B1's output and B2's updated
   stack and momentum from the step's real gradient ``torch.equal`` to
   the plain versions, touched rows past 2^31 bytes); then 1 warm-up and
   20 timed steps over 4 cycled batches (samples/s, every loss finite,
   one B1 and one B2 launch per step and nothing else), the cross net's
   forward and backward alone, three profiled steps with the cross net's
   GEMMs named, and 3 steps of each other optimizer and of a
   bfloat16-table arm at the 1,000,000-row cap;
7. serving — quantized serving: DLRM at the widths of ``bench.py`` (26 sparse
   features, D=128, 13 dense, dense arch 512-256-128, over arch
   1024-1024-512-256-1, float32) over int8 tables at the MLPerf DLRM-v2
   row counts (204,184,588 rows); first each kernel against its plain
   version (``torch.equal``) on every feature of one formed batch (B=256)
   over those tables, uniform and Zipf ids, int8 and the int4/int2 views
   of the same codes, with row offsets past 2^31 bytes; the collection's
   forward on one formed batch under ``torch.cuda.set_sync_debug_mode(
   "error")`` (no host sync); then behind ``InferenceServer`` with eight
   client threads, once with the int8 TBE kernel and once with the dedup
   kernel on Zipf ids (one grouped launch per batch and nothing else);
   then ``serving_fn`` alone at B=4096, a ``torch.profiler`` breakdown of
   one served batch (B=256): wall time, device busy time and idle share,
   the kernels that take the time; and last the grouped launches (all 26
   features of a batch in one launch) against their plain versions at
   the served B=256 and the B=4096 batch, int8 and the int4/int2 views,
   uniform and Zipf ids, with times and bounds;
8. app (before serving) — the DLRM application through its ``main`` at
   ``--num_embeddings 100000 --embedding_dim 128 --batch_size 4096
   --steps 40 --eval_steps 10 --warmup_steps 20`` (8 features x 10 ids,
   DLRM 13 -> 512-256-128, over arch 512-512-256-1, float32; rowwise
   Adagrad and dense Adagrad 0.05, one linear warmup schedule on both;
   the planner's plan at world 1): one B1 per train step and eval batch
   and one B2 per train step and nothing else (counts and a profile),
   finite losses, ``id_overflow`` zero, ``make_forward`` ``torch.equal``
   to ``train_step``'s logits, a ramp step ``torch.equal`` to the plain
   B1/B2 at the scheduled float32 lr, NE / AUC / calibration finite and
   the card's ``RecMetricModule`` within 1e-6 of a CPU module's; ms a
   step, samples/s, eval ms a batch, peak memory, and the planner's
   per-rank HBM and step estimates beside them;
   roundtrip — ``package_model`` at 10k rows per table, loaded on the
   card and on the CPU, scores compared.
12. serving_tier (after roundtrip, before sharded; budget
   ``SERVING_TIER_BUDGET_S`` = 120 s, every check hard) — the DLRM of
   phase 7 over the int8 MLPerf DLRM-v2 tables: the same 256 requests
   (8 client threads, B ≤ 256) through ``InferenceServer`` on the python
   queue, on the native queue, through ``NetworkInferenceServer`` (8
   ``PredictClient`` connections), through a ``BucketedInferenceServer
   (dedup=True)`` behind ``HttpInferenceServer`` (2 executors), and
   through a ``ReplicaRouter`` over two bucketed replicas sharing one
   serving module, the second killed after 128 answers: every score
   within ``rtol=1e-4, atol=1e-5`` of one direct batch, no executor
   error; one B3 (full pad) or B5 (bucketed) launch a batch and no
   other kernel; the bucketed programs'
   pooled KeyedTensors ``torch.equal`` to the full-pad program's at 4
   batch sizes (scores' bitwise equality recorded), a profiled batch
   with B5 and no other pooled kernel, ``program_count`` ≤ its bound and
   ``/metrics`` parsed; the mesh 0 failed and 0 degraded; p50 / p99,
   requests/s and the idle share of one batch for each front end.  Then
   BF16 tables at the full row counts (52.3 GB, drawn in bf16 after the
   int8 tables are freed) behind the native queue: 26 B1 launches a
   batch into float32, no elementwise (cast) kernel in a profiled
   forward, peak memory ≤ tables + 1 GiB, scores finite; the dedup view
   of the same tables 26 B4 launches and the same bits; the grouped
   float lookup through B1 and B4 ``torch.equal`` to its plain version
   at the served batch's own ids, over these tables and over FP16 ones
   at the same rows (rows read past 2^32 elements required).  Then FP16
   and BF16 at 5,000,000 rows a table: the grouped float lookup through
   B1 and B4 ``torch.equal`` to its plain version and to the lookup over
   the float32 tables, with times, bounds and one ``F.embedding_bag``
   over the stacked float32 tables, and the dedup serving program's KT
   equal to the tbe one's.
13. native_serving (after serving_tier, before sharded; budget
   ``NATIVE_SERVING_BUDGET_S`` = 360 s, every check hard) — serving with
   no Python in the request path: the DLRM of ``serving_tier`` at its
   widths through ``package_model`` -> ``export_native(batch_size=256)``
   on the card (``torch.export``, then an AOTInductor package compiled
   with no table inside) -> ``NativeInferenceServer`` (the C++ executor
   loop on the native queue behind the C++ TCP front end), one arm a
   lookup kernel: int8 on B3, int4 on B5, BF16 on B1
   (``lookup_kernel="tbe"``) and on B4 (``"dedup"``), every arm's tables
   capped at 100,000 rows.  Each arm:
   ``model.pt2``'s graph holds each group's ``trt::`` operators (B1 and
   B4: one a feature) and nothing else reads a table; the package is
   under 64 MiB and its mutating operators write one buffer with no copy
   of it; 256 single-example requests over 8 ``PredictClient``
   connections (closed loop, B <= 256, 2 ms flush, seed 0, uniform ids,
   the multi-hot caps) within ``rtol=1e-4, atol=1e-5`` of the eager
   module on the same batches, none NaN; the operator library's counts
   one B3, or B5's three launches, or 26 B1 or 26 B4 a batch and nothing
   else, and Python's launch counts 0; a profiled batch through the
   executor with the operators' kernels and no clone kernel; each group's
   operators ``torch.equal`` to its plain version at a served batch's
   ids; peak memory <= the package's constants + 1 GiB.  p50 / p99 ms,
   requests/s, the idle share of one batch, each step's seconds (package,
   export, save, AOTInductor compile, open) beside ``serving_tier``'s TCP
   figures.
9. sharded — the multi-rank train step (``parallel/comm.py``,
   ``multiprocess.py``, ``sharding/{tw,rw,twrw}.py``, the sharded
   ``EmbeddingBagCollection`` and ``DistributedModelParallel(env=...)``)
   at the width of phase 3, B=4096 per rank.  Four ranks on the one card
   over gloo (``multiprocess.launch``: spawned after the parent built
   every kernel), each on ``cuda:0``, for four plans (``SHARDED_PLANS``):
   table-wise round-robin, table-row-wise over nodes of 2 ranks,
   row-wise + table-wise + column-wise (in 2 shards) + 2 data-parallel
   tables, and the port's planner's plan at world 4, every table
   row-wise (``planned``, which adds each rank's ``make_forward``
   ``torch.equal``
   to the one-device forward of its batch, and one step with rank 0's
   batch over capacity whose ``id_overflow``, summed over ranks, equals
   the one-device counts).  Per plan and rank: the KT of its one-id batch
   ``torch.equal`` to the unsharded ``EmbeddingBagCollection``'s (same
   seeded tables) and of a weighted multi-hot batch (Zipf(1.2) lengths of
   1 to 64, Zipf(1.0) ids, repacked to the ranks' largest bucketed caps)
   ``torch.equal`` on table-wise, column-wise and data-parallel features
   and within 1e-5 on row-wise and table-row-wise ones (partial sums
   added in rank order); on the table-wise plan the dedup kernels' KT
   (B4) ``torch.equal`` to B1's; B1 (over the rank's received regions)
   and B2 (from the step's real gradient) ``torch.equal`` to their plain
   versions and their card-alone times, ranks in turns; 1 warm-up and 1
   timed step (ms a step, each rank's B1 and B2 launches at least one a
   step and nothing else, the wire bytes a step from the ledger); the
   trained tables, gathered by ``table_weights``, ``np.array_equal`` to a
   one-device DMP's after the same 2 steps on the global batches, its
   dense part run over the ranks' micro-batches (``one_device_run``), and
   the losses within ``PLAIN_LOSS_RTOL`` of the plain one-device
   ``train_step``'s on the global batches (its tables part from the
   sharded ones by more than a tolerance could hold: see
   ``--one-device-gap``); and one step on every rank at once under
   ``torch.profiler`` with B1 and B2 in it.  Then one rank over NCCL: the
   row-wise plan's
   KT and its tables after one step ``torch.equal`` to the one-device
   DMP's.  After the plans, in the same 4-rank launch, the stages of
   ``STAGE_BUDGETS`` (each record carries its seconds and budget):
   ``all_reduce`` (the dense gradients through the reduce-scatter
   ``all_reduce_sum``, ``torch.equal`` to an all-gather and rank-order
   sum, bytes and ms of both), ``split`` (``make_embed_step`` then
   ``make_dense_update_step`` ``torch.equal`` to ``train_step``, B1 and
   B2 only), ``chunked_a2a`` (the pooled KT in K = 2, 8 column chunks
   ``torch.equal`` to one all-to-all, the overlapped first layer within
   1e-5 of ``a2a(x) @ w``), ``qcomms`` (the row-wise plan with bf16 and
   int8 wire codecs: KT within the JAX package's fp32-vs-qcomm bounds and
   not equal, the ledger's bytes the codec's, finite losses),
   ``dmp2d_replicated`` and ``dmp2d_fully_sharded`` (``DMPCollection`` over
   2 replicas of 2 model ranks, the planner's world-2 plan: B1/B2 against
   their plain versions at each rank's shapes, 1 + 1 steps with
   ``maybe_sync`` launching B1 and B2 and nothing else, the replicas
   ``torch.equal`` after each sync and apart between; FULLY_SHARDED: the
   replicas' forwards equal, the losses within ``PLAIN_LOSS_RTOL`` of the
   plain one-device step and the tables ``np.array_equal`` to the
   micro-batched one-device run), and ``sharded_ec`` (the sharded
   ``EmbeddingCollection`` on the mixed plan (row-, table- and
   column-wise groups and 2 data-parallel tables) over a 1-4 id sequence
   batch: rows ``torch.equal`` to the unsharded collection's with
   ``index_dedup`` off and on, an update launching only B6, B6 equal to
   its plain version at each group's shapes, the tables after 3 steps
   ``np.array_equal`` to one device's).  Then ``seq_sharded``: BERT4Rec
   at the seq width (phase 10) over the ranks, 64 sessions each (global
   256), on a row-wise plan and a table-wise one (the item table on rank
   3): the rows before training ``torch.equal`` to the unsharded EC's, B6
   ``torch.equal`` to its plain version at each rank's shapes, 3 steps
   launching B6 and nothing else, the table after them ``np.array_equal``
   to the one-device run over the ranks' micro-batches in rank order
   (``seq_one_device_run``) and the losses within ``PLAIN_LOSS_RTOL`` of
   the plain one-device step on the ranks' objective (``seq_plain_run``);
   and ``ring_attention``: B=2, T=8192 over the 4 ranks, H=8, Dh=64,
   causal and padded, the output within ``RING_OUT_ATOL`` of
   ``full_attention_reference`` on rank 0 and the q, k, v gradients
   within ``RING_GRAD_RTOL`` of its autograd's largest.  The times of
   this phase are of 4 processes sharing one card: not multi-GPU figures.
10. seq (after train_dcn) — the sequence path: ``SequenceModelParallel``
   training BERT4Rec at the paper's MovieLens-20m width (Sun et al., CIKM
   2019, Table 1 and section 4.4: 26,744 items, N = 200, d = 64, 2
   blocks, 2 heads, batch 256, mask proportion 0.2, Adam lr 1e-4 on the
   dense part and, through B6, on the item table) on one device.  Cuts:
   synthetic sessions (lengths uniform on 5-200, Zipf(1.0) item ids, the
   cloze mask only inside each real length, random targets) stand in for
   the ML-20m ratings, which wait until such files are in the
   repository; the paper's l2 weight decay and linear lr decay are left
   out (the JAX ``SequenceModelParallel`` takes neither).  The rows of
   the item collection ``torch.equal`` to the unsharded EC's; B6 (Adam)
   ``torch.equal`` to its plain version at the step's 51,200 per-id slots
   (``seq_kernel``, with times and bound); 1 warm-up and 20 timed steps
   over 4 batches (ms a step, sequences/s, peak memory; losses finite,
   the last, on batch 0 again, below the first; 21 B6 launches and
   nothing else) and two profiled steps (the idle share; the fused
   update and no pooled kernel on the card);
11. models (after seq) — the other model families at the train width (26
   f32 tables of 100,000 x 128, B=4096, 13 dense features):
   ``DLRM_Transformer`` (8 heads, 4 layers, its MLPs as phase 3's) and
   ``SimpleDeepFMNN`` (hidden 512, deep dimension 128) through the
   one-device DMP (the path check: B1 and B2 ``torch.equal`` to their
   plain versions at the path's shapes; 1 + 10 steps, one B1 and one B2
   each and nothing else, counts and a profiled step); ``TwoTower`` (a
   1,000,000 x 64 table a tower, MLPs 128-64, 1 to 8 query ids): 1 + 10
   steps of in-batch negatives with Adam over every parameter (two B1
   launches a step), then ``BruteForceKNN`` over the candidate tower's
   1,000,000 embeddings, top 100 of 4096 queries (8 held to a host
   recompute within 1e-5); the position-weighted EBC's forward (1 to 20
   ids, learned position weights): 26 weighted B1 launches, each
   ``torch.equal`` to the plain version.  ms a step for each.
14. lowp_state (after train_dcn; budget ``LOWP_BUDGET_S``) — train_dcn's
   configuration with a bfloat16 per-element Adagrad state: the path
   check (B1, and B2 with the bf16 momentum, ``torch.equal`` to plain on
   the step's own gradient), 1 + 10 steps with one B1 and one B2 each and
   nothing else (counts and a profile), the state still bf16, ms a step
   and peak memory beside train_dcn's float32-state run; at the 1M-row
   cap B2 and B6 for the six stateful optimizers over bf16 and f16 states
   and, on bf16 tables with stochastic rounding off, ``torch.equal`` to
   plain; 2 steps each of the switch off and on through each kernel,
   whose tables differ.  The ``guarded`` phase ends with ``registry``
   (a DMP built under ``trace_kernels(pooled="pallas_dedup",
   update="pallas_dedup")`` launches B4 and B6 alone, its KT
   ``torch.equal`` to an explicit dedup DMP's; the default registry B1
   and B2) and the ``serving`` phase checks ``quant_registry`` (a
   ``QuantEmbeddingBagCollection`` built under ``pallas_dedup`` looks up
   through B5 alone).  The sharded launch adds, after ``dedup_rw``,
   ``vbe`` (budget ``VBE_BUDGET_S``: 13 features at full stride and 13 at
   stride 1,024 with inverse indices, plans rw_dedup, twrw and mixed
   (whose groups are rw, tw, cw and dp): the KT ``torch.equal`` to the
   unsharded collection's VBE
   forward and to the expanded batch's, multi-hot within 1e-5 off TW/DP,
   two VBE steps ``torch.equal``, the tables within rtol 1e-5 / atol 1e-6
   of the expanded batch's step, the fused updates ``torch.equal`` to
   plain) and ``hier`` (budget ``HIER_BUDGET_S``: the ranks as 2 slices x
   2, plans twrw and mixed two-level against flat; see
   :func:`hier_stage`).
15. ft_loop (after models; budget ``FT_BUDGET_S``) — the fault-tolerant
   loop (``reliability/train_loop.py``) over ``TrainPipelineSparseDist`` at
   ``bench.py main()``'s DMP with ``Checkpointer(keep_last_n=2,
   async_save=True)``: a NaN step skipped (state ``torch.equal``), three
   bad steps rolled back (``torch.equal`` to a fresh restore), transient
   read errors retried, a SIGTERM's final checkpoint and two resumes, the
   final state ``torch.equal`` to an uninterrupted run, one B1 and one B2
   a step call; the checkpoint drills (crash before the commit, a flipped
   table byte) and the semi-sync rollback arm at ``train_dedup``'s
   configuration (B4/B6); see :func:`ft_loop_phase`.
16. elastic (last; budget ``ELASTIC_BUDGET_S``) — ``ElasticSupervisor``
   over ``reliability/elastic_demo.py`` as 2 gloo ranks on the card at
   bench widths with 10,000 rows a table: a SIGKILLed rank, the relaunch
   at world 1 resuming through ``restore_elastic``, its digest equal to
   a clean restart's, and a torn save; see :func:`elastic_phase`.  The
   sharded launch ends with the ``reshard`` stage (budget
   ``RESHARD_BUDGET_S``; :func:`reshard_stage`) and the parent's world-1
   ``restore_elastic`` of its checkpoint.
17. tiered (after elastic; budget ``TIERED_BUDGET_S``) — MLPerf DLRM-v2
   (``DLRM_DCN``, train_dcn's widths and optimizer, B = 8192) trained
   with its five 40M-row tables host-cached: the planner's
   FUSED_HOST_CACHED plan (cache load factor 0.2: 1,000,000 cache rows
   over 5,000,000 packed host rows a table), ``tiered_tables_from_plan``,
   ``TieredCollection`` and ``TieredTrainPipeline`` on B4/B6, prefetch on
   and off, each ``torch.equal`` to the all-device bucketed run in every
   loss and every logical row and Adagrad slot; the synchronous
   ``host_offload`` arm (B1/B2) ``torch.equal`` to the all-device step;
   B4/B6 against plain at the cache stack; the loop arm (a NaN skip, and
   drain + checkpoint + resume) at 100,000 rows; see
   :func:`tiered_phase`.
18. migrate (after tiered; budget ``MIGRATE_BUDGET_S``) — ``migration_demo``'s
   recipe at bench widths on 2 gloo ranks sharing the card: the drift
   alarms the health monitor and the migrator flips the big table RW ->
   DP with no committed step lost, its state equal to a clean restart's
   under the new plan, no alert in a clean arm, and one supervised
   ``kill_mid_reshard`` drill; see :func:`migrate_phase`.
19. dynamic (last; budget ``DYNAMIC_BUDGET_S``, every check hard) —
   the dynamic side (``dynamic/``, ``modules/mc_modules.py``,
   ``inference/freshness.py``, the hot-row cache): ``vocab`` (26
   ``DynamicVocab``s of 100,000 slots in front of ``bench.py main()``'s
   trainer, dynamic_bench's stream, 1 + 6 steps: losses, tables and
   momentum ``torch.equal`` to an oracle that held the final map from
   step 0, one B1 and one B2 a step, the path check), ``fresh`` (the
   same trainer under ``FaultTolerantTrainLoop`` publishing a delta
   generation at every checkpoint to a ``BucketedInferenceServer
   (hot_rows=)`` replica: host tier and card caches ``torch.equal`` to
   the trainer, served scores against a direct batch, 26 B4 a batch,
   the torn, corrupt and clean publishes), ``zch`` (26 managed-collision
   modules and a ``ParameterServer``: stored, reset and restored rows),
   ``vocab_evict`` (8,192 slots: LFU, TTL, deferrals, KV rows) and
   ``gate`` (``TieredCollection(vocab=)`` on B4/B6 against the sanitized
   stream, checkpoint and resume); see :func:`dynamic_phase`.  The gloo
   launch of ``sharded`` also runs ``zch_synced``
   (:func:`zch_synced_stage`).

Then the ``kernels`` summary line, the ``nvidia-smi`` name/power line,
and the result line ``{"ok": true, "device": {...}}`` last.

Cut for the smoke run: the training weights are random from a seed and
the step count is the bench's; for ``train_dcn``, the five 40M-row
tables are capped at 5,000,000 rows each (no other table exceeds 5M;
104 GB of float32 tables and Adagrad state cannot fit one card), the
weights are random from a seed and 4 batches are cycled; the serving
tables' codes, scales and
biases are drawn on the device from a seeded generator instead of
quantizing trained weights through ``package_model`` (26 GB of float
tables would not fit the run); the dense weights are random from a seed;
the serving tier's BF16/FP16 rows are drawn from a seeded generator in
their own dtype, and its kernel checks cap the tables at 5,000,000 rows
(a float32 copy of the full BF16 tables, 104.5 GB, cannot be held); the
eviction arm of ``dynamic`` puts 8,192 vocabulary slots in front of the
bench table (at its 100,000 rows nothing evicts within the phase); the
native serving arms cap the MLPerf DLRM-v2 tables at 100,000 rows, the
bench's row count (921,198 rows: ``package_model`` writes them,
``export_native`` saves them again in ``model.pt2`` and the server reads
them back, all on the machine's disk inside the whole run's time limit;
the widths, the 26 features and their multi-hot caps stay), and their
float rows
are drawn on the card from a seeded generator before ``package_model``
quantizes them.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bandwidth and float32 rate
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

KERNEL_SOURCES = {
    "pooled_lookup": "torchrec_tpu_torch/csrc/tbe_float.cu",
    "fused_sparse_update": "torchrec_tpu_torch/csrc/tbe_backward.cu",
    "quant_pooled_lookup_int8": "torchrec_tpu_torch/csrc/tbe_quant.cu",
    "dedup_quant_pooled_lookup": "torchrec_tpu_torch/csrc/tbe_quant.cu",
    "dedup_pooled_lookup": "torchrec_tpu_torch/csrc/tbe_dedup.cu",
    "dedup_fused_sparse_update":
        "torchrec_tpu_torch/csrc/tbe_dedup_backward.cu",
}
# the main paths that launch each kernel (chip_smoke's phases)
KERNEL_PATHS = {
    "pooled_lookup": ["train", "ebc", "train_dcn", "app", "sharded",
                      "split", "qcomms", "dmp2d_replicated",
                      "dmp2d_fully_sharded", "models", "serving_tier",
                      "guarded", "dedup_rw", "ft_loop", "elastic",
                      "reshard", "tiered", "migrate", "dynamic_vocab",
                      "dynamic_fresh", "dynamic_zch", "dynamic_vocab_evict",
                      "zch_synced"],
    "fused_sparse_update": ["train", "train_dcn", "app", "sharded", "split",
                            "qcomms", "dmp2d_replicated",
                            "dmp2d_fully_sharded", "models", "dedup_rw",
                            "ft_loop", "elastic", "reshard", "tiered",
                            "migrate", "dynamic_vocab", "dynamic_fresh",
                            "dynamic_zch", "dynamic_vocab_evict",
                            "zch_synced"],
    "quant_pooled_lookup_int8": ["serving", "serving_tier"],
    "dedup_quant_pooled_lookup": ["serving", "serving_tier"],
    "dedup_pooled_lookup": ["train_dedup", "ebc", "serving_tier",
                            "guarded", "dedup_rw", "ft_loop", "tiered",
                            "dynamic_fresh", "dynamic_gate"],
    "dedup_fused_sparse_update": ["train_dedup", "sharded_ec", "seq",
                                  "seq_sharded", "guarded", "dedup_rw",
                                  "ft_loop", "tiered", "dynamic_gate"],
}
REPLACES = {
    "pooled_lookup": "torchrec_tpu/ops/pallas_tbe.py:287",
    "fused_sparse_update": "torchrec_tpu/ops/pallas_tbe_backward.py:920",
    "quant_pooled_lookup_int8":
        "torchrec_tpu/ops/pallas_tbe.py:383",
    "dedup_quant_pooled_lookup":
        "torchrec_tpu/ops/pallas_tbe.py:888",
    "dedup_pooled_lookup": "torchrec_tpu/ops/pallas_tbe.py:811",
    "dedup_fused_sparse_update":
        "torchrec_tpu/ops/pallas_tbe_backward.py:1127",
}

KERNEL_ROWS = 1_000_000
# cuda_ms(device_only=True): the spin that hides the host's launch time
# (about 1.1 ms at the H100's 1.755 GHz boost clock)
SPIN_CYCLES = 2_000_000
KERNEL_SEGMENTS = 4096
DIM = 128
NUM_DENSE = 13
DENSE_ARCH = (512, 256, DIM)
OVER_ARCH = (1024, 1024, 512, 256, 1)
NUM_REQUESTS = 256
NUM_CLIENTS = 8
SERVING_BATCH = 256
BENCH_BATCH = 4096
ROUNDTRIP_ROWS = 10_000
ZIPF_A = 1.1
# the training step of bench.py main()
TRAIN_FEATURES = 26
TRAIN_ROWS = 100_000
TRAIN_BATCH = 4096
TRAIN_LR = 0.05
TRAIN_BATCHES = 4
TRAIN_STEPS = 20
BF16_STEPS = 3
SR_SEED = 12345
# the bucketed training pipeline on the dedup kernels: the same DLRM, a
# stream with Zipf(1.2) lengths of 1..64 ids per feature (bench.py's
# bucketing bench) and Zipf(1.0) ids (its dedup bench's headline exponent)
DEDUP_MAX_IDS = 64
DEDUP_ZIPF_LENGTHS = 1.2
DEDUP_ZIPF_IDS = 1.0
BUCKETING = {"floor": 8, "growth": 2.0, "max_programs": 8}
ARM_STEPS = 3
# the plain versions of the fused updates walk a Zipf-hot row slot by slot
PLAIN_RUNS = 1
# MLPerf DLRM-v2 training (DLRM_DCN, train_dcn): the row cap of the main
# path and of the kernel rows and arms of the other optimizers, the
# recipe's per-card batch, cross net and learning rate
DCN_ROW_CAP = 5_000_000
DCN_ARM_ROW_CAP = 1_000_000
DCN_BATCH = 8192
DCN_LAYERS = 3
DCN_RANK = 512
DCN_LR = 0.004
EPS = 1e-8  # the fused optimizers' eps (the JAX default)
# row offsets past this many bytes need the kernels' 64-bit addressing
FAR_BYTES = 2**31
# the runs arm of B2 and B6: one run of each length on its own row (the
# table's last among them), then RUN_PADDING invalid slots (the sentinel)
RUN_LENGTHS = (1, 2, 31, 32, 33, 63, 64, 65, 100, 1000, 2731, 3000, 10000)
RUN_PADDING = 4096
# multiplies, adds, divisions and roots per column of one row's update
# (after the gradient sum), for the operations bound of the fused updates
UPDATE_OPS_PER_COLUMN = {
    "sgd": 2, "lars_sgd": 6, "adagrad": 6, "rowwise_adagrad": 5,
    "adam": 13, "partial_rowwise_adam": 9, "lamb": 17,
    "partial_rowwise_lamb": 13,
}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, flush, runs: int = 20, warmup: int = 3, setup=None,
            device_only: bool = False) -> float:
    """Median time of ``fn`` over ``runs`` calls after ``warmup``, by CUDA
    events; ``flush`` (a 128 MB buffer) is rewritten before each timed
    call, outside the events, so no call finds the previous call's rows in
    the 50 MB L2.  ``setup`` (if given) runs before each call, outside the
    events too: it restores what an in-place ``fn`` wrote.  By default the
    events also take in the host's time to launch ``fn``'s work whenever
    the card waits for it; ``device_only`` first queues a ~1 ms spin on
    the card, so the host has queued ``fn``'s work before the start event
    and the events time the card alone."""
    import torch

    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if setup is not None:
            setup()
        flush.zero_()
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def memory_of(fn):
    """(peak, held): the card memory one call of ``fn`` allocates at its
    peak, and what it still holds when it returns (its output), both above
    what was allocated before it.  The allocator's cache is emptied first,
    so the same calls get the same blocks every time."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kept = fn()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del kept
    return torch.cuda.max_memory_allocated() - before, held


def meta_ebc(tables):
    """The model's ``EmbeddingBagCollection`` on ``torch.device("meta")``:
    a placeholder where the sharded collection or the quantized one holds
    the tables (no table is allocated twice)."""
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )

    return EmbeddingBagCollection(tables, device="meta")


def zipf_ids(rng: np.random.RandomState, size: int, rows: int) -> np.ndarray:
    """Zipf-distributed ids as ``bench.py`` draws them."""
    return np.minimum(rng.zipf(ZIPF_A, size=size) - 1, rows - 1)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(dev, flush):
    import torch
    import torch.nn.functional as F

    from torchrec_tpu_torch.datasets.criteo import MLPERF_DLRM_V2_MULTI_HOT
    from torchrec_tpu_torch.ops import tbe

    R, D, S = KERNEL_ROWS, DIM, KERNEL_SEGMENTS
    lengths = torch.tensor(
        [MLPERF_DLRM_V2_MULTI_HOT[s % len(MLPERF_DLRM_V2_MULTI_HOT)]
         for s in range(S)], dtype=torch.int64,
    )
    V = int(lengths.sum())
    segs = torch.repeat_interleave(torch.arange(S), lengths).to(dev)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(lengths, 0)[:-1]]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    w = torch.rand(V, generator=gen, device=dev)
    scale = (torch.rand(R, generator=gen, device=dev) + 0.5) * (0.1 / 255)
    bias = torch.rand(R, generator=gen, device=dev) * 0.01 - 0.05
    rng = np.random.RandomState(0)
    id_sets = {
        "uniform": torch.randint(0, R, (V,), generator=gen, device=dev),
        "zipf": torch.from_numpy(zipf_ids(rng, V, R)).to(dev),
    }
    rows = []
    for bits in (8, 4, 2):
        Dp = D * bits // 8
        packed = torch.randint(0, 256, (R, Dp), generator=gen, device=dev,
                               dtype=torch.uint8)
        deq = (tbe.unpack_rows(packed, bits).to(torch.float32)
               * scale[:, None] + bias[:, None])
        kernels = [("dedup_quant_pooled_lookup", tbe.dedup_quant_pooled_lookup,
                    tbe.dedup_quant_pooled_lookup_plain, {"bits": bits})]
        if bits == 8:
            kernels.insert(0, ("quant_pooled_lookup_int8",
                               tbe.quant_pooled_lookup_int8,
                               tbe.quant_pooled_lookup_int8_plain, {}))
        for dist, ids in id_sets.items():
            args = (packed, scale, bias, ids, segs, S, w)
            U = int(torch.unique(ids).numel())
            # the least this lookup must move: each distinct row (codes +
            # scale + bias) once, each id, segment and weight once, the
            # float32 output once; 4 flops per id and column
            nbytes = (U * (Dp + 8)
                      + V * (ids.element_size() + segs.element_size()
                             + w.element_size())
                      + S * D * 4)
            flops = 4 * V * D
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            flops_ms = flops / PEAK_F32_FLOPS * 1e3
            library = lambda: F.embedding_bag(  # noqa: E731
                ids, deq, offsets, mode="sum", per_sample_weights=w)
            lib_ms = cuda_ms(library, flush)
            lib_device_ms = cuda_ms(library, flush, device_only=True)
            lib_out = F.embedding_bag(ids, deq, offsets, mode="sum",
                                      per_sample_weights=w)
            for name, wrapper, plain, kw in kernels:
                got = wrapper(*args, **kw)
                torch.cuda.synchronize()
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, ref))
                err = float((got - ref).abs().max())
                if not equal:
                    raise AssertionError(
                        f"{name} bits={bits} {dist}: kernel != plain "
                        f"(max abs err {err})"
                    )
                if name == "quant_pooled_lookup_int8":
                    prep = tbe.sort_by_segment(ids, segs, w, S, R)
                    launch = lambda: tbe.launch_q8_pooled(  # noqa: E731
                        packed, scale, bias, *prep)
                else:
                    prep = tbe.dedup_prepare_sized(ids, segs, w, S)
                    launch = lambda: tbe.launch_dedup_q(  # noqa: E731
                        packed, scale, bias, *prep, bits)
                rec = {
                    "phase": "kernel", "kernel": name, "bits": bits,
                    "ids": dist, "rows": R, "D": D, "S": S, "V": V,
                    "distinct": U, "equal": equal, "max_abs_err": err,
                    "ms": cuda_ms(lambda: wrapper(*args, **kw), flush),
                    "kernel_ms": cuda_ms(launch, flush),
                    "kernel_device_ms": cuda_ms(launch, flush,
                                                device_only=True),
                    "plain_ms": cuda_ms(lambda: plain(*args, **kw), flush),
                    "library_ms": lib_ms,
                    "library_device_ms": lib_device_ms,
                    "library_max_abs_diff": float(
                        (lib_out - got).abs().max()),
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": max(bytes_ms, flops_ms),
                    "bound_by": "bytes" if bytes_ms >= flops_ms
                    else "operations",
                }
                emit(rec)
                rows.append(rec)
        del packed, deq
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the training step at full width
# ---------------------------------------------------------------------------


def build_trainer(dev, table_dtype, model_fn=None):
    """``DistributedModelParallel`` at the configuration of ``bench.py
    main()``, on the plan of the planner at world 1 as ``bench.py main()``
    makes it (bench.py:3987; ``table_wise_plan``, which the planner
    record holds), its state from a seeded generator on the card, and the
    first ``TRAIN_BATCHES`` batches of its dataset on the card.
    ``model_fn(tables)``: another model over the same tables (the
    ``models`` phase), in place of the bench's DLRM."""
    import torch

    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
    from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner

    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    tables = tuple(
        EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k in keys)
    ds = RandomRecDataset(keys, TRAIN_BATCH, [TRAIN_ROWS] * len(keys),
                          [1] * len(keys), num_dense=NUM_DENSE,
                          manual_seed=0)
    model = (DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                  dense_dtype=torch.bfloat16) if model_fn is None
             else model_fn(tables))
    dmp = DistributedModelParallel(
        model, tables, EmbeddingShardingPlanner(world_size=1).plan(tables),
        TRAIN_BATCH, dict(zip(keys, ds.caps)),
        fused_config=FusedOptimConfig(learning_rate=TRAIN_LR),
        dense_optimizer=adagrad(TRAIN_LR), table_dtype=table_dtype,
        device=dev,
    )
    state = dmp.init(torch.Generator(device=dev).manual_seed(0))
    it = iter(ds)
    batches = [next(it).to(dev) for _ in range(TRAIN_BATCHES)]
    return dmp, state, batches


def _b1_bytes(R, D, esize, ids, segs, w, S):
    """The bytes the pooled lookup must move on these inputs, by part:
    each distinct valid row once, each valid slot's id, segment and
    weight once (a padding slot needs no read), the output once.
    Returns (distinct rows, valid slots, {part: bytes})."""
    import torch

    valid = segs < S
    U = int(torch.unique(ids.clamp(0, R - 1)[valid]).numel())
    n = int(valid.sum())
    return U, n, {"rows": U * D * esize,
                  "slots": n * (ids.element_size() + segs.element_size()
                                + w.element_size()),
                  "output": S * D * esize}


def _b1_bound(R, D, esize, ids, segs, w, S):
    """Bytes and flops the pooled lookup must move / do on these inputs
    (:func:`_b1_bytes`); a multiply and an add per valid slot and
    column."""
    U, n, parts = _b1_bytes(R, D, esize, ids, segs, w, S)
    return U, sum(parts.values()), 2 * n * D


def _bound(nbytes, flops):
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def _update_bound(D, esize, sg, optim, state_esize=4):
    """Bytes and operations a fused update must move / do on these
    inputs: each referenced gradient row once, each kept slot's id,
    flag, segment and weight once (a padding or dropped slot needs no
    read), each touched table row and its optimizer state
    (``state_esize`` bytes an element) read and written once (no weight
    without weights: the per-id segments); per kept slot a
    multiply and an add per column, per touched row
    ``UPDATE_OPS_PER_COLUMN`` per column."""
    import torch

    from torchrec_tpu_torch.ops.tbe_backward import STATE_LAYOUTS

    ok = sg.ok() & (sg.ids >= 0)
    U = int(torch.unique(sg.ids[ok]).numel())
    n_seg = int(torch.unique(sg.segments[ok]).numel())
    V = int(ok.sum())
    state_bytes = sum(state_esize * (1 if kind == "row" else D)
                      for kind in STATE_LAYOUTS[optim])
    nbytes = (n_seg * D * 4
              + V * (sg.ids.element_size() + 1 + sg.segments.element_size()
                     + (0 if sg.weights is None
                        else sg.weights.element_size()))
              + U * 2 * (D * esize + state_bytes))
    flops = 2 * V * D + UPDATE_OPS_PER_COLUMN[optim] * U * D
    return U, nbytes, flops


def _checksum(t) -> int:
    """The sum of a tensor's bit patterns as integers: changes when any
    element does (barring a cancellation), at the cost of one read.
    Summed in blocks of rows: an int64 sum casts its input whole."""
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}
    bits = t.view(ints[t.dtype])
    return sum(int(b.sum(dtype=torch.int64)) for b in bits.split(1 << 20))


class RowSnapshot:
    """The ``rows`` of each array (a stack and its optimizer states),
    saved once, so an in-place update can be undone on those rows alone
    (the 15 GB arrays are never copied whole)."""

    def __init__(self, arrays, rows):
        self.arrays, self.rows = list(arrays), rows
        self.saved = [a[rows].clone() for a in self.arrays]
        self.sums = [_checksum(a) for a in self.arrays]

    def take(self):
        """The rows as they are now, and undo the update on them."""
        now = [a[self.rows].clone() for a in self.arrays]
        self.restore()
        return now

    def restore(self):
        for a, saved in zip(self.arrays, self.saved):
            a.index_copy_(0, self.rows, saved)

    def intact(self) -> bool:
        """Every array equal to what it was when saved, by checksum: an
        update that wrote outside the saved rows shows here."""
        return [_checksum(a) for a in self.arrays] == self.sums


def _update_call(fn, stack, states, optim, sg, lr, seed, bc):
    """``fn`` (B2's wrapper or plain version) on a stack and the
    optimizer's states, with the JAX package's argument layout."""
    adam = len(states) == 2
    return fn(stack, None if adam or not states else states[0], sg.ids,
              sg.valid, sg.segments, sg.weights, sg.grad_seg, lr,
              eps=EPS, weight_decay=0.0, sr_seed=seed, optim=optim,
              states=states if adam else None, bias_corrections=bc)


def runs_slots(R, S, seed):
    """A slot stream built to hit the edges of the fused updates' grid and
    walk: one run of each of ``RUN_LENGTHS`` slots on its own random row
    (row ``R - 1`` among them), then ``RUN_PADDING`` invalid slots, all
    shuffled, with random segments in ``[0, S)`` and weights.  Returns
    host ``(ids, valid, segments, weights)``."""
    rng = np.random.RandomState(seed)
    rows = np.unique(rng.randint(0, R - 1, 4 * len(RUN_LENGTHS)))
    rows = rng.permutation(rows)[: len(RUN_LENGTHS)]
    rows[-1] = R - 1
    n_valid = sum(RUN_LENGTHS)
    n = n_valid + RUN_PADDING
    ids = np.concatenate([np.repeat(rows, RUN_LENGTHS),
                          rng.randint(0, R, RUN_PADDING)])
    perm = rng.permutation(n)
    return (ids[perm].astype(np.int32), (np.arange(n) < n_valid)[perm],
            rng.randint(0, S, n).astype(np.int32),
            rng.rand(n).astype(np.float32))


def _runs_seg_grad(dev, R, grad, seed):
    """``runs_slots`` on the card over the upstream gradient ``grad``."""
    import torch

    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad

    arrays = runs_slots(R, grad.shape[0], seed)
    return SparseSegGrad(*(torch.from_numpy(a).to(dev) for a in arrays),
                         grad)


def _launch_facts(kernel, optim, dtype, sg, R, state_dtype=None):
    """The launch's instantiation and grid on these inputs: registers,
    column layout, blocks (and resident per SM), warps, the 32-position
    windows that hold work, and the claims on the work queue (one more
    per warp, the claim that stops it); ``state_dtype`` the optimizer
    state's (float32 if None)."""
    import torch

    from torchrec_tpu_torch.ops.tbe_backward import update_launch

    D = sg.grad_seg.shape[1]
    info = update_launch(kernel, optim, dtype, D, sg.ids.numel(),
                         state_dtype=state_dtype or torch.float32)
    kept = int((sg.ok() & (sg.ids >= 0) & (sg.ids < R)).sum())
    windows = -(-kept // 32)
    warps = info["blocks"] * 8
    return {"registers": info["registers"], "layout": info["layout"],
            "grid": {"blocks": info["blocks"],
                     "blocks_per_sm": info["blocks_per_sm"], "warps": warps,
                     "windows": windows, "claims": windows + warps}}


def b2_row(flush, phase, stack, states, optim, sg, lr, seed, common):
    """B2 with ``optim`` against its plain version on the card, in place
    on ``stack`` and ``states`` and undone on the touched rows after
    every call: ``torch.equal`` on the touched rows of the stack and every
    state, nothing written elsewhere (checksums), times (the kernel also
    of the card alone), bound, registers and grid.  The plain version is
    timed by CUDA events around the one call the check makes (seconds a
    call at Zipf ids).  Returns the emitted record."""
    import torch

    from torchrec_tpu_torch.ops import tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        FusedOptimConfig,
        bias_corrections,
    )

    R, D = stack.shape
    ok = sg.ok() & (sg.ids >= 0) & (sg.ids < R)
    rows = torch.unique(sg.ids[ok]).to(torch.int64)
    snap = RowSnapshot([stack, *states], rows)
    bc = bias_corrections(FusedOptimConfig(), 1)  # the Adam family's step 1
    args = (stack, states, optim, sg, lr, seed, bc)
    _update_call(tbe_backward.fused_sparse_update, *args)
    torch.cuda.synchronize()
    got = snap.take()
    kernel_intact = snap.intact()
    p0, p1 = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    p0.record()
    _update_call(tbe_backward.fused_sparse_update_plain, *args)
    p1.record()
    torch.cuda.synchronize()
    plain_once_ms = p0.elapsed_time(p1)
    ref = snap.take()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, ref))
    equal = kernel_intact and all(torch.equal(a, b)
                                  for a, b in zip(got, ref))
    touched = int((got[0] != snap.saved[0]).any(dim=1).sum())
    sr_rows = None
    if seed is not None:
        _update_call(tbe_backward.fused_sparse_update_plain, stack, states,
                     optim, sg, lr, None, bc)
        sr_rows = int((snap.take()[0] != ref[0]).sum())
    if not equal:
        raise AssertionError(f"fused_sparse_update {optim} {common}: kernel "
                             f"!= plain (max abs err {err}, nothing "
                             f"written elsewhere: {kernel_intact})")
    if seed is not None and not sr_rows:
        raise AssertionError("bfloat16 update did not round stochastically")
    prep = tbe_backward.sort_by_row(sg.ids, sg.valid, sg.segments,
                                    sg.weights, R, sg.grad_seg.shape[0])

    def launch():
        tbe_backward.launch_fused_sparse_update(
            stack, states, *prep, sg.grad_seg, optim, lr, EPS, 0.0,
            (0.9, 0.999), bc, seed)

    state_esize = states[0].element_size() if states else 4
    U, nbytes, flops = _update_bound(D, stack.element_size(), sg, optim,
                                     state_esize)
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {
        "phase": phase, "kernel": "fused_sparse_update",
        "optim": optim, **common, "kept": int(ok.sum()), "distinct": U,
        "touched_rows": touched,
        "rows_past_2^31_bytes": int((rows * D * 4 >= FAR_BYTES).sum()),
        "sr_seed": seed, "sr_differs_from_nearest": sr_rows,
        "equal": True, "max_abs_err": err,
        **_launch_facts("fused_sparse_update", optim, stack.dtype, sg, R,
                        states[0].dtype if states else None),
        "ms": cuda_ms(lambda: _update_call(
            tbe_backward.fused_sparse_update, *args), flush,
            setup=snap.restore),
        "kernel_ms": cuda_ms(launch, flush, setup=snap.restore),
        "kernel_device_ms": cuda_ms(launch, flush, setup=snap.restore,
                                    device_only=True),
        "plain_ms": plain_once_ms,
        "library_ms": None,
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    snap.restore()
    emit(rec)
    return rec


def b1_row(flush, phase, stack, ids, segs, w, S, common, regions):
    """B1 on the card at these inputs, through both entries: the region
    entry (the main paths' call: ``regions``, no sort) and the sorted one
    (``segs``), each ``torch.equal`` to the plain version; the region
    entry checked for host syncs (``set_sync_debug_mode("error")``) and
    its peak memory held to its output plus the lengths' running ends.
    Times: each entry's wrapper, the kernel on prepared inputs (the region
    entry's ends, the sorted entry's sort; host time in, and of the card
    alone), the plain version, ``F.embedding_bag`` over the sorted valid
    slots; and the bound.  Returns the emitted record."""
    import torch
    import torch.nn.functional as F

    from torchrec_tpu_torch.ops import tbe

    R, D = stack.shape
    args = (stack, ids, segs, S, w)
    rargs = (stack, ids, regions, w)
    got = tbe.pooled_lookup_regions(*rargs)
    got_sorted = tbe.pooled_lookup(*args)
    torch.cuda.synchronize()
    ref = tbe.pooled_lookup_plain(*args)
    err = max(float((g.float() - ref.float()).abs().max())
              for g in (got, got_sorted))
    if not (torch.equal(got, ref) and torch.equal(got_sorted, ref)):
        raise AssertionError(f"pooled_lookup {common}: kernel != plain "
                             f"(max abs err {err})")
    # the region entry, cumsum and launch, must not synchronise
    torch.cuda.set_sync_debug_mode("error")
    try:
        tbe.pooled_lookup_regions(*rargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    lens = regions.lengths
    ends_bytes = -(-lens.numel() * lens.element_size() // 512) * 512
    peak, out_bytes = memory_of(lambda: tbe.pooled_lookup_regions(*rargs))
    if peak > out_bytes + ends_bytes:
        raise AssertionError(f"pooled_lookup {common}: peak {peak} bytes > "
                             f"output {out_bytes} + ends {ends_bytes}")
    ends = tbe.region_ends(lens)
    sids, sw, offs = tbe.sort_by_segment(ids, segs, w, S, R)
    n = int(offs[-1])
    lib_ids, lib_offs = sids[:n].to(torch.int64), offs.to(torch.int64)
    lib_w = sw[:n].to(stack.dtype)

    def kernel():
        return tbe.launch_pooled(stack, ids, w, ends, regions.starts,
                                 regions.caps, regions.counts)

    def sorted_kernel():
        return tbe.launch_pooled(stack, sids, sw, offs[1:], (0,),
                                 (ids.numel(),), (S,))

    def library():
        return F.embedding_bag(lib_ids, stack, lib_offs, mode="sum",
                               per_sample_weights=lib_w,
                               include_last_offset=True)

    U, nbytes, flops = _b1_bound(R, D, stack.element_size(), ids, segs, w, S)
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {
        "phase": phase, "kernel": "pooled_lookup", **common,
        "valid": n, "distinct": U, "regions": len(regions.counts),
        "equal": True, "max_abs_err": err, "wrapper_syncs": False,
        "peak_bytes": peak, "out_bytes": out_bytes,
        "ends_bytes": ends_bytes,
        "ms": cuda_ms(lambda: tbe.pooled_lookup_regions(*rargs), flush),
        "kernel_ms": cuda_ms(kernel, flush),
        "kernel_device_ms": cuda_ms(kernel, flush, device_only=True),
        "sorted_ms": cuda_ms(lambda: tbe.pooled_lookup(*args), flush),
        "sorted_kernel_ms": cuda_ms(sorted_kernel, flush),
        "sorted_kernel_device_ms": cuda_ms(sorted_kernel, flush,
                                           device_only=True),
        "plain_ms": cuda_ms(lambda: tbe.pooled_lookup_regions_plain(*rargs),
                            flush, runs=PLAIN_RUNS, warmup=1),
        "library_ms": cuda_ms(library, flush),
        "library_device_ms": cuda_ms(library, flush, device_only=True),
        "library_max_abs_diff": float(
            (library().float() - got.float()).abs().max()),
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    emit(rec)
    return rec


def b4_row(flush, phase, stack, ids, segs, w, S, common):
    """B4 against its plain version on the card at these inputs
    (``torch.equal``), its wrapper checked for host syncs
    (``set_sync_debug_mode("error")``) and its peak memory held to its
    output plus what the sized prep alone allocates, with times (the
    kernel and ``F.embedding_bag`` over the sorted valid slots also of the
    card alone) and the bound.  Returns the emitted record."""
    import torch
    import torch.nn.functional as F

    from torchrec_tpu_torch.ops import tbe

    R, D = stack.shape
    args = (stack, ids, segs, S, w)
    got = tbe.dedup_pooled_lookup(*args)
    torch.cuda.synchronize()
    ref = tbe.dedup_pooled_lookup_plain(*args)
    err = float((got.float() - ref.float()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"dedup_pooled_lookup {common}: kernel != "
                             f"plain (max abs err {err})")
    # the wrapper, prep and launch, must not synchronise with the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        tbe.dedup_pooled_lookup(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # one call allocates its output and, at most, what the sized prep
    # alone allocates: no copy of the distinct rows
    prep_peak, _ = memory_of(lambda: tbe.dedup_prepare_sized(ids, segs,
                                                             w, S))
    peak, out_bytes = memory_of(lambda: tbe.dedup_pooled_lookup(*args))
    if peak > out_bytes + prep_peak:
        raise AssertionError(f"dedup_pooled_lookup {common}: peak {peak} "
                             f"bytes > output {out_bytes} + prep "
                             f"{prep_peak}")
    prep = tbe.dedup_prepare_sized(ids, segs, w, S)
    sids, sw, offs = tbe.sort_by_segment(ids, segs, w, S, R)
    n = int(offs[-1])
    lib_ids, lib_offs = sids[:n].to(torch.int64), offs.to(torch.int64)
    lib_w = sw[:n].to(stack.dtype)

    def library():
        return F.embedding_bag(
            lib_ids, stack, lib_offs, mode="sum",
            per_sample_weights=lib_w, include_last_offset=True)

    def kernel():
        return tbe.launch_dedup_pooled(stack, *prep)

    U, n_valid, parts = _b1_bytes(R, D, stack.element_size(), ids, segs,
                                  w, S)
    nbytes, flops = sum(parts.values()), 2 * n_valid * D
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {
        "phase": phase, "kernel": "dedup_pooled_lookup",
        "bytes_by_part": parts,
        **common, "distinct": U, "peak_bytes": peak,
        "out_bytes": out_bytes, "prep_peak_bytes": prep_peak,
        "wrapper_syncs": False, "equal": True, "max_abs_err": err,
        "ms": cuda_ms(lambda: tbe.dedup_pooled_lookup(*args), flush),
        "kernel_ms": cuda_ms(kernel, flush),
        "kernel_device_ms": cuda_ms(kernel, flush, device_only=True),
        "plain_ms": cuda_ms(lambda: tbe.dedup_pooled_lookup_plain(*args),
                            flush, runs=PLAIN_RUNS, warmup=1),
        "library_ms": cuda_ms(library, flush),
        "library_device_ms": cuda_ms(library, flush, device_only=True),
        "library_max_abs_diff": float(
            (library().float() - got.float()).abs().max()),
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    emit(rec)
    return rec


def tw_b1_inputs(lay, kjt):
    """A table-wise group's lookup inputs both ways: (ids, weights,
    segments, the segment count, the slots' regions)."""
    from torchrec_tpu_torch.parallel.sharding.tw import (
        tw_regions,
        tw_segments,
        tw_slot_stream,
    )

    ids, w, lengths = tw_slot_stream(lay, kjt)
    return (ids, w, *tw_segments(lay, lengths), tw_regions(lay, lengths))


def _zipf_slots(lay, rows, seed):
    """Zipf(1.1) ids in the layout's ``[F * C]`` slot stream, each slot's
    ids drawn over its own table's rows and offset into the stack."""
    import torch

    rng = np.random.RandomState(seed)
    ids = np.stack([zipf_ids(rng, lay.cap, r) for r in rows])
    ids = ids + lay.row_offset[0][: len(rows), None]
    return torch.from_numpy(ids.reshape(-1).astype(np.int32))


def train_kernel_phase(dev, flush, dmp, state, batch):
    """B1 and B2 (rowwise Adagrad) against their plain versions on the
    card, at the shapes the training step gives them: the group's
    ``[2,600,000, 128]`` stack (the trainer's float32 one, and its
    bfloat16 cast), the slots of one bench batch (V = S = 106,496, about
    half valid), the batch's uniform ids and Zipf(1.1) ids drawn per
    feature, weight decay 0, a random ``[S, 128]`` upstream gradient;
    bfloat16 with stochastic rounding.  Returns the records it emits."""
    import torch

    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad

    (name, lay), = dmp.sharded_ebc.tw_layouts.items()
    stack32 = state["tables"][name]
    mom = state["fused"][name]["momentum"]
    ids_u, w, segs, S, regions = tw_b1_inputs(lay, batch.sparse_features)
    ids_z = _zipf_slots(lay, [TRAIN_ROWS] * TRAIN_FEATURES, seed=5).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    grad = torch.randn((S, DIM), generator=gen, device=dev) * 1e-2
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        stack = stack32 if dtype == torch.float32 else stack32.to(dtype)
        seed = SR_SEED if dtype == torch.bfloat16 else None
        for dist, ids in (("uniform", ids_u), ("zipf", ids_z)):
            common = {"dtype": str(dtype).replace("torch.", ""),
                      "ids": dist, "rows": stack.shape[0], "D": DIM,
                      "S": S, "V": ids.numel()}
            rows.append(b1_row(flush, "train_kernel", stack, ids, segs, w,
                               S, common, regions))
            sg = SparseSegGrad(ids, (segs < S) & (w != 0), segs, w, grad)
            rows.append(b2_row(flush, "train_kernel", stack, [mom],
                               "rowwise_adagrad", sg, TRAIN_LR, seed,
                               common))
        del stack
    torch.cuda.empty_cache()
    return rows


def train_path_check(dmp, state, batch, sr_seed, phase="train_path_check",
                     lr=None):
    """On one batch at full width, the step's own calls: B1's pooled
    output (the KT values) ``torch.equal`` to the plain version's, and
    B2's updated stack and optimizer state, from the step's real
    gradient, equal to the plain version's on the touched rows, with
    nothing written elsewhere (checksums; the touched rows are undone
    after each, so no stack is copied whole).  ``lr``: the fused update's
    learning rate for this step (a schedule's; the config's if None).  A stack larger than
    ``FAR_BYTES`` must be touched past them; with a bfloat16 stack and a
    seed, the stochastically rounded stack must differ from
    round-to-nearest.  The state is left as it was.  Returns the emitted
    record."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        apply_sparse_update_segments,
    )
    from torchrec_tpu_torch.parallel.sharding.tw import (
        tw_backward_local,
        tw_output_features,
    )

    ebc = dmp.sharded_ebc
    (name, lay), = ebc.tw_layouts.items()
    stack = state["tables"][name]
    fused = state["fused"][name]
    states = [fused[k] for k in ("momentum", "m", "v") if k in fused]
    kt, ctxs = dmp.sparse_forward(state, batch)
    ids, w, segs = ctxs[name][:3]
    S = lay.f_max * lay.world_size * lay.batch_size
    plain = tbe.pooled_lookup_plain(stack, ids, segs, S, w)
    kt_plain = ebc.output_kt(tw_output_features(lay, plain)).values()
    b1_err = float((kt.float() - kt_plain.float()).abs().max())
    loss, _, _, grad_by_feature = dmp.dense_forward_backward(state, batch,
                                                             kt)
    sg = tw_backward_local(lay, ctxs[name], grad_by_feature)
    cfg = dmp.fused_config
    R, D = stack.shape
    rows = torch.unique(sg.ids[sg.ok()]).to(torch.int64)
    snap = RowSnapshot([stack, *states], rows)
    apply_sparse_update_segments(stack, fused, sg, cfg, sr_seed=sr_seed,
                                 learning_rate=lr)
    torch.cuda.synchronize()
    got = snap.take()
    intact = snap.intact()

    def plain_update(seed):
        _update_call(tbe_backward.fused_sparse_update_plain, stack, states,
                     cfg.optim.value, sg,
                     cfg.learning_rate if lr is None else lr, seed,
                     (1.0, 1.0))
        return snap.take()

    ref = plain_update(sr_seed)
    far = rows * D * 4 >= FAR_BYTES  # the f32 offsets of stack and state
    rec = {
        "phase": phase, "table_dtype": str(stack.dtype),
        "batch": lay.batch_size, "stack": list(stack.shape),
        "states": [list(st.shape) for st in states],
        "slots": int(ids.numel()), "valid_slots": int(sg.ok().sum()),
        "segments": S, "distinct_rows": int(rows.numel()),
        "touched_rows": int((got[0] != snap.saved[0]).any(dim=1).sum()),
        "rows_past_2^31_bytes": int(far.sum()),
        "largest_row": int(rows.max()), "loss": float(loss),
        "b1_equal": bool(torch.equal(kt, kt_plain)), "b1_max_abs_err": b1_err,
        "b2_nothing_written_elsewhere": intact,
        "b2_table_equal": bool(torch.equal(got[0], ref[0])),
        "b2_momentum_equal": all(torch.equal(a, b)
                                 for a, b in zip(got[1:], ref[1:])),
        "b2_max_abs_err": max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, ref)),
        "sr_seed": sr_seed, "learning_rate": lr,
    }
    if sr_seed is not None:
        rec["sr_differs_from_nearest"] = int((plain_update(None)[0]
                                              != got[0]).sum())
    del got, ref, snap, kt, kt_plain, plain, sg, grad_by_feature
    emit(rec)
    if not (rec["b1_equal"] and rec["b2_table_equal"]
            and rec["b2_momentum_equal"] and intact):
        raise AssertionError(f"{phase} failed: {rec}")
    if R * D * 4 > FAR_BYTES and not rec["rows_past_2^31_bytes"]:
        raise AssertionError(f"{phase}: no touched row lies past 2^31 bytes")
    if sr_seed is not None and not rec["sr_differs_from_nearest"]:
        raise AssertionError("bfloat16 update did not round stochastically")
    return rec


def _train_steps(dmp, state, batches, n):
    """``n`` train steps cycling ``batches``, ending in a synchronise;
    returns (state, losses as floats, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(n):
        state, m = dmp.train_step(state, batches[i % len(batches)])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return state, [float(x) for x in losses], dt


def train_phase(dev, flush):
    """The training main path, float32 tables then the bfloat16 arm.
    Returns (training launches per kernel, the train_kernel records, the
    path checks)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    card = nvidia_smi_line()  # beside every training number
    t0 = time.perf_counter()
    dmp, state, batches = build_trainer(dev, torch.float32)
    torch.cuda.synchronize()
    emit({"phase": "train_setup", "table_dtype": "float32",
          "seconds": time.perf_counter() - t0,
          "stacks": {k: list(v.shape) for k, v in state["tables"].items()},
          "memory_allocated": torch.cuda.memory_allocated()})
    kernel_rows = train_kernel_phase(dev, flush, dmp, state, batches[0])
    checks = [train_path_check(dmp, state, batches[0], None)]

    # the main path: 1 warm-up step, then TRAIN_STEPS timed steps cycling
    # the batches (bench.py's timed_run)
    launches = dict.fromkeys(tbe.LAUNCHES, 0)
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    state, warm, _ = _train_steps(dmp, state, batches[:1], 1)
    state, losses, dt = _train_steps(dmp, state, batches, TRAIN_STEPS)
    counts = tbe.launch_counts()
    rec = {"phase": "train", "card": card, "table_dtype": "float32",
           "batch": TRAIN_BATCH,
           "steps": 1 + TRAIN_STEPS, "timed_steps": TRAIN_STEPS,
           "samples_per_s": TRAIN_STEPS * TRAIN_BATCH / dt,
           "ms_per_step": dt * 1e3 / TRAIN_STEPS, "losses": warm + losses,
           "all_finite": bool(np.isfinite(warm + losses).all()),
           "launches": counts,
           "peak_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(rec)
    _check_train(rec, counts, 1 + TRAIN_STEPS)
    for k, v in counts.items():
        launches[k] += v
    profile_calls({"phase": "train_profile", "card": card,
                   "table_dtype": "float32", "batch": TRAIN_BATCH},
                  lambda: dmp.train_step(state, batches[1]), 3, "step")
    del dmp, state
    torch.cuda.empty_cache()

    # the bfloat16-table arm: B1 over bfloat16 rows, B2 with stochastic
    # rounding from a per-step seed
    dmp, state, batches = build_trainer(dev, torch.bfloat16)
    checks.append(train_path_check(dmp, state, batches[0],
                                   dmp.sr_seeds(0)[0]))
    tbe.reset_launch_counts()
    state, losses, dt = _train_steps(dmp, state, batches, BF16_STEPS)
    counts = tbe.launch_counts()
    rec = {"phase": "train", "card": card, "table_dtype": "bfloat16",
           "batch": TRAIN_BATCH,
           "steps": BF16_STEPS, "samples_per_s": BF16_STEPS * TRAIN_BATCH / dt,
           "losses": losses, "all_finite": bool(np.isfinite(losses).all()),
           "sr_seeds": [dmp.sr_seeds(s)[0] for s in range(BF16_STEPS)],
           "launches": counts}
    emit(rec)
    _check_train(rec, counts, BF16_STEPS)
    for k, v in counts.items():
        launches[k] += v
    del dmp, state, batches
    torch.cuda.empty_cache()
    return launches, kernel_rows, checks


def _check_train(rec, counts, steps):
    if not rec["all_finite"]:
        raise AssertionError(f"non-finite training loss: {rec['losses']}")
    want = {"pooled_lookup": steps, "fused_sparse_update": steps}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{steps} train steps launched {got}, want "
                             f"{want}")


# ---------------------------------------------------------------------------
# phase 4: the unsharded authoring path (EmbeddingBagCollection -> DLRM ->
# DLRMTrain) at the width of bench.py main()
# ---------------------------------------------------------------------------

# the device kernel names of the pooled lookups, by wrapper
POOLED_KERNEL_NAMES = {
    "tbe_pooled_kernel": "pooled_lookup",
    "dedup_pooled_kernel": "dedup_pooled_lookup",
    "q8_pooled_kernel": "quant_pooled_lookup_int8",
    "dedup_q_pool_kernel": "dedup_quant_pooled_lookup",
}
# DLRM_Projection's two interaction branches at this width: the shape of
# the JAX package's test (``(32, 2 * D)``) at D = 128
PROJECTION_BRANCH = (512, 2 * DIM)


def pooled_launches_profiled(call):
    """The pooled-lookup kernels one ``call`` launches on the card, by
    wrapper name, read from a ``torch.profiler`` trace (not from the
    wrappers' counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for kname, wrapper in POOLED_KERNEL_NAMES.items():
            if kname in e.name:
                out[wrapper] = out.get(wrapper, 0) + 1
    return out


def ebc_forward_check(ebc, kjt, kernel, n_tables):
    """One forward of ``ebc``: its launches by the wrappers' counts and by
    the profile, each exactly ``n_tables`` of ``kernel`` and no other
    pooled kernel.  Returns (the KeyedTensor, the counts)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    with torch.no_grad():
        kt = ebc(kjt)
        tbe.reset_launch_counts()
        profiled = pooled_launches_profiled(lambda: ebc(kjt))
        counts = {k: v for k, v in tbe.launch_counts().items() if v}
    want = {kernel: n_tables}
    if counts != want or profiled != want:
        raise AssertionError(f"EBC forward ({kernel}) launched {counts}, "
                             f"profiled {profiled}; want {want}")
    return kt, counts


def ebc_grads(ebc, kjt, weights, g):
    """The table and per-id weight gradients of ``sum(ebc(kjt) * g)``,
    the KJT carrying ``weights``."""
    import torch

    w = weights.detach().requires_grad_()
    with torch.enable_grad():
        kt = ebc(kjt.with_values(kjt.values(), w))
        params = list(ebc.parameters())
        grads = torch.autograd.grad((kt.values() * g).sum(), params + [w])
    return grads


def ebc_phase(dev, flush):
    """The unsharded authoring path on the card.  Returns (the main run's
    launches, its kernel records, its check record)."""
    import torch

    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.models.dlrm import (
        DLRM,
        DLRM_DCN,
        DLRM_Projection,
        DLRMTrain,
    )
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
        EmbeddingConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
        EmbeddingCollection,
        key_regions,
    )
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    card = nvidia_smi_line()
    t0 = time.perf_counter()
    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    F = len(keys)
    tables = tuple(
        EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k in keys)
    ds = RandomRecDataset(keys, TRAIN_BATCH, [TRAIN_ROWS] * F, [1] * F,
                          num_dense=NUM_DENSE, manual_seed=0)
    it = iter(ds)
    batches = [next(it).to(dev) for _ in range(TRAIN_BATCHES)]
    batch, kjt = batches[0], batches[0].sparse_features
    ebc = EmbeddingBagCollection(
        tables, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    torch.manual_seed(0)
    model = DLRM(ebc, NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                 dense_dtype=torch.bfloat16).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the kernels against their plain versions at the path's shapes: the
    # first table's lookup (one feature, V = S = 4096)
    ids, _, regions, _ = key_regions(kjt, [0])
    segs = regions.segment_ids(ids.numel())
    w = torch.ones(ids.shape, dtype=torch.float32, device=dev)
    table0 = getattr(ebc, tables[0].name).detach()
    S = regions.num_segments
    common = {"dtype": "float32", "ids": "ebc", "rows": TRAIN_ROWS, "D": DIM,
              "S": S, "V": ids.numel()}
    rows = [b1_row(flush, "ebc_kernel", table0, ids, segs, w, S, common,
                   regions),
            b4_row(flush, "ebc_kernel", table0, ids, segs, w, S, common)]

    # each forward: 26 launches of its kernel, none of another
    kt, tbe_counts = ebc_forward_check(ebc, kjt, "pooled_lookup", F)
    ebc_dedup = EmbeddingBagCollection(tables, device="meta",
                                       kernel="dedup")
    ebc_dedup.load_state_dict(ebc.state_dict(), assign=True)
    kt_dedup, dedup_counts = ebc_forward_check(ebc_dedup, kjt,
                                               "dedup_pooled_lookup", F)
    dedup_equal = bool(torch.equal(kt_dedup.values(), kt.values()))

    # sharded = unsharded: the one-device DMP's stack filled from the
    # EBC's own weights
    dmp = DistributedModelParallel(
        DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH), tables,
        table_wise_plan(tables), TRAIN_BATCH, dict(zip(keys, ds.caps)),
        device=dev)
    state = dmp.init(torch.Generator(device=dev).manual_seed(1))
    dmp.load_table_weights(state, {c.name: getattr(ebc, c.name).detach()
                                   for c in tables})
    with torch.no_grad():
        sharded, _ = dmp.sparse_forward(state, batch)
    sharded_equal = bool(torch.equal(sharded, kt.values())
                         and dmp.sharded_ebc.feature_order == kt.keys())
    sharded_err = float((sharded - kt.values()).abs().max())
    del dmp, state, sharded

    # the backward, twice on one batch: table and weight gradients equal
    gen = torch.Generator(device=dev).manual_seed(5)
    wts = torch.rand(kjt.values().shape, generator=gen, device=dev)
    g = torch.randn(kt.values().shape, generator=gen, device=dev)
    ebc_w = EmbeddingBagCollection(tables, is_weighted=True, device="meta")
    ebc_w.load_state_dict(ebc.state_dict(), assign=True)
    first = ebc_grads(ebc_w, kjt, wts, g)
    second = ebc_grads(ebc_w, kjt, wts, g)
    bwd_equal = all(torch.equal(a, b) for a, b in zip(first, second))
    del first, second, ebc_w

    # the sequence collection over the same rows: a row gather
    ec = EmbeddingCollection(
        [EmbeddingConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                         name=c.name, feature_names=c.feature_names)
         for c in tables], device="meta")
    ec.load_state_dict(ebc.state_dict(), assign=True)
    with torch.no_grad():
        seq = ec(kjt)
        ec_equal = True
        for c in tables:
            jt = kjt[c.feature_names[0]]
            want = getattr(ebc, c.name)[jt.values()]
            want[~jt.valid_mask()] = 0
            ec_equal &= bool(torch.equal(seq[c.feature_names[0]].values(),
                                         want))
    del seq, ec

    # DLRM_DCN and DLRM_Projection through the same collection
    with torch.no_grad():
        dcn = DLRM_DCN(ebc, NUM_DENSE, DENSE_ARCH, OVER_ARCH, DCN_LAYERS,
                       DCN_RANK, dense_dtype=torch.bfloat16).to(dev)
        proj = DLRM_Projection(ebc, NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                               PROJECTION_BRANCH, PROJECTION_BRANCH,
                               dense_dtype=torch.bfloat16).to(dev)
        other = {type(m).__name__: m(batch.dense_features, kjt)
                 for m in (dcn, proj)}
    others_finite = {k: bool(torch.isfinite(v).all()) and
                     tuple(v.shape) == (TRAIN_BATCH, 1)
                     for k, v in other.items()}
    del dcn, proj, other

    check = {
        "phase": "ebc_check", "card": card, "batch": TRAIN_BATCH,
        "tables": F, "rows": TRAIN_ROWS, "D": DIM,
        "setup_seconds": setup_s,
        "forward_launches": {"tbe": tbe_counts, "dedup": dedup_counts},
        "sharded_equal": sharded_equal, "sharded_max_abs_err": sharded_err,
        "dedup_equal": dedup_equal, "backward_deterministic": bwd_equal,
        "ec_equal": ec_equal, "others_finite": others_finite,
    }
    emit(check)
    if not (sharded_equal and dedup_equal and bwd_equal and ec_equal
            and all(others_finite.values())):
        raise AssertionError(f"ebc check failed: {check}")

    # the main path: DLRMTrain with autograd and the port's dense Adagrad
    # over every parameter, 1 warm-up and TRAIN_STEPS timed steps
    train = DLRMTrain(model)
    params = dict(model.named_parameters())
    tx = adagrad(TRAIN_LR)
    opt = tx.init(params)
    seen = torch.unique(torch.cat([
        b.sparse_features[keys[0]].values()[
            b.sparse_features[keys[0]].valid_mask()] for b in batches]))
    t0_rows = getattr(ebc, tables[0].name)
    looked = batches[0].sparse_features[keys[0]]
    looked = torch.unique(looked.values()[looked.valid_mask()])
    unseen = torch.ones(TRAIN_ROWS, dtype=torch.bool, device=dev)
    unseen[seen] = False
    before_looked = t0_rows[looked].detach().clone()
    before_unseen = _checksum(t0_rows.detach()[unseen])

    def step(b):
        loss, (loss_d, _, _) = train(b)
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.update(params, dict(zip(params, grads)), opt)
        return loss_d

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    warm = [step(batches[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(batches[i % len(batches)]) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = tbe.launch_counts()
    losses = [float(x) for x in warm + losses]
    changed = (t0_rows[looked].detach() != before_looked).any(dim=1)
    rec = {"phase": "ebc", "card": card, "batch": TRAIN_BATCH,
           "steps": 1 + TRAIN_STEPS, "timed_steps": TRAIN_STEPS,
           "samples_per_s": TRAIN_STEPS * TRAIN_BATCH / dt,
           "ms_per_step": dt * 1e3 / TRAIN_STEPS, "losses": losses,
           "all_finite": bool(np.isfinite(losses).all()),
           "launches": counts,
           "looked_up_rows": int(looked.numel()),
           "looked_up_rows_changed": int(changed.sum()),
           "unseen_rows_unchanged": _checksum(t0_rows.detach()[unseen])
           == before_unseen,
           "peak_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(rec)
    want = {"pooled_lookup": F * (1 + TRAIN_STEPS)}
    got = {k: v for k, v in counts.items() if v}
    if not rec["all_finite"] or got != want:
        raise AssertionError(f"ebc steps: losses {losses}, launches {got}, "
                             f"want {want}")
    if not (rec["looked_up_rows_changed"] == rec["looked_up_rows"]
            and rec["unseen_rows_unchanged"]):
        raise AssertionError(f"ebc steps: the table rows moved wrongly: "
                             f"{rec}")
    profile_calls({"phase": "ebc_profile", "card": card,
                   "batch": TRAIN_BATCH},
                  lambda: step(batches[1]), 3, "step")
    launches = dict.fromkeys(tbe.LAUNCHES, 0)
    launches.update(counts)
    # the dedup arm's forward is a main path of B4 (one forward, F launches)
    launches["dedup_pooled_lookup"] += dedup_counts["dedup_pooled_lookup"]
    del train, model, ebc, ebc_dedup, params, opt, batches
    torch.cuda.empty_cache()
    return launches, rows, check


# ---------------------------------------------------------------------------
# phase 5: the bucketed training pipeline on the dedup kernels
# ---------------------------------------------------------------------------


def dedup_batches():
    """The first ``TRAIN_BATCHES`` batches of the dedup stream, on the
    host (the pipeline repacks and copies them per step)."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    F = len(keys)
    ds = RandomRecDataset(
        keys, TRAIN_BATCH, [TRAIN_ROWS] * F, [DEDUP_MAX_IDS] * F,
        num_dense=NUM_DENSE, manual_seed=0, min_ids_per_features=[1] * F,
        zipf_lengths=DEDUP_ZIPF_LENGTHS, zipf_ids=DEDUP_ZIPF_IDS)
    it = iter(ds)
    return keys, ds.caps, [next(it) for _ in range(TRAIN_BATCHES)]


def build_dedup_trainer(dev, keys, caps, optim, table_dtype):
    """``DistributedModelParallel`` of ``build_trainer`` at the dedup
    stream's caps, on the dedup kernels, with fused optimizer ``optim``
    (lr 0.05, the JAX defaults otherwise), and its state."""
    import torch

    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    tables = tuple(
        EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k in keys)
    model = DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                 dense_dtype=torch.bfloat16)
    dmp = DistributedModelParallel(
        model, tables, table_wise_plan(tables), TRAIN_BATCH,
        dict(zip(keys, caps)),
        fused_config=FusedOptimConfig(optim=EmbOptimType(optim),
                                      learning_rate=TRAIN_LR),
        dense_optimizer=adagrad(TRAIN_LR), table_dtype=table_dtype,
        device=dev, lookup_kernel="dedup", update_kernel="dedup",
    )
    return dmp, dmp.init(torch.Generator(device=dev).manual_seed(0))


def _bucketing_config():
    from torchrec_tpu_torch.parallel.train_pipeline import BucketingConfig

    return BucketingConfig(**BUCKETING,
                           kernels={"pooled": "dedup", "update": "dedup"})


def bucketed_batch(dmp, batch, dev):
    """The batch repacked to its bucketed signature, on the card, and the
    clone of ``dmp`` for that signature (what the pipeline runs)."""
    import dataclasses

    kjt = batch.sparse_features
    sig = kjt.bucketed_caps(BUCKETING["floor"], BUCKETING["growth"])
    clone = dmp.with_feature_caps(dict(zip(kjt.keys(), sig)))
    return (dataclasses.replace(batch, sparse_features=kjt.repad(sig))
            .to(dev), clone, sig)


def _clone_state(state):
    """A deep copy of a train state (tensors cloned on their device)."""
    import torch

    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    return state.clone() if isinstance(state, torch.Tensor) else state


def _state_equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return a == b


def dedup_kernel_phase(dev, flush, dmp, state, batch):
    """B4 and B6 against their plain versions on the card at the bucketed
    path's shapes: the ``[2,600,000, 128]`` stack and the first bucketed
    batch of the dedup stream (its real ids, segments and weights).  B4
    over the float32 stack and its bfloat16 cast, each with B1 on the same
    slots (one function, two designs, timed on one batch), B4's wrapper
    checked for host syncs (``set_sync_debug_mode("error")``) and its peak
    memory held to its output plus what the sized prep alone allocates;
    B6 for each of its eight optimizers on float32 and rowwise Adagrad on
    bfloat16 with stochastic rounding, each on fresh copies of the stack
    and of random states, with a random ``[S, 128]`` upstream gradient;
    then B6's runs arm (rowwise Adagrad over ``runs_slots``).  Times by
    ``cuda_ms`` (the kernels also of the card alone); the plain versions
    over ``PLAIN_RUNS`` runs.  Returns the records."""
    import torch

    from torchrec_tpu_torch.ops import tbe_backward
    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad

    bb, clone, sig = bucketed_batch(dmp, batch, dev)
    (name, lay), = clone.sharded_ebc.tw_layouts.items()
    stack32 = state["tables"][name]
    R, D = stack32.shape
    ids, w, segs, S, regions = tw_b1_inputs(lay, bb.sparse_features)
    valid = (segs < S) & (w != 0)
    common = {"rows": R, "D": D, "S": S, "V": ids.numel(),
              "valid": int(valid.sum()), "signature_slots": sum(sig)}
    gen = torch.Generator(device=dev).manual_seed(11)
    grad = torch.randn((S, D), generator=gen, device=dev) * 1e-2
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        stack = stack32 if dtype == torch.float32 else stack32.to(dtype)
        dname = str(dtype).replace("torch.", "")
        rows.append(b4_row(flush, "dedup_kernel", stack, ids, segs, w, S,
                           {"dtype": dname, **common}))
        rows.append(b1_row(flush, "dedup_kernel", stack, ids, segs, w, S,
                           {"dtype": dname, "ids": "bucketed", **common},
                           regions))
        del stack

    sg = SparseSegGrad(ids, valid, segs, w, grad)
    arms = [(o, torch.float32, None) for o in tbe_backward.OPTIMIZERS]
    arms.append(("rowwise_adagrad", torch.bfloat16, SR_SEED))
    for optim, dtype, seed in arms:
        stack = stack32 if dtype == torch.float32 else stack32.to(dtype)
        rows.append(b6_row(flush, stack, optim, sg, seed, gen, common))
        del stack
    # the runs arm: runs of 1 to 10,000 slots, then the sentinel
    rsg = _runs_seg_grad(dev, R, grad, seed=13)
    rows.append(b6_row(flush, stack32, "rowwise_adagrad", rsg, None, gen,
                       {"rows": R, "D": D, "S": S, "V": rsg.ids.numel(),
                        "valid": int(rsg.valid.sum()), "ids": "runs"}))
    torch.cuda.empty_cache()
    return rows


def b6_row(flush, stack, optim, sg, seed, gen, common, phase="dedup_kernel",
           lr=TRAIN_LR):
    """B6 with ``optim`` against its plain version on the card, each on
    its own copy of ``stack`` and of random states: ``torch.equal`` on the
    whole stack and every state, times (the kernel also of the card
    alone), bound, registers and grid, emitted as ``phase`` at the fused
    lr ``lr``.  The plain version is timed by CUDA events around the one
    call the check makes (seconds a call at Zipf ids).  Returns the
    emitted record."""
    import torch

    from torchrec_tpu_torch.ops import tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        FusedOptimConfig,
        bias_corrections,
    )

    R, D = stack.shape
    states = [
        torch.rand((R,) if kind == "row" else (R, D), generator=gen,
                   device=stack.device) * 1e-2
        for kind in tbe_backward.STATE_LAYOUTS[optim]]
    # the Adam family's first step (the others ignore the corrections)
    kw = {"eps": EPS, "weight_decay": 0.0,
          "bias_corrections": bias_corrections(FusedOptimConfig(), 1),
          "sr_seed": seed}
    upd = (sg.ids, sg.valid, sg.segments, sg.weights, sg.grad_seg, optim,
           lr)
    tk, sk = stack.clone(), [s.clone() for s in states]
    tbe_backward.dedup_fused_sparse_update(tk, sk, *upd, **kw)
    torch.cuda.synchronize()
    tp, sp = stack.clone(), [s.clone() for s in states]
    p0, p1 = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    p0.record()
    tbe_backward.dedup_fused_sparse_update_plain(tp, sp, *upd, **kw)
    p1.record()
    p1.synchronize()
    plain_once_ms = p0.elapsed_time(p1)
    err = max([float((tk.float() - tp.float()).abs().max())]
              + [float((a - b).abs().max()) for a, b in zip(sk, sp)])
    equal = bool(torch.equal(tk, tp)) and all(
        torch.equal(a, b) for a, b in zip(sk, sp))
    touched = int((tk != stack).any(dim=1).sum())
    sr_rows = None
    if seed is not None:
        rn = stack.clone()
        tbe_backward.dedup_fused_sparse_update_plain(
            rn, [s.clone() for s in states], *upd, **{**kw, "sr_seed": None})
        sr_rows = int((rn != tk).sum())
        del rn
    del tp, sp
    if not equal:
        raise AssertionError(f"dedup_fused_sparse_update {optim} "
                             f"{stack.dtype} {common}: kernel != plain "
                             f"(max abs err {err})")
    if seed is not None and not sr_rows:
        raise AssertionError("bfloat16 update did not round stochastically")

    def restore():  # the timed calls update tk and sk in place
        tk.copy_(stack)
        for a, b in zip(sk, states):
            a.copy_(b)

    srt = tbe_backward.sort_by_row(sg.ids, sg.valid, sg.segments, sg.weights,
                                   R, sg.grad_seg.shape[0])

    def launch():
        tbe_backward.launch_dedup_fused_sparse_update(
            tk, sk, *srt, sg.grad_seg, optim, lr, EPS, 0.0,
            (0.9, 0.999), kw["bias_corrections"], seed)

    U, nbytes, flops = _update_bound(D, stack.element_size(), sg, optim)
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {
        "phase": phase, "kernel": "dedup_fused_sparse_update",
        "optim": optim, "dtype": str(stack.dtype).replace("torch.", ""),
        **common, "kept": int(sg.ok().sum()), "distinct": U,
        "touched_rows": touched, "sr_seed": seed,
        "sr_differs_from_nearest": sr_rows, "equal": True,
        "max_abs_err": err,
        **_launch_facts("dedup_fused_sparse_update", optim, stack.dtype, sg,
                        R),
        "ms": cuda_ms(lambda: tbe_backward.dedup_fused_sparse_update(
            tk, sk, *upd, **kw), flush, setup=restore),
        "kernel_ms": cuda_ms(launch, flush, setup=restore),
        "kernel_device_ms": cuda_ms(launch, flush, setup=restore,
                                    device_only=True),
        "plain_ms": plain_once_ms,
        "library_ms": None,
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    emit(rec)
    return rec


def dedup_path_check(dmp, state, batch, dev):
    """On the first batch at full width, the three checks of the dedup
    path: (1) B4's pooled output (the KT values of the bucketed step)
    ``torch.equal`` to B1's on the same slots; (2) B6's updated stack and
    momentum from the step's real gradient equal to its plain version's;
    (3) the state after one step at the bucketed signature equal to the
    state after the same step at the full-caps signature.  The state is
    left as it was.  Returns the emitted record."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        apply_sparse_update_segments,
    )
    from torchrec_tpu_torch.parallel.sharding.tw import (
        tw_backward_local,
        tw_output_features,
    )

    bb, clone, sig = bucketed_batch(dmp, batch, dev)
    ebc = clone.sharded_ebc
    (name, lay), = ebc.tw_layouts.items()
    stack = state["tables"][name]
    mom = state["fused"][name]["momentum"]
    kt, ctxs = clone.sparse_forward(state, bb)
    ids, w, segs = ctxs[name][:3]
    S = lay.f_max * lay.world_size * lay.batch_size
    b1 = tbe.pooled_lookup(stack, ids, segs, S, w)
    kt_b1 = ebc.output_kt(tw_output_features(lay, b1)).values()
    loss, _, _, grad_by_feature = clone.dense_forward_backward(state, bb, kt)
    sg = tw_backward_local(lay, ctxs[name], grad_by_feature)
    cfg = clone.fused_config
    tk, mk = stack.clone(), mom.clone()
    apply_sparse_update_segments(tk, {"momentum": mk}, sg, cfg,
                                 update_kernel="dedup")
    torch.cuda.synchronize()
    tp, mp = stack.clone(), mom.clone()
    tbe_backward.dedup_fused_sparse_update_plain(
        tp, (mp,), sg.ids, sg.valid, sg.segments, sg.weights, sg.grad_seg,
        cfg.optim.value, cfg.learning_rate, cfg.eps, cfg.weight_decay)
    rec = {
        "phase": "dedup_path_check", "batch": lay.batch_size,
        "stack": list(stack.shape), "signature_slots": sum(sig),
        "full_slots": sum(dmp.feature_caps.values()),
        "valid_slots": int(sg.ok().sum()),
        "touched_rows": int((tk != stack).any(dim=1).sum()),
        "loss": float(loss),
        "b4_equals_b1": bool(torch.equal(kt, kt_b1)),
        "b4_max_abs_err": float((kt - kt_b1).abs().max()),
        "b6_table_equal": bool(torch.equal(tk, tp)),
        "b6_momentum_equal": bool(torch.equal(mk, mp)),
        "b6_max_abs_err": max(float((tk - tp).abs().max()),
                              float((mk - mp).abs().max())),
    }
    del tk, mk, tp, mp, kt, kt_b1, b1, sg, grad_by_feature
    bucketed = _clone_state(state)
    _, mb = clone.train_step(bucketed, bb)
    full = _clone_state(state)
    _, mf = dmp.train_step(full, batch.to(dev))
    rec["bucketed_equals_full_caps"] = bool(
        _state_equal(bucketed, full) and torch.equal(mb["loss"], mf["loss"]))
    del bucketed, full
    torch.cuda.empty_cache()
    emit(rec)
    if not (rec["b4_equals_b1"] and rec["b6_table_equal"]
            and rec["b6_momentum_equal"]
            and rec["bucketed_equals_full_caps"]):
        raise AssertionError(f"dedup path check failed: {rec}")
    return rec


def _pipeline_steps(pipe, it, n):
    """``n`` pipeline steps ending in a synchronise; returns (losses as
    floats, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [pipe.progress(it)["loss"] for _ in range(n)]
    torch.cuda.synchronize()
    return [float(x) for x in losses], time.perf_counter() - t0


def _check_dedup(rec, counts, steps):
    if not rec["all_finite"]:
        raise AssertionError(f"non-finite training loss: {rec['losses']}")
    want = {"dedup_pooled_lookup": steps, "dedup_fused_sparse_update": steps}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{steps} dedup steps launched {got}, want "
                             f"{want}")


def train_dedup_phase(dev, flush):
    """The bucketed training pipeline on the dedup kernels: the kernels
    at the path's shapes, the path checks, 1 warm-up and 20 timed
    rowwise-Adagrad steps over 4 cycled batches, three profiled steps,
    then 3 steps of each other optimizer and 3 steps of the bfloat16-table
    arm.  Returns (the main run's launches, the dedup_kernel records, the
    path check)."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.parallel.train_pipeline import (
        BucketedTrainPipeline,
    )

    card = nvidia_smi_line()
    t0 = time.perf_counter()
    keys, caps, batches = dedup_batches()
    occ = [b.sparse_features.occupancy_per_key() for b in batches]
    dmp, state = build_dedup_trainer(dev, keys, caps, "rowwise_adagrad",
                                     torch.float32)
    torch.cuda.synchronize()
    emit({"phase": "train_dedup_setup", "seconds": time.perf_counter() - t0,
          "full_caps_slots": sum(caps), "ids_per_batch": [sum(o) for o in occ],
          "max_ids_per_feature": max(max(o) for o in occ),
          "stacks": {k: list(v.shape) for k, v in state["tables"].items()},
          "memory_allocated": torch.cuda.memory_allocated()})
    kernel_rows = dedup_kernel_phase(dev, flush, dmp, state, batches[0])
    check = dedup_path_check(dmp, state, batches[0], dev)

    # the main path: 1 warm-up and TRAIN_STEPS timed steps, then the
    # profiled steps (1 + 3 + 3 calls), from one finite stream
    n_main = 1 + TRAIN_STEPS
    stream = iter([batches[i % len(batches)] for i in range(n_main + 7)])
    pipe = BucketedTrainPipeline(dmp, state, _bucketing_config())
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    warm, _ = _pipeline_steps(pipe, stream, 1)
    losses, dt = _pipeline_steps(pipe, stream, TRAIN_STEPS)
    counts = tbe.launch_counts()
    stats = pipe.stats
    rec = {"phase": "train_dedup", "card": card, "optim": "rowwise_adagrad",
           "table_dtype": "float32", "batch": TRAIN_BATCH, "steps": n_main,
           "timed_steps": TRAIN_STEPS,
           "samples_per_s": TRAIN_STEPS * TRAIN_BATCH / dt,
           "ms_per_step": dt * 1e3 / TRAIN_STEPS, "losses": warm + losses,
           "all_finite": bool(np.isfinite(warm + losses).all()),
           "launches": counts,
           "signatures": {str(sum(s)): n
                          for s, n in stats.dispatch_counts.items()},
           "padding": stats.scalar_metrics(),
           "peak_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(rec)
    _check_dedup(rec, counts, n_main)
    main_counts = counts
    profile_calls({"phase": "train_dedup_profile", "card": card,
                   "batch": TRAIN_BATCH}, lambda: pipe.progress(stream), 3,
                  "step")
    del pipe, dmp, state
    torch.cuda.empty_cache()

    # 3 steps for each other optimizer, then the bfloat16-table arm
    arms = [(o, torch.float32) for o in tbe_backward.OPTIMIZERS
            if o != "rowwise_adagrad"]
    arms.append(("rowwise_adagrad", torch.bfloat16))
    for optim, dtype in arms:
        dmp, state = build_dedup_trainer(dev, keys, caps, optim, dtype)
        pipe = BucketedTrainPipeline(dmp, state, _bucketing_config())
        tbe.reset_launch_counts()
        losses, dt = _pipeline_steps(pipe, iter(batches[:ARM_STEPS]),
                                     ARM_STEPS)
        counts = tbe.launch_counts()
        rec = {"phase": "train_dedup_arm", "optim": optim,
               "table_dtype": str(dtype).replace("torch.", ""),
               "steps": ARM_STEPS,
               "samples_per_s": ARM_STEPS * TRAIN_BATCH / dt,
               "losses": losses, "all_finite": bool(np.isfinite(losses).all()),
               "launches": counts,
               "fused_step": next(iter(pipe.state["fused"].values()))
               .get("step")}
        emit(rec)
        _check_dedup(rec, counts, ARM_STEPS)
        del pipe, dmp, state
        torch.cuda.empty_cache()
    return main_counts, kernel_rows, check


# ---------------------------------------------------------------------------
# phase: guardrails, the dedup'd row-wise dist and the semi-sync pipeline
# ---------------------------------------------------------------------------

GUARDED_BUDGET_S = 90
GUARDED_STEPS = 11  # pipeline steps a run: 1 warm-up and 10 timed
GUARDED_FACTOR = 8.0  # the undersized arm's dedup_factor
# injected ids by key (one table-wise, one dedup'd row-wise feature)
GUARDED_INJECT = {"cat_3": (TRAIN_ROWS, -1, TRAIN_ROWS + 7),
                  "cat_20": (-5, 2 * TRAIN_ROWS)}


def build_guarded(dev, keys, caps, guardrails=None, factor=1.0,
                  tw_only=False):
    """``build_dedup_trainer``'s model and stream caps on the plan of the
    guarded phase: the first half of the tables table-wise, the rest
    row-wise with ``dedup`` (``dedup_factor`` ``factor``), or every table
    table-wise; one rank, the dedup kernels, ``guardrails`` on the DMP.
    Returns the DMP and its state (the same tables for every plan)."""
    import torch

    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
    from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType as ST,
    )

    tables = tuple(
        EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k in keys)
    half = len(tables) // 2
    plan = {t.name: (ParameterSharding(ST.TABLE_WISE, ranks=[0])
                     if tw_only or i < half else
                     ParameterSharding(ST.ROW_WISE, ranks=[0], dedup=True,
                                       dedup_factor=factor))
            for i, t in enumerate(tables)}
    model = DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                 dense_dtype=torch.bfloat16)
    dmp = DistributedModelParallel(
        model, tables, plan, TRAIN_BATCH, dict(zip(keys, caps)),
        fused_config=FusedOptimConfig(learning_rate=TRAIN_LR),
        dense_optimizer=adagrad(TRAIN_LR), device=dev,
        lookup_kernel="dedup", update_kernel="dedup", guardrails=guardrails)
    return dmp, dmp.init(torch.Generator(device=dev).manual_seed(0))


def _poisoned(batch, inject):
    """``batch`` with the first real ids of each key of ``inject``
    replaced by its ids."""
    import dataclasses

    import torch

    kjt = batch.sparse_features
    values = kjt.values().clone()
    for key, ids in inject.items():
        start = kjt.cap_offsets()[kjt.keys().index(key)]
        values[start:start + len(ids)] = torch.tensor(ids,
                                                      dtype=values.dtype)
    return dataclasses.replace(batch, sparse_features=kjt.with_values(values))


def _b6_call(fn, stack, states, sg, lr, optim="rowwise_adagrad"):
    """``fn`` (B6's wrapper or plain version) on a stack and its states,
    in place, round to nearest."""
    return fn(stack, states, sg.ids, sg.valid, sg.segments, sg.weights,
              sg.grad_seg, optim, lr, EPS, 0.0, (0.9, 0.999), (1.0, 1.0),
              None)


def _touched_masks(dmp, batch):
    """{group: bool [stack rows] on the card}: the rows the batch's valid
    ids read (host arithmetic from the batch's ids)."""
    import torch

    ebc = dmp.sharded_ebc
    kjt = batch.sparse_features
    lens, values = kjt.lengths().cpu().numpy(), kjt.values().cpu().numpy()
    B = kjt.stride()
    masks = {name: np.zeros(ebc.local_rows(name), bool)
             for name in ebc.group_names}
    for f, key in enumerate(kjt.keys()):
        start = kjt.cap_offsets()[f]
        ids = values[start:start + int(lens[f * B:(f + 1) * B].sum())]
        ids = ids[(ids >= 0) & (ids < TRAIN_ROWS)]
        group, rows, _ = ebc.stack_rows_for_table(f"t_{key}", ids)
        masks[group][rows] = True
    return {n: torch.from_numpy(m).to(dmp.device) for n, m in masks.items()}


def guarded_kernel_check(dmp, state, batch, flush):
    """The kernels of the guarded path at its shapes (the first batch's
    bucketed signature): B1 over the dedup'd group's returned rows (the
    source pooling), B4 over the table-wise group's slots, and B6 on each
    group's gradient of that step, each ``torch.equal`` to its plain
    version; their card-alone times and bounds.  Returns the records."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.ops.embedding_ops import (
        sequence_embedding_lookup,
    )
    from torchrec_tpu_torch.parallel.sharding.rw import _source_regions

    dev_batch, clone, sig = bucketed_batch(dmp, batch, dmp.device)
    ebc = clone.sharded_ebc
    with torch.no_grad():
        kt, ctxs = clone.sparse_forward(state, dev_batch)
    _, _, _, grads = clone.dense_forward_backward(state, dev_batch, kt)
    sgs = ebc.backward_local(ctxs, grads, clone.env)
    kjt = dev_batch.sparse_features
    recs = []
    for kind, name, lay in ebc.sharded_groups():
        stack = state["tables"][name]
        R, D = stack.shape
        if kind == "rw":  # the source pooling over the returned rows
            ids_recv, valid_recv, sidx, _, w, _ = ctxs[name]
            rows = sequence_embedding_lookup(stack, ids_recv.reshape(-1),
                                             valid_recv.reshape(-1))
            table = torch.cat([rows, rows.new_zeros((1, D))])
            regions = _source_regions(lay, kjt)
            segs = regions.segment_ids(sidx.shape[0])

            def lookup():
                return tbe.pooled_lookup_regions(table, sidx, regions, w)

            ref = tbe.pooled_lookup_regions_plain(table, sidx, regions, w)
            lk, ids, S = "pooled_lookup", sidx, regions.num_segments
        else:  # B4 over the table-wise group's slots
            ids, w, segs, regions = ctxs[name]
            S, table = regions.num_segments, stack

            def lookup():
                return tbe.dedup_pooled_lookup(table, ids, segs, S, w)

            ref = tbe.dedup_pooled_lookup_plain(table, ids, segs, S, w)
            lk = "dedup_pooled_lookup"
        got = lookup()
        sorted_eq = None
        if kind == "rw":  # the backward's sum by send slot (sorted entry)
            g_cat = torch.cat([grads[f.name].float() for f in lay.features])
            seg_g, sent = ctxs[name][3], ctxs[name][0].numel()
            sorted_eq = bool(torch.equal(
                tbe.pooled_lookup(g_cat, seg_g, sidx, sent, w),
                tbe.pooled_lookup_plain(g_cat, seg_g, sidx, sent, w)))
            del g_cat
        sg = sgs[name]
        mom = state["fused"][name]["momentum"]
        outs = []
        for fn in (tbe_backward.dedup_fused_sparse_update,
                   tbe_backward.dedup_fused_sparse_update_plain):
            t, m = stack.clone(), mom.clone()
            _b6_call(fn, t, [m], sg, TRAIN_LR)
            outs.append((t, m))
        torch.cuda.synchronize()
        look_eq = bool(torch.equal(got, ref))
        b6_eq = all(torch.equal(a, b) for a, b in zip(*outs))
        rec = {"phase": "guarded_kernel", "group": name, "kind": kind,
               "signature_slots": sum(sig), "stack": [R, D],
               "lookup": lk, "lookup_table_rows": int(table.shape[0]),
               "slots": int(ids.numel()), "segments": S,
               "update_valid_slots": int(sg.ok().sum()),
               f"{lk}_equal": look_eq, "b6_equal": b6_eq,
               f"{lk}_max_abs_err": float((got.float() - ref.float())
                                          .abs().max()),
               "b6_max_abs_err": max(float((a - b).abs().max())
                                     for a, b in zip(*outs))}
        if sorted_eq is not None:
            rec["gradient_sum_b1_sorted_equal"] = sorted_eq
        del outs, ref
        if not (look_eq and b6_eq and sorted_eq is not False):
            raise AssertionError(f"guarded kernel check failed: {rec}")
        tk, mk = stack.clone(), mom.clone()

        def restore():
            tk.copy_(stack)
            mk.copy_(mom)

        def b6():
            _b6_call(tbe_backward.dedup_fused_sparse_update, tk, [mk], sg,
                     TRAIN_LR)

        rec[f"{lk}_device_ms"] = cuda_ms(lookup, flush, device_only=True)
        rec["b6_device_ms"] = cuda_ms(b6, flush, setup=restore,
                                      device_only=True)
        _, nbytes, flops = _b1_bound(table.shape[0], D, table.element_size(),
                                     ids, segs, w, S)
        rec[f"{lk}_bound_ms"] = _bound(nbytes, flops)[0]
        _, nbytes, flops = _update_bound(D, stack.element_size(), sg,
                                         "rowwise_adagrad")
        rec["b6_bound_ms"] = _bound(nbytes, flops)[0]
        emit(rec)
        del tk, mk, got, table
        recs.append(rec)
    return recs


def _device_kernel_names(call, window=None):
    """The names of the device events of one ``call``, by a profile.  The
    window closes on a marker kernel launched after the call has
    synchronized, so that the call's last kernels are never the window's
    last records.  ``window``, a dict, gets the window's event count and
    its last names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
        marker.add_(1.0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if window is not None:
        window.update(device_events=len(names),
                      last=[n[:60] for n in names[-6:]])
    return names


def _update_kernels_profiled(call):
    """The pooled and fused-update kernels one ``call`` launches, by a
    profile: pooled kernels by wrapper, B2 and B6 told apart by the
    update kernel's ``PER_ID`` template argument (true for B2)."""
    out, names = {}, set()
    for name in _device_kernel_names(call):
        for kname, wrapper in POOLED_KERNEL_NAMES.items():
            if kname in name:
                out[wrapper] = out.get(wrapper, 0) + 1
        if UPDATE_KERNEL_NAME in name:
            names.add(name.split("(")[0])
            per_id = "true>" in name.split("(")[0]
            k = "fused_sparse_update" if per_id else \
                "dedup_fused_sparse_update"
            out[k] = out.get(k, 0) + 1
    return out, sorted(names)


def guarded_phase(dev, flush):
    """Guardrails over the dedup'd row-wise dist through the bucketed
    semi-sync pipeline at ``bench.py main()``'s width on ``dedup_batches``'
    stream: 13 tables table-wise and 13 row-wise with ``dedup`` at one
    rank, the dedup kernels (B4, B6; B1 pools the dedup'd group at the
    source), ``GuardrailsConfig(SANITIZE)`` on the DMP and a
    ``GuardedIterator`` in front.  Hard checks: the kernels at the path's
    shapes; the dedup'd group's KT = the table-wise plan's; guarded =
    unguarded (losses, tables); semi-sync = the hand-ordered split steps
    and != the synchronous bucketed run; the launch counts and a profile
    (B1, B4 and B6, nothing else); a poisoned batch (``id_violations`` per
    key, untouched rows unchanged, finite loss, the host tier's SANITIZE
    and QUARANTINE); ``dedup_factor`` 8 downgrades at least once and
    factor 1 never drops; ``invalidate_prefetch`` = a fresh pipeline;
    ``EvalPipelineSparseDist`` = ``make_forward``.  Returns (the main
    run's launches, the kernel records)."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel import train_pipeline as tp
    from torchrec_tpu_torch.robustness import (
        GuardedIterator,
        GuardrailPolicy,
        GuardrailsConfig,
        InputGuardrails,
    )

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    stages = {}

    def lap(name, t0):
        stages[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    keys, caps, batches = dedup_batches()
    n = GUARDED_STEPS
    cycle = [batches[i % len(batches)] for i in range(n)]
    cfg = GuardrailsConfig(policy=GuardrailPolicy.SANITIZE)
    rows = {k: TRAIN_ROWS for k in keys}
    dmp_g, st_g = build_guarded(dev, keys, caps, cfg)
    # check 3: the dedup'd group's pooled output = the table-wise plan's
    tw, st_tw = build_guarded(dev, keys, caps, tw_only=True)
    with torch.no_grad():
        kt_g, _ = dmp_g.sparse_forward(st_g, batches[0].to(dev))
        kt_tw, _ = tw.sparse_forward(st_tw, batches[0].to(dev))
    kt_equal = bool(torch.equal(kt_g, kt_tw))
    if not kt_equal:
        raise AssertionError("guarded: the dedup'd group's KT != the "
                             "table-wise plan's")
    del tw, st_tw, kt_g, kt_tw
    t0 = lap("setup_and_kt_check_s", t0)
    kchecks = guarded_kernel_check(dmp_g, st_g, batches[0], flush)
    t0 = lap("kernel_checks_s", t0)

    def run(pipe, it, steps):
        """``steps`` progress calls: (the loss tensors, the last metrics,
        seconds of the timed ones after the first)."""
        torch.cuda.synchronize()
        ms = [pipe.progress(it)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        ms += [pipe.progress(it) for _ in range(steps - 1)]
        torch.cuda.synchronize()
        return [m["loss"] for m in ms], ms[-1], time.perf_counter() - t

    # the main path: the guarded semi-sync pipeline behind GuardedIterator
    # (its stream runs on into the profiled steps: 1 + 7 calls, and a
    # pending batch)
    host = InputGuardrails(cfg, rows)
    stream = GuardedIterator(
        iter([batches[i % len(batches)] for i in range(n + 9)]), host)
    pipe_g = tp.BucketedTrainPipelineSemiSync(dmp_g, st_g,
                                              _bucketing_config())
    tbe.reset_launch_counts()
    loss_g, m_g, dt_g = run(pipe_g, stream, n)
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    # n updates; n + 1 embeddings (the next batch's rides ahead); B1 pools
    # the dedup'd group at the source in each embedding and sums its
    # gradients by send slot in each update
    want = {"pooled_lookup": 2 * n + 1, "dedup_pooled_lookup": n + 1,
            "dedup_fused_sparse_update": 2 * n}
    if counts != want:
        raise AssertionError(f"guarded: {n} steps launched {counts}, want "
                             f"{want}")
    if (m_g["id_violations"].any() or int(m_g["dedup_overflow"])
            or host.sanitized_batches):
        raise AssertionError(f"guarded: a clean stream flagged: "
                             f"{m_g['id_violations']}, "
                             f"{m_g['dedup_overflow']}, "
                             f"{host.scalar_metrics()}")
    t0 = lap("guarded_run_s", t0)

    # check 1: unguarded on the same clean stream, the same numbers
    dmp_u, st_u = build_guarded(dev, keys, caps)
    pipe_u = tp.BucketedTrainPipelineSemiSync(dmp_u, st_u,
                                              _bucketing_config())
    loss_u, m_u, dt_u = run(pipe_u, iter(cycle), n)
    guarded_equal = (all(torch.equal(a, b) for a, b in zip(loss_g, loss_u))
                     and _state_equal(pipe_g.state, pipe_u.state))
    if not guarded_equal:
        raise AssertionError("guarded: guarded != unguarded on clean batches")
    t0 = lap("unguarded_run_s", t0)

    profiled, update_names = _update_kernels_profiled(
        lambda: pipe_g.progress(stream))
    if profiled != {"pooled_lookup": 2, "dedup_pooled_lookup": 1,
                    "dedup_fused_sparse_update": 2}:
        raise AssertionError(f"guarded: a profiled step launched {profiled} "
                             f"({update_names})")
    prof = profile_calls({"phase": "guarded_profile", "card": card,
                          "batch": TRAIN_BATCH},
                         lambda: pipe_g.progress(stream), 3, "step")
    # the sanitizer alone on the card
    from torchrec_tpu_torch.robustness.sanitize import sanitize_kjt

    kjt_dev = batches[0].sparse_features.to(dev)
    sanitize_ms = cuda_ms(lambda: sanitize_kjt(kjt_dev, rows), flush,
                          device_only=True)
    t0 = lap("profile_s", t0)

    # check 2: the hand-ordered split steps, and the synchronous pipeline
    dmp_h, st_h = build_guarded(dev, keys, caps)
    cache = tp.BucketedStepCache(dmp_h, _bucketing_config())
    prepared = []
    for b in cycle:
        (rb,), sig = tp._bucketize_locals(cache, [b])
        prepared.append((rb.to(dev), sig))
    pending = cache.embed_program(prepared[0][1])(st_h["tables"],
                                                  prepared[0][0])
    for i, (b, sig) in enumerate(prepared):
        nxt = (cache.embed_program(prepared[i + 1][1])(
            st_h["tables"], prepared[i + 1][0]) if i + 1 < n else None)
        st_h, _ = cache.dense_program(sig)(st_h, b, *pending)
        pending = nxt
    hand_equal = _state_equal(st_h, pipe_u.state)
    del dmp_h, st_h, cache, prepared, pending
    dmp_s, st_s = build_guarded(dev, keys, caps)
    pipe_s = tp.BucketedTrainPipeline(dmp_s, st_s, _bucketing_config())
    loss_s, _, dt_s = run(pipe_s, iter(cycle), n)
    stale = not _state_equal(pipe_s.state["tables"], pipe_u.state["tables"])
    if not (hand_equal and stale):
        raise AssertionError(f"guarded: semi-sync = hand-ordered "
                             f"{hand_equal}, differs from sync {stale}")
    del pipe_s, dmp_s, st_s
    t0 = lap("hand_and_sync_runs_s", t0)

    # check 6: invalidate_prefetch after a rollback = a fresh pipeline
    dmp_i, st_i = build_guarded(dev, keys, caps)
    pipe_a = tp.BucketedTrainPipelineSemiSync(dmp_i, st_i,
                                              _bucketing_config())
    it_a = iter(cycle[:5])
    pipe_a.progress(it_a)
    saved = _clone_state(pipe_a.state)
    pipe_a.progress(it_a)
    pipe_a.state = _clone_state(saved)
    pipe_a.invalidate_prefetch()
    pipe_b = tp.BucketedTrainPipelineSemiSync(dmp_i, saved,
                                              _bucketing_config())
    it_b = iter(cycle[2:5])
    replay_equal = all(
        torch.equal(pipe_a.progress(it_a)["loss"],
                    pipe_b.progress(it_b)["loss"]) for _ in range(2))
    replay_equal = replay_equal and _state_equal(pipe_a.state, pipe_b.state)
    if not replay_equal:
        raise AssertionError("guarded: invalidate_prefetch != a fresh "
                             "pipeline from the restored state")
    del pipe_a, pipe_b, saved, st_i
    t0 = lap("invalidate_prefetch_s", t0)

    # check 7: the eval pipeline = make_forward, the state unchanged
    state = pipe_u.state
    before = _clone_state(state["tables"])
    fwd = dmp_u.make_forward()
    ev = tp.EvalPipelineSparseDist(
        lambda s, b: fwd(s["dense"], s["tables"], b), state, device=dev)
    it_e = iter(batches[:2])
    eval_equal = all(
        torch.equal(ev.progress(it_e),
                    fwd(state["dense"], state["tables"], b.to(dev)))
        for b in batches[:2])
    eval_equal = eval_equal and _state_equal(state["tables"], before)
    if not eval_equal:
        raise AssertionError("guarded: eval pipeline != make_forward, or "
                             "the tables moved")
    del before, ev
    t0 = lap("eval_s", t0)

    # check 4: a poisoned batch through the guarded step and the host tier
    poisoned = _poisoned(batches[1], GUARDED_INJECT)
    st = pipe_g.state
    before = _clone_state(st["tables"])
    masks = _touched_masks(dmp_g, poisoned)
    st, m = dmp_g.train_step(st, poisoned.to(dev))
    viol = dict(zip(dmp_g.sharded_ebc.feature_order,
                    m["id_violations"].tolist()))
    want_viol = {k: len(GUARDED_INJECT.get(k, ())) for k in keys}
    untouched_equal = all(
        torch.equal(before[g][~masks[g]], st["tables"][g][~masks[g]])
        for g in masks)
    loss_finite = bool(torch.isfinite(m["loss"]))
    sanitize_host = InputGuardrails(cfg, rows)
    repaired = sanitize_host.apply(poisoned)
    with tempfile.TemporaryDirectory() as qdir:
        q = InputGuardrails(GuardrailsConfig(
            policy=GuardrailPolicy.QUARANTINE, quarantine_dir=qdir), rows)
        kept = list(GuardedIterator(iter([poisoned, batches[2]]), q))
        quarantine = {"entries": len(q.quarantine),
                      "kept": len(kept), "skipped": q.quarantined_batches}
    poison = {"id_violations": {k: v for k, v in viol.items() if v},
              "injected": {k: v for k, v in want_viol.items() if v},
              "untouched_rows_equal": untouched_equal,
              "loss_finite": loss_finite,
              "host_sanitize": sanitize_host.scalar_metrics(),
              "host_repaired_clean": sanitize_host.diagnose(repaired) is None,
              "quarantine": quarantine}
    if not (viol == want_viol and untouched_equal and loss_finite
            and sanitize_host.sanitized_batches == 1
            and poison["host_repaired_clean"]
            and quarantine == {"entries": 1, "kept": 1, "skipped": 1}):
        raise AssertionError(f"guarded: poisoned batch checks {poison}")
    del before, masks
    t0 = lap("poison_s", t0)

    # check 5: an undersized distinct-id capacity downgrades
    dmp_8, st_8 = build_guarded(dev, keys, caps, factor=GUARDED_FACTOR)
    pipe_8 = tp.BucketedTrainPipeline(dmp_8, st_8, _bucketing_config())
    _, m_8, _ = run(pipe_8, iter(cycle[:4]), 4)
    downgrades = pipe_8.stats.overflow_fallback_count
    padding_8 = pipe_8.stats.scalar_metrics()
    if downgrades < 1 or int(m_u["dedup_overflow"]):
        raise AssertionError(f"guarded: factor {GUARDED_FACTOR} downgraded "
                             f"{downgrades} times; dedup_overflow at factor "
                             f"1 {int(m_u['dedup_overflow'])}")
    del pipe_8, dmp_8, st_8
    t0 = lap("undersized_s", t0)

    losses = [float(x) for x in loss_g]
    seconds = time.perf_counter() - t_phase
    rec = {"phase": "guarded", "card": card, "batch": TRAIN_BATCH,
           "plan": {"table_wise": len(keys) // 2,
                    "row_wise_dedup": len(keys) - len(keys) // 2},
           "steps": n, "launches": counts,
           "profiled_launches_one_step": profiled,
           "update_kernel_names": update_names,
           "guarded_semi_sync": {"ms_per_step": dt_g * 1e3 / (n - 1),
                                 "samples_per_s": (n - 1) * TRAIN_BATCH
                                 / dt_g},
           "unguarded_semi_sync": {"ms_per_step": dt_u * 1e3 / (n - 1),
                                   "samples_per_s": (n - 1) * TRAIN_BATCH
                                   / dt_u},
           "sync_bucketed": {"ms_per_step": dt_s * 1e3 / (n - 1),
                             "samples_per_s": (n - 1) * TRAIN_BATCH / dt_s},
           "sanitize_device_ms": sanitize_ms,
           "device_idle_share": prof["device_idle_share_of_unprofiled_wall"],
           "losses": losses, "all_finite": bool(np.isfinite(losses).all()),
           "sync_losses": [float(x) for x in loss_s],
           "kt_equal_table_wise": kt_equal,
           "guarded_equal_unguarded": guarded_equal,
           "semi_sync_equal_hand_ordered": hand_equal,
           "semi_sync_differs_from_sync": stale,
           "invalidate_prefetch_equal_fresh": replay_equal,
           "eval_equal_make_forward": eval_equal, "poisoned": poison,
           "undersized": {"dedup_factor": GUARDED_FACTOR,
                          "overflow_fallback_count": downgrades,
                          "dedup_overflow_last_step":
                              int(m_8["dedup_overflow"]),
                          "padding": padding_8},
           "dedup_overflow_factor_1": int(m_u["dedup_overflow"]),
           "peak_memory_allocated": torch.cuda.max_memory_allocated(),
           "stage_seconds": stages, "seconds": seconds,
           "budget_s": GUARDED_BUDGET_S}
    emit(rec)
    if not rec["all_finite"]:
        raise AssertionError(f"guarded: losses {losses}")
    del pipe_g, pipe_u, dmp_g, dmp_u, st, st_g, st_u, state
    torch.cuda.empty_cache()
    registry_check(dev)
    return counts, kchecks


REGISTRY_BUDGET_S = 10


def registry_check(dev):
    """The kernel registry at ``bench.py main()``'s width (26 tables
    table-wise, B=4096, one id a feature): a DMP built with no kernel
    arguments under ``trace_kernels(pooled="pallas_dedup",
    update="pallas_dedup")`` takes B4 and B6, and a step launches them and
    nothing else (counts and a profile), its KT ``torch.equal`` to an
    explicit ``lookup_kernel="dedup"`` DMP's; under the default registry
    a DMP takes B1 and B2, and a step launches them and nothing else.
    Returns the emitted record."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.ops.embedding_ops import trace_kernels
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    t0 = time.perf_counter()
    caps, host = one_id_batches(1)
    batch = host[0].to(dev)
    _, tables = bench_tables()
    plan = table_wise_plan(tables)
    with trace_kernels(pooled="pallas_dedup", update="pallas_dedup"):
        reg, state = sharded_dmp(dev, plan, TRAIN_BATCH, caps)
    explicit, _ = sharded_dmp(dev, plan, TRAIN_BATCH, caps,
                              lookup_kernel="dedup", update_kernel="dedup")
    default, st_d = sharded_dmp(dev, plan, TRAIN_BATCH, caps)
    with torch.no_grad():
        kt_equal = bool(torch.equal(reg.sparse_forward(state, batch)[0],
                                    explicit.sparse_forward(state,
                                                            batch)[0]))
    runs = {}
    for name, dmp, st in (("registry", reg, state), ("default", default,
                                                     st_d)):
        torch.cuda.synchronize()
        tbe.reset_launch_counts()
        dmp.train_step(st, batch)
        torch.cuda.synchronize()
        counts = {k: v for k, v in tbe.launch_counts().items() if v}
        profiled, _ = _update_kernels_profiled(
            lambda: dmp.train_step(st, batch))
        runs[name] = {"kernels": [dmp.lookup_kernel, dmp.update_kernel],
                      "launches": counts, "profiled": profiled}
    want = {"registry": {"dedup_pooled_lookup": 1,
                         "dedup_fused_sparse_update": 1},
            "default": {"pooled_lookup": 1, "fused_sparse_update": 1}}
    rec = {"phase": "registry", "kt_equal_explicit_dedup": kt_equal,
           **runs, "seconds": time.perf_counter() - t0,
           "budget_s": REGISTRY_BUDGET_S}
    emit(rec)
    for name, w in want.items():
        if runs[name]["launches"] != w or runs[name]["profiled"] != w:
            raise AssertionError(f"registry {name}: {runs[name]}, want {w}")
    if not kt_equal:
        raise AssertionError("registry: the registry DMP's KT != the "
                             "explicit dedup DMP's")
    del reg, explicit, default, state, st_d
    torch.cuda.empty_cache()
    return rec


def quant_registry_check(tables, params, batch):
    """A ``QuantEmbeddingBagCollection`` built under the quant registry's
    ``"pallas_dedup"`` looks up through B5 alone (one grouped launch a
    batch), its KT ``torch.equal`` to an explicit ``"dedup"``
    collection's; one built under the default registry through B3.
    Returns the emitted record."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.ops.embedding_ops import trace_kernels
    from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection

    t0 = time.perf_counter()
    with trace_kernels(quant="pallas_dedup"):
        reg = QuantEmbeddingBagCollection(tables, params)
    explicit = QuantEmbeddingBagCollection(tables, params, "dedup")
    default = QuantEmbeddingBagCollection(tables, params)
    out = {}
    for name, qebc in (("registry", reg), ("default", default)):
        torch.cuda.synchronize()
        tbe.reset_launch_counts()
        kt = qebc(batch.sparse_features)
        torch.cuda.synchronize()
        out[name] = ({k: v for k, v in tbe.launch_counts().items() if v},
                     kt.values())
    kt_equal = bool(torch.equal(out["registry"][1],
                                explicit(batch.sparse_features).values()))
    rec = {"phase": "quant_registry", "kt_equal_explicit_dedup": kt_equal,
           "registry_launches": out["registry"][0],
           "default_launches": out["default"][0],
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if (set(out["registry"][0]) != {"dedup_quant_pooled_lookup"}
            or set(out["default"][0]) != {"quant_pooled_lookup_int8"}
            or not kt_equal):
        raise AssertionError(f"quant registry: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 6: MLPerf DLRM-v2 (DLRM_DCN) training on the per-id kernels
# ---------------------------------------------------------------------------


def dcn_batches(row_cap):
    """The MLPerf DLRM-v2 tables' row counts capped at ``row_cap``, their
    feature caps, and the first ``TRAIN_BATCHES`` batches of the fixed
    multi-hot stream over them, on the host."""
    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        MLPERF_DLRM_V2_ROWS,
    )
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    keys = list(DEFAULT_CAT_NAMES)
    rows = [min(r, row_cap) for r in MLPERF_DLRM_V2_ROWS]
    hot = list(MLPERF_DLRM_V2_MULTI_HOT)
    ds = RandomRecDataset(keys, DCN_BATCH, rows, hot, num_dense=NUM_DENSE,
                          manual_seed=0, min_ids_per_features=hot)
    it = iter(ds)
    return keys, rows, ds.caps, [next(it) for _ in range(TRAIN_BATCHES)]


def build_dcn_trainer(dev, keys, rows, caps, optim, table_dtype,
                      momentum_dtype=None, update_kernel="tbe",
                      stochastic_rounding=True):
    """``DistributedModelParallel`` of ``DLRM_DCN`` at the recipe's widths
    over tables of ``rows``, on the per-id lookup and ``update_kernel``,
    with fused optimizer ``optim`` (lr 0.004, eps 1e-8, the JAX defaults
    otherwise; its state in ``momentum_dtype``, float32 if None), and its
    state from a seeded generator on the card."""
    import torch

    from torchrec_tpu_torch.models.dlrm import DLRM_DCN
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    tables = tuple(
        EmbeddingBagConfig(num_embeddings=r, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k, r in zip(keys, rows))
    torch.manual_seed(0)  # the module's own init; dmp.init draws the state
    model = DLRM_DCN(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                     DCN_LAYERS, DCN_RANK, dense_dtype=torch.bfloat16)
    dmp = DistributedModelParallel(
        model, tables, table_wise_plan(tables), DCN_BATCH,
        dict(zip(keys, caps)),
        fused_config=FusedOptimConfig(
            optim=EmbOptimType(optim), learning_rate=DCN_LR, eps=EPS,
            momentum_dtype=momentum_dtype or torch.float32,
            stochastic_rounding=stochastic_rounding),
        dense_optimizer=adagrad(DCN_LR), table_dtype=table_dtype,
        device=dev, lookup_kernel="tbe", update_kernel=update_kernel,
    )
    return dmp, dmp.init(torch.Generator(device=dev).manual_seed(0))


def dcn_crossnet(flush, dmp, card):
    """The cross net's forward and backward alone at the path's shape
    (``[8192, 3456]`` float32, rank 512, 3 layers): time by CUDA events
    against the float32 operations bound, and the names of the GEMM
    kernels it launches (which mark it in the step's profile)."""
    import torch

    net = dmp.model.inter_arch.crossnet
    width = net.w_0.shape[0]
    gen = torch.Generator(device=dmp.device).manual_seed(3)
    x = torch.randn((DCN_BATCH, width), generator=gen, device=dmp.device)
    x.requires_grad_()

    def fwd_bwd():
        net(x).sum().backward()

    # per layer: forward 2 products of 2*B*d*r flops, backward 4
    flops = DCN_LAYERS * 12 * DCN_BATCH * width * DCN_RANK
    ms = cuda_ms(fwd_bwd, flush, runs=10)
    prof = profile_calls({"phase": "dcn_crossnet_profile", "card": card,
                          "batch": DCN_BATCH}, fwd_bwd, 3, "call")
    gemms = {n for n in prof["device_names"] if "gemm" in n.lower()}
    rec = {"phase": "dcn_crossnet", "card": card, "batch": DCN_BATCH,
           "width": width, "rank": DCN_RANK, "layers": DCN_LAYERS,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "ms_fwd_bwd": ms, "flops": flops,
           "bound_ms": flops / PEAK_F32_FLOPS * 1e3,
           "tflops_per_s": flops / ms / 1e9, "gemm_kernels": sorted(gemms)}
    emit(rec)
    net.zero_grad(set_to_none=True)
    return rec


def train_dcn_phase(dev, flush):
    """MLPerf DLRM-v2 training on the per-id kernels: the kernels at the
    path's shapes, the path check, 1 warm-up and 20 timed per-element
    Adagrad steps over 4 cycled batches, the cross net alone, three
    profiled steps; then at the 1,000,000-row cap B2's other optimizers
    and bfloat16 rows, and 3 steps of each other optimizer and of the
    bfloat16-table arm.  Returns (the main run's launches, the dcn_kernel
    records, the path check)."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad

    card = nvidia_smi_line()
    t0 = time.perf_counter()
    keys, rows, caps, host = dcn_batches(DCN_ROW_CAP)
    dmp, state = build_dcn_trainer(dev, keys, rows, caps, "adagrad",
                                   torch.float32)
    batches = [b.to(dev) for b in host]
    del host
    torch.cuda.synchronize()
    (name, lay), = dmp.sharded_ebc.tw_layouts.items()
    stack = state["tables"][name]
    mom = state["fused"][name]["momentum"]
    emit({"phase": "train_dcn_setup", "seconds": time.perf_counter() - t0,
          "stacks": {k: list(v.shape) for k, v in state["tables"].items()},
          "momentum": list(mom.shape), "slot_cap": lay.cap,
          "ids_per_batch": int(batches[0].sparse_features.lengths().sum()),
          "memory_allocated": torch.cuda.memory_allocated()})

    # B1 and B2 (Adagrad) at the path's shapes: the batch's ids, Zipf ids
    ids_u, w, segs, S, regions = tw_b1_inputs(lay,
                                              batches[0].sparse_features)
    ids_z = _zipf_slots(lay, rows, seed=5).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    grad = torch.randn((S, DIM), generator=gen, device=dev) * 1e-2
    kernel_rows = []
    for dist, ids in (("uniform", ids_u), ("zipf", ids_z)):
        common = {"dtype": "float32", "ids": dist, "rows": stack.shape[0],
                  "D": DIM, "S": S, "V": ids.numel()}
        kernel_rows.append(b1_row(flush, "dcn_kernel", stack, ids, segs, w,
                                  S, common, regions))
        sg = SparseSegGrad(ids, (segs < S) & (w != 0), segs, w, grad)
        kernel_rows.append(b2_row(flush, "dcn_kernel", stack, [mom],
                                  "adagrad", sg, DCN_LR, None, common))
    # the runs arm: runs of 1 to 10,000 slots, then the sentinel
    sg = _runs_seg_grad(dev, stack.shape[0], grad, seed=17)
    kernel_rows.append(b2_row(
        flush, "dcn_kernel", stack, [mom], "adagrad", sg, DCN_LR, None,
        {"dtype": "float32", "ids": "runs", "rows": stack.shape[0], "D": DIM,
         "S": S, "V": sg.ids.numel()}))
    del ids_z, grad, sg
    check = train_path_check(dmp, state, batches[0], None, "dcn_path_check")

    # the main path: 1 warm-up step, then TRAIN_STEPS timed steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    state, warm, _ = _train_steps(dmp, state, batches[:1], 1)
    state, losses, dt = _train_steps(dmp, state, batches, TRAIN_STEPS)
    counts = tbe.launch_counts()
    rec = {"phase": "train_dcn", "card": card, "optim": "adagrad",
           "table_dtype": "float32", "batch": DCN_BATCH,
           "steps": 1 + TRAIN_STEPS, "timed_steps": TRAIN_STEPS,
           "samples_per_s": TRAIN_STEPS * DCN_BATCH / dt,
           "ms_per_step": dt * 1e3 / TRAIN_STEPS, "losses": warm + losses,
           "all_finite": bool(np.isfinite(warm + losses).all()),
           "launches": counts,
           "peak_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(rec)
    _check_train(rec, counts, 1 + TRAIN_STEPS)
    DCN_MAIN_RUN.update(rec)  # lowp_state's float32-state reference
    main_counts = counts
    cross = dcn_crossnet(flush, dmp, card)
    profile_calls({"phase": "train_dcn_profile", "card": card,
                   "batch": DCN_BATCH, "marked": "cross-net GEMMs"},
                  lambda: dmp.train_step(state, batches[1]), 3, "step",
                  marked=set(cross["gemm_kernels"]))
    del dmp, state, stack, mom, batches, ids_u, w, segs, regions
    torch.cuda.empty_cache()

    # at the 1,000,000-row cap: B2's other optimizers on float32 and all
    # eight on bfloat16 with stochastic rounding, on the first batch's
    # slots, random states and a random gradient
    keys, rows, caps, host = dcn_batches(DCN_ARM_ROW_CAP)
    batches = [b.to(dev) for b in host]
    dmp, state = build_dcn_trainer(dev, keys, rows, caps, "sgd",
                                   torch.float32)
    (name, lay), = dmp.sharded_ebc.tw_layouts.items()
    stack32 = state["tables"][name]
    ids, w, segs, S, _ = tw_b1_inputs(lay, batches[0].sparse_features)
    grad = torch.randn((S, DIM), generator=gen, device=dev) * 1e-2
    sg = SparseSegGrad(ids, (segs < S) & (w != 0), segs, w, grad)
    arms = [(o, torch.float32, None) for o in tbe_backward.OPTIMIZERS
            if o != "adagrad"]
    arms += [(o, torch.bfloat16, SR_SEED) for o in tbe_backward.OPTIMIZERS]
    R = stack32.shape[0]
    for optim, dtype, seed in arms:
        st = stack32 if dtype == torch.float32 else stack32.to(dtype)
        states = [
            torch.rand((R,) if kind == "row" else (R, DIM), generator=gen,
                       device=dev) * 1e-2
            for kind in tbe_backward.STATE_LAYOUTS[optim]]
        common = {"dtype": str(dtype).replace("torch.", ""), "ids": "uniform",
                  "rows": R, "D": DIM, "S": S, "V": ids.numel()}
        kernel_rows.append(b2_row(flush, "dcn_kernel", st, states, optim, sg,
                                  DCN_LR, seed, common))
        del st, states
    del dmp, state, stack32, sg, grad, ids, w, segs
    torch.cuda.empty_cache()

    # 3 steps of each other optimizer, then the bfloat16-table arm
    arms = [(o, torch.float32) for o in tbe_backward.OPTIMIZERS
            if o != "adagrad"]
    arms.append(("adagrad", torch.bfloat16))
    for optim, dtype in arms:
        dmp, state = build_dcn_trainer(dev, keys, rows, caps, optim, dtype)
        tbe.reset_launch_counts()
        state, losses, dt = _train_steps(dmp, state, batches, ARM_STEPS)
        counts = tbe.launch_counts()
        rec = {"phase": "train_dcn_arm", "optim": optim,
               "table_dtype": str(dtype).replace("torch.", ""),
               "rows": sum(rows), "steps": ARM_STEPS,
               "samples_per_s": ARM_STEPS * DCN_BATCH / dt,
               "losses": losses, "all_finite": bool(np.isfinite(losses).all()),
               "launches": counts,
               "fused_step": next(iter(state["fused"].values())).get("step")}
        emit(rec)
        _check_train(rec, counts, ARM_STEPS)
        del dmp, state
        torch.cuda.empty_cache()
    return main_counts, kernel_rows, check


# ---------------------------------------------------------------------------
# phase lowp_state: train_dcn with a bfloat16 optimizer state, and every
# stateful optimizer's B2 and B6 over 16-bit states, and the
# stochastic-rounding switch
# ---------------------------------------------------------------------------

LOWP_BUDGET_S = 90
LOWP_STEPS = 10  # timed, after one warm-up step
LOWP_OPTIMIZERS = ("rowwise_adagrad", "adagrad", "adam",
                   "partial_rowwise_adam", "lamb", "partial_rowwise_lamb")
LOWP_SR_STEPS = 2  # steps of each stochastic-rounding arm
# train_dcn's main record (ms a step, peak memory), the lowp_state
# phase's float32-state reference; empty in a development run
DCN_MAIN_RUN: dict = {}


def _lowp_arm_row(flush, kernel, stack, states, optim, sg, seed, common):
    """B2 (``kernel="fused_sparse_update"``) or B6 over ``states`` (a
    16-bit state) against its plain version, in place and undone on the
    touched rows: ``torch.equal`` on the stack and every state, nothing
    written elsewhere (checksums), the state's dtype kept, and the card
    time of one call.  Returns the emitted record."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        FusedOptimConfig,
        bias_corrections,
    )

    R, D = stack.shape
    ok = sg.ok() & (sg.ids >= 0) & (sg.ids < R)
    rows = torch.unique(sg.ids[ok]).to(torch.int64)
    snap = RowSnapshot([stack, *states], rows)
    bc = bias_corrections(FusedOptimConfig(), 1)

    def call(plain):
        if kernel == "fused_sparse_update":
            fn = (tbe_backward.fused_sparse_update_plain if plain
                  else tbe_backward.fused_sparse_update)
            _update_call(fn, stack, states, optim, sg, DCN_LR, seed, bc)
        else:
            fn = (tbe_backward.dedup_fused_sparse_update_plain if plain
                  else tbe_backward.dedup_fused_sparse_update)
            fn(stack, states, sg.ids, sg.valid, sg.segments, sg.weights,
               sg.grad_seg, optim, DCN_LR, eps=EPS, bias_corrections=bc,
               sr_seed=seed)

    before = tbe.launch_counts()[kernel]
    call(False)
    torch.cuda.synchronize()
    launched = tbe.launch_counts()[kernel] - before
    got = snap.take()
    intact = snap.intact()
    call(True)
    ref = snap.take()
    equal = intact and launched == 1 and all(
        torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, ref))
    rec = {"phase": "lowp_kernel", "kernel": kernel, "optim": optim,
           **common, "state_dtype": str(states[0].dtype).replace(
               "torch.", ""), "kept": int(ok.sum()),
           "distinct": int(rows.numel()), "sr_seed": seed,
           "equal": equal, "max_abs_err": err,
           "kernel_device_ms": cuda_ms(lambda: call(False), flush, runs=5,
                                       warmup=1, setup=snap.restore,
                                       device_only=True),
           **_launch_facts(kernel, optim, stack.dtype, sg, R,
                           states[0].dtype)}
    snap.restore()
    emit(rec)
    if not equal or states[0].dtype == torch.float32:
        raise AssertionError(f"lowp_state {kernel} {optim}: kernel != plain "
                             f"or the state changed dtype: {rec}")
    return rec


def lowp_state_phase(dev, flush):
    """``train_dcn``'s configuration (MLPerf DLRM-v2 ``DLRM_DCN``,
    per-element Adagrad lr 0.004 over the ``[29,184,588, 128]`` stack,
    B=8192) with a bfloat16 optimizer state: the path check (B1 and B2
    ``torch.equal`` to their plain versions on the step's own gradient,
    the bfloat16 momentum included), B2 at the path's shapes on
    ``train_dcn``'s own stream and gradient (its times beside that phase's
    float32-state row), 1 warm-up and ``LOWP_STEPS`` timed steps with one
    B1 and one B2 a step and no other kernel (counts and a profile), the state still bfloat16, ms a step and peak memory beside
    ``train_dcn``'s float32-state run.  Then at the 1,000,000-row cap: B2
    and B6 for every stateful optimizer over bfloat16 and float16 states
    against their plain versions; and on bfloat16 tables with stochastic
    rounding off, B2 and B6 equal to their plain versions with no seed,
    and ``LOWP_SR_STEPS`` steps each of the switch off and on through each
    kernel, whose tables differ.  Returns (the main run's launches, the
    records)."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad
    from torchrec_tpu_torch.ops.tbe_backward import STATE_LAYOUTS

    card = nvidia_smi_line()
    t0 = time.perf_counter()
    keys, rows, caps, host = dcn_batches(DCN_ROW_CAP)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dmp, state = build_dcn_trainer(dev, keys, rows, caps, "adagrad",
                                   torch.float32,
                                   momentum_dtype=torch.bfloat16)
    batches = [b.to(dev) for b in host]
    del host
    (name, lay), = dmp.sharded_ebc.tw_layouts.items()
    mom = state["fused"][name]["momentum"]
    setup = {"seconds": time.perf_counter() - t0,
             "momentum": [list(mom.shape), str(mom.dtype)],
             "momentum_bytes": mom.numel() * mom.element_size()}
    check = train_path_check(dmp, state, batches[0], None, "lowp_path_check")
    # B2 at the path's shapes on train_dcn's own stream and gradient (its
    # dcn_kernel uniform row: the same batch, the same seeded gradient),
    # the bf16 momentum in place of the f32 one
    ids, w, segs, S, _ = tw_b1_inputs(lay, batches[0].sparse_features)
    gen = torch.Generator(device=dev).manual_seed(7)
    grad = torch.randn((S, DIM), generator=gen, device=dev) * 1e-2
    path_b2 = b2_row(
        flush, "lowp_kernel", state["tables"][name], [mom], "adagrad",
        SparseSegGrad(ids, (segs < S) & (w != 0), segs, w, grad), DCN_LR,
        None, {"dtype": "float32", "state_dtype": "bfloat16",
               "ids": "uniform", "rows": int(mom.shape[0]), "D": DIM,
               "S": S, "V": ids.numel()})
    del ids, w, segs, grad
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    state, warm, _ = _train_steps(dmp, state, batches[:1], 1)
    state, losses, dt = _train_steps(dmp, state, batches, LOWP_STEPS)
    counts = tbe.launch_counts()
    profiled, names = _update_kernels_profiled(
        lambda: dmp.train_step(state, batches[1]))
    mom = state["fused"][name]["momentum"]
    ref = DCN_MAIN_RUN
    rec = {"phase": "lowp_state", "card": card, "optim": "adagrad",
           "table_dtype": "float32", "momentum_dtype": str(mom.dtype),
           "batch": DCN_BATCH, "setup": setup,
           "steps": 1 + LOWP_STEPS, "timed_steps": LOWP_STEPS,
           "ms_per_step": dt * 1e3 / LOWP_STEPS,
           "samples_per_s": LOWP_STEPS * DCN_BATCH / dt,
           "losses": warm + losses,
           "all_finite": bool(np.isfinite(warm + losses).all()),
           "launches": counts, "profiled_launches_one_step": profiled,
           "update_kernels_profiled": names,
           "peak_memory_allocated": torch.cuda.max_memory_allocated(),
           "f32_state_ms_per_step": ref.get("ms_per_step"),
           "f32_state_peak_memory_allocated":
               ref.get("peak_memory_allocated")}
    if ref:
        rec["peak_memory_saved"] = (ref["peak_memory_allocated"]
                                    - rec["peak_memory_allocated"])
    emit(rec)
    _check_train(rec, counts, 1 + LOWP_STEPS)
    if profiled != {"pooled_lookup": 1, "fused_sparse_update": 1}:
        raise AssertionError(f"lowp_state: a profiled step launched "
                             f"{profiled}")
    if mom.dtype != torch.bfloat16:
        raise AssertionError(f"lowp_state: the state became {mom.dtype}")
    main_counts = counts
    del dmp, state, batches, mom
    torch.cuda.empty_cache()

    # the arms at the 1,000,000-row cap, on the first batch's kept slots
    keys, rows, caps, host = dcn_batches(DCN_ARM_ROW_CAP)
    batches = [b.to(dev) for b in host]
    dmp, state = build_dcn_trainer(dev, keys, rows, caps, "sgd",
                                   torch.float32)
    (name, lay), = dmp.sharded_ebc.tw_layouts.items()
    stack = state["tables"][name]
    ids, w, segs, S, _ = tw_b1_inputs(lay, batches[0].sparse_features)
    keep = (segs < S) & (w != 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    grad = torch.randn((S, DIM), generator=gen, device=dev) * 1e-2
    sg = SparseSegGrad(ids[keep], torch.ones_like(ids[keep], dtype=bool),
                       segs[keep], w[keep], grad)
    R = stack.shape[0]
    common = {"dtype": "float32", "rows": R, "D": DIM, "S": S,
              "V": int(sg.ids.numel())}
    arm_rows = []
    for sdtype in (torch.bfloat16, torch.float16):
        for optim in LOWP_OPTIMIZERS:
            states = [
                (torch.rand((R,) if kind == "row" else (R, DIM),
                            generator=gen, device=dev) * 1e-2).to(sdtype)
                for kind in STATE_LAYOUTS[optim]]
            for kernel in ("fused_sparse_update",
                           "dedup_fused_sparse_update"):
                arm_rows.append(_lowp_arm_row(flush, kernel, stack, states,
                                              optim, sg, None, common))
            del states
    # stochastic rounding off on bfloat16 tables: one rounding to nearest
    st16 = stack.to(torch.bfloat16)
    mom = torch.rand((R, DIM), generator=gen, device=dev) * 1e-2
    for kernel in ("fused_sparse_update", "dedup_fused_sparse_update"):
        arm_rows.append(_lowp_arm_row(
            flush, kernel, st16, [mom.to(torch.bfloat16)], "adagrad", sg,
            None, {**common, "dtype": "bfloat16", "sr": "off"}))
    del dmp, state, stack, st16, mom, sg, grad, ids, w, segs
    torch.cuda.empty_cache()
    sr = {}
    for kernel in ("tbe", "dedup"):
        tables = {}
        for on in (False, True):
            dmp, state = build_dcn_trainer(
                dev, keys, rows, caps, "adagrad", torch.bfloat16,
                update_kernel=kernel, stochastic_rounding=on)
            if on is False and dmp.sr_seeds(0) is not None:
                raise AssertionError("stochastic rounding off still seeds")
            tbe.reset_launch_counts()
            state, losses, _ = _train_steps(dmp, state, batches,
                                            LOWP_SR_STEPS)
            counts = {k: v for k, v in tbe.launch_counts().items() if v}
            want = {"pooled_lookup": LOWP_SR_STEPS,
                    ("fused_sparse_update" if kernel == "tbe"
                     else "dedup_fused_sparse_update"): LOWP_SR_STEPS}
            if counts != want or not np.isfinite(losses).all():
                raise AssertionError(f"lowp_state SR arm {kernel} {on}: "
                                     f"{counts}, losses {losses}")
            tables[on] = next(iter(state["tables"].values())).clone()
            sr[f"{kernel}_sr_{'on' if on else 'off'}_losses"] = losses
            del dmp, state
            torch.cuda.empty_cache()
        differ = int((tables[False] != tables[True]).sum())
        sr[f"{kernel}_elements_on_differ_from_off"] = differ
        if not differ:
            raise AssertionError(f"lowp_state: {kernel} SR on == off")
        del tables
    arm_rows.insert(0, path_b2)
    emit({"phase": "lowp_state_arms", "card": card, "rows": sum(rows),
          "arms": len(arm_rows), "all_equal": all(r["equal"]
                                                   for r in arm_rows),
          **sr, "seconds": time.perf_counter() - t0,
          "budget_s": LOWP_BUDGET_S})
    torch.cuda.empty_cache()
    return main_counts, [check] + arm_rows


# ---------------------------------------------------------------------------
# phase 10: the sequence path, SequenceModelParallel training BERT4Rec at
# the paper's MovieLens-20m width
# ---------------------------------------------------------------------------

# BERT4Rec on ML-20m (Sun et al., CIKM 2019, Table 1 and section 4.4): the
# items, N, d, blocks, heads, batch, mask proportion and Adam's lr
SEQ_VOCAB = 26_744
SEQ_LEN = 200
SEQ_DIM = 64
SEQ_BLOCKS = 2
SEQ_HEADS = 2
SEQ_BATCH = 256
SEQ_MASK = 0.2
SEQ_LR = 1e-4
SEQ_MIN_LEN = 5  # synthetic sessions: lengths uniform on 5..200
SEQ_ZIPF = 1.0  # Zipf(1.0) item ids
SEQ_BATCHES = 4
SEQ_STEPS = 20  # timed, after one warm-up step
SEQ_BUDGET_S = 90
# the device kernel name of B2 and B6 (one template)
UPDATE_KERNEL_NAME = "fused_update_kernel"


def seq_host_batches(n, batch, seed):
    """``n`` synthetic session batches of ``batch`` sessions on the host
    (``examples/bert4rec/main.py::make_session_batch`` at the seq width)."""
    from torchrec_tpu_torch.examples.bert4rec.main import make_session_batch

    rng = np.random.RandomState(seed)
    return [make_session_batch(rng, batch, SEQ_LEN, SEQ_VOCAB, SEQ_MASK,
                               SEQ_MIN_LEN, SEQ_ZIPF) for _ in range(n)]


def seq_tables():
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig

    return [EmbeddingConfig(num_embeddings=SEQ_VOCAB, embedding_dim=SEQ_DIM,
                            name="t_item", feature_names=["item"])]


def build_seq(dev, batch, env=None, kind="tw", loss_fn=None):
    """``SequenceModelParallel`` over BERT4Rec at the seq width, ``batch``
    sessions a rank, fused Adam on the item table (B6) and the dense Adam,
    both at ``SEQ_LR``; the plan ``kind``: ``"tw"`` (the item table on the
    last rank) or ``"rw"`` (its rows over every rank); the loss the
    example's masked-item loss unless ``loss_fn`` is given.  Its state
    from a seeded generator on ``dev`` (the same draws on every rank)."""
    import torch

    from torchrec_tpu_torch.examples.bert4rec.main import make_loss_fn
    from torchrec_tpu_torch.models.experimental.bert4rec import BERT4Rec
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim.adam import adam
    from torchrec_tpu_torch.parallel.sequence_model_parallel import (
        SequenceModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType,
    )

    N = 1 if env is None else env.world_size
    ps = (ParameterSharding(ShardingType.ROW_WISE, ranks=list(range(N)))
          if kind == "rw" else
          ParameterSharding(ShardingType.TABLE_WISE, ranks=[N - 1]))
    model = BERT4Rec(SEQ_VOCAB, SEQ_LEN, SEQ_DIM, SEQ_BLOCKS, SEQ_HEADS,
                     device="meta")
    smp = SequenceModelParallel(
        model, seq_tables(), env, {"t_item": ps}, batch,
        {"item": batch * SEQ_LEN}, loss_fn or make_loss_fn(SEQ_LEN),
        FusedOptimConfig(optim=EmbOptimType.ADAM, learning_rate=SEQ_LR),
        adam(SEQ_LR), device=dev if env is None else None)
    return smp, smp.init(torch.Generator(device=dev).manual_seed(0))


def seq_rows_check(smp, state, kjt, env=None):
    """The sharded collection's per-id rows of ``kjt`` ``torch.equal`` to
    the unsharded ``EmbeddingCollection``'s over the same weights
    (``table_weights``: a collective).  Returns (equal, max abs err)."""
    import torch

    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingCollection,
    )

    dev = kjt.values().device
    weights = smp.table_weights(state)
    ref = EmbeddingCollection(seq_tables(), device="meta")
    ref.load_state_dict({"t_item": torch.from_numpy(weights["t_item"]).to(
        dev)}, assign=True)
    with torch.no_grad():
        got, _ = smp.sharded_ec.forward_local(state["tables"], kjt, env)
        want = ref(kjt)["item"].values()
    got = got["item"].values()
    return bool(torch.equal(got, want)), float((got - want).abs().max())


def seq_step_grads(smp, state, batch):
    """The step's own per-id gradients at the rank's shapes: the forward,
    the dense backward and the reductions over ranks, then the reverse
    dists (collectives).  Returns {group: SparseSegGrad}."""
    import torch

    ec = smp.sharded_ec
    with torch.no_grad():
        outs, ctxs = ec.forward_local(state["tables"],
                                      batch.sparse_features, smp.env)
    loss, g_dense, g_emb = smp.dense_forward_backward(
        state, batch, {f: jt.values() for f, jt in outs.items()})
    _, _, g_emb = smp.reduce_grads(loss, g_dense, g_emb)
    return ec.backward_local(ctxs, g_emb, smp.env)


def seq_b6_check(state, sgs, lr):
    """B6 with Adam (its first step's bias corrections) on each group's
    per-id slots, the kernel and the plain version each on copies of the
    stack and the fused state: ``torch.equal``.  Returns {group: (equal,
    slots, valid slots, max abs err)}."""
    import torch

    from torchrec_tpu_torch.ops import tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        FusedOptimConfig,
        bias_corrections,
    )

    out = {}
    bc = bias_corrections(FusedOptimConfig(), 1)
    for name, sg in sgs.items():
        res = []
        for fn in (tbe_backward.dedup_fused_sparse_update,
                   tbe_backward.dedup_fused_sparse_update_plain):
            t = state["tables"][name].clone()
            sts = [state["fused"][name][k].clone() for k in ("m", "v")]
            fn(t, sts, sg.ids, sg.valid, sg.segments, sg.weights,
               sg.grad_seg, "adam", lr, eps=EPS, bias_corrections=bc)
            res.append([t] + sts)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) if a.numel() else 0.0
                  for a, b in zip(*res))
        out[name] = (all(torch.equal(a, b) for a, b in zip(*res)),
                     int(sg.ids.numel()), int(sg.ok().sum()), err)
    return out


def _seq_steps(smp, state, batches, n, offset=0):
    """``n`` train steps cycling ``batches`` from ``offset``, ending in a
    synchronise; returns (state, losses as floats, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(n):
        state, m = smp.train_step(state,
                                  batches[(offset + i) % len(batches)])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return state, [float(x) for x in losses], time.perf_counter() - t0


def _update_profile_check(rec, what):
    """A profiled step's device kernels: the fused update ran and no
    pooled lookup did."""
    names = rec["device_names"]
    updates = [n for n in names if UPDATE_KERNEL_NAME in n]
    pooled = [n for n in names if any(k in n for k in POOLED_KERNEL_NAMES)]
    if not updates or pooled:
        raise AssertionError(f"{what}: profiled update kernels {updates}, "
                             f"pooled kernels {pooled}")
    return {"update_kernels": updates, "pooled_kernels": pooled}


def seq_phase(dev, flush):
    """The sequence path at the ML-20m width (module docstring).  Returns
    (the main path's launches, the B6 row)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    t0 = time.perf_counter()
    card = nvidia_smi_line()
    smp, state = build_seq(dev, SEQ_BATCH)
    batches = [b.to(dev) for b in seq_host_batches(SEQ_BATCHES, SEQ_BATCH,
                                                   seed=0)]
    rows_equal, rows_err = seq_rows_check(smp, state,
                                          batches[0].sparse_features)
    if not rows_equal:
        raise AssertionError(f"seq: sharded rows != the unsharded EC's "
                             f"(max abs err {rows_err})")
    (name, sg), = seq_step_grads(smp, state, batches[0]).items()
    stack = state["tables"][name]
    gen = torch.Generator(device=dev).manual_seed(13)
    b6 = b6_row(flush, stack, "adam", sg, None, gen, {
        "rows": stack.shape[0], "D": stack.shape[1], "V": sg.ids.numel(),
        "valid": int(sg.valid.sum()), "ids": "zipf",
        "S": sg.grad_seg.shape[0]}, phase="seq_kernel", lr=SEQ_LR)
    del sg
    # the main path: 1 warm-up step, then SEQ_STEPS timed steps cycling
    # the batches (the last step runs on batch 0 again, as the first)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    state, warm, _ = _seq_steps(smp, state, batches, 1)
    state, losses, dt = _seq_steps(smp, state, batches, SEQ_STEPS, offset=1)
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    losses = warm + losses
    steps = 1 + SEQ_STEPS
    prof = profile_calls({"phase": "seq_profile", "card": card,
                          "batch": SEQ_BATCH},
                         lambda: smp.train_step(state, batches[1]), 2,
                         "step")
    rec = {"phase": "seq", "card": card, "vocab": SEQ_VOCAB,
           "max_len": SEQ_LEN, "dim": SEQ_DIM, "blocks": SEQ_BLOCKS,
           "heads": SEQ_HEADS, "batch": SEQ_BATCH, "mask_prob": SEQ_MASK,
           "lr": SEQ_LR, "steps": steps, "timed_steps": SEQ_STEPS,
           "ms_per_step": dt * 1e3 / SEQ_STEPS,
           "sequences_per_s": SEQ_STEPS * SEQ_BATCH / dt,
           "peak_memory_allocated": peak, "losses": losses,
           "all_finite": bool(np.isfinite(losses).all()),
           "last_below_first": losses[-1] < losses[0],
           "rows_equal_unsharded": rows_equal, "launches": counts,
           "profiled": _update_profile_check(prof, "seq"),
           "device_idle_share": prof["device_idle_share"],
           "b6_slots": b6["V"], "b6_valid_slots": b6["valid"],
           "seconds": time.perf_counter() - t0, "budget_s": SEQ_BUDGET_S}
    rec["within_budget"] = rec["seconds"] <= SEQ_BUDGET_S
    emit(rec)
    if not rec["all_finite"] or not rec["last_below_first"]:
        raise AssertionError(f"seq: losses {losses}")
    if counts != {"dedup_fused_sparse_update": steps}:
        raise AssertionError(f"seq: {steps} steps launched {counts}")
    del smp, state, batches
    torch.cuda.empty_cache()
    return counts, b6


# ---------------------------------------------------------------------------
# phase 11: the remaining model families at the train width
# ---------------------------------------------------------------------------

MODELS_STEPS = 10  # timed, after one warm-up step
MODELS_BUDGET_S = 60
TRANSFORMER_HEADS = 8  # the JAX DLRM_Transformer's defaults
TRANSFORMER_LAYERS = 4
DEEPFM_HIDDEN = 512
DEEPFM_DIM = 128
TWO_TOWER_ROWS = 1_000_000
TWO_TOWER_DIM = 64
TWO_TOWER_LAYERS = (128, 64)
TWO_TOWER_HISTORY = 8  # query ids an example, 1 to 8
TWO_TOWER_LR = 1e-3
KNN_K = 100
KNN_CHECKED = 8  # queries held to a host recompute
FP_MAX_LEN = 20  # position-weighted EBC: 1 to 20 ids an example


def _dmp_model_run(dev, name, model_fn):
    """A model through the one-device DMP at the train width: the path
    check (B1 and B2 ``torch.equal`` to their plain versions at the
    path's shapes), 1 + ``MODELS_STEPS`` steps launching one B1 and one
    B2 each and nothing else (counts and a profiled step).  Returns (the
    record, counts, the path check)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    dmp, state, batches = build_trainer(dev, torch.float32, model_fn)
    check = train_path_check(dmp, state, batches[0], None,
                             phase=f"models_{name}_path_check")
    tbe.reset_launch_counts()
    state, warm, _ = _train_steps(dmp, state, batches[:1], 1)
    state, losses, dt = _train_steps(dmp, state, batches, MODELS_STEPS)
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    profiled = _profiled_kernels(lambda: dmp.train_step(state, batches[1]))
    rec = {"phase": f"models_{name}", "batch": TRAIN_BATCH,
           "steps": 1 + MODELS_STEPS,
           "ms_per_step": dt * 1e3 / MODELS_STEPS,
           "samples_per_s": MODELS_STEPS * TRAIN_BATCH / dt,
           "losses": warm + losses,
           "all_finite": bool(np.isfinite(warm + losses).all()),
           "launches": counts, "profiled_launches_one_step": profiled}
    _check_train(rec, counts, 1 + MODELS_STEPS)
    if profiled != {"pooled_lookup": 1, "fused_sparse_update": 1}:
        raise AssertionError(f"{name}: profiled step launched {profiled}")
    del dmp, state, batches
    torch.cuda.empty_cache()
    return rec, counts, check


def _two_tower_run(dev):
    """``TwoTower`` (a 1,000,000 x 64 table a tower, MLPs 128-64):
    1 + ``MODELS_STEPS`` steps of in-batch negatives with Adam over every
    parameter (two B1 launches a step, nothing else), then
    ``BruteForceKNN`` over the candidate tower's 1,000,000 embeddings:
    the top ``KNN_K`` of one batch's queries, ``KNN_CHECKED`` of them
    held to a host recompute.  Returns (record, counts)."""
    import torch

    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.models.two_tower import (
        BruteForceKNN,
        TwoTower,
        in_batch_negatives_loss,
    )
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.optim.adam import adam
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    gen = torch.Generator(device=dev).manual_seed(0)

    def tower(feature):
        return EmbeddingBagCollection(
            [EmbeddingBagConfig(num_embeddings=TWO_TOWER_ROWS,
                                embedding_dim=TWO_TOWER_DIM,
                                name=f"t_{feature}",
                                feature_names=[feature])],
            device=dev, generator=gen)

    torch.manual_seed(0)  # the MLPs' initial weights
    model = TwoTower(tower("query"), tower("candidate"),
                     TWO_TOWER_LAYERS).to(dev)
    qds = RandomRecDataset(["query"], TRAIN_BATCH, [TWO_TOWER_ROWS],
                           [TWO_TOWER_HISTORY], num_dense=1, manual_seed=1,
                           min_ids_per_features=[1])
    cds = RandomRecDataset(["candidate"], TRAIN_BATCH, [TWO_TOWER_ROWS],
                           [1], num_dense=1, manual_seed=2,
                           min_ids_per_features=[1])
    qit, cit = iter(qds), iter(cds)
    pairs = [(next(qit).sparse_features.to(dev),
              next(cit).sparse_features.to(dev))
             for _ in range(TRAIN_BATCHES)]
    params = dict(model.named_parameters())
    opt = adam(TWO_TOWER_LR)
    ost = opt.init(params)

    def step(q, c):
        loss = in_batch_negatives_loss(model(q, c))
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), ost)
        return loss.detach()

    tbe.reset_launch_counts()
    losses = [step(*pairs[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MODELS_STEPS):
        losses.append(step(*pairs[(i + 1) % len(pairs)]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    losses = [float(x) for x in losses]
    steps = 1 + MODELS_STEPS
    if counts != {"pooled_lookup": 2 * steps}:
        raise AssertionError(f"two_tower: {steps} steps launched {counts}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"two_tower: losses {losses}")
    # the retrieval index: every candidate id through the candidate tower
    with torch.no_grad():
        R = TWO_TOWER_ROWS
        ck = KeyedJaggedTensor(["candidate"], torch.arange(R, device=dev),
                               torch.ones(R, dtype=torch.int32, device=dev),
                               caps=R)
        cands = model.embed_candidate(ck)
        queries = model.embed_query(pairs[0][0])
        knn = BruteForceKNN(cands)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scores, idx = knn.query(queries, KNN_K)
        end.record()
        end.synchronize()
        knn_ms = start.elapsed_time(end)
        knn_peak = torch.cuda.max_memory_allocated() - base
        host_c = cands.cpu().numpy()
        host_q = queries[:KNN_CHECKED].cpu().numpy()
        got_s = scores[:KNN_CHECKED].cpu().numpy()
        got_i = idx[:KNN_CHECKED].cpu().numpy()
    want = host_q @ host_c.T  # [checked, R] on the host
    top = -np.sort(-want, axis=1)[:, :KNN_K]
    score_err = float(np.abs(got_s - top).max())
    own_err = float(np.abs(np.take_along_axis(want, got_i, 1)
                           - got_s).max())
    rec = {"phase": "models_two_tower", "batch": TRAIN_BATCH,
           "rows_per_tower": TWO_TOWER_ROWS, "dim": TWO_TOWER_DIM,
           "layers": list(TWO_TOWER_LAYERS), "steps": steps,
           "ms_per_step": dt * 1e3 / MODELS_STEPS, "losses": losses,
           "launches": counts, "knn_candidates": R,
           "knn_queries": int(queries.shape[0]), "k": KNN_K,
           "knn_ms": knn_ms, "knn_peak_bytes": knn_peak,
           "knn_topk_score_max_abs_err": score_err,
           "knn_own_score_max_abs_err": own_err}
    if score_err > 1e-5 or own_err > 1e-5:
        raise AssertionError(f"two_tower KNN off the host recompute: {rec}")
    del model, params, ost, cands, knn, scores, idx
    torch.cuda.empty_cache()
    return rec, counts


def _fp_ebc_run(dev, flush):
    """The position-weighted EBC's forward over the 26 train tables (1 to
    ``FP_MAX_LEN`` ids an example, learned position weights): 26 weighted
    B1 launches, each table's pooled output ``torch.equal`` to B1's plain
    version over the processed per-slot weights.  Returns (record,
    counts, max abs err)."""
    import torch

    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
        key_regions,
    )
    from torchrec_tpu_torch.modules.feature_processor import (
        FeatureProcessedEmbeddingBagCollection,
    )
    from torchrec_tpu_torch.ops import tbe

    keys, tables = bench_tables()
    ebc = EmbeddingBagCollection(
        tables, is_weighted=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    fp = FeatureProcessedEmbeddingBagCollection(
        ebc, {k: FP_MAX_LEN for k in keys}).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for p in fp.position_weights.parameters():
            p.copy_(torch.rand(p.shape, generator=gen, device=dev))
    ds = RandomRecDataset(keys, TRAIN_BATCH, [TRAIN_ROWS] * len(keys),
                          [FP_MAX_LEN] * len(keys), num_dense=NUM_DENSE,
                          manual_seed=3,
                          min_ids_per_features=[1] * len(keys))
    kjt = next(iter(ds)).sparse_features.to(dev)
    with torch.no_grad():
        kt, counts = _counted(lambda: fp(kjt))
        weighted = fp.position_weights(kjt)
        errs, equal = [], True
        for i, c in enumerate(tables):
            ids, w, regions, _ = key_regions(weighted, [i])
            plain = tbe.pooled_lookup_regions_plain(getattr(ebc, c.name),
                                                    ids, regions, w)
            got = kt.values()[:, i * DIM:(i + 1) * DIM]
            equal &= bool(torch.equal(got, plain))
            errs.append(float((got - plain).abs().max()))
        ms = cuda_ms(lambda: fp(kjt), flush, runs=5, warmup=1)
    rec = {"phase": "models_fp_ebc", "batch": TRAIN_BATCH,
           "tables": len(tables), "max_len": FP_MAX_LEN,
           "slots": int(kjt.values().numel()),
           "valid_slots": int(kjt.lengths().sum()), "launches": counts,
           "b1_weighted_equal": equal, "b1_max_abs_err": max(errs),
           "forward_ms": ms}
    if not equal or counts != {"pooled_lookup": len(tables)}:
        raise AssertionError(f"position-weighted EBC: {rec}")
    del fp, ebc, kt, weighted
    torch.cuda.empty_cache()
    return rec, counts, max(errs)


def models_phase(dev, flush):
    """The remaining model families at the train width (module
    docstring).  Returns (the main paths' launches, the DMP path checks,
    the position-weighted B1's max abs err)."""
    import torch

    from torchrec_tpu_torch.models.deepfm import SimpleDeepFMNN
    from torchrec_tpu_torch.models.experimental.transformerdlrm import (
        DLRM_Transformer,
    )

    t0 = time.perf_counter()
    card = nvidia_smi_line()
    launches: dict = {}
    checks = []

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for name, fn in (
            ("dlrm_transformer", lambda tables: DLRM_Transformer(
                meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                TRANSFORMER_HEADS, TRANSFORMER_LAYERS,
                dense_dtype=torch.bfloat16)),
            ("deepfm", lambda tables: SimpleDeepFMNN(
                meta_ebc(tables), NUM_DENSE, DEEPFM_HIDDEN, DEEPFM_DIM))):
        rec, counts, check = _dmp_model_run(dev, name, fn)
        emit({**rec, "card": card})
        add(counts)
        checks.append(check)
    rec, counts = _two_tower_run(dev)
    emit({**rec, "card": card})
    add(counts)
    rec, counts, err = _fp_ebc_run(dev, flush)
    emit({**rec, "card": card})
    add(counts)
    s = time.perf_counter() - t0
    emit({"phase": "models_summary", "card": card, "seconds": s,
          "budget_s": MODELS_BUDGET_S,
          "within_budget": s <= MODELS_BUDGET_S, "launches": launches})
    return launches, checks, err


# ---------------------------------------------------------------------------
# phase 7: serving at full width
# ---------------------------------------------------------------------------


def _random_int8_tables(dev, tables, seed):
    """Codes, scales and biases drawn on the device from a seeded
    generator (dequantized values in about [-0.05, 0.06])."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {}
    for cfg in tables:
        R = cfg.num_embeddings
        params[cfg.name] = {
            "q": torch.randint(0, 256, (R, cfg.embedding_dim), generator=gen,
                               device=dev, dtype=torch.uint8),
            "scale": (torch.rand(R, generator=gen, device=dev) + 0.5)
            * (0.1 / 255),
            "bias": torch.rand(R, generator=gen, device=dev) * 0.01 - 0.05,
        }
    return params


def _requests(batch, num_features):
    """Split one dataset batch into single-example requests."""
    kjt = batch.sparse_features
    B = kjt.stride()
    lengths = kjt.lengths().numpy().reshape(num_features, B)
    values = kjt.values().numpy()
    offs = kjt.cap_offsets()
    per_feat = []
    for f in range(num_features):
        starts = np.concatenate([[0], np.cumsum(lengths[f])])
        per_feat.append([values[offs[f] + starts[b]: offs[f] + starts[b + 1]]
                         for b in range(B)])
    dense = batch.dense_features.numpy()
    return [(dense[b], [per_feat[f][b] for f in range(num_features)])
            for b in range(B)]


def _serve(server, requests):
    """Send ``requests`` from NUM_CLIENTS threads; returns (scores,
    per-request latencies in ms, wall seconds)."""
    scores = np.full((len(requests),), np.nan, np.float64)
    lat = np.zeros((len(requests),), np.float64)
    errors = []

    def client(k):
        try:
            for i in range(k, len(requests), NUM_CLIENTS):
                t0 = time.perf_counter()
                scores[i] = server.predict(*requests[i])
                lat[i] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # reported below, after every join
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(NUM_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors:
        raise RuntimeError(f"serving clients failed: {errors[:3]}")
    return scores, lat, wall


def _direct_batch(requests, features, caps, dev):
    """The requests as one formed batch (KJT, dense) on ``dev``."""
    import torch

    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    B, F = len(requests), len(features)
    lengths = np.asarray([[len(x) for x in ids] for _, ids in requests],
                         np.int32)
    values = np.concatenate([np.asarray(requests[b][1][f], np.int64)
                             for f in range(F) for b in range(B)])
    kjt = KeyedJaggedTensor.from_lengths_packed(
        features, values, lengths.T.reshape(-1), caps=[c * B for c in caps])
    dense = torch.from_numpy(np.stack([d for d, _ in requests]))
    return kjt.to(dev), dense.to(dev)


def profile_serving(kernel, fn, batch, iters: int = 10):
    """Where one formed batch's time goes (:func:`profile_calls` over
    ``iters`` calls of the serving module)."""

    def step():
        fn(batch.dense_features, batch.sparse_features)

    profile_calls({"phase": "profile", "kernel": kernel,
                   "batch": batch.dense_features.shape[0]}, step, iters,
                  "batch")


def profile_calls(record, call, iters: int, unit: str, marked=None):
    """``torch.profiler`` over ``iters`` calls of ``call``, each ending in
    a synchronise, emitted as ``record`` plus the numbers per ``unit``.
    Device busy time is the sum of the device events (one stream, so
    they do not overlap; spans are left out); the rest of the profiled
    wall time the card is idle.  The same calls are timed once without the
    profiler, which gives the profiler's own cost and the idle share of
    the unprofiled wall.  ``marked`` (a set of names as the record gives
    them) adds the device time of those items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        call()
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    bare_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # a span (record_function) also shows as a device-side range over the
    # kernels it launched: it is not device work of its own
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    # a profiler that traced no device event measured nothing: report
    # the device numbers as not measured (null), never as an idle card
    busy_ms = (sum(e.time_range.elapsed_us() for e in device) / 1e3 / iters
               if device else None)
    by_name: dict = {}
    for e in device:
        # the C++ signature without its argument list, cut to 72 chars
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0][:72]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    rec = {**record, "iters": iters,
           f"unprofiled_wall_ms_per_{unit}": bare_ms,
           f"wall_ms_per_{unit}": wall_ms,
           f"device_busy_ms_per_{unit}": busy_ms,
           "device_idle_share": (None if busy_ms is None
                                 else 1.0 - busy_ms / wall_ms),
           "device_idle_share_of_unprofiled_wall": (
               None if busy_ms is None else 1.0 - busy_ms / bare_ms),
           f"device_events_per_{unit}": len(device) / iters,
           f"top_device_ms_per_{unit}": {k: v / 1e3 / iters
                                         for k, v in top}}
    if marked is not None:
        rec[f"marked_device_ms_per_{unit}"] = sum(
            v for k, v in by_name.items() if k in marked) / 1e3 / iters
    # the sort kernels (radix sorts of slot streams), by name
    sorts = {k: v for k, v in by_name.items() if "sort" in k.lower()}
    rec[f"sort_device_ms_per_{unit}"] = {k: v / 1e3 / iters
                                         for k, v in sorts.items()}
    rec[f"sort_events_per_{unit}"] = sum(
        1 for e in device if "sort" in e.name.lower()) / iters
    emit(rec)
    rec["device_names"] = sorted(by_name)  # for the caller, not printed
    return rec


def path_kernel_phase(dev, tables, params, kjt, zipf_seed):
    """Each kernel against its plain version on the card, at the shapes
    the serving path gives it: every feature of one formed batch over the
    full-size tables, as ``QuantEmbeddingBagCollection`` calls them, with
    the batch's uniform ids and with Zipf ids.  int4 and int2 run over
    the same codes viewed as packed rows (``[R, 128]`` uint8 is ``[2R,
    64]`` int4 and ``[4R, 32]`` int2, scale and bias repeated per row),
    with ids ``k * id + k - 1``, so the largest row offsets pass 2^31
    bytes at every width.  Returns the records it emits."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.sharding.common import per_slot_segments

    B = kjt.stride()
    rng = np.random.RandomState(zipf_seed)
    # per id set and (kernel, bits): [slots, slots past 2^31 bytes,
    # largest row, max abs err]
    stats: dict = {}
    for cfg in tables:
        p = params[cfg.name]
        R, D = p["q"].shape
        for f in cfg.feature_names:
            jt = kjt[f]
            seg = per_slot_segments(jt.lengths(), jt.capacity)
            valid = (seg >= 0) & (seg < B)
            uni = jt.values().to(torch.int64)
            zipf = torch.from_numpy(
                zipf_ids(rng, uni.numel(), R).astype(np.int64)).to(dev)
            for bits in (8, 4, 2):
                per = 8 // bits
                packed = p["q"].view(R * per, D // per)
                scale = p["scale"].repeat_interleave(per)
                bias = p["bias"].repeat_interleave(per)
                runs = [("dedup_quant_pooled_lookup",
                         tbe.dedup_quant_pooled_lookup,
                         tbe.dedup_quant_pooled_lookup_plain, {"bits": bits})]
                if bits == 8:
                    runs.insert(0, ("quant_pooled_lookup_int8",
                                    tbe.quant_pooled_lookup_int8,
                                    tbe.quant_pooled_lookup_int8_plain, {}))
                for dist, base in (("uniform", uni), ("zipf", zipf)):
                    ids = base * per + (per - 1)
                    vids = ids[valid]
                    far = int((vids * packed.shape[1] >= FAR_BYTES).sum())
                    top = int(vids.max()) if vids.numel() else -1
                    for name, wrapper, plain, kw in runs:
                        got = wrapper(packed, scale, bias, ids, seg, B, **kw)
                        torch.cuda.synchronize()
                        ref = plain(packed, scale, bias, ids, seg, B, **kw)
                        torch.cuda.synchronize()
                        err = float((got - ref).abs().max())
                        if not torch.equal(got, ref):
                            raise AssertionError(
                                f"{name} bits={bits} {dist} feature {f}: "
                                f"kernel != plain on the serving tables "
                                f"(max abs err {err})")
                        s = stats.setdefault((dist, name, bits),
                                             [0, 0, -1, 0.0])
                        s[0] += int(vids.numel())
                        s[1] += far
                        s[2] = max(s[2], top)
                        s[3] = max(s[3], err)
                del packed, scale, bias
    recs = []
    for (dist, name, bits), (n, far, top, err) in stats.items():
        rec = {"phase": "path_kernel", "kernel": name, "bits": bits,
               "ids": dist, "batch": B, "features": len(kjt.keys()),
               "slots": n, "slots_past_2^31_bytes": far, "largest_row": top,
               "equal": True, "max_abs_err": err}
        emit(rec)
        recs.append(rec)
    near = [(r["kernel"], r["bits"]) for r in recs
            if r["ids"] == "uniform" and r["slots_past_2^31_bytes"] == 0]
    if near:
        raise AssertionError(f"{near}: no row offset of the served batch "
                             "passed 2^31 bytes")
    return recs


# (kernel, packed bits) of the grouped rows: the int8 lookup and the dedup
# lookup at every packed width
GROUPED_KERNELS = (("tbe", 8), ("dedup", 8), ("dedup", 4), ("dedup", 2))


def grouped_phase(dev, tables, params, batches, zipf_seed):
    """The grouped lookups (every feature of a formed batch in one launch,
    as ``QuantEmbeddingBagCollection.forward`` calls them) against their
    plain versions (``torch.equal``) over the full-size tables, at each
    batch of ``batches``: the batch's uniform ids and Zipf ids, int8 and
    the int4/int2 views of the same codes (ids ``k * id + k - 1`` as in
    :func:`path_kernel_phase`, so row offsets pass 2^31 bytes), with the
    wrapper's, the kernel's (on prepared inputs) and the plain version's
    times and the bound.  No single library call computes 26 tables'
    lookups, so ``library_ms`` is null.  Returns the records it emits."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    rng = np.random.RandomState(zipf_seed)
    named = [(cfg, f) for cfg in tables for f in cfg.feature_names]
    recs = []
    for kjt in batches:
        B, keys, offs = kjt.stride(), list(kjt.keys()), kjt.cap_offsets()
        lengths = kjt.lengths()
        zipf = kjt.values().clone()
        for cfg, f in named:
            k = keys.index(f)
            zipf[offs[k]:offs[k + 1]] = torch.from_numpy(zipf_ids(
                rng, offs[k + 1] - offs[k], cfg.num_embeddings)
                .astype(np.int64)).to(dev)
        for bits in (8, 4, 2):
            per = 8 // bits
            feats, width = [], 0
            for cfg, f in named:
                p = params[cfg.name]
                R, D = p["q"].shape
                scale, bias = p["scale"], p["bias"]
                if per > 1:
                    scale = scale.repeat_interleave(per)
                    bias = bias.repeat_interleave(per)
                feats.append(tbe.GroupFeature(
                    p["q"].view(R * per, D // per), scale, bias,
                    keys.index(f), width))
                width += D
            Dp = feats[0].q.shape[1]
            for kernel, kbits in GROUPED_KERNELS:
                if kbits != bits:
                    continue
                if kernel == "tbe":
                    name = "quant_pooled_lookup_int8"
                    wrapper = tbe.quant_pooled_lookup_int8_grouped
                    plain = tbe.quant_pooled_lookup_int8_grouped_plain
                    kw = {}
                else:
                    name = "dedup_quant_pooled_lookup"
                    wrapper = tbe.dedup_quant_pooled_lookup_grouped
                    plain = tbe.dedup_quant_pooled_lookup_grouped_plain
                    kw = {"bits": bits}
                for dist, base in (("uniform", kjt.values()), ("zipf", zipf)):
                    values = base * per + (per - 1)
                    args = (values, lengths, offs, feats)
                    out = torch.empty((B, width), device=dev)
                    got = wrapper(*args, out.clone(), **kw)
                    torch.cuda.synchronize()
                    ref = plain(*args, out.clone(), **kw)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"grouped {name} bits={bits} {dist} B={B}: "
                            f"kernel != plain (max abs err {err})")
                    if kernel == "tbe":
                        ends = tbe.group_ends(lengths, len(keys), B)
                        launch = lambda: tbe.launch_q8_grouped(  # noqa: E731
                            feats, offs, values, ends, out)
                    else:
                        prep = tbe.dedup_prepare_grouped(*args, B)
                        launch = lambda: tbe.launch_dedup_q_grouped(  # noqa: E731
                            feats, offs, *prep, out, bits)
                    # the least the group must move: each distinct (feature,
                    # row) once (codes, scale, bias), each valid id (int64)
                    # once, the lengths, the float32 output once; 4 flops
                    # per valid id and column
                    gkeys = tbe.group_keys_plain(*args, B)
                    valid = gkeys != tbe.SENTINEL
                    U = int(tbe.num_unique(tbe.sized_unique(gkeys)[0]))
                    n = int(valid.sum())
                    nbytes = (U * (Dp + 8) + n * 8 + lengths.numel() * 4
                              + B * width * 4)
                    flops = 4 * n * Dp * per
                    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                    flops_ms = flops / PEAK_F32_FLOPS * 1e3
                    rec = {
                        "phase": "grouped", "kernel": name, "bits": bits,
                        "ids": dist, "batch": B, "features": len(feats),
                        "slots": n, "distinct": U,
                        "slots_past_2^31_bytes": int(
                            (values[valid] * Dp >= FAR_BYTES).sum()),
                        "equal": True, "max_abs_err": err,
                        "ms": cuda_ms(lambda: wrapper(*args, out, **kw),
                                      flush),
                        "kernel_ms": cuda_ms(launch, flush),
                        "kernel_device_ms": cuda_ms(launch, flush,
                                                    device_only=True),
                        "plain_ms": cuda_ms(
                            lambda: plain(*args, out, **kw), flush,
                            runs=PLAIN_RUNS, warmup=1),
                        "library_ms": None,
                        "bytes": nbytes, "flops": flops,
                        "bound_ms": max(bytes_ms, flops_ms),
                        "bound_by": "bytes" if bytes_ms >= flops_ms
                        else "operations",
                    }
                    rec["peak_bytes_above_inputs"] = memory_of(
                        lambda: wrapper(*args, out, **kw))[0]
                    emit(rec)
                    recs.append(rec)
            del feats
    near = [(r["kernel"], r["bits"], r["batch"]) for r in recs
            if r["ids"] == "uniform" and r["slots_past_2^31_bytes"] == 0]
    if near:
        raise AssertionError(f"{near}: no row offset of a grouped batch "
                             "passed 2^31 bytes")
    del flush
    torch.cuda.empty_cache()
    return recs


def sync_check(fns, batch):
    """Each collection's forward on one formed batch under
    ``torch.cuda.set_sync_debug_mode("error")`` (it must not synchronise
    with the host: it raises if it does); the whole serving module is
    tried the same way and only reported."""
    import torch

    for kernel, fn in fns.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.inference_mode():
                fn.quant_ebc(batch.sparse_features)
            try:
                fn(batch.dense_features, batch.sparse_features)
                serving_syncs = False
            except RuntimeError:
                serving_syncs = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        emit({"phase": "sync_check", "kernel": kernel,
              "batch": batch.dense_features.shape[0],
              "collection_forward_syncs": False,
              "serving_module_syncs": serving_syncs})


def serving_phase(dev):
    import torch

    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        MLPERF_DLRM_V2_ROWS,
        mlperf_dlrm_v2_tables,
    )
    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.inference import InferenceServer, build_serving_fn
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import DataType
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection

    import dataclasses

    features = list(DEFAULT_CAT_NAMES)
    caps = list(MLPERF_DLRM_V2_MULTI_HOT)
    tables = tuple(dataclasses.replace(c, data_type=DataType.INT8)
                   for c in mlperf_dlrm_v2_tables(DIM))
    t0 = time.perf_counter()
    params = _random_int8_tables(dev, tables, seed=0)
    torch.cuda.synchronize()
    table_bytes = sum(p["q"].numel() + 8 * p["scale"].numel()
                      for p in params.values())
    emit({"phase": "serving_tables", "rows": sum(MLPERF_DLRM_V2_ROWS),
          "bytes": table_bytes, "seconds": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    torch.manual_seed(0)
    model = DLRM(meta_ebc(mlperf_dlrm_v2_tables(DIM)), NUM_DENSE, DENSE_ARCH,
                 OVER_ARCH)
    fns = {
        kernel: build_serving_fn(
            model, QuantEmbeddingBagCollection(tables, params, kernel),
            device=dev)
        for kernel in ("tbe", "dedup")
    }
    ds = RandomRecDataset(features, NUM_REQUESTS, MLPERF_DLRM_V2_ROWS, caps,
                          num_dense=NUM_DENSE, manual_seed=0, num_batches=1)
    uniform = _requests(next(iter(ds)), len(features))
    zrng = np.random.RandomState(1)
    zipf = [(d, [zipf_ids(zrng, len(x), r).astype(np.int64)
                 for x, r in zip(ids, MLPERF_DLRM_V2_ROWS)])
            for d, ids in uniform]
    # one batch of the server's padded size: warms both serving modules
    # (cuBLAS handles, the kernels' first launch) before any timed
    # request, then is profiled after the server runs
    served = next(iter(RandomRecDataset(
        features, SERVING_BATCH, MLPERF_DLRM_V2_ROWS, caps,
        num_dense=NUM_DENSE, manual_seed=2, num_batches=1))).to(dev)
    for fn in fns.values():
        fn(served.dense_features, served.sparse_features)
    torch.cuda.synchronize()
    path = path_kernel_phase(dev, tables, params, served.sparse_features,
                             zipf_seed=3)
    sync_check(fns, served)
    quant_registry_check(tables, params, served)
    main_launches = dict.fromkeys(tbe.LAUNCHES, 0)
    runs = {}
    for kernel, requests, counter in (
        ("tbe", uniform, "quant_pooled_lookup_int8"),
        ("dedup", zipf, "dedup_quant_pooled_lookup"),
    ):
        server = InferenceServer(
            fns[kernel], features, caps, NUM_DENSE,
            max_batch_size=SERVING_BATCH, max_latency_us=2000,
            queue="python",
        )
        server.start()
        try:
            tbe.reset_launch_counts()
            scores, lat, wall = _serve(server, requests)
            counts = tbe.launch_counts()
        finally:
            server.stop()
        batches = server.metrics.snapshot()["serving/batch_size"].count
        errors = server.metrics.snapshot().get(
            "serving/executor_error_count", 0)
        for k, v in counts.items():
            main_launches[k] += v
        others = sum(v for k, v in counts.items() if k != counter)
        # the same requests as one formed batch, straight through the
        # serving module: the reference for what the server answered
        kjt, dense = _direct_batch(requests, features, caps, dev)
        direct = fns[kernel](dense, kjt).double().cpu().numpy()
        rec = {
            "phase": "serving", "kernel": kernel, "requests": len(requests),
            "clients": NUM_CLIENTS, "batches": batches,
            "executor_errors": errors, "launches": counts,
            "all_finite": bool(np.isfinite(scores).all()),
            "max_abs_diff_vs_direct": float(np.abs(scores - direct).max()),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "requests_per_s": len(requests) / wall,
        }
        emit(rec)
        if not rec["all_finite"] or errors:
            raise AssertionError(f"serving with {kernel}: non-finite scores "
                                 f"or {errors} executor errors")
        # one grouped launch per batch and group, and no other kernel
        groups = fns[kernel].quant_ebc.num_groups
        if counts[counter] != groups * batches or others:
            raise AssertionError(
                f"serving with {kernel}: {counts} launches for {batches} "
                f"batches of {groups} group(s)"
            )
        if not np.allclose(scores, direct, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"serving with {kernel}: served scores "
                                 "differ from the direct batch")
        runs[kernel] = rec

    # serving_fn alone on formed batches of the bench's size
    ds = RandomRecDataset(features, BENCH_BATCH, MLPERF_DLRM_V2_ROWS, caps,
                          num_dense=NUM_DENSE, manual_seed=1, num_batches=1)
    batch = next(iter(ds)).to(dev)
    outs = {}
    for kernel, fn in fns.items():
        def step():
            return fn(batch.dense_features, batch.sparse_features)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        outs[kernel] = out
        emit({"phase": "serving_fn", "kernel": kernel, "batch": BENCH_BATCH,
              "ms_per_batch": ms, "samples_per_s": BENCH_BATCH / ms * 1e3,
              "all_finite": bool(torch.isfinite(out).all())})
    if not torch.equal(outs["tbe"], outs["dedup"]):
        raise AssertionError("tbe and dedup serving differ on one batch")
    for kernel, fn in fns.items():
        profile_serving(kernel, fn, served)
    del outs
    grouped = grouped_phase(dev, tables, params,
                            [served.sparse_features, batch.sparse_features],
                            zipf_seed=4)
    del fns, params
    torch.cuda.empty_cache()
    return main_launches, runs, path + grouped


# ---------------------------------------------------------------------------
# phase 8: artifact round trip, card against CPU
# ---------------------------------------------------------------------------


def roundtrip_phase(dev):
    import torch

    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        mlperf_dlrm_v2_tables,
    )
    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.inference import load_packaged_model, package_model
    from torchrec_tpu_torch.models.dlrm import DLRM

    import dataclasses

    tables = tuple(dataclasses.replace(c, num_embeddings=ROUNDTRIP_ROWS)
                   for c in mlperf_dlrm_v2_tables(DIM))
    rng = np.random.RandomState(0)
    weights = {c.name: (rng.randn(ROUNDTRIP_ROWS, DIM) * 0.05)
               .astype(np.float32) for c in tables}
    torch.manual_seed(1)
    model = DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH)
    features = list(DEFAULT_CAT_NAMES)
    caps = list(MLPERF_DLRM_V2_MULTI_HOT)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "artifact")
        package_model(
            path, tables, weights, dict(zip(features, caps)), NUM_DENSE,
            quant_dtype="int8", dense_state_dict=model.state_dict(),
            model_config={"arch": "dlrm",
                          "dense_arch_layer_sizes": list(DENSE_ARCH),
                          "over_arch_layer_sizes": list(OVER_ARCH)},
        )
        fn_gpu, _ = load_packaged_model(path, device=dev)
        fn_cpu, _ = load_packaged_model(path, device="cpu")
    ds = RandomRecDataset(features, 256, [ROUNDTRIP_ROWS] * len(features),
                          caps, num_dense=NUM_DENSE, manual_seed=2,
                          num_batches=1)
    batch = next(iter(ds))
    gpu = fn_gpu(batch.dense_features.to(dev),
                 batch.sparse_features.to(dev)).cpu().numpy()
    cpu = fn_cpu(batch.dense_features, batch.sparse_features).numpy()
    ok = bool(np.allclose(gpu, cpu, rtol=1e-4, atol=1e-5))
    rec = {"phase": "roundtrip", "examples": 256, "rows_per_table":
           ROUNDTRIP_ROWS, "max_abs_diff": float(np.abs(gpu - cpu).max()),
           "all_finite": bool(np.isfinite(gpu).all()), "within_tol": ok}
    emit(rec)
    if not ok or not rec["all_finite"]:
        raise AssertionError("card and CPU scores of one artifact differ")


# ---------------------------------------------------------------------------
# phase 12: the serving tier — the native queue, the TCP and HTTP front
# ends, bucketed dedup programs, the replica mesh, and the FP16/BF16
# serving tables
# ---------------------------------------------------------------------------

SERVING_TIER_BUDGET_S = 120
# the bucketed programs of the tier: the train pipeline's ladder
TIER_BUCKETS = {"batch_floor": 8, "id_floor": 8, "max_programs": 8}
# requests answered before the mesh's second replica is killed
MESH_KILL_AFTER = 128
# the capped FP16/BF16 tables (the train_dcn cap: 29,184,588 rows in all),
# where a float32 copy fits beside them for the kernel-over-float check
TIER_ROW_CAP = 5_000_000
# the BF16 serving run may hold no more than its tables plus this much
# above what was allocated before them
TIER_PEAK_SLACK = 2**30
# what may stay allocated when the int8 tables (27.8 GB) are freed: about
# twice the 156 MB measured on an H100 80GB HBM3 at 700 W
TIER_INT8_LEFT = 2**29
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)  # served vs one direct batch
FLOAT_KERNELS = ("tbe", "dedup")  # the float groups' lookup kernels


def _serve_calls(calls, requests, between=None):
    """``requests`` from ``len(calls)`` client threads, thread ``k``
    through ``calls[k]`` (its own connection); ``between(done)`` runs on
    the thread that completes request number ``done``.  Returns (scores,
    per-request latencies in ms, wall seconds); raises if a request
    failed."""
    scores = np.full((len(requests),), np.nan, np.float64)
    lat = np.zeros((len(requests),), np.float64)
    errors, done, lock = [], [0], threading.Lock()

    def client(k):
        try:
            for i in range(k, len(requests), len(calls)):
                t0 = time.perf_counter()
                scores[i] = calls[k](*requests[i])
                lat[i] = (time.perf_counter() - t0) * 1e3
                with lock:
                    done[0] += 1
                    n = done[0]
                if between is not None:
                    between(n)
        except Exception as e:  # reported below, after every join
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(len(calls))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors:
        raise RuntimeError(f"serving clients failed: {errors[:3]}")
    return scores, lat, wall


class _HttpClient:
    """A keep-alive HTTP client of ``HttpInferenceServer``: ``predict``
    POSTs one request to ``/predict``; ``close`` ends the connection (and
    so the server's handler thread, which holds the serving module)."""

    def __init__(self, port, features):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        self.features = features

    def predict(self, dense, ids):
        body = json.dumps({"float_features": np.asarray(dense).tolist(),
                           "id_list_features": {
                               f: np.asarray(x).tolist()
                               for f, x in zip(self.features, ids)}})
        self.conn.request("POST", "/predict", body,
                          {"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        out = json.loads(resp.read())
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {out}")
        return out["score"]

    def close(self):
        self.conn.close()


def _formed_batch(requests, n):
    """The first ``n`` requests as the queue forms them: (n, dense, flat
    request-major ids, lengths [n, F])."""
    part = requests[:n]
    lengths = np.asarray([[len(x) for x in ids] for _, ids in part],
                         np.int32)
    flat = np.concatenate([np.asarray(x, np.int64) for _, ids in part
                           for x in ids])
    return n, np.stack([d for d, _ in part]), flat, lengths


def _tier_record(front, scores, lat, wall, direct, launches, batches,
                 idle, **extra):
    """One front end's record (emitted by the caller once complete);
    raises if a score is not finite or differs from the direct batch's
    beyond ``SCORE_TOL``."""
    rec = {"phase": "serving_tier", "front_end": front,
           "requests": len(scores), "batches": batches,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "requests_per_s": len(scores) / wall,
           "idle_share_of_one_batch": idle,
           "launches": {k: v for k, v in launches.items() if v},
           "all_finite": bool(np.isfinite(scores).all()),
           "max_abs_diff_vs_direct": float(np.abs(scores - direct).max()),
           "within_tol": bool(np.allclose(scores, direct, **SCORE_TOL)),
           **extra}
    if not (rec["all_finite"] and rec["within_tol"]):
        raise AssertionError(f"serving tier {front}: scores differ from the "
                             f"direct batch ({rec['max_abs_diff_vs_direct']})")
    return rec


def _idle_share(record, call):
    """The device idle share of one formed batch through ``call`` (an
    executor's ``_run_batch``): :func:`profile_calls`' record."""
    rec = profile_calls(record, call, 5, "batch")
    return rec["device_idle_share"], rec


def _check_metrics_text(text):
    """Parse Prometheus text: every sample line ``name[{labels}] value``;
    returns {name: value} of the unlabelled samples."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        float(value)  # raises on a malformed value
        if "{" not in name:
            out[name] = float(value)
    if not out:
        raise AssertionError("/metrics returned no sample")
    return out


def _float_tables(dev, tables, dtype, seed, row_cap=None):
    """16-bit serving tables drawn on the device in their own dtype (no
    float32 temporary): rows N(0, 0.02), scale ones, bias zeros."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {}
    for cfg in tables:
        R = cfg.num_embeddings if row_cap is None else min(
            cfg.num_embeddings, row_cap)
        q = torch.empty((R, cfg.embedding_dim), dtype=dtype, device=dev)
        q.normal_(0.0, 0.02, generator=gen)
        params[cfg.name] = {
            "q": q, "scale": torch.ones(R, device=dev),
            "bias": torch.zeros(R, device=dev)}
    return params


def _float_features(params, tables, keys):
    """The grouped float lookup's features of ``tables`` (in order, their
    columns side by side) over the tables in ``params``."""
    from torchrec_tpu_torch.ops import tbe

    feats, col = [], 0
    for c in tables:
        feats.append(tbe.FloatFeature(params[c.name]["q"],
                                      keys.index(c.feature_names[0]), col))
        col += c.embedding_dim
    return feats


def _float_library(kjt, stack, starts, feats):
    """One ``F.embedding_bag`` computing the grouped float lookup of
    ``feats`` (SUM, no weights, as the served batch) over their float32
    tables stacked in one ``[sum R, D]`` tensor (table ``i`` from row
    ``starts[i]``): each valid slot's id shifted to its table's first
    row, one bag a (key, example) segment.  Returns (the call, a map of
    its ``[K * B, D]`` output onto the lookup's ``[B, W]`` columns)."""
    import torch
    import torch.nn.functional as F

    if any(f.mean for f in feats):
        raise ValueError("the library call pools by SUM only")
    B, K = kjt.stride(), len(kjt.keys())
    seg = kjt.segment_ids().to(torch.int64)
    vseg = seg[seg < kjt.total_stride]
    base = torch.zeros(K, dtype=torch.int64)
    for f, start in zip(feats, starts):
        base[f.key] = start
    ids = (kjt.values().to(torch.int64)[seg < kjt.total_stride]
           + base.to(seg.device)[vseg // B])
    offs = torch.cat([vseg.new_zeros(1), torch.cumsum(
        torch.bincount(vseg, minlength=K * B), 0)])

    def call():
        return F.embedding_bag(ids, stack, offs, mode="sum",
                               include_last_offset=True)

    def layout(out):
        y = out.view(K, B, -1)
        return torch.cat([y[f.key] for f in sorted(feats,
                                                   key=lambda f: f.col)], 1)

    return call, layout


def _float_full_check(dtype, feats, kjt):
    """The grouped float lookup of one served batch at its own ids over
    the full-row 16-bit tables, through B1 and B4, ``torch.equal`` to the
    plain versions (which gather only the batch's rows, so no float32
    copy of a table is made).  Requires rows read past element 2^32 of a
    table, where 32-bit element offsets would wrap.  Emits and returns
    the record."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    B, W = kjt.stride(), sum(f.table.shape[1] for f in feats)
    D = feats[0].table.shape[1]
    args = (kjt.values(), kjt.lengths(), kjt.cap_offsets())
    seg = kjt.segment_ids().to(torch.int64)
    valid = seg < kjt.total_stride
    far_ids = valid & (kjt.values().to(torch.int64) * D >= 2**32)
    far = sum(int((far_ids & (seg // B == f.key)).sum()) for f in feats)
    rec = {"phase": "serving_float_full",
           "table_dtype": str(dtype).replace("torch.", ""),
           "out_dtype": "float32", "batch": B, "features": len(feats),
           "rows": sum(f.table.shape[0] for f in feats),
           "max_rows": max(f.table.shape[0] for f in feats),
           "slots": int(valid.sum()), "slots_past_element_2_32": far}
    for kernel in FLOAT_KERNELS:
        out = torch.empty((B, W), device=kjt.values().device)
        got = tbe.float_pooled_lookup_grouped(*args, feats, out.clone(),
                                              kernel)
        torch.cuda.synchronize()
        plain = tbe.float_pooled_lookup_grouped_plain(*args, feats,
                                                      out.clone(), kernel)
        rec[f"{kernel}_equal"] = bool(torch.equal(got, plain))
        rec[f"{kernel}_max_abs_err"] = float((got - plain).abs().max())
    emit(rec)
    if not all(rec[f"{k}_equal"] for k in FLOAT_KERNELS) or far == 0:
        raise AssertionError(f"full-row {dtype} tables: kernel != plain, or "
                             f"no row read past element 2^32 ({far})")
    return rec


def _float_group_row(dev, flush, dtype, kernel, feats, kjt, f32_feats,
                     library):
    """The grouped float lookup of one served batch (one launch a
    feature) against its plain version and against the float32 tables'
    lookup (``torch.equal``), with its times, the time of ``library`` (a
    :func:`_float_library` pair) and the bound: each distinct (feature,
    row) read once in 16 bits, each valid id (int64) and length once, the
    float32 output written once; 2 flops per valid id and column."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    B, W = kjt.stride(), sum(f.table.shape[1] for f in feats)
    args = (kjt.values(), kjt.lengths(), kjt.cap_offsets())
    out = torch.empty((B, W), device=dev)
    got = tbe.float_pooled_lookup_grouped(*args, feats, out.clone(), kernel)
    torch.cuda.synchronize()
    plain = tbe.float_pooled_lookup_grouped_plain(*args, feats, out.clone(),
                                                  kernel)
    over = tbe.float_pooled_lookup_grouped(*args, f32_feats, out.clone(),
                                           kernel)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max()) if got.numel() else 0.0
    if not (torch.equal(got, plain) and torch.equal(got, over)):
        raise AssertionError(
            f"grouped float {kernel} {dtype}: kernel != plain or != the "
            f"float32 tables' lookup (max abs err {err})")
    seg = kjt.segment_ids().to(torch.int64)
    valid = seg < kjt.total_stride
    n = int(valid.sum())
    D = feats[0].table.shape[1]
    keys = (seg // B) * (1 << 32) + kjt.values().to(torch.int64)
    U = int(torch.unique(keys[valid]).numel())
    esize = feats[0].table.element_size()
    nbytes = U * D * esize + n * 8 + kjt.lengths().numel() * 4 + B * W * 4
    flops = 2 * n * D
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    name = "pooled_lookup" if kernel == "tbe" else "dedup_pooled_lookup"
    call = lambda: tbe.float_pooled_lookup_grouped(  # noqa: E731
        *args, feats, out, kernel)
    rec = {
        "phase": "serving_float_kernel", "kernel": name,
        "table_dtype": str(dtype).replace("torch.", ""),
        "out_dtype": "float32", "batch": B, "features": len(feats),
        "launches_per_call": len(feats), "slots": n, "distinct": U,
        "equal": True, "equal_over_float32": True, "max_abs_err": err,
        "ms": cuda_ms(call, flush),
        "kernel_device_ms": cuda_ms(call, flush, device_only=True),
        "plain_ms": cuda_ms(lambda: tbe.float_pooled_lookup_grouped_plain(
            *args, feats, out, kernel), flush, runs=PLAIN_RUNS, warmup=1),
        "float32_tables_ms": cuda_ms(lambda: tbe.float_pooled_lookup_grouped(
            *args, f32_feats, out, kernel), flush),
        "library_ms": cuda_ms(library[0], flush),
        "library_device_ms": cuda_ms(library[0], flush, device_only=True),
        "library_max_abs_diff": float(
            (library[1](library[0]()) - got).abs().max()),
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
    }
    # the card's busy time of one call from a profile: the host takes
    # longer to enqueue the call's launches than kernel_device_ms's spin
    # hides, so that figure has host time in it
    prof = profile_calls({"phase": "serving_float_profile", "kernel": name,
                          "table_dtype": rec["table_dtype"], "batch": B},
                         call, 5, "call")
    rec["card_ms_profiled"] = prof.get("device_busy_ms_per_call")
    rec["device_events_per_call"] = prof.get("device_events_per_call")
    emit(rec)
    return rec


def serving_tier_phase(dev):
    """The serving tier on the card (budget ``SERVING_TIER_BUDGET_S``):
    int8 MLPerf DLRM-v2 tables behind the python queue, the native queue,
    the TCP front end (8 connections), a bucketed dedup server behind
    HTTP, and a two-replica mesh; then BF16 tables at the full row counts
    (52.3 GB: B1 pools them in place into float32); then FP16 and BF16 at
    the 5,000,000-row cap, where B1 and B4 are held to their plain
    versions and to the float32 tables' lookup.  Returns (the launch
    counts of its main paths, its kernel rows)."""
    import torch

    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        MLPERF_DLRM_V2_ROWS,
        mlperf_dlrm_v2_tables,
    )
    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.inference import (
        BucketedInferenceServer,
        HttpInferenceServer,
        InferenceServer,
        NetworkInferenceServer,
        PredictClient,
        ReplicaRouter,
        ServingBucketConfig,
        build_serving_fn,
    )
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import DataType
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    features = list(DEFAULT_CAT_NAMES)
    caps = list(MLPERF_DLRM_V2_MULTI_HOT)
    base = mlperf_dlrm_v2_tables(DIM)
    tables = tuple(dataclasses.replace(c, data_type=DataType.INT8)
                   for c in base)
    params = _random_int8_tables(dev, tables, seed=0)
    torch.manual_seed(0)
    model = DLRM(meta_ebc(base), NUM_DENSE, DENSE_ARCH, OVER_ARCH)
    fn = build_serving_fn(model, QuantEmbeddingBagCollection(
        tables, params, "tbe"), device=dev)
    requests = _requests(next(iter(RandomRecDataset(
        features, NUM_REQUESTS, MLPERF_DLRM_V2_ROWS, caps,
        num_dense=NUM_DENSE, manual_seed=0, num_batches=1))), len(features))
    kjt, dense = _direct_batch(requests, features, caps, dev)
    direct = fn(dense, kjt).double().cpu().numpy()
    served = _formed_batch(requests, SERVING_BATCH)
    main = dict.fromkeys(tbe.LAUNCHES, 0)
    kw = dict(max_batch_size=SERVING_BATCH, max_latency_us=2000)
    recs = {}

    def run(front, servers, calls, between=None):
        """Serve ``requests`` through ``calls`` with every launch count
        set to 0 just before; the record of the run, with the batches
        ``servers`` formed and the counts read just after."""
        def total_batches():
            batches = 0
            for srv in servers:
                snap = srv.metrics.snapshot()
                if snap.get("serving/executor_error_count", 0):
                    raise AssertionError(f"serving tier {front}: executor "
                                         "errors")
                if "serving/batch_size" in snap:
                    batches += snap["serving/batch_size"].count
            return batches

        batches0 = total_batches()
        tbe.reset_launch_counts()
        scores, lat, wall = _serve_calls(calls, requests, between)
        counts = tbe.launch_counts()
        for k, v in counts.items():
            main[k] += v
        rec = _tier_record(front, scores, lat, wall, direct, counts,
                           total_batches() - batches0, None, nvidia_smi=smi)
        recs[front] = (rec, scores, counts)
        return rec

    # one formed batch through the full-pad program, profiled: it also
    # warms the program at the served shape before any timed request
    warm = InferenceServer(fn, features, caps, NUM_DENSE, queue="python",
                           **kw)
    full_idle, _ = _idle_share(
        {"phase": "serving_tier_profile", "server": "full_pad_int8_tbe",
         "batch": SERVING_BATCH}, lambda: warm._run_batch(*served))
    # python queue, native queue (in process), native TCP: the full-pad
    # int8 program, B3 once a batch
    for front, queue in (("python_queue", "python"),
                         ("native_queue", "native")):
        srv = InferenceServer(fn, features, caps, NUM_DENSE, queue=queue,
                              **kw)
        srv.start()
        try:
            run(front, [srv], [srv.predict] * NUM_CLIENTS)
        finally:
            srv.stop()
    srv = NetworkInferenceServer(fn, features, caps, NUM_DENSE, **kw)
    port = srv.serve()
    clients = [PredictClient(port) for _ in range(NUM_CLIENTS)]
    try:
        run("tcp", [srv], [c.predict for c in clients])
    finally:
        for c in clients:
            c.close()
        srv.stop()
    for front in ("python_queue", "native_queue", "tcp"):
        rec, _, counts = recs[front]
        rec["idle_share_of_one_batch"] = full_idle
        others = sum(v for k, v in counts.items()
                     if k != "quant_pooled_lookup_int8")
        if counts["quant_pooled_lookup_int8"] != rec["batches"] or others:
            raise AssertionError(f"serving tier {front}: {counts} launches "
                                 f"for {rec['batches']} batches")

    # bucketed dedup programs behind HTTP (two executors), B5 once a batch
    cfg = ServingBucketConfig(**TIER_BUCKETS)
    bsrv = BucketedInferenceServer(fn, features, caps, NUM_DENSE,
                                   bucket_config=cfg, dedup=True, **kw)
    bsrv.warmup()
    http = HttpInferenceServer(bsrv)
    hport = http.serve(num_executors=2)
    hclients = [_HttpClient(hport, features) for _ in range(NUM_CLIENTS)]
    try:
        # an untimed pass in process runs each signature the stream needs
        # once (first launches at its shapes)
        _, cold, _ = _serve_calls([bsrv.predict] * NUM_CLIENTS, requests)
        run("http_bucketed", [bsrv], [c.predict for c in hclients])
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{hport}/metrics", timeout=60) as r:
            samples = _check_metrics_text(r.read().decode())
    finally:
        for c in hclients:
            c.close()
        http.stop()
    rec, _, counts = recs["http_bucketed"]
    programs = bsrv.cache.program_count
    rec.update(program_count=programs, max_programs=cfg.max_programs,
               cold_pass_p50_ms=float(np.percentile(cold, 50)),
               cold_pass_p99_ms=float(np.percentile(cold, 99)),
               metrics_samples=len(samples),
               signatures=sorted(str(s) for s in bsrv.cache._programs))
    others = sum(v for k, v in counts.items()
                 if k != "dedup_quant_pooled_lookup")
    if counts["dedup_quant_pooled_lookup"] != rec["batches"] or others:
        raise AssertionError(f"bucketed HTTP: {counts} launches for "
                             f"{rec['batches']} batches")
    if programs > cfg.max_programs or samples.get(
            "serving_program_count") != programs:
        raise AssertionError(f"bucketed HTTP: {programs} programs, /metrics "
                             f"says {samples.get('serving_program_count')}")
    # each program's pooled KeyedTensor equal to the full-pad program's
    full = InferenceServer(fn, features, caps, NUM_DENSE, queue="python",
                           **kw)
    bitwise = []
    sizes = (1, 7, SERVING_BATCH // 4, SERVING_BATCH)
    for n in sizes:
        n, d, ids, lengths = _formed_batch(requests, n)
        sig = bsrv.cache.resolve(bsrv.cache.signature(n, lengths.sum(0)))
        bd, bkjt = bsrv._device_inputs(n, d, ids, lengths, sig[0],
                                       list(sig[1]))
        fd, fkjt = full._device_inputs(n, d, ids, lengths, SERVING_BATCH,
                                       [c * SERVING_BATCH for c in caps])
        with torch.inference_mode():
            bkt = bsrv.cache.fn.quant_ebc(bkjt).values()[:n]
            fkt = fn.quant_ebc(fkjt).values()[:n]
            bs, fs = bsrv.cache.run(sig, bd, bkjt)[:n], fn(fd, fkjt)[:n]
        if not torch.equal(bkt, fkt):
            raise AssertionError(f"bucketed program {sig}: pooled KT != "
                                 "the full-pad program's")
        if not torch.allclose(bs, fs, **SCORE_TOL):
            raise AssertionError(f"bucketed program {sig}: scores differ")
        bitwise.append(bool(torch.equal(bs, fs)))
    rec["program_checks"] = {"batches": list(sizes),
                             "pooled_equal": True,
                             "scores_bitwise": bitwise}
    bucket_idle, prof = _idle_share(
        {"phase": "serving_tier_profile", "server": "bucketed_int8_dedup",
         "batch": SERVING_BATCH}, lambda: bsrv._run_batch(*served))
    rec["idle_share_of_one_batch"] = bucket_idle
    names = prof["device_names"]
    pooled = {w for k, w in POOLED_KERNEL_NAMES.items()
              if any(k in x for x in names)}
    if pooled != {"dedup_quant_pooled_lookup"}:
        raise AssertionError(f"bucketed batch profiled {pooled}")

    # the mesh: two bucketed replicas sharing one serving module, replica
    # r1 killed after MESH_KILL_AFTER answers
    reps = {f"r{i}": BucketedInferenceServer(
        fn, features, caps, NUM_DENSE, bucket_config=cfg, dedup=True, **kw)
        for i in range(2)}
    for replica in reps.values():
        replica.warmup()
        replica.start()
        _serve_calls([replica.predict] * NUM_CLIENTS, requests)  # untimed
    router = ReplicaRouter(reps, hedge=True, hedge_warmup=32,
                           probe_interval_s=0.01, deadline_us=30_000_000)
    router.start_probes()
    degraded = []

    def mesh_call(d, ids):
        score, deg, reason = router.predict_ex(d, ids)
        if deg:
            degraded.append(reason)
        return score

    def killer(done):
        if done == MESH_KILL_AFTER:
            reps["r1"]._running = False
            reps["r1"]._queue.shutdown()  # a killed replica's queue

    try:
        run("mesh", list(reps.values()), [mesh_call] * NUM_CLIENTS,
            between=killer)
    finally:
        router.stop()
        for replica in reps.values():
            replica.stop()
    rec, mesh_scores, counts = recs["mesh"]
    m = router.metrics
    rec.update(
        degraded=len(degraded), killed_after=MESH_KILL_AFTER,
        routable=router.routable(),
        failovers=m.value("mesh/failover_count")
        if "mesh/failover_count" in m.names() else 0,
        hedges=m.value("mesh/hedge_count")
        if "mesh/hedge_count" in m.names() else 0,
        idle_share_of_one_batch=bucket_idle,
        max_abs_diff_vs_http=float(np.abs(
            mesh_scores - recs["http_bucketed"][1]).max()))
    if degraded or "r1" in rec["routable"]:
        raise AssertionError(f"mesh: {len(degraded)} degraded answers, "
                             f"routable {rec['routable']}")
    want = rec["batches"]
    if (counts["dedup_quant_pooled_lookup"] != want
            or sum(counts.values()) != want):
        raise AssertionError(f"mesh: {counts} launches for {want} batches")
    for front in ("python_queue", "native_queue", "tcp", "http_bucketed",
                  "mesh"):
        emit(recs[front][0])
    del fn, params, bsrv, reps, replica, router, full, warm, srv, http
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()  # before the BF16 tables
    if mem0 > TIER_INT8_LEFT:
        raise AssertionError(f"{mem0} bytes still allocated: the int8 "
                             "tables were not freed")

    # BF16 tables at the full MLPerf row counts, pooled in place
    kernel_rows = []
    bf16 = tuple(dataclasses.replace(c, data_type=DataType.BF16)
                 for c in base)
    t0 = time.perf_counter()
    params = _float_tables(dev, bf16, torch.bfloat16, seed=1)
    torch.cuda.synchronize()
    table_bytes = sum(p["q"].numel() * 2 + 8 * p["scale"].numel()
                      for p in params.values())
    qebc = QuantEmbeddingBagCollection(bf16, params)
    bfn = build_serving_fn(model, qebc, device=dev)
    batch = next(iter(RandomRecDataset(
        features, SERVING_BATCH, MLPERF_DLRM_V2_ROWS, caps,
        num_dense=NUM_DENSE, manual_seed=2, num_batches=1))).to(dev)
    bfn(batch.dense_features, batch.sparse_features)  # builds, warms
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    srv = InferenceServer(bfn, features, caps, NUM_DENSE, **kw)
    srv.start()
    try:
        tbe.reset_launch_counts()
        scores, lat, wall = _serve_calls([srv.predict] * NUM_CLIENTS,
                                         requests)
        counts = tbe.launch_counts()
    finally:
        srv.stop()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts.items():
        main[k] += v
    batches = srv.metrics.snapshot()["serving/batch_size"].count
    with torch.inference_mode():
        tbe.reset_launch_counts()
        qebc(batch.sparse_features)
        torch.cuda.synchronize()
        per_forward = tbe.launch_counts()["pooled_lookup"]
        main["pooled_lookup"] += per_forward
        prof = profile_calls(
            {"phase": "serving_tier_profile", "server": "bf16_collection",
             "batch": SERVING_BATCH},
            lambda: qebc(batch.sparse_features), 5, "batch")
    casts = [x for x in prof["device_names"] if "elementwise" in x
             or "copy" in x.lower()]
    tb1 = [x for x in prof["device_names"] if "tbe_pooled_kernel" in x]
    bf_rec = {
        "phase": "serving_tier", "front_end": "native_queue_bf16_tables",
        "requests": len(scores), "batches": batches,
        "table_rows": sum(MLPERF_DLRM_V2_ROWS), "table_bytes": table_bytes,
        "tables_seconds": time.perf_counter() - t0,
        "memory_before_tables": mem0, "memory_before": before,
        "peak_memory": peak, "peak_above_tables": peak - mem0 - table_bytes,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "requests_per_s": len(scores) / wall,
        "idle_share_of_one_batch": prof["device_idle_share"],
        "launches": {k: v for k, v in counts.items() if v},
        "b1_launches_per_forward": per_forward,
        "b1_events_per_forward": prof["device_events_per_batch"],
        "cast_kernels": casts, "all_finite": bool(np.isfinite(scores).all()),
        "nvidia_smi": smi}
    emit(bf_rec)
    if not bf_rec["all_finite"]:
        raise AssertionError("bf16 serving: non-finite scores")
    if (counts["pooled_lookup"] != len(features) * batches
            or per_forward != len(features)
            or sum(counts.values()) != counts["pooled_lookup"]):
        raise AssertionError(f"bf16 serving: {counts} launches for "
                             f"{batches} batches, {per_forward} a forward")
    if casts or not tb1:
        raise AssertionError(f"bf16 collection profiled {prof['device_names']}")
    if peak - mem0 > table_bytes + TIER_PEAK_SLACK:
        raise AssertionError(f"bf16 serving peaked {peak - mem0} bytes "
                             f"above the {mem0} allocated before its "
                             f"{table_bytes} bytes of tables")
    # the dedup view of the same tables: 26 B4 launches, the same bits
    with torch.inference_mode():
        tbe.reset_launch_counts()
        dkt = qebc.with_kernel("dedup")(batch.sparse_features).values()
        torch.cuda.synchronize()
        dcounts = tbe.launch_counts()
        for k, v in dcounts.items():
            main[k] += v
        if not torch.equal(dkt, qebc(batch.sparse_features).values()):
            raise AssertionError("bf16: dedup collection != tbe collection")
    if dcounts["dedup_pooled_lookup"] != len(features):
        raise AssertionError(f"bf16 dedup collection launched {dcounts}")
    # B1 and B4 against their plain versions over the full-row tables at
    # the batch's own ids: these BF16 tables, then FP16 ones
    keys = list(batch.sparse_features.keys())
    full_checks = [_float_full_check(torch.bfloat16, _float_features(
        params, bf16, keys), batch.sparse_features)]
    del qebc, bfn, params, dkt, srv
    gc.collect()
    torch.cuda.empty_cache()
    fp16 = tuple(dataclasses.replace(c, data_type=DataType.FP16)
                 for c in base)
    params = _float_tables(dev, fp16, torch.float16, seed=1)
    full_checks.append(_float_full_check(torch.float16, _float_features(
        params, fp16, keys), batch.sparse_features))
    del params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # FP16 and BF16 at the row cap: B1 and B4 against their plain versions
    # and against the float32 tables' lookup, the dedup program = the tbe
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    # the served batch's ids folded into the capped rows
    values = batch.sparse_features.values().clone()
    offs = batch.sparse_features.cap_offsets()
    for c in base:
        k = keys.index(c.feature_names[0])
        values[offs[k]:offs[k + 1]] %= min(c.num_embeddings, TIER_ROW_CAP)
    kjt = batch.sparse_features.with_values(values)
    for dtype, dt in ((torch.float16, DataType.FP16),
                      (torch.bfloat16, DataType.BF16)):
        cap_tables = tuple(dataclasses.replace(
            c, data_type=dt, num_embeddings=min(c.num_embeddings,
                                                TIER_ROW_CAP)) for c in base)
        params = _float_tables(dev, cap_tables, dtype, seed=3,
                               row_cap=TIER_ROW_CAP)
        feats = _float_features(params, cap_tables, keys)
        # the float32 copies, stacked in one tensor for the library call
        rows = [f.table.shape[0] for f in feats]
        starts = np.concatenate([[0], np.cumsum(rows)[:-1]]).tolist()
        stack = torch.empty((sum(rows), DIM), device=dev)
        f32 = []
        for f, start, R in zip(feats, starts, rows):
            stack[start:start + R].copy_(f.table)
            f32.append(f._replace(table=stack[start:start + R]))
        library = _float_library(kjt, stack, starts, f32)
        for kernel in FLOAT_KERNELS:
            kernel_rows.append(_float_group_row(dev, flush, dtype, kernel,
                                                feats, kjt, f32, library))
        del f32, stack, library
        torch.cuda.empty_cache()
        with torch.inference_mode():
            q_tbe = QuantEmbeddingBagCollection(cap_tables, params, "tbe")
            fn_tbe = build_serving_fn(model, q_tbe, device=dev)
            fn_dedup = fn_tbe.with_lookup_kernel("dedup")
            a = fn_tbe(batch.dense_features, kjt)
            b = fn_dedup(batch.dense_features, kjt)
            same_kt = torch.equal(q_tbe(kjt).values(),
                                  fn_dedup.quant_ebc(kjt).values())
        emit({"phase": "serving_tier_programs", "table_dtype":
              str(dtype).replace("torch.", ""), "rows": sum(
                  c.num_embeddings for c in cap_tables),
              "pooled_equal": same_kt, "scores_equal": bool(torch.equal(a, b)),
              "all_finite": bool(torch.isfinite(a).all())})
        if not same_kt or not torch.isfinite(a).all():
            raise AssertionError(f"{dtype}: the dedup program != the tbe one")
        del params, feats, q_tbe, fn_tbe, fn_dedup
        torch.cuda.empty_cache()
    del flush
    seconds = time.perf_counter() - t_phase
    emit({"phase": "serving_tier_done", "seconds": seconds,
          "budget_s": SERVING_TIER_BUDGET_S, "full_row_checks": [
              {k: r[k] for k in ("table_dtype", "tbe_equal", "dedup_equal",
                                 "slots_past_element_2_32")}
              for r in full_checks],
          "launches": {k: v for k, v in main.items() if v}})
    if seconds > SERVING_TIER_BUDGET_S:
        raise AssertionError(f"serving tier took {seconds:.1f} s, over its "
                             f"{SERVING_TIER_BUDGET_S} s budget")
    return main, kernel_rows, recs["tcp"][0]


# ---------------------------------------------------------------------------
# phase 13: serving with no Python in the request path — export_native's
# AOTInductor package on the card, the trt:: operators inside it, the C++
# executor loop on the native queue behind the C++ TCP front end
# ---------------------------------------------------------------------------

NATIVE_SERVING_BUDGET_S = 360
NATIVE_ROW_CAP = 100_000  # every arm's tables (the run's time limit)
# (quant dtype, lookup kernel, row cap, one group's operators (B1 and B4:
# one call a feature)); every arm's package serves SERVING_BATCH
NATIVE_ARMS = (
    ("int8", None, NATIVE_ROW_CAP, ("q8_pooled",)),
    ("int4", None, NATIVE_ROW_CAP,
     ("dedup_q_keys", "dedup_q_gather", "dedup_q_pool")),
    ("bf16", "tbe", NATIVE_ROW_CAP, ("tbe_pooled",)),
    ("bf16", "dedup", NATIVE_ROW_CAP, ("dedup_pooled",)),
)
NATIVE_PACKAGE_LIMIT = 64 * 2**20  # a package this small holds no table
NATIVE_PEAK_SLACK = 2**30  # the native server's peak above its constants
# each operator's launches as the kernel summary's wrapper counts them (B5's
# three launches are one grouped lookup)
NATIVE_OP_KERNELS = {"q8_pooled": "quant_pooled_lookup_int8",
                     "dedup_q_pool": "dedup_quant_pooled_lookup",
                     "tbe_pooled": "pooled_lookup",
                     "dedup_pooled": "dedup_pooled_lookup"}


def _flat_batch(requests, caps, B):
    """``requests`` as the native executor loop lays them out for the
    package (``csrc/host/aoti_executor.cpp``): dense [B, num_dense] f32
    zero-padded, values [sum(caps) * B] i32 with feature f's ids
    front-packed in request order at ``sum(caps[:f]) * B``, lengths
    [F * B] i32 feature-major."""
    F = len(caps)
    dense = np.zeros((B, len(requests[0][0])), np.float32)
    values = np.zeros((sum(caps) * B,), np.int32)
    lengths = np.zeros((F * B,), np.int32)
    starts = np.concatenate([[0], np.cumsum(caps)[:-1]]) * B
    for i, (d, ids) in enumerate(requests):
        dense[i] = d
        for f, x in enumerate(ids):
            values[starts[f]:starts[f] + len(x)] = x
            starts[f] += len(x)
            lengths[f * B + i] = len(x)
    return dense, values, lengths


def _table_readers(ep):
    """The nodes of an exported program that read a lookup table (a
    ``.q`` buffer) and are not a ``trt::`` operator: a plain version's
    gather."""
    tables = {spec.arg.name for spec in ep.graph_signature.input_specs
              if spec.target and spec.target.endswith(".q")}
    out = []
    for node in ep.graph.nodes:
        if node.op == "placeholder" and node.name in tables:
            out += [str(u.target) for u in node.users
                    if getattr(u.target, "namespace", None) != "trt"]
    return out


def _wrapper_copies(package):
    """The AOTInductor package's run: the buffers its mutating ``trt::``
    operators write (their ``out``, the KeyedTensor's) and the lines of
    the generated wrapper that copy or clone one of them."""
    import re
    import zipfile

    with zipfile.ZipFile(package) as z:
        names = z.namelist()
        nodes = json.loads(z.read(next(
            n for n in names if n.endswith(".wrapper.json"))))["nodes"]
        src = z.read(next(n for n in names
                          if n.endswith(".wrapper.cpp"))).decode()
    written = sorted({a["arg"]["as_tensor"]["name"]
                      for n in nodes if n["node"]["target"].startswith("trt::")
                      for a in n["node"]["inputs"] if a["name"] == "out"})
    pattern = re.compile(r"(copy_|clone)\w*\(\s*(" + "|".join(written)
                         + r")\b")
    copies = ([line.strip()[:160] for line in src.splitlines()
               if pattern.search(line)] if written else [])
    return written, copies


def _native_op_checks(qebc, kjt):
    """Each group of the collection through its ``trt::`` operators (the
    eager wrapper on the card) against its plain version on ``kjt``'s ids:
    ``torch.equal`` of the pooled columns."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.quant.embedding_modules import (
        _BITS,
        FLOAT_TABLE_DTYPES,
    )

    keys = {k: i for i, k in enumerate(kjt.keys())}
    offs, B = kjt.cap_offsets(), kjt.stride()
    W = sum(qebc._out_dims)
    v, l = kjt.values(), kjt.lengths()
    rows = []
    for data_type, kernel, members in qebc._groups:
        got = torch.zeros((B, W), device=v.device)
        ref = torch.zeros_like(got)
        if data_type in FLOAT_TABLE_DTYPES:
            feats = [tbe.FloatFeature(qebc.params[t].q, keys[f], col, mean)
                     for t, f, col, mean in members]
            tbe.float_pooled_lookup_grouped(v, l, offs, feats, got, kernel)
            tbe.float_pooled_lookup_grouped_plain(v, l, offs, feats, ref,
                                                  kernel)
        else:
            feats = [tbe.GroupFeature(qebc.params[t].q, qebc.params[t].scale,
                                      qebc.params[t].bias, keys[f], col, mean)
                     for t, f, col, mean in members]
            if kernel == "tbe":
                tbe.quant_pooled_lookup_int8_grouped(v, l, offs, feats, got)
                tbe.quant_pooled_lookup_int8_grouped_plain(v, l, offs, feats,
                                                           ref)
            else:
                bits = _BITS[data_type]
                tbe.dedup_quant_pooled_lookup_grouped(v, l, offs, feats, got,
                                                      bits)
                tbe.dedup_quant_pooled_lookup_grouped_plain(
                    v, l, offs, feats, ref, bits)
        rows.append({"data_type": data_type.name, "kernel": kernel,
                     "features": len(members),
                     "equal": bool(torch.equal(got, ref)),
                     "max_abs_err": float((got - ref).abs().max())})
    return rows


def _native_tables(row_cap):
    """The serving DLRM's tables, each at most ``row_cap`` rows."""
    from torchrec_tpu_torch.datasets.criteo import mlperf_dlrm_v2_tables

    return tuple(dataclasses.replace(
        c, num_embeddings=min(c.num_embeddings, row_cap))
        for c in mlperf_dlrm_v2_tables(DIM))


def _native_arm_name(quant, kernel):
    return f"{quant}" + (f"_{kernel}" if kernel else "")


def native_package_arm(dev, path, quant, kernel, row_cap, model_sd):
    """Package and export one arm of :data:`NATIVE_ARMS` into ``path``:
    its tables' float rows N(0, 0.05^2) drawn on the card from seed 0 and
    quantized there by ``package_model`` (the artifact's tables are what
    it writes), then ``export_native`` (``model.pt2`` and the
    AOTInductor package).  Returns each step's seconds."""
    import torch

    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
    )
    from torchrec_tpu_torch.inference import export_native, package_model

    features, caps = list(DEFAULT_CAT_NAMES), list(MLPERF_DLRM_V2_MULTI_HOT)
    tables = _native_tables(row_cap)
    seconds = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    weights = {c.name: torch.randn((c.num_embeddings, DIM), generator=gen,
                                   device=dev).mul_(0.05) for c in tables}
    t0 = time.perf_counter()
    package_model(path, tables, weights, dict(zip(features, caps)),
                  NUM_DENSE, quant_dtype=quant, dense_state_dict=model_sd,
                  model_config={"arch": "dlrm",
                                "dense_arch_layer_sizes": list(DENSE_ARCH),
                                "over_arch_layer_sizes": list(OVER_ARCH)})
    seconds["package"] = time.perf_counter() - t0
    del weights
    torch.cuda.empty_cache()
    mani = export_native(path, batch_size=SERVING_BATCH, device=dev,
                         lookup_kernel=kernel)
    seconds.update(mani["seconds"])
    torch.cuda.empty_cache()
    return seconds


def native_serving_arm(dev, path, quant, kernel, row_cap, ops, requests,
                       seconds, tcp):
    """One arm of :func:`native_serving_phase` over the artifact and
    package that :func:`native_package_arm` wrote into ``path`` (its
    steps' ``seconds``): check the exported graph and the package, serve
    ``requests`` through ``NativeInferenceServer`` over TCP, hold the
    scores to the eager module's and each operator to its plain version.
    Returns (its record, its kernels' launches while serving)."""
    import torch

    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
    )
    from torchrec_tpu_torch.inference import (
        NativeInferenceServer,
        PredictClient,
    )
    from torchrec_tpu_torch.ops import custom_ops, tbe
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    t_arm = time.perf_counter()
    features, caps = list(DEFAULT_CAT_NAMES), list(MLPERF_DLRM_V2_MULTI_HOT)
    B, F = SERVING_BATCH, len(features)
    tables = _native_tables(row_cap)
    name = _native_arm_name(quant, kernel)
    seconds = dict(seconds)
    # the exported graph: each group's trt:: operators, the tables read by
    # nothing else; the package: no table inside, no copy of the KT
    t0 = time.perf_counter()
    ep = torch.export.load(os.path.join(path, "model.pt2"))
    calls = custom_ops.trt_op_calls(ep.graph)
    plain_readers = _table_readers(ep)
    del ep
    seconds["load_pt2"] = time.perf_counter() - t0
    per_batch = {op: (F if op in ("tbe_pooled", "dedup_pooled") else 1)
                 for op in ops}
    package = os.path.join(path, "model_aoti.pt2")
    package_bytes = os.path.getsize(package)
    written, copies = _wrapper_copies(package)
    gc.collect()
    torch.cuda.empty_cache()

    # no Python in the request path: 8 TCP connections, closed loop
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = NativeInferenceServer(path, max_latency_us=2000)
    seconds["open"] = time.perf_counter() - t0
    constant_bytes = sum(t.numel() * t.element_size() for t in srv._constants)
    port = srv.serve()
    flat = _flat_batch(requests[:B], caps, B)
    srv.run(*flat)  # the first run at the served shape, untimed
    clients = [PredictClient(port) for _ in range(NUM_CLIENTS)]
    try:
        # an untimed pass of the stream: the loop's and each connection's
        # first batches
        _, cold, _ = _serve_calls([c.predict for c in clients], requests)
        custom_ops.reset_op_launch_counts()
        tbe.reset_launch_counts()
        stats0 = srv.loop_stats()
        scores, lat, wall = _serve_calls([c.predict for c in clients],
                                         requests)
        counts = custom_ops.op_launch_counts()
        python_counts = tbe.launch_counts()
        stats = srv.loop_stats()
    finally:
        for c in clients:
            c.close()
    batches = stats["batches"] - stats0["batches"]
    failed = stats["failed_batches"]
    peak = torch.cuda.max_memory_allocated() - base
    prof = profile_calls({"phase": "native_serving_profile", "arm": name,
                          "batch": B, "nvidia_smi": nvidia_smi_line()},
                         lambda: srv.run(*flat), 5, "batch")
    native_first = srv.run(*flat)
    kernels_seen = {op: any(f"{op}_kernel" in n for n in prof["device_names"])
                    for op in ops}

    # the eager module, the server's own (the same tables), on the same
    # batches; each operator vs its plain version at the first batch's ids
    module = srv._module
    direct = []
    for i in range(0, len(requests), B):
        d, v, l = (torch.from_numpy(x).to(dev)
                   for x in _flat_batch(requests[i:i + B], caps, B))
        direct.append(module(d, v, l).double().cpu().numpy()
                      [:len(requests[i:i + B])])
    direct = np.concatenate(direct)
    d, v, l = (torch.from_numpy(x).to(dev) for x in flat)
    eager_first = module(d, v, l).cpu().numpy()
    kjt = KeyedJaggedTensor(features, v, l, caps=[c * B for c in caps])
    op_rows = _native_op_checks(module.serving.quant_ebc, kjt)
    srv.stop()
    srv.stop()  # idempotent
    del srv, module, kjt, d, v, l
    gc.collect()
    torch.cuda.empty_cache()

    expected = {op: n * batches for op, n in per_batch.items()}
    rec = {"phase": "native_serving", "arm": name, "quant_dtype": quant,
           "lookup_kernel": kernel, "rows": sum(c.num_embeddings
                                                for c in tables),
           "row_cap": row_cap, "requests": len(requests),
           "batches": batches, "failed_batches": failed,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "requests_per_s": len(requests) / wall,
           # the five slowest requests, by their index in the stream
           "slowest_ms": {int(i): float(lat[i])
                          for i in np.argsort(lat)[-5:][::-1]},
           "cold_pass_p50_ms": float(np.percentile(cold, 50)),
           "cold_pass_p99_ms": float(np.percentile(cold, 99)),
           "idle_share_of_one_batch": prof["device_idle_share"],
           "tcp_serving_tier": {k: tcp[k] for k in (
               "p50_ms", "p99_ms", "requests_per_s",
               "idle_share_of_one_batch")},
           "graph_trt_calls": calls, "graph_trt_calls_expected": per_batch,
           "plain_table_readers": plain_readers,
           "package_bytes": package_bytes,
           "package_written_buffers": written, "package_kt_copies": copies,
           "op_launches": {k: v for k, v in counts.items() if v},
           "op_launches_expected": expected,
           "python_launches": {k: v for k, v in python_counts.items() if v},
           "profile_kernels_seen": kernels_seen,
           "profile_clone_kernels": [n for n in prof["device_names"]
                                     if "clone" in n],
           "op_checks": op_rows,
           "constant_bytes": constant_bytes, "peak_bytes": peak,
           "all_finite": bool(np.isfinite(scores).all()),
           "max_abs_diff_vs_eager": float(np.abs(scores - direct).max()),
           "within_tol": bool(np.allclose(scores, direct, **SCORE_TOL)),
           "run_vs_eager_max_abs_diff": float(
               np.abs(native_first - eager_first).max()),
           "seconds": {**seconds, "arm": time.perf_counter() - t_arm},
           "nvidia_smi": nvidia_smi_line()}
    emit(rec)
    problems = []
    if calls != per_batch or plain_readers:
        problems.append(f"graph: {calls}, plain readers {plain_readers}")
    if package_bytes >= NATIVE_PACKAGE_LIMIT or copies or len(written) != 1:
        problems.append(f"package: {package_bytes} B, writes {written}, "
                        f"copies {copies}")
    if ({k: v for k, v in counts.items() if v} != expected or batches == 0
            or any(python_counts.values()) or failed):
        problems.append(f"launches: {counts} for {batches} batches "
                        f"({failed} failed), python {python_counts}")
    if not all(kernels_seen.values()) or rec["profile_clone_kernels"]:
        problems.append(f"profile: {kernels_seen}, "
                        f"{rec['profile_clone_kernels']}")
    if not all(r["equal"] for r in op_rows):
        problems.append(f"operators vs plain: {op_rows}")
    if not (rec["all_finite"] and rec["within_tol"]
            and np.allclose(native_first, eager_first, **SCORE_TOL)):
        problems.append(f"scores: {rec['max_abs_diff_vs_eager']}")
    if peak > constant_bytes + NATIVE_PEAK_SLACK:
        problems.append(f"peak {peak} B above {constant_bytes} B of "
                        f"constants + 1 GiB")
    if problems:
        raise AssertionError(f"native serving {name}: " + "; ".join(problems))
    launches = dict.fromkeys(tbe.LAUNCHES, 0)
    for op, k in NATIVE_OP_KERNELS.items():
        launches[k] += counts[op]
    shutil.rmtree(path)
    return rec, launches


NATIVE_PREBUILD_NICE = 10  # the packaging child's priority below the run's


def _native_model_sd():
    """The serving DLRM's dense weights, the same in every arm (seed 0):
    Inductor's caches serve the dense kernels after the first compile."""
    import torch

    from torchrec_tpu_torch.datasets.criteo import mlperf_dlrm_v2_tables
    from torchrec_tpu_torch.models.dlrm import DLRM

    torch.manual_seed(0)
    return DLRM(meta_ebc(mlperf_dlrm_v2_tables(DIM)), NUM_DENSE,
                DENSE_ARCH, OVER_ARCH).state_dict()


def native_prebuild(out_dir) -> None:
    """``python3 chip_smoke.py --native-prebuild DIR``: every arm of
    :data:`NATIVE_ARMS` packaged and exported
    (:func:`native_package_arm`) into ``DIR/<arm>``, then its steps'
    seconds into ``DIR/<arm>.json``, and the whole wall into
    ``DIR/done.json``.  :func:`start_native_prebuild` runs it in a child
    process beside the phases before ``native_serving``."""
    import torch

    sys.path.insert(0, ROOT)
    from torchrec_tpu_torch.ops import _native

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    _native.load_libraries()
    model_sd = _native_model_sd()
    for quant, kernel, row_cap, _ in NATIVE_ARMS:
        name = _native_arm_name(quant, kernel)
        seconds = native_package_arm(dev, os.path.join(out_dir, name), quant,
                                     kernel, row_cap, model_sd)
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(seconds, f)
    with open(os.path.join(out_dir, "done.json"), "w") as f:
        json.dump({"seconds": time.perf_counter() - t0}, f)


def start_native_prebuild():
    """Start :func:`native_prebuild` in a child process: the four arms'
    AOTInductor compiles (about two minutes of host work, most of it the
    first compile's) then run beside the phases before ``native_serving``
    instead of inside it.  The child runs at a lower priority
    (``NATIVE_PREBUILD_NICE``) with one Inductor compile thread, so that
    the phases it runs beside keep their cores; its work on the card is
    the packaging's draws and quantization.  Returns (the child, its
    directory); the caller ends the child and removes the directory."""
    d = tempfile.mkdtemp(prefix="native_prebuild_")
    env = dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS="1")
    with open(os.path.join(d, "log.txt"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--native-prebuild",
             d], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
            preexec_fn=lambda: os.nice(NATIVE_PREBUILD_NICE))
    return proc, d


def stop_native_prebuild(prebuild) -> None:
    """End :func:`start_native_prebuild`'s child if it still runs, and
    remove its directory."""
    proc, d = prebuild
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    shutil.rmtree(d, ignore_errors=True)


def native_serving_phase(dev, tcp, prebuild):
    """Serving with no Python in the request path (budget
    ``NATIVE_SERVING_BUDGET_S``, every check hard): the DLRM of
    ``serving_tier`` through ``package_model`` -> ``export_native`` on the
    card -> ``NativeInferenceServer`` over TCP, one arm a lookup kernel
    (:data:`NATIVE_ARMS`).  ``tcp``: the serving tier's TCP record, set
    beside each arm's figures.  ``prebuild``: :func:`start_native_prebuild`'s
    (child, directory), whose packages the arms serve; the phase waits for
    the child first, and its seconds count that wait.  Returns the arms'
    kernel launches."""
    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        MLPERF_DLRM_V2_ROWS,
    )
    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.ops import tbe

    t_phase = time.perf_counter()
    proc, pdir = prebuild
    try:
        rc = proc.wait(timeout=NATIVE_SERVING_BUDGET_S)
    except subprocess.TimeoutExpired:
        rc = None
    wait_s = time.perf_counter() - t_phase
    if rc != 0:
        with open(os.path.join(pdir, "log.txt")) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"the native packages' build ended with {rc} "
                           f"after a {wait_s:.1f} s wait:\n{tail}")
    with open(os.path.join(pdir, "done.json")) as f:
        prebuild_s = json.load(f)["seconds"]
    features, caps = list(DEFAULT_CAT_NAMES), list(MLPERF_DLRM_V2_MULTI_HOT)
    launches = dict.fromkeys(tbe.LAUNCHES, 0)
    recs = []
    for quant, kernel, row_cap, ops in NATIVE_ARMS:
        rows = [min(r, row_cap) for r in MLPERF_DLRM_V2_ROWS]
        requests = _requests(next(iter(RandomRecDataset(
            features, NUM_REQUESTS, rows, caps, num_dense=NUM_DENSE,
            manual_seed=0, num_batches=1))), len(features))
        name = _native_arm_name(quant, kernel)
        with open(os.path.join(pdir, name + ".json")) as f:
            seconds = json.load(f)
        rec, arm = native_serving_arm(dev, os.path.join(pdir, name), quant,
                                      kernel, row_cap, ops, requests,
                                      seconds, tcp)
        recs.append(rec)
        for k, v in arm.items():
            launches[k] += v
    seconds = time.perf_counter() - t_phase
    emit({"phase": "native_serving_done", "seconds": seconds,
          "budget_s": NATIVE_SERVING_BUDGET_S,
          "prebuild_wait_seconds": wait_s,
          "prebuild_seconds": prebuild_s,
          "compile_seconds": {r["arm"]: r["seconds"].get("aoti_compile")
                              for r in recs},
          "launches": {k: v for k, v in launches.items() if v}})
    if seconds > NATIVE_SERVING_BUDGET_S:
        raise AssertionError(f"native serving took {seconds:.1f} s, over "
                             f"its {NATIVE_SERVING_BUDGET_S} s budget")
    return launches


# ---------------------------------------------------------------------------
# the sharding planner's records, and phase 10: the planner-driven DLRM
# application (examples/dlrm/dlrm_main.py) on the card
# ---------------------------------------------------------------------------

APP_STEPS, APP_EVAL, APP_WARMUP = 40, 10, 20
APP_FLAGS = ["--num_embeddings", "100000", "--embedding_dim", str(DIM),
             "--batch_size", str(BENCH_BATCH), "--steps", str(APP_STEPS),
             "--eval_steps", str(APP_EVAL), "--warmup_steps",
             str(APP_WARMUP)]
APP_RAMP_STEP = 3  # the ramp check's step, inside the 20-step warmup
APP_BUDGET_S = 60
METRICS_TOL = 1e-6  # card vs CPU RecMetricModule (float32 sums)


def _plan_summary(plan):
    return {t: [ps.sharding_type.value, ps.compute_kernel.value, ps.ranks,
                ps.cache_load_factor] for t, ps in plan.items()}


def planner_records():
    """The port's planner with its H100 profile, no run: the bench tables
    (26 x 100,000 x 128) at B=4096 a rank at world 1 (the train phase's
    plan, which must be ``table_wise_plan``) and world 4 (the sharded
    phase's ``planned`` plan), and the MLPerf DLRM-v2 tables (204M rows,
    D=128) at world 1 and B=8192, as the planner's defaults give it (the
    f32 tables and state do not fit 80 GB) and with the multi-hot pooling
    factors and ``tiered="on"`` (host-cached options) for the five
    40M-row tables.  Emits one record each, a ``PlannerError``'s message
    where the planner finds no plan."""
    from torchrec_tpu_torch.datasets.criteo import (
        MLPERF_DLRM_V2_MULTI_HOT,
        mlperf_dlrm_v2_tables,
    )
    from torchrec_tpu_torch.parallel.planner import (
        EmbeddingShardingPlanner,
        ParameterConstraints,
        PlannerError,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    _, bench = bench_tables()
    mlperf = mlperf_dlrm_v2_tables()
    tiered = {c.name: ParameterConstraints(
        tiered="on" if c.num_embeddings >= 4_000_000 else None,
        pooling_factor=float(h))
        for c, h in zip(mlperf, MLPERF_DLRM_V2_MULTI_HOT)}
    for name, tables, world, batch, cons in (
            ("bench", bench, 1, BENCH_BATCH, None),
            ("bench", bench, SHARDED_RANKS, BENCH_BATCH, None),
            ("mlperf_dlrm_v2", mlperf, 1, DCN_BATCH, None),
            ("mlperf_dlrm_v2_host_cached", mlperf, 1, DCN_BATCH, tiered)):
        t0 = time.perf_counter()
        planner = EmbeddingShardingPlanner(
            world_size=world, batch_size_per_device=batch, constraints=cons)
        rec = {"phase": "planner", "tables": name, "world": world,
               "batch_per_rank": batch,
               "device": planner.topology.device,
               "calibration": planner.topology.calibration_sources}
        try:
            plan = planner.plan(tables)
        except PlannerError as e:
            rec.update(planner_error=str(e).splitlines(),
                       seconds=time.perf_counter() - t0)
            emit(rec)
            continue
        kinds: dict = {}
        for ps in plan.values():
            k = f"{ps.sharding_type.value}/{ps.compute_kernel.value}"
            kinds[k] = kinds.get(k, 0) + 1
        rec.update(
            seconds=time.perf_counter() - t0, kinds=kinds,
            plan=_plan_summary(plan),
            per_rank_hbm_bytes=planner.stats.per_rank_hbm,
            per_rank_perf_ms={r: p.total * 1e3 for r, p in
                              planner.stats.per_rank_perf.items()},
            report=planner.last_report.splitlines())
        if name == "bench" and world == 1:
            rec["is_table_wise_plan"] = dict(plan) == table_wise_plan(tables)
            if not rec["is_table_wise_plan"]:
                raise AssertionError("the planner's world-1 plan of the "
                                     "bench tables is not table_wise_plan")
        emit(rec)


def _app_metrics_check(run, dev, device_type):
    """The application's eval batches again (a fresh iterator past the
    training batches), their predictions from the trained state into a
    fresh module on the card and one on the CPU: every metric of the two
    within ``METRICS_TOL``, and of the card's equal to the run's report."""
    import itertools

    import torch

    from torchrec_tpu_torch.metrics import (
        MetricsConfig,
        RecMetricModule,
        RecTaskInfo,
    )

    cfg = MetricsConfig(tasks=[RecTaskInfo(name="ctr")],
                        metrics=["ne", "auc", "calibration"])
    card = RecMetricModule(cfg, BENCH_BATCH, device=device_type)
    cpu = RecMetricModule(cfg, BENCH_BATCH, device="cpu")
    fwd = run["dmp"].make_forward()
    state = run["state"]
    for b in itertools.islice(iter(run["ds"]), APP_STEPS,
                              APP_STEPS + APP_EVAL):
        b = b.to(dev)
        preds = torch.sigmoid(fwd(state["dense"], state["tables"], b))
        card.update({"ctr": preds}, {"ctr": b.labels})
        cpu.update({"ctr": preds.cpu()}, {"ctr": b.labels.cpu()})
    got, want = card.compute(), cpu.compute()
    keys = sorted(k for k in got if not k.startswith("throughput"))
    err = max(abs(got[k] - want[k]) for k in keys)
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
              for k in keys)
    run_err = max(abs(got[k] - run["report"][k]) for k in keys)
    out = {"metrics": {k: got[k] for k in keys},
           "metrics_card_vs_cpu_max_abs_err": err,
           "metrics_card_vs_cpu_max_rel_err": rel,
           "metrics_vs_run_report_max_abs_err": run_err}
    if not all(np.isfinite(got[k]) for k in keys):
        raise AssertionError(f"app: non-finite metrics {got}")
    if err > METRICS_TOL and rel > METRICS_TOL:
        raise AssertionError(f"app: card metrics off the CPU module's by "
                             f"{err} ({got} vs {want})")
    if run_err > METRICS_TOL:
        raise AssertionError(f"app: metrics off the run's report by "
                             f"{run_err}")
    return out


def app_phase(dev):
    """The planner-driven DLRM application at full width: ``dlrm_main``
    (8 features x 10 ids over 100,000-row tables of D=128, DLRM 13 ->
    512-256-128, over arch 512-512-256-1 in float32, B=4096, 40 steps with
    a 20-step linear warmup on the dense Adagrad and the fused sparse lr,
    10 eval batches, NE / AUC / calibration) on the port's planner plan
    at world 1, through ``main`` as a user runs it.  Checks: one B1 per
    train step and eval batch and one B2 per train step and nothing else
    (counts, and a profile of one step and one eval forward), finite
    losses, ``id_overflow`` all zero, ``make_forward``'s logits
    ``torch.equal`` to ``train_step``'s on one state and batch, a step in
    the warmup ramp ``torch.equal`` to the plain B1/B2 at the scheduled
    float32 lr (``train_path_check``), and the card's metrics against a
    CPU module's.  Records ms a step, samples/s, eval ms a batch, peak
    memory, and the planner's per-rank estimates against them.  Returns
    (the main path's launches, the ramp check's record)."""
    import contextlib
    import io
    import itertools

    import torch

    from torchrec_tpu_torch.examples.dlrm import dlrm_main
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.comm import ShardingEnv

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    flags = APP_FLAGS + ["--device", dev.type]
    # an earlier phase's cyclic garbage, freed by a collection during the
    # run, would take its bytes off the run's peak over the base
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    tbe.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        run = dlrm_main.main(flags)
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() - base
    main_s = time.perf_counter() - t_phase
    losses = [float(x) for x in run["losses"]]
    overflow = int(sum(int(o.sum()) for o in run["id_overflow"]))
    timed = APP_STEPS - 1  # after the first step
    ms_per_step = run["train_s"] * 1e3 / timed
    planner = run["planner"]
    est_perf = planner.stats.per_rank_perf[0]
    rec = {"phase": "app", "card": card, "flags": flags,
           "plan": _plan_summary(run["plan"]),
           "planner_report": planner.last_report.splitlines(),
           "stdout": out.getvalue().splitlines()[-8:],
           "steps": len(losses), "eval_batches": run["evaluated"],
           "losses": losses, "all_finite": bool(np.isfinite(losses).all()),
           "id_overflow_total": overflow, "launches": counts,
           "first_step_ms": run["first_step_s"] * 1e3,
           "ms_per_step": ms_per_step,
           "samples_per_s": timed * BENCH_BATCH / run["train_s"],
           "eval_ms_per_batch": run["eval_s"] * 1e3 / run["evaluated"],
           "peak_memory_allocated": peak,
           "planner_hbm_estimate_bytes": planner.stats.per_rank_hbm[0],
           "planner_hbm_estimate_over_peak": (
               planner.stats.per_rank_hbm[0] / peak if peak > 0 else None),
           "planner_step_estimate_ms": est_perf.total * 1e3,
           "planner_step_estimate_parts_ms": {
               k: v * 1e3 for k, v in dataclasses.asdict(est_perf).items()},
           "planner_step_estimate_over_measured": (
               est_perf.total * 1e3 / ms_per_step),
           "report": run["report"]}
    want = {"pooled_lookup": APP_STEPS + APP_EVAL,
            "fused_sparse_update": APP_STEPS}
    if counts != want:
        raise AssertionError(f"app: launched {counts}, want {want}")
    if not rec["all_finite"] or overflow:
        raise AssertionError(f"app: losses {losses}, id_overflow {overflow}")
    rec.update(_app_metrics_check(run, dev, dev.type))

    # the eval forward and the train step on one state and batch; then
    # both under a profile: one B1 each, one B2 for the step
    dmp, state = run["dmp"], run["state"]
    batch = next(itertools.islice(iter(run["ds"]), APP_STEPS + APP_EVAL,
                                  None)).to(dev)
    fwd = dmp.make_forward()
    logits = fwd(state["dense"], state["tables"], batch)
    _, m = dmp.train_step(state, batch)
    rec["forward_equals_train_step_logits"] = bool(torch.equal(logits,
                                                               m["logits"]))
    if not rec["forward_equals_train_step_logits"]:
        raise AssertionError("app: make_forward's logits != train_step's")
    rec["profiled_launches"] = _profiled_kernels(lambda: (
        dmp.train_step(state, batch),
        fwd(state["dense"], state["tables"], batch)))
    if rec["profiled_launches"] != {"pooled_lookup": 2,
                                    "fused_sparse_update": 1}:
        raise AssertionError(f"app: profiled {rec['profiled_launches']}")
    del run, dmp, state, m, logits
    torch.cuda.empty_cache()

    # a step inside the warmup ramp against the plain versions, at the
    # scheduled float32 lr (a second instance of the application)
    args = dlrm_main.parse_args(flags)
    ramp = dlrm_main.build(args, ShardingEnv.single_device(dev))
    dmp, state = ramp["dmp"], ramp["state"]
    it = iter(ramp["ds"])
    for _ in range(APP_RAMP_STEP):
        state, _ = dmp.train_step(state, next(it).to(dev))
    lr = dmp.sparse_lr(state["step"])
    if not 0 < lr < dmp.fused_config.learning_rate:
        raise AssertionError(f"app: step {state['step']} lr {lr} is not in "
                             "the ramp")
    check = train_path_check(dmp, state, next(it).to(dev), None,
                             phase="app_ramp_check", lr=lr)
    del ramp, dmp, state
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    rec["main_seconds"] = main_s
    rec["budget_s"] = APP_BUDGET_S
    emit(rec)
    return counts, check


# ---------------------------------------------------------------------------
# phase 9: multi-rank sharding at the width of bench.py main(): 4 ranks on
# one card over gloo, and one rank over NCCL
# ---------------------------------------------------------------------------

SHARDED_RANKS = 4
SHARDED_STEPS = 1  # timed, after one warm-up step (the run's time limit)
# column-wise runs inside "mixed" (the run's time limit took its own plan)
SHARDED_PLANS = ("tw", "twrw", "mixed", "planned")  # rw: in mixed, planned
SHARDED_TIMEOUT = 600
ONE_CARD = "4 ranks on one card over gloo: not a multi-GPU figure"
# the sharded losses against the plain one-device train_step's: measured
# 1.9e-5 to 3.0e-5 apart over 6 steps (bf16 dense GEMMs at 4 x 4,096 rows
# against 16,384, then the rowwise steps that follow); 3x that
PLAIN_LOSS_RTOL = 1e-4


def sharded_plan(kind, tables, n):
    """The plans of the sharded phase over ``n`` ranks: table-wise
    round-robin, column-wise in 2 shards, row-wise, table-row-wise over
    nodes of 2 ranks, a mix of row-wise, table-wise, column-wise and
    (two tables) data-parallel, and the port's planner's plan with its
    H100 profile at B=4096 a rank (``planned``)."""
    from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType as ST,
    )

    if kind == "planned":
        return EmbeddingShardingPlanner(
            world_size=n, batch_size_per_device=TRAIN_BATCH).plan(tables)

    def one(i, t):
        if kind == "mixed":
            t = ("rw", "tw", "cw")[min(i * 3 // (len(tables) - 2), 2)] \
                if i < len(tables) - 2 else "dp"
        if t == "tw":
            return ParameterSharding(ST.TABLE_WISE, ranks=[i % n])
        if t == "cw":
            return ParameterSharding(ST.COLUMN_WISE,
                                     ranks=[i % n, (i + 1) % n])
        if t == "rw":
            return ParameterSharding(ST.ROW_WISE, ranks=list(range(n)))
        if t == "twrw":
            start = 2 * (i % (n // 2))
            return ParameterSharding(ST.TABLE_ROW_WISE,
                                     ranks=[start, start + 1])
        return ParameterSharding(ST.DATA_PARALLEL)

    return {c.name: one(i, kind) for i, c in enumerate(tables)}


def bench_tables():
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig

    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    return keys, tuple(
        EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k in keys)


def sharded_dmp(dev, plan, batch, caps, env=None, eps=EPS,
                dense_dtype=None, cls=None, optim="rowwise_adagrad", **kw):
    """The DMP of ``build_trainer`` with ``plan``, on ``env`` (one rank
    when None), and its state from a seeded generator on the card (every
    rank draws the same full tables and keeps its share).  ``eps`` is the
    fused optimizer's, ``optim`` its family, ``dense_dtype`` the dense
    part's (bf16 if None); ``cls`` (``DMPCollection``) and ``kw``
    (``qcomms``, its strategy and sync interval) go to the constructor."""
    import torch

    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )

    _, tables = bench_tables()
    model = DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                 dense_dtype=dense_dtype or torch.bfloat16)
    dmp = (cls or DistributedModelParallel)(
        model, tables, plan, batch, caps,
        fused_config=FusedOptimConfig(optim=EmbOptimType(optim),
                                      learning_rate=TRAIN_LR, eps=eps),
        dense_optimizer=adagrad(TRAIN_LR), device=dev, env=env, **kw)
    return dmp, dmp.init(torch.Generator(device=dev).manual_seed(0))


def one_id_batches(n_batches):
    """The first ``n_batches`` batches of ``build_trainer``'s dataset (one
    id per feature at most), on the host."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    keys, _ = bench_tables()
    ds = RandomRecDataset(keys, TRAIN_BATCH, [TRAIN_ROWS] * len(keys),
                          [1] * len(keys), num_dense=NUM_DENSE,
                          manual_seed=0)
    it = iter(ds)
    return dict(zip(keys, ds.caps)), [next(it) for _ in range(n_batches)]


def global_batch(batches):
    """The batches of one step's ranks as the one global batch, examples
    in rank order (each key's values and lengths concatenated)."""
    import torch

    from torchrec_tpu_torch.datasets.utils import Batch
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    kjts = [b.sparse_features for b in batches]
    keys = kjts[0].keys()
    vals, lens, ws = [], [], []
    for f in range(len(keys)):
        for k in kjts:
            ln = k.lengths_for_key(f).cpu().numpy()
            co, n = k.cap_offsets()[f], int(ln.sum())
            vals.append(k.values()[co:co + n].cpu().numpy())
            lens.append(ln)
            if k.weights_or_none() is not None:
                ws.append(k.weights_or_none()[co:co + n].cpu().numpy())
    caps = [sum(k.caps[f] for k in kjts) for f in range(len(keys))]
    kjt = KeyedJaggedTensor.from_lengths_packed(
        keys, np.concatenate(vals), np.concatenate(lens),
        np.concatenate(ws) if ws else None, caps=caps)
    return Batch(torch.cat([b.dense_features for b in batches]), kjt,
                 torch.cat([b.labels for b in batches]))


def multi_hot_batch(env):
    """This rank's weighted multi-hot batch: the bucketed stream's
    Zipf(1.2) lengths of 1 to 64 with Zipf(1.0) ids (seeded per rank),
    repacked to the bucketed caps of the largest of the ranks' batches
    (each feature's cap the same on every rank: the dists' geometry)."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.parallel.multiprocess import allgather_host

    keys, _ = bench_tables()
    F = len(keys)
    b = next(iter(RandomRecDataset(
        keys, TRAIN_BATCH, [TRAIN_ROWS] * F, [DEDUP_MAX_IDS] * F,
        num_dense=NUM_DENSE, manual_seed=100 + env.rank,
        min_ids_per_features=[1] * F, zipf_lengths=DEDUP_ZIPF_LENGTHS,
        zipf_ids=DEDUP_ZIPF_IDS, weighted=True)))
    kjt = b.sparse_features
    sig = kjt.bucketed_caps(BUCKETING["floor"], BUCKETING["growth"])
    caps = [int(c) for c in allgather_host(np.asarray(sig, np.int64))
            .max(axis=0)]
    return dict(zip(keys, caps)), kjt.repad(caps)


def group_kind_of_features(dmp):
    """{feature: kind} of the sharded collection's groups."""
    ebc = dmp.sharded_ebc
    out = {}
    for kind, _, lay in ebc.sharded_groups():
        feats = (lay.feature_order if kind != "rw"
                 else [f.name for f in lay.features])
        out.update(dict.fromkeys(feats, kind))
    for g in ebc.dp_groups.values():
        out.update(dict.fromkeys((f.name for f in g.features), "dp"))
    return out


def _kt_check(kt, ref, kinds, exact_all):
    """The sharded KT against the unsharded collection's, per feature:
    (bitwise equal features, max abs err), or raise.  Table-wise,
    column-wise and data-parallel features (and every feature when
    ``exact_all``) must be ``torch.equal``; row-wise and block-shard
    ones, summed over ranks, within rtol 1e-5, atol 1e-5."""
    import torch

    got, want = kt.to_dict(), ref.to_dict()
    equal, err = 0, 0.0
    for f, kind in kinds.items():
        a, b = got[f].float(), want[f].float()
        err = max(err, float((a - b).abs().max()))
        if torch.equal(a, b):
            equal += 1
        elif exact_all or kind in ("tw", "dp"):
            raise AssertionError(f"{kind} feature {f}: sharded KT != "
                                 f"unsharded (max abs err "
                                 f"{float((a - b).abs().max())})")
        elif not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{kind} feature {f}: sharded KT off the "
                                 f"unsharded by {float((a - b).abs().max())}")
    return equal, err


def _in_turns(env, fn):
    """``fn()`` on one rank at a time, rank order, the others waiting at
    a barrier (a rank's kernel times are then its own on the card)."""
    import torch.distributed as dist

    out = None
    for r in range(env.world_size):
        if env.rank == r:
            out = fn()
        dist.barrier()
    return out


def sharded_kernel_check(dmp, state, batch, flush):
    """B1 and B2 at this rank's shapes on one step's inputs: for each
    sharded group, the group's received slot stream through B1's region
    entry and the step's real gradient through B2 (rowwise Adagrad, on a
    copy of the rank's stack), each ``torch.equal`` to its plain version;
    and their card-alone times, ranks in turns.  Returns the records."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.parallel.sharding.rw import rw_backward_local
    from torchrec_tpu_torch.parallel.sharding.tw import tw_backward_local
    from torchrec_tpu_torch.parallel.sharding.twrw import (
        twrw_backward_local,
    )

    ebc, env = dmp.sharded_ebc, dmp.env
    back = {"tw": tw_backward_local, "rw": rw_backward_local,
            "twrw": twrw_backward_local}
    kt, ctxs = dmp.sparse_forward(state, batch)
    _, _, _, grads = dmp.dense_forward_backward(state, batch, kt)
    cfg = dmp.fused_config
    recs = []
    for kind, name, lay in ebc.sharded_groups():
        stack = state["tables"][name]
        mom = state["fused"][name]["momentum"]
        ids, w, segs, regions = ctxs[name]
        got = tbe.pooled_lookup_regions(stack, ids, regions, w)
        ref = tbe.pooled_lookup_regions_plain(stack, ids, regions, w)
        sg = back[kind](lay, ctxs[name], grads, env)  # a collective
        outs = []
        for fn in (tbe_backward.fused_sparse_update,
                   tbe_backward.fused_sparse_update_plain):
            t, m = stack.clone(), mom.clone()
            _update_call(fn, t, [m], "rowwise_adagrad", sg,
                         cfg.learning_rate, None, (1.0, 1.0))
            outs.append((t, m))
        torch.cuda.synchronize()
        b1_eq = bool(torch.equal(got, ref))
        b2_eq = all(torch.equal(a, b) for a, b in zip(*outs))
        rec = {"phase": "sharded_kernel", "rank": env.rank, "group": name,
               "kind": kind, "stack": list(stack.shape),
               "slots": int(ids.numel()), "regions": len(regions.counts),
               "segments": regions.num_segments,
               "valid_slots": int(sg.ok().sum()),
               "b1_equal": b1_eq, "b2_equal": b2_eq,
               "b1_max_abs_err": float((got.float() - ref.float())
                                       .abs().max()),
               "b2_max_abs_err": max(float((a - b).abs().max())
                                     for a, b in zip(*outs))}
        del outs, got, ref
        if not (b1_eq and b2_eq):
            raise AssertionError(f"sharded kernel check failed: {rec}")
        tk, mk = stack.clone(), mom.clone()
        ends = tbe.region_ends(regions.lengths)
        prep = tbe_backward.sort_by_row(sg.ids, sg.valid, sg.segments,
                                        sg.weights, stack.shape[0],
                                        sg.grad_seg.shape[0])

        def restore():
            tk.copy_(stack)
            mk.copy_(mom)

        def b1():
            return tbe.pooled_lookup_regions(stack, ids, regions, w)

        def b1_kernel():
            return tbe.launch_pooled(stack, ids, w, ends, regions.starts,
                                     regions.caps, regions.counts)

        def b2():
            _update_call(tbe_backward.fused_sparse_update, tk, [mk],
                         "rowwise_adagrad", sg, cfg.learning_rate, None,
                         (1.0, 1.0))

        def b2_kernel():
            tbe_backward.launch_fused_sparse_update(
                tk, [mk], *prep, sg.grad_seg, "rowwise_adagrad",
                cfg.learning_rate, EPS, 0.0, (0.9, 0.999), (1.0, 1.0), None)

        def times():
            return {
                "b1_kernel_device_ms": cuda_ms(b1_kernel, flush,
                                               device_only=True),
                "b1_wrapper_device_ms": cuda_ms(b1, flush, device_only=True),
                "b2_kernel_device_ms": cuda_ms(b2_kernel, flush,
                                               setup=restore,
                                               device_only=True),
                "b2_wrapper_device_ms": cuda_ms(b2, flush, setup=restore,
                                                device_only=True)}

        R, D = stack.shape
        _, nbytes, flops = _b1_bound(R, D, stack.element_size(), ids, segs,
                                     w, regions.num_segments)
        rec["b1_bound_ms"] = _bound(nbytes, flops)[0]
        _, nbytes, flops = _update_bound(D, stack.element_size(), sg,
                                         "rowwise_adagrad")
        rec["b2_bound_ms"] = _bound(nbytes, flops)[0]
        rec.update(_in_turns(env, times) or {})
        del tk, mk, prep
        recs.append(rec)
    return recs


def _profiled_kernels(call, window=None):
    """B1's and B2's device launches in one ``call``, by a profile
    (:func:`_device_kernel_names`)."""
    names = _device_kernel_names(call, window)
    return {"pooled_lookup": sum("tbe_pooled_kernel" in n for n in names),
            "fused_sparse_update": sum("fused_update_kernel" in n
                                       for n in names)}


def _rank_device(device_type):
    """The rank's device: the card's first for every rank (the kernels
    built by the parent are loaded), or the CPU for a rehearsal."""
    import torch

    from torchrec_tpu_torch.ops import _native

    if device_type != "cuda":
        return torch.device(device_type)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _native.load_libraries()  # built by the parent: loads them
    return dev


# a development run's choices
GLOO_STAGES = ("dedup_rw", "vbe", "hier", "reshard", "zch_synced")


def sharded_rank(kinds, device_type="cuda", only=None, ckpt_dir=None):
    """One rank of the gloo arm (run by ``multiprocess.launch``): every
    plan of ``kinds`` through the checks of the phase, then the stages
    (``only``, a development run: those of ``GLOO_STAGES`` alone);
    ``ckpt_dir`` the reshard stage's checkpoint directory.  Returns its
    records and launch counts."""
    import torch

    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel import multiprocess
    from torchrec_tpu_torch.parallel.comm import ShardingEnv
    from torchrec_tpu_torch.parallel.qcomm import wire_accounting

    dev = _rank_device(device_type)
    multiprocess.initialize("gloo")
    env = ShardingEnv.from_process_group("gloo", device=dev)
    r, N = env.rank, env.world_size
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    caps, host = one_id_batches(N * (1 + SHARDED_STEPS))
    mine = [host[s * N + r].to(dev) for s in range(1 + SHARDED_STEPS)]
    records, launches, refs = [], {}, {}
    _, tables = bench_tables()
    ebc = EmbeddingBagCollection(
        tables, is_weighted=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    mh_caps, mh_kjt = multi_hot_batch(env)
    mh_kjt = mh_kjt.to(dev)
    for kind in kinds:
        t0 = time.perf_counter()
        stages = {}
        plan = sharded_plan(kind, tables, N)
        ref_key = one_device_plan(plan)
        if r == 0 and ref_key not in refs:  # the others wait
            refs[ref_key] = (one_device_run(dev, ref_key, host, N),
                             one_device_run(dev, ref_key, host, N, False)[0])
        stages["one_device_reference_s"] = time.perf_counter() - t0
        dmp, state = sharded_dmp(dev, plan, TRAIN_BATCH, caps, env)
        kinds_of = group_kind_of_features(dmp)
        with torch.no_grad():
            kt, _ = dmp.sparse_forward(state, mine[0])
            one_hot = _kt_check(_kt(dmp, kt), ebc(mine[0].sparse_features),
                                kinds_of, exact_all=True)
            mh = dmp.with_feature_caps(mh_caps)
            kt_m, _ = mh.sparse_forward(state, _with_kjt(mine[0], mh_kjt))
            multi = _kt_check(_kt(mh, kt_m), ebc(mh_kjt), kinds_of,
                              exact_all=False)
            dedup = None
            if kind == "tw":
                dd = dmp.with_feature_caps(caps, "dedup", "dedup")
                kt_d, _ = dd.sparse_forward(state, mine[0])
                dedup = bool(torch.equal(kt_d, kt))
                if not dedup:
                    raise AssertionError("tw: B4's KT != B1's")
        planned = None
        if kind == "planned":
            planned, one = planned_forward_check(dmp, state, mine[0], dev)
        stages["forward_checks_s"] = time.perf_counter() - t0 - sum(
            stages.values())
        kchecks = sharded_kernel_check(dmp, state, mine[0], flush)
        stages["kernel_checks_s"] = time.perf_counter() - t0 - sum(
            stages.values())
        # the main path: 1 warm-up and SHARDED_STEPS timed steps
        torch.cuda.synchronize()
        tbe.reset_launch_counts()
        state, warm, _ = _train_steps(dmp, state, mine[:1], 1)
        with wire_accounting() as ledger:
            state, losses, dt = _train_steps(dmp, state, mine[1:],
                                             SHARDED_STEPS)
        counts = {k: v for k, v in tbe.launch_counts().items() if v}
        steps = 1 + SHARDED_STEPS
        if (counts.get("pooled_lookup", 0) < steps
                or counts.get("fused_sparse_update", 0) < steps
                or set(counts) - {"pooled_lookup", "fused_sparse_update"}):
            raise AssertionError(f"{kind} rank {r}: {steps} steps launched "
                                 f"{counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        stages["train_steps_s"] = time.perf_counter() - t0 - sum(
            stages.values())
        weights = dmp.table_weights(state)  # a collective
        table_err = ref_losses = tables_equal = plain_losses = None
        plain_gap = None
        if r == 0:
            (ref_losses, ref_tables), plain_losses = refs[ref_key]
            plain_gap = max(abs(a - b) / abs(b)
                            for a, b in zip(warm + losses, plain_losses))
            if plain_gap > PLAIN_LOSS_RTOL:
                raise AssertionError(
                    f"{kind}: losses {warm + losses} off the one-device "
                    f"train_step's {plain_losses} by {plain_gap} (rtol "
                    f"{PLAIN_LOSS_RTOL})")
            tables_equal = all(np.array_equal(weights[t], ref_tables[t])
                               for t in ref_tables)
            table_err = max(float(np.abs(weights[t] - ref_tables[t]).max())
                            for t in ref_tables)
            if not tables_equal:
                raise AssertionError(
                    f"{kind}: trained tables != the one-device DMP's (max "
                    f"abs err {table_err}; tables " + str(sorted(
                        t for t in ref_tables
                        if not np.array_equal(weights[t], ref_tables[t])))
                    + ")")
        stages["tables_check_s"] = time.perf_counter() - t0 - sum(
            stages.values())
        # every rank profiles the same step at once: a profiler's first
        # start takes seconds in each process, so not one rank at a time;
        # the barrier keeps rank 0's table check (seconds) out of the
        # other ranks' profiling windows, which then hold the step alone
        torch.distributed.barrier()
        window = {}
        profiled = _profiled_kernels(lambda: dmp.train_step(state, mine[0]),
                                     window)
        if not (profiled["pooled_lookup"] and
                profiled["fused_sparse_update"]):
            raise AssertionError(f"{kind} rank {r}: profiled {profiled}; "
                                 f"window {window}")
        stages["profile_s"] = time.perf_counter() - t0 - sum(stages.values())
        if kind == "planned":
            planned.update(planned_overflow_check(dmp, state, mine[1], env,
                                                  one))
            planned["plan"] = _plan_summary(plan)
            del one
            stages["planned_checks_s"] = time.perf_counter() - t0 - sum(
                stages.values())
        rec = {"phase": "sharded", "plan": kind, "rank": r, "ranks": N,
               "backend": "gloo", "note": ONE_CARD,
               "groups": {n: list(t.shape)
                          for n, t in state["tables"].items()},
               "batch_per_rank": TRAIN_BATCH, "steps": steps,
               "ms_per_step": dt * 1e3 / SHARDED_STEPS,
               "losses": warm + losses,
               "all_finite": bool(np.isfinite(warm + losses).all()),
               "one_device_losses": ref_losses,
               "one_hot_equal_features": one_hot[0],
               "one_hot_max_abs_err": one_hot[1],
               "multi_hot_equal_features": multi[0],
               "multi_hot_max_abs_err": multi[1],
               "multi_hot_caps": sorted(set(mh_caps.values())),
               "dedup_kt_equal": dedup, "launches": counts,
               "profiled_launches_one_step": profiled,
               "wire_bytes_per_step": {k: v / SHARDED_STEPS
                                       for k, v in ledger.items()},
               "tables_equal_one_device": tables_equal,
               "table_max_abs_err_vs_one_device": table_err,
               "one_device_train_step_losses": plain_losses,
               "loss_max_rel_gap_vs_train_step": plain_gap,
               "stage_seconds": stages,
               "seconds": time.perf_counter() - t0}
        if planned is not None:
            rec["planned"] = planned
        if not rec["all_finite"]:
            raise AssertionError(f"{kind} rank {r}: losses {rec['losses']}")
        records += [rec] + kchecks
        del dmp, state, weights
        torch.cuda.empty_cache()
    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    if only is None or "dedup_rw" in only:
        rec, counts, kchecks = dedup_rw_stage(dev, env, caps, mine, ebc,
                                              flush)
        records += [rec] + kchecks
        add(counts)
    if only is None or "vbe" in only:
        rec, counts = vbe_stage(dev, env, caps, mine, ebc,
                                (mh_caps, mh_kjt))
        records.append(rec)
        add(counts)
    if only is None or "hier" in only:
        torch.cuda.empty_cache()
        rec, counts = hier_stage(dev, caps, mine, (mh_caps, mh_kjt))
        records.append(rec)
        add(counts)
    if only is None or "reshard" in only:
        torch.cuda.empty_cache()
        rec, counts, kchecks = reshard_stage(dev, env, caps, mine, flush,
                                             ckpt_dir)
        records += [rec] + kchecks
        add(counts)
    if only is None or "zch_synced" in only:
        torch.cuda.empty_cache()
        rec, counts = zch_synced_stage(dev, env)
        records.append(rec)
        add(counts)
    if only is not None:
        return records, launches
    recs, counts, kchecks = sharded_stages(dev, env, caps, host, mine, refs)
    records += recs + kchecks
    add(counts)
    del ebc, flush
    torch.cuda.empty_cache()
    rec, counts, kchecks = seq_sharded_stage(dev, env)
    records += [rec] + kchecks
    add(counts)
    records.append(ring_stage(dev, env))
    return records, launches


def zch_synced_stage(dev, env):
    """``SyncedCollisionCollection`` across the launch's ranks: every rank
    remaps its own batch of :func:`zch_stream` ids (one
    ``MCHManagedCollisionModule(ZCH_SYNCED_SIZE)`` a table, LRU) against
    the synced state and applies every eviction of the global stream
    (``reset_table_rows``) to the tw plan's DMP, for 2 steps.  Checks:
    each rank's remapped values ``np.array_equal`` to the single-process
    remap of the concatenated global batch (rank order); on rank 0, the
    trained tables ``np.array_equal`` to the one-device DMP's over the
    global batches with the same resets (the micro-batched reference of
    the plans, :func:`_micro_grads`).  Caps: 2 x B a feature (1-2 ids an
    example).  Returns (record, launches)."""
    import torch

    from torchrec_tpu_torch.datasets.utils import Batch
    from torchrec_tpu_torch.modules.mc_modules import (
        ManagedCollisionCollection,
        MCHManagedCollisionModule,
    )
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.multiprocess import (
        SyncedCollisionCollection,
    )
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    t0 = time.perf_counter()
    r, N = env.rank, env.world_size
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType,
    )

    keys, tables = bench_tables()
    plan = sharded_plan("tw", tables, N)
    caps = {k: 2 * TRAIN_BATCH for k in keys}

    def mcc():
        return ManagedCollisionCollection({
            k: MCHManagedCollisionModule(ZCH_SYNCED_SIZE, f"t_{k}")
            for k in keys})

    stream = zch_stream(keys, TRAIN_BATCH, DYN_SEED + 4)
    steps = [[next(stream) for _ in range(N)] for _ in range(2)]

    def kjt_of(values, lengths):
        return KeyedJaggedTensor.from_lengths_packed(
            keys, values, lengths, caps=[caps[k] for k in keys])

    synced = SyncedCollisionCollection(mcc())
    dmp, state = sharded_dmp(dev, plan, TRAIN_BATCH, caps, env)
    torch.cuda.synchronize()
    tbe.reset_launch_counts()
    remapped, evictions = [], []
    for locals_ in steps:
        values, lengths, dense, labels = locals_[r]
        evs: list = []
        (kjt,) = synced.remap_local([kjt_of(values, lengths)], evs)
        for e in evs:
            state = dmp.reset_table_rows(state, e.table, e.slots)
        evictions.append(sum(len(e.slots) for e in evs))
        remapped.append(kjt.values().numpy().copy())
        state, _ = dmp.train_step(state, Batch(
            torch.from_numpy(dense), kjt, torch.from_numpy(labels)).to(dev))
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    weights = dmp.table_weights(state)  # a collective
    del dmp, state
    torch.cuda.empty_cache()
    # the single-process remap of the concatenated global batches
    ref = mcc()
    remap_equal = True
    ref_steps = []
    for s, locals_ in enumerate(steps):
        per_rank = []
        for q, (values, lengths, dense, labels) in enumerate(locals_):
            k = kjt_of(values, lengths)
            k2, evs = ref.remap_kjt(k)
            per_rank.append((k2, evs, dense, labels))
            if q == r:
                remap_equal &= bool(np.array_equal(k2.values().numpy(),
                                                   remapped[s]))
        ref_steps.append(per_rank)
    tables_equal = None
    if r == 0:
        one, st = sharded_dmp(
            dev, {t: ParameterSharding(ShardingType.TABLE_WISE, ranks=[0])
                  for t in plan}, N * TRAIN_BATCH,
            {k: N * c for k, c in caps.items()})
        for per_rank in ref_steps:
            for _, evs, _, _ in per_rank:
                for e in evs:
                    st = one.reset_table_rows(st, e.table, e.slots)
            mbs = [Batch(torch.from_numpy(d), k2, torch.from_numpy(lb)).to(dev)
                   for k2, _, d, lb in per_rank]
            gb = global_batch([Batch(torch.from_numpy(d), k2,
                                     torch.from_numpy(lb))
                               for k2, _, d, lb in per_rank]).to(dev)
            kt, ctxs = one.sparse_forward(st, gb)
            _, g_dense, grads = _micro_grads(one, st, kt, mbs)
            one.sharded_ebc.backward_and_update_local(
                st["tables"], st["fused"], ctxs, grads, one.fused_config)
            one.dense_tx.update(st["dense"], g_dense, st["dense_opt"])
            st["step"] += 1
        ref_w = one.table_weights(st)
        tables_equal = all(np.array_equal(weights[t], ref_w[t])
                           for t in ref_w)
        del one, st, ref_w
        torch.cuda.empty_cache()
    rec = {"phase": "zch_synced", "rank": r, "ranks": N, "note": ONE_CARD,
           "zch_size": ZCH_SYNCED_SIZE, "batch_per_rank": TRAIN_BATCH,
           "steps": len(steps), "evictions_per_step": evictions,
           "remap_equal_single_process": remap_equal,
           "tables_equal_one_device": tables_equal, "launches": counts,
           "seconds": time.perf_counter() - t0,
           "budget_s": ZCH_SYNCED_BUDGET_S}
    if not (remap_equal and tables_equal is not False and evictions[-1]):
        raise AssertionError(f"zch_synced rank {r} failed: {rec}")
    if rec["seconds"] > ZCH_SYNCED_BUDGET_S:
        raise AssertionError(f"zch_synced rank {r} took "
                             f"{rec['seconds']:.1f} s")
    return rec, counts


# -- the sharded phase's later stages, in the same 4-rank launch ------------

# each stage's time budget in seconds (one rank's wall, its checks in)
STAGE_BUDGETS = {"all_reduce": 15, "split": 20, "chunked_a2a": 15,
                 "qcomms": 45, "dmp2d_replicated": 60,
                 "dmp2d_fully_sharded": 60, "sharded_ec": 90}
DMP2D_REPLICAS = 2
DMP2D_SYNC_INTERVAL = 2
EC_PLANS = ("mixed",)  # its groups are tw, rw, cw and dp
EC_MAX_IDS = 4  # ids a sequence example, 1 to 4, Zipf(1.0) ids
EC_STEPS = 3
CHUNKS = (2, 8)
CHUNK_WIDTH = 512  # the dense arch's first width
CHUNK_REL_TOL = 1e-5  # chunked linear vs a2a(x) @ w: |err| / max |ref|
# tests/test_sharded_ebc.py:285-287, the JAX package's fp32-vs-qcomm bounds
QCOMM_RTOL, QCOMM_ATOL = 0.02, 0.05
QCOMM_PRECISIONS = ("bf16", "int8")


def _stage_record(name, t0, **fields):
    """A stage's record: its fields, its seconds and its budget."""
    s = time.perf_counter() - t0
    return {"phase": name, **fields, "seconds": s,
            "budget_s": STAGE_BUDGETS[name],
            "within_budget": s <= STAGE_BUDGETS[name]}


def _counted(call):
    """(``call()``'s result, the launches it counted, by kernel)."""
    from torchrec_tpu_torch.ops import tbe

    tbe.reset_launch_counts()
    out = call()
    return out, {k: v for k, v in tbe.launch_counts().items() if v}


def _lockstep_ms(fn, runs=5):
    """Median ms of a collective ``fn`` that every rank calls together."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _local_dense_grads(dmp, state, batch):
    """This rank's loss and dense gradients before the all-reduce, flat:
    the dense forward and backward of ``dense_forward_backward``."""
    import torch

    from torchrec_tpu_torch.models.dlrm import bce_with_logits_loss
    from torchrec_tpu_torch.sparse import KeyedTensor

    ebc = dmp.sharded_ebc
    kt, _ = dmp.sparse_forward(state, batch)
    dense = {k: v.detach().requires_grad_() for k, v in state["dense"].items()}
    with torch.enable_grad():
        logits = torch.func.functional_call(
            dmp._dense_forward, {f"model.{k}": v for k, v in dense.items()},
            (batch.dense_features,
             KeyedTensor(ebc.feature_order, ebc.feature_dims, kt.detach())))
        loss = bce_with_logits_loss(logits, batch.labels, batch.weights)
        grads = torch.autograd.grad(loss, list(dense.values()))
    return torch.cat([loss.detach().reshape(1).float()]
                     + [g.reshape(-1) for g in grads])


def all_reduce_stage(dmp, state, batch):
    """The reduce-scatter ``all_reduce_sum`` of the dense gradients (this
    rank's loss and gradients of one step) ``torch.equal`` to an
    all-gather and rank-order sum, on every rank; each one's bytes a rank
    (the ledger's record, and ``N`` copies for the all-gather) and ms."""
    import torch

    from torchrec_tpu_torch.parallel.comm import (
        all_gather,
        all_reduce_sum,
        sum_over_ranks,
    )
    from torchrec_tpu_torch.parallel.qcomm import wire_accounting

    t0 = time.perf_counter()
    env = dmp.env
    flat = _local_dense_grads(dmp, state, batch)
    with wire_accounting() as ledger:
        new = all_reduce_sum(flat, env, tag="dense_grads:all_reduce")
    old = sum_over_ranks(all_gather(flat, env))
    equal = bool(torch.equal(new, old))
    rec = _stage_record(
        "all_reduce", t0, rank=env.rank, ranks=env.world_size,
        elements=flat.numel(), equal_all_gather_sum=equal,
        bytes_reduce_scatter_all_gather=ledger["dense_grads:all_reduce"],
        bytes_all_gather=flat.numel() * flat.element_size() * env.world_size,
        ms_reduce_scatter_all_gather=_lockstep_ms(
            lambda: all_reduce_sum(flat, env)),
        ms_all_gather_sum=_lockstep_ms(
            lambda: sum_over_ranks(all_gather(flat, env))),
        note=ONE_CARD)
    if not equal:
        raise AssertionError(f"all_reduce: new != all-gather sum: {rec}")
    return rec


def split_stage(dmp, state, batch):
    """``make_embed_step`` then ``make_dense_update_step`` from a copy of
    the state: the tables, states and metrics ``torch.equal`` to
    ``train_step``'s from the state; the split step launches B1 and B2
    and nothing else.  Leaves ``state`` one step on."""
    import torch

    t0 = time.perf_counter()
    split = _clone_state(state)

    def halves():
        kt, ctxs = dmp.make_embed_step()(split["tables"], batch)
        return dmp.make_dense_update_step()(split, batch, kt, ctxs)

    (split, ms), counts = _counted(halves)
    _, m = dmp.train_step(state, batch)
    equal = _state_equal(split, state) and all(
        torch.equal(ms[k], m[k]) for k in m)
    rec = _stage_record("split", t0, rank=dmp.env.rank, plan="tw",
                        equal_train_step=equal, launches=counts,
                        loss=float(m["loss"]))
    if not equal or set(counts) != {"pooled_lookup", "fused_sparse_update"}:
        raise AssertionError(f"split: {rec}")
    return rec, counts


def chunked_a2a_stage(dmp, state, batch):
    """The pooled KT of the rank's batch as ``[N, B / N, 26 * 128]``
    blocks: ``chunked_pooled_a2a`` with K of :data:`CHUNKS` ``torch.equal``
    to one all-to-all, ``chunked_a2a_linear`` within ``CHUNK_REL_TOL`` of
    ``a2a(x) @ w`` (a seeded ``[3328, 512]`` weight), ms of each."""
    import torch

    from torchrec_tpu_torch.parallel.chunked_a2a import (
        chunked_a2a_linear,
        chunked_pooled_a2a,
    )
    from torchrec_tpu_torch.parallel.comm import all_to_all

    t0 = time.perf_counter()
    env = dmp.env
    N = env.world_size
    kt, _ = dmp.sparse_forward(state, batch)
    x = kt.view(N, kt.shape[0] // N, kt.shape[1])
    w = torch.randn((kt.shape[1], CHUNK_WIDTH), device=kt.device,
                    generator=torch.Generator(kt.device).manual_seed(7)) * 0.02
    mono = all_to_all(x, env).reshape(-1, kt.shape[1])
    ref = mono @ w
    out = {"rank": env.rank, "shape": list(x.shape),
           "ms_one_a2a": _lockstep_ms(lambda: all_to_all(x, env)),
           "ms_one_a2a_linear": _lockstep_ms(
               lambda: all_to_all(x, env).reshape(-1, kt.shape[1]) @ w)}
    for k in CHUNKS:
        got = chunked_pooled_a2a(x, env, k)
        lin = chunked_a2a_linear(x, w, env, k)
        rel = float((lin - ref).abs().max() / ref.abs().max())
        out[f"k{k}"] = {
            "equal_one_a2a": bool(torch.equal(got, mono)),
            "linear_rel_err": rel,
            "ms": _lockstep_ms(lambda: chunked_pooled_a2a(x, env, k)),
            "ms_linear": _lockstep_ms(
                lambda: chunked_a2a_linear(x, w, env, k))}
        if not out[f"k{k}"]["equal_one_a2a"] or rel > CHUNK_REL_TOL:
            raise AssertionError(f"chunked_a2a K={k}: {out}")
    return _stage_record("chunked_a2a", t0, **out,
                         rel_tol=CHUNK_REL_TOL, note=ONE_CARD)


def qcomms_stage(dev, env, caps, mine, tables):
    """The row-wise plan with bf16 and int8 qcomms on the DMP: the KT of
    the rank's batch within the JAX package's fp32-vs-qcomm tolerances of
    the float32 dists' and not equal to it, the ledger's bytes a tag of
    one step equal to the codec's, and 3 steps of finite losses."""
    import torch

    from torchrec_tpu_torch.parallel.qcomm import (
        CommType,
        QCommsConfig,
        wire_accounting,
        wire_bytes_per_f32,
    )

    t0 = time.perf_counter()
    N, B = env.world_size, TRAIN_BATCH
    plan = sharded_plan("rw", tables, N)
    fp32, st = sharded_dmp(dev, plan, B, caps, env)
    with torch.no_grad():
        kt32, _ = fp32.sparse_forward(st, mine[0])
    del fp32, st
    out, launches = {"rank": env.rank, "plan": "rw"}, {}
    for prec in QCOMM_PRECISIONS:
        qc = QCommsConfig(CommType(prec), CommType(prec))
        dmp, st = sharded_dmp(dev, plan, B, caps, env, qcomms=qc)
        with torch.no_grad():
            kt, _ = dmp.sparse_forward(st, mine[0])
        err = float((kt - kt32).abs().max())
        close = bool(torch.allclose(kt, kt32, rtol=QCOMM_RTOL,
                                    atol=QCOMM_ATOL))
        (ledger, losses), counts = _counted(lambda: _ledger_steps(dmp, st,
                                                                  mine))
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        want = {}
        for name, lay in dmp.sharded_ebc.rw_layouts.items():
            G, D = len(lay.features), lay.dim
            wf = wire_bytes_per_f32(qc, "fwd", D)
            wb = wire_bytes_per_f32(qc, "bwd", D)
            want[f"{name}:out_dist"] = N * G * B * D * wf
            want[f"{name}:bwd_dist"] = G * B * D * wb * N
        out[prec] = {"kt_max_abs_err_vs_fp32": err, "kt_close": close,
                     "kt_equal_fp32": bool(torch.equal(kt, kt32)),
                     "losses": losses, "wire_bytes_one_step": ledger,
                     "codec_bytes": want, "launches": counts}
        ok = (close and not out[prec]["kt_equal_fp32"]
              and np.isfinite(losses).all()
              and all(ledger.get(k) == v for k, v in want.items()))
        del dmp, st
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"qcomms {prec}: {out[prec]}")
    return _stage_record("qcomms", t0, **out, rtol=QCOMM_RTOL,
                         atol=QCOMM_ATOL), launches


def _ledger_steps(dmp, state, batches):
    """3 steps: (the first step's ledger, the losses)."""
    from torchrec_tpu_torch.parallel.qcomm import wire_accounting

    losses = []
    for i in range(3):
        with wire_accounting() as ledger:
            state, m = dmp.train_step(state, batches[i % len(batches)])
        losses.append(float(m["loss"]))
        if i == 0:
            first = dict(ledger)
    return first, losses


def _replicas_digest_equal(dmp, state):
    """Whether every replica holds the same tables and fused states: one
    checksum an array, gathered over the replicas."""
    import torch

    from torchrec_tpu_torch.parallel.comm import all_gather

    arrays = [state["tables"][n] for n in state["tables"]] + [
        v for st in state["fused"].values() for v in st.values()
        if isinstance(v, torch.Tensor) and v.dim()]
    sums = torch.tensor([_checksum(a) for a in arrays], dtype=torch.int64,
                        device=arrays[0].device)
    got = all_gather(sums, dmp.env.replica_env)
    return bool((got == got[0]).all())


def _replicas_equal(dmp, state):
    """Whether every replica's tables and fused states are ``torch.equal``
    (each array gathered over the replicas)."""
    import torch

    from torchrec_tpu_torch.parallel.comm import all_gather

    env = dmp.env.replica_env
    for name, t in state["tables"].items():
        for a in [t] + [v for v in state["fused"][name].values()
                        if isinstance(v, torch.Tensor) and v.dim()]:
            g = all_gather(a, env)
            if not all(torch.equal(g[0], g[q]) for q in range(1, len(g))):
                return False
            del g
    return True


def dmp2d_kernel_check(dmp, state, batch):
    """B1 and B2 at this rank's shapes in a 2D step: each sharded group's
    lookup over the stack the forward reads (FULLY_SHARDED: gathered over
    the replicas) and its update over the slot stream the step applies
    (FULLY_SHARDED: every replica's, cut to this rank's slice), each
    ``torch.equal`` to its plain version."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward

    env, ebc = dmp.env, dmp.sharded_ebc
    kt, ctxs = dmp.sparse_forward(state, batch)
    _, _, _, grads = dmp.dense_forward_backward(state, batch, kt)
    stacks = dmp._sparse_params_for_forward(state["tables"])
    fs = dmp._is_fully_sharded
    sgs = ebc.backward_local(ctxs, grads, env,
                             dp_env=env.global_env if fs else None,
                             dp_divisor=env.num_replicas if fs else 1)
    recs = []
    for kind, name, _ in ebc.sharded_groups():
        ids, w, _, regions = ctxs[name]
        got = tbe.pooled_lookup_regions(stacks[name], ids, regions, w)
        ref = tbe.pooled_lookup_regions_plain(stacks[name], ids, regions, w)
        stack = state["tables"][name]
        sg = sgs[name]
        if fs:
            sg = dmp._replica_slots(name, sg, stack.shape[0])
        outs = []
        for fn in (tbe_backward.fused_sparse_update,
                   tbe_backward.fused_sparse_update_plain):
            t = stack.clone()
            m = state["fused"][name]["momentum"].clone()
            _update_call(fn, t, [m], "rowwise_adagrad", sg,
                         dmp.fused_config.learning_rate, None, (1.0, 1.0))
            outs.append((t, m))
        torch.cuda.synchronize()
        rec = {"phase": "sharded_kernel", "stage": dmp.sharding_strategy.value,
               "rank": env.global_rank, "group": name, "kind": kind,
               "stack": list(stack.shape),
               "slots": int(sg.ids.numel()),
               "b1_equal": bool(torch.equal(got, ref)),
               "b2_equal": all(torch.equal(a, b) for a, b in zip(*outs)),
               "b1_max_abs_err": float((got - ref).abs().max()),
               "b2_max_abs_err": max(float((a - b).abs().max())
                                     for a, b in zip(*outs))}
        del outs
        if not (rec["b1_equal"] and rec["b2_equal"]):
            raise AssertionError(f"2D kernel check: {rec}")
        recs.append(rec)
    return recs


def dmp2d_stage(strategy, dev, env2, caps, host, mine, refs):
    """``DMPCollection`` over 2 replicas of 2 model ranks (the planner's
    plan at world 2, ``sync_interval`` 2): B1 and B2 against their plain
    versions at the rank's shapes, 1 + 5 steps each followed by
    ``maybe_sync`` (B1 and B2 at least once a step and nothing else, by
    the counts and a profile; ms a step, wire bytes a step by tag, peak
    memory), finite losses; REPLICATED: the replicas apart between syncs
    and ``torch.equal`` after each; FULLY_SHARDED: each replica's forward
    of one batch ``torch.equal`` to the other's, the losses within
    ``PLAIN_LOSS_RTOL`` of the plain one-device ``train_step`` over the
    global batches, and the tables ``np.array_equal`` to the one-device
    run of the same arithmetic (the KT gradient halved by the model ranks
    and the replicas' sum halved, a power of two, exactly the one-device
    step's quarter; each row's slots in global batch order)."""
    import torch

    from torchrec_tpu_torch.parallel.model_parallel import DMPCollection
    from torchrec_tpu_torch.parallel.qcomm import wire_accounting
    from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner

    name = f"dmp2d_{strategy}"
    t0 = time.perf_counter()
    _, tables = bench_tables()
    plan = EmbeddingShardingPlanner(
        world_size=env2.world_size,
        batch_size_per_device=TRAIN_BATCH).plan(tables)
    torch.cuda.reset_peak_memory_stats(dev)
    dmp, state = sharded_dmp(dev, plan, TRAIN_BATCH, caps, env2,
                             cls=DMPCollection, sharding_strategy=strategy,
                             sync_interval=DMP2D_SYNC_INTERVAL)
    g = env2.global_rank
    kchecks = dmp2d_kernel_check(dmp, state, mine[0])
    fs = strategy == "fully_sharded"
    tbe_counts = {}
    losses, in_step, dt = [], [], 0.0
    with wire_accounting() as ledger:
        for s, batch in enumerate(mine):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (out, counts) = _counted(lambda: dmp.train_step(state, batch))
            state, m = out
            state = dmp.maybe_sync(state)
            torch.cuda.synchronize()
            if s:  # step 0 warms up
                dt += time.perf_counter() - t1
            losses.append(float(m["loss"]))
            for k, v in counts.items():
                tbe_counts[k] = tbe_counts.get(k, 0) + v
            if set(counts) != {"pooled_lookup", "fused_sparse_update"}:
                raise AssertionError(f"{name} step {s}: launched {counts}")
            if not fs:
                synced = (s + 1) % DMP2D_SYNC_INTERVAL == 0
                in_step.append(_replicas_equal(dmp, state) if synced
                               else _replicas_digest_equal(dmp, state))
    steps = len(mine)
    fs_checks = (_fully_sharded_checks(dmp, state, dev, host, refs, losses)
                 if fs else {})
    torch.distributed.barrier()
    profiled = _profiled_kernels(lambda: dmp.train_step(state, mine[0]))
    rec = {"rank": g, "model_rank": env2.rank, "replica": env2.replica_rank,
           "replicas": env2.num_replicas, "model_ranks": env2.world_size,
           "plan": _plan_summary(plan),
           "groups": {n: list(t.shape) for n, t in state["tables"].items()},
           "steps": steps, "ms_per_step": dt * 1e3 / (steps - 1),
           "losses": losses, "launches": tbe_counts,
           "profiled_launches_one_step": profiled,
           "wire_bytes_per_step": {k: v / steps for k, v in ledger.items()},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "kernel_checks": kchecks, "note": ONE_CARD}
    if not (np.isfinite(losses).all() and profiled["pooled_lookup"]
            and profiled["fused_sparse_update"]):
        raise AssertionError(f"{name}: {rec}")
    if not fs:
        rec["replicas_equal_after_step"] = in_step
        want = [(s + 1) % DMP2D_SYNC_INTERVAL == 0 for s in range(steps)]
        if in_step != want:
            raise AssertionError(f"{name}: replicas equal after steps "
                                 f"{in_step}, want {want}")
    rec.update(fs_checks)
    del dmp, state
    torch.cuda.empty_cache()
    return _stage_record(name, t0, **rec), tbe_counts, kchecks


def _fully_sharded_checks(dmp, state, dev, host, refs, losses):
    """The FULLY_SHARDED checks of :func:`dmp2d_stage` after its steps:
    each replica's forward of one batch, the losses against the plain
    one-device step's, the tables against the one-device run of the same
    arithmetic (rank 0 reads the references, computing them if no plan
    of the phase did)."""
    import torch

    from torchrec_tpu_torch.parallel.comm import all_gather

    env = dmp.env
    n = env.global_size
    batch = host[env.rank].to(dev)  # the same batch on every replica
    logits = dmp.forward(state["dense"], state["tables"], batch)
    got = all_gather(logits, env.replica_env)
    out = {"forward_equal_across_replicas": bool(torch.equal(got[0],
                                                             got[1]))}
    weights = dmp.table_weights(state)  # a collective
    if env.global_rank == 0:
        key = one_device_plan(dmp.plan)
        if key not in refs:
            refs[key] = (one_device_run(dev, key, host, n),
                         one_device_run(dev, key, host, n, False)[0])
        (_, ref_tables), plain = refs[key]
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
        out.update({
            "one_device_train_step_losses": plain,
            "loss_max_rel_gap_vs_train_step": gap,
            "tables_equal_one_device": all(
                np.array_equal(weights[t], ref_tables[t])
                for t in ref_tables),
            "table_max_abs_err_vs_one_device": max(
                float(np.abs(weights[t] - ref_tables[t]).max())
                for t in ref_tables)})
        if gap > PLAIN_LOSS_RTOL or not out["tables_equal_one_device"]:
            raise AssertionError(f"fully_sharded: {out}")
    if not out["forward_equal_across_replicas"]:
        raise AssertionError("fully_sharded: replica forwards differ")
    return out


def _ec_batches(env, dev):
    """Every rank's multi-hot sequence batch (1 to ``EC_MAX_IDS`` ids an
    example, Zipf(1.0) ids, seeded per rank) and the caps."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    keys, _ = bench_tables()
    F = len(keys)
    out = []
    for q in range(env.world_size):
        ds = RandomRecDataset(keys, TRAIN_BATCH, [TRAIN_ROWS] * F,
                              [EC_MAX_IDS] * F, num_dense=NUM_DENSE,
                              manual_seed=200 + q,
                              min_ids_per_features=[1] * F, zipf_ids=1.0)
        out.append(next(iter(ds)).sparse_features.to(dev))
    return dict(zip(keys, ds.caps)), out


def _ec_grads(kjt, step, q, dev):
    """Rank ``q``'s seeded per-id gradients of ``step`` by feature."""
    import torch

    gen = torch.Generator(dev).manual_seed(1000 * step + q)
    return {k: torch.randn((kjt.caps[i], DIM), generator=gen, device=dev)
            for i, k in enumerate(kjt.keys())}


def _ec_reference(dev, tables, weights, plan, kjts, cfg):
    """The one-device run of the sharded EC's arithmetic: each table (a
    column-wise one in its column shards, each with its own rowwise
    state) updated by B6 per step over every rank's valid ids and
    gradients, ranks in order, each id one segment of weight 1."""
    import torch

    from torchrec_tpu_torch.ops.fused_update import (
        apply_sparse_update_segments,
        init_optimizer_state,
    )
    from torchrec_tpu_torch.parallel.embedding import UPDATE_KERNEL, _per_id
    from torchrec_tpu_torch.parallel.types import ShardingType as ST

    out = {}
    for c in tables:
        ps = plan[c.name]
        k = len(ps.ranks) if ps.sharding_type == ST.COLUMN_WISE else 1
        f = c.feature_names[0]
        full = torch.as_tensor(weights[c.name]).to(dev).clone()
        w = c.embedding_dim // k
        for j in range(k):
            t = full[:, j * w:(j + 1) * w].contiguous()
            st = init_optimizer_state(cfg, t.shape[0], w, dev)
            for step in range(EC_STEPS):
                ids, rows = [], []
                for q, kjt in enumerate(kjts):
                    jt = kjt[f]
                    valid = jt.valid_mask()
                    ids.append(jt.values()[valid])
                    rows.append(_ec_grads(kjt, step, q, dev)[f][valid][
                        :, j * w:(j + 1) * w])
                ids = torch.cat(ids)
                sg = _per_id(ids, torch.ones_like(ids, dtype=torch.bool),
                             torch.cat(rows))
                apply_sparse_update_segments(t, st, sg, cfg,
                                             update_kernel=UPDATE_KERNEL)
            full[:, j * w:(j + 1) * w] = t
        out[c.name] = full.cpu().numpy()
    return out


def sharded_ec_stage(dev, env):
    """The sharded ``EmbeddingCollection`` over the 26 bench tables
    (100,000 x 128, float32, rowwise Adagrad) on the mixed plan (its
    groups row-, table- and column-wise and 2 data-parallel tables), a
    multi-hot sequence batch a rank
    (:func:`_ec_batches`): per feature the rows ``torch.equal`` to the
    unsharded ``EmbeddingCollection``'s with ``index_dedup`` off and on;
    one update launches B6 and nothing else, and B6 ``torch.equal`` to its
    plain version on each group's per-id gradients at the rank's shapes;
    the tables after ``EC_STEPS`` steps ``np.array_equal`` to the
    one-device run of the same arithmetic (:func:`_ec_reference`)."""
    import torch

    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingCollection,
    )
    from torchrec_tpu_torch.ops import tbe_backward
    from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
    from torchrec_tpu_torch.parallel.embedding import (
        ShardedEmbeddingCollection,
    )

    t0 = time.perf_counter()
    r, N = env.rank, env.world_size
    keys, _ = bench_tables()
    tables = [EmbeddingConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                              name=f"t_{k}", feature_names=[k])
              for k in keys]
    ref_ec = EmbeddingCollection(
        tables, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    weights = {n: t.detach() for n, t in ref_ec.state_dict().items()}
    caps, kjts = _ec_batches(env, dev)
    kjt = kjts[r]
    with torch.no_grad():
        want = {f: jt.values() for f, jt in ref_ec(kjt).items()}
    cfg = FusedOptimConfig(learning_rate=TRAIN_LR, eps=EPS)
    out, launches, errs = {"rank": r}, {}, []
    for kind in EC_PLANS:
        plan = sharded_plan(kind, tables, N)
        rec = {}
        for dd in (True, False):  # the steps run on the plain one
            ec = ShardedEmbeddingCollection.build(tables, plan, N,
                                                  TRAIN_BATCH, caps,
                                                  index_dedup=dd)
            params = ec.params_from_tables(weights, device=dev, rank=r)
            with torch.no_grad():
                got, _ = ec.forward_local(params, kjt, env)
            rec[f"rows_equal_dedup_{dd}"] = all(
                torch.equal(got[f].values(), want[f]) for f in keys)
            del got
        fused = ec.init_fused_state(cfg, dev)
        b6 = {}
        for step in range(EC_STEPS):
            with torch.no_grad():
                _, ctxs = ec.forward_local(params, kjt, env)
            grads = _ec_grads(kjt, step, r, dev)
            if step == 0:  # B6 at the rank's shapes, on copies
                sgs = ec.backward_local(ctxs, grads, env)
                for name, sg in sgs.items():
                    res = []
                    for fn in (tbe_backward.dedup_fused_sparse_update,
                               tbe_backward.dedup_fused_sparse_update_plain):
                        t = params[name].clone()
                        sts = [fused[name]["momentum"].clone()]
                        fn(t, sts, sg.ids, sg.valid, sg.segments, sg.weights,
                           sg.grad_seg, cfg.optim.value, cfg.learning_rate,
                           eps=cfg.eps)
                        res.append([t] + sts)
                    torch.cuda.synchronize()
                    err = max(float((a - b).abs().max())
                              for a, b in zip(*res))
                    b6[name] = {"equal": all(torch.equal(a, b)
                                             for a, b in zip(*res)),
                                "slots": int(sg.ids.numel()),
                                "max_abs_err": err}
                    errs.append({"phase": "sharded_kernel",
                                 "stage": "sharded_ec", "rank": r,
                                 "plan": kind, "group": name,
                                 "b6_max_abs_err": err})
                    del res
            _, counts = _counted(lambda: ec.backward_and_update_local(
                params, fused, ctxs, grads, cfg, env))
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            if set(counts) != {"dedup_fused_sparse_update"}:
                raise AssertionError(f"sharded_ec {kind}: an update "
                                     f"launched {counts}")
        full = ec.tables_to_weights(ec.gather_stacks(params, env))
        rec["b6"] = b6
        if r == 0:
            ref = _ec_reference(dev, tables, weights, plan, kjts, cfg)
            rec["tables_equal_one_device"] = all(
                np.array_equal(full[t].cpu().numpy(), ref[t]) for t in ref)
            rec["table_max_abs_err_vs_one_device"] = max(
                float(np.abs(full[t].cpu().numpy() - ref[t]).max())
                for t in ref)
        out[kind] = rec
        if not (rec["rows_equal_dedup_False"] and rec["rows_equal_dedup_True"]
                and all(v["equal"] for v in b6.values())
                and rec.get("tables_equal_one_device", True)):
            raise AssertionError(f"sharded_ec {kind}: {rec}")
        del ec, params, fused, full
        torch.cuda.empty_cache()
    return (_stage_record("sharded_ec", t0, **out, caps=sorted(
        set(caps.values()))), launches, errs)


def sharded_stages(dev, env, caps, host, mine, refs):
    """The stages after the plans, in the same launch: all_reduce, split
    and chunked_a2a on the tw plan, qcomms on the rw plan, the two 2D
    strategies over 2 replicas of 2 model ranks, and the sharded EC.
    Returns (records, launches by kernel, the kernel checks' records)."""
    import torch

    from torchrec_tpu_torch.parallel.comm import ShardingEnv

    records, launches, kchecks = [], {}, []

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    _, tables = bench_tables()
    dmp, state = sharded_dmp(dev, sharded_plan("tw", tables, env.world_size),
                             TRAIN_BATCH, caps, env)
    records.append(all_reduce_stage(dmp, state, mine[0]))
    rec, counts = split_stage(dmp, state, mine[0])
    records.append(rec)
    add(counts)
    records.append(chunked_a2a_stage(dmp, state, mine[0]))
    del dmp, state
    torch.cuda.empty_cache()
    rec, counts = qcomms_stage(dev, env, caps, mine, tables)
    records.append(rec)
    add(counts)
    env2 = ShardingEnv.from_process_group("gloo", device=dev,
                                          num_replicas=DMP2D_REPLICAS)
    for strategy in ("replicated", "fully_sharded"):
        rec, counts, checks = dmp2d_stage(strategy, dev, env2, caps, host,
                                          mine, refs)
        records.append(rec)
        add(counts)
        kchecks += checks
    rec, counts, checks = sharded_ec_stage(dev, env)
    records.append(rec)
    add(counts)
    kchecks += checks
    return records, launches, kchecks


# -- the dedup'd row-wise dist across the 4 ranks, in the same launch -------

DEDUP_RW_BUDGET_S = 60
DEDUP_RW_STEPS = 2  # every table row-wise: dedup'd against plain
DEDUP_MIXED_STEPS = 2  # the mixed plan, guarded against unguarded
# tests/test_dedup_lookup.py:316-323, the JAX package's dedup-vs-plain bound
DEDUP_RW_RTOL, DEDUP_RW_ATOL = 1e-5, 1e-6
DEDUP_POISON_KEY = "cat_0"  # a dedup'd row-wise key of the mixed plan
# a row's n float32 gradient addends summed in two orders differ by at most
# 2 (n - 1) u sum ||g||; through rowwise Adagrad's first step (g / rms(g))
# that moves an element by at most 4 lr (n - 1) u sqrt(D) / c, where
# c = ||sum g|| / sum ||g|| (the row's cancellation ratio).  A row may leave
# the bound above only at a step where that reaches DEDUP_RW_ATOL
DEDUP_RW_U = 2.0 ** -24  # float32's unit roundoff
# the bucketed semi-sync pipeline on ranks of unequal traffic: rank s % N
# keeps the first KEEP[1] examples of its batch of step s, the others
# KEEP[0]; at this factor the heavier rank alone passes the signature's
# dedup capacity, so every rank must follow it to the full-caps program
DEDUP_PIPE_FACTOR, DEDUP_PIPE_KEEP, DEDUP_PIPE_STEPS = 8.0, (256, 1024), 4


def dedup_plan(kind, tables, n, factor=1.0):
    """``rw_dedup``: every table row-wise with ``dedup``; ``mixed_dedup``:
    the sharded phase's mixed plan with ``dedup`` on its row-wise tables;
    ``factor`` their ``dedup_factor``."""
    import dataclasses

    from torchrec_tpu_torch.parallel.types import ShardingType

    base = sharded_plan("rw" if kind == "rw_dedup" else "mixed", tables, n)
    return {name: (dataclasses.replace(ps, dedup=True, dedup_factor=factor)
                   if ps.sharding_type == ShardingType.ROW_WISE else ps)
            for name, ps in base.items()}


def _measured_duplication(kjt):
    """Real ids over distinct (feature, id) pairs of a KJT (host)."""
    lens, values = kjt.lengths().cpu().numpy(), kjt.values().cpu().numpy()
    B = kjt.stride()
    real = distinct = 0
    for f in range(kjt.num_keys):
        start = kjt.cap_offsets()[f]
        ids = values[start:start + int(lens[f * B:(f + 1) * B].sum())]
        real += ids.size
        distinct += np.unique(ids).size
    return real / max(1, distinct)


def dedup_rw_kernel_check(ded, st_d, p4, st_p, batch, flush):
    """This rank's kernels of the stage at its shapes: B1 over the rows
    the dedup'd group got back (its source pooling), B2 on that group's
    per-id gradients, B4 over the plain row-wise group's received slots
    and B6 on its gradient, each ``torch.equal`` to its plain version
    (collectives: every rank calls it).  Returns the records."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.ops.embedding_ops import (
        sequence_embedding_lookup,
    )
    from torchrec_tpu_torch.parallel.comm import all_to_all
    from torchrec_tpu_torch.parallel.sharding.rw import _source_regions

    env, recs = ded.env, []
    for dmp, state, kind in ((ded, st_d, "rw_dedup"), (p4, st_p, "rw")):
        ebc = dmp.sharded_ebc
        with torch.no_grad():
            kt, ctxs = dmp.sparse_forward(state, batch)
        _, _, _, grads = dmp.dense_forward_backward(state, batch, kt)
        sgs = ebc.backward_local(ctxs, grads, env)  # collectives
        (name, lay), = ebc.rw_layouts.items()
        stack = state["tables"][name]
        R, D = stack.shape
        # the kernels run rowwise Adagrad on a fresh momentum
        mom = torch.zeros(R, dtype=torch.float32, device=stack.device)
        sg = sgs[name]
        if kind == "rw_dedup":
            ids_recv, valid_recv, ids, _, w, _ = ctxs[name]
            rows = sequence_embedding_lookup(stack, ids_recv.reshape(-1),
                                             valid_recv.reshape(-1))
            back = all_to_all(rows.view(tuple(ids_recv.shape) + (D,)), env)
            table = torch.cat([back.reshape(-1, D), back.new_zeros((1, D))])
            del rows, back  # 4 ranks share the card: keep one copy
            regions = _source_regions(lay, batch.sparse_features)
            segs, S = regions.segment_ids(ids.shape[0]), regions.num_segments
            got = tbe.pooled_lookup_regions(table, ids, regions, w)
            ref = tbe.pooled_lookup_regions_plain(table, ids, regions, w)
            # and the backward's sum by send slot (B1's sorted entry)
            g_cat = torch.cat([grads[f.name].float() for f in lay.features])
            seg_g, sent = ctxs[name][3], ids_recv.numel()
            sorted_eq = bool(torch.equal(
                tbe.pooled_lookup(g_cat, seg_g, ids, sent, w),
                tbe.pooled_lookup_plain(g_cat, seg_g, ids, sent, w)))
            del g_cat
            lk, upd = "b1", (tbe_backward.fused_sparse_update,
                             tbe_backward.fused_sparse_update_plain)
        else:
            ids, w, segs, regions = ctxs[name]
            S, table = regions.num_segments, stack
            got = tbe.dedup_pooled_lookup(table, ids, segs, S, w)
            ref = tbe.dedup_pooled_lookup_plain(table, ids, segs, S, w)
            lk, upd = "b4", (tbe_backward.dedup_fused_sparse_update,
                             tbe_backward.dedup_fused_sparse_update_plain)
            sorted_eq = True
        ub = "b2" if kind == "rw_dedup" else "b6"
        outs = []
        for fn in upd:
            t, m = stack.clone(), mom.clone()
            if ub == "b2":
                _update_call(fn, t, [m], "rowwise_adagrad", sg, TRAIN_LR,
                             None, (1.0, 1.0))
            else:
                _b6_call(fn, t, [m], sg, TRAIN_LR)
            outs.append((t, m))
        torch.cuda.synchronize()
        rec = {"phase": "dedup_rw_kernel", "rank": env.rank, "plan": kind,
               "group": name, "stack": [R, D],
               "lookup_table_rows": int(table.shape[0]),
               "slots": int(ids.numel()), "segments": S,
               "update_slots": int(sg.ids.numel()),
               "update_valid_slots": int(sg.ok().sum()),
               f"{lk}_equal": bool(torch.equal(got, ref)),
               f"{ub}_equal": all(torch.equal(a, b) for a, b in zip(*outs)),
               f"{lk}_max_abs_err": float((got.float() - ref.float())
                                          .abs().max()),
               f"{ub}_max_abs_err": max(float((a - b).abs().max())
                                        for a, b in zip(*outs)),
               "gradient_sum_b1_sorted_equal": sorted_eq}
        _, nbytes, flops = _b1_bound(table.shape[0], D, table.element_size(),
                                     ids, segs, w, S)
        rec[f"{lk}_bound_ms"] = _bound(nbytes, flops)[0]
        _, nbytes, flops = _update_bound(D, stack.element_size(), sg,
                                         "rowwise_adagrad")
        rec[f"{ub}_bound_ms"] = _bound(nbytes, flops)[0]
        if not (rec[f"{lk}_equal"] and rec[f"{ub}_equal"] and sorted_eq):
            raise AssertionError(f"dedup_rw kernel check failed: {rec}")
        del outs, got, ref, table, sgs, sg, ctxs, kt, grads
        torch.cuda.empty_cache()  # for the other ranks on the card
        recs.append(rec)
    return recs


def dedup_update_check(ded, plain, st_d, st_p, batch):
    """The JAX package's dedup-against-plain contract
    (``tests/test_dedup_lookup.py:294-330``): one rowwise-Adagrad update
    (lr 0.05) of copies of the two plans' stacks with each rank's pooled
    outputs times 2 as the gradients, on ``batch``.  Returns (whether the
    stacks agree within rtol 1e-5 / atol 1e-6, the largest difference)."""
    import torch

    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )

    cfg = FusedOptimConfig(optim=EmbOptimType.ROWWISE_ADAGRAD,
                           learning_rate=0.05)
    stacks = []
    for dmp, st in ((ded, st_d), (plain, st_p)):
        ebc = dmp.sharded_ebc
        params = {n: t.clone() for n, t in st["tables"].items()}
        fused = ebc.init_fused_state(cfg, dmp.device)
        with torch.no_grad():
            outs, ctxs = ebc.forward_local(params, batch.sparse_features,
                                           env=dmp.env)
        ebc.backward_and_update_local(
            params, fused, ctxs, {f: 2.0 * o.float() for f, o in outs.items()},
            cfg, env=dmp.env)
        stacks.append(params)
    return _local_stacks_close({"tables": stacks[0]}, {"tables": stacks[1]},
                               DEDUP_RW_RTOL, DEDUP_RW_ATOL)


def _local_stacks_close(a, b, rtol, atol):
    """Whether two states' stacks (one group each, the same layout) agree
    within the tolerance, and the largest difference."""
    import torch

    (x,), (y,) = a["tables"].values(), b["tables"].values()
    return (bool(torch.allclose(x, y, rtol=rtol, atol=atol)),
            float((x - y).abs().max()))


def _row_grad_sums(dmp, state, batch, upstream=None):
    """The row-wise group's gradient of ``batch`` at ``state``, before the
    update, on this rank's stack rows: (each row's slot gradients summed
    in float64, their count, the sum of their norms, the upstream
    gradients by feature).  ``upstream``: gradients by feature to use in
    place of the step's own (the group's dist alone then differs)."""
    import torch

    ebc = dmp.sharded_ebc
    (name, _), = ebc.rw_layouts.items()
    R, D = state["tables"][name].shape
    with torch.no_grad():
        kt, ctxs = dmp.sparse_forward(state, batch)
    if upstream is None:
        _, _, _, upstream = dmp.dense_forward_backward(state, batch, kt)
    sg = ebc.backward_local(ctxs, upstream, dmp.env)[name]
    ok = sg.ok()
    ids, rg = sg.ids[ok].long(), sg.row_grads()[ok].double()
    g = rg.new_zeros((R, D)).index_add_(0, ids, rg)
    mass = rg.new_zeros(R).index_add_(0, ids, rg.norm(dim=1))
    return g, torch.bincount(ids, minlength=R), mass, upstream


class _FirstOff:
    """Per stack row, the step at which two stacks first left the JAX
    bound (rtol 1e-5 / atol 1e-6) and that step's readings."""

    def __init__(self, R, dev):
        import torch

        self.step = torch.full((R,), -1, dtype=torch.int64, device=dev)
        self.at = {}

    def update(self, t, x, y, **readings):
        import torch

        off = ~torch.isclose(x, y, rtol=DEDUP_RW_RTOL,
                             atol=DEDUP_RW_ATOL).all(1)
        new = off & (self.step < 0)
        self.step[new] = t
        for k, v in readings.items():
            if k not in self.at:
                self.at[k] = torch.zeros_like(v)
            self.at[k][new] = v[new]

    def record(self, x, y, explained, steps):
        """Counts, errors and the readings' spread over the rows off."""
        import torch

        err = (x - y).abs().amax(1)
        off = self.step >= 0
        rec = {"rows_off": int(off.sum()), "rows_off_explained": int(
            (off & explained).sum()), "max_abs_err": float(err.max()),
            "max_abs_err_rows_in_bound": float(err[~off].max())}
        if off.any():
            rec["first_off_step"] = torch.bincount(
                self.step[off], minlength=steps).tolist()
            rec["err_median"] = float(err[off].median())
            for k, v in self.at.items():
                v = v[off].double()
                rec[f"{k}_min_median_max"] = [float(v.min()),
                                              float(v.median()),
                                              float(v.max())]
        return rec


def dedup_rw_lockstep(ded, st_d, plain, st_p, batches, steps):
    """``steps`` rowwise-Adagrad train steps of the dedup'd (D) and the
    plain (P) row-wise plans in lockstep from the same state on the same
    batches, and a third state (S): the dedup'd tables updated by the
    dedup'd dist with P's own upstream gradients each step, so that S and
    P differ only by the order in which the two dists sum a row's slots.

    Before each step it reads, per row, the slot count n, the
    cancellation ratio c = ||sum g|| / sum ||g|| of P's gradient and the
    relative difference rho = ||G_D - G_P|| / ||G_P|| of the two runs'
    float64 row sums (what their dense parts fed them).  Summing n
    float32 addends in another order moves rowwise Adagrad's first step
    by at most 4 lr (n - 1) u sqrt(D) / c an element (``DEDUP_RW_U``), a
    relative gradient difference rho by at most 2 lr sqrt(D) rho.  A row
    of S may leave the JAX bound only at a step where the first reaches
    ``DEDUP_RW_ATOL``; a row of D only where the first or the second
    does.  Raises on a row neither explains, or on losses of D and P
    further apart than rtol 1e-5.  Returns (D's state, its losses and
    step seconds, P's step seconds, D's launches, the record)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    (name_d,), (name_p,) = st_d["tables"], st_p["tables"]
    R, D = st_d["tables"][name_d].shape
    dev = st_d["tables"][name_d].device
    ebc = ded.sharded_ebc
    st_s = {"tables": {name_d: st_d["tables"][name_d].clone()},
            "fused": ebc.init_fused_state(ded.fused_config, dev)}
    sp, dp = _FirstOff(R, dev), _FirstOff(R, dev)
    losses_d, losses_p, dt_d, dt_p, counts, typical = [], [], 0.0, 0.0, {}, []
    for t in range(steps):
        b = batches[t % len(batches)]
        g_p, n, mass, upstream = _row_grad_sums(plain, st_p, b)
        g_d = _row_grad_sums(ded, st_d, b)[0]
        norm = g_p.norm(dim=1)
        typical.append(float(norm[n > 0].median()))
        c = torch.where(mass > 0, norm / mass.clamp_min(1e-300), 1.0)
        rho = torch.where(norm > 0, (g_d - g_p).norm(dim=1)
                          / norm.clamp_min(1e-300),
                          (g_d - g_p).norm(dim=1).gt(0).double())
        del g_p, g_d
        with torch.no_grad():
            _, ctxs = ded.sparse_forward(st_s, b)
        ebc.backward_and_update_local(
            st_s["tables"], st_s["fused"], ctxs, upstream, ded.fused_config,
            update_kernel=ded.update_kernel, env=ded.env)
        torch.cuda.synchronize()
        tbe.reset_launch_counts()
        t0 = time.perf_counter()
        st_d, m = ded.train_step(st_d, b)
        losses_d.append(float(m["loss"]))
        torch.cuda.synchronize()
        dt_d += time.perf_counter() - t0
        for k, v in tbe.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        t0 = time.perf_counter()
        st_p, m = plain.train_step(st_p, b)
        losses_p.append(float(m["loss"]))
        torch.cuda.synchronize()
        dt_p += time.perf_counter() - t0
        readings = dict(slots=n, cancellation=c, rho=rho,
                        grad_norm_over_typical=norm / typical[-1])
        y = st_p["tables"][name_p]
        sp.update(t, st_s["tables"][name_d], y, **readings)
        dp.update(t, st_d["tables"][name_d], y, **readings)

    def reach(first):
        at = first.at
        if not at:
            return torch.zeros(R, dtype=torch.bool, device=dev), None
        assoc = (4 * TRAIN_LR * (at["slots"] - 1).clamp_min(0) * DEDUP_RW_U
                 * D ** 0.5 / at["cancellation"].clamp_min(1e-300))
        up = 2 * TRAIN_LR * D ** 0.5 * at["rho"]
        return assoc >= DEDUP_RW_ATOL, up >= DEDUP_RW_ATOL

    y = st_p["tables"][name_p]
    assoc_s, _ = reach(sp)
    assoc_d, up_d = reach(dp)
    explained_d = assoc_d if up_d is None else assoc_d | up_d
    rec = {"typical_row_grad_norm_by_step": typical,
           "losses_max_rel_diff": float(np.max(np.abs(
               np.subtract(losses_d, losses_p)) / np.abs(losses_p))),
           "shared_upstream_vs_plain": sp.record(
               st_s["tables"][name_d], y, assoc_s, steps),
           "trained_vs_plain": dp.record(
               st_d["tables"][name_d], y, explained_d, steps)}
    if up_d is not None:
        off = dp.step >= 0
        rec["trained_vs_plain"]["rows_off_by_upstream_only"] = int(
            (off & up_d & ~assoc_d).sum())
    bad = [k for k in ("shared_upstream_vs_plain", "trained_vs_plain")
           if rec[k]["rows_off"] != rec[k]["rows_off_explained"]]
    if bad or rec["losses_max_rel_diff"] > DEDUP_RW_RTOL:
        raise AssertionError(f"dedup_rw rank {ded.env.rank}: {bad} rows "
                             f"off the plain plan unexplained, or losses "
                             f"apart: {rec}")
    del st_s
    return st_d, losses_d, losses_p, dt_d, dt_p, counts, rec


def _thin_batch(batch, keep):
    """``batch`` (on the host) with the ids of its first ``keep``
    examples only, the caps kept: a rank with little traffic."""
    import dataclasses

    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    kjt = batch.sparse_features
    B, lens = kjt.stride(), kjt.lengths().numpy().copy()
    values, w = kjt.values().numpy(), kjt.weights_or_none()
    vals, ws = [], []
    for f in range(kjt.num_keys):
        start = kjt.cap_offsets()[f]
        n = int(lens[f * B:f * B + keep].sum())
        vals.append(values[start:start + n])
        if w is not None:
            ws.append(w.numpy()[start:start + n])
        lens[f * B + keep:(f + 1) * B] = 0
    return dataclasses.replace(
        batch, sparse_features=KeyedJaggedTensor.from_lengths_packed(
            kjt.keys(), np.concatenate(vals), lens,
            np.concatenate(ws) if ws else None, caps=kjt.caps))


def bucketed_agreement_check(dev, env, caps, tables, batches):
    """``BucketedTrainPipelineSemiSync`` on the ``rw_dedup`` plan at
    ``DEDUP_PIPE_FACTOR`` over a stream where rank ``s % N`` keeps more of
    its batch than the others (``DEDUP_PIPE_KEEP``): every rank dispatched
    the signature that the all-gathered occupancies and dedup demands give
    (the full caps where the largest demand passes the signature's
    capacity) and counted the same downgrades, some rank's own view
    differing; at least one step where one rank alone passes the
    capacity; no id dropped, losses finite.  With the CPU
    profiler's host ms a batch of ``pipeline/bucketize`` (its occupancy
    all-gather waits for the card's queue) and ``pipeline/step_dispatch``.
    Returns the record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchrec_tpu_torch.parallel import train_pipeline as tp
    from torchrec_tpu_torch.parallel.comm import all_gather
    from torchrec_tpu_torch.parallel.sharding.rw import dedup_cap_for
    from torchrec_tpu_torch.sparse.jagged_tensor import bucketed_cap

    t0 = time.perf_counter()
    r, N = env.rank, env.world_size
    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    stream = [_thin_batch(b.to("cpu"), DEDUP_PIPE_KEEP[int(s % N == r)])
              for s, b in enumerate(batches[:DEDUP_PIPE_STEPS])]
    dmp, state = sharded_dmp(dev, dedup_plan("rw_dedup", tables, N,
                                             DEDUP_PIPE_FACTOR),
                             TRAIN_BATCH, caps, env)
    (lay,) = dmp.sharded_ebc.rw_layouts.values()
    pipe = tp.BucketedTrainPipelineSemiSync(dmp, state)
    it, sigs, losses, dropped = iter(stream), [], [], []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in stream:
            before = dict(pipe.stats.dispatch_counts)
            m = pipe.progress(it)
            (sig,) = [g for g, c in pipe.stats.dispatch_counts.items()
                      if c != before.get(g, 0)]
            sigs.append(list(sig))
            losses.append(float(m["loss"]))
            dropped.append(int(m["dedup_overflow"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1  # the profiler's teardown left out
    host_ms = {e.key: e.cpu_time_total / e.count / 1e3
               for e in prof.key_averages()
               if e.key in ("pipeline/bucketize", "pipeline/step_dispatch")}
    local = torch.tensor(
        [list(b.sparse_features.occupancy_per_key())
         + [tp._dedup_demand(lay, [b])] for b in stream], dtype=torch.int64)
    views = all_gather(local.to(dev), env).cpu().tolist()  # [N][S][F + 1]
    got = all_gather(torch.tensor(
        [g + [pipe.stats.overflow_fallback_count] for g in sigs],
        dtype=torch.int64, device=dev), env).cpu().tolist()
    full = [caps[k] for k in keys]
    want, downgrades, split = [], 0, 0
    for s in range(len(stream)):
        occ = [v[s][:-1] for v in views]
        demands = [v[s][-1] for v in views]
        sig = [bucketed_cap(max(o[f] for o in occ), full[f])
               for f in range(len(keys))]
        cap = dedup_cap_for(lay.features, dict(zip(keys, sig)),
                            lay.block_size, lay.dedup_factor)
        downgrades += max(demands) > cap
        want.append(full if max(demands) > cap else sig)
        own = {tuple(bucketed_cap(x, c) for x, c in zip(o, full))
               for o in occ}
        split += len(own) > 1 and min(demands) <= cap < max(demands)
    agreed = all([g[:-1] for g in rank] == want
                 and all(g[-1] == downgrades for g in rank) for rank in got)
    rec = {"phase": "dedup_rw_bucketed", "rank": r, "ranks": N,
           "note": ONE_CARD, "dedup_factor": DEDUP_PIPE_FACTOR,
           "keep": list(DEDUP_PIPE_KEEP), "steps": len(stream),
           "signature_max_by_step": [max(g) for g in sigs],
           "downgrades": pipe.stats.overflow_fallback_count,
           "expected_downgrades": downgrades,
           "steps_where_ranks_split": split,
           "demands_by_step": [[v[s][-1] for v in views]
                               for s in range(len(stream))],
           "ranks_agree": agreed, "dedup_overflow": dropped,
           "losses": losses, "ms_per_step": wall * 1e3 / len(stream),
           "host_ms_per_batch": host_ms,
           "seconds": time.perf_counter() - t0}
    if not (agreed and split > 0 and downgrades > 0 and not any(dropped)
            and np.isfinite(losses).all()):
        raise AssertionError(f"dedup_rw rank {r}: bucketed pipeline {rec}")
    del pipe, dmp, state
    torch.cuda.empty_cache()
    return rec


def dedup_rw_stage(dev, env, caps, mine, ebc, flush):
    """The dedup'd row-wise dist on the 4 ranks: ``rw_dedup`` (B1 pools at
    the source and sums the gradients by send slot, B2 updates) and
    ``mixed_dedup`` (the dedup kernels; guardrails on, against the same
    plan unguarded).  On each rank's weighted multi-hot batch
    (``multi_hot_batch``): the KTs ``torch.equal`` to the unsharded
    collection's; the id dist at most the plain row-wise plan's bytes over
    the measured duplication; B1, B2, B4 and B6 ``torch.equal`` to their
    plain versions at this rank's shapes; on the plain row-wise plan B4's
    KT = B1's.  On the one-id stream (``mine``; at factor 1 a multi-hot
    step would ship every rank a [4, 26, 25,000, 128] float32 block of
    rows each way): ``DEDUP_RW_STEPS`` rowwise-Adagrad steps beside the
    plain row-wise plan, every row off the JAX bound explained
    (``dedup_rw_lockstep``); the bucketed semi-sync pipeline's signatures
    agreed across ranks (``bucketed_agreement_check``); guarded =
    unguarded; a poisoned batch's ``id_violations`` summed over ranks =
    the injected count.  Returns (record, launches, kernel records)."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.qcomm import wire_accounting
    from torchrec_tpu_torch.robustness import GuardrailsConfig

    t0 = time.perf_counter()
    r, N = env.rank, env.world_size
    _, tables = bench_tables()
    mh_caps, mh_kjt = multi_hot_batch(env)
    dup = _measured_duplication(mh_kjt)
    mh = _with_kjt(mine[0], mh_kjt.to(dev))
    with torch.no_grad():
        ref_kt = ebc(mh.sparse_features)
    plain, st_p = sharded_dmp(dev, sharded_plan("rw", tables, N),
                              TRAIN_BATCH, caps, env)
    ded, st_d = sharded_dmp(dev, dedup_plan("rw_dedup", tables, N),
                            TRAIN_BATCH, caps, env)
    plain_mh, ded_mh = (plain.with_feature_caps(mh_caps),
                        ded.with_feature_caps(mh_caps))
    p4_mh = plain.with_feature_caps(mh_caps, "dedup", "dedup")
    with torch.no_grad():
        kt_d, _ = ded_mh.sparse_forward(st_d, mh)
        kt_p, _ = plain_mh.sparse_forward(st_p, mh)
        kt_4, _ = p4_mh.sparse_forward(st_p, mh)
    fwd = _kt_check(_kt(ded_mh, kt_d), ref_kt,
                    group_kind_of_features(ded_mh), exact_all=True)
    b4_equal = bool(torch.equal(kt_4, kt_p))
    if not b4_equal:
        raise AssertionError("dedup_rw: B4's KT != B1's on the plain "
                             "row-wise plan")
    ledgers = {}
    for name, dmp, st in (("plain", plain_mh, st_p), ("dedup", ded_mh, st_d)):
        with wire_accounting() as led, torch.no_grad():
            dmp.sparse_forward(st, mh)
        ledgers[name] = sum(v for k, v in led.items() if ":id_dist" in k)
    if not 0 < ledgers["dedup"] <= ledgers["plain"] / dup:
        raise AssertionError(f"dedup_rw: id dist {ledgers} at duplication "
                             f"{dup}")
    kchecks = dedup_rw_kernel_check(ded_mh, st_d, p4_mh, st_p, mh, flush)
    update_close, update_err = dedup_update_check(ded_mh, plain_mh, st_d,
                                                  st_p, mh)
    if not update_close:
        raise AssertionError(f"dedup_rw rank {r}: one multi-hot update off "
                             f"the plain row-wise plan's by {update_err}")
    del plain_mh, ded_mh, p4_mh, kt_d, kt_p, kt_4
    torch.cuda.empty_cache()
    t_checks = time.perf_counter() - t0

    kchecks += dedup_rw_kernel_check(
        ded, st_d, plain.with_feature_caps(caps, "dedup", "dedup"), st_p,
        mine[0], flush)
    with torch.no_grad():  # one id an example: every sum exact
        one_id_kt_equal = bool(torch.equal(
            ded.sparse_forward(st_d, mine[0])[0],
            plain.sparse_forward(st_p, mine[0])[0]))
    if not one_id_kt_equal:
        raise AssertionError(f"dedup_rw rank {r}: one-id KT != plain RW's")
    # main path 1: rw_dedup, DEDUP_RW_STEPS rowwise-Adagrad steps (B1 +
    # B2), each beside the plain row-wise plan's on the same batch
    st_d, loss_d, loss_p, dt_d, dt_p, counts_d, attribution = (
        dedup_rw_lockstep(ded, st_d, plain, st_p, mine, DEDUP_RW_STEPS))
    counts_d = {k: v for k, v in counts_d.items() if v}
    if (counts_d.get("pooled_lookup", 0) < DEDUP_RW_STEPS
            or counts_d.get("fused_sparse_update", 0) < DEDUP_RW_STEPS
            or set(counts_d) - {"pooled_lookup", "fused_sparse_update"}):
        raise AssertionError(f"dedup_rw rank {r}: launched {counts_d}")
    del plain, st_p, ded, st_d
    torch.cuda.empty_cache()
    # main path 1b: the bucketed semi-sync pipeline across the ranks
    bucketed = bucketed_agreement_check(dev, env, caps, tables, mine)

    # main path 2: mixed_dedup, guarded against unguarded
    plan = dedup_plan("mixed_dedup", tables, N)
    kw = dict(lookup_kernel="dedup", update_kernel="dedup")
    gdmp, st_g = sharded_dmp(dev, plan, TRAIN_BATCH, caps, env,
                             guardrails=GuardrailsConfig(), **kw)
    udmp, st_u = sharded_dmp(dev, plan, TRAIN_BATCH, caps, env, **kw)
    g_mh = gdmp.with_feature_caps(mh_caps)
    with torch.no_grad():
        kt_g, _ = g_mh.sparse_forward(st_g, mh)
    mixed_fwd = _kt_check(_kt(g_mh, kt_g), ref_kt,
                          group_kind_of_features(g_mh), exact_all=True)
    del g_mh, kt_g
    torch.cuda.synchronize()
    tbe.reset_launch_counts()
    st_g, loss_g, dt_g = _train_steps(gdmp, st_g, mine, DEDUP_MIXED_STEPS)
    counts_g = {k: v for k, v in tbe.launch_counts().items() if v}
    st_u, loss_u, _ = _train_steps(udmp, st_u, mine, DEDUP_MIXED_STEPS)
    guarded_equal = loss_g == loss_u and _state_equal(st_g, st_u)
    if (set(counts_g) != {"pooled_lookup", "dedup_pooled_lookup",
                          "dedup_fused_sparse_update"}
            or min(counts_g.values()) < DEDUP_MIXED_STEPS):
        raise AssertionError(f"mixed_dedup rank {r}: launched {counts_g}")
    poisoned = _poisoned(mine[DEDUP_MIXED_STEPS % len(mine)], {
        DEDUP_POISON_KEY: (TRAIN_ROWS,) * (r + 1)})
    _, m = gdmp.train_step(st_g, poisoned)
    viol = dict(zip(gdmp.sharded_ebc.feature_order,
                    m["id_violations"].tolist()))
    injected = N * (N + 1) // 2
    if not (guarded_equal and viol[DEDUP_POISON_KEY] == injected
            and sum(viol.values()) == injected):
        raise AssertionError(f"mixed_dedup rank {r}: guarded = unguarded "
                             f"{guarded_equal}, violations {viol}")
    launches = {k: counts_d.get(k, 0) + counts_g.get(k, 0)
                for k in set(counts_d) | set(counts_g)}
    rec = {"phase": "dedup_rw", "rank": r, "ranks": N, "backend": "gloo",
           "note": ONE_CARD, "batch_per_rank": TRAIN_BATCH,
           "multi_hot_caps": sorted(set(mh_caps.values())),
           "kt_equal_features": fwd[0], "kt_max_abs_err": fwd[1],
           "mixed_kt_equal_features": mixed_fwd[0],
           "b4_kt_equal_b1_plain_rw": b4_equal,
           "id_dist_bytes_multi_hot": ledgers, "measured_duplication": dup,
           "rw_dedup_losses": loss_d, "plain_rw_losses": loss_p,
           "rw_dedup_ms_per_step": dt_d * 1e3 / DEDUP_RW_STEPS,
           "plain_rw_ms_per_step": dt_p * 1e3 / DEDUP_RW_STEPS,
           "one_id_kt_equal_plain_rw": one_id_kt_equal,
           "tables_vs_plain_rw_adagrad": attribution,
           "multi_hot_update_max_abs_err_vs_plain_rw": update_err,
           "mixed_dedup_guarded_losses": loss_g,
           "mixed_dedup_guarded_ms_per_step": dt_g * 1e3 / DEDUP_MIXED_STEPS,
           "guarded_equal_unguarded": guarded_equal,
           "poisoned_id_violations": {k: v for k, v in viol.items() if v},
           "injected_over_ranks": injected,
           "launches": {"rw_dedup": counts_d, "mixed_dedup": counts_g},
           "checks_seconds": t_checks,
           "seconds": time.perf_counter() - t0,
           "budget_s": DEDUP_RW_BUDGET_S}
    if not np.isfinite(loss_d + loss_p + loss_g).all():
        raise AssertionError(f"dedup_rw rank {r}: losses {rec}")
    del gdmp, udmp, st_g, st_u
    torch.cuda.empty_cache()
    return rec, launches, kchecks + [bucketed]


# -- variable-batch (VBE) KJTs through the sharded collection, 4 ranks ------

VBE_BUDGET_S = 30
# table- and row-wise run inside "mixed" (the run's time limit)
VBE_PLANS = ("rw_dedup", "twrw", "mixed")  # dp: in mixed
VBE_REDUCED = 13  # the last 13 features: one row per 4 examples
VBE_SHARE = 4  # examples sharing a reduced row (a request's candidates)


def vbe_kjts(kjt, with_expanded=True):
    """``kjt`` (a uniform KJT of ``TRAIN_BATCH`` examples) as a
    variable-batch one, on the host: its first ``TRAIN_FEATURES -
    VBE_REDUCED`` keys at the full stride, the last ``VBE_REDUCED`` at
    stride ``TRAIN_BATCH / VBE_SHARE`` (each key's first rows), example
    ``b`` reading reduced row ``b // VBE_SHARE``; and the same batch
    expanded to the full stride (each example its reduced row's ids),
    when ``with_expanded``.  Returns (vbe, expanded or None)."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    kjt = kjt.to("cpu")
    keys, B = kjt.keys(), kjt.stride()
    R = B // VBE_SHARE
    w = kjt.weights_or_none()
    full = len(keys) - VBE_REDUCED
    lens, vals, ws, spk, inv = [], [], [], [], []
    exp_lens, exp_vals, exp_ws = [], [], []
    co = kjt.cap_offsets()
    for f in range(len(keys)):
        ln = kjt.lengths_for_key(f).numpy()
        n = R if f >= full else B
        offs = np.concatenate([[0], np.cumsum(ln)])
        v = kjt.values()[co[f]:co[f] + int(offs[n])].numpy()
        wt = None if w is None else w[co[f]:co[f] + int(offs[n])].numpy()
        lens.append(ln[:n])
        vals.append(v)
        if wt is not None:
            ws.append(wt)
        spk.append(n)
        rows = (np.arange(B) // VBE_SHARE if f >= full else np.arange(B))
        inv.append(rows)
        if with_expanded:
            exp_lens.append(ln[rows])
            exp_vals += [v[offs[r]:offs[r + 1]] for r in rows]
            if wt is not None:
                exp_ws += [wt[offs[r]:offs[r + 1]] for r in rows]
    vbe = KeyedJaggedTensor.from_lengths_packed(
        keys, np.concatenate(vals), np.concatenate(lens),
        np.concatenate(ws) if ws else None, caps=kjt.caps,
        stride_per_key=spk, inverse_indices=np.stack(inv).astype(np.int32))
    expanded = None
    if with_expanded:
        expanded = KeyedJaggedTensor.from_lengths_packed(
            keys, np.concatenate(exp_vals), np.concatenate(exp_lens),
            np.concatenate(exp_ws) if exp_ws else None, caps=kjt.caps)
    return vbe, expanded


def _group_update_check(dmp, state, ctxs, grads):
    """The fused update of every sharded group from this step's
    gradients (the VBE reduction included) against its plain version on
    copies of the rank's stacks: B2, or B6 on a DMP with the dedup update
    kernel; and the VBE reduction's B1 sorted entry against its plain
    version on the first reduced feature.  Returns the largest difference,
    or raises when one is not ``torch.equal``."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward

    ebc, env = dmp.sharded_ebc, dmp.env
    sgs = ebc.backward_local(ctxs, grads, env)  # a collective
    err = 0.0
    inv = ctxs.get("__vbe_inv__")
    if inv is not None:
        f = ebc.feature_order[-1]
        g = grads[f].to(torch.float32).contiguous()
        rows = torch.arange(g.shape[0], dtype=torch.int32, device=g.device)
        a = tbe.pooled_lookup(g, rows, inv[f], g.shape[0])
        b = tbe.pooled_lookup_plain(g, rows, inv[f], g.shape[0])
        if not torch.equal(a, b):
            raise AssertionError("the VBE reduction: B1 != plain")
    for name, sg in sgs.items():
        stack = state["tables"][name]
        states = [state["fused"][name][k] for k in ("momentum", "m", "v")
                  if k in state["fused"][name]]
        outs = []
        for plain in (False, True):
            t, st = stack.clone(), [x.clone() for x in states]
            if dmp.update_kernel == "tbe":
                fn = (tbe_backward.fused_sparse_update_plain if plain
                      else tbe_backward.fused_sparse_update)
                _update_call(fn, t, st, dmp.fused_config.optim.value, sg,
                             TRAIN_LR, None, (1.0, 1.0))
            else:
                fn = (tbe_backward.dedup_fused_sparse_update_plain if plain
                      else tbe_backward.dedup_fused_sparse_update)
                fn(t, st, sg.ids, sg.valid, sg.segments, sg.weights,
                   sg.grad_seg, dmp.fused_config.optim.value, TRAIN_LR,
                   eps=EPS)
            outs.append([t, *st])
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            err = max(err, float((a.float() - b.float()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"group {name}: the fused update != "
                                     f"plain by {err}")
        del outs
    return err


def vbe_stage(dev, env, caps, mine, ebc, mh):
    """VBE batches through the sharded collection on the 4 ranks, every
    plan of ``VBE_PLANS`` (the dedup'd row-wise plan on the dedup update
    kernel): the one-id batch's KT ``torch.equal`` to the unsharded
    collection's VBE forward and to the same batch expanded to the full
    stride; the multi-hot batch's KT against the unsharded collection's
    (table-wise and data-parallel features ``torch.equal``, the others
    within 1e-5); two runs of a VBE step from one state ``torch.equal``;
    the tables after one rowwise-Adagrad step within rtol 1e-5 / atol
    1e-6 of the expanded batch's step; the fused updates (and the VBE
    reduction's B1) ``torch.equal`` to their plain versions at this
    rank's shapes; and each step's launches (B1 and B2; B1 and B6 on the
    dedup plan) and nothing else.  Returns (record, launches)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    t0 = time.perf_counter()
    r, N = env.rank, env.world_size
    _, tables = bench_tables()
    vbe, expanded = vbe_kjts(mine[0].sparse_features)
    b_vbe = _with_kjt(mine[0], vbe.to(dev))
    b_exp = _with_kjt(mine[0], expanded.to(dev))
    mh_caps, mh_kjt = mh
    mh_vbe = vbe_kjts(mh_kjt, with_expanded=False)[0].to(dev)
    launches, per_plan = {}, {}
    with torch.no_grad():
        ref_one = ebc(b_vbe.sparse_features)
        ref_mh = ebc(mh_vbe)
    for kind in VBE_PLANS:
        if kind == "rw_dedup":
            plan, kw = dedup_plan(kind, tables, N), dict(
                lookup_kernel="dedup", update_kernel="dedup")
        else:
            plan, kw = sharded_plan(kind, tables, N), {}
        dmp, state = sharded_dmp(dev, plan, TRAIN_BATCH, caps, env, **kw)
        kinds_of = group_kind_of_features(dmp)
        with torch.no_grad():
            kt, ctxs = dmp.sparse_forward(state, b_vbe)
            one = _kt_check(_kt(dmp, kt), ref_one, kinds_of, exact_all=True)
            kt_exp, _ = dmp.sparse_forward(state, b_exp)
            exp_equal = bool(torch.equal(kt, kt_exp))
            mhd = dmp.with_feature_caps(mh_caps)
            kt_m, _ = mhd.sparse_forward(state, _with_kjt(mine[0], mh_vbe))
            multi = _kt_check(_kt(mhd, kt_m), ref_mh, kinds_of,
                              exact_all=False)
        _, _, _, grads = dmp.dense_forward_backward(state, b_vbe, kt)
        upd_err = _group_update_check(dmp, state, ctxs, grads)
        # one step from the same state: twice on the VBE batch, once on
        # the expanded batch
        runs = []
        for batch in (b_vbe, b_vbe, b_exp):
            st = _clone_state(state)
            torch.cuda.synchronize()
            tbe.reset_launch_counts()
            t_step = time.perf_counter()
            st, m = dmp.train_step(st, batch)
            torch.cuda.synchronize()
            t_step = time.perf_counter() - t_step
            counts = {k: v for k, v in tbe.launch_counts().items() if v}
            runs.append((st, float(m["loss"]), counts, t_step * 1e3))
        twice = _state_equal(runs[0][0], runs[1][0])
        close = all(
            torch.allclose(runs[0][0]["tables"][n].float(),
                           runs[2][0]["tables"][n].float(), rtol=1e-5,
                           atol=1e-6) for n in state["tables"])
        gap = max(float((runs[0][0]["tables"][n].float()
                         - runs[2][0]["tables"][n].float()).abs().max())
                  for n in state["tables"])
        allowed = ({"pooled_lookup", "dedup_fused_sparse_update"}
                   if kind == "rw_dedup"
                   else {"pooled_lookup", "fused_sparse_update"})
        counts = runs[0][2]
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        per_plan[kind] = {
            "one_id_equal_features": one[0],
            "one_id_max_abs_err": one[1], "kt_equal_expanded": exp_equal,
            "multi_hot_equal_features": multi[0],
            "multi_hot_max_abs_err": multi[1],
            "step_twice_equal": twice, "tables_close_expanded_step": close,
            "tables_max_abs_err_vs_expanded": gap,
            "losses": [x[1] for x in runs], "launches": counts,
            "step_ms_vbe_vbe_expanded": [x[3] for x in runs],
            "update_max_abs_err": upd_err}
        if not (exp_equal and twice and close
                and set(counts) <= allowed and counts.get(
                    "pooled_lookup") and len(counts) == 2
                and all(np.isfinite([x[1] for x in runs]))):
            raise AssertionError(f"vbe {kind} rank {r}: {per_plan[kind]}")
        del dmp, state, runs, mhd
        torch.cuda.empty_cache()
    rec = {"phase": "vbe", "rank": r, "ranks": N, "backend": "gloo",
           "note": ONE_CARD, "batch_per_rank": TRAIN_BATCH,
           "reduced_features": VBE_REDUCED,
           "reduced_stride": TRAIN_BATCH // VBE_SHARE, "plans": per_plan,
           "seconds": time.perf_counter() - t0, "budget_s": VBE_BUDGET_S}
    return rec, launches


# -- the two-level (ICI/DCN) dists, 4 ranks as 2 slices x 2 ----------------

HIER_BUDGET_S = 60
HIER_SLICES = 2
HIER_STEPS = 1  # trained steps held to flat (the run's time limit)
# row-wise dedup runs inside "mixed" (the run's time limit)
HIER_PLANS = ("twrw", "mixed")
# the two-level plans' hier_factor: at 1 the DCN request buffer is the
# exactness bound, L * features * send cap rows a destination slice, the
# same bytes the flat dist sends across slices; 2 halves it, and the
# one-id and multi-hot batches here need under a quarter of it (checked:
# dedup_overflow 0)
HIER_FACTOR = 2.0


def hier_plan(kind, tables, n, hier, factor=HIER_FACTOR):
    """``rw_dedup``: every table row-wise with ``dedup``; ``twrw``: every
    table row-wise over a node of 2 ranks (a slice); ``mixed``: the first
    13 tables row-wise with ``dedup``, the others table-wise; with
    ``hier`` (and ``hier_factor=factor``) on every row-wise and
    block-shard entry."""
    import dataclasses

    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType as ST,
    )

    if kind == "rw_dedup":
        base = dedup_plan("rw_dedup", tables, n)
    elif kind == "twrw":
        base = sharded_plan("twrw", tables, n)
    else:
        base = {c.name: (ParameterSharding(ST.ROW_WISE, ranks=list(range(n)),
                                           dedup=True)
                         if i < len(tables) // 2
                         else ParameterSharding(ST.TABLE_WISE,
                                                ranks=[i % n]))
                for i, c in enumerate(tables)}
    return {name: (dataclasses.replace(ps, hier=hier, hier_factor=factor)
                   if ps.sharding_type != ST.TABLE_WISE else ps)
            for name, ps in base.items()}


def _dyadic(dmp, seed):
    """Upstream gradients on a grid of 1/32 (``tests/test_hier_sharding.py``
    's exact regime): every sum of them the dists take is exact."""
    import torch

    ebc = dmp.sharded_ebc
    gen = torch.Generator(device=dmp.device).manual_seed(seed)
    return {f: torch.randint(-4, 5, (TRAIN_BATCH, d), generator=gen,
                             device=dmp.device).float() / 32.0
            for f, d in zip(ebc.feature_order, ebc.feature_dims)}


def _hier_kernel_check(dmp, state, ctxs, grads):
    """B1's sorted entry at this rank's two-level shapes (the source's
    gradient sum) and B4 on a table-wise group, against their plain
    versions; then every group's fused update (``_group_update_check``).
    Returns the largest update difference."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    ebc = dmp.sharded_ebc
    for kind, name, lay in ebc.sharded_groups():
        if kind != "tw" and lay.hier is not None:
            _, _, (sidx, _), seg_global, w_all, _ = ctxs[name]
            feats = ([f.name for f in lay.features] if kind == "rw"
                     else [s.feature.name for s in lay.slots])
            g_cat = torch.cat([grads[f][:, :lay.dim].float()
                               for f in feats]).contiguous()
            M = lay.hier.world_size * lay.hier_num_groups * lay.hier_send_cap
            a = tbe.pooled_lookup(g_cat, seg_global, sidx, M, w_all)
            b = tbe.pooled_lookup_plain(g_cat, seg_global, sidx, M, w_all)
            if not torch.equal(a, b):
                raise AssertionError(f"hier {name}: B1 sorted != plain")
        elif kind == "tw" and dmp.lookup_kernel == "dedup":
            ids, w, segs = ctxs[name][:3]
            S = lay.f_max * lay.world_size * lay.batch_size
            stack = state["tables"][name]
            a = tbe.dedup_pooled_lookup(stack, ids, segs, S, w)
            b = tbe.dedup_pooled_lookup_plain(stack, ids, segs, S, w)
            if not torch.equal(a, b):
                raise AssertionError(f"hier {name}: B4 != plain")
    return _group_update_check(dmp, state, ctxs, grads)


def hier_stage(dev, caps, mine, mh):
    """The two-level dists on the 4 ranks as ``HIER_SLICES`` slices of 2
    (a ``ShardingEnv`` with ``num_slices``; one card's ranks, so no figure
    is a cross-node figure), each plan of ``HIER_PLANS`` against the same
    plan flat on the same world: the multi-hot KT of the row-wise dedup'd
    features ``torch.equal`` to the flat plan's, every feature within
    1e-5; the split step's update fed dyadic upstream gradients over
    dyadic tables leaving the tables ``torch.equal`` to flat;
    ``HIER_STEPS`` trained one-id steps within rtol 1e-4 / atol 1e-6 of
    flat with finite losses; the ledger's DCN bytes below flat's and its
    ICI bytes above 0; the kernels (B1's source sums, B4, B2/B6)
    ``torch.equal`` to their plain versions and a step's launches and
    profile holding them and nothing else.  Then the int8 DCN leg's KT
    within rtol 0.02 / atol 0.05 of float32 and not equal to it,
    ``hier_factor=1e6`` counted in ``dedup_overflow``, and the planner's
    ``hierarchical=True`` plan trained on the two-level world and run on
    a flat world.  Returns (record, launches)."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.comm import (
        LINK_DCN,
        LINK_ICI,
        ShardingEnv,
        all_reduce_sum,
    )
    from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner
    from torchrec_tpu_torch.parallel.qcomm import (
        CommType,
        QCommsConfig,
        wire_accounting,
    )
    from torchrec_tpu_torch.sparse import KeyedTensor

    t0 = time.perf_counter()
    env2 = ShardingEnv.from_process_group("gloo", device=dev,
                                          num_slices=HIER_SLICES)
    r, N = env2.rank, env2.world_size
    _, tables = bench_tables()
    mh_caps, mh_kjt = mh
    b_mh = _with_kjt(mine[0], mh_kjt)
    rng = np.random.RandomState(5)  # dyadic tables: multiples of 1/64
    grid = {c.name: (rng.randint(-8, 9, (TRAIN_ROWS, DIM)) / 64.0).astype(
        np.float32) for c in tables}
    launches, per_plan = {}, {}
    for kind in HIER_PLANS:
        kw = (dict(lookup_kernel="dedup", update_kernel="dedup")
              if kind == "mixed" else {})
        runs = {}
        for mode in ("flat", "hier"):
            dmp, state = sharded_dmp(dev, hier_plan(kind, tables, N,
                                                    mode == "hier"),
                                     TRAIN_BATCH, caps, env2, **kw)
            out = {"hier_groups": sorted(
                n for k, n, lay in dmp.sharded_ebc.sharded_groups()
                if k != "tw" and lay.hier is not None)}
            with torch.no_grad():
                _, ctxs = dmp.sparse_forward(state, mine[0])
                ov = dmp.sharded_ebc.dedup_overflow(ctxs)
                out["dedup_overflow"] = (0 if ov is None else int(
                    all_reduce_sum(ov.reshape(1), env2)[0]))
                # multi-hot where the plan dedups its row-wise tables (a
                # block-shard group's stage-1 buffer at multi-hot caps
                # would hold GBs a rank); the one-id batch everywhere
                out["kt_mh"] = (dmp.with_feature_caps(mh_caps).sparse_forward(
                    state, b_mh)[0] if kind != "twrw" else None)
                out["kt_one"] = dmp.sparse_forward(state, mine[0])[0]
                torch.cuda.empty_cache()
            # the split step's update over dyadic tables and gradients
            st = _clone_state(state)
            dmp.load_table_weights(st, grid)
            kt, ctxs = dmp.embed_step(st["tables"], mine[0])
            dmp.sharded_ebc.backward_and_update_local(
                st["tables"], st["fused"], ctxs, _dyadic(dmp, 7),
                dmp.fused_config, update_kernel=dmp.update_kernel, env=env2)
            # a two-level group's stack is laid out as its flat twin's
            # (the same blocks, one group name apart)
            out["dyadic_tables"] = {n.replace("_hier", ""): t.clone()
                                    for n, t in st["tables"].items()}
            del st
            if mode == "hier":
                _, ctxs = dmp.sparse_forward(state, mine[0])
                kt, _ = dmp.sparse_forward(state, mine[0])
                _, _, _, g = dmp.dense_forward_backward(state, mine[0], kt)
                out["update_max_abs_err"] = _hier_kernel_check(
                    dmp, state, ctxs, g)
            torch.cuda.synchronize()
            tbe.reset_launch_counts()
            with wire_accounting() as ledger:
                state, losses, dt = _train_steps(dmp, state, mine[:HIER_STEPS],
                                                 HIER_STEPS)
            out["counts"] = {k: v for k, v in tbe.launch_counts().items()
                             if v}
            out["ledger"] = {k: v / HIER_STEPS for k, v in ledger.items()}
            out["ms_per_step"] = dt * 1e3 / HIER_STEPS
            out["losses"] = losses
            out["tables"] = {n.replace("_hier", ""): t.clone()
                             for n, t in state["tables"].items()}
            torch.distributed.barrier()
            out["profiled"], _ = _update_kernels_profiled(
                lambda: dmp.train_step(state, mine[0]))
            runs[mode] = out
            del dmp, state
            torch.cuda.empty_cache()
        flat, hier = runs["flat"], runs["hier"]
        fo = [c.feature_names[0] for c in tables]
        dims = [DIM] * len(fo)
        which = "kt_one" if kind == "twrw" else "kt_mh"
        kt_h = KeyedTensor(fo, dims, hier[which]).to_dict()
        kt_f = KeyedTensor(fo, dims, flat[which]).to_dict()
        rw_feats = [f for i, f in enumerate(fo)
                    if kind == "rw_dedup" or (kind == "mixed"
                                              and i < len(tables) // 2)]
        rw_equal = all(torch.equal(kt_h[f], kt_f[f]) for f in rw_feats)
        kt_err = max(float((kt_h[f] - kt_f[f]).abs().max()) for f in fo)
        one_err = max(float((hier["kt_one"] - flat["kt_one"]).abs().max()),
                      0.0)
        dyadic_equal = all(torch.equal(hier["dyadic_tables"][n],
                                       flat["dyadic_tables"][n])
                           for n in flat["dyadic_tables"])
        close = all(torch.allclose(hier["tables"][n], flat["tables"][n],
                                   rtol=1e-4, atol=1e-6)
                    for n in flat["tables"])
        allowed = {"pooled_lookup", "fused_sparse_update"}
        if kind == "mixed":
            allowed = {"pooled_lookup", "dedup_pooled_lookup",
                       "dedup_fused_sparse_update"}
        for k, v in hier["counts"].items():
            launches[k] = launches.get(k, 0) + v
        per_plan[kind] = {
            "hier_groups": hier["hier_groups"],
            "kt_batch": "one_id" if kind == "twrw" else "multi_hot",
            "rw_dedup_features_equal": rw_equal,
            "kt_max_abs_err": kt_err, "one_id_kt_max_abs_err": one_err,
            "dyadic_split_update_tables_equal": dyadic_equal,
            "trained_tables_close": close,
            "trained_tables_max_abs_err": max(
                float((hier["tables"][n] - flat["tables"][n]).abs().max())
                for n in flat["tables"]),
            "losses": {"hier": hier["losses"], "flat": flat["losses"]},
            "ms_per_step": {"hier": hier["ms_per_step"],
                            "flat": flat["ms_per_step"]},
            "wire_bytes_per_step": {"hier": hier["ledger"],
                                    "flat": flat["ledger"]},
            "dedup_overflow": hier["dedup_overflow"],
            "launches": hier["counts"], "profiled": hier["profiled"],
            "update_max_abs_err": hier["update_max_abs_err"]}
        ok = (hier["hier_groups"] and not hier["dedup_overflow"]
              and rw_equal and kt_err <= 1e-5
              and one_err <= 1e-5
              and dyadic_equal and close
              and np.isfinite(hier["losses"] + flat["losses"]).all()
              and hier["ledger"].get(LINK_DCN, 0) < flat["ledger"][LINK_DCN]
              and hier["ledger"].get(LINK_ICI, 0) > 0
              and set(hier["counts"]) <= allowed
              and set(hier["profiled"]) <= allowed
              and hier["counts"].get("pooled_lookup"))
        if not ok:
            raise AssertionError(f"hier {kind} rank {r}: {per_plan[kind]}")
        del runs, flat, hier
        torch.cuda.empty_cache()

    # the int8 DCN leg against float32, the overflow count, the planner
    extra = {}
    kts = {}
    for prec in ("fp32", "int8"):
        qc = QCommsConfig(CommType(prec), CommType(prec))
        dmp, state = sharded_dmp(dev, hier_plan("rw_dedup", tables, N, True),
                                 TRAIN_BATCH, caps, env2, qcomms=qc)
        with torch.no_grad():
            kts[prec] = dmp.sparse_forward(state, mine[0])[0]
        del dmp, state
    extra["int8_dcn_kt_close"] = bool(torch.allclose(
        kts["int8"], kts["fp32"], rtol=0.02, atol=0.05))
    extra["int8_dcn_kt_differs"] = not torch.equal(kts["int8"], kts["fp32"])
    extra["int8_dcn_max_abs_err"] = float(
        (kts["int8"] - kts["fp32"]).abs().max())
    del kts
    dmp, state = sharded_dmp(dev, hier_plan("rw_dedup", tables, N, True,
                                            factor=1e6),
                             TRAIN_BATCH, caps, env2)
    with torch.no_grad():
        _, ctxs = dmp.sparse_forward(state, mine[0])
        ov = dmp.sharded_ebc.dedup_overflow(ctxs)
        extra["dedup_overflow_factor_1e6"] = int(all_reduce_sum(
            ov.reshape(1), env2)[0])
    del dmp, state, ctxs
    plan = EmbeddingShardingPlanner(
        world_size=N, batch_size_per_device=TRAIN_BATCH,
        hierarchical=True).plan(tables)
    flat_env = ShardingEnv(N, r, dev, env2.group, env2.backend)
    for name, e, steps in (("two_level", env2, HIER_STEPS),
                           ("flat", flat_env, 1)):
        dmp, state = sharded_dmp(dev, plan, TRAIN_BATCH, caps, e)
        n_hier = sum(1 for k, _, lay in dmp.sharded_ebc.sharded_groups()
                     if k != "tw" and lay.hier is not None)
        state, losses, _ = _train_steps(dmp, state, mine[:steps], steps)
        extra[f"planned_{name}"] = {"hier_groups": n_hier,
                                    "losses": losses}
        del dmp, state
        torch.cuda.empty_cache()
    rec = {"phase": "hier", "rank": r, "ranks": N, "slices": HIER_SLICES,
           "backend": "gloo", "note": ONE_CARD + "; the slices are the "
           "dists' topology, not nodes", "batch_per_rank": TRAIN_BATCH,
           "plans": per_plan, **extra,
           "seconds": time.perf_counter() - t0, "budget_s": HIER_BUDGET_S}
    if not (extra["int8_dcn_kt_close"] and extra["int8_dcn_kt_differs"]
            and extra["dedup_overflow_factor_1e6"] > 0
            and extra["planned_two_level"]["hier_groups"] > 0
            and extra["planned_flat"]["hier_groups"] == 0
            and np.isfinite(extra["planned_two_level"]["losses"]
                            + extra["planned_flat"]["losses"]).all()):
        raise AssertionError(f"hier rank {r}: {rec}")
    return rec, launches


# -- live resharding across the 4 ranks, in the same launch ----------------

RESHARD_BUDGET_S = 45
RESHARD_STEPS = 1  # steps before the reshard, and after it on both DMPs


def reshard_plan(tables, n):
    """The reshard stage's target: row-wise, table-row-wise (nodes of 2),
    grid (2 column shards over every rank) and data-parallel tables, in
    that order by table index."""
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType as ST,
    )

    def one(i):
        if i < 8:
            return ParameterSharding(ST.ROW_WISE, ranks=list(range(n)))
        if i < 16:
            start = 2 * (i % (n // 2))
            return ParameterSharding(ST.TABLE_ROW_WISE,
                                     ranks=[start, start + 1])
        if i < 20:
            return ParameterSharding(ST.GRID_SHARD, ranks=list(range(n)),
                                     num_col_shards=2)
        return ParameterSharding(ST.DATA_PARALLEL)

    return {c.name: one(i) for i, c in enumerate(tables)}


def _device_snapshot(dmp, state):
    """(per-table weights, per-table slots), on the device: both gathered
    from every rank (collectives)."""
    from torchrec_tpu_torch.parallel.dynamic_sharding import (
        slots_to_tables,
    )

    tables, _ = dmp.gather_group_state(state)
    return (dmp.sharded_ebc.tables_to_weights(tables),
            slots_to_tables(dmp, state))


def _snapshots_equal(a, b) -> bool:
    import torch

    (wa, sa), (wb, sb) = a, b
    return (wa.keys() == wb.keys() and sa.keys() == sb.keys()
            and all(torch.equal(wa[t], wb[t]) for t in wa)
            and all(sa[t] == sb[t] if t == "__scalars__"
                    else all(torch.equal(sa[t][k], sb[t][k]) for k in sa[t])
                    for t in sa))


def _all_ranks(flag: bool, env) -> bool:
    """Whether ``flag`` holds on every rank (a MIN over ranks)."""
    import torch

    from torchrec_tpu_torch.parallel.comm import all_gather

    return bool(all_gather(torch.tensor([int(flag)], device=env.device),
                           env).min())


def reshard_stage(dev, env, caps, mine, flush, ckpt_dir):
    """Live resharding (``parallel/dynamic_sharding.py``, budget
    ``RESHARD_BUDGET_S``): ``RESHARD_STEPS`` steps under the table-wise
    plan, then ``reshard`` onto :func:`reshard_plan`.  Hard checks: the
    per-table weights and slots ``torch.equal`` across the reshard (on
    the card, gathered from every rank); the forward's KT ``torch.equal``
    on the one-id batch; ``RESHARD_STEPS`` more steps ``torch.equal`` to a
    fresh DMP of the new plan loaded with the same weights, slots and
    dense state, one B1 and one B2 a group a step on the resharded DMP and
    nothing else; resharding back to table-wise gives the first stacks and fused
    states bit for bit; B1 and B2 ``torch.equal`` to plain at this rank's
    shapes under the new plan (``sharded_kernel_check``).  Then the
    world-4 checkpoint into ``ckpt_dir`` (rank 0 writes it), whose
    per-table checksums rank 0 returns for the parent's world-1
    ``restore_elastic`` (:func:`reshard_restore_check`).  Returns (record,
    launches, kernel-check records)."""
    import torch

    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.dynamic_sharding import (
        reshard,
        scatter_slots,
        slots_to_tables,
    )

    t0 = time.perf_counter()
    N = env.world_size
    _, tables = bench_tables()
    dmp, state = sharded_dmp(dev, sharded_plan("tw", tables, N),
                             TRAIN_BATCH, caps, env)
    state, _, _ = _train_steps(dmp, state, mine[1:], RESHARD_STEPS)
    first = _clone_state(state)
    before = _device_snapshot(dmp, state)
    with torch.no_grad():
        kt_before, _ = dmp.sparse_forward(state, mine[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    new_dmp, new_state = reshard(dmp, _clone_state(state),
                                 reshard_plan(tables, N))
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t1
    after = _device_snapshot(new_dmp, new_state)
    moved_equal = _all_ranks(_snapshots_equal(before, after), env)
    with torch.no_grad():
        kt_after, _ = new_dmp.sparse_forward(new_state, mine[0])
    kt_equal = _all_ranks(bool(torch.equal(kt_before, kt_after)), env)
    del kt_before, kt_after
    kchecks = sharded_kernel_check(new_dmp, new_state, mine[0], flush)
    # a fresh DMP of the new plan with the same weights, slots and dense
    fresh_dmp, fresh = sharded_dmp(dev, new_dmp.plan, TRAIN_BATCH, caps, env)
    fresh_dmp.load_table_weights(fresh, after[0])
    scatter_slots(fresh_dmp, fresh["fused"], after[1])
    fresh.update(dense=_clone_state(new_state["dense"]),
                 dense_opt=_clone_state(new_state["dense_opt"]),
                 step=new_state["step"])
    del after
    torch.cuda.synchronize()
    tbe.reset_launch_counts()
    new_state, losses, dt = _train_steps(new_dmp, new_state, mine[1:],
                                         RESHARD_STEPS)
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    groups = len(new_dmp.sharded_ebc.group_names)
    fresh, _, _ = _train_steps(fresh_dmp, fresh, mine[1:], RESHARD_STEPS)
    steps_equal = _all_ranks(_state_equal(new_state, fresh), env)
    del fresh
    # back to table-wise: the first stacks and fused states bit for bit
    mid_dmp, mid = reshard(dmp, _clone_state(first), reshard_plan(tables, N))
    _, back = reshard(mid_dmp, mid, dmp.plan)
    back_equal = _all_ranks(
        _state_equal(back["tables"], first["tables"])
        and _state_equal(back["fused"], first["fused"]), env)
    del mid, back
    # the world-4 checkpoint, for the parent's world-1 restore_elastic
    Checkpointer(ckpt_dir).save(dmp, first)
    sums = None
    if env.rank == 0:
        w, s = before
        sums = {"weights": {t: _checksum(v) for t, v in w.items()},
                "slots": {t: _checksum(v["momentum"]) for t, v in s.items()
                          if t != "__scalars__"},
                "step": first["step"]}
    del before, first
    rec = {"phase": "reshard", "rank": env.rank, "ranks": N,
           "note": ONE_CARD, "from": "tw",
           "to": "rw 0-7, twrw 8-15, grid 16-19, dp 20-25",
           "groups_before": {n: list(t.shape)
                             for n, t in state["tables"].items()},
           "groups_after": {n: list(t.shape)
                            for n, t in new_state["tables"].items()},
           "weights_and_slots_equal": moved_equal,
           "kt_equal_one_id_batch": kt_equal,
           "steps_equal_fresh_dmp": steps_equal,
           "back_to_tw_equal": back_equal,
           "reshard_seconds": reshard_s, "launches": counts,
           "groups_after_count": groups,
           "ms_per_step_after": dt * 1e3 / RESHARD_STEPS,
           "losses_after": losses, "checksums": sums,
           "seconds": time.perf_counter() - t0,
           "budget_s": RESHARD_BUDGET_S}
    # one B1 and one B2 a group a step
    steps = RESHARD_STEPS * groups
    if not (moved_equal and kt_equal and steps_equal and back_equal):
        raise AssertionError(f"reshard rank {env.rank}: {rec}")
    if (counts.get("pooled_lookup", 0) != steps
            or counts.get("fused_sparse_update", 0) != steps
            or set(counts) - {"pooled_lookup", "fused_sparse_update"}):
        raise AssertionError(f"reshard rank {env.rank}: {steps} steps "
                             f"launched {counts}")
    if rec["seconds"] > RESHARD_BUDGET_S:
        raise AssertionError(f"reshard took {rec['seconds']:.1f} s")
    del dmp, state, new_dmp, new_state, fresh_dmp
    torch.cuda.empty_cache()
    return rec, counts, kchecks


def reshard_restore_check(dev, ckpt_dir, sums):
    """The reshard stage's world-4 checkpoint restored through
    ``restore_elastic`` here, at world 1 on the card under the table-wise
    plan: every table's weights and rowwise slots carry the checksums the
    world-4 state had, and the step.  Returns the record."""
    import torch

    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.parallel.dynamic_sharding import slots_to_tables

    t0 = time.perf_counter()
    _, tables = bench_tables()
    caps, _ = one_id_batches(1)
    dmp, _ = sharded_dmp(dev, sharded_plan("tw", tables, 1), TRAIN_BATCH,
                         caps)
    state = Checkpointer(ckpt_dir).restore_elastic(dmp, sums["step"])
    weights = dmp.sharded_ebc.tables_to_weights(state["tables"])
    slots = slots_to_tables(dmp, state)
    rec = {"phase": "reshard_restore", "world": 1,
           "weights_equal": all(_checksum(weights[t]) == c
                                for t, c in sums["weights"].items()),
           "slots_equal": all(_checksum(slots[t]["momentum"]) == c
                              for t, c in sums["slots"].items()),
           "step": state["step"], "seconds": time.perf_counter() - t0}
    del dmp, state, weights, slots
    torch.cuda.empty_cache()
    if not (rec["weights_equal"] and rec["slots_equal"]
            and rec["step"] == sums["step"]):
        raise AssertionError(f"world-1 restore_elastic failed: {rec}")
    return rec


# -- the sequence path across the 4 ranks, in the same launch ---------------

SEQ_RANK_BATCH = 64  # sessions a rank: the global batch is SEQ_BATCH
SEQ_SHARDED_STEPS = 3
SEQ_SHARDED_PLANS = ("rw", "tw")
SEQ_SHARDED_BUDGET_S = 60
# ring attention: B=2, T=8192 over the 4 ranks, H=8, Dh=64, causal, the
# tail padded
RING_B, RING_T, RING_H, RING_DH = 2, 8192, 8, 64
RING_OUT_ATOL = 1e-5
# the gradients' bound, relative to the largest gradient of each of q, k
# and v: the ring's backward recomputes each block's probabilities from
# its row's log-sum-exp where autograd differentiates the unsharded
# softmax, and dK and dV sum up to 8,192 query rows in other orders
RING_GRAD_RTOL = 1e-5


def seq_one_device_run(dev, host, n):
    """The sharded step's arithmetic on one device over the ranks'
    micro-batches (``host[s * n + q]`` rank ``q``'s batch of step ``s``):
    the one-device collection's rows of the global batch, the dense
    forward and backward over each micro-batch, the loss and dense
    gradients summed in rank order and divided by ``n``, the per-id
    gradients divided by ``n`` and applied over the global slot stream
    (ranks in order) by B6.  Returns (losses, the trained table)."""
    import torch

    from torchrec_tpu_torch.parallel.comm import sum_over_ranks

    one, st = build_seq(dev, n * SEQ_RANK_BATCH)
    ec = one.sharded_ec
    cap = SEQ_RANK_BATCH * SEQ_LEN
    losses = []
    for s in range(SEQ_SHARDED_STEPS):
        micro = [b.to(dev) for b in host[s * n:(s + 1) * n]]
        gb = global_batch(micro).to(dev)
        with torch.no_grad():
            outs, ctxs = ec.forward_local(st["tables"], gb.sparse_features)
        rows = outs["item"].values()
        flats, g_emb, off = [], [], 0
        for b in micro:
            k = int(b.sparse_features.lengths().sum())
            ev = rows.new_zeros((cap, SEQ_DIM))
            ev[:k] = rows[off:off + k]
            off += k
            loss, g_dense, ge = one.dense_forward_backward(st, b,
                                                           {"item": ev})
            flats.append(torch.cat([loss.reshape(1).to(torch.float32)]
                                   + [g.reshape(-1)
                                      for g in g_dense.values()]))
            g_emb.append(ge["item"][:k] / n)
        flat = sum_over_ranks(torch.stack(flats)) / n
        pieces = flat[1:].split([g.numel() for g in g_dense.values()])
        g_dense = {k: p.view_as(g) for (k, g), p in zip(g_dense.items(),
                                                         pieces)}
        g = rows.new_zeros((n * cap, SEQ_DIM))
        g[:off] = torch.cat(g_emb)
        ec.backward_and_update_local(st["tables"], st["fused"], ctxs,
                                     {"item": g}, one.fused_config)
        one.dense_tx.update(st["dense"], g_dense, st["dense_opt"])
        losses.append(float(flat[0]))
    table = one.table_weights(st)["t_item"]
    del one, st
    torch.cuda.empty_cache()
    return losses, table


def seq_ranks_loss(n):
    """The loss ``n`` ranks optimize, on one device: the mean over the
    global batch's ``n`` rank slices of each slice's masked-item loss
    (each rank normalizes by its own masked positions, and the step
    averages the ranks' losses, as the JAX step's ``pmean`` does); the
    model runs once over the whole batch."""
    import torch

    from torchrec_tpu_torch.models.experimental.bert4rec import (
        masked_item_loss,
    )
    from torchrec_tpu_torch.parallel.model_parallel import (
        forward_from_embeddings,
    )
    from torchrec_tpu_torch.sparse import JaggedTensor

    def loss_fn(model, dense_params, emb_values, b):
        lengths = b.sparse_features["item"].lengths()
        x = JaggedTensor(emb_values["item"], lengths).to_padded_dense(
            SEQ_LEN)
        pos = torch.arange(SEQ_LEN, device=x.device)[None, :]
        logits = forward_from_embeddings(model, dense_params, x,
                                         pos < lengths[:, None])
        m = logits.shape[0] // n
        return sum(masked_item_loss(logits[q * m:(q + 1) * m],
                                    b.dense_features[q * m:(q + 1) * m],
                                    b.labels[q * m:(q + 1) * m])
                   for q in range(n)) / n

    return loss_fn


def seq_plain_run(dev, host, n):
    """The plain one-device ``train_step`` over the global batches (its
    dense products at ``n`` times the rows) on the ranks' objective
    (:func:`seq_ranks_loss`): its losses."""
    import torch

    one, st = build_seq(dev, n * SEQ_RANK_BATCH,
                        loss_fn=seq_ranks_loss(n))
    losses = []
    for s in range(SEQ_SHARDED_STEPS):
        gb = global_batch(host[s * n:(s + 1) * n]).to(dev)
        st, m = one.train_step(st, gb)
        losses.append(float(m["loss"]))
    del one, st
    torch.cuda.empty_cache()
    return losses


def seq_sharded_stage(dev, env):
    """BERT4Rec at the seq width across the ranks, ``SEQ_RANK_BATCH``
    sessions each, on a row-wise plan and a table-wise one (the item
    table on the last rank): the rows before training ``torch.equal`` to
    the unsharded EC's, B6 ``torch.equal`` to its plain version at the
    rank's shapes, 3 steps launching B6 and nothing else, the table after
    them ``np.array_equal`` to :func:`seq_one_device_run` and the losses
    within ``PLAIN_LOSS_RTOL`` of :func:`seq_plain_run`.  Returns
    (record, launches, kernel checks)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    t0 = time.perf_counter()
    r, N = env.rank, env.world_size
    host = seq_host_batches(SEQ_SHARDED_STEPS * N, SEQ_RANK_BATCH, seed=7)
    mine = [host[s * N + r].to(dev) for s in range(SEQ_SHARDED_STEPS)]
    ref = None
    out, launches, errs = {"rank": r}, {}, []
    for kind in SEQ_SHARDED_PLANS:
        smp, state = build_seq(dev, SEQ_RANK_BATCH, env, kind)
        rows_equal, _ = seq_rows_check(smp, state, mine[0].sparse_features,
                                       env)
        b6 = seq_b6_check(state, seq_step_grads(smp, state, mine[0]),
                          SEQ_LR)
        for name, (_, slots, valid, err) in b6.items():
            errs.append({"phase": "sharded_kernel", "stage": "seq_sharded",
                         "rank": r, "plan": kind, "group": name,
                         "slots": slots, "valid_slots": valid,
                         "b6_max_abs_err": err})
        torch.cuda.synchronize()
        tbe.reset_launch_counts()
        t1 = time.perf_counter()
        state, losses, dt = _seq_steps(smp, state, mine, SEQ_SHARDED_STEPS)
        counts = {k: v for k, v in tbe.launch_counts().items() if v}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        table = smp.table_weights(state)["t_item"]  # a collective
        rec = {"rows_equal_unsharded": rows_equal,
               "b6_equal": all(v[0] for v in b6.values()),
               "b6_slots": {k: v[1] for k, v in b6.items()},
               "ms_per_step": dt * 1e3 / SEQ_SHARDED_STEPS,
               "losses": losses, "launches": counts}
        if r == 0:
            if ref is None:  # the same arithmetic for either plan
                ref = (seq_one_device_run(dev, host, N),
                       seq_plain_run(dev, host, N))
            (ref_losses, ref_table), plain_losses = ref
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, plain_losses))
            rec.update(tables_equal_one_device=bool(np.array_equal(
                table, ref_table)),
                table_max_abs_err_vs_one_device=float(
                    np.abs(table - ref_table).max()),
                one_device_losses=ref_losses,
                plain_one_device_losses=plain_losses,
                loss_max_rel_gap_vs_plain=gap)
        out[kind] = rec
        owns = any(int(t.shape[0]) for t in state["tables"].values())
        if not (rows_equal and rec["b6_equal"]
                and np.isfinite(losses).all()
                and set(counts) <= {"dedup_fused_sparse_update"}
                and (not owns or counts.get("dedup_fused_sparse_update", 0)
                     >= SEQ_SHARDED_STEPS)
                and rec.get("tables_equal_one_device", True)
                and rec.get("loss_max_rel_gap_vs_plain", 0.0)
                <= PLAIN_LOSS_RTOL):
            raise AssertionError(f"seq_sharded {kind} rank {r}: {rec}")
        del smp, state, table
        torch.cuda.empty_cache()
        torch.distributed.barrier()  # rank 0's references end here
    s = time.perf_counter() - t0
    rec = {"phase": "seq_sharded", **out, "note": ONE_CARD,
           "batch_per_rank": SEQ_RANK_BATCH, "steps": SEQ_SHARDED_STEPS,
           "seconds": s, "budget_s": SEQ_SHARDED_BUDGET_S,
           "within_budget": s <= SEQ_SHARDED_BUDGET_S}
    return rec, launches, errs


def ring_stage(dev, env):
    """Ring attention over the ranks (``ops/ring_attention.py``): each
    rank's ``RING_T / N`` slice of seeded q, k, v (causal, the tail
    padded: the last rank's keys wholly so in one example), the forward
    and the backward through the ring (``sum(out * g)``), then on rank 0
    the gathered output within ``RING_OUT_ATOL`` of
    ``full_attention_reference`` over the whole sequence and the gathered
    gradients within ``RING_GRAD_RTOL`` of the largest of its
    autograd's.  Returns the record."""
    import torch

    from torchrec_tpu_torch.ops.ring_attention import (
        full_attention_reference,
        ring_attention,
    )
    from torchrec_tpu_torch.parallel.comm import all_gather

    t0 = time.perf_counter()
    r, N = env.rank, env.world_size
    n = RING_T // N
    rng = np.random.RandomState(21)
    full = [rng.randn(RING_B, RING_T, RING_H, RING_DH).astype(np.float32)
            for _ in range(4)]  # q, k, v, g
    valid = np.ones((RING_B, RING_T), bool)
    valid[0, RING_T - 1500:] = False
    valid[1, RING_T - n - 100:] = False

    def mine(a):
        return torch.from_numpy(np.ascontiguousarray(
            a[:, r * n:(r + 1) * n])).to(dev)

    q, k, v = (mine(a).requires_grad_() for a in full[:3])
    g, vm = mine(full[3]), mine(valid)
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        ring_attention(q, k, v, env, vm, causal=True)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t1) * 1e3
    torch.distributed.barrier()
    t1 = time.perf_counter()
    out = ring_attention(q, k, v, env, vm, causal=True)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    fwd_bwd_ms = (time.perf_counter() - t1) * 1e3
    parts = [all_gather(x.detach().contiguous(), env)
             for x in (out, q.grad, k.grad, v.grad)]
    rec = {"phase": "ring_attention", "rank": r, "note": ONE_CARD,
           "B": RING_B, "T": RING_T, "heads": RING_H, "Dh": RING_DH,
           "ranks": N, "causal": True, "forward_ms": fwd_ms,
           "forward_backward_ms": fwd_bwd_ms}
    del q, k, v, out, g
    if r == 0:
        got = [torch.cat(list(p), dim=1) for p in parts]
        del parts
        qf, kf, vf = (torch.from_numpy(a).to(dev).requires_grad_()
                      for a in full[:3])
        ref = full_attention_reference(qf, kf, vf,
                                       torch.from_numpy(valid).to(dev),
                                       causal=True)
        (ref * torch.from_numpy(full[3]).to(dev)).sum().backward()
        rec["out_max_abs_err"] = float((got[0] - ref.detach()).abs().max())
        rec["grad_max_abs_err"] = {
            x: float((a - t.grad).abs().max())
            for x, a, t in zip("qkv", got[1:], (qf, kf, vf))}
        rec["grad_max_abs"] = {x: float(t.grad.abs().max())
                               for x, t in zip("qkv", (qf, kf, vf))}
        del got, qf, kf, vf, ref
        torch.cuda.empty_cache()
        if (rec["out_max_abs_err"] > RING_OUT_ATOL
                or any(rec["grad_max_abs_err"][x]
                       > RING_GRAD_RTOL * rec["grad_max_abs"][x]
                       for x in "qkv")):
            raise AssertionError(f"ring attention: {rec}")
    torch.distributed.barrier()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def over_cap_batch(batch, key_index, length):
    """``batch`` with every example of key ``key_index`` claiming
    ``length`` ids, past the key's capacity: the saturation a device-side
    relayout leaves, which ``id_overflow`` counts."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    kjt = batch.sparse_features
    B = kjt.stride()
    lengths = kjt.lengths().clone()
    lengths[key_index * B:(key_index + 1) * B] = length
    return dataclasses.replace(batch, sparse_features=KeyedJaggedTensor(
        kjt.keys(), kjt.values(), lengths, stride=B, caps=kjt.caps))


def planned_forward_check(dmp, state, batch, dev):
    """The planned plan's eval forward on this rank: ``make_forward``'s
    logits of the rank's batch ``torch.equal`` to the one-device DMP's
    (the same seeded tables and dense parameters, each table whole) on
    that batch.  Returns (the record's fields, the one-device DMP and
    state, kept for :func:`planned_overflow_check`)."""
    import torch

    one, one_st = one_device_dmp(dev, one_device_plan(dmp.plan), 1)
    logits = dmp.make_forward()(state["dense"], state["tables"], batch)
    ref = one.make_forward()(one_st["dense"], one_st["tables"], batch)
    out = {"forward_equal_one_device": bool(torch.equal(logits, ref)),
           "forward_max_abs_err": float((logits - ref).abs().max())}
    if not out["forward_equal_one_device"]:
        raise AssertionError(f"planned: rank forward != one device: {out}")
    return out, (one, one_st)


def planned_overflow_check(dmp, state, batch, env, one):
    """One step with rank 0's batch over capacity (key 0 claiming two ids
    an example, its cap one): the step's ``id_overflow``, summed over
    ranks, equal to the sum of each rank's one-device count on its own
    batch, and on key 0 the ``B`` ids dropped."""
    from torchrec_tpu_torch.parallel.multiprocess import allgather_host

    if env.rank == 0:
        batch = over_cap_batch(batch, 0, 2)
    _, m = dmp.train_step(state, batch)
    one_dmp, one_st = one
    _, m1 = one_dmp.train_step(one_st, batch)
    mine = m1["id_overflow"].cpu().numpy()
    want = allgather_host(mine).sum(axis=0)
    got = m["id_overflow"].cpu().numpy()
    out = {"id_overflow": got.tolist(),
           "one_device_id_overflow_sum": want.tolist()}
    if not (np.array_equal(got, want) and got[0] == TRAIN_BATCH
            and not got[1:].any()):
        raise AssertionError(f"planned: id_overflow {out}")
    return out


def one_device_plan(plan):
    """The one-device plan a sharded plan trains like: each table whole
    on rank 0, but a column-wise one in its column shards (the rowwise
    optimizer's state is a shard's own), as a hashable tuple."""
    from torchrec_tpu_torch.parallel.types import ShardingType as ST

    cw = (ST.COLUMN_WISE, ST.TABLE_COLUMN_WISE)
    return tuple((t, len(ps.ranks) if ps.sharding_type in cw else 1)
                 for t, ps in plan.items())


def _micro_grads(one, st, kt, micro_batches):
    """The sharded step's dense arithmetic on one device: the dense
    forward and backward over each rank's micro-batch (its rows of the
    global ``kt``), the loss and dense gradients summed in rank order and
    divided by the ranks, the KT gradient divided by them.  (loss, dense
    gradients, KT gradient by feature.)"""
    import torch

    from torchrec_tpu_torch.parallel.comm import sum_over_ranks

    n = len(micro_batches)
    flats, kt_grads = [], []
    for r, b in enumerate(micro_batches):
        loss, _, g_dense, g_kt = one.dense_forward_backward(
            st, b, kt[r * TRAIN_BATCH:(r + 1) * TRAIN_BATCH])
        flats.append(torch.cat([loss.reshape(1).to(torch.float32)]
                               + [g.reshape(-1) for g in g_dense.values()]))
        kt_grads.append(g_kt)
    flat = sum_over_ranks(torch.stack(flats)) / n
    pieces = flat[1:].split([g.numel() for g in g_dense.values()])
    g_dense = {k: p.view_as(g) for (k, g), p in zip(g_dense.items(), pieces)}
    grads = {f: torch.cat([g[f] for g in kt_grads]) / n for f in kt_grads[0]}
    return flat[0], g_dense, grads


def one_device_dmp(dev, key, n, eps=EPS, dense_dtype=None):
    """The one-device DMP of :func:`one_device_plan`'s ``key`` at the
    global batch of ``n`` ranks, and its state."""
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType as ST,
    )

    caps, _ = one_id_batches(0)
    plan = {t: ParameterSharding(ST.COLUMN_WISE if k > 1 else ST.TABLE_WISE,
                                 ranks=[0] * k) for t, k in key}
    return sharded_dmp(dev, plan, n * TRAIN_BATCH,
                       {k: n * c for k, c in caps.items()}, eps=eps,
                       dense_dtype=dense_dtype)


def one_device_run(dev, key, host, n, micro=True, eps=EPS,
                   dense_dtype=None):
    """The one-device DMP of ``key`` over the global batches (each the
    ``n`` ranks' batches of a step): its losses and its trained tables
    after ``1 + SHARDED_STEPS`` steps.  With ``micro`` its step runs the
    sparse forward and the fused update over the global batch and the
    dense part by :func:`_micro_grads`: the sharded step's arithmetic,
    which the sharded run matches bit for bit.  Without, ``train_step``
    on the global batch: its dense GEMMs run at ``n`` times the rows and
    its dense gradients stay in the dense dtype, so it rounds otherwise
    (see :func:`one_device_gap` for how far that carries)."""
    import torch

    one, st = one_device_dmp(dev, key, n, eps, dense_dtype)
    losses = []
    for s in range(1 + SHARDED_STEPS):
        gb = global_batch(host[s * n:(s + 1) * n]).to(dev)
        if not micro:
            st, m = one.train_step(st, gb)
            losses.append(float(m["loss"]))
            continue
        kt, ctxs = one.sparse_forward(st, gb)
        loss, g_dense, grads = _micro_grads(
            one, st, kt, [b.to(dev) for b in host[s * n:(s + 1) * n]])
        one.sharded_ebc.backward_and_update_local(
            st["tables"], st["fused"], ctxs, grads, one.fused_config)
        one.dense_tx.update(st["dense"], g_dense, st["dense_opt"])
        st["step"] += 1
        losses.append(float(loss))
    tables = one.table_weights(st)
    del one, st
    torch.cuda.empty_cache()
    return losses, tables


def _quantiles(x):
    import torch

    q = torch.tensor([0.0, 0.01, 0.5, 0.99, 1.0], device=x.device)
    x = x.reshape(-1).float()
    if x.numel() > 1 << 24:  # torch.quantile's limit
        x = x[torch.randperm(x.numel(), device=x.device)[:1 << 24]]
    return [float(v) for v in torch.quantile(x, q)]


def first_step_gap(dev, key, host, n, eps, dense_dtype):
    """On the first global batch, from one state: the plain step's and
    the micro-batched step's KT gradients per (feature, example) row, and
    the first rowwise Adagrad step each gives a row hit once (``lr * g /
    (rms(g) + eps)``, the fused update from a zero momentum)."""
    import torch

    one, st = one_device_dmp(dev, key, n, eps, dense_dtype)
    gb = global_batch(host[:n]).to(dev)
    kt, _ = one.sparse_forward(st, gb)
    _, _, gd_plain, gk_plain = one.dense_forward_backward(st, gb, kt)
    _, gd_micro, gk_micro = _micro_grads(one, st, kt,
                                         [b.to(dev) for b in host[:n]])
    keys = list(gk_plain)
    P = torch.stack([gk_plain[f].float() for f in keys])  # [F, B, D]
    M = torch.stack([gk_micro[f].float() for f in keys])
    lengths = torch.stack([gb.sparse_features.lengths_for_key(f)
                           for f in range(len(keys))]).to(dev)
    hit = lengths > 0  # the rows the update reads

    def step(g):
        return TRAIN_LR * g / (g.pow(2).mean(-1, keepdim=True).sqrt() + eps)

    rms = P.pow(2).mean(-1).sqrt()[hit]
    rel = ((M - P).norm(dim=-1) / P.norm(dim=-1).clamp_min(1e-30))[hit]
    dstep = (step(M) - step(P)).abs().amax(-1)[hit]
    dense_rel = max(float((gd_micro[k].float() - g.float()).norm()
                          / g.float().norm().clamp_min(1e-30))
                    for k, g in gd_plain.items())
    out = {"rows_hit": int(hit.sum()),
           "kt_grad_row_rms_q": _quantiles(rms),
           "kt_grad_row_rel_diff_q": _quantiles(rel),
           "first_step_gap_q": _quantiles(dstep),
           "first_step_rows_over_1e-2": int((dstep > 1e-2).sum()),
           "dense_grad_max_rel_diff": dense_rel}
    del one, st
    torch.cuda.empty_cache()
    return out


def one_device_gap():
    """``python3 chip_smoke.py --one-device-gap``: how far the plain
    one-device ``train_step`` on the global batches parts from the
    micro-batched one (the sharded step's arithmetic), at the sharded
    phase's table-wise reference (4 ranks of B=4096), and why.  Arms: the
    fused optimizer's eps at 1e-8 (the phase's) and 1e-5, the dense part
    in bf16 (the phase's) and float32.  Per arm: the KT gradients' and
    the first rowwise Adagrad step's gaps on one state, then the losses
    and the tables after ``1 + SHARDED_STEPS`` steps of each."""
    import torch

    sys.path.insert(0, ROOT)
    from torchrec_tpu_torch.ops import _native

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    _native.load_libraries()
    card = nvidia_smi_line()
    n = SHARDED_RANKS
    _, host = one_id_batches(n * (1 + SHARDED_STEPS))
    _, tables = bench_tables()
    key = one_device_plan(sharded_plan("tw", tables, n))
    one, st = one_device_dmp(dev, key, n)
    init = one.table_weights(st)
    del one, st
    for eps, dtype in ((EPS, torch.bfloat16), (EPS, torch.float32),
                       (1e-5, torch.bfloat16)):
        t0 = time.perf_counter()
        rec = {"phase": "one_device_gap", "card": card, "fused_eps": eps,
               "dense_dtype": str(dtype).replace("torch.", ""),
               **first_step_gap(dev, key, host, n, eps, dtype)}
        micro = one_device_run(dev, key, host, n, True, eps, dtype)
        plain = one_device_run(dev, key, host, n, False, eps, dtype)
        gap = np.concatenate([np.abs(micro[1][t] - w).max(axis=1)
                              for t, w in plain[1].items()])
        moved = np.concatenate([np.abs(micro[1][t] - w).max(axis=1)
                                for t, w in init.items()])
        rec.update({
            "micro_losses": micro[0], "plain_losses": plain[0],
            "loss_max_rel_gap": max(abs(a - b) / abs(b)
                                    for a, b in zip(*(micro[0], plain[0]))),
            "table_max_abs_gap": float(gap.max()),
            "table_rows_gap_over_1e-2": int((gap > 1e-2).sum()),
            "table_rows_gap_over_1e-4": int((gap > 1e-4).sum()),
            "rows_moved": int((moved > 0).sum()),
            "row_move_q": _quantiles(torch.from_numpy(moved[moved > 0])),
            "seconds": time.perf_counter() - t0})
        emit(rec)
        del micro, plain, gap, moved


def _kt(dmp, values):
    """The sharded collection's KT values as a KeyedTensor."""
    from torchrec_tpu_torch.sparse import KeyedTensor

    ebc = dmp.sharded_ebc
    return KeyedTensor(ebc.feature_order, ebc.feature_dims, values)


def _with_kjt(batch, kjt):
    import dataclasses

    return dataclasses.replace(batch, sparse_features=kjt)


def nccl_rank(backend="nccl", device_type="cuda"):
    """The NCCL arm, one rank on the card: the row-wise plan's forward
    and one step ``torch.equal`` to the one-device DMP's (at one rank a
    row-wise table is the whole table; the NCCL collectives run).  A CPU
    rehearsal passes gloo and the CPU."""
    import torch

    from torchrec_tpu_torch.parallel import multiprocess
    from torchrec_tpu_torch.parallel.comm import ShardingEnv
    from torchrec_tpu_torch.parallel.qcomm import wire_accounting
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    dev = _rank_device(device_type)
    multiprocess.initialize(backend)
    env = ShardingEnv.from_process_group(backend, device=dev)
    caps, host = one_id_batches(1)
    batch = host[0].to(dev)
    _, tables = bench_tables()
    rw, rw_state = sharded_dmp(dev, sharded_plan("rw", tables, 1),
                               TRAIN_BATCH, caps, env)
    one, one_state = sharded_dmp(dev, table_wise_plan(tables), TRAIN_BATCH,
                                 caps)
    with torch.no_grad():
        kt, _ = rw.sparse_forward(rw_state, batch)
        kt_one, _ = one.sparse_forward(one_state, batch)
    with wire_accounting() as ledger:
        rw_state, m = rw.train_step(rw_state, batch)
    one_state, m1 = one.train_step(one_state, batch)
    a, b = rw.table_weights(rw_state), one.table_weights(one_state)
    rec = {"phase": "sharded_nccl", "ranks": env.world_size,
           "backend": env.backend, "plan": "rw",
           "kt_equal": bool(torch.equal(kt, kt_one)),
           "tables_equal_after_step": all(np.array_equal(a[t], b[t])
                                          for t in a),
           "loss": float(m["loss"]), "one_device_loss": float(m1["loss"]),
           "wire_bytes_per_step": dict(ledger)}
    if not (rec["kt_equal"] and rec["tables_equal_after_step"]):
        raise AssertionError(f"NCCL arm failed: {rec}")
    return rec


def sharded_phase(rank_fn=sharded_rank, nccl_fn=nccl_rank, only=None,
                  device_type="cuda"):
    """The multi-rank phase: the gloo arm's 4 ranks, then the NCCL arm's
    one, each spawned by ``multiprocess.launch`` (the parent built every
    kernel before), each rank's records emitted here beside the card's
    line; after the gloo arm, the reshard stage's world-4 checkpoint
    restored here at world 1 (:func:`reshard_restore_check`, on
    ``device_type``).  ``only`` (a development run): those of the gloo
    arm's stages (``GLOO_STAGES``) alone, without its plans, its other
    stages and the NCCL arm.  Returns (the main path's launches, summed
    over ranks and plans; the kernel checks' records)."""
    import torch

    from torchrec_tpu_torch.parallel.multiprocess import launch

    card = nvidia_smi_line()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="reshard_")
    args = (((), device_type, tuple(only), ckpt) if only
            else (SHARDED_PLANS, device_type, None, ckpt))
    try:
        results = launch(rank_fn, SHARDED_RANKS, args=args,
                         timeout=SHARDED_TIMEOUT)
        sums = next((r["checksums"] for records, _ in results
                     for r in records
                     if r["phase"] == "reshard" and r["rank"] == 0), None)
        restore = (None if sums is None else reshard_restore_check(
            torch.device(device_type), ckpt, sums))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches: dict = {}
    kchecks = []
    for records, counts in results:
        for rec in records:
            emit({**rec, "card": card})
        kchecks += [r for r in records
                    if r["phase"] in ("sharded_kernel", "dedup_rw_kernel")]
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    if restore is not None:
        emit({**restore, "card": card})
    gloo_s = time.perf_counter() - t0
    if only:
        return launches, kchecks
    t0 = time.perf_counter()
    (nccl,) = launch(nccl_fn, 1, timeout=SHARDED_TIMEOUT)
    emit({**nccl, "card": card})
    emit({"phase": "sharded_summary", "card": card, "note": ONE_CARD,
          "gloo_arm_seconds": gloo_s,
          "nccl_arm_seconds": time.perf_counter() - t0,
          "launches": launches})
    return launches, kchecks


# -- checkpoint and resume, the fault-tolerant loop, the elastic supervisor --

FT_BUDGET_S = 60
# the loop's stream: item i is batch i % TRAIN_BATCHES of build_trainer
FT_ITEMS = 20
FT_CKPT_EVERY = 4  # applied steps between checkpoints
FT_NAN = {3, 7, 8, 9}  # NaN step calls: item 3 skipped, 7-9 roll back
FT_FLAKY = {11, 12}  # next() attempts that fail transiently (loop 1)
# loop 1 steps items 0-13, a SIGTERM after item 13's step; loop 2 resumes
# at 14, a SIGTERM after its third step (item 16); loop 3 runs 17-19
FT_SIGTERM_AFTER = (13, 2)
# the items whose updates survive: 5 and 6 are rolled back with 7-9
FT_APPLIED = (0, 1, 2, 4, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19)
FT_TIMED = 3  # steps timed with and without the loop and the log
FT_CORRUPT_FEATURE = 7  # the table whose file gets a flipped byte


def _payload_bytes(payload) -> int:
    import torch

    if isinstance(payload, dict):
        return sum(_payload_bytes(v) for v in payload.values())
    if isinstance(payload, torch.Tensor):
        return payload.numel() * payload.element_size()
    return 0


def _signalling_step(step, after):
    """``step`` that sends this process a SIGTERM right after its
    ``after``-th call (0-based)."""
    import signal

    calls = itertools.count()

    def run(state, batch):
        out = step(state, batch)
        if next(calls) == after:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    return run


def _cuda_ms(fn, n):
    """Mean ms of ``n`` calls of ``fn`` on the card (synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _undo_log_ms(dmp, state, batch, n):
    """The undo log's own work on the card, from CUDA events around each
    piece of it in ``n`` logged steps: opening it (the dense copies) and
    each fused update's row and slot gathers (``before_update``); then
    one ``restore()`` of the last step.  Each span runs from the card
    reaching the log's first kernel to its last one, so it also holds
    the gaps in which the card waits for the host to launch them.
    Returns ms: {"open", "gathers"} a step and one "restore"."""
    import torch

    from torchrec_tpu_torch.reliability.train_loop import StepUndoLog

    spans = []

    def timed(piece, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        spans.append((piece, start, end))
        return out

    class TimedUndoLog(StepUndoLog):
        def before_update(self, *args):
            timed("gathers", lambda: StepUndoLog.before_update(self, *args))

    for _ in range(n):
        undo = timed("open", lambda: TimedUndoLog(state))
        with undo.recording():
            dmp.train_step(state, batch)
    timed("restore", undo.restore)
    torch.cuda.synchronize()
    ms = {"open": 0.0, "gathers": 0.0, "restore": 0.0}
    for piece, a, b in spans:
        ms[piece] += a.elapsed_time(b) / (1 if piece == "restore" else n)
    return ms


def ft_checkpoint_checks(dmp, state, batch, tmp):
    """The checkpoint's own drills at full width, on a directory of their
    own: a sync save timed piece by piece (the host snapshot, the write
    with its checksums and commit, the verified read, the restore), then
    one step and a crash between the payload write and the commit
    (``latest_step()`` stays at the previous commit), and a byte flipped
    in one table's file (``CheckpointCorruption`` naming it).  Returns
    the record.  The state takes the one step, in place."""
    import json as _json

    import torch

    from torchrec_tpu_torch.checkpoint import (
        CheckpointCorruption,
        Checkpointer,
    )
    from torchrec_tpu_torch.reliability.fault_injection import (
        CrashMidSaveCheckpointer,
        SimulatedCrash,
    )

    d = os.path.join(tmp, "drills")
    ck = Checkpointer(d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = ck._build_payload(dmp, state)
    snapshot_s = time.perf_counter() - t0
    nbytes = _payload_bytes(payload)
    step = state["step"]
    t0 = time.perf_counter()
    ck._write(payload, step)
    write_s = time.perf_counter() - t0
    del payload
    t0 = time.perf_counter()
    ck._read_payload(step)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = ck.restore(dmp, step)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_equal = _state_equal(restored, state)
    del restored
    state, _ = dmp.train_step(state, batch)
    crash = CrashMidSaveCheckpointer(d, crash_on_save=0, save_retries=0)
    crashed = False
    try:
        crash.save(dmp, state)
    except SimulatedCrash:
        crashed = True
    torn = [n for n in os.listdir(d) if n.startswith(".tmp_step_")]
    latest = crash.latest_step()
    # one byte of one table's file, flipped on disk
    victim = f"t_cat_{min(FT_CORRUPT_FEATURE, TRAIN_FEATURES - 1)}"
    pdir = os.path.join(d, f"step_{step}", "payload")
    with open(os.path.join(pdir, "manifest.json")) as f:
        entry = next(e for e in _json.load(f)["leaves"]
                     if e["path"] == ["tables", victim])
    path = os.path.join(pdir, entry["file"])
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x40]))
    named = None
    try:
        ck.restore(dmp, step)
    except CheckpointCorruption as e:
        named = str([victim]) in str(e)
    shutil.rmtree(d, ignore_errors=True)
    rec = {"payload_bytes": nbytes, "snapshot_s": snapshot_s,
           "write_s": write_s, "read_s": read_s, "restore_s": restore_s,
           "write_gb_per_s": nbytes / write_s / 1e9,
           "read_gb_per_s_warm": nbytes / read_s / 1e9,
           "restored_equal": restored_equal, "crash_raised": crashed,
           "torn_dirs": len(torn), "latest_after_crash": latest,
           "corrupted_table": victim, "corruption_named": named}
    if not (restored_equal and crashed and torn and latest == step
            and named):
        raise AssertionError(f"ft_loop checkpoint drills failed: {rec}")
    return rec


def ft_semisync_arm(dev, tmp):
    """The semi-sync rollback arm at ``train_dedup``'s configuration
    (B4/B6, the bucketed semi-sync pipeline): two forced bad steps roll
    back to the start's checkpoint, the pending embedding is recomputed,
    and the next steps equal a fresh pipeline's from the restored step
    over the same batches.  Returns (record, launches)."""
    import torch

    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.train_pipeline import (
        BucketedTrainPipelineSemiSync,
    )
    from torchrec_tpu_torch.reliability import FaultTolerantTrainLoop

    keys, caps, host = dedup_batches()
    dmp, state = build_dedup_trainer(dev, keys, caps, "rowwise_adagrad",
                                     torch.float32)
    items = [host[i % len(host)] for i in range(8)]
    ck = Checkpointer(os.path.join(tmp, "semisync"))
    pipe = BucketedTrainPipelineSemiSync(dmp, state, _bucketing_config())
    refreshed = []
    orig = pipe.invalidate_prefetch
    pipe.invalidate_prefetch = lambda: (refreshed.append(1), orig())[0]
    calls = itertools.count()
    tbe.reset_launch_counts()
    loop = FaultTolerantTrainLoop(
        pipe, ck, dmp, checkpoint_interval=None, max_consecutive_bad_steps=2,
        is_bad_fn=lambda m: next(calls) in (1, 2))
    it = iter(items)
    for _ in range(3):
        loop.progress(it)
    restored = ck.restore(dmp, 0)
    rolled_back = loop.rollbacks == 1 and _state_equal(pipe.state, restored)
    # the pending batch is item 3: a fresh pipeline from step 0 over 3..
    fresh = BucketedTrainPipelineSemiSync(dmp, restored, _bucketing_config())
    fit = iter(items[3:])
    equal = []
    for _ in range(2):
        loop.progress(it)
        fresh.progress(fit)
        equal.append(_state_equal(pipe.state, fresh.state))
    torch.cuda.synchronize()
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    rec = {"rolled_back_to_step_0": rolled_back,
           "prefetch_recomputed": len(refreshed),
           "steps_equal_fresh_pipeline": equal, "launches": counts}
    # 5 loop steps and 2 fresh ones: one B6 each; B4 embeds ahead
    if not (rolled_back and refreshed and all(equal)
            and counts.get("dedup_fused_sparse_update") == 7
            and counts.get("dedup_pooled_lookup", 0) >= 7
            and set(counts) <= {"dedup_pooled_lookup",
                                "dedup_fused_sparse_update"}):
        raise AssertionError(f"ft_loop semi-sync arm failed: {rec}")
    del dmp, state, pipe, fresh, restored, loop
    return rec, counts


def ft_loop_phase(dev, flush):
    """The fault-tolerant loop at ``bench.py main()``'s DMP (budget
    ``FT_BUDGET_S``; :func:`build_trainer`): ``FaultTolerantTrainLoop``
    over ``TrainPipelineSparseDist`` with ``Checkpointer(keep_last_n=2,
    async_save=True)`` and a checkpoint every ``FT_CKPT_EVERY`` applied
    steps, in a temporary directory the phase removes, over the stream of
    ``FT_ITEMS`` items.  Hard checks: the NaN step is skipped and leaves
    the state ``torch.equal`` to before it; three bad steps in a row roll
    back to a state ``torch.equal`` to a fresh restore of the last commit;
    the transient read errors are retried; a SIGTERM makes ``progress``
    raise ``Preempted`` after a final checkpoint, a new loop auto-resumes
    from it (``torch.equal``), a SIGTERM inside ``run()`` returns with
    ``preempted`` true, and a third loop finishes; the final tables, slots
    and dense state ``torch.equal`` to one uninterrupted run over the
    applied items (``FT_APPLIED``); every step call launched one B1 and
    one B2 and nothing else (counts, and a profiled step); B1 and B2
    ``torch.equal`` to plain at the step's shapes (the path check); the
    checkpoint drills (:func:`ft_checkpoint_checks`) and the semi-sync
    arm (:func:`ft_semisync_arm`).  Recorded: save and restore seconds,
    the disk's GB/s, the undo log's bytes and ms a step, the step's ms
    with and without the loop.  Returns (launches, path check record)."""
    import torch

    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.train_pipeline import (
        TrainPipelineSparseDist,
    )
    from torchrec_tpu_torch.reliability import (
        FaultTolerantTrainLoop,
        Preempted,
    )
    from torchrec_tpu_torch.reliability.fault_injection import (
        FlakyIterator,
        NaNInjectingStep,
    )

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    tmp = tempfile.mkdtemp(prefix="ft_loop_")
    try:
        dmp, state, batches = build_trainer(dev, torch.float32)
        items = [batches[i % len(batches)] for i in range(FT_ITEMS)]
        start = _clone_state(state)
        path = train_path_check(dmp, state, batches[0], None,
                                phase="ft_loop_path_check")
        d = os.path.join(tmp, "loop")

        def new_loop(step, st):
            pipe = TrainPipelineSparseDist(step, st, dev)
            return pipe, FaultTolerantTrainLoop(
                pipe, Checkpointer(d, keep_last_n=2, async_save=True), dmp,
                checkpoint_interval=FT_CKPT_EVERY,
                max_consecutive_bad_steps=3)

        torch.cuda.synchronize()
        tbe.reset_launch_counts()
        t_loops = time.perf_counter()
        # loop 1: items 0-13, the skip, the rollback, the retries, SIGTERM
        pipe, loop = new_loop(NaNInjectingStep(_signalling_step(
            dmp.train_step, FT_SIGTERM_AFTER[0]), FT_NAN), state)
        loop.install_signal_handlers()
        src = FlakyIterator(items, fail_on=FT_FLAKY)
        for _ in range(3):
            loop.progress(src)
        before = _clone_state(pipe.state)
        loop.progress(src)  # item 3: NaN
        skip_equal = loop.last_step_skipped and _state_equal(pipe.state,
                                                             before)
        undo_bytes = loop.last_undo_bytes
        del before
        for _ in range(6):  # items 4-6 applied, 7-9 NaN: the rollback
            loop.progress(src)
        loop.checkpointer.wait()
        rollback_equal = loop.rollbacks == 1 and _state_equal(
            pipe.state, Checkpointer(d).restore(dmp, 4))
        for _ in range(4):  # items 10-13, the SIGTERM after 13
            loop.progress(src)
        preempted = False
        try:
            loop.progress(src)
        except Preempted:
            preempted = True
        summary1 = loop.scalar_metrics()
        # loop 2: auto-resumes, SIGTERM inside run() after item 16
        pipe2, loop2 = new_loop(_signalling_step(dmp.train_step,
                                                 FT_SIGTERM_AFTER[1]),
                                dmp.init(torch.Generator(device=dev)
                                         .manual_seed(1)))
        resumed_equal = (loop2.resumed_from == 8
                         and _state_equal(pipe2.state, pipe.state))
        del pipe, loop
        loop2.install_signal_handlers()
        run2 = loop2.run(iter(items[14:]))
        # loop 3: auto-resumes and finishes
        pipe3, loop3 = new_loop(dmp.train_step, dmp.init(
            torch.Generator(device=dev).manual_seed(2)))
        run3 = loop3.run(iter(items[17:]))
        torch.cuda.synchronize()
        loops_s = time.perf_counter() - t_loops
        counts = {k: v for k, v in tbe.launch_counts().items() if v}
        # one uninterrupted run over the applied items
        ref = start
        for i in FT_APPLIED:
            ref, _ = dmp.train_step(ref, items[i])
        final_equal = _state_equal(pipe3.state, ref)
        del ref, start
        calls = 14 + 3 + 3  # loop 1, 2 and 3's step calls
        ckpt = ft_checkpoint_checks(dmp, pipe3.state, items[0], tmp)
        # timing: the undo log's own work, the step alone and in the loop
        st = pipe3.state
        undo_ms = _undo_log_ms(dmp, st, items[0], FT_TIMED)
        plain_ms = _cuda_ms(lambda: dmp.train_step(st, items[0]), FT_TIMED)
        tp = TrainPipelineSparseDist(dmp.train_step, st, dev)
        tloop = FaultTolerantTrainLoop(
            tp, Checkpointer(os.path.join(tmp, "timed")), dmp,
            checkpoint_interval=None, resume=False, checkpoint_on_start=False)
        titer = iter(items * 2)
        tloop.progress(titer)
        loop_ms = _cuda_ms(lambda: tloop.progress(titer), FT_TIMED)
        profiled = _profiled_kernels(lambda: tloop.progress(titer))
        del tp, tloop, st, pipe2, loop2, pipe3, loop3, dmp, state, batches
        del items
        torch.cuda.empty_cache()
        semi, semi_counts = ft_semisync_arm(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "ft_loop", "card": card, "items": FT_ITEMS,
           "checkpoint_every": FT_CKPT_EVERY,
           "skip_equal": skip_equal, "rollback_equal": rollback_equal,
           "data_retries": summary1.get("reliability/data_retries"),
           "loop1": {k.split("/")[1]: v for k, v in summary1.items()},
           "progress_raised_preempted": preempted,
           "resumed_equal": resumed_equal, "run2": run2, "run3": run3,
           "final_equal_uninterrupted": final_equal,
           "launches": counts, "step_calls": calls,
           "profiled_launches_one_step": profiled,
           "save_seconds_async_snapshot": summary1[
               "reliability/checkpoint_save_seconds"] / max(
               1, summary1["reliability/checkpoint_save_count"]),
           "checkpoint": ckpt, "undo_bytes_per_step": undo_bytes,
           "undo_device_ms_per_step": undo_ms["open"] + undo_ms["gathers"],
           "undo_device_ms": undo_ms, "step_ms_plain": plain_ms,
           "step_ms_in_loop": loop_ms, "loops_seconds": loops_s,
           "semi_sync": semi,
           "seconds": time.perf_counter() - t_phase,
           "budget_s": FT_BUDGET_S}
    emit(rec)
    ok = (skip_equal and rollback_equal and preempted and resumed_equal
          and final_equal and rec["data_retries"] == len(FT_FLAKY)
          and run2["preempted"] and run2["final_step"] == 11
          and not run3["preempted"] and run3["final_step"] == 14
          and run3["resumed_from"] == 11
          and summary1["reliability/rollbacks"] == 1
          and summary1["reliability/skipped_steps"] == len(FT_NAN))
    if not ok:
        raise AssertionError(f"ft_loop failed: {rec}")
    if (counts.get("pooled_lookup") != calls
            or counts.get("fused_sparse_update") != calls
            or set(counts) - {"pooled_lookup", "fused_sparse_update"}
            or profiled != {"pooled_lookup": 1, "fused_sparse_update": 1}):
        raise AssertionError(f"ft_loop: {calls} step calls launched "
                             f"{counts}, profiled {profiled}")
    if rec["seconds"] > FT_BUDGET_S:
        raise AssertionError(f"ft_loop took {rec['seconds']:.1f} s")
    launches = dict(counts)
    for k, v in semi_counts.items():
        launches[k] = launches.get(k, 0) + v
    return launches, path


ELASTIC_BUDGET_S = 90
ELASTIC_RANKS = 2  # gloo ranks sharing the card in generation 0
ELASTIC_ROWS = 10_000  # a table: a checkpoint every step is 133 MB
ELASTIC_STEPS, ELASTIC_KILL_STEP = 6, 3
ELASTIC_TORN = (3, 2)  # the kill_mid_save drill's steps, its torn step
ELASTIC_SEED = 11
ELASTIC_DEVICE = "cuda:0"  # every worker's: the ranks share the card


def elastic_widths():
    """``bench.py main()``'s widths with ``ELASTIC_ROWS`` rows a table."""
    from torchrec_tpu_torch.reliability.elastic_demo import Widths

    return Widths(features=TRAIN_FEATURES, rows=(ELASTIC_ROWS,), dim=DIM,
                  ids=1, batch=TRAIN_BATCH, dense_in=NUM_DENSE,
                  dense_arch=DENSE_ARCH, over_arch=OVER_ARCH)


def _elastic_drill(tmp, name, steps, fault):
    """One ``ElasticSupervisor`` run of ``elastic_demo.py`` over
    ``ELASTIC_RANKS`` gloo ranks on ``cuda:0`` with one scheduled
    process fault; returns (report, the final generation's result, the
    checkpoint directory, seconds)."""
    from torchrec_tpu_torch.reliability import ElasticSupervisor
    from torchrec_tpu_torch.reliability import elastic_demo
    from torchrec_tpu_torch.reliability.fault_injection import (
        ProcessFaultPlan,
    )

    run_dir = os.path.join(tmp, name)
    ckpt = os.path.join(run_dir, "ckpt")
    out = os.path.join(run_dir, "result.json")
    sup = ElasticSupervisor(
        elastic_demo.__file__, ELASTIC_RANKS,
        args=["--steps", str(steps), "--ckpt", ckpt, "--out", out,
              "--seed", str(ELASTIC_SEED), "--device", ELASTIC_DEVICE,
              *elastic_demo.widths_args(elastic_widths())],
        run_dir=run_dir, fault_plan=ProcessFaultPlan([fault]),
        max_relaunches=2, hang_timeout_s=60.0, startup_grace_s=120.0,
        generation_timeout_s=240.0, env_extra={"PYTHONPATH": ROOT})
    t0 = time.perf_counter()
    report = sup.run()
    seconds = time.perf_counter() - t0
    for g in report.generations:
        for pid in g.pids:
            try:
                os.kill(pid, 0)
            except (ProcessLookupError, PermissionError):
                continue
            raise AssertionError(f"{name}: orphaned worker {pid}")
    with open(out) as f:
        return report, json.load(f), ckpt, seconds


def elastic_phase(dev):
    """The elastic supervisor (budget ``ELASTIC_BUDGET_S``):
    ``ElasticSupervisor`` spawns ``reliability/elastic_demo.py`` as
    ``ELASTIC_RANKS`` gloo ranks sharing the card, at ``bench.py
    main()``'s widths (26 features, D=128, B=4096 a rank) with
    ``ELASTIC_ROWS`` rows a table, a checkpoint every step behind the
    two-phase commit barrier.  Hard checks: generation 0 runs at world 2,
    rank 1 is SIGKILLed at step ``ELASTIC_KILL_STEP``, the supervisor
    tears down and relaunches at world 1, which resumes through
    ``restore_elastic`` to step ``ELASTIC_STEPS``; its final checkpoint's
    digest equals a clean world-1 run here (in this process, B1 and B2
    launched every step) restarted from a copy of the committed step; a
    ``kill_mid_save`` drill leaves the torn step uncommitted, and the
    relaunch resumes from the step before it; each drill's supervised
    final generation launched one B1 and one B2 a resumed step and no
    other kernel (the counts its worker writes to its result), as did the
    clean run.  Recorded: detection, teardown, relaunch and restore
    seconds and the report's scalars.  Returns the supervised final
    generations' launches, summed."""
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.reliability import elastic_demo
    from torchrec_tpu_torch.reliability.fault_injection import ProcessFault

    t0 = time.perf_counter()
    card = nvidia_smi_line()
    tmp = tempfile.mkdtemp(prefix="elastic_")
    try:
        report, result, ckpt, kill_s = _elastic_drill(
            tmp, "kill", ELASTIC_STEPS,
            ProcessFault(rank=1, step=ELASTIC_KILL_STEP, kind="kill"))
        clean_dir = os.path.join(tmp, "clean")
        shutil.copytree(os.path.join(ckpt, f"step_{ELASTIC_KILL_STEP}"),
                        os.path.join(clean_dir, f"step_{ELASTIC_KILL_STEP}"))
        tbe.reset_launch_counts()
        clean = elastic_demo.run(ELASTIC_STEPS, clean_dir, seed=ELASTIC_SEED,
                                 device=str(dev), widths=elastic_widths())
        counts = {k: v for k, v in tbe.launch_counts().items() if v}
        torn_report, torn, torn_ckpt, torn_s = _elastic_drill(
            tmp, "torn", ELASTIC_TORN[0],
            ProcessFault(rank=1, step=ELASTIC_TORN[1], kind="kill_mid_save"))
        torn_dirs = sorted(n for n in os.listdir(torn_ckpt)
                           if n.startswith(f".tmp_step_{ELASTIC_TORN[1]}."))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gens = report.generations
    rec = {"phase": "elastic", "card": card, "note": ONE_CARD.replace(
               "4 ranks", f"{ELASTIC_RANKS} ranks"),
           "rows_per_table": ELASTIC_ROWS, "batch_per_rank": TRAIN_BATCH,
           "generations": [{"world": g.world, "ok": g.ok,
                            "failures": [dataclasses.asdict(f)
                                         for f in g.failures]}
                           for g in gens],
           "detect_latency_s": report.detect_latency_s,
           "teardown_s": report.teardown_s,
           "relaunch_to_first_resumed_step_s":
               report.relaunch_to_first_resumed_step_s,
           "mttr_s": report.mttr_s, "scalars": report.scalar_metrics(),
           "result": result, "clean_restart": clean,
           "digest_equal": result["digest"] == clean["digest"],
           "clean_launches": counts, "drill_seconds": kill_s,
           "torn": {"report": torn_report.scalar_metrics(),
                    "failures": [dataclasses.asdict(f) for f in
                                 torn_report.generations[0].failures],
                    "resumed_from": torn["resumed_from"],
                    "final_step": torn["final_step"],
                    "launches": torn["launches"],
                    "torn_tmp_dirs": torn_dirs, "seconds": torn_s},
           "seconds": time.perf_counter() - t0,
           "budget_s": ELASTIC_BUDGET_S}
    emit(rec)
    steps = ELASTIC_STEPS - ELASTIC_KILL_STEP
    ok = (report.ok and report.restarts == 1 and len(gens) == 2
          and gens[0].world == ELASTIC_RANKS and gens[1].world == 1
          and [(f.rank, f.cause) for f in gens[0].failures] == [(1, "crash")]
          and result["resumed_from"] == ELASTIC_KILL_STEP
          and result["final_step"] == ELASTIC_STEPS and result["world"] == 1
          and rec["digest_equal"]
          and clean["resumed_from"] == ELASTIC_KILL_STEP
          and torn_report.ok and torn_report.restarts == 1
          and any(f.rank == 1 and f.cause == "crash"
                  for f in torn_report.generations[0].failures)
          and torn["resumed_from"] == ELASTIC_TORN[1] - 1
          and torn["final_step"] == ELASTIC_TORN[0] and torn_dirs)
    if not ok:
        raise AssertionError(f"elastic failed: {rec}")
    torn_steps = ELASTIC_TORN[0] - torn["resumed_from"]
    for name, n, got in (("clean run", steps, counts),
                         ("supervised resume", steps, result["launches"]),
                         ("torn drill's resume", torn_steps,
                          torn["launches"])):
        if got != {"pooled_lookup": n, "fused_sparse_update": n}:
            raise AssertionError(f"elastic {name}: {n} steps launched {got}")
    if rec["seconds"] > ELASTIC_BUDGET_S:
        raise AssertionError(f"elastic took {rec['seconds']:.1f} s")
    return {k: result["launches"][k] + torn["launches"][k]
            for k in result["launches"]}


# ---------------------------------------------------------------------------
# phase tiered: MLPerf DLRM-v2 trained with its five largest tables
# host-cached (tiered storage)
# ---------------------------------------------------------------------------

TIERED_BUDGET_S = 150
# the tables' rows are train_dcn's cut: the all-device oracle holds the
# same tables on the card, and the host tier initialises in the budget
TIERED_ROW_CAP = DCN_ROW_CAP
TIERED_CLF = 0.2  # the host-cached tables' cache load factor
TIERED_STEPS = 20  # timed, after one warm-up step
TIERED_PROFILED = 2  # profiled steps of the prefetch run, after its check
TIERED_OFFLOAD_STEPS = 3  # the synchronous host_offload arm
TIERED_INIT_BLOCK = 1 << 16  # rows of one seeded init block
TIERED_SEED = 23
TIERED_ZIPF_SEED = 29
# the loop arm: the same tables cut to fewer rows, a smaller batch
TIERED_LOOP_ROW_CAP = 100_000
TIERED_LOOP_BATCH = 512
TIERED_LOOP_BATCHES = 9
TIERED_LOOP_NAN = 2  # the step call the NaN injector poisons
TIERED_LOOP_EVERY = 3  # applied steps between the loop's checkpoints


def _mem_available_bytes():
    """The host's available memory (``/proc/meminfo``), or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def tiered_names():
    """(keys, capped rows, multi-hot sizes, the host-cached keys): the
    MLPerf DLRM-v2 tables of ``TIERED_ROW_CAP`` rows, the five 40M-row
    tables host-cached."""
    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        MLPERF_DLRM_V2_ROWS,
    )

    big = max(MLPERF_DLRM_V2_ROWS)
    cached = [k for k, r in zip(DEFAULT_CAT_NAMES, MLPERF_DLRM_V2_ROWS)
              if r == big]
    return (list(DEFAULT_CAT_NAMES), list(MLPERF_DLRM_V2_ROWS),
            list(MLPERF_DLRM_V2_MULTI_HOT), cached)


def tiered_batches(row_cap, batch, n, seed=TIERED_ZIPF_SEED):
    """``n`` host batches of the fixed multi-hot stream over the tables
    capped at ``row_cap`` (four base batches, cycled), the host-cached
    keys' ids drawn afresh each batch Zipf(1.1) (``zipf_ids``) so that
    the cache has a hot set; returns (keys, rows, caps, batches)."""
    import dataclasses

    import torch

    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    keys, rows, hot, cached = tiered_names()
    rows = [min(r, row_cap) for r in rows]
    ds = RandomRecDataset(keys, batch, rows, hot, num_dense=NUM_DENSE,
                          manual_seed=0, min_ids_per_features=hot)
    it = iter(ds)
    base = [next(it) for _ in range(min(n, TRAIN_BATCHES))]
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        b = base[i % len(base)]
        kjt = b.sparse_features
        values = kjt.values().numpy().copy()
        lens = kjt.lengths().numpy()
        lo, co = kjt._length_offsets(), kjt.cap_offsets()
        for f, k in enumerate(keys):
            if k in cached:
                m = int(lens[lo[f]:lo[f + 1]].sum())
                values[co[f]:co[f] + m] = zipf_ids(rng, m, rows[f])
        out.append(dataclasses.replace(b, sparse_features=kjt.with_values(
            torch.from_numpy(values).to(kjt.values().dtype))))
    return keys, rows, ds.caps, out


def tier_init(dev, t, rows):
    """The seeded init of table index ``t`` of ``rows`` rows: ``(start,
    end) -> [end - start, DIM]`` float32 on ``dev``, uniform in
    +-1/sqrt(rows), a pure function of (seed, table, row): each block of
    ``TIERED_INIT_BLOCK`` rows draws from its own generator on the card,
    so the host tier (in parallel chunks) and the all-device tables get
    the same rows."""
    import torch

    scale = 1.0 / float(np.sqrt(rows))

    def block(b):
        g = torch.Generator(device=dev).manual_seed(
            TIERED_SEED * 1_000_003 + t * 10_007 + b)
        n = min(TIERED_INIT_BLOCK, rows - b * TIERED_INIT_BLOCK)
        return (torch.rand((n, DIM), generator=g, device=dev) * 2 - 1) * scale

    def rows_of(s, e):
        b0, b1 = s // TIERED_INIT_BLOCK, (e - 1) // TIERED_INIT_BLOCK
        parts = torch.cat([block(b) for b in range(b0, b1 + 1)])
        off = b0 * TIERED_INIT_BLOCK
        return parts[s - off:e - off]

    return rows_of


def tiered_plan(tables, cached_names, batch):
    """The planner's plan at world 1 (and the cache load factors it
    chose): the host-cached tables TABLE_WISE with the FUSED_HOST_CACHED
    kernel, the others TABLE_WISE on the card.  The planner scales caches
    into the card memory left over, which at the capped rows holds the
    whole tables; the cached entries are pinned to ``TIERED_CLF``, the
    MLPerf configuration's factor."""
    import dataclasses

    from torchrec_tpu_torch.parallel.planner import (
        EmbeddingShardingPlanner,
        ParameterConstraints,
    )
    from torchrec_tpu_torch.parallel.types import (
        EmbeddingComputeKernel,
        ShardingType,
    )

    _, _, hot, _ = tiered_names()
    constraints = {}
    for cfg, h in zip(tables, hot):
        cached = cfg.name in cached_names
        constraints[cfg.name] = ParameterConstraints(
            sharding_types=[ShardingType.TABLE_WISE],
            compute_kernels=[EmbeddingComputeKernel.FUSED_HOST_CACHED
                             if cached else EmbeddingComputeKernel.FUSED],
            cache_load_factor=TIERED_CLF if cached else None,
            pooling_factor=float(h))
    plan = EmbeddingShardingPlanner(
        world_size=1, constraints=constraints,
        batch_size_per_device=batch).plan(tables)
    chosen = {t: plan[t].cache_load_factor for t in cached_names}
    for t in cached_names:
        plan[t] = dataclasses.replace(plan[t], cache_load_factor=TIERED_CLF)
    return plan, chosen


def _dcn_dmp(dev, tables, plan, batch, caps, kernels=("tbe", "tbe")):
    """``DistributedModelParallel`` of ``DLRM_DCN`` at the recipe's widths
    (train_dcn's model and optimizer: per-element Adagrad, lr 0.004) over
    ``tables`` under ``plan``, and a fresh state."""
    import torch

    from torchrec_tpu_torch.models.dlrm import DLRM_DCN
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )

    torch.manual_seed(0)
    model = DLRM_DCN(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                     DCN_LAYERS, DCN_RANK, dense_dtype=torch.bfloat16)
    dmp = DistributedModelParallel(
        model, tables, plan, batch, caps,
        fused_config=FusedOptimConfig(optim=EmbOptimType.ADAGRAD,
                                      learning_rate=DCN_LR, eps=EPS),
        dense_optimizer=adagrad(DCN_LR), device=dev,
        lookup_kernel=kernels[0], update_kernel=kernels[1])
    return dmp, dmp.init(torch.Generator(device=dev).manual_seed(0))


def _table_views(dmp, state):
    """Per table: (weights, momentum) views of the group stacks."""
    ebc = dmp.sharded_ebc
    w = ebc.tables_to_weights(state["tables"])
    m = ebc.tables_to_weights({g: s["momentum"]
                               for g, s in state["fused"].items()})
    return {t: (w[t], m[t]) for t in w}


def _reset_state(dmp, state, inits, dense0, skip=()):
    """Put ``state`` back to the phase's start: every table but ``skip``
    from its seeded init, the slots zero, the dense parameters
    ``dense0``, a fresh dense optimizer state, step 0 (in place)."""
    import torch

    for t, (w, m) in _table_views(dmp, state).items():
        m.zero_()
        if t in skip:
            continue
        for s in range(0, w.shape[0], 1 << 20):
            e = min(s + (1 << 20), w.shape[0])
            w[s:e].copy_(inits[t](s, e))
    state["dense"] = {k: v.clone() for k, v in dense0.items()}
    state["dense_opt"] = dmp.dense_tx.init(state["dense"])
    state["step"] = 0
    if dmp.device.type == "cuda":
        torch.cuda.synchronize()
    return state


def _dense_equal(a, b):
    import torch

    return all(torch.equal(a["dense"][k], b["dense"][k]) for k in a["dense"])


def _logical_equal(coll, dmp, state, ref_dmp, ref_state, chunk=1 << 20):
    """Each host-cached table's logical rows (the host tier after the
    cache's rows were written back to it) ``torch.equal`` to the
    all-device run's weights and Adagrad slots, chunk by chunk on the
    card; the other tables' weights and slots ``torch.equal`` too."""
    import torch

    coll.sync_to_host(dmp, state)
    coll.flush()
    ref = _table_views(ref_dmp, ref_state)
    mine = _table_views(dmp, state)
    bad = []
    for t, tbl in coll.tables.items():
        rw, rm = ref[t]
        D = tbl.embedding_dim
        for s in range(0, tbl.num_embeddings, chunk):
            e = min(s + chunk, tbl.num_embeddings)
            # the RAM tier's rows in place (a contiguous slice), copied to
            # the card once
            host = torch.from_numpy(tbl.store.array[s:e]).to(rw.device)
            if not (torch.equal(host[:, :D], rw[s:e])
                    and torch.equal(host[:, D:], rm[s:e])):
                bad.append(t)
                break
    for t, (w, m) in mine.items():
        if t not in coll.tables and not (torch.equal(w, ref[t][0])
                                         and torch.equal(m, ref[t][1])):
            bad.append(t)
    return bad


class _IoMeter:
    """Wraps a tiered collection's remap and IO: host seconds of each,
    the last remapped batch group (the kernels' check inputs), and the
    fetches of ids written back by an earlier step (the stream must
    fetch rows right after their eviction for the check to see a stale
    write-back)."""

    def __init__(self, coll):
        self.remap_s = self.io_s = 0.0
        self.refetched = 0
        self.written = {t: set() for t in coll.tables}
        self.last_kjts = None
        process, apply_io = coll.process_group, coll.apply_io

        def timed_process(kjts):
            t0 = time.perf_counter()
            out = process(kjts)
            self.remap_s += time.perf_counter() - t0
            self.last_kjts = out[0]
            return out

        def timed_apply(dmp, state, ios, staged=None):
            for t, io in ios.items():
                seen = self.written[t]
                self.refetched += len(seen.intersection(
                    io.fetch_logical.tolist()))
                seen.update(io.writeback_logical.tolist())
            t0 = time.perf_counter()
            out = apply_io(dmp, state, ios, staged=staged)
            self.io_s += time.perf_counter() - t0
            return out

        coll.process_group, coll.apply_io = timed_process, timed_apply


def _host_inits(inits, names):
    """The host tiers' ``init_fn``s: the seeded rows, on the host."""
    return {t: (lambda s, e, f=inits[t]: f(s, e).cpu().numpy())
            for t in names}


def _tiered_run(dev, dmp, state, tables, names_to_keys, inits, dense0,
                batches, prefetch, card, refill):
    """One tiered run over ``tables`` (``tiered_tables_from_plan``'s, their
    host tiers at the seeded init; ``refill``: an earlier run's, filled
    again in place first, which spares the host the page faults of a new
    25.6 GB): ``TieredTrainPipeline`` over the batches (1 warm-up and
    ``TIERED_STEPS`` timed steps).  Returns (the pipeline, its
    collection, the meter, losses, timed seconds, launch counts, host
    tier refill seconds)."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.tiered import (
        TieredCollection,
        TieredTrainPipeline,
    )

    _reset_state(dmp, state, inits, dense0, skip=set(names_to_keys))
    t0 = time.perf_counter()
    if refill:
        host_inits = _host_inits(inits, names_to_keys)
        for t, tbl in tables.items():
            tbl._init_rows(tbl.store.array, host_inits[t], 0)
    for tbl in tables.values():
        tbl.reset_cache()
    init_s = time.perf_counter() - t0
    coll = TieredCollection(tables, {k: t for t, k in names_to_keys.items()})
    meter = _IoMeter(coll)
    pipe = TieredTrainPipeline(dmp, state, coll, _tiered_bucketing(),
                               prefetch=prefetch)
    it = iter(batches[:1 + TIERED_STEPS])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    warm, _ = _pipeline_steps(pipe, it, 1)
    losses, dt = _pipeline_steps(pipe, it, TIERED_STEPS)
    counts = tbe.launch_counts()
    return pipe, coll, meter, warm + losses, dt, counts, init_s


def _tiered_bucketing():
    from torchrec_tpu_torch.parallel.train_pipeline import BucketingConfig

    return BucketingConfig(**BUCKETING,
                           kernels={"pooled": "dedup", "update": "dedup"})


def tiered_offload_arm(dev, full, full_state, cache, cstate, inits, dense0,
                       names_to_keys, batches, logical_rows, cache_rows,
                       card, weights):
    """The synchronous ``host_offload`` path as ``bench.py``'s tiered mode
    runs it: per batch the remap, the write-back and the fill in front of
    the DMP's own step (B1 and B2) over the cache tables, against the
    all-device DMP's step on the same batches, its host tables
    ``weights`` (the tiered host tiers' weight columns, seeded, which it
    only reads).  No eviction happens in ``TIERED_OFFLOAD_STEPS`` steps
    (the caches hold every id drawn), so the weights-only path must give
    the same losses, rows, slots and dense parameters (``torch.equal``).
    Returns (record, launches)."""
    import dataclasses

    import torch

    from torchrec_tpu_torch.modules.host_offload import (
        HostOffloadedCollection,
        HostOffloadedTable,
    )
    from torchrec_tpu_torch.ops import tbe

    n = TIERED_OFFLOAD_STEPS
    _reset_state(full, full_state, inits, dense0)
    _reset_state(cache, cstate, inits, dense0, skip=set(names_to_keys))
    ref_losses = []
    for b in batches[:n]:
        full_state, m = full.train_step(full_state, b.to(dev))
        ref_losses.append(float(m["loss"]))
    hoc = HostOffloadedCollection(
        {t: HostOffloadedTable(t, logical_rows[t], DIM, cache_rows[t],
                               storage=weights[t])
         for t in names_to_keys},
        {k: t for t, k in names_to_keys.items()})
    fetched = {t: {} for t in names_to_keys}
    evicted = 0
    tbe.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in batches[:n]:
        kjt, ios = hoc.process(b.sparse_features)
        for t, io in ios.items():
            fetched[t].update(zip(io.fetch_logical.tolist(),
                                  io.fetch_slots.tolist()))
            evicted += len(io.writeback_slots)
        cstate = hoc.apply_io(cache, cstate, ios)
        cstate, m = cache.train_step(
            cstate, dataclasses.replace(b, sparse_features=kjt).to(dev))
        losses.append(m["loss"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = tbe.launch_counts()
    losses = [float(x) for x in losses]
    bad = []
    for t, pairs in fetched.items():
        ids = np.fromiter(pairs.keys(), np.int64, len(pairs))
        slots = np.fromiter(pairs.values(), np.int64, len(pairs))
        slot_cols = {"momentum": DIM}
        got = cache.gather_row_state_tensor(cstate, t, slots, slot_cols)
        want = full.gather_row_state_tensor(full_state, t, ids, slot_cols)
        if not torch.equal(got, want):
            bad.append(t)
    views, ref = _table_views(cache, cstate), _table_views(full, full_state)
    bad += [t for t, (w, m) in views.items() if t not in names_to_keys
            and not (torch.equal(w, ref[t][0]) and torch.equal(m, ref[t][1]))]
    rec = {"phase": "tiered_offload", "card": card, "steps": n,
           "batch": DCN_BATCH,
           "ms_per_step": dt * 1e3 / n, "samples_per_s": n * DCN_BATCH / dt,
           "losses": losses, "reference_losses": ref_losses,
           "evicted_rows": evicted,
           "fetched_rows": {t: len(p) for t, p in fetched.items()},
           "launches": {k: v for k, v in counts.items() if v},
           "mismatched_tables": bad, "dense_equal": _dense_equal(cstate,
                                                                 full_state)}
    emit(rec)
    want = {"pooled_lookup": n, "fused_sparse_update": n}
    if (losses != ref_losses or bad or not rec["dense_equal"] or evicted
            or rec["launches"] != want):
        raise AssertionError(f"tiered host_offload arm failed: {rec}")
    del hoc
    return rec, counts


def tiered_loop_arm(dev, tmp, card):
    """The fault-tolerant loop over the tiered pipeline at
    ``TIERED_LOOP_ROW_CAP`` rows and ``TIERED_LOOP_BATCH`` a batch: (1) a
    ``NaNInjectingStep`` skip (the loop's undo log, recorded after the
    step's fills, undoes the step) leaves the same state as an
    uninterrupted run over the stream without that batch; (2) the loop's
    interval checkpoints drain the lookahead first, and a fresh world
    restored from one of them (host tiers with the device state) and run
    over the rest of the stream ends on the same tables.  Both compared
    ``torch.equal`` / bitwise on every logical row, slot and dense
    parameter.  Returns the record."""
    import torch

    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.parallel.types import table_wise_plan
    from torchrec_tpu_torch.reliability import FaultTolerantTrainLoop
    from torchrec_tpu_torch.reliability.fault_injection import (
        NaNInjectingStep,
    )
    from torchrec_tpu_torch.tiered import (
        TieredCollection,
        TieredTrainPipeline,
        tiered_tables_from_plan,
    )

    t0 = time.perf_counter()
    keys, rows, caps, batches = tiered_batches(
        TIERED_LOOP_ROW_CAP, TIERED_LOOP_BATCH, TIERED_LOOP_BATCHES)
    _, _, _, cached = tiered_names()
    logical, names_to_keys, plan, _, cache_tables, inits = _tiered_tables(
        dev, keys, rows, cached, TIERED_LOOP_BATCH)
    caps_d = dict(zip(keys, caps))
    ref_dmp, ref_state = _dcn_dmp(dev, logical, table_wise_plan(logical),
                                  TIERED_LOOP_BATCH, caps_d)
    dense0 = {k: v.clone() for k, v in ref_state["dense"].items()}
    del ref_dmp, ref_state

    def world():
        dmp, st = _dcn_dmp(dev, cache_tables, plan, TIERED_LOOP_BATCH, caps_d)
        _reset_state(dmp, st, inits, dense0, skip=set(names_to_keys))
        host_inits = {t: (lambda s, e, f=inits[t]: f(s, e).cpu().numpy())
                      for t in names_to_keys}
        tabs = tiered_tables_from_plan(plan, logical, dmp.fused_config,
                                       init_fns=host_inits)
        coll = TieredCollection(tabs, {k: t for t, k in names_to_keys.items()})
        pipe = TieredTrainPipeline(dmp, st, coll, _tiered_bucketing())
        return dmp, coll, pipe

    def inject(pipe, calls):
        # every step program of the pipeline's cache through one injector
        programs = pipe.cache.train_program
        current = [None]
        inj = NaNInjectingStep(lambda s, b: current[0](s, b), calls)

        def program(sig):
            current[0] = programs(sig)
            return inj

        pipe.cache.train_program = program
        return inj

    def finish(loop, it):
        while True:
            try:
                loop.progress(it)
            except StopIteration:
                break
        loop.pipeline.drain()

    def snapshot(dmp, coll, pipe):
        st = pipe.state
        views = _table_views(dmp, st)
        return ({t: coll.logical_table_rows(dmp, st, t) for t in coll.tables},
                {t: (w.clone(), m.clone()) for t, (w, m) in views.items()
                 if t not in coll.tables},
                {k: v.clone() for k, v in st["dense"].items()})

    def same(a, b):
        return (all(np.array_equal(a[0][t], b[0][t]) for t in a[0])
                and all(torch.equal(a[1][t][0], b[1][t][0])
                        and torch.equal(a[1][t][1], b[1][t][1])
                        for t in a[1])
                and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))

    ckdir = os.path.join(tmp, "tiered_loop")
    # (1) the loop: a NaN at call TIERED_LOOP_NAN, interval checkpoints
    dmp1, coll1, pipe1 = world()
    inj = inject(pipe1, {TIERED_LOOP_NAN})
    ck1 = Checkpointer(ckdir, keep_last_n=2, tiered=coll1)
    loop1 = FaultTolerantTrainLoop(pipe1, ck1, dmp1,
                                   checkpoint_interval=TIERED_LOOP_EVERY,
                                   checkpoint_on_start=False,
                                   max_consecutive_bad_steps=10)
    finish(loop1, iter(batches))
    saved = ck1.steps()
    first = saved[0]
    s1 = snapshot(dmp1, coll1, pipe1)
    pipe1.close()
    del dmp1, coll1, pipe1, loop1
    # (2) the uninterrupted run without the poisoned batch
    dmp2, coll2, pipe2 = world()
    it = iter([b for i, b in enumerate(batches) if i != TIERED_LOOP_NAN])
    while True:
        try:
            pipe2.progress(it)
        except StopIteration:
            break
    s2 = snapshot(dmp2, coll2, pipe2)
    pipe2.close()
    del dmp2, coll2, pipe2
    # (3) a fresh world restored from the first committed checkpoint
    dmp3, coll3, pipe3 = world()
    ck3 = Checkpointer(ckdir, tiered=coll3)
    pipe3.state = ck3.restore(dmp3, first)
    pipe3.invalidate_prefetch()
    loop3 = FaultTolerantTrainLoop(pipe3, ck3, dmp3, checkpoint_interval=None,
                                   resume=False, checkpoint_on_start=False)
    # the checkpoint's step counts applied updates; the skipped batch
    # came before it
    finish(loop3, iter(batches[first + 1:]))
    s3 = snapshot(dmp3, coll3, pipe3)
    pipe3.close()
    del dmp3, coll3, pipe3, loop3
    rec = {"phase": "tiered_loop", "card": card,
           "row_cap": TIERED_LOOP_ROW_CAP, "batch": TIERED_LOOP_BATCH,
           "batches": TIERED_LOOP_BATCHES, "nan_call": TIERED_LOOP_NAN,
           "injected": inj.injected, "checkpoints": saved,
           "resumed_from": first,
           "skip_equals_uninterrupted": same(s1, s2),
           "resume_equals_uninterrupted": same(s3, s1),
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not (inj.injected == 1 and rec["skip_equals_uninterrupted"]
            and rec["resume_equals_uninterrupted"] and first > TIERED_LOOP_NAN):
        raise AssertionError(f"tiered loop arm failed: {rec}")
    return rec


def _tiered_tables(dev, keys, rows, cached, batch):
    """(logical table configs, cached table -> key, the plan, the
    planner's own cache factors, the cache DMP's table configs, seeded
    inits by table) for ``rows``; the cache tables are as many rows as
    the plan's factor gives (``cache_rows_from_plan``)."""
    import dataclasses

    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.modules.host_offload import cache_rows_from_plan

    logical = tuple(EmbeddingBagConfig(num_embeddings=r, embedding_dim=DIM,
                                       name=f"t_{k}", feature_names=[k])
                    for k, r in zip(keys, rows))
    names_to_keys = {f"t_{k}": k for k in cached}
    plan, chosen = tiered_plan(logical, set(names_to_keys), batch)
    n_cache = cache_rows_from_plan(plan, {c.name: c.num_embeddings
                                          for c in logical})
    cache_tables = tuple(
        dataclasses.replace(c, num_embeddings=n_cache[c.name])
        if c.name in n_cache else c for c in logical)
    inits = {c.name: tier_init(dev, i, c.num_embeddings)
             for i, c in enumerate(logical)}
    return logical, names_to_keys, plan, chosen, cache_tables, inits


def tiered_phase(dev, flush):
    """MLPerf DLRM-v2 trained with its five largest tables host-cached
    (budget ``TIERED_BUDGET_S``): ``DLRM_DCN`` at train_dcn's widths and
    optimizer, B = 8192, the 26 tables capped at ``TIERED_ROW_CAP`` rows;
    the planner's plan makes the five 40M-row tables FUSED_HOST_CACHED
    at ``TIERED_CLF`` (caches of 1,000,000 rows over host tiers of
    5,000,000 packed rows each, ``RamStore``), the others table-wise on
    the card; their ids are Zipf(1.1).  Arms, each from the same seeded
    tables: the synchronous ``host_offload`` path (B1/B2) against the
    all-device step; the all-device bucketed pipeline (B4/B6, the
    oracle); ``TieredTrainPipeline`` with prefetch and without, each
    ``torch.equal`` to the oracle in every loss and, after the cache's
    write-back, every logical row and Adagrad slot; B4 and B6 against
    their plain versions at the cache stack and a remapped batch; the
    loop arm.  Returns (the prefetch run's B4/B6 launches and the
    offload arm's B1/B2 launches, the kernel rows)."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad
    from torchrec_tpu_torch.parallel.train_pipeline import (
        BucketedTrainPipeline,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan
    from torchrec_tpu_torch.tiered import tiered_tables_from_plan

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    mem0 = _mem_available_bytes()
    n_batches = 1 + TIERED_STEPS
    # the profile's 1 + 2 x TIERED_PROFILED calls, and the lookahead
    # beyond them, so that each profiled step remaps a batch as the run's do
    keys, rows, caps, batches = tiered_batches(
        TIERED_ROW_CAP, DCN_BATCH, n_batches + 2 * TIERED_PROFILED + 4)
    _, _, _, cached = tiered_names()
    logical, names_to_keys, plan, chosen, cache_tables, inits = (
        _tiered_tables(dev, keys, rows, cached, DCN_BATCH))
    caps_d = dict(zip(keys, caps))
    full, full_state = _dcn_dmp(dev, logical, table_wise_plan(logical),
                                DCN_BATCH, caps_d)
    dense0 = {k: v.clone() for k, v in full_state["dense"].items()}
    cache, cstate = _dcn_dmp(dev, cache_tables, plan, DCN_BATCH, caps_d)
    logical_rows = {c.name: c.num_embeddings for c in logical}
    cache_rows = {c.name: c.num_embeddings for c in cache_tables}
    row_width = 2 * DIM  # weights and the per-element Adagrad slot
    setup = {"phase": "tiered_setup", "card": card,
             "seconds": time.perf_counter() - t_phase,
             "mem_available_bytes": mem0,
             "host_tier_bytes": sum(logical_rows[t] for t in names_to_keys)
             * row_width * 4,
             "plan": {t: [ps.sharding_type.value, ps.compute_kernel.value,
                          ps.cache_load_factor]
                      for t, ps in plan.items() if t in names_to_keys},
             "planner_cache_load_factors": chosen,
             "cache_rows": {t: cache_rows[t] for t in names_to_keys},
             "logical_rows": {t: logical_rows[t] for t in names_to_keys},
             "ids_per_batch": int(batches[0].sparse_features.lengths()
                                  .sum())}
    emit(setup)
    if mem0 is not None and mem0 < 1.5 * setup["host_tier_bytes"]:
        raise AssertionError(f"host memory {mem0} cannot take a RAM host "
                             f"tier of {setup['host_tier_bytes']} bytes")

    marks = {"setup": time.perf_counter() - t_phase}
    # the host tiers, from the seeded init on the card in parallel chunks;
    # the offload arm reads their weight columns, the runs the whole rows
    t_arm = time.perf_counter()
    tables = tiered_tables_from_plan(plan, logical, cache.fused_config,
                                     init_fns=_host_inits(inits,
                                                          names_to_keys))
    marks["host_tier_init"] = time.perf_counter() - t_arm
    t_arm = time.perf_counter()
    offload, offload_counts = tiered_offload_arm(
        dev, full, full_state, cache, cstate, inits, dense0, names_to_keys,
        batches, logical_rows, cache_rows, card,
        {t: tbl.store.array[:, :DIM] for t, tbl in tables.items()})

    marks["offload"] = time.perf_counter() - t_arm
    t_arm = time.perf_counter()
    # the all-device oracle: the bucketed pipeline on B4/B6
    _reset_state(full, full_state, inits, dense0)
    opipe = BucketedTrainPipeline(full, full_state, _tiered_bucketing())
    oit = iter(batches[:n_batches])
    owarm, _ = _pipeline_steps(opipe, oit, 1)
    olosses, odt = _pipeline_steps(opipe, oit, TIERED_STEPS)
    oracle_losses = owarm + olosses
    full_state = opipe.state
    emit({"phase": "tiered_oracle", "card": card, "steps": n_batches,
          "ms_per_step": odt * 1e3 / TIERED_STEPS,
          "samples_per_s": TIERED_STEPS * DCN_BATCH / odt})

    marks["oracle"] = time.perf_counter() - t_arm
    runs = {}
    for prefetch in (True, False):
        t_arm = time.perf_counter()
        pipe, coll, meter, losses, dt, counts, init_s = _tiered_run(
            dev, cache, cstate, tables, names_to_keys, inits, dense0,
            batches, prefetch, card, refill=not prefetch)
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else None)
        m = pipe.scalar_metrics()
        t_check = time.perf_counter()
        bad = _logical_equal(coll, cache, pipe.state, full, full_state)
        check_s = time.perf_counter() - t_check
        st = coll.stats
        fetched = sum(a["fetch_rows"] for a in st.per_table.values())
        written = sum(a["writeback_rows"] for a in st.per_table.values())
        rec = {"phase": "tiered", "card": card, "prefetch": prefetch,
               "batch": DCN_BATCH, "steps": n_batches,
               "timed_steps": TIERED_STEPS,
               "host_refill_seconds": init_s, "check_seconds": check_s,
               "ms_per_step": dt * 1e3 / TIERED_STEPS,
               "samples_per_s": TIERED_STEPS * DCN_BATCH / dt,
               "losses": losses, "losses_equal_oracle":
                   losses == oracle_losses,
               "mismatched_tables": bad,
               "dense_equal_oracle": _dense_equal(pipe.state, full_state),
               "hit_rate": st.hit_rate(),
               "hit_rate_by_table": {t: m[f"tiered/{t}/hit_rate"]
                                     for t in names_to_keys},
               "prefetch_overlap_ratio": st.prefetch_overlap_ratio(),
               "fetched_rows_per_step": fetched / n_batches,
               "written_back_rows_per_step": written / n_batches,
               "fetched_bytes_per_step": fetched * row_width * 4 / n_batches,
               "written_back_bytes_per_step":
                   written * row_width * 4 / n_batches,
               "staged_rows": sum(a["staged_rows"]
                                  for a in st.per_table.values()),
               "sync_fetch_rows": sum(a["sync_fetch_rows"]
                                      for a in st.per_table.values()),
               "refetched_after_writeback": meter.refetched,
               "host_remap_s_per_step": meter.remap_s / n_batches,
               "host_io_s_per_step": meter.io_s / n_batches,
               "host_wait_s_per_step": st.wait_seconds / n_batches,
               "stage_s_per_step": st.stage_seconds / n_batches,
               "peak_memory_allocated": peak,
               "launches": {k: v for k, v in counts.items() if v}}
        if prefetch:
            # the profile after the check: a few steps more
            pipe.invalidate_prefetch()
            prof_it = iter(batches[n_batches:])
            prof = profile_calls({"phase": "tiered_profile", "card": card,
                                  "batch": DCN_BATCH},
                                 lambda: pipe.progress(prof_it),
                                 TIERED_PROFILED, "step")
            rec["device_idle_share"] = prof["device_idle_share"]
            main_counts = counts
        emit(rec)
        runs[prefetch] = rec
        want = {"dedup_pooled_lookup": n_batches,
                "dedup_fused_sparse_update": n_batches}
        if not (rec["losses_equal_oracle"] and not bad
                and rec["dense_equal_oracle"] and rec["launches"] == want
                and written > 0 and meter.refetched > 0):
            raise AssertionError(f"tiered run failed: {rec}")
        last = meter.last_kjts
        pipe.close()
        del pipe, coll, meter
        gc.collect()
        marks["prefetch" if prefetch else "no_prefetch"] = (
            time.perf_counter() - t_arm)
    if runs[True]["losses"] != runs[False]["losses"]:
        raise AssertionError("tiered prefetch on and off disagree")

    # B4 and B6 against their plain versions at the cache stack and the
    # last remapped batch
    t_arm = time.perf_counter()
    del opipe, full, full_state, tables
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rb = dataclasses.replace(batches[0], sparse_features=last[0])
    bb, clone, sig = bucketed_batch(cache, rb, dev)
    (name, lay), = clone.sharded_ebc.tw_layouts.items()
    stack = cstate["tables"][name]
    ids, w, segs, S, _ = tw_b1_inputs(lay, bb.sparse_features)
    valid = (segs < S) & (w != 0)
    common = {"rows": stack.shape[0], "D": DIM, "S": S, "V": ids.numel(),
              "valid": int(valid.sum()), "dtype": "float32",
              "ids": "tiered"}
    kernel_rows = [b4_row(flush, "tiered_kernel", stack, ids, segs, w, S,
                          common)]
    gen = torch.Generator(device=dev).manual_seed(19)
    grad = torch.randn((S, DIM), generator=gen, device=dev) * 1e-2
    kernel_rows.append(b6_row(flush, stack, "adagrad",
                              SparseSegGrad(ids, valid, segs, w, grad),
                              None, gen, common, phase="tiered_kernel",
                              lr=DCN_LR))
    del cache, cstate, stack, bb, clone, grad
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    marks["kernels"] = time.perf_counter() - t_arm
    tmp = tempfile.mkdtemp(prefix="tiered_")
    try:
        loop = tiered_loop_arm(dev, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "tiered_summary", "card": card, "seconds": seconds,
          "budget_s": TIERED_BUDGET_S, "arm_seconds": marks,
          "async_ms_per_step": runs[True]["ms_per_step"],
          "sync_off_ms_per_step": runs[False]["ms_per_step"],
          "host_offload_ms_per_step": offload["ms_per_step"],
          "oracle_equal": True, "loop": {k: loop[k] for k in (
              "skip_equals_uninterrupted", "resume_equals_uninterrupted")}})
    if seconds > TIERED_BUDGET_S:
        raise AssertionError(f"tiered took {seconds:.1f} s")
    counts = {k: main_counts.get(k, 0) + offload_counts.get(k, 0)
              for k in tbe.LAUNCHES}
    return counts, kernel_rows


# ---------------------------------------------------------------------------
# phase migrate: drift-triggered replan and live plan migration
# ---------------------------------------------------------------------------

MIGRATE_BUDGET_S = 90
MIGRATE_RANKS = 2  # gloo ranks sharing the card
MIGRATE_BATCH = 2048  # a rank: at 4096 the plan-time plan is DP already
MIGRATE_STEPS, MIGRATE_DRIFT, MIGRATE_CLEAN_STEPS = 15, 4, 6
MIGRATE_MIN_IMPROVEMENT = 0.1  # the PlanMigrator's default gate
MIGRATE_SEED = 11
MIGRATE_DEVICE = "cuda:0"  # the supervised drill's workers


def migrate_widths():
    """``migration_demo``'s recipe at ``bench.py main()``'s widths (D=128,
    its arches) with ``ELASTIC_ROWS`` rows in the big table."""
    from torchrec_tpu_torch.reliability.migration_demo import Widths

    return Widths(rows=(ELASTIC_ROWS, 128), dim=DIM, batch=MIGRATE_BATCH,
                  dense_in=NUM_DENSE, dense_arch=DENSE_ARCH,
                  over_arch=OVER_ARCH)


def migrate_rank(tmp, device_type="cuda"):
    """One gloo rank of the migration drill (``multiprocess.launch``):
    ``migration_demo.drill_arms`` on the card shared by every rank.
    Returns the arms' results."""
    from torchrec_tpu_torch.parallel import multiprocess as mp
    from torchrec_tpu_torch.parallel.comm import ShardingEnv
    from torchrec_tpu_torch.reliability.migration_demo import drill_arms

    mp.initialize("gloo")
    dev = _rank_device(device_type)
    env = ShardingEnv.from_process_group("gloo", device=dev)
    return drill_arms(env, tmp, MIGRATE_STEPS, MIGRATE_DRIFT,
                      clean_target=MIGRATE_CLEAN_STEPS, seed=MIGRATE_SEED,
                      widths=migrate_widths(),
                      min_improvement=MIGRATE_MIN_IMPROVEMENT)


def _migrate_kill_drill(tmp, device):
    """One ``ElasticSupervisor`` run of ``migration_demo.py`` over
    ``MIGRATE_RANKS`` gloo ranks on ``device`` with rank 1 SIGKILLed in
    the migration's reshard window (generation 0); returns (report, the
    final generation's result, the committed step the killed rank
    reported, seconds)."""
    import re

    from torchrec_tpu_torch.reliability import ElasticSupervisor
    from torchrec_tpu_torch.reliability import migration_demo
    from torchrec_tpu_torch.reliability.fault_injection import (
        ProcessFault,
        ProcessFaultPlan,
    )

    run_dir = os.path.join(tmp, "kill")
    ckpt = os.path.join(run_dir, "ckpt")
    out = os.path.join(run_dir, "result.json")
    sup = ElasticSupervisor(
        migration_demo.__file__, MIGRATE_RANKS,
        args=["--steps", str(MIGRATE_STEPS), "--ckpt", ckpt, "--out", out,
              "--seed", str(MIGRATE_SEED), "--device", device,
              "--drift-step", str(MIGRATE_DRIFT),
              "--min-improvement", str(MIGRATE_MIN_IMPROVEMENT),
              *migration_demo.widths_args(migrate_widths())],
        run_dir=run_dir, fault_plan=ProcessFaultPlan(
            [ProcessFault(rank=1, step=0, kind="kill_mid_reshard", gen=0)]),
        max_relaunches=2, hang_timeout_s=60.0, startup_grace_s=120.0,
        generation_timeout_s=240.0, env_extra={"PYTHONPATH": ROOT})
    t0 = time.perf_counter()
    report = sup.run()
    seconds = time.perf_counter() - t0
    for g in report.generations:
        for pid in g.pids:
            try:
                os.kill(pid, 0)
            except (ProcessLookupError, PermissionError):
                continue
            raise AssertionError(f"migrate drill: orphaned worker {pid}")
    with open(sup.log_path(0, 1)) as f:
        m = re.search(r"SIGKILL in migration reshard window .*committed "
                      r"step (\d+)", f.read())
    with open(out) as f:
        return report, json.load(f), (int(m.group(1)) if m else None), seconds


def migrate_phase(dev, device_type="cuda", kill_device=MIGRATE_DEVICE):
    """The drift-triggered plan migration (budget ``MIGRATE_BUDGET_S``):
    ``migration_demo``'s recipe at ``migrate_widths()`` on
    ``MIGRATE_RANKS`` gloo ranks sharing the card, a checkpoint every
    step.  One launch runs the drill's arms (``drill_arms``): at
    ``MIGRATE_DRIFT`` the big table's occupancy collapses, the monitor
    alarms, the trigger fires and the migrator flips ``t_f0`` RW -> DP
    with every step committed (zero committed-step loss); a clean restart
    from a copy of the migration's committed step under the new plan
    ends on the same checkpoint digest (the same bytes); a clean arm
    raises no alert and attempts no migration.  Then one supervised
    ``kill_mid_reshard`` drill: the relaunch resumes from the committed
    step the killed rank anchored on.  Returns the drift arm's launches,
    summed over its ranks."""
    from torchrec_tpu_torch.parallel.multiprocess import launch

    t0 = time.perf_counter()
    card = nvidia_smi_line()
    tmp = tempfile.mkdtemp(prefix="migrate_")
    try:
        results = launch(migrate_rank, MIGRATE_RANKS,
                         args=(tmp, device_type), timeout=MIGRATE_BUDGET_S * 3)
        arms_s = time.perf_counter() - t0
        report, killed, anchor, kill_s = _migrate_kill_drill(tmp,
                                                            kill_device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = results[0]
    drift, clean = r0["drift"], r0["clean"]
    restart = r0.get("restart")
    done = [r for r in drift["migration"]["reports"]
            if r["outcome"] == "completed"]
    rep = done[0] if done else {}
    launches: dict = {}
    for r in results:
        for k, v in r["drift"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    gens = report.generations
    rec = {"phase": "migrate", "card": card,
           "note": ONE_CARD.replace("4 ranks", f"{MIGRATE_RANKS} ranks"),
           "widths": dataclasses.asdict(migrate_widths()),
           "steps": MIGRATE_STEPS, "drift_step": MIGRATE_DRIFT,
           "alarms": drift["alarms"], "alerts": drift["alerts"],
           "attempts": [{k: r[k] for k in ("step", "outcome", "improvement",
                                           "committed_step")}
                        for r in drift["migration"]["reports"]],
           "initial_plan": drift["initial_plan"],
           "final_plan": drift["final_plan"],
           "final_step": drift["final_step"],
           "migrate_step": rep.get("step"),
           "committed_step": rep.get("committed_step"),
           "improvement": rep.get("improvement"),
           "phase_seconds": rep.get("phase_seconds"),
           "mttr_s": rep.get("duration_s"),
           "restart_resumed_from": restart and restart["resumed_from"],
           "digest_equal": bool(restart) and restart["digest"] is not None
           and restart["digest"] == drift["digest"],
           "clean_alarms": clean["alarms"],
           "clean_attempts": clean["migration"]["attempts"],
           "launches": launches,
           "arm_seconds": {k: r0[k] for k in r0 if k.endswith("_s")},
           "kill": {"generations": [{"world": g.world, "ok": g.ok,
                                     "failures": [dataclasses.asdict(f)
                                                  for f in g.failures]}
                                    for g in gens],
                    "anchor_step": anchor,
                    "resumed_from": killed["resumed_from"],
                    "final_step": killed["final_step"],
                    "mttr_s": report.mttr_s, "seconds": kill_s},
           "seconds": time.perf_counter() - t0,
           "budget_s": MIGRATE_BUDGET_S}
    emit(rec)
    ok = (drift["alarms"] >= 1 and len(done) == 1
          and drift["initial_plan"]["t_f0"] == "row_wise"
          and drift["final_plan"]["t_f0"] == "data_parallel"
          and drift["final_step"] == MIGRATE_STEPS
          and drift["migration"]["rolled_back"] == 0
          and rec["digest_equal"]
          and restart["resumed_from"] == rep["committed_step"]
          and clean["alarms"] == 0 and clean["migration"]["attempts"] == 0
          and clean["final_plan"] == clean["initial_plan"]
          and report.ok and report.restarts == 1
          and any(f.rank == 1 and f.cause == "crash"
                  for f in gens[0].failures)
          and anchor is not None and killed["resumed_from"] == anchor
          and killed["final_step"] == MIGRATE_STEPS)
    if not ok:
        raise AssertionError(f"migrate failed: {rec}")
    steps = MIGRATE_STEPS * MIGRATE_RANKS
    if device_type == "cuda" and not (
            launches.get("pooled_lookup", 0) >= steps
            and launches.get("fused_sparse_update", 0) >= steps):
        raise AssertionError(f"migrate: {steps} rank steps launched "
                             f"{launches}")
    if rec["seconds"] > MIGRATE_BUDGET_S:
        raise AssertionError(f"migrate took {rec['seconds']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# the dynamic side: the vocabulary, managed collision, the parameter server
# and the train -> publish -> serve freshness loop
# ---------------------------------------------------------------------------

DYNAMIC_BUDGET_S = 90
DYN_STEPS = 6  # the vocab arm's steps after one warm-up step
# dynamic_bench's stream (bench.py:2519-2553, its full configuration) at
# B = 4096 a feature: Zipf(1.1) over a hot set of 12,000 ids sliding 150 a
# step, rank -> id scatter, ids past any table's rows
DYN_HOT, DYN_DRIFT, DYN_ZIPF = 12_000, 150, 1.1
DYN_ID_BASE = 1 << 40
DYN_ADMIT, DYN_WINDOW = 2, 2  # admit_threshold, window_steps
DYN_SEED = 31
# the freshness loop: a checkpoint (and a delta generation) every
# FRESH_EVERY applied steps, FRESH_STEPS steps under the loop
FRESH_EVERY, FRESH_STEPS = 2, 4
FRESH_CACHE_ROWS = 16_384  # the replica's card cache, a table
FRESH_REQUESTS = 256  # after each adoption: one formed batch
# managed collision: every table a DistanceLFU ZCH module of the table's
# rows; raw ids uniform over 2^60, 1-2 a feature, a twentieth from a fixed
# hot set, so a table fills in 17 steps and evicts in the last two
ZCH_STEPS = 19
ZCH_HOT, ZCH_HOT_SHARE = 512, 0.05
ZCH_RETURNING = 64  # evicted ids that come back, a table
# the eviction arm: one vocabulary of EVICT_CAPACITY slots in front of one
# bench table (at the table's 100,000 rows nothing evicts within a phase);
# ids uniform over a window of EVICT_HOT sliding EVICT_DRIFT a step, more
# distinct ids a batch than slots (so admissions defer), TTL 1 step
EVICT_CAPACITY = 8_192
EVICT_STEPS, EVICT_IDS = 5, 4  # steps, ids an example
EVICT_HOT, EVICT_DRIFT, EVICT_TTL = 16_000, 2_000, 1
# the gate arm: the tiered loop arm's tables and batch
GATE_BATCHES, GATE_EVERY = 6, 2
ZCH_SYNCED_BUDGET_S = 20
ZCH_SYNCED_SIZE = 32_768  # fills in one step of 4 ranks, evicts in the next


def dyn_init_fn(dim, scale=1.0 / float(np.sqrt(TRAIN_ROWS)), seed=DYN_SEED):
    """The vocabularies' row init (``DynamicVocab(init_fn=)``): a pure
    function of the global id, vectorized on the host, each (id, column)
    hashed (splitmix64) to a uniform in ``[-scale, scale)``."""
    cols = np.arange(dim, dtype=np.uint64)

    def init(ids):
        with np.errstate(over="ignore"):
            z = (np.asarray(ids, np.int64).astype(np.uint64)[:, None]
                 * np.uint64(0x9E3779B97F4A7C15)
                 + cols[None, :] * np.uint64(0xBF58476D1CE4E5B9)
                 + np.uint64(seed))
            z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            z ^= z >> np.uint64(31)
        u = (z >> np.uint64(40)).astype(np.float64) / float(1 << 24)
        return ((2.0 * u - 1.0) * scale).astype(np.float32)

    return init


def dyn_stream(keys, batch, seed):
    """dynamic_bench's stream, one item a step: (raw ids by key ``[batch]``
    int64, lengths by key ``[batch]`` (one id each), dense ``[batch, 13]``
    f32, labels ``[batch]`` f32); key ``f``'s ids from its own disjoint
    range past ``DYN_ID_BASE``."""
    rng = np.random.RandomState(seed)
    perms = [rng.permutation(DYN_HOT) for _ in keys]
    s = 0
    while True:
        out = {}
        for f, k in enumerate(keys):
            r = (rng.zipf(DYN_ZIPF, size=batch) - 1) % DYN_HOT
            out[k] = (np.int64(DYN_ID_BASE) + np.int64(f) * np.int64(1 << 36)
                      + np.int64(s * DYN_DRIFT) + perms[f][r])
        yield (out, {k: np.ones((batch,), np.int32) for k in keys},
               rng.rand(batch, NUM_DENSE).astype(np.float32),
               rng.randint(0, 2, size=(batch,)).astype(np.float32))
        s += 1


def _time_vocab_parts(vocab, acc):
    """Accumulate the host seconds of a vocabulary's plan, commit, journal
    and row init into ``acc`` (by wrapping its methods)."""
    for name, part in (("_plan", "plan"), ("_commit", "commit"),
                       ("_append_records", "journal"),
                       ("_fetch_rows", "init")):
        fn = getattr(vocab, name)

        def timed(*a, fn=fn, part=part, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[part] = acc.get(part, 0.0) + time.perf_counter() - t0

        setattr(vocab, name, timed)


class VocabPipeline:
    """The trainer over raw ids through a ``DynamicVocabCollection``, one
    step a ``progress``: each table's lookup runs after the previous step
    was queued on the card, so the rows it reads for the evicted slots
    (``gather_row_state``, on the step's stream) are the trained ones; the
    evicted rows are reset and the admitted ones written (``io.
    fetch_rows``) before the step; the batch's weights are the admitted
    masks (a pre-admission id pools slot 0 with weight 0); every touched
    slot is credited to ``tracker`` when one is set.  ``progress(it)``
    takes the next :func:`dyn_stream` item.  ``lookup_s``: the host
    seconds of the lookups, ``last``: the last step's (batch, slots,
    admitted, VocabIO by table)."""

    def __init__(self, dmp, state, col, keys, dev):
        self.dmp, self.state, self.col = dmp, state, col
        self.keys, self.dev = keys, dev
        self.tracker = None
        self.lookup_s = []
        self.last = None

    def remap(self, item):
        import torch

        from torchrec_tpu_torch.datasets.utils import Batch
        from torchrec_tpu_torch.sparse import KeyedJaggedTensor

        ids, lengths, dense, labels = item
        dmp = self.dmp
        slots, adm, ios = {}, {}, {}
        t0 = time.perf_counter()
        for k in self.keys:
            t = f"t_{k}"
            sl, a, io = self.col.tables[t].lookup(
                ids[k], row_reader=lambda s, t=t: dmp.gather_row_state(
                    self.state, t, s))
            if io.evicted_slots.size:
                dmp.reset_table_rows(self.state, t, io.evicted_slots)
            if io.admitted_slots.size:
                dmp.set_table_rows(self.state, t, io.admitted_slots,
                                   io.fetch_rows)
            if self.tracker is not None:
                self.tracker.record(t, np.concatenate(
                    [sl, io.admitted_slots, io.evicted_slots]))
            slots[k], adm[k], ios[t] = sl, a, io
        self.lookup_s.append(time.perf_counter() - t0)
        kjt = KeyedJaggedTensor.from_lengths_packed(
            self.keys, np.concatenate([slots[k] for k in self.keys]),
            np.concatenate([lengths[k] for k in self.keys]),
            weights=np.concatenate([adm[k].astype(np.float32)
                                    for k in self.keys]),
            caps=[dmp.feature_caps[k] for k in self.keys])
        batch = Batch(torch.from_numpy(dense), kjt,
                      torch.from_numpy(labels)).to(self.dev)
        self.last = (batch, slots, adm, ios)
        return batch

    def progress(self, it):
        batch = self.remap(next(it))
        self.state, m = self.dmp.train_step(self.state, batch)
        return m


def _vocab_collection(tmp, name, keys, capacity, kv=True, **kw):
    """A ``DynamicVocabCollection`` of one vocabulary a key (``t_<key>``),
    its journals under ``tmp/name``, a ``file://`` KV each when ``kv``."""
    from torchrec_tpu_torch.dynamic import DynamicVocab, DynamicVocabCollection

    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    return DynamicVocabCollection({
        f"t_{k}": DynamicVocab(
            f"t_{k}", capacity=capacity, dim=DIM,
            journal_path=os.path.join(d, k),
            admit_threshold=DYN_ADMIT, window_steps=DYN_WINDOW,
            kv_url=(f"file://{d}/{k}.kv" if kv else None),
            init_fn=dyn_init_fn(DIM), **kw)
        for k in keys})


def _table_tensors(dmp, state):
    """Each table's weights as a view of its group stack on the card."""
    return dmp.sharded_ebc.tables_to_weights(state["tables"])


def dyn_vocab_arm(dev, tmp, card, stream):
    """The vocabulary at ``bench.py main()``'s width (module docstring,
    ``dynamic`` phase): 1 + ``DYN_STEPS`` steps of :class:`VocabPipeline`
    over :func:`dyn_stream`, then the oracle, the launch counts, the
    profile and the path check.  Returns (record, the trainer's pieces
    for the freshness arm)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    t0 = time.perf_counter()
    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    dmp, state, _ = build_trainer(dev, torch.float32)
    start = _clone_state(state)
    col = _vocab_collection(tmp, "vocab", keys, TRAIN_ROWS)
    marks = {"setup": time.perf_counter() - t0}
    parts: dict = {}
    for v in col.tables.values():
        _time_vocab_parts(v, parts)
    pipe = VocabPipeline(dmp, state, col, keys, dev)
    items = [next(stream) for _ in range(1 + DYN_STEPS)]
    admit_step = {f"t_{k}": {} for k in keys}
    admissions, losses = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tbe.reset_launch_counts()
    t_steps = time.perf_counter()
    for item in items:
        m = pipe.progress(iter([item]))
        losses.append(m["loss"])
        n = 0
        for t, v in col.tables.items():
            for rec in v.drain_events():
                if rec["op"] == "admit":
                    admit_step[t][rec["id"]] = rec["step"]
                    n += 1
        admissions.append(n)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    steps_s = time.perf_counter() - t_steps
    marks["steps"] = steps_s
    t_mark = time.perf_counter()
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    parts_main = dict(parts)
    col.verify_consistency()
    # the oracle: a fresh trainer holding the final id -> slot map from step
    # 0 (the survivors' init rows at their final slots), the occurrences
    # before an id's admission weighted 0
    odmp, ostate, _ = build_trainer(dev, torch.float32)
    final = {}
    for k in keys:
        t = f"t_{k}"
        ids, slots = col.tables[t].assigned_items()  # ascending ids
        at = np.asarray([admit_step[t][int(g)] for g in ids], np.int64)
        final[k] = (ids, slots, at)
        odmp.set_table_rows(ostate, t, slots, dyn_init_fn(DIM)(ids))
    olosses = []
    for s, (ids_by, lengths, dense, labels) in enumerate(items):
        o_slots, o_w = [], []
        for k in keys:
            fid, fsl, fat = final[k]
            raw = ids_by[k]
            if not len(fid):
                o_slots.append(np.zeros(len(raw), np.int64))
                o_w.append(np.zeros(len(raw), np.float32))
                continue
            pos = np.minimum(np.searchsorted(fid, raw), len(fid) - 1)
            hit = fid[pos] == raw
            o_slots.append(np.where(hit, fsl[pos], 0))
            o_w.append((hit & (fat[pos] <= s)).astype(np.float32))
        from torchrec_tpu_torch.datasets.utils import Batch
        from torchrec_tpu_torch.sparse import KeyedJaggedTensor

        kjt = KeyedJaggedTensor.from_lengths_packed(
            keys, np.concatenate(o_slots),
            np.concatenate([lengths[k] for k in keys]),
            weights=np.concatenate(o_w),
            caps=[odmp.feature_caps[k] for k in keys])
        ostate, om = odmp.train_step(ostate, Batch(
            torch.from_numpy(dense), kjt, torch.from_numpy(labels)).to(dev))
        olosses.append(om["loss"])
    losses_equal = all(bool(torch.equal(a, b))
                       for a, b in zip(losses, olosses))
    tables_equal = all(torch.equal(pipe.state["tables"][g], ostate["tables"][g])
                       for g in ostate["tables"])
    momentum_equal = all(
        torch.equal(pipe.state["fused"][g]["momentum"],
                    ostate["fused"][g]["momentum"]) for g in ostate["fused"])
    moved = sum(int((pipe.state["tables"][g] != start["tables"][g])
                    .any(dim=1).sum()) for g in start["tables"])
    del odmp, ostate, start
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    path = train_path_check(dmp, pipe.state, pipe.last[0], None,
                            phase="dynamic_vocab_path_check")
    marks["oracle_and_path_check"] = time.perf_counter() - t_mark
    t_mark = time.perf_counter()
    # the step's kernels by a profile, on the last batch (the remap is host
    # work: its wall is the step's, the card's share is the train step's)
    last = pipe.last[0]
    profiled = _profiled_kernels(lambda: dmp.train_step(pipe.state, last))
    prof = profile_calls({"phase": "dynamic_vocab_profile", "card": card,
                          "batch": TRAIN_BATCH},
                         lambda: dmp.train_step(pipe.state, last), 1, "step")
    busy = prof["device_busy_ms_per_step"]
    marks["profile"] = time.perf_counter() - t_mark
    metrics = col.scalar_metrics()
    occ = [metrics[f"vocab/t_{k}/occupancy"] for k in keys]
    looked = sum(metrics[f"vocab/t_{k}/lookup_count"] for k in keys)
    nulled = sum(metrics[f"vocab/t_{k}/null_routed_total"] for k in keys)
    n_steps = len(items)
    rec = {"phase": "dynamic_vocab", "card": card, "tables": len(keys),
           "rows": TRAIN_ROWS, "batch": TRAIN_BATCH,
           "capacity": TRAIN_ROWS, "admit_threshold": DYN_ADMIT,
           "window_steps": DYN_WINDOW, "hot": DYN_HOT, "drift": DYN_DRIFT,
           "steps": n_steps, "losses": [float(x) for x in losses],
           "oracle_losses_equal": losses_equal,
           "oracle_tables_equal": tables_equal,
           "oracle_momentum_equal": momentum_equal,
           "rows_moved": moved, "launches": counts,
           "profiled_launches_one_step": profiled,
           "admissions_per_step": admissions,
           "occupancy_min_max": [min(occ), max(occ)],
           "null_routed_share": nulled / max(1.0, looked),
           "vocab_host_ms_per_step": 1e3 * float(np.mean(
               pipe.lookup_s[:n_steps])),
           "vocab_host_ms_per_step_by_part": {
               p: 1e3 * s / n_steps for p, s in parts_main.items()},
           "step_wall_ms": 1e3 * steps_s / n_steps,
           "card_ms_per_step": busy,
           "device_idle_share": (None if busy is None else
                                 1.0 - busy / (1e3 * steps_s / n_steps)),
           "arm_seconds": marks, "seconds": time.perf_counter() - t0}
    emit(rec)
    if not (losses_equal and tables_equal and momentum_equal and moved):
        raise AssertionError(f"dynamic vocab != its oracle: {rec}")
    if counts != {"pooled_lookup": n_steps, "fused_sparse_update": n_steps} \
            or profiled != {"pooled_lookup": 1, "fused_sparse_update": 1}:
        raise AssertionError(f"dynamic vocab: {n_steps} steps launched "
                             f"{counts}, profiled {profiled}")
    if not sum(admissions) or max(occ) >= TRAIN_ROWS:
        raise AssertionError(f"dynamic vocab: admissions {admissions}, "
                             f"occupancy {occ}")
    return rec, path, (dmp, pipe, col, keys)


class _HotDlrm:
    """A replica's serving function over hot-row caches: each feature's
    lookup over its table's card cache (``pooled_embedding_lookup`` on
    ``kernel``, else the registry's: B4 in the server's dedup programs,
    which take the ``with_lookup_kernel`` view), then the trainer DLRM's
    dense side (``forward_from_embeddings``) with the replica's copy of
    the dense parameters, ``dense`` (a dict the views share).
    ``fn(dense, kjt, caches) -> logits [B]``."""

    def __init__(self, dmp, keys, dense, kernel=None):
        self.device = dmp.device
        self.dmp, self.keys = dmp, keys
        self.dense = dense
        self.kernel = kernel

    def with_lookup_kernel(self, kernel):
        """The same function and dense dict with its lookups on
        ``kernel``."""
        return _HotDlrm(self.dmp, self.keys, self.dense, kernel)

    def __call__(self, dense_features, kjt, caches):
        import torch

        from torchrec_tpu_torch.ops.embedding_ops import (
            pooled_embedding_lookup,
            resolve_lookup_kernel,
        )
        from torchrec_tpu_torch.sparse import KeyedTensor

        B = dense_features.shape[0]
        segs = kjt.segment_ids()
        co = kjt.cap_offsets()
        kernel = resolve_lookup_kernel(self.kernel)
        pooled = []
        for f, k in enumerate(self.keys):
            pooled.append(pooled_embedding_lookup(
                caches[f"t_{k}"], kjt.values()[co[f]:co[f + 1]],
                segs[co[f]:co[f + 1]] - f * B, B, kernel=kernel))
        kt = KeyedTensor(self.keys, [DIM] * len(self.keys),
                         torch.cat(pooled, dim=1))
        with torch.no_grad():
            logits = torch.func.functional_call(
                self.dmp._dense_forward,
                {f"model.{k}": v for k, v in self.dense.items()},
                (dense_features, kt))
        return logits.reshape(-1)


def _fresh_requests(rng, stream_item, views, keys, n):
    """``n`` single-example requests drawn from a stream item, each raw id
    mapped through the replica's ``VocabView`` (an id it does not hold is
    left out, as its weight would be 0): (dense [n, 13] f32, request-major
    flat slot ids, lengths [n, F] i32, the requests as ``predict`` takes
    them)."""
    ids_by, _, dense, _ = stream_item
    rows = rng.choice(len(dense), size=n, replace=False)
    lengths = np.zeros((n, len(keys)), np.int32)
    per_req = [[None] * len(keys) for _ in range(n)]
    for f, k in enumerate(keys):
        slots, adm = views[f"t_{k}"].lookup(ids_by[k][rows])
        for i in range(n):
            per_req[i][f] = slots[i:i + 1][adm[i:i + 1]]
            lengths[i, f] = int(adm[i])
    flat = np.concatenate([x for req in per_req for x in req]).astype(
        np.int64)
    d = dense[rows]
    return d, flat, lengths, [(d[i], per_req[i]) for i in range(n)]


def _fresh_check(srv, fn, dmp, state, hot, req, dev):
    """One formed batch of the requests through the server's batch path
    (``_run_batch``: the hot-row remap, the bucketed dedup program) and the
    same batch at the same shapes straight over the trainer's tables:
    (served scores, direct scores, max abs diff)."""
    from torchrec_tpu_torch.ops.embedding_ops import trace_kernels

    d, flat, lengths, _ = req
    n = len(d)
    served, _ = srv._run_batch(n, d, flat, lengths)
    sig = srv.cache.resolve(srv.cache.signature(n, lengths.sum(axis=0)))
    dense_t, kjt = srv._device_inputs(n, d, flat, lengths, sig[0],
                                      list(sig[1]))
    tables = _table_tensors(dmp, state)
    with trace_kernels(pooled="pallas_dedup"):
        direct = fn(dense_t, kjt, tables)[:n].float().cpu().numpy()
    return served, direct, float(np.abs(served - direct).max())


def _tier_equal(hot, dmp, state, dev):
    """(each table's host tier ``torch.equal`` to the trainer's rows, its
    resident card-cache rows ``torch.equal`` to the host tier's rows)."""
    import torch

    tw = _table_tensors(dmp, state)
    host_ok = cache_ok = True
    caches = hot.device_caches()
    for t, tbl in hot.tables.items():
        # a RAM tier's rows in place (no host copy), else a copy
        array = getattr(tbl.store, "array", None)
        rows = (array[:, :tbl.embedding_dim] if array is not None
                else tbl.host_weights_view())
        host = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
        host_ok &= bool(torch.equal(host, tw[t].float()))
        ids, slots = tbl.resident_items()
        if ids.size:
            i = torch.as_tensor(ids, device=dev)
            s = torch.as_tensor(slots, device=dev)
            cache_ok &= bool(torch.equal(caches[t][s], host[i]))
    return host_ok, cache_ok


def dyn_fresh_arm(dev, tmp, card, stream, trainer):
    """The freshness loop at full width, continuing the vocab arm's trainer
    (``trainer``: its DMP, pipeline, vocabularies and keys): a
    ``FaultTolerantTrainLoop`` over the pipeline checkpoints every
    ``FRESH_EVERY`` applied steps with ``Checkpointer(vocab=)`` and
    publishes each checkpoint's touched rows and vocabulary events
    (``attach_delta_publisher(DeltaPublisher, TouchedRowTracker, vocab)``)
    for ``FRESH_STEPS`` steps; one replica (``BucketedInferenceServer(
    hot_rows=HotRowServingCache.from_host_weights(the trainer's tables at
    the loop's start, FRESH_CACHE_ROWS), dedup="pallas_dedup")`` over the
    trainer's dense weights, its ``DeltaSubscriber`` with a ``VocabView``
    a table) adopts each generation.  Then one more step and the drills:
    a publisher killed before its manifest, a corrupt chunk, a clean
    republish.  Returns (record, the served steps' launches)."""
    import copy

    import torch

    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.dynamic import VocabView
    from torchrec_tpu_torch.inference.bucketed_serving import (
        BucketedInferenceServer,
        HotRowServingCache,
    )
    from torchrec_tpu_torch.inference.freshness import (
        DeltaPublisher,
        DeltaSubscriber,
    )
    from torchrec_tpu_torch.obs.registry import MetricsRegistry
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.production import TouchedRowTracker
    from torchrec_tpu_torch.reliability import FaultTolerantTrainLoop
    from torchrec_tpu_torch.reliability.fault_injection import (
        CrashMidPublishPublisher,
        SimulatedCrash,
    )

    t0 = time.perf_counter()
    fm = dict.fromkeys(("bootstrap", "loop_steps", "adopt_and_checks",
                        "profile_and_b4", "closed_loop", "drills"), 0.0)
    dmp, pipe, col, keys = trainer
    rng = np.random.RandomState(DYN_SEED + 1)
    ddir = os.path.join(tmp, "deltas")
    # the replica bootstraps from the trainer at the loop's start
    weights0 = dmp.table_weights(pipe.state)
    t_boot = time.perf_counter()
    hot = HotRowServingCache.from_host_weights(
        weights0, {t: FRESH_CACHE_ROWS for t in weights0},
        {k: f"t_{k}" for k in keys}, device=dev)
    del weights0
    boot_s = time.perf_counter() - t_boot
    views = {}
    for t, v in col.tables.items():
        ids, slots = v.assigned_items()
        views[t] = VocabView(v.capacity)
        views[t].apply_events([{"op": "admit", "id": int(g), "slot": int(s),
                                "step": 0} for g, s in zip(ids, slots)])
    registry = MetricsRegistry()
    sub = DeltaSubscriber(ddir, hot.tables, hot_rows=hot, metrics=registry,
                          vocabs=views)
    fn = _HotDlrm(dmp, keys, {k: v.clone()
                              for k, v in pipe.state["dense"].items()})
    srv = BucketedInferenceServer(
        fn, keys, [1] * len(keys), NUM_DENSE, max_batch_size=SERVING_BATCH,
        max_latency_us=2000, dedup="pallas_dedup", hot_rows=hot)
    # the copy-on-write fills: their ms a batch, and the remap's
    fills, remaps = [], []
    write = hot._write_slots
    process = hot.process

    def timed_write(*a, **k):
        t1 = time.perf_counter()
        write(*a, **k)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        fills.append(time.perf_counter() - t1)

    def timed_process(*a, **k):
        t1 = time.perf_counter()
        out = process(*a, **k)
        remaps.append(time.perf_counter() - t1)
        return out

    hot._write_slots, hot.process = timed_write, timed_process
    srv.warmup()
    srv.start(num_executors=1)
    fm["bootstrap"] = time.perf_counter() - t0
    tracker = TouchedRowTracker()
    pipe.tracker = tracker
    publisher = DeltaPublisher(ddir)
    pub_s, pub_rows = [], []
    inner_publish = publisher.publish

    def timed_publish(step, deltas, vocab_events=None):
        t1 = time.perf_counter()
        try:
            return inner_publish(step, deltas, vocab_events=vocab_events)
        finally:
            pub_s.append(time.perf_counter() - t1)
            pub_rows.append(sum(len(i) for i, _ in deltas.values()))

    publisher.publish = timed_publish
    ck = Checkpointer(os.path.join(tmp, "fresh_ckpt"), keep_last_n=1,
                      async_save=True, vocab=col)
    loop = FaultTolerantTrainLoop(pipe, ck, dmp,
                                  checkpoint_interval=FRESH_EVERY,
                                  resume=False, checkpoint_on_start=False)
    loop.attach_delta_publisher(publisher, tracker, col)
    gens, problems = [], []

    def serve(req):
        return srv._run_batch(len(req[0]), req[0], req[1], req[2])[0]

    def adopt_and_serve(label):
        """Poll; then the host tier and the caches against the trainer,
        and a formed batch against the direct one."""
        t_adopt = t1 = time.perf_counter()
        adopted = sub.poll()
        adopt_s = time.perf_counter() - t1
        fn.dense.update({k: v.clone()
                         for k, v in pipe.state["dense"].items()})
        host_ok, cache_ok = _tier_equal(hot, dmp, pipe.state, dev)
        req = _fresh_requests(rng, next(stream), views, keys,
                              FRESH_REQUESTS)
        served, direct, diff = _fresh_check(srv, fn, dmp, pipe.state, hot,
                                            req, dev)
        flat = registry.flat()
        g = {"label": label, "adopted": adopted, "adopt_seconds": adopt_s,
             "generation": sub.generation, "applied_step": sub.applied_step,
             "host_tier_equal_trainer": host_ok,
             "cache_rows_equal_host": cache_ok,
             "max_abs_diff_vs_direct": diff,
             "scores_within_tol": bool(np.allclose(served, direct,
                                                   **SCORE_TOL)),
             "all_finite": bool(np.isfinite(served).all()),
             "staleness_steps": flat.get(
                 f"freshness/t_{keys[0]}/staleness_steps")}
        gens.append(g)
        if not (adopted and host_ok and cache_ok and g["scores_within_tol"]
                and g["all_finite"]):
            problems.append(g)
        fm["adopt_and_checks"] += time.perf_counter() - t_adopt
        return req

    it = stream
    train_counts: dict = {}
    for target in range(FRESH_EVERY, FRESH_STEPS + 1, FRESH_EVERY):
        tbe.reset_launch_counts()
        t1 = time.perf_counter()
        while loop.applied_steps < target:
            loop.progress(it)
        for k, v in tbe.launch_counts().items():
            train_counts[k] = train_counts.get(k, 0) + v
        ck.wait()
        fm["loop_steps"] += time.perf_counter() - t1
        req = adopt_and_serve(f"step_{target}")
        if sub.applied_step != target:
            problems.append({"applied_step": sub.applied_step,
                             "target": target})
    # the profiled batch: 26 B4 over the caches and no other pooled kernel
    t1 = time.perf_counter()
    names = _device_kernel_names(lambda: serve(req))
    b4 = sum("dedup_pooled_kernel" in n for n in names)
    other_pooled = sum(("tbe_pooled_kernel" in n) or ("q8_pooled" in n)
                       or ("dedup_q_pool" in n) for n in names)
    batch_prof = profile_calls({"phase": "dynamic_fresh_profile",
                                "card": card, "batch": FRESH_REQUESTS},
                               lambda: serve(req), 3, "batch")
    # B4 against its plain version on one feature's cache at the formed
    # batch's shapes
    sig = srv.cache.resolve(srv.cache.signature(
        len(req[0]), req[2].sum(axis=0)))
    slot_ids = hot.remap(req[1], req[2], srv.features)
    _, kjt = srv._device_inputs(len(req[0]), req[0], slot_ids, req[2],
                                sig[0], list(sig[1]))
    cache0 = hot.device_caches()[f"t_{keys[0]}"]
    co = kjt.cap_offsets()
    ids0, segs0 = kjt.values()[co[0]:co[1]], kjt.segment_ids()[co[0]:co[1]]
    got = tbe.dedup_pooled_lookup(cache0, ids0, segs0, sig[0])
    ref = tbe.dedup_pooled_lookup_plain(cache0, ids0, segs0, sig[0])
    b4_equal = bool(torch.equal(got, ref))
    b4_err = float((got - ref).abs().max())
    # 8 closed-loop clients over the replica
    fm["profile_and_b4"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    clients = _fresh_requests(rng, next(stream), views, keys,
                              NUM_REQUESTS)[3]
    tbe.reset_launch_counts()
    scores, lat, wall = _serve(srv, clients)
    served_counts = {k: v for k, v in tbe.launch_counts().items() if v}
    errors = srv.metrics.flat().get("serving/executor_error_count", 0.0)
    # the drills, after one more trained step: the same formed batch served
    # before and after each failed publish
    fm["closed_loop"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    loop.progress(it)
    ck.wait()
    pub_step = loop.applied_steps
    deltas = copy.deepcopy(tracker).drain(dmp, pipe.state)
    events = col.drain_events()
    drill_req = _fresh_requests(rng, next(stream), views, keys,
                                FRESH_REQUESTS)
    before = serve(drill_req)
    torn = CrashMidPublishPublisher(DeltaPublisher(ddir), "before_manifest")
    crashed = False
    try:
        torn.publish(pub_step, deltas, events)
    except SimulatedCrash:
        crashed = True
    torn_adopted = sub.poll()
    after_torn = serve(drill_req)
    bad = CrashMidPublishPublisher(DeltaPublisher(ddir), "corrupt_chunk")
    bad.publish(pub_step, deltas, events)
    bad_adopted = sub.poll()
    after_bad = serve(drill_req)
    flat = registry.flat()
    rollbacks = flat.get("freshness/rollback_count", 0.0)
    stale_bad = flat.get(f"freshness/t_{keys[0]}/staleness_steps")
    # the clean republish: the real drain, the same events
    DeltaPublisher(ddir).publish(pub_step, tracker.drain(dmp, pipe.state),
                                 events)
    adopt_and_serve("clean_republish")
    g_clean = gens[-1]
    srv.stop()
    ck.wait()
    fm["drills"] = time.perf_counter() - t1
    rec = {"phase": "dynamic_fresh", "card": card, "tables": len(keys),
           "cache_rows": FRESH_CACHE_ROWS, "every": FRESH_EVERY,
           "loop_steps": FRESH_STEPS, "generations": gens,
           "bootstrap_seconds": boot_s, "publish_seconds": pub_s,
           "rows_per_generation": pub_rows,
           "profiled_b4_launches": b4, "profiled_other_pooled": other_pooled,
           "b4_equal_plain": b4_equal, "b4_max_abs_err": b4_err,
           "clients": NUM_CLIENTS, "requests": len(clients),
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "requests_per_s": len(clients) / wall,
           "closed_loop_all_finite": bool(np.isfinite(scores).all()),
           "executor_errors": errors, "closed_loop_launches": served_counts,
           "loop_launches": {k: v for k, v in train_counts.items() if v},
           "hot_row_remap_ms": 1e3 * float(np.median(remaps)),
           "cache_fill_ms": 1e3 * float(np.median(fills)) if fills else None,
           "cache_fills": len(fills),
           "serving_cache_hit_rate": hot.stats.hit_rate(),
           "batch_device_idle_share": batch_prof["device_idle_share"],
           "torn_publish_crashed": crashed, "torn_adopted": torn_adopted,
           "torn_scores_equal": bool(np.array_equal(after_torn, before)),
           "corrupt_adopted": bad_adopted,
           "corrupt_scores_equal": bool(np.array_equal(after_bad, before)),
           "rollback_count": rollbacks, "staleness_after_corrupt": stale_bad,
           "republish_adopted": g_clean["adopted"],
           "staleness_after_republish": g_clean["staleness_steps"],
           "arm_seconds": fm, "seconds": time.perf_counter() - t0}
    emit(rec)
    ok = (not problems and b4 == len(keys) and not other_pooled and b4_equal
          and rec["closed_loop_all_finite"] and not errors and crashed
          and not torn_adopted and rec["torn_scores_equal"]
          and not bad_adopted and rec["corrupt_scores_equal"]
          and rollbacks >= 1 and (stale_bad or 0) > 0
          and g_clean["staleness_steps"] == 0.0 and len(pub_rows) >= 2
          and rec["loop_launches"] == {"pooled_lookup": FRESH_STEPS,
                                       "fused_sparse_update": FRESH_STEPS}
          and set(served_counts) == {"dedup_pooled_lookup"})
    if not ok:
        raise AssertionError(f"dynamic fresh failed: {rec}; {problems}")
    launches = dict(served_counts)
    for k, v in train_counts.items():
        launches[k] = launches.get(k, 0) + v
    return rec, launches




def zch_stream(keys, batch, seed):
    """``examples/zch/main.py``'s raw ids, one item a step: (values
    key-major int64, lengths ``[F * batch]`` of 1 or 2, dense, labels);
    a ``ZCH_HOT_SHARE`` of the ids from a fixed hot set of ``ZCH_HOT`` a
    key, the rest uniform over ``[0, 2^60)``."""
    rng = np.random.RandomState(seed)
    hot = rng.randint(0, 1 << 60, size=(len(keys), ZCH_HOT)).astype(np.int64)
    while True:
        lengths = rng.randint(1, 3, size=(len(keys) * batch,)).astype(
            np.int32)
        per_key = lengths.reshape(len(keys), batch).sum(axis=1)
        vals = []
        for f, n in enumerate(per_key):
            fresh = rng.randint(0, 1 << 60, size=int(n)).astype(np.int64)
            pick = rng.rand(int(n)) < ZCH_HOT_SHARE
            vals.append(np.where(pick, hot[f, rng.randint(0, ZCH_HOT,
                                                          size=int(n))],
                                 fresh))
        yield (np.concatenate(vals), lengths,
               rng.rand(batch, NUM_DENSE).astype(np.float32),
               rng.randint(0, 2, size=(batch,)).astype(np.float32))


def dyn_zch_arm(dev, tmp, card):
    """Managed collision at full width: ``bench.py main()``'s trainer (caps
    2 x B a feature) behind a ``ManagedCollisionCollection`` of 26
    ``MCHManagedCollisionModule(TRAIN_ROWS, distance_lfu)`` and a
    ``ParameterServer`` on ``file://`` stores, ``ZCH_STEPS`` steps of
    :func:`zch_stream`.  Every eviction: its rows stored by
    ``flush_evictions`` ``torch.equal`` to the trained rows
    (``gather_row_state`` after the step's update), then reset to zero;
    then ``ZCH_RETURNING`` evicted ids a table come back and
    ``restore_assigned`` writes their stored rows; one B1 and one B2 a
    step.  Returns the record."""
    import torch

    from torchrec_tpu_torch.datasets.utils import Batch
    from torchrec_tpu_torch.dynamic import ParameterServer
    from torchrec_tpu_torch.modules.mc_modules import (
        ManagedCollisionCollection,
        MCHManagedCollisionModule,
    )
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    t0 = time.perf_counter()
    keys, tables = bench_tables()
    caps = {k: 2 * TRAIN_BATCH for k in keys}
    from torchrec_tpu_torch.models.dlrm import DLRM

    dmp = DistributedModelParallel(
        DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
             dense_dtype=torch.bfloat16), tables, table_wise_plan(tables),
        TRAIN_BATCH, caps, fused_config=FusedOptimConfig(
            learning_rate=TRAIN_LR), dense_optimizer=adagrad(TRAIN_LR),
        device=dev)
    state = dmp.init(torch.Generator(device=dev).manual_seed(0))
    mcc = ManagedCollisionCollection({
        k: MCHManagedCollisionModule(TRAIN_ROWS, f"t_{k}",
                                     eviction_policy="distance_lfu")
        for k in keys})
    ps = ParameterServer.from_urls(
        {f"t_{k}": f"file://{tmp}/zch_{k}.kv" for k in keys},
        {f"t_{k}": DIM for k in keys})
    stream = zch_stream(keys, TRAIN_BATCH, DYN_SEED + 2)
    evicted_by_step, remap_s, flush_s = [], [], []
    stored_ok = reset_ok = True
    last_evicted = {}  # table -> the ids the last remap evicted

    def remap(values, lengths):
        nonlocal state, stored_ok, reset_ok
        t1 = time.perf_counter()
        slots, evs = mcc.remap_packed(keys, values, lengths)
        remap_s.append(time.perf_counter() - t1)
        n = 0
        last_evicted.clear()
        for e in evs:
            t1 = time.perf_counter()
            ps.flush_evictions(dmp, state, e.table, e)
            flush_s.append(time.perf_counter() - t1)
            trained = dmp.gather_row_state(state, e.table, e.slots)
            rows, found = ps.stores[e.table].get(e.global_ids)
            stored_ok &= bool(found.all() and np.array_equal(rows, trained))
            state = dmp.reset_table_rows(state, e.table, e.slots)
            reset_ok &= not dmp.gather_row_state(state, e.table,
                                                 e.slots).any()
            last_evicted[e.table] = e.global_ids
            n += len(e.global_ids)
        return slots, n

    if dev.type == "cuda":
        torch.cuda.synchronize()
    tbe.reset_launch_counts()
    losses = []
    for _ in range(ZCH_STEPS):
        values, lengths, dense, labels = next(stream)
        slots, n = remap(values, lengths)
        evicted_by_step.append(n)
        kjt = KeyedJaggedTensor.from_lengths_packed(keys, slots, lengths,
                                                    caps=[caps[k]
                                                          for k in keys])
        state, m = dmp.train_step(state, Batch(
            torch.from_numpy(dense), kjt, torch.from_numpy(labels)).to(dev))
        losses.append(m["loss"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    # ids the last step evicted come back: fresh slots, their stored rows
    # restored
    restore_ok, restore_s, returned = True, [], 0
    gone = dict(last_evicted)
    for f, k in enumerate(keys):
        t = f"t_{k}"
        back = np.asarray(gone.get(t, [])[:ZCH_RETURNING], np.int64)
        if not back.size:
            restore_ok = False
            continue
        lengths = np.zeros((len(keys) * len(back),), np.int32)
        lengths[f * len(back):(f + 1) * len(back)] = 1
        slots, _ = remap(back, lengths)
        t1 = time.perf_counter()
        state = ps.restore_assigned(dmp, state, t, back, slots)
        got = dmp.gather_row_state(state, t, slots)
        restore_s.append(time.perf_counter() - t1)
        want, found = ps.stores[t].get(back)
        restore_ok &= bool(found.all() and np.array_equal(got, want))
        returned += len(back)
    tables_evicting = sum(
        mcc.modules[k].eviction_count > 0 for k in keys)
    rec = {"phase": "dynamic_zch", "card": card, "tables": len(keys),
           "zch_size": TRAIN_ROWS, "policy": "distance_lfu",
           "batch": TRAIN_BATCH, "steps": ZCH_STEPS,
           "hot_share": ZCH_HOT_SHARE, "evicted_per_step": evicted_by_step,
           "tables_evicting": tables_evicting,
           "stored_rows_equal_trained": stored_ok,
           "reset_rows_zero": reset_ok,
           "returning_ids": returned, "restored_rows_equal_stored": restore_ok,
           "launches": counts,
           "all_finite": bool(np.isfinite([float(x) for x in losses]).all()),
           "remap_ms_per_step": 1e3 * float(np.mean(remap_s[:ZCH_STEPS])),
           "flush_ms_per_eviction_batch": (1e3 * float(np.mean(flush_s))
                                           if flush_s else None),
           "restore_ms_per_table": 1e3 * float(np.mean(restore_s)),
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not (stored_ok and reset_ok and restore_ok and returned
            and tables_evicting == len(keys) and rec["all_finite"]):
        raise AssertionError(f"dynamic zch failed: {rec}")
    if counts != {"pooled_lookup": ZCH_STEPS,
                  "fused_sparse_update": ZCH_STEPS}:
        raise AssertionError(f"dynamic zch: {ZCH_STEPS} steps launched "
                             f"{counts}")
    return rec


def dyn_evict_arm(dev, tmp, card):
    """The vocabulary's eviction path: one ``DynamicVocab`` of
    ``EVICT_CAPACITY`` slots (TTL ``EVICT_TTL``) in front of one bench
    table of ``TRAIN_ROWS`` x 128 with a ``file://`` KV, ``EVICT_STEPS``
    steps of ``EVICT_IDS`` ids an example uniform over a window of
    ``EVICT_HOT`` ids sliding ``EVICT_DRIFT`` a step.  Checks: occupancy
    below the capacity at every step, admissions deferred and counted,
    LFU and TTL evictions, each evicted id's KV row ``torch.equal`` to its
    trained row (the table before the lookup), each readmitted id's row
    after the write ``torch.equal`` to the row it left with.  Returns the
    record."""
    import torch

    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    t0 = time.perf_counter()
    keys = ["cat_0"]
    tables = (EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                                 name="t_cat_0", feature_names=["cat_0"]),)
    dmp = DistributedModelParallel(
        DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
             dense_dtype=torch.bfloat16), tables, table_wise_plan(tables),
        TRAIN_BATCH, {"cat_0": EVICT_IDS * TRAIN_BATCH},
        fused_config=FusedOptimConfig(learning_rate=TRAIN_LR),
        dense_optimizer=adagrad(TRAIN_LR), device=dev)
    state = dmp.init(torch.Generator(device=dev).manual_seed(0))
    col = _vocab_collection(tmp, "evict", keys, EVICT_CAPACITY,
                            ttl_steps=EVICT_TTL)
    v = col.tables["t_cat_0"]
    pipe = VocabPipeline(dmp, state, col, keys, dev)
    rng = np.random.RandomState(DYN_SEED + 3)
    left = {}  # evicted id -> the row it left with (on the card)
    kv_ok = readmit_ok = True
    occ, readmitted = [], 0
    tbe.reset_launch_counts()
    for s in range(EVICT_STEPS):
        ids = (np.int64(DYN_ID_BASE) + np.int64(s * EVICT_DRIFT)
               + rng.randint(0, EVICT_HOT, size=EVICT_IDS * TRAIN_BATCH))
        item = ({"cat_0": ids},
                {"cat_0": np.full((TRAIN_BATCH,), EVICT_IDS, np.int32)},
                rng.rand(TRAIN_BATCH, NUM_DENSE).astype(np.float32),
                rng.randint(0, 2, size=(TRAIN_BATCH,)).astype(np.float32))
        before = _table_tensors(dmp, pipe.state)["t_cat_0"].clone()
        batch = pipe.remap(item)
        io = pipe.last[3]["t_cat_0"]
        if io.evicted_ids.size:
            rows, found = v.kv.get(io.evicted_ids)
            sl = torch.as_tensor(io.evicted_slots, device=dev)
            trained = before[sl]
            kv_ok &= bool(found.all()) and bool(torch.equal(
                torch.from_numpy(rows).to(dev), trained))
            for g, i in zip(io.evicted_ids.tolist(), range(len(sl))):
                left[g] = trained[i]
        back = [(g, s_) for g, s_ in zip(io.admitted_ids.tolist(),
                                         io.admitted_slots.tolist())
                if g in left]
        if back:
            got = torch.from_numpy(dmp.gather_row_state(
                pipe.state, "t_cat_0", [s_ for _, s_ in back])).to(dev)
            want = torch.stack([left.pop(g) for g, _ in back])
            readmit_ok &= bool(torch.equal(got, want))
            readmitted += len(back)
        del before
        pipe.state, _ = dmp.train_step(pipe.state, batch)
        occ.append(v.occupancy)
    counts = {k: v_ for k, v_ in tbe.launch_counts().items() if v_}
    v.verify_consistency()
    m = v.scalar_metrics("vocab")
    rec = {"phase": "dynamic_vocab_evict", "card": card,
           "capacity": EVICT_CAPACITY, "rows": TRAIN_ROWS,
           "batch": TRAIN_BATCH, "ids_per_example": EVICT_IDS,
           "window": EVICT_HOT, "drift": EVICT_DRIFT, "ttl_steps": EVICT_TTL,
           "steps": EVICT_STEPS, "occupancy": occ,
           "evicted_lfu": m["vocab/t_cat_0/evicted_lfu_total"],
           "evicted_ttl": m["vocab/t_cat_0/evicted_ttl_total"],
           "deferred": m["vocab/t_cat_0/admission_deferred_total"],
           "kv_rows_equal_trained": kv_ok, "readmitted": readmitted,
           "readmitted_rows_equal": readmit_ok, "launches": counts,
           "vocab_host_ms_per_step": 1e3 * float(np.mean(pipe.lookup_s)),
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not (kv_ok and readmit_ok and readmitted and rec["evicted_lfu"]
            and rec["evicted_ttl"] and rec["deferred"]
            and max(occ) < EVICT_CAPACITY
            and counts == {"pooled_lookup": EVICT_STEPS,
                           "fused_sparse_update": EVICT_STEPS}):
        raise AssertionError(f"dynamic vocab eviction failed: {rec}")
    col.close()
    return rec


def dyn_gate_arm(dev, tmp, card):
    """Gate mode at the tiered loop arm's size (``TIERED_LOOP_ROW_CAP``
    rows, ``TIERED_LOOP_BATCH`` a batch, the five host-cached MLPerf
    DLRM-v2 tables): ``TieredCollection(vocab=)`` with one gate-mode
    ``DynamicVocab`` a host-cached table, trained on B4/B6 through
    ``TieredTrainPipeline`` under a ``FaultTolerantTrainLoop`` with
    ``Checkpointer(tiered=, vocab=)`` every ``GATE_EVERY`` steps, over
    ``GATE_BATCHES`` batches.  Checks: each gated KJT's values and
    weights ``torch.equal`` to the ungated collection's on the same ids
    with the un-admitted ones made invalid; the gated run's losses,
    logical tables, slots and dense state ``torch.equal`` to the ungated
    run on that sanitized stream; a fresh world restored from the first
    checkpoint has each vocabulary at its pinned generation (the remap
    saved with it) and, resumed, ends ``torch.equal`` to the gated run,
    whose vocabularies restarted at each checkpoint (their advisory
    sightings, which no checkpoint holds, lost at the same step).
    Returns the record."""
    import dataclasses

    import torch

    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.types import table_wise_plan
    from torchrec_tpu_torch.reliability import FaultTolerantTrainLoop
    from torchrec_tpu_torch.tiered import (
        TieredCollection,
        TieredTrainPipeline,
        tiered_tables_from_plan,
    )

    t0 = time.perf_counter()
    keys, rows, caps, batches = tiered_batches(
        TIERED_LOOP_ROW_CAP, TIERED_LOOP_BATCH, GATE_BATCHES)
    _, _, _, cached = tiered_names()
    logical, names_to_keys, plan, _, cache_tables, inits = _tiered_tables(
        dev, keys, rows, cached, TIERED_LOOP_BATCH)
    caps_d = dict(zip(keys, caps))
    ref_dmp, ref_state = _dcn_dmp(dev, logical, table_wise_plan(logical),
                                  TIERED_LOOP_BATCH, caps_d)
    dense0 = {k: v.clone() for k, v in ref_state["dense"].items()}
    del ref_dmp, ref_state
    vdir = os.path.join(tmp, "gate_vocab")

    def vocabs():
        from torchrec_tpu_torch.dynamic import (
            DynamicVocab,
            DynamicVocabCollection,
        )

        return DynamicVocabCollection({
            t: DynamicVocab(t, capacity=TIERED_LOOP_ROW_CAP, dim=DIM,
                            journal_path=os.path.join(vdir, t),
                            admit_threshold=DYN_ADMIT,
                            window_steps=DYN_WINDOW, keep_generations=4)
            for t in names_to_keys})

    def world(col):
        dmp, st = _dcn_dmp(dev, cache_tables, plan, TIERED_LOOP_BATCH, caps_d)
        _reset_state(dmp, st, inits, dense0, skip=set(names_to_keys))
        host_inits = {t: (lambda s, e, f=inits[t]: f(s, e).cpu().numpy())
                      for t in names_to_keys}
        tabs = tiered_tables_from_plan(plan, logical, dmp.fused_config,
                                       init_fns=host_inits)
        coll = TieredCollection(tabs, {k: t for t, k in names_to_keys.items()},
                                vocab=col)
        pipe = TieredTrainPipeline(dmp, st, coll, _tiered_bucketing())
        outs, losses = [], []
        process = coll.process_group
        record = pipe._record_step

        def capture(kjts):
            out = process(kjts)
            outs.append([(k.values().clone(), k.weights_or_none().clone())
                         for k in out[0]])
            return out

        def record_step(batch, metrics):
            losses.append(metrics["loss"])
            return record(batch, metrics)

        coll.process_group, pipe._record_step = capture, record_step
        return dmp, coll, pipe, outs, losses

    def finish(step, it):
        while True:
            try:
                step(it)
            except StopIteration:
                break

    def snapshot(dmp, coll, pipe):
        st = pipe.state
        views = _table_views(dmp, st)
        return ({t: coll.logical_table_rows(dmp, st, t) for t in coll.tables},
                {t: (w.clone(), m.clone()) for t, (w, m) in views.items()
                 if t not in coll.tables},
                {k: v.clone() for k, v in st["dense"].items()})

    def same(a, b):
        return (all(np.array_equal(a[0][t], b[0][t]) for t in a[0])
                and all(torch.equal(a[1][t][0], b[1][t][0])
                        and torch.equal(a[1][t][1], b[1][t][1])
                        for t in a[1])
                and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))

    ckdir = os.path.join(tmp, "gate_ckpt")
    # (1) the gated run under the loop; the remaps the checkpoints pin.  At
    # each checkpoint the run's vocabularies restart (reopened from their
    # journals): the sketch and Bloom sightings are advisory and not
    # journaled, so a restore resumes from the pinned remap with none of
    # them, and the run it is held to has lost them at the same step
    col1 = vocabs()
    pinned = {}
    payload = col1.checkpoint_payload

    def pin():
        out = payload()
        pinned[len(pinned)] = {t: v.assigned_items()
                               for t, v in col1.tables.items()}
        col1.close()
        col1.tables.update(vocabs().tables)
        coll1.vocab.update(col1.tables)
        return out

    col1.checkpoint_payload = pin
    dmp1, coll1, pipe1, outs1, losses1 = world(col1)
    ck1 = Checkpointer(ckdir, keep_last_n=4, tiered=coll1, vocab=col1)
    tbe.reset_launch_counts()
    loop1 = FaultTolerantTrainLoop(pipe1, ck1, dmp1,
                                   checkpoint_interval=GATE_EVERY,
                                   checkpoint_on_start=False)
    finish(loop1.progress, iter(batches))
    pipe1.drain()
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    saved = ck1.steps()
    first = saved[0]
    s1 = snapshot(dmp1, coll1, pipe1)
    metrics = col1.scalar_metrics()
    nulled = sum(metrics[f"vocab/{t}/null_routed_total"] for t in col1.tables)
    looked = sum(metrics[f"vocab/{t}/lookup_count"] for t in col1.tables)
    pipe1.close()
    col1.close()
    del dmp1, coll1, pipe1, loop1
    # the sanitized stream: the gated run's un-admitted ids made invalid
    key_pos = {k: f for f, k in enumerate(keys)}
    sanitized = []
    for b, out in zip(batches, outs1):
        kjt = b.sparse_features
        values = kjt.values().numpy().copy()
        w = out[0][1].cpu().numpy()
        lens = kjt.lengths().numpy()
        lo, co = kjt._length_offsets(), kjt.cap_offsets()
        for k in names_to_keys.values():
            f = key_pos[k]
            m = int(lens[lo[f]:lo[f + 1]].sum())
            seg = values[co[f]:co[f] + m]
            seg[w[co[f]:co[f] + m] == 0.0] = -1
        sanitized.append(dataclasses.replace(b, sparse_features=kjt.with_values(
            torch.from_numpy(values).to(kjt.values().dtype))))
    # (2) the ungated run over the sanitized stream
    dmp2, coll2, pipe2, outs2, losses2 = world(None)
    finish(pipe2.progress, iter(sanitized))
    pipe2.drain()
    s2 = snapshot(dmp2, coll2, pipe2)
    pipe2.close()
    del dmp2, coll2, pipe2
    kjt_equal = len(outs1) == len(outs2) and all(
        torch.equal(a[0][0], b[0][0]) and torch.equal(a[0][1], b[0][1])
        for a, b in zip(outs1, outs2))
    losses_equal = len(losses1) == len(losses2) and all(
        bool(torch.equal(a, b)) for a, b in zip(losses1, losses2))
    # (3) a fresh world restored from the first checkpoint, resumed
    col3 = vocabs()
    dmp3, coll3, pipe3, _, _ = world(col3)
    ck3 = Checkpointer(ckdir, tiered=coll3, vocab=col3)
    pipe3.state = ck3.restore(dmp3, first)
    pipe3.invalidate_prefetch()
    pin_equal = all(
        np.array_equal(col3.tables[t].assigned_items()[0], ids)
        and np.array_equal(col3.tables[t].assigned_items()[1], slots)
        for t, (ids, slots) in pinned[0].items())
    finish(pipe3.progress, iter(batches[first:]))
    pipe3.drain()
    s3 = snapshot(dmp3, coll3, pipe3)
    pipe3.close()
    col3.close()
    del dmp3, coll3, pipe3
    rec = {"phase": "dynamic_gate", "card": card,
           "row_cap": TIERED_LOOP_ROW_CAP, "batch": TIERED_LOOP_BATCH,
           "batches": GATE_BATCHES, "gated_tables": sorted(names_to_keys),
           "checkpoints": saved, "resumed_from": first,
           "null_routed_share": nulled / max(1.0, looked),
           "gated_kjt_equal_sanitized": kjt_equal,
           "gated_losses_equal_sanitized": losses_equal,
           "gated_state_equal_sanitized": same(s1, s2),
           "restored_vocab_at_pinned_generation": pin_equal,
           "resume_equals_restart_at_checkpoint": same(s3, s1),
           "launches": counts,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not (kjt_equal and losses_equal and rec["gated_state_equal_sanitized"]
            and pin_equal and rec["resume_equals_restart_at_checkpoint"]
            and 0 < nulled < looked and first < GATE_BATCHES):
        raise AssertionError(f"dynamic gate failed: {rec}")
    steps = len(losses1)
    if counts != {"dedup_pooled_lookup": steps,
                  "dedup_fused_sparse_update": steps}:
        raise AssertionError(f"dynamic gate: {steps} steps launched "
                             f"{counts}")
    return rec


def dynamic_phase(dev):
    """The dynamic side at full width (budget ``DYNAMIC_BUDGET_S``, every
    check hard; module docstring): the ``vocab`` arm
    (:func:`dyn_vocab_arm`), the ``fresh`` arm continuing its trainer
    (:func:`dyn_fresh_arm`), then ``zch`` (:func:`dyn_zch_arm`),
    ``vocab_evict`` (:func:`dyn_evict_arm`) and ``gate``
    (:func:`dyn_gate_arm`), in a temporary directory the phase removes.
    Returns (the main paths' launches, the vocab arm's path check)."""
    import torch

    t0 = time.perf_counter()
    card = nvidia_smi_line()
    tmp = tempfile.mkdtemp(prefix="dynamic_")
    launches: dict = {}
    try:
        keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
        stream = dyn_stream(keys, TRAIN_BATCH, DYN_SEED)
        vocab, path, trainer = dyn_vocab_arm(dev, tmp, card, stream)
        fresh, served = dyn_fresh_arm(dev, tmp, card, stream, trainer)
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        zch = dyn_zch_arm(dev, tmp, card)
        evict = dyn_evict_arm(dev, tmp, card)
        gate = dyn_gate_arm(dev, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for counts in (vocab["launches"], zch["launches"], served,
                   evict["launches"], gate["launches"]):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    rec = {"phase": "dynamic_done", "card": card,
           "arm_seconds": {"vocab": vocab["seconds"],
                           "fresh": fresh["seconds"], "zch": zch["seconds"],
                           "vocab_evict": evict["seconds"],
                           "gate": gate["seconds"]},
           "launches": launches, "seconds": time.perf_counter() - t0,
           "budget_s": DYNAMIC_BUDGET_S}
    emit(rec)
    if rec["seconds"] > DYNAMIC_BUDGET_S:
        raise AssertionError(f"dynamic took {rec['seconds']:.1f} s")
    return launches, path


def registers_record():
    """The registers a thread of every B2 and B6 instantiation uses, by
    optimizer and table dtype, at D = 128 (the narrow layout, bounded to
    two 256-thread blocks an SM, so at most 128), D = 512 (wide) and
    D = 130 (scalar); fails if a narrow one takes more than 128.  And
    every B1 instantiation's registers and resident blocks, by table
    dtype, column path and index types."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward

    rec = {"phase": "registers", "pooled_lookup": {}}
    # (table, output) dtypes: each table into its own dtype, and the
    # 16-bit serving tables into float32
    pairs = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float16, torch.float16), (torch.bfloat16, torch.float32),
             (torch.float16, torch.float32))
    for (dtype, odt), runs, vec, ids, ends in itertools.product(
            pairs, (True, False), (True, False),
            (torch.int32, torch.int64), (torch.int32, torch.int64)):
        key = " ".join(str(t).replace("torch.", "") for t in (
            dtype, "runs" if runs else "segments",
            "4 columns" if vec else "1 column", ids, ends))
        if odt != dtype:
            key += " -> float32"
        rec["pooled_lookup"][key] = tbe.pooled_kernel_info(
            dtype, runs, vec, ids, ends, odt)
    for kernel in ("fused_sparse_update", "dedup_fused_sparse_update"):
        rec[kernel] = {}
        for dim in (128, 512, 130):
            for dtype in (torch.float32, torch.bfloat16):
                for optim in tbe_backward.OPTIMIZERS:
                    info = tbe_backward.update_launch(kernel, optim, dtype,
                                                      dim)
                    if info["layout"] != tbe_backward.column_layout(dim)[0]:
                        raise AssertionError(f"{kernel} D={dim}: layout "
                                             f"{info['layout']}")
                    if dim == 128 and info["registers"] > 128:
                        raise AssertionError(f"{kernel} {optim} {dtype}: "
                                             f"{info['registers']} registers")
                    key = f"D={dim} {str(dtype).replace('torch.', '')}"
                    rec[kernel].setdefault(key, {})[optim] = {
                        "registers": info["registers"],
                        "blocks_per_sm": info["blocks_per_sm"]}
    return rec


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    sys.path.insert(0, ROOT)
    from torchrec_tpu_torch.ops import _native, tbe

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _native.load_libraries()  # one nvcc per source, all started together
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "load_seconds": time.perf_counter() - t0,
          "build_seconds": {s: i["seconds"]
                            for s, i in _native.BUILD_INFO.items()},
          "ptxas": {s: [l.strip() for l in str(i["log"]).splitlines()
                        if "registers" in l or "spill" in l]
                    for s, i in _native.BUILD_INFO.items()}})
    def timed(fn, *args):
        # each phase's wall, and the run's so far, as it ends
        t = time.perf_counter()
        out = fn(*args)
        emit({"phase": "wall", "name": fn.__name__,
              "seconds": time.perf_counter() - t,
              "since_start": time.perf_counter() - t0})
        return out

    # the native serving arms' packages build beside the phases before it
    prebuild = start_native_prebuild()
    atexit.register(stop_native_prebuild, prebuild)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    emit(registers_record())
    kernel_rows = timed(kernel_phase, dev, flush)
    timed(planner_records)
    train_launches, train_rows, checks = timed(train_phase, dev, flush)
    ebc_launches, ebc_rows, _ = timed(ebc_phase, dev, flush)
    dedup_launches, dedup_rows, dedup_check = timed(train_dedup_phase, dev,
                                                    flush)
    guarded_launches, guarded_rows = timed(guarded_phase, dev, flush)
    dcn_launches, dcn_rows, dcn_check = timed(train_dcn_phase, dev, flush)
    lowp_launches, lowp_rows = timed(lowp_state_phase, dev, flush)
    seq_launches, seq_row = timed(seq_phase, dev, flush)
    models_launches, models_checks, fp_err = timed(models_phase, dev, flush)
    ft_launches, ft_check = timed(ft_loop_phase, dev, flush)
    del flush
    app_launches, app_check = timed(app_phase, dev)
    serve_launches, _, path_rows = timed(serving_phase, dev)
    timed(roundtrip_phase, dev)
    tier_launches, tier_rows, tier_tcp = timed(serving_tier_phase, dev)
    native_launches = timed(native_serving_phase, dev, tier_tcp, prebuild)
    stop_native_prebuild(prebuild)
    sharded_launches, sharded_checks = timed(sharded_phase)
    elastic_launches = timed(elastic_phase, dev)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    tiered_launches, tiered_rows = timed(tiered_phase, dev, flush)
    del flush
    migrate_launches = timed(migrate_phase, dev)
    dynamic_launches, dynamic_check = timed(dynamic_phase, dev)

    # each kernel's launches on its own main paths: B1/B2 the training
    # step (21 + 3 steps), the DCN step (21) and the application (40
    # steps; B1 also its 10 eval batches), B1 also the EBC's 21 steps (26
    # a step), B4/B6 the bucketed pipeline's 21 steps, B4 also the dedup
    # EBC's forward (26), B3/B5 serving; the serving tier B3/B5 behind
    # its front ends and B1/B4 over the BF16 tables (26 a batch)
    launches = {k: train_launches[k] + ebc_launches[k] + dedup_launches[k]
                + dcn_launches[k] + app_launches.get(k, 0)
                + serve_launches[k] + sharded_launches.get(k, 0)
                + seq_launches.get(k, 0) + models_launches.get(k, 0)
                + tier_launches.get(k, 0) + native_launches[k]
                + guarded_launches.get(k, 0) + lowp_launches.get(k, 0)
                + ft_launches.get(k, 0) + elastic_launches.get(k, 0)
                + tiered_launches.get(k, 0) + migrate_launches.get(k, 0)
                + dynamic_launches.get(k, 0)
                for k in tbe.LAUNCHES}
    errs = [(r["kernel"], r["max_abs_err"])
            for r in kernel_rows + train_rows + ebc_rows + dedup_rows
            + dcn_rows + path_rows + [seq_row] + lowp_rows[1:]]
    errs.append(("pooled_lookup", fp_err))
    errs += [(r["kernel"], r["max_abs_err"]) for r in tier_rows]
    errs += [(r["kernel"], r["max_abs_err"]) for r in tiered_rows]
    errs += [(k, c[f"{b}_max_abs_err"])
             for c in checks + [dcn_check, app_check, lowp_rows[0],
                                ft_check, dynamic_check]
             + models_checks
             for k, b in (("pooled_lookup", "b1"),
                          ("fused_sparse_update", "b2"))]
    errs += [("dedup_pooled_lookup", dedup_check["b4_max_abs_err"]),
             ("dedup_fused_sparse_update", dedup_check["b6_max_abs_err"])]
    errs += [(k, c[f"{b}_max_abs_err"]) for c in sharded_checks
             for k, b in (("pooled_lookup", "b1"),
                          ("fused_sparse_update", "b2"),
                          ("dedup_pooled_lookup", "b4"),
                          ("dedup_fused_sparse_update", "b6"))
             if f"{b}_max_abs_err" in c]
    errs += [(k, c[f"{b}_max_abs_err"]) for c in guarded_rows
             for k, b in (("pooled_lookup", "pooled_lookup"),
                          ("dedup_pooled_lookup", "dedup_pooled_lookup"),
                          ("dedup_fused_sparse_update", "b6"))
             if f"{b}_max_abs_err" in c]

    def representative(name):
        """The timed row of each kernel: float32 (int8 for B3/B5), rowwise
        Adagrad for B6; B1/B2 at the training batch's uniform ids, B3 at
        uniform and B5 at Zipf ids; B4/B6 at the bucketed batch."""
        want_ids = "zipf" if name == "dedup_quant_pooled_lookup" else "uniform"
        return next(
            r for r in kernel_rows + train_rows + dedup_rows
            if r["kernel"] == name and r.get("bits", 8) == 8
            and r.get("dtype", "float32") == "float32"
            and r.get("optim", "rowwise_adagrad") == "rowwise_adagrad"
            and r.get("ids", want_ids) == want_ids)

    summary = []
    for name in tbe.LAUNCHES:
        rep = representative(name)
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on its path")
        summary.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name], "paths": KERNEL_PATHS[name],
            "launches": launches[name],
            "max_abs_err": max(e for k, e in errs if k == name),
            "ms": rep["ms"], "kernel_ms": rep["kernel_ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            **{k: rep[k] for k in ("kernel_device_ms", "library_device_ms")
               if k in rep},
        })
    # B2 covers all eight optimizers: each one's float32 row of the DCN
    # phase (Adagrad at the path's uniform ids, the others at the
    # 1,000,000-row cap)
    b2 = next(k for k in summary if k["name"] == "fused_sparse_update")
    b2["optimizers"] = {
        r["optim"]: {k: r[k] for k in ("ms", "kernel_ms", "kernel_device_ms",
                                       "plain_ms", "bound_ms", "registers")}
        for r in dcn_rows
        if r["kernel"] == "fused_sparse_update" and r["dtype"] == "float32"
        and r["ids"] == "uniform"}
    # B3 and B5 as the collection launches them: one grouped launch for
    # the 26 features of a formed batch (B=256 served, B=4096 serving_fn)
    for k in summary:
        grouped = {f"B={r['batch']} {r['ids']} int{r['bits']}": {
            x: r[x] for x in ("ms", "kernel_ms", "kernel_device_ms",
                              "plain_ms", "bound_ms",
                              "peak_bytes_above_inputs")}
            for r in path_rows
            if r["phase"] == "grouped" and r["kernel"] == k["name"]}
        if grouped:
            k["grouped"] = grouped
    # B1 and B4 as the FP16/BF16 serving tables launch them: one launch a
    # feature of a served batch, 16-bit rows into float32
    for k in summary:
        rows = {f"{r['table_dtype']} -> float32, B={r['batch']}": {
            x: r[x] for x in ("ms", "kernel_device_ms", "card_ms_profiled",
                              "plain_ms", "float32_tables_ms", "bound_ms",
                              "bound_by", "library_ms", "library_device_ms",
                              "launches_per_call")}
            for r in tier_rows if r["kernel"] == k["name"]}
        if rows:
            k["serving_float"] = rows
    # B4 and B6 as the tiered path launches them: over the cache stack of
    # the host-cached MLPerf DLRM-v2 tables, per-element Adagrad
    for k in summary:
        rows = {x: r[x] for r in tiered_rows if r["kernel"] == k["name"]
                for x in ("ms", "kernel_ms", "kernel_device_ms", "plain_ms",
                          "bound_ms", "bound_by", "library_ms", "rows",
                          "V", "valid")}
        if rows:
            k["tiered"] = rows
    # B6 as the sequence path launches it: Adam over the BERT4Rec step's
    # per-id slots
    b6 = next(k for k in summary if k["name"] == "dedup_fused_sparse_update")
    b6["seq"] = {x: seq_row[x] for x in ("ms", "kernel_ms",
                                         "kernel_device_ms", "plain_ms",
                                         "bound_ms", "V", "valid")}
    # B2 and B6 over 16-bit optimizer states (lowp_state's 1M-row arms)
    for k in summary:
        rows = {f"{r['optim']} {r['state_dtype']} state"
                + (" sr off" if r.get("sr") else "")
                + (" at the DCN path" if r.get("ids") else ""):
                r["kernel_device_ms"]
                for r in lowp_rows[1:] if r["kernel"] == k["name"]}
        if rows:
            k["lowp_state_device_ms"] = rows
    # B1, B4 and B6 on the guarded path: the dedup'd group's
    # source pooling (B1), the table-wise group's lookup (B4), both
    # groups' updates (B6), card alone
    for k in summary:
        rows = {}
        for r in guarded_rows:
            if r["lookup"] == k["name"]:
                rows[r["group"]] = {
                    "device_ms": r[f"{k['name']}_device_ms"],
                    "bound_ms": r[f"{k['name']}_bound_ms"],
                    "slots": r["slots"], "segments": r["segments"]}
            if k["name"] == "dedup_fused_sparse_update":
                rows[r["group"]] = {"device_ms": r["b6_device_ms"],
                                    "bound_ms": r["b6_bound_ms"],
                                    "valid_slots": r["update_valid_slots"]}
        if rows:
            k["guarded"] = rows
    emit({"kernels": summary})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


DEV_PHASES = ("guarded", "lowp_state", "ft_loop", "native_serving",
              "elastic", "sharded", "tiered", "migrate",
              "dynamic") + GLOO_STAGES


BUILD_STUDY_ORDER = ("parts", "split_compile", "one_unit", "split_compile",
                     "parts")


def _sass_by_kernel(lib):
    """SHA-1 of each kernel's SASS in ``lib`` (``cuobjdump -sass``, the
    address comments dropped: the code, not where it sits)."""
    import hashlib
    import re

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name, body = {}, None, []
    for line in dump.splitlines() + ["Function : "]:
        m = re.search(r"Function : (\S*)", line)
        if m:
            if name:
                text = "\n".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", b)
                                 for b in body)
                out[name] = hashlib.sha1(text.encode()).hexdigest()
            name, body = m.group(1), []
        elif name:
            body.append(line)
    return out


def build_study() -> None:
    """``python3 chip_smoke.py --build-study``: the two backward sources
    built from nothing three ways, in the order ``BUILD_STUDY_ORDER``,
    each build's compiles all started together: in parts, as
    ``ops/_native.py`` builds them; as one translation unit (the source
    and an explicit instantiation of every type pair of
    ``backward_common.cuh``); and as one unit with ``nvcc
    --split-compile=0`` (the device compile in parallel on every core).
    Prints each build's seconds, and how many kernels' SASS and registers
    equal the one-unit build's."""
    import re

    from torchrec_tpu_torch.ops import _native

    card = nvidia_smi_line()
    sources = {"tbe_backward.cu": "true", "tbe_dedup_backward.cu": "false"}
    tmp = tempfile.mkdtemp(prefix="build_study_")
    runs, kernels = [], {}
    try:
        for n, variant in enumerate(BUILD_STUDY_ORDER):
            compiles, links, libs = [], [], []
            for src, per_id in sources.items():
                out = os.path.join(tmp, f"{n}_{variant}_{src}.so")
                libs.append(out)
                if variant == "parts":
                    c, link = _native._build_commands(src, out)
                    compiles += c
                    links.append(link)
                    continue
                one = os.path.join(tmp, f"{n}_one_{src}")
                with open(one, "w") as f:
                    f.write(f'#include "{os.path.join(_native.CSRC_DIR, src)}"'
                            "\nnamespace bwd {\n")
                    for k in range(_native.type_pairs()):
                        f.write("template const void* kernel_for<TypePair<"
                                f"{k}>::Table, TypePair<{k}>::State, "
                                f"{per_id}>(int, int);\n")
                    f.write("}\n")
                flag = (["--split-compile=0"] if variant == "split_compile"
                        else [])
                compiles.append([_native._nvcc(), *_native.NVCC_FLAGS, *flag,
                                 "-o", out, one])
            t0 = time.perf_counter()
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in compiles]
            logs = [p.communicate()[0] for p in procs]
            if any(p.returncode for p in procs):
                raise RuntimeError("\n".join(logs))
            for link in links:
                subprocess.run(link, check=True, capture_output=True)
            seconds = time.perf_counter() - t0
            regs, fn = {}, None
            for line in "".join(logs).splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                fn = m.group(1) if m else fn
                m = re.search(r"Used (\d+) registers", line)
                if m and fn:
                    regs[fn] = int(m.group(1))
            sass = {}
            for lib in libs:
                sass.update(_sass_by_kernel(lib))
            kernels.setdefault(variant, (sass, regs))
            runs.append({"variant": variant, "seconds": seconds,
                         "kernels": len(sass)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref_sass, ref_regs = kernels["one_unit"]
    rec = {"phase": "build_study", "card": card, "runs": runs}
    for variant, (sass, regs) in kernels.items():
        if variant == "one_unit":
            continue
        rec[f"{variant}_sass_equal_one_unit"] = sum(
            sass.get(k) == v for k, v in ref_sass.items())
        rec[f"{variant}_registers_equal_one_unit"] = sum(
            regs.get(k) == v for k, v in ref_regs.items())
    rec["kernels"] = len(ref_sass)
    emit(rec)


def dev_run(phases) -> None:
    """A development run of some phases (``--phases lowp_state,hier``):
    the kernels built, then the named phases' records and the usual last
    line; no ``kernels`` line and not the acceptance run, which is the
    script with no arguments.  ``dedup_rw``, ``vbe`` and ``hier`` run the
    sharded phase's gloo arm with those stages alone; ``sharded`` runs
    the whole phase.  ``lowp_state`` runs without ``train_dcn`` before
    it, so its record has no float32-state reference."""
    import torch

    unknown = set(phases) - set(DEV_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; choose from "
                         f"{', '.join(DEV_PHASES)}")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    sys.path.insert(0, ROOT)
    from torchrec_tpu_torch.ops import _native

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    _native.load_libraries()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "development_run": list(phases)})
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    if "guarded" in phases:
        guarded_phase(dev, flush)
    if "lowp_state" in phases:
        lowp_state_phase(dev, flush)
    if "ft_loop" in phases:
        ft_loop_phase(dev, flush)
    if "tiered" in phases:
        tiered_phase(dev, flush)
    del flush
    if "native_serving" in phases:
        # no serving tier before it: its TCP figures are absent
        prebuild = start_native_prebuild()
        try:
            native_serving_phase(dev, dict.fromkeys(
                ("p50_ms", "p99_ms", "requests_per_s",
                 "idle_share_of_one_batch")), prebuild)
        finally:
            stop_native_prebuild(prebuild)
    if "sharded" in phases:
        sharded_phase()
    elif set(phases) & set(GLOO_STAGES):
        sharded_phase(only=tuple(p for p in GLOO_STAGES if p in phases))
    if "elastic" in phases:
        elastic_phase(dev)
    if "migrate" in phases:
        migrate_phase(dev)
    if "dynamic" in phases:
        dynamic_phase(dev)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--one-device-gap"]:
        one_device_gap()
    elif sys.argv[1:] == ["--build-study"]:
        build_study()
    elif len(sys.argv) == 3 and sys.argv[1] == "--native-prebuild":
        native_prebuild(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--phases":
        dev_run(tuple(p for p in sys.argv[2].split(",") if p))
    else:
        main()
