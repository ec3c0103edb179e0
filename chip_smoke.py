#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--n N] [--shards P] [--queries Q] [--batch B]
                          [--seed S]

Phases, each printing one JSON object per line; any failure exits
non-zero:

  1. device   — ``nvidia-smi`` name and power limit, torch's device name;
  2. build    — ``nvcc`` builds the eleven kernel sources from
                ``kernels/csrc`` (the ten of the port's kernels and an
                empty kernel; one process per source, started together);
  3. kernels  — each kernel at the main path's shapes (B=1024 for search,
                2048 for the build probe) plus edge rows, held against its
                plain PyTorch version on the card (indices and distances
                exact on integer-valued inputs, distances to rtol 1e-5 /
                atol 1e-3 on float inputs: the f32 summation order
                differs; ``ksort_l`` exact on every input, values to
                their sign bits, it does no arithmetic, also at its warp
                tier's edges M = 256, 257, 512, 513 with k = 1 and k =
                M); kernel, plain and library times from CUDA-graph
                replays timed with CUDA events; each timed ``ksort_l``
                row with its plan (tier, rows a block); dist_l, ksort_l
                and dist_h also at the footprint bench's shapes. dist_l
                at each of its shapes on f32 and on bf16 rows (keys
                ending "bf16"), each with its launch plan and one device
                kernel a call (the nodes of a CUDA graph of one call).
                ``trip_fold`` (a trip's pop, accept test and three
                merges in one launch) at the main path's fold shapes
                (pca layers 0 / 1 / 2+, the deferred arms' layer 0, the
                probe's layers, with tombstones, and the mutable index's
                insert probe, B=128 at ef 100 with tombstones; its
                ``fused_expand_rows`` and ``dist_h`` rows at B=128 too)
                and at W = 4, 8 and a
                frontier past shared memory, then gated per row (row
                ``trip_fold_gated``: random ``ef_eff`` and ``pop``, the
                scheduler's bank of 64 slots at ef 10 and 30, the block
                and the global tier; every row popped at the compiled
                bound equal to the ungated kernel), and ``pq_expand_rows`` (the
                PQ expand with its row gathers) at the pq and
                cascade arms' layer 0 and W = 4, 8: each bit for bit
                against its plain version (raw f32 bits) on integer and
                float data, the expand also against the unfused path it
                replaces; the library yardsticks are the stable
                ``torch.sort`` route of the search body before the fold
                and index_select + gather-sum + stable sort. Then
                ``fused_expand_rows`` (the pca expand with its row
                gathers) at the pca arms' layer 0 shape for W = 1, 2, 4
                (timed) and 8, W = 1 (timed) and 8 also on the layer's
                rows in bf16, on a 50,000-node layer: bit for bit
                against its plain version, the unfused path (index_select,
                ``fused_expand``, id gather) and the library route
                (index_select, distances, stable sort, id gather) on
                integer rows, against the unfused path on float rows;
                its bound counts the payload rows its gates and
                neighbours need. Then the stacked kernels of the
                sharded slotted pass (``check_stacked``: keys starting
                "stacked"): ``fused_expand_rows`` (f32 and bf16 rows),
                ``pq_expand_rows`` and the gated ``trip_fold`` on P = 4
                shards' stacked leaves at the stream phase's sharded
                bank (4 x 64 shard-major rows): bit for bit against
                their plain versions, the P per-shard launches and the
                library route, one device kernel a call, timed beside
                them (``per_shard_ms``: the P launches the host loop
                made before). Then the wide
                tiers (phase ``wide_tiers``): the expands at M = 160 and
                256, fused_filter at 60,000, merge_sorted at 12,816 and
                60,100 elements, ksort_l at 13,000 and 60,000, exact
                against their plain versions.
                Then ``fused_filter`` at the footprint bench's [64, 32, 15]
                (f32 and bf16 rows, one device kernel a call) and the
                search's [1024, 32, 15] k=16 plus edge rows (k = M, k =
                1, M = 100, B = 1, bf16 at dl = 16; exact on integer
                inputs),
                ``flash_attention`` at the bench's shape (B=1 H=4
                S=T=512 d=64 bf16 causal), at starcoder2-3b widths (24
                heads, d=128, causal: S=T=4096 and a chunked prefill
                S=512 T=4096, q aligned to the end), mixtral-8x7b
                widths (32 heads, d=128, S=T=8192, window 4096) and
                recurrentgemma-9b's local attention (16 heads, d=256,
                S=T=8192, window 2048; both with the plain version head
                by head), the lm_families phase's shapes
                (recurrentgemma's local MQA at 2,049 tokens, whisper's
                encoder at 1,500 frames and its cross-attention, qwen3's
                64 heads over 4), with TFLOP/s, the ratio to the library
                and, where the bf16 kernel splits the kv range, the
                unsplit launch checked and timed beside it;
                ``decode_attention`` at the bench's shape (B=1 H=4
                T=4096 d=64 bf16), the lm_families phase's
                (recurrentgemma's full ring, whisper's cross cache,
                qwen3's last step) and starcoder2-3b widths (B=8 H=24
                T=16384 d=128 bf16, lengths 0 to T+7; each with its
                plan: chunk, blocks per (b, h), tile, stages, copy
                mode, shared memory, and
                the device operations of one call, which must be one
                kernel),
                plus edge rows (f32, S=1, S>T, ragged S and T, window >=
                T, non-causal, d = 30/40/96/256, a window starting
                mid-tile, a split ragged chunk), each within 2e-3 (f32) or
                0.05 (bf16) of its plain version and, tighter at model
                widths where the outputs are ~0.01-0.04, within
                ``kernel_footprint.attention_excess`` (per element one
                bf16 ulp plus 1/32 of the row's RMS; 1e-4 of each in
                f32), and exactly 0 on rows that see no key; the
                library yardstick for attention is
                ``scaled_dot_product_attention`` with an explicit mask;
                last, an empty kernel's replay (``launch_floor``: the
                floor under every small kernel's time);
  3b. footprint — ``python -m repro_torch.bench.kernel_footprint``'s six
                rows (dist_l, ksort_l, dist_h, fused_filter,
                flash_attention, decode_attention at the reference
                bench's shapes and seed) and their JSON, each row's op
                first held against its plain version on the tensors the
                bench times; each of the six
                kernels must launch;
  3c. lm      — LM serving (``run_lm``): ``GenerationEngine`` over
                starcoder2-3b at full width (30 layers, d_model 3072, 24
                heads over 2 kv heads, bf16, seeded random weights drawn
                on the card): (a) ``launch.serve.serve_lm`` at the
                launcher's defaults (batch 4, prompt 32, 16 new): tokens
                in the vocabulary, finite logits, ``flash_attention``
                exactly 30 launches (one a layer at prefill) and
                ``decode_attention`` exactly 30 x 16, nothing else; (b)
                a timed generate, B=8, prompt 1,024, 32 greedy tokens
                (prefill seconds, decode tokens/s, peak memory); (c) a
                prefill of S tokens against a prefill of S-1 and one
                decode step, last logits within ``LM_BF16_TOL`` of their
                RMS; (d) a 2-layer cut at full width in f32, on the card
                with the kernels and on this machine's CPU with the
                plain versions: equal greedy tokens, logits within
                ``LM_F32_TOL``, and (c) there at that tolerance; (e)
                retrieval decode at the cut with full coverage against
                dense decode (``LM_F32_TOL``), then timed at full width
                with the long-context settings (d_low 16, topk 2048,
                block 128, 16 partitions; B=1, prompt 8,192, 16 new)
                beside dense decode at the same prompt;
  3d. lm_families — the moe, encdec, hybrid and ssm families
                (``run_lm_families``), seeded bf16 weights drawn on the
                card at full width, each model freed before the next:
                mixtral-8x7b (8 of 32 layers) and qwen3-moe-235b-a22b (4
                of 94; ``reduced`` lines: their bf16 weights pass the
                card's 80 GB), whisper-medium, recurrentgemma-9b and
                rwkv6-1.6b whole; (a) a timed greedy generate with its
                own launch counts, exactly B8 once an attention layer at
                prefill and B9 once an attention layer a step (rwkv6
                neither), and a profiled decode step; (b) decode against
                prefill in bf16 for whisper, rwkv6 and recurrentgemma
                (2,048 -> 2,049 tokens: B8's window mask and the ring's
                wrap) within ``LM_BF16_TOL`` of the logits' RMS; (c) a
                full-width cut in f32 on the card and on this machine's
                CPU: equal greedy tokens, logits within ``LM_F32_TOL``;
  3e. train   — LM training (``run_train``; no kernel: the port trains
                through ``blocked_attention``, as the reference through
                its jnp attention): (a) starcoder2-3b at full width and
                depth, bf16, ``remat="full"``, seeded weights, sequence
                4,096, global batch 8 (a ``reduced`` line: train_4k's is
                256) in 4 microbatches, one warm-up and 2 timed steps
                (s a step, tokens/s, FLOPs, peak memory, finite loss and
                gradient norm, 0 attention-kernel launches); (b) one
                loss and backward in f32 on the card and on this
                machine's CPU: a 2-layer cut at full width and the smoke
                configs of mixtral-8x7b, internvl2-76b, whisper-medium,
                recurrentgemma-9b and rwkv6-1.6b, the loss to rtol 1e-5
                and each gradient leaf within 1e-4 of its largest
                magnitude; (c) ``TrainLoop`` on the card, 4 straight
                steps against 2 + resume from a checkpoint + 2: losses
                and parameters bit for bit;
  3f. mesh_lm — the LM side on a mesh of the card repeated
                (``run_mesh_lm``, through ``launch.steps``): (a)
                starcoder2-3b at full width, 4 layers, bf16, seq 4,096,
                global batch 8 on a (2, 2) mesh: every stored block laid
                out by ``param_specs``, one copy of the parameters, m
                and v, timed steps, no attention kernel; a full-width
                f32 cut card against CPU under "tp" and "fsdp" (every
                gradient leaf of the step before its update, and every
                parameter after it, within 1e-4 of its leaf's largest
                + 1e-7; the loss and the gradient norm to rtol 1e-5);
                (b) the cut's state
                saved and restored onto a (1, 4) mesh, ``remesh``, and
                ``TrainLoop`` resuming on the (2, 2) mesh, bit for bit;
                (c) mixtral-8x7b, 2 layers, serving on a (2, 4) mesh,
                B=8, prompt 1,024, 16 new: the expert-parallel dispatch
                in every prefill MoE layer (a data row each), a decode's
                local over the whole batch (one computing unit, as the
                reference's serve step), B8 exactly layers x prefill
                units and B9 layers x decode units x new, the cache
                laid out by
                ``cache_shardings``; a 1-layer f32 cut card against CPU
                (tokens equal, logits within 2e-3, dropped fractions
                equal); (d) ``build_pipeline_forward`` on a (1, 4) mesh
                against the sequential forward (1e-5);
  3g. dryrun  — the dry-run tools (``run_dryrun``): (a) each cell of
                ``mesh_lm`` (starcoder2-3b training on (2, 2), mixtral-8x7b
                prefill and decode on (2, 4), the card repeated) lowered on
                "meta" by ``launch.steps.lower_step``: its FLOPs summed
                over positions equal a ``FlopCounterMode`` count around the
                same real step on the card (B8 and B9 counted by their
                formulas) and its argument bytes, once per (block,
                device), the bytes the real state stores, both exactly;
                the temp estimate beside the card's peak, no gate; B8 and
                B9 exactly layers x units; (b) starcoder2-3b x
                ``train_4k`` x ``pod16x16`` at full width and depth
                (``launch.dryrun.run_cell``, no card involved): ok, the
                per-chip FLOPs, argument bytes, collective bytes by
                category, ``lower_s`` / ``trace_s`` and the roofline row
                (``launch.roofline``, the H100's peaks), the useful FLOPs
                over the positions' sum <= 1, inside 90 s; (c) the host
                time of a B8 / B9 call through the public op, its
                ctypes wrapper and the dispatcher's operator;
  4. build    — the wave builder at the paper's SIFT1M configuration:
                ``--shards`` graphs over ``shard_bounds(--n, P)``, shard s
                with seed ``seed + s``; ``graph_invariants`` must hold for
                each;
  5. pq_train — the PQ codebook (16 x 256, density-aware from the shard
                graphs' levels in shard order, 4 Lloyd iterations on a 20k
                subsample) and the codes of all ``--n`` points, host
                numpy, timed as their own stage; the PCA is fitted on all
                points;
  6. search   — single-shard: shard 0's graph in layout (3) on the card,
                ``--queries`` queries in batches of ``--batch``, six
                arms: pca (per-step, the first arm), pca-deferred, pq,
                cascade-deferred, and pca-bf16 and pca-deferred-bf16
                (layout (3) stored in bfloat16). Per arm: QPS, recall@10
                against shard 0's points (>= 0.80; >= 0.60 for pq),
                ``steps_mean``, ``dist_h_mean``, bytes, launches per
                kernel (each kernel of the arm's path must launch) and one
                profiled batch (with its copy kernels); each bf16 arm
                within 0.02 recall of its f32 arm, its ``bytes_layout3``
                below 0.75 of the f32 arm's, the same wrappers launched
                (each as often, up to the trips the two loops ran), and
                no more copy kernels (no cast);
  7. sharded  — all ``--n`` points over the P shards (``build_sharded``
                reusing the graphs), ``shard_search_host`` in the six
                arms' modes (the bf16 ones held to their f32 arms as on
                one shard): QPS, recall@10 against all points (>= 0.80;
                >= 0.60 for pq, and for cascade-deferred, whose merge
                ranks on PQ distances), launches (``ksort_l`` and the
                arm's kernels must launch), the stacked db's bytes, peak
                device memory and one profiled batch;
  7b. mesh    — the collective path (``distributed_search``) on the same
                P-shard dbs over a (1, P) mesh of the first P cards, or
                of cuda:0 P times on a machine with fewer (the line names
                the devices, and the card's name and power limit): in
                the pca, pca-deferred, pq and cascade-deferred arms the
                first ``MESH_QUERIES`` (2,048) queries (a ``reduced``
                line says why) bit-equal to ``shard_search_host``
                with each kernel launched as often (``ksort_l`` once a
                batch), QPS of both (the host path first); on the first
                4 batches the pca arm over a (2, P) mesh bit-equal to the
                host path on the same two blocks of each batch, and with
                shard 0 dead bit-equal in ids, dists and coverage;
  8. degraded — the first 4 batches, the pca arm with shard 0 dead:
                coverage equals ``shard_live_counts`` exactly, no id of
                shard 0 comes back, and ids and dists are bit-identical to
                searching ``select([1..P-1])``;
  9. tombstones — the first 4 batches, pca and pca-deferred, with 1% of
                the points deleted plus every query's true nearest
                neighbour: no deleted id comes back, recall@10 against the
                live points >= 0.78;
 10. resilient — one batch: ``probe_shard`` over every shard then
                ``merge_surviving`` is bit-identical to
                ``shard_search_host``; under a ``FaultPlan`` killing shard
                2 the probe raises ``ShardKilledError`` and the merge over
                the survivors equals the live-masked search; a corrupted
                answer fails ``check_shard_result``;
 10b. serve  — the README quickstart on the card at shard 0's size:
                ``MutableIndex.from_graph`` (the pca filter) with
                ``reserve(65536)`` and ``VectorSearchService(batch_size=
                --batch)``: the ``--queries`` queries served, 4,096 fresh
                points upserted (32 calls of ``insert_batch`` 128, each
                timed; a ``reduced`` line), 2,500 original ids deleted (5 calls, timed), the
                queries served again (no deleted id; recall@10 against the
                live points >= 0.80), self-recall of the inserted points
                (own id at rank 0) >= 0.95, ``save`` -> ``load`` on the
                card serving bit-equal ids and dists on every query, the
                first epoch's tensors unchanged, a NaN query refused; QPS
                and p50/p99 from ``ServiceStats`` at ``--batch`` and at
                64, peak device memory, and launches per part (the upserts
                must launch ``trip_fold``, ``fused_expand_rows`` and
                ``dist_h``, the queries the search's kernels);
 10c. serve_sharded — ``ShardedMutableIndex`` over the P shard graphs (one
                shared pca filter) behind a ``FaultPolicy`` service: the
                queries at recall@10 >= 0.80; shard 2 killed by a
                ``FaultPlan`` -> degraded, coverage the live-count share
                exactly, none of its ids; ``recover_shard(2)`` -> full
                coverage and the healthy ids; a corrupt answer
                quarantined; 2,048 round-robin upserts found by the next
                queries (self-recall >= 0.95), the stacked db of the
                epoch before them unchanged; a deferred search of the
                index; the one-npz snapshot round-trips bit-equal (each
                id's shard and local id: a restore renumbers a
                reservation's stride); the index's ``search(mesh=)`` (plain and deferred) and a
                service over the mesh bit-equal to the host path, the
                mesh service's ``scheduler()`` refused; peak
                device memory (every publish stacks a copy of the shards);
                ``ksort_l`` and ``dist_l`` must launch besides the
                search's and the probe's kernels;
 11. parity   — on the 8k bench fixture, the same graph packed on the card
                and on the CPU, for pca and the pq, pq-deferred,
                pca-deferred and cascade-deferred modes: bit-identical
                ids, dists, steps and Dist.H counts on integer-valued data
                (integer centroids, a coordinate-selecting projection),
                recall within 0.005 and ids equal for >= 99% of queries on
                float data; then the sharded search at P=4 on the card
                and on the CPU (the first ``SHARDED_PARITY_QUERIES``, 50,
                of the 200 queries, a ``reduced`` line) in every mode
                bit-identical on integer data with and without
                tombstones, and in ``SHARDED_FLOAT_MODES`` (pca) the
                same recall and id bars on float data; with layout (3)
                in bf16, pca and pca-deferred bit-identical on integer
                data, single-shard and at P=4 (with and without
                tombstones); the mesh search (``mesh``) at P=4 with
                tombstones in ``MESH_PARITY_MODES`` (pca) on 64
                queries, over a (1, 4) mesh and a (2, 4) one with
                shard 0 dead; ``run_stream()``
                through the scheduler (``stream``), single-shard and at
                P=4, bit-identical card against CPU and equal to the
                card's ``run_stream_sync()``; and the pca arm at
                expand_width W = 4
                and 8 (128 and 256 expand slots a row), card against CPU
                on both fixtures (``wide``); the mutable index (``mutable``)
                and the sharded one at P=4 on the integer data, card
                against CPU: the same integer upserts, deletes and a
                replace-upsert give identical ids, adjacency, levels,
                entry, dists and tombstone words; and ``compact()`` on the
                card's 8k index with a quarter deleted (the remap dense,
                recall@10 against the live points >= 0.80);
 13. replica  — (runs after 10c) the serve phase's setup cloned into a
                ``ReplicaSet`` of three replicas, each with its own copy
                of the index on the card: the ``--queries`` queries
                through ``rs.query`` (QPS, p50/p99 per request) and
                bit-equal on every replica; 8 replicated upserts of 128
                and one delete of 500 (``assert_converged`` at
                ``applied_seq`` 9); a checkpoint; replica 0 killed by a
                ``FaultPlan`` -> the request fails over to replica 1
                and 4 more upserts go in; ``recover(0)`` from the stale
                checkpoint replays exactly those 4, ``republish(0)``
                then 0, the three converge, and every id the recovered
                replica serves is live; every replica killed ->
                ``AllReplicasDeadError``; seconds per replicated upsert,
                checkpoint and recovery, and peak device memory; the
                queries and the upserts must launch ``trip_fold``,
                ``fused_expand_rows`` and ``dist_h``;
 14. stream   — (runs after 13) the continuous-batching scheduler:
                shard 0's ``MutableIndex`` behind a service of 64 (the
                bank's S = 64 slots): 5k queries (a ``reduced`` line)
                through
                ``run_stream()`` (the scheduler) and
                ``run_stream_sync()``, bit-equal, with QPS, p50 and p99
                of each and the escalations (a 1k-query pilot of the
                scheduler first, and the count cut, with a ``reduced``
                line, if the two passes would pass 60 s); 2,000
                mixed-k submits (k 10, 50, 100) at
                ``scheduler(ef=100)``: each rid exactly
                once with k ids, recall@10 >= 0.80; a pca-deferred
                service's scheduler bit-equal to its sync path; the P=4
                service over all points behind a ``FaultPolicy``:
                healthy bit-equal to its sync path, then shard 2 killed
                by a ``FaultPlan`` until marked dead: every completion
                degraded with the exact coverage, none of its ids, equal
                to the degraded sync answers; its sharded runs step all
                P shards in one pass: ``fused_expand_rows`` and
                ``trip_fold`` launch once a layer-body trip and
                ``trip_fold_gated`` once a slotted trip (trips counted
                on the host, ``search_torch.trip_counts``), not P times,
                and one full tick of each service (single and P=4) is
                counted: ATen operations dispatched on the host, port
                kernel launches and trips (``tick_ops``);
                ``slot_cache_sizes()``
                unchanged after each scheduler's warm-up; and
                ``repro_torch.bench.load`` at 0.5 and 0.9 of capacity
                (capacity, ``sync_tight``, the scheduler arm, the cost
                bridge); the scheduler parts must launch the gated fold,
                the sync part never;
 15. benches  — (runs after 11, on its cached 8k fixture and trained
                filters) the paper's benches through the runner,
                ``repro_torch.bench.run.main([...])``, one call a mode,
                each writing its JSON: ``--build --n-points 2000`` (the
                reference CI's gate size: wave recall@10 >= 0.95, both
                graphs' invariants, levels and entry equal to the
                oracle's, ``recall_delta`` >= -0.01; ``speedup_vs_ref``
                recorded), ``--faults`` (8k, P = 4: coverage the live
                share exactly at each dead-shard count, ``recall_full``
                within 0.02 of ``BENCH_table3.json`` -> ``faults``,
                ``recall_survivor`` >= 0.90 at one dead shard, no new
                search-program key over the kill / failover / recover
                cycle, recovered coverage 1.0), the full suite at 8k
                (``--fast``: Table III with the former ``table3``
                phase's checks — the card's pca recall within 0.02 of
                the host oracle's, the modeled processor's orderings
                with Fig 5's energies — and the filters A/B within 0.02
                of ``BENCH_table3.json`` -> ``filters``, the former
                filters table; Fig 2; the kernel footprint; the PQ
                ablation, each tracked mode within 0.02 and pq64 at 64
                bytes a vector and >= 0.60; the churn bench on one
                index), ``--churn --shards 4`` (both churns: final
                recall@10 against the live set >= 0.80, no deleted id
                answered, live size and tombstone fraction from the op
                counts) and ``--perf-smoke`` with ``--filter pq`` (>=
                0.60), ``--filter cascade --deferred`` (>= 0.80) and
                ``--shards 4`` (the (1, 4) mesh row >= 0.80); each
                call's path must launch its kernels; then the cost
                bridge on one 8k pca batch (its seven families);
 16. the ``{"kernels": [...]}`` line (each kernel's ``launches`` sums
     every main-path run, ``launches_replica``, ``launches_benches``,
     ``launches_stream``, ``launches_mesh``, ``launches_lm`` (the
     lm and lm_families phases' timed generates) and
     ``launches_dryrun`` included), the
     ``nvidia-smi`` line, and last
     ``{"ok": true, "device": {...}}``.

Launch counts are reset just before each main-path run (the footprint
bench, the lm phase, each lm_families generate, the train phase's timed
steps, the dryrun phase's real steps, the build, each
single-shard arm, each sharded arm, each mesh run,
each part of the serve, replica and stream phases and each runner call
of the benches phase) and read just after. The degraded, resilient and mesh phases need
P >= 2 and are skipped at ``--shards 1``, which otherwise gives the
single-shard smoke
over all ``--n`` points. It needs no network and one card, and exits
non-zero without CUDA or without the ``src/repro_torch`` package beside
it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIME_LIMIT_S = 1200
# SIFT1M is 1M points; the smoke builds 40k by default. The wave
# builder's linking runs in numpy on the host (the reference's
# arithmetic, kept so the graph can be held bit-for-bit against it) and
# takes ~93% of the build: a 1M build does not fit a third of the time
# limit; 200k did, until the mesh_lm phase needed its ~125 s, 100k,
# until the dryrun phase's 38-50 s took the total past 1,000 s on a
# slow host, and 75k, until the benches phase's ~125 s (PERF.md,
# "Cells").
FULL_N = 1_000_000
DEFAULT_N = 40_000
# the smoke's PQ codebook: 4 Lloyd iterations (the config's 8 before the
# benches phase; 4 is what the reference's benches train plain PQ with),
# ~21 s of host numpy on 20k points instead of ~43
PQ_TRAIN_ITERS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------ kernels ------------------------------------

def _expand_case(np, rng, B, M, dl, integer):
    if integer:
        x = rng.integers(0, 16, (B, M, dl)).astype(np.float32)
        q = rng.integers(0, 16, (B, dl)).astype(np.float32)
        th = np.where(rng.random(B) < 0.5, 4.0 * 16 * dl, 3.4e38)
    else:
        x = rng.standard_normal((B, M, dl)).astype(np.float32)
        q = rng.standard_normal((B, dl)).astype(np.float32)
        th = np.where(rng.random(B) < 0.5, 2.0 * dl, 3.4e38)
    valid = rng.random((B, M)) < 0.8
    if integer and B >= 8:
        # edge rows: all invalid, all-equal distances, every slot above
        # the threshold (all INF pads)
        valid[0] = False
        x[1] = x[1, :1]
        valid[1] = True
        th[2] = 0.0
    return x, q, valid, th.astype(np.float32)


def _merge_case(np, rng, B, Na, Nb, integer):
    pool = rng.integers(0, 8, 16) if integer else rng.standard_normal(16)
    a = np.sort(rng.choice(pool, (B, Na)), 1).astype(np.float32)
    b = np.sort(rng.choice(pool, (B, Nb)), 1).astype(np.float32)
    if B >= 4:
        a[0, Na // 2:] = 3.4e38           # INF pads on both sides
        b[1, :] = 3.4e38
        a[2, :], b[2, :] = 1.0, 1.0        # all equal: a side, then slot
    ia = rng.integers(0, 1 << 20, (B, Na)).astype(np.int32)
    ib = rng.integers(0, 1 << 20, (B, Nb)).astype(np.int32)
    return a, ia, b, ib


def _pq_case(np, rng, B, M, S, integer):
    """uint8 codes and a flat per-query row [S*256 + 15] whose first
    S*256 entries are the tables (the cascade's prep layout); integer
    tables make every sum exact. Edge rows as in ``_expand_case``."""
    codes = rng.integers(0, 256, (B, M, S)).astype(np.uint8)
    if integer:
        flat = rng.integers(0, 1 << 16, (B, S * 256 + 15)).astype(np.float32)
        th = np.where(rng.random(B) < 0.5, float(S << 15), 3.4e38)
    else:
        flat = np.abs(rng.standard_normal((B, S * 256 + 15))) \
            .astype(np.float32)
        th = np.where(rng.random(B) < 0.5, 0.8 * S, 3.4e38)
    valid = rng.random((B, M)) < 0.8
    if integer and B >= 8:
        valid[0] = False
        codes[1] = codes[1, :1]
        valid[1] = True
        th[2] = 0.0
    return codes, flat, valid, th.astype(np.float32)


def _ksort_case(np, rng, B, M, integer):
    """Rows to rank: small integers (tie-rich) or 3x standard normal
    (negatives included); where B allows, edge rows: all INF, -0.0
    beside 0.0 (they tie by index), and a tie pool of four values."""
    if integer:
        d = rng.integers(0, 8, (B, M)).astype(np.float32)
    else:
        d = (3.0 * rng.standard_normal((B, M))).astype(np.float32)
    if B >= 4:
        d[0] = 3.4e38
        d[1] = rng.choice(np.asarray([-0.0, 0.0, 1.0], np.float32), M)
        d[2] = rng.choice(np.asarray([0.0, 1.0, 1.0, 2.0], np.float32), M)
    return d


def _library_pq_expand(torch, codes, lut, valid, th, k):
    """The PQ expand as library calls: gather, sum, mask, stable sort."""
    d = torch.gather(lut, 2, codes.long().transpose(1, 2)).sum(1)
    d = torch.where(valid & (d < th[:, None]), d, 3.4e38)
    return torch.sort(d, dim=1, stable=True)[0][:, :k]


def _library_expand(torch, x, q, valid, th, k):
    """The fused expand as library calls: distances, mask, stable sort."""
    d = ((x - q[:, None]) ** 2).sum(-1)
    d = torch.where(valid & (d < th[:, None]), d, 3.4e38)
    return torch.sort(d, dim=1, stable=True)[0][:, :k]


def phase_kernels(torch, np, seed: int, device: str = "cuda") -> dict:
    from repro_torch.bench.kernel_footprint import (bound_ms,
                                                    device_kernels,
                                                    graph_ms,
                                                    launch_floor_ms)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels._launch import smem_optin
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    T = lambda *arrs: [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in arrs]
    results = {}

    def compare(name, shape, got, want, exact):
        gd, gi = got if isinstance(got, tuple) else (got, None)
        wd, wi = want if isinstance(want, tuple) else (want, None)
        torch.cuda.synchronize()
        err = float((gd - wd).abs().max()) if gd.numel() else 0.0
        if exact:
            need(torch.equal(gd, wd), f"{name}{shape}: distances differ "
                 f"from the plain version on exact inputs (max {err})")
        else:
            need(torch.allclose(gd, wd, rtol=1e-5, atol=1e-3),
                 f"{name}{shape}: max abs err {err} vs plain")
        if gi is not None and exact:
            need(torch.equal(gi, wi), f"{name}{shape}: indices differ")
        return err

    # --- fused_expand: search layers 0 / 1 / 2+ (M, k) at dl = 15 ---
    fe_shapes = [(1024, 32, 15, 16), (1024, 16, 15, 8), (1024, 16, 15, 3),
                 (1024, 32, 15, 1), (1024, 64, 15, 32)]
    for B, M, dl, k in fe_shapes:
        errs = []
        for integer in (True, False):
            x, q, v, th = T(*_expand_case(np, rng, B, M, dl, integer))
            errs.append(compare("fused_expand", (B, M, dl, k),
                                ops.fused_expand(x, q, v, th, k),
                                ref.fused_expand_ref(x, q, v, th, k),
                                integer))
        nbytes = B * M * dl * 4 + B * dl * 4 + B * M + B * 4 + B * k * 8
        nops = B * M * dl * 3 + B * M * M
        results[("fused_expand", (B, M, dl, k))] = dict(
            max_abs_err=max(errs),
            ms=graph_ms(lambda: ops.fused_expand(x, q, v, th, k)),
            plain_ms=graph_ms(lambda: ref.fused_expand_ref(
                x, q, v, th, k)),
            library_ms=graph_ms(lambda: _library_expand(
                torch, x, q, v, th, k)),
            bound=bound_ms(nbytes, nops))

    # --- merge_sorted: search L0 F/C/Cp, L1 C, L2+ C, probe F/C ---
    # (+ layer 0 of pca-deferred F/C and cascade-deferred F/C/Cp)
    mg_shapes = [(1024, 10, 10, 10), (1024, 26, 16, 26), (1024, 16, 16, 16),
                 (1024, 9, 8, 9), (1024, 8, 3, 8), (1024, 1, 1, 1),
                 (2048, 100, 32, 100), (2048, 132, 32, 132),
                 (2048, 32, 16, 32), (1024, 30, 16, 30), (1024, 46, 16, 46),
                 (1024, 60, 32, 60), (1024, 92, 32, 92), (1024, 32, 32, 32)]
    for B, Na, Nb, k in mg_shapes:
        errs = []
        for integer in (True, False):
            a, ia, b, ib = T(*_merge_case(np, rng, B, Na, Nb, integer))
            errs.append(compare("merge_sorted", (B, Na, Nb, k),
                                ops.merge_topk_sorted(a, ia, b, ib, k),
                                ref.merge_topk_sorted_ref(a, ia, b, ib, k),
                                True))
        nbytes = B * (Na + Nb) * 8 + B * k * 8
        nops = B * (Na * max(Nb, 1).bit_length()
                    + Nb * max(Na, 1).bit_length())
        results[("merge_sorted", (B, Na, Nb, k))] = dict(
            max_abs_err=max(errs),
            ms=graph_ms(lambda: ops.merge_topk_sorted(a, ia, b, ib,
                                                             k)),
            plain_ms=graph_ms(lambda: ref.merge_topk_sorted_ref(
                a, ia, b, ib, k)),
            library_ms=graph_ms(lambda: torch.sort(
                torch.cat([a, b], 1), dim=1, stable=True)[0][:, :k]),
            bound=bound_ms(nbytes, nops))

    # --- dist_h: search K = 16/8/3 and the entry (1); probe K = 32/16;
    #     the mutable index's insert probe [128, 16, 128]; the deferred
    #     re-rank K = 30 (pca) and 20 (cascade); the footprint bench's
    #     [64, 16, 128] ---
    dh_shapes = [(1024, 16, 128), (1024, 8, 128), (1024, 3, 128),
                 (1024, 1, 128), (2048, 32, 128), (2048, 16, 128),
                 (128, 16, 128), (1024, 30, 128), (1024, 20, 128),
                 (64, 16, 128)]
    for B, K, D in dh_shapes:
        errs = []
        for integer in (True, False):
            if integer:
                xn = rng.integers(0, 220, (B, K, D)).astype(np.float32)
                qn = rng.integers(0, 220, (B, D)).astype(np.float32)
            else:
                xn = rng.standard_normal((B, K, D)).astype(np.float32)
                qn = rng.standard_normal((B, D)).astype(np.float32)
            x, q = T(xn, qn)
            errs.append(compare("dist_h", (B, K, D), ops.dist_h(x, q),
                                ref.dist_h_ref(x, q), integer))
        results[("dist_h", (B, K, D))] = dict(
            max_abs_err=max(errs),
            ms=graph_ms(lambda: ops.dist_h(x, q)),
            plain_ms=graph_ms(lambda: ref.dist_h_ref(x, q)),
            library_ms=graph_ms(lambda: ((x - q[:, None]) ** 2)
                                .sum(-1)),
            bound=bound_ms(B * K * D * 4 + B * D * 4 + B * K * 4,
                           B * K * D * 3))
    # --- dist_l: cascade promote K = promote_mult * ef0 = 60, the
    #     deferred entry score K = 1 (bf16 rows in the bf16 arms); the
    #     footprint bench's [64, 32, 15]; each on f32 and bf16 rows (the
    #     bf16 key carries "bf16"), one device kernel a bf16 call ---
    from repro_torch.kernels._launch import sm_count
    from repro_torch.kernels.dist_l import dist_l_plan
    for (B, K, dl), dt in [(s, dt) for s in ((1024, 60, 15), (1024, 1, 15),
                                              (64, 32, 15))
                           for dt in ("f32", "bf16")]:
        errs = []
        for integer in (True, False):
            if integer:
                xn = rng.integers(-64, 64, (B, K, dl)).astype(np.float32)
                qn = rng.integers(-64, 64, (B, dl)).astype(np.float32)
            else:
                xn = rng.standard_normal((B, K, dl)).astype(np.float32)
                qn = rng.standard_normal((B, dl)).astype(np.float32)
            x, q = T(xn, qn)
            if dt == "bf16":
                x = x.to(torch.bfloat16)
            errs.append(compare("dist_l", (B, K, dl, dt), ops.dist_l(x, q),
                                ref.dist_l_ref(x, q), integer))
        key = (B, K, dl) if dt == "f32" else (B, K, dl, "bf16")
        isz = x.element_size()
        kernels_a_call = device_kernels(lambda: ops.dist_l(x, q))
        need(kernels_a_call == 1, f"dist_l{key}: {kernels_a_call} device "
             "kernels a call")
        results[("dist_l", key)] = dict(
            max_abs_err=max(errs),
            ms=graph_ms(lambda: ops.dist_l(x, q)),
            plain_ms=graph_ms(lambda: ref.dist_l_ref(x, q)),
            library_ms=graph_ms(lambda: ((x - q[:, None]) ** 2)
                                .sum(-1)),
            bound=bound_ms(B * K * dl * isz + B * dl * 4 + B * K * 4,
                           B * K * dl * 3),
            plan=dist_l_plan(B * K, sm_count(dev)),
            device_kernels=kernels_a_call)

    # --- pq_adc_expand: pq layers 0/1/2+ (M, k) = (32, 16)/(16, 8)/
    #     (16, 3); cascade-deferred layer 0 keeps all M0 = 32. The
    #     cascade's tables are a strided view of its flat prep row ---
    pq_shapes = [(1024, 32, 16, 16), (1024, 16, 16, 8), (1024, 16, 16, 3),
                 (1024, 32, 16, 32)]
    for B, M, S, k in pq_shapes:
        errs = []
        for integer in (True, False):
            c, flat, v, th = T(*_pq_case(np, rng, B, M, S, integer))
            lut = flat[:, :S * 256].reshape(B, S, 256)
            if k != 32:
                lut = lut.contiguous()         # the pq filter's own tables
            errs.append(compare("pq_adc_expand", (B, M, S, k),
                                ops.pq_adc_expand(c, lut, v, th, k),
                                ref.pq_adc_expand_ref(c, lut, v, th, k),
                                integer))
        # bytes: the table entries the codes name (each read once; the
        # whole [B, S, 256] table is B*S*1 KB), the codes, mask, th, out
        touched = torch.zeros((B, S, 256), dtype=torch.bool, device=dev)
        touched.scatter_(2, c.long().transpose(1, 2), True)
        nbytes = int(touched.sum()) * 4 + B * M * S + B * M + B * 4 \
            + B * k * 8
        results[("pq_adc_expand", (B, M, S, k))] = dict(
            max_abs_err=max(errs),
            ms=graph_ms(lambda: ops.pq_adc_expand(c, lut, v, th, k)),
            plain_ms=graph_ms(lambda: ref.pq_adc_expand_ref(
                c, lut, v, th, k)),
            library_ms=graph_ms(lambda: _library_pq_expand(
                torch, c, lut, v, th, k)),
            bound=bound_ms(nbytes, B * M * S + B * M * M),
            bound_full_table_ms=bound_ms(
                nbytes - int(touched.sum()) * 4 + B * S * 256 * 4,
                B * M * S + B * M * M)[0])

    # --- ksort_l: the cross-shard merge at P=4, M = P * E, k = E for the
    #     per-step arms (E = ef0 = 10), pca-deferred (E = 30) and the
    #     cascade (E = 60) and the footprint bench's [64, 32] k=16, all
    #     timed; then edge shapes (M not a multiple of 32, k == M, B ==
    #     1) and the warp tier's edges (M = 256, 257, 512, 513 at k = 1
    #     and k = M), checked but not timed; values to their sign bits ---
    from repro_torch.kernels.ksort_l import ksort_plan
    edges = [(64, M, k) for M in (256, 257, 512, 513) for k in (1, M)]
    for B, M, k in [(1024, 40, 10), (1024, 120, 30), (1024, 240, 60),
                    (64, 32, 16), (8, 33, 5), (4, 64, 64), (1, 40, 10)] \
            + edges:
        errs = []
        for integer in (True, False):
            (d,) = T(_ksort_case(np, rng, B, M, integer))
            got, want = ops.ksort_l(d, k), ref.ksort_l_ref(d, k)
            errs.append(compare("ksort_l", (B, M, k), got, want, True))
            need(torch.equal(torch.signbit(got[0]), torch.signbit(want[0])),
                 f"ksort_l{(B, M, k)}: sign bits differ")
        if B < 1024 and (B, M, k) != (64, 32, 16):
            continue
        results[("ksort_l", (B, M, k))] = dict(
            plan=ksort_plan(M, smem_optin(dev)),
            max_abs_err=max(errs),
            ms=graph_ms(lambda: ops.ksort_l(d, k)),
            plain_ms=graph_ms(lambda: ref.ksort_l_ref(d, k)),
            library_ms=graph_ms(lambda: [
                t[:, :k] for t in torch.sort(d, dim=1, stable=True)]),
            # a comparison sort's M * log2(M) compares per row
            bound=bound_ms(B * M * 4 + B * k * 8,
                           B * M * max(M - 1, 1).bit_length()))

    results.update(check_fused_filter(torch, np, rng, T))
    results.update(check_fold_and_rows(torch, np, rng, T))
    results.update(check_pca_rows(torch, np, rng, T))
    results.update(check_stacked(torch, np, rng, T))
    emit({"phase": "wide_tiers", "tiers": check_wide_tiers(torch, np, rng,
                                                           T)})
    results.update(check_attention(torch, np, rng))
    # the floor under every small kernel: an empty kernel's replay
    floor = launch_floor_ms()
    emit({"phase": "launch_floor", "name": "empty", "ms": floor,
          "source": "src/repro_torch/kernels/csrc/empty.cu"})

    for (name, shape), r in results.items():
        emit({"phase": "kernel", "name": name, "shape": list(shape),
              "max_abs_err": r["max_abs_err"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
              **{key: val for key, val in r.items() if key not in (
                  "max_abs_err", "ms", "plain_ms", "library_ms", "bound")}})
    return results


def _fold_case(np, rng, B, ef, cap, k, kk, integer, n_ids=50_000):
    """A trip's state and feed: ascending frontiers with INF/-1 tails,
    a feed with INF/-1 slots, tombstone words over ``n_ids`` ids; integer
    data from a tie-rich pool with -0.0 beside 0.0, or float squared
    distances; edge rows (F empty, C exhausted, a one-value feed)."""
    if integer:
        pool = np.asarray([-0.0, 0.0, 1.0, 2.0, 2.0, 3.0, 5.0], np.float32)
        draw = lambda shape: rng.choice(pool, shape)
    else:
        draw = lambda shape: (3 * rng.standard_normal(shape)) ** 2

    def frontier(n):
        d = np.sort(draw((B, n)), 1).astype(np.float32)
        pads = rng.integers(0, n + 1, B)
        d[np.arange(n)[None, :] >= n - pads[:, None]] = 3.4e38
        i = rng.integers(0, n_ids, (B, n)).astype(np.int32)
        i[d == 3.4e38] = -1
        return d, i

    F_d, F_i = frontier(ef)
    C_d, C_i = frontier(cap)
    Cp = frontier(max(k, 1))[0]
    dh = draw((B, kk)).astype(np.float32)
    dh[rng.random((B, kk)) < 0.2] = 3.4e38
    cand = rng.integers(0, n_ids, (B, kk)).astype(np.int32)
    cand[dh == 3.4e38] = -1
    kv = draw((B, kk)).astype(np.float32)
    if B >= 4:
        F_d[0], F_i[0] = 3.4e38, -1
        C_d[1], C_i[1] = 3.4e38, -1
        dh[2] = dh[2, :1]
    flags = rng.random(n_ids) < 0.01
    words = np.zeros(-(-n_ids // 32), np.uint32)
    ids = np.nonzero(flags)[0].astype(np.uint32)
    np.bitwise_or.at(words, ids // 32, np.uint32(1) << (ids % 32))
    return F_d, F_i, C_d, C_i, Cp, dh, cand, kv, words.view(np.int32)


def _library_fold(torch, F_d, F_i, C_d, C_i, W, Cp, dh, cand, kv,
                  deleted, ef_eff=None, pop=None):
    """The fold as library calls: the stable torch.sort route of the
    search body before the fold (accept, where rows, one stable sort of
    each frontier followed by its feed; a stable sort of [a, b] keeps
    the merge's ties, the a side first, then the lower slot); gated per
    row by ``ef_eff`` (the bound's slot) and ``pop``."""
    B = dh.shape[0]
    inf = 3.4e38
    bnd = F_d[:, -1:] if ef_eff is None else torch.gather(
        F_d, 1, (ef_eff.clamp(1, F_d.shape[1]) - 1).long()[:, None])
    acc = dh < bnd
    cd = torch.where(acc, dh, inf)
    ci = torch.where(acc, cand, -1)
    fd, fi = cd, ci
    if deleted is not None:
        safe = cand.clamp(min=0)
        word = (safe // 32).long()
        if deleted.dim() == 2:      # stacked: row r reads shard r // (B / P)
            P, nw = deleted.shape
            word = word + (torch.arange(B, device=cand.device)
                           // (B // P) * nw)[:, None]
        tomb = ((torch.take(deleted, word) >> (safe % 32)) & 1) != 0
        fd = torch.where(acc & ~tomb, dh, inf)
        fi = torch.where(acc & ~tomb, cand, -1)

    def merge(ad, ai, bd, bi, n):
        sd, o = torch.sort(torch.cat([ad, bd], 1), dim=1, stable=True)
        return sd[:, :n], torch.gather(torch.cat([ai, bi], 1), 1, o[:, :n])

    out = list(merge(F_d, F_i, fd, fi, F_d.shape[1]))
    pad_d = C_d.new_full((B, W), inf)
    pad_i = C_i.new_full((B, W), -1)
    sh_d = torch.cat([C_d[:, W:], pad_d], 1)
    sh_i = torch.cat([C_i[:, W:], pad_i], 1)
    if pop is not None:
        sh_d = torch.where(pop[:, None], sh_d, C_d)
        sh_i = torch.where(pop[:, None], sh_i, C_i)
    out += merge(sh_d, sh_i, cd, ci, C_d.shape[1])
    if Cp is not None:
        pv = torch.where(acc, kv, inf) if kv is not None else cd
        out.append(torch.sort(torch.cat([Cp, pv], 1), dim=1,
                              stable=True)[0][:, :Cp.shape[1]])
    return out


def _fold_cost(B, ef, cap, k, kk, kv, tombs, nw):
    """Bytes and operations of one fold: F, C, the heap and the feed
    read once (the tombstone words a row's feed names, at most all of
    them), the new frontiers written once; each feed ranked by a
    comparison sort (kk log2 kk compares) and each side of each merge
    placed by a binary search into the other."""
    lg = lambda n: max(n - 1, 1).bit_length()
    feeds = [(ef, True), (cap, True), (k, k > 0)]
    nbytes = B * (16 * ef + 16 * cap + 8 * k + 8 * kk
                  + (4 * kk if kv else 0)) + (4 * min(B * kk, nw)
                                              if tombs else 0)
    nops = sum(B * (kk * lg(kk) + kk * lg(n) + n * lg(kk))
               for n, on in feeds if on)
    return nbytes, nops


# trip_fold rows: (B, ef, k, W, kk, heap, kv row, tombstones, timed) — the
# folds of the main path (the merges of mg_shapes: pca layers 0 / 1 / 2+,
# pca-deferred and cascade-deferred layer 0, the probe's layer 0 and
# upper layers, the tombstone arms' layer 0, the mutable index's insert
# probe at every layer), then W = 4 and 8 (W * k > 64: the block tier)
# and a frontier past shared memory (global tier)
FOLD_CASES = [(1024, 10, 16, 1, 16, True, True, False, True),
              (128, 100, 16, 1, 16, True, True, True, True),
              (1024, 30, 16, 1, 16, True, False, False, True),
              (1024, 60, 32, 1, 32, True, False, False, True),
              (2048, 100, 0, 1, 32, False, False, False, True),
              (2048, 16, 0, 1, 16, False, False, False, True),
              (1024, 10, 16, 1, 16, True, True, True, True),
              (1024, 1, 8, 1, 8, True, True, False, False),
              (1024, 1, 3, 1, 3, True, True, False, False),
              (1024, 10, 16, 4, 64, True, True, True, False),
              (256, 10, 16, 8, 128, True, True, True, False),
              (256, 100, 0, 8, 256, False, False, True, False),
              (2, 30000, 16, 1, 32, True, True, True, False)]
# the fold gated per row (the slotted search: ``ef_eff`` picks the
# bound's slot, ``pop`` keeps a done or budget-frozen row's C unpopped),
# in the same layout: the pca scheduler's bank (S = 64 slots, ef 10, the
# mutable index's tombstones: row 2c), the pca-deferred bank (ef 30),
# then the block tier (W = 8) and the global tier
GATED_FOLD_CASES = [(64, 10, 16, 1, 16, True, True, True, True),
                    (64, 30, 16, 1, 16, True, False, True, False),
                    (64, 10, 16, 8, 128, True, True, True, False),
                    (2, 30000, 16, 1, 32, True, True, True, False)]
# pq_expand_rows rows: (B, W, M0, S, k, cascade, timed): the pq arm's
# layer 0 (k = 16 of 32), the cascade-deferred arm's (k = M0), then W =
# 2 and 4 (64 and 128 slots: the warp tier's other widths) and W = 8
# (256 slots: the block tier)
ROWS_CASES = [(1024, 1, 32, 16, 16, False, True),
              (1024, 1, 32, 16, 32, True, True),
              (1024, 2, 32, 16, 16, False, True),
              (1024, 4, 32, 16, 16, False, True),
              (256, 8, 32, 16, 16, True, False)]


def _rows_case(np, rng, B, W, M0, S, N=50_000):
    """A layer (adj with -1 tails, layout-(3) codes), a frontier whose
    first W ids are popped (some -1), gates, a flat integer table row
    [S*256 + 15] (the cascade's layout) and a heap whose last column is
    the threshold."""
    adj = rng.integers(0, N, (N, M0)).astype(np.int32)
    tails = rng.integers(0, M0 // 2, N)
    adj[np.arange(M0)[None, :] >= M0 - tails[:, None]] = -1
    codes = rng.integers(0, 256, (N, M0, S)).astype(np.uint8)
    C_i = rng.integers(-1, N, (B, W + 9)).astype(np.int32)
    exp = rng.random((B, W)) < 0.9
    exp[0] = False
    flat = rng.integers(0, 1 << 16, (B, S * 256 + 15)).astype(np.float32)
    heap = np.sort(rng.integers(0, 1 << 22, (B, 4)), 1).astype(np.float32)
    heap[::2, -1] = 3.4e38
    return adj, codes, C_i, exp, flat, heap


def check_fold_and_rows(torch, np, rng, T) -> dict:
    """trip_fold and pq_expand_rows against their plain versions on the
    card, bit for bit (raw f32 bits: -0.0 and 0.0 told apart) on integer
    and float data (the fold) and integer tables (the expand); then the
    expand also against the path it replaces (index_select, the
    pq_adc_expand kernel, the id gather). Timed rows: kernel, plain,
    library (the fold: ``_library_fold``; the expand: index_select +
    gather-sum + stable sort + id gather) and the bound; the expand also
    unfused (``unfused_ms``)."""
    from repro_torch.bench.kernel_footprint import bound_ms, graph_ms
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels._launch import smem_optin
    from repro_torch.kernels.trip_fold import fold_plan
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    out = {}
    for B, ef, k, W, kk, heap, kv_row, tombs, timed in FOLD_CASES:
        cap = max(ef + kk, 8)
        shape = (B, ef, cap, k, kk, W, "heap" if heap else "bypass",
                 "kv" if kv_row else "-", "tombs" if tombs else "-")
        for integer in (True, False):
            F_d, F_i, C_d, C_i, Cp, dh, cand, kv, words = T(
                *_fold_case(np, rng, B, ef, cap, k, kk, integer))
            args = (F_d, F_i, C_d, C_i, W, Cp if heap else None, dh, cand,
                    kv if kv_row else None, words if tombs else None)
            got = ops.trip_fold(*args)
            want = ref.trip_fold_ref(*args)
            torch.cuda.synchronize()
            need(all(torch.equal(bits(g), bits(w)) for g, w in
                     zip(got, want) if w is not None),
                 f"trip_fold{shape} (integer={integer}): differs from the "
                 "plain version")
            if not integer:     # no -0.0: a radix sort may order it
                lib = _library_fold(torch, *args)
                need(all(torch.equal(g, w) for g, w in zip(got, lib)),
                     f"trip_fold{shape}: differs from the library route")
        if not timed:
            continue
        nbytes, nops = _fold_cost(B, ef, cap, k, kk, kv_row, tombs,
                                  words.numel())
        out[("trip_fold", shape)] = dict(
            max_abs_err=0.0,
            tier=fold_plan(ef, cap, k, kk, smem_optin(F_d.device))["tier"],
            ms=graph_ms(lambda: ops.trip_fold(*args)),
            plain_ms=graph_ms(lambda: ref.trip_fold_ref(*args)),
            library_ms=graph_ms(lambda: _library_fold(torch, *args)),
            bound=bound_ms(nbytes, nops))
    for B, ef, k, W, kk, heap, kv_row, tombs, timed in GATED_FOLD_CASES:
        cap = max(ef + kk, 8)
        shape = (B, ef, cap, k, kk, W, "heap" if heap else "bypass",
                 "kv" if kv_row else "-", "tombs" if tombs else "-")
        for integer in (True, False):
            F_d, F_i, C_d, C_i, Cp, dh, cand, kv, words = T(
                *_fold_case(np, rng, B, ef, cap, k, kk, integer))
            ef_eff, pop = T(rng.integers(1, ef + 1, B).astype(np.int32),
                            rng.random(B) < 0.6)
            ef_eff[:1], pop[:1] = ef, True
            args = (F_d, F_i, C_d, C_i, W, Cp if heap else None, dh, cand,
                    kv if kv_row else None, words if tombs else None)
            gates = dict(ef_eff=ef_eff, pop=pop)
            got = ops.trip_fold(*args, **gates)
            want = ref.trip_fold_ref(*args, **gates)
            torch.cuda.synchronize()
            need(all(torch.equal(bits(g), bits(w)) for g, w in
                     zip(got, want) if w is not None),
                 f"trip_fold_gated{shape} (integer={integer}): differs "
                 "from the plain version")
            # every row popped at the compiled bound is today's fold
            full = dict(ef_eff=torch.full_like(ef_eff, ef),
                        pop=torch.ones_like(pop))
            need(all(torch.equal(bits(g), bits(w)) for g, w in
                     zip(ops.trip_fold(*args, **full), ops.trip_fold(*args))
                     if w is not None),
                 f"trip_fold_gated{shape}: ungated rows differ from the "
                 "ungated kernel")
            if not integer:
                lib = _library_fold(torch, *args, **gates)
                need(all(torch.equal(g, w) for g, w in zip(got, lib)),
                     f"trip_fold_gated{shape}: differs from the library "
                     "route")
        if not timed:
            continue
        nbytes, nops = _fold_cost(B, ef, cap, k, kk, kv_row, tombs,
                                  words.numel())
        out[("trip_fold_gated", shape)] = dict(
            max_abs_err=0.0,
            tier=fold_plan(ef, cap, k, kk, smem_optin(F_d.device))["tier"],
            ms=graph_ms(lambda: ops.trip_fold(*args, **gates)),
            plain_ms=graph_ms(lambda: ref.trip_fold_ref(*args, **gates)),
            library_ms=graph_ms(lambda: _library_fold(torch, *args,
                                                      **gates)),
            bound=bound_ms(nbytes + B * 5, nops))
    for B, W, M0, S, k, cascade, timed in ROWS_CASES:
        adj, codes, C_i, exp, flat, heap = T(*_rows_case(np, rng, B, W, M0,
                                                         S))
        lut = flat[:, :S * 256].reshape(B, S, 256)
        if not cascade:
            lut = lut.contiguous()          # the pq filter's own tables
        c_w, th, kk = C_i[:, :W], heap[:, -1], W * k
        shape = (B, W, M0, S, k)

        def unfused():
            c_safe = torch.where(exp, c_w.clamp(min=0), 0).reshape(-1)
            nb_i = adj.index_select(0, c_safe).reshape(B, W * M0)
            mask = (nb_i >= 0) & exp.repeat_interleave(M0, dim=1)
            pay = codes.index_select(0, c_safe).reshape(B, W * M0, S)
            d, i = ops.pq_adc_expand(pay, lut, mask, th, kk)
            return d, torch.gather(nb_i, 1, i.long())

        def library():
            c_safe = torch.where(exp, c_w.clamp(min=0), 0).reshape(-1)
            nb_i = adj.index_select(0, c_safe).reshape(B, W * M0)
            mask = (nb_i >= 0) & exp.repeat_interleave(M0, dim=1)
            pay = codes.index_select(0, c_safe).reshape(B, W * M0, S)
            d = torch.gather(lut, 2, pay.long().transpose(1, 2)).sum(1)
            d = torch.where(mask & (d < th[:, None]), d, 3.4e38)
            sd, o = torch.sort(d, dim=1, stable=True)
            return sd[:, :kk], torch.gather(nb_i, 1, o[:, :kk])

        want = ref.pq_expand_rows_ref(adj, codes, c_w, exp, lut, th, kk)
        for name, got in (
                ("kernel", ops.pq_expand_rows(adj, codes, c_w, exp, lut, th,
                                              kk)),
                ("unfused", unfused()), ("library", library())):
            torch.cuda.synchronize()
            need(torch.equal(bits(got[0]), bits(want[0]))
                 and torch.equal(got[1], want[1]),
                 f"pq_expand_rows{shape} {name}: differs from the plain "
                 "version")
        if not timed:
            continue
        # bytes: what the function needs, as for fused_expand_rows: the
        # adjacency rows of the gated nodes (and node 0's once), the codes
        # of their slots whose neighbour is not -1 and the table entries
        # those codes name; per row the ids, gates, threshold and outputs
        M = W * M0
        c_safe = torch.where(exp, c_w.clamp(min=0), 0).reshape(-1)
        used = (adj.index_select(0, c_safe).reshape(B, M) >= 0) \
            & exp.repeat_interleave(M0, dim=1)
        pay = codes.index_select(0, c_safe).reshape(B, M, S)
        hits = torch.zeros((B, S, 256), dtype=torch.int32, device=adj.device)
        hits.scatter_add_(2, pay.long().transpose(1, 2),
                          used.int()[:, None, :].expand(B, S, M))
        per_row = B * (W * 5 + 4 + kk * 8)
        nbytes = int((hits > 0).sum()) * 4 + int(exp.sum()) * M0 * 4 \
            + M0 * 4 + int(used.sum()) * S + per_row
        touched = torch.zeros((B, S, 256), dtype=torch.bool, device=adj.device)
        touched.scatter_(2, pay.long().transpose(1, 2), True)
        all_bytes = int(touched.sum()) * 4 + B * M * (4 + S) + per_row
        out[("pq_expand_rows", shape)] = dict(
            max_abs_err=0.0,
            ms=graph_ms(lambda: ops.pq_expand_rows(adj, codes, c_w, exp, lut,
                                                   th, kk)),
            unfused_ms=graph_ms(unfused),
            plain_ms=graph_ms(lambda: ref.pq_expand_rows_ref(
                adj, codes, c_w, exp, lut, th, kk)),
            library_ms=graph_ms(library),
            bound=bound_ms(nbytes, int(used.sum()) * S + B * M * M),
            bound_all_rows_ms=bound_ms(all_bytes, B * M * S + B * M * M)[0])
    return out


# fused_expand_rows rows (on a layer of M0 = 32, dl = 15): (B, W, M0,
# dl, k, timed): the pca arms' layer
# 0 (W = 1: 32 slots, k = 16), the mutable index's insert probe at layer
# 0 (B = 128), W = 2 and 4 (64 and 128 slots: the warp
# tier's other widths), W = 8 (256 slots: the block tier), checked only
PCA_ROWS_CASES = [(1024, 1, 32, 15, 16, True, "f32"),
                  (128, 1, 32, 15, 16, True, "f32"),
                  (1024, 1, 32, 15, 16, True, "bf16"),
                  (1024, 2, 32, 15, 16, True, "f32"),
                  (1024, 4, 32, 15, 16, True, "f32"),
                  (256, 8, 32, 15, 16, False, "f32"),
                  (256, 8, 32, 15, 16, False, "bf16")]


def _pca_layer(np, rng, N, M0, dl, integer):
    """A layer: adj with -1 tails and layout-(3) rows, integer (exact
    sums) or standard normal."""
    adj = rng.integers(0, N, (N, M0)).astype(np.int32)
    tails = rng.integers(0, M0 // 2, N)
    adj[np.arange(M0)[None, :] >= M0 - tails[:, None]] = -1
    low = rng.integers(0, 16, (N, M0, dl)) if integer \
        else rng.standard_normal((N, M0, dl))
    return adj, low.astype(np.float32)


def _pca_pops(np, rng, B, W, N, dl, integer):
    """A frontier whose first W ids are popped (some -1; row 2 a -1 pop
    with its gate set), gates (row 0 all clear), queries and a heap whose
    last column is the threshold (row 1: 0; even rows INF)."""
    C_i = rng.integers(-1, N, (B, W + 9)).astype(np.int32)
    exp = rng.random((B, W)) < 0.9
    exp[0] = False
    C_i[2, 0], exp[2, 0] = -1, True
    q = rng.integers(0, 16, (B, dl)) if integer \
        else rng.standard_normal((B, dl))
    scale = 64.0 * dl if integer else 1.5 * dl
    heap = np.sort(rng.random((B, 4)) * scale, 1).astype(np.float32)
    heap[::2, -1] = 3.4e38
    heap[1, -1] = 0.0
    return C_i, exp, q.astype(np.float32), heap


def _unfused_pca(torch, ops, ref, adj, low, c_w, exp, q, th, kk):
    """The search's pca expand before the gathers were fused, as it was
    launched: the popped ids' where/clamp, two index_select and the mask
    (``ref.popped_rows``), the fused_expand kernel (with its copy of the
    threshold column) and the id gather."""
    nb_i, mask, pay = ref.popped_rows(adj, low, c_w, exp)
    d, i = ops.fused_expand(pay, q, mask, th, kk)
    return d, torch.gather(nb_i, 1, i.long())


def _library_pca(torch, ref, adj, low, c_w, exp, q, th, kk):
    """The pca expand as library calls: the gathers, distances, mask,
    stable sort, id gather."""
    nb_i, mask, pay = ref.popped_rows(adj, low, c_w, exp)
    d = ((pay - q[:, None]) ** 2).sum(-1)
    d = torch.where(mask & (d < th[:, None]), d, 3.4e38)
    sd, o = torch.sort(d, dim=1, stable=True)
    return sd[:, :kk], torch.gather(nb_i, 1, o[:, :kk])


def _pca_rows_bytes(B, W, M0, dl, kk, gated: int, rows: int,
                    itemsize: int = 4) -> int:
    """Bytes the expand must move: per row its popped ids and gates, q,
    the threshold and the k outputs; per gated popped node its adjacency
    row (``gated`` of the B * W; a gated-off node loads nothing), and
    ``rows`` payload rows of dl elements of ``itemsize`` bytes; plus node
    0's adjacency row once (the gated-off slots' ids)."""
    return gated * M0 * 4 + rows * dl * itemsize + M0 * 4 \
        + B * (W * 5 + dl * 4 + 4 + kk * 8)


def _pca_needed_rows(torch, adj, c_w, exp) -> int:
    """Payload rows the pca expand needs: the slots of gated popped
    nodes (a -1 pop is node 0) whose neighbour is not -1; any other
    slot is INF whatever its payload."""
    nb = adj.index_select(0, c_w.clamp(min=0).reshape(-1))
    return int(((nb.reshape(*c_w.shape, -1) >= 0) & exp[..., None]).sum())


def check_pca_rows(torch, np, rng, T) -> dict:
    """fused_expand_rows (the pca expand with its row gathers) on a
    50,000-node layer at PCA_ROWS_CASES: bit for bit (raw f32 bits)
    against its plain version, the unfused path it replaces (index_select,
    the fused_expand kernel, the id gather) and the library route on
    integer rows, and against the unfused path on float rows (the same
    sums in the same order). Timed rows: kernel, unfused as launched,
    plain, library; the bound counts the payload rows the function needs
    (a gated node's slots whose neighbour is not -1), with every gated
    node's whole [M0, dl] block (what the kernel stages) as
    ``bound_gated_blocks_ms`` and every popped node's as
    ``bound_all_rows_ms``. The bf16 cases read the same layers rounded to
    bf16 (integer rows exactly), one device kernel a call."""
    from repro_torch.bench.kernel_footprint import (bound_ms,
                                                    device_kernels,
                                                    graph_ms)
    from repro_torch.kernels import ops, ref
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    N, out = 50_000, {}
    layers = {integer: T(*_pca_layer(np, rng, N, 32, 15, integer))
              for integer in (True, False)}
    for B, W, M0, dl, k, timed, dt in PCA_ROWS_CASES:
        shape, kk = (B, W, M0, dl, k, dt), W * k
        for integer in (True, False):
            adj, low = layers[integer]
            if dt == "bf16":
                low = low.to(torch.bfloat16)
            C_i, exp, q, heap = T(*_pca_pops(np, rng, B, W, N, dl, integer))
            c_w, th = C_i[:, :W], heap[:, -1]
            got = ops.fused_expand_rows(adj, low, c_w, exp, q, th, kk)
            checks = [("unfused", _unfused_pca(torch, ops, ref, adj, low,
                                               c_w, exp, q, th, kk))]
            if integer:
                checks += [
                    ("plain", ref.fused_expand_rows_ref(adj, low, c_w, exp, q,
                                                        th, kk)),
                    ("library", _library_pca(torch, ref, adj, low, c_w, exp,
                                             q, th, kk))]
            for name, want in checks:
                torch.cuda.synchronize()
                need(torch.equal(bits(got[0]), bits(want[0]))
                     and torch.equal(got[1], want[1]),
                     f"fused_expand_rows{shape} (integer={integer}): differs "
                     f"from the {name} path")
        if not timed:
            continue
        gated, rows = int(exp.sum()), _pca_needed_rows(torch, adj, c_w, exp)
        nops = rows * dl * 3 + B * (W * M0) ** 2
        isz = low.element_size()
        calls = device_kernels(lambda: ops.fused_expand_rows(
            adj, low, c_w, exp, q, th, kk))
        need(calls == 1, f"fused_expand_rows{shape}: {calls} device "
             "kernels a call")
        key = shape[:-1] if dt == "f32" else shape
        out[("fused_expand_rows", key)] = dict(
            max_abs_err=0.0,
            ms=graph_ms(lambda: ops.fused_expand_rows(adj, low, c_w, exp, q,
                                                      th, kk)),
            unfused_ms=graph_ms(lambda: _unfused_pca(
                torch, ops, ref, adj, low, c_w, exp, q, th, kk)),
            plain_ms=graph_ms(lambda: ref.fused_expand_rows_ref(
                adj, low, c_w, exp, q, th, kk)),
            library_ms=graph_ms(lambda: _library_pca(
                torch, ref, adj, low, c_w, exp, q, th, kk)),
            bound=bound_ms(_pca_rows_bytes(B, W, M0, dl, kk, gated, rows,
                                           isz), nops),
            bound_gated_blocks_ms=bound_ms(_pca_rows_bytes(
                B, W, M0, dl, kk, gated, gated * M0, isz), nops)[0],
            bound_all_rows_ms=bound_ms(_pca_rows_bytes(
                B, W, M0, dl, kk, B * W, B * W * M0, isz), nops)[0],
            gated_share=gated / (B * W), needed_row_share=rows / (B * W * M0),
            device_kernels=calls)
    return out


# the stacked kernels at the stream phase's sharded bank: P shards of
# STACKED_N nodes (the shards of a 75,000-point build, the smoke's size
# when these rows were first timed, kept so they stay comparable), S =
# STREAM_SLOTS
# rows each, W = 1, M0 = 32; pca dl = 15 (f32 and bf16), pq S = 16, the
# gated fold at ef 10 with the shards' tombstone words
STACKED_P, STACKED_N = 4, 18_750


def check_stacked(torch, np, rng, T) -> dict:
    """The three per-trip kernels on stacked leaves ([P, N, ...], the B =
    P * S rows shard-major: the sharded slotted pass over
    ``core.distributed.stacked_db_view``), at the stream phase's sharded
    bank: ``fused_expand_rows`` on f32 and bf16 rows and
    ``pq_expand_rows`` on integer data, the gated ``trip_fold`` on
    integer and float data; each bit for bit (raw f32 bits) against its
    plain version, against P per-shard launches on the same leaves and
    (the fold on float data, which has no -0.0) against the library
    route; each stacked call one device kernel. Timed: the stacked
    launch (``ms``), the P per-shard launches the host loop made before
    (``per_shard_ms``), plain, library, and the bound on this data."""
    from repro_torch.bench.kernel_footprint import (bound_ms,
                                                    device_kernels,
                                                    graph_ms)
    from repro_torch.core.search_torch import pack_bitmap
    from repro_torch.kernels import ops, ref
    P, R, N, M0, W = STACKED_P, STREAM_SLOTS, STACKED_N, 32, 1
    B = P * R
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    rows = lambda p: slice(p * R, (p + 1) * R)
    cat = lambda outs: tuple(map(torch.cat, zip(*outs)))
    out = {}

    def same(name, got, wants):
        torch.cuda.synchronize()
        for what, want in wants:
            need(all(torch.equal(bits(g), bits(w))
                     for g, w in zip(got, want) if w is not None),
                 f"{name}: the stacked launch differs from {what}")

    def one_kernel(name, fn):
        calls = device_kernels(fn)
        need(calls == 1, f"{name}: {calls} device kernels a stacked call")
        return calls

    # -- fused_expand_rows --
    adj, low = T(*(np.stack(a) for a in zip(
        *(_pca_layer(np, rng, N, M0, 15, True) for _ in range(P)))))
    C_i, exp, q, heap = T(*_pca_pops(np, rng, B, W, N, 15, True))
    c_w, th, kk = C_i[:, :W], heap[:, -1], W * 16
    for dt in ("f32", "bf16"):
        pay = low.to(torch.bfloat16) if dt == "bf16" else low
        name = f"fused_expand_rows{('stacked', P, R, W, M0, 15, 16, dt)}"
        run = lambda: ops.fused_expand_rows(adj, pay, c_w, exp, q, th, kk)
        per = lambda: [ops.fused_expand_rows(
            adj[p], pay[p], c_w[rows(p)], exp[rows(p)], q[rows(p)],
            th[rows(p)], kk) for p in range(P)]
        plain = lambda: ref.fused_expand_rows_ref(adj, pay, c_w, exp, q, th,
                                                  kk)
        lib = lambda: _library_pca(torch, ref, adj, pay, c_w, exp, q, th, kk)
        same(name, run(), [("the plain version", plain()),
                           ("the per-shard launches", cat(per())),
                           ("the library route", lib())])
        calls = one_kernel(name, run)
        gated = int(exp.sum())
        needed = int(ref.popped_rows(adj, pay, c_w, exp)[1].sum())
        out[("fused_expand_rows", ("stacked", P, R, W, M0, 15, 16, dt))] = \
            dict(max_abs_err=0.0, ms=graph_ms(run), per_shard_ms=graph_ms(per),
                 plain_ms=graph_ms(plain), library_ms=graph_ms(lib),
                 bound=bound_ms(_pca_rows_bytes(B, W, M0, 15, kk, gated,
                                                needed, pay.element_size())
                                + (P - 1) * M0 * 4,
                                needed * 15 * 3 + B * (W * M0) ** 2),
                 device_kernels=calls)
    del adj, low, pay

    # -- pq_expand_rows --
    S = 16
    cases = [_rows_case(np, rng, R, W, M0, S, N) for _ in range(P)]
    adj, codes = T(np.stack([c[0] for c in cases]),
                   np.stack([c[1] for c in cases]))
    C_i, exp, flat, heap = T(*(np.concatenate([c[i] for c in cases])
                               for i in range(2, 6)))
    lut = flat[:, :S * 256].reshape(B, S, 256).contiguous()
    c_w, th, kk = C_i[:, :W], heap[:, -1], W * 16
    name = f"pq_expand_rows{('stacked', P, R, W, M0, S, 16)}"
    run = lambda: ops.pq_expand_rows(adj, codes, c_w, exp, lut, th, kk)
    per = lambda: [ops.pq_expand_rows(adj[p], codes[p], c_w[rows(p)],
                                      exp[rows(p)], lut[rows(p)],
                                      th[rows(p)], kk) for p in range(P)]
    plain = lambda: ref.pq_expand_rows_ref(adj, codes, c_w, exp, lut, th, kk)

    def lib():
        nb_i, mask, pay = ref.popped_rows(adj, codes, c_w, exp)
        d = torch.gather(lut, 2, pay.long().transpose(1, 2)).sum(1)
        d = torch.where(mask & (d < th[:, None]), d, 3.4e38)
        sd, o = torch.sort(d, dim=1, stable=True)
        return sd[:, :kk], torch.gather(nb_i, 1, o[:, :kk])

    same(name, run(), [("the plain version", plain()),
                       ("the per-shard launches", cat(per())),
                       ("the library route", lib())])
    calls = one_kernel(name, run)
    # bytes as pq_expand_rows' row: the gated nodes' adjacency rows (and
    # each shard's node 0 once), the codes of the slots whose neighbour
    # is not -1, the table entries those codes name, the per-row words
    M = W * M0
    _, used, pay = ref.popped_rows(adj, codes, c_w, exp)
    hits = torch.zeros((B, S, 256), dtype=torch.int32, device=adj.device)
    hits.scatter_add_(2, pay.long().transpose(1, 2),
                      used.int()[:, None, :].expand(B, S, M))
    nbytes = int((hits > 0).sum()) * 4 + int(exp.sum()) * M0 * 4 \
        + P * M0 * 4 + int(used.sum()) * S + B * (W * 5 + 4 + kk * 8)
    out[("pq_expand_rows", ("stacked", P, R, W, M0, S, 16))] = dict(
        max_abs_err=0.0, ms=graph_ms(run), per_shard_ms=graph_ms(per),
        plain_ms=graph_ms(plain), library_ms=graph_ms(lib),
        bound=bound_ms(nbytes, int(used.sum()) * S + B * M * M),
        device_kernels=calls)
    del adj, codes, pay, hits

    # -- the gated fold, the shards' own tombstone words --
    ef, k, kk = 10, 16, 16
    cap = max(ef + kk, 8)
    words, = T(np.stack([pack_bitmap(rng.random(N) < 0.01)
                         for _ in range(P)]))
    for integer in (True, False):
        F_d, F_i, C_d, C_i, Cp, dh, cand, kv, _ = T(
            *_fold_case(np, rng, B, ef, cap, k, kk, integer, n_ids=N))
        ef_eff, pop = T(rng.integers(1, ef + 1, B).astype(np.int32),
                        rng.random(B) < 0.6)
        args = (F_d, F_i, C_d, C_i, W, Cp, dh, cand, kv, words)
        gates = dict(ef_eff=ef_eff, pop=pop)
        name = f"trip_fold_gated{('stacked', P, R, ef, cap, k, kk, W)}"
        run = lambda: ops.trip_fold(*args, **gates)
        per = lambda: [ops.trip_fold(
            *(t[rows(p)] for t in args[:4]), W,
            *(t[rows(p)] for t in args[5:9]), words[p],
            **{n: t[rows(p)] for n, t in gates.items()}) for p in range(P)]
        plain = lambda: ref.trip_fold_ref(*args, **gates)
        lib = lambda: _library_fold(torch, *args, **gates)
        wants = [("the plain version", plain()),
                 ("the per-shard launches", cat(per()))]
        if not integer:     # no -0.0: a radix sort may order it
            wants.append(("the library route", lib()))
        same(name, run(), wants)
    calls = one_kernel(name, run)
    nbytes, nops = _fold_cost(B, ef, cap, k, kk, True, True, words.numel())
    out[("trip_fold_gated", ("stacked", P, R, ef, cap, k, kk, W))] = dict(
        max_abs_err=0.0, ms=graph_ms(run), per_shard_ms=graph_ms(per),
        plain_ms=graph_ms(plain), library_ms=graph_ms(lib),
        bound=bound_ms(nbytes + B * 5, nops), device_kernels=calls)
    return out


def check_wide_tiers(torch, np, rng, T) -> dict:
    """The tiers past the main path's widths against the plain versions
    (exact: integer inputs, or no arithmetic): the expands at M = 160 and
    256 (a block per row), fused_filter at M = 60,000 (a global scratch
    row), merge_sorted at 12,816 (opted-in shared memory) and 60,100
    elements (global), ksort_l at 13,000 and 60,000. Checked, not timed;
    returns each case's tier."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels._launch import smem_optin
    from repro_torch.kernels.fused_filter import expand_plan
    from repro_torch.kernels.ksort_l import ksort_plan
    from repro_torch.kernels.merge_sorted import merge_plan
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    optin = smem_optin(torch.cuda.current_device())
    tiers = {}
    for M in (160, 256):
        x, q, v, th = T(*_expand_case(np, rng, 512, M, 15, True))
        c, flat, v2, th2 = T(*_pq_case(np, rng, 512, M, 16, True))
        lut = flat[:, :16 * 256].reshape(512, 16, 256)
        for name, got, want in (
                ("fused_expand", ops.fused_expand(x, q, v, th, 40),
                 ref.fused_expand_ref(x, q, v, th, 40)),
                ("fused_filter", ops.fused_filter(x, q, 40),
                 ref.fused_filter_ref(x, q, 40)),
                ("pq_adc_expand", ops.pq_adc_expand(c, lut, v2, th2, 40),
                 ref.pq_adc_expand_ref(c, lut, v2, th2, 40))):
            torch.cuda.synchronize()
            need(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                 f"{name} at M={M}: differs from the plain version")
            tiers[f"{name} M={M}"] = expand_plan(M, optin)["tier"]
    x, q = T(rng.integers(0, 8, (2, 60000, 2)).astype(np.float32),
             rng.integers(0, 8, (2, 2)).astype(np.float32))
    got, want = ops.fused_filter(x, q, 9), ref.fused_filter_ref(x, q, 9)
    torch.cuda.synchronize()
    need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
         "fused_filter at M=60000: differs from the plain version")
    tiers["fused_filter M=60000"] = expand_plan(60000, optin)["tier"]
    for Na, Nb, k in ((12800, 16, 300), (60000, 100, 64)):
        a, ia, b, ib = T(*_merge_case(np, rng, 4, Na, Nb, True))
        got = ops.merge_topk_sorted(a, ia, b, ib, k)
        want = ref.merge_topk_sorted_ref(a, ia, b, ib, k)
        torch.cuda.synchronize()
        need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
             f"merge_sorted at Na+Nb={Na + Nb}: differs from the plain "
             "version")
        tiers[f"merge_sorted N={Na + Nb}"] = merge_plan(Na, Nb,
                                                        optin)["tier"]
    for M, k in ((13000, 20), (60000, 7)):
        (d,) = T(_ksort_case(np, rng, 4, M, False))
        got, want = ops.ksort_l(d, k), ref.ksort_l_ref(d, k)
        torch.cuda.synchronize()
        need(torch.equal(bits(got[0]), bits(want[0]))
             and torch.equal(got[1], want[1]),
             f"ksort_l at M={M}: differs from the plain version")
        tiers[f"ksort_l M={M}"] = ksort_plan(M, optin)["tier"]
    return tiers


def _library_filter(torch, x, q, k):
    """fused_filter as library calls: distances, stable sort, slice."""
    d = ((x - q[:, None]) ** 2).sum(-1)
    return [t[:, :k] for t in torch.sort(d, dim=1, stable=True)]


def check_fused_filter(torch, np, rng, T) -> dict:
    """fused_filter at the footprint bench's [64, 32, 15] k=16 (timed on
    f32 and bf16 rows, one device kernel a call) and the search's widths
    [1024, 32, 15] k=16 (timed in f32), then edge rows (k = M, k = 1, M
    = 100 over four lanes, B = 1, bf16 at dl = 16), against the plain
    version:
    values and indices exact on integer inputs (ties by index: row 1 has
    all-equal distances); on float inputs distances to rtol 1e-5 / atol
    1e-3 and each returned index's plain distance equal to the returned
    one within the same tolerance (a near-tie may order two indices
    either way when the f32 sums round apart)."""
    from repro_torch.bench.kernel_footprint import (bound_ms,
                                                    device_kernels,
                                                    fused_filter_cost,
                                                    graph_ms)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels._launch import smem_optin
    from repro_torch.kernels.fused_filter import fused_filter_plan
    out = {}
    for B, M, dl, k, timed, dt in [
            (64, 32, 15, 16, True, "f32"), (64, 32, 15, 16, True, "bf16"),
            (1024, 32, 15, 16, True, "f32"), (1024, 32, 15, 16, False, "bf16"),
            (64, 32, 15, 32, False, "f32"), (64, 32, 15, 1, False, "f32"),
            (8, 100, 4, 7, False, "f32"), (1, 33, 15, 33, False, "f32"),
            (7, 100, 16, 9, False, "bf16")]:
        errs = []
        for integer in (True, False):
            if integer:
                xn = rng.integers(0, 8, (B, M, dl)).astype(np.float32)
                qn = rng.integers(0, 8, (B, dl)).astype(np.float32)
                if B >= 2:
                    xn[1] = xn[1, :1]
            else:
                xn = rng.standard_normal((B, M, dl)).astype(np.float32)
                qn = rng.standard_normal((B, dl)).astype(np.float32)
            x, q = T(xn, qn)
            if dt == "bf16":
                x = x.to(torch.bfloat16)
            gd, gi = ops.fused_filter(x, q, k)
            wd, wi = ref.fused_filter_ref(x, q, k)
            torch.cuda.synchronize()
            errs.append(float((gd - wd).abs().max()))
            shape = (B, M, dl, k, dt)
            if integer:
                need(torch.equal(gd, wd) and torch.equal(gi, wi),
                     f"fused_filter{shape}: differs on exact inputs")
            else:
                need(torch.allclose(gd, wd, rtol=1e-5, atol=1e-3),
                     f"fused_filter{shape}: max abs err {errs[-1]}")
                dd = ref.dist_l_ref(x, q).gather(1, gi.long())
                need(torch.allclose(dd, gd, rtol=1e-5, atol=1e-3),
                     f"fused_filter{shape}: an index's distance differs")
        if not timed:
            continue
        cost = fused_filter_cost(B, M, dl, k, x.element_size())
        calls = device_kernels(lambda: ops.fused_filter(x, q, k))
        need(calls == 1, f"fused_filter{shape}: {calls} device kernels a "
             "call")
        key = (B, M, dl, k) if dt == "f32" else (B, M, dl, k, "bf16")
        out[("fused_filter", key)] = dict(
            max_abs_err=max(errs),
            ms=graph_ms(lambda: ops.fused_filter(x, q, k)),
            plain_ms=graph_ms(lambda: ref.fused_filter_ref(x, q, k)),
            library_ms=graph_ms(lambda: _library_filter(torch, x, q, k)),
            bound=bound_ms(cost["bytes"], cost["ops"]),
            plan=fused_filter_plan(
                M, dl, x.data_ptr() % (4 * x.element_size()) == 0,
                smem_optin(x.device)),
            device_kernels=calls)
    return out


# flash_attention rows: (label, B, H, KV, S, T, d, dtype, causal, window,
# timed, plain head by head); KV < H is grouped-query attention (query
# head h reads kv head h // (H // KV)). Model widths from
# src/repro/configs: starcoder2-3b (24 heads, expanded to 24 kv heads,
# d=128; and at the LM phase's prefill, B=8, S=1024, over its 2 kv
# heads), mixtral-8x7b (32 heads, d=128, sliding window 4096) and
# recurrentgemma-9b's local attention (16 heads, MQA expanded, d=256,
# window 2048). The lm_families phase's shapes (rows 8c-8f): recurrentgemma's
# local MQA (16 heads over 1, d=256, window 2048) at its decode-against-
# prefill length 2,049, whisper's encoder (1,500 frames, non-causal) and
# cross-attention (64 tokens against 1,500 frames), qwen3's 64 heads over 4
# (G = 16). Edge rows check, not timed.
FLASH_CASES = [
    ("bench", 1, 4, 4, 512, 512, 64, "bf16", True, 0, True, False),
    ("starcoder2-3b prefill", 1, 24, 24, 4096, 4096, 128, "bf16", True, 0,
     True, False),
    ("starcoder2-3b chunked prefill", 1, 24, 24, 512, 4096, 128, "bf16",
     True, 0, True, False),
    ("starcoder2-3b lm prefill gqa", 8, 24, 2, 1024, 1024, 128, "bf16", True,
     0, True, False),
    ("mixtral-8x7b window", 1, 32, 32, 8192, 8192, 128, "bf16", True, 4096,
     True, True),
    ("recurrentgemma-9b local", 1, 16, 16, 8192, 8192, 256, "bf16", True,
     2048, True, True),
    ("f32 window", 2, 2, 2, 256, 256, 64, "f32", True, 64, False, False),
    ("S=1", 2, 3, 3, 1, 300, 64, "bf16", True, 0, False, False),
    ("S>T", 1, 2, 2, 200, 100, 64, "f32", True, 0, False, False),
    ("S>T bf16", 1, 2, 2, 130, 70, 128, "bf16", True, 0, False, False),
    ("ragged", 1, 2, 2, 77, 77, 128, "f32", True, 0, False, False),
    ("ragged chunk", 1, 2, 2, 100, 1000, 64, "bf16", True, 0, False, False),
    ("window >= T", 1, 2, 2, 300, 300, 64, "f32", True, 5000, False, False),
    ("non-causal", 1, 2, 2, 128, 200, 64, "f32", False, 0, False, False),
    ("non-causal window", 1, 2, 2, 130, 130, 64, "bf16", False, 30, False,
     False),
    ("d=40", 1, 2, 2, 96, 96, 40, "bf16", True, 0, False, False),
    ("d=30", 1, 2, 2, 70, 90, 30, "f32", True, 0, False, False),
    ("d=256", 1, 2, 2, 128, 128, 256, "f32", True, 0, False, False),
    ("d=256 window mid-tile", 1, 2, 2, 300, 300, 256, "bf16", True, 100,
     False, False),
    ("d=96", 1, 2, 2, 128, 200, 96, "bf16", True, 0, False, False),
    ("d=30 bf16", 1, 2, 2, 70, 90, 30, "bf16", True, 0, False, False),
    ("split ragged", 1, 4, 4, 100, 1000, 128, "bf16", True, 0, False, False),
    ("gqa G=4 f32", 2, 8, 2, 130, 130, 64, "f32", True, 0, False, False),
    ("gqa G=12 split", 1, 24, 2, 300, 300, 128, "bf16", True, 0, False,
     False),
    ("gqa G=4 S>T window", 1, 8, 2, 150, 100, 128, "bf16", True, 40, False,
     False),
    ("recurrentgemma-9b local mqa", 4, 16, 1, 2049, 2049, 256, "bf16", True,
     2048, True, False),
    ("whisper-medium encoder", 4, 16, 16, 1500, 1500, 64, "bf16", False, 0,
     True, False),
    ("whisper-medium cross", 4, 16, 16, 64, 1500, 64, "bf16", False, 0, True,
     False),
    ("qwen3-moe lm prefill gqa G=16", 8, 64, 4, 1024, 1024, 128, "bf16",
     True, 0, True, False),
    # the mesh_lm phase's prefill: one data row's 4 prompts a launch
    ("mixtral-8x7b mesh prefill gqa", 4, 32, 8, 1024, 1024, 128, "bf16",
     True, 4096, True, False),
]
# decode_attention rows: (label, B, H, KV, T, d, dtype, lengths, timed);
# starcoder2-3b at its widths (24 kv heads, expanded) with empty, short,
# ragged, full and past-the-end lengths, and at the LM phase's last
# decode step (B=8, T=1,056 over its 2 kv heads); the lm_families phase's
# (rows 9c-9e): recurrentgemma's full ring (16 heads over 1, d=256, T =
# 2,048), whisper's cross-attention (T = 1,500 frames) and qwen3's last
# step (64 heads over 4, T = 1,040)
DECODE_CASES = [
    ("bench", 1, 4, 4, 4096, 64, "bf16", [4096], True),
    ("starcoder2-3b", 8, 24, 24, 16384, 128, "bf16",
     [0, 1, 1000, 8191, 16384, 16384 + 7, 5, 12345], True),
    ("starcoder2-3b lm decode gqa", 8, 24, 2, 1056, 128, "bf16", [1056] * 8,
     True),
    ("f32", 3, 4, 4, 300, 64, "f32", [0, 150, 300], False),
    ("ragged", 2, 3, 3, 1000, 128, "bf16", [999, 129], False),
    ("d=40", 2, 2, 2, 257, 40, "f32", [257, 1], False),
    ("d=256", 2, 2, 2, 600, 256, "bf16", [600, 300], False),
    ("d=30", 2, 2, 2, 100, 30, "bf16", [100, 64], False),
    ("gqa G=4 f32", 3, 8, 2, 300, 64, "f32", [0, 150, 300], False),
    ("gqa G=12", 2, 24, 2, 2000, 128, "bf16", [0, 1999], False),
    ("recurrentgemma-9b ring mqa", 4, 16, 1, 2048, 256, "bf16", [2048] * 4,
     True),
    ("whisper-medium cross", 4, 16, 16, 1500, 64, "bf16", [1500] * 4, True),
    ("qwen3-moe lm decode gqa G=16", 8, 64, 4, 1040, 128, "bf16",
     [1040] * 8, True),
    # the mesh_lm phase's last decode step: its one computing unit's 8
    # rows (an MoE decode pools the whole batch, as the reference's)
    ("mixtral-8x7b mesh decode gqa", 8, 32, 8, 1040, 128, "bf16",
     [1040] * 8, True),
]
# the JAX suite's attention tolerances (tests/test_kernels.py): the PV
# products round at other places in the kernel and the plain version.
# At model widths the outputs are ~0.01-0.04, so each check also holds
# the kernel to kernel_footprint.attention_excess <= 1, a tolerance that
# scales with each row's RMS.
ATTN_TOL = {"f32": 2e-3, "bf16": 0.05}


def check_attention(torch, np, rng) -> dict:
    """flash_attention and decode_attention against their plain versions
    on the card (allclose at ``ATTN_TOL``, ``attention_excess`` <= 1, rows
    that see no key exactly 0), and at the timed rows kernel, plain and
    library times with the bound. The library yardstick is
    ``scaled_dot_product_attention`` with an explicit boolean mask (its
    ``is_causal`` aligns to the top left when S != T; the reference
    aligns to the end); the port never calls it. Inputs are standard
    normal, drawn on the card from a seed. Where the bf16 kernel splits a
    row's kv range (``split_plan`` > 1), the unsplit launch is checked and
    timed beside it (``unsplit_ms``). Grouped-query rows (KV < H) hand
    the library its kv heads expanded, outside the timed call."""
    import torch.nn.functional as F
    from repro_torch.bench.kernel_footprint import (
        PEAK_BF16_OPS_PER_S, PEAK_F32_OPS_PER_S, attention_excess, bound_ms,
        decode_cost, device_kernels, flash_cost, graph_ms)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import _align as decode_align
    from repro_torch.kernels.decode_attention import split_plan as decode_plan
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     split_plan)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    peak = {"f32": PEAK_F32_OPS_PER_S, "bf16": PEAK_BF16_OPS_PER_S}
    randn = lambda shape, dt: torch.randn(shape, generator=gen, device=dev,
                                          dtype=torch.float32).to(dts[dt])
    out, excess = {}, {}
    for (label, B, H, KV, S, T, d, dt, causal, window, timed,
         by_head) in FLASH_CASES:
        q = randn((B, H, S, d), dt)
        k, v = randn((B, KV, T, d), dt), randn((B, KV, T, d), dt)
        if by_head:     # bounds the plain version's [S, T] logits (KV == H)
            plain = lambda: torch.cat([ref.flash_attention_ref(
                q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1], causal=causal,
                window=window) for h in range(H)], 1)
        else:
            plain = lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                    window=window)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = ATTN_TOL[dt]
        shape = (B, H, KV, S, T, d, dt, causal, window)
        need(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
             f"flash_attention {label} {shape}: max abs err {err}")
        ex = excess["flash " + label] = attention_excess(got, want)
        need(ex <= 1, f"flash_attention {label} {shape}: error {ex} "
             f"times the row-scaled tolerance (max abs {err})")
        blind = max(S - T, 0) if causal else 0
        need(bool((got[:, :, :blind] == 0).all()),
             f"flash_attention {label}: a row that sees no key is not 0")
        del got, want
        if not timed:
            continue
        mask = ref.attention_mask(S, T, causal, window, device=dev)
        small = B * H * S * T <= 1 << 22
        reps = {} if small else {"reps": 2, "replays": 3}
        cost = flash_cost(B, H, S, T, d, 2 if dt == "bf16" else 4, causal,
                          window, kv_heads=KV)
        ke, ve = (t.repeat_interleave(H // KV, 1) for t in (k, v))
        r = out[("flash_attention", shape)] = dict(
            label=label, max_abs_err=err, excess=ex,
            ms=graph_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window), **reps),
            plain_ms=graph_ms(plain, **reps),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q, ke, ve, attn_mask=mask), **reps),
            bound=bound_ms(cost["bytes"], cost["ops"], peak[dt]),
            flops=cost["ops"])
        r["tflops"] = cost["ops"] / r["ms"] / 1e9
        r["ms_over_library"] = r["ms"] / r["library_ms"]
        r["n_split"] = split_plan(B, H, S, T, d, causal, window, torch.cuda.
                                  get_device_properties(0)
                                  .multi_processor_count) if dt == "bf16" \
            else 1
        if r["n_split"] > 1:
            one = lambda: flash_attention_cuda(q, k, v, causal=causal,
                                               window=window, n_split=1)
            ex1 = excess["flash " + label + " unsplit"] = attention_excess(
                one(), plain())
            need(ex1 <= 1, f"flash_attention {label} {shape} unsplit: error "
                 f"{ex1} times the row-scaled tolerance")
            r["unsplit_ms"] = graph_ms(one, **reps)
        del q, k, v, ke, ve, mask
        torch.cuda.empty_cache()
    for label, B, H, KV, T, d, dt, lengths, timed in DECODE_CASES:
        q, k, v = randn((B, H, d), dt), randn((B, KV, T, d), dt), \
            randn((B, KV, T, d), dt)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = ops.decode_attention(q, k, v, ln)
        want = ref.decode_attention_ref(q, k, v, ln)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = ATTN_TOL[dt]
        shape = (B, H, KV, T, d, dt)
        need(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
             f"decode_attention {label} {shape}: max abs err {err}")
        ex = excess["decode " + label] = attention_excess(got, want)
        need(ex <= 1, f"decode_attention {label} {shape}: error {ex} "
             f"times the row-scaled tolerance (max abs {err})")
        need(bool((got[ln <= 0] == 0).all()),
             f"decode_attention {label}: a length-0 row is not 0")
        if not timed:
            continue
        mask = (torch.arange(T, device=dev)[None, :] < ln[:, None])
        cost = decode_cost(H, d, 2 if dt == "bf16" else 4, lengths, T,
                           kv_heads=KV)
        ke, ve = (t.repeat_interleave(H // KV, 1) for t in (k, v))
        kernels = device_kernels(lambda: ops.decode_attention(q, k, v, ln))
        need(kernels == 1, f"decode_attention {label}: one call ran "
             f"{kernels} device operations, not one kernel")
        out[("decode_attention", shape)] = dict(
            label=label, lengths=lengths, max_abs_err=err, excess=ex,
            plan=decode_plan(B * H, T, d, k.element_size(), sms,
                             decode_align(k, v)),
            device_kernels=kernels,
            ms=graph_ms(lambda: ops.decode_attention(q, k, v, ln)),
            plain_ms=graph_ms(lambda: ref.decode_attention_ref(q, k, v, ln)),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], ke, ve, attn_mask=mask[:, None, None])),
            bound=bound_ms(cost["bytes"], cost["ops"], peak[dt]))
        del q, k, v, ke, ve
        torch.cuda.empty_cache()
    emit({"phase": "attention_check", "excess_max": max(excess.values()),
          "excess": excess})
    return out


def run_footprint(torch) -> dict:
    """The kernel-footprint bench on the card (``repro_torch.bench.
    kernel_footprint``): its six CSV rows, then one JSON line. First each
    row's op is held against its plain version on the very tensors the
    bench times (dist_l, dist_h and fused_filter's distances to rtol
    1e-5 / atol 1e-3, ksort_l and fused_filter's indices exact — the
    bench's normal inputs have no ties —, attention at
    ``attention_excess`` <= 1). Launch counts are reset after that, just
    before the timed run, and read just after; each of the six kernels
    must have launched. The shared memory the bench reports is held
    against the kernels' own figures: the attention kernels' C functions
    (decode at the plan of the bench's shape on this card) and
    ``ksort_plan`` at the card's opt-in maximum."""
    import ctypes
    from repro_torch.bench import kernel_footprint as kf
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels._launch import smem_optin
    from repro_torch.kernels.decode_attention import split_plan
    from repro_torch.kernels.ksort_l import ksort_plan
    calls = kf.make_calls(torch.device("cuda"))
    errs = {}
    for name, (fn, plain) in calls.items():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        gd, gi = got if isinstance(got, tuple) else (got, None)
        wd, wi = want if isinstance(want, tuple) else (want, None)
        errs[name] = float((gd.float() - wd.float()).abs().max())
        if "attention" in name:
            errs[name + ":excess"] = kf.attention_excess(gd, wd)
            need(errs[name + ":excess"] <= 1, f"footprint: {name} is "
                 f"{errs[name + ':excess']} times the row-scaled tolerance")
        else:
            need(torch.allclose(gd, wd, rtol=1e-5, atol=1e-3),
                 f"footprint: {name} max abs err {errs[name]} vs plain")
        if gi is not None:
            need(torch.equal(gi, wi), f"footprint: {name} indices differ")
    ops.reset_launch_counts()
    rows = kf.run(calls)
    counts = ops.launch_counts()
    kf.emit(rows)
    for row in rows:
        name = row["name"].split("/", 1)[1]
        need(counts[name] > 0, f"footprint: {name} never launched")
        if name == "ksort_l":
            M = row["shape"][1]
            plan = ksort_plan(M, smem_optin(torch.cuda.current_device()))
            need(plan["smem"] == row["smem_per_block_bytes"],
                 f"footprint: ksort_l shared memory {plan['smem']} != the "
                 f"bench's {row['smem_per_block_bytes']}")
        if name in ("flash_attention", "decode_attention"):
            # both attention rows are bf16: the kernels' figure for dtype 1
            fn = getattr(_build.load(name), f"{name}_smem_bytes")
            args = (row["shape"][-1], 1)
            if name == "decode_attention":
                Bq, H, T, d = row["shape"]
                plan = split_plan(Bq * H, T, d, 2, torch.cuda.
                                  get_device_properties(0)
                                  .multi_processor_count)
                args += (plan["tile"], plan["stages"])
            fn.argtypes = [ctypes.c_int] * len(args)
            fn.restype = ctypes.c_int
            need(fn(*args) == row["smem_per_block_bytes"],
                 f"footprint: {name} shared memory {fn(*args)} "
                 f"!= the bench's {row['smem_per_block_bytes']}")
    return {"phase": "footprint", "rows": rows, "launches": counts,
            "max_abs_err_vs_plain": errs}


# --------------------------- main-path phases ------------------------------

def run_build(torch, np, n: int, shards: int, seed: int, device: str):
    """The ``shards`` wave graphs over ``shard_bounds(n, shards)``, shard
    s with seed ``seed + s`` (as ``build_sharded`` builds them). Returns
    (x, graphs, per-shard lines, the build line); launch counts cover
    all the shard builds."""
    from repro_torch.configs.sift1m_phnsw import CONFIG
    from repro_torch.core.build import graph_invariants
    from repro_torch.core.distributed import shard_bounds
    from repro_torch.core.graph import build_hnsw
    from repro_torch.data.vectors import make_sift_like
    from repro_torch.kernels import ops
    import dataclasses
    cfg = dataclasses.replace(CONFIG, n_points=n)
    x = make_sift_like(n, seed=seed)
    timings, graphs, lines = {}, [], []
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for s, (a, b) in enumerate(shard_bounds(n, shards)):
        t1 = time.perf_counter()
        g = build_hnsw(x[a:b], cfg, seed=seed + s, device=device,
                       timings=timings)
        sync()
        secs = time.perf_counter() - t1
        inv = graph_invariants(g)
        graphs.append(g)
        lines.append({"phase": "build_shard", "shard": s, "rows": [a, b],
                      "seed": seed + s, "seconds": secs,
                      "vec_per_s": (b - a) / secs,
                      "invariants_ok": inv["ok"],
                      "violations": inv["violations"][:5],
                      "reachable_frac": inv["reachable_frac"],
                      "mean_degree": inv["mean_degree"],
                      "levels_max": int(g.levels.max()),
                      "entry": int(g.entry)})
    secs = time.perf_counter() - t0
    out = {"phase": "build", "n_points": n, "shards": shards,
           "seconds": secs, "vec_per_s": n / secs,
           "invariants_ok": all(ln["invariants_ok"] for ln in lines),
           "stage_seconds": timings, "launches": ops.launch_counts()}
    return x, graphs, lines, out


def recall_at_10(fi, gt) -> float:
    return float(sum(len(set(a[:10].tolist()) & set(b[:10].tolist()))
                     for a, b in zip(fi, gt)) / (10 * len(gt)))


def ground_truth(torch, x, q, k: int, device: str, deleted=None):
    """Exact top-k by squared L2 in f32, chunked matmul on ``device``;
    ``deleted`` ([n] bool) rows are never returned."""
    xt = torch.as_tensor(x, device=device)
    n2 = (xt * xt).sum(1)
    if deleted is not None:
        n2 = torch.where(torch.as_tensor(deleted, device=device),
                         torch.tensor(float("inf"), device=device), n2)
    out = []
    for i in range(0, len(q), 1024):
        qt = torch.as_tensor(q[i:i + 1024], device=device)
        d = n2[None, :] - 2.0 * (qt @ xt.T)
        out.append(torch.topk(d, k, dim=1, largest=False).indices.cpu())
    return torch.cat(out).numpy()


# the search arms at --n points: (name, filter kind, deferred,
# rerank_mult, recall@10 floor, pca storage dtype). The pca arms call
# search_batched with pca=; the pq floor guards against a broken table
# (the tracked 8k value is 0.923), the others are the sanity floor of the
# pca arm. The bf16 arms store layout (3) in bfloat16 and are held to
# their f32 arm (BF16_ARMS).
ARMS = [("pca", "pca", False, None, 0.80, "float32"),
        ("pca-deferred", "pca", True, 3, 0.80, "float32"),
        ("pq", "pq", False, None, 0.60, "float32"),
        ("cascade-deferred", "cascade", True, 2, 0.80, "float32"),
        ("pca-bf16", "pca", False, None, 0.80, "bfloat16"),
        ("pca-deferred-bf16", "pca", True, 3, 0.80, "bfloat16")]
# each bf16 arm's f32 twin: recall within BF16_RECALL of it (the
# reference's bar for bf16 storage), bytes_layout3 below BF16_BYTES of it,
# the same launches but for the trips the two arms' loops ran (a batch
# stops at the first all-done check, every 8 trips, and bf16 distances
# can latch a batch's queries a check earlier or later), and no cast
# from or to bf16 in a batch (check_bf16_arms)
BF16_ARMS = {"pca-bf16": "pca", "pca-deferred-bf16": "pca-deferred"}
BF16_RECALL, BF16_BYTES = 0.02, 0.75
# the pca arms' expand: one launch a trip, as trip_fold
EXPAND = "fused_expand_rows"


def per_trip_wrappers(deferred: bool) -> tuple:
    """The wrappers a pca search launches once a trip (and a fixed number
    of times a batch): the expand and the fold, and without deferral the
    Dist.H of each trip's winners (plus the entry point's, once a
    batch)."""
    return (EXPAND, "trip_fold") + (() if deferred else ("dist_h",))
# the kernels each arm's path must launch
ARM_KERNELS = {
    "pca": ("fused_expand_rows", "trip_fold", "dist_h"),
    "pca-deferred": ("fused_expand_rows", "trip_fold", "dist_h", "dist_l"),
    "pq": ("pq_expand_rows", "trip_fold", "dist_h"),
    "cascade-deferred": ("pq_expand_rows", "trip_fold", "dist_h",
                         "dist_l"),
}
ARM_KERNELS.update({arm: ARM_KERNELS[twin]
                    for arm, twin in BF16_ARMS.items()})
PORTED = ("fused_expand", "merge_sorted", "dist_h", "dist_l",
          "pq_adc_expand", "ksort_l", "fused_filter", "flash_attention",
          "decode_attention", "trip_fold", "fused_expand_rows",
          "pq_expand_rows")


def _profile_match(name: str, key: str) -> bool:
    """Each kernel's CUDA functions are named "{name}_kernel..."."""
    return f"{name}_kernel" in key


def train_filters(np, x, cfg, levels, pca) -> tuple:
    """The filters of every arm, fitted once on all points: the PCA, and
    ONE PQ codebook trained density-aware (weights ``level + 1``, the
    shard graphs' levels in shard order) at ``PQ_TRAIN_ITERS`` Lloyd
    iterations and shared by the pq and cascade arms, with the codes
    encoded once. Host numpy, the reference's arithmetic (so the
    codebook is bit-identical to ``repro.core.pq``'s)."""
    import dataclasses
    from repro_torch.core import filters
    cfg = dataclasses.replace(cfg, pq_train_iters=PQ_TRAIN_ITERS)
    t0 = time.perf_counter()
    fpq = filters.make_filter(dataclasses.replace(cfg, filter_kind="pq"),
                              x, seed=0, levels=levels)
    t1 = time.perf_counter()
    codes = fpq.encode(x)
    t2 = time.perf_counter()
    filts = {"pca": filters.PCAFilter(pca), "pq": fpq,
             "cascade": filters.CascadeFilter(fpq.cb, pca)}
    return filts, codes, {
        "phase": "pq_train", "n_points": len(x),
        "n_train": min(len(x), 20_000), "pq_n_sub": cfg.pq_n_sub,
        "pq_train_iters": cfg.pq_train_iters,
        "train_seconds": t1 - t0, "encode_seconds": t2 - t1}


def run_search(torch, np, x, g, pca, filts, codes, q, gt, batch: int,
               device: str):
    """Every arm of ``ARMS`` over all queries in batches of ``batch``;
    launch counts are reset just before each arm's timed run and read
    just after."""
    from repro_torch.core.search_torch import build_packed, search_batched
    from repro_torch.kernels import ops
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    dbs, pack_s = {}, {}
    outs = []
    for name, kind, deferred, rm, floor, low_dtype in ARMS:
        key = (kind, low_dtype)
        if key not in dbs:
            t0 = time.perf_counter()
            x_low = codes if kind != "pca" else \
                pca.transform(x).astype(np.float32)
            dbs[key] = build_packed(
                g, x_low, filt=None if kind == "pca" else filts[kind],
                low_dtype=low_dtype if kind == "pca" else None,
                device=device)
            sync()
            pack_s[key] = time.perf_counter() - t0
        db = dbs[key]
        kw = {"pca": pca} if kind == "pca" and not deferred else {
            "filt": filts[kind], "deferred": deferred, "rerank_mult": rm}
        search_batched(db, q[:batch], device=device, **kw)      # warm-up
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fis, steps, dhe = [], [], []
        for i in range(0, len(q), batch):
            _, fi, st = search_batched(db, q[i:i + batch],
                                       return_stats=True, device=device,
                                       **kw)
            fis.append(fi)
            steps.append(st["steps_total"])
            dhe.append(st["dist_h_evals"])
        sync()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        fi = torch.cat(fis).cpu().numpy()
        prof = profile_batch(torch, lambda: search_batched(
            db, q[:batch], device=device, **kw)) \
            if device == "cuda" else None
        casts = count_casts(torch, lambda: search_batched(
            db, q[:batch], device=device, **kw)) \
            if device == "cuda" else None
        outs.append({
            "phase": "search", "arm": name, "filter_kind": kind,
            "deferred": deferred, "rerank_mult": rm or 1,
            "promote_mult": g.cfg.promote_mult
            if (deferred and kind == "cascade") else 1,
            "low_dtype": str(db.low.dtype).replace("torch.", ""),
            "n_points": len(x), "queries": len(q), "batch": batch,
            "seconds": secs, "qps": len(q) / secs,
            "recall_at_10": recall_at_10(fi, gt), "recall_floor": floor,
            "steps_mean": float(torch.cat(steps).float().mean()),
            "dist_h_mean": float(torch.cat(dhe).float().mean()),
            "pack_seconds": pack_s[key],
            "bytes_layout3": db.bytes_layout3,
            "bytes_layout4": db.bytes_layout4,
            "bytes_sidecar": db.bytes_sidecar,
            "launches": counts, "casts_one_batch": casts,
            "profile_one_batch": prof})
    return outs


# the kernels each sharded arm must launch: the arm's own and the merge
SHARD_ARM_KERNELS = {arm: ks + ("ksort_l",)
                     for arm, ks in ARM_KERNELS.items()}
# recall@10 floors of the sharded arms. The deferred cascade merges the
# shards' lists on PQ distances (the top promote_mult * ef0 of P times as
# many) before its PCA promote, so, like pq, its floor guards against a
# broken table: the same 0.60 (PERF.md, § 2).
SHARD_FLOORS = {"pca": 0.80, "pca-deferred": 0.80, "pq": 0.60,
                "cascade-deferred": 0.60, "pca-bf16": 0.80,
                "pca-deferred-bf16": 0.80}


def _arm_kwargs(cfg, kind, deferred, rm):
    return {"deferred": deferred, "rerank_mult": rm,
            "promote_mult": cfg.promote_mult if kind == "cascade" else None}


def build_sharded_dbs(torch, np, x, graphs, filts, codes, device,
                      deleted=None, kinds=("pca", "pq", "cascade")):
    """One ``ShardedDB`` per filter kind over the same shard graphs; the
    PQ codes are encoded once and sliced per shard. Kind "pca-bf16" is
    the pca db stored in bfloat16 (the graphs' config with that
    ``low_dtype``). Returns ({kind: sdb}, {kind: seconds})."""
    import dataclasses
    from repro_torch.core.distributed import build_sharded, shard_bounds
    bounds = shard_bounds(len(x), len(graphs))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sdbs, secs = {}, {}
    for kind in kinds:
        t0 = time.perf_counter()
        pays = None if kind.startswith("pca") else \
            [codes[a:b] for a, b in bounds]
        gs, cfg = graphs, graphs[0].cfg
        if kind == "pca-bf16":
            cfg = dataclasses.replace(cfg, low_dtype="bfloat16")
            gs = [dataclasses.replace(g, cfg=cfg) for g in graphs]
        sdbs[kind] = build_sharded(x, cfg, filts[kind.split("-")[0]],
                                   len(graphs), graphs=gs,
                                   payloads=pays, deleted=deleted,
                                   device=device)
        sync()
        secs[kind] = time.perf_counter() - t0
    return sdbs, secs


def _sharded_all(torch, sdb, filt, q, batch, device, mesh=None, **kw):
    """``shard_search_host`` (or with ``mesh`` ``distributed_search``)
    over all of ``q`` in batches: (dists, ids) on the host and the last
    batch's stats."""
    from functools import partial
    from repro_torch.core import distributed
    search = partial(distributed.shard_search_host, device=device) \
        if mesh is None else partial(distributed.distributed_search, mesh)
    fds, fis, st = [], [], None
    for i in range(0, len(q), batch):
        fd, fi, st = search(sdb, q[i:i + batch], filt=filt,
                            return_stats=True, **kw)
        fds.append(fd)
        fis.append(fi)
    return torch.cat(fds).cpu(), torch.cat(fis).cpu(), st


def run_sharded(torch, np, sdbs, filts, q, gt, batch: int, device: str,
                pack_s: dict):
    """Every arm of ``ARMS`` through ``shard_search_host``; launch counts
    and the peak device memory are reset just before each arm's timed
    run and read just after."""
    from repro_torch.core.distributed import shard_search_host
    from repro_torch.kernels import ops
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    outs = []
    for name, kind, deferred, rm, _, low_dtype in ARMS:
        sdb = sdbs["pca-bf16" if low_dtype == "bfloat16" else kind]
        filt = filts[kind]
        floor = SHARD_FLOORS[name]
        kw = _arm_kwargs(sdb.cfg, kind, deferred, rm)
        shard_search_host(sdb, q[:batch], filt=filt, device=device, **kw)
        sync()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, fi, _ = _sharded_all(torch, sdb, filt, q, batch, device, **kw)
        sync()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" \
            else None
        prof = profile_batch(torch, lambda: shard_search_host(
            sdb, q[:batch], filt=filt, device=device, **kw)) \
            if device == "cuda" else None
        casts = count_casts(torch, lambda: shard_search_host(
            sdb, q[:batch], filt=filt, device=device, **kw)) \
            if device == "cuda" else None
        outs.append({
            "phase": "sharded", "arm": name, "filter_kind": kind,
            "deferred": deferred, "rerank_mult": rm or 1,
            "promote_mult": kw["promote_mult"] or 1,
            "shards": sdb.n_shards, "n_points": int(sdb.counts.sum()),
            "queries": len(q), "batch": batch, "seconds": secs,
            "qps": len(q) / secs, "recall_at_10": recall_at_10(fi.numpy(),
                                                               gt),
            "recall_floor": floor,
            "pack_seconds": pack_s["pca-bf16" if low_dtype == "bfloat16"
                                   else kind],
            "low_dtype": str(sdb.low.dtype).replace("torch.", ""),
            "bytes_layout3": sum(sdb.shard_db(s).bytes_layout3
                                 for s in range(sdb.n_shards)),
            "sharded_db_bytes": sdb.nbytes,
            "max_memory_allocated": peak, "launches": counts,
            "casts_one_batch": casts, "profile_one_batch": prof})
    return outs


# the mesh phase's arms (the sharded phase's f32 arms) and the mesh's
# devices: the first P cards where the machine has them, else cuda:0 for
# every shard
MESH_ARMS = ("pca", "pca-deferred", "pq", "cascade-deferred")
# the mesh phase's queries: its checks are bit-equality and launch counts;
# two batches, the least its turns over two halves take
MESH_QUERIES = 2_048


def mesh_devices(torch, P: int, device: str = "cuda") -> list:
    """P device names for a (1, P) mesh (``bench.table3_qps.mesh_devices``):
    the first P cards when there are as many, else the first card P times
    (on the CPU, "cpu" P times)."""
    from repro_torch.bench.table3_qps import mesh_devices as devices
    return [str(d) for d in devices(P, device)]


def run_mesh(torch, np, sdbs, filts, q, batch: int, device: str = "cuda",
             smi: str = "") -> dict:
    """The collective path (``distributed_search``) on the sharded
    phase's P-shard dbs over a (1, P) mesh (``mesh_devices``): in each of
    ``MESH_ARMS`` the ``--queries`` queries bit-equal to
    ``shard_search_host``, each kernel launched as often (``ksort_l`` once
    a batch), QPS of both on the host's clock, timed in turns over the
    queries' two halves (host, mesh on the first; mesh, host on the
    second); then, on the first 4 batches, the pca arm on a (2, P) mesh
    bit-equal to the host path on the same two blocks of each batch, and
    with shard 0 dead bit-equal in ids, dists and coverage. Launch counts
    are reset just before each mesh run and read just after."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import ops
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    P = sdbs["pca"].n_shards
    devs = mesh_devices(torch, P, device)
    mesh = make_mesh((1, P), ("data", "model"), devices=devs)
    out = {"phase": "mesh", "shards": P, "devices": devs,
           "one_card_for_every_shard": len(set(devs)) == 1 and P > 1,
           "gpu": smi, "queries": len(q), "batch": batch, "arms": {}}
    same = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))
    for name, kind, deferred, rm, _, low_dtype in ARMS:
        if name not in MESH_ARMS:
            continue
        sdb, filt = sdbs[kind], filts[kind]
        kw = _arm_kwargs(sdb.cfg, kind, deferred, rm)
        _sharded_all(torch, sdb, filt, q[:batch], batch, device, mesh, **kw)
        sync()
        half = batch * -(-len(q) // (2 * batch))
        runs = {"host": [], "mesh": []}
        for part, order in ((q[:half], (None, mesh)),
                            (q[half:], (mesh, None))):
            for m in order:
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                res = _sharded_all(torch, sdb, filt, part, batch, device, m,
                                   **kw)
                sync()
                runs["host" if m is None else "mesh"].append(
                    (time.perf_counter() - t0, ops.launch_counts(), res))
        secs = {k: [r[0] for r in v] for k, v in runs.items()}
        counts, host_counts = ({n: sum(r[1][n] for r in runs[k])
                                for n in runs[k][0][1]}
                               for k in ("mesh", "host"))
        arm = {"qps_mesh": len(q) / sum(secs["mesh"]),
               "qps_host": len(q) / sum(secs["host"]),
               "seconds_mesh_halves": secs["mesh"],
               "seconds_host_halves": secs["host"],
               "bit_equal": all(same(a[2][:2], b[2][:2]) for a, b in
                                zip(runs["mesh"], runs["host"])),
               "launches": counts, "launches_host": host_counts,
               "batches": -(-half // batch) + -(-(len(q) - half) // batch)}
        out["arms"][name] = arm
        need(arm["bit_equal"], f"mesh {name}: differs from "
             "shard_search_host")
    qs, sdb, filt = q[:4 * batch], sdbs["pca"], filts["pca"]
    split = make_mesh((2, P), ("data", "model"), devices=devs * 2)
    ops.reset_launch_counts()
    got = _sharded_all(torch, sdb, filt, qs, batch, device, split)
    sync()
    out["split_launches"] = ops.launch_counts()
    blocks = []
    for i in range(0, len(qs), batch):
        b = qs[i:i + batch]
        blocks += [b[:len(b) // 2], b[len(b) // 2:]]
    parts = [_sharded_all(torch, sdb, filt, blk, len(blk), device)
             for blk in blocks]
    want = (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))
    out["split_bit_equal"] = same(got[:2], want)
    need(out["split_bit_equal"], "mesh (2, P) pca: differs from the host "
         "path on the same blocks")
    live = np.arange(P) != 0
    ops.reset_launch_counts()
    got = _sharded_all(torch, sdb, filt, qs, batch, device, mesh,
                       live=live)
    sync()
    out["dead_launches"] = ops.launch_counts()
    want = _sharded_all(torch, sdb, filt, qs, batch, device, live=live)
    out["dead_shard"] = {"dead": [0], "coverage": got[2]["coverage"],
                         "bit_equal": same(got[:2], want[:2]) and
                         got[2]["coverage"] == want[2]["coverage"]}
    need(out["dead_shard"]["bit_equal"], "mesh pca with shard 0 dead: "
         "differs from the host path")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def run_degraded(torch, np, sdb, filt, q, batch: int, device: str) -> dict:
    """The pca arm with shard 0 dead, against the survivors' db."""
    from repro_torch.core.distributed import shard_live_counts
    P = sdb.n_shards
    live = np.arange(P) != 0
    t0 = time.perf_counter()
    fd, fi, st = _sharded_all(torch, sdb, filt, q, batch, device, live=live)
    secs = time.perf_counter() - t0
    od, oi, _ = _sharded_all(torch, sdb.select(np.arange(1, P)), filt, q,
                             batch, device)
    lc = shard_live_counts(sdb)
    want = int(lc[1:].sum()) / int(lc.sum())
    ids = fi.numpy()
    shard0 = int(((ids >= 0) & (ids < int(sdb.counts[0]))).sum())
    out = {"phase": "degraded", "arm": "pca", "dead_shards": [0],
           "queries": len(q), "seconds": secs, "qps": len(q) / secs,
           "coverage": st["coverage"], "coverage_expected": want,
           "live_shards": st["live_shards"], "shard0_ids_returned": shard0,
           "bit_identical_to_survivors": bool(torch.equal(fi, oi)
                                               and torch.equal(fd, od))}
    need(st["coverage"] == want and st["degraded"],
         f"degraded: coverage {st['coverage']} != {want}")
    need(shard0 == 0, f"degraded: {shard0} ids of the dead shard returned")
    need(out["bit_identical_to_survivors"],
         "degraded: differs from searching the survivors only")
    return out


def run_tombstones(torch, np, x, graphs, filts, q, gt, batch: int,
                   device: str, seed: int) -> list:
    """pca and pca-deferred with 1% of the points deleted plus every
    query's true nearest neighbour."""
    rng = np.random.default_rng(seed + 7)
    deleted = np.zeros(len(x), bool)
    deleted[rng.choice(len(x), len(x) // 100, replace=False)] = True
    deleted[gt[:, 0]] = True
    t0 = time.perf_counter()
    sdbs, _ = build_sharded_dbs(torch, np, x, graphs, filts, None, device,
                                deleted=deleted, kinds=("pca",))
    pack = time.perf_counter() - t0
    gt_live = ground_truth(torch, x, q, 10, device, deleted=deleted)
    outs = []
    for name, deferred, rm in (("pca", False, None),
                               ("pca-deferred", True, 3)):
        t0 = time.perf_counter()
        _, fi, st = _sharded_all(torch, sdbs["pca"], filts["pca"], q, batch,
                                 device, deferred=deferred, rerank_mult=rm)
        secs = time.perf_counter() - t0
        ids = fi.numpy()
        n_bad = int(deleted[ids[ids >= 0]].sum())
        rec = recall_at_10(ids, gt_live)
        outs.append({"phase": "tombstones", "arm": name,
                     "deleted": int(deleted.sum()), "queries": len(q),
                     "seconds": secs, "qps": len(q) / secs,
                     "pack_seconds": pack, "deleted_ids_returned": n_bad,
                     "recall_at_10_live": rec, "recall_floor": 0.78,
                     "coverage": st["coverage"]})
        need(n_bad == 0, f"tombstones {name}: {n_bad} deleted ids returned")
        need(rec >= 0.78, f"tombstones {name}: recall {rec} < 0.78")
    return outs


def run_resilient(torch, np, sdb, filt, q, device: str) -> dict:
    """One batch through the resilient path, healthy and under faults."""
    from repro_torch.core.distributed import (check_shard_result,
                                              merge_surviving, probe_shard,
                                              shard_search_host)
    from repro_torch.distributed import faults
    P = sdb.n_shards
    qt = torch.as_tensor(q, device=sdb.device)
    qp = filt.prepare_torch(qt)
    victim = min(2, P - 1)
    out = {"phase": "resilient", "queries": len(q), "killed_shard": victim}
    same = lambda a, b: all(torch.equal(u.cpu(), v.cpu())
                            for u, v in zip(a, b))
    for mode, deferred, rm in (("pca", False, None),
                               ("pca-deferred", True, 3)):
        kw = {"deferred": deferred, "rerank_mult": rm}
        probes = [probe_shard(sdb, s, qt, qp, **kw) for s in range(P)]
        fd_all = np.stack([p[0] for p in probes])
        gi_all = np.stack([p[1] for p in probes])
        ok = all(check_shard_result(p[0], p[1], int(sdb.offsets[s]),
                                    int(sdb.counts[s]))
                 for s, p in enumerate(probes))
        healthy = same(merge_surviving(sdb, fd_all, gi_all, None, qt, **kw),
                       shard_search_host(sdb, qt, qp, device=device, **kw))
        with faults.inject(faults.FaultPlan()) as plan:
            plan.add("kill_shard", victim)
            answered = np.ones(P, bool)
            raised = False
            for s in range(P):
                try:
                    fd_all[s], gi_all[s], _ = probe_shard(sdb, s, qt, qp,
                                                          **kw)
                except faults.ShardKilledError:
                    raised = s == victim
                    answered[s] = False
            killed = same(merge_surviving(sdb, fd_all, gi_all, answered, qt,
                                          **kw),
                          shard_search_host(sdb, qt, qp, live=answered,
                                            device=device, **kw))
            plan.heal()
            plan.add("corrupt_shard", 0)
            cfd, cgi, _ = probe_shard(sdb, 0, qt, qp, **kw)
            caught = not check_shard_result(cfd, cgi, int(sdb.offsets[0]),
                                            int(sdb.counts[0]))
            log = [list(e) for e in plan.log]
        out[mode] = {"probe_wall_ms": [p[2] * 1e3 for p in probes],
                     "all_checks_pass": ok, "merge_equals_search": healthy,
                     "kill_raised": raised, "answered": answered.tolist(),
                     "merge_survivors_equals_live_mask": killed,
                     "corrupt_caught": caught, "fault_log": log}
        need(ok and healthy, f"resilient {mode}: probe + merge differs "
             "from shard_search_host")
        need(raised and killed, f"resilient {mode}: the killed shard did "
             "not raise, or the survivors' merge differs")
        need(caught, f"resilient {mode}: corrupt answer passed the check")
    return out



# ------------------------------ serving ------------------------------------

# the serve phases' sizes: shard 0's index reserved to 65,536 slots, 4,096
# upserts (32 probes of insert_batch 128; 8,192 before the benches
# phase), 2,500 deletes; the sharded index takes 2,048 upserts
# round-robin (4,096 before)
SERVE_RESERVE, SERVE_UPSERTS, SERVE_DELETES = 65_536, 4_096, 2_500
SHARDED_UPSERTS = 2_048
# the kernels each serving part must launch: the probe's on upsert, the
# search's on query, and the merge's and the deferred entry's on the
# sharded deferred search
SERVE_UPSERT_KERNELS = ("trip_fold", "fused_expand_rows", "dist_h")
SERVE_QUERY_KERNELS = ("trip_fold", "fused_expand_rows", "dist_h")
SERVE_SHARDED_KERNELS = ("trip_fold", "fused_expand_rows", "dist_h",
                         "ksort_l", "dist_l")


def _epoch_tensors(db) -> list:
    """Every tensor of a published PackedDB or ShardedDB (held on the
    host by the frozen-epoch checks, so device memory peaks stay the
    index's own)."""
    if hasattr(db, "layers"):
        return [db.low, db.high, db.deleted] + \
            [t for lay in db.layers for t in (lay.adj, lay.packed_low)]
    return [db.low, db.high, db.deleted] + list(db.adj) + \
        list(db.packed_low)


def _stream(svc, q, scheduler=False):
    """``run_stream`` over ``q`` with the service's stats reset just
    before: (ids, stream stats, seconds). The serve, serve_sharded and
    replica phases keep the synchronous batch path (``scheduler=False``),
    so their figures compare with earlier runs; the stream phase passes
    None (the scheduler, ``run_stream``'s default)."""
    svc.stats.reset()
    t0 = time.perf_counter()
    ids, st = svc.run_stream(q, scheduler=scheduler)
    return ids, st, time.perf_counter() - t0


def fresh_points(np, n_base: int, n: int, seed: int):
    """``n`` new points of the smoke's SIFT-like distribution (the same
    basis and cluster centres as its first ``n_base``)."""
    from repro_torch.data.vectors import make_sift_like
    return make_sift_like(n_base + n, seed=seed)[n_base:]


def profile_upsert(svc, xb) -> dict:
    """One upsert call under cProfile: its host-clock seconds and the
    cumulative seconds of the probe (on the card, up to its results on
    the host), the host linking and the publish. cProfile slows Python
    calls, not the card or numpy's C loops, so the shares are a guide."""
    import cProfile
    import pstats
    parts = ("probe_neighborhoods", "link_wave", "_publish_incremental",
             "_publish_full")
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    svc.upsert(xb)
    pr.disable()
    out = {"seconds": time.perf_counter() - t0}
    for (_, _, fn), (_, _, _, cum, _) in pstats.Stats(pr).stats.items():
        if fn in parts:
            out[fn] = out.get(fn, 0.0) + cum
    return out


def run_serve(torch, np, g, filt, q, batch: int, seed: int, n_base: int,
              device: str = "cuda") -> dict:
    """The README quickstart at shard 0's size: ``MutableIndex.from_graph``
    + ``reserve`` + ``VectorSearchService``; serve ``q``, upsert
    ``SERVE_UPSERTS`` fresh points one insert batch a call, delete
    ``SERVE_DELETES`` original ids, serve again (no deleted id, recall@10
    against the live points >= 0.80), self-recall of the inserted points
    >= 0.95, ``save`` -> ``load`` on the card serving bit-equal ids and
    dists, the first epoch's tensors unchanged, a NaN query refused; QPS
    and latency at ``batch`` and at 64; one more upsert call profiled.
    Launch counts are reset just before each part (query, upsert, delete
    and query again) and read just after."""
    from repro_torch.index import MutableIndex
    from repro_torch.kernels import ops
    from repro_torch.serve.vector_service import VectorSearchService
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"phase": "serve", "n_points": len(g.x), "queries": len(q),
           "batch": batch}
    t_phase = t0 = time.perf_counter()
    idx = MutableIndex.from_graph(g, filt, seed=seed + 1, device=device)
    idx.reserve(SERVE_RESERVE)
    svc = VectorSearchService(idx, batch_size=batch, device=device)
    sync()
    out.update(setup_seconds=time.perf_counter() - t0, capacity=idx.cap)
    db0, epoch0 = idx.db, idx.epoch
    held = [t.to("cpu", copy=True) for t in _epoch_tensors(db0)]
    launches = {}

    ops.reset_launch_counts()
    ids0, st, secs = _stream(svc, q)
    launches["query"] = ops.launch_counts()
    out["query"] = {"seconds": secs, "qps": len(q) / secs,
                    "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                    "path": st["path"]}
    gt = ground_truth(torch, idx.x[:idx.n], q, 10, device)
    out["query"]["recall_at_10"] = recall_at_10(ids0, gt)

    bb = idx.cfg.insert_batch
    xs = fresh_points(np, n_base, SERVE_UPSERTS + bb, seed)
    xs, x_prof = xs[:SERVE_UPSERTS], xs[SERVE_UPSERTS:]
    ops.reset_launch_counts()
    up_s, new_ids = [], []
    for i in range(0, len(xs), bb):
        t1 = time.perf_counter()
        new_ids.append(svc.upsert(xs[i:i + bb]))
        sync()
        up_s.append(time.perf_counter() - t1)
    launches["upsert"] = ops.launch_counts()
    new_ids = np.concatenate(new_ids)
    rng = np.random.default_rng(seed + 23)
    doomed = rng.choice(len(g.x), SERVE_DELETES, replace=False)
    ops.reset_launch_counts()
    del_s = []
    for part in np.array_split(doomed, 5):
        t1 = time.perf_counter()
        n_del = svc.delete(part)
        sync()
        del_s.append(time.perf_counter() - t1)
        need(n_del == len(part), f"serve: delete took {n_del} of "
             f"{len(part)}")
    launches["delete"] = ops.launch_counts()
    out["upsert"] = {"vectors": len(xs), "calls": len(up_s),
                     "seconds_per_call": up_s,
                     "seconds_mean": float(np.mean(up_s)),
                     "seconds_max": float(np.max(up_s))}
    out["delete"] = {"ids": len(doomed), "calls": len(del_s),
                     "seconds_per_call": del_s}
    need(idx.cap == SERVE_RESERVE, f"serve: capacity {idx.cap} grew past "
         f"the reserved {SERVE_RESERVE}")

    ops.reset_launch_counts()
    ids1, st, secs = _stream(svc, q)
    launches["query_after"] = ops.launch_counts()
    gt_live = ground_truth(torch, idx.x[:idx.n], q, 10, device,
                           deleted=idx.deleted[:idx.n])
    rec = recall_at_10(ids1, gt_live)
    n_bad = int(np.isin(ids1, doomed).sum())
    out["query_after"] = {"seconds": secs, "qps": len(q) / secs,
                          "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                          "recall_at_10_live": rec, "recall_floor": 0.80,
                          "deleted_ids_returned": n_bad}
    need(n_bad == 0, f"serve: {n_bad} deleted ids returned")
    need(rec >= 0.80, f"serve: recall@10 {rec} against the live points "
         "< 0.80")
    self_ids, _ = svc.run_stream(xs, scheduler=False)
    self_rec = float((self_ids[:, 0] == new_ids).mean())
    out["self_recall_at_1"] = self_rec
    need(self_rec >= 0.95, f"serve: self-recall {self_rec} < 0.95")
    out["upsert_profile"] = profile_upsert(svc, x_prof)

    snap = ROOT / "build" / "serve_snapshot.npz"
    t1 = time.perf_counter()
    idx.save(snap)
    t2 = time.perf_counter()
    idx2 = MutableIndex.load(snap, idx.cfg, seed=seed + 1, device=device)
    svc2 = VectorSearchService(idx2, batch_size=batch, device=device)
    sync()
    t3 = time.perf_counter()
    snap.unlink()
    same = True
    for i in range(0, len(q), batch):
        a, b = svc.query(q[i:i + batch]), svc2.query(q[i:i + batch])
        same &= all(np.array_equal(u, v) for u, v in zip(a, b))
    out["snapshot"] = {"save_seconds": t2 - t1, "load_seconds": t3 - t2,
                       "bit_equal": bool(same)}
    need(same, "serve: the restored index serves other ids or dists")
    frozen = all(torch.equal(a, b.cpu()) for a, b in zip(
        held, _epoch_tensors(db0)))
    out["first_epoch_unchanged"] = frozen
    out["epochs"] = {"held": epoch0, "last": idx.epoch,
                     "service": svc.epoch}
    need(frozen, "serve: an earlier epoch's tensors changed")
    nan_q = q[:4].copy()
    nan_q[0, 0] = np.nan
    try:
        svc.query(nan_q)
        refused = False
    except ValueError:
        refused = True
    out["nan_refused"] = refused
    need(refused, "serve: nan_policy='raise' served a NaN query")

    svc64 = VectorSearchService(idx, batch_size=64, device=device)
    n64 = min(len(q), 64 * 64)
    _, st, secs = _stream(svc64, q[:n64])
    out["query_b64"] = {"queries": n64, "seconds": secs,
                        "qps": n64 / secs, "p50_ms": st["p50_ms"],
                        "p99_ms": st["p99_ms"]}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
        if device == "cuda" else None
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def run_serve_sharded(torch, np, graphs, filt, q, gt, batch: int,
                      seed: int, n_base: int, device: str = "cuda") -> dict:
    """``ShardedMutableIndex`` over the shard graphs (one shared filter)
    served under a ``FaultPolicy``: recall@10 >= 0.80 over ``q``; shard 2
    killed -> degraded, coverage the live-count share exactly, none of
    its ids; ``recover_shard(2)`` -> full coverage and the healthy ids; a
    corrupt answer quarantined; ``SHARDED_UPSERTS`` round-robin upserts
    found by the next queries (self-recall >= 0.95), the ShardedDB of the
    epoch before them unchanged; a deferred search of the index; the
    one-npz snapshot round-trips to the same points (dists, and each
    id's shard and local id: the restored stride is the next power of
    two of the points, not the reservation), and the restored index's
    own round trip bit-equal (dists and ids). Launch counts are reset just
    before the part and read just after."""
    from repro_torch.core.distributed import shard_bounds
    from repro_torch.distributed import faults
    from repro_torch.distributed.faults import FaultPlan, FaultPolicy
    from repro_torch.index import MutableIndex, ShardedMutableIndex
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer
    from repro_torch.serve.vector_service import VectorSearchService
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    P = len(graphs)
    victim = min(2, P - 1)
    out = {"phase": "serve_sharded", "shards": P,
           "n_points": sum(len(g.x) for g in graphs), "queries": len(q),
           "batch": batch, "killed_shard": victim}
    t_phase = t0 = time.perf_counter()
    cfg = graphs[0].cfg
    sidx = ShardedMutableIndex(
        [MutableIndex.from_graph(g, filt, seed=seed + 101 * s + 1,
                                 device=device)
         for s, g in enumerate(graphs)], filt, cfg)
    sidx.reserve(SERVE_RESERVE)
    # deadlines well past a probe's time; every retry is data, not time
    pol = FaultPolicy(deadline_ms=2000.0, max_retries=2, backoff_ms=5.0)
    tracer = Tracer(capacity=8)
    svc = VectorSearchService(sidx, batch_size=batch, fault_policy=pol,
                              tracer=tracer, device=device)
    sync()
    out.update(setup_seconds=time.perf_counter() - t0, stride=sidx.stride,
               sharded_db_bytes=sidx.sdb.nbytes)
    # exact ids -> global ids (gid = shard * stride + local)
    bounds = shard_bounds(sum(len(g.x) for g in graphs), P)
    gid_of = np.concatenate([s * sidx.stride + np.arange(b - a)
                             for s, (a, b) in enumerate(bounds)])
    ggt = gid_of[gt]
    ops.reset_launch_counts()
    ids, st, secs = _stream(svc, q)
    rec = recall_at_10(ids, ggt)
    out["query"] = {"seconds": secs, "qps": len(q) / secs,
                    "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                    "recall_at_10": rec, "recall_floor": 0.80}
    need(rec >= 0.80, f"serve_sharded: recall@10 {rec} < 0.80")

    qb = q[:batch]
    _, fi_h, st_h = svc.query(qb, return_stats=True)
    lc = svc._live_counts
    with faults.inject(FaultPlan()) as plan:
        plan.add("kill_shard", victim)
        _, fi_k, st_k = svc.query(qb, return_stats=True)
    mask = np.arange(P) != victim
    want = int(lc[mask].sum()) / int(lc.sum())
    n_dead = int(((fi_k // sidx.stride) == victim).sum())
    dead_marked = bool(svc.health.dead[victim])
    svc.recover_shard(victim)
    _, fi_r, st_r = svc.query(qb, return_stats=True)
    out["kill"] = {"degraded": st_k["degraded"],
                   "coverage": st_k["coverage"],
                   "coverage_expected": want, "dead_shard_ids": n_dead,
                   "dead_marked": dead_marked,
                   "recovered_coverage": st_r["coverage"],
                   "recovered_ids_equal": bool(np.array_equal(fi_r,
                                                              fi_h))}
    need(st_k["degraded"] and st_k["coverage"] == want,
         f"serve_sharded: kill gave coverage {st_k['coverage']} != {want}")
    need(n_dead == 0, f"serve_sharded: {n_dead} ids of the killed shard")
    need(st_r["coverage"] == 1.0 and np.array_equal(fi_r, fi_h),
         "serve_sharded: recover_shard did not restore the healthy ids")
    with faults.inject(FaultPlan()) as plan:
        plan.add("corrupt_shard", 0)
        _, fi_c, st_c = svc.query(qb, return_stats=True)
    root = tracer.last("serve.query")
    probe0 = next(p for p in root.find_all("shard.probe")
                  if p.attrs["shard"] == 0)
    svc.recover_shard(0)
    out["corrupt"] = {"answered": st_c["answered"].tolist(),
                      "probe_events": probe0.event_kinds(),
                      "shard0_ids": int(((fi_c // sidx.stride) == 0)
                                        .sum())}
    need(not st_c["answered"][0] and "quarantine" in probe0.event_kinds()
         and out["corrupt"]["shard0_ids"] == 0,
         "serve_sharded: the corrupt answer was not quarantined")

    xs = fresh_points(np, n_base, SHARDED_UPSERTS, seed + 1)
    sdb0 = sidx.sdb
    held = [t.to("cpu", copy=True) for t in _epoch_tensors(sdb0)]
    t1 = time.perf_counter()
    gids = svc.upsert(xs)
    sync()
    up_s = time.perf_counter() - t1
    frozen = all(torch.equal(a, b.cpu()) for a, b in zip(
        held, _epoch_tensors(sdb0)))
    del held, sdb0
    out["earlier_epoch_unchanged"] = frozen
    need(frozen, "serve_sharded: an earlier epoch's tensors changed")
    self_ids, _ = svc.run_stream(xs, scheduler=False)
    self_rec = float((self_ids[:, 0] == gids).mean())
    out["upsert"] = {"vectors": len(xs), "seconds": up_s,
                     "per_shard": np.bincount(gids // sidx.stride,
                                              minlength=P).tolist(),
                     "self_recall_at_1": self_rec}
    need(self_rec >= 0.95, f"serve_sharded: self-recall {self_rec} < 0.95")
    # the deferred sharded mode: the merge on filter distances and one
    # global Dist.H pass (dist_l scores the deferred entry points)
    fd_d, fi_d = sidx.search(qb, deferred=True, rerank_mult=3)
    sync()
    launches = ops.launch_counts()
    out["mesh"] = run_serve_mesh(torch, np, sidx, qb, batch, device)

    snap = ROOT / "build" / "serve_sharded_snapshot.npz"
    t1 = time.perf_counter()
    sidx.save(snap)
    t2 = time.perf_counter()
    back = ShardedMutableIndex.load(snap, cfg, seed=seed, device=device)
    sync()
    t3 = time.perf_counter()
    snap.unlink()
    # the snapshot keeps no capacity (the reference's format): the
    # restored index's stride is the next power of two of its points,
    # not the reservation, so global ids renumber (ROADMAP.md C); each
    # answer must be the same (shard, local) point at the same distance
    local = lambda ids, stride: torch.where(
        ids >= 0, (ids // stride) * (1 << 40) + ids % stride, ids)
    qs = [q[i:i + batch] for i in range(0, min(len(q), 4 * batch), batch)]
    same = True
    for qi in qs:
        (ad, ai), (bd, bi) = sidx.search(qi), back.search(qi)
        same &= torch.equal(ad, bd) and torch.equal(
            local(ai.long(), sidx.stride), local(bi.long(), back.stride))
    need(same, "serve_sharded: the restored index searches otherwise")
    # the restored index is reserved no further than its points' power of
    # two: its own round trip keeps the stride, and every id bit for bit
    back.save(snap)
    again = ShardedMutableIndex.load(snap, cfg, seed=seed, device=device)
    snap.unlink()
    strict = again.stride == back.stride and all(
        torch.equal(a, b) for qi in qs
        for a, b in zip(back.search(qi), again.search(qi)))
    out["snapshot"] = {"save_seconds": t2 - t1, "load_seconds": t3 - t2,
                       "stride": sidx.stride, "restored_stride":
                       back.stride, "same_points": bool(same),
                       "second_stride": again.stride,
                       "second_bit_equal": bool(strict)}
    need(strict, "serve_sharded: a snapshot of an index at its points' "
         "stride did not round-trip bit for bit")
    del back, again
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
        if device == "cuda" else None
    out["epoch"] = sidx.epoch
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def run_serve_mesh(torch, np, sidx, qb, batch: int, device: str) -> dict:
    """The sharded index searched over a (1, P) mesh (``mesh_devices``),
    plain and deferred, and a service over the mesh: each bit-equal to
    the index's host path; the service's ``scheduler()`` refused. Launch
    counts are reset just before and read just after."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import SchedulerUnsupported
    from repro_torch.serve.vector_service import VectorSearchService
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    devs = mesh_devices(torch, sidx.n_shards, device)
    mesh = make_mesh((1, sidx.n_shards), ("data", "model"), devices=devs)
    same = lambda a, b: all(torch.equal(u.cpu(), v.cpu())
                            for u, v in zip(a, b))
    kws = ({}, {"deferred": True, "rerank_mult": 3})
    ops.reset_launch_counts()
    got = [sidx.search(qb, mesh=mesh, **kw) for kw in kws]
    msvc = VectorSearchService(sidx, batch_size=batch, mesh=mesh,
                               device=device)
    fd, fi = msvc.query(qb)
    sync()
    launches = ops.launch_counts()
    index_eq = all(same(g, sidx.search(qb, **kw))
                   for g, kw in zip(got, kws))
    hd, hi = sidx.search(qb)
    svc_eq = np.array_equal(fi, hi.cpu().numpy()) and \
        np.array_equal(fd, hd.cpu().numpy())
    try:
        msvc.scheduler()
        refused = False
    except SchedulerUnsupported:
        refused = True
    out = {"devices": devs, "index_bit_equal": index_eq,
           "service_bit_equal": bool(svc_eq),
           "scheduler_refused": refused, "launches": launches}
    need(index_eq, "serve_sharded: search(mesh=) differs from the host "
         "path")
    need(svc_eq, "serve_sharded: the mesh service differs from the host "
         "path")
    need(refused and not msvc.scheduler_supported,
         "serve_sharded: the mesh service's scheduler was not refused")
    return out


# phase stream: the continuous-batching scheduler (run_stream's default
# path) on shard 0's mutable index behind a service of STREAM_SLOTS
# (the bank's S); the mixed-k traffic's k and their shares; the
# deferred and sharded parts' query counts; the load bench's offered
# loads, request size, seconds per point and queries (its closed loops
# serve them all, a request at a time)
STREAM_SLOTS, STREAM_QUERIES, STREAM_MIXED = 64, 5_000, 2_000
STREAM_KS, STREAM_K_SHARES = (10, 50, 100), (0.45, 0.45, 0.10)
STREAM_DEFERRED, STREAM_SHARDED = 2_000, 1_000
STREAM_LOAD_FRACS, STREAM_LOAD_REQ, STREAM_LOAD_SECONDS = (0.5, 0.9), 16, 2.0
STREAM_LOAD_QUERIES = 256
# the pilot's queries, and the time the two run_stream passes may take
# (past it their query count is cut)
STREAM_PILOT, STREAM_RUN_BUDGET_S = 1_000, 60.0
# the kernels the scheduler's parts must launch (the gated fold on every
# slotted trip; dist_l scores the deferred admissions' entry points)
STREAM_KERNELS = ("trip_fold", "trip_fold_gated", "fused_expand_rows",
                  "dist_h")
STREAM_DEFERRED_KERNELS = ("trip_fold_gated", "fused_expand_rows", "dist_h",
                           "dist_l")


def _sched_counters(svc) -> dict:
    reg = svc.stats.registry
    shed = reg.get("phnsw_sched_shed_total")
    return {"escalations": reg.get("phnsw_sched_escalations_total").value,
            "admitted": reg.get("phnsw_sched_admitted_total").value,
            "retired": reg.get("phnsw_sched_retired_total").value,
            "shed": sum(c.value for c in shed.children()) if shed else 0}


def tick_ops(torch, np, svc, q) -> dict:
    """One full tick of ``svc``'s scheduler counted on the host: a bank
    of ``STREAM_SLOTS`` fresh queries (``q``) admitted and stepped by one
    ``tick()`` (``tick``; the bank then drains uncounted), and one step
    of the whole bank alone after the same queries' admission (``step``:
    the stepper's program, up to a quantum of trips), each with
    ``aten_ops`` the ATen operations it dispatches (each a host call; on
    the card most are device kernels), the port's kernel ``launches``
    (ctypes calls, not ATen ops) and the layer-body ``trips``
    (``search_torch.trip_counts``); the step's also per slotted trip.
    The admission is the unnoted program, so no slotted-program key is
    added."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core import search_torch as st
    from repro_torch.kernels import ops

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    sync = torch.cuda.synchronize if svc.device.type == "cuda" \
        else (lambda: None)

    def counted(fn) -> dict:
        sync()
        ops.reset_launch_counts()
        st.reset_trip_counts()
        Count.n = 0
        with Count():
            fn()
        sync()
        # each gated fold is also one of trip_fold's launches
        return {"aten_ops": Count.n,
                "launches": sum(n for name, n in ops.launch_counts().items()
                                if name != "trip_fold_gated"),
                "trips": st.trip_counts()}

    sched = svc.scheduler()
    for i in range(STREAM_SLOTS):
        need(sched.submit(q[i], k=10, rid=i) == i, "tick_ops: shed")
    out = {"tick": counted(sched.tick)}
    sched.drain()
    # the step alone: the same queries admitted into a fresh bank (the
    # admission program, uncounted), then one step of the whole bank
    sched = svc.scheduler()
    S, dbv = sched.S, sched._db()
    t = lambda a: torch.as_tensor(np.asarray(a), device=svc.device)
    ef_eff = min(max(10, sched.ef_policy), sched.EF)
    sched.state = st._slot_admit_impl(
        dbv, sched.state, t(q[:S]),
        t(np.asarray(svc.filt.prepare(q[:S]), np.float32)),
        t(np.arange(S, dtype=np.int32)), t(np.full(S, ef_eff, np.int32)),
        t(np.full(S, sched._static_cap(ef_eff), np.int32)))
    out["step"] = counted(lambda: sched._step_call(dbv, S))
    per = max(out["step"]["trips"]["slotted"], 1)
    out["step"]["aten_ops_a_trip"] = out["step"]["aten_ops"] / per
    out["step"]["launches_a_trip"] = out["step"]["launches"] / per
    return out


def _trips_once(launches: dict, trips: dict, what: str) -> None:
    """Each layer-body trip launched the pca expand and the fold once,
    and each slotted trip the gated fold once: not once a shard."""
    every = trips["slotted"] + trips["layer"]
    for name, want in (("fused_expand_rows", every), ("trip_fold", every),
                       ("trip_fold_gated", trips["slotted"])):
        need(launches[name] == want, f"stream: the {what} part launched "
             f"{name} {launches[name]} times in {trips} trips, not once "
             f"a trip ({want})")


def _drain_all(sched, q, ks) -> list:
    """Submit ``q[i]`` with k ``ks[i]`` as rid i, ticking whenever the
    queue is full, then drain; every completion in retirement order."""
    comps = []
    for i in range(len(q)):
        while not sched.has_capacity():
            comps.extend(sched.tick())
        need(sched.submit(q[i], k=int(ks[i]), rid=i) == i,
             f"stream: submit {i} was shed")
    comps.extend(sched.drain())
    return comps


def run_stream_phase(torch, np, g, graphs, x, filt, q, gt, seed: int,
                     device: str = "cuda", n_queries: int = STREAM_QUERIES
                     ) -> dict:
    """The continuous-batching scheduler on the card: ``MutableIndex``
    over shard 0's graph ``g`` behind a ``STREAM_SLOTS`` service. The
    first ``n_queries`` of ``q`` through ``run_stream()`` (the scheduler)
    and ``run_stream_sync()``: bit-equal ids, QPS and p50/p99 of each
    (a ``STREAM_PILOT``-query pilot of the scheduler first, and the count
    cut if the two passes would pass ``STREAM_RUN_BUDGET_S``);
    ``STREAM_MIXED`` mixed-k submits at ``scheduler(ef=100)``: each rid
    exactly once, k ids each, recall@10 >= 0.80 against ``gt``; a
    pca-deferred service's scheduler bit-equal to its sync path; the
    P-shard non-deferred service over ``graphs`` (all of ``x``) with
    ``FaultPolicy``: healthy bit-equal to its sync path, then shard 2
    killed by a ``FaultPlan`` until the policy marks it dead: every
    completion degraded with the exact coverage and none of its ids;
    ``slot_cache_sizes()`` unchanged after each scheduler's warm-up; and
    ``repro_torch.bench.load`` at ``STREAM_LOAD_FRACS`` of capacity.
    Launch counts are reset just before each part and read just after;
    the sharded parts' kernels launch once a trip for every shard (the
    layer-body trips counted on the host, ``search_torch.trip_counts``),
    and one tick of each service is counted (``tick_ops``)."""
    import dataclasses
    from repro_torch.bench.load import run_load
    from repro_torch.core import search_torch as st
    from repro_torch.core.distributed import build_sharded
    from repro_torch.core.search_torch import build_packed, slot_cache_sizes
    from repro_torch.distributed import faults
    from repro_torch.distributed.faults import FaultPlan, FaultPolicy
    from repro_torch.index import MutableIndex
    from repro_torch.kernels import ops
    from repro_torch.serve.vector_service import VectorSearchService
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    n = min(n_queries, len(q))
    out = {"phase": "stream", "n_points": len(g.x), "slots": STREAM_SLOTS,
           "queries": n}
    launches = {}
    idx = MutableIndex.from_graph(g, filt, seed=seed + 1, device=device)
    svc = VectorSearchService(idx, batch_size=STREAM_SLOTS, device=device)
    t0 = time.perf_counter()
    sched = svc.scheduler()
    sync()
    out["warmup_seconds"] = time.perf_counter() - t0
    out["rungs"] = sched.rungs
    warm = slot_cache_sizes()
    pilot = min(STREAM_PILOT, n)
    secs_p = _stream(svc, q[:pilot], scheduler=None)[2]
    out["pilot"] = {"queries": pilot, "seconds": secs_p}
    projected = 2 * secs_p * n / pilot
    if projected > STREAM_RUN_BUDGET_S:
        n_cut = max(pilot, int(n * STREAM_RUN_BUDGET_S / projected))
        emit({"reduced": {"stream_queries": n_cut, "of": n, "why": (
            f"the scheduler and sync passes would take {projected:.1f} s, "
            f"over the {STREAM_RUN_BUDGET_S} s the smoke gives them")}})
        n = out["queries"] = n_cut

    ops.reset_launch_counts()
    ids_s, st_s, secs_s = _stream(svc, q[:n], scheduler=None)
    launches["scheduler"] = ops.launch_counts()
    new_keys = [a - b for a, b in zip(slot_cache_sizes(), warm)]
    need(slot_cache_sizes() == warm, "stream: run_stream() added "
         f"slotted-program keys {new_keys}")
    esc = _sched_counters(svc)
    ops.reset_launch_counts()
    ids_y, st_y, secs_y = _stream(svc, q[:n], scheduler=False)
    launches["sync"] = ops.launch_counts()
    same = bool(np.array_equal(ids_s, ids_y.astype(np.int64)))
    out["scheduler"] = {"path": st_s["path"], "seconds": secs_s,
                        "qps": n / secs_s, "p50_ms": st_s["p50_ms"],
                        "p99_ms": st_s["p99_ms"],
                        "recall_at_10": recall_at_10(ids_s, gt[:n]),
                        "new_keys": new_keys, **esc}
    out["sync"] = {"path": st_y["path"], "seconds": secs_y,
                   "qps": n / secs_y, "p50_ms": st_y["p50_ms"],
                   "p99_ms": st_y["p99_ms"]}
    out["bit_equal_to_sync"] = same
    need(st_s["path"] == "scheduler", "stream: run_stream() did not take "
         "the scheduler")
    need(same, "stream: the scheduler's ids differ from run_stream_sync's")
    need(launches["sync"]["trip_fold_gated"] == 0,
         "stream: the synchronous path launched the gated fold")

    rng = np.random.default_rng(seed + 31)
    ks = rng.choice(STREAM_KS, size=STREAM_MIXED, p=STREAM_K_SHARES)
    picks = rng.integers(0, len(q), STREAM_MIXED)
    mk = svc.scheduler(ef=max(STREAM_KS))
    warm_mk = slot_cache_sizes()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    comps = _drain_all(mk, q[picks], ks)
    secs = time.perf_counter() - t0
    launches["mixed_k"] = ops.launch_counts()
    rids = sorted(c.rid for c in comps)
    ids_mk = np.stack([c.ids[:10] for c in sorted(comps,
                                                  key=lambda c: c.rid)])
    rec_mk = recall_at_10(ids_mk, gt[picks])
    lens_ok = all(len(c.ids) == ks[c.rid] for c in comps)
    out["mixed_k"] = {"submits": STREAM_MIXED, "ks": list(STREAM_KS),
                      "shares": list(STREAM_K_SHARES), "seconds": secs,
                      "qps": STREAM_MIXED / secs,
                      "exactly_once": rids == list(range(STREAM_MIXED)),
                      "k_ids_each": lens_ok, "recall_at_10": rec_mk,
                      "recall_floor": 0.80,
                      "forced": int(sum(c.forced for c in comps)),
                      "steps_mean": float(np.mean([c.steps for c in comps])),
                      "new_keys": [a - b for a, b in
                                   zip(slot_cache_sizes(), warm_mk)]}
    need(rids == list(range(STREAM_MIXED)) and lens_ok,
         "stream: mixed-k completions not exactly once with k ids each")
    need(rec_mk >= 0.80, f"stream: mixed-k recall@10 {rec_mk} < 0.80")
    need(slot_cache_sizes() == warm_mk, "stream: the mixed-k traffic "
         f"added slotted-program keys {out['mixed_k']['new_keys']}")

    # the pca-deferred service: the promote-free re-rank at retirement
    dcfg = dataclasses.replace(g.cfg, deferred_rerank=True)
    ddb = build_packed(dataclasses.replace(g, cfg=dcfg), filt=filt,
                       device=device)
    dsvc = VectorSearchService(ddb, filt=filt, batch_size=STREAM_SLOTS,
                               device=device)
    dsvc.scheduler()
    warm_d = slot_cache_sizes()
    nd = min(STREAM_DEFERRED, len(q))
    ops.reset_launch_counts()
    ids_d, st_d, secs_d = _stream(dsvc, q[:nd], scheduler=None)
    launches["deferred"] = ops.launch_counts()
    ids_dy, _, secs_dy = _stream(dsvc, q[:nd], scheduler=False)
    same_d = bool(np.array_equal(ids_d, ids_dy.astype(np.int64)))
    out["deferred"] = {"queries": nd, "rerank_mult": dcfg.rerank_mult,
                       "seconds": secs_d, "qps": nd / secs_d,
                       "p50_ms": st_d["p50_ms"], "p99_ms": st_d["p99_ms"],
                       "sync_qps": nd / secs_dy,
                       "recall_at_10": recall_at_10(ids_d, gt[:nd]),
                       "bit_equal_to_sync": same_d}
    need(st_d["path"] == "scheduler" and same_d,
         "stream: the deferred scheduler differs from its sync path")
    need(slot_cache_sizes() == warm_d, "stream: the deferred traffic added "
         "slotted-program keys")
    del dsvc, ddb

    # P shards, not deferred, behind a FaultPolicy; shard 2 killed
    P = len(graphs)
    if P > 1:
        sdb = build_sharded(x, g.cfg, filt, P, graphs=graphs, device=device)
        pol = FaultPolicy(deadline_ms=2000.0, max_retries=2, backoff_ms=5.0)
        ssvc = VectorSearchService(sdb, filt=filt, batch_size=STREAM_SLOTS,
                                   fault_policy=pol, device=device)
        ssvc.scheduler()
        warm_s = slot_cache_sizes()
        ns = min(STREAM_SHARDED, len(q))
        ops.reset_launch_counts()
        st.reset_trip_counts()
        ids_h, st_h, secs_h = _stream(ssvc, q[:ns], scheduler=None)
        launches["sharded"] = ops.launch_counts()
        trips_h = st.trip_counts()
        if device == "cuda":
            _trips_once(launches["sharded"], trips_h, "sharded")
        ids_hy, _, secs_hy = _stream(ssvc, q[:ns], scheduler=False)
        same_h = bool(np.array_equal(ids_h, ids_hy.astype(np.int64)))
        victim = min(2, P - 1)
        with faults.inject(FaultPlan()) as plan:
            plan.add("kill_shard", victim)
            for _ in range(4):
                if ssvc.health.dead[victim]:
                    break
                ssvc.query(q[:STREAM_SLOTS])
        dead = bool(ssvc.health.dead[victim])
        live = np.arange(P) != victim
        lc = ssvc._live_counts
        want = int(lc[live].sum()) / int(lc.sum())
        ops.reset_launch_counts()
        st.reset_trip_counts()
        t0 = time.perf_counter()
        comps = _drain_all(ssvc.scheduler(), q[:ns], np.full(ns, 10))
        secs_k = time.perf_counter() - t0
        launches["sharded_degraded"] = ops.launch_counts()
        trips_k = st.trip_counts()
        if device == "cuda":
            _trips_once(launches["sharded_degraded"], trips_k,
                        "sharded degraded")
        lo = int(sdb.offsets[victim])
        hi = lo + int(sdb.counts[victim])
        ids_k = np.stack([c.ids for c in sorted(comps,
                                                key=lambda c: c.rid)])
        # the synchronous degraded answers: the live-masked shard loop
        fi_k = np.concatenate([ssvc.query(q[i:min(i + STREAM_SLOTS, ns)])[1]
                               for i in range(0, ns, STREAM_SLOTS)])
        ssvc.recover_shard(victim)
        cov_ok = all(c.degraded and c.coverage == want for c in comps)
        n_victim = int(((ids_k >= lo) & (ids_k < hi)).sum())
        out["sharded"] = {
            "shards": P, "queries": ns, "qps": ns / secs_h,
            "p50_ms": st_h["p50_ms"], "p99_ms": st_h["p99_ms"],
            "sync_qps": ns / secs_hy, "bit_equal_to_sync": same_h,
            "killed_shard": victim, "dead_marked": dead,
            "degraded_qps": ns / secs_k, "coverage_expected": want,
            "coverage_exact": cov_ok, "victim_ids": n_victim,
            "degraded_equal_to_sync": bool(np.array_equal(
                ids_k, fi_k.astype(np.int64))),
            "trips": trips_h, "degraded_trips": trips_k}
        need(same_h, "stream: the sharded scheduler differs from its sync "
             "path")
        need(dead and cov_ok and n_victim == 0
             and out["sharded"]["degraded_equal_to_sync"],
             f"stream: the killed shard: dead {dead}, coverage exact "
             f"{cov_ok}, {n_victim} of its ids, equal to the degraded "
             f"sync answers {out['sharded']['degraded_equal_to_sync']}")
        need(slot_cache_sizes() == warm_s, "stream: the sharded traffic "
             "added slotted-program keys")
        out["sharded"]["tick_ops"] = tick_ops(torch, np, ssvc, q)
        out["sharded"]["tick_ops_single"] = tick_ops(torch, np, svc, q)
        del ssvc, sdb

    t0 = time.perf_counter()
    svc.stats.reset()
    nl = STREAM_LOAD_QUERIES
    res = run_load(svc, q[:nl], gt[:nl], req_size=STREAM_LOAD_REQ,
                   offered_fracs=STREAM_LOAD_FRACS, calib_reps=2,
                   seed=seed, mixed_k=False,
                   point_seconds=STREAM_LOAD_SECONDS)
    out["load"] = {"seconds": time.perf_counter() - t0, **res["entry"],
                   "rows": [list(r) for r in res["rows"]]}
    need(sum(res["entry"]["new_keys"]) == 0,
         "stream: the load bench added slotted-program keys")
    out["launches"] = launches
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
        if device == "cuda" else None
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase replica: 3 replicas of the serve phase's index; replicated
# upserts of one insert batch each, one delete, and the upserts that go
# in while replica 0 is dead (the gap its recovery replays)
REPLICAS, REPLICA_UPSERTS, REPLICA_DELETES, REPLICA_GAP = 3, 8, 500, 4
REPLICA_KERNELS = ("trip_fold", "fused_expand_rows", "dist_h")
# the seven metric families of the cost bridge
BRIDGE_FAMILIES = ("phnsw_search_steps", "phnsw_search_dist_h_evals",
                   "phnsw_search_coverage", "phnsw_search_batches_total",
                   "phnsw_query_measured_us", "phnsw_query_predicted_us",
                   "phnsw_cost_ratio")


def run_replica(torch, np, g, filt, q, batch: int, seed: int, n_base: int,
                device: str = "cuda") -> dict:
    """The serve phase's setup (shard 0's ``MutableIndex`` reserved to
    ``SERVE_RESERVE`` behind a ``VectorSearchService``) cloned by
    ``ReplicaSet.replicate`` into ``REPLICAS`` replicas, each with its own
    copy of the index on the card: ``q`` through ``rs.query`` (QPS and
    p50/p99 per request), bit-equal on every replica; replicated upserts
    and a delete, converged at ``applied_seq`` 9; a checkpoint; replica 0
    killed by a ``FaultPlan`` -> the same request fails over, more upserts
    go in; ``recover(0)`` from the stale checkpoint replays exactly the
    gap, ``republish(0)`` then replays nothing, the three replicas
    converge, and every id the recovered replica serves is live; every
    replica killed -> ``AllReplicasDeadError``. Launch counts are reset
    just before each part (query, upsert) and read just after."""
    import shutil
    from repro_torch.distributed import faults
    from repro_torch.distributed.faults import (AllReplicasDeadError,
                                                FaultPlan)
    from repro_torch.index import MutableIndex
    from repro_torch.kernels import ops
    from repro_torch.serve import ReplicaSet, VectorSearchService
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"phase": "replica", "n_points": len(g.x), "queries": len(q),
           "batch": batch, "replicas": REPLICAS}
    t_phase = t0 = time.perf_counter()
    snap_dir = ROOT / "build" / "replica_snapshots"
    shutil.rmtree(snap_dir, ignore_errors=True)
    idx = MutableIndex.from_graph(g, filt, seed=seed + 1, device=device)
    idx.reserve(SERVE_RESERVE)
    svc = VectorSearchService(idx, batch_size=batch, device=device)
    rs = ReplicaSet.replicate(svc, REPLICAS, snapshot_dir=snap_dir)
    sync()
    out["setup_seconds"] = time.perf_counter() - t0
    out["devices"] = sorted({str(r.svc.device) for r in rs.replicas})
    need(len({id(r.svc._mut) for r in rs.replicas}) == REPLICAS,
         "replica: the replicas share an index")
    launches = {}

    ops.reset_launch_counts()
    lat, got = [], []
    for i in range(0, len(q), batch):
        t1 = time.perf_counter()
        got.append(rs.query(q[i:i + batch]))
        lat.append(time.perf_counter() - t1)
    launches["query"] = ops.launch_counts()
    out["query"] = {"seconds": sum(lat), "qps": len(q) / sum(lat),
                    "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                    "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                    "requests": len(lat)}
    same = True
    for r in rs.replicas[1:]:
        for j, i in enumerate(range(0, len(q), batch)):
            a = r.svc.query(q[i:i + batch])
            same &= all(np.array_equal(u, v) for u, v in zip(a, got[j]))
    out["replicas_bit_equal"] = bool(same)
    need(same, "replica: the replicas answer differently")

    bb = idx.cfg.insert_batch
    xs = fresh_points(np, n_base, (REPLICA_UPSERTS + REPLICA_GAP) * bb,
                      seed + 3)
    ops.reset_launch_counts()
    up_s = []
    for i in range(REPLICA_UPSERTS):
        t1 = time.perf_counter()
        rs.upsert(xs[i * bb:(i + 1) * bb])
        sync()
        up_s.append(time.perf_counter() - t1)
    launches["upsert"] = ops.launch_counts()
    doomed = np.random.default_rng(seed + 29).choice(
        len(g.x), REPLICA_DELETES, replace=False)
    t1 = time.perf_counter()
    n_del = rs.delete(doomed)
    sync()
    del_s = time.perf_counter() - t1
    need(n_del == REPLICA_DELETES, f"replica: delete took {n_del}")
    conv = rs.assert_converged()
    need(conv["n_healthy"] == REPLICAS and conv["applied_seq"]
         == REPLICA_UPSERTS + 1, f"replica: converged as {conv}")
    out["upsert"] = {"calls": len(up_s), "vectors": len(up_s) * bb,
                     "seconds_per_call": up_s,
                     "seconds_mean": float(np.mean(up_s))}
    out["delete"] = {"ids": REPLICA_DELETES, "seconds": del_s}
    out["converged"] = conv

    t1 = time.perf_counter()
    ckpt, ckpt_seq = rs.checkpoint()
    out["checkpoint_seconds"] = time.perf_counter() - t1
    gap_s = []
    with faults.inject(FaultPlan()) as plan:
        plan.add("kill_replica", 0)
        t1 = time.perf_counter()
        rs.query(q[:batch])
        out["failover_seconds"] = time.perf_counter() - t1
        fo_ok = any(e[0] == "failover" and e[1] == 1 for e in rs.events)
        need(fo_ok and not rs.replicas[0].alive,
             f"replica: no failover to 1 ({rs.events})")
        for i in range(REPLICA_UPSERTS, REPLICA_UPSERTS + REPLICA_GAP):
            t1 = time.perf_counter()
            rs.upsert(xs[i * bb:(i + 1) * bb])
            sync()
            gap_s.append(time.perf_counter() - t1)
        need(rs.assert_converged()["n_healthy"] == REPLICAS - 1,
             "replica: the survivors diverged")
    out["upsert_while_dead"] = {"calls": len(gap_s),
                                "seconds_per_call": gap_s}
    behind = rs.seq - ckpt_seq
    t1 = time.perf_counter()
    replayed = rs.recover(0, snapshot=ckpt, snapshot_seq=ckpt_seq)
    sync()
    out["recover_seconds"] = time.perf_counter() - t1
    again = rs.republish(0)
    conv = rs.assert_converged()
    out.update(ops_replayed=replayed, behind=behind, republished=again,
               converged_after_recover=conv)
    need(replayed == behind == REPLICA_GAP and again == 0,
         f"replica: replayed {replayed} of a {behind}-op gap, then "
         f"{again}")
    need(conv["n_healthy"] == REPLICAS and conv["applied_seq"] == rs.seq,
         f"replica: converged as {conv} after the recovery")
    live = rs.replicas[1].svc._mut.live_ids()
    n_dead_ids = 0
    for i in range(0, len(q), batch):
        _, fi = rs.replicas[0].svc.query(q[i:i + batch])
        n_dead_ids += int((~np.isin(fi, live)).sum())
    out["recovered_dead_ids"] = n_dead_ids
    need(n_dead_ids == 0, f"replica: the recovered replica served "
         f"{n_dead_ids} ids that are not live")
    with faults.inject(FaultPlan()) as plan:
        plan.add("kill_replica", -1)
        try:
            rs.query(q[:batch])
            all_dead = False
        except AllReplicasDeadError:
            all_dead = True
    out["all_dead_raised"] = all_dead
    need(all_dead, "replica: a query with every replica dead served")
    out["events"] = [list(e) for e in rs.events]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
        if device == "cuda" else None
    out["launches"] = launches
    del rs, svc, idx
    shutil.rmtree(snap_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _derived(text: str) -> dict:
    """A bench row's ``derived`` column as a dict (numbers as floats)."""
    out = {}
    for part in text.split(";"):
        k, _, v = part.partition("=")
        try:
            out[k] = float(v)
        except ValueError:
            out[k] = v
    return out


def _bench_rows(doc: dict) -> dict:
    return {r["name"]: {"us": r["us"], **_derived(r["derived"])}
            for r in doc["rows"]}


def check_build_bench(doc: dict) -> None:
    need(doc["recall_at_10_wave"] >= 0.95, f"benches build: wave "
         f"recall@10 {doc['recall_at_10_wave']} < 0.95")
    need(doc["invariants_ok"], "benches build: graph invariants fail")
    need(doc["levels_match"] and doc["entry_match"], "benches build: "
         "the wave graph's levels or entry differ from the oracle's")
    need(doc["recall_delta"] >= -0.01, f"benches build: recall_delta "
         f"{doc['recall_delta']} < -0.01")


def check_faults_bench(doc: dict, tracked: dict) -> None:
    for pt, tr in zip(doc["curve"], tracked["curve"]):
        k = pt["dead_shards"]
        need(pt["coverage"] == pt["live_share"], f"benches faults dead{k}: "
             f"coverage {pt['coverage']} != live share {pt['live_share']}")
        need(abs(pt["recall_full"] - tr["recall_full"]) <= 0.02,
             f"benches faults dead{k}: recall_full {pt['recall_full']} vs "
             f"tracked {tr['recall_full']}")
    need(len(doc["curve"]) == len(tracked["curve"]),
         "benches faults: the curve's length differs from the tracked one")
    need(doc["curve"][1]["recall_survivor"] >= 0.90, "benches faults: "
         f"recall_survivor at one dead shard "
         f"{doc['curve'][1]['recall_survivor']} < 0.90")
    need(doc["zero_recompiles"], "benches faults: the cycle added search "
         "program keys")
    need(doc["recovered_coverage"] == 1.0, "benches faults: recovered "
         f"coverage {doc['recovered_coverage']}")


def check_churn_bench(doc: dict, what: str) -> None:
    need(doc["recall_at_10"] >= 0.80, f"benches {what}: final recall@10 "
         f"{doc['recall_at_10']} < 0.80")
    need(doc["non_live_returned"] == 0, f"benches {what}: "
         f"{doc['non_live_returned']} deleted ids in the final answers")
    need(doc["live"] == doc["expected_live"], f"benches {what}: live "
         f"{doc['live']} != {doc['expected_live']} from the op counts")
    need(doc["tombstone_frac"] == doc["expected_tombstone_frac"],
         f"benches {what}: tombstone_frac {doc['tombstone_frac']} != "
         f"{doc['expected_tombstone_frac']} from the op counts")


def check_table3_bench(t3: dict, fig5: dict, tracked: dict) -> dict:
    """The Table III rows' checks (the host oracle against the card's pca
    row; the modeled processor's orderings) and the filters A/B against
    the tracked ``BENCH_table3.json`` -> ``filters``."""
    rows, erows = _bench_rows(t3), _bench_rows(fig5)
    pca = rows["table3/pHNSW-torch-batched/pca"]["recall@10"]
    host = rows["table3/pHNSW-CPU"]["recall@10"]
    need(abs(pca - host) <= 0.02, f"benches table3: the card's pca "
         f"recall@10 {pca} is {abs(pca - host)} from the host oracle's "
         f"{host}")
    for d in ("DDR4", "HBM"):
        qps = {v: rows[f"table3/{v}/{d}"]["qps"]
               for v in ("HNSW-Std", "pHNSW-Sep", "pHNSW")}
        en = {v: erows[f"fig5/{v}/{d}"]["energy_uj"] for v in qps}
        need(qps["pHNSW"] > max(qps["pHNSW-Sep"], qps["HNSW-Std"]),
             f"benches table3: the modeled pHNSW is not the fastest on {d}")
        need(en["pHNSW"] < min(en["pHNSW-Sep"], en["HNSW-Std"]),
             f"benches fig5: the modeled pHNSW is not the lowest energy "
             f"on {d}")
    for v in ("HNSW-Std", "pHNSW-Sep", "pHNSW"):
        need(rows[f"table3/{v}/HBM"]["qps"] >= rows[f"table3/{v}/DDR4"]["qps"],
             f"benches table3: {v} is slower on HBM than on DDR4")
    filters = {}
    for mode, t in tracked.items():
        got = t3["filters"][mode]
        need(abs(got["recall"] - t["recall"]) <= 0.02, f"benches filters "
             f"A/B: {mode} recall {got['recall']} vs tracked {t['recall']}")
        need(got["bytes_per_vec"] == t["bytes_per_vec"], f"benches "
             f"filters A/B: {mode} bytes_per_vec {got['bytes_per_vec']}")
        filters[mode] = {"recall": got["recall"],
                         "tracked_recall": t["recall"],
                         "dist_h_mean": got["dist_h_mean"],
                         "tracked_dist_h_mean": t["dist_h_mean"]}
    return {"pca_recall": pca, "host_recall": host, "filters": filters}


def check_ablation_bench(doc: dict, tracked: dict) -> None:
    for mode, t in tracked.items():
        got = doc["modes"][mode]
        need(abs(got["recall"] - t["recall"]) <= 0.02, f"benches "
             f"pq_ablation: {mode} recall {got['recall']} vs tracked "
             f"{t['recall']}")
    pq64 = doc["modes"]["pq64"]
    need(pq64["bytes_per_vec"] == 64, f"benches pq_ablation: pq64 "
         f"bytes_per_vec {pq64['bytes_per_vec']}")
    need(pq64["recall"] >= 0.60, f"benches pq_ablation: pq64 recall "
         f"{pq64['recall']} < 0.60")


def check_bridge(torch, np, device: str) -> dict:
    """The cost bridge on one of the 8k fixture's pca batches (the
    runner's Table III does not fold one): ``record_search_stats`` into a
    fresh registry must fill the seven families."""
    from repro_torch.bench.common import batched_filter_ab, load_bench_db
    from repro_torch.obs import Registry, record_search_stats
    cfg, x, g, pca, _, q, gt = load_bench_db(BENCH_FIXTURE_N, 64,
                                             device=device)
    m = batched_filter_ab(cfg, x, g, pca, q, gt, batch=64, reps=1,
                          modes=[("pca", False)], device=device)[0]
    reg = Registry()
    br = record_search_stats(m["stats"], wall_s=m["wall_s"],
                             n_queries=m["queries"], registry=reg, cfg=cfg,
                             filt=m["filt"])
    missing = [f for f in BRIDGE_FAMILIES if reg.get(f) is None]
    need(not missing, f"benches: the bridge left out {missing}")
    return {k: br[k] for k in ("steps_mean", "dist_h_mean", "measured_us",
                               "predicted_us", "cost_ratio")}


# the runner's 8k fixture (``--fast`` / ``--perf-smoke``), which the
# parity phase builds and caches
BENCH_FIXTURE_N = 8000
# phase benches: each runner call (``repro_torch.bench.run``), its name,
# its flags and the kernels its path must launch. ``suite`` is the full
# suite at 8k (--fast): Table III with the filters A/B, Fig 2, Fig 5, the
# kernel footprint, the PQ ablation and the single-index churn
BENCH_MODES = [
    ("build", ["--build", "--n-points", "2000"], ("trip_fold", "dist_h")),
    ("faults", ["--faults"], ("fused_expand_rows", "trip_fold", "dist_h",
                              "ksort_l")),
    ("suite", ["--fast"], ("fused_expand_rows", "pq_expand_rows",
                           "trip_fold", "dist_h", "dist_l", "ksort_l",
                           "fused_filter", "flash_attention",
                           "decode_attention")),
    ("churn_p4", ["--churn", "--shards", "4"],
     ("fused_expand_rows", "trip_fold", "dist_h", "ksort_l")),
    ("perf_pq", ["--perf-smoke", "--filter", "pq"],
     ("pq_expand_rows", "trip_fold", "dist_h")),
    ("perf_cascade", ["--perf-smoke", "--filter", "cascade", "--deferred"],
     ("pq_expand_rows", "trip_fold", "dist_h", "dist_l")),
    ("perf_p4", ["--perf-smoke", "--shards", "4"],
     ("fused_expand_rows", "trip_fold", "dist_h", "ksort_l")),
]


def run_benches(torch, np, smi: str, device: str = "cuda") -> dict:
    """The paper's benches through the runner, ``repro_torch.bench.run
    .main([...])``, each mode into its own JSON directory, and each held
    to its bars: build (wave recall >= 0.95, invariants, levels and entry
    equal to the oracle's, ``recall_delta`` >= -0.01), faults (coverage
    the live share exactly, ``recall_full`` within 0.02 of the tracked
    curve, ``recall_survivor`` >= 0.90 at one dead shard, zero new
    program keys, recovered coverage 1.0), churn single (the suite's) and
    P = 4 (recall >= 0.80, no deleted id, live size and tombstone
    fraction from the op counts), the suite's Table III and Fig 5 (the
    checks of the former ``table3`` phase) and filters A/B and the PQ
    ablation (recall within 0.02 of ``BENCH_table3.json``; pq64 at 64
    bytes and >= 0.60), the perf-smoke rows (pq >= 0.60, cascade-deferred
    and the P = 4 sharded row >= 0.80). Launch counts are reset just
    before each runner call and read just after; each mode's kernels must
    launch."""
    import tempfile
    from repro_torch.bench import run as bench_run
    from repro_torch.kernels import ops
    tracked = json.loads((ROOT / "BENCH_table3.json").read_text())
    out = {"phase": "benches", "nvidia_smi": smi, "modes": {}}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phnsw_benches_") as tmp:
        docs = {}
        for name, argv, kernels in BENCH_MODES:
            d = Path(tmp) / name
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            bench_run.main(argv + ["--device", device, "--out", str(d)])
            secs = time.perf_counter() - t0
            counts = ops.launch_counts()
            docs[name] = {f.stem: json.loads(f.read_text())
                          for f in sorted(d.glob("*.json"))}
            out["modes"][name] = {"argv": argv, "seconds": secs,
                                  "launches": counts}
            if device == "cuda":
                for k in kernels:
                    need(counts[k] > 0, f"benches {name}: never launched {k}")
        b = docs["build"]["build"]
        check_build_bench(b)
        out["build"] = {k: b[k] for k in (
            "n_points", "wave_vps", "ref_vps", "speedup_vs_ref",
            "recall_at_10_wave", "recall_at_10_ref", "recall_delta",
            "levels_match", "entry_match", "invariants_ok")}
        f = docs["faults"]["faults"]
        check_faults_bench(f, tracked["faults"])
        out["faults"] = {k: f[k] for k in (
            "curve", "healthy_query_ms", "degraded_query_ms", "failover_ms",
            "reseed_ms", "recovered_coverage", "zero_recompiles")}
        suite = docs["suite"]
        out["table3"] = check_table3_bench(
            suite["table3_qps"], suite["fig5_energy"], tracked["filters"])
        out["table3"]["rows"] = suite["table3_qps"]["rows"]
        check_ablation_bench(suite["pq_ablation"], tracked["filters"])
        out["pq_ablation"] = suite["pq_ablation"]["modes"]
        for name, doc in (("churn", suite["churn"]),
                          ("churn_p4", docs["churn_p4"]["churn"])):
            check_churn_bench(doc, name)
            out[name] = {k: doc[k] for k in (
                "n_shards", "qps", "p99_ms", "upserts_per_s",
                "deletes_per_s", "recall_at_10", "live", "tombstone_frac",
                "pca_drift")}
        perf = {}
        for name, row, floor in (
                ("perf_pq", "table3/pHNSW-torch-batched/pq", 0.60),
                ("perf_cascade",
                 "table3/pHNSW-torch-batched/cascade-deferred", 0.80),
                ("perf_p4", "table3/pHNSW-torch-sharded/p4-pca", 0.80),
                ("perf_p4", "table3/pHNSW-torch-batched/pca", 0.80)):
            r = _bench_rows(docs[name]["table3_qps"])[row]
            need(r["recall@10"] >= floor, f"benches {name}: {row} recall@10 "
                 f"{r['recall@10']} < {floor}")
            perf[row] = {"qps": r["qps"], "recall_at_10": r["recall@10"],
                         "us_per_query": r["us"]}
        out["perf_smoke"] = perf
        out["fig2"] = docs["suite"]["fig2_kselect"]["rows"][-1]
    out["bridge"] = check_bridge(torch, np, device)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def profile_batch(torch, fn, top: int = 10) -> dict:
    """One extra call of ``fn`` under torch.profiler: device time by
    kernel name and the device's busy share of the profiled window (the
    profiler slows the host, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((float(us), e.key, int(e.count)))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    ported = {n: sum(us for us, k, _ in rows if _profile_match(n, k)) / 1e3
              for n in PORTED}
    return {"wall_ms": wall * 1e3, "device_ms": busy_ms,
            "busy_share": busy_ms / (wall * 1e3),
            "launches": sum(r[2] for r in rows),
            "ported_kernels_ms": ported,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": c}
                    for us, k, c in rows[:top]]}


def count_casts(torch, fn) -> dict:
    """One extra call of ``fn`` with every ATen op it dispatches seen on
    the host: ``casts``, the copies that change a tensor's dtype
    (``_to_copy``, and ``copy_`` between dtypes; on a CUDA tensor each is
    a device kernel), ``bf16_casts``, those from or to bfloat16, and the
    call's ``trips`` (``trip_fold`` launches). Counted where the op is
    dispatched, so no event the profiler drops can hide one. The port's
    kernels are called through ctypes and are not ATen ops."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import ops
    aten = torch.ops.aten
    n = {"casts": 0, "bf16_casts": 0}
    trips = ops.launch_counts()["trip_fold"]

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            pair = None
            if func is aten._to_copy.default:
                pair = (args[0].dtype, out.dtype)
            elif func is aten.copy_.default \
                    and isinstance(args[1], torch.Tensor):
                pair = (args[1].dtype, args[0].dtype)
            if pair is not None and pair[0] != pair[1]:
                n["casts"] += 1
                n["bf16_casts"] += int(torch.bfloat16 in pair)
            return out

    with Casts():
        fn()
    n["trips"] = ops.launch_counts()["trip_fold"] - trips
    return n


def check_bf16_arms(outs, phase: str) -> None:
    """Each bf16 arm against its f32 twin (``BF16_ARMS``): recall@10
    within ``BF16_RECALL``, ``bytes_layout3`` below ``BF16_BYTES`` of the
    twin's, the same launches but for the loop's trips, and no cast in a
    batch. A wrapper of ``per_trip_wrappers`` launches once a trip and a
    fixed number of times a batch, so in each arm the expand launches as
    often as ``trip_fold`` (one a trip), and each such wrapper's launches
    less the arm's trips equal the twin's; every other wrapper launches
    exactly as often as in the twin. On the card, the batch run by
    ``count_casts`` casts nothing from or to bf16, and makes as many
    casts as the twin's where the two ran as many trips (the CPU's plain
    versions widen bf16 by a cast). Emits one line per arm."""
    by = {o["arm"]: o for o in outs}
    for arm, twin in BF16_ARMS.items():
        b, f = by[arm], by[twin]
        lb, lf = b["launches"], f["launches"]
        line = {"phase": f"{phase}_bf16", "arm": arm, "twin": twin,
                "recall_at_10": b["recall_at_10"],
                "twin_recall_at_10": f["recall_at_10"],
                "bytes_layout3": b["bytes_layout3"],
                "twin_bytes_layout3": f["bytes_layout3"],
                "bytes_ratio": b["bytes_layout3"] / f["bytes_layout3"],
                "launches": lb, "twin_launches": lf,
                "trips": lb["trip_fold"], "twin_trips": lf["trip_fold"],
                "casts": b["casts_one_batch"],
                "twin_casts": f["casts_one_batch"],
                "qps": b["qps"], "twin_qps": f["qps"]}
        emit(line)
        need(abs(b["recall_at_10"] - f["recall_at_10"]) <= BF16_RECALL,
             f"{phase} {arm}: recall {b['recall_at_10']} vs {twin}'s "
             f"{f['recall_at_10']}")
        need(line["bytes_ratio"] < BF16_BYTES,
             f"{phase} {arm}: bytes_layout3 ratio {line['bytes_ratio']}")
        per_trip = per_trip_wrappers(b["deferred"])
        same = lb.keys() == lf.keys() and all(
            lb[w] - lb["trip_fold"] == lf[w] - lf["trip_fold"]
            if w in per_trip else lb[w] == lf[w] for w in lf)
        one_a_trip = all(o["launches"][EXPAND] == o["launches"]["trip_fold"]
                         for o in (b, f))
        need(same and one_a_trip, f"{phase} {arm}: launches {lb} against "
             f"{twin}'s {lf}")
        cb, cf = line["casts"], line["twin_casts"]
        need(cb is None or (cb["bf16_casts"] == 0 and (
            cb["trips"] != cf["trips"] or cb["casts"] == cf["casts"])),
             f"{phase} {arm}: {cb} casts in one batch, {twin} {cf}")


# the 8k filter modes held card vs CPU: (filter kind, deferred,
# rerank_mult), at the tracked bench's multipliers
PARITY_MODES = {"pq": ("pq", False, None), "pq-deferred": ("pq", True, 3),
                "pca-deferred": ("pca", True, 3),
                "cascade-deferred": ("cascade", True, 2)}
def _bench_filters(np, cfg, x, pca, levels):
    """The 8k bench's filters (``bench.common.make_bench_filter``, which
    the benches phase then finds trained): the adopted PCA; PQ at 4 Lloyd
    iterations; the cascade at the config's 8, adopting the PCA; both
    density-aware from ``levels``."""
    from repro_torch.bench.common import make_bench_filter
    from repro_torch.core import filters
    return {"pca": filters.PCAFilter(pca),
            "pq": make_bench_filter("pq", cfg, x, pca, levels),
            "cascade": make_bench_filter("cascade", cfg, x, pca, levels),
            "none": filters.IdentityFilter(dim=x.shape[1])}


def _int_filters(np, filts, d_low: int, dim: int):
    """Exact-arithmetic twins of the filters: the cascade's codebook
    rounded to integers, and a 'PCA' that selects the first d_low
    coordinates (a projection, so still a lower bound)."""
    from repro_torch.core import filters
    arrays = {"centroids": np.round(filts["cascade"].cb.centroids),
              "mean": np.zeros(dim, np.float32),
              "components": np.eye(dim, d_low, dtype=np.float32),
              "explained": np.full(d_low, 1.0 / d_low, np.float32)}
    return {k: filters.from_reference(k, arrays)
            for k in ("pca", "pq", "cascade")}


def _search_all(torch, g, filt, q, deferred, rm, device, dbs, batch=None):
    from repro_torch.core.search_torch import build_packed, search_batched
    key = (filt.kind, device)
    if key not in dbs:
        dbs[key] = build_packed(g, filt=filt, device=device)
    db = dbs[key]
    batch = batch or len(q)
    outs = [search_batched(db, q[i:i + batch], filt=filt, deferred=deferred,
                           rerank_mult=rm, return_stats=True, device=device)
            for i in range(0, len(q), batch)]
    cat = lambda xs, d=0: torch.cat([t.cpu() for t in xs], d)
    return (cat([o[0] for o in outs]), cat([o[1] for o in outs]),
            cat([o[2]["steps_per_layer"] for o in outs], 1),
            cat([o[2]["dist_h_evals"] for o in outs]), db)


def run_parity(torch, np, seed: int = 0, device: str = "cuda") -> dict:
    """The 8k bench fixture (``bench.common.load_bench_db(8000, 200)``:
    SIFT50k-shaped config at 8000 points, seed 0, 200 queries): one
    graph, built on ``device``, packed on ``device`` and on the CPU; the
    pca check, then every other filter mode on float data (recall within
    0.005, ids equal for >= 99% of queries) and on integer data
    (bit-identical ids, dists, steps and Dist.H counts). (The filters
    table is the benches phase's, from the runner.)"""
    from repro_torch.bench.common import load_bench_db
    from repro_torch.core.graph import HNSWGraph
    from repro_torch.core.search_torch import build_packed, search_batched
    t0 = time.perf_counter()
    # the benches' fixture (``experiments/data/``), built on ``device``
    # here and cached for the benches phase
    cfg, x, g, pca, xl, q, gt = load_bench_db(8000, 200, device=device)
    res, outs = {}, {}
    for dev in (device, "cpu"):
        db = build_packed(g, xl, device=dev)
        fd, fi, st = search_batched(db, q, pca=pca, return_stats=True,
                                    device=dev)
        res[dev] = (fd.cpu().numpy(), fi.cpu().numpy(),
                    st["dist_h_evals"].cpu().numpy())
    card, host = res[device], res["cpu"]
    rec_card, rec_host = recall_at_10(card[1], gt), recall_at_10(host[1], gt)
    rec64 = recall_at_10(card[1][:64], gt[:64])
    dhe64 = float(card[2][:64].mean())
    same = float((card[1] == host[1]).all(1).mean())
    need(abs(rec_card - rec_host) <= 0.005,
         f"8k float parity: recall card {rec_card} vs cpu {rec_host}")
    need(same >= 0.99, f"8k float parity: ids equal for {same:.4f} < 0.99")
    # integer-valued fixture: every f32 sum exact in any order
    xi = np.round(x)
    qi = np.round(q)
    gi = HNSWGraph(cfg=cfg, x=xi, levels=g.levels, layers=g.layers,
                   entry=g.entry)
    xli = np.round(pca.transform(xi)).astype(np.float32)
    qpi = np.round(pca.transform(qi)).astype(np.float32)
    for dev in (device, "cpu"):
        db = build_packed(gi, xli, device=dev)
        fd, fi, st = search_batched(db, qi, qpi, return_stats=True,
                                    device=dev)
        outs[dev] = [fd.cpu(), fi.cpu(), st["steps_per_layer"].cpu(),
                     st["dist_h_evals"].cpu()]
    bit = all(torch.equal(a, b) for a, b in zip(outs[device], outs["cpu"]))
    need(bit, "8k integer parity: card and CPU differ")
    # the same with layout (3) stored in bf16, pca and pca-deferred
    bf16 = {}
    for mode, deferred in (("pca", False), ("pca-deferred", True)):
        ob = {}
        for dev in (device, "cpu"):
            db = build_packed(gi, xli, low_dtype="bfloat16", device=dev)
            fd, fi, st = search_batched(db, qi, qpi, deferred=deferred,
                                        rerank_mult=3 if deferred else None,
                                        return_stats=True, device=dev)
            ob[dev] = [fd.cpu(), fi.cpu(), st["steps_per_layer"].cpu(),
                       st["dist_h_evals"].cpu()]
        bf16[mode] = all(torch.equal(a, b)
                         for a, b in zip(ob[device], ob["cpu"]))
        need(bf16[mode], f"8k bf16 {mode} integer parity: card and CPU "
             "differ")
    wide = _wide_parity(torch, np, g, gi, cfg, pca, xl, xli, q, qi, qpi, gt,
                        device)

    # --- every new filter mode, card vs CPU ---
    filts = _bench_filters(np, cfg, x, pca, g.levels)
    ifilts = _int_filters(np, filts, cfg.d_low, x.shape[1])
    dbs, idbs, modes = {}, {}, {}
    for mode, (kind, deferred, rm) in PARITY_MODES.items():
        r = {}
        for dev in (device, "cpu"):
            r[dev] = _search_all(torch, g, filts[kind], q, deferred, rm,
                                 dev, dbs)
        ids_c, ids_h = r[device][1].numpy(), r["cpu"][1].numpy()
        rc, rh = recall_at_10(ids_c, gt), recall_at_10(ids_h, gt)
        eq = float((ids_c == ids_h).all(1).mean())
        need(abs(rc - rh) <= 0.005,
             f"8k {mode} float parity: recall card {rc} vs cpu {rh}")
        need(eq >= 0.99, f"8k {mode} float parity: ids equal for {eq:.4f}")
        ri = {}
        for dev in (device, "cpu"):
            ri[dev] = _search_all(torch, gi, ifilts[kind], qi, deferred, rm,
                                  dev, idbs)
        ibit = all(torch.equal(a, b)
                   for a, b in zip(ri[device][:4], ri["cpu"][:4]))
        need(ibit, f"8k {mode} integer parity: card and CPU differ")
        modes[mode] = {"recall_card": rc, "recall_cpu": rh,
                       "ids_equal_frac": eq,
                       "dist_h_mean_card": float(r[device][3]
                                                 .float().mean()),
                       "integer_bit_identical": ibit,
                       "integer_dist_h_mean": float(ri[device][3]
                                                    .float().mean())}
    mutable = _mutable_parity(torch, np, gi, ifilts["pca"], qi, device,
                              seed)
    stream = _stream_parity(np, lambda dev: build_packed(
        gi, filt=ifilts["pca"], device=dev), ifilts["pca"], qi, device)
    mutable["compact"] = run_compact_8k(torch, np, g, pca, q, device, seed)
    parity = {"phase": "parity_8k", "recall_card": rec_card,
              "recall_cpu": rec_host, "recall_first64_card": rec64,
              "ids_equal_frac": same,
              "dist_h_mean_card": float(card[2].mean()),
              "dist_h_mean_first64_card": dhe64,
              "integer_bit_identical": bit,
              "bf16_integer_bit_identical": bf16, "wide": wide,
              "modes": modes, "mutable": mutable, "stream": stream,
              "sharded": _sharded_parity(
                  torch, np, cfg, x, q[:SHARDED_PARITY_QUERIES],
                  gt[:SHARDED_PARITY_QUERIES], filts, ifilts, seed, device)}
    parity["seconds"] = time.perf_counter() - t0
    return parity


def _mutate_int(np, idx, rng, n_up: int, n_del: int) -> list:
    """Integer upserts (a replace-upsert among them) and deletes through
    any index kind; returns the ids each step handed out or removed."""
    rows = lambda n: np.round(rng.random((n, 128)) * 200).astype(np.float32)
    g1 = idx.upsert(rows(n_up))
    n = idx.delete(g1[::max(len(g1) // n_del, 1)][:n_del])
    g2 = idx.upsert(rows(20), ids=g1[1:21])
    return [g1, np.asarray([n]), g2]


def _stream_parity(np, backend, filt, qi, device: str, batch: int = 64
                   ) -> dict:
    """``run_stream()`` (the continuous-batching scheduler) over the
    integer queries on the card and on the CPU, each service over
    ``backend(dev)``: bit-identical ids, and the card's equal to its own
    ``run_stream_sync()``."""
    from repro_torch.serve.vector_service import VectorSearchService
    got = {}
    for dev in (device, "cpu"):
        svc = VectorSearchService(backend(dev), filt=filt, batch_size=batch,
                                  device=dev)
        ids, st = svc.run_stream(qi)
        need(st["path"] == "scheduler", "stream parity: not the scheduler")
        got[dev] = ids
        if dev == device:
            sync_ids = svc.run_stream_sync(qi)[0]
    ok = bool(np.array_equal(got[device], got["cpu"]))
    ok_sync = bool(np.array_equal(got[device], sync_ids.astype(np.int64)))
    need(ok and ok_sync, f"stream parity: card vs CPU {ok}, card vs its "
         f"sync path {ok_sync}")
    return {"queries": len(qi), "slots": batch, "integer_bit_identical": ok,
            "equal_to_sync": ok_sync}


def _mutable_parity(torch, np, gi, filt, qi, device: str, seed: int) -> dict:
    """The mutable index on the 8k integer fixture, on the card and on
    the CPU: the same graph, the same integer upserts (the probe on each
    device), deletes and a replace-upsert give identical adjacency rows,
    levels, entry, ids, dists and tombstone words."""
    from repro_torch.index import MutableIndex
    got = {}
    for dev in (device, "cpu"):
        idx = MutableIndex.from_graph(gi, filt, seed=seed + 3, device=dev)
        steps = _mutate_int(np, idx, np.random.default_rng(seed + 5), 512,
                            200)
        fd, fi = idx.search(qi)
        got[dev] = (steps, [fd.cpu(), fi.cpu(), idx.db.deleted.cpu()],
                    idx)
    (sc, tc, ic), (sh, th, ih) = got[device], got["cpu"]
    ok = all(np.array_equal(a, b) for a, b in zip(sc, sh)) \
        and all(torch.equal(a, b) for a, b in zip(tc, th)) \
        and (ic.n, ic.entry, ic.epoch) == (ih.n, ih.entry, ih.epoch) \
        and np.array_equal(ic.levels, ih.levels) \
        and all(np.array_equal(a, b) for a, b in zip(ic.adj, ih.adj))
    need(ok, "8k mutable integer parity: card and CPU differ")
    return {"n": ic.n, "epoch": ic.epoch, "deleted": ic.n_deleted,
            "integer_bit_identical": ok}


def _sharded_mutable_parity(torch, np, cfg, igraphs, filt, qi,
                            device: str, seed: int) -> dict:
    """The sharded mutable index over the integer shard graphs, on the
    card and on the CPU: the same global ids from round-robin integer
    upserts, deletes and a replace-upsert, identical ids, dists and
    tombstone words."""
    from repro_torch.index import MutableIndex, ShardedMutableIndex
    got = {}
    for dev in (device, "cpu"):
        idx = ShardedMutableIndex(
            [MutableIndex.from_graph(g, filt, seed=seed + 101 * s + 1,
                                     device=dev)
             for s, g in enumerate(igraphs)], filt, cfg)
        steps = _mutate_int(np, idx, np.random.default_rng(seed + 6), 512,
                            100)
        fd, fi = idx.search(qi)
        got[dev] = (steps, [fd.cpu(), fi.cpu(), idx.sdb.deleted.cpu()])
    (sc, tc), (sh, th) = got[device], got["cpu"]
    ok = all(np.array_equal(a, b) for a, b in zip(sc, sh)) \
        and all(torch.equal(a, b) for a, b in zip(tc, th))
    need(ok, "8k sharded mutable integer parity: card and CPU differ")
    return {"shards": len(igraphs), "integer_bit_identical": ok}


def run_compact_8k(torch, np, g, pca, q, device: str, seed: int) -> dict:
    """``compact()`` on the card index of the 8k fixture with a quarter
    of its points deleted: the remap drops exactly the deleted ids and
    numbers the survivors densely, and recall@10 against the live
    points stays >= 0.80."""
    from repro_torch.index import MutableIndex
    idx = MutableIndex.from_graph(g, pca, seed=seed + 1, device=device)
    n0 = idx.n
    doomed = np.random.default_rng(seed + 9).choice(n0, n0 // 4,
                                                    replace=False)
    idx.delete(doomed, auto_compact=False)
    t0 = time.perf_counter()
    rep = idx.compact()
    secs = time.perf_counter() - t0
    remap = rep["remap"]
    dense = bool((remap[doomed] == -1).all() and np.array_equal(
        np.sort(remap[remap >= 0]), np.arange(idx.n)))
    gt = idx.live_ground_truth(q, 10)
    _, fi = idx.search(q)
    rec = recall_at_10(fi.cpu().numpy(), gt)
    out = {"n_before": n0, "deleted": len(doomed), "n_after": idx.n,
           "capacity": idx.cap, "seconds": secs, "remap_dense": dense,
           "recall_at_10_live": rec, "recall_floor": 0.80}
    need(dense, "compact: the remap is not dense over the survivors")
    need(rec >= 0.80, f"compact: recall@10 {rec} < 0.80")
    return out


# the pca arm at these expand widths on the 8k fixture: W * M0 = 128
# expand slots (the warp tier's widest) and 256 (the block tier), W * k
# = 64 and 128 fold feeds (the block tier past 64)
WIDE_W = (4, 8)


def _wide_parity(torch, np, g, gi, cfg, pca, xl, xli, q, qi, qpi, gt,
                 device: str) -> dict:
    """The pca arm at ``expand_width`` W in ``WIDE_W`` on the 8k graph,
    card against CPU: integer data bit-identical (ids, dists, steps,
    Dist.H counts), float data recall within 0.005 and ids equal for >=
    99% of queries; card seconds of the 200 queries beside."""
    import dataclasses
    from repro_torch.core.search_torch import build_packed, search_batched
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {}
    for W in WIDE_W:
        cw = dataclasses.replace(cfg, expand_width=W)
        res, ires, secs = {}, {}, None
        for dev in (device, "cpu"):
            db = build_packed(dataclasses.replace(g, cfg=cw), xl, device=dev)
            t0 = time.perf_counter()
            fd, fi, st = search_batched(db, q, pca=pca, return_stats=True,
                                        device=dev)
            sync()
            if dev == device:
                secs = time.perf_counter() - t0
            res[dev] = (fi.cpu().numpy(), st["dist_h_evals"].cpu().numpy())
            idb = build_packed(dataclasses.replace(gi, cfg=cw), xli,
                               device=dev)
            fd, fi, st = search_batched(idb, qi, qpi, return_stats=True,
                                        device=dev)
            ires[dev] = [fd.cpu(), fi.cpu(), st["steps_per_layer"].cpu(),
                         st["dist_h_evals"].cpu()]
        rc = recall_at_10(res[device][0], gt)
        rh = recall_at_10(res["cpu"][0], gt)
        eq = float((res[device][0] == res["cpu"][0]).all(1).mean())
        ibit = all(torch.equal(a, b)
                   for a, b in zip(ires[device], ires["cpu"]))
        need(abs(rc - rh) <= 0.005,
             f"8k pca W={W} float parity: recall card {rc} vs cpu {rh}")
        need(eq >= 0.99, f"8k pca W={W} float parity: ids equal for {eq}")
        need(ibit, f"8k pca W={W} integer parity: card and CPU differ")
        out[f"W={W}"] = {"recall_card": rc, "recall_cpu": rh,
                         "ids_equal_frac": eq, "integer_bit_identical": ibit,
                         "dist_h_mean_card": float(res[device][1].mean()),
                         "card_seconds": secs}
    return out


# the sharded modes held card vs CPU on the 8k fixture
SHARD_PARITY_MODES = {"pca": ("pca", False, None), **PARITY_MODES,
                      "none": ("none", False, None)}


def _mesh_parity(torch, np, cfg, xi, qi, igraphs, ifilts, deleted,
                 device: str) -> dict:
    """``distributed_search`` on the integer fixture's first 64 queries
    with tombstones, in ``MESH_PARITY_MODES``, on the card
    (``mesh_devices``) and on the CPU: over a (1, P) mesh with every
    shard live and a (2, P) mesh with shard 0 dead, ids, dists and
    coverage bit-identical."""
    from repro_torch.core.distributed import (build_sharded,
                                              distributed_search, make_mesh)
    P = len(igraphs)
    out = {}
    for mode in MESH_PARITY_MODES:
        kind, deferred, rm = SHARD_PARITY_MODES[mode]
        kw = _arm_kwargs(cfg, kind, deferred, rm)
        got = {}
        for dev in (device, "cpu"):
            sdb = build_sharded(xi, cfg, ifilts[kind], P, graphs=igraphs,
                                deleted=deleted, device=dev)
            devs = mesh_devices(torch, P, dev)
            got[dev] = []
            for R, live in ((1, None), (2, np.arange(P) != 0)):
                mesh = make_mesh((R, P), ("data", "model"),
                                 devices=devs * R)
                fd, fi, st = distributed_search(
                    mesh, sdb, qi[:64], filt=ifilts[kind], live=live,
                    return_stats=True, **kw)
                got[dev] += [fd.cpu(), fi.cpu(), st["coverage"]]
        ok = all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                 else a == b for a, b in zip(got[device], got["cpu"]))
        out[mode] = ok
        need(ok, f"8k mesh {mode} integer parity: card and CPU differ")
    return out


# the sharded parity's queries (of the fixture's 200) and the modes it also
# runs on float data (every mode runs on integer data, bit for bit): its
# checks are bits and id agreement, not rates; on all 200 queries and
# every mode it took 106 s of the smoke on an H100 host, 67.92 s at 100
# queries in the pca float mode, so it is cut to make room for the
# lm_families and train phases
SHARDED_PARITY_QUERIES = 50
SHARDED_FLOAT_MODES = ("pca",)
# the modes of its mesh search card against CPU: the mesh phase holds the
# card's mesh to its host path in four modes, this phase the host path
# card against CPU in every mode, and the CPU tests the CPU's mesh to
# the reference's host path in every mode
MESH_PARITY_MODES = ("pca",)


def _sharded_parity(torch, np, cfg, x, q, gt, filts, ifilts, seed: int,
                    device: str, shards: int = 4) -> dict:
    """The 8k fixture over ``shards`` shard graphs (built on ``device``,
    seed ``seed + s``), searched by ``shard_search_host`` on the card and
    on the CPU in every mode: float data within 0.005 recall and >= 99%
    of ids equal; integer data (the rounded points on the same graphs,
    integer filters) bit-identical in ids, dists and coverage, with and
    without tombstones (1% of the points plus every query's nearest
    neighbour)."""
    import dataclasses
    from repro_torch.core import filters
    from repro_torch.core.distributed import (build_sharded, shard_bounds,
                                              shard_search_host)
    from repro_torch.core.graph import HNSWGraph, build_hnsw
    t0 = time.perf_counter()
    bounds = shard_bounds(len(x), shards)
    graphs = [build_hnsw(x[a:b], cfg, seed=seed + s, device=device)
              for s, (a, b) in enumerate(bounds)]
    xi, qi = np.round(x), np.round(q)
    igraphs = [HNSWGraph(cfg=cfg, x=xi[a:b], levels=g.levels,
                         layers=g.layers, entry=g.entry)
               for g, (a, b) in zip(graphs, bounds)]
    ifilts = dict(ifilts, none=filters.IdentityFilter(dim=x.shape[1]))
    rng = np.random.default_rng(seed + 11)
    deleted = np.zeros(len(x), bool)
    deleted[rng.choice(len(x), len(x) // 100, replace=False)] = True
    deleted[gt[:, 0]] = True
    out = {"shards": shards, "modes": {}}
    for mode, (kind, deferred, rm) in SHARD_PARITY_MODES.items():
        kw = _arm_kwargs(cfg, kind, deferred, rm)
        out["modes"][mode] = r = {}
        if mode in SHARDED_FLOAT_MODES:
            res = {}
            for dev in (device, "cpu"):
                sdb = build_sharded(x, cfg, filts[kind], shards,
                                    graphs=graphs, device=dev)
                res[dev] = shard_search_host(sdb, q, filt=filts[kind],
                                             device=dev, **kw)[1] \
                    .cpu().numpy()
            rc = recall_at_10(res[device], gt)
            rh = recall_at_10(res["cpu"], gt)
            eq = float((res[device] == res["cpu"]).all(1).mean())
            need(abs(rc - rh) <= 0.005, f"8k sharded {mode} float parity: "
                 f"recall card {rc} vs cpu {rh}")
            need(eq >= 0.99, f"8k sharded {mode} float parity: ids equal "
                 f"for {eq:.4f}")
            r.update(recall_card=rc, recall_cpu=rh, ids_equal_frac=eq)
        bits = {}
        for tombs in (False, True):
            got = {}
            for dev in (device, "cpu"):
                sdb = build_sharded(xi, cfg, ifilts[kind], shards,
                                    graphs=igraphs,
                                    deleted=deleted if tombs else None,
                                    device=dev)
                fd, fi, st = shard_search_host(
                    sdb, qi, filt=ifilts[kind], live=[False, True, True,
                                                      True][:shards]
                    if tombs else None, return_stats=True, device=dev, **kw)
                got[dev] = (fd.cpu(), fi.cpu(), st["coverage"])
            ok = torch.equal(got[device][0], got["cpu"][0]) \
                and torch.equal(got[device][1], got["cpu"][1]) \
                and got[device][2] == got["cpu"][2]
            ids = got[device][1].numpy()
            if tombs:
                ok = ok and not deleted[ids[ids >= 0]].any()
            bits["tombstones" if tombs else "plain"] = ok
            need(ok, f"8k sharded {mode} integer parity "
                 f"(tombstones={tombs}): card and CPU differ")
        r["integer_bit_identical"] = bits
    # layout (3) stored in bf16 (the graphs' config says so), pca and
    # pca-deferred on the integer data, with and without tombstones
    bcfg = dataclasses.replace(cfg, low_dtype="bfloat16")
    bgraphs = [dataclasses.replace(g, cfg=bcfg) for g in igraphs]
    out["bf16"] = {}
    for mode in ("pca", "pca-deferred"):
        kind, deferred, rm = SHARD_PARITY_MODES[mode]
        kw = _arm_kwargs(cfg, kind, deferred, rm)
        for tombs in (False, True):
            got = {}
            for dev in (device, "cpu"):
                sdb = build_sharded(xi, bcfg, ifilts[kind], shards,
                                    graphs=bgraphs,
                                    deleted=deleted if tombs else None,
                                    device=dev)
                need(sdb.low.dtype == torch.bfloat16, "bf16 sharded db")
                fd, fi, st = shard_search_host(
                    sdb, qi, filt=ifilts[kind], live=[False, True, True,
                                                      True][:shards]
                    if tombs else None, return_stats=True, device=dev, **kw)
                got[dev] = (fd.cpu(), fi.cpu(), st["coverage"])
            ok = torch.equal(got[device][0], got["cpu"][0]) \
                and torch.equal(got[device][1], got["cpu"][1]) \
                and got[device][2] == got["cpu"][2]
            out["bf16"][f"{mode} tombstones={tombs}"] = ok
            need(ok, f"8k sharded bf16 {mode} integer parity "
                 f"(tombstones={tombs}): card and CPU differ")
    out["stream"] = _stream_parity(np, lambda dev: build_sharded(
        xi, cfg, ifilts["pca"], shards, graphs=igraphs, device=dev),
        ifilts["pca"], qi, device)
    t_mesh = time.perf_counter()
    out["mesh"] = _mesh_parity(torch, np, cfg, xi, qi, igraphs, ifilts,
                               deleted, device)
    out["mesh_seconds"] = time.perf_counter() - t_mesh
    out["mutable"] = _sharded_mutable_parity(torch, np, cfg, igraphs,
                                             ifilts["pca"], qi, device,
                                             seed)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------- lm --------------------------------------

LM_ARCH = "starcoder2-3b"
LM_TIMED = (8, 1024, 32)            # (b): batch, prompt, new tokens
LM_PARITY = (2, 64, 4)              # (c), (d): batch, prompt, new tokens
LM_CUT_LAYERS = 2                   # (d), (e): the full-width cut, f32
LM_RETRIEVAL_STEPS = 8              # (e): decode steps held to dense
LM_RETRIEVAL_TIMED = (1, 8192, 16)  # (e): batch, prompt, new tokens
# (e)'s timed retrieval settings: launch/dryrun.py's long-context ones
LM_RETRIEVAL = dict(enabled=True, d_low=16, topk=2048, block=128,
                    partitions=16)
# (c) bf16 over 30 layers: both runs round to bf16 (8 significant bits,
# 2^-9 relative) at every residual add, sublayer output and product,
# in other orders (a GEMM of B*S rows against one of B rows, the flash
# kernel against the decode kernel); ~120 roundings a token add up as a
# random walk to ~2% of the hidden state, which the final norm and head
# carry to the logits (RMS ~1 at this init): a few hundredths, the max
# over 2 x 49,152 logits ~0.1. The H100 run read 0.0547 at an RMS of
# 0.999 (seeded, the same each run); the limit is about 3x that, in
# units of the logits' RMS. The phase plants a fault (every query head
# reading kv head 0) and needs it to break the limit.
LM_BF16_TOL = 0.16
# (d), (e) f32: the reference's own decode-against-prefill tolerance
# (tests/test_models.py:76); matrix products in full f32 (no TF32).
LM_F32_TOL = 2e-3


def _lm_batch(torch, np, cfg, seed, B, S, dev):
    from repro_torch.data.tokens import synthetic_batch
    toks = synthetic_batch(seed, 1, B, S, cfg.vocab)["tokens"]
    return {"tokens": torch.from_numpy(toks).to(dev)}


def _timed_generate(torch, cfg, model, batch, new, dev) -> dict:
    """A warm-up generate of 2 tokens, then ``new`` greedy tokens with the
    peak memory and the launch counts reset just before (on the card);
    ``launches`` are the timed generate's own."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import GenerationEngine
    GenerationEngine(cfg, model, max_new=2, device=dev).generate(batch)
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = GenerationEngine(cfg, model, max_new=new, device=dev) \
        .generate(batch)
    B = batch["tokens"].shape[0]
    return {"batch": B, "prompt": batch["tokens"].shape[1], "new": new,
            "layers": cfg.n_layers,
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "decode_tokens_per_s": res.tokens_per_s,
            "ms_per_step": res.decode_s / new * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated()
            if cuda else None,
            "launches": {k: v for k, v in ops.launch_counts().items() if v}}


def run_lm(torch, np, smi: str, seed: int = 0, device: str = "cuda") -> dict:
    """LM serving on the card (``GenerationEngine`` over starcoder2-3b at
    full width, seeded random weights drawn on the card):
    (a) ``launch.serve.serve_lm`` at the launcher's defaults (batch 4,
        prompt 32, 16 new, bf16): tokens in the vocabulary, finite
        logits, B8 launched once a layer and B9 once a layer a step;
    (b) a timed generate, B=8, prompt 1,024, 32 greedy tokens, and one
        more decode step there under the profiler (``profile_batch``);
    (c) the last logits of a prefill of S tokens against a prefill of
        S-1 and one decode step, bf16 (``LM_BF16_TOL``);
    (d) a 2-layer cut at full width in f32 on the card (kernels) and on
        this machine's CPU (plain versions), the same parameters: equal
        greedy tokens, logits within ``LM_F32_TOL``; (c) in f32 there;
    (e) retrieval decode at the cut with full coverage (d_low = Hd,
        every block kept) against dense decode, ``LM_F32_TOL``; then
        timed at full width with ``LM_RETRIEVAL``: B=1, prompt 8,192, 16
        new, retrieval and dense.
    The launch counts are reset just before (a) and just before (b)'s
    timed generate and read just after each (``launcher["launches"]``,
    ``timed["launches"]``; the checks on them live in ``main``: the CPU
    counts none); the check runs of (c)-(e) count nowhere.
    ``device="cpu"`` rehearses the phase with the plain versions (both
    sides of (d) on the CPU)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RetrievalConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import parser, serve_lm
    from repro_torch.models import get_model
    from repro_torch.serve.engine import (GenerationEngine, low_keys,
                                          cache_len)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = get_config(LM_ARCH)
    L = cfg.n_layers
    out = {"phase": "lm", "arch": LM_ARCH, "gpu": smi,
           "n_params": cfg.n_params(), "dtype": cfg.dtype}
    # (a)
    t0 = time.perf_counter()
    args = parser().parse_args(["--arch", LM_ARCH, "--seed", str(seed),
                                "--device", device])
    ops.reset_launch_counts()
    res = serve_lm(args)
    out["launcher"] = {
        "batch": args.batch, "prompt": args.prompt_len, "new": res.steps,
        "layers": L, "prefill_s": res.prefill_s, "decode_s": res.decode_s,
        "decode_tokens_per_s": res.tokens_per_s,
        "seconds": time.perf_counter() - t0,
        "launches": {k: v for k, v in ops.launch_counts().items() if v}}
    need(res.tokens.shape == (args.batch, args.max_new) and bool(
        ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
        f"lm (a): tokens {res.tokens.shape} outside the vocabulary")
    need(bool(np.isfinite(res.last_logits).all()), "lm (a): logits not "
         "finite")
    # (b), (c) and (e)'s timed lines on one full-width model
    ret_cfg = cfg.replace(retrieval=RetrievalConfig(**LM_RETRIEVAL))
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = get_model(ret_cfg).init(gen, dev)
    sync()
    out["init_s"] = time.perf_counter() - t0
    B, S, new = LM_TIMED
    batch = _lm_batch(torch, np, cfg, seed, B, S, dev)
    out["timed"] = _timed_generate(torch, cfg, model, batch, new, dev)
    api = get_model(cfg)
    if dev.type == "cuda":     # where a decode step's time goes
        lg, cache = api.prefill(model, batch, S + 1)
        tok = lg.argmax(-1, keepdim=True)
        out["timed"]["profiled_step"] = profile_batch(
            torch, lambda: api.decode_step(model, cache, tok, S))
    B, S, _ = LM_PARITY
    toks = _lm_batch(torch, np, cfg, seed + 1, B, S, dev)["tokens"]
    full, _ = api.prefill(model, {"tokens": toks})
    _, cache = api.prefill(model, {"tokens": toks[:, :-1]}, S)
    step, _ = api.decode_step(model, cache, toks[:, -1:], S - 1)
    rms = float(full.pow(2).mean().sqrt())
    err = float((step - full).abs().max())
    # the planted fault: the cache's other kv heads overwritten by head 0,
    # so every query head reads kv head 0, as a wrong group index would
    _, bad = api.prefill(model, {"tokens": toks[:, :-1]}, S)
    bad["k"][:, :, 1:] = bad["k"][:, :, :1]
    bad["v"][:, :, 1:] = bad["v"][:, :, :1]
    wrong, _ = api.decode_step(model, bad, toks[:, -1:], S - 1)
    err_fault = float((wrong - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    out["decode_vs_prefill_bf16"] = {
        "batch": B, "S": S, "max_abs": err, "logits_rms": rms,
        "tol": LM_BF16_TOL, "planted_fault_max_abs": err_fault,
        "argmax_equal": bool(torch.equal(step.argmax(-1), full.argmax(-1))),
        "top2_gap_min": float((top2[:, 0] - top2[:, 1]).min())}
    need(bool(torch.isfinite(full).all()) and err <= LM_BF16_TOL * rms,
         f"lm (c): decode against prefill max abs {err}, logits RMS {rms}")
    need(out["decode_vs_prefill_bf16"]["argmax_equal"], "lm (c): decode "
         "and prefill pick other tokens")
    need(err_fault > LM_BF16_TOL * rms, f"lm (c): the planted fault (kv "
         f"head 0 for every group) moved the logits only {err_fault}")
    del cache, bad
    B, S, new = LM_RETRIEVAL_TIMED
    batch = _lm_batch(torch, np, cfg, seed + 2, B, S, dev)
    out["retrieval_timed"] = {
        "settings": LM_RETRIEVAL,
        "cache_len": {"retrieval": cache_len(ret_cfg, S, new),
                      "dense": cache_len(cfg, S, new)},
        "retrieval": _timed_generate(torch, ret_cfg, model, batch, new, dev),
        "dense": _timed_generate(torch, cfg, model, batch, new, dev)}
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (d) and (e) at the 2-layer cut, f32
    cut = cfg.replace(n_layers=LM_CUT_LAYERS, dtype="float32")
    B, S, new = LM_PARITY
    # full coverage: the projection lossless (d_low = Hd) and topk past
    # every cache position, so every block is kept
    cut_r = cut.replace(retrieval=RetrievalConfig(
        enabled=True, d_low=cut.resolved_head_dim, topk=1 << 16, block=8,
        partitions=4))
    T = cache_len(cut_r, S, LM_RETRIEVAL_STEPS)
    card = get_model(cut_r).init(gen, dev)
    host = get_model(cut_r).init(None, "cpu")
    host.load_state_dict(card.state_dict())
    batch = _lm_batch(torch, np, cfg, seed + 3, B, S, dev)
    t0 = time.perf_counter()
    got = GenerationEngine(cut, card, max_new=new, device=dev) \
        .generate(batch)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = GenerationEngine(cut, host, max_new=new, device="cpu") \
        .generate({"tokens": batch["tokens"].cpu()})
    host_s = time.perf_counter() - t0
    api = get_model(cut)
    pre = [api.prefill(m, {"tokens": batch["tokens"].to(d)})[0].cpu()
           for m, d in ((card, dev), (host, "cpu"))]
    err = max(float((pre[0] - pre[1]).abs().max()),
              float(np.abs(got.last_logits - want.last_logits).max()))
    toks = batch["tokens"]
    full, _ = api.prefill(card, {"tokens": toks})
    _, cache = api.prefill(card, {"tokens": toks[:, :-1]}, S)
    step, _ = api.decode_step(card, cache, toks[:, -1:], S - 1)
    err_dp = float((step - full).abs().max())
    out["card_vs_cpu_f32"] = {
        "layers": LM_CUT_LAYERS, "batch": B, "prompt": S, "new": new,
        "tokens_equal": bool(np.array_equal(got.tokens, want.tokens)),
        "max_abs": err, "decode_vs_prefill_max_abs": err_dp,
        "tol": LM_F32_TOL, "card_s": card_s, "cpu_s": host_s}
    need(out["card_vs_cpu_f32"]["tokens_equal"], "lm (d): greedy tokens "
         f"differ card {got.tokens.tolist()} cpu {want.tokens.tolist()}")
    need(err <= LM_F32_TOL, f"lm (d): card against CPU max abs {err}")
    need(err_dp <= LM_F32_TOL, f"lm (d): f32 decode against prefill max "
         f"abs {err_dp}")
    del host
    api_r = get_model(cut_r)
    lg, cd = api.prefill(card, batch, T)
    _, cr = api_r.prefill(card, batch, T)
    cr = low_keys(card, cr)
    tok = lg.argmax(-1, keepdim=True)
    errs = []
    for i in range(LM_RETRIEVAL_STEPS):
        lg_d, cd = api.decode_step(card, cd, tok, S + i)
        lg_r, cr = api_r.decode_step(card, cr, tok, S + i)
        errs.append(float((lg_d - lg_r).abs().max()))
        tok = lg_d.argmax(-1, keepdim=True)
    out["retrieval_full_coverage"] = {
        "settings": dataclasses.asdict(cut_r.retrieval), "cache_len": T,
        "steps": LM_RETRIEVAL_STEPS, "max_abs": max(errs), "tol": LM_F32_TOL}
    need(max(errs) <= LM_F32_TOL, f"lm (e): full-coverage retrieval "
         f"against dense decode max abs {max(errs)}")
    del card, cd, cr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ------------------------------ lm_families ---------------------------------

# (a): arch -> (batch, prompt, new tokens, layers served; None: all).
# mixtral's prompt is its window, so the ring wraps at the first step;
# recurrentgemma's is its local window.
LM_FAMILIES = {
    "mixtral-8x7b": (1, 4096, 16, 8),
    "qwen3-moe-235b-a22b": (8, 1024, 16, 4),
    "whisper-medium": (4, 64, 16, None),
    "recurrentgemma-9b": (4, 2048, 16, None),
    "rwkv6-1.6b": (8, 1024, 16, None),
}
# (b): decode against prefill at (a)'s prompt, B=2 (the MoEs are left out,
# as tests/test_models.py:58-61 leaves them out: prefill and decode route
# at other capacities, 1.25 and 2.0). bf16 is recorded, not held: with
# seeded random weights bf16 rounding alone puts these deep stacks' prefill
# 0.05-0.66 of the logits' RMS from the f32 prefill of the same weights
# (whisper, recurrentgemma, rwkv6; H100, PERF.md 6), more than the
# hybrid's short ring moves them, while f32 decode against prefill reads
# 3e-6-1.1e-4 and the short ring 0.025. So the same weights, cast to f32,
# are held to LM_F32_TOL at full depth.
LM_FAMILY_DECODE = ("whisper-medium", "rwkv6-1.6b", "recurrentgemma-9b")
# (c): the full-width cut in f32, card against this machine's CPU
LM_FAMILY_CUTS = {
    "mixtral-8x7b": dict(n_layers=1),
    "qwen3-moe-235b-a22b": dict(n_layers=1),
    "whisper-medium": dict(n_layers=2, enc_layers=2),
    "recurrentgemma-9b": dict(n_layers=3),           # one group
    "rwkv6-1.6b": dict(n_layers=2),
}
LM_FAMILY_PARITY = (1, 32, 4)      # (c): batch, prompt, new tokens
CARD_BYTES = 80e9                  # one H100's memory


def family_launches(cfg, new: int) -> dict:
    """The attention launches of one generate of ``new`` tokens: B8 once
    an attention layer at prefill (whisper: the encoder's, and the
    decoder's self- and cross-attention), B9 once an attention layer a
    step; rwkv6 none."""
    if cfg.family == "ssm":
        return {}
    if cfg.family == "encdec":
        flash, dec = cfg.enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    elif cfg.family == "hybrid":
        flash = dec = cfg.n_layers // len(cfg.pattern)
    else:
        flash = dec = cfg.n_layers
    return {"flash_attention": flash, "decode_attention": dec * new}


def _family_batch(torch, np, cfg, seed, B, S, dev):
    """Tokens from ``synthetic_batch`` and whisper's stub frames, cast to
    the model's dtype as the launcher casts them."""
    from repro_torch.data.tokens import batch_extras_for, synthetic_batch
    from repro_torch.models.common import dtype_of
    b = synthetic_batch(seed, 1, B, S, cfg.vocab,
                        extras=batch_extras_for(cfg))
    b.pop("labels")
    out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    if "frames" in out:
        out["frames"] = out["frames"].to(dtype_of(cfg))
    return out


def _decode_vs_prefill(cfg, model, batch, S):
    """(max |logits| difference, the prefill's logits): the last token of
    ``batch`` decoded after a prefill of the S before it, against a
    prefill of all S + 1."""
    from repro_torch.models import get_model
    from repro_torch.serve.engine import cache_len
    api = get_model(cfg)
    toks = batch["tokens"]
    full, _ = api.prefill(model, batch)
    _, cache = api.prefill(model, dict(batch, tokens=toks[:, :S]),
                           cache_len(cfg, S, 1))
    step, _ = api.decode_step(model, cache, toks[:, S:S + 1], S)
    return float((step - full).abs().max()), step, full


def _family_decode_checks(torch, cfg, model, batch, S: int) -> dict:
    """(b) on the timed model, B=2: decode against prefill in bf16
    (recorded: finite), then the same weights cast to f32 (exact) and
    held to ``LM_F32_TOL`` at full depth, with the bf16 prefill's own
    distance from the f32 one beside it. The hybrid also decodes after
    a prompt shorter than its window (the reference's short ring,
    ROADMAP.md C: position 0 evicted at the first step), which must
    break the limit: the check sees one position missing from the
    ring."""
    two = {k: v[:2] for k, v in batch.items()}
    err, step, want = _decode_vs_prefill(cfg, model, two, S)
    rms = float(want.pow(2).mean().sqrt())
    need(bool(torch.isfinite(want).all() and torch.isfinite(step).all()),
         f"lm_families {cfg.name} (b): bf16 logits not finite")
    out = {"decode_vs_prefill_bf16": {
        "batch": 2, "S": S, "max_abs": err, "logits_rms": rms,
        "over_rms": err / rms,
        "argmax_equal": bool((step.argmax(-1) == want.argmax(-1)).all())}}
    cfg32 = cfg.replace(dtype="float32")
    model.float()
    two = {k: v.float() if v.is_floating_point() else v
           for k, v in two.items()}
    err32, _, want32 = _decode_vs_prefill(cfg32, model, two, S)
    f32 = out["decode_vs_prefill_f32"] = {
        "batch": 2, "S": S, "max_abs": err32, "tol": LM_F32_TOL,
        "logits_rms": float(want32.pow(2).mean().sqrt()),
        "bf16_prefill_vs_f32_max_abs": float((want - want32).abs().max())}
    need(err32 <= LM_F32_TOL, f"lm_families {cfg.name} (b): f32 decode "
         f"against prefill max abs {err32}")
    if cfg.family == "hybrid":
        short = S // 2
        err_s, _, _ = _decode_vs_prefill(
            cfg32, model, dict(two, tokens=two["tokens"][:, :short + 1]),
            short)
        f32["short_ring_S"] = short
        f32["short_ring_max_abs"] = err_s
        need(err_s > LM_F32_TOL, f"lm_families {cfg.name} (b): the short "
             f"ring (S = {short}) moved the logits only {err_s}")
    return out


def run_lm_families(torch, np, smi: str, seed: int = 0,
                    device: str = "cuda") -> dict:
    """The moe, encdec, hybrid and ssm families on the card
    (``GenerationEngine``, seeded random weights drawn on the card, bf16,
    full width; the MoEs cut in depth, each with a ``reduced`` line, the
    others whole), each model freed before the next:
    (a) a warm-up generate, then a timed greedy generate (``LM_FAMILIES``)
        with its own launch counts (checked exactly in ``main``:
        ``family_launches``) and one profiled decode step;
    (b) for ``LM_FAMILY_DECODE``: the last logits of a prefill of S + 1
        tokens against a prefill of S and one decode step
        (``_family_decode_checks``), in bf16 (recorded) and in f32 at
        full depth within ``LM_F32_TOL`` (recurrentgemma at S = 2,048 ->
        2,049 crosses B8's window mask and the ring's wrap);
    (c) the ``LM_FAMILY_CUTS`` cut at full width in f32 on the card
        (kernels) and on this machine's CPU (plain versions), the same
        parameters: equal greedy tokens, logits within ``LM_F32_TOL``.
    ``device="cpu"`` rehearses the phase with the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve.engine import GenerationEngine, cache_len
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    out = {"phase": "lm_families", "gpu": smi, "archs": {}, "reduced": []}
    for i, (arch, (B, S, new, layers)) in enumerate(LM_FAMILIES.items()):
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = full if layers is None else full.replace(n_layers=layers)
        r = out["archs"][arch] = {
            "family": cfg.family, "layers": cfg.n_layers,
            "n_params": cfg.n_params(), "bf16_bytes": 2 * cfg.n_params()}
        if layers is not None:
            out["reduced"].append({
                "arch": arch, "layers": layers, "of": full.n_layers,
                "why": f"{2 * full.n_params() / 1e9:.1f} GB of bf16 weights "
                       f"against the card's {CARD_BYTES / 1e9:.0f} GB; "
                       f"{layers} layers take "
                       f"{2 * cfg.n_params() / 1e9:.1f} GB"})
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        t0 = time.perf_counter()
        model = get_model(cfg).init(gen, dev)
        if cuda:
            torch.cuda.synchronize()
        r["init_s"] = time.perf_counter() - t0
        batch = _family_batch(torch, np, cfg, seed + i, B, S + 1, dev)
        prompt = dict(batch, tokens=batch["tokens"][:, :S])
        r["timed"] = _timed_generate(torch, cfg, model, prompt, new, dev)
        r["timed"]["expected_launches"] = family_launches(cfg, new)
        api = get_model(cfg)
        if cuda:
            lg, cache = api.prefill(model, prompt, cache_len(cfg, S, 1))
            tok = lg.argmax(-1, keepdim=True)
            r["timed"]["profiled_step"] = profile_batch(
                torch, lambda: api.decode_step(model, cache, tok, S))
            del cache
        if arch in LM_FAMILY_DECODE:
            r.update(_family_decode_checks(torch, cfg, model, batch, S))
        del model
        if cuda:
            torch.cuda.empty_cache()
        # (c) the full-width cut in f32
        cut = full.replace(dtype="float32", **LM_FAMILY_CUTS[arch])
        Bc, Sc, newc = LM_FAMILY_PARITY
        card = get_model(cut).init(gen, dev)
        host = get_model(cut).init(None, "cpu")
        host.load_state_dict(card.state_dict())
        cb = _family_batch(torch, np, cut, seed + 10 + i, Bc, Sc, dev)
        t0 = time.perf_counter()
        got = GenerationEngine(cut, card, max_new=newc, device=dev) \
            .generate(cb)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = GenerationEngine(cut, host, max_new=newc, device="cpu") \
            .generate({k: v.cpu() for k, v in cb.items()})
        host_s = time.perf_counter() - t0
        err = float(np.abs(got.last_logits - want.last_logits).max())
        r["card_vs_cpu_f32"] = {
            "cut": LM_FAMILY_CUTS[arch], "batch": Bc, "prompt": Sc,
            "new": newc, "tokens_equal": bool(np.array_equal(got.tokens,
                                                             want.tokens)),
            "max_abs": err, "tol": LM_F32_TOL, "card_s": card_s,
            "cpu_s": host_s}
        need(r["card_vs_cpu_f32"]["tokens_equal"], f"lm_families {arch} "
             f"(c): greedy tokens differ card {got.tokens.tolist()} cpu "
             f"{want.tokens.tolist()}")
        need(err <= LM_F32_TOL, f"lm_families {arch} (c): card against CPU "
             f"max abs {err}")
        del card, host
        if cuda:
            torch.cuda.empty_cache()
        r["seconds"] = time.perf_counter() - t_arch
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------- train ------------------------------------

TRAIN_ARCH = "starcoder2-3b"
# (a): global batch, sequence (train_4k's), timed steps after one warm-up
TRAIN_TIMED = (8, 4096, 2)
TRAIN_CUT_LAYERS = 2               # (b): the full-width cut, f32
TRAIN_PARITY = (2, 64)             # (b): batch, sequence of the cut
TRAIN_FAMILIES = ("mixtral-8x7b", "internvl2-76b", "whisper-medium",
                  "recurrentgemma-9b", "rwkv6-1.6b")
TRAIN_FAMILY_BATCH = (2, 32)       # (b): the smoke configs' batch, sequence
TRAIN_RESUME = (8, 64, 4)          # (c): batch, sequence (the launcher's
                                   # --smoke shape), steps
# (b): the CPU tests' tolerances (tests/test_torch_train_loss.py): the loss
# to rtol 1e-5, each gradient leaf within 1e-4 of its largest magnitude
# plus 1e-7 (f32 on both sides, matrix products without TF32)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL, TRAIN_GRAD_ABS = 1e-4, 1e-7


def train_flops(cfg, B: int, S: int) -> dict:
    """The FLOPs of one training step under ``remat="full"``: the matrix
    products (2 a weight a token forward, twice that backward, and one
    more forward recomputed; the embedding is a gather) and
    ``blocked_attention``'s two products, every causal block computed
    (the reference's q-chunks skip none)."""
    tokens = B * S
    dense = cfg.n_params() - cfg.vocab * cfg.d_model
    attn = 4 * B * S * S * cfg.n_heads * cfg.resolved_head_dim \
        * cfg.n_layers
    fwd = 2 * dense * tokens + attn
    return {"matmul": 8 * dense * tokens, "attention": 4 * attn,
            "total": 4 * fwd}


def _loss_and_grads(torch, api, model, batch):
    loss, metrics = api.loss(model, batch)
    loss.backward()
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), \
        {k: float(v.detach()) for k, v in metrics.items()}, \
        grads


def _card_vs_cpu(torch, np, cfg, card, host, batch, dev) -> dict:
    """One loss and backward of the same parameters and batch on the card
    and on this machine's CPU: the losses, the metrics and every
    gradient leaf, against the CPU tests' tolerances."""
    from repro_torch.models import get_model
    api = get_model(cfg)
    t0 = time.perf_counter()
    cl, cm, cg = _loss_and_grads(torch, api, card,
                                 {k: v.to(dev) for k, v in batch.items()})
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hl, hm, hg = _loss_and_grads(torch, api, host, batch)
    cpu_s = time.perf_counter() - t0
    worst, worst_leaf = 0.0, None
    for n, want in hg.items():
        scale = float(want.abs().max())
        err = float((cg[n] - want).abs().max())
        need(err <= TRAIN_GRAD_REL * scale + TRAIN_GRAD_ABS,
             f"train (b) {cfg.name}: gradient {n} off by {err} at scale "
             f"{scale}")
        if scale > 1e-6 and err / scale > worst:
            worst, worst_leaf = err / scale, n
    need(abs(cl - hl) <= TRAIN_LOSS_RTOL * abs(hl),
         f"train (b) {cfg.name}: loss card {cl} cpu {hl}")
    need(cm.get("dropped_frac") == hm.get("dropped_frac"),
         f"train (b) {cfg.name}: dropped_frac card {cm} cpu {hm}")
    return {"loss_card": cl, "loss_cpu": hl,
            "loss_rel": abs(cl - hl) / abs(hl), "metrics_card": cm,
            "metrics_cpu": hm, "grad_leaves": len(hg),
            "worst_grad_rel": worst, "worst_grad_leaf": worst_leaf,
            "card_s": card_s, "cpu_s": cpu_s}


def _profile_layer(torch, cfg, model, B: int, S: int, dev) -> dict:
    """One block's forward and backward at a microbatch's shape under
    the profiler (``profile_batch``): where a layer's time goes. (A
    whole microbatch launches ~40,000 kernels, whose trace takes the
    profiler ~45 s to reduce on the card's host.)"""
    from repro_torch.models.transformer import _layer_fwd
    x = torch.randn((B, S, cfg.d_model), dtype=model.emb.dtype, device=dev,
                    requires_grad=True)
    pos = torch.arange(S, device=dev)

    def layer():
        h, _ = _layer_fwd(cfg, model.layers[0], x, pos)
        h.float().sum().backward()
        model.zero_grad(set_to_none=True)
    layer()
    return profile_batch(torch, layer, top=12)


def _train_batch(torch, cfg, seed, B, S):
    from repro_torch.data.tokens import batch_extras_for, synthetic_batch
    return {k: torch.from_numpy(v) for k, v in synthetic_batch(
        seed, 0, B, S, cfg.vocab, extras=batch_extras_for(cfg)).items()}


TRAIN_CKPT_DEVICE_BYTES = 1 << 30   # (a): a checkpoint's device memory


def _checkpoint_state(torch, cfg, model, opt, dev) -> dict:
    """What ``TrainLoop`` hands its async checkpoint at full width:
    ``train.loop.state_tree`` (parameters, ``m``, ``v`` and ``step`` in
    the reference's layout, new host arrays, copied a block at a time
    and stacked on the host). Records its seconds, the host bytes and
    the device memory it takes above what was allocated before it,
    which must stay under ``TRAIN_CKPT_DEVICE_BYTES`` (one transposed
    block, not the stacked state)."""
    from repro_torch.train.loop import state_tree
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tree = state_tree(cfg, model, opt)
    seconds = time.perf_counter() - t0
    host = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        for v in node.values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                host += v.nbytes
    extra = torch.cuda.max_memory_allocated() - base if cuda else None
    del tree
    if cuda:
        need(extra <= TRAIN_CKPT_DEVICE_BYTES,
             f"train (a): the checkpoint's state took {extra} bytes of "
             f"device memory")
    return {"seconds": seconds, "host_bytes": host,
            "device_bytes_above": extra}


def _resume_on_card(torch, cfg, dev, seed) -> dict:
    """(c): ``TrainLoop`` for ``TRAIN_RESUME``'s steps straight, against
    half of them, a new loop resuming from the checkpoint, and the
    rest: losses after the restart and final parameters bit for bit."""
    import shutil
    import tempfile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import TrainLoop, TrainLoopConfig
    B, S, steps = TRAIN_RESUME
    half = steps // 2
    shape = ShapeConfig("smoke", S, B, "train")
    d = tempfile.mkdtemp(prefix="chip_smoke_train_")
    run = lambda n, sub: TrainLoop(
        cfg, shape, None, TrainLoopConfig(steps=n, seed=seed, ckpt_every=half,
                                          log_every=1_000,
                                          ckpt_dir=f"{d}/{sub}"),
        device=dev)
    try:
        straight = run(steps, "a")
        straight.run()
        run(half, "b").run()
        resumed = run(steps, "b")
        resumed.run()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = [m["loss"] for m in resumed.metrics_log]
    want = [m["loss"] for m in straight.metrics_log][half:]
    params_equal = all(torch.equal(a, b) for a, b in zip(
        resumed.model.parameters(), straight.model.parameters()))
    need(got == want, f"train (c): resumed losses {got}, straight {want}")
    need(params_equal, "train (c): the resumed parameters differ from the "
         "straight run's")
    return {"arch": cfg.name, "batch": B, "seq": S, "steps": steps,
            "resumed_at": half, "losses_straight":
            [m["loss"] for m in straight.metrics_log],
            "losses_resumed": got, "losses_equal": got == want,
            "params_equal": params_equal}


def run_train(torch, np, smi: str, seed: int = 0,
              device: str = "cuda") -> dict:
    """LM training on the card (the port's ``build_train_step``:
    ``api.loss`` through ``blocked_attention`` and ``chunked_xent``,
    backward, f32 gradient sums over the microbatches, ``adamw_update``
    in place; no attention kernel):
    (a) starcoder2-3b at full width and depth, bf16, ``remat="full"``,
        seeded weights drawn on the card, sequence 4,096 (train_4k's),
        global batch 8 (``default_microbatches``: 4 of 2) from
        ``TokenPipeline``: one warm-up step, then ``TRAIN_TIMED``'s
        timed steps: seconds a step, tokens/s, the FLOPs a step and the
        rate, peak memory, loss and gradient norm (finite, the norm > 0),
        and the attention kernels' launches (0: the counts are reset just
        before the timed steps and read just after; checked in
        ``main``); then one block's forward and backward at a
        microbatch's shape under the profiler (``_profile_layer``), and
        the state a checkpoint takes, with the device memory it adds
        (``_checkpoint_state``);
    (b) one loss and backward card against this machine's CPU in f32,
        the same parameters and batch: a 2-layer cut of starcoder2-3b at
        full width, then the smoke config of one arch each of the moe,
        vlm, encdec, hybrid and ssm families (``_card_vs_cpu``);
    (c) resume on the card (``_resume_on_card``): starcoder2-3b's smoke
        config at the launcher's --smoke shape.
    ``device="cpu"`` rehearses the phase (point ``get_config`` at a
    smoke config and cut ``TRAIN_TIMED``)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    out = {"phase": "train", "gpu": smi}
    # (a) the timed run at full width
    cfg = get_config(TRAIN_ARCH)
    B, S, n_timed = TRAIN_TIMED
    shape = ShapeConfig("train_4k_b8", S, B, "train")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = get_model(cfg).init(gen, dev).requires_grad_(True)
    opt = adamw_init(model)
    sync()
    init_s = time.perf_counter() - t0
    step, specs = build_train_step(cfg, None, shape)
    pipe = TokenPipeline(cfg, shape, seed=seed, device=dev)
    try:
        _, batch = next(pipe)
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        sync()
        warm_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        steps = []
        for _ in range(n_timed):
            _, batch = next(pipe)
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, batch)
            sync()
            steps.append({"seconds": time.perf_counter() - t0,
                          **{k: float(v) for k, v in m.items()}})
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() if cuda else None
        if cuda:
            profiled = _profile_layer(torch, cfg, model,
                                      B // specs["microbatches"], S, dev)
        ckpt_state = _checkpoint_state(torch, cfg, model, opt, dev)
    finally:
        pipe.close()
    s_step = sum(r["seconds"] for r in steps) / n_timed
    flops = train_flops(cfg, B, S)
    out["timed"] = {
        "arch": TRAIN_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_params": cfg.n_params(), "dtype": cfg.dtype, "remat": cfg.remat,
        "global_batch": B, "seq_len": S,
        "microbatches": specs["microbatches"], "init_s": init_s,
        "warmup_s": warm_s, "steps": steps, "s_per_step": s_step,
        "tokens_per_s": B * S / s_step, "flops_per_step": flops,
        "tflops_per_s": flops["total"] / s_step / 1e12,
        "max_memory_allocated": peak, "launches": launches,
        "profiled_layer": profiled if cuda else None,
        "checkpoint_state": ckpt_state}
    for r in steps:
        need(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
             and r["grad_norm"] > 0, f"train (a): step {r}")
    del model, opt, step, batch, m
    if cuda:
        torch.cuda.empty_cache()
    # (b) card against CPU in f32
    out["card_vs_cpu"] = {}
    cut = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_CUT_LAYERS,
                                         dtype="float32")
    cases = [(f"{TRAIN_ARCH}-cut{TRAIN_CUT_LAYERS}", cut, TRAIN_PARITY)] + \
        [(a, get_smoke_config(a), TRAIN_FAMILY_BATCH) for a in TRAIN_FAMILIES]
    for i, (name, c, (b, s)) in enumerate(cases):
        card = get_model(c).init(gen, dev).requires_grad_(True)
        host = get_model(c).init(None, "cpu")
        host.load_state_dict(card.state_dict())
        host.requires_grad_(True)
        r = out["card_vs_cpu"][name] = _card_vs_cpu(
            torch, np, c, card, host, _train_batch(torch, c, seed + i, b, s),
            dev)
        r.update(batch=b, seq=s, layers=c.n_layers, d_model=c.d_model)
        del card, host
    if cuda:
        torch.cuda.empty_cache()
    # (c) resume, bit for bit
    out["resume"] = _resume_on_card(torch, get_smoke_config(TRAIN_ARCH),
                                    dev, seed)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ------------------------------- mesh_lm ----------------------------------

MESH_TRAIN_ARCH = "starcoder2-3b"
MESH_TRAIN = dict(layers=4, batch=8, seq=4096, mesh=(2, 2), timed=2)
MESH_TRAIN_CUT = dict(layers=2, batch=4, seq=64)    # (a) card vs CPU, f32
MESH_RESUME = (8, 64, 4)           # (b): batch, sequence, steps (TrainLoop)
MESH_SERVE_ARCH = "mixtral-8x7b"
MESH_SERVE = dict(layers=2, batch=8, prompt=1024, new=16, mesh=(2, 4))
MESH_SERVE_CUT = dict(layers=1, batch=2, prompt=32, new=3)  # (c) vs CPU, f32
MESH_PIPE = dict(d=3072, layers=8, micro=8, batch=2, seq=128, mesh=(1, 4))
MESH_PIPE_TOL = 1e-5


def _grid_mesh(shape, device):
    from repro_torch.core.distributed import make_mesh
    n = 1
    for k in shape:
        n *= k
    return make_mesh(shape, ("data", "model"), devices=[device] * n)


def _check_layout(torch, leaves, shardings, what: str) -> None:
    """Each ``Sharded`` leaf laid out by its sharding: its spec, and each
    stored block of its block's shape on its position's device, every
    (block, device) pair once."""
    for n, leaf in leaves.items():
        want = shardings[n]
        need(tuple(leaf.sharding.spec) == tuple(want.spec),
             f"{what}: {n} laid out {leaf.sharding.spec}, not {want.spec}")
        keys = leaf.keys()
        need(list(leaf.blocks) == list(dict.fromkeys(keys)),
             f"{what}: {n} stores {len(leaf.blocks)} blocks for "
             f"{len(set(keys))} (block, device) pairs")
        for (idx, dev), b in leaf.blocks.items():
            shape = [hi - lo for lo, hi in leaf.block_range(idx)]
            need(list(b.shape) == shape and b.device == dev,
                 f"{what}: {n} block {idx} is {list(b.shape)} on "
                 f"{b.device}, not {shape} on {dev}")


def _moe_probe():
    """Wrap ``moe._apply_moe_sharded`` and ``moe._apply_moe_local``: the
    calls of each ("sharded", "local") and every call's dropped_frac
    tensor in order ("dropped", with its kind in "kinds") until
    ``restore()``."""
    from repro_torch.models import moe as moe_mod
    orig = {"sharded": moe_mod._apply_moe_sharded,
            "local": moe_mod._apply_moe_local}
    log = {"sharded": 0, "local": 0, "dropped": [], "kinds": []}

    def wrap(kind):
        def probe(*a, **kw):
            y, m = orig[kind](*a, **kw)
            log[kind] += 1
            log["dropped"].append(m["dropped_frac"])
            log["kinds"].append(kind)
            return y, m
        return probe
    moe_mod._apply_moe_sharded = wrap("sharded")
    moe_mod._apply_moe_local = wrap("local")

    def restore():
        moe_mod._apply_moe_sharded = orig["sharded"]
        moe_mod._apply_moe_local = orig["local"]
    log["restore"] = restore
    return log


def _mesh_train_cut(torch, np, cfg, seed, dev) -> dict:
    """(a) card against CPU: one mesh train step of the same parameters
    and batch on a mesh of the card and the same mesh shape of "cpu":
    the step's gradients first (``specs["grads"]``, before the update),
    each leaf within ``TRAIN_GRAD_REL`` of the CPU leaf's largest +
    ``TRAIN_GRAD_ABS``; then the step: the loss and the gradient norm
    to ``TRAIN_LOSS_RTOL``, each parameter after the step within the
    gradients' bar. (AdamW's first step moves an element by about lr x
    the sign of its gradient, so the parameters alone cannot see a
    wrong gradient.)"""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import (adamw_init_sharded,
                                          build_train_step, shard_params)
    from repro_torch.models import get_model
    c = MESH_TRAIN_CUT
    shape = ShapeConfig("cut", c["seq"], c["batch"], "train")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = get_model(cfg).init(gen, dev)
    named = {n: p.detach() for n, p in model.named_parameters()}
    batch = _train_batch(torch, cfg, seed, c["batch"], c["seq"])
    res, states, grads = {}, {}, {}
    for where in (dev, torch.device("cpu")):
        mesh = _grid_mesh(MESH_TRAIN["mesh"], where)
        step, specs = build_train_step(cfg, mesh, shape)
        params = shard_params({n: t.to(where) for n, t in named.items()},
                              specs["p_sh"], requires_grad=True)
        opt = adamw_init_sharded(params)
        t0 = time.perf_counter()
        g, _ = specs["grads"](params, batch)
        grads[where.type] = {n: leaf.gather().cpu() for n, leaf in
                             g.items()}
        grads_s = time.perf_counter() - t0
        del g
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        secs = time.perf_counter() - t0
        res[where.type] = {"seconds": secs, "grads_seconds": grads_s,
                           "microbatches": specs["microbatches"],
                           **{k: float(v) for k, v in m.items()}}
        states[where.type] = (params, opt, specs)
    hl, cl = res["cpu"]["loss"], res[dev.type]["loss"]
    need(abs(cl - hl) <= TRAIN_LOSS_RTOL * abs(hl),
         f"mesh_lm (a) {cfg.shard_profile}: loss card {cl} cpu {hl}")
    hn, cn = res["cpu"]["grad_norm"], res[dev.type]["grad_norm"]
    need(abs(cn - hn) <= TRAIN_LOSS_RTOL * abs(hn) and hn > 0,
         f"mesh_lm (a) {cfg.shard_profile}: grad_norm card {cn} cpu {hn}")
    worst_g = 0.0
    for n, want in grads["cpu"].items():
        scale = float(want.abs().max())
        err = float((grads[dev.type][n] - want).abs().max())
        need(err <= TRAIN_GRAD_REL * scale + TRAIN_GRAD_ABS,
             f"mesh_lm (a) {cfg.shard_profile}: gradient {n} off by {err} "
             f"at scale {scale}")
        worst_g = max(worst_g, err / max(scale, 1e-30))
    del grads
    worst = 0.0
    with torch.no_grad():
        for n, leaf in states["cpu"][0].items():
            want = leaf.gather()
            got = states[dev.type][0][n].gather().cpu()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            need(err <= TRAIN_GRAD_REL * scale + TRAIN_GRAD_ABS,
                 f"mesh_lm (a) {cfg.shard_profile}: parameter {n} off by "
                 f"{err} at scale {scale}")
            worst = max(worst, err / max(scale, 1e-30))
    return {"profile": cfg.shard_profile, "layers": cfg.n_layers,
            "batch": c["batch"], "seq": c["seq"], "card": res[dev.type],
            "cpu": res["cpu"], "loss_rel": abs(cl - hl) / abs(hl),
            "grad_norm_rel": abs(cn - hn) / hn, "worst_grad_rel": worst_g,
            "worst_param_rel": worst}, states[dev.type]


def _mesh_restore(torch, cfg, state, seed, dev) -> dict:
    """(b): the cut's state saved from its (2, 2) mesh and restored onto a
    (1, 4) mesh (``train.loop.load_state_sharded``), and the live tree
    ``remesh``ed there: every leaf bit-equal; then ``TrainLoop`` on the
    (2, 2) mesh resumes bit for bit."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.fault import remesh
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.train import TrainLoop, TrainLoopConfig
    from repro_torch.train.loop import (load_state_sharded, state_like,
                                        state_tree)
    params, opt, specs = state
    mesh14 = _grid_mesh((1, 4), dev)
    p_sh14 = param_shardings(cfg, specs["skeleton"], mesh14)
    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = {}
    try:
        t0 = time.perf_counter()
        save_checkpoint(d, 1, state_tree(cfg, params, opt))
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = restore_checkpoint(d, 1, like=state_like(cfg))
        p14, o14 = load_state_sharded(cfg, tree, p_sh14)
        out["restore_s"] = time.perf_counter() - t0
        live = remesh(params, p_sh14)
        with torch.no_grad():
            for n, leaf in params.items():
                want = leaf.gather()
                for what, got in (("restored", p14[n]), ("remeshed",
                                                         live[n])):
                    need(torch.equal(got.gather(), want),
                         f"mesh_lm (b): {what} {n} differs")
                for k in ("m", "v"):
                    need(torch.equal(o14[k][n].gather(),
                                     opt[k][n].gather()),
                         f"mesh_lm (b): restored {k}[{n}] differs")
        need(int(o14["step"]) == int(opt["step"]), "mesh_lm (b): step")
        out["leaves_equal"] = len(params)
        del tree, p14, o14, live
        # TrainLoop on the (2, 2) mesh: straight against half + resume
        from repro_torch.configs import get_smoke_config
        B, S, steps = MESH_RESUME
        half = steps // 2
        scfg = get_smoke_config(cfg.name)
        mesh = _grid_mesh(MESH_TRAIN["mesh"], dev)
        run = lambda n, sub: TrainLoop(
            scfg, ShapeConfig("smoke", S, B, "train"), mesh,
            TrainLoopConfig(steps=n, seed=seed, ckpt_every=half,
                            log_every=1_000, ckpt_dir=f"{d}/{sub}"))
        straight = run(steps, "a")
        straight.run()
        run(half, "b").run()
        resumed = run(steps, "b")
        resumed.run()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = [m["loss"] for m in resumed.metrics_log]
    want = [m["loss"] for m in straight.metrics_log][half:]
    need(got == want, f"mesh_lm (b): resumed losses {got}, straight {want}")
    with torch.no_grad():
        equal = all(torch.equal(resumed.model[n].gather(),
                                straight.model[n].gather())
                    for n in straight.model)
    need(equal, "mesh_lm (b): the resumed parameters differ")
    out["resume"] = {"arch": scfg.name, "batch": B, "seq": S,
                     "steps": steps, "resumed_at": half,
                     "losses_resumed": got, "params_equal": equal}
    return out


def _mesh_generate(torch, cfg, mesh, params, batch, new, dev,
                   timed=False) -> dict:
    """Prefill (cache ``prompt + new``) and ``new`` greedy decode steps
    through ``build_prefill_step`` / ``build_serve_step``: tokens,
    logits (on the host), the cache and, timed, the seconds."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    B, S = batch["tokens"].shape
    T = S + new
    pf, pspecs = build_prefill_step(cfg, mesh,
                                    ShapeConfig("p", S, B, "prefill"))
    sv, sspecs = build_serve_step(cfg, mesh, ShapeConfig("d", T, B,
                                                          "decode"))
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    lg, cache = pf(params, batch, T)
    tok = lg.gather().argmax(-1, keepdim=True)
    sync()
    prefill_s = time.perf_counter() - t0
    logits, toks = [lg.gather().cpu()], [tok.cpu()]
    t0 = time.perf_counter()
    for i in range(new):
        lg, cache = sv(params, cache, tok, S + i)
        g = lg.gather()
        tok = g.argmax(-1, keepdim=True)
        if not timed:
            logits.append(g.cpu())
            toks.append(tok.cpu())
    sync()
    decode_s = time.perf_counter() - t0
    if timed:
        logits.append(g.cpu())
        toks.append(tok.cpu())
    return {"tokens": torch.cat(toks, 1), "logits": logits, "cache": cache,
            "c_sh": sspecs["c_sh"], "prefill_s": prefill_s,
            "decode_s": decode_s}


def _mesh_serve(torch, np, cfg, seed, dev) -> dict:
    """(c): mixtral-8x7b on a (2, 4) mesh at full width, bf16: a timed
    prefill, the expert-parallel dispatch in every MoE layer and B8 on
    each data row, and greedy decode, each MoE layer dispatching locally
    over the whole batch (the reference's serve step sets no mesh) and
    B9 on that one computing unit; then the full-width f32 cut card
    against CPU."""
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import computing_units, shard_params
    from repro_torch.models import get_model
    s = MESH_SERVE
    mesh = _grid_mesh(s["mesh"], dev)
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = get_model(cfg).init(gen, dev)
    p_sh = param_shardings(cfg, model, mesh)
    params = shard_params(model, p_sh)
    want_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    del model
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    _check_layout(torch, params, p_sh, "mesh_lm (c) parameters")
    stored = sum(leaf.nbytes for leaf in params.values())
    need(stored == want_bytes, f"mesh_lm (c): {stored} bytes stored for "
         f"{want_bytes} of parameters")
    batch = _lm_batch(torch, np, cfg, seed, s["batch"], s["prompt"], dev)
    # warm-up: a prefill and 2 steps
    _mesh_generate(torch, cfg, mesh, params, batch, 2, dev)
    units = len(computing_units(cfg, mesh, s["batch"], "prefill"))
    d_units = len(computing_units(cfg, mesh, s["batch"], "decode"))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    probe = _moe_probe()
    ops.reset_launch_counts()
    try:
        run = _mesh_generate(torch, cfg, mesh, params, batch, s["new"], dev,
                             timed=True)
    finally:
        probe["restore"]()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    cache = run["cache"]
    for name in ("k", "v"):
        _check_layout(torch, {name: cache[name]}, run["c_sh"],
                      "mesh_lm (c) cache")
    toks, lg = run["tokens"], run["logits"][-1]
    need(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
         "mesh_lm (c): a token outside the vocabulary")
    need(bool(torch.isfinite(lg).all()), "mesh_lm (c): logits not finite")
    # the prefill dispatches expert-parallel a data row (a unit each);
    # every decode step locally over the whole batch, one unit, as the
    # reference's serve step (no mesh context)
    calls_want = {"sharded": cfg.n_layers * units,
                  "local": cfg.n_layers * d_units * s["new"]}
    calls = {k: probe[k] for k in calls_want}
    need(calls == calls_want, f"mesh_lm (c): the MoE dispatches ran "
         f"{calls} times, not {calls_want}")
    need(probe["kinds"][:calls_want["sharded"]]
         == ["sharded"] * calls_want["sharded"],
         "mesh_lm (c): a prefill MoE layer did not dispatch "
         "expert-parallel")
    dropped = [float(x) for x in probe["dropped"]]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": s["mesh"],
           "batch": s["batch"], "prompt": s["prompt"], "new": s["new"],
           "computing_units": units, "computing_units_decode": d_units,
           "init_s": init_s,
           "param_bytes": stored, "prefill_s": run["prefill_s"],
           "decode_s": run["decode_s"],
           "ms_per_step": run["decode_s"] / s["new"] * 1e3,
           "max_memory_allocated": peak, "launches": launches,
           "expected_launches": {
               "flash_attention": cfg.n_layers * units,
               "decode_attention": cfg.n_layers * d_units * s["new"]},
           "moe_calls": calls,
           "dropped_frac_prefill": dropped[:cfg.n_layers * units],
           "dropped_frac_decode_max": max(dropped[cfg.n_layers * units:])}
    del params, run, cache
    if cuda:
        torch.cuda.empty_cache()
    # the f32 cut, card against CPU
    c = MESH_SERVE_CUT
    cut = cfg.replace(n_layers=c["layers"], dtype="float32")
    model = get_model(cut).init(gen, dev)
    named = {n: p.detach() for n, p in model.named_parameters()}
    del model
    batch = _lm_batch(torch, np, cut, seed + 1, c["batch"], c["prompt"],
                      "cpu")
    res = {}
    for where in (dev, torch.device("cpu")):
        m = _grid_mesh(s["mesh"], where)
        p = shard_params({n: t.to(where) for n, t in named.items()},
                         param_shardings(cut, named, m))
        probe = _moe_probe()
        try:
            r = _mesh_generate(torch, cut, m, p, {"tokens": batch[
                "tokens"].to(where)}, c["new"], where)
        finally:
            probe["restore"]()
        r["dropped"] = [float(x) for x in probe["dropped"]]
        res[where.type] = r
        del p
    hc, cc = res["cpu"], res[dev.type]
    need(torch.equal(cc["tokens"], hc["tokens"]),
         f"mesh_lm (c) cut: tokens card {cc['tokens'].tolist()} cpu "
         f"{hc['tokens'].tolist()}")
    err = max(float((a - b).abs().max()) for a, b in zip(cc["logits"],
                                                         hc["logits"]))
    need(err <= LM_F32_TOL, f"mesh_lm (c) cut: logits off by {err}")
    need(cc["dropped"] == hc["dropped"], f"mesh_lm (c) cut: dropped_frac "
         f"card {cc['dropped']} cpu {hc['dropped']}")
    out["card_vs_cpu"] = {"layers": c["layers"], "batch": c["batch"],
                          "prompt": c["prompt"], "new": c["new"],
                          "max_logit_err": err, "tokens_equal": True,
                          "dropped_frac": cc["dropped"]}
    return out


def _mesh_pipeline(torch, np, seed, dev) -> dict:
    """(d): ``build_pipeline_forward`` on a (1, 4) mesh with the
    reference test's layer, tanh(x @ W), against the sequential forward
    in f32."""
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  build_pipeline_forward)
    p = MESH_PIPE
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, M, D = p["layers"], p["micro"], p["d"]
    params = {"w": torch.randn((L, D, D), generator=gen, device=dev)
              / D ** 0.5}
    xs = torch.randn((M, p["batch"], p["seq"], D), generator=gen, device=dev)
    layer_fn = lambda lp, x: torch.tanh(x @ lp["w"])
    mesh = _grid_mesh(p["mesh"], dev)
    pf = build_pipeline_forward(mesh, layer_fn, L)
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    with torch.no_grad():
        pf(params, xs)
        sync()
        t0 = time.perf_counter()
        out = pf(params, xs)
        sync()
        pipe_s = time.perf_counter() - t0
        h = xs
        t0 = time.perf_counter()
        for l in range(L):
            h = layer_fn({"w": params["w"][l]}, h)
        sync()
        seq_s = time.perf_counter() - t0
    err = float((out - h).abs().max())
    need(err <= MESH_PIPE_TOL, f"mesh_lm (d): pipeline off by {err}")
    stages = mesh.shape["model"]
    return {"d": D, "layers": L, "microbatches": M, "stages": stages,
            "max_abs_err": err, "bubble_fraction": bubble_fraction(stages, M),
            "pipeline_s": pipe_s, "sequential_s": seq_s}


def run_mesh_lm(torch, np, smi: str, seed: int = 0,
                device: str = "cuda") -> dict:
    """The LM side on a mesh of one card repeated (``make_mesh(...,
    devices=["cuda:0"] * n)``), through ``launch.steps``:
    (a) starcoder2-3b at full width, ``MESH_TRAIN``'s depth, bf16, a
        (2, 2) mesh, sequence 4,096, global batch 8 in
        ``default_microbatches``: every stored block laid out by
        ``param_specs``, one copy of the parameters, ``m`` and ``v``
        stored, a warm-up and timed steps (s a step, tokens/s, peak
        memory; finite loss, gradient norm > 0, no attention kernel);
        then a full-width f32 cut card against CPU, under "tp" and
        "fsdp" (``_mesh_train_cut``);
    (b) the cut's state saved and restored onto a (1, 4) mesh,
        ``remesh``, and ``TrainLoop`` resuming on the (2, 2) mesh, bit
        for bit (``_mesh_restore``);
    (c) mixtral-8x7b serving on a (2, 4) mesh (``_mesh_serve``);
    (d) the GPipe pipeline (``_mesh_pipeline``).
    ``device="cpu"`` rehearses the phase (point ``get_config`` at smoke
    configs and cut the sizes above)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed.sharding import tree_nbytes
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (adamw_init_sharded,
                                          build_train_step, shard_params)
    from repro_torch.models import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    out = {"phase": "mesh_lm", "gpu": smi, "reduced": []}
    # (a) training on a (2, 2) mesh at full width
    a = MESH_TRAIN
    full = get_config(MESH_TRAIN_ARCH)
    cfg = full.replace(n_layers=a["layers"])
    out["reduced"].append({"mesh_train_layers": a["layers"],
                           "of": full.n_layers, "why": (
        "the mesh phases' training checks layouts, bytes and parity, not "
        "the full model's rate (the train phase times 30 layers on one "
        f"card); 4 layers keep them inside the {TIME_LIMIT_S} s limit")})
    mesh = _grid_mesh(a["mesh"], dev)
    shape = ShapeConfig("train_4k_b8", a["seq"], a["batch"], "train")
    step, specs = build_train_step(cfg, mesh, shape)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = get_model(cfg).init(gen, dev)
    params = shard_params(model, specs["p_sh"], requires_grad=True)
    want_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    want_f32 = sum(p.numel() * 4 for p in model.parameters())
    del model
    opt = adamw_init_sharded(params)
    sync()
    init_s = time.perf_counter() - t0
    _check_layout(torch, params, specs["p_sh"], "mesh_lm (a) parameters")
    for k in ("m", "v"):
        _check_layout(torch, opt[k], specs["o_sh"][k], f"mesh_lm (a) {k}")
    stored = {"params": tree_nbytes(params), "m": tree_nbytes(opt["m"]),
              "v": tree_nbytes(opt["v"])}
    need(stored == {"params": want_bytes, "m": want_f32, "v": want_f32},
         f"mesh_lm (a): stored {stored}, one copy is {want_bytes} of "
         f"parameters and {want_f32} each of m and v")
    pipe = TokenPipeline(cfg, shape, seed=seed, shardings=specs["b_sh"])
    try:
        _, batch = next(pipe)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        sync()
        warm_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        steps = []
        for _ in range(a["timed"]):
            _, batch = next(pipe)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            sync()
            steps.append({"seconds": time.perf_counter() - t0,
                          **{k: float(v) for k, v in m.items()}})
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() if cuda else None
    finally:
        pipe.close()
    for r in steps:
        need(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
             and r["grad_norm"] > 0, f"mesh_lm (a): step {r}")
    s_step = sum(r["seconds"] for r in steps) / len(steps)
    out["train"] = {"arch": cfg.name, "layers": cfg.n_layers,
                    "d_model": cfg.d_model, "mesh": a["mesh"],
                    "global_batch": a["batch"], "seq_len": a["seq"],
                    "microbatches": specs["microbatches"],
                    "stored_bytes": stored, "init_s": init_s,
                    "warmup_s": warm_s, "steps": steps, "s_per_step": s_step,
                    "tokens_per_s": a["batch"] * a["seq"] / s_step,
                    "max_memory_allocated": peak, "launches": launches}
    del params, opt, step, batch, m
    if cuda:
        torch.cuda.empty_cache()
    cut = full.replace(n_layers=MESH_TRAIN_CUT["layers"], dtype="float32")
    out["train_cut"], state = _mesh_train_cut(torch, np, cut, seed, dev)
    out["train_cut_fsdp"], _ = _mesh_train_cut(
        torch, np, cut.replace(shard_profile="fsdp"), seed, dev)
    # (b) elastic restore
    out["restore"] = _mesh_restore(torch, cut, state, seed, dev)
    del state
    if cuda:
        torch.cuda.empty_cache()
    # (c) serving mixtral-8x7b on a (2, 4) mesh
    sfull = get_config(MESH_SERVE_ARCH)
    out["reduced"].append({"mesh_serve_layers": MESH_SERVE["layers"],
                           "of": sfull.n_layers, "why": (
        "mixtral-8x7b's bf16 weights at full depth pass the card's 80 GB "
        "(93 GB)")})
    out["serve"] = _mesh_serve(
        torch, np, sfull.replace(n_layers=MESH_SERVE["layers"]), seed, dev)
    # (d) the pipeline
    out["pipeline"] = _mesh_pipeline(torch, np, seed, dev)
    out["seconds"] = time.perf_counter() - t_phase
    return out


DRYRUN_CELL = ("starcoder2-3b", "train_4k", False)  # (b): arch, shape, pods
DRYRUN_CELL_S = 90                  # (b): the cell's budget, lower and trace
OP_HOST_ROUNDS, OP_HOST_CALLS = 21, 50  # (c): rounds x calls a path


def _stored(torch, *trees) -> int:
    """The bytes ``trees`` store: each ``Sharded`` leaf's blocks (each
    (block, device) once) and each plain tensor's."""
    from repro_torch.distributed.sharding import Sharded
    total = 0
    for tree in trees:
        stack = [tree]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack.extend(t.values())
            elif isinstance(t, Sharded):
                total += t.nbytes
            elif isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


class _GlobalOnly:
    """A ``FlopCounterMode``'s module tracker that tracks no module: every
    count goes to "Global". Torch's ``ModuleTracker`` hooks every
    module's tensors and so keeps each checkpointed layer's activations
    alive: under it the remat="full" train step of ``run_dryrun`` (a)
    ran the card out of its 80 GB."""
    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def _counted(torch, fn):
    """(``fn()``, the FLOPs a ``FlopCounterMode`` counts around it), with
    no module tracking (``_GlobalOnly``). Its ``bmm`` formula takes the
    operands' shapes only: on the card the training attention's scores
    call ``bmm``'s ``out_dtype`` overload (``models/attention.py:
    _mm_f32``), whose third positional argument torch's own formula
    takes for ``out_shape`` and raises."""
    from torch.utils.flop_counter import FlopCounterMode, bmm_flop
    fix = {torch.ops.aten.bmm:
           lambda a, b, *_, out_shape=None, **__: bmm_flop(a, b)}
    fc = FlopCounterMode(display=False, custom_mapping=fix)
    fc.mod_tracker = _GlobalOnly()
    with fc:
        out = fn()
    return out, fc.get_total_flops()


def _dryrun_check(torch, what: str, lowered, flops: int, stored: int,
                  peak) -> dict:
    """One (a) cell: ``lowered``'s summed FLOPs and stored argument bytes
    against the real step's, exactly; its temp estimate beside the
    card's peak, no gate."""
    cost, mem = lowered.cost(), lowered.memory_analysis()
    need(cost.total.flops == flops, f"dryrun (a) {what}: lowered FLOPs "
         f"{cost.total.flops} against the real step's {flops}")
    need(mem.stored_argument_bytes == stored, f"dryrun (a) {what}: "
         f"lowered argument bytes {mem.stored_argument_bytes} (once per "
         f"(block, device)) against {stored} stored")
    return {"flops": flops, "lowered_flops": cost.total.flops,
            "busiest_flops": cost.busiest.flops,
            "collective_busiest": cost.busiest.collective,
            "stored_argument_bytes": stored,
            "argument_size_in_bytes": mem.argument_size_in_bytes,
            "units": {"/".join(map(str, k)): n
                      for k, n in cost.units.items()},
            "trace_s": lowered.trace_s,
            "temp_size_in_bytes": mem.temp_size_in_bytes,
            "max_memory_allocated": peak,
            "temp_note": ("an estimate of one position's transient peak; "
                          "one card repeated holds every position at once, "
                          "so a position's own peak is not measured here: "
                          "no gate")}


def op_host_cost(torch, dev) -> dict:
    """(c) the host time of a B8 / B9 call on three paths: the ctypes
    wrapper (``direct``), the public op (``ops``: its checks, then the
    wrapper, as no dispatch mode watches) and the dispatcher's operator
    (``torch.ops.repro_torch.*``, what a FLOP counter sees), at rows 8b's
    and 9b's shapes (the LM's prefill and last decode step): the enqueue
    time of ``OP_HOST_CALLS`` calls, the card synchronised outside the
    timed loops, ``OP_HOST_ROUNDS`` rounds of the three in a rotating
    order, and the median over rounds of each path's excess over
    ``direct`` in its round (the host's speed drifts by tens of us a call
    between rounds). Then the dispatcher alone, free of the card: the
    operator on "meta" tensors against its "meta" kernel called
    directly (``q.new_empty``), 20 x 1,000 calls each."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                     dtype=torch.bfloat16)
    q, k, v = rnd(8, 24, 128), rnd(8, 2, 1056, 128), rnd(8, 2, 1056, 128)
    length = torch.full((8,), 1056, dtype=torch.int32, device=dev)
    qf, kf, vf = rnd(8, 24, 1024, 128), rnd(8, 2, 1024, 128), \
        rnd(8, 2, 1024, 128)
    mq, mk, mv, ml = (t.to("meta") for t in (q, k, v, length))
    rows = {
        "9b": {"direct": lambda: decode_attention_cuda(q, k, v, length),
               "ops": lambda: ops.decode_attention(q, k, v, length),
               "operator": lambda: torch.ops.repro_torch.decode_attention(
                   q, k, v, length)},
        "8b": {"direct": lambda: flash_attention_cuda(qf, kf, vf,
                                                      causal=True, window=0),
               "ops": lambda: ops.flash_attention(qf, kf, vf),
               "operator": lambda: torch.ops.repro_torch.flash_attention(
                   qf, kf, vf, True, 0)},
        "meta": {"direct": lambda: mq.new_empty(mq.shape),
                 "operator": lambda: torch.ops.repro_torch.decode_attention(
                     mq, mk, mv, ml)}}
    med = lambda xs: sorted(xs)[len(xs) // 2]
    out = {}
    for row, fns in rows.items():
        names = list(fns)
        calls = 1000 if row == "meta" else OP_HOST_CALLS
        rounds = 20 if row == "meta" else OP_HOST_ROUNDS
        for fn in fns.values():
            fn()
        per = {n: [] for n in names}
        for r in range(rounds):
            for n in names[r % len(names):] + names[:r % len(names)]:
                if row != "meta":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fns[n]()
                per[n].append((time.perf_counter() - t0) / calls * 1e6)
            if row != "meta":
                torch.cuda.synchronize()
        out[row] = {f"{n}_us": med(t) for n, t in per.items()}
        for n in names[1:]:
            out[row][f"{n}_added_us"] = med(
                [a - b for a, b in zip(per[n], per["direct"])])
    return out


def run_dryrun(torch, np, smi: str, seed: int = 0,
               device: str = "cuda") -> dict:
    """The dry-run tools (``launch.steps.lower_step``,
    ``launch.dryrun``, ``launch.roofline``):
    (a) each cell the ``mesh_lm`` phase runs, on its device map (the card
        repeated), lowered on "meta" and held against the same real step
        on the card: starcoder2-3b (``MESH_TRAIN``'s depth) training on
        (2, 2), mixtral-8x7b (``MESH_SERVE``'s depth) prefill and decode
        on (2, 4). The lowered step's FLOPs summed over positions equal
        a ``FlopCounterMode`` count around the real step exactly (B8 and
        B9 counted by their formulas); its argument bytes summed once
        per (block, device) equal the bytes the real step's state
        stores, exactly; its temp estimate is printed beside the card's
        peak, with no gate;
    (b) ``DRYRUN_CELL`` at full width and depth on the abstract
        ``pod16x16`` (``launch.dryrun.run_cell``): ``ok``, the per-chip
        FLOPs, argument bytes, collective bytes by category, ``lower_s``
        / ``trace_s`` and the roofline row with its bottleneck; ``ok``
        true, ``useful_flops_ratio`` over the sum of positions <= 1 (the
        useful work is a floor), inside ``DRYRUN_CELL_S``;
    (c) on the card only, the host time of a B8 / B9 call through the
        public op, the ctypes wrapper and the dispatcher's operator, and
        of the dispatcher alone (``op_host_cost``), with no gate.
    ``device="cpu"`` rehearses (a) and (b) (point ``get_config`` at
    smoke configs and cut ``MESH_TRAIN`` / ``MESH_SERVE``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (adamw_init_sharded,
                                          build_prefill_step,
                                          build_serve_step,
                                          build_train_step, computing_units,
                                          lower_step, shard_params)
    from repro_torch.models import get_model
    t_phase = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)

    def peak_reset():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    peak = lambda: torch.cuda.max_memory_allocated() if cuda else None
    out = {"phase": "dryrun", "gpu": smi}
    ops.reset_launch_counts()
    # (a) training: starcoder2-3b on (2, 2)
    a = MESH_TRAIN
    cfg = get_config(MESH_TRAIN_ARCH).replace(n_layers=a["layers"])
    mesh = _grid_mesh(a["mesh"], dev)
    shape = ShapeConfig("train_4k_b8", a["seq"], a["batch"], "train")
    step, specs = build_train_step(cfg, mesh, shape)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = shard_params(get_model(cfg).init(gen, dev), specs["p_sh"],
                          requires_grad=True)
    opt = adamw_init_sharded(params)
    pipe = TokenPipeline(cfg, shape, seed=seed, shardings=specs["b_sh"])
    try:
        _, batch = next(pipe)
    finally:
        pipe.close()
    stored = _stored(torch, params, opt, batch)
    peak_reset()
    _, flops = _counted(torch, lambda: step(params, opt, batch))
    sync()
    out["train"] = {"arch": cfg.name, "layers": cfg.n_layers,
                    "mesh": a["mesh"], "batch": a["batch"], "seq": a["seq"],
                    **_dryrun_check(torch, "train", lower_step(cfg, mesh,
                                                               shape),
                                    flops, stored, peak())}
    del params, opt, batch, step
    # (a) serving: mixtral-8x7b on (2, 4), prefill then decode
    sv = MESH_SERVE
    cfg = get_config(MESH_SERVE_ARCH).replace(n_layers=sv["layers"])
    mesh = _grid_mesh(sv["mesh"], dev)
    B, S, T = sv["batch"], sv["prompt"], sv["prompt"] + sv["new"]
    model = get_model(cfg).init(gen, dev)
    params = shard_params(model, param_shardings(cfg, model, mesh))
    del model
    batch = {"tokens": _lm_batch(torch, np, cfg, seed, B, S, dev)[
        "tokens"].to(torch.int32)}
    pshape = ShapeConfig("prefill", S, B, "prefill")
    pf, _ = build_prefill_step(cfg, mesh, pshape)
    peak_reset()
    _, flops = _counted(torch, lambda: pf(params, batch))
    sync()
    out["prefill"] = {"arch": cfg.name, "layers": cfg.n_layers,
                      "mesh": sv["mesh"], "batch": B, "prompt": S,
                      **_dryrun_check(torch, "prefill", lower_step(
                          cfg, mesh, pshape), flops,
                          _stored(torch, params, batch), peak())}
    lg, cache = pf(params, batch, T)
    token = lg.gather().argmax(-1, keepdim=True).to(torch.int32)
    pos = torch.tensor(S, dtype=torch.int32, device=dev)
    dshape = ShapeConfig("decode", T, B, "decode")
    serve, _ = build_serve_step(cfg, mesh, dshape)
    stored = _stored(torch, params, cache, token, pos)
    peak_reset()
    _, flops = _counted(torch, lambda: serve(params, cache, token, pos))
    sync()
    out["decode"] = {"arch": cfg.name, "layers": cfg.n_layers,
                     "mesh": sv["mesh"], "batch": B, "cache": T,
                     **_dryrun_check(torch, "decode", lower_step(
                         cfg, mesh, dshape), flops, stored, peak())}
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    # B8 a layer a prefill unit (the counted prefill and the cache's), B9
    # a layer a decode unit; training takes blocked_attention
    want = {"flash_attention": 2 * cfg.n_layers * len(computing_units(
        cfg, mesh, B, "prefill")), "decode_attention": cfg.n_layers
        * len(computing_units(cfg, mesh, B, "decode"))}
    out["expected_launches"] = want
    need(not cuda or out["launches"] == want, f"dryrun (a): launches "
         f"{out['launches']}, not exactly {want}")
    del params, cache, lg, batch
    if cuda:
        torch.cuda.empty_cache()
    # (b) the production cell on the abstract pod16x16
    arch, shape_name, multi = DRYRUN_CELL
    t0 = time.perf_counter()
    rec = run_cell(arch, shape_name, multi)
    cell_s = time.perf_counter() - t0
    need(rec["ok"], f"dryrun (b) {arch} x {shape_name}: "
         f"{rec.get('error')}\n{rec.get('traceback', '')}")
    row = roofline.analyze(rec)
    useful_total = roofline.model_flops_per_chip(
        arch, shape_name, rec["n_chips"]) * rec["n_chips"]
    ratio_sum = useful_total / rec["total_flops"]
    need(ratio_sum <= 1.0, f"dryrun (b): useful FLOPs {useful_total} over "
         f"the positions' sum {rec['total_flops']} is {ratio_sum} > 1: a "
         "unit was dropped")
    need(cell_s <= DRYRUN_CELL_S, f"dryrun (b): the cell took {cell_s} s, "
         f"over {DRYRUN_CELL_S}")
    out["cell"] = {
        "arch": arch, "shape": shape_name, "mesh": rec["mesh"],
        "ok": rec["ok"], "seconds": cell_s, "lower_s": rec["lower_s"],
        "trace_s": rec["trace_s"], "flops_per_chip": rec["flops"],
        "total_flops": rec["total_flops"],
        "reference_share_flops": rec["total_flops"] / rec["n_chips"],
        "per_chip_over_share": rec["flops"] * rec["n_chips"]
        / rec["total_flops"],
        "argument_size_in_bytes": rec["argument_size_in_bytes"],
        "temp_size_in_bytes": rec["temp_size_in_bytes"],
        "collectives": rec["walker_collectives"],
        "units": rec["units"], "roofline": row,
        "useful_flops_ratio_sum": ratio_sum,
        "what_would_help": roofline.what_would_help(row),
        "constants": {"PEAK_FLOPS": roofline.PEAK_FLOPS,
                      "HBM_BW": roofline.HBM_BW,
                      "LINK_BW": roofline.LINK_BW}}
    # (c) the operators' host cost
    if cuda:
        out["op_host_cost"] = op_host_cost(torch, dev)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# --------------------------------- main ------------------------------------

KERNEL_META = {
    "fused_expand": ("cuda", "src/repro_torch/kernels/csrc/fused_expand.cu",
                     "src/repro/kernels/fused_filter.py:91",
                     (1024, 32, 15, 16)),
    "merge_sorted": ("cuda", "src/repro_torch/kernels/csrc/merge_sorted.cu",
                     "src/repro/kernels/merge_sorted.py:52",
                     (1024, 26, 16, 26)),
    "dist_h": ("cuda", "src/repro_torch/kernels/csrc/dist_h.cu",
               "src/repro/kernels/dist_h.py:21", (1024, 16, 128)),
    "dist_l": ("cuda", "src/repro_torch/kernels/csrc/dist_l.cu",
               "src/repro/kernels/dist_l.py:25", (1024, 60, 15)),
    "pq_adc_expand": ("cuda", "src/repro_torch/kernels/csrc/pq_adc_expand.cu",
                      "src/repro/kernels/pq_adc.py:41", (1024, 32, 16, 32)),
    "ksort_l": ("cuda", "src/repro_torch/kernels/csrc/ksort_l.cu",
                "src/repro/kernels/ksort_l.py:36", (1024, 40, 10)),
    "fused_filter": ("cuda", "src/repro_torch/kernels/csrc/fused_filter.cu",
                     "src/repro/kernels/fused_filter.py:47", (64, 32, 15, 16)),
    "flash_attention": ("cuda",
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:77",
                        (1, 4, 4, 512, 512, 64, "bf16", True, 0)),
    "decode_attention": ("cuda",
                         "src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:63",
                         (1, 4, 4, 4096, 64, "bf16")),
    # the search's fold of a trip's three merges (merge_sorted_pallas)
    # and the glue around them, at the pca arm's layer 0
    "trip_fold": ("cuda", "src/repro_torch/kernels/csrc/trip_fold.cu",
                  "src/repro/kernels/merge_sorted.py:52",
                  (1024, 10, 26, 16, 16, 1, "heap", "kv", "-")),
    # the same fold gated per row (ef_eff, pop), at the pca scheduler's
    # bank of 64 slots on the mutable index (row 2c)
    "trip_fold_gated": ("cuda", "src/repro_torch/kernels/csrc/trip_fold.cu",
                        "src/repro/kernels/merge_sorted.py:52",
                        (64, 10, 26, 16, 16, 1, "heap", "kv", "tombs")),
    # fused_expand_pallas with the row gathers fused, at the pca arm's
    # layer 0
    "fused_expand_rows": ("cuda",
                          "src/repro_torch/kernels/csrc/fused_expand.cu",
                          "src/repro/kernels/fused_filter.py:91",
                          (1024, 1, 32, 15, 16)),
    # pq_adc_expand_pallas with the row gathers fused, at the pq arm's
    # layer 0
    "pq_expand_rows": ("cuda",
                       "src/repro_torch/kernels/csrc/pq_adc_expand.cu",
                       "src/repro/kernels/pq_adc.py:41",
                       (1024, 1, 32, 16, 16)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=DEFAULT_N,
                    help="points in the SIFT1M-shaped build and search")
    ap.add_argument("--shards", type=int, default=4,
                    help="shards the points are split into (1: the "
                         "single-shard smoke over all points)")
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_device": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build_kernels", "seconds": time.perf_counter() - t0,
          "sources": built})

    kres = phase_kernels(torch, np, args.seed)
    fout = run_footprint(torch)
    emit(fout)
    lm = run_lm(torch, np, smi, args.seed)
    emit(lm)
    for part, tag in (("launcher", "(a)"), ("timed", "(b)")):
        a = lm[part]
        want = {"flash_attention": a["layers"],
                "decode_attention": a["layers"] * a["new"]}
        need(a["launches"] == want, f"lm {tag}: launches {a['launches']}, "
             f"not exactly {want}")
    fam = run_lm_families(torch, np, smi, args.seed)
    for line in fam["reduced"]:
        emit({"reduced": line})
    emit(fam)
    for arch, r in fam["archs"].items():
        want = r["timed"]["expected_launches"]
        need(r["timed"]["launches"] == want, f"lm_families {arch} (a): "
             f"launches {r['timed']['launches']}, not exactly {want}")
    tr = run_train(torch, np, smi, args.seed)
    emit({"reduced": {"train_timed_steps": TRAIN_TIMED[2], "of": 3,
                      "why": (
        "the mesh_lm phase's time: two timed steps (9.7-10.1 s each, "
        "within 0.5% of each other) still give the rate")}})
    emit({"reduced": {"train_global_batch": TRAIN_TIMED[0], "of": 256,
                      "why": (
        "train_4k's global batch of 256 sequences of 4,096 is 32 times "
        "the timed steps' work; 8 (4 microbatches of 2) keep the phase "
        f"inside the {TIME_LIMIT_S} s smoke limit")}})
    emit(tr)
    need(not tr["timed"]["launches"].get("flash_attention")
         and not tr["timed"]["launches"].get("decode_attention"),
         f"train (a): attention kernels launched "
         f"{tr['timed']['launches']}: training must take blocked_attention")
    ml = run_mesh_lm(torch, np, smi, args.seed)
    for line in ml["reduced"]:
        emit({"reduced": line})
    emit(ml)
    need(not ml["train"]["launches"].get("flash_attention")
         and not ml["train"]["launches"].get("decode_attention"),
         f"mesh_lm (a): attention kernels launched "
         f"{ml['train']['launches']}: training must take blocked_attention")
    want = ml["serve"]["expected_launches"]
    need(ml["serve"]["launches"] == want, f"mesh_lm (c): launches "
         f"{ml['serve']['launches']}, not exactly {want}")
    dry = run_dryrun(torch, np, smi, args.seed)
    emit(dry)

    P = args.shards
    x, graphs, blines, bout = run_build(torch, np, args.n, P, args.seed,
                                        "cuda")
    for line in blines:
        emit(line)
    emit(bout)
    need(bout["invariants_ok"], "graph invariants: " + "; ".join(
        str(ln["violations"]) for ln in blines if not ln["invariants_ok"]))
    for name in ("trip_fold", "dist_h"):
        need(bout["launches"][name] > 0, f"build never launched {name}")
    if args.n < FULL_N:
        emit({"reduced": {"n_points": args.n, "of": FULL_N, "why": (
            "the wave builder links on the host in numpy (the "
            "reference's arithmetic); a 1M build does not fit a third "
            f"of the {TIME_LIMIT_S} s smoke limit, and 40,000 (200,000 "
            "before the mesh_lm phase, 100,000 before the dryrun phase, "
            "75,000 before the benches phase) pays for those phases' "
            "~125 s, ~50 s and ~125 s")}})
    g0 = graphs[0]
    n0 = len(g0.x)
    if P > 1:
        emit({"reduced": {"single_shard_n_points": n0, "of": args.n,
                          "why": (
            "the single-shard arms search shard 0's graph: the shard "
            "graphs replace the one graph over all points, so the sharded "
            "search keeps every point inside the time limit")}})

    from repro_torch.core.pca import fit_pca
    from repro_torch.data.vectors import make_queries
    pca = fit_pca(x, g0.cfg.d_low)
    filts, codes, tout = train_filters(
        np, x, g0.cfg, np.concatenate([g.levels for g in graphs]), pca)
    emit({"reduced": {"pq_train_iters": PQ_TRAIN_ITERS,
                      "of": g0.cfg.pq_train_iters, "why": (
        "the codebook's Lloyd iterations run in host numpy (~5 s each on "
        "20k points); 4, the reference benches' plain-PQ schedule, pays "
        f"for part of the benches phase within the {TIME_LIMIT_S} s "
        "smoke limit")}})
    emit(tout)
    q = make_queries(x, args.queries, seed=args.seed + 1)
    gt0 = ground_truth(torch, x[:n0], q, 10, "cuda")
    souts = run_search(torch, np, x[:n0], g0, pca, filts, codes[:n0], q,
                       gt0, args.batch, "cuda")
    for sout in souts:
        emit(sout)
        arm = sout["arm"]
        for name in ARM_KERNELS[arm]:
            need(sout["launches"][name] > 0,
                 f"search arm {arm} never launched {name}")
        need(sout["launches"]["trip_fold_gated"] == 0,
             f"search arm {arm} launched the gated fold")
        need(sout["recall_at_10"] >= sout["recall_floor"],
             f"arm {arm}: recall@10 {sout['recall_at_10']} < "
             f"{sout['recall_floor']}")
    check_bf16_arms(souts, "search")

    gt = ground_truth(torch, x, q, 10, "cuda")
    sdbs, pack_s = build_sharded_dbs(
        torch, np, x, graphs, filts, codes, "cuda",
        kinds=("pca", "pq", "cascade", "pca-bf16"))
    del codes
    shouts = run_sharded(torch, np, sdbs, filts, q, gt, args.batch, "cuda",
                         pack_s)
    for sout in shouts:
        emit(sout)
        arm = sout["arm"]
        for name in SHARD_ARM_KERNELS[arm]:
            need(sout["launches"][name] > 0,
                 f"sharded arm {arm} never launched {name}")
        need(sout["recall_at_10"] >= sout["recall_floor"],
             f"sharded arm {arm}: recall@10 {sout['recall_at_10']} < "
             f"{sout['recall_floor']}")
    check_bf16_arms(shouts, "sharded")
    mesh_launches = []
    if P > 1:
        mout = run_mesh(torch, np, sdbs, filts, q[:MESH_QUERIES], args.batch,
                        "cuda", smi)
        emit(mout)
        if len(q) > MESH_QUERIES:
            emit({"reduced": {"mesh_queries": MESH_QUERIES, "of": len(q),
                              "why": (
                "the mesh phase checks bit-equality and launch counts, "
                "not rates; the lm phases need its time within the "
                f"{TIME_LIMIT_S} s smoke limit")}})
        for arm, res in mout["arms"].items():
            counts = res["launches"]
            need(counts == res["launches_host"], f"mesh {arm}: launches "
                 f"{counts} against the host path's {res['launches_host']}")
            need(counts["ksort_l"] == res["batches"], f"mesh {arm}: "
                 f"ksort_l {counts['ksort_l']} times for {res['batches']} "
                 "batches")
            for name in SHARD_ARM_KERNELS[arm]:
                need(counts[name] > 0, f"mesh {arm} never launched {name}")
        mesh_launches = [a["launches"] for a in mout["arms"].values()] \
            + [mout["split_launches"], mout["dead_launches"]]
    else:
        emit({"phase": "mesh", "skipped": "needs --shards >= 2"})
    # the degraded and tombstone phases check properties, not rates: the
    # first four batches are enough
    nq = 4 * args.batch
    if P > 1:
        emit(run_degraded(torch, np, sdbs["pca"], filts["pca"], q[:nq],
                          args.batch, "cuda"))
    del sdbs["pq"], sdbs["cascade"], sdbs["pca-bf16"]
    for tout in run_tombstones(torch, np, x, graphs, filts, q[:nq], gt[:nq],
                               args.batch, "cuda", args.seed):
        emit(tout)
    if P > 1:
        emit(run_resilient(torch, np, sdbs["pca"], filts["pca"],
                           q[:args.batch], "cuda"))
    else:
        emit({"phase": "degraded+resilient", "skipped": "needs --shards "
              ">= 2"})
    del sdbs
    serve = run_serve(torch, np, g0, filts["pca"], q, args.batch,
                      args.seed, args.n)
    emit(serve)
    for part, names in (("upsert", SERVE_UPSERT_KERNELS),
                        ("query", SERVE_QUERY_KERNELS)):
        for name in names:
            need(serve["launches"][part][name] > 0,
                 f"serve: the {part} part never launched {name}")
    emit({"reduced": {"compact": "the 8k fixture (parity_8k -> mutable "
                      "-> compact), not the serve index", "why": (
        "compact() is a host loop per node: 93.65 s on an 8-core Intel "
        "Xeon host for 50,000 points with 25% deleted (python -m "
        "repro_torch.bench.compact_cost --n 50000 --device cpu), over the "
        "60 s the smoke gives it")}})
    serve_launches = [serve["launches"][part]
                      for part in ("query", "upsert", "delete",
                                   "query_after")]
    emit({"reduced": {"serve_upserts": SERVE_UPSERTS, "of": 8_192,
                      "sharded_upserts": SHARDED_UPSERTS, "of_sharded": 4_096,
                      "why": (
        "the upserts' probes and host linking take ~0.5 s a call of 128; "
        "halving both pays for part of the benches phase within the "
        f"{TIME_LIMIT_S} s smoke limit, and the self-recall and "
        "frozen-epoch checks need no more")}})
    if P > 1:
        sserve = run_serve_sharded(torch, np, graphs, filts["pca"], q, gt,
                                   args.batch, args.seed, args.n)
        emit(sserve)
        for name in SERVE_SHARDED_KERNELS:
            need(sserve["launches"][name] > 0,
                 f"serve_sharded: never launched {name}")
        serve_launches.append(sserve["launches"])
        mesh_launches.append(sserve["mesh"]["launches"])
    else:
        emit({"phase": "serve_sharded", "skipped": "needs --shards >= 2"})
    rep = run_replica(torch, np, g0, filts["pca"], q, args.batch, args.seed,
                      args.n)
    emit(rep)
    for part in ("query", "upsert"):
        for name in REPLICA_KERNELS:
            need(rep["launches"][part][name] > 0,
                 f"replica: the {part} part never launched {name}")
    stream = run_stream_phase(torch, np, g0, graphs, x, filts["pca"], q, gt0,
                              args.seed)
    emit(stream)
    for part, names in (("scheduler", STREAM_KERNELS),
                        ("mixed_k", STREAM_KERNELS),
                        ("deferred", STREAM_DEFERRED_KERNELS)):
        for name in names:
            need(stream["launches"][part][name] > 0,
                 f"stream: the {part} part never launched {name}")
    stream_launches = [c for part, c in stream["launches"].items()
                       if part != "sync"]
    emit({"reduced": {"stream_queries": STREAM_QUERIES, "of": 10_000,
                      "load_point_seconds": STREAM_LOAD_SECONDS, "of_s": 3.0,
                      "why": (
        "the scheduler and sync passes check bits and take rates; half "
        "the queries and 2 s a load point (each point still offers at "
        "least 20 requests) pay for part of the benches phase within the "
        f"{TIME_LIMIT_S} s smoke limit")}})
    del x, graphs, g0

    emit({"reduced": {"sharded_parity_queries": SHARDED_PARITY_QUERIES,
                      "of": 200, "float_modes": list(SHARDED_FLOAT_MODES),
                      "mesh_modes": list(MESH_PARITY_MODES),
                      "of_modes": list(SHARD_PARITY_MODES), "why": (
        "the sharded parity checks bits and id agreement, not rates; the "
        "lm_families and train phases need its time within the "
        f"{TIME_LIMIT_S} s smoke limit")}})
    parity = run_parity(torch, np)
    emit(parity)
    benches = run_benches(torch, np, smi)
    emit(benches)
    bench_launches = [m["launches"] for m in benches["modes"].values()]

    rows = []
    for name, (route, src, replaces, shape) in KERNEL_META.items():
        r = kres[(name, shape)]
        per_arm = {s["arm"]: s["launches"][name] for s in souts}
        per_sharded = {s["arm"]: s["launches"][name] for s in shouts}
        n_serve = sum(c[name] for c in serve_launches)
        n_replica = sum(c[name] for c in rep["launches"].values())
        n_benches = sum(c[name] for c in bench_launches)
        n_stream = sum(c[name] for c in stream_launches)
        n_mesh = sum(c[name] for c in mesh_launches)
        n_mesh_lm = ml["serve"]["launches"].get(name, 0)
        n_dryrun = dry["launches"].get(name, 0)
        n_lm = sum(lm[part]["launches"].get(name, 0)
                   for part in ("launcher", "timed")) \
            + sum(r["timed"]["launches"].get(name, 0)
                  for r in fam["archs"].values())
        rows.append({"name": name, "route": route, "source": src,
                     "replaces": replaces, "shape": list(shape),
                     "launches": bout["launches"][name]
                     + sum(per_arm.values()) + sum(per_sharded.values())
                     + fout["launches"][name] + n_serve + n_replica
                     + n_benches + n_stream + n_mesh + n_lm + n_mesh_lm
                     + n_dryrun,
                     "launches_build": bout["launches"][name],
                     "launches_search": per_arm,
                     "launches_sharded": per_sharded,
                     "launches_footprint": fout["launches"][name],
                     "launches_serve": n_serve,
                     "launches_replica": n_replica,
                     "launches_benches": n_benches,
                     "launches_stream": n_stream,
                     "launches_mesh": n_mesh,
                     "launches_lm": n_lm,
                     "launches_mesh_lm": n_mesh_lm,
                     "launches_dryrun": n_dryrun,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1],
                     "library_ms": r["library_ms"]})
    total = time.perf_counter() - t_start
    emit({"total_seconds": total})
    need(total < TIME_LIMIT_S, f"the smoke took {total} s, over the "
         f"{TIME_LIMIT_S} s limit")
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
