#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch/``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a: H100/H200) and the CUDA toolkit's nvcc; run
it from the root of a checkout.  It imports nothing of JAX or of the JAX
package, and exits non-zero (printing no result) on any failure, without
a card, or outside a checkout.  Phases:

1. device   — torch/CUDA versions, the card's name and power limit;
              TF32 off for matmuls and convolutions.
2. build    — nvcc builds every kernel source under
              src/repro_torch/kernels/csrc/ (one nvcc each, all at once).
3. parity   — each kernel against its plain PyTorch version on the card,
              at the main path's sizes (the MLP bus, N = 16,384; the
              sparse payload's k = 656 and 1,313) and at N = 2^27
              (k = 0.05 * 2^27 = 6,710,886): Eq. 1 and Eq. 2 bit-exact in
              f32 and bf16 storage (Eq. 2 with 1-9, 33 and 511 clients;
              1, 4, 8 and 9 at 2^27), Adam
              bit-exact with f32 and bf16 params, with and without weight
              decay, the elastic EASGD round bit-exact in f32 and bf16
              with 1-9 replicas (its own instances for 1-8, the generic
              one for 9; 1, 3, 8 and 9 at 2^27), int8 quantize /
              dequantize and the
              sparse-body pack bit-exact (the pack also at a k for each
              k mod 4, with q at byte offsets 0-3; the dequantize with q
              at byte offsets 0-15; the quantize at every k mod 16, k =
              4,096-4,111, with x at element offsets 0-3 from a 16-byte
              boundary, block 256 and 100).
              Each kernel's time, its plain version's, one PyTorch
              library call's where one computes the same function
              (torch.lerp / torch.addmv / torch._fused_adam_ / a scale
              multiply / torch.cat of byte views: yardsticks the port
              never calls) and the bound (B1, B2, B3, B10 and B12 timed
              in turns with their library calls; the share of the bound
              at each size); the host microseconds of one B1, B3, B2,
              B12 and B10 wrapper call at the main sizes beside
              torch.lerp's, torch._fused_adam_'s, torch.addmv's,
              torch.cat's and torch.mul's, and of one B9 call at k = 656
              and one B5 call at 16,384 with 3 replicas (no library
              call), timed in turns; B9's and B5's graph-timed device
              us there; B9's and B5's ptxas lines; the launch helper's
              raw stream handle held to the current stream's.
4. the main path, through the entry points a user calls:
   a. the quickstart --smoke configuration (examples/quickstart.py:30-45,
      VC-ASGD with var_alpha) on the card and on the CPU from one seed:
      the Eq. 1 launch count equals the results assimilated, the Adam
      count equals the client steps, the event traces are identical and
      each epoch's accuracy agrees within ACC_BAND;
   b. Eq. 2: four clients train from the server copy and return in one
      batch, folded by assimilate_many_flat (one Eq. 2 launch), held
      against folding Eq. 1 four times;
   c. the full quickstart configuration on the card, its 10 epochs cut
      to QUICKSTART_EPOCHS = 1: counts, accuracy table, wall time and
      where the host time goes (B3's share: the span of Adam.update_flat,
      inside client_train); the smoke run's first PROFILE_TASKS client
      tasks under the profiler first (device-busy share, top items);
   d. the pinned replay: the 12 flat MLP cases of
      results/PINNED_sim_regression.json (every server scheme, dense and
      compressed uploads; configurations of tools/pin_sim_regression.py)
      on the card and on the CPU from one seed.  Every event-trace and
      wire field equals the pinned JSON and card equals CPU; accuracy
      agrees card vs CPU within ACC_BAND; each kernel's launches equal
      what the path implies (quantize = pack = compressed submits,
      dequantize = compressed submits + sparse assimilations, EASGD =
      pod barrier rounds, Eq. 1 = VC-ASGD-family assimilations);
   e. the paper's §IV-C comparison at examples/asgd_comparison.py's full
      configuration on the card: the eight schemes' table (hours, final
      accuracy, preemptions, reassignments, wire MB), each scheme's wall
      time and the host share spent in compress_flat and encode_sparse.
6. serve — the port's LLM serving path (launch/serve.py) for the dense
   transformer family:
   a. flash attention (B13) against its plain version at internlm2's
      prefill shape ([4,16/8,2048,128] bf16, causal; timed with its bound
      and torch's scaled_dot_product_attention as the library yardstick,
      which the port never calls), gemma3's local layers (hd 256, window
      1,024, a ragged 2,300 tokens), non-causal cross attention with a
      softcap in f32, h == kvh at hd 16 and jamba's prefill
      ([4,32/8,2048,128] bf16, causal), granite's prefill
      ([4,16/8,2048,64] bf16, causal), both prefill shapes and granite's
      again with peaked scores (q, k at 2 N(0,1)), ragged cross and
      windowed hd-64 cases, and the prefills of stablelm-3b ([4, 32/32,
      2,048, 80]) and gemma3-4b's global layers ([4, 8/4, 2,048, 256]),
      flat and peaked, and whisper-tiny's encoder ([4, 6/6, 1,500, 64],
      not causal) and cross-attention (376 rows against 1,500 keys);
      each shape names the route that took it (bf16 at
      hd 64, 80, 128 and 256: the wgmma kernel,
      csrc/flash_attention_sm90.cu, held within 5e-3 + 2^-7 |plain|, the
      SIMT kernel timed beside it at hd 64, 80 and 256; the rest: the
      SIMT kernel, csrc/flash_attention.cu, 2e-5 in f32 and 2e-2 in
      bf16); the wgmma kernel's ptxas lines (registers, spills, static
      shared memory; every instance: hd 64, 80, 128, 256, with and
      without softcap) and the host cost of a call on each route;
   b. serve.run at internlm2-1.8b's full width (24 layers, 1.89B
      parameters from the port's init, --seed 0): batch 4 x 2,048 prompt
      tokens, 96 greedy decode steps; finite logits, 24 B13 launches in
      prefill, all on the wgmma route, none in decode, one compaction
      (after step 64); prefill and decode times and tokens/s, the
      compaction's time, and the profiler's device-busy share of 2
      further decode steps;
   c. the same architecture at full width cut to 2 layers, batch 2 x 256
      prompt tokens and 72 decode steps (one compaction) on the card and
      on the CPU from one draw of the weights, in f32 and in the shipped
      bf16 compute; the f32 card run decodes greedily and the other runs
      are fed its tokens: prefill and every step's logits card vs CPU
      within CMP_TOL; the CPU run launches nothing; B13 runs on the SIMT
      route in f32 and on the wgmma route in bf16.
7. serve rwkv6 — launch/serve.py for the SSM family:
   a. the WKV6 recurrence (B14, the chunked form) against its plain
      version at rwkv6's prefill shape ([4,32,2048,64] f32), the reduced
      head dim (hd 16, a ragged 37 steps), T = 1, [b, T, h, hd] strided
      views as the model passes them, and decays with exact zeros and
      denormals (2e-5 on out and the final state, both finite); kernel,
      plain and bound ms and the share of the bound at each (no PyTorch
      call computes WKV6);
   b. serve.run at rwkv6-1.6b's full width and depth (24 layers,
      1,599,819,776 parameters from the port's init, --seed 0): batch 4
      x 2,048 prompt tokens, 96 greedy decode steps against the O(1)
      recurrent state; finite logits, 24 B14 launches in prefill (none
      writing chunk states, none of its backward), none in decode, no
      compaction; prefill (cold and warm) and decode times,
      tokens/s, peak device memory and the profiler's device-busy share
      of the warm prefill and of 2 further decode steps;
   c. the same architecture at full width cut to 2 layers, batch 2 x 256
      prompt tokens and 72 decode steps on the card and on the CPU from
      the same weights, as 6c.
8. serve jamba — launch/serve.py for the hybrid mamba / attention / MoE
   family:
   a. the selective scan (B15) against its plain version at jamba's
      prefill shape ([4, 2048, 8192], ds 16, u in bf16, dt/B/C in f32),
      the reduced shape (di 128, ds 4, a ragged 37 steps, f32), T = 1,
      and B/C as the column views of an x_proj output the model passes
      (y within 2e-5 in f32 and 2e-2 in bf16, h_T within 2e-5); kernel,
      plain and bound ms at each (the bound counts bytes, the exps at
      the SFU's rate and the FMAs; no PyTorch call computes the scan);
      the kernel's ptxas lines (registers, spills, shared memory);
   b. serve.serve at jamba-v0.1's full width cut to blocks 2 and 4 of
      its published 8-layer period (mamba + dense, attention + dense;
      1,036,464,128 parameters from the port's init, seed 0, cast to bf16
      as each layer is placed): batch 4 x 2,048 prompt tokens, 96 greedy
      decode steps; finite logits, 1 B15 and 1 B13 launch in prefill (the
      wgmma route; no B15 launch writing chunk states, no backward), none
      in decode, one compaction; init seconds, prefill (cold and warm),
      decode and compaction times, tokens/s, peak device memory and the
      profiler's device-busy share of the warm prefill and of 2 further
      decode steps;
   c. blocks 3 and 4 of the period (mamba + MoE, then attention + dense)
      at full width on the card and on the CPU, as 6c but with 8 decode
      steps (B13 on the SIMT route in f32, the wgmma route in bf16), with
      the MoE routes that differ between card and CPU counted.
9. the pod runtime's compressed cross-pod round
   (runtime/vc_runtime.py::compressed_assimilate) on the bench model of
   benchmarks/kernel_bench.py:370-383 (24 leaves, 2,101,504 parameters on
   a 2,105,344-element bus):
   a. the blocked top-k's passes, B6 (packed candidate words) and B7
      (exact-k emit), against their plain versions bit for bit at the
      bench bus, 2^20, a ragged 2^20 + 4,128, a tie-heavy round(4x)/4 bus
      (ties cut by the budget across tiles) and 2^27, each with the
      bracket and refinement of its own bus, B6 with ``lo`` as the
      bracket's device int32 [1] and as a number, B7 with tau and the
      budget as the refinement's device tensors and as numbers; kernel
      (B6 in both forms), plain and bound ms at the bench bus and at 2^27
      (no PyTorch call computes packed ballot words or the exact-k emit),
      B6's and B7's host microseconds a call at the bench bus in both
      forms and their graph-timed device microseconds there, and both
      kernels' ptxas lines;
   b. select_topk and compress_flat, card against CPU, at 2^20,
      2,105,344, 5,242,880 and 2^24 at densities 0.05 and 0.01: indices,
      q, scales and the new residual identical; B6 once per selection, B7
      once per compress_flat where the bracket holds and never where it
      misses (2^24); the whole selection's time at the bench bus beside
      the port's own stable sort (the branch a missed bracket takes, the
      same indices) and torch.topk (a yardstick the port never calls);
   c. compressed_assimilate (4 islands, alpha 0.9, density 0.05, a
      loopback transport) for 3 rounds with the residuals carried, island
      2 dead in round 2, card against CPU: server and residuals bit for
      bit, every frame byte for byte outside the residual-norm field and
      the crc (norms within 2 f32 ulps); per round B6 4, B7 4, B9 4, B10
      8, B12 4 launches; the wall of each round, the host spans of
      selection, compression, encode and decode, and the profiler's
      device-busy share of one more round;
   d. CompressedVCASGD(0.9, density=0.05) through Coordinator.issue /
      submit / deliver / assimilate on the same bus, 3 clients for 2
      rounds, card against CPU under the same frame rule.
10. the port's kernel bench (src/repro_torch/benchmarks/), the path of
   the last three kernels:
   a. B4 (DC-ASGD's corrected lerp, flat) and B1's and B4's per-tensor
      entries against their plain versions bit for bit in f32 and bf16 at
      N = 16,384, 2^24 and 2^27 and at the ragged shapes (17,), (255, 9),
      (3, 5, 7, 11); B8 (the threshold pass, tau 0.01) bit for bit on the
      bench bus in f32 and bf16, a ragged 9,000 and 2^27, kept + residual
      == x; B11 (quantize + pack) byte for byte at every k mod 16 (k =
      4,096-4,111; sel and idx also at element offsets from their
      allocations, off 16-byte boundaries; block 256 and 100) and at k =
      656, 1,313, 1,000, 105,075 and 6,710,886, its body equal to B12 of
      B9's payload.  Each timed beside its plain version and its bound,
      with its share of the bound, at the bench's shape (2^24, the bench
      bus, k = 105,075) and at 2^27 (no single PyTorch call computes any
      of the three: no library time);
   b. repro_torch.benchmarks.run with every kernel-bench suite (kernels,
      flat, flat_adam, compression, roofline) in this process on the card
      with --check: the launch gate equals results/BASELINE_launches.json
      (flat 1 / per_leaf 96, flat_adam 1, compression 2 / 1 / 1), every
      suite's rows and the roofline table print, and flat_adam's
      train_ckpt_one_pass row (the one-pass train record of the bench
      bus, host clock) is timed and launches nothing.  B4, B8 and B11
      launch there.
11. the paper's preemptible-instance story:
   a. run_preemptible_training (core/simulator.py) on the card at the
      MLP's full published width (13,130 parameters, 16,384-element bus):
      40 steps, batch 64, a one-pass train record every 10 steps; killed
      before steps 13 and 27, every step's loss and the final bus equal
      the uninterrupted run's bit for bit, with 2 restores, 10 recomputed
      steps and B3 launched once a step (50); the same killed run on the
      CPU within PRE_LOSS_TOL a step; the card's last record restores on
      the CPU and the CPU's on the card bit for bit (params, m, v, step)
      and re-saves byte for byte;
   b. Coordinator.save_checkpoint / restore_checkpoint with VCASGD (B1)
      and EASGDFlatPod (B5): restored into coordinators built from other
      params on the card and on the CPU, the next handout is the saved
      center (the pod's replicas tiled from it) and three more results
      folded on each agree bit for bit;
   c. the paper suites cost and fig6 (benchmarks/paper_figs.py, quick) on
      the card and on the CPU: every claim holds, fig6's hours equal and
      its accuracy curves agree within ACC_BAND; walls and claims print.
12. the rest of the simulator — fleets, the sharded bus with delta
   handouts, the aggregation tier, read-only subscribers:
   a. the fixture's other 5 cases (PINNED_FLEET_CASES;
      tools/pin_sim_regression.py:68-80, :95-98) on the card and on the
      CPU: every trace, wire and tier field equals the pinned JSON on
      both; the four ProbeTask cases (fleet-churn, fleet-sharded-bus,
      fleet-eval-stride, tier-fleet) card == CPU bit for bit in every
      accuracy and in the final bus, and within PROBE_ACC_TOL of the
      fixture's accuracy (the gap printed); tier-2level equals its
      device's tier-flat-twin run bit for bit; B1 launches = results
      assimilated (the Eq. 1 folds, at the hub or at an edge), B3 =
      client steps, nothing else;
   b. the registry's scenarios at their own sizes: fleet_1k on the card
      and on the CPU, every summary field and the final bus bit for bit;
      az_reclaim (a sharded bus), spot_price, diurnal and tiered once on
      the card; each run's wall and events/s (the CPU's beside fleet_1k's);
   c. ``repro_torch.benchmarks.run --only fleet,handout --check`` in this
      process on the card: fleet_1k, fleet_10k and fleet_10k_tier,
      handout_flash_10k in f32 and bf16 and handout_lagged_10k, each
      row's fingerprint equal to results/BENCH_fleet.json /
      BENCH_handout.json, every claim (the tier's upstream reduction, the
      dedup and bf16 claims), and the floors of
      results/BASELINE_torch_fleet.json (fleet_smoke's events/s at 25%,
      handout_smoke's dedup ratio at 50%).
13. the wall-clock runtime (launch/vc_serve.py over ProcessTransport
   brokers), the frontier suite and the examples:
   a. vc_serve at its default size (4 rounds x 3 clients, the MLP's
      13,130 parameters on the 16,384-element bus) on the card and on the
      CPU from one seed: every wire, handout, frame-kind and lease counter
      equal, each round's accuracy within ACC_BAND, the final bus within
      SERVE_BUS_TOL (printed beside it); B1 launched once per fold and B3
      once per client step (3 x 4 x 4 = 48), nothing else; round 0's and
      the warm rounds' walls on both devices with a warm round's shares
      (client_train, submit, fold, checkpoint write, evaluation, serving,
      time inside broker RPCs); the host us of one broker RPC of the
      bus's 65.6 KB dense frame;
   b. vc_serve --density 0.05 --shards 4 --handout-dtype bf16 --tier 2
      --subscribers 16 on the card: every end-of-run check passes; B9 and
      B12 once per compressed upload (12), B10 once per upload and once
      per sparse decode at an edge (22), B1 once per edge fold (10), B3
      48; the hub folds 8 merged frames; the subscribers' bytes served
      and encoded;
   c. a child ``python -m repro_torch.launch.vc_serve --rounds 50`` on
      the card, SIGKILLed after its ``round 2:`` line: its broker exits,
      a restart resumes at the last checkpoint's round with the uid
      continued, steps monotone with no gap and none rewritten;
   d. ``repro_torch.benchmarks.run --only frontier`` in this process on
      the card: every point equals results/BENCH_frontier.json but its
      wall, the Pareto front and the three claims too; B1 once per
      assimilated result;
   e. examples/torch_quickstart.py and examples/torch_asgd_comparison.py
      with --smoke on the card, their trace lines equal to the CPU runs';
      CNNTask.client_train (20 steps) card vs CPU within CNN_TOL, B3 once
      a step.
14. LLM VC training (launch/train.py, runtime/vc_runtime.py::
    make_vc_round) and the MoE configs:
   a. B13's backward against the autograd of the plain forward, on the
      route each case takes (bf16 at hd 64, 80, 128 and 256: the wgmma
      kernel, csrc/flash_attention_bwd_sm90.cu; the rest: the SIMT
      kernel, csrc/flash_attention_bwd.cu; counted by route): f32 and
      bf16, causal and causal + window, sq = skv in {1, 63, 128, 2048},
      hd 16, 64, 128 at GQA groups 1, 2, 4 and hd 80, 256 at groups 1,
      2, and at the training shapes of internlm2 [8, 16/8, 128, 128],
      granite [8, 16/8, 128, 64], stablelm-3b [8, 32/32, 128, 80] and
      gemma3-4b [8, 8/4, 128, 256] and the prefill shapes [4, 16/8,
      2,048, 128], [4, 32/32, 2,048, 80], [4, 8/4, 2,048, 256] in both
      dtypes, each case twice and bit-equal; timed at those seven shapes
      and whisper-tiny's training shapes (not causal: [8, 6/6, 1,500,
      64] and 128 rows against 1,500 keys), the outputs of both routes
      checked against the plain formula too, beside the SIMT kernel, the
      plain formula, SDPA's backward and the bound, with the wgmma
      kernel's device time in a CUDA graph;
   b. internlm2-1.8b at full width cut to 4 of its 24 layers
      (630,736,896 parameters on an f32 bus): 4 rounds of 2 islands x 2
      local steps of 8 x 128 tokens, island 0 preempted in round 2, a
      checkpoint after round 3; every step B13 forward + recompute and
      backward in each layer (all on the wgmma routes) and B3, B2 once a
      round, counted; round
      walls, the step split (forward + backward, clip, B3; B2 a round),
      tokens/s, peak memory; a resume from the round-3 record gives
      round 4's loss and server bus bit-equal; one more step profiled
      (device-busy share, top device items);
   c. the same model cut to 2 layers and a vocabulary of TRAIN_CMP_VOCAB
      (16,384): one round of 1 island x 1 step of 2 x 64 tokens, card vs
      CPU: in f32 every gradient leaf within
      TRAIN_CMP_LEAF, and planted faults in dq / dk / dv refused; in bf16
      the loss, the grad norms and every leaf within their bounds;
   d. granite-moe-1b-a400m served at full width and depth (4 x 2,048,
      96 steps, wgmma route), mixtral-8x7b at full width cut to 1 layer
      (2 x 6,144 past its 4,096 window, 32 steps, wgmma route), and card
      vs CPU as 6c, granite at 2 layers, mixtral at 1 (128 prompt tokens,
      8 steps).
15. rwkv6 and jamba VC training (the same trainer):
   a. B14's backward (csrc/wkv6_bwd.cu) and B15's (csrc/mamba_scan_bwd.cu)
      from their forwards' chunk states against the plain backwards
      (ref.wkv6_bwd / ref.mamba_scan_bwd) per element, each case twice and
      bit-equal: B14 at rwkv6's training shape [8, 32, 128, 64] and at T
      63, 128, 300 with hd 16 and 64 (30% exact-0 decays in some), as
      [b, T, h, hd] strided views; B15 at jamba's training shape [8, 128,
      8,192] ds 16 (u bf16) and at ds 4 and 16, di no multiple of a
      block, u f32 and bf16, B / C column views; each timed at its
      training shape beside the plain backward and the bound (no PyTorch
      call computes either); their ptxas lines;
   b. rwkv6-1.6b at full width cut to 4 of its 24 layers (490,336,256
      parameters) as 14b: 4 rounds, island 0 preempted in round 2, killed
      after round 3 and resumed bit-equal; a step launches B14 8 times
      (with the remat recompute) and its backward 4 times; one step
      profiled;
   c. jamba-v0.1 at full width, blocks (0, 2, 4) of its period (mamba +
      dense twice, attention + dense; 1,317,941,248 parameters), 2
      rounds; a step launches B15 4 times and its backward twice, B13 2
      and its backward once, all B13 on the wgmma routes; one step
      profiled;
   d. card vs CPU as 14c (vocabulary TRAIN_CMP_VOCAB), rwkv6 layers 0-1
      and jamba block 2 (mamba + dense), one island: f32 leaf by leaf,
      with planted faults in
      B14's backward (dk = 0, dw x 1.01) and B15's (dC = 0, dA x 1.01)
      refused; bf16: each leaf no farther from the CPU's f32 gradient than
      twice the CPU's own bf16 gradient is.
16. stablelm-3b (hd 80) and gemma3-4b (hd 256), whose bf16 attention
   the wgmma route took in PR 32:
   a. launch/serve.py's serve at full width, batch 4 x 2,048 prompt
      tokens, 96 greedy decode steps: stablelm-3b cut to 8 of its 32
      layers (892,032,000 parameters), gemma3-4b to its first layer
      group (5 local layers, window 1,024, and 1 global: 1,237,356,032
      parameters); one B13 launch a layer in prefill, all on the wgmma
      route, none in decode; prefill (cold and warm) and decode times,
      tokens/s, peak device memory, the warm prefill's device-busy share;
   b. each at 2 layers (gemma3: one local, one global) card vs CPU as
      6c (B13 on the SIMT route in f32, the wgmma route in bf16), at full
      width but for gemma3's vocabulary, cut to TRAIN_CMP_VOCAB (its
      262,144-row tied embedding would be 78% of the cut's parameters,
      which the CPU's work scales with);
   c. each trained with the launcher's defaults (2 islands x 2 steps of
      8 x 128 tokens) for 2 rounds, as 14b without the checkpoint and the
      profile: stablelm-3b cut to 12 layers (1,209,267,200 parameters),
      gemma3-4b to its first group; every B13 forward, remat recompute
      and backward counted by route, all wgmma; B3 a step, B2 a round;
      round walls, tokens/s, peak memory;
   d. each at 16b's 2 layers card vs CPU as 14c: f32 leaf by leaf within
      TRAIN_CMP_LEAF (B13 on the SIMT routes), the four planted faults
      (dq, dk, dv zeroed; dq x 1.01) refused at hd 80 and at hd 256; bf16
      within 14c's bounds.
17. whisper-tiny and the internvl2-2b VLM stub served and trained, and
   granite-moe trained:
   a. whisper-tiny served at full size (launch/serve.py's serve: batch
      4, 1,500 frames a row, a 376-token prompt, 72 decode steps; 448
      positions, the published decoder context): 12 B13 launches a
      prefill (4 encoder, 4 causal, 4 cross-attention), all on the
      wgmma route, none a decode step, no compaction (the ring wraps at
      step 64 and holds the last 64 positions); then card vs CPU at full
      width and depth as 6c (2e-3 f32, 0.15 bf16);
   b. whisper-tiny trained as 14b (2 islands x 2 steps of 8 x 128
      tokens and 8 x 1,500 frames, 68,977,152 parameters) for 2 rounds:
      24 B13 forwards (remat included) and 12 backwards a step, all
      wgmma; then card vs CPU as 14c, the planted faults refused at the
      cross-attention's projections, bf16 held as 15d;
   c. internvl2-2b at full width cut to 6 of its 24 layers, served at 4 x
      2,048 (256 patches + 1,792 tokens), 96 decode steps at the
      reference's positions (n_patches past the prompt), one
      compaction; its 2-layer training round card vs CPU as 14c at 2 x
      320 positions (vis_proj's gradient printed);
   d. granite-moe-1b-a400m trained at full width and depth (1,334,641,664
      parameters) for 2 rounds: B13 48 forwards and 24 backwards a step
      (hd 64, wgmma), B3 a step, B2 a round; round walls, tokens/s, the
      step split and peak memory.
18. the pod mesh and the sharded flat bus; the mesh plans' one-card
   forms (context-parallel attention, expert-parallel MoE); the
   weights of b-e are drawn on the CPU in threads beside a:
   a. pod meshes of 1, 2, 4 and 8 shards on the one card: Eq. 1 (B1),
      Eq. 2 (B2, 4 clients), Adam (B3), the elastic EASGD round (B5, 3
      replicas), the redistribution broadcast and the masked Eq. 2 with
      a dead (nan) island, a shard at a time, on the bench bus (laid out
      for 8 shards) and at 2^27: each bit-equal to the whole-bus kernel
      call, on the bench bus also to the CPU's plain version; B1, B2,
      B3 and B5 launched once a shard; the per-shard route timed in
      turns against the whole call;
   b. internlm2-1.8b's VC round at full width, 4 layers (14b's cut), 2
      islands x 2 steps of 8 x 128, 3 rounds, island 1 dead in round 2,
      unsharded and with ``flat_shard_axis`` over a 4-shard pod mesh
      (B2 4 times a round): losses and server bit-equal; tokens/s and
      peak memory of both;
   c. qwen2.5-14b at full width, 2 layers, vocabulary 16,384: prefill 4
      x 2,048 under ``NullPlan(attn_mode="cp", cp=4)`` against cp = 1,
      within 0.15 in bf16, every B13 launch on the wgmma route; the
      reduced qwen2.5 under cp = 4 card vs CPU within 2e-3 in f32;
   d. gemma3-4b's first layer group at full width, vocabulary 16,384:
      prefill 2 x 4,096 under cp = 4 with the window gather (one B13
      launch: the global layer) and without it (six), within 0.15; one
      training step under cp = 4 (B13's backward on the global layer)
      against cp = 1, each leaf's gradient within 16d's bf16 bounds;
   e. granite-moe-1b-a400m in full after ``ep_tune(cfg, 4)``: prefill 4
      x 2,048 under ``NullPlan(moe_ep=True, ep=4)`` against the dense
      dispatch at capacity factor 8.0, within 0.15; at its own capacity
      factor the (token, choice) assignments each dispatch drops; one
      training step under EP.
19. the abstract shapes and the mesh plans as data; the production
   plans' chunked decode caches (its wall printed; gemma3's weights
   drawn on the CPU in a thread beside a-b):
   a. every arch at full size on the meta device: ``param_specs`` and
      ``param_count``, ``MeshPlan.build`` on 16 x 16 and 2 x 16 x 16 for
      every applicable shape cell with its parameter, batch and cache
      tables, every cell's ``input_specs``; ``memory_allocated``
      unchanged; a line an arch with its count, bytes and the
      decode_32k / long_500k plans' attn_mode, cache_mode and chunks;
   b. internlm2-1.8b at full width, 2 layers, initialised on the card
      without cast: its tree equals ``param_specs()`` in shape and dtype
      and the bytes it asks the allocator for equal the specs'; prefill
      4 x 2,048 through ``make_prefill_step`` under a ``MeshPlan`` over
      a one-position mesh (caches equal ``cache_specs``), 96 decode
      steps through ``make_decode_step``: B13 twice, wgmma;
   c. the production plans' computing fields on one card
      (``one_card_plan()``): internlm2 (b's weights) under its
      decode_32k plan (16 chunks) at 4 x 2,048, gemma3-4b cut to blocks
      0 and 5 of its first group under its long_500k plan (cp 16, 256
      chunks) at 1 x 4,096; 70 teacher-forced decode steps across the
      compaction, the logits within 0.15 of one chunk without cp.
Then a ``kernels`` JSON line (all 18 kernels; B13's forward and backward
each name their main path's route's source, under ``sources`` both
routes', and under ``route_by_head_dim`` the route bf16 takes at each
head dim; ``launches_phase18`` / ``launches_phase19`` their launches in
those phases), the nvidia-smi line, and the last line ``{"ok": true,
"device": {...}}``.

Each phase's wall time is printed on its own line as the next begins,
and at the end the sum of phases 1-13 (a slow host shows there) and the
total.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# repro_torch.benchmarks.kernel_bench, imported by main() once SRC is on
# the path: the card's memory rate and the one CUDA-event timer
KB = None
# repro_torch.kernels.launches, likewise: B13's launches by route
LA = None
F32_OPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
MAIN_N = 16384                   # the MLP's 13,130 params on the BLOCK bus
BIG_N = 2 ** 27                  # order of the ~100M-parameter demo LM
ACC_BAND = 0.03                  # card vs CPU epoch accuracy (6 of 200)
MAIN_K = (656, 1313)             # sparse payload at densities 0.05 / 0.1
# 4c: examples/quickstart.py's full configuration, its depth (10 epochs)
# cut to 1 to hold the script's time; every epoch does the same work
QUICKSTART_EPOCHS = 1
PROFILE_TASKS = 1                # 4c: client tasks under the profiler
BIG_K = int(BIG_N * 0.05)        # 6,710,886
QBLOCK = 256
# B2's client counts in phase 3: its instances for 1-8 clients and its
# generic one (9 and up); at 2^27 the counts whose [n, 2^27] matrix fits
EQ2_COUNTS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 33, 511)
EQ2_COUNTS_BIG = (1, 4, 8, 9)
# B12's payloads in phase 3 beyond MAIN_K: a k for each k mod 4 (the
# seams' shifts), 105,075 the bench bus's
PACK_KS = (655, 656, 657, 658, 105_075)
# B10's payloads in phase 3 with q at byte offsets 0-15 from a 16-byte
# boundary: heads and tails of every length, packs across a group seam
DEQUANT_KS = (1, 15, 17, 255, 271, 656, 1313, 105_075)
# B5's replica counts in phase 3: its instances for 1-8 and its generic
# one; at 2^27 the smallest, the path's, the largest instance and generic
EASGD_COUNTS = (1, 2, 3, 4, 5, 6, 7, 8, 9)
EASGD_COUNTS_BIG = (1, 3, 8, 9)
# B9's payloads in phase 3 with x at element offsets 0-3 from a 16-byte
# boundary (tests/test_torch_quantize_walk.py's shapes): every k mod 16,
# the wire's block and a generic one
QUANT_KS = tuple(4096 + r for r in range(16))
QUANT_BLOCKS = (QBLOCK, 100)

# results/PINNED_sim_regression.json's 12 flat MLP cases, with the
# configurations of tools/pin_sim_regression.py:33-62, 90-93:
# name -> (scheme class in repro_torch.core.baselines, its kwargs,
# SimConfig overrides of PIN_BASE).  tests/test_torch_simulator.py holds
# this table to the pin tool's own.
PIN_BASE = dict(n_param_servers=2, n_clients=3, tasks_per_client=2,
                n_shards=8, max_epochs=2, local_steps=2,
                subtask_compute_s=120.0, seed=5)
PIN_DATA = dict(n_train=1500, n_val=300, seed=0)
_PREEMPT = dict(preemptible=True, mean_lifetime_s=900.0, restart_delay_s=60.0)
_TWIN = dict(n_param_servers=1, consistency="strong", tasks_per_client=3,
             n_shards=9, max_epochs=1)
PINNED_CASES = {
    "vc-asgd": ("VCASGD", dict(alpha=0.95), {}),
    "vc-asgd-preempt": ("VCASGD", dict(alpha=0.95), _PREEMPT),
    "vc-asgd-compressed": ("CompressedVCASGD",
                           dict(alpha=0.95, density=0.05), _PREEMPT),
    "downpour": ("Downpour", dict(server_lr=0.5), {}),
    "dc-asgd": ("DCASGD", dict(server_lr=0.5, lam=0.05), {}),
    "easgd-persistent": ("EASGDPersistent", dict(beta=0.05), _PREEMPT),
    "easgd-flat-pod": ("EASGDFlatPod", dict(n_replicas=3, beta=0.05), {}),
    "easgd-flat-pod-compressed": (
        "EASGDFlatPod", dict(n_replicas=3, beta=0.05, compress_density=0.1),
        {}),
    "sync-bsp": ("SyncBSP", dict(n_shards=8), {}),
    "vc-asgd-strong": ("VCASGD", dict(alpha=0.95), dict(consistency="strong")),
    "vc-asgd-contended": ("VCASGD", dict(alpha=0.95),
                          dict(n_param_servers=2, tasks_per_client=4,
                               server_proc_s=45.0)),
    "tier-flat-twin": ("VCASGD", dict(alpha=0.9), _TWIN),
}
# the fixture's other 5 cases (tools/pin_sim_regression.py:68-80, :95-98,
# phase 12a): name -> (scheme class, kwargs, SimConfig overrides of
# PIN_BASE, task: "probe" = scenarios/probe.py's ProbeTask on its probe
# data, "mlp" = the MLP on PIN_DATA)
_FLEET = dict(n_param_servers=2, n_clients=120, tasks_per_client=1,
              n_shards=240, max_epochs=2, local_steps=1, timeout_s=1800.0,
              preemptible=True, mean_lifetime_s=5400.0,
              restart_delay_s=120.0, subtask_compute_s=120.0,
              server_proc_s=0.05, seed=7)
PINNED_FLEET_CASES = {
    "fleet-churn": ("VCASGD", dict(alpha=0.95), _FLEET, "probe"),
    "fleet-sharded-bus": ("VCASGD", dict(alpha=0.95),
                          dict(_FLEET, bus_shards=4, seed=11), "probe"),
    "fleet-eval-stride": ("VCASGD", dict(alpha=0.95),
                          dict(_FLEET, eval_stride=8), "probe"),
    "tier-2level": ("VCASGD", dict(alpha=0.9), dict(_TWIN, aggregators=1),
                    "mlp"),
    "tier-fleet": ("VCASGD", dict(alpha=0.95),
                   dict(_FLEET, aggregators=4), "probe"),
}
# the tier cases' extra pinned fields
PIN_TIER = ("aggregators", "agg_flushes", "wire_agg_frames",
            "edge_wire_frames_sent", "edge_wire_bytes_sent")
# the ProbeTask cases' accuracy against the fixture on the card: the
# probe's progress proxy is np.linalg.norm in f32, whose dot another
# numpy build may sum in another order
PROBE_ACC_TOL = 1e-6
# the pinned fields that do not depend on the parameter values
PIN_TRACE = ("wall_time_s", "epochs_done", "results_assimilated",
             "reassignments", "preemptions", "lost_updates", "store_updates",
             "t_complete", "wire_frames_sent", "wire_bytes_sent",
             "wire_frames_recv", "wire_bytes_recv", "wire_frames_dropped",
             "wire_bytes_dropped", "wire_dense_frames", "wire_sparse_frames",
             "wire_handout_frames", "wire_handout_bytes", "leases_expired",
             "leases_dropped")


def pinned_case(name: str):
    """(scheme, SimConfig) of one pinned case of either table, fresh."""
    from repro_torch.core import baselines
    from repro_torch.core.simulator import SimConfig
    cls, kwargs, overrides = (PINNED_CASES[name] if name in PINNED_CASES
                              else PINNED_FLEET_CASES[name][:3])
    return (getattr(baselines, cls)(**kwargs),
            SimConfig(**{**PIN_BASE, **overrides}))


def pinned_task(name: str, cfg):
    """(task, data) of one pinned case: the ProbeTask on its probe data,
    or the MLP on the fixture's data."""
    if PINNED_FLEET_CASES.get(name, (None,) * 4)[3] == "probe":
        from repro_torch.scenarios.probe import ProbeTask, make_probe_data
        return ProbeTask(), make_probe_data(cfg.n_shards, seed=cfg.seed)
    from repro_torch.core.tasks import MLPTask, make_classification_data
    return MLPTask(), make_classification_data(**PIN_DATA)


def pinned_fields(res) -> dict:
    """The pinned fixture's fields of one SimResult (the pin tool's
    run_case, without the accuracy; a tier run's edge fields too)."""
    tier = {}
    if res.aggregators:
        tier = {"aggregators": int(res.aggregators),
                "agg_flushes": int(res.agg_flushes),
                "wire_agg_frames": int(res.wire_agg_frames),
                "edge_wire_frames_sent": int(res.edge_wire.frames_sent),
                "edge_wire_bytes_sent": int(res.edge_wire.bytes_sent)}
    return {**tier, 
        "wall_time_s": float(res.wall_time_s),
        "epochs_done": int(res.epochs_done),
        "results_assimilated": int(res.results_assimilated),
        "reassignments": int(res.reassignments),
        "preemptions": int(res.preemptions),
        "lost_updates": int(res.store_stats.lost_updates),
        "store_updates": int(res.store_stats.updates),
        "t_complete": [float(p.t_complete) for p in res.points],
        "wire_frames_sent": int(res.wire.frames_sent),
        "wire_bytes_sent": int(res.wire.bytes_sent),
        "wire_frames_recv": int(res.wire.frames_recv),
        "wire_bytes_recv": int(res.wire.bytes_recv),
        "wire_frames_dropped": int(res.wire.frames_dropped),
        "wire_bytes_dropped": int(res.wire.bytes_dropped),
        "wire_dense_frames": int(res.wire_dense_frames),
        "wire_sparse_frames": int(res.wire_sparse_frames),
        "wire_handout_frames": int(res.handout_frames),
        "wire_handout_bytes": int(res.handout_bytes),
        "leases_expired": int(res.leases_expired),
        "leases_dropped": int(res.leases_dropped),
    }


def implied_launches(scheme, res) -> dict:
    """The launches of each kernel that a run of ``scheme`` implies."""
    compressed = (getattr(scheme, "density", None) is not None
                  or getattr(scheme, "compress_density", None) is not None)
    submits = res.wire.frames_sent - res.handout_frames
    sparse_submits = submits if compressed else 0
    vc_family = scheme.name.startswith("vc-asgd")
    pod = scheme.name == "easgd-flat-pod"
    return {
        "vc_asgd_lerp_flat": res.results_assimilated if vc_family else 0,
        "assimilate_flat": 0,
        "adam_update_flat": res.client_steps,
        "easgd_elastic_flat": res.scheme_state.version if pod else 0,
        "quantize_int8": sparse_submits,
        "dequantize_int8": sparse_submits + res.wire_sparse_frames,
        "pack_body": sparse_submits,
        "flash_attention": 0,
        "flash_attention_bwd": 0,
        "wkv6": 0,
        "wkv6_bwd": 0,
        "mamba_scan": 0,
        "mamba_scan_bwd": 0,
        "blocked_topk_stats": 0,         # the MLP bus takes the global sort
        "threshold_sparsify_exact": 0,
        "vc_asgd_dc_lerp_flat": 0,       # the bench's kernels (phase 10)
        "threshold_sparsify": 0,
        "quantize_pack": 0,
    }


class SmokeFailure(SystemExit):
    def __init__(self, msg: str):
        print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
        super().__init__(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class Phases:
    """Prints each phase's wall time on its own line when the next one
    starts (and the total at ``end``)."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.name = None
        self.walls = {}

    def start(self, name) -> None:
        now = time.perf_counter()
        if self.name is not None:
            say(f"phase {self.name} wall: {now - self.t:.3f} s")
            self.walls[self.name] = now - self.t
        self.name, self.t = name, now

    def end(self) -> None:
        """The total, and the sum of phases 1-13 (the same work since PR
        27: a slow host shows there before any later phase)."""
        self.start(None)
        early = sum(w for n, w in self.walls.items()
                    if int(re.match(r"\d+", n).group()) <= 13)
        say(f"phases 1-13 wall: {early:.3f} s")
        say(f"total wall: {time.perf_counter() - self.t0:.3f} s")


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def bound_ms(nbytes: float, ops: float):
    t_mem, t_ops = nbytes / KB.HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def say_ptxas(build, source: str, label: str, kernel: str = "") -> None:
    """The ptxas lines (registers, spills, shared memory) of one source's
    kernels, or of those whose mangled names hold ``kernel`` as a whole
    name (``quantize_kernel``, not ``dequantize_kernel``), each after its
    kernel's name, from this run's build."""
    log = build.build_log.get(source)
    if log is None:
        say(f"{label} ptxas: not built in this run (its library was "
            f"already in build/kernels)")
    entry = ""
    for line in (log or "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif (re.search(rf"(?<![A-Za-z_]){kernel}", entry)
              and ("registers" in line or "spill" in line
                   or "smem" in line)):
            say(f"{label} ptxas {entry}: {line.strip()}")


def bits_equal(torch, a, b) -> bool:
    view = torch.int16 if a.dtype in (torch.bfloat16, torch.float16) else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


# ---------------------------------------------------------------------------
# phase 3: kernel parity
# ---------------------------------------------------------------------------

def parity(torch, np, VK, R, n_elems: int, timed: bool) -> dict:
    """Check every kernel against its plain version at ``n_elems``; time
    them (f32) when ``timed``.  Returns per-kernel numbers."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n_elems)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    iters = 50 if n_elems <= MAIN_N else 10
    out = {}

    # B1: Eq. 1
    alpha = 2.0 / 3.0
    for dtype in (torch.float32, torch.bfloat16):
        s, c = rnd(n_elems).to(dtype), rnd(n_elems).to(dtype)
        k, p = VK.vc_asgd_lerp_flat(s, c, alpha), R.vc_asgd_lerp(s, c, alpha)
        torch.cuda.synchronize()
        check(bits_equal(torch, k, p),
              f"Eq. 1 {dtype} N={n_elems}: kernel != plain version")
        say(f"parity B1 vc_asgd_lerp_flat {str(dtype)[6:]} N={n_elems}: bit-exact")
    s, c = rnd(n_elems), rnd(n_elems)
    err = float((VK.vc_asgd_lerp_flat(s, c, alpha)
                 - R.vc_asgd_lerp(s, c, alpha)).abs().max())
    rec = {"max_abs_err": err}
    if timed:
        a32 = float(np.float32(alpha))
        rec["ms"], rec["library_ms"] = in_turns(
            torch, lambda: VK.vc_asgd_lerp_flat(s, c, alpha),
            lambda: torch.lerp(c, s, a32), iters)
        rec["plain_ms"] = KB.cuda_ms(lambda: R.vc_asgd_lerp(s, c, alpha), iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(12 * n_elems, 3 * n_elems)
    out["vc_asgd_lerp_flat"] = rec

    # B2: Eq. 2, at every client count of its own instance (1-8) and on
    # its generic instance (9, 33, 511; at 2^27 the counts that fit)
    for dtype in (torch.float32, torch.bfloat16):
        for n in (EQ2_COUNTS if n_elems <= MAIN_N else EQ2_COUNTS_BIG):
            s, cl = rnd(n_elems).to(dtype), rnd(n, n_elems).to(dtype)
            w = [alpha ** n] + [(1 - alpha) * alpha ** (n - 1 - j) for j in range(n)]
            k, p = VK.assimilate_flat(s, cl, w), R.assimilate(s, cl, w)
            torch.cuda.synchronize()
            check(bits_equal(torch, k, p),
                  f"Eq. 2 {dtype} n={n} N={n_elems}: kernel != plain version")
            say(f"parity B2 assimilate_flat {str(dtype)[6:]} n={n} N={n_elems}: bit-exact")
            del s, cl, k, p
    n = 4
    s, cl = rnd(n_elems), rnd(n, n_elems)
    w = [alpha ** n] + [(1 - alpha) * alpha ** (n - 1 - j) for j in range(n)]
    err = float((VK.assimilate_flat(s, cl, w) - R.assimilate(s, cl, w)).abs().max())
    rec = {"max_abs_err": err}
    if timed:
        w32 = torch.tensor(np.asarray(w[1:], np.float32), device=dev)
        clt = cl.t()
        w0 = float(np.float32(w[0]))
        rec["ms"], rec["library_ms"] = in_turns(
            torch, lambda: VK.assimilate_flat(s, cl, w),
            lambda: torch.addmv(s, clt, w32, beta=w0), iters)
        rec["plain_ms"] = KB.cuda_ms(lambda: R.assimilate(s, cl, w), iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * (n + 2) * n_elems, (2 * n + 1) * n_elems)
    out["assimilate_flat"] = rec
    del s, cl

    # B3: fused Adam (t = 3: every bias correction term is live), params
    # in f32 and bf16 storage, with and without weight decay
    t = 3
    c1 = np.float32(1) - np.float32(0.9) ** np.float32(t)
    c2 = np.float32(1) - np.float32(0.999) ** np.float32(t)
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    for dtype in (torch.float32, torch.bfloat16):
        for wd in (0.0, 0.01):
            p, gr, m = rnd(n_elems).to(dtype), rnd(n_elems), rnd(n_elems)
            v = rnd(n_elems).abs()
            kern = VK.adam_update_flat(p, gr, m, v, hyper["lr"], hyper["b1"],
                                       hyper["b2"], hyper["eps"], wd, c1, c2)
            plain = R.adam_update(p, gr, m, v, c1=c1, c2=c2,
                                  weight_decay=wd, **hyper)
            torch.cuda.synchronize()
            for name, a, b in zip(("p", "m", "v"), kern, plain):
                check(bits_equal(torch, a, b),
                      f"Adam {dtype} wd={wd} N={n_elems}: lane {name}: "
                      f"kernel != plain version")
            say(f"parity B3 adam_update_flat {str(dtype)[6:]} wd={wd} "
                f"N={n_elems}: bit-exact")
    p, gr, m = rnd(n_elems), rnd(n_elems), rnd(n_elems)
    v = rnd(n_elems).abs()
    kern = VK.adam_update_flat(p, gr, m, v, hyper["lr"], hyper["b1"],
                               hyper["b2"], hyper["eps"], 0.0, c1, c2)
    plain = R.adam_update(p, gr, m, v, c1=c1, c2=c2, weight_decay=0.0,
                          **hyper)
    err = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
    rec = {"max_abs_err": err}
    if timed:
        lp, lm, lv = p.clone(), m.clone(), v.clone()
        step = [torch.tensor(float(t), device=dev)]
        rec["ms"], rec["library_ms"] = in_turns(
            torch, lambda: VK.adam_update_flat(
                p, gr, m, v, hyper["lr"], hyper["b1"], hyper["b2"],
                hyper["eps"], 0.0, c1, c2),
            lambda: torch._fused_adam_(
                [lp], [gr], [lm], [lv], [], step, lr=hyper["lr"],
                beta1=hyper["b1"], beta2=hyper["b2"], weight_decay=0.0,
                eps=hyper["eps"], amsgrad=False, maximize=False), iters)
        rec["plain_ms"] = KB.cuda_ms(lambda: R.adam_update(
            p, gr, m, v, c1=c1, c2=c2, weight_decay=0.0, **hyper), iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(28 * n_elems, 14 * n_elems)
    out["adam_update_flat"] = rec
    if timed:
        for name, r in out.items():
            say(f"timing {name} N={n_elems}: kernel {r['ms']:.6f} ms")
            say(f"timing {name} N={n_elems}: plain {r['plain_ms']:.6f} ms")
            say(f"timing {name} N={n_elems}: library {r['library_ms']:.6f} ms")
            say(f"timing {name} N={n_elems}: bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% "
                f"of it")
    return out


def pack_seams(torch, SK, R, rnd) -> None:
    """B12 byte-equal at a k for each k mod 4 (both seams of the body
    unaligned by each shift), with q read at byte offsets 0-3 (q a slice
    of a larger buffer)."""
    dev = torch.device("cuda")
    for k in PACK_KS:
        ng = -(-k // QBLOCK)
        q0 = (rnd(k + 3) * 60).round().clamp(-127, 127).to(torch.int8)
        sc = rnd(ng).abs() * 0.01
        idx = torch.arange(k, dtype=torch.int32, device=dev) * 7 + 3
        for off in range(4):
            q = q0[off:off + k]
            kb, pb = SK.pack_body(q, sc, idx), R.pack_body(q, sc, idx)
            torch.cuda.synchronize()
            check(kb.numel() == 5 * k + 4 * ng and torch.equal(kb, pb),
                  f"pack_body k={k} q at byte {off}: kernel != plain version")
        say(f"parity B12 pack_body k={k} (k mod 4 = {k % 4}), q at byte "
            f"offsets 0-3: bytes equal")


def dequant_offsets(torch, QK, R, rnd) -> None:
    """B10 bit-exact at DEQUANT_KS with q at every byte offset 0-15 from a
    16-byte boundary (q a view of a larger buffer): the head, the packs
    that straddle two groups, the tail."""
    dev = torch.device("cuda")
    for k in DEQUANT_KS:
        ng = -(-k // QBLOCK)
        base = (rnd(k + 32) * 60).round().clamp(-127, 127).to(torch.int8)
        sc = rnd(ng).abs() * 0.01
        for off in range(16):
            lead = (off - base.data_ptr()) % 16
            q = base[lead:lead + k]
            kd, pd = QK.dequantize_int8(q, sc, k), R.dequantize_int8(q, sc, k)
            torch.cuda.synchronize()
            check(q.data_ptr() % 16 == off and bits_equal(torch, kd, pd),
                  f"dequantize k={k} q at byte {off}: kernel != plain")
        say(f"parity B10 dequantize_int8 k={k}, q at byte offsets 0-15: "
            f"bit-exact")


def quantize_offsets(torch, QK, R, rnd) -> None:
    """B9 bit-exact at QUANT_KS with x at element offsets 0-3 from a
    16-byte boundary (x a view of a larger buffer: 1-3 take the value
    loads), at the wire's block and a generic one."""
    for k in QUANT_KS:
        base = rnd(k + 8) * 0.01
        for off in range(4):
            lead = (off - base.data_ptr() // 4) % 4
            x = base[lead:lead + k]
            for block in QUANT_BLOCKS:
                (kq, ks_), (pq, ps) = (QK.quantize_int8(x, block),
                                       R.quantize_int8(x, block))
                torch.cuda.synchronize()
                check(x.data_ptr() % 16 == 4 * off and torch.equal(kq, pq)
                      and bits_equal(torch, ks_, ps),
                      f"quantize k={k} x at element {off} block {block}: "
                      f"kernel != plain")
    say(f"parity B9 quantize_int8 k = {QUANT_KS[0]}..{QUANT_KS[-1]} (every "
        f"k mod 16), x at element offsets 0-3, block {QUANT_BLOCKS}: "
        f"bit-exact")


def in_turns(torch, kernel, library, iters: int) -> tuple:
    """(kernel ms, library ms) a call by CUDA events, timed in turns (K L
    L K, twice) after a warm-up (wrapper_cost.event_ms)."""
    from repro_torch.benchmarks import wrapper_cost as WC
    ms = WC.event_ms(torch, {"kernel": kernel, "library": library}, iters)
    return ms["kernel"], ms["library"]


def wrapper_host_cost(torch, np, VK, SK, QK, TK, LA) -> dict:
    """Phase 3: host microseconds of one B1, B3, B2, B12 and B10 wrapper
    call and of the one PyTorch call computing the same function
    (torch.lerp, torch._fused_adam_, torch.addmv, torch.cat, torch.mul),
    and of one B9 and one B5 call (no such PyTorch call), at the main
    sizes (the MLP bus, N = MAIN_N f32, Eq. 2 over 4 clients, EASGD over 3
    replicas; k = 656 for the pack and the codec; each kernel shorter than
    its call): the host clock around
    200 back-to-back calls, every call of wrapper_cost.calls in turns
    over 9 rounds, the median kept (wrapper_cost.host_us).  The launch
    helper's raw stream handle is held to the current stream's."""
    from repro_torch.benchmarks import wrapper_cost as WC
    idx = torch.cuda.current_device()
    check(LA._raw_stream(idx) == torch.cuda.current_stream().cuda_stream,
          "launches: the raw stream handle is not the current stream's")
    us = WC.host_us(torch, WC.calls(torch, np, VK, SK, QK, TK, MAIN_N))
    out = {}
    for kern, lib in (("B1 vc_asgd_lerp_flat", "torch.lerp"),
                      ("B3 adam_update_flat", "torch._fused_adam_"),
                      ("B2 assimilate_flat", "torch.addmv"),
                      ("B12 pack_body", "torch.cat"),
                      ("B10 dequantize_int8", "torch.mul"),
                      ("B9 quantize_int8", None),
                      ("B5 easgd_elastic_flat", None)):
        size = WC.size_of(kern, MAIN_N)
        lib_us = None if lib is None else us[lib]
        say(f"host cost {kern} {size}: {us[kern]:.2f} us a call, "
            + ("no library call" if lib is None else
               f"{lib} {lib_us:.2f} us") + " (in turns, median of 9 rounds)")
        out[kern.split()[1]] = {"host_us": us[kern],
                                "library_host_us": lib_us}
    return out


def parity_scheme_kernels(torch, np, KK, R, n_elems: int, ks, timed: bool
                          ) -> dict:
    """The scheme-comparison path's kernels against their plain versions:
    the elastic EASGD round (B5) at ``n_elems`` with 1 and 3 replicas in
    f32 and bf16, int8 quantize / dequantize (B9, B10) and the sparse-body
    pack (B12) at each payload size in ``ks``.  Timed (B5 f32 with 3
    replicas, the codec and pack at ``ks[0]``) when ``timed``."""
    from repro_torch.benchmarks import wrapper_cost as WC
    VK, QK, SK = KK
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n_elems + 7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    iters = 50 if n_elems <= MAIN_N else 10
    out = {}

    # B5: elastic EASGD round, replicas in slot order
    beta = 0.05
    for dtype in (torch.float32, torch.bfloat16):
        for n in (EASGD_COUNTS if n_elems <= MAIN_N else EASGD_COUNTS_BIG):
            c, x = rnd(n_elems).to(dtype), rnd(n, n_elems).to(dtype)
            (kc, kx), (pc, px) = (VK.easgd_elastic_flat(c, x, beta),
                                  R.easgd_elastic(c, x, beta))
            torch.cuda.synchronize()
            check(bits_equal(torch, kc, pc) and bits_equal(torch, kx, px),
                  f"EASGD {dtype} n={n} N={n_elems}: kernel != plain version")
            say(f"parity B5 easgd_elastic_flat {str(dtype)[6:]} n={n} "
                f"N={n_elems}: bit-exact")
            del c, x, kc, kx, pc, px
    n = 3
    c, x = rnd(n_elems), rnd(n, n_elems)
    (kc, kx), (pc, px) = (VK.easgd_elastic_flat(c, x, beta),
                          R.easgd_elastic(c, x, beta))
    rec = {"max_abs_err": max(float((kc - pc).abs().max()),
                              float((kx - px).abs().max())),
           "library_ms": None}
    if timed:
        rec["ms"] = KB.cuda_ms(lambda: VK.easgd_elastic_flat(c, x, beta),
                               iters)
        rec["plain_ms"] = KB.cuda_ms(lambda: R.easgd_elastic(c, x, beta),
                                     iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            2 * 4 * (n + 1) * n_elems, (4 * n + 2) * n_elems)
        if n_elems <= MAIN_N:
            rec["device_us"] = WC.graph_us(
                torch, lambda: VK.easgd_elastic_flat(c, x, beta))
    out["easgd_elastic_flat"] = rec
    del c, x, kc, kx, pc, px

    # B9 / B10 / B12 at each payload size
    for k in ks:
        ng = -(-k // QBLOCK)
        sel = rnd(k) * 0.01
        sel[k // 3] = 0.0
        (kq, ks_), (pq, ps) = QK.quantize_int8(sel), R.quantize_int8(sel)
        torch.cuda.synchronize()
        check(torch.equal(kq, pq) and bits_equal(torch, ks_, ps),
              f"quantize k={k}: kernel != plain version")
        kd, pd = QK.dequantize_int8(kq, ks_, k), R.dequantize_int8(kq, ks_, k)
        torch.cuda.synchronize()
        check(bits_equal(torch, kd, pd), f"dequantize k={k}: kernel != plain")
        idx = torch.arange(k, dtype=torch.int32, device=dev) * 13 + 5
        kb, pb = SK.pack_body(kq, ks_, idx), R.pack_body(kq, ks_, idx)
        torch.cuda.synchronize()
        check(kb.numel() == 5 * k + 4 * ng and torch.equal(kb, pb),
              f"pack_body k={k}: kernel != plain version")
        say(f"parity B9/B10/B12 quantize/dequantize/pack_body k={k}: "
            f"bit-exact")
        if k != ks[0]:
            continue
        recs = {"quantize_int8": {"max_abs_err": float(
                    (kq.float() - pq.float()).abs().max()), "library_ms": None},
                "dequantize_int8": {"max_abs_err": float(
                    (kd - pd).abs().max())},
                "pack_body": {"max_abs_err": float(
                    (kb.int() - pb.int()).abs().max())}}
        if timed:
            q_pad = torch.zeros(ng * QBLOCK, dtype=torch.int8, device=dev)
            q_pad[:k] = kq
            r = recs["quantize_int8"]
            r["ms"] = KB.cuda_ms(lambda: QK.quantize_int8(sel), iters)
            r["device_us"] = WC.graph_us(torch, lambda: QK.quantize_int8(sel))
            r["plain_ms"] = KB.cuda_ms(lambda: R.quantize_int8(sel), iters)
            r["bound_ms"], r["bound_by"] = bound_ms(4 * k + k + 4 * ng, 5 * k)
            r = recs["dequantize_int8"]
            q_rows, sc_col = q_pad.view(ng, QBLOCK), ks_[:, None]
            r["ms"], r["library_ms"] = in_turns(
                torch, lambda: QK.dequantize_int8(kq, ks_, k),
                lambda: torch.mul(q_rows, sc_col), iters)
            r["plain_ms"] = KB.cuda_ms(
                lambda: R.dequantize_int8(kq, ks_, k), iters)
            r["bound_ms"], r["bound_by"] = bound_ms(k + 4 * ng + 4 * k, k)
            r = recs["pack_body"]
            r["ms"], r["library_ms"] = in_turns(
                torch, lambda: SK.pack_body(kq, ks_, idx),
                lambda: torch.cat([kq.view(torch.uint8), ks_.view(torch.uint8),
                                   idx.view(torch.uint8)]), iters)
            r["plain_ms"] = KB.cuda_ms(
                lambda: R.pack_body(kq, ks_, idx), iters)
            r["bound_ms"], r["bound_by"] = bound_ms(2 * (5 * k + 4 * ng), 0)
        out.update(recs)
    if n_elems <= MAIN_N:
        pack_seams(torch, SK, R, rnd)
        dequant_offsets(torch, QK, R, rnd)
        quantize_offsets(torch, QK, R, rnd)
    if timed:
        for name, r in out.items():
            size = f"N={n_elems} n=3" if name == "easgd_elastic_flat" \
                else f"k={ks[0]}"
            say(f"timing {name} {size}: kernel {r['ms']:.6f} ms")
            say(f"timing {name} {size}: plain {r['plain_ms']:.6f} ms")
            lib = r["library_ms"]
            say(f"timing {name} {size}: library "
                + ("none" if lib is None else f"{lib:.6f} ms"))
            say(f"timing {name} {size}: bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% "
                f"of it")
            if "device_us" in r:
                say(f"timing {name} {size}: device {r['device_us']:.3f} us "
                    f"a call (100 calls in a CUDA graph), "
                    f"{100e3 * r['bound_ms'] / r['device_us']:.1f}% of the "
                    f"bound")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

TRACE = ("wall_time_s", "epochs_done", "reassignments", "preemptions",
         "results_assimilated", "handout_frames", "handout_bytes",
         "leases_expired", "leases_dropped", "events_processed",
         "wire_dense_frames", "client_steps")


def quickstart(smoke: bool, epochs=None):
    """(data, SimConfig) of examples/quickstart.py; ``epochs`` cuts its
    depth."""
    from repro_torch.core.simulator import SimConfig
    from repro_torch.core.tasks import make_classification_data
    data = make_classification_data(n_train=800 if smoke else 4000,
                                    n_val=200 if smoke else 800)
    if epochs is None:
        epochs = 2 if smoke else QUICKSTART_EPOCHS
    cfg = SimConfig(n_param_servers=3, n_clients=5, tasks_per_client=2,
                    n_shards=8 if smoke else 25, max_epochs=epochs,
                    preemptible=True, mean_lifetime_s=2400.0,
                    consistency="eventual", seed=0)
    return data, cfg


def run(device, smoke: bool, task=None, epochs=None):
    from repro_torch.core.baselines import VCASGD
    from repro_torch.core.simulator import run_simulation
    from repro_torch.core.tasks import MLPTask
    from repro_torch.core.vc_asgd import var_alpha
    data, cfg = quickstart(smoke, epochs)
    t0 = time.perf_counter()
    res = run_simulation(task or MLPTask(), data, VCASGD(alpha=var_alpha()),
                         cfg, device=device)
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_counts(VK, res, label: str) -> dict:
    counts = VK.launch_counts()
    say(f"{label}: launches {counts}, results_assimilated "
        f"{res.results_assimilated}, client_steps {res.client_steps}")
    check(counts["vc_asgd_lerp_flat"] == res.results_assimilated > 0,
          f"{label}: Eq. 1 launches {counts['vc_asgd_lerp_flat']} != "
          f"results assimilated {res.results_assimilated}")
    check(counts["adam_update_flat"] == res.client_steps > 0,
          f"{label}: Adam launches {counts['adam_update_flat']} != "
          f"client steps {res.client_steps}")
    return counts


def profile_smoke(torch, VK):
    """The smoke run's first PROFILE_TASKS client tasks on the card under
    torch.profiler (the rest of its first epoch runs unrecorded; the
    whole first epoch until PR 32, whose post-processing took 35 s of
    the script): device busy share and the top kernels/ops."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.core.tasks import MLPTask
    real, ends = MLPTask.client_train, []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=0, active=PROFILE_TASKS,
                                   repeat=1)) as prof:
        t0 = time.perf_counter()

        def stepped(*a, **k):
            out = real(*a, **k)
            if len(ends) < PROFILE_TASKS:
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
            prof.step()
            return out
        MLPTask.client_train = stepped
        try:
            run("cuda", smoke=True, epochs=1)
        finally:
            MLPTask.client_train = real
    check(len(ends) == PROFILE_TASKS, f"the smoke run took {len(ends)} "
          f"client tasks, fewer than {PROFILE_TASKS}")
    wall = ends[-1] - t0
    report_profile(prof, f"smoke, its first {PROFILE_TASKS} client tasks "
                   f"(profiled wall {wall:.3f} s)", wall)


def host_breakdown(run_fn, targets=None):
    """Host wall time spent inside each of ``targets`` ((class or module,
    attribute) pairs; by default the layers of the loop: client training,
    the coordinator's wire legs, the server fold and evaluation) during
    ``run_fn()``.  Each sums to its own sync points, so a layer that waits
    on the device carries the device work before it."""
    from repro_torch.core.tasks import MLPTask
    from repro_torch.protocol.coordinator import Coordinator
    spans = {}
    if targets is None:
        targets = [(MLPTask, "client_train"), (MLPTask, "evaluate"),
                   (Coordinator, "issue"), (Coordinator, "submit"),
                   (Coordinator, "deliver"), (Coordinator, "assimilate")]
    saved = [(cls, name, getattr(cls, name)) for cls, name in targets]

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for cls, name, fn in saved:
        owner = cls.__name__.rsplit(".", 1)[-1]
        setattr(cls, name, timed(f"{owner}.{name}", fn))
    try:
        result = run_fn()
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return result, spans


def pinned_replay(torch, VK) -> dict:
    """Phase 4d: the 12 flat MLP cases of the pinned fixture on the card
    and on the CPU from one seed.  Returns the card runs' launches summed
    over the cases."""
    from repro_torch.core.simulator import run_simulation
    from repro_torch.core.tasks import MLPTask, make_classification_data
    pin = json.loads((ROOT / "results" / "PINNED_sim_regression.json")
                     .read_text())
    check(pin["base_cfg"] == PIN_BASE and pin["data"] == PIN_DATA,
          "the pinned fixture's base configuration is not the one replayed")
    data = make_classification_data(**PIN_DATA)
    totals = dict.fromkeys(VK.KERNELS, 0)
    for name in PINNED_CASES:
        want = pin["cases"][name]
        runs = {}
        for device in ("cuda", "cpu"):
            scheme, cfg = pinned_case(name)
            VK.reset_launch_count()
            res = run_simulation(MLPTask(), data, scheme, cfg, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            runs[device] = (scheme, res, VK.launch_counts())
        scheme, res_g, counts = runs["cuda"]
        _, res_c, counts_cpu = runs["cpu"]
        check(sum(counts_cpu.values()) == 0,
              f"pinned {name}: the CPU run launched a CUDA kernel")
        implied = implied_launches(scheme, res_g)
        check(counts == implied, f"pinned {name}: launches {counts} != "
              f"implied by the path {implied}")
        got_g, got_c = pinned_fields(res_g), pinned_fields(res_c)
        for f in PIN_TRACE:
            check(got_g[f] == want[f], f"pinned {name}: {f} on cuda "
                  f"{got_g[f]} != pinned {want[f]}")
            check(got_c[f] == want[f], f"pinned {name}: {f} on cpu "
                  f"{got_c[f]} != pinned {want[f]}")
        accs_g = [p.acc_mean for p in res_g.points] + [res_g.final_accuracy]
        accs_c = [p.acc_mean for p in res_c.points] + [res_c.final_accuracy]
        gap = max(abs(a - b) for a, b in zip(accs_g, accs_c))
        check(gap <= ACC_BAND, f"pinned {name}: accuracy cuda vs cpu {gap}")
        buf = res_g.scheme_state.params.buf
        check(bool(torch.isfinite(buf).all()) and buf.shape == (MAIN_N,),
              f"pinned {name}: server bus not finite or wrong shape")
        say(f"pinned {name}: trace == pin (cuda and cpu), acc gap "
            f"{gap:.4f}, final acc cuda {res_g.final_accuracy:.4f}, "
            f"launches " + ", ".join(f"{k}={v}" for k, v in counts.items()
                                     if v))
        for k, v in counts.items():
            totals[k] += v
    return totals


def comparison(torch, VK) -> None:
    """Phase 4e: examples/asgd_comparison.py's full configuration (3,000
    training rows, 15 shards, 6 epochs, 5 preemptible clients), its eight
    schemes on the card."""
    from repro_torch.core import baselines as B
    from repro_torch.core import compression
    from repro_torch.core.simulator import SimConfig, run_simulation
    from repro_torch.core.tasks import MLPTask, make_classification_data
    from repro_torch.core.vc_asgd import var_alpha
    from repro_torch.transfer import wire
    data = make_classification_data(n_train=3000, n_val=800)
    n_shards = 15
    schemes = {
        "vc-asgd(0.95)": lambda: B.VCASGD(0.95),
        "vc-asgd(var)": lambda: B.VCASGD(var_alpha()),
        "vc-asgd(0.999)~easgd": lambda: B.VCASGD(0.999),
        "vc-asgd-compressed": lambda: B.CompressedVCASGD(0.95, density=0.05),
        "downpour": lambda: B.Downpour(server_lr=0.5),
        "dc-asgd": lambda: B.DCASGD(server_lr=0.5, lam=0.05),
        "easgd-persistent": lambda: B.EASGDPersistent(beta=0.05),
        "sync-bsp": lambda: B.SyncBSP(n_shards),
    }
    say(f"{'scheme':>22} {'hours':>7} {'final acc':>10} {'preempt':>8} "
        f"{'reassigned':>10} {'wire MB':>8} {'wall s':>8} {'steps':>6} "
        f"{'ms/step':>8} {'compress %':>10} {'encode_sparse %':>15}")
    for name, make in schemes.items():
        scheme = make()
        cfg = SimConfig(n_param_servers=3, n_clients=5, tasks_per_client=2,
                        n_shards=n_shards, max_epochs=6, local_steps=2,
                        preemptible=True, mean_lifetime_s=1200.0, seed=3)

        def go():
            t0 = time.perf_counter()
            res = run_simulation(MLPTask(), data, scheme, cfg, device="cuda")
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        VK.reset_launch_count()
        (res, wall), spans = host_breakdown(
            go, [(compression, "compress_flat"), (wire, "encode_sparse")])
        counts = VK.launch_counts()
        implied = implied_launches(scheme, res)
        check(counts == implied, f"comparison {name}: launches {counts} != "
              f"implied by the path {implied}")
        check(res.epochs_done == 6 and 0.0 <= res.final_accuracy <= 1.0,
              f"comparison {name}: did not finish its 6 epochs")
        share = lambda key: 100 * spans.get(key, 0.0) / wall
        say(f"{name:>22} {res.wall_time_s / 3600:>7.2f} "
            f"{res.final_accuracy:>10.3f} {res.preemptions:>8} "
            f"{res.reassignments:>10} {res.wire.bytes_sent / 1e6:>8.1f} "
            f"{wall:>8.3f} {res.client_steps:>6} "
            f"{1e3 * wall / res.client_steps:>8.3f} "
            f"{share('compression.compress_flat'):>10.2f} "
            f"{share('wire.encode_sparse'):>15.2f}")


# ---------------------------------------------------------------------------
# phase 6: serve
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16, tensor cores
# kernel vs plain, as (atol, rtol) by route.  SIMT: 2e-5 in f32 (the
# reference's blocked-vs-plain tolerance), tests/test_kernels.py TOL in
# bf16 (outputs rounded to bf16).  wgmma (bf16 at hd 64, 80, 128 and 256,
# P rounded to bf16 for P.V): the bound its source states, 5e-3 before
# the output's rounding plus one bf16 ulp of |plain| (at most 2^-7
# |plain|)
ATTN_TOL = {("simt", "float32"): (2e-5, 2e-5),
            ("simt", "bfloat16"): (2e-2, 2e-2),
            ("wgmma", "bfloat16"): (5e-3, 2 ** -7)}
# B13 at the serving path's shapes and the family's others: (b, h, kvh,
# sq, skv, hd, dtype, causal, window, softcap, qk) with q and k drawn at
# qk N(0,1), v at N(0,1): 0.5 gives a flat softmax, 2 a peaked one whose
# row max moves between kv tiles (what the online rescale must follow)
ATTN_SHAPES = {
    "a internlm2 prefill": (4, 16, 8, 2048, 2048, 128, "bfloat16", True,
                            None, None, 0.5),
    "a2 internlm2 prefill, peaked": (4, 16, 8, 2048, 2048, 128, "bfloat16",
                                     True, None, None, 2.0),
    "b gemma3 local": (2, 8, 4, 2300, 2300, 256, "bfloat16", True, 1024,
                       None, 0.5),
    "c cross softcap": (1, 4, 4, 333, 517, 64, "float32", False, None, 50.0,
                        0.5),
    "d h=kvh hd16": (2, 4, 4, 512, 512, 16, "bfloat16", True, None, None,
                     0.5),
    "e jamba prefill": (4, 32, 8, 2048, 2048, 128, "bfloat16", True, None,
                        None, 0.5),
    "e2 jamba prefill, peaked": (4, 32, 8, 2048, 2048, 128, "bfloat16",
                                 True, None, None, 2.0),
    "f granite prefill": (4, 16, 8, 2048, 2048, 64, "bfloat16", True, None,
                          None, 0.5),
    "f2 granite prefill, peaked": (4, 16, 8, 2048, 2048, 64, "bfloat16",
                                   True, None, None, 2.0),
    "g hd64 ragged cross": (1, 4, 2, 333, 517, 64, "bfloat16", False, None,
                            None, 0.5),
    "h hd64 window": (2, 16, 8, 2300, 2300, 64, "bfloat16", True, 1024,
                      None, 2.0),
    # stablelm-3b's prefill (hd 80: hd 128's wgmma instance on tiles
    # zero-filled past column 80) and gemma3-4b's global layers (hd 256:
    # 64-key tiles), 4 x 2,048 bf16, flat and peaked
    "i stablelm-3b prefill": (4, 32, 32, 2048, 2048, 80, "bfloat16", True,
                              None, None, 0.5),
    "i2 stablelm-3b prefill, peaked": (4, 32, 32, 2048, 2048, 80,
                                       "bfloat16", True, None, None, 2.0),
    "j gemma3-4b prefill": (4, 8, 4, 2048, 2048, 256, "bfloat16", True,
                            None, None, 0.5),
    "j2 gemma3-4b prefill, peaked": (4, 8, 4, 2048, 2048, 256, "bfloat16",
                                     True, None, None, 2.0),
    # whisper-tiny served (MHA 6 / 6, hd 64, not causal): the encoder over
    # 1,500 frames (the last kv tile 92 keys) and the decoder's 376-row
    # prompt against them in cross-attention
    "k whisper encoder": (4, 6, 6, 1500, 1500, 64, "bfloat16", False, None,
                          None, 0.5),
    "k2 whisper cross": (4, 6, 6, 376, 1500, 64, "bfloat16", False, None,
                         None, 0.5),
}
# host cost of one wrapper call, at a shape whose kernel is shorter than
# the call: (b, h, kvh, s)
HOST_SHAPE, HOST_CALLS = (1, 4, 2, 128), 200
SERVE_ARGS = ["--arch", "internlm2-1.8b", "--batch", "4", "--prompt-len",
              "2048", "--gen", "96"]
SERVE_LAYERS = 24                # internlm2-1.8b: one B13 launch a layer
# decode steps under the profiler (the profiler's post-processing costs
# ~12 s per second of profiled decode)
PROFILE_STEPS = 2
# card vs CPU: internlm2-1.8b's full width, depth cut to 2 layers
CMP_LAYERS, CMP_BATCH, CMP_PROMPT, CMP_STEPS = 2, 2, 256, 72
# logits, card vs CPU: 2e-3 in f32 compute (the reference's own
# prefill/decode tolerance); bf16 as tests/test_torch_models.py states it
CMP_TOL = {"float32": 2e-3, "bfloat16": 0.15}
# B13's route in 6c / 8c / 14d (head dim 128, granite's 64)
ATTN_ROUTES = {"float32": "simt", "bfloat16": "wgmma"}


def attn_pairs(np, sq: int, skv: int, causal: bool, window) -> int:
    """Visible (query, key) pairs: the work this call's masks leave."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, q + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attention_host_cost(torch, FK) -> None:
    """Host microseconds of one B13 wrapper call on each route (enqueue
    only: the kernel is shorter than the call; the wgmma route's includes
    encoding its three tensor maps), at HOST_SHAPE."""
    b, h, kvh, s = HOST_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(b, h, s, 128, device="cuda").to(dt)
        k = torch.randn(b, kvh, s, 128, device="cuda").to(dt)
        FK.flash_attention(q, k, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            FK.flash_attention(q, k, k)
        us = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
        torch.cuda.synchronize()
        say(f"B13 host cost, route {FK.route(q)} ({dt}, [{b},{h}/{kvh},{s},"
            f"128]): {us:.1f} us a wrapper call")


def attention_parity(torch, np, FK, R) -> dict:
    """B13 against its plain version at ATTN_SHAPES; kernel, plain and
    (where one PyTorch call computes the same function) SDPA times and
    the bound at each, with the route that took each shape.  Returns the
    record of shape (a)."""
    import math
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    out = None
    for name, (b, h, kvh, sq, skv, hd, dt, causal, window, softcap,
               qk) in ATTN_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(sq + hd)
        dtype = getattr(torch, dt)
        q = (torch.randn(b, h, sq, hd, generator=g, device=dev) * qk
             ).to(dtype)
        k = (torch.randn(b, kvh, skv, hd, generator=g, device=dev) * qk
             ).to(dtype)
        v = torch.randn(b, kvh, skv, hd, generator=g, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, softcap=softcap)
        kern, plain = FK.flash_attention(q, k, v, **kw), R.attention(q, k, v,
                                                                     **kw)
        torch.cuda.synchronize()
        diff = (kern.float() - plain.float()).abs()
        atol, rtol = ATTN_TOL[FK.route(q), dt]
        err = float(diff.max())
        # the largest share of its limit that any output takes (<= 1: pass)
        share = float((diff / (atol + rtol * plain.float().abs())).max())
        tol = f"atol {atol:g} + rtol {rtol:g} |plain|"
        check(share <= 1.0, f"B13 {name}: kernel vs plain max abs err {err},"
                            f" {share:.3f} of its limit ({tol})")
        del kern, plain, diff
        esize = 2 if dt == "bfloat16" else 4
        ops = 4 * hd * b * h * attn_pairs(np, sq, skv, causal, window)
        nbytes = esize * (2 * b * h * sq * hd + 2 * b * kvh * skv * hd)
        peak = BF16_OPS_PER_S if dt == "bfloat16" else F32_OPS_PER_S
        t_mem, t_ops = nbytes / KB.HBM_BYTES_PER_S, ops / peak
        rec = {"max_abs_err": err, "bound_ms": 1e3 * max(t_mem, t_ops),
               "bound_by": "bytes" if t_mem >= t_ops else "operations",
               "ms": KB.cuda_ms(lambda: FK.flash_attention(q, k, v, **kw),
                                10),
               "plain_ms": KB.cuda_ms(lambda: R.attention(q, k, v, **kw),
                                      3),
               "library_ms": None}
        if window is None and softcap is None:      # SDPA has neither
            rec["library_ms"] = KB.cuda_ms(lambda: sdpa(
                q, k, v, is_causal=causal, scale=1.0 / math.sqrt(hd),
                enable_gqa=h != kvh), 10)
        simt = ""
        # the SIMT forward beside the wgmma one where both are built: bf16
        # at hd 64, 80 and 256, the routes of granite's, stablelm-3b's and
        # gemma3-4b's prefills before the wgmma kernel took them
        if FK.route(q) == "wgmma" and hd != 128:
            got = FK.flash_attention(q, k, v, kernel="simt", **kw)
            plain = R.attention(q, k, v, **kw)
            atol, rtol = ATTN_TOL["simt", dt]
            d = (got.float() - plain.float()).abs()
            s_share = float((d / (atol + rtol * plain.float().abs())).max())
            check(s_share <= 1.0, f"B13 {name}: the SIMT kernel vs plain "
                  f"{s_share:.3f} of its limit")
            del got, plain, d
            s_ms = KB.cuda_ms(lambda: FK.flash_attention(
                q, k, v, kernel="simt", **kw), 3)
            simt = (f"; the SIMT kernel on the same inputs {s_ms:.4f} ms "
                    f"({s_share:.3f} of its limit), "
                    f"{100 * rec['bound_ms'] / s_ms:.1f}% of the bound")
        torch.cuda.empty_cache()
        lib = rec["library_ms"]
        say(f"B13 {name} [{b},{h}/{kvh},{sq}x{skv},{hd}] {dt} causal={causal} "
            f"window={window} softcap={softcap}, route {FK.route(q)}: "
            f"q, k at {qk} N(0,1): max abs err {err:.3g}, {share:.3f} of "
            f"its limit ({tol}); kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, SDPA "
            + ("none" if lib is None else f"{lib:.4f} ms")
            + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
            f"{ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound, "
            f"{ops / rec['ms'] / 1e9:.1f} TFLOP/s{simt}")
        if out is None:
            out = rec
    return out


def profile_decode(torch, res) -> None:
    """PROFILE_STEPS more decode steps from the serve run's state under
    torch.profiler: the device-busy share of the decode loop."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import greedy
    caches, tok = res.caches, res.tokens[:, -1].cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(PROFILE_STEPS):
            lg, caches = res.model.decode_step(res.params, caches, tok,
                                               res.next_pos + 1 + j)
            tok = greedy(lg, res.cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, f"decode ({PROFILE_STEPS} steps, profiled wall "
                         f"{wall:.3f} s, {1e3 * wall / PROFILE_STEPS:.3f} "
                         f"ms/step)", wall)


def check_attn_route(n: int, route: str, label: str,
                     kernel: str = "flash_attention") -> None:
    """Every one of the ``n`` launches of ``kernel`` (B13's forward or
    backward) since the last reset ran on ``route``."""
    routes = LA.route_counts(kernel)
    want = {r: (n if r == route else 0) for r in routes}
    check(routes == want, f"{label}: {kernel} routes {routes}, want {want}")


def serve_full_width(torch, VK) -> dict:
    """Phase 6b: launch/serve.py at internlm2-1.8b's full width, batch 4 x
    2,048 prompt tokens, 96 greedy decode steps, weights from the port's
    own init (--seed 0).  Returns the run's launches."""
    from repro_torch.launch import serve
    zero = dict.fromkeys(VK.KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    VK.reset_launch_count()
    t0 = time.perf_counter()
    res = serve.run(SERVE_ARGS)
    wall = time.perf_counter() - t0
    counts = VK.launch_counts()
    check_attn_route(SERVE_LAYERS, "wgmma", "serve")
    arg = lambda flag: int(SERVE_ARGS[SERVE_ARGS.index(flag) + 1])
    b, s, gen = arg("--batch"), arg("--prompt-len"), arg("--gen")
    check(res.logits_finite, "serve: non-finite logits")
    check(tuple(res.tokens.shape) == (b, gen + 1)
          and int(res.tokens.max()) < res.cfg.vocab_size
          and int(res.tokens.min()) >= 0, "serve: tokens out of range")
    check(res.launches_prefill == {**zero, "flash_attention": SERVE_LAYERS},
          f"serve: prefill launches {res.launches_prefill}")
    check(res.launches_decode == zero,
          f"serve: decode launches {res.launches_decode}")
    check(res.compactions == 1, f"serve: {res.compactions} compactions")
    check(counts == res.launches_prefill, f"serve: launches {counts}")
    step_s = (res.decode_s - res.compact_s) / gen
    say(f"serve {res.cfg.describe()}")
    say(f"serve prefill {b}x{s}: {1e3 * res.prefill_s:.3f} ms, "
        f"{b * s / res.prefill_s:.1f} tok/s; B13 launches "
        f"{res.launches_prefill['flash_attention']} (routes "
        f"{LA.route_counts('flash_attention')})")
    say(f"serve decode {gen} steps: loop {1e3 * res.decode_s:.3f} ms, "
        f"{1e3 * step_s:.3f} ms/step without compaction, "
        f"{b * gen / res.decode_s:.1f} tok/s; B13 launches "
        f"{res.launches_decode['flash_attention']}")
    say(f"serve compaction: {res.compactions} in {1e3 * res.compact_s:.3f} ms")
    say(f"serve peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" GB; serve.run wall {wall:.3f} s (weight init included)")
    profile_prefill(torch, res, b, s)
    profile_decode(torch, res)
    del res
    torch.cuda.empty_cache()
    return counts


def profile_prefill(torch, res, b: int, s: int) -> None:
    """The serve run's prefill again, warm (its first call includes the
    first use of every kernel): host-clock time, then once more under
    torch.profiler for the device-busy share and the top device items."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import make_batch_for
    tokens = make_batch_for(res.cfg, b, s, 0)["tokens"].cuda()
    go = lambda: res.model.prefill(res.params, {"tokens": tokens})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    go()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say(f"serve prefill {b}x{s} warm: {1e3 * warm:.3f} ms, "
        f"{b * s / warm:.1f} tok/s")
    report_profile(prof, f"prefill (profiled wall {wall:.3f} s)", wall)
    torch.cuda.empty_cache()


def report_profile(prof, label: str, wall: float) -> None:
    """Device-busy share of ``wall`` and the top device and host items.
    Busy time sums the device-side events only (kernels, copies, fills):
    the host-side rows of the ops that launched them carry the same time
    again as their own device time."""
    from torch.autograd import DeviceType
    t0 = time.perf_counter()
    avgs = prof.key_averages()
    say(f"profile {label}: key_averages {time.perf_counter() - t0:.3f} s")
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    device = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in device)
    if busy_us <= 0:
        say(f"profile {label}: device time not measured (profiler saw none)")
        return
    say(f"profile {label}: device busy {busy_us / 1e3:.3f} ms = "
        f"{100 * busy_us / 1e6 / wall:.2f}% of wall")
    for e in sorted(device, key=dev_us, reverse=True)[:10]:
        say(f"profile device {dev_us(e) / 1e3:10.3f} ms  x{e.count:<6d} "
            f"{e.key[:70]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:6]:
        say(f"profile host   {e.self_cpu_time_total / 1e3:10.3f} ms  "
            f"x{e.count:<6d} {e.key[:70]}")


def depth_cut(arch: str, n_layers: int = CMP_LAYERS):
    """``arch`` at full width, its first block repeated ``n_layers`` times
    (a uniform stack: the dense family, rwkv6)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import uniform_groups
    full = get_config(arch)
    return full.replace(layer_groups=uniform_groups(n_layers,
                                                    full.all_blocks[0]))


def _tree_to(node, dev):
    """A parameter tree of dicts and lists with every tensor on ``dev``."""
    if isinstance(node, dict):
        return {k: _tree_to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to(v, dev) for v in node]
    return node.to(dev)


# A (token, layer) MoE route that differs between card and CPU must be a
# near-tie: the CPU's router log-probabilities of the experts swapped
# differ by at most 2^-4, four bf16 ulps of a router logit below 4 (bf16
# rounds the logits before the softmax, and card and CPU round their
# inputs in different places)
ROUTE_TIE_GAP = 2.0 ** -4


class RouteLog:
    """Records each MoE router call (``layers.route``) of a run, in call
    order: the router's probabilities and the experts it picks.  With
    ``replay`` (another run's log of the same schedule) the run is fed
    that run's experts instead, as a run is fed another's tokens: it
    gates them with its own probabilities, renormalised as ``route``
    does, and its own picks are still recorded."""

    def __init__(self, replay=None):
        self.probs, self.calls, self.replay = [], [], replay

    def __enter__(self):
        from repro_torch.models import layers as L
        self._L, self._route = L, L.route

        def spy(p, x, cfg):
            probs, top_p, top_i = self._route(p, x, cfg)
            self.probs.append(probs.cpu())
            self.calls.append(top_i.cpu())
            if self.replay is not None:
                top_i = self.replay.calls[len(self.calls) - 1].to(
                    top_i.device)
                top_p = probs.gather(-1, top_i)
                top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
            return probs, top_p, top_i
        L.route = spy
        return self

    def __exit__(self, *exc):
        self._L.route = self._route


def routes_differing(ref: "RouteLog", run: "RouteLog") -> tuple:
    """(routes whose expert sets differ between the two runs, routes
    compared, the largest log-probability gap under ``run``'s router
    between an expert only ``run`` picked and one only ``ref`` picked)."""
    import torch
    diff = total = 0
    gap = 0.0
    for a, b, probs in zip(ref.calls, run.calls, run.probs):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        logp = probs.reshape(-1, probs.shape[-1]).clamp(min=1e-30).log()
        rows = (a.sort(-1).values != b.sort(-1).values).any(-1)
        diff += int(rows.sum())
        total += a.shape[0]
        for r in torch.nonzero(rows).flatten().tolist():
            only_run = [e for e in b[r].tolist() if e not in a[r].tolist()]
            only_ref = [e for e in a[r].tolist() if e not in b[r].tolist()]
            gap = max(gap, float(logp[r, only_run].min()
                                 - logp[r, only_ref].max()))
    return diff, total, gap


def serve_card_vs_cpu(torch, VK, cut, launches: dict,
                      attn_routes=None, prompt: int = CMP_PROMPT,
                      steps: int = CMP_STEPS) -> None:
    """Phases 6c, 7c, 8c, 14d and 17a: the depth-cut config ``cut`` (full
    width) at batch 2 x ``prompt`` tokens (256; with ``make_batch_for``'s
    frame or patch embeddings), then ``steps`` decode steps (72: across
    step 64, where attention caches are compacted, but an
    encoder-decoder's, as in launch/serve.py), on the card and on the CPU
    from one set of weights (drawn once, in f32), in f32 and in the
    shipped bf16 compute.  The f32 card run decodes greedily; the other
    three runs are fed its tokens, so every run sees one schedule, and an
    MoE's CPU run is fed the card's expert routes (RouteLog): a route
    that differs is a discrete choice at a near-tie, which would move
    that token's output by a whole expert's.  Prefill and every step's
    logits compared card vs CPU; every route that differs must be a
    near-tie (ROUTE_TIE_GAP); the card's prefill launches ``launches``,
    the CPU run nothing.  Also reported: each bf16 run's distance from
    the CPU's f32 logits.  ``attn_routes``: dtype -> the B13 route every
    card launch of that dtype takes."""
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import compact_all, greedy
    from repro_torch.models.layers import RECENT_RING
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    master = build_model(cut).init(0, device="cpu")     # parameter dtype
    inputs = make_batch_for(cut, CMP_BATCH, prompt, 0)
    t_init = time.perf_counter() - t0
    prefix = cut.vision.n_patches if cut.vision is not None else 0
    fed, f32_cpu = [], None
    for dt in ("float32", "bfloat16"):
        cfg = cut.replace(compute_dtype=dt)
        model = build_model(cfg)
        p_cpu = model.compute_params(master)
        p_gpu = _tree_to(p_cpu, torch.device("cuda"))
        runs = {}
        for run, dev, params in (("card", "cuda", p_gpu),
                                 ("cpu", "cpu", p_cpu)):
            VK.reset_launch_count()
            t0 = time.perf_counter()
            replay = runs["card"][3] if run == "cpu" else None
            with RouteLog(replay) as routes:
                lg, caches = model.prefill(
                    params, {k: v.to(dev) for k, v in inputs.items()})
                logits = [lg.float().cpu()]
                for i in range(steps):
                    if len(fed) == i:       # the f32 card run's greedy
                        fed.append(greedy(lg, cfg).cpu())
                    pos = prompt + prefix + i       # as launch/serve.py
                    lg, caches = model.decode_step(
                        params, caches, fed[i].to(dev), pos)
                    logits.append(lg.float().cpu())
                    if (i + 1) % RECENT_RING == 0 and not cut.is_enc_dec:
                        caches = compact_all(caches, pos)
            runs[run] = (logits, VK.launch_counts(),
                         time.perf_counter() - t0, routes)
            if run == "card" and attn_routes:
                check_attn_route(launches["flash_attention"], attn_routes[dt],
                                 f"card vs cpu {dt}")
        g_logits, g_counts, g_wall, g_routes = runs["card"]
        c_logits, c_counts, c_wall, c_routes = runs["cpu"]
        check(g_counts == {**dict.fromkeys(VK.KERNELS, 0), **launches},
              f"card vs cpu {dt}: card launches {g_counts}")
        check(sum(c_counts.values()) == 0,
              f"card vs cpu {dt}: the CPU run launched {c_counts}")
        v = cfg.vocab_size
        dist = lambda xs, ys: [float((a[:, :v] - b[:, :v]).abs().max())
                               for a, b in zip(xs, ys)]
        errs = dist(g_logits, c_logits)
        scale = max(float(a[:, :v].abs().max()) for a in g_logits)
        agree = sum(bool(torch.equal(a[:, :v].argmax(-1), b[:, :v].argmax(-1)))
                    for a, b in zip(g_logits, c_logits))
        finite = all(bool(torch.isfinite(a).all()) for a in g_logits)
        worst = max(range(steps), key=lambda i: errs[1 + i])
        say(f"card vs cpu {cut.arch} {dt} ({cut.n_layers} layers "
            f"{''.join(b.short() for b in cut.all_blocks)}, "
            f"{CMP_BATCH}x{prompt} + {steps} steps): logits max abs "
            f"err prefill {errs[0]:.4g}, decode {max(errs[1:]):.4g} (step "
            f"{worst}), mean over steps {sum(errs) / len(errs):.4g}; "
            f"logit scale {scale:.3f}; argmax equal in {agree}/{len(errs)} "
            f"steps; wall card {g_wall:.2f} s, cpu {c_wall:.2f} s, init "
            f"{t_init:.2f} s; tol {CMP_TOL[dt]}")
        if g_routes.calls:
            diff, total, gap = routes_differing(g_routes, c_routes)
            say(f"card vs cpu {cut.arch} {dt}: {diff} of {total} (token, "
                f"layer) MoE routes differ (the CPU fed the card's); "
                f"largest log-probability gap of a differing route {gap:.4g}"
                f" (near-tie bound {ROUTE_TIE_GAP})")
            check(gap <= ROUTE_TIE_GAP,
                  f"card vs cpu {dt}: an MoE route differs by a "
                  f"log-probability gap of {gap} > {ROUTE_TIE_GAP}")
        if dt == "float32":
            f32_cpu = c_logits
        else:
            for run, xs in (("card", g_logits), ("cpu", c_logits)):
                e = dist(xs, f32_cpu)
                say(f"card vs cpu {cut.arch}: {run} bf16 vs cpu f32 logits "
                    f"max abs err {max(e):.4g}, mean over steps "
                    f"{sum(e) / len(e):.4g}")
        check(finite, f"card vs cpu {dt}: non-finite card logits")
        check(max(errs) <= CMP_TOL[dt],
              f"card vs cpu {dt}: logits differ by {max(errs)} > "
              f"{CMP_TOL[dt]}")
        del p_gpu, p_cpu, runs
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: serve rwkv6
# ---------------------------------------------------------------------------

WKV_TOL = 2e-5                   # the reference's test_wkv6 tolerance
# B14 at the serving path's prefill shape and the others:
# (b, h, T, hd, [b, T, h, hd] strided views, w as drawn): w as test_wkv6
# draws it, in (0.35, 0.95); or 30% of it exact zeros (a decay that
# underflows, as exp(-exp(ww)) does past ww ~4.5) or denormals (1e-40)
WKV_SHAPES = {
    "a rwkv6 prefill": (4, 32, 2048, 64, False, "test"),
    "b reduced hd16 ragged": (2, 4, 37, 16, False, "test"),
    "c T=1": (4, 32, 1, 64, False, "test"),
    "d strided views": (4, 32, 2048, 64, True, "test"),
    "e w zeros": (2, 8, 300, 64, False, "zero"),
    "f w denormal": (2, 8, 300, 64, False, "denormal"),
    "g w zeros hd16": (2, 4, 37, 16, False, "zero"),
}
RWKV_ARGS = ["--arch", "rwkv6-1.6b", "--batch", "4", "--prompt-len",
             "2048", "--gen", "96"]
RWKV_LAYERS = 24                 # rwkv6-1.6b: one B14 launch a layer
RWKV_PARAMS = 1_599_819_776      # the published config's parameter count


def wkv6_parity(torch, WK, R) -> dict:
    """B14 against its plain version at WKV_SHAPES (out and the final
    state, both finite); kernel, plain and bound ms and the share of the
    bound at each.  Returns the record of shape (a)."""
    dev = torch.device("cuda")
    out = None
    for name, (b, h, T, hd, strided, decay) in WKV_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(T + hd)
        shape = (b, T, h, hd) if strided else (b, h, T, hd)
        rnd = lambda: torch.randn(*shape, generator=g, device=dev)
        args = [rnd() * 0.4, rnd() * 0.4, rnd(),
                torch.sigmoid(rnd()) * 0.6 + 0.35]      # w in (0.35, 0.95)
        if decay != "test":
            hit = torch.rand(*shape, generator=g, device=dev) < 0.3
            args[3] = torch.where(hit, torch.tensor(
                0.0 if decay == "zero" else 1e-40, device=dev), args[3])
        if strided:
            args = [t.transpose(1, 2) for t in args]
        args.append(torch.randn(h, hd, generator=g, device=dev) * 0.2)
        (o, S), (o_p, S_p) = WK.wkv6(*args), R.wkv6(*args)
        torch.cuda.synchronize()
        err = max(float((o - o_p).abs().max()), float((S - S_p).abs().max()))
        check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(S).all()),
              f"B14 {name}: non-finite out or state")
        check(torch.allclose(o, o_p, rtol=WKV_TOL, atol=WKV_TOL)
              and torch.allclose(S, S_p, rtol=WKV_TOL, atol=WKV_TOL),
              f"B14 {name}: kernel vs plain max abs err {err} (tol "
              f"{WKV_TOL})")
        del o, S, o_p, S_p
        n = b * h * T * hd
        nbytes = 4 * (5 * n + b * h * hd * hd + h * hd)
        ops = 2 * 3 * n * hd                # 3 FMAs per (i, j) and step
        bound, by = bound_ms(nbytes, ops)
        rec = {"max_abs_err": err, "bound_ms": bound, "bound_by": by,
               "ms": KB.cuda_ms(lambda: WK.wkv6(*args), 10),
               "plain_ms": KB.cuda_ms(lambda: R.wkv6(*args), 1),
               "library_ms": None}      # no PyTorch call computes WKV6
        say(f"B14 {name} [{b},{h},{T},{hd}]{' strided' if strided else ''}"
            f" f32: max abs err {err:.3g} (tol {WKV_TOL}); kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"none, bound {bound:.4f} ms ({by}: {ops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB), {100 * bound / rec['ms']:.1f}% of it")
        if out is None:
            out = rec
        del args
    torch.cuda.empty_cache()
    return out


def serve_rwkv_full_width(torch, VK) -> dict:
    """Phase 7b: launch/serve.py at rwkv6-1.6b's full width and depth,
    batch 4 x 2,048 prompt tokens, 96 greedy decode steps against the
    recurrent state, weights from the port's own init (--seed 0).
    Returns the run's launches."""
    from repro_torch.launch import serve
    from repro_torch.models.rwkv import RWKVState
    from repro_torch.kernels import rwkv6_scan as WK
    zero = dict.fromkeys(VK.KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    VK.reset_launch_count()
    real, stores = WK.wkv6, []

    def spy(*a, states=None):           # serving writes no chunk states
        stores.append(states is not None)
        return real(*a, states=states)
    WK.wkv6 = spy
    t0 = time.perf_counter()
    try:
        res = serve.run(RWKV_ARGS)
    finally:
        WK.wkv6 = real
    wall = time.perf_counter() - t0
    check(len(stores) == RWKV_LAYERS and not any(stores),
          f"rwkv serve: chunk states written by {sum(stores)} of "
          f"{len(stores)} B14 launches")
    counts = VK.launch_counts()
    arg = lambda flag: int(RWKV_ARGS[RWKV_ARGS.index(flag) + 1])
    b, s, gen = arg("--batch"), arg("--prompt-len"), arg("--gen")
    n_params = sum(t.numel() for t in _leaves(res.params))
    check(n_params == RWKV_PARAMS, f"rwkv serve: {n_params} parameters")
    check(res.logits_finite, "rwkv serve: non-finite logits")
    check(tuple(res.tokens.shape) == (b, gen + 1)
          and int(res.tokens.max()) < res.cfg.vocab_size
          and int(res.tokens.min()) >= 0, "rwkv serve: tokens out of range")
    check(res.launches_prefill == {**zero, "wkv6": RWKV_LAYERS},
          f"rwkv serve: prefill launches {res.launches_prefill}")
    check(res.launches_decode == zero,
          f"rwkv serve: decode launches {res.launches_decode}")
    check(res.compactions == 0, f"rwkv serve: {res.compactions} compactions")
    check(len(res.caches) == RWKV_LAYERS
          and all(isinstance(c, RWKVState) for c in res.caches),
          "rwkv serve: decode states are not one RWKVState a layer")
    check(counts == res.launches_prefill, f"rwkv serve: launches {counts}")
    step_s = res.decode_s / gen
    say(f"rwkv serve {res.cfg.describe()}, {n_params:,} parameters")
    say(f"rwkv serve prefill {b}x{s}: {1e3 * res.prefill_s:.3f} ms, "
        f"{b * s / res.prefill_s:.1f} tok/s; B14 launches "
        f"{res.launches_prefill['wkv6']}")
    say(f"rwkv serve decode {gen} steps: loop {1e3 * res.decode_s:.3f} ms, "
        f"{1e3 * step_s:.3f} ms/step, {b * gen / res.decode_s:.1f} tok/s; "
        f"B14 launches {res.launches_decode['wkv6']}")
    say(f"rwkv serve peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; serve.run wall "
        f"{wall:.3f} s (weight init included)")
    profile_prefill(torch, res, b, s)
    profile_decode(torch, res)
    del res
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 8: serve jamba
# ---------------------------------------------------------------------------

# kernel vs plain: y 2e-5 in f32 (the reference's test_mamba_scan
# tolerance), 2e-2 in bf16 storage (one rounding of y to bf16, as B13);
# the f32 final state h_T 2e-5
SCAN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# B15 at the serving path's prefill shape and the others:
# (b, T, di, ds, u / y dtype, B / C as column views of an x_proj output)
SCAN_SHAPES = {
    "a jamba prefill": (4, 2048, 8192, 16, "bfloat16", False),
    "b reduced ragged": (2, 37, 128, 4, "float32", False),
    "c T=1": (4, 1, 8192, 16, "bfloat16", False),
    "d strided views": (4, 2048, 8192, 16, "bfloat16", True),
}
SFU_PER_CLOCK = 16               # exp results a clock per SM (sm_90)
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN = 4, 2048, 96
# one layer group (8 layers) at full width: what tests/test_torch_jamba.py
# holds jamba_config() to; 8b serves blocks 2 and 4 of it (cut from the
# whole group to blocks 2-5, then 2-4, then in PR 32 to 2 and 4, to hold
# the script's time: the CPU draws every weight, 31 s for blocks 2-4, whose
# MoE layer is 2.9B of the 4.0B; the MoE is served at full width in 8c
# and 14d)
JAMBA_PARAMS = 13_295_235_072
JAMBA_SERVE_BLOCKS = (2, 4)      # Md Ad
JAMBA_SERVE_PARAMS = 1_036_464_128
JAMBA_SCANS, JAMBA_ATTNS = 1, 1  # B15 / B13 launches per 8b prefill
JAMBA_CMP_BLOCKS = (3, 4)        # mamba + MoE, then attention + dense
# 8c's decode steps (72 until PR 32: the CPU's MoE decode gathers whole
# 14,336-wide experts, 66 s in f32 and 38 s in bf16 of 8c's 131 s; the
# compaction at step 64 stays held card vs CPU in 6c, 7c and 14d)
JAMBA_CMP_STEPS = 8


def jamba_config(blocks=None):
    """jamba-v0.1-52b at its full published width cut to one layer group:
    the published 8-layer period (attention at index 4, MoE on the odd
    layers), or the period's ``blocks``."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import LayerGroup
    full = get_config("jamba-v0.1-52b")
    period = full.layer_groups[0].blocks
    picked = period if blocks is None else tuple(period[i] for i in blocks)
    return full.replace(layer_groups=(LayerGroup(picked, 1),))


def sfu_exps_per_s(torch) -> float:
    """The card's exp rate: SFU_PER_CLOCK a clock per SM at the SM clock's
    maximum (nvidia-smi)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"SFU exp rate: {SFU_PER_CLOCK} a clock x {sms} SMs x {mhz:.0f} MHz"
        f" = {SFU_PER_CLOCK * sms * mhz * 1e6:.4g} /s")
    return SFU_PER_CLOCK * sms * mhz * 1e6


def mamba_scan_parity(torch, MK, R) -> dict:
    """B15 against its plain version at SCAN_SHAPES (y and the final
    state); kernel, plain and bound ms at each.  Returns the record of
    shape (a)."""
    dev = torch.device("cuda")
    exp_rate = sfu_exps_per_s(torch)
    out = None
    for name, (b, T, di, ds, dt, strided) in SCAN_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(T + di + ds)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
        dtype = getattr(torch, dt)
        u = (rnd(b, T, di) * 0.4).to(dtype)
        dts = torch.nn.functional.softplus(rnd(b, T, di))
        if strided:                     # [dt_r | B | C] as x_proj writes it
            xdbc = rnd(b, T, 256 + 2 * ds) * 0.4
            B, C = xdbc[..., 256:256 + ds], xdbc[..., 256 + ds:]
        else:
            B, C = rnd(b, T, ds) * 0.4, rnd(b, T, ds) * 0.4
        A = -torch.exp(rnd(di, ds) * 0.3)
        D = torch.ones(di, device=dev)
        args = (u, dts, B, C, A, D)
        (y, h), (y_p, h_p) = MK.mamba_scan(*args), R.mamba_scan(*args)
        torch.cuda.synchronize()
        err = max(float((y.float() - y_p.float()).abs().max()),
                  float((h - h_p).abs().max()))
        tol = SCAN_TOL[dt]
        check(torch.allclose(y.float(), y_p.float(), rtol=tol, atol=tol)
              and torch.allclose(h, h_p, rtol=2e-5, atol=2e-5),
              f"B15 {name}: kernel vs plain max abs err {err} (tol {tol}, "
              f"h_T 2e-5)")
        del y, h, y_p, h_p
        n, esize = b * T * di, u.element_size()
        nbytes = (2 * esize * n + 4 * n + 4 * 2 * b * T * ds
                  + 4 * (b * di * ds + di * ds + di))
        t_mem = nbytes / KB.HBM_BYTES_PER_S
        t_exp = n * ds / exp_rate       # one exp per state per step
        t_fma = 5 * n * ds / F32_OPS_PER_S
        bound = 1e3 * max(t_mem, t_exp, t_fma)
        rec = {"max_abs_err": err, "bound_ms": bound,
               "bound_by": "bytes" if t_mem >= max(t_exp, t_fma)
               else "operations",
               "ms": KB.cuda_ms(lambda: MK.mamba_scan(*args), 10),
               "plain_ms": KB.cuda_ms(lambda: R.mamba_scan(*args), 1),
               "library_ms": None}      # no PyTorch call computes the scan
        say(f"B15 {name} [{b},{T},{di}] ds {ds} u {dt}"
            f"{' strided B/C' if strided else ''}: max abs err {err:.3g} "
            f"(tol {tol}); kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, library none, bound {bound:.4f} ms "
            f"({rec['bound_by']}: {nbytes / 1e6:.1f} MB {1e3 * t_mem:.4f} "
            f"ms, {n * ds / 1e9:.3f} G exps {1e3 * t_exp:.4f} ms, "
            f"{5 * n * ds / 1e9:.2f} GFLOP {1e3 * t_fma:.4f} ms)")
        if out is None:
            out = rec
        del args, u, dts, B, C
    torch.cuda.empty_cache()
    return out


def serve_jamba_full_width(torch, VK) -> dict:
    """Phase 8b: launch/serve.py's ``serve`` at jamba-v0.1's full width,
    blocks JAMBA_SERVE_BLOCKS of its layer group (JAMBA_SERVE_PARAMS
    parameters, weights from the port's own init, seed 0), batch 4 x
    2,048 prompt tokens, 96 greedy decode steps
    (one compaction of the attention layer's cache; the mamba states pass
    through).  Returns the run's launches."""
    from repro_torch.launch import serve
    from repro_torch.models.layers import DecodeCache
    from repro_torch.models.mamba import MambaState
    cfg = jamba_config(JAMBA_SERVE_BLOCKS)
    b, s, gen = JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN
    from repro_torch.kernels import mamba_scan as MK
    zero = dict.fromkeys(VK.KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    VK.reset_launch_count()
    real, stores = MK.mamba_scan, []

    def spy(*a, h_ck=None):             # serving writes no chunk states
        stores.append(h_ck is not None)
        return real(*a, h_ck=h_ck)
    MK.mamba_scan = spy
    t0 = time.perf_counter()
    try:
        res = serve.serve(cfg, b, s, gen, seed=0, device="cuda")
    finally:
        MK.mamba_scan = real
    wall = time.perf_counter() - t0
    counts = VK.launch_counts()
    check(len(stores) == JAMBA_SCANS and not any(stores),
          f"jamba serve: chunk states written by {sum(stores)} of "
          f"{len(stores)} B15 launches")
    check_attn_route(JAMBA_ATTNS, "wgmma", "jamba serve")
    n_params = sum(t.numel() for t in _leaves(res.params))
    check(n_params == JAMBA_SERVE_PARAMS,
          f"jamba serve: {n_params} parameters")
    check(res.logits_finite, "jamba serve: non-finite logits")
    check(tuple(res.tokens.shape) == (b, gen + 1)
          and int(res.tokens.max()) < cfg.vocab_size
          and int(res.tokens.min()) >= 0, "jamba serve: tokens out of range")
    check(res.launches_prefill == {**zero, "mamba_scan": JAMBA_SCANS,
                                   "flash_attention": JAMBA_ATTNS},
          f"jamba serve: prefill launches {res.launches_prefill}")
    check(res.launches_decode == zero,
          f"jamba serve: decode launches {res.launches_decode}")
    check(res.compactions == 1, f"jamba serve: {res.compactions} compactions")
    want = [DecodeCache if spec.mixer == "attn" else MambaState
            for spec in cfg.all_blocks]
    check([type(c) for c in res.caches] == want,
          "jamba serve: decode states are not one MambaState a mamba layer "
          "and one DecodeCache an attention layer")
    check(counts == res.launches_prefill, f"jamba serve: launches {counts}")
    step_s = (res.decode_s - res.compact_s) / gen
    say(f"jamba serve {cfg.describe()}, {n_params:,} parameters")
    say(f"jamba serve init {res.init_s:.3f} s (drawn on the CPU, cast to "
        f"bf16 as each layer is placed)")
    say(f"jamba serve prefill {b}x{s}: {1e3 * res.prefill_s:.3f} ms, "
        f"{b * s / res.prefill_s:.1f} tok/s; B15 launches "
        f"{res.launches_prefill['mamba_scan']}, B13 launches "
        f"{res.launches_prefill['flash_attention']} (routes "
        f"{LA.route_counts('flash_attention')})")
    say(f"jamba serve decode {gen} steps: loop {1e3 * res.decode_s:.3f} ms, "
        f"{1e3 * step_s:.3f} ms/step without compaction, "
        f"{b * gen / res.decode_s:.1f} tok/s; B15 launches "
        f"{res.launches_decode['mamba_scan']}, B13 launches "
        f"{res.launches_decode['flash_attention']}")
    say(f"jamba serve compaction: {res.compactions} in "
        f"{1e3 * res.compact_s:.3f} ms")
    say(f"jamba serve peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; serve wall "
        f"{wall:.3f} s (weight init included)")
    profile_prefill(torch, res, b, s)
    profile_decode(torch, res)
    del res
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 9: the pod runtime's compressed cross-pod round
# ---------------------------------------------------------------------------

# benchmarks/kernel_bench.py:309-310, :370-376: the bench model's bus
BENCH_N, BENCH_LOGICAL = 2_105_344, 2_101_504
BENCH_SIZES = [(256, 256), (1024, 64), (64,), (512, 512), (128, 1024),
               (1024,)]
POD_ISLANDS, POD_ALPHA, POD_DENSITY, POD_ROUNDS = 4, 0.9, 0.05, 3
POD_DEAD = {1: 2}                        # round -> dead island
# launches of one compressed round of 4 islands on a bus that holds the
# bracket: per island B6 + B7 (selection), B9 + B10 (quantize and the
# error feedback's dequantize), B12 (the frame), B10 (decompress)
POD_LAUNCHES = {"blocked_topk_stats": 4, "threshold_sparsify_exact": 4,
                "quantize_int8": 4, "dequantize_int8": 8, "pack_body": 4}
# B6 / B7 parity: name -> (n, tie-heavy); timed at the bench bus and 2^27
TOPK_SHAPES = {"bench": (BENCH_N, False), "2^20": (1 << 20, False),
               "ragged": ((1 << 20) + 4128, False),
               "ties": (1 << 20, True), "2^27": (BIG_N, False)}
SELECT_SIZES = (1 << 20, BENCH_N, 5 << 20, 1 << 24)
_NORM, _CRC = slice(36, 40), slice(64, 68)     # res_norm and crc (v2 header)


def np_bus(np, n: int, seed: int, ties: bool = False):
    """N(0, 0.02^2) f32 from a numpy seed; ``ties``: N(0, 1) rounded to
    quarters (thousands of elements share each magnitude)."""
    x = np.random.default_rng(seed).standard_normal(n)
    return (np.round(4 * x) / 4 if ties else 0.02 * x).astype(np.float32)


def bench_model(np, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {f"layer{rep}/p{i}": rng.standard_normal(shp).astype(np.float32)
            for rep in range(4) for i, shp in enumerate(BENCH_SIZES)}


def topk_parity(torch, np, TK, C, R) -> dict:
    """Phase 9a: B6 and B7 against their plain versions on the card, bit
    for bit, at each TOPK_SHAPES bus: B6 with the bus's own bracket at
    density 0.05, as the path's device int32 [1] and as a number, B7
    with the refinement of B6's words.  Returns the numbers of both at
    the bench bus, the path's shape, with B6's host us a call there."""
    from repro_torch.benchmarks import wrapper_cost as WC
    out = {}
    for seed, (name, (n, ties)) in enumerate(TOPK_SHAPES.items()):
        x = torch.from_numpy(np_bus(np, n, 90 + seed, ties)).cuda()
        k = int(n * POD_DENSITY)
        nb = -(-n // TK.BLOCK)
        lo = C.bracket(x, k)
        lo_int = int(lo)
        words, counts = TK.blocked_topk_stats(x, lo)
        iw, ic = TK.blocked_topk_stats(x, lo_int)
        pw, pc = R.blocked_topk_stats(x, lo)
        torch.cuda.synchronize()
        check(torch.equal(words, pw) and torch.equal(counts, pc),
              f"B6 {name} n={n}: kernel != plain version")
        check(torch.equal(iw, pw) and torch.equal(ic, pc),
              f"B6 {name} n={n}, lo a number: kernel != plain version")
        c_lo = int(counts.sum())
        idx, tau, tie_start, budget = C.refine(x, words, c_lo, k)
        tau_f, budget_i = float(tau), int(budget)
        kept, res = TK.threshold_sparsify_exact(x, tau, tie_start, budget)
        nk, nr = TK.threshold_sparsify_exact(x, tau_f, tie_start, budget_i)
        pk, pr = R.threshold_sparsify_exact(x, tau, tie_start, budget)
        torch.cuda.synchronize()
        check(bits_equal(torch, kept, pk) and bits_equal(torch, res, pr),
              f"B7 {name} n={n}: kernel != plain version")
        check(bits_equal(torch, nk, pk) and bits_equal(torch, nr, pr),
              f"B7 {name} n={n}, tau and budget numbers: kernel != plain "
              f"version")
        check(int((kept != 0).sum()) == k
              and torch.equal(torch.nonzero(kept).flatten().int(), idx),
              f"B7 {name}: the kept set is not the refinement's {k}")
        ties_at = int((x.abs() == tau).sum())
        say(f"parity B6/B7 {name} n={n}: bit-exact (B6's lo, B7's tau and "
            f"budget tensors and numbers); c_lo {c_lo}, k {k}, ties at tau "
            f"{ties_at} of which kept {budget_i}")
        if name not in ("bench", "2^27"):
            continue
        iters = 50 if name == "bench" else 10
        recs = {
            "blocked_topk_stats": {
                "max_abs_err": float((words.long() - pw.long()).abs().max()),
                "library_ms": None,
                "ms": KB.cuda_ms(lambda: TK.blocked_topk_stats(x, lo),
                                 iters),
                "int_lo_ms": KB.cuda_ms(
                    lambda: TK.blocked_topk_stats(x, lo_int), iters),
                "plain_ms": KB.cuda_ms(lambda: R.blocked_topk_stats(x, lo),
                                       iters)},
            "threshold_sparsify_exact": {
                "max_abs_err": max(float((kept - pk).abs().max()),
                                   float((res - pr).abs().max())),
                "library_ms": None,
                "ms": KB.cuda_ms(lambda: TK.threshold_sparsify_exact(
                    x, tau, tie_start, budget), iters),
                "plain_ms": KB.cuda_ms(lambda: R.threshold_sparsify_exact(
                    x, tau, tie_start, budget), iters)}}
        # bytes: each input read once, each output written once; ops: a
        # magnitude compare (B6), |x|, two compares and a subtract (B7)
        recs["blocked_topk_stats"]["bound_ms"], \
            recs["blocked_topk_stats"]["bound_by"] = bound_ms(
                4 * n + n / 8 + 4 * nb, n)
        recs["threshold_sparsify_exact"]["bound_ms"], \
            recs["threshold_sparsify_exact"]["bound_by"] = bound_ms(
                12 * n + 4 * nb, 4 * n)
        b6, b7 = recs["blocked_topk_stats"], recs["threshold_sparsify_exact"]
        b6["device_us"] = WC.graph_us(
            torch, lambda: TK.blocked_topk_stats(x, lo))
        b7["device_us"] = WC.graph_us(
            torch, lambda: TK.threshold_sparsify_exact(x, tau, tie_start,
                                                       budget))
        say(f"timing blocked_topk_stats N={n}: kernel, lo a number "
            f"{b6['int_lo_ms']:.6f} ms")
        for kname, r in recs.items():
            say(f"timing {kname} N={n}: device {r['device_us']:.3f} us a "
                f"call (100 calls in a CUDA graph, the path's device "
                f"tensors), {100e3 * r['bound_ms'] / r['device_us']:.1f}% "
                f"of the bound")
        if name == "bench":
            us = WC.host_us(torch, {
                "B6 tensor": lambda: TK.blocked_topk_stats(x, lo),
                "B6 number": lambda: TK.blocked_topk_stats(x, lo_int),
                "B7 tensors": lambda: TK.threshold_sparsify_exact(
                    x, tau, tie_start, budget),
                "B7 numbers": lambda: TK.threshold_sparsify_exact(
                    x, tau_f, tie_start, budget_i)})
            b6["host_us"], b7["host_us"] = us["B6 tensor"], us["B7 tensors"]
            b6["library_host_us"] = b7["library_host_us"] = None
            say(f"host cost B6 blocked_topk_stats N={n}: "
                f"{us['B6 tensor']:.2f} us a call with lo the bracket's "
                f"tensor, {us['B6 number']:.2f} with lo a number (in turns, "
                f"median of 9 rounds)")
            say(f"host cost B7 threshold_sparsify_exact N={n}: "
                f"{us['B7 tensors']:.2f} us a call with tau and the budget "
                f"the refinement's tensors, {us['B7 numbers']:.2f} with "
                f"numbers (in turns, median of 9 rounds)")
        for kname, r in recs.items():
            say(f"timing {kname} N={n}: kernel {r['ms']:.6f} ms")
            say(f"timing {kname} N={n}: plain {r['plain_ms']:.6f} ms")
            say(f"timing {kname} N={n}: library none (no PyTorch call "
                f"computes it)")
            say(f"timing {kname} N={n}: bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% "
                f"of it")
        if name == "bench":
            out = recs
        del x, words, counts, iw, ic, pw, pc, kept, res, nk, nr, pk, pr, idx
        torch.cuda.empty_cache()
    return out


def host_ms(torch, fn, iters: int) -> float:
    """Mean host-clock time of ``fn()`` ending in a synchronize, after a
    warm-up: for work that waits on the host itself."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def select_card_vs_cpu(torch, np, C, VK) -> None:
    """Phase 9b: select_topk and compress_flat on the card against the
    CPU at each SELECT_SIZES bus and density 0.05 / 0.01."""
    zero = dict.fromkeys(VK.KERNELS, 0)
    for seed, n in enumerate(SELECT_SIZES):
        for density in (0.05, 0.01):
            xc = torch.from_numpy(np_bus(np, n, 70 + seed))
            xg = xc.cuda()
            k = int(n * density)
            lo = C.bracket(xc, k)
            c_lo = int((C.magnitude_bits(xc) >= lo).sum())
            holds = k <= c_lo <= k + C.MARGIN and int(lo) > 0
            VK.reset_launch_count()
            ig = C.select_topk(xg, k)
            torch.cuda.synchronize()
            sel = VK.launch_counts()
            check(torch.equal(ig.cpu(), C.select_topk(xc, k)),
                  f"select_topk n={n} d={density}: card != cpu")
            check(sel == {**zero, "blocked_topk_stats": 1},
                  f"select_topk n={n} d={density}: launches {sel}")
            VK.reset_launch_count()
            pg, rg = C.compress_flat(xg, density=density)
            torch.cuda.synchronize()
            cmp = VK.launch_counts()
            pc, rc = C.compress_flat(xc, density=density)
            for f in ("indices", "values", "scales"):
                check(torch.equal(getattr(pg, f).cpu(), getattr(pc, f)),
                      f"compress_flat n={n} d={density}: {f} card != cpu")
            check(bits_equal(torch, rg.cpu(), rc),
                  f"compress_flat n={n} d={density}: residual card != cpu")
            want = {**zero, "blocked_topk_stats": 1, "quantize_int8": 1,
                    "dequantize_int8": 1,
                    "threshold_sparsify_exact": 1 if holds else 0}
            check(cmp == want, f"compress_flat n={n} d={density}: launches "
                  f"{cmp} != {want}")
            say(f"select/compress n={n} d={density} k={k}: bracket "
                f"{'holds' if holds else 'misses (sort)'}; card == cpu "
                f"(indices, q, scales, residual); launches select "
                f"B6={sel['blocked_topk_stats']}, compress B6="
                f"{cmp['blocked_topk_stats']} B7="
                f"{cmp['threshold_sparsify_exact']}")
            if n == BENCH_N and density == POD_DENSITY:
                a = xg.abs()
                say(f"timing select_topk N={n} k={k} (host clock, one sync "
                    f"a call): {host_ms(torch, lambda: C.select_topk(xg, k), 20):.6f} ms")
                say(f"timing compress_flat N={n} k={k} (host clock): "
                    f"{host_ms(torch, lambda: C.compress_flat(xg, density=density), 20):.6f} ms")
                check(torch.equal(C.sort_topk(xg, k), ig),
                      f"sort_topk n={n}: != the blocked selection")
                say(f"timing sort_topk N={n} k={k} (the stable sort, same "
                    f"indices, host clock): "
                    f"{host_ms(torch, lambda: C.sort_topk(xg, k), 20):.6f} ms")
                say(f"timing torch.topk(|flat|, k) N={n} k={k} (yardstick, "
                    f"host clock): {host_ms(torch, lambda: torch.topk(a, k), 20):.6f} ms")
            del xc, xg, ig, pg, rg, pc, rc
        torch.cuda.empty_cache()


def recording_transport():
    """A LoopbackTransport that keeps every frame it carries in ``sent``."""
    from repro_torch.transfer.transport import LoopbackTransport

    class Recording(LoopbackTransport):
        def send(self, frame):
            self.sent.append(bytes(frame))
            return super().send(frame)

    t = Recording()
    t.sent = []
    return t


def frames_match(np, card: list, cpu: list, label: str) -> None:
    """Frames byte for byte outside the residual-norm field and the crc;
    the norms within 2 f32 ulps (XLA-free f64 sums on both sides, in
    different orders)."""
    check(len(card) == len(cpu) > 0, f"{label}: {len(card)} vs {len(cpu)} "
          f"frames")
    worst = 0
    for a, b in zip(card, cpu):
        ma, mb = bytearray(a), bytearray(b)
        for m in (ma, mb):
            if m[6] == 1:                     # sparse frame
                m[_NORM] = bytes(4)
                m[_CRC] = bytes(4)
        check(ma == mb, f"{label}: frames differ outside the norm and crc")
        if a[6] == 1:
            na, nb_ = (np.frombuffer(f[_NORM], np.int32)[0] for f in (a, b))
            worst = max(worst, abs(int(na) - int(nb_)))
    check(worst <= 2, f"{label}: residual norms {worst} ulps apart")
    say(f"{label}: {len(card)} frames byte-identical outside the norm and "
        f"crc; norms at most {worst} ulp apart")


def pod_round_card_vs_cpu(torch, np, VK) -> dict:
    """Phase 9c: compressed_assimilate on the bench model, card against
    CPU, POD_ROUNDS rounds with the residuals carried.  Returns the card
    rounds' launches."""
    from repro_torch.core import compression as C
    from repro_torch.runtime import vc_runtime as VR
    from repro_torch.transfer import wire
    zero = dict.fromkeys(VK.KERNELS, 0)
    server = bench_model(np, 0)
    rounds, walls, totals = [], [], dict(zero)
    t_card = recording_transport()

    def islands(cur: dict, rnd: int) -> dict:
        """POD_ISLANDS islands = server + 0.01 N(0, 1), island-major."""
        rng = np.random.default_rng(100 + rnd)
        return {k: np.stack([v + np.float32(0.01) * rng.standard_normal(
            v.shape).astype(np.float32) for _ in range(POD_ISLANDS)])
            for k, v in cur.items()}

    def card_rounds():
        srv, res = {k: torch.from_numpy(v).cuda() for k, v in server.items()}, None
        cur = server
        for rnd in range(POD_ROUNDS):
            isl = islands(cur, rnd)
            alive = np.ones(POD_ISLANDS, bool)
            if rnd in POD_DEAD:
                alive[POD_DEAD[rnd]] = False
            isl_g = {k: torch.from_numpy(v).cuda() for k, v in isl.items()}
            torch.cuda.synchronize()
            VK.reset_launch_count()
            t0 = time.perf_counter()
            srv, res = VR.compressed_assimilate(
                srv, isl_g, POD_ALPHA, torch.from_numpy(alive),
                density=POD_DENSITY, residuals=res, transport=t_card)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = VK.launch_counts()
            check(counts == {**zero, **POD_LAUNCHES},
                  f"pod round {rnd}: launches {counts}")
            for kk, v in counts.items():
                totals[kk] += v
            cur = {k: v.cpu().numpy() for k, v in srv.items()}
            rounds.append((isl, alive, cur,
                           {k: v.cpu().numpy() for k, v in res.items()}))
        return srv, res

    # a warm-up round (first use of every kernel and library), discarded
    VR.compressed_assimilate(
        {k: torch.from_numpy(v).cuda() for k, v in server.items()},
        {k: torch.from_numpy(v).cuda() for k, v in islands(server, 0).items()},
        POD_ALPHA, torch.ones(POD_ISLANDS, dtype=torch.bool),
        density=POD_DENSITY, transport=recording_transport())
    torch.cuda.synchronize()
    (srv, res), spans = host_breakdown(card_rounds, [
        (C, "exact_topk"), (C, "compress_flat"), (wire, "encode_sparse"),
        (wire, "decode"), (C, "decompress_flat")])
    wall = sum(walls)
    for rnd, w in enumerate(walls):
        say(f"pod round {rnd} on cuda: {1e3 * w:.3f} ms (host clock, ending "
            f"in a synchronize), launches {POD_LAUNCHES}")
    for key, sec in sorted(spans.items(), key=lambda kv: -kv[1]):
        say(f"pod host span {key}: {1e3 * sec / POD_ROUNDS:.3f} ms a round "
            f"({100 * sec / wall:.1f}% of the rounds' wall)")

    # one more round under the profiler (its first-use costs are paid)
    from torch.profiler import ProfilerActivity, profile
    last_isl = {k: torch.from_numpy(v).cuda() for k, v in rounds[-1][0].items()}
    alive = torch.ones(POD_ISLANDS, dtype=torch.bool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        VR.compressed_assimilate(srv, last_isl, POD_ALPHA, alive,
                                 density=POD_DENSITY, residuals=res,
                                 transport=recording_transport())
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    report_profile(prof, f"pod round (profiled wall {pwall:.3f} s)", pwall)
    del srv, res, last_isl
    torch.cuda.empty_cache()

    # the same rounds on the CPU, from the same islands
    t_cpu = recording_transport()
    srv, res = {k: torch.from_numpy(v) for k, v in server.items()}, None
    VK.reset_launch_count()
    for rnd, (isl, alive, want_srv, want_res) in enumerate(rounds):
        srv, res = VR.compressed_assimilate(
            srv, {k: torch.from_numpy(v) for k, v in isl.items()}, POD_ALPHA,
            torch.from_numpy(alive), density=POD_DENSITY, residuals=res,
            transport=t_cpu, device="cpu")
        for k in server:
            check(srv[k].numpy().tobytes() == want_srv[k].tobytes(),
                  f"pod round {rnd}: server leaf {k} card != cpu")
            check(res[k].numpy().tobytes() == want_res[k].tobytes(),
                  f"pod round {rnd}: residual leaf {k} card != cpu")
        say(f"pod round {rnd}: server and residuals card == cpu (bit for "
            f"bit), island {POD_DEAD.get(rnd, 'none')} dead")
    check(VK.launch_count() == 0, "the CPU pod rounds launched a kernel")
    frames_match(np, t_card.sent, t_cpu.sent, "pod rounds")
    check(all(np.isfinite(v).all() for v in rounds[-1][2].values()),
          "pod rounds: server not finite")
    return totals


def coordinator_card_vs_cpu(torch, np, VK) -> None:
    """Phase 9d: CompressedVCASGD(0.9, density=0.05) through the
    Coordinator's issue / submit / deliver / assimilate on the bench
    model's bus, 3 clients for 2 rounds, card against CPU."""
    from repro_torch.core import flat as F
    from repro_torch.core.baselines import CompressedVCASGD
    from repro_torch.protocol import Coordinator
    model = bench_model(np, 1)
    mask = np.arange(BENCH_N) < BENCH_LOGICAL
    runs = {}
    for device in ("cuda", "cpu"):
        coord = Coordinator(
            CompressedVCASGD(0.9, density=POD_DENSITY),
            F.flatten({k: torch.from_numpy(v).to(device)
                       for k, v in model.items()}),
            transport=recording_transport())
        VK.reset_launch_count()
        uid = 0
        for rnd in (1, 2):
            leases = []
            for cid in range(3):
                leases.append(coord.issue(cid=cid, uid=uid, round=rnd,
                                          base=coord.state.params))
                uid += 1
            for lease in leases:
                step = (np.random.default_rng(10 * rnd + lease.cid)
                        .standard_normal(BENCH_N).astype(np.float32)
                        * np.float32(0.01) * mask)
                coord.submit(lease, lease.base.buf
                             + torch.from_numpy(step).to(device))
            for lease in leases:
                coord.assimilate(lease, coord.deliver(lease),
                                 server_version=rnd - 1)
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = (coord, VK.launch_counts())
    (cg, counts), (cc, counts_cpu) = runs["cuda"], runs["cpu"]
    want = {**dict.fromkeys(VK.KERNELS, 0), "blocked_topk_stats": 6,
            "threshold_sparsify_exact": 6, "quantize_int8": 6,
            "dequantize_int8": 12, "pack_body": 6, "vc_asgd_lerp_flat": 6}
    check(counts == want, f"coordinator: launches {counts} != {want}")
    check(sum(counts_cpu.values()) == 0, "coordinator: the CPU launched")
    check(bits_equal(torch, cg.state.params.buf.cpu(), cc.state.params.buf),
          "coordinator: server bus card != cpu")
    for cid in range(3):
        check(bits_equal(torch, cg._residuals[cid].cpu(), cc._residuals[cid]),
              f"coordinator: client {cid}'s residual card != cpu")
    frames_match(np, cg.transport.sent, cc.transport.sent, "coordinator")
    say(f"coordinator: 2 rounds x 3 clients, server bus and residual ledger "
        f"card == cpu; launches {counts}")


# ---------------------------------------------------------------------------
# phase 10: the port's kernel bench, with B4, B8 and B11
# ---------------------------------------------------------------------------

# shapes of B1's and B4's per-tensor entries (tests/test_kernels.py:23-50)
RAGGED_SHAPES = ((17,), (255, 9), (3, 5, 7, 11))
DC_MAIN_N = 1 << 24              # the bench's dc_lerp_flat_16M row
B8_TAU = 0.01                    # the bench's threshold_sparsify rows
B11_KS = (656, 1313, 1000, 105_075, BIG_K)
B11_MAIN_K = 105_075             # the bench bus's k (density 0.05)
# every k mod 16 (the value section's last lane, the scale and index
# sections' shifts and seams), and sel / idx off 16-byte boundaries
B11_MOD16_KS = tuple(4096 + r for r in range(16))
B11_OFFSETS = ((0, 0), (1, 0), (0, 3), (2, 1))
BENCH_SUITES = ("kernels", "flat", "flat_adam", "compression", "roofline")


def _record(torch, kern, plain, iters: int, nbytes: float, ops: float,
            err: float) -> dict:
    rec = {"max_abs_err": err, "library_ms": None,
           "ms": KB.cuda_ms(kern, iters),
           "plain_ms": KB.cuda_ms(plain, iters)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
    return rec


def _say_timing(name: str, size: str, r: dict) -> None:
    say(f"timing {name} {size}: kernel {r['ms']:.6f} ms, plain "
        f"{r['plain_ms']:.6f} ms, library none (no single PyTorch call "
        f"computes it), bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of it")


def new_kernels_parity(torch, np, VK, TK, QK, SK, R) -> dict:
    """Phase 10a: B4 (with B1's per-tensor entry), B8 and B11 against
    their plain versions on the card, bit for bit; each timed beside its
    plain version and its bound at the bench's shape and at 2^27 (k =
    6,710,886 for B11).  Returns the records at the bench's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    out = {}

    # B4 flat and B1 / B4 per tensor
    for n in (MAIN_N, DC_MAIN_N, BIG_N):
        for dtype in (torch.float32, torch.bfloat16):
            s, c, gr, b = (rnd(n).to(dtype) for _ in range(4))
            kern = VK.vc_asgd_dc_lerp_flat(s, c, gr, b, POD_ALPHA, 0.05)
            plain = R.vc_asgd_dc_lerp(s, c, gr, b, POD_ALPHA, 0.05)
            torch.cuda.synchronize()
            check(bits_equal(torch, kern, plain),
                  f"B4 {dtype} N={n}: kernel != plain version")
            for name, k_, p_ in (
                    ("B1 vc_asgd_lerp", VK.vc_asgd_lerp(s, c, 0.95),
                     R.vc_asgd_lerp(s, c, 0.95)),
                    ("B4 vc_asgd_dc_lerp", VK.vc_asgd_dc_lerp(
                        s, c, gr, b, 0.95, 0.04), R.vc_asgd_dc_lerp(
                        s, c, gr, b, 0.95, 0.04))):
                check(bits_equal(torch, k_, p_),
                      f"{name} {dtype} N={n}: kernel != plain version")
            say(f"parity B4 vc_asgd_dc_lerp_flat and the per-tensor B1 / B4 "
                f"{str(dtype)[6:]} N={n}: bit-exact")
            if dtype == torch.float32 and n != MAIN_N:
                rec = _record(
                    torch, lambda: VK.vc_asgd_dc_lerp_flat(
                        s, c, gr, b, POD_ALPHA, 0.05),
                    lambda: R.vc_asgd_dc_lerp(s, c, gr, b, POD_ALPHA, 0.05),
                    20 if n == DC_MAIN_N else 10, 20 * n, 8 * n,
                    float((kern - plain).abs().max()))
                _say_timing("vc_asgd_dc_lerp_flat", f"N={n}", rec)
                if n == DC_MAIN_N:
                    out["vc_asgd_dc_lerp_flat"] = rec
            del s, c, gr, b, kern, plain
        torch.cuda.empty_cache()
    for shape in RAGGED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            s, c, gr, b = (rnd(*shape).to(dtype) for _ in range(4))
            k1, k4 = (VK.vc_asgd_lerp(s, c, 0.95),
                      VK.vc_asgd_dc_lerp(s, c, gr, b, 0.95, 0.04))
            check(k1.shape == k4.shape == s.shape
                  and bits_equal(torch, k1, R.vc_asgd_lerp(s, c, 0.95))
                  and bits_equal(torch, k4, R.vc_asgd_dc_lerp(
                      s, c, gr, b, 0.95, 0.04)),
                  f"B1 / B4 per tensor {shape} {dtype}: kernel != plain")
        say(f"parity B1 / B4 per tensor {shape} f32 and bf16: bit-exact")

    # B8
    for name, n, dtype in (("bench", BENCH_N, torch.float32),
                           ("ragged", 9000, torch.float32),
                           ("bench bf16", BENCH_N, torch.bfloat16),
                           ("2^27", BIG_N, torch.float32)):
        x = (rnd(n) * 0.02).to(dtype)
        x[::13] = -0.0
        (kk, kr), (pk, pr) = (TK.threshold_sparsify(x, B8_TAU),
                              R.threshold_sparsify(x, B8_TAU))
        torch.cuda.synchronize()
        check(bits_equal(torch, kk, pk) and bits_equal(torch, kr, pr),
              f"B8 {name} n={n}: kernel != plain version")
        check(torch.equal(kk.float() + kr.float(), x.float()),
              f"B8 {name}: kept + residual != x")
        say(f"parity B8 threshold_sparsify {name} n={n} tau {B8_TAU}: "
            f"bit-exact, {int((kk != 0).sum())} kept")
        if name in ("bench", "2^27"):
            rec = _record(torch, lambda: TK.threshold_sparsify(x, B8_TAU),
                          lambda: R.threshold_sparsify(x, B8_TAU),
                          50 if name == "bench" else 10, 12 * n, 3 * n,
                          max(float((kk - pk).abs().max()),
                              float((kr - pr).abs().max())))
            _say_timing("threshold_sparsify", f"N={n}", rec)
            if name == "bench":
                out["threshold_sparsify"] = rec
        del x, kk, kr, pk, pr
    torch.cuda.empty_cache()

    # B11 at every k mod 16, sel / idx at element offsets from their
    # allocation, the wire's block and a generic one
    for k in B11_MOD16_KS:
        for so, io in B11_OFFSETS:
            sel = (rnd(k + so) * 0.01)[so:]
            idx = torch.randint(0, 2 ** 31 - 1, (k + io,), generator=g,
                                device=dev, dtype=torch.int32)[io:]
            for block in ((QBLOCK, 100) if (so, io) == (0, 0) else
                          (QBLOCK,)):
                (kb, kq, ks_), (pb, pq, ps) = (
                    SK.quantize_pack(sel, idx, block),
                    R.quantize_pack(sel, idx, block))
                torch.cuda.synchronize()
                check(torch.equal(kb, pb) and torch.equal(kq, pq)
                      and bits_equal(torch, ks_, ps),
                      f"B11 k={k} sel/idx at +{so}/+{io} block {block}: "
                      f"kernel != plain version")
    say(f"parity B11 quantize_pack at k = {B11_MOD16_KS[0]}.."
        f"{B11_MOD16_KS[-1]} (every k mod 16), sel / idx at element "
        f"offsets {B11_OFFSETS}, block {QBLOCK} and 100: byte-exact")

    # B11, and B12 of B9's payload
    for k in B11_KS:
        ng = -(-k // QBLOCK)
        sel = rnd(k) * 0.01
        sel[k // 3] = 0.0
        idx = torch.sort(torch.randperm(BIG_N, generator=g, device=dev)[:k]
                         ).values.to(torch.int32)
        (kb, kq, ks_), (pb, pq, ps) = (SK.quantize_pack(sel, idx),
                                       R.quantize_pack(sel, idx))
        q9, s9 = QK.quantize_int8(sel)
        b12 = SK.pack_body(q9, s9, idx)
        torch.cuda.synchronize()
        check(kb.numel() == 5 * k + 4 * ng and torch.equal(kb, pb)
              and torch.equal(kq, pq) and bits_equal(torch, ks_, ps),
              f"B11 k={k}: kernel != plain version")
        check(torch.equal(kb, b12), f"B11 k={k}: body != B12(B9(sel))")
        say(f"parity B11 quantize_pack k={k}: body, q and scales "
            f"byte-exact; body == pack_body(quantize_int8(sel))")
        if k in (B11_MAIN_K, BIG_K):
            nbytes = 8 * k + (5 * k + 4 * ng) + ng * QBLOCK + 4 * ng
            rec = _record(torch, lambda: SK.quantize_pack(sel, idx),
                          lambda: R.quantize_pack(sel, idx),
                          50 if k == B11_MAIN_K else 10, nbytes, 5 * k,
                          float((kb.int() - pb.int()).abs().max()))
            _say_timing("quantize_pack", f"k={k}", rec)
            if k == B11_MAIN_K:
                out["quantize_pack"] = rec
        del sel, idx, kb, kq, ks_, pb, pq, ps, q9, s9, b12
    torch.cuda.empty_cache()
    return out


def bench_on_card(VK) -> dict:
    """Phase 10b: the port's bench (repro_torch.benchmarks.run, every
    suite) in this process on the card with --check: the launch gate
    must equal results/BASELINE_launches.json, every suite's rows and
    the roofline table must print.  Returns the run's launches."""
    import contextlib
    import io
    from repro_torch.benchmarks import run as bench
    buf = io.StringIO()
    VK.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--only", ",".join(BENCH_SUITES), "--check"])
    counts = VK.launch_counts()
    lines = buf.getvalue().splitlines()
    for line in lines:
        say(f"bench {line}")
    check(rc == 0, "bench --check: the launch gate failed (see stderr)")
    check(lines[0] == "name,us_per_call,derived", "bench: no CSV header")
    for suite in BENCH_SUITES:
        rows = [ln for ln in lines[1:] if ln.startswith(suite + ".")]
        check(len(rows) >= 4 and all(ln.count(",") == 2 for ln in rows),
              f"bench suite {suite}: rows missing or malformed")
    ckpt = [ln.split(",") for ln in lines
            if ln.startswith("flat_adam.train_ckpt_one_pass,")]
    check(len(ckpt) == 1 and float(ckpt[0][1]) > 0
          and "launches=" not in ckpt[0][2],
          "bench: flat_adam.train_ckpt_one_pass not timed (or it launched)")
    say(f"bench: {len(lines) - 1} rows, launch gate == "
        f"results/BASELINE_launches.json; launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the paper's preemptible-instance story
# ---------------------------------------------------------------------------

# 11a: run_preemptible_training at the MLP's full published width, killed
# before steps 13 and 27 (records every 10 steps: 3 + 7 steps recomputed)
PRE_STEPS, PRE_BATCH, PRE_EVERY, PRE_KILLS = 40, 64, 10, (13, 27)
# the card's losses against the CPU's, step by step (the same f32 math in
# another order: cuBLAS against the CPU's GEMMs): 4.77e-7 measured on an
# H100, two f32 ulps of a loss near 2; the limit leaves 20x
PRE_LOSS_TOL = 1e-5
# 11b: results folded after a restore, card against CPU
AFTER_RESTORE = 3


def ckpt_dir():
    """A fresh directory under the checkout's ignored build/ for phase
    11's records."""
    import tempfile
    base = ROOT / "build" / "ckpt"
    base.mkdir(parents=True, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=base)


def preemptible_on_card(torch, VK) -> None:
    """Phase 11a: kill-and-restore training on the card (B3 every step):
    killed at PRE_KILLS, the loss at every step and the final bus equal
    the uninterrupted run's bit for bit; 2 restores, 10 recomputed steps,
    B3 launches = steps + recomputed steps; the same run on the CPU within
    PRE_LOSS_TOL a step; a record written on the card restores on the CPU
    bit for bit and the other way round (params, m, v, step, and the
    re-saved file byte for byte)."""
    from repro_torch.checkpoint import (load_train_checkpoint,
                                        save_train_checkpoint)
    from repro_torch.core.preemption import KillSchedule
    from repro_torch.core.simulator import run_preemptible_training
    from repro_torch.core.tasks import MLPTask, make_classification_data
    data = make_classification_data()
    with ckpt_dir() as d:
        d = Path(d)

        def train(name, device, kills=()):
            VK.reset_launch_count()
            t0 = time.perf_counter()
            res = run_preemptible_training(
                MLPTask(), data, steps=PRE_STEPS, batch=PRE_BATCH,
                ckpt_every=PRE_EVERY, ckpt_dir=d / name, seed=0,
                device=device,
                kill_schedule=KillSchedule.at(*kills) if kills else None)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = VK.launch_counts()
            say(f"preemptible {name} on {device}: {res.steps_done} steps, "
                f"{res.restores} restores, {res.recomputed_steps} "
                f"recomputed, wall {wall:.3f} s, B3 launches "
                f"{counts['adam_update_flat']}, final loss "
                f"{res.losses[PRE_STEPS - 1]:.6f}")
            return res, counts

        clean, counts = train("clean", "cuda")
        check(counts["adam_update_flat"] == PRE_STEPS,
              f"clean run: {counts['adam_update_flat']} B3 launches")
        killed, counts = train("killed", "cuda", PRE_KILLS)
        check(killed.restores == 2 and killed.recomputed_steps == 10,
              f"killed run: {killed.restores} restores, "
              f"{killed.recomputed_steps} recomputed steps")
        check(counts["adam_update_flat"] == PRE_STEPS + 10,
              f"killed run: {counts['adam_update_flat']} B3 launches != "
              f"{PRE_STEPS} steps + 10 recomputed")
        check(sum(counts.values()) == counts["adam_update_flat"],
              f"killed run launched other kernels: {counts}")
        check(killed.trajectory() == clean.trajectory(),
              "killed and clean loss trajectories differ on the card")
        check(bits_equal(torch, killed.final_params.buf,
                         clean.final_params.buf),
              "killed and clean final params differ on the card")
        say(f"preemptible: killed at {PRE_KILLS} == clean, every one of "
            f"{PRE_STEPS} losses and the final bus bit for bit")
        host, counts = train("host", "cpu", PRE_KILLS)
        check(sum(counts.values()) == 0, "the CPU run launched a kernel")
        gap = max(abs(host.losses[s] - clean.losses[s])
                  for s in range(PRE_STEPS))
        say(f"preemptible: card vs CPU max loss gap {gap:.3g} (tolerance "
            f"{PRE_LOSS_TOL})")
        check(gap <= PRE_LOSS_TOL, f"card vs CPU loss gap {gap}")
        for src, res, other in (("killed", killed, "cpu"),
                                ("host", host, "cuda")):
            path = d / src / f"ckpt_{PRE_STEPS:08d}.msgpack"
            fp, opt, extra = load_train_checkpoint(path, res.final_params)
            fo, oo, _ = load_train_checkpoint(path, res.final_params,
                                              device=other)
            check(fo.buf.device.type == other and oo.step == opt.step
                  == PRE_STEPS, f"{src} record on {other}")
            for a, b in ((res.final_params.buf, fo.buf), (fp.buf, fo.buf),
                         (opt.m, oo.m), (opt.v, oo.v)):
                check(bits_equal(torch, a.cpu(), b.cpu()),
                      f"{src} record restored on {other} differs")
            again = d / f"{src}-on-{other}.msgpack"
            save_train_checkpoint(again, fo, oo, extra)
            check(again.read_bytes() == path.read_bytes(),
                  f"{src} record re-saved from {other} differs")
            say(f"preemptible: the {src} run's record "
                f"({path.stat().st_size} bytes) restores on {other} bit "
                f"for bit and re-saves byte for byte")


def coordinator_checkpoints(torch, np, VK) -> None:
    """Phase 11b: Coordinator.save_checkpoint / restore_checkpoint on the
    card with VCASGD (B1) and EASGDFlatPod (B5): after a restore into a
    coordinator built from other params the next handout is the saved
    center (the pod's replicas tiled from it), and AFTER_RESTORE more
    results folded on the card equal the same folded on the CPU from the
    same record, bit for bit (B1 and B5 against their plain versions)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import flat as F
    from repro_torch.core.baselines import VCASGD, EASGDFlatPod
    from repro_torch.core.tasks import MLPTask
    from repro_torch.protocol import Coordinator
    task = MLPTask()
    rng = np.random.default_rng(11)

    def results(n):
        return [rng.standard_normal(MAIN_N).astype(np.float32) * 0.01
                for _ in range(n)]

    def fold(coord, bufs, cids, uid0):
        for j, (buf, cid) in enumerate(zip(bufs, cids)):
            lease = coord.issue(cid=cid, uid=uid0 + j, round=1,
                                base=coord.state.params)
            coord.submit(lease, lease.base.buf + torch.from_numpy(buf).to(
                lease.base.buf.device))
            coord.assimilate(lease, coord.deliver(lease),
                             server_version=coord.state.version)

    for name, make, cids in (
            ("VCASGD", lambda: VCASGD(0.9), (0, 1, 2)),
            ("EASGDFlatPod", lambda: EASGDFlatPod(n_replicas=2, beta=0.1),
             (0, 1, 0))):
        with ckpt_dir() as d:
            VK.reset_launch_count()
            coord = Coordinator(make(), F.flatten(task.init_params(
                1, device="cuda")))
            fold(coord, results(2), (0, 1), 0)
            saved = coord.state.params.buf.clone()
            mgr = CheckpointManager(d, async_save=False)
            coord.save_checkpoint(mgr, step=5, extra={"next_uid": 2})
            after = results(AFTER_RESTORE)
            resumed = {}
            for device in ("cuda", "cpu"):
                c = Coordinator(make(), F.flatten(task.init_params(
                    2, device=device)))
                check(c.restore_checkpoint(mgr) == 5
                      and c.restored_extra["next_uid"] == 2
                      and c.state.version == coord.state.version,
                      f"{name} restore on {device}")
                lease = c.issue(cid=0, uid=100, round=1,
                                base=c.state.params)
                check(bits_equal(torch, lease.base.buf.cpu(), saved.cpu()),
                      f"{name} on {device}: the next handout is not the "
                      f"saved center")
                c.drop(lease)
                if name == "EASGDFlatPod":
                    check(all(bits_equal(torch, r.cpu(), saved.cpu())
                              for r in c.state.replicas),
                          f"{name} on {device}: replicas not tiled from "
                          f"the saved center")
                fold(c, after, cids, 200)
                resumed[device] = c.state
            counts = {k: v for k, v in VK.launch_counts().items() if v}
            card, host = resumed["cuda"], resumed["cpu"]
            check(bits_equal(torch, card.params.buf.cpu(), host.params.buf),
                  f"{name}: card and CPU folds after the restore differ")
            if name == "EASGDFlatPod":
                check(bits_equal(torch, card.replicas.cpu(), host.replicas)
                      and set(card.pending) == set(host.pending) == {0}
                      and bits_equal(torch, card.pending[0].cpu(),
                                     host.pending[0]),
                      f"{name}: replicas or pending rows differ")
                check(counts == {"easgd_elastic_flat": 2},
                      f"{name}: launches {counts}, expected 2 B5 (one round "
                      f"before the save, one after)")
            else:
                check(counts == {"vc_asgd_lerp_flat": 2 + AFTER_RESTORE},
                      f"{name}: launches {counts}, expected "
                      f"{2 + AFTER_RESTORE} B1")
            say(f"coordinator checkpoint {name}: restored on card and CPU, "
                f"next handout == saved center, {AFTER_RESTORE} folds after "
                f"it card == CPU bit for bit; launches {counts}")


def paper_suites_on_card(torch, VK) -> None:
    """Phase 11c: the cost and fig6 suites (repro_torch.benchmarks.
    paper_figs, quick) on the card: their claims and walls; fig6's hours
    equal the same suite's on the CPU and its accuracy curves agree
    within ACC_BAND."""
    from repro_torch.benchmarks import paper_figs as PFIGS
    out = {}
    for suite in ("cost", "fig6"):
        for device in ("cuda", "cpu"):
            VK.reset_launch_count()
            t0 = time.perf_counter()
            res = PFIGS.SUITES[suite](True, device)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in VK.launch_counts().items() if v}
            say(f"paper suite {suite} on {device}: wall {wall:.3f} s, claims "
                f"{res['_claims']}, launches {counts}")
            check(all(res["_claims"].values()),
                  f"paper suite {suite} on {device}: a claim failed")
            out[suite, device] = res
    cost = out["cost", "cuda"]
    say(f"paper suite cost: {json.dumps(cost)}")
    card, host = out["fig6", "cuda"], out["fig6", "cpu"]
    for curve in ("distributed", "serial"):
        check([p["hours"] for p in card[curve]]
              == [p["hours"] for p in host[curve]],
              f"fig6 {curve}: hours differ card vs CPU")
        worst = max(abs(a["acc"] - b["acc"])
                    for a, b in zip(card[curve], host[curve]))
        check(worst <= ACC_BAND, f"fig6 {curve}: accuracy gap {worst}")
        say(f"paper suite fig6 {curve}: hours card == CPU, max accuracy "
            f"gap {worst:.4f}; final acc {card[curve][-1]['acc']}")


# ---------------------------------------------------------------------------
# phase 12: the rest of the simulator — fleets, the sharded bus, the tier,
# subscribers
# ---------------------------------------------------------------------------

# 12b: the registry's behaviour scenarios, once each on the card
BEHAVIOUR = ("az_reclaim", "spot_price", "diurnal", "tiered")
# 12c: the scenario suites of the port's bench
SCENARIO_SUITES = ("fleet", "handout")


def _bus_bits(torch, res):
    return res.scheme_state.params.buf.detach().cpu().view(torch.int32)


def fleet_pinned(torch, VK) -> dict:
    """Phase 12a: the fixture's 5 cases the earlier phases cannot replay,
    on the card and on the CPU: every trace, wire and tier field equals
    the fixture on both; the ProbeTask cases card == CPU bit for bit in
    every accuracy and in the final bus, and within PROBE_ACC_TOL of the
    fixture's accuracy; tier-2level equals its device's tier-flat-twin
    run bit for bit (bus and final accuracy).  Each card run launches B1
    once a fold (results assimilated, at the hub or at an edge) and B3
    once an MLP client step (none for the probe), nothing else.  Returns the launches summed."""
    from repro_torch.core.simulator import run_simulation
    pin = json.loads((ROOT / "results" / "PINNED_sim_regression.json")
                     .read_text())
    totals = dict.fromkeys(VK.KERNELS, 0)

    def run_case(name, device, **overrides):
        scheme, cfg = pinned_case(name)
        cfg = dataclasses.replace(cfg, **overrides)
        task, data = pinned_task(name, cfg)
        VK.reset_launch_count()
        t0 = time.perf_counter()
        res = run_simulation(task, data, scheme, cfg, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return res, VK.launch_counts(), time.perf_counter() - t0

    for name, (_, _, _, kind) in PINNED_FLEET_CASES.items():
        want = pin["cases"][name]
        (res_g, counts, wall_g), (res_c, counts_c, wall_c) = (
            run_case(name, "cuda"), run_case(name, "cpu"))
        check(sum(counts_c.values()) == 0,
              f"pinned {name}: the CPU run launched a CUDA kernel")
        implied = dict.fromkeys(VK.KERNELS, 0)
        implied["vc_asgd_lerp_flat"] = res_g.results_assimilated
        # the probe's nudge is not an Adam step: B3 runs only for the MLP
        implied["adam_update_flat"] = (0 if kind == "probe"
                                       else res_g.client_steps)
        check(counts == implied, f"pinned {name}: launches {counts} != "
              f"implied {implied}")
        got_g, got_c = pinned_fields(res_g), pinned_fields(res_c)
        for f in PIN_TRACE + (PIN_TIER if "aggregators" in want else ()):
            check(got_g[f] == want[f], f"pinned {name}: {f} on cuda "
                  f"{got_g[f]} != pinned {want[f]}")
            check(got_c[f] == want[f], f"pinned {name}: {f} on cpu "
                  f"{got_c[f]} != pinned {want[f]}")
        accs_g = [p.acc_mean for p in res_g.points] + [res_g.final_accuracy]
        accs_c = [p.acc_mean for p in res_c.points] + [res_c.final_accuracy]
        bus_g = res_g.scheme_state.params.buf
        check(bool(torch.isfinite(bus_g).all()),
              f"pinned {name}: the card's bus is not finite")
        if kind == "probe":
            check(accs_g == accs_c, f"pinned {name}: accuracy card "
                  f"{accs_g} != cpu {accs_c}")
            check(torch.equal(_bus_bits(torch, res_g),
                              _bus_bits(torch, res_c)),
                  f"pinned {name}: final bus card != cpu")
            gap = max(abs(a - w) for a, w in zip(
                accs_g, want["acc_mean"] + [want["final_accuracy"]]))
            check(gap <= PROBE_ACC_TOL, f"pinned {name}: accuracy vs the "
                  f"fixture {gap} > {PROBE_ACC_TOL}")
            note = (f"accuracy card == cpu bit for bit, bus too, gap to "
                    f"the fixture {gap:.3g}")
        else:
            # the twin property on each device: one aggregator in front
            # of one strong PS folds exactly what the flat hub folds
            for device, res in (("cuda", res_g), ("cpu", res_c)):
                twin, _, _ = run_case(name, device, aggregators=0)
                check(twin.final_accuracy == res.final_accuracy
                      and torch.equal(
                          _bus_bits(torch, twin),
                          _bus_bits(torch, res)),
                      f"pinned {name} on {device}: != its tier-flat-twin")
            gap = max(abs(a - b) for a, b in zip(accs_g, accs_c))
            check(gap <= ACC_BAND, f"pinned {name}: accuracy cuda vs cpu "
                  f"{gap}")
            note = (f"== tier-flat-twin bit for bit on each device, "
                    f"accuracy card vs cpu gap {gap:.4f}, final acc cuda "
                    f"{res_g.final_accuracy:.4f} (fixture "
                    f"{want['final_accuracy']:.4f})")
        say(f"pinned {name}: trace == pin (cuda and cpu); {note}; wall "
            f"cuda {wall_g:.3f} s, cpu {wall_c:.3f} s; events "
            f"{res_g.events_processed}; launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
        for k, v in counts.items():
            totals[k] += v
    return totals


def registry_on_card(torch, VK) -> None:
    """Phase 12b: fleet_1k on the card and on the CPU (every summary
    field but the walls, and the final bus, bit for bit); the behaviour
    scenarios once each on the card (every unit assimilated, finite
    progress).  Each card run launches B1 once a result and nothing
    else.  fleet_10k, fleet_10k_tier and handout_flash_10k (f32, bf16)
    run in 12c's suites, which hold them to BENCH_fleet.json and
    BENCH_handout.json."""
    from repro_torch.benchmarks.fleet_bench import timed_run
    from repro_torch.scenarios import registry as REG

    def one(name, device):
        VK.reset_launch_count()
        res, wall = timed_run(name, device)
        counts = {k: v for k, v in VK.launch_counts().items() if v}
        summary = REG.summarize(REG.get(name), res, wall)
        if device == "cuda":
            check(counts == {"vc_asgd_lerp_flat": res.results_assimilated},
                  f"{name}: launches {counts}")
        else:
            check(not counts, f"{name}: the CPU run launched a kernel")
        return res, summary

    res_g, card = one("fleet_1k", "cuda")
    res_c, host = one("fleet_1k", "cpu")
    timing = ("bench_wall_s", "events_per_sec")
    for k in card:
        if k not in timing:
            check(card[k] == host[k], f"fleet_1k: {k} card {card[k]} != "
                  f"cpu {host[k]}")
    check(torch.equal(_bus_bits(torch, res_g),
                      _bus_bits(torch, res_c)),
          "fleet_1k: final bus card != cpu")
    say(f"scenario fleet_1k: card == cpu (every field, the bus bit for "
        f"bit); wall card {card['bench_wall_s']} s ({card['events_per_sec']}"
        f" events/s), cpu {host['bench_wall_s']} s "
        f"({host['events_per_sec']} events/s); {json.dumps(card)}")
    for name in BEHAVIOUR:
        res, summary = one(name, "cuda")
        cfg = REG.get(name).config()
        check(res.results_assimilated == cfg.n_shards * cfg.max_epochs
              and res.epochs_done == cfg.max_epochs
              and 0.0 < res.final_accuracy < 1.0,
              f"{name}: {res.results_assimilated} results, "
              f"{res.epochs_done} epochs, accuracy {res.final_accuracy}")
        say(f"scenario {name} on cuda: wall {summary['bench_wall_s']} s, "
            f"{summary['events_per_sec']} events/s; {json.dumps(summary)}")


def scenario_suites_on_card(torch, VK) -> None:
    """Phase 12c: ``run --only fleet,handout --check`` in this process on
    the card: the floors of results/BASELINE_torch_fleet.json hold, every
    claim holds, and every row's fingerprint equals the reference's
    BENCH_fleet.json / BENCH_handout.json."""
    import contextlib
    import io
    from repro_torch.benchmarks import run as bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, results = bench.run_cli(
            ["--only", ",".join(SCENARIO_SUITES), "--check"])
    for line in buf.getvalue().splitlines():
        say(f"bench {line}")
    check(rc == 0, "bench --only fleet,handout --check failed (see stderr)")
    for suite in SCENARIO_SUITES:
        res = results[suite]
        check(all(res["_claims"].values()),
              f"{suite}: a claim failed: {res['_claims']}")
        for row, entry in res.items():
            if row.startswith("_"):
                continue
            check(entry.get("fingerprint_matches_reference") is True,
                  f"{suite}.{row}: fingerprint != the reference's")
            say(f"scenario {suite}.{row} on cuda: wall "
                f"{entry['bench_wall_s']} s, {entry['events_per_sec']} "
                f"events/s; fingerprint == reference; {json.dumps(entry)}")
        say(f"suite {suite}: claims {res['_claims']}")


# ---------------------------------------------------------------------------
# phase 13: the wall-clock runtime, the frontier, the examples
# ---------------------------------------------------------------------------

# 13a/13b: vc_serve's argv sets (the default size: 4 rounds x 3 clients,
# 3,000 / 600 rows, the MLP's 13,130 parameters on a 16,384-element bus)
SERVE_STEPS = 4                  # Adam steps a client runs on one lease
SERVE_TIER_ARGS = ["--density", "0.05", "--shards", "4", "--handout-dtype",
                   "bf16", "--tier", "2", "--subscribers", "16"]
# card vs CPU final bus of vc_serve: cuBLAS and the CPU's BLAS sum in
# other orders, and Adam can turn an ulp on a near-zero gradient into an
# lr-sized step (1e-3); the simulator's tests document drift up to 1e-2
SERVE_BUS_TOL = 1e-2
RPC_ITERS = 200
# 13e: CNNTask.client_train card vs CPU (cuDNN's and the CPU's
# convolutions sum in other orders; TF32 off), 20 steps
CNN_STEPS = 20
CNN_TOL = 1e-3


def _serve_counters(c) -> dict:
    return {"wire": dataclasses.asdict(c.wire_stats),
            "handout": (c.handout_frames, c.handout_bytes),
            "frames": dict(c.frames),
            "leases": (c.assimilated, c.dropped, c.expired),
            "version": c.state.version}


def _round_shares(rounds) -> str:
    """Median warm round (rounds after the first) and the shares of its
    phases, host clock."""
    warm = sorted(rounds[1:], key=lambda r: r["wall"])
    mid = warm[len(warm) // 2]
    shares = ", ".join(f"{k} {1e3 * mid[k]:.2f} ms "
                       f"({100 * mid[k] / mid['wall']:.1f}%)"
                       for k in ("train", "submit", "fold", "ckpt", "eval",
                                 "serve", "rpc"))
    return (f"round 0 {1e3 * rounds[0]['wall']:.2f} ms; warm rounds "
            + ", ".join(f"{1e3 * r['wall']:.2f}" for r in rounds[1:])
            + f" ms; median warm round {1e3 * mid['wall']:.2f} ms: {shares}")


def broker_rpc_us(np, torch) -> None:
    """Host us of one broker RPC carrying the MLP bus's dense frame
    (65,536 bytes of body), send and recv timed apart, medians of
    RPC_ITERS."""
    from repro_torch.transfer import ProcessTransport, wire
    frame = wire.encode_dense(torch.zeros(MAIN_N))
    with ProcessTransport() as t:
        sends, recvs = [], []
        for _ in range(RPC_ITERS):
            t0 = time.perf_counter()
            mid = t.send(frame)
            t1 = time.perf_counter()
            got = t.recv(mid)
            recvs.append(time.perf_counter() - t1)
            sends.append(t1 - t0)
        check(got == frame and t.in_flight == 0, "broker RPC round trip")
    say(f"broker RPC, {len(frame)}-byte dense frame: send "
        f"{1e6 * float(np.median(sends)):.1f} us, recv "
        f"{1e6 * float(np.median(recvs)):.1f} us (medians of {RPC_ITERS}, "
        f"host clock)")


def serve_card_vs_cpu_13a(torch, np, VK, tmp: Path) -> dict:
    """Phase 13a: vc_serve at its default size on the card and on the CPU
    from one seed: counters equal, accuracy within ACC_BAND, the bus
    within SERVE_BUS_TOL; B1 launched once a fold, B3 once a client step,
    nothing else; the round walls and where a warm round's time goes."""
    from repro_torch.launch import vc_serve as VS
    VK.reset_launch_count()
    card = VS.run(["--ckpt-dir", str(tmp / "a-cuda")])
    torch.cuda.synchronize()
    counts = {k: v for k, v in VK.launch_counts().items() if v}
    VK.reset_launch_count()
    host = VS.run(["--ckpt-dir", str(tmp / "a-cpu"), "--device", "cpu"])
    check(VK.launch_count() == 0, "13a: the CPU run launched a kernel")
    steps = 3 * SERVE_STEPS * 4                     # clients x steps x rounds
    want = {"vc_asgd_lerp_flat": card.coord.assimilated,
            "adam_update_flat": steps}
    check(counts == want, f"13a: launches {counts} != {want}")
    check(_serve_counters(card.coord) == _serve_counters(host.coord),
          f"13a: counters card {_serve_counters(card.coord)} != cpu "
          f"{_serve_counters(host.coord)}")
    check(card.next_uid == host.next_uid == 12, "13a: next uid")
    gap = max(abs(a - b) for a, b in zip(card.accuracy, host.accuracy))
    check(gap <= ACC_BAND, f"13a: accuracy card vs cpu {gap} > {ACC_BAND}")
    bus_g = card.coord.state.params.buf
    check(bool(torch.isfinite(bus_g).all()) and bus_g.shape == (MAIN_N,),
          "13a: the card's bus is not finite or has the wrong shape")
    diff = float((bus_g.cpu() - host.coord.state.params.buf).abs().max())
    check(diff <= SERVE_BUS_TOL, f"13a: bus card vs cpu {diff} > "
          f"{SERVE_BUS_TOL}")
    say(f"vc_serve default: counters card == cpu "
        f"{json.dumps(_serve_counters(card.coord))}; accuracy cuda "
        f"{[round(a, 4) for a in card.accuracy]} cpu "
        f"{[round(a, 4) for a in host.accuracy]} (max gap {gap:.4f}, band "
        f"{ACC_BAND}); final bus max abs diff {diff:.3g} (limit "
        f"{SERVE_BUS_TOL}); launches {counts}")
    say(f"vc_serve default on cuda: {_round_shares(card.rounds)}")
    say(f"vc_serve default on cpu: {_round_shares(host.rounds)}")
    broker_rpc_us(np, torch)
    return counts


def serve_tier_on_card(torch, VK, tmp: Path) -> None:
    """Phase 13b: compressed uploads, a 4-shard bus with bf16 handouts,
    two edge aggregators and 16 subscribers on the card: every _check of
    the run passes (a failed one raises), B9 and B12 launched once per
    compressed upload, B10 once per upload and once per sparse decode at
    an edge, B1 once per edge fold, B3 once per client step."""
    from repro_torch.launch import vc_serve as VS
    from repro_torch.transfer import wire
    VK.reset_launch_count()
    res = VS.run(SERVE_TIER_ARGS + ["--ckpt-dir", str(tmp / "b")])
    torch.cuda.synchronize()
    counts = {k: v for k, v in VK.launch_counts().items() if v}
    uploads = sum(a.wire_stats.frames_sent - a.handout_frames
                  for a in res.aggs)
    decodes = sum(a.frames[wire.KIND_SPARSE] for a in res.aggs)
    folds = sum(a.assimilated for a in res.aggs)
    want = {"vc_asgd_lerp_flat": folds,
            "adam_update_flat": 3 * SERVE_STEPS * 4,
            "quantize_int8": uploads, "pack_body": uploads,
            "dequantize_int8": uploads + decodes}
    check(uploads == 12 and decodes == folds == 10,
          f"13b: {uploads} uploads, {decodes} sparse decodes, {folds} folds")
    check(counts == want, f"13b: launches {counts} != {want}")
    check(res.coord.frames[wire.KIND_AGG] == 8
          and res.coord.assimilated == 8, "13b: hub folds 2 merges a round")
    svc, cache = res.service, res.coord.handout_cache
    check(svc.pulls == 64 and svc.bytes_served > cache.encoded_bytes > 0,
          f"13b: {svc.pulls} pulls, {svc.bytes_served} B served, "
          f"{cache.encoded_bytes} B encoded")
    acc = res.accuracy
    check(all(0.0 < a < 1.0 for a in acc)
          and bool(torch.isfinite(res.coord.state.params.buf).all()),
          f"13b: accuracy {acc} or the bus not finite")
    say(f"vc_serve {' '.join(SERVE_TIER_ARGS)} on cuda: every check passed; "
        f"launches {counts}; hub {json.dumps(_serve_counters(res.coord))}; "
        f"served {svc.bytes_served} B for {cache.encoded_bytes} B encoded "
        f"(dedup {cache.dedup_ratio:.2f}x); accuracy "
        f"{[round(a, 4) for a in acc]}")
    say(f"vc_serve tier on cuda: {_round_shares(res.rounds)}")


def _pid_gone(pid: int) -> bool:
    try:
        status = Path(f"/proc/{pid}/status").read_text()
    except FileNotFoundError:
        return True
    return re.search(r"^State:\s+Z", status, re.M) is not None


def serve_kill_and_resume(tmp: Path) -> None:
    """Phase 13c: a child vc_serve on the card, SIGKILLed after its
    ``round 2:`` line; its broker exits on EOF; the restarted server
    resumes past the last checkpoint with monotone steps and uids and
    rewrites no step."""
    import os
    import signal
    d = tmp / "c"
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    cmd = [sys.executable, "-m", "repro_torch.launch.vc_serve",
           "--ckpt-dir", str(d)]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd + ["--rounds", "50"], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, text=True)
    broker, lines = None, []
    try:
        for line in child.stdout:
            lines.append(line.rstrip())
            m = re.search(r"broker pid=(\d+)", line)
            if m:
                broker = int(m.group(1))
            if "round 2:" in line:
                break
        child.send_signal(signal.SIGKILL)
    finally:
        child.kill()
        child.wait(timeout=60)
    killed_s = time.perf_counter() - t0
    check(child.returncode == -signal.SIGKILL and broker is not None,
          f"13c: child ended {child.returncode}, broker {broker}")
    deadline = time.monotonic() + 30
    while not _pid_gone(broker) and time.monotonic() < deadline:
        time.sleep(0.05)
    check(_pid_gone(broker), f"13c: broker {broker} outlived its server")
    steps = sorted(int(p.stem.split("_")[1]) for p in d.glob("ckpt_*.msgpack"))
    k = steps[-1]
    check(k >= 3, f"13c: last checkpoint step {k} < 3")
    kept = {s: (d / f"ckpt_{s:08d}.msgpack").read_bytes() for s in steps}
    walls = re.findall(r"round \d+: .*\[(\S+)\]$", "\n".join(lines), re.M)
    t0 = time.perf_counter()
    out = subprocess.run(cmd + ["--rounds", "2"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    resumed_s = time.perf_counter() - t0
    check(out.returncode == 0, f"13c: restart failed: {out.stderr[-2000:]}")
    check(f"from checkpoint step {k} (continuing at round {k}, uid {3 * k})"
          in out.stdout, f"13c: restart did not resume at step {k}")
    rounds = [int(r) for r in re.findall(r"round (\d+):", out.stdout)]
    check(rounds == [k, k + 1], f"13c: rounds after the restart {rounds}")
    check(f"next uid {3 * (k + 2)}" in out.stdout, "13c: next uid")
    after = sorted(int(p.stem.split("_")[1]) for p in d.glob("ckpt_*.msgpack"))
    check(after[-1] == k + 2 and after == list(range(after[0], k + 3)),
          f"13c: steps on disk after the restart {after}")
    for s in set(steps) & set(after):
        check((d / f"ckpt_{s:08d}.msgpack").read_bytes() == kept[s],
              f"13c: step {s} was rewritten")
    again = re.findall(r"round \d+: .*\[(\S+)\]$", out.stdout, re.M)
    say(f"kill-and-resume on cuda: killed after round 2 ({killed_s:.3f} s "
        f"from spawn; fresh-process round walls {walls}), broker {broker} "
        f"gone, last step {k}; restart resumed at round {k} "
        f"(uid {3 * k}), rounds {rounds}, steps {after}, none rewritten; "
        f"restart {resumed_s:.3f} s, round walls {again}")


def frontier_on_card(torch, VK) -> int:
    """Phase 13d: ``run --only frontier`` in this process on the card:
    every point equals results/BENCH_frontier.json but its wall, and so
    do the Pareto front and the three claims; B1 launched once per
    assimilated result, nothing else."""
    import contextlib
    import io
    from repro_torch.benchmarks import run as bench
    pin = json.loads((ROOT / "results" / "BENCH_frontier.json").read_text())
    VK.reset_launch_count()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, results = bench.run_cli(["--only", "frontier"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in VK.launch_counts().items() if v}
    for line in buf.getvalue().splitlines():
        say(f"bench {line}")
    res = results["frontier"]
    check(rc == 0 and all(res["_claims"].values()),
          f"frontier: rc {rc}, claims {res['_claims']}")
    for got, want in zip(res["points"], pin["points"]):
        strip = lambda p: {k: v for k, v in p.items() if k != "bench_wall_s"}
        check(strip(got) == strip(want),
              f"frontier {got['scenario']}: {got} != pin {want}")
        say(f"frontier {got['scenario']} on cuda: == pin but the wall; "
            f"wall {got['bench_wall_s']} s (pin's CPU wall "
            f"{want['bench_wall_s']} s)")
    check(len(res["points"]) == len(pin["points"])
          and res["pareto_front"] == pin["pareto_front"]
          and res["_claims"] == pin["_claims"], "frontier: front or claims")
    results_n = sum(p["results_assimilated"] for p in res["points"])
    check(counts == {"vc_asgd_lerp_flat": results_n},
          f"frontier: launches {counts}, {results_n} results")
    say(f"frontier on cuda: wall {res['_wall_s']:.3f} s, Pareto front "
        f"{res['pareto_front']}, claims 3/3, launches {counts}")
    return results_n


def _example(name: str, argv) -> str:
    import contextlib
    import importlib.util
    import io
    path = ROOT / "examples" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(mod.main(argv) == 0, f"{name} {argv} failed")
    return buf.getvalue()


def _trace_lines(out: str) -> list:
    """An example's printed lines with the accuracy columns taken out
    (the event trace stays)."""
    lines = []
    for ln in out.splitlines():
        ln = re.sub(r"^(\s*\d+\s+[\d.]+)\s+[\d.]+ ±\S+", r"\1", ln)
        ln = re.sub(r"final accuracy \S+ \|", "", ln)
        ln = re.sub(r"^(\s*\S+\s+[\d.]+)\s+[\d.]+(\s+\d+\s+\d+\s+[\d.]+)$",
                    r"\1\2", ln)
        lines.append(ln)
    return lines


def examples_and_cnn_on_card(torch, VK) -> None:
    """Phase 13e: both examples with --smoke on the card, their trace
    lines equal to the CPU runs'; CNNTask.client_train card vs CPU from
    one init and one set of draws within CNN_TOL, B3 once a step."""
    from repro_torch.core import flat as F
    from repro_torch.core.tasks import CNNTask, make_image_data
    for name in ("torch_quickstart.py", "torch_asgd_comparison.py"):
        VK.reset_launch_count()
        t0 = time.perf_counter()
        card = _example(name, ["--smoke"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in VK.launch_counts().items() if v}
        host = _example(name, ["--smoke", "--device", "cpu"])
        check(_trace_lines(card) == _trace_lines(host),
              f"{name}: trace card != cpu:\n{card}\n{host}")
        check(counts.get("vc_asgd_lerp_flat", 0) > 0
              and counts.get("adam_update_flat", 0) > 0,
              f"{name}: launches {counts}")
        say(f"{name} --smoke on cuda: trace == cpu, wall {wall:.3f} s, "
            f"launches {counts}")
        for ln in card.splitlines():
            if ln.strip():
                say(f"  {ln}")
    data = make_image_data(n_train=600, n_val=200)
    task = CNNTask()
    outs = {}
    for device in ("cuda", "cpu"):
        base = F.flatten(task.init_params(0, device=device))
        x = torch.from_numpy(data.x_train).to(device)
        y = torch.from_numpy(data.y_train).to(device, torch.int64)
        VK.reset_launch_count()
        t0 = time.perf_counter()
        outs[device] = task.client_train(base, x, y, steps=CNN_STEPS,
                                         seed=7).cpu()
        wall = time.perf_counter() - t0
        n = VK.launch_count("adam_update_flat")
        check(n == (CNN_STEPS if device == "cuda" else 0),
              f"CNNTask on {device}: {n} Adam launches")
        say(f"CNNTask.client_train on {device}: {CNN_STEPS} steps, "
            f"{wall:.3f} s, {n} B3 launches")
    diff = float((outs["cuda"] - outs["cpu"]).abs().max())
    check(bool(torch.isfinite(outs["cuda"]).all()) and diff <= CNN_TOL,
          f"CNNTask card vs cpu {diff} > {CNN_TOL}")
    say(f"CNNTask.client_train card vs cpu: max abs diff {diff:.3g} "
        f"(limit {CNN_TOL})")


# ---------------------------------------------------------------------------
# phase 14: LLM VC training on the card
# ---------------------------------------------------------------------------

# B13's backward against the autograd of its plain forward, per element:
# |kernel - plain| <= atol + rtol |plain|.  f32 (the SIMT route): every
# sum in f32 in another order (measured 1e-5 relative at [1, 8/2, 2048,
# 128]); bf16: the gradients are stored in bf16, o enters delta in bf16
# and the wgmma forward rounds P to bf16 (measured 1.3e-2 relative at hd
# 128); on the wgmma backward route (bf16 at hd 64 and 128) P and dS are
# also rounded to bf16 for their products: the limit its source derives
# from a CPU emulation, the same for q, k drawn at N(0,1) as here
BWD_TOL = {"float32": (5e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}
BWD_GROUPS, BWD_SQS, BWD_HDS, BWD_WINDOW = (1, 2, 4), (1, 63, 128, 2048), \
    (16, 64, 128), 48
# stablelm-3b's and gemma3-4b's head dims, at GQA groups 1 and 2
BWD_HDS_NEW, BWD_GROUPS_NEW = (80, 256), (1, 2)
# timed: internlm2's training step ([batch 8, 16/8 heads, seq 128, 128])
# and its prefill shape, and granite's training step (hd 64), bf16,
# causal; "train" is the main path's
BWD_TIMED = {"train": (8, 16, 8, 128, 128), "prefill": (4, 16, 8, 2048, 128),
             "granite train": (8, 16, 8, 128, 64),
             "stablelm train": (8, 32, 32, 128, 80),
             "gemma3 train": (8, 8, 4, 128, 256),
             "stablelm prefill": (4, 32, 32, 2048, 80),
             "gemma3 prefill": (4, 8, 4, 2048, 256)}
# whisper-tiny's training step (MHA 6 / 6, hd 64, not causal): (b, h,
# kvh, sq, skv, hd) of the encoder over 8 x 1,500 frames and the
# decoder's 128 rows against them in cross-attention
BWD_TIMED_WHISPER = {"whisper encoder train": (8, 6, 6, 1500, 1500, 64),
                     "whisper cross train": (8, 6, 6, 128, 1500, 64)}
# 14b: internlm2-1.8b at full width cut to 4 of its 24 layers (the full
# depth's flat round — islands, their Adam lanes, server, gradient and
# B3's outputs — needs ~68 GB before activations; the CPU's draw of the
# weights and the record's write and read, 12.6 GB at 4 layers, are most
# of the phase)
TRAIN_LAYERS = 4
TRAIN_PARAMS = 630_736_896       # 379,062,272 + 4 x 62,918,656
TRAIN_KW = dict(islands=2, local_steps=2, batch=8, seq=128, alpha="var",
                lr=1e-3, seed=0)
TRAIN_ROUNDS, TRAIN_PREEMPT, TRAIN_KILL = 4, 1, 3   # round 2 is index 1
# 14c: one round card vs CPU at full width, 2 layers, one island (two
# until PR 30: the CPU's round is most of the phase), batch 2 x 64.
# f32 compute: each step's gradient leaf by leaf, ||card - cpu|| / ||cpu||
# <= TRAIN_CMP_LEAF (f32 sums in other orders: cuBLAS without TF32, the
# card's SIMT attention forward and the backward kernel against the CPU's
# BLAS and plain attention; measured 5.1e-6), the global grad norm and
# the loss within TRAIN_CMP_F32; then the card's round again with a
# planted fault in the backward kernel's output (TRAIN_FAULTS), which the
# per-leaf check must refuse at the faulted projection of every layer.
# bf16 (the shipped compute): bf16 matmuls accumulate in other orders on
# the two devices and the card's attention rounds P to bf16 (the CPU's
# plain attention keeps f32); the loss averages 2 x 63 tokens, so
# within 0.02 of ~11.8; the global grad norm and each leaf's grad norm
# within TRAIN_CMP_GNORM relative (measured 7.4e-4 per leaf), each leaf
# within TRAIN_CMP_LEAF_BF16 as the f32 check measures it (measured 0.019)
TRAIN_CMP_LEAF, TRAIN_CMP_F32, TRAIN_CMP_ISLANDS = 1e-3, 1e-4, 1
# the vocabulary of every training card-vs-CPU check (14c, 15d, 16d) and
# of gemma3's serving one (16b), cut from the published 50,304-262,144
# since PR 32: no hand-written kernel reads it, the CPU's round is
# memory-bound on the flat bus, and the embedding and LM head were 46-78%
# of the 2-layer cuts' parameters (14c, 15d and 16d took 62, 165 and 97 s
# on a slow host, ~80% of it the CPU's rounds)
TRAIN_CMP_VOCAB = 16384
TRAIN_CMP_LOSS, TRAIN_CMP_GNORM, TRAIN_CMP_LEAF_BF16 = 0.02, 0.005, 0.1
TRAIN_FAULTS = {"dq = 0": (0, 0.0, "attn/wq"), "dk = 0": (1, 0.0, "attn/wk"),
                "dv = 0": (2, 0.0, "attn/wv"),
                "dq x 1.01": (0, 1.01, "attn/wq")}
# 14d: granite at full width and depth; mixtral at full width cut to 1
# layer (its card-vs-CPU check too: cut from 2 to hold the script's time),
# a prompt past its 4,096-token window
GRANITE_SERVE = (4, 2048, 96)
MIXTRAL_SERVE, MIXTRAL_LAYERS = (2, 6144, 32), 1
MOE_CMP_STEPS, MIXTRAL_CMP_PROMPT = 8, 128


def _grad_inputs(torch, dev, b, h, kvh, s, hd, dtype, seed, skv=None):
    """q / k / v as [b, s, h, hd] views (``skv`` keys, default s) and dO,
    N(0,1) in ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    skv = s if skv is None else skv
    q, k, v = (torch.randn(b, n_s, n, hd, generator=g, device=dev).to(dtype)
               .transpose(1, 2) for n_s, n in ((s, h), (skv, kvh), (skv, kvh)))
    do = torch.randn(b, h, s, hd, generator=g, device=dev).to(dtype)
    return q, k, v, do


def _bwd_share(torch, got, want, dt: str, label: str) -> tuple:
    """Checks each of ``got`` (dq, dk, dv) against ``want`` per element at
    BWD_TOL[dt]; returns (worst share of the limit, max abs err)."""
    atol, rtol = BWD_TOL[dt]
    worst, err = 0.0, 0.0
    for g_, w_ in zip(got, want):
        d = (g_.float() - w_.float()).abs()
        share = float((d / (atol + rtol * w_.float().abs())).max())
        check(share <= 1.0, f"{label}: max abs err {float(d.max())}, "
              f"{share:.3f} of its limit")
        worst, err = max(worst, share), max(err, float(d.max()))
    return worst, err


def attention_bwd_parity(torch, np, FK, R) -> dict:
    """Phase 14a: B13's backward against the autograd of its plain
    forward at every case of f32 / bf16 x causal / causal + window x GQA
    groups 1, 2, 4 x sq = skv in BWD_SQS x hd in BWD_HDS (and groups 1, 2
    at BWD_HDS_NEW), and at the BWD_TIMED shapes (the training path's own
    grid, causal) in both dtypes, q / k / v as transposed views of [b, s,
    h, hd] (the model's layout); each case run twice, bit-equal, on the
    route ``bwd_route`` picks (bf16 at hd 64, 80, 128 and 256: the wgmma
    kernel, csrc/flash_attention_bwd_sm90.cu; the rest: the SIMT kernel,
    csrc/flash_attention_bwd.cu), counted by ``route_counts``.  Then
    timed at BWD_TIMED (causal) and BWD_TIMED_WHISPER (not causal, sq
    and skv apart) beside the SIMT kernel on the same inputs, the
    plain formula (``ref.attention_bwd``, against which the timed outputs
    are checked too), SDPA's backward (the library yardstick, never
    called by the port) and the bound, with the wgmma kernel's device
    time from a CUDA graph (no host).  Returns the record of the training
    shape."""
    import math
    from repro_torch.benchmarks import wrapper_cost as WC
    dev = torch.device("cuda")
    grid = [(dt, window, 2, 2 * grp, 2, sq, hd)
            for dt in ("float32", "bfloat16") for window in (None, BWD_WINDOW)
            for grp in BWD_GROUPS for sq in BWD_SQS for hd in BWD_HDS]
    grid += [(dt, window, 2, 2 * grp, 2, sq, hd)
             for dt in ("float32", "bfloat16")
             for window in (None, BWD_WINDOW) for grp in BWD_GROUPS_NEW
             for sq in BWD_SQS for hd in BWD_HDS_NEW]
    grid = [(dt, w, 1 if sq > 1024 else b, h, kvh, sq, hd)
            for dt, w, b, h, kvh, sq, hd in grid]
    grid += [(dt, None) + shape for shape in BWD_TIMED.values()
             for dt in ("float32", "bfloat16")]
    worst, routes = {}, {}
    for cases, (dt, window, b, h, kvh, sq, hd) in enumerate(grid):
        q, k, v, do = _grad_inputs(torch, dev, b, h, kvh, sq, hd,
                                   getattr(torch, dt), cases)
        kw = dict(causal=True, window=window)
        o = FK.flash_attention(q, k, v, **kw)
        LA.reset_launch_count()
        got = FK.flash_attention_bwd(q, k, v, o, do, **kw)
        again = FK.flash_attention_bwd(q, k, v, o, do, **kw)
        route = FK.bwd_route(q)
        check_attn_route(2, route, f"B13 bwd {dt} hd {hd}",
                         "flash_attention_bwd")
        routes[route] = routes.get(route, 0) + 1
        req = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(R.attention(*req, **kw), req, do.float())
        torch.cuda.synchronize()
        label = (f"B13 bwd {dt} window={window} [{b},{h}/{kvh},{sq},{hd}]")
        for g_, a_ in zip(got, again):
            check(bits_equal(torch, g_, a_), f"{label}: two runs differ")
        share, err = _bwd_share(torch, got, want, dt, label)
        if share > worst.get((dt, route), (0.0,))[0]:
            worst[dt, route] = (share, err, label)
        del q, k, v, do, o, got, again, req, want
    torch.cuda.empty_cache()
    for (dt, route), (share, err, label) in worst.items():
        atol, rtol = BWD_TOL[dt]
        say(f"B13 bwd parity {dt}, route {route}: worst {share:.3f} of the "
            f"limit (atol {atol:g} + rtol {rtol:g} |plain|), max abs err "
            f"{err:.4g} at {label}")
    say(f"B13 bwd parity: {len(grid)} cases held to the plain forward's "
        f"autograd, each bit-equal run to run; cases by route {routes}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = None
    timed = {name: (b, h, kvh, s, s, hd, True)
             for name, (b, h, kvh, s, hd) in BWD_TIMED.items()}
    timed.update({name: shape + (False,)
                  for name, shape in BWD_TIMED_WHISPER.items()})
    for name, (b, h, kvh, s, skv, hd, causal) in timed.items():
        q, k, v, do = _grad_inputs(torch, dev, b, h, kvh, s, hd,
                                   torch.bfloat16, 99, skv)
        kw = dict(causal=causal)
        lse = FK.lse_buffer(q)          # what FlashAttention saves
        o = FK.flash_attention(q, k, v, lse=lse, **kw)
        got = FK.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        plain = R.attention_bwd(q, k, v, o, do, **kw)
        _, err = _bwd_share(torch, got, plain, "bfloat16",
                            f"B13 bwd {name} vs ref.attention_bwd")
        simt = FK.flash_attention_bwd(q, k, v, o, do, kernel="simt", **kw)
        _bwd_share(torch, simt, plain, "bfloat16",
                   f"B13 bwd {name}, the SIMT kernel, vs ref.attention_bwd")
        del got, plain, simt
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        so = sdpa(qs, ks, vs, is_causal=causal, scale=1.0 / math.sqrt(hd),
                  enable_gqa=True)
        ops = 10 * hd * b * h * attn_pairs(np, s, skv, causal, None)
        nbytes = 2 * (4 * b * h * s * hd + 4 * b * kvh * skv * hd)
        t_mem, t_ops = nbytes / KB.HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
        rec = {"max_abs_err": err, "bound_ms": 1e3 * max(t_mem, t_ops),
               "bound_by": "bytes" if t_mem >= t_ops else "operations",
               "ms": KB.cuda_ms(lambda: FK.flash_attention_bwd(
                   q, k, v, o, do, lse=lse, **kw), 10),
               "plain_ms": KB.cuda_ms(lambda: R.attention_bwd(
                   q, k, v, o, do, **kw), 3),
               "library_ms": KB.cuda_ms(lambda: torch.autograd.grad(
                   so, (qs, ks, vs), do, retain_graph=True), 10)}
        fwd_ms = KB.cuda_ms(lambda: FK.flash_attention(q, k, v, **kw), 10)
        simt_ms = KB.cuda_ms(lambda: FK.flash_attention_bwd(
            q, k, v, o, do, kernel="simt", **kw), 3)
        dev_us = WC.graph_us(torch, lambda: FK.flash_attention_bwd(
            q, k, v, o, do, lse=lse, **kw), 20)
        shape = f"{s}" if s == skv else f"{s}x{skv}"
        say(f"B13 bwd {name} [{b},{h}/{kvh},{shape},{hd}] bf16 "
            f"{'causal' if causal else 'not causal'}, route "
            f"{FK.bwd_route(q)}: kernel {rec['ms']:.4f} ms (device "
            f"{dev_us / 1e3:.4f} ms in a CUDA graph; forward {fwd_ms:.4f} "
            f"ms, route {FK.route(q)}), the SIMT kernel {simt_ms:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, SDPA backward "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}: {ops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB), {100 * rec['bound_ms'] / rec['ms']:.1f}"
            f"% of the bound ({100 * rec['bound_ms'] * 1e3 / dev_us:.1f}% of "
            f"it on the device time); max abs err vs plain {err:.4g}")
        del q, k, v, do, o, qs, ks, vs, so, lse
        torch.cuda.empty_cache()
        if out is None:
            out = rec
    return out


def _span(torch, spans: dict, owner, name: str, key: str):
    """Wrap ``owner.name`` so each call is timed on the host clock between
    two device synchronisations, summed into ``spans[key]``; returns the
    original."""
    fn = getattr(owner, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*a, **k)
        torch.cuda.synchronize()
        spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
        return res
    setattr(owner, name, timed)
    return fn


def train_full_width(torch, VK, tmp: Path, cfg, label: str, n_want: int,
                     per_step: dict, attn: int = 0, rounds=TRAIN_ROUNDS,
                     kill=TRAIN_KILL, profile: bool = True) -> dict:
    """Phases 14b, 15b, 15c: launch/train.py's ``train`` at ``cfg`` (a
    full width, its depth cut; ``n_want`` parameters, the port's init,
    seed 0), the launcher's defaults (2 islands, 2 local steps, batch 8 x
    128 tokens, var alpha), ``rounds`` rounds, island 0 preempted in round
    2.  Every step launches ``per_step`` (the mixers' kernels, forward
    with its remat recompute and backward; ``attn`` of them B13 forwards,
    each on the wgmma route, half as many B13 backwards) and B3 once; B2
    once a round.  With ``kill``, a checkpoint after round ``kill``, and a
    new ``train`` call resumes from that record (what a process killed
    after it would find): its last round must equal the run's bit for
    bit, loss and server bus.  Prints round walls, each step's time split
    (host clock between synchronisations: forward + backward, clip, B3; B2
    a round), tokens/s, launches and peak memory; then (``profile``) one
    step profiled.  Returns the run's launches."""
    import math
    import shutil
    from repro_torch.launch import train as LT
    from repro_torch.optim.optimizers import Adam
    from repro_torch.runtime import vc_runtime as VR
    ckdir = tmp / label.replace(" ", "_")
    shutil.rmtree(ckdir, ignore_errors=True)
    spans = {}
    wrapped = [(VR, "_lane_loss_and_grad", "forward+backward"),
               (VR, "clip_by_global_norm", "clip"),
               (Adam, "update_flat", "B3 (Adam.update_flat)"),
               (VR, "assimilate_flat", "B2 (assimilate_flat)")]
    originals = [(o, n, _span(torch, spans, o, n, k)) for o, n, k in wrapped]
    torch.cuda.reset_peak_memory_stats()
    VK.reset_launch_count()
    t0 = time.perf_counter()
    ck = dict(ckpt_dir=str(ckdir), ckpt_every=kill, keep=1) if kill else {}
    try:
        run = LT.train(cfg, rounds=rounds, preempt_round=TRAIN_PREEMPT,
                       device="cuda", log=lambda m: say(f"{label} {m}"),
                       **ck, **TRAIN_KW)
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    wall = time.perf_counter() - t0
    counts = VK.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = run.server.spec.n
    steps = TRAIN_KW["islands"] * TRAIN_KW["local_steps"] * rounds
    check(n_params == n_want, f"{label}: {n_params} parameters")
    want = {**dict.fromkeys(VK.KERNELS, 0),
            **{k: n * steps for k, n in per_step.items()},
            "adam_update_flat": steps, "assimilate_flat": rounds}
    check(counts == want, f"{label}: launches {counts}, want {want}")
    if attn:
        check_attn_route(attn * steps, "wgmma", label)
        check_attn_route(attn // 2 * steps, "wgmma", label,
                         "flash_attention_bwd")
    check(all(math.isfinite(r["loss"]) for r in run.rounds)
          and bool(torch.isfinite(run.server.buf).all()),
          f"{label}: a non-finite loss or server")
    tokens = TRAIN_KW["islands"] * TRAIN_KW["local_steps"] * \
        TRAIN_KW["batch"] * TRAIN_KW["seq"]
    say(f"{label} {cfg.describe()}, {n_params:,} parameters (f32 bus), "
        f"{TRAIN_KW['islands']} islands x {TRAIN_KW['local_steps']} steps "
        f"of {TRAIN_KW['batch']}x{TRAIN_KW['seq']} tokens a round")
    for r in run.rounds:
        say(f"{label} round {r['round'] + 1}: wall {r['wall_s']:.3f} s, "
            f"{tokens / r['wall_s']:.1f} tokens/s, loss {r['loss']:.6f}")
    for key, sec in spans.items():
        per = rounds if key.startswith("B2") else steps
        unit = "round" if key.startswith("B2") else "step"
        say(f"{label} {key}: {1e3 * sec / per:.3f} ms a {unit} (host clock "
            f"between synchronisations)")
    say(f"{label} launches per step: " + ", ".join(
        f"{k} {counts[k] / steps:g}" for k in per_step)
        + f" (remat included), B3 {counts['adam_update_flat'] / steps:g}; "
        f"B2 per round {counts['assimilate_flat'] / rounds:g}")
    say(f"{label} peak device memory (max_memory_allocated) "
        f"{peak / 1e9:.3f} GB; train() wall {wall:.3f} s (init"
        + (f" and the round-{kill} checkpoint's write" if kill else "")
        + " included)")
    server = run.server
    if kill:
        # the kill: a process that stopped after round `kill` leaves this
        recs = sorted(p.name for p in ckdir.iterdir())
        check(recs == [f"ckpt_{kill:08d}.msgpack"],
              f"{label}: records {recs}")
        size = (ckdir / recs[0]).stat().st_size
        clean_loss, clean_bus = run.rounds[-1]["loss"], run.server.buf
        del run, server
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = LT.train(cfg, rounds=rounds, ckpt_dir=str(ckdir),
                           ckpt_every=kill, keep=1,
                           preempt_round=TRAIN_PREEMPT, device="cuda",
                           log=lambda m: say(f"{label} resume {m}"),
                           **TRAIN_KW)
        rwall = time.perf_counter() - t0
        check(resumed.start_round == kill and len(resumed.rounds) == 1,
              f"{label} resume: started at {resumed.start_round}")
        check(resumed.rounds[0]["loss"] == clean_loss,
              f"{label} resume: round {rounds} loss "
              f"{resumed.rounds[0]['loss']} != {clean_loss}")
        check(bits_equal(torch, resumed.server.buf, clean_bus),
              f"{label} resume: server bus differs from the run's")
        say(f"{label} kill after round {kill} and resume: round {rounds} "
            f"loss {clean_loss!r} and the server bus ({clean_bus.numel():,} "
            f"f32) bit-equal; record {size / 1e9:.3f} GB (server + 2 "
            f"islands' m and v); resume wall {rwall:.3f} s (load included)")
        server = resumed.server
        del resumed, clean_bus
    else:
        del run
    if profile:
        profile_train_step(torch, cfg, server, label)
    del server
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def profile_train_step(torch, cfg, server, label: str) -> None:
    """One island's local step and its round's B2 from ``server`` (a round
    of ``make_vc_round`` with 1 island x 1 step, the 14b batch), warm
    once, then under torch.profiler: the device-busy share and the top
    device and host items of a training step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import _round_batches
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizers import Adam
    from repro_torch.runtime import vc_runtime as VR
    batches = _round_batches(cfg, 1, 1, TRAIN_KW["batch"], TRAIN_KW["seq"],
                             seed=1)
    vc_round = VR.make_vc_round(build_model(cfg), 1, 1, Adam(lr=1e-3))
    isl, opts = VR.init_islands(server, 1, Adam(lr=1e-3))
    go = lambda: vc_round(server, isl, opts, batches, 0.5, [True])
    go()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, f"{label} step + B2 (1 island x 1 step of "
                   f"{TRAIN_KW['batch']}x{TRAIN_KW['seq']}, profiled wall "
                   f"{wall:.3f} s)", wall)
    del isl, opts
    torch.cuda.empty_cache()


def _leaf_names(tree, path: str = "") -> list:
    """The leaf paths of a parameter tree in ``tree_flatten``'s order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree)
                for n in _leaf_names(x, f"{path}[{i}]")]
    return [path]


def _cmp_round(torch, VK, model, master, batches, dev: str) -> dict:
    """One round of ``make_vc_round`` (an island a row of ``batches``, 1
    step each) from ``master`` on ``dev``: the mean loss, each step's
    global grad norm and flat
    gradient before the clip (a copy on ``dev``), the server bus (on the
    host), the launches and the wall."""
    from repro_torch.optim.optimizers import Adam
    from repro_torch.runtime import vc_runtime as VR
    n = master.spec.n
    grads, norms = [], []
    real = VR.clip_by_global_norm

    def spy(g, max_norm):
        grads.append(g[:n].clone())
        res = real(g, max_norm)
        norms.append(float(res[1]))
        return res
    VR.clip_by_global_norm = spy
    VK.reset_launch_count()
    t0 = time.perf_counter()
    try:
        n_isl = int(batches["tokens"].shape[0])
        server = master.with_buf(master.buf.to(dev))
        isl, opts = VR.init_islands(server, n_isl, Adam(lr=1e-3))
        s, isl, opts, m = VR.make_vc_round(model, n_isl, 1, Adam(lr=1e-3))(
            server, isl, opts, batches, 0.5, [True] * n_isl)
        loss = float(m["loss"])
    finally:
        VR.clip_by_global_norm = real
    out = {"loss": loss, "norms": norms, "grads": grads, "bus": s.buf.cpu(),
           "launches": VK.launch_counts(), "wall": time.perf_counter() - t0}
    del server, isl, opts, s
    return out


def _leaf_diffs(torch, spec, got: list, want: list) -> tuple:
    """Per leaf, over the round's steps: the worst ||got - want|| /
    ||want|| and the worst | ||got|| - ||want|| | / ||want||."""
    lv = torch.linalg.vector_norm
    rel, rel_norm = [0.0] * spec.num_leaves, [0.0] * spec.num_leaves
    for g, w in zip(got, want):
        for i, (o, n) in enumerate(zip(spec.offsets, spec.sizes)):
            a, b = g[o:o + n], w[o:o + n]
            wn = float(lv(b))
            rel[i] = max(rel[i], float(lv(a - b)) / wn)
            rel_norm[i] = max(rel_norm[i], abs(float(lv(a)) - wn) / wn)
    return rel, rel_norm


def train_card_vs_cpu(torch, VK, cut, label: str, per_step: dict,
                      faults: dict, bf16=None, seq: int = 64,
                      show: tuple = ()) -> None:
    """Phases 14c, 15d, 16d and 17b-c: one round of ``make_vc_round``
    (TRAIN_CMP_ISLANDS islands x 1 step, batch 2 x ``seq`` tokens, a
    VLM's patches among them, whisper's frames beside them) at ``cut``
    (a full width cut to a few layers, its vocabulary to
    TRAIN_CMP_VOCAB), on the card and on the CPU from
    one set of weights (the port's init, drawn once); the card launches
    ``per_step`` a step (and B3, B2), the CPU nothing.  In f32 compute
    each step's gradient is held to the CPU's leaf by leaf
    (TRAIN_CMP_LEAF), and each planted fault of ``faults`` in a backward
    kernel's output must fail that check at its leaf in every layer.  In
    the shipped bf16 compute the mean loss within TRAIN_CMP_LOSS, and then
    with ``bf16`` (grad norms, per leaf) the global and each leaf's grad
    norm and each leaf's gradient within those bounds of the CPU's bf16
    round; without it, each leaf's gradient no farther from the CPU's f32
    gradient than TRAIN_CMP_NOISE times the CPU's own bf16 gradient is
    (plus TRAIN_CMP_LEAF): the card's bf16 round adds no error beyond
    bf16's own rounding.  ``show``: leaf-name suffixes whose f32
    per-leaf distance is printed."""
    from repro_torch.core import flat as F
    from repro_torch.launch.train import _round_batches
    from repro_torch.models.registry import build_model
    cut = cut.replace(vocab_size=TRAIN_CMP_VOCAB)
    init = build_model(cut).init(0, device="cpu")
    names = _leaf_names(init)
    master = F.flatten(init)
    del init
    spec = master.spec
    islands = TRAIN_CMP_ISLANDS
    batches = _round_batches(cut, islands, 1, 2, seq, seed=0)
    want = {**dict.fromkeys(VK.KERNELS, 0),
            **{k: islands * n for k, n in per_step.items()},
            "adam_update_flat": islands, "assimilate_flat": 1}
    cpu_f32 = None
    for dt in ("float32", "bfloat16"):
        model = build_model(cut.replace(compute_dtype=dt))
        card = _cmp_round(torch, VK, model, master, batches, "cuda")
        cpu = _cmp_round(torch, VK, model, master, batches, "cpu")
        cpu["grads"] = [g.cuda() for g in cpu["grads"]]
        check(card["launches"] == want,
              f"{label} {dt}: card launches {card['launches']}")
        check(sum(cpu["launches"].values()) == 0,
              f"{label} {dt}: cpu launched {cpu['launches']}")
        check(all(bool(torch.isfinite(g).all()) for g in card["grads"])
              and bool(torch.isfinite(card["bus"]).all()),
              f"{label} {dt}: non-finite gradient or server")
        rel, rel_norm = _leaf_diffs(torch, spec, card["grads"], cpu["grads"])
        gl, cl, gn, cn = card["loss"], cpu["loss"], card["norms"], \
            cpu["norms"]
        grel = max(abs(a - b) / b for a, b in zip(gn, cn))
        i, j = max(range(len(rel)), key=rel.__getitem__), \
            max(range(len(rel)), key=rel_norm.__getitem__)
        say(f"{label} {cut.describe()} {dt}, {islands} island(s) x 1 step "
            f"of 2x{seq}: "
            f"loss card {gl:.6f} cpu {cl:.6f} (|diff| {abs(gl - cl):.4g}); "
            f"grad norms card {gn} cpu {cn} (max relative diff "
            f"{grel:.4g}); per leaf worst ||card - cpu|| / ||cpu|| "
            f"{rel[i]:.4g} ({names[i]}), worst relative grad-norm diff "
            f"{rel_norm[j]:.4g} ({names[j]}); server bus max abs diff "
            f"{float((card['bus'] - cpu['bus']).abs().max()):.4g}; wall "
            f"card {card['wall']:.2f} s, cpu {cpu['wall']:.2f} s")
        if dt == "float32":
            for k, n in enumerate(names):
                if n.endswith(show) and show:
                    say(f"{label} f32 {n}: ||card - cpu|| / ||cpu|| "
                        f"{rel[k]:.4g} (bound {TRAIN_CMP_LEAF})")
            bad = [names[k] for k, r in enumerate(rel) if r > TRAIN_CMP_LEAF]
            check(not bad, f"{label} f32: gradient leaves past "
                  f"{TRAIN_CMP_LEAF}: {bad}")
            check(abs(gl - cl) <= TRAIN_CMP_F32 and grel <= TRAIN_CMP_F32,
                  f"{label} f32: loss {gl} vs {cl}, grad norms {gn} vs "
                  f"{cn}")
            _planted_faults(torch, VK, model, master, batches, names,
                            cpu["grads"], faults, label)
            cpu_f32 = cpu["grads"]
        else:
            check(abs(gl - cl) <= TRAIN_CMP_LOSS,
                  f"{label} bf16: loss {gl} vs {cl}")
            if bf16 is not None:
                gnorm, leaf = bf16
                bad = [names[k] for k in range(len(rel))
                       if rel_norm[k] > gnorm or rel[k] > leaf]
                check(grel <= gnorm and not bad,
                      f"{label} bf16: grad norms {gn} vs {cn}; leaves past "
                      f"their bounds: {bad}")
            else:
                d_card, _ = _leaf_diffs(torch, spec, card["grads"], cpu_f32)
                d_cpu, _ = _leaf_diffs(torch, spec, cpu["grads"], cpu_f32)
                lim = [TRAIN_CMP_NOISE * c + TRAIN_CMP_LEAF for c in d_cpu]
                k = max(range(len(lim)), key=lambda k: d_card[k] / lim[k])
                say(f"{label} bf16 against the CPU's f32 gradient, per leaf: "
                    f"card {max(d_card):.4g}, the CPU's bf16 "
                    f"{max(d_cpu):.4g}; worst {d_card[k]:.4g} of its limit "
                    f"{lim[k]:.4g} ({names[k]})")
                bad = [names[k] for k in range(len(lim)) if d_card[k] > lim[k]]
                check(not bad, f"{label} bf16: leaves farther from the f32 "
                      f"gradient than {TRAIN_CMP_NOISE} x the CPU's bf16: "
                      f"{bad}")
        del card, cpu
    bounds = (f"grad norms (global and per leaf) {bf16[0]}, per-leaf "
              f"{bf16[1]}" if bf16 is not None else
              f"per leaf to the f32 gradient {TRAIN_CMP_NOISE} x the CPU's "
              f"bf16 + {TRAIN_CMP_LEAF}")
    say(f"{label}: bounds f32 per-leaf {TRAIN_CMP_LEAF}, loss and grad norm "
        f"{TRAIN_CMP_F32}; bf16 loss {TRAIN_CMP_LOSS}, {bounds}")
    del cpu_f32
    torch.cuda.empty_cache()


def _planted_faults(torch, VK, model, master, batches, names: list,
                    cpu_grads: list, faults: dict, label: str) -> None:
    """The f32 card round again with each fault of ``faults`` planted in
    a backward kernel's output (``{label: (module, wrapper name, output
    index, scale, leaf suffix, layers)}``: the launch runs, that output is
    then scaled): the per-leaf check must refuse the faulted leaf of every
    one of its ``layers`` layers."""
    for fault, (mod, fn, which, scale, leaf, layers) in faults.items():
        real = getattr(mod, fn)

        def faulty(*a, which=which, scale=scale, real=real, **k):
            out = list(real(*a, **k))
            out[which] = out[which] * scale
            return tuple(out)
        setattr(mod, fn, faulty)
        try:
            run = _cmp_round(torch, VK, model, master, batches, "cuda")
        finally:
            setattr(mod, fn, real)
        rel, _ = _leaf_diffs(torch, master.spec, run["grads"], cpu_grads)
        hit = [k for k, n in enumerate(names) if n.endswith(f"/{leaf}")]
        caught = [n for k, n in enumerate(names) if rel[k] > TRAIN_CMP_LEAF]
        check(len(hit) == layers
              and all(rel[k] > TRAIN_CMP_LEAF for k in hit),
              f"{label} planted fault {fault}: {leaf} not refused "
              f"({[rel[k] for k in hit]})")
        say(f"{label} planted fault {fault}: refused; {leaf} per-leaf "
            f"{[round(rel[k], 6) for k in hit]} (bound {TRAIN_CMP_LEAF}); "
            f"{len(caught)} of {len(names)} leaves past the bound")
        del run


def prefill_attn(cfg) -> int:
    """B13 launches a prefill: one an attention layer; an
    encoder-decoder's encoder layers and its decoder's self- and
    cross-attention each."""
    if cfg.is_enc_dec:
        return cfg.encoder.n_layers + 2 * cfg.n_layers
    return cfg.n_layers


def _serve_lm(torch, VK, cfg, shape, route: str, label: str,
              profile: bool = False) -> dict:
    """serve.serve at ``cfg`` (batch, prompt, decode steps = ``shape``):
    one B13 launch an attention layer in prefill (``prefill_attn``), all
    on ``route``, none in decode, a compaction every 64 steps (none for an
    encoder-decoder, whose ring wraps), the decode positions of
    launch/serve.py; with ``profile``, the warm prefill again, timed and
    profiled (``profile_prefill``).  Returns the run's launches."""
    from repro_torch.launch import serve
    b, s, gen = shape
    zero = dict.fromkeys(VK.KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    VK.reset_launch_count()
    t0 = time.perf_counter()
    res = serve.serve(cfg, b, s, gen, seed=0, device="cuda")
    wall = time.perf_counter() - t0
    counts = VK.launch_counts()
    n_attn = prefill_attn(cfg)
    check_attn_route(n_attn, route, label)
    check(res.logits_finite, f"{label}: non-finite logits")
    check(tuple(res.tokens.shape) == (b, gen + 1)
          and int(res.tokens.max()) < cfg.vocab_size
          and int(res.tokens.min()) >= 0, f"{label}: tokens out of range")
    check(res.launches_prefill == {**zero, "flash_attention": n_attn},
          f"{label}: prefill launches {res.launches_prefill}")
    check(res.launches_decode == zero,
          f"{label}: decode launches {res.launches_decode}")
    check(res.compactions == (0 if cfg.is_enc_dec else gen // 64),
          f"{label}: {res.compactions} compactions")
    prefix = cfg.vision.n_patches if cfg.vision is not None else 0
    check(res.next_pos == s + prefix + gen - 1,
          f"{label}: the last token at position {res.next_pos}")
    n_params = sum(t.numel() for t in _leaves(res.params))
    step_s = (res.decode_s - res.compact_s) / gen
    cache = res.caches.self_cache[0] if cfg.is_enc_dec else res.caches[0]
    if cfg.is_enc_dec:          # the ring wrapped: the last 64 positions
        want = list(range(max(s, s + gen - 64), s + gen))
        check(sorted(int(p) for p in cache.rec_pos if p >= 0) == want,
              f"{label}: the ring holds {cache.rec_pos.tolist()}")
    spec = cfg.all_blocks[0]
    slots = cache.k_old.shape[2] * cache.k_old.shape[3]
    check(slots == (min(s, spec.window) if spec.attn_kind == "swa" else s),
          f"{label}: the old tier holds {slots} slots")
    say(f"{label} {cfg.describe()}, {n_params:,} parameters; init "
        f"{res.init_s:.3f} s")
    say(f"{label} prefill {b}x{s}: {1e3 * res.prefill_s:.3f} ms, "
        f"{b * s / res.prefill_s:.1f} tok/s; B13 launches {n_attn} (route "
        f"{route}); old-tier cache {slots} slots")
    say(f"{label} decode {gen} steps: {1e3 * step_s:.3f} ms/step without "
        f"compaction, {b * gen / res.decode_s:.1f} tok/s; compactions "
        f"{res.compactions}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; wall {wall:.3f} s")
    if profile:
        profile_prefill(torch, res, b, s)
    del res
    torch.cuda.empty_cache()
    return counts


def serve_moe_on_card(torch, VK) -> None:
    """Phase 14d: the MoE family served.  granite-moe-1b-a400m at full
    width and depth (batch 4 x 2,048 prompt, 96 decode steps: its hd 64
    takes B13's wgmma route in bf16); mixtral-8x7b at full width cut to
    MIXTRAL_LAYERS (batch 2 x a 6,144-token prompt, past its 4,096-token
    window: the old tier holds the window; 32 decode steps slide it).
    Then each at full width card vs CPU as 6c does (the CPU fed the card's
    MoE routes), granite at 2 layers, mixtral at MIXTRAL_LAYERS with a
    128-token prompt and 8 decode steps (its decode gathers whole
    14,336-wide experts, slow on the CPU)."""
    from repro_torch.configs import get_config
    granite = get_config("granite-moe-1b-a400m")
    _serve_lm(torch, VK, granite, GRANITE_SERVE, "wgmma", "granite serve")
    mixtral = depth_cut("mixtral-8x7b", MIXTRAL_LAYERS)
    _serve_lm(torch, VK, mixtral, MIXTRAL_SERVE, "wgmma", "mixtral serve")
    serve_card_vs_cpu(torch, VK, depth_cut("granite-moe-1b-a400m"),
                      {"flash_attention": CMP_LAYERS}, ATTN_ROUTES)
    serve_card_vs_cpu(torch, VK, mixtral,
                      {"flash_attention": MIXTRAL_LAYERS},
                      ATTN_ROUTES, prompt=MIXTRAL_CMP_PROMPT,
                      steps=MOE_CMP_STEPS)


# ---------------------------------------------------------------------------
# phase 15: rwkv6 and jamba VC training on the card
# ---------------------------------------------------------------------------

# B14's and B15's backward kernels against their plain backwards
# (ref.wkv6_bwd / ref.mamba_scan_bwd), per element: |kernel - plain| <=
# atol + rtol |plain|, atol SCAN_BWD_TOL[0] times the output's largest
# |plain| (f32 sums in other orders: the states from the forward's chunk
# checkpoints, the row and column sums by butterflies and warps; the
# cuda tests' bound); du in bf16 within SCAN_BWD_BF16 (one bf16 ulp)
SCAN_BWD_TOL, SCAN_BWD_BF16 = (1e-5, 1e-4), 2e-2
# B14's backward: (b, h, T, hd, share of exact-0 decays); [b, T, h, hd]
# strided views (the model's), the training shape (rwkv6-1.6b, 8 x 128)
# first, its record; it and the long shape (b * h = 128 < 132 SMs) timed
WKV_BWD_SHAPES = {
    "a rwkv6 train": (8, 32, 128, 64, 0.0),
    "b T=63 hd16": (2, 4, 63, 16, 0.3), "c T=128 hd16": (2, 4, 128, 16, 0.0),
    "d T=300 hd16": (2, 4, 300, 16, 0.3), "e T=63": (2, 4, 63, 64, 0.3),
    "f T=300": (2, 4, 300, 64, 0.3), "g long": (4, 32, 2048, 64, 0.0),
}
# B15's backward: (b, T, di, ds, u dtype); B / C column views of an
# x_proj output; the training shape (jamba, 8 x 128, bf16) first, its
# record; it and the long shape timed
SCAN_BWD_SHAPES = {
    "a jamba train": (8, 128, 8192, 16, "bfloat16"),
    "b ds16 ragged f32": (2, 63, 200, 16, "float32"),
    "c ds16 ragged bf16": (2, 300, 100, 16, "bfloat16"),
    "d ds4 f32": (2, 37, 130, 4, "float32"),
    "e ds4 bf16": (2, 128, 37, 4, "bfloat16"),
    "f long": (2, 2048, 8192, 16, "bfloat16"),
}
SCAN_BWD_TIMED = ("a rwkv6 train", "g long", "a jamba train", "f long")
# 15b: rwkv6-1.6b at full width cut to 4 of its 24 layers, as 14b;
# 14b's launcher defaults, rounds, preemption and kill; 268,439,552 + 4
# x 55,474,176 parameters
RWKV_TRAIN_LAYERS, RWKV_TRAIN_PARAMS = 4, 490_336_256
# 15c: jamba-v0.1 at full width, blocks (0, 2, 4) of its period (mamba +
# dense twice, attention + dense), 2 rounds
JAMBA_TRAIN_BLOCKS, JAMBA_TRAIN_PARAMS = (0, 2, 4), 1_317_941_248
JAMBA_TRAIN_ROUNDS = 2
# 15d: card vs CPU, rwkv6 layers 0-1 and jamba block 2 (mamba + dense;
# blocks (2, 4) until PR 32: B13's backward is held card vs CPU in 14c
# and 16d), one island as 14c; f32 as 14c; bf16: the loss as 14c, and
# each leaf's
# gradient no farther from the CPU's f32 gradient than TRAIN_CMP_NOISE
# times the CPU's own bf16 gradient is (rwkv6's bf16 gradients of the
# small leaves, u above all, carry bf16's rounding: card vs CPU in bf16
# 0.15 at u, 1.4% on the global norm, where f32 agrees to 2.9e-5)
JAMBA_TRAIN_CMP_BLOCKS, TRAIN_CMP_NOISE = (2,), 2.0


def _bwd_check(torch, got, want, names, label: str) -> float:
    """Each of ``got`` against ``want`` per element (SCAN_BWD_TOL; a bf16
    output within SCAN_BWD_BF16); returns the max abs err."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        check(g.shape == w.shape and g.dtype == w.dtype
              and bool(torch.isfinite(g).all()),
              f"{label}: d{name} {g.dtype} {tuple(g.shape)}, not finite or "
              f"not {w.dtype} {tuple(w.shape)}")
        g, w = g.float(), w.float()
        d = (g - w).abs()
        atol = SCAN_BWD_TOL[0] * max(float(w.abs().max()), 1.0)
        lim = atol + SCAN_BWD_TOL[1] * w.abs()
        err = float(d.max())
        check(bool((d <= lim).all()), f"{label}: d{name} max abs err {err}")
        worst = max(worst, err)
    return worst


def wkv6_bwd_parity(torch, WK, R) -> dict:
    """Phase 15a: B14's backward (csrc/wkv6_bwd.cu) from the forward's
    chunk states against ``ref.wkv6_bwd`` at WKV_BWD_SHAPES, each run
    twice, bit-equal; then timed at the training and long shapes beside
    the bound (the training shape also beside the plain backward), and
    the CTAs an SM holds.  Returns the record of the training shape."""
    dev = torch.device("cuda")
    out = None
    per_sm = WK._library("wkv6_bwd").wkv6_bwd_blocks_per_sm(64)
    say(f"B14 bwd at hd 64: {per_sm} CTAs an SM of 256 threads "
        f"({8 * per_sm} warps), clusters of 4 CTAs a (b, h)")
    for name, (b, h, T, hd, zeros) in WKV_BWD_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(T + hd)
        rnd = lambda: torch.randn(b, T, h, hd, generator=g, device=dev)
        r, k, v = rnd() * 0.4, rnd() * 0.4, rnd()
        w = torch.sigmoid(rnd()) * 0.6 + 0.35
        if zeros:
            hit = torch.rand(b, T, h, hd, generator=g, device=dev) < zeros
            w = torch.where(hit, torch.zeros((), device=dev), w)
        r, k, v, w = (t.transpose(1, 2) for t in (r, k, v, w))
        u = torch.randn(h, hd, generator=g, device=dev) * 0.2
        do = torch.randn(b, h, T, hd, generator=g, device=dev)
        states = WK.chunk_states(r)
        WK.wkv6(r, k, v, w, u, states=states)
        got = WK.wkv6_bwd(r, k, v, w, u, do, states)
        again = WK.wkv6_bwd(r, k, v, w, u, do, states)
        torch.cuda.synchronize()
        label = f"B14 bwd {name} [{b},{h},{T},{hd}]"
        check(all(bits_equal(torch, x, y) for x, y in zip(got, again)),
              f"{label}: two runs differ")
        err = _bwd_check(torch, got, R.wkv6_bwd(r, k, v, w, u, do), "rkvwu",
                         label)
        say(f"{label} f32, {zeros:.0%} zero decays: max abs err {err:.3g} "
            f"vs the plain backward; bit-equal run to run")
        del got, again
        if name in SCAN_BWD_TIMED:
            n = b * h * T * hd
            nch = -(-T // WK.CHUNK)
            nbytes = 4 * (9 * n + b * h * nch * hd * hd + 2 * h * hd)
            ops = 12 * n * hd      # 6 FMAs per (i, j) and step
            bound, by = bound_ms(nbytes, ops)
            ms = KB.cuda_ms(lambda: WK.wkv6_bwd(r, k, v, w, u, do, states),
                            10)
            fwd = KB.cuda_ms(lambda: WK.wkv6(r, k, v, w, u, states=states),
                             10)
            rec = {"max_abs_err": err, "bound_ms": bound, "bound_by": by,
                   "ms": ms, "plain_ms": None,
                   "library_ms": None}   # no PyTorch call computes it
            if out is None:
                rec["plain_ms"] = KB.cuda_ms(lambda: R.wkv6_bwd(
                    r, k, v, w, u, do), 1)
                out = rec
            plain = ("not timed" if rec["plain_ms"] is None
                     else f"{rec['plain_ms']:.4f} ms")
            say(f"{label} timed: kernel {ms:.4f} ms (the forward "
                f"writing its chunk states {fwd:.4f} ms), plain {plain}, "
                f"library none, bound {bound:.4f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), "
                f"{100 * bound / ms:.1f}% of it")
        del r, k, v, w, u, do, states
    torch.cuda.empty_cache()
    return out


def mamba_scan_bwd_parity(torch, MK, R) -> dict:
    """Phase 15a: B15's backward (csrc/mamba_scan_bwd.cu) from the
    forward's chunk states against ``ref.mamba_scan_bwd`` at
    SCAN_BWD_SHAPES, each run twice, bit-equal; then timed at the training
    and long shapes beside the bound (bytes, one exp a state-step and the
    FMAs side by side; the training shape also beside the plain
    backward), and the CTAs an SM holds.  Returns the record of the
    training shape."""
    dev = torch.device("cuda")
    exp_rate = sfu_exps_per_s(torch)
    out = None
    lib = MK._library("mamba_scan_bwd")
    per_sm = lib.mamba_scan_bwd_blocks_per_sm(16, 1)
    say(f"B15 bwd at ds 16, u bf16: {per_sm} CTAs an SM of 128 threads "
        f"({4 * per_sm} warps), clusters of {MK._BWD_CLUSTER} CTAs")
    for name, (b, T, di, ds, dt) in SCAN_BWD_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(T + di + ds)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
        dtype = getattr(torch, dt)
        u = (rnd(b, T, di) * 0.4).to(dtype)
        dts = torch.nn.functional.softplus(rnd(b, T, di))
        xdbc = rnd(b, T, 256 + 2 * ds) * 0.4
        B, C = xdbc[..., 256:256 + ds], xdbc[..., 256 + ds:]
        A = -torch.exp(rnd(di, ds) * 0.3)
        D = rnd(di)
        dy = rnd(b, T, di).to(dtype)
        args = (u, dts, B, C, A, D)
        h_ck = MK.chunk_states(u, ds)
        MK.mamba_scan(*args, h_ck=h_ck)
        got = MK.mamba_scan_bwd(*args, dy, h_ck)
        again = MK.mamba_scan_bwd(*args, dy, h_ck)
        torch.cuda.synchronize()
        label = f"B15 bwd {name} [{b},{T},{di}] ds {ds} u {dt}"
        check(all(bits_equal(torch, x, y) for x, y in zip(got, again)),
              f"{label}: two runs differ")
        want = R.mamba_scan_bwd(*args, dy)
        names = ["u", "dt", "B", "C", "A", "D"]
        err = 0.0
        if dtype == torch.bfloat16:
            d = (got[0].float() - want[0].float()).abs()
            err = float(d.max())
            check(bool((d <= SCAN_BWD_BF16 * (1 + want[0].float().abs()))
                       .all()), f"{label}: du (bf16) max abs err {err}")
            got, want, names = got[1:], want[1:], names[1:]
        err = max(err, _bwd_check(torch, got, want, names, label))
        say(f"{label}: max abs err {err:.3g} vs the plain backward; "
            f"bit-equal run to run")
        del got, again, want
        if name in SCAN_BWD_TIMED:
            n, es = b * T * di, u.element_size()
            nch = -(-T // MK.CHUNK)
            nbytes = (3 * es * n + 4 * 2 * n + 4 * 4 * b * T * ds
                      + 4 * b * nch * di * ds + 4 * 2 * (di * ds + di))
            t_mem = nbytes / KB.HBM_BYTES_PER_S
            t_exp = n * ds / exp_rate          # a_t, once a state-step
            t_fma = 20 * n * ds / F32_OPS_PER_S   # ~10 FMAs a state-step
            bound = 1e3 * max(t_mem, t_exp, t_fma)
            ms = KB.cuda_ms(lambda: MK.mamba_scan_bwd(*args, dy, h_ck), 10)
            fwd = KB.cuda_ms(lambda: MK.mamba_scan(*args, h_ck=h_ck), 10)
            rec = {"max_abs_err": err, "bound_ms": bound,
                   "bound_by": "bytes" if t_mem >= max(t_exp, t_fma)
                   else "operations", "ms": ms, "plain_ms": None,
                   "library_ms": None}   # no PyTorch call computes it
            if out is None:
                rec["plain_ms"] = KB.cuda_ms(lambda: R.mamba_scan_bwd(
                    *args, dy), 1)
                out = rec
            plain = ("not timed" if rec["plain_ms"] is None
                     else f"{rec['plain_ms']:.4f} ms")
            say(f"{label} timed: kernel {ms:.4f} ms (the forward "
                f"writing its chunk states {fwd:.4f} ms), plain {plain}, "
                f"library none, bound {bound:.4f} ms ({rec['bound_by']}: "
                f"bytes {nbytes / 1e6:.1f} MB {1e3 * t_mem:.4f} ms "
                f"({100 * 1e3 * t_mem / ms:.1f}% of the kernel), one exp a "
                f"state-step {n * ds / 1e9:.3f} G exps {1e3 * t_exp:.4f} ms "
                f"({100 * 1e3 * t_exp / ms:.1f}%), {20 * n * ds / 1e9:.2f} "
                f"GFLOP {1e3 * t_fma:.4f} ms), {100 * bound / ms:.1f}% of "
                f"the bound")
        del args, u, dts, xdbc, B, C, dy, h_ck
    torch.cuda.empty_cache()
    return out


def train_rwkv_jamba(torch, VK, tmp: Path, WK, MK, phases) -> tuple:
    """Phases 15b-15d: rwkv6-1.6b at full width cut to RWKV_TRAIN_LAYERS
    layers trained as 14b (4 rounds, island 0 preempted in round 2, killed
    after round 3 and resumed bit-equal); jamba-v0.1 at full width,
    blocks JAMBA_TRAIN_BLOCKS, JAMBA_TRAIN_ROUNDS rounds; then each at
    full width and 2 layers card vs CPU as 14c, with planted faults in
    B14's backward (dk, dw) and B15's (dC, dA).  Returns the launches of
    15b and 15c."""
    phases.start("15b")
    layers = RWKV_TRAIN_LAYERS
    rwkv = train_full_width(torch, VK, tmp, depth_cut("rwkv6-1.6b", layers),
                            "rwkv train", RWKV_TRAIN_PARAMS,
                            {"wkv6": 2 * layers, "wkv6_bwd": layers})
    phases.start("15c")
    jamba = train_full_width(
        torch, VK, tmp, jamba_config(JAMBA_TRAIN_BLOCKS), "jamba train",
        JAMBA_TRAIN_PARAMS, {"mamba_scan": 4, "mamba_scan_bwd": 2,
                             "flash_attention": 2, "flash_attention_bwd": 1},
        attn=2, rounds=JAMBA_TRAIN_ROUNDS, kill=None)
    phases.start("15d")
    train_card_vs_cpu(
        torch, VK, depth_cut("rwkv6-1.6b"), "rwkv train card vs cpu",
        {"wkv6": 2 * CMP_LAYERS, "wkv6_bwd": CMP_LAYERS},
        {"dk = 0": (WK, "wkv6_bwd", 1, 0.0, "rwkv_tm/wk", CMP_LAYERS),
         "dw x 1.01": (WK, "wkv6_bwd", 3, 1.01, "rwkv_tm/w0", CMP_LAYERS)})
    train_card_vs_cpu(
        torch, VK, jamba_config(JAMBA_TRAIN_CMP_BLOCKS),
        "jamba train card vs cpu", {"mamba_scan": 2, "mamba_scan_bwd": 1},
        {"dC = 0": (MK, "mamba_scan_bwd", 3, 0.0, "mamba/x_proj", 1),
         "dA x 1.01": (MK, "mamba_scan_bwd", 4, 1.01, "mamba/a_log", 1)})
    return rwkv, jamba


# ---------------------------------------------------------------------------
# phase 16: stablelm-3b and gemma3-4b (B13 at hd 80 and 256)
# ---------------------------------------------------------------------------

# 16a: served at full width, batch 4 x 2,048 prompt tokens, 96 greedy
# decode steps: stablelm-3b cut to 8 of its 32 layers, gemma3-4b to its
# first layer group (5 local layers, window 1,024, then 1 global); the
# weights are drawn on the CPU at ~100M parameters a second, which the
# full depths' 2.8B and 3.9B would take ~65 s of
DENSE_SERVE = (4, 2048, 96)
STABLELM_SERVE_LAYERS = 8
# 16c: trained as 14b (the launcher's defaults) for 2 rounds, no
# checkpoint: stablelm-3b cut to 12 layers, gemma3-4b to its first group
STABLELM_TRAIN_LAYERS = 12
STABLELM_TRAIN_PARAMS = 1_209_267_200    # 257,561,600 + 12 x 79,308,800
GEMMA3_GROUP_PARAMS = 1_237_356_032      # 671,088,640 tied + 6 x
                                         # 94,377,472 + 2,560 (final norm)
DENSE_TRAIN_ROUNDS = 2


def gemma3_group(blocks=None):
    """gemma3-4b at full width, its first layer group once (5 local
    layers and 1 global), or the group's blocks at ``blocks``."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import LayerGroup
    full = get_config("gemma3-4b")
    group = full.layer_groups[0].blocks
    if blocks is not None:
        group = tuple(group[i] for i in blocks)
    return full.replace(layer_groups=(LayerGroup(group, 1),))


def dense_hd_paths(torch, VK, FK, tmp: Path, phases) -> None:
    """Phase 16: the dense models whose head dims the wgmma route took in
    PR 32.  16a: stablelm-3b (hd 80) and gemma3-4b (hd 256) served at
    full width (DENSE_SERVE; depth cut as above): one B13 launch a layer
    in prefill, all on the wgmma route, none in decode; warm prefill ms
    and tokens/s, decode ms a step, peak memory and the warm prefill's
    device-busy share.  16b: each at 2 layers (gemma3: one local, one
    global) card vs CPU as 6c.  16c: each trained at full width as 14b
    for DENSE_TRAIN_ROUNDS rounds (every B13 forward, recompute and
    backward counted by route, all wgmma; B3 a step, B2 a round).  16d:
    each at 2 layers card vs CPU as 14c: f32 leaf by leaf, the four
    planted faults in B13's backward refused at hd 80 and at hd 256,
    bf16 within 14c's bounds."""
    phases.start("16a")
    _serve_lm(torch, VK, depth_cut("stablelm-3b", STABLELM_SERVE_LAYERS),
              DENSE_SERVE, "wgmma", "stablelm serve", profile=True)
    _serve_lm(torch, VK, gemma3_group(), DENSE_SERVE, "wgmma",
              "gemma3 serve", profile=True)
    # gemma3's tied embedding would be 78% of its 2-layer cut's 860M
    # parameters, which the CPU's work scales with (at full vocabulary
    # 16d's gemma3 CPU rounds took 25.5 s f32 + 48.3 s bf16): its
    # vocabulary is TRAIN_CMP_VOCAB here as in 16d, every other width as
    # published (16a and 16c run the full vocabulary on the card)
    cmp_cuts = (("stablelm", depth_cut("stablelm-3b")),
                ("gemma3", gemma3_group((0, 5)).replace(
                    vocab_size=TRAIN_CMP_VOCAB)))
    phases.start("16b")
    for _, cut in cmp_cuts:
        serve_card_vs_cpu(torch, VK, cut, {"flash_attention": CMP_LAYERS},
                          ATTN_ROUTES)
    phases.start("16c")
    for cfg, label, n in (
            (depth_cut("stablelm-3b", STABLELM_TRAIN_LAYERS),
             "stablelm train", STABLELM_TRAIN_PARAMS),
            (gemma3_group(), "gemma3 train", GEMMA3_GROUP_PARAMS)):
        layers = cfg.n_layers
        train_full_width(torch, VK, tmp, cfg, label, n,
                         {"flash_attention": 2 * layers,
                          "flash_attention_bwd": layers},
                         attn=2 * layers, rounds=DENSE_TRAIN_ROUNDS,
                         kill=None, profile=False)
    phases.start("16d")
    for name, cut in cmp_cuts:
        train_card_vs_cpu(
            torch, VK, cut, f"{name} train card vs cpu",
            {"flash_attention": 2 * CMP_LAYERS,
             "flash_attention_bwd": CMP_LAYERS},
            {k: (FK, "flash_attention_bwd", i, sc, leaf, CMP_LAYERS)
             for k, (i, sc, leaf) in TRAIN_FAULTS.items()},
            (TRAIN_CMP_GNORM, TRAIN_CMP_LEAF_BF16))


# ---------------------------------------------------------------------------
# phase 17: whisper-tiny and the internvl2-2b VLM stub, served and trained;
# granite-moe-1b-a400m trained at full size
# ---------------------------------------------------------------------------

# 17a: whisper-tiny served at full size: batch 4, 1,500 frames, a 376-token
# prompt and 72 decode steps (448 positions: the published decoder
# context; the recent ring wraps at step 64, an encoder-decoder's ring is
# never compacted)
WHISPER_SERVE = (4, 376, 72)
# 17b: trained at the launcher's defaults (8 x 128 tokens and 8 x 1,500
# frames a step), 2 rounds; card vs CPU as 14c, but bf16 held as 15d
# (each leaf no farther from the CPU's f32 gradient than TRAIN_CMP_NOISE
# times the CPU's own bf16 gradient is): the last decoder layer's
# self-attention gradients differ card vs CPU in bf16 by 0.9% in norm
# (14c's 0.5% was set on internlm2), where f32 agrees to 1.3e-5.
# Parameters: the embedding and unembedding 2 x 19,918,848,
# the learned position table 12,607,488 (32,832 x 384), 4 encoder layers
# of 1,771,008, 4 decoder layers of 2,361,600 and two final norms
WHISPER_PARAMS = 68_977_152
PHASE17_ROUNDS = 2
# 17c: internvl2-2b at full width cut to 6 of its 24 layers, batch 4 x
# 2,048 (256 patches + 1,792 tokens), 96 decode steps (a compaction); its
# training round card vs CPU at 2 layers and TRAIN_CMP_VOCAB, 2 x 320
# positions (256 patches + 64 tokens)
VLM_SERVE, VLM_LAYERS, VLM_CMP_SEQ = (4, 2048, 96), 6, 320
# 17d: granite-moe-1b-a400m trained at full width and depth (24 layers,
# the 32-expert MoE in each; its tied embedding), 2 rounds
GRANITE_PARAMS = 1_334_641_664


def whisper_and_vlm(torch, VK, FK, tmp: Path, phases) -> None:
    """Phase 17: whisper-tiny and the VLM stub, and granite-moe's
    training.
    17a: whisper-tiny served at full size (WHISPER_SERVE): 12 B13
    launches a prefill (4 encoder, 4 causal, 4 cross), all wgmma, none a
    decode step; then card vs CPU at full width and depth as 6c (batch 2
    x 256 + 72 steps: 2e-3 in f32, 0.15 in bf16).  17b: whisper trained
    as 14b for PHASE17_ROUNDS rounds (B13's forward, recompute and
    backward counted by route, all wgmma; B3 a step, B2 a round), then
    card vs CPU as 14c with the planted faults refused at the non-causal
    cross-attention's projections.  17c: internvl2-2b served at full
    width (VLM_SERVE, VLM_LAYERS) at the reference's decode positions,
    and its 2-layer training round card vs CPU (vis_proj's gradient
    among the leaves).  17d: granite-moe-1b-a400m trained at full size
    for PHASE17_ROUNDS rounds (B13's backward at hd 64 on the wgmma
    route, B3 a step, B2 a round): round walls, tokens/s, peak memory."""
    from repro_torch.configs import get_config
    whisper = get_config("whisper-tiny")
    n_attn = prefill_attn(whisper)
    phases.start("17a")
    _serve_lm(torch, VK, whisper, WHISPER_SERVE, "wgmma", "whisper serve")
    serve_card_vs_cpu(torch, VK, whisper, {"flash_attention": n_attn},
                      ATTN_ROUTES)
    phases.start("17b")
    train_full_width(torch, VK, tmp, whisper, "whisper train",
                     WHISPER_PARAMS, {"flash_attention": 2 * n_attn,
                                      "flash_attention_bwd": n_attn},
                     attn=2 * n_attn, rounds=PHASE17_ROUNDS, kill=None,
                     profile=False)
    train_card_vs_cpu(
        torch, VK, whisper, "whisper train card vs cpu",
        {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn},
        {k: (FK, "flash_attention_bwd", i, sc, "x" + leaf, whisper.n_layers)
         for k, (i, sc, leaf) in TRAIN_FAULTS.items()})
    phases.start("17c")
    _serve_lm(torch, VK, depth_cut("internvl2-2b", VLM_LAYERS), VLM_SERVE,
              "wgmma", "internvl2 serve")
    train_card_vs_cpu(
        torch, VK, depth_cut("internvl2-2b"), "internvl2 train card vs cpu",
        {"flash_attention": 2 * CMP_LAYERS, "flash_attention_bwd": CMP_LAYERS},
        {k: (FK, "flash_attention_bwd", i, sc, leaf, CMP_LAYERS)
         for k, (i, sc, leaf) in TRAIN_FAULTS.items()},
        (TRAIN_CMP_GNORM, TRAIN_CMP_LEAF_BF16), seq=VLM_CMP_SEQ,
        show=("vis_proj/w1", "vis_proj/w2"))
    phases.start("17d")
    granite = get_config("granite-moe-1b-a400m")
    train_full_width(torch, VK, tmp, granite, "granite train",
                     GRANITE_PARAMS,
                     {"flash_attention": 2 * granite.n_layers,
                      "flash_attention_bwd": granite.n_layers},
                     attn=2 * granite.n_layers, rounds=PHASE17_ROUNDS,
                     kill=None, profile=False)


# ---------------------------------------------------------------------------
# phase 18: the pod mesh and the sharded flat bus; the mesh plans' one-card
# forms (context-parallel attention, expert-parallel MoE)
# ---------------------------------------------------------------------------

# 18a: the pod meshes' shard counts; the bench bus laid out for the
# largest (the reference's fixed layout: every count divides it), and
# 2^27; Eq. 2 over 4 clients, B5 over 3 replicas
POD_SHARDS = (1, 2, 4, 8)
POD_CLIENTS, POD_REPLICAS = 4, 3
POD_ITERS = {"bench": 50, "big": 5}
# 18b: internlm2-1.8b at 14b's cut, the launcher's defaults, 3 rounds,
# island 1 dead in round 2 (index 1), the bus over a 4-shard pod mesh
POD_ROUND_SHARDS, POD_ROUNDS, POD_DEAD_ROUND = 4, 3, 1
# 18c: qwen2.5-14b (40 / 8 heads: the reference's planner sends it to CP,
# 40 heads do not divide 16) at 2 layers and TRAIN_CMP_VOCAB; 18d:
# gemma3-4b's first layer group (window 1,024: each 1,024-token chunk
# sees its neighbour); 18e: granite-moe in full
CP_CHUNKS, CP_QWEN_PREFILL, CP_GEMMA_SEQ = 4, (4, 2048), (2, 4096)
EP_DEGREE, EP_PREFILL, EP_CAPACITY = 4, (4, 2048), 8.0
PLAN_TOL = 0.15                   # the port's bf16 logit bound (CMP_TOL)


def _pod_inputs(torch, n: int, seed: int, device: str) -> dict:
    """A bus and its companions on ``device``: server, 4 clients (server
    + 0.01 N(0, 1)), a gradient and a second moment.  ``n`` KB.N_PADDED:
    the bench model laid out for the largest shard count, its clients
    from ``bench_clients``; else ``n`` N(0, 1) values drawn on
    ``device``."""
    from repro_torch.core import flat as F
    if n == KB.N_PADDED:
        tree = KB.bench_model(device, seed)
        fp = F.flatten_sharded(tree, max(POD_SHARDS))
        s = fp.buf
        cl = torch.stack([F.flatten_like(c, fp.spec)
                          for c in KB.bench_clients(tree)])
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    if n != KB.N_PADDED:
        s = draw(n)
        cl = s + 0.01 * draw(POD_CLIENTS, n)
    return {"s": s, "clients": cl, "g": 0.01 * draw(s.numel()),
            "v": draw(s.numel()).abs()}


def _pod_ops(torch, K, S, VR, x: dict, mesh) -> dict:
    """Every flat op once over ``x`` (whole tensors), a shard at a time on
    ``mesh`` (None: the whole-bus call); results gathered whole."""
    s, cl, g, v = x["s"], x["clients"], x["g"], x["v"]
    w = [0.2, 0.1, 0.15, 0.25, 0.3]
    wi, ws = VR.island_weights(POD_CLIENTS, 0.6, torch.tensor(
        [True, False, True, True]))
    dead = cl.clone()
    dead[1] = float("nan")
    rep = cl[:POD_REPLICAS]
    adam = (1e-3, 0.9, 0.999, 1e-8, 0.01, 0.1, 0.001)
    if mesh is None:
        out = {"vc_asgd_lerp_flat": [K.fused_lerp_flat(s, cl[0], 0.7)],
               "assimilate_flat": [K.fused_assimilate_flat(s, cl, w)],
               "adam_update_flat": list(K.fused_adam_flat(
                   s, g, g, v, *adam)),
               "easgd_elastic_flat": list(K.fused_easgd_flat(s, rep, 0.3)),
               "broadcast": [VR.redistribute_flat(s, 3)],
               "masked": [VR.assimilate_flat(s, dead, wi, ws)]}
    else:
        out = {"vc_asgd_lerp_flat": [S.sharded_lerp_flat(s, cl[0], 0.7,
                                                         mesh)],
               "assimilate_flat": [S.sharded_assimilate_flat(s, cl, w,
                                                             mesh)],
               "adam_update_flat": list(S.sharded_adam_update_flat(
                   s, g, g, v, *adam, mesh)),
               "easgd_elastic_flat": list(S.sharded_easgd_flat(
                   s, rep, 0.3, mesh)),
               "broadcast": [VR.redistribute_flat(s, 3, mesh=mesh,
                                                  shard_axis="pod")],
               "masked": [VR.assimilate_flat(s, dead, wi, ws, mesh=mesh,
                                             shard_axis="pod")]}
    return {k: [S.gather_flat(t) for t in ts] for k, ts in out.items()}


def sharded_bus_parity(torch, VK) -> dict:
    """Phase 18a: every sharded op at every shard count against the
    whole-bus kernel call (and, on the bench bus, the CPU's plain
    version), bit for bit; each kernel's launches a sharded op (one a
    shard); the per-shard route timed in turns against the whole call.
    Returns B1's, B2's, B3's and B5's launches over the checks."""
    from repro_torch.benchmarks import wrapper_cost as WC
    from repro_torch.kernels import ops as K
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.runtime import sharding as S
    from repro_torch.runtime import vc_runtime as VR
    flat_ops = ("vc_asgd_lerp_flat", "assimilate_flat", "adam_update_flat",
                "easgd_elastic_flat")
    adam = (1e-3, 0.9, 0.999, 1e-8, 0.01, 0.1, 0.001)
    w = [0.2, 0.1, 0.15, 0.25, 0.3]
    total = dict.fromkeys(flat_ops, 0)
    for label, n in (("bench", KB.N_PADDED), ("big", BIG_N)):
        plain = None
        if label == "bench":
            host = _pod_inputs(torch, n, 18, "cpu")
            plain = _pod_ops(torch, K, S, VR, host, None)
            x = {k: t.cuda() for k, t in host.items()}
            del host
        else:
            x = _pod_inputs(torch, n, 18, "cuda")
        n = x["s"].numel()
        whole = _pod_ops(torch, K, S, VR, x, None)
        for shards in POD_SHARDS:
            mesh = make_pod_mesh(shards, device="cuda")
            VK.reset_launch_count()
            got = _pod_ops(torch, K, S, VR, x, mesh)
            torch.cuda.synchronize()
            counts = VK.launch_counts()
            # lerp, Eq. 2 (plain and masked), Adam, EASGD: one a shard each
            want = {**dict.fromkeys(VK.KERNELS, 0),
                    **dict.fromkeys(flat_ops, shards),
                    "assimilate_flat": 2 * shards}
            check(counts == want, f"18a {label} x{shards}: launches "
                  f"{counts}, want {want}")
            for k in flat_ops:
                total[k] += counts[k]
            for op, outs in got.items():
                for i, t in enumerate(outs):
                    check(bits_equal(torch, t, whole[op][i]),
                          f"18a {label} x{shards}: {op}[{i}] differs from "
                          f"the whole-bus call")
                    if plain is not None:
                        check(bits_equal(torch, t.cpu(), plain[op][i]),
                              f"18a {label} x{shards}: {op}[{i}] differs "
                              f"from the CPU's plain version")
            del got
        check(bool(torch.isfinite(whole["masked"][0]).all()),
              f"18a {label}: the dead island reached the server")
        say(f"18a {label} bus ({n:,} f32): lerp, Eq. 2 ({POD_CLIENTS} "
            f"clients), Adam, EASGD ({POD_REPLICAS} replicas), the "
            f"broadcast and the masked Eq. 2 with a dead island at "
            f"{POD_SHARDS} shards bit-equal to the whole-bus kernel call"
            + (" and to the CPU's plain version" if plain is not None
               else "") + "; B1, B2 (twice: plain and masked), B3, B5 "
            "launched once a shard")
        del whole, plain
        # the per-shard route against the whole call, in turns
        k8 = max(POD_SHARDS)
        mesh = make_pod_mesh(k8, device="cuda")
        s, cl, g, v = x["s"], x["clients"], x["g"], x["v"]
        rep = cl[:POD_REPLICAS]
        ss, cs, gs, vs, c0s, rs = (S.shard_buf(t, mesh) for t in
                                   (s, cl, g, v, cl[0], rep))
        fns = {
            "B1 whole": lambda: K.fused_lerp_flat(s, cl[0], 0.7),
            f"B1 x{k8}": lambda: S.sharded_lerp_flat(ss, c0s, 0.7, mesh),
            "B2 whole": lambda: K.fused_assimilate_flat(s, cl, w),
            f"B2 x{k8}": lambda: S.sharded_assimilate_flat(ss, cs, w, mesh),
            "B3 whole": lambda: K.fused_adam_flat(s, g, g, v, *adam),
            f"B3 x{k8}": lambda: S.sharded_adam_update_flat(
                ss, gs, gs, vs, *adam, mesh),
            "B5 whole": lambda: K.fused_easgd_flat(s, rep, 0.3),
            f"B5 x{k8}": lambda: S.sharded_easgd_flat(ss, rs, 0.3, mesh)}
        ms = WC.event_ms(torch, fns, POD_ITERS[label])
        say(f"18a {label} bus ({n:,} f32) CUDA-event ms a call, in turns, "
            f"whole / {k8} shards: " + "; ".join(
                f"{b} {ms[b + ' whole']:.4f} / {ms[f'{b} x{k8}']:.4f} "
                f"({ms[f'{b} x{k8}'] / ms[b + ' whole']:.2f}x)"
                for b in ("B1", "B2", "B3", "B5")))
        del x, s, cl, g, v, rep, ss, cs, gs, vs, c0s, rs, fns
        torch.cuda.empty_cache()
    return total


def _draw_in_threads(cfgs: dict):
    """Each config's port init (seed 0) drawn on the CPU in its own
    thread (the draws release the GIL), beside the card's work: name ->
    a future of the parameter tree."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.models.registry import build_model
    pool = ThreadPoolExecutor(max_workers=len(cfgs))
    futures = {k: pool.submit(build_model(c).init, 0, "cpu")
               for k, c in cfgs.items()}
    pool.shutdown(wait=False)
    return futures


def sharded_round_on_card(torch, VK, tree) -> dict:
    """Phase 18b: internlm2's VC round unsharded and with
    ``flat_shard_axis`` over a POD_ROUND_SHARDS-shard pod mesh, from one
    server (``tree`` on the CPU, the bus padded to BLOCK x shards):
    every loss and the server bit-equal; launches (B13 forward with its
    recompute and backward a layer and step, B3 a step, B2 once a
    round unsharded and once a shard sharded); round walls, tokens/s
    and peak memory of both.  Returns the sharded run's launches."""
    from repro_torch.core import flat as F
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.launch.train import _round_batches
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizers import Adam
    from repro_torch.runtime import vc_runtime as VR
    cfg = depth_cut("internlm2-1.8b", TRAIN_LAYERS)
    model = build_model(cfg)
    master = F.flatten(tree, pad_to=F.BLOCK * POD_ROUND_SHARDS)
    check(master.spec.n == TRAIN_PARAMS, f"18b: {master.spec.n} parameters")
    kw = TRAIN_KW
    n_isl, k = kw["islands"], kw["local_steps"]
    batches = [_round_batches(cfg, n_isl, k, kw["batch"], kw["seq"],
                              seed=r) for r in range(POD_ROUNDS)]
    tokens = n_isl * k * kw["batch"] * kw["seq"]
    mesh = make_pod_mesh(POD_ROUND_SHARDS, device="cuda")
    runs = {}
    for axis in (None, "pod"):
        torch.cuda.reset_peak_memory_stats()
        server = F.FlatParams(master.buf.cuda(), master.spec)
        isl, opts = VR.init_islands(server, n_isl, Adam(lr=1e-3))
        rnd = VR.make_vc_round(model, n_isl, k, Adam(lr=1e-3),
                               flat_shard_axis=axis,
                               mesh=mesh if axis else None)
        VK.reset_launch_count()
        losses, walls = [], []
        for r in range(POD_ROUNDS):
            surv = [True, r != POD_DEAD_ROUND]
            t0 = time.perf_counter()
            server, isl, opts, m = rnd(server, isl, opts, batches[r], 0.5,
                                       surv)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t0)
        counts = VK.launch_counts()
        steps = n_isl * k * POD_ROUNDS
        shards = POD_ROUND_SHARDS if axis else 1
        want = {**dict.fromkeys(VK.KERNELS, 0),
                "flash_attention": 2 * TRAIN_LAYERS * steps,
                "flash_attention_bwd": TRAIN_LAYERS * steps,
                "adam_update_flat": steps,
                "assimilate_flat": shards * POD_ROUNDS}
        label = f"18b {'sharded x%d' % shards if axis else 'unsharded'}"
        check(counts == want, f"{label}: launches {counts}, want {want}")
        check_attn_route(2 * TRAIN_LAYERS * steps, "wgmma", label)
        check(all(torch.isfinite(torch.tensor(losses)))
              and bool(torch.isfinite(server.buf).all()),
              f"{label}: a non-finite loss or server")
        say(f"{label} {cfg.describe()}, {master.spec.n:,} parameters: "
            + "; ".join(f"round {r + 1} loss {losses[r]!r}, wall "
                        f"{walls[r]:.3f} s, {tokens / walls[r]:.1f} tokens/s"
                        for r in range(POD_ROUNDS))
            + f"; peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
            f"B2 {counts['assimilate_flat'] // POD_ROUNDS} a round")
        runs[axis] = (losses, server.buf.clone(), counts, walls)
        del server, isl, opts, rnd
        torch.cuda.empty_cache()
    (l0, b0, _, w0), (l1, b1, c1, w1) = runs[None], runs["pod"]
    check(l0 == l1, f"18b: losses {l1} sharded, {l0} unsharded")
    check(bits_equal(torch, b0, b1), "18b: the sharded round's server "
          "differs from the unsharded round's")
    warm = lambda w: tokens * (POD_ROUNDS - 1) / sum(w[1:])
    say(f"18b: the round over {POD_ROUND_SHARDS} shards bit-equal to the "
        f"unsharded round (losses and the {b0.numel():,}-element server); "
        f"rounds 2-{POD_ROUNDS} {warm(w1):.1f} tokens/s sharded, "
        f"{warm(w0):.1f} unsharded (round 1 is the card's first at this "
        f"width: cold)")
    del runs, b0, b1
    torch.cuda.empty_cache()
    return c1


def _prefill(torch, VK, model, params, tokens, plan):
    """(prefill logits [b, vocab] in f32, the cold wall, the launches, B13's
    launches by route) of one prefill on the card."""
    VK.reset_launch_count()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, _ = model.prefill(params, {"tokens": tokens}, plan=plan)
    lg = lg.float()
    torch.cuda.synchronize()
    return (lg, time.perf_counter() - t0, VK.launch_counts(),
            LA.route_counts("flash_attention"))


def _all_wgmma(routes: dict, n: int) -> bool:
    return routes == {r: (n if r == "wgmma" else 0) for r in routes}


def _plan_compare(torch, label: str, a, b, tol: float) -> float:
    d = float((a - b).abs().max())
    check(bool(torch.isfinite(a).all()) and d <= tol,
          f"{label}: max |diff| {d} > {tol}")
    return d


def _grads(torch, VK, model, params, batch, plan) -> tuple:
    """(loss, the gradient of every leaf, the launches) of ``model.loss``
    under ``plan`` on the card."""
    from repro_torch.core import flat as F
    leaves, td = F.tree_flatten(params)
    req = [t.detach().requires_grad_(True) for t in leaves]
    VK.reset_launch_count()
    loss, _ = model.loss(F.tree_unflatten(td, req), batch, plan=plan)
    grads = torch.autograd.grad(loss, req)
    torch.cuda.synchronize()
    return float(loss.detach()), grads, VK.launch_counts()


def _grad_bounds(torch, label: str, got, want) -> None:
    """Each leaf of ``got`` against ``want`` within 16d's bf16 bounds:
    ||got - want|| / ||want|| <= TRAIN_CMP_LEAF_BF16 and the norms within
    TRAIN_CMP_GNORM relative, and the global norms within it too."""
    lv = torch.linalg.vector_norm
    rel = rn = 0.0
    for g, w in zip(got, want):
        wn = float(lv(w.float()))
        if wn == 0.0:
            check(float(lv(g.float())) == 0.0, f"{label}: a zero leaf moved")
            continue
        rel = max(rel, float(lv((g - w).float())) / wn)
        rn = max(rn, abs(float(lv(g.float())) - wn) / wn)
    gg = float(torch.sqrt(sum(lv(g.float()) ** 2 for g in got)))
    gw = float(torch.sqrt(sum(lv(w.float()) ** 2 for w in want)))
    check(rel <= TRAIN_CMP_LEAF_BF16 and rn <= TRAIN_CMP_GNORM
          and abs(gg - gw) / gw <= TRAIN_CMP_GNORM,
          f"{label}: per-leaf {rel:.4g} (bound {TRAIN_CMP_LEAF_BF16}), "
          f"leaf norms {rn:.4g}, global norms {gg} vs {gw} (bound "
          f"{TRAIN_CMP_GNORM})")
    say(f"{label}: per leaf worst ||a - b|| / ||b|| {rel:.4g} (bound "
        f"{TRAIN_CMP_LEAF_BF16}), worst relative leaf-norm diff {rn:.4g}, "
        f"global grad norms {gg:.6g} / {gw:.6g} (bound {TRAIN_CMP_GNORM})")


def context_parallel_on_card(torch, np, VK, futures, phases) -> dict:
    """Phases 18c-d: context parallelism at full width.  Returns B13's
    forward and backward launches under cp = 4."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.plan import NULL_PLAN, NullPlan
    from repro_torch.models.registry import build_model
    cp = NullPlan(attn_mode="cp", cp=CP_CHUNKS)
    out = {"flash_attention": 0, "flash_attention_bwd": 0}
    # 18c: qwen2.5-14b prefill under cp = 4 against cp = 1
    cfg = depth_cut("qwen2.5-14b").replace(vocab_size=TRAIN_CMP_VOCAB)
    model = build_model(cfg)
    params = model.compute_params(_tree_to(futures["qwen"].result(),
                                           "cuda"))
    b, s = CP_QWEN_PREFILL
    tok = torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    lg1, w1, _, _ = _prefill(torch, VK, model, params, tok, NULL_PLAN)
    lg4, w4, c4, r4 = _prefill(torch, VK, model, params, tok, cp)
    check(c4["flash_attention"] == cfg.n_layers
          and _all_wgmma(r4, cfg.n_layers),
          f"18c: B13 launches {c4['flash_attention']}, routes {r4}")
    out["flash_attention"] += c4["flash_attention"]
    d = _plan_compare(torch, "18c qwen2.5 cp=4 vs cp=1", lg4, lg1, PLAN_TOL)
    say(f"18c {cfg.describe()}: prefill {b}x{s} under cp={CP_CHUNKS} "
        f"({1e3 * w4:.3f} ms cold) vs cp=1 ({1e3 * w1:.3f} ms): logits max "
        f"|diff| {d:.4g} (bound {PLAN_TOL}); B13 {c4['flash_attention']} "
        f"launches, routes {r4}")
    del params, lg1, lg4
    torch.cuda.empty_cache()
    red = get_reduced("qwen2.5-14b").replace(compute_dtype="float32")
    rmodel = build_model(red)
    rp = rmodel.init(0, device="cpu")
    rtok = torch.from_numpy(np.random.default_rng(19).integers(
        0, red.vocab_size, (2, 64)).astype(np.int32))
    card, *_ = _prefill(torch, VK, rmodel, _tree_to(rp, "cuda"), rtok.cuda(),
                        cp)
    with torch.no_grad():
        cpu, _ = rmodel.prefill(rp, {"tokens": rtok}, plan=cp)
    d = _plan_compare(torch, "18c reduced qwen2.5 card vs cpu",
                      card.cpu(), cpu.float(), CMP_TOL["float32"])
    say(f"18c reduced qwen2.5 (f32) prefill 2x64 under cp={CP_CHUNKS}: card "
        f"vs CPU max |diff| {d:.4g} (bound {CMP_TOL['float32']})")
    # 18d: gemma3's SWA gather and a training step under cp = 4
    phases.start("18d")
    cfg = gemma3_group().replace(vocab_size=TRAIN_CMP_VOCAB)
    model = build_model(cfg)
    master = _tree_to(futures["gemma"].result(), "cuda")
    params = model.compute_params(master)
    b, s = CP_GEMMA_SEQ
    tok = torch.from_numpy(np.random.default_rng(20).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    n_global = sum(sp.attn_kind != "swa" for sp in cfg.all_blocks)
    res = {}
    for gather in (True, False):
        plan = NullPlan(attn_mode="cp", cp=CP_CHUNKS, window_gather=gather)
        lg, w, c, r = _prefill(torch, VK, model, params, tok, plan)
        want = n_global if gather else cfg.n_layers
        check(c["flash_attention"] == want and _all_wgmma(r, want),
              f"18d gather={gather}: B13 {c['flash_attention']}, routes {r}")
        out["flash_attention"] += c["flash_attention"]
        res[gather] = (lg, w, c["flash_attention"])
    d = _plan_compare(torch, "18d gemma3 gather vs full", res[True][0],
                      res[False][0], PLAN_TOL)
    say(f"18d {cfg.describe()}: prefill {b}x{s} under cp={CP_CHUNKS} with "
        f"the window gather ({1e3 * res[True][1]:.3f} ms cold, "
        f"{res[True][2]} B13) vs without ({1e3 * res[False][1]:.3f} ms, "
        f"{res[False][2]} B13): logits max |diff| {d:.4g} (bound "
        f"{PLAN_TOL})")
    del res, params
    torch.cuda.empty_cache()
    batch = {"tokens": tok}
    l4, g4, c4 = _grads(torch, VK, model, master, batch, cp)
    check(c4["flash_attention_bwd"] == n_global
          and c4["flash_attention"] == 2 * n_global,
          f"18d train step cp={CP_CHUNKS}: launches {c4}")
    check_attn_route(n_global, "wgmma", "18d train step",
                     "flash_attention_bwd")
    out["flash_attention"] += c4["flash_attention"]
    out["flash_attention_bwd"] += c4["flash_attention_bwd"]
    l1, g1, _ = _grads(torch, VK, model, master, batch, NULL_PLAN)
    say(f"18d training step {b}x{s}: loss cp={CP_CHUNKS} {l4:.6f}, cp=1 "
        f"{l1:.6f}; B13 {c4['flash_attention']} forwards (remat included) "
        f"and {c4['flash_attention_bwd']} backward under cp={CP_CHUNKS}")
    check(abs(l4 - l1) <= TRAIN_CMP_LOSS, f"18d: losses {l4} vs {l1}")
    _grad_bounds(torch, f"18d gradients cp={CP_CHUNKS} vs cp=1", g4, g1)
    del master, g4, g1
    torch.cuda.empty_cache()
    return out


def expert_parallel_on_card(torch, np, VK, tree) -> dict:
    """Phase 18e: granite-moe-1b-a400m in full after ``ep_tune``: prefill
    under EP against the dense dispatch at EP_CAPACITY (no drops: the
    logits within PLAN_TOL); at the config's own capacity factor the
    assignments each dispatch drops, counted from each MoE layer's input
    (at the prefill's 4 x 2,048 and the training batch); one training
    step under EP (the launcher's 8 x 128).  Returns B13's launches of
    the EP prefill and the step."""
    import dataclasses as dc
    import math
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.plan import NULL_PLAN, NullPlan
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import ep_tune
    base = ep_tune(get_config("granite-moe-1b-a400m"), EP_DEGREE)
    ep = NullPlan(moe_ep=True, ep=EP_DEGREE)
    master = _tree_to(tree, "cuda")
    b, s = EP_PREFILL
    tok = torch.from_numpy(np.random.default_rng(21).integers(
        0, base.vocab_size, (b, s)).astype(np.int32)).cuda()
    cfg = base.replace(moe=dc.replace(base.moe, capacity_factor=EP_CAPACITY))
    model = build_model(cfg)
    params = model.compute_params(master)
    lgd, wd, _, _ = _prefill(torch, VK, model, params, tok, NULL_PLAN)
    lge, we, ce, re_ = _prefill(torch, VK, model, params, tok, ep)
    check(ce["flash_attention"] == cfg.n_layers
          and _all_wgmma(re_, cfg.n_layers),
          f"18e: B13 {ce['flash_attention']}, routes {re_}")
    d = _plan_compare(torch, "18e EP vs dense", lge, lgd, PLAN_TOL)
    say(f"18e {cfg.describe()}, ep_virtual {cfg.moe.ep_virtual}: prefill "
        f"{b}x{s} under ep={EP_DEGREE} ({1e3 * we:.3f} ms cold) vs the "
        f"dense dispatch ({1e3 * wd:.3f} ms) at capacity factor "
        f"{EP_CAPACITY}: logits max |diff| {d:.4g} (bound {PLAN_TOL})")
    # the drops at the config's own capacity factor
    model = build_model(base)
    drops = {"dense": 0, "ep": 0}
    total = [0]
    real = (L.apply_moe, L.apply_moe_ep)

    def dense(p, x, c):
        kept = L.moe_kept(p, x, c)
        drops["dense"] += int((~kept).sum())
        total[0] += kept.numel()
        return real[0](p, x, c)

    def expert(p, x, c, plan):
        drops["ep"] += int((~L.moe_kept(p, x, c, ep=plan.ep)).sum())
        return real[1](p, x, c, plan)
    kw = TRAIN_KW
    ttok = torch.from_numpy(np.random.default_rng(22).integers(
        0, base.vocab_size, (kw["batch"], kw["seq"])).astype(
        np.int32)).cuda()
    L.apply_moe, L.apply_moe_ep = dense, expert
    try:
        for t in (tok, ttok):
            for k in drops:
                drops[k] = 0
            total[0] = 0
            _prefill(torch, VK, model, params, t, NULL_PLAN)
            _prefill(torch, VK, model, params, t, ep)
            g = t.shape[0] // EP_DEGREE
            say(f"18e at capacity factor {base.moe.capacity_factor}, "
                f"{t.shape[0]}x{t.shape[1]} tokens: of {total[0]:,} (token, "
                f"choice) assignments over {cfg.n_layers} layers the dense "
                f"dispatch (a capacity a row) drops {drops['dense']:,}, the "
                f"EP dispatch ({EP_DEGREE} groups of {g} row(s), a "
                f"capacity a group) {drops['ep']:,}")
    finally:
        L.apply_moe, L.apply_moe_ep = real
    del params, lgd, lge
    torch.cuda.empty_cache()
    loss, grads, c = _grads(torch, VK, model, master, {"tokens": ttok}, ep)
    gn = float(torch.sqrt(sum(torch.linalg.vector_norm(g.float()) ** 2
                              for g in grads)))
    check(c["flash_attention_bwd"] == cfg.n_layers and math.isfinite(loss)
          and math.isfinite(gn), f"18e train step: loss {loss}, grad norm "
          f"{gn}, launches {c}")
    say(f"18e training step under ep={EP_DEGREE} ({kw['batch']}x"
        f"{kw['seq']}): loss {loss:.6f}, grad norm {gn:.6g}, B13 "
        f"{c['flash_attention']} forwards and {c['flash_attention_bwd']} "
        f"backwards")
    del master, grads
    torch.cuda.empty_cache()
    return {"flash_attention": ce["flash_attention"] + c["flash_attention"],
            "flash_attention_bwd": c["flash_attention_bwd"]}


def pod_mesh_and_plans(torch, np, VK, phases) -> dict:
    """Phase 18 (a-e).  Returns each kernel's launches over the phase's
    checks and paths (18b the sharded round's)."""
    from repro_torch.configs import get_config
    cuts = {"internlm2": depth_cut("internlm2-1.8b", TRAIN_LAYERS),
            "qwen": depth_cut("qwen2.5-14b").replace(
                vocab_size=TRAIN_CMP_VOCAB),
            "gemma": gemma3_group().replace(vocab_size=TRAIN_CMP_VOCAB),
            "granite": get_config("granite-moe-1b-a400m")}
    phases.start("18a")
    counts = sharded_bus_parity(torch, VK)
    futures = _draw_in_threads(cuts)
    phases.start("18b")
    rounds = sharded_round_on_card(torch, VK, futures.pop("internlm2")
                                   .result())
    phases.start("18c")
    cp = context_parallel_on_card(torch, np, VK, futures, phases)
    phases.start("18e")
    ep = expert_parallel_on_card(torch, np, VK,
                                 futures.pop("granite").result())
    for part in (rounds, cp, ep):
        for k, n in part.items():
            if n:
                counts[k] = counts.get(k, 0) + n
    return counts


# ---------------------------------------------------------------------------
# phase 19: the abstract shapes and the mesh plans as data; the production
# plans' chunked decode caches served on the card
# ---------------------------------------------------------------------------

# 19b: internlm2-1.8b at full width cut to CMP_LAYERS, initialised on the
# card in the parameter dtype (no cast), prefilled b x s under a mesh plan
# over one position, then `steps` greedy decode steps (the compaction
# after step 64)
SPEC_SERVE = (4, 2048, 96)
# 19c: the production plans' chunked decode caches on one card, each run
# CHUNK_STEPS teacher-forced decode steps across the compaction against
# the same weights at one chunk (NullPlan()): internlm2 (19b's weights)
# under its decode_32k plan at SPEC_SERVE's prompt; gemma3-4b's first
# group cut to its first local and its global layer (as phase 8 picks
# jamba's blocks) under its long_500k plan at CHUNK_GEMMA
CHUNK_STEPS = 70
CHUNK_GEMMA = (1, 4096)
GEMMA_CHUNK_BLOCKS = (0, 5)


def _requested(torch) -> int:
    """Bytes the live tensors asked the caching allocator for (before its
    rounding to blocks and segments)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _spec_str(t) -> str:
    return f"{tuple(t.shape)} {t.dtype}"


def _state_leaves(caches):
    """The tensors of a list of decode states (or a WhisperDecCache)."""
    if hasattr(caches, "self_cache"):
        caches = [*caches.self_cache, *caches.cross]
    return [t for state in caches for t in state]


def shapes_and_plans_on_meta(torch) -> None:
    """Phase 19a: every arch at full size on the meta device: its
    parameter specs and count, ``MeshPlan.build`` on both production
    meshes for every applicable cell (as the reference's dry run builds
    them: the cell's tuning, bf16 serving weights without FSDP,
    ``decode_batch`` for a decode cell) with its parameter, batch and
    cache tables, and every cell's input specs; the card's allocation
    unchanged."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs import shapes as PS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.common import param_count
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import MeshPlan
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    meshes = {"16x16": (make_production_mesh(), "data"),
              "2x16x16": (make_production_mesh(multi_pod=True),
                          ("pod", "data"))}
    specs = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        leaves = list(_leaves(build_model(cfg).param_specs()))
        n = param_count(cfg)
        check(all(t.is_meta for t in leaves)
              and n == sum(t.numel() for t in leaves),
              f"19a {arch}: specs not meta or {n} parameters miscounted")
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        told, n_tables = {}, 0
        for mname, (mesh, data_axis) in meshes.items():
            for cname, cell in PS.SHAPES.items():
                if PS.cell_applicable(cfg, cell):
                    continue
                tuned = PS.tune_for_shape(cfg, cell)
                serve = cell.kind != "train"
                if serve:
                    tuned = tuned.replace(param_dtype="bfloat16")
                plan = MeshPlan.build(
                    tuned, mesh, data_axis=data_axis,
                    decode_batch=(cell.global_batch if cell.kind == "decode"
                                  else None))
                plan.fsdp = not serve
                model = build_model(tuned)
                if tuned not in specs:
                    specs[tuned] = model.param_specs()
                p_sh = list(_leaves(plan.param_shardings(specs[tuned])))
                inputs = PS.input_specs(tuned, cell, plan)
                batch = {k: v for k, v in inputs.items() if k != "caches"}
                b_sh = plan.batch_shardings(batch)
                ok = (len(p_sh) == len(leaves) and len(b_sh) == len(batch)
                      and all(t.is_meta for t in batch.values()))
                if serve:
                    caches = inputs.get("caches") or model.cache_specs(
                        cell.global_batch, cell.seq_len, plan)
                    c_leaves = _state_leaves(caches)
                    c_sh = _state_leaves(plan.cache_shardings(caches))
                    ok = ok and len(c_sh) == len(c_leaves) and all(
                        t.is_meta for t in c_leaves)
                check(ok, f"19a {arch} {mname} {cname}: a table's leaves")
                n_tables += 1
                if cell.kind == "decode" and mname == "16x16":
                    told[cname] = (f"{plan.attn_mode}/{plan.cache_mode}/"
                                   f"{plan.cache_chunks}")
        say(f"19a {arch}: {n:,} parameters, {nbytes:,} bytes "
            f"({cfg.param_dtype}); {n_tables} plans with their tables; "
            f"16x16 attn_mode/cache_mode/cache_chunks: decode_32k "
            f"{told['decode_32k']}, long_500k "
            f"{told.get('long_500k', 'not applicable')}")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(after == before, f"19a: memory_allocated {before} -> {after}")
    say(f"19a: torch.cuda.memory_allocated {before} before, {after} after")


def specs_on_card(torch, np, VK) -> tuple:
    """Phase 19b: internlm2-1.8b (CMP_LAYERS at full width) initialised
    on the card without cast: its tree equals ``param_specs()`` in shape
    and dtype, and the bytes it asks the allocator for equal the specs'
    bytes; a prefill through
    ``make_prefill_step`` under a mesh plan over one position gives
    caches equal to ``cache_specs``; SPEC_SERVE's decode steps through
    ``make_decode_step``.  Returns (the model, its parameters, the
    path's launches)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import compact_all, greedy
    from repro_torch.models.layers import RECENT_RING
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import MeshPlan
    from repro_torch.runtime.train import (make_decode_step,
                                           make_prefill_step, padded_vocab_of)
    cfg = depth_cut("internlm2-1.8b")
    model = build_model(cfg)
    specs = list(_leaves(model.param_specs()))
    torch.cuda.synchronize()
    req0, alloc0 = _requested(torch), torch.cuda.memory_allocated()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    added = _requested(torch) - req0
    blocks = torch.cuda.memory_allocated() - alloc0
    live = list(_leaves(params))
    check([_spec_str(t) for t in live] == [_spec_str(t) for t in specs]
          and all(t.is_cuda for t in live),
          "19b: the live tree differs from param_specs()")
    nbytes = sum(t.numel() * t.element_size() for t in specs)
    check(added == nbytes, f"19b: init requested {added} bytes, the specs "
          f"hold {nbytes}")
    plan = MeshPlan.build(cfg, Mesh(("data", "model"), (1, 1)))
    b, s, steps = SPEC_SERVE
    tok = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    prefill, decode = make_prefill_step(model, plan), make_decode_step(
        model, plan)
    VK.reset_launch_count()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, caches = prefill(params, {"tokens": tok})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        want = model.cache_specs(b, s, plan)
        check([_spec_str(t) for t in _state_leaves(caches)] ==
              [_spec_str(t) for t in _state_leaves(want)],
              "19b: the prefill's caches differ from cache_specs()")
        t0 = time.perf_counter()
        for i in range(steps):
            lg, caches = decode(params, caches, greedy(lg, cfg), s + i)
            if (i + 1) % RECENT_RING == 0:
                caches = compact_all(caches, s + i)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
    counts = VK.launch_counts()
    routes = LA.route_counts("flash_attention")
    check(counts["flash_attention"] == cfg.n_layers
          and _all_wgmma(routes, cfg.n_layers),
          f"19b: B13 {counts['flash_attention']} launches, routes {routes}")
    check(bool(torch.isfinite(lg).all())
          and tuple(lg.shape) == (b, padded_vocab_of(model)),
          "19b: decode logits not finite or of the wrong shape")
    say(f"19b {cfg.describe()}: init on the card requested {added:,} "
        f"bytes = the specs' {nbytes:,} (memory_allocated +{blocks:,}: the "
        f"allocator's blocks); plan over "
        f"mesh {plan.mesh.shape} ({plan.attn_mode}, {plan.cache_mode}, "
        f"{plan.cache_chunks} chunk); prefill {b}x{s} {1e3 * t_prefill:.3f} "
        f"ms cold, caches = cache_specs; {steps} decode steps "
        f"{1e3 * t_decode / steps:.3f} ms a step; B13 "
        f"{counts['flash_attention']} launches, routes {routes}")
    return model, params, counts


def _teacher_forced(torch, model, params, tok, plan, feed):
    """Prefill ``tok`` under ``plan`` and CHUNK_STEPS decode steps fed
    ``feed`` (or the run's own greedy tokens when None), compacting after
    step 64.  Returns (the logit rows in f32, the tokens fed, the final
    states, B13's launches by route)."""
    from repro_torch.launch.serve import compact_all, greedy
    from repro_torch.models.layers import RECENT_RING
    cfg = model.cfg
    s = tok.shape[1]
    LA.reset_launch_count()
    with torch.no_grad():
        lg, caches = model.prefill(params, {"tokens": tok}, plan)
        routes = LA.route_counts("flash_attention")
        rows, fed = [lg.float()], []
        for i in range(CHUNK_STEPS):
            t = feed[i] if feed is not None else greedy(lg, cfg)
            fed.append(t)
            lg, caches = model.decode_step(params, caches, t, s + i, plan)
            rows.append(lg.float())
            if (i + 1) % RECENT_RING == 0:
                caches = compact_all(caches, s + i)
    torch.cuda.synchronize()
    return rows, fed, caches, routes


def chunked_decode_on_card(torch, np, model, master, gemma_future) -> None:
    """Phase 19c: the production plans' chunked decode caches served on
    one card (their computing fields as ``one_card_plan()``), each against
    the same weights at one chunk: logits within CMP_TOL's bf16 bound."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.plan import NULL_PLAN
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import MeshPlan
    mesh = make_production_mesh()
    b, s, _ = SPEC_SERVE
    gcfg = gemma3_group(GEMMA_CHUNK_BLOCKS)
    runs = (("internlm2-1.8b", "decode_32k", model,
             model.compute_params(master), (b, s), 128),
            ("gemma3-4b", "long_500k", build_model(gcfg),
             build_model(gcfg).compute_params(_tree_to(
                 gemma_future.result(), "cuda")), CHUNK_GEMMA, 1))
    for arch, cell, mdl, params, (bb, ss), dbatch in runs:
        plan = MeshPlan.build(get_config(arch), mesh, decode_batch=dbatch)
        one_card = plan.one_card_plan()
        tok = torch.from_numpy(np.random.default_rng(191).integers(
            0, mdl.cfg.vocab_size, (bb, ss)).astype(np.int32)).cuda()
        t0 = time.perf_counter()
        want, fed, _, r1 = _teacher_forced(torch, mdl, params, tok,
                                           NULL_PLAN, None)
        t1 = time.perf_counter()
        got, _, caches, rc = _teacher_forced(torch, mdl, params, tok,
                                             one_card, fed)
        t2 = time.perf_counter()
        chunks = {int(c.k_old.shape[2]) for c in caches}
        check(chunks == {plan.cache_chunks},
              f"19c {arch}: cache chunks {chunks}, plan "
              f"{plan.cache_chunks}")
        v = mdl.cfg.vocab_size
        d = max(float((a[:, :v] - w[:, :v]).abs().max())
                for a, w in zip(got, want))
        check(all(bool(torch.isfinite(a).all()) for a in got)
              and d <= CMP_TOL["bfloat16"],
              f"19c {arch}: logits max |diff| {d} > {CMP_TOL['bfloat16']}")
        say(f"19c {mdl.cfg.describe()}: its {cell} plan on 16x16 "
            f"({plan.attn_mode}, cp {plan.cp}, {plan.cache_mode} cache in "
            f"{plan.cache_chunks} chunks) on one card, prefill {bb}x{ss} + "
            f"{CHUNK_STEPS} decode steps across the compaction "
            f"({t2 - t1:.3f} s; B13 routes {rc}) vs one chunk, no cp "
            f"({t1 - t0:.3f} s; B13 routes {r1}): logits max |diff| {d:.4g} "
            f"(bound {CMP_TOL['bfloat16']})")
        del params, got, want, caches
        torch.cuda.empty_cache()


def shapes_and_plans(torch, np, VK, phases) -> dict:
    """Phase 19 (a-c), with its wall.  Returns 19b's launches."""
    t0 = time.perf_counter()
    gemma = _draw_in_threads({"gemma": gemma3_group(GEMMA_CHUNK_BLOCKS)})
    phases.start("19a")
    shapes_and_plans_on_meta(torch)
    phases.start("19b")
    model, master, counts = specs_on_card(torch, np, VK)
    phases.start("19c")
    chunked_decode_on_card(torch, np, model, master, gemma["gemma"])
    del master
    torch.cuda.empty_cache()
    say(f"phase 19 (a-c) wall: {time.perf_counter() - t0:.3f} s")
    return counts


def _leaves(node):
    """The tensors of a parameter tree of dicts and lists."""
    if isinstance(node, (dict, list)):
        for v in (node.values() if isinstance(node, dict) else node):
            yield from _leaves(v)
    else:
        yield node


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: needs a GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SmokeFailure(f"{SRC / 'repro_torch'} not found: run from the "
                           f"root of a checkout")
    sys.path.insert(0, str(SRC))
    global KB, LA
    import numpy as np
    from repro_torch.benchmarks import kernel_bench as KB
    from repro_torch.kernels import launches as LA
    from repro_torch.core import vc_asgd as V
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import mamba_scan as MK
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rwkv6_scan as WK
    from repro_torch.core import compression as C
    from repro_torch.kernels import sparse_pack as SK
    from repro_torch.kernels import topk_mask as TK
    from repro_torch.kernels import vc_asgd_update as VK
    from repro_torch.kernels.launches import REPLACES, ROUTES, SOURCE

    # ---- 1. device --------------------------------------------------------
    phases = Phases()
    phases.start("1")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    say(f"nvidia-smi: {smi}")

    # ---- 2. build ---------------------------------------------------------
    phases.start("2")
    t0 = time.perf_counter()
    libs = build.build_all()
    say(f"build: {len(libs)} source(s) in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s)")
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "entry function" in line):
                say(f"ptxas {name}: {line.strip()}")

    # ---- 3. kernel parity -------------------------------------------------
    phases.start("3")
    numbers = parity(torch, np, VK, R, MAIN_N, timed=True)
    numbers.update(parity_scheme_kernels(torch, np, (VK, QK, SK), R, MAIN_N,
                                         MAIN_K, timed=True))
    for name, rec in wrapper_host_cost(torch, np, VK, SK, QK, TK,
                                       LA).items():
        numbers[name].update(rec)
    say_ptxas(build, "quantize", "B9", "quantize_kernel")
    say_ptxas(build, "vc_asgd_update", "B5", "easgd_kernel")
    parity(torch, np, VK, R, BIG_N, timed=True)
    torch.cuda.empty_cache()
    parity_scheme_kernels(torch, np, (VK, QK, SK), R, BIG_N, (BIG_K,),
                          timed=True)
    torch.cuda.empty_cache()

    # ---- 4a. quickstart --smoke: card vs CPU ------------------------------
    phases.start("4a")
    VK.reset_launch_count()
    res_gpu, wall_gpu = run("cuda", smoke=True)
    check_counts(VK, res_gpu, "smoke on cuda")
    check(VK.launch_count("assimilate_flat") == 0, "Eq. 2 ran in the Eq. 1 loop")
    VK.reset_launch_count()
    res_cpu, wall_cpu = run("cpu", smoke=True)
    check(VK.launch_count() == 0, "the CPU run launched a CUDA kernel")
    say(f"smoke wall: cuda {wall_gpu:.3f} s, cpu {wall_cpu:.3f} s")
    for f in TRACE:
        check(getattr(res_gpu, f) == getattr(res_cpu, f),
              f"trace field {f}: cuda {getattr(res_gpu, f)} != cpu "
              f"{getattr(res_cpu, f)}")
    check(dataclasses.asdict(res_gpu.wire) == dataclasses.asdict(res_cpu.wire),
          "wire stats differ between cuda and cpu")
    check(len(res_gpu.points) == len(res_cpu.points) == 2, "epoch count")
    worst = 0.0
    for a, b in zip(res_gpu.points, res_cpu.points):
        check(a.t_complete == b.t_complete, f"epoch {a.epoch} t_complete")
        worst = max(worst, abs(a.acc_mean - b.acc_mean))
        say(f"smoke epoch {a.epoch}: t {a.t_complete:.3f} s, acc_mean cuda "
            f"{a.acc_mean:.4f} cpu {b.acc_mean:.4f}")
    check(worst <= ACC_BAND, f"acc_mean differs by {worst} > {ACC_BAND}")
    buf = res_gpu.scheme_state.params.buf
    check(bool(torch.isfinite(buf).all()) and buf.shape == (MAIN_N,),
          "server bus not finite or wrong shape")
    say(f"smoke trace identical cuda vs cpu; acc_mean max diff {worst:.4f} "
        f"(band {ACC_BAND})")

    # ---- 4b. Eq. 2: four results folded in one batch -----------------------
    phases.start("4b")
    from repro_torch.core import flat as F
    from repro_torch.core.tasks import MLPTask
    data, _ = quickstart(smoke=True)
    task = MLPTask()
    x = torch.from_numpy(data.x_train).cuda()
    y = torch.from_numpy(data.y_train).cuda().long()
    server = res_gpu.scheme_state.params
    alpha = V.var_alpha()(2)
    VK.reset_launch_count()
    trained = [task.client_train(server, x[100 * j:100 * (j + 1)],
                                 y[100 * j:100 * (j + 1)], steps=120, seed=j)
               for j in range(4)]
    merged = V.assimilate_many_flat(server, [server.with_buf(t) for t in trained],
                                    alpha)
    torch.cuda.synchronize()
    eq2_counts = VK.launch_counts()
    say(f"eq2 path: launches {eq2_counts}")
    check(eq2_counts["assimilate_flat"] == 1 and
          eq2_counts["adam_update_flat"] == 4 * 120, "Eq. 2 path launches")
    stacked = F.stack_flats([server.with_buf(t) for t in trained])
    plain = R.assimilate(server.buf, stacked,
                         V.assimilation_weights(4, alpha))
    check(bits_equal(torch, merged.buf, plain), "Eq. 2 path: kernel != plain")
    fold = server
    for t in trained:
        fold = V.vc_asgd_update_flat(fold, t, alpha)
    gap = float((fold.buf - merged.buf).abs().max())
    say(f"eq2 path: Eq. 2 vs Eq. 1 folded 4x max abs diff {gap:.3g}")
    check(gap <= 1e-5, f"Eq. 2 disagrees with the Eq. 1 fold by {gap}")

    # ---- 4c. the full quickstart configuration -----------------------------
    phases.start("4c")
    profile_smoke(torch, VK)
    from repro_torch.core.tasks import MLPTask
    from repro_torch.optim.optimizers import Adam
    from repro_torch.protocol.coordinator import Coordinator
    VK.reset_launch_count()
    (res, wall), spans = host_breakdown(
        lambda: run("cuda", smoke=False),
        [(MLPTask, "client_train"), (Adam, "update_flat"),
         (MLPTask, "evaluate"), (Coordinator, "issue"),
         (Coordinator, "submit"), (Coordinator, "deliver"),
         (Coordinator, "assimilate")])
    main_counts = check_counts(VK, res, "quickstart on cuda")
    check(res.epochs_done == QUICKSTART_EPOCHS
          and np.isfinite(res.final_accuracy),
          f"quickstart did not finish its {QUICKSTART_EPOCHS} epochs")
    say(f"quickstart: {res.results_assimilated} results, {res.client_steps} "
        f"client steps, wall {wall:.3f} s")
    say(f"{'epoch':>6} {'sim hours':>10} {'val acc':>8} {'spread':>7}")
    for p in res.points:
        say(f"{p.epoch:>6} {p.t_complete / 3600:>10.2f} {p.acc_mean:>8.3f} "
            f"±{p.acc_std:.3f}")
    say(f"quickstart final accuracy {res.final_accuracy:.4f}, preemptions "
        f"{res.preemptions}, reassignments {res.reassignments}, wire "
        f"{res.wire.frames_sent} frames / {res.wire.bytes_sent} B")
    for key, sec in sorted(spans.items(), key=lambda kv: -kv[1]):
        say(f"host span {key}: {sec:.3f} s ({100 * sec / wall:.1f}% of wall)")
    adam_s = spans.get("Adam.update_flat", 0.0)
    say(f"host span Adam.update_flat: {1e6 * adam_s / res.client_steps:.2f} "
        f"us a client step, {100 * adam_s / spans['MLPTask.client_train']:.1f}"
        f"% of client_train (inside it)")

    # ---- 4d. the pinned replay: every scheme, card vs CPU vs the pin ------
    phases.start("4d")
    pinned_counts = pinned_replay(torch, VK)
    say(f"pinned replay: launches summed over the 12 cases {pinned_counts}")

    # ---- 4e. the §IV-C comparison at the example's full configuration -----
    phases.start("4e")
    comparison(torch, VK)

    # ---- 6. serve: B13, internlm2-1.8b at full width, card vs CPU -------
    phases.start("6")
    numbers["flash_attention"] = attention_parity(torch, np, FK, R)   # 6a
    say_ptxas(build, "flash_attention_sm90", "B13 wgmma kernel")
    attention_host_cost(torch, FK)
    torch.cuda.empty_cache()
    serve_counts = serve_full_width(torch, VK)                        # 6b
    serve_card_vs_cpu(torch, VK, depth_cut("internlm2-1.8b"),       # 6c
                      {"flash_attention": CMP_LAYERS}, ATTN_ROUTES)

    # ---- 7. serve rwkv6: B14, rwkv6-1.6b at full width, card vs CPU -----
    phases.start("7")
    numbers["wkv6"] = wkv6_parity(torch, WK, R)                       # 7a
    rwkv_counts = serve_rwkv_full_width(torch, VK)                    # 7b
    serve_card_vs_cpu(torch, VK, depth_cut("rwkv6-1.6b"),           # 7c
                      {"wkv6": CMP_LAYERS})

    # ---- 8. serve jamba: B15, jamba-v0.1 one group at full width --------
    phases.start("8")
    numbers["mamba_scan"] = mamba_scan_parity(torch, MK, R)           # 8a
    say_ptxas(build, "mamba_scan", "B15")
    jamba_counts = serve_jamba_full_width(torch, VK)                  # 8b
    serve_card_vs_cpu(torch, VK, jamba_config(JAMBA_CMP_BLOCKS),      # 8c
                      {"mamba_scan": 1, "flash_attention": 1}, ATTN_ROUTES,
                      steps=JAMBA_CMP_STEPS)

    # ---- 9. the pod runtime's compressed cross-pod round ----------------
    phases.start("9")
    numbers.update(topk_parity(torch, np, TK, C, R))                  # 9a
    say_ptxas(build, "topk_mask", "B6", "stats_kernel")
    say_ptxas(build, "topk_mask", "B7", "exact_kernel")
    select_card_vs_cpu(torch, np, C, VK)                              # 9b
    pod_counts = pod_round_card_vs_cpu(torch, np, VK)                 # 9c
    coordinator_card_vs_cpu(torch, np, VK)                            # 9d

    # ---- 10. the port's kernel bench, with B4, B8 and B11 ----------------
    phases.start("10a")
    numbers.update(new_kernels_parity(torch, np, VK, TK, QK, SK, R))  # 10a
    phases.start("10b")
    bench_counts = bench_on_card(VK)                                  # 10b

    # ---- 11. the preemptible-instance story -----------------------------
    phases.start("11a")
    preemptible_on_card(torch, VK)                                    # 11a
    phases.start("11b")
    coordinator_checkpoints(torch, np, VK)                            # 11b
    phases.start("11c")
    paper_suites_on_card(torch, VK)                                   # 11c

    # ---- 12. fleets, the sharded bus, the tier, subscribers -------------
    phases.start("12a")
    fleet_counts = fleet_pinned(torch, VK)                            # 12a
    say(f"fleet pinned cases: launches summed {fleet_counts}")
    phases.start("12b")
    registry_on_card(torch, VK)                                       # 12b
    phases.start("12c")
    scenario_suites_on_card(torch, VK)                                # 12c

    # ---- 13. the wall-clock runtime, the frontier, the examples ---------
    import shutil
    tmp = ROOT / "build" / "chip_smoke_serve"    # git-ignored
    shutil.rmtree(tmp, ignore_errors=True)
    phases.start("13a")
    serve_card_vs_cpu_13a(torch, np, VK, tmp)                         # 13a
    phases.start("13b")
    serve_tier_on_card(torch, VK, tmp)                                # 13b
    phases.start("13c")
    serve_kill_and_resume(tmp)                                        # 13c
    phases.start("13d")
    frontier_on_card(torch, VK)                                       # 13d
    phases.start("13e")
    examples_and_cnn_on_card(torch, VK)                               # 13e

    # ---- 14. LLM VC training: B13's backward, internlm2, the MoE configs
    phases.start("14a")
    say_ptxas(build, "flash_attention_bwd_sm90", "B13 wgmma backward")
    numbers["flash_attention_bwd"] = attention_bwd_parity(torch, np, FK,
                                                          R)          # 14a
    phases.start("14b")
    train_counts = train_full_width(                                  # 14b
        torch, VK, tmp, depth_cut("internlm2-1.8b", TRAIN_LAYERS), "train",
        TRAIN_PARAMS, {"flash_attention": 2 * TRAIN_LAYERS,
                       "flash_attention_bwd": TRAIN_LAYERS},
        attn=2 * TRAIN_LAYERS)
    phases.start("14c")
    train_card_vs_cpu(                                                # 14c
        torch, VK, depth_cut("internlm2-1.8b"), "train card vs cpu",
        {"flash_attention": 2 * CMP_LAYERS, "flash_attention_bwd": CMP_LAYERS},
        {k: (FK, "flash_attention_bwd", i, sc, leaf, CMP_LAYERS)
         for k, (i, sc, leaf) in TRAIN_FAULTS.items()},
        (TRAIN_CMP_GNORM, TRAIN_CMP_LEAF_BF16))
    phases.start("14d")
    serve_moe_on_card(torch, VK)                                      # 14d

    # ---- 15. rwkv6 and jamba VC training: B14's and B15's backwards ----
    phases.start("15a")
    say_ptxas(build, "wkv6_bwd", "B14 backward")
    say_ptxas(build, "mamba_scan_bwd", "B15 backward")
    numbers["wkv6_bwd"] = wkv6_bwd_parity(torch, WK, R)               # 15a
    numbers["mamba_scan_bwd"] = mamba_scan_bwd_parity(torch, MK, R)
    rwkv_train_counts, jamba_train_counts = train_rwkv_jamba(     # 15b-d
        torch, VK, tmp, WK, MK, phases)

    # ---- 16. stablelm-3b and gemma3-4b: B13 at hd 80 and 256 -----------
    dense_hd_paths(torch, VK, FK, tmp, phases)                        # 16a-d

    # ---- 17. whisper and the VLM served and trained, granite trained ----
    whisper_and_vlm(torch, VK, FK, tmp, phases)                       # 17a-d

    # ---- 18. the pod mesh, the sharded bus, the plans' one-card forms -
    pod_counts18 = pod_mesh_and_plans(torch, np, VK, phases)          # 18a-e

    # ---- 19. the abstract shapes and plans; the chunked decode caches ---
    counts19 = shapes_and_plans(torch, np, VK, phases)                # 19a-c

    # ---- result lines -----------------------------------------------------
    phases.end()
    path_counts = {"assimilate_flat": eq2_counts,        # 4b
                   "vc_asgd_lerp_flat": main_counts,     # 4c
                   "adam_update_flat": main_counts,      # 4c
                   "flash_attention": serve_counts,      # 6b
                   "flash_attention_bwd": train_counts,  # 14b
                   "wkv6": rwkv_counts,                  # 7b
                   "wkv6_bwd": rwkv_train_counts,        # 15b
                   "mamba_scan": jamba_counts,           # 8b
                   "mamba_scan_bwd": jamba_train_counts,  # 15c
                   "blocked_topk_stats": pod_counts,     # 9c
                   "threshold_sparsify_exact": pod_counts,
                   "vc_asgd_dc_lerp_flat": bench_counts,  # 10b
                   "threshold_sparsify": bench_counts,    # 10b
                   "quantize_pack": bench_counts}         # 10b
    kernels = []
    for name in VK.KERNELS:
        r = numbers[name]
        launches = path_counts.get(name, pinned_counts)[name]   # else 4d
        check(launches > 0, f"{name} was never launched on its path")
        entry = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if name in pod_counts18:    # phase 18's launches of the kernel
            entry["launches_phase18"] = pod_counts18[name]
        if counts19.get(name):      # phase 19b's path (B13 only)
            entry["launches_phase19"] = counts19[name]
        if "host_us" in r:          # host us a wrapper call, where taken
            entry["host_us"] = r["host_us"]
            entry["library_host_us"] = r["library_host_us"]
        if name in ROUTES:          # B13: the main path's route, and both
            entry["source"] = ROUTES[name]["wgmma"]
            entry["sources"] = ROUTES[name]
            # the route (and so the source) of the bf16 main paths at
            # each head dim: every model the port serves or trains
            entry["route_by_head_dim"] = {
                str(hd): "wgmma" if hd in FK.WGMMA_HEAD_DIMS else "simt"
                for hd in FK.HEAD_DIMS}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
