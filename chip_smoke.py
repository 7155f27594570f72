#!/usr/bin/env python3
"""Smoke test of the PyTorch port (stoix_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device      — needs CUDA; TF32 off for matmuls and convolutions.
  2. build       — builds every kernel from the sources in stoix_tpu_torch/csrc/,
                   one nvcc per source, all started together; prints ptxas's
                   registers, spills and shared memory for every instance of
                   every library (B1's entry points, B2's forward and
                   backward, B3, and the wide route past head dim 256).
  3. kernel      — B1's generic entry point (linear recurrence) against its
                   plain PyTorch version on the card, bitwise: at ff_pqn's
                   [8, 1024] with resets, [16, 1024],
                   a ragged [17, 1000] with resets in float32 and bfloat16,
                   T in {1, 15, 16, 17, 33, 63, 64, 65, 129} (row and stage
                   edges) at 1000 columns, and a long rollout [128, 4096];
                   timed at [8, 1024], [16, 1024] and [128, 4096] with CUDA events, per
                   call from Python and per launch replayed from a CUDA graph,
                   beside an empty kernel on the same grid (the launch floor);
                   then from batch-major views at ff_awr's [7, 256] and
                   ff_mpo's and ff_mpo_continuous's Retrace shapes [6, 128]
                   and [14, 256], bitwise and timed (also a call through the
                   dispatch from the views).
  4. attention   — B2 (flash attention): the forward kernel against its plain
                   version at the ff_trans_ppo path's shapes ([1024|4096|16384,
                   16, 4, 32] float32 causal, from strided qkv views), the ring
                   phase's long window [64, 512, 4, 32] causal, a ragged causal
                   [2, 300, 2, 64], a ragged non-causal [2, 100, 2, 32], a
                   bfloat16 causal [1, 128, 1, 64], and head dims 8 and 128
                   and float16 ([1024, 16, 4, 8], [2, 300, 2, 128],
                   [1024, 16, 4, 32] float16, [2, 100, 2, 8] bfloat16), each
                   also run twice and held bitwise equal; the fused backward
                   kernel against the plain backward at [4096, 16, 4, 32]
                   causal, the ragged non-causal [2, 100, 2, 32],
                   [2, 300, 2, 64] causal (five key tiles), a bfloat16 causal
                   [1, 128, 1, 64], [1024, 16, 4, 8], [2, 200, 2, 128] and
                   [1024, 16, 4, 32] float16; each kernel timed at the path's
                   shapes, beside its plain version and SDPA (forward,
                   backward alone, and both).
  5. gae         — B1's GAE entry point (truncated GAE in one launch) against
                   its plain version, bitwise, at [16, 1024] with terminations
                   and truncations, a ragged [17, 1000] and [128, 4096]; timed
                   at [16, 1024]. Then GAE through the dispatch on the card
                   against the `scan` impl on the CPU (one GAE launch, no
                   generic one), and the composed path's own run: GAE with a
                   tensor lambda and in bfloat16, every B1 counter zeroed just
                   before and read just after (generic launches only). The
                   generic entry point is on neither training path: its
                   kernels-line `launches` is 0, and its composed-path
                   launches stand under `composed_path_launches`. Then the
                   five estimators that reach B1 through its generic entry
                   (the general off-policy return, Retrace at ff_mpo's
                   [128, 8] sequences, discounted returns, the importance-
                   corrected TD errors, V-trace) through the dispatch on the
                   card against the CPU's `scan`, bitwise, one generic launch
                   each (`estimator_launches`).
  6. learn       — ff_ppo trains IdentityGame on the card to a return above 8.0
                   (the JAX package's learning oracle, tests/test_ff_ppo.py).
  7. train       — Anakin ff_ppo on CartPole at the default config's full width
                   (1024 envs, T=16, MLP 256x256, 4 epochs x 4 minibatches) for
                   a few updates with system.multistep_impl=pallas; B1's two
                   counters are zeroed just before and read just after: one
                   GAE launch per update, no generic one.
  8. trans_learn — ff_trans_ppo trains IdentityGame on the card (window 4, one
                   layer) to a return above 8.0.
  9. trans_train — Anakin ff_trans_ppo on CartPole at its default config's full
                   width (1024 envs, T=16, window 16, 2 layers of 4 heads x 32,
                   FFN 256, 4 epochs x 4 minibatches), MAIN_UPDATES updates in 2 eval
                   windows with system.multistep_impl=pallas. Every counter is
                   zeroed just before the run and read just after; around each
                   learner call the learner's own launches are counted and must
                   be exact per update: 130 forward, 64 backward, 1 of B1's
                   GAE entry point, 0 of its generic one. The evaluator's
                   launches are the rest.
 10. ring_kernel — B3 (flash attention over one K/V chunk) against its plain
                   version on the card: every (rank, step) chunk of a 4-rank
                   causal ring over ff_trans_ppo's transformer at the torso's
                   default window (64 windows of 512, chunks [64, 128, 4, 32]
                   float32 with global positions: future, diagonal and visible
                   chunks), a non-causal chunk, Sq != Sk, a ragged chunk with
                   shuffled key positions, a bfloat16 [1, 128, 1, 64] and
                   visible chunks at head dims 8 and 128 and in float16; the
                   4 ranks' chunks folded as the ring folds them against
                   `full_attention` on the card; each shape timed.
 11. ring        — a one-rank NCCL process group (a `file://` store in a
                   temporary directory) and its mesh; the full-width torso's
                   forward on [64, 512] with ring attention as its attention
                   (exactly one B3 launch per layer, no B2) against the same
                   torso through B2 and through plain attention on the CPU;
                   timed beside the B2 torso and SDPA.
 12. c6          — attention at any head dim up to 128 and in float16 runs
                   through the kernels, as the TPU kernel takes any head dim
                   and float dtype: `best_attention` at D = 8, 128, 24 (padded
                   to 32) float32 and D = 32 float16, each one B2 forward
                   launch, and the one-rank NCCL ring at D = 8, 24 and 32
                   float16, each one B3 launch, against the CPU; then
                   ff_trans_ppo at its CPU test's small config (head_dim 8)
                   takes one update step on the card through B2's forward
                   and backward, with finite losses.

 13. c8          — head dims up to 256 run through the kernels (C8): B2's forward
                   and backward and B3 at D = 256 in float32, bfloat16 and
                   float16 against their plain versions ([1024, 16, 4, 256]
                   causal, the ragged [2, 300, 2, 256]); `best_attention` at
                   D = 200 (padded to 256) and `TransformerTorso` forward and
                   gradients at D = 256 against the CPU; one ff_trans_ppo
                   update at 4 heads x 256 through B2 (130 forward, 64
                   backward launches); the D = 256 forward, backward and B3
                   timed (a launch, a call) beside their bounds and SDPA.
 14. knobs       — ff_ppo at full width with every main-path knob on
                   (normalize_observations, update_guard=skip, fused_update,
                   update_batch_size=2, use_cached_auto_reset, the json and
                   wandb-offline sinks, save_model) for 2 eval windows:
                   env-steps/s, one B1 GAE launch an update at U = 2, device
                   launches per update (torch.profiler); a resume from window
                   1 bitwise equal to the unbroken run's final state; a
                   poisoned loss under skip ending with finite params and
                   skipped updates. IdentityGame with the same knobs above 8.0
                   runs with the oracles (knobs_learn).
 15. c8_wide     — head dims past 256 through the wide kernels: the forward,
                   backward and chunk kernels against their plain versions at
                   D = 257, 384, 512, 513 and 1000 (both sides of the 512-column
                   slice boundary) in three dtypes, causal and not, at S = 40;
                   `best_attention` at D = 257 and the torso at D = 384
                   against the CPU; then their paths, every counter zeroed
                   just before and read just after: one ff_trans_ppo update
                   at 2 heads x 512 (130 wide forward and 64 wide backward
                   launches, nothing narrow) and a one-rank ring at D = 384
                   (one wide chunk launch); the three against their plain
                   versions at the update's minibatch shape [4096, 16, 2, 384]
                   and [..., 512], then timed there beside their bounds and
                   SDPA. (Runs inside the mesh of phase ring, after c6 and
                   c8.)
 16. q_learn     — ff_dqn and ff_pqn (multistep_impl=pallas) train IdentityGame
                   on the card above 8.0 (the JAX package's oracles).
 17. q_train     — ff_dqn and ff_pqn at their default configs' full width on
                   CartPole, MAIN_UPDATES updates in 2 windows: env-steps/s per window,
                   device launches an update (torch.profiler); B1's counters
                   zeroed just before ff_pqn's run and read just after:
                   exactly one generic launch an update (Q(lambda)), no GAE
                   one; then ff_ddqn, ff_dqn_reg, ff_mdqn, ff_c51 and
                   ff_qr_dqn one window each at their default widths, finite.

 18. cont_learn  — ff_ppo_penalty with adaptive beta trains IdentityGame above
                   4.0 (the JAX package's oracle), and ff_ppo_continuous trains
                   Pendulum (64 envs, 524 288 steps, reward_scale 0.1) above
                   the midpoint of uniform random actions' return and the JAX
                   package's under the same overrides, fixed beforehand by
                   scripts/jax_oracle_thresholds.py.
 19. cont_train  — ff_ppo_continuous at its default config's full width (1024
                   Pendulum envs, T=16, MLP 256x256, the tanh-Gaussian head on
                   [-2, 2], 4 x 4 minibatches), MAIN_UPDATES updates in 2 eval windows
                   with system.multistep_impl=pallas: B1's counters zeroed just
                   before and read just after (one GAE launch an update, no
                   generic one), env-steps/s, device launches an update; then
                   ff_ppo_penalty (CartPole, adaptive beta),
                   ff_ppo_penalty_continuous, ff_dpo_continuous (4 x 16
                   minibatches), and the Beta and diagonal-Gaussian heads, one
                   window each at their default widths, each with one GAE
                   launch an update.
 20. rec_learn   — rec_ppo trains IdentityGame above 8.0 (64 envs, 32 768
                   steps, where the JAX package's rec_ppo returns 10.0).
 21. rec_train   — rec_ppo at its default config's full width (1024 CartPole
                   envs, T=16, GRU 128 between torsos of 128, 4 x 4 minibatches
                   of env sequences), MAIN_UPDATES updates in 2 eval windows: one GAE
                   launch an update, env-steps/s, device launches an update.
 22. rainbow_learn — ff_rainbow trains IdentityGame above 8.0 (16 envs,
                   65 536 steps, C51 on [0, 10]; the JAX package returns
                   10.0 there, scripts/jax_oracle_thresholds.py).
 23. rainbow_train — ff_rainbow at its default config's full width (128
                   CartPole envs, T = 8, a prioritised buffer of 100 000
                   steps of 4-step sequences, 4 epochs of 256, MLP 256 then
                   the noisy dueling C51 head with 128-wide streams and 51
                   atoms on [0, 500]), MAIN_UPDATES updates in 2 windows
                   through `run_experiment`, every kernel counter zeroed just
                   before and read just after (no kernel is on this path:
                   each count must stay 0); env-steps/s, device launches an
                   update (torch.profiler), the buffers' device bytes, the
                   duplicate indices `set_priorities` collapsed, one update
                   on the card against the same update on the CPU (loss and
                   priorities 1e-5 relative, params 1e-5 absolute) and
                   `set_priorities` on the card twice on indices with
                   duplicates (bitwise both times, the last occurrence of
                   every index written, on the card and on the CPU).
 24. r2d2_learn  — rec_r2d2 trains IdentityGame above 8.0 (16 envs, 131 072
                   steps; the JAX package returns 8.99 there).
 25. r2d2_train  — rec_r2d2 at its default config's full width (1024
                   CartPole envs, T = 16, a GRU of 128 between silu torsos
                   of 128, 64 sequences of 8 burn-in + 8 trained steps at
                   period 4, 2 epochs): as rainbow_train.
 26. data_parallel — data-parallel Anakin training through `run_experiment`
                   at full width (ff_ppo: CartPole, 1024 envs, MAIN_UPDATES updates in 2
                   windows, multistep_impl=pallas, normalize_observations on,
                   so the statistics are reduced too), B1's counters zeroed
                   just before each run and read just after:
                   (a) a one-rank NCCL group that the runner forms itself from
                   `arch.distributed.*`, against the same run with no group:
                   params, optimizer states and statistics bitwise equal,
                   one GAE launch an update; the same for ff_pqn (one generic
                   launch an update);
                   (b) two ranks, started by this script as subprocesses
                   (`--data-parallel-rank`): NCCL with one card each when
                   the host has two, else both ranks on the one card over a
                   gloo group that the ranks form themselves; identical params,
                   optimizer states and statistics on both ranks after the
                   run, one GAE launch an update on each, epochs x minibatches
                   gradient all-reduces an update. Each case prints the
                   backend, the ranks, the envs a rank, the all-reduces an
                   update, env-steps/s a rank and in total, and the card.

 27. mpo_train   — ff_mpo (64 CartPole envs, T = 8, a 100 000-step trajectory
                   buffer, 4 epochs of 128 sequences of 8) and
                   ff_mpo_continuous (64 Pendulum envs, 32 epochs of 256
                   sequences of 16, 128 action samples, MLPs 4 x 256) at their
                   default configs, MAIN_UPDATES updates in 2 windows with
                   multistep_impl=pallas, every kernel counter zeroed just
                   before and read just after: exactly 4 and 32 launches of
                   B1's generic entry an update (Retrace, one an epoch), 0 of
                   every other kernel; env-steps/s a window, device launches
                   an update (torch.profiler), the buffer's device bytes, an
                   update's peak device bytes, and one epoch on the card
                   against the CPU (losses 1e-5 relative, params 1e-5
                   absolute).
 28. mpo_learn   — ff_mpo trains IdentityGame above 8.0 (16 envs, 16 384 steps;
                   the JAX package returns 10.0 there).
 29. vmpo_train  — ff_vmpo (1024 CartPole envs, T = 32, 16 full-batch epochs)
                   and ff_vmpo_continuous (1024 Pendulum envs), as mpo_train:
                   exactly 16 launches of B1's GAE entry an update (one an
                   epoch); the epoch on the card against the CPU also compares
                   the top halves index for index.
 30. vmpo_learn  — ff_vmpo trains IdentityGame above 8.0 (64 envs, 32 768
                   steps; the JAX package returns 10.0 there).
 31. mcts        — the batched MCTS (stoix_tpu_torch/search/mcts.py) on the
                   card against the same calls on the CPU: a random tabular
                   MDP from a numpy seed, B = 64, A = 4, 50 simulations,
                   max_depth 50 and 4, muzero_policy and gumbel_muzero_policy;
                   the tree's integer arrays and the actions equal, its float
                   arrays, weights and values within 1e-6 (whether bitwise is
                   printed); device launches a search (torch.profiler).
 32. search_train — ff_az (64 CartPole envs, T = 8, 16 simulations, MLPs
                   256 x 256), also with search_method=gumbel and with
                   use_replay_buffer=true, ff_mz (25 simulations, a world model
                   of 64 with an LSTM, 601 atoms), ff_sampled_az and
                   ff_sampled_mz (64 Pendulum envs, 50 simulations, K = 8) at
                   their default configs, SEARCH_UPDATES updates, one a window
                   (the sampled paths one in one window)
                   with multistep_impl=pallas, every kernel counter zeroed just
                   before and read just after: exactly 1, 1, 4, 0, 64 and 0
                   launches of B1's GAE entry an update, 0 of every other
                   kernel; env-steps/s a window, device launches a searched
                   step and an update, the buffer's device bytes, an update's
                   peak device bytes, one update or epoch on the card against
                   the CPU (losses 1e-5 relative, params 1e-5 absolute). Then
                   B1's GAE entry timed at ff_az's [8, 64] and at the replay
                   paths' [7, 32] from a batch-major view.
 33. az_learn    — ff_az trains IdentityGame above 8.0 (64 envs, 16 384 steps,
                   8 simulations; the JAX package returns 10.0 there).
 34. mz_learn    — ff_mz trains IdentityGame above 8.0 (16 envs, 16 384 steps,
                   8 simulations, 16 epochs of sequences of 3 at lr 1e-2; the
                   JAX package returns 10.0 there).

 35. spo_train   — ff_spo (64 CartPole envs, T = 32, 16 particles over a
                   horizon of 4, MLPs 256 x 256, 64 epochs of 32 sequences of
                   32) and ff_spo_continuous (64 Pendulum envs) at their default
                   configs, SPO_UPDATES updates in 2 windows with
                   multistep_impl=pallas, every kernel counter zeroed just
                   before and read just after: exactly 64 launches of B1's GAE
                   entry an update (one an epoch), 0 of every other kernel;
                   env-steps/s a window, device launches a searched step and an
                   update, the buffer's device bytes, an update's peak device
                   bytes; one epoch on the card against the CPU (losses 1e-5
                   relative, params and duals 1e-5 absolute) and one searched
                   step from draws made on the CPU (resampling decisions and
                   choices exact, particle actions exact or 1e-6 on Pendulum,
                   weights 1e-6).
 36. disco_train — ff_disco103 at its default config's full width (1024
                   CartPole envs, T = 16, 2 epochs x 4 env-minibatches, MLP
                   256 x 256, LSTM 128, 51 bins) in grounded mode, MAIN_UPDATES
                   updates in 2 windows, no kernel on the path (every count
                   0); env-steps/s, device launches an update, peak device
                   bytes; then one update in meta mode from an npz the phase
                   writes with the port's `flatten_meta_params`; in each mode
                   one minibatch step on the card against the CPU (losses 1e-5
                   relative, params and the EMA params 1e-5 absolute). Then
                   B1's GAE entry timed at SPO's [32, 32] from the batch-major
                   sequences (a launch, a call, a call through the dispatch,
                   the empty kernel on the same grid).
 37. spo_learn   — ff_spo trains IdentityGame above 8.0 (64 envs, 16 384 steps,
                   16 epochs; the JAX package returns 10.0 there).
 38. disco_learn — ff_disco103 trains IdentityGame above 8.0 (64 envs, 131 072
                   steps, policy temperature 16; the JAX package returns 10.0).
 39. spo_continuous_learn, vmpo_continuous_learn — ff_spo_continuous (64
                   envs, 393 216 steps, 16 epochs) and ff_vmpo_continuous (64
                   envs, 1 048 576 steps) train Pendulum above the midpoint of
                   uniform random actions' return and the JAX package's under
                   the same overrides (PENDULUM_ORACLES, PENDULUM_THRESHOLDS).

 40. vision_train — ff_ppo on 84x84x4 pixel Breakout (env=breakout_pixel_jax)
                   with the Nature CNN (network=cnn_atari: conv 32/8/4, 64/4/2,
                   64/3/1, dense 512, actor and critic) at the default config's
                   full width (1024 envs, T = 16, 4 epochs x 4 minibatches),
                   MAIN_UPDATES updates in 2 windows with
                   multistep_impl=pallas, every kernel counter zeroed just
                   before and read just after: exactly one launch of B1's GAE
                   entry an update, 0 of every other kernel; env-steps/s a
                   window, device launches an env step and an update
                   (torch.profiler), an update's peak device bytes, finite
                   losses.
 41. minatar_train — one window each at the default arch: ff_ppo + cnn on
                   Breakout-, Asterix-, Freeway- and SpaceInvaders-minatar,
                   ff_ppo + visual_resnet on Breakout-minatar, ff_ppo +
                   mlp_resnet on CartPole (one GAE launch an update each),
                   ff_dqn + cnn_dqn and ff_c51 + cnn_c51 on Breakout-minatar
                   (no kernel launch); finite.
 42. vision_parity — TF32 off for matmuls and cuDNN: 50 steps of pixel
                   Breakout and of each MinAtar game (64 envs, no auto-reset)
                   on the card and on the CPU from the same reset draws and
                   actions, every timestep equal; at 32 envs, from the same
                   rollout, params and permutations on the card and on the
                   CPU: one ff_ppo update with visual_resnet
                   (Breakout-minatar; losses 1e-5 relative, params 1e-5
                   absolute) and one update of one minibatch with cnn_atari
                   (pixel Breakout, one Adam step: over 16 the Nature CNN's
                   float32 sums part the params by 2.9e-4); the losses'
                   absolute floor 1e-6 (the clip loss sits near 0).
 43. catch_learn — ff_ppo + cnn trains Catch (bsuite, 64 envs, CATCH) above
                   CATCH_THRESHOLD, the midpoint of uniform random actions'
                   return and the JAX package's under the same overrides,
                   fixed beforehand by scripts/jax_oracle_thresholds.py.
 44. loco_train — ff_ppo_continuous on Ant (env=ant,
                   normalize_observations on) at the default config's full
                   width (1024 envs, T = 16, 4 epochs x 4 minibatches, MLPs
                   256 x 256, 27-dim observations, 8 actions), MAIN_UPDATES
                   updates in 2 windows with multistep_impl=pallas, every
                   kernel counter zeroed just before and read just after:
                   exactly one launch of B1's GAE entry an update, 0 of every
                   other kernel; env-steps/s a window, device launches a
                   control step and an update, an update's peak device bytes,
                   finite losses. Then ff_sac on Ant at its default config
                   (64 envs, T = 8, 32 warm-up steps, 4 epochs of 512): no
                   kernel launch. Episodes cut to LOCO_MAX_STEPS control
                   steps, no absolute metric (LOCO_COMMON).
 45. loco_envs   — one window each of ff_ppo_continuous on Hopper, Walker2d
                   and HalfCheetah (one GAE launch an update), then the four
                   robots on the card against the CPU: LOCO_PARITY_STEPS
                   control steps, each from the CPU's state, within 1e-5.
 46. grid_train  — one window each at the default arch: ff_dqn, ff_c51 and
                   ff_dqn + cnn_dqn on Snake (no kernel launch), ff_ppo on
                   Snake, 2048 and DoorKey (one GAE launch an update), finite;
                   then the three games on the card against the CPU from the
                   same draws, every timestep equal for GRID_ENV_STEPS steps.
 47. snake_learn — ff_ppo trains Snake (6x6, 64 envs, SNAKE) above
                   SNAKE_THRESHOLD, the midpoint of uniform random legal
                   actions' return and the JAX package's under the same
                   overrides, fixed beforehand by
                   scripts/jax_oracle_thresholds.py.
 48. sebulba_train — Sebulba (actor threads, the rollout pipeline, the
                   parameter server, the asynchronous evaluator, the native
                   C++ env pool built with g++ in phase build) with every role
                   on the card: ff_ppo at the JAX package's tracked shape (512
                   cvec CartPole envs in 2 actors, T = 64, MLP 256 x 256, 4 x 4
                   minibatches, multistep_impl=pallas), SEBULBA_UPDATES
                   updates in 2 windows, every kernel counter zeroed just
                   before and read just after: exactly one launch of B1's GAE
                   entry an update at [64, 512], 0 of every other kernel;
                   exactly that many learn steps, no actor crash, supervisor
                   restart or evaluator error; steady env-steps/s and fps, the
                   learner's rollout get-wait, the actors' inference and
                   env-step means, a learn step's device launches and peak
                   bytes. Then default_ff_ppo.yaml as it is (64 CartPole envs
                   on the host through the stateful wrapper), one window.
 49. sebulba_pixel — ff_ppo on the pool's 84x84x4 pixel Breakout with
                   cnn_atari (128 envs, T = 32), 4 updates in 2 windows, one
                   GAE launch an update, the run's peak device bytes.
 50. sebulba_envs — ff_ppo on the pool's Pendulum (continuous, a negative
                   return; one GAE launch an update), ff_impala and
                   ff_impala_shared_torso at their defaults (64 cvec CartPole
                   envs, T = 16): exactly 4 generic B1 launches an update at
                   [16, 16], no GAE launch.
 51. sebulba_parity — a learn step of each Sebulba system on the card against
                   the CPU (losses 1e-5 relative, 1e-6 floor; params 1e-5
                   absolute); B1's two entries at the Sebulba shapes bitwise
                   against their plain versions; the tree an actor holds
                   bitwise unchanged after the learner's next two updates.
 52. sebulba_ppo_learn, sebulba_impala_learn — Sebulba ff_ppo and ff_impala
                   learn IdentityGame (SEBULBA_IDENTITY) above
                   SEBULBA_THRESHOLD, 8.0: the JAX package returns 10.0 for
                   seeds 42 and 1 in both (scripts/jax_oracle_thresholds.py).
 53. sebulba_replay — the sharded replay service alone at bench.py --replay's
                   shape (REPLAY_BENCH: 64-float observations, 4 096 slots,
                   batches of 512, chunks of 2 048, prioritized), one shard
                   on the card: sampled items/s over 64 add -> sample ->
                   set_priorities cycles, the ledger (ingested bytes against
                   sampled bytes crossed), the ring's device bytes, a cycle's
                   device launches, no kernel launch; one sample and one
                   set_priorities against a CPU copy of the ring from the
                   same uniforms (indices and rows exact, probabilities and
                   priorities 1e-6).
 54. sebulba_dqn_train — Sebulba ff_dqn at default_ff_dqn.yaml (64 CartPole
                   envs in 2 actors, T = 8, 8 epochs of 512 from a 100 000-
                   item ring, min_fill 1 024, MLP 256 x 256), uniform then
                   prioritized, SEBULBA_DQN_UPDATES updates in 2 windows,
                   every kernel counter zeroed just before and read just
                   after: no launch; steady env-steps/s and fps, the
                   learner's ingest and learn means, the actors' means, the
                   ring's device bytes, the replay ledger, no actor crash,
                   restart or evaluator error; a learn step's device
                   launches and peak bytes above the state.
 55. sebulba_impact_train — Sebulba ff_ppo with IMPACT at the tracked shape
                   (512 cvec CartPole envs, T = 64, 4 x 4 minibatches,
                   pallas), SEBULBA_UPDATES updates: exactly one B1 GAE
                   launch an update at [64, 512], the impact stats (fresh and
                   reused updates, staleness, at least one target refresh).
 56. sebulba_offpolicy_parity — TF32 off: an ff_dqn learn step, uniform (8
                   epochs) and prioritized (one epoch from non-dyadic
                   priorities), and an IMPACT learn step on the card against
                   the CPU from the same ring, params, uniforms, batch,
                   permutations and target (losses 1e-5 relative, 1e-6
                   floor; params 1e-5 absolute; priorities 1e-6); the IMPACT
                   step's one GAE launch, B1 bitwise on its inputs.
 57. sebulba_dqn_learn, sebulba_impact_learn — Sebulba ff_dqn
                   (SEBULBA_DQN_IDENTITY: a 4 096-item uniform ring) and
                   IMPACT learn IdentityGame above 8.0: the JAX package
                   returns 10.0 for seeds 42 and 1 in both.
 58. gossip_train — TF32 off, gossip-grouped Anakin ff_ppo at
                   default/gossip/default_ff_ppo.yaml (CartPole, 1024 envs
                   a group, T = 16, 4 x 4 minibatches, MLP 256 x 256,
                   pallas), MAIN_UPDATES updates in 2 windows: (a) one group
                   is every leaf of every window bitwise the plain Anakin
                   run, no round dispatched; (b) two groups, ring, w = 0.5,
                   as two ranks on the one card over gloo
                   (`--gossip-rank`): a round a window, the groups' params
                   different before each round and their mean kept by it
                   (GOSSIP_MEAN_TOLERANCE), one B1 GAE launch an update on
                   each rank, every gradient all-reduce on the rank's own
                   group (epochs x minibatches an update), env-steps/s per
                   group and in total, the gossip step's wall ms.
 59. sebulba_adapters — Sebulba ff_ppo with cnn_atari through
                   `EnvPoolAdapter` over AtariDoublePool (envpool's surface:
                   84x84x4 frames, lives, elapsed_step, partial steps by env
                   ids) at sebulba_pixel's shape, one GAE launch an update;
                   its task id has no tensor-env twin, so it evaluates
                   through `get_stateful_evaluator_fn` (the episodes and host
                   steps of each evaluation); then Sebulba ff_dqn on the
                   pool's RAM frames, one window, no launch.
 60. ring_grad    — C27: a one-rank NCCL ring's output and q, k, v
                   gradients on card-drawn [64, 512, 4, 32], causal and not,
                   against float64 full attention on the host (RING_GRAD_
                   TOLERANCE of each gradient's largest entry; the output
                   2e-5), timed beside full attention's; `use_flash=True`
                   under grad refused naming C5; the tensor-parallel block
                   on one model shard against `reference_block`.
 61. ops_train    — A19a, the operations layer of one process, on the main
                   path: ff_ppo at the default config's full width,
                   MAIN_UPDATES updates in 2 windows, every switch on
                   (preflight with its probe child, the integrity sentinel
                   with the determinism probe every window, telemetry,
                   checkpoints, update_guard=skip), then every switch off:
                   the final states bitwise equal, one B1 GAE launch an
                   update (plus the probe's replay of window 0), trace.json
                   and metrics.prom valid, the probe clean, the fingerprint
                   of the card's state equal to the CPU's; env-steps/s on and
                   off, the probe child's and the first-compile stage's
                   seconds, the fingerprint's launches and ms, the memory
                   gate's prediction beside window 0's measured peak.
 62. ops_faults   — the Anakin faults: a child under sigterm:0 exits 0 with
                   its checkpoint and a run resumed from it ends bitwise in
                   the unbroken (ops_train off) state; two gloo ranks on the
                   card under bitflip:1 exit 88 with the quarantine file, its
                   flight record and no checkpoint of the flipped window;
                   here, nan_loss under skip (one skip, finite params),
                   backend_wedge (two 3 s attempts), slow_compile (the
                   first_compile watchdog) and ckpt_corrupt (the fallback
                   with its reason).
 63. fleet_train  — A19b, the operations layer across processes, on the
                   main path: two ranks on the card over gloo (a tcp://
                   store for the fleet run, a file:// one for the other)
                   run ff_ppo at the default config's full width (1024 envs
                   in total, 512 a rank), MAIN_UPDATES updates in 2
                   windows, with `arch.fleet` and the HTTP ops plane off,
                   then on, then off again (warm, beside on): the final
                   states bitwise equal on both ranks,
                   one B1 GAE launch an update on each rank, `/metrics/fleet`
                   scraped while the run is live carrying both ranks' host
                   labels and `/healthz` answering 200; env-steps/s a window
                   on and off, the rescue snapshot's host copy (ms a window,
                   bytes) and the skew ratio.
 64. fleet_faults — at the same width, three pairs of ranks at once: SIGTERM
                   to rank 1 (sigterm:0 over 3 windows: both stop at window
                   1 and exit 0); host_loss:2 on rank 1 (the survivor exits
                   87 naming process 1, with the seconds from the freeze to
                   the declaration and to the exit; a relaunch at one
                   process here restores the emergency store, every params/
                   digest the manifest's, and trains to its end); shrink:0
                   (both exit 89 with a resize request for one device). Then
                   the sigterm pair's two-rank store restored in one process
                   and the relaunch's one-process store over two ranks
                   through the checkpointer, the replicated leaves bitwise
                   and the per-rank fields reported; no child left, the
                   store's port free.
 65. population  — population training (in the pool) at
                   default/population/default_ff_ppo.yaml's full width
                   (CartPole, 1024 envs a member, T=16, 4 x 4 minibatches,
                   MLP 256x256, pallas): (a) one member, PBT off, every leaf
                   of every window bitwise the plain ff_ppo run; (b) 8
                   members, ent_coef lifted to [0.001 ... 0.008], PBT every 2
                   windows over 4 windows of one update: clone pairs bitwise
                   at the fire windows and none between, 4 exploited
                   members, the changed hparams at float32(0.8 or 1.2) times
                   a survivor's, 8 B1 GAE launches an update, env-steps/s in
                   total and a member; (c) (b)'s state as a fleet emergency
                   store restored at 4 and 12 members through the
                   population's raw transform (whole leaves at the store's
                   digests, survivors and old members bitwise, clones'
                   hparams at the exact products); (d) (b) as two ranks of
                   four members (`arch.mesh.pop=2`) on the card over gloo,
                   every leaf of every window bitwise (b)'s rows.

Once every kernel is timed (after c8_wide, B1's GAE entry at the search and
SPO shapes included), a pool of child processes of this script runs beside
the main process's later phases (knobs onwards): the learning oracles
(learn, knobs_learn, trans_learn, q_learn, cont_learn, rec_learn,
rainbow_learn, r2d2_learn, sac_learn, vpg_learn, awr_learn, mpo_learn,
vmpo_learn, az_learn, mz_learn, spo_learn, disco_learn, spo_continuous_learn,
vmpo_continuous_learn, catch_learn, snake_learn, sebulba_ppo_learn,
sebulba_impala_learn, sebulba_dqn_learn, sebulba_impact_learn,
population_learn; each `--learn-phase NAME`) and the phases whose numbers no
kernel timing reads (rec_train, mpo_train and vmpo_train, mcts, search_train,
spo_train and disco_train, loco_train, loco_envs and grid_train, population;
`--pool-phase NAME SMI`),
LEARN_WORKERS at a time (four at least, more where the host has the cores;
`host_cpus` is printed), the longest first. Their lines are printed when the
main process's phases are done, and a `learn_all` line gives the pool's wall
time. The env-steps/s and seconds of every phase from knobs on are taken
beside the pool, on a shared host and card. Every child dies with its parent
(PR_SET_PDEATHSIG), the main process adopts its children's orphans and stops
any process left when it ends, and SIGTERM ends it through its cleanup. Then a
`{"kernels": [...]}` line, the card's `nvidia-smi` name and power limit, and
last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import glob
import inspect
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from stoix_tpu_torch import envs, parallel
from stoix_tpu_torch.buffers.buffers import duplicate_indices
from stoix_tpu_torch.kernels import (
    build, flash_attention, flash_attention_chunk, flash_attention_wide, linear_recurrence,
)
from stoix_tpu_torch.networks.attention import TransformerTorso
from stoix_tpu_torch.ops import (
    best_attention, scan_kernels, truncated_generalized_advantage_estimation,
)
from stoix_tpu_torch.ops.ring_attention import fold_chunk, full_attention, ring_attention
from stoix_tpu_torch.systems import anakin, runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo, ff_trans_ppo
from stoix_tpu_torch.systems.q_learning import (
    ff_c51, ff_ddqn, ff_dqn, ff_dqn_reg, ff_mdqn, ff_pqn, ff_qr_dqn, q_family,
)
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map, tree_stack

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# The full-width paths' updates, one an eval window (2, not 4, so that the
# Sebulba phases fit in the script's time).
MAIN_UPDATES = 2
# ff_trans_ppo's default config: layers, heads, head dim, window, rollout, epochs, minibatches.
TRANS = dict(layers=2, heads=4, head_dim=32, window=16, rollout=16, epochs=4, minibatches=4)
TRANS_ENVS = 1024
RECURRENCE_SOURCE = "stoix_tpu_torch/csrc/linear_recurrence.cu"
RECURRENCE_REPLACES = "stoix_tpu/ops/scan_kernels.py:198"
ATTENTION_SOURCE = "stoix_tpu_torch/csrc/flash_attention.cu"
ATTENTION_REPLACES = "stoix_tpu/ops/pallas_attention.py:154"
CHUNK_SOURCE = "stoix_tpu_torch/csrc/flash_attention_chunk.cu"
CHUNK_REPLACES = "stoix_tpu/ops/pallas_attention.py:255"
WIDE_SOURCE = "stoix_tpu_torch/csrc/flash_attention_wide.cu"
# B1's generic launches from batch-major sequence views: ff_awr's lambda
# returns, ff_mpo's and ff_mpo_continuous's Retrace ([L - 2, B]).
BATCH_MAJOR_SHAPES = ((7, 256), (6, 128), (14, 256))
RING_BATCH = 64  # windows per forward in the ring phases
RING_RANKS = 4  # the ring the ring_kernel phase emulates


def cpu_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The causal reference on the host in float64, rounded to float32. The
    card's host rounds float32 batched matmuls off by up to 8.6e-5 in about
    one process of eight (PERF.md §7): the references are exact instead."""
    return full_attention(*(x.detach().cpu().double() for x in (q, k, v)), causal=True).float()


def cpu_torso_reference(torso: torch.nn.Module, x: torch.Tensor):
    """A torso's output and parameter gradients of (out ** 2).sum() on the
    host in float64 (see `cpu_attention`), rounded to float32."""
    ref = copy.deepcopy(torso).cpu().double()
    out = ref(x.cpu().double())
    (out ** 2).sum().backward()
    return out.detach().float(), [p.grad.float() for p in ref.parameters()]


START = time.perf_counter()


def emit(record: dict) -> None:
    """One JSON line, with the seconds since this process started."""
    print(json.dumps({**record, "elapsed_s": time.perf_counter() - START}), flush=True)


# Every process this script starts ends with it: the children of this script
# die with their parent (PR_SET_PDEATHSIG), the main process adopts its
# children's orphans (PR_SET_CHILD_SUBREAPER) and stops whatever is left when
# it ends, and SIGTERM ends it through its `finally` blocks.
PR_SET_PDEATHSIG, PR_SET_CHILD_SUBREAPER = 1, 36
PARENT_ENV = "CHIP_SMOKE_PARENT_PID"


def _prctl(option: int, value: int) -> None:
    if ctypes.CDLL(None, use_errno=True).prctl(option, value, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), f"prctl({option}, {value}) failed")


def die_with_parent() -> None:
    """A child of this script: SIGKILL when the process that started it
    ends, and exit now if it already has."""
    _prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if str(os.getppid()) != os.environ.get(PARENT_ENV):
        os._exit(1)


def _terminated(signum, frame) -> None:
    raise SystemExit(128 + signum)


def adopt_children() -> None:
    """The main process: orphans of its children become its own, SIGTERM
    unwinds through every `finally`, and the children know their parent.
    SIGINT gets Python's handler back: the first-compile watchdog
    interrupts the main thread through it (ops_faults' slow_compile), and a
    shell starts a background job with SIGINT ignored."""
    _prctl(PR_SET_CHILD_SUBREAPER, 1)
    signal.signal(signal.SIGTERM, _terminated)
    signal.signal(signal.SIGINT, signal.default_int_handler)
    os.environ[PARENT_ENV] = str(os.getpid())


def _children() -> dict:
    """This process's children (adopted orphans included): pid -> state."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rpartition(")")[2].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid():
            children[int(entry)] = fields[0]
    return children


def stop_leftovers() -> list:
    """Kill and reap every child still here; returns the command lines of
    those that were still running (a zombie is only reaped)."""
    stopped = []
    for _ in range(50):
        children = _children()
        if not children:
            break
        for pid, state in children.items():
            if state != "Z":
                with contextlib.suppress(OSError):
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        stopped.append(f.read().replace(b"\0", b" ").decode(errors="replace"))
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL)
        for pid in children:
            with contextlib.suppress(OSError):
                os.waitpid(pid, 0)
    for command in stopped:
        print(f"[chip_smoke] stopped a leftover process: {command}", file=sys.stderr, flush=True)
    return stopped


def cuda_ms(fn, repeats: int = 21, inner: int = 50, warmup: int = 10) -> float:
    """Median over `repeats` of the per-call time of `inner` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, inner: int = 20) -> float:
    """Device time per call: `inner` calls captured in one CUDA graph and
    replayed, so the host's per-launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, inner=1) / inner


def recurrence_inputs(t_len: int, batch: int, dtype: torch.dtype, resets: bool, seed: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    w = torch.rand((t_len, batch), generator=gen, device="cuda") * 0.99
    if resets:
        w = torch.where(torch.rand((t_len, batch), generator=gen, device="cuda") < 0.05, 0.0, w)
    d = torch.randn((t_len, batch), generator=gen, device="cuda")
    init = torch.randn((batch,), generator=gen, device="cuda")
    return w.to(dtype), d.to(dtype), init.to(dtype)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi, "host_cpus": os.cpu_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def ptxas_instances(lines: list) -> list:
    """One record per kernel instance from ptxas's `-v` lines: registers,
    spill stores and loads (bytes), static shared memory (bytes)."""
    fields = {"registers": r"Used (\d+) registers", "spill_stores": r"(\d+) bytes spill stores",
              "spill_loads": r"(\d+) bytes spill loads", "smem": r"(\d+) bytes smem"}
    instances = []
    for line in lines:
        if "Compiling entry function" in line:
            instances.append({"kernel": line.split("'")[1], **dict.fromkeys(fields)})
        elif instances:
            for key, pattern in fields.items():
                found = re.search(pattern, line)
                if found:
                    instances[-1][key] = int(found.group(1))
    return instances


def phase_build() -> None:
    from stoix_tpu_torch.envs import cvec

    sources = ((linear_recurrence.LIBRARY, RECURRENCE_SOURCE),
               (flash_attention.LIBRARY, ATTENTION_SOURCE),
               (flash_attention_chunk.LIBRARY, CHUNK_SOURCE),
               (flash_attention_wide.LIBRARY, WIDE_SOURCE))
    libraries = [library for library, _ in sources]
    start = time.perf_counter()
    build.build_all(libraries)
    seconds = time.perf_counter() - start
    # The native env pool (Sebulba's), with g++, after the kernels.
    gxx = subprocess.run(["g++", "--version"], check=True, capture_output=True, text=True,
                         timeout=60).stdout.splitlines()[0]
    pool_start = time.perf_counter()
    pool = cvec.ensure_built()
    emit({"phase": "build", "libraries": [lib.library_path() for lib in libraries],
          "seconds": seconds, "gxx": gxx, "env_pool_library": pool,
          "env_pool_seconds": time.perf_counter() - pool_start})
    for library, source in sources:
        lines = library.ptxas_report()
        for line in lines:
            print(line, flush=True)
        emit({"phase": "build_ptxas", "library": source, "instances": ptxas_instances(lines)})


def launch_floor(t_len: int, b_len: int):
    """A function that launches an empty kernel on the grid B1 takes at
    [t_len, b_len]: the practical floor of one launch."""
    entry = linear_recurrence.LIBRARY.load().linear_recurrence_empty

    def run():
        # The current stream, looked up at each launch: a graph captures on its own.
        stream = torch.cuda.current_stream().cuda_stream
        linear_recurrence.LIBRARY.check(entry(t_len, b_len, stream), "empty kernel")

    return run


def bound(moved: int, flops: int):
    """(bound_ms, bound_by): bytes at the HBM rate or float32 flops at the
    card's peak, whichever takes longer."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def recurrence_times(t_len: int, batch: int, view: bool = False) -> dict:
    """B1's generic entry point at [t_len, batch] float32: a call, a launch,
    the empty-kernel floor, the plain version, the bound; with `view`, also
    a call through the dispatch from batch-major [batch, t_len] views (the
    contiguous copies included), as the sequence-replay systems make it."""
    w, d, init = recurrence_inputs(t_len, batch, torch.float32, False, seed=1)
    run = partial(linear_recurrence.linear_recurrence_reverse, w, d, init)
    moved = (2 * t_len * batch + batch + t_len * batch) * 4  # read w, d, init; write out
    flops = 2 * t_len * batch
    bound_ms, bound_by = bound(moved, flops)
    extra = {}
    if view:
        w_view, d_view = w.T.contiguous().T, d.T.contiguous().T
        extra["view_call_ms"] = cuda_ms(partial(scan_kernels.linear_recurrence_reverse, w_view,
                                                d_view, init, "pallas"))
    return {**extra,
        "shape": [t_len, batch], "dtype": "float32",
        "ms": cuda_ms(run),  # per call from Python, back to back (host-bound)
        "device_ms": graph_ms(run),  # per launch replayed from a CUDA graph
        "empty_kernel_device_ms": graph_ms(launch_floor(t_len, batch)),
        "plain_ms": cuda_ms(partial(linear_recurrence.plain_linear_recurrence_reverse, w, d, init),
                            repeats=5, inner=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved, "flops": flops,
    }


def phase_kernel() -> dict:
    """B1's generic entry point against its plain version; returns its
    kernels-line entry (without launches), at ff_pqn's [8, 1024]."""
    max_abs_err = 0.0
    cases = [
        (8, 1024, torch.float32, True),  # ff_pqn's Q(lambda): [rollout, envs], truncations reset
        (16, 1024, torch.float32, False),
        (17, 1000, torch.float32, True),
        (17, 1000, torch.bfloat16, True),
        *((t_len, 1000, torch.float32, True) for t_len in (1, 15, 16, 33, 63, 64, 65, 129)),
        (128, 4096, torch.float32, True),  # a long rollout: two stages
    ]
    for t_len, batch, dtype, resets in cases:
        w, d, init = recurrence_inputs(t_len, batch, dtype, resets, seed=t_len * batch)
        got = linear_recurrence.linear_recurrence_reverse(w, d, init)
        torch.cuda.synchronize()
        want = linear_recurrence.plain_linear_recurrence_reverse(w, d, init)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != want.dtype or got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"kernel output malformed at {t_len}x{batch} {dtype}")
        # Same arithmetic (one float32 FMA per step, one rounding per row): bitwise.
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at {t_len}x{batch} {dtype}: max err {err}")
        max_abs_err = max(max_abs_err, err)
        emit({"phase": "kernel", "kernel": linear_recurrence.KERNEL.name,
              "shape": [t_len, batch], "dtype": str(dtype), "resets": resets,
              "max_abs_err": err, "bitwise": True})

    # Launches fed from batch-major [B, T] views, which the dispatch makes
    # contiguous once before the kernel: ff_awr's [7, 256], ff_mpo's Retrace
    # [6, 128] and ff_mpo_continuous's [14, 256].
    for t_len, batch in BATCH_MAJOR_SHAPES:
        w, d, _ = recurrence_inputs(batch, t_len, torch.float32, True, seed=77 + t_len)
        w_view, d_view, init = w.T, d.T, d[:, -1].contiguous()
        got = scan_kernels.linear_recurrence_reverse(w_view, d_view, init, "pallas")
        torch.cuda.synchronize()
        want = linear_recurrence.plain_linear_recurrence_reverse(w_view.contiguous(),
                                                                 d_view.contiguous(), init)
        if got.shape != (t_len, batch) or not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at the batch-major [{t_len}, {batch}]")
        emit({"phase": "kernel", "kernel": linear_recurrence.KERNEL.name,
              "shape": [t_len, batch], "from": f"a transposed [{batch}, {t_len}] view",
              "dtype": "torch.float32", "resets": True, "max_abs_err": 0.0, "bitwise": True})

    shapes = [recurrence_times(8, 1024), recurrence_times(16, 1024), recurrence_times(128, 4096),
              *(recurrence_times(t_len, batch, view=True) for t_len, batch in BATCH_MAJOR_SHAPES)]
    emit({"phase": "kernel_time", "kernel": linear_recurrence.KERNEL.name, "shapes": shapes})
    main_shape = shapes[0]  # the training path's (ff_pqn, phase q_train)
    return {
        "name": linear_recurrence.KERNEL.name, "route": "cuda", "source": RECURRENCE_SOURCE,
        "replaces": RECURRENCE_REPLACES, "max_abs_err": max_abs_err,
        **{key: main_shape[key] for key in ("shape", "ms", "device_ms", "empty_kernel_device_ms",
                                            "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,  # no single PyTorch call computes this recurrence
        "shapes": shapes,
    }


def qkv_views(batch: int, seq: int, heads: int, head_dim: int, dtype: torch.dtype, seed: int):
    """q, k, v as the main path gives them: strided views of one
    [B, S, 3, H, D] projection."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    proj = torch.randn((batch, seq, 3, heads, head_dim), generator=gen, device="cuda").to(dtype)
    return proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]


def attention_bound(kind: str, q: torch.Tensor, causal: bool, lse: bool = False):
    """(bound_ms, bound_by, bytes, flops) of one launch on these inputs: each
    input read once, each output written once; the flops of the (query, key)
    pairs the mask leaves."""
    batch, seq, heads, head_dim = q.shape
    tensor = q.numel() * q.element_size()  # one [B, S, H, D] operand
    stat = batch * heads * seq * 4  # one float32 [B, H, S] row statistic
    pairs = batch * heads * (seq * (seq + 1) // 2 if causal else seq * seq)
    if kind == "forward":  # read q, k, v; write o (and lse)
        moved, flops = 4 * tensor + (stat if lse else 0), 4 * head_dim * pairs
    else:  # backward: read q, k, v, o, dO, lse; write dQ, dK, dV
        moved = 8 * tensor + stat
        # q.k and dO.v (4D), dV, dK and dQ (6D) per pair; delta = rowsum(dO.o)
        flops = 10 * head_dim * pairs + 2 * batch * seq * heads * head_dim
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved, flops


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """PyTorch's one call for the same function: the yardstick, never used by the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal
    ).transpose(1, 2)


def phase_attention() -> list:
    """B2's two kernels against their plain versions; returns their
    kernels-line entries (without launches)."""
    fa = flash_attention
    # Same tiles, another summation order than the plain version: float32 is
    # held at 1e-5 absolute, bfloat16 at 2e-2 (JAX's own bf16 tolerance for
    # this kernel, tests/test_pallas_attention.py), float16 at 2e-3 (two
    # float16 ulps in [1, 2)).
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
    path = [((b, TRANS["window"], TRANS["heads"], TRANS["head_dim"]), True, torch.float32)
            for b in (TRANS_ENVS, 4 * TRANS_ENVS, TRANS["rollout"] * TRANS_ENVS)]
    errors = {"forward": 0.0, "backward": 0.0}
    long = ((RING_BATCH, 512, TRANS["heads"], TRANS["head_dim"]), True, torch.float32)
    for seed, (shape, causal, dtype) in enumerate(path + [
        long,
        ((2, 300, 2, 64), True, torch.float32),
        ((2, 100, 2, 32), False, torch.float32),
        ((1, 128, 1, 64), True, torch.bfloat16),
        # Head dims 8 and 128 and float16 (C6).
        ((TRANS_ENVS, 16, 4, 8), True, torch.float32),
        ((2, 300, 2, 128), True, torch.float32),
        ((TRANS_ENVS, 16, 4, 32), True, torch.float16),
        ((2, 100, 2, 8), False, torch.bfloat16),
    ]):
        q, k, v = qkv_views(*shape, dtype, seed=seed)
        got, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
        again, lse_again = fa.forward_kernel(q, k, v, causal, need_lse=True)
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(lse, lse_again)):
            raise AssertionError(f"forward kernel not deterministic at {shape} {dtype}")
        want, want_lse = fa.plain_flash_attention_forward(q, k, v, causal, need_lse=True)
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if got.dtype != dtype or got.shape != q.shape or not torch.isfinite(got).all():
            raise AssertionError(f"forward kernel output malformed at {shape} {dtype}")
        if not (err <= tolerance[dtype] and lse_err <= 1e-5):
            raise AssertionError(f"forward != plain at {shape} {dtype}: {err}, lse {lse_err}")
        if dtype == torch.float32:
            errors["forward"] = max(errors["forward"], err)
        emit({"phase": "attention", "kernel": "flash_attention_forward", "shape": list(shape),
              "causal": causal, "dtype": str(dtype), "max_abs_err": err,
              "lse_max_abs_err": lse_err, "tolerance": tolerance[dtype], "bitwise_twice": True})

    # The backward: the path's shape, a ragged one, one of five 64-key tiles
    # (dQ partials summed), a bfloat16 one, and head dims 8 and 128 and
    # float16 (C6). The 16-bit types are also held relative, at their own
    # tolerance: above 2 a bf16 ulp is 1.6e-2 or more (a float16 ulp 2e-3),
    # and the two fp32 sums may round to neighbouring values.
    for seed, (shape, causal, dtype) in enumerate([
        ((4 * TRANS_ENVS, 16, 4, 32), True, torch.float32),
        ((2, 100, 2, 32), False, torch.float32),
        ((2, 300, 2, 64), True, torch.float32),
        ((1, 128, 1, 64), True, torch.bfloat16),
        ((TRANS_ENVS, 16, 4, 8), True, torch.float32),
        ((2, 200, 2, 128), True, torch.float32),
        ((TRANS_ENVS, 16, 4, 32), True, torch.float16),
    ]):
        q, k, v = qkv_views(*shape, dtype, seed=10 + seed)
        dout = qkv_views(*shape, dtype, seed=30 + seed)[0].contiguous()
        o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
        got = fa.backward_kernel(q, k, v, o, lse, dout, causal)
        torch.cuda.synchronize()
        want = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
        rtol = 0.0 if dtype == torch.float32 else tolerance[dtype]
        errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        held = all(bool(((g.float() - w.float()).abs() <= tolerance[dtype] + rtol * w.float().abs())
                        .all()) for g, w in zip(got, want))
        if any(g.dtype != dtype or g.shape != q.shape or not torch.isfinite(g).all() for g in got):
            raise AssertionError(f"backward kernel output malformed at {shape} {dtype}")
        if not held:
            raise AssertionError(f"backward kernel != plain at {shape} {dtype}: dq, dk, dv {errs}")
        if dtype == torch.float32:
            errors["backward"] = max(errors["backward"], *errs)
        emit({"phase": "attention", "kernel": "flash_attention_backward", "shape": list(shape),
              "causal": causal, "dtype": str(dtype), "max_abs_err_dq_dk_dv": errs,
              "tolerance": tolerance[dtype], "rtol": rtol})

    # Times at the path's shapes: the forward at each batch it runs at and at
    # the ring phase's long window, the backward at the minibatch's.
    shapes = []
    for shape, causal, _ in path + [long]:
        q, k, v = qkv_views(*shape, torch.float32, seed=20)
        bound, bound_by, moved, flops = attention_bound("forward", q, causal)
        shapes.append({
            "shape": list(shape),
            "ms": cuda_ms(lambda: fa.forward_kernel(q, k, v, causal)),
            "device_ms": graph_ms(lambda: fa.forward_kernel(q, k, v, causal)),
            "with_lse_device_ms": graph_ms(lambda: fa.forward_kernel(q, k, v, causal, True)),
            "plain_ms": cuda_ms(lambda: fa.plain_flash_attention_forward(q, k, v, causal),
                                repeats=5, inner=3),
            "library_ms": cuda_ms(lambda: sdpa(q, k, v, causal)),
            "bound_ms": bound, "bound_by": bound_by, "bytes": moved, "flops": flops,
        })
    emit({"phase": "attention_time", "kernel": "flash_attention_forward", "shapes": shapes})
    main_shape = shapes[1]  # the minibatch forward, [4096, 16, 4, 32]
    forward_entry = {
        "name": fa.FORWARD.name, "route": "cuda", "source": ATTENTION_SOURCE,
        "replaces": ATTENTION_REPLACES, "max_abs_err": errors["forward"],
        **{key: main_shape[key] for key in
           ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shapes": shapes,
    }

    shape, causal = (4 * TRANS_ENVS, 16, 4, 32), True
    q, k, v = qkv_views(*shape, torch.float32, seed=21)
    dout = qkv_views(*shape, torch.float32, seed=32)[0].contiguous()
    o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
    leaf = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    library_out = sdpa(*leaf, causal)

    def ours_fwd_bwd():
        out = fa.FlashAttention.apply(*leaf, causal)
        out.backward(dout)

    def sdpa_fwd_bwd():
        sdpa(*leaf, causal).backward(dout)

    def sdpa_bwd():  # SDPA's backward alone, on one saved forward
        torch.autograd.grad(library_out, leaf, dout, retain_graph=True)

    run = lambda: fa.backward_kernel(q, k, v, o, lse, dout, causal)  # noqa: E731
    bound, bound_by, moved, flops = attention_bound("backward", q, causal)
    backward_entry = {
        "name": fa.BACKWARD.name, "route": "cuda", "source": ATTENTION_SOURCE,
        "replaces": ATTENTION_REPLACES, "max_abs_err": errors["backward"], "shape": list(shape),
        "ms": cuda_ms(run), "device_ms": graph_ms(run),
        "plain_ms": cuda_ms(
            lambda: fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal),
            repeats=5, inner=3),
        "bound_ms": bound, "bound_by": bound_by, "bytes": moved, "flops": flops,
        "library_ms": cuda_ms(sdpa_bwd, repeats=11, inner=20),
        "fwd_bwd_ms": cuda_ms(ours_fwd_bwd, repeats=11, inner=20),
        "library_fwd_bwd_ms": cuda_ms(sdpa_fwd_bwd, repeats=11, inner=20),
    }
    emit({"phase": "attention_time", "kernel": fa.BACKWARD.name,
          **{key: backward_entry[key] for key in (
              "shape", "ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "fwd_bwd_ms",
              "library_fwd_bwd_ms")}})
    return [forward_entry, backward_entry]


def gae_inputs(t_len: int, batch: int, seed: int, device: str = "cuda"):
    """r, discount, v_tm1, v_t, truncation [T, B] float32 as a rollout gives
    them: terminations zero the discount, truncations mark 1.0 elsewhere."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (t_len, batch)
    r = torch.randn(shape, generator=gen, device=device)
    done = torch.rand(shape, generator=gen, device=device) < 0.05
    truncated = (torch.rand(shape, generator=gen, device=device) < 0.03) & ~done
    v_tm1 = torch.randn(shape, generator=gen, device=device)
    v_t = torch.randn(shape, generator=gen, device=device)
    return r, 0.99 * (1.0 - done.float()), v_tm1, v_t, truncated.float()


def phase_gae() -> tuple:
    """B1's GAE entry point against its plain version, and GAE through the
    dispatch; returns the entry point's kernels-line entry (without launches)
    and the generic entry point's launches on the composed path's own run."""
    lr = linear_recurrence
    lam = 0.95
    max_abs_err = 0.0
    # ff_reinforce's launch is [32, 1024] at lambda 1.0.
    for t_len, batch, case_lam in ((16, 1024, lam), (17, 1000, lam), (128, 4096, lam),
                                   (32, 1024, 1.0)):
        args = gae_inputs(t_len, batch, seed=t_len + batch)
        got = lr.truncated_gae(*args, case_lam)
        torch.cuda.synchronize()
        want = lr.plain_truncated_gae(*args, case_lam)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if any(g.shape != (t_len, batch) or not torch.isfinite(g).all() for g in got):
            raise AssertionError(f"GAE kernel output malformed at {t_len}x{batch}")
        # The plain version's op order and roundings: bitwise.
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"GAE kernel != plain at {t_len}x{batch}: max err {err}")
        max_abs_err = max(max_abs_err, err)
        emit({"phase": "gae", "kernel": lr.GAE_KERNEL.name, "shape": [t_len, batch],
              "lambda": case_lam, "truncation": True, "max_abs_err": err, "bitwise": True})

    # Through the dispatch: the card against `scan` on the CPU.
    cpu = [x.cpu() for x in gae_inputs(16, 1024, seed=7)]
    want = truncated_generalized_advantage_estimation(
        cpu[0], cpu[1], lam, v_tm1=cpu[2], v_t=cpu[3], truncation_t=cpu[4], impl="scan")
    card = [x.cuda() for x in cpu]
    before = [c.launches for c in lr.COUNTERS]
    got = truncated_generalized_advantage_estimation(
        card[0], card[1], lam, v_tm1=card[2], v_t=card[3], truncation_t=card[4], impl="pallas")
    if [c.launches - b for c, b in zip(lr.COUNTERS, before)] != [0, 1]:
        raise AssertionError("GAE on CUDA tensors did not take exactly one GAE launch")
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("GAE on the card != the CPU scan")
    emit({"phase": "gae", "route": "dispatch, impl=pallas", "shape": [16, 1024],
          "bitwise_vs_cpu_scan": True})

    # The composed path's own run (a tensor lambda; bfloat16): the generic
    # entry point between separate elementwise ops, each held against the CPU.
    for counter in lr.COUNTERS:
        counter.launches = 0
    lam_t = torch.full((16, 1024), lam)
    composed = {
        "tensor lambda": (card[:2] + [lam_t.cuda()] + card[2:], cpu[:2] + [lam_t] + cpu[2:]),
        "bfloat16": ([x.bfloat16() for x in card[:2]] + [lam] + [x.bfloat16() for x in card[2:]],
                     [x.bfloat16() for x in cpu[:2]] + [lam] + [x.bfloat16() for x in cpu[2:]]),
    }
    outputs = {}
    for name, (on_card, on_cpu) in composed.items():
        r, discount, lam_in, v_tm1, v_t, trunc = on_card
        outputs[name] = (truncated_generalized_advantage_estimation(
            r, discount, lam_in, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, impl="pallas"), on_cpu)
    composed_launches = {c.name: c.launches for c in lr.COUNTERS}
    if composed_launches != {lr.KERNEL.name: len(composed), lr.GAE_KERNEL.name: 0}:
        raise AssertionError(f"the composed path launched {composed_launches}")
    for name, (got, on_cpu) in outputs.items():
        r, discount, lam_in, v_tm1, v_t, trunc = on_cpu
        want = truncated_generalized_advantage_estimation(
            r, discount, lam_in, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, impl="pallas")
        # The CPU runs the same composed path with the kernel's plain version.
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"composed GAE ({name}) on the card != on the CPU")
    emit({"phase": "gae", "route": "composed (tensor lambda, bfloat16)",
          "launches": composed_launches, "bitwise_vs_cpu": True})
    estimator_launches = phase_estimators()

    args = gae_inputs(16, 1024, seed=8)
    t_len, batch = args[0].shape
    run = partial(lr.truncated_gae, *args, lam)
    moved = (5 + 2) * t_len * batch * 4  # read r, discount, v_tm1, v_t, truncation; write 2
    flops = 9 * t_len * batch  # 2 FMAs, 2 multiplies, 3 adds a step
    bound_ms, bound_by = bound(moved, flops)
    entry = {
        "name": lr.GAE_KERNEL.name, "route": "cuda", "source": RECURRENCE_SOURCE,
        "replaces": f"{RECURRENCE_REPLACES} with stoix_tpu/ops/multistep.py:73",
        "max_abs_err": max_abs_err, "shape": [t_len, batch],
        "ms": cuda_ms(run), "device_ms": graph_ms(run),
        "empty_kernel_device_ms": graph_ms(launch_floor(t_len, batch)),
        "plain_ms": cuda_ms(partial(lr.plain_truncated_gae, *args, lam), repeats=5, inner=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved, "flops": flops,
        "library_ms": None,  # no single PyTorch call computes GAE
    }
    # ff_reinforce's shape, [32, 1024] at lambda 1.0.
    args = gae_inputs(32, 1024, seed=9)
    run = partial(lr.truncated_gae, *args, 1.0)
    moved, flops = 7 * 32 * 1024 * 4, 9 * 32 * 1024
    reinforce_bound = bound(moved, flops)
    entry["shapes"] = [{"shape": [32, 1024], "lambda": 1.0, "ms": cuda_ms(run),
                        "device_ms": graph_ms(run),
                        "plain_ms": cuda_ms(partial(lr.plain_truncated_gae, *args, 1.0),
                                            repeats=5, inner=3),
                        "bound_ms": reinforce_bound[0], "bound_by": reinforce_bound[1]}]
    emit({"phase": "gae_time", **entry})
    return entry, composed_launches[lr.KERNEL.name], estimator_launches


def phase_estimators() -> dict:
    """The estimators that reach B1 only through its generic entry (the
    general off-policy return, Retrace at ff_mpo's [128, 8] sequences,
    discounted returns, the importance-corrected TD errors, V-trace), each
    through the dispatch on CUDA tensors against the CPU's `scan`, bitwise,
    with every B1 counter zeroed just before and read just after: one
    generic launch each, no GAE launch. Returns the launches by estimator."""
    from stoix_tpu_torch.ops import multistep

    lr = linear_recurrence
    gen = torch.Generator().manual_seed(9)
    rand = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    discount = 0.99 * (torch.rand((128, 8), generator=gen) > 0.1).float()
    time_major = discount.T.contiguous()
    cases = {
        "general_off_policy_returns_from_q_and_v": (
            multistep.general_off_policy_returns_from_q_and_v, {},
            (rand(128, 7), rand(128, 8), rand(128, 8), discount,
             torch.rand((128, 7), generator=gen))),
        "retrace_continuous": (multistep.retrace_continuous, {"lambda_": 0.95},
                               (rand(128, 7), rand(128, 6), rand(128, 7), rand(128, 7),
                                discount[:, :7], rand(128, 6) * 0.8)),
        "discounted_returns": (multistep.discounted_returns, {},
                               (rand(8, 128), time_major, rand(8, 128))),
        "importance_corrected_td_errors": (
            lambda r, d, rho, values, impl: multistep.importance_corrected_td_errors(
                r, d, rho, 0.9, values, impl=impl), {},
            (rand(8, 128), time_major, torch.exp(rand(8, 128) * 0.5), rand(9, 128))),
        "vtrace_td_error_and_advantage": (
            multistep.vtrace_td_error_and_advantage, {},
            (rand(8, 128), rand(8, 128), rand(8, 128), time_major,
             torch.exp(rand(8, 128) * 0.5))),
    }
    launches = {}
    for name, (fn, kwargs, args) in cases.items():
        want = fn(*args, **kwargs, impl="scan")
        for counter in lr.COUNTERS:
            counter.launches = 0
        got = fn(*(a.cuda() for a in args), **kwargs, impl="pallas")
        torch.cuda.synchronize()
        launches[name] = _counts(lr.COUNTERS)
        if launches[name] != {lr.KERNEL.name: 1, lr.GAE_KERNEL.name: 0}:
            raise AssertionError(f"{name} on CUDA tensors launched {launches[name]}")
        pairs = zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want)))
        if not all(torch.equal(g.cpu(), w) for g, w in pairs):
            raise AssertionError(f"{name} on the card != the CPU scan")
        emit({"phase": "gae", "route": "dispatch, impl=pallas", "estimator": name,
              "shape": list(args[0].shape), "launches": launches[name],
              "bitwise_vs_cpu_scan": True})
    return {name: counts[lr.KERNEL.name] for name, counts in launches.items()}


def compose(overrides, root: str = "default/anakin/default_ff_ppo.yaml") -> dict:
    return config_lib.compose(config_lib.default_config_dir(), root, overrides)


TRANS_ROOT = "default/anakin/default_ff_trans_ppo.yaml"
IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=65536",
            "arch.num_evaluation=1", "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
            "arch.absolute_metric=False", "logger.use_console=False"]


def phase_learn() -> None:
    config = compose(IDENTITY + ["system.rollout_length=16", "system.epochs=4",
                                 "system.multistep_impl=pallas"])
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(config, device="cuda")
    if not final_return > 8.0:
        raise AssertionError(f"IdentityGame did not learn on the card: return {final_return}")
    emit({"phase": "learn", "env": "identity_game", "final_return": final_return,
          "seconds": time.perf_counter() - start})


def phase_train(smi: str) -> int:
    """The main path at full width; returns B1's GAE launches in it."""
    lr = linear_recurrence
    config = compose([
        f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
        "arch.num_eval_episodes=16", "system.multistep_impl=pallas", "logger.use_console=False",
    ])
    for counter in lr.COUNTERS:
        counter.launches = 0
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    launches = lr.GAE_KERNEL.launches
    if (lr.KERNEL.launches, launches) != (0, MAIN_UPDATES):
        raise AssertionError(f"B1 launched {lr.KERNEL.launches} generic and {launches} GAE "
                             f"times over {MAIN_UPDATES} updates, not 0 and {MAIN_UPDATES}")
    stats = runner.LAST_RUN_STATS
    train = [rec for rec in stats["history"] if rec["event"] == "trainer"]
    losses = {k: v for rec in train for k, v in rec.items() if k.endswith("loss") or k == "entropy"}
    if not train or not all(math.isfinite(v) for rec in train for k, v in rec.items()
                            if k not in ("event", "t", "t_eval")):
        raise AssertionError(f"non-finite training metrics: {train}")
    if not math.isfinite(final_return):
        raise AssertionError(f"non-finite eval return {final_return}")
    emit({"phase": "train", "env": "cartpole", "total_num_envs": int(config.arch.total_num_envs),
          "rollout_length": int(config.system.rollout_length), "updates": MAIN_UPDATES,
          "b1_gae_launches": launches, "b1_generic_launches": lr.KERNEL.launches,
          "final_eval_return": final_return, "last_losses": losses,
          "window_seconds": stats["window_seconds"],
          "env_steps_per_second": stats["steps_per_second"], "seconds": seconds,
          "card": smi})
    return launches


def phase_trans_learn() -> None:
    # The JAX package's ff_trans_ppo returns 10.0 with these overrides on the CPU.
    config = compose(IDENTITY + ["system.window_length=4", "system.num_layers=1",
                                 "system.multistep_impl=pallas"], TRANS_ROOT)
    start = time.perf_counter()
    final_return = ff_trans_ppo.run_experiment(config, device="cuda")
    if not final_return > 8.0:
        raise AssertionError(f"ff_trans_ppo did not learn IdentityGame on the card: {final_return}")
    emit({"phase": "trans_learn", "env": "identity_game", "final_return": final_return,
          "seconds": time.perf_counter() - start})


def _counts(counters) -> dict:
    return {c.name: c.launches for c in counters}


def phase_trans_train(smi: str) -> dict:
    """ff_trans_ppo's main path at full width; returns each kernel's launches
    in the run, split into the learner's and the evaluator's."""
    fa, lr = flash_attention, linear_recurrence
    counters = [fa.FORWARD, fa.BACKWARD, *lr.COUNTERS]
    layers = TRANS["layers"]
    per_update = {  # the learner's launches in one update step
        fa.FORWARD.name: 2 * layers * TRANS["rollout"] + layers
        + 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
        fa.BACKWARD.name: 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
        lr.KERNEL.name: 0,  # GAE takes the GAE entry point, never the generic one
        lr.GAE_KERNEL.name: 1,
    }
    config = compose([
        f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
        "arch.num_eval_episodes=16", "system.multistep_impl=pallas", "logger.use_console=False",
    ], TRANS_ROOT)
    if (int(config.system.num_layers), int(config.arch.total_num_envs)) != (layers, TRANS_ENVS):
        raise AssertionError("the default ff_trans_ppo config changed; update TRANS")
    learner = dict.fromkeys(per_update, 0)
    original_setup = ff_trans_ppo.learner_setup

    def counted_setup(env, cfg, device, seed):
        setup = original_setup(env, cfg, device, seed)

        def learn(state):
            before = _counts(counters)
            output = setup.learn(state)
            for name, count in _counts(counters).items():
                learner[name] += count - before[name]
            return output

        return setup._replace(learn=learn)

    for counter in counters:
        counter.launches = 0
    ff_trans_ppo.learner_setup = counted_setup
    start = time.perf_counter()
    try:
        final_return = ff_trans_ppo.run_experiment(config, device="cuda")
    finally:
        ff_trans_ppo.learner_setup = original_setup
    seconds = time.perf_counter() - start
    total = _counts(counters)

    expected = {name: n * MAIN_UPDATES for name, n in per_update.items()}
    if learner != expected:
        raise AssertionError(f"learner launches {learner} != {expected} in {MAIN_UPDATES} updates")
    evaluator = {name: total[name] - learner[name] for name in total}
    stats = runner.LAST_RUN_STATS
    # The stateful evaluator steps until its longest episode ends: L forward
    # launches per step, nothing else.
    eval_steps = sum(int(rec["episode_length/max"]) for rec in stats["history"]
                     if rec["event"] in ("evaluator", "absolute"))
    if evaluator != {**dict.fromkeys(total, 0), fa.FORWARD.name: layers * eval_steps}:
        raise AssertionError(f"evaluator launches {evaluator} over {eval_steps} eval steps")
    train = [rec for rec in stats["history"] if rec["event"] == "trainer"]
    if not train or not all(math.isfinite(v) for rec in train for k, v in rec.items()
                            if k not in ("event", "t", "t_eval")):
        raise AssertionError(f"non-finite training metrics: {train}")
    if not math.isfinite(final_return):
        raise AssertionError(f"non-finite eval return {final_return}")
    emit({"phase": "trans_train", "env": "cartpole", "total_num_envs": TRANS_ENVS,
          "updates": MAIN_UPDATES, "learner_launches": learner,
          "learner_launches_per_update": per_update, "evaluator_launches": evaluator,
          "eval_steps": eval_steps, "final_eval_return": final_return,
          "last_losses": train[-1], "window_seconds": stats["window_seconds"],
          "env_steps_per_second": stats["steps_per_second"], "seconds": seconds, "card": smi})
    return {"learner": learner, "evaluator": evaluator, "total": total}


def ring_width() -> dict:
    """The ring phases' transformer: ff_trans_ppo's default config (layers,
    heads, head dim, FFN, env) over the torso's default window."""
    config = compose([], TRANS_ROOT)
    window = inspect.signature(TransformerTorso).parameters["max_timesteps"].default
    return dict(layers=int(config.system.num_layers), heads=int(config.system.num_heads),
                head_dim=int(config.system.head_dim), ffn=int(config.system.ffn_dim),
                window=int(window),
                obs=ff_trans_ppo.observation_width(envs.make(config)[0]))


def chunk_bound(q, k, q_pos, k_pos, causal: bool):
    """(bound_ms, bound_by, bytes, flops) of one B3 launch on these inputs,
    after `attention_bound`: the flops of the (query, key) pairs these
    positions leave; q, k, v read once if any pair is left (a chunk wholly in
    the future needs none of them), positions read once, pv, m and l written."""
    batch, q_len, heads, head_dim = q.shape
    visible = q_pos[:, None].long() >= k_pos[None, :].long()
    pairs = batch * heads * (int(visible.sum()) if causal else q_len * k.shape[1])
    stat = batch * heads * q_len * 4
    moved = batch * q_len * heads * head_dim * 4 + 2 * stat + 4 * (q_len + k.shape[1])
    if pairs:
        moved += q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    flops = 4 * head_dim * pairs
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved, flops


def phase_ring_kernel(width: dict) -> dict:
    """B3 against its plain version; returns its kernels-line entry (without
    launches)."""
    fac = flash_attention_chunk
    # The kernel and its plain version take the same inputs widened to float32
    # and fold the same key tiles in another summation order; both write
    # float32, so float32 and bfloat16 inputs are held at 1e-5 (m absolute, l
    # and pv relative to l). The fold against full attention at 2e-5, JAX's
    # own tolerance (tests/test_pallas_attention.py).
    tolerance, fold_tolerance = 1e-5, 2e-5
    batch, window, heads, head_dim = RING_BATCH, width["window"], width["heads"], width["head_dim"]
    local = window // RING_RANKS
    q, k, v = qkv_views(batch, window, heads, head_dim, torch.float32, seed=40)
    positions = torch.arange(window, dtype=torch.int32, device=q.device)
    max_err = max_abs_err = 0.0

    def check(name, args, causal):
        nonlocal max_err, max_abs_err
        got = fac.chunk_kernel(*args, causal=causal)
        torch.cuda.synchronize()
        want = fac.plain_flash_attention_chunk(*args, causal=causal)
        errs = fac.chunk_errors(got, want)
        abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not all(torch.isfinite(x).all() for x in got) or not max(errs) <= tolerance:
            raise AssertionError(f"chunk kernel != plain at {name}: m, l, pv errors {errs}")
        max_err, max_abs_err = max(max_err, *errs), max(max_abs_err, abs_err)
        emit({"phase": "ring_kernel", "case": name, "q": list(args[0].shape),
              "k": list(args[1].shape), "dtype": str(args[0].dtype), "causal": causal,
              "errors_m_l_pv": errs, "max_abs_err": abs_err, "tolerance": tolerance})
        return got

    def chunk_args(rank, src):
        rows, keys = slice(rank * local, (rank + 1) * local), slice(src * local, (src + 1) * local)
        return q[:, rows], k[:, keys], v[:, keys], positions[rows], positions[keys]

    outputs = []
    for rank in range(RING_RANKS):
        acc = (torch.full((batch, heads, local), float("-inf"), device=q.device),
               torch.zeros((batch, heads, local), device=q.device),
               torch.zeros((batch, local, heads, head_dim), device=q.device))
        for step in range(RING_RANKS):  # in the ring's order: source (rank + step) % R
            src = (rank + step) % RING_RANKS
            kind = "future" if src > rank else "diagonal" if src == rank else "visible"
            acc = fold_chunk(acc, *check(f"rank {rank} source {src} ({kind})",
                                         chunk_args(rank, src), True))
        outputs.append(acc[2] / torch.where(acc[1] == 0.0, 1.0, acc[1]).permute(0, 2, 1)[..., None])
    fold_err = (torch.cat(outputs, dim=1) - full_attention(q, k, v, causal=True)).abs().max().item()
    if not fold_err <= fold_tolerance:
        raise AssertionError(f"4-rank fold of the chunk kernel != full attention: {fold_err}")
    emit({"phase": "ring_kernel", "case": f"{RING_RANKS}-rank causal ring folded",
          "shape": [batch, window, heads, head_dim], "max_abs_err_vs_full_attention": fold_err,
          "tolerance": fold_tolerance})

    check("non-causal chunk", chunk_args(1, 2), False)
    check("Sq != Sk", (q[:, local:2 * local], k[:, :200], v[:, :200],
                       positions[local:2 * local], positions[:200]), True)
    rq, rk, rv = qkv_views(3, 77, 2, 32, torch.float32, seed=41)
    shuffled = torch.randperm(45, generator=torch.Generator(device=q.device).manual_seed(42),
                              device=q.device).to(torch.int32) + 10
    check("ragged, shuffled key positions", (rq, rk[:, :45], rv[:, :45],
                                             positions[:77], shuffled), True)
    bq, bk, bv = qkv_views(1, 128, 1, 64, torch.bfloat16, seed=43)
    check("bfloat16 diagonal", (bq, bk, bv, positions[:128], positions[:128]), True)
    # Head dims 8 and 128 and float16 (C6), each at a visible 4-rank chunk.
    for seed, (dim, dtype) in enumerate(((8, torch.float32), (128, torch.float32),
                                         (32, torch.float16))):
        cq, ck, cv = qkv_views(batch, 2 * local, heads, dim, dtype, seed=45 + seed)
        check(f"visible chunk, D = {dim} {dtype}",
              (cq[:, local:], ck[:, :local], cv[:, :local], positions[local:2 * local],
               positions[:local]), True)
    # The one-rank ring's launch: the whole window, several query row blocks
    # per (batch, head), each with its own causal bound.
    check("one-rank window", (q, k, v, positions, positions), True)

    # Times: the three kinds of 4-rank chunk, and the one-rank ring's chunk
    # (the whole window), which is what the ring phase launches.
    shapes = []
    for name, args in (("visible", chunk_args(1, 0)), ("diagonal", chunk_args(1, 1)),
                       ("future", chunk_args(1, 2)), ("one-rank", (q, k, v, positions, positions))):
        bound, bound_by, moved, flops = chunk_bound(args[0], args[1], args[3], args[4], True)
        shapes.append({
            "case": name, "q": list(args[0].shape), "k": list(args[1].shape),
            "ms": cuda_ms(lambda: fac.chunk_kernel(*args, causal=True)),
            "device_ms": graph_ms(lambda: fac.chunk_kernel(*args, causal=True)),
            "plain_ms": cuda_ms(lambda: fac.plain_flash_attention_chunk(*args, causal=True),
                                repeats=5, inner=3),
            "bound_ms": bound, "bound_by": bound_by, "bytes": moved, "flops": flops,
        })
    emit({"phase": "ring_kernel_time", "kernel": fac.KERNEL.name, "shapes": shapes})
    main_shape = shapes[-1]
    return {
        "name": fac.KERNEL.name, "route": "cuda", "source": CHUNK_SOURCE,
        # max_abs_err: the largest |kernel - plain| over pv, m and l of every
        # case; max_err_rel_l: what the tolerance holds (m absolute, l and pv
        # relative to the row's l).
        "replaces": CHUNK_REPLACES, "max_abs_err": max_abs_err, "max_err_rel_l": max_err,
        "shape": main_shape["q"],
        **{key: main_shape[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        # No single PyTorch call returns the unnormalised pv with its stats;
        # SDPA's time on the composed op is under the ring phase.
        "library_ms": None,
        "shapes": shapes,
    }


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank NCCL process group (a `file://` store in a temporary
    directory) and its mesh, destroyed on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        config = config_lib.Config.from_dict({"arch": {"distributed": {
            "coordinator_address": "file://" + os.path.join(tmp, "store"),
            "num_processes": 1, "process_id": 0,
        }}})
        parallel.maybe_initialize_distributed(config, device="cuda")
        try:
            yield parallel.create_mesh({"data": 1}, device="cuda")
        finally:
            dist.destroy_process_group()


def phase_ring(width: dict, smi: str, mesh) -> dict:
    """The full-width torso's forward through a one-rank NCCL ring; returns
    B3's launches in that forward and the timings."""
    fa, fac = flash_attention, flash_attention_chunk
    tolerance = 1e-4
    ranks = parallel.axis_size(mesh, "data")

    def torso(attention_fn=None):
        return TransformerTorso(
            width["obs"], width["layers"], width["heads"], width["head_dim"],
            width["ffn"], attention_fn=attention_fn,
            generator=torch.Generator().manual_seed(0),
        )

    ring_torso = torso(partial(ring_attention, group=mesh.get_group("data"))).cuda()
    flash_torso = torso().cuda()  # best_attention: B2 on the card
    flash_torso.load_state_dict(ring_torso.state_dict())
    cpu_torso = copy.deepcopy(flash_torso).cpu().double()  # float64 full attention
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((RING_BATCH, width["window"], width["obs"]), generator=gen)
    x_card = x.cuda()

    for counter in (*fa.COUNTERS, fac.KERNEL):
        counter.launches = 0
    with torch.no_grad():
        ring_out = ring_torso(x_card)
        torch.cuda.synchronize()
        launches = {c.name: c.launches for c in (*fa.COUNTERS, fac.KERNEL)}
        flash_out = flash_torso(x_card)
        cpu_out = cpu_torso(x.double()).float()
    expected = {**{c.name: 0 for c in fa.COUNTERS},
                fac.KERNEL.name: width["layers"] * ranks}
    if launches != expected:
        raise AssertionError(f"ring torso forward launched {launches}, not {expected}")
    errs = {"ring_vs_flash": (ring_out - flash_out).abs().max().item(),
            "ring_vs_cpu": (ring_out.cpu() - cpu_out).abs().max().item(),
            "flash_vs_cpu": (flash_out.cpu() - cpu_out).abs().max().item()}
    if not torch.isfinite(ring_out).all() or not max(errs.values()) <= tolerance:
        raise AssertionError(f"ring torso disagrees: {errs}")

    q, k, v = qkv_views(RING_BATCH, width["window"], width["heads"], width["head_dim"],
                        torch.float32, seed=44)
    group = mesh.get_group("data")
    torso_ms = partial(cuda_ms, repeats=5, inner=5)
    with torch.no_grad():
        times = {
            "ring_torso_forward_ms": torso_ms(lambda: ring_torso(x_card)),
            "flash_torso_forward_ms": torso_ms(lambda: flash_torso(x_card)),
            "ring_attention_ms": cuda_ms(lambda: ring_attention(q, k, v, group, True)),
            "flash_attention_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, True)),
            "sdpa_ms": cuda_ms(lambda: sdpa(q, k, v, True)),
        }
    tokens = RING_BATCH * width["window"]
    emit({"phase": "ring", "mesh": {"data": ranks}, "backend": "nccl",
          "torso": {k: width[k] for k in ("layers", "heads", "head_dim", "ffn", "window")},
          "batch": RING_BATCH, "launches_per_forward": launches, "max_abs_err": errs,
          "tolerance": tolerance, **times,
          "ring_torso_tokens_per_s": tokens / (times["ring_torso_forward_ms"] / 1e3),
          "flash_torso_tokens_per_s": tokens / (times["flash_torso_forward_ms"] / 1e3),
          "card": smi})
    return {"launches": launches[fac.KERNEL.name], "sdpa_ms": times["sdpa_ms"],
            "ring_attention_ms": times["ring_attention_ms"]}


# ff_trans_ppo at its CPU test's small config (tests/test_torch_ff_trans_ppo.py):
# head_dim 8, a quarter of the default's 32.
C6_TRANS = ["system.window_length=4", "system.num_layers=1", "system.num_heads=2",
            "system.head_dim=8", "system.ffn_dim=32", "arch.total_num_envs=16",
            "system.rollout_length=8", "system.num_minibatches=2", "env=identity_game",
            "system.multistep_impl=pallas", "logger.use_console=False"]


def phase_c6(mesh, smi: str) -> None:
    """Attention at any head dim up to 128 and in float16 runs through the
    kernels on the card (C6): `best_attention` and a one-rank NCCL ring against
    the CPU, each launching its kernel; then ff_trans_ppo at head_dim 8 trains
    a step there through B2."""
    fa, fac = flash_attention, flash_attention_chunk
    counters = (*fa.COUNTERS, fac.KERNEL)
    # float32 at 2e-5, the attention tolerance (JAX's own); float16 against the
    # CPU's float32 attention on the same float16 inputs at 2e-3 absolute and
    # relative: the kernel computes in fp32 and rounds once to float16.
    tolerance = {torch.float32: (0.0, 2e-5), torch.float16: (2e-3, 2e-3)}
    group = mesh.get_group("data")
    cases = [("best_attention", 8, torch.float32, fa.FORWARD),
             ("best_attention", 128, torch.float32, fa.FORWARD),
             ("best_attention", 32, torch.float16, fa.FORWARD),
             ("best_attention", 24, torch.float32, fa.FORWARD),  # padded to 32
             ("ring_attention", 8, torch.float32, fac.KERNEL),
             ("ring_attention", 32, torch.float16, fac.KERNEL),
             ("ring_attention", 24, torch.float32, fac.KERNEL)]
    for seed, (name, head_dim, dtype, counter) in enumerate(cases):
        q, k, v = qkv_views(64, 16, 4, head_dim, dtype, seed=60 + seed)
        for each in counters:
            each.launches = 0
        if name == "best_attention":
            got = best_attention(q, k, v, causal=True)
        else:
            got = ring_attention(q, k, v, group, causal=True)
        torch.cuda.synchronize()
        launches = {c.name: c.launches for c in counters}
        want = cpu_attention(*(x.float() for x in (q, k, v)))
        rtol, atol = tolerance[dtype]
        err = (got.cpu().float() - want).abs()
        if launches != {c.name: int(c is counter) for c in counters}:
            raise AssertionError(f"C6 {name} at D={head_dim} {dtype}: launches {launches}")
        if got.dtype != dtype or got.shape != q.shape or not torch.isfinite(got).all():
            raise AssertionError(f"C6 {name} at D={head_dim} {dtype}: output malformed")
        if not bool((err <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"C6 {name} at D={head_dim} {dtype}: max err {err.max().item()}")
        emit({"phase": "c6", "case": name, "shape": list(q.shape), "dtype": str(dtype),
              "causal": True, "max_abs_err_vs_cpu": err.max().item(), "rtol": rtol,
              "atol": atol, "kernel_launches": launches})

    config = check_total_timesteps(compose(C6_TRANS, TRANS_ROOT), 1)
    env, _ = envs.make(config)
    setup = ff_trans_ppo.learner_setup(env, config, torch.device("cuda"),
                                       seed=int(config.arch.seed))
    for counter in (*counters, *linear_recurrence.COUNTERS):
        counter.launches = 0
    _, (_, losses) = setup.learn.update_step(setup.learner_state)
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in (*counters, *linear_recurrence.COUNTERS)}
    losses = {key: value.float().mean().item() for key, value in losses.items()}
    if (not launches[fa.FORWARD.name] or not launches[fa.BACKWARD.name]
            or launches[linear_recurrence.GAE_KERNEL.name] != 1):
        raise AssertionError(f"ff_trans_ppo at head_dim 8 launched {launches}")
    if not all(math.isfinite(value) for value in losses.values()):
        raise AssertionError(f"ff_trans_ppo at head_dim 8: non-finite losses {losses}")
    emit({"phase": "c6", "case": "ff_trans_ppo update step", "head_dim": 8,
          "launches": launches, "losses": losses, "card": smi})


C8_WIDTH = 256  # the widest head dim the kernels are built for (C8)


def phase_c8(smi: str) -> dict:
    """Head dims up to 256 run through the kernels on the card (C8): B2's
    forward and backward and B3 at D = 256 in float32, bfloat16 and float16
    against their plain versions; `best_attention` at D = 200 (padded to 256)
    and `TransformerTorso` forward and gradients at D = 256 against the CPU;
    one ff_trans_ppo update at 4 heads x 256 through B2; D = 257 refused; the
    D = 256 forward and backward timed beside their bounds. Returns the
    timing records."""
    fa, fac = flash_attention, flash_attention_chunk
    width = C8_WIDTH
    # As phase attention: float32 1e-5 absolute, bfloat16 2e-2, float16 2e-3;
    # the backward's 16-bit types also relative at those; B3 1e-5 relative to l.
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
    shapes = [((TRANS_ENVS, 16, 4, width), True), ((2, 300, 2, width), True)]
    for seed, ((shape, causal), dtype) in enumerate(
            (case, dtype) for case in shapes for dtype in tolerance):
        q, k, v = qkv_views(*shape, dtype, seed=70 + seed)
        dout = qkv_views(*shape, dtype, seed=90 + seed)[0].contiguous()
        o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
        grads = fa.backward_kernel(q, k, v, o, lse, dout, causal)
        positions = torch.arange(shape[1], dtype=torch.int32, device="cuda")
        chunk = fac.chunk_kernel(q, k, v, positions, positions, causal)
        torch.cuda.synchronize()
        want_o, want_lse = fa.plain_flash_attention_forward(q, k, v, causal, need_lse=True)
        want_grads = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
        want_chunk = fac.plain_flash_attention_chunk(q, k, v, positions, positions, causal)
        atol = tolerance[dtype]
        rtol = 0.0 if dtype == torch.float32 else atol
        forward_err = (o.float() - want_o.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        backward_errs = [(g.float() - w.float()).abs().max().item()
                         for g, w in zip(grads, want_grads)]
        chunk_errs = fac.chunk_errors(chunk, want_chunk)
        outputs = (o, *grads, *chunk)
        if any(not torch.isfinite(x).all() for x in outputs) or o.shape != q.shape:
            raise AssertionError(f"C8 kernels' output malformed at {shape} {dtype}")
        if not (forward_err <= atol and lse_err <= 1e-5):
            raise AssertionError(f"C8 forward != plain at {shape} {dtype}: {forward_err}, "
                                 f"lse {lse_err}")
        if not all(bool(((g.float() - w.float()).abs() <= atol + rtol * w.float().abs()).all())
                   for g, w in zip(grads, want_grads)):
            raise AssertionError(f"C8 backward != plain at {shape} {dtype}: {backward_errs}")
        if not max(chunk_errs) <= 1e-5:
            raise AssertionError(f"C8 chunk != plain at {shape} {dtype}: {chunk_errs}")
        emit({"phase": "c8", "case": "kernels", "shape": list(shape), "dtype": str(dtype),
              "causal": causal, "forward_max_abs_err": forward_err, "lse_max_abs_err": lse_err,
              "backward_max_abs_err_dq_dk_dv": backward_errs, "chunk_errors_m_l_pv": chunk_errs,
              "tolerance": atol, "rtol": rtol})

    # Against the CPU (2e-5, the attention tolerance): best_attention at a
    # padded head dim, one forward launch. The torso's forward and gradients
    # at D = 256, one forward and one backward launch: the output at 1e-4, the
    # torso tolerance of phase ring; the gradients at 5e-4 absolute and 1e-4
    # relative, since its 512-wide layers sum in another order on the card
    # (tests/test_torch_cuda.py, the torso at wide head dims).
    q, k, v = qkv_views(64, 16, 4, 200, torch.float32, seed=80)
    for counter in fa.COUNTERS:
        counter.launches = 0
    got = best_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = _counts(fa.COUNTERS)
    err = (got.cpu() - cpu_attention(q, k, v)).abs().max().item()
    if launches != {fa.FORWARD.name: 1, fa.BACKWARD.name: 0} or not err <= 2e-5:
        raise AssertionError(f"C8 best_attention at D=200: launches {launches}, err {err}")
    emit({"phase": "c8", "case": "best_attention", "shape": list(q.shape), "padded_to": width,
          "max_abs_err_vs_cpu": err, "tolerance": 2e-5, "kernel_launches": launches})

    torso = TransformerTorso(5, 1, 2, width, 32, generator=torch.Generator().manual_seed(0))
    x = torch.randn((3, 4, 5), generator=torch.Generator().manual_seed(1))
    want, want_grads = cpu_torso_reference(torso, x)
    for counter in fa.COUNTERS:
        counter.launches = 0
    got = torso.to("cuda")(x.to("cuda"))
    (got ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = _counts(fa.COUNTERS)
    out_err = (got.detach().cpu() - want.detach()).abs().max().item()
    grad_err = max(((p.grad.cpu() - w).abs() - 1e-4 * w.abs()).max().item()
                   for p, w in zip(torso.parameters(), want_grads))
    if launches != {fa.FORWARD.name: 1, fa.BACKWARD.name: 1} or not (out_err <= 1e-4
                                                                    and grad_err <= 5e-4):
        raise AssertionError(f"C8 torso at D=256: launches {launches}, errors {out_err}, "
                             f"{grad_err}")
    emit({"phase": "c8", "case": "transformer_torso", "head_dim": width,
          "max_abs_err_vs_cpu": out_err, "grad_err_past_1e-4_relative": grad_err,
          "tolerance": 1e-4, "grad_tolerance": 5e-4,
          "kernel_launches": launches})

    config = check_total_timesteps(compose([f"system.head_dim={width}", "system.num_heads=4",
                                            "system.multistep_impl=pallas",
                                            "logger.use_console=False"], TRANS_ROOT), 1)
    env, _ = envs.make(config)
    setup = ff_trans_ppo.learner_setup(env, config, torch.device("cuda"),
                                       seed=int(config.arch.seed))
    for counter in fa.COUNTERS:
        counter.launches = 0
    start = time.perf_counter()
    _, (_, losses) = setup.learn.update_step(setup.learner_state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = _counts(fa.COUNTERS)
    layers = int(config.system.num_layers)
    expected = {fa.FORWARD.name: 2 * layers * TRANS["rollout"] + layers
                + 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
                fa.BACKWARD.name: 2 * layers * TRANS["epochs"] * TRANS["minibatches"]}
    losses = {key: value.float().mean().item() for key, value in losses.items()}
    if launches != expected or not all(math.isfinite(value) for value in losses.values()):
        raise AssertionError(f"ff_trans_ppo at head_dim {width}: launches {launches} (expected "
                             f"{expected}), losses {losses}")
    emit({"phase": "c8", "case": "ff_trans_ppo update step", "heads": 4, "head_dim": width,
          "total_num_envs": int(config.arch.total_num_envs), "launches": launches,
          "losses": losses, "seconds": seconds, "card": smi})

    # Times at the path-like shape, float32: a launch (graph replay) and a call.
    times = timed_kernels(NARROW_ROUTE, (TRANS_ENVS, 16, 4, width), 81, smi, "c8_time")
    return {"times": times}


def sdpa_ms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            dout: torch.Tensor) -> dict:
    """SDPA's forward and its backward alone on these inputs, or the error
    that refuses them."""
    try:
        leaf = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = sdpa(*leaf, causal)
        return {"forward": cuda_ms(lambda: sdpa(q, k, v, causal)),
                "backward": cuda_ms(lambda: torch.autograd.grad(out, leaf, dout,
                                                                retain_graph=True),
                                    repeats=11, inner=20)}
    except RuntimeError as refused:
        return {"forward": None, "backward": None, "refused": str(refused)}


NARROW_ROUTE = {
    "forward": (flash_attention.forward_kernel, flash_attention.plain_flash_attention_forward),
    "backward": (flash_attention.backward_kernel, flash_attention.plain_flash_attention_backward),
    "chunk": (flash_attention_chunk.chunk_kernel,
              flash_attention_chunk.plain_flash_attention_chunk),
}
WIDE_ROUTE = {
    "forward": (flash_attention_wide.forward_kernel, flash_attention_wide.plain_wide_forward),
    "backward": (flash_attention_wide.backward_kernel, flash_attention_wide.plain_wide_backward),
    "chunk": (flash_attention_wide.chunk_kernel, flash_attention_wide.plain_wide_chunk),
}


def route_errors(kind: str, got, want, relative_backward: bool) -> tuple:
    """A kernel's largest |kernel - plain| over its outputs, and whether it
    holds (`timed_kernels`): the forward's output and lse within 1e-5; the
    backward's dQ, dK, dV within 1e-5 or, with `relative_backward` (the wide
    route's gradients reach tens), 1e-5 of the tensor's largest (at least 1);
    the chunk's `chunk_errors` (m absolute, l and pv relative to l) within
    1e-5."""
    abs_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    if kind == "chunk":
        return abs_err, max(flash_attention_chunk.chunk_errors(got, want)) <= 1e-5
    scale = max(1.0, *(w.abs().max().item() for w in want)) if (
        kind == "backward" and relative_backward) else 1.0
    return abs_err, abs_err <= 1e-5 * scale


def timed_kernels(route: dict, shape, seed: int, smi: str, phase: str,
                  relative_backward: bool = False) -> list:
    """A route's forward, backward and chunk kernels (`NARROW_ROUTE`,
    `WIDE_ROUTE`: each kind's kernel and plain version) at one float32 causal
    shape: first each held against its plain version on the same inputs
    (`route_errors`), then timed: a call, a launch replayed from a CUDA
    graph, the plain version, the bound and SDPA (forward; backward alone; B3
    has none)."""
    causal = True
    q, k, v = qkv_views(*shape, torch.float32, seed=seed)
    dout = qkv_views(*shape, torch.float32, seed=seed + 1)[0].contiguous()
    o, lse = route["forward"][0](q, k, v, causal, need_lse=True)
    positions = torch.arange(shape[1], dtype=torch.int32, device="cuda")
    args = {"forward": (q, k, v, causal), "backward": (q, k, v, o, lse, dout, causal),
            "chunk": (q, k, v, positions, positions, causal)}
    errors = {}
    for kind, (kernel, plain) in route.items():
        extra = {"need_lse": True} if kind == "forward" else {}
        got = kernel(*args[kind], **extra)
        torch.cuda.synchronize()
        want = plain(*args[kind], **extra)
        if any(not torch.isfinite(x).all() for x in got):
            raise AssertionError(f"{phase}: {kind} kernel's output malformed at {shape}")
        errors[kind], held = route_errors(kind, got, want, relative_backward)
        if not held:
            raise AssertionError(f"{phase}: {kind} kernel != plain at {shape}: {errors[kind]}")
        del got, want
    library = sdpa_ms(q, k, v, causal, dout)
    times = []
    for kind, (kernel, plain) in route.items():
        if kind == "chunk":
            bound_ms, bound_by, moved, flops = chunk_bound(q, k, positions, positions, causal)
        else:
            bound_ms, bound_by, moved, flops = attention_bound(kind, q, causal)
        record = {"phase": phase, "kernel": kind, "shape": list(shape), "dtype": "torch.float32",
                  "causal": causal, "max_abs_err": errors[kind],
                  "backward_tolerance_relative": relative_backward,
                  "ms": cuda_ms(lambda: kernel(*args[kind])),
                  "device_ms": graph_ms(lambda: kernel(*args[kind])),
                  "plain_ms": cuda_ms(lambda: plain(*args[kind]), repeats=5, inner=3),
                  "library_ms": library.get(kind), "bound_ms": bound_ms, "bound_by": bound_by,
                  "bytes": moved, "flops": flops, "card": smi}
        if "refused" in library and kind != "chunk":
            record["library_refused"] = library["refused"]
        times.append(record)
        emit(record)
    return times


# Rows that are not whole 16-byte pieces; 6 chunks; the widest one-slice head
# dim; two 512-column output slices, the second one column wide; 16 chunks.
WIDE_DIMS = (257, 384, 512, 513, 1000)
WIDE_TRANS = dict(heads=2, head_dim=512)  # phase c8_wide's ff_trans_ppo update


def phase_c8_wide(mesh, smi: str) -> list:
    """Head dims past 256 run through the wide kernels (C8): each against its
    plain version at D = 257, 384, 512, 513 and 1000 (both sides of the
    512-column slice boundary) in three dtypes, causal and not; `best_attention`
    at D = 257 and the torso's forward and gradients at D = 384 against the
    CPU; then the two paths the kernels serve, each with every counter zeroed
    just before and read just after: one ff_trans_ppo update at 2 heads x 512
    (wide forward and backward) and a one-rank ring over [64, 128, 2, 384]
    (wide chunk); then, at the update's minibatch shape [4096, 16, 2, D] for
    D = 384 and 512, each against its plain version and timed. Returns the
    three kernels-line entries, at D = 512."""
    fa, wide = flash_attention, flash_attention_wide
    counters = (*fa.COUNTERS, flash_attention_chunk.KERNEL, *wide.COUNTERS)
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
    errors = {"forward": 0.0, "backward": 0.0, "chunk": 0.0}
    cases = [(d, dtype, causal) for d in WIDE_DIMS for dtype in tolerance
             for causal in (True, False)]
    for seed, (d, dtype, causal) in enumerate(cases):
        q, k, v = qkv_views(4, 40, 2, d, dtype, seed=100 + seed)
        dout = qkv_views(4, 40, 2, d, dtype, seed=200 + seed)[0].contiguous()
        q_pos = torch.arange(24, 64, dtype=torch.int32, device="cuda")
        k_pos = torch.randperm(40, generator=torch.Generator().manual_seed(seed)).to(
            device="cuda", dtype=torch.int32)
        o, lse = wide.forward_kernel(q, k, v, causal, need_lse=True)
        grads = wide.backward_kernel(q, k, v, o, lse, dout, causal)
        chunk = wide.chunk_kernel(q, k, v, q_pos, k_pos, causal)
        torch.cuda.synchronize()
        want_o, want_lse = wide.plain_wide_forward(q, k, v, causal, need_lse=True)
        want_grads = wide.plain_wide_backward(q, k, v, o, lse, dout, causal)
        want_chunk = wide.plain_wide_chunk(q, k, v, q_pos, k_pos, causal)
        tol = tolerance[dtype]
        forward_err = (o.float() - want_o.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        # The gradients reach tens: float32 within 1e-5 of the largest (at
        # least 1), the 16-bit types also relative at their tolerance.
        backward_errs = [((g.float() - w.float()).abs().max()
                          / max(1.0, w.float().abs().max().item())).item()
                         for g, w in zip(grads, want_grads)]
        rtol = 0.0 if dtype == torch.float32 else tol
        held = all(bool(((g.float() - w.float()).abs() <= tol * max(1.0, w.float().abs().max()
                                                                    .item())
                         + rtol * w.float().abs()).all()) for g, w in zip(grads, want_grads))
        chunk_errs = flash_attention_chunk.chunk_errors(chunk, want_chunk)
        if any(not torch.isfinite(x).all() for x in (o, *grads, *chunk)):
            raise AssertionError(f"wide kernels' output malformed at D={d} {dtype} {causal}")
        if not (forward_err <= tol and lse_err <= 1e-5 and held and max(chunk_errs) <= 1e-5):
            raise AssertionError(f"wide kernels != plain at D={d} {dtype} causal={causal}: "
                                 f"forward {forward_err}, lse {lse_err}, backward "
                                 f"{backward_errs}, chunk {chunk_errs}")
        if dtype == torch.float32:
            errors = {"forward": max(errors["forward"], forward_err),
                      "backward": max(errors["backward"], *(
                          (g - w).abs().max().item() for g, w in zip(grads, want_grads))),
                      "chunk": max(errors["chunk"], *chunk_errs)}
        emit({"phase": "c8_wide", "case": "kernels", "shape": [4, 40, 2, d], "dtype": str(dtype),
              "causal": causal, "forward_max_abs_err": forward_err, "lse_max_abs_err": lse_err,
              "backward_err_of_largest_dq_dk_dv": backward_errs,
              "chunk_errors_m_l_pv": chunk_errs, "tolerance": tol, "rtol": rtol})

    # best_attention at D = 257: one wide forward launch, nothing narrow; 2e-5 of the CPU.
    q, k, v = qkv_views(64, 16, 2, 257, torch.float32, seed=300)
    for counter in counters:
        counter.launches = 0
    got = best_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = _counts(counters)
    err = (got.cpu() - cpu_attention(q, k, v)).abs().max().item()
    if launches != {**dict.fromkeys(launches, 0), wide.FORWARD.name: 1} or not err <= 2e-5:
        raise AssertionError(f"best_attention at D=257: launches {launches}, err {err}")
    emit({"phase": "c8_wide", "case": "best_attention", "shape": list(q.shape),
          "max_abs_err_vs_cpu": err, "tolerance": 2e-5, "kernel_launches": launches})

    # The torso at D = 384 (tolerances of phase c8's torso).
    torso = TransformerTorso(5, 1, 2, 384, 32, generator=torch.Generator().manual_seed(0))
    x = torch.randn((3, 4, 5), generator=torch.Generator().manual_seed(1))
    want, want_grads = cpu_torso_reference(torso, x)
    for counter in counters:
        counter.launches = 0
    got = torso.to("cuda")(x.to("cuda"))
    (got ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = _counts(counters)
    out_err = (got.detach().cpu() - want.detach()).abs().max().item()
    grad_err = max(((p.grad.cpu() - w).abs() - 1e-4 * w.abs()).max().item()
                   for p, w in zip(torso.parameters(), want_grads))
    expected = {**dict.fromkeys(launches, 0), wide.FORWARD.name: 1, wide.BACKWARD.name: 1}
    if launches != expected or not (out_err <= 1e-4 and grad_err <= 5e-4):
        raise AssertionError(f"torso at D=384: launches {launches}, errors {out_err}, {grad_err}")
    emit({"phase": "c8_wide", "case": "transformer_torso", "head_dim": 384,
          "max_abs_err_vs_cpu": out_err, "grad_err_past_1e-4_relative": grad_err,
          "tolerance": 1e-4, "grad_tolerance": 5e-4, "kernel_launches": launches})

    # Path 1: ff_trans_ppo's update at 2 heads x 512 (d_model 1024).
    config = check_total_timesteps(compose([
        f"system.head_dim={WIDE_TRANS['head_dim']}", f"system.num_heads={WIDE_TRANS['heads']}",
        "system.multistep_impl=pallas", "logger.use_console=False"], TRANS_ROOT), 1)
    env, _ = envs.make(config)
    setup = ff_trans_ppo.learner_setup(env, config, torch.device("cuda"),
                                       seed=int(config.arch.seed))
    for counter in counters:
        counter.launches = 0
    start = time.perf_counter()
    _, (_, losses) = setup.learn.update_step(setup.learner_state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    update_launches = _counts(counters)
    layers = int(config.system.num_layers)
    expected = {**dict.fromkeys(update_launches, 0),
                wide.FORWARD.name: 2 * layers * TRANS["rollout"] + layers
                + 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
                wide.BACKWARD.name: 2 * layers * TRANS["epochs"] * TRANS["minibatches"]}
    losses = {key: value.float().mean().item() for key, value in losses.items()}
    if update_launches != expected or not all(math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"ff_trans_ppo at {WIDE_TRANS}: launches {update_launches} "
                             f"(expected {expected}), losses {losses}")
    emit({"phase": "c8_wide", "case": "ff_trans_ppo update step", **WIDE_TRANS,
          "total_num_envs": int(config.arch.total_num_envs), "launches": update_launches,
          "losses": losses, "seconds": seconds, "card": smi})
    del setup

    # Path 2: the one-rank ring at D = 384, one wide chunk launch, 2e-5 of the CPU.
    q, k, v = qkv_views(RING_BATCH, 128, 2, 384, torch.float32, seed=301)
    for counter in counters:
        counter.launches = 0
    got = ring_attention(q, k, v, mesh.get_group("data"), causal=True)
    torch.cuda.synchronize()
    ring_launches = _counts(counters)
    err = (got.cpu() - cpu_attention(q, k, v)).abs().max().item()
    if ring_launches != {**dict.fromkeys(ring_launches, 0), wide.CHUNK.name: 1} or not err <= 2e-5:
        raise AssertionError(f"one-rank ring at D=384: launches {ring_launches}, err {err}")
    emit({"phase": "c8_wide", "case": "one-rank ring", "shape": list(q.shape),
          "max_abs_err_vs_cpu": err, "tolerance": 2e-5, "kernel_launches": ring_launches})

    # Held against the plain versions and timed at the update's minibatch
    # shape (both the forward and the backward run there).
    times = {d: timed_kernels(WIDE_ROUTE, (4 * TRANS_ENVS, 16, WIDE_TRANS["heads"], d), 400 + d,
                              smi, "c8_wide_time", relative_backward=True)
             for d in (384, WIDE_TRANS["head_dim"])}
    entries = []
    for index, (counter, kind, replaces, launches) in enumerate((
            (wide.FORWARD, "forward", ATTENTION_REPLACES, update_launches),
            (wide.BACKWARD, "backward", ATTENTION_REPLACES, update_launches),
            (wide.CHUNK, "chunk", CHUNK_REPLACES, ring_launches))):
        main_time = times[WIDE_TRANS["head_dim"]][index]
        entries.append({
            "name": counter.name, "route": "cuda", "source": WIDE_SOURCE, "replaces": replaces,
            "launches": launches[counter.name],
            **{key: main_time[key] for key in ("shape", "max_abs_err", "ms", "device_ms",
                                                "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "max_abs_err_small_shapes": errors[kind],
            "shapes": [times[d][index] for d in times],
        })
    return entries


# ff_ppo's main-path knobs, all on (phase knobs).
KNOBS = ["system.normalize_observations=true", "system.update_guard=skip",
         "system.fused_update=true", "arch.update_batch_size=2",
         "env.wrapper.use_cached_auto_reset=true", "logger.use_json=true",
         "logger.use_wandb=true", "logger.checkpointing.save_model=true",
         "logger.checkpointing.save_args.max_to_keep=~", "system.multistep_impl=pallas",
         "logger.use_console=False"]


def _saved_state(uid: str, step: int) -> dict:
    """A checkpoint's leaves, as utils/checkpointing.py wrote them."""
    from stoix_tpu_torch.utils import checkpointing

    path = os.path.join("checkpoints", uid, "ff_ppo", str(step), checkpointing.STATE_FILE)
    return torch.load(path, weights_only=True)


def _device_launches(learner, state) -> int:
    """Device kernel launches of one update step, counted by torch.profiler."""
    return _device_launches_of(lambda: learner.update_step(state))


def _device_launches_of(fn) -> int:
    """Device kernel launches of one call of `fn`, counted by torch.profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_knobs(smi: str) -> None:
    """ff_ppo with every main-path knob on at the default config's full width
    (1024 CartPole envs, MLP 256x256, T=16, 4 x 4 minibatches): env-steps/s,
    B1 launches and device launches per update; a resume from window 1
    against the unbroken run, bitwise; a poisoned loss under skip (the
    IdentityGame oracle with the same knobs is knobs_learn). Checkpoints and
    logs go to a temporary directory."""
    from stoix_tpu_torch.ops import losses

    lr = linear_recurrence
    full = KNOBS + ["arch.num_eval_episodes=16"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_knobs_") as tmp, contextlib.chdir(tmp):
        def run(overrides, uid):
            config = compose(full + [f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                                     f"logger.base_exp_path={tmp}/results", *overrides])
            return ff_ppo.run_experiment(config, device="cuda"), config

        for counter in lr.COUNTERS:
            counter.launches = 0
        start = time.perf_counter()
        final_return, config = run([f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2"],
                                   "unbroken")
        seconds = time.perf_counter() - start
        stats = copy.deepcopy(runner.LAST_RUN_STATS)
        gae_launches = {c.name: c.launches for c in lr.COUNTERS}
        if gae_launches != {lr.KERNEL.name: 0, lr.GAE_KERNEL.name: MAIN_UPDATES}:
            raise AssertionError(f"B1 launched {gae_launches} in {MAIN_UPDATES} updates at "
                                 "update_batch_size=2, not one GAE launch an update")
        steps = int(config.arch.total_timesteps)
        files = sorted(os.path.relpath(path, tmp) for path in glob.glob(
            os.path.join(tmp, "results", "**", "*.json*"), recursive=True))
        if not any(f.endswith("metrics.json") for f in files) or not any(
                f.endswith("wandb-history.jsonl") for f in files):
            raise AssertionError(f"the json and wandb sinks wrote {files}")

        # Resume: window 1 saved by a run of one window, then loaded and continued.
        run([f"arch.num_updates={MAIN_UPDATES // 2}", "arch.num_evaluation=1"], "first")
        run([f"arch.num_updates={MAIN_UPDATES // 2}", "arch.num_evaluation=1",
             "logger.checkpointing.load_model=true",
             "logger.checkpointing.load_args.checkpoint_uid=first"], "resumed")
        unbroken, resumed = _saved_state("unbroken", steps), _saved_state("resumed", steps)
        differ = [key for key, value in unbroken.items() if not (
            torch.equal(value, resumed[key]) if isinstance(value, torch.Tensor) else
            torch.equal(value["generator_state"], resumed[key]["generator_state"])
            if isinstance(value, dict) else value == resumed[key])]
        if unbroken.keys() != resumed.keys() or differ:
            raise AssertionError(f"the resumed run differs from the unbroken one at {differ}")

        # A poisoned loss (NaN, and NaN gradients, at its second call) under skip.
        clip, calls = losses.ppo_clip_loss, {"n": 0}

        def poisoned(*args, **kwargs):
            calls["n"] += 1
            loss = clip(*args, **kwargs)
            return loss * float("nan") if calls["n"] == 2 else loss

        losses.ppo_clip_loss = poisoned
        try:
            run([f"arch.num_updates={MAIN_UPDATES // 2}", "arch.num_evaluation=1"], "poisoned")
        finally:
            losses.ppo_clip_loss = clip
        skipped = runner.LAST_RUN_STATS["resilience"]["skipped_updates"]
        poisoned_state = _saved_state("poisoned", steps // 2)
        finite = all(bool(torch.isfinite(v).all()) for k, v in poisoned_state.items()
                     if k.startswith("params/"))
        if not (skipped > 0 and finite):
            raise AssertionError(f"skip left skipped_updates {skipped}, finite params {finite}")

        env, _ = envs.make(config)
        setup = ff_ppo.learner_setup(env, config, torch.device("cuda"),
                                     seed=int(config.arch.seed))
        state, _ = setup.learn.update_step(setup.learner_state)  # warm-up
        launches = _device_launches(setup.learn, state)
    emit({"phase": "knobs", "env": "cartpole", "total_num_envs": int(config.arch.total_num_envs),
          "update_batch_size": 2, "updates": MAIN_UPDATES, "knobs": KNOBS,
          "b1_gae_launches_per_update": gae_launches[lr.GAE_KERNEL.name] / MAIN_UPDATES,
          "device_launches_per_update": launches,
          "env_steps_per_second": stats["steps_per_second"],
          "window_seconds": stats["window_seconds"], "final_eval_return": final_return,
          "resume_bitwise": True, "resumed_leaves": len(unbroken),
          "poisoned_skipped_updates": skipped, "poisoned_params_finite": finite,
          "sink_files": files, "seconds": seconds, "card": smi})


def phase_knobs_learn() -> None:
    """IdentityGame with every main-path knob on (KNOBS) above 8.0, in the
    pool of oracles (it was phase knobs' last run, in the script's timed
    part); its checkpoints and logs go to a temporary directory."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_knobs_") as tmp, contextlib.chdir(tmp):
        config = compose(KNOBS + IDENTITY + [
            "arch.num_eval_episodes=16", "system.rollout_length=16", "system.epochs=4",
            "logger.checkpointing.save_args.checkpoint_uid=identity",
            f"logger.base_exp_path={tmp}/results"])
        learn_return = ff_ppo.run_experiment(config, device="cuda")
    if not learn_return > 8.0:
        raise AssertionError(f"IdentityGame with every knob on returned {learn_return}")
    emit({"phase": "knobs_learn", "env": "identity_game", "knobs": KNOBS,
          "final_return": learn_return, "seconds": time.perf_counter() - start})


# The value-based family: the JAX package's IdentityGame oracles (10.0 on the
# CPU with these overrides); ff_pqn at 32768 steps, where the JAX package
# returns 10.0 on every seed tried (at 16384 it misses 8.0 on two of four).
Q_IDENTITY = ["env=identity_game", "arch.total_num_envs=16", "arch.num_evaluation=1",
              "arch.num_eval_episodes=32", "logger.use_console=False"]
Q_LEARN = {
    "ff_dqn": (ff_dqn, ["arch.total_timesteps=16384", "system.total_buffer_size=4096",
                        "system.total_batch_size=64"]),
    "ff_pqn": (ff_pqn, ["arch.total_timesteps=32768", "system.decay_epsilon=false",
                        "system.num_minibatches=2", "system.multistep_impl=pallas"]),
}
Q_SYSTEMS = {"ff_dqn": ff_dqn, "ff_ddqn": ff_ddqn, "ff_dqn_reg": ff_dqn_reg, "ff_mdqn": ff_mdqn,
             "ff_c51": ff_c51, "ff_qr_dqn": ff_qr_dqn, "ff_pqn": ff_pqn}


def phase_q_learn() -> None:
    for name, (module, overrides) in Q_LEARN.items():
        config = compose(Q_IDENTITY + overrides, f"default/anakin/default_{name}.yaml")
        start = time.perf_counter()
        final_return = module.run_experiment(config, device="cuda")
        if not final_return > 8.0:
            raise AssertionError(f"{name} did not learn IdentityGame on the card: {final_return}")
        emit({"phase": "q_learn", "system": name, "env": "identity_game",
              "final_return": final_return, "seconds": time.perf_counter() - start})


def phase_q_train(smi: str) -> int:
    """ff_dqn and ff_pqn (multistep_impl=pallas) at their default configs'
    full width on CartPole, MAIN_UPDATES updates in 2 eval windows: env-steps/s
    per window and device launches an update (torch.profiler, after a
    warm-up step); B1's counters zeroed just before ff_pqn's run and read
    just after: exactly one generic launch an update, no GAE one. Then the
    other five systems one window each at their default widths, each
    finite. Returns B1 generic's launches in ff_pqn's run."""
    lr = linear_recurrence
    pallas_launches = None
    for name, module in Q_SYSTEMS.items():
        full = name in ("ff_dqn", "ff_pqn")
        config = compose([f"arch.num_updates={MAIN_UPDATES if full else 2}",
                          f"arch.num_evaluation={2 if full else 1}", "arch.num_eval_episodes=16",
                          "system.multistep_impl=pallas", "logger.use_console=False"],
                         f"default/anakin/default_{name}.yaml")
        for counter in lr.COUNTERS:
            counter.launches = 0
        start = time.perf_counter()
        final_return = module.run_experiment(config, device="cuda")
        seconds = time.perf_counter() - start
        b1 = _counts(lr.COUNTERS)
        stats = copy.deepcopy(runner.LAST_RUN_STATS)
        train = [rec for rec in stats["history"] if rec["event"] == "trainer"]
        if not math.isfinite(final_return) or not train or not all(
                math.isfinite(v) for rec in train for k, v in rec.items()
                if k not in ("event", "t", "t_eval")):
            raise AssertionError(f"{name}: non-finite return {final_return} or metrics {train}")
        record = {"phase": "q_train", "system": name, "env": "cartpole",
                  "total_num_envs": int(config.arch.total_num_envs),
                  "rollout_length": int(config.system.rollout_length),
                  "updates": int(config.arch.num_updates), "final_eval_return": final_return,
                  "last_train_metrics": train[-1], "b1_launches": b1,
                  "window_seconds": stats["window_seconds"],
                  "env_steps_per_second": stats["steps_per_second"], "seconds": seconds,
                  "card": smi}
        if name == "ff_pqn":
            pallas_launches = b1[lr.KERNEL.name]
            if b1 != {lr.KERNEL.name: int(config.arch.num_updates), lr.GAE_KERNEL.name: 0}:
                raise AssertionError(f"ff_pqn launched B1 {b1} in {config.arch.num_updates} "
                                     "updates, not one generic launch an update")
            record["b1_generic_launches_per_update"] = pallas_launches / MAIN_UPDATES
        if full:
            config = check_total_timesteps(config, 1)
            env, _ = envs.make(config)
            device, seed = torch.device("cuda"), int(config.arch.seed)
            if name == "ff_pqn":
                setup = ff_pqn.learner_setup(env, config, device, seed)
                state = setup.learner_state
            else:
                setup, warmup = q_family.q_learner_setup(env, config, device, seed,
                                                         ff_dqn.dqn_loss)
                state = warmup(setup.learner_state)
            state, _ = setup.learn.update_step(state)  # warm-up
            record["device_launches_per_update"] = _device_launches(setup.learn, state)
        emit(record)
    return pallas_launches


# ---------------------------------------------------- the continuous PPO family and rec_ppo

CONT_ROOT = "default/anakin/default_ff_ppo_continuous.yaml"
REC_ROOT = "default/anakin/default_rec_ppo.yaml"
# Pendulum's learning oracle, fixed before any card run of these systems by
# scripts/jax_oracle_thresholds.py on the CPU: uniform random actions return
# -1221.52 (4096 episodes); the JAX package's ff_ppo_continuous under these
# overrides returns -247.88 (seeds 1 and 2: -215.59, -127.38); the threshold
# is their midpoint.
PENDULUM = ["arch.total_num_envs=64", "arch.total_timesteps=524288", "arch.num_evaluation=4",
            "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
            "arch.absolute_metric=False", "system.reward_scale=0.1",
            "system.multistep_impl=pallas", "logger.use_console=False"]
PENDULUM_RANDOM_RETURN, PENDULUM_JAX_RETURN = -1221.5223388671875, -247.8776092529297
PENDULUM_THRESHOLD = (PENDULUM_RANDOM_RETURN + PENDULUM_JAX_RETURN) / 2
# ff_ppo_penalty with adaptive beta: tests/test_ff_ppo.py::test_ppo_penalty_adaptive_kl_beta_runs.
PENALTY_IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=65536",
                    "arch.num_evaluation=1", "arch.num_eval_episodes=32",
                    "arch.absolute_metric=False", "system.rollout_length=16",
                    "system.adaptive_kl_beta=true", "system.kl_target=0.01",
                    "system.multistep_impl=pallas", "logger.use_console=False"]
# rec_ppo's IdentityGame oracle: the JAX package's rec_ppo returns 10.0 under
# these overrides on the CPU (scripts/jax_oracle_thresholds.py).
REC_IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=32768",
                "arch.num_evaluation=1", "arch.num_eval_episodes=32",
                "arch.evaluation_greedy=True", "arch.absolute_metric=False",
                "system.multistep_impl=pallas", "logger.use_console=False"]

# The continuous actor-critics' learning oracle: ff_sac on Pendulum (64 envs,
# 393 216 steps, 768 updates of 4 epochs), fixed before any card run of it by
# scripts/jax_oracle_thresholds.py on the CPU: the JAX package's ff_sac under
# these overrides returns -191.12 (seed 1: -176.37), uniform random actions
# -1221.52; the threshold is their midpoint.
SAC_PENDULUM = ["arch.total_num_envs=64", "arch.total_timesteps=393216", "arch.num_evaluation=4",
                "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
                "arch.absolute_metric=False", "logger.use_console=False"]
SAC_JAX_RETURN = -191.12234497070312
SAC_THRESHOLD = (PENDULUM_RANDOM_RETURN + SAC_JAX_RETURN) / 2
# ff_reinforce's and ff_awr's IdentityGame oracles (64 envs; 65 536 and 32 768
# steps): the JAX package returns 10.0 there (scripts/jax_oracle_thresholds.py,
# seeds 42 and 1), uniform random actions 2.5; the threshold is the family's 8.0.
VPG_IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=65536",
                "arch.num_evaluation=1", "arch.num_eval_episodes=32",
                "arch.evaluation_greedy=True", "arch.absolute_metric=False",
                "system.multistep_impl=pallas", "logger.use_console=False"]
AWR_IDENTITY = [o if o != "arch.total_timesteps=65536" else "arch.total_timesteps=32768"
                for o in VPG_IDENTITY]
PG_THRESHOLD = 8.0
# ff_mpo's and ff_vmpo's IdentityGame oracles (16 envs, 16 384 steps, a
# 4 096-step buffer, batches of 64; 64 envs, 32 768 steps): the JAX package
# returns 10.0 there for seeds 42 and 1 (scripts/jax_oracle_thresholds.py
# --oracles mpo vmpo), uniform random actions 2.5; the threshold is 8.0.
MPO_IDENTITY = ["env=identity_game", "arch.total_num_envs=16", "arch.total_timesteps=16384",
                "system.total_buffer_size=4096", "system.total_batch_size=64",
                "arch.num_evaluation=1", "arch.num_eval_episodes=32",
                "arch.evaluation_greedy=True", "arch.absolute_metric=False",
                "system.multistep_impl=pallas", "logger.use_console=False"]
VMPO_IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=32768",
                 "arch.num_evaluation=1", "arch.num_eval_episodes=32",
                 "arch.evaluation_greedy=True", "arch.absolute_metric=False",
                 "system.multistep_impl=pallas", "logger.use_console=False"]
MPO_THRESHOLD = 8.0
MPO_ROOTS = {name: f"default/anakin/default_{name}.yaml"
             for name in ("ff_mpo", "ff_mpo_continuous", "ff_vmpo", "ff_vmpo_continuous")}
AC_ROOTS = {name: f"default/anakin/default_{name}.yaml"
            for name in ("ff_ddpg", "ff_td3", "ff_d4pg", "ff_sac")}
VPG_ROOT = "default/anakin/default_ff_reinforce.yaml"
AWR_ROOT = "default/anakin/default_ff_awr.yaml"


def _finite_run(name: str, final_return: float) -> list:
    """The run's trainer records, after checking they and the return are finite."""
    train = [rec for rec in runner.LAST_RUN_STATS["history"] if rec["event"] == "trainer"]
    if not math.isfinite(final_return) or not train or not all(
            math.isfinite(v) for rec in train for k, v in rec.items()
            if k not in ("event", "t", "t_eval")):
        raise AssertionError(f"{name}: non-finite return {final_return} or metrics {train}")
    return train


def phase_cont_learn() -> None:
    """ff_ppo_penalty with adaptive beta on IdentityGame above 4.0 (the JAX
    package's oracle), then ff_ppo_continuous on Pendulum above the
    threshold fixed beforehand."""
    from stoix_tpu_torch.systems.ppo.anakin import ff_ppo_continuous, ff_ppo_penalty

    for name, module, root, overrides, limit in (
            ("ff_ppo_penalty", ff_ppo_penalty, "default/anakin/default_ff_ppo_penalty.yaml",
             PENALTY_IDENTITY, 4.0),
            ("ff_ppo_continuous", ff_ppo_continuous, CONT_ROOT, PENDULUM, PENDULUM_THRESHOLD)):
        start = time.perf_counter()
        final_return = module.run_experiment(compose(overrides, root), device="cuda")
        if not final_return > limit:
            raise AssertionError(f"{name} returned {final_return}, not above {limit}")
        emit({"phase": "cont_learn", "system": name, "final_return": final_return,
              "threshold": limit, "window_seconds": runner.LAST_RUN_STATS["window_seconds"],
              "seconds": time.perf_counter() - start})


def _b1_path_run(name: str, module, root: str, overrides: list, smi: str,
                 device_launches: bool) -> dict:
    """One system's run with B1's counters zeroed just before and read just
    after: exactly one GAE launch an update and no generic one; finite.
    With `device_launches`, one more update step is profiled after a warm-up."""
    lr = linear_recurrence
    config = compose(overrides, root)
    for counter in lr.COUNTERS:
        counter.launches = 0
    start = time.perf_counter()
    final_return = module.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    b1 = _counts(lr.COUNTERS)
    stats = copy.deepcopy(runner.LAST_RUN_STATS)
    train = _finite_run(name, final_return)
    config = check_total_timesteps(config, 1)
    updates = int(config.arch.num_updates)
    if b1 != {lr.KERNEL.name: 0, lr.GAE_KERNEL.name: updates}:
        raise AssertionError(f"{name} launched B1 {b1} in {updates} updates, not one GAE "
                             "launch an update and no generic one")
    record = {"system": name, "env": config.env.scenario.name,
              "total_num_envs": int(config.arch.total_num_envs),
              "rollout_length": int(config.system.rollout_length),
              "epochs": int(config.system.epochs),
              "num_minibatches": int(config.system.num_minibatches), "updates": updates,
              "head": config.network.actor_network.action_head["_target_"].rsplit(".", 1)[-1],
              "b1_gae_launches_per_update": b1[lr.GAE_KERNEL.name] / updates,
              "b1_generic_launches": b1[lr.KERNEL.name], "final_eval_return": final_return,
              "last_train_metrics": train[-1], "window_seconds": stats["window_seconds"],
              "env_steps_per_second": stats["steps_per_second"], "seconds": seconds,
              "card": smi}
    if device_launches:
        env, _ = envs.make(config)
        setup = module.learner_setup(env, config, torch.device("cuda"), int(config.arch.seed))
        state, _ = setup.learn.update_step(setup.learner_state)  # warm-up
        record["device_launches_per_update"] = _device_launches(setup.learn, state)
    return record


def phase_cont_train(smi: str) -> int:
    """ff_ppo_continuous at its default config's full width (1024 Pendulum
    envs, T=16, 4 x 4 minibatches, MLP 256x256 silu, the tanh-Gaussian head
    on [-2, 2]), MAIN_UPDATES updates in 2 eval windows; then ff_ppo_penalty
    (CartPole, adaptive beta), ff_ppo_penalty_continuous, ff_dpo_continuous
    (4 x 16 minibatches) and ff_ppo_continuous with the Beta and the
    diagonal-Gaussian heads, one window of 2 updates each at their default
    widths. Returns B1's GAE launches in the first run."""
    from stoix_tpu_torch.systems.ppo.anakin import (
        ff_dpo_continuous, ff_ppo_continuous, ff_ppo_penalty, ff_ppo_penalty_continuous,
    )

    common = ["arch.num_eval_episodes=16", "system.multistep_impl=pallas",
              "logger.use_console=False"]
    main_run = [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2", *common]
    short = ["arch.num_updates=2", "arch.num_evaluation=1", *common]
    beta_head = ("network.actor_network.action_head._target_="
                 "stoix_tpu_torch.networks.heads.BetaDistributionHead")
    runs = [
        ("ff_ppo_continuous", ff_ppo_continuous, CONT_ROOT, main_run, True),
        ("ff_ppo_penalty", ff_ppo_penalty, "default/anakin/default_ff_ppo_penalty.yaml",
         short + ["system.adaptive_kl_beta=true"], False),
        ("ff_ppo_penalty_continuous", ff_ppo_penalty_continuous,
         "default/anakin/default_ff_ppo_penalty_continuous.yaml", short, False),
        ("ff_dpo_continuous", ff_dpo_continuous, "default/anakin/default_ff_dpo_continuous.yaml",
         short, False),
        ("ff_ppo_continuous", ff_ppo_continuous, CONT_ROOT, short + [beta_head], False),
        ("ff_ppo_continuous", ff_ppo_continuous, CONT_ROOT,
         short + ["network=mlp_mvn_continuous"], False),
    ]
    launches = None
    for name, module, root, overrides, full in runs:
        record = _b1_path_run(name, module, root, overrides, smi, device_launches=full)
        if launches is None:
            launches = int(record["b1_gae_launches_per_update"] * record["updates"])
        emit({"phase": "cont_train", **record})
    return launches


def phase_rec_learn() -> None:
    from stoix_tpu_torch.systems.ppo.anakin import rec_ppo

    start = time.perf_counter()
    final_return = rec_ppo.run_experiment(compose(REC_IDENTITY, REC_ROOT), device="cuda")
    if not final_return > 8.0:
        raise AssertionError(f"rec_ppo did not learn IdentityGame on the card: {final_return}")
    emit({"phase": "rec_learn", "env": "identity_game", "final_return": final_return,
          "seconds": time.perf_counter() - start})


def phase_rec_train(smi: str) -> int:
    """rec_ppo at its default config's full width (1024 CartPole envs, T=16,
    GRU 128 between pre- and post-torsos of 128, 4 x 4 minibatches of env
    sequences), MAIN_UPDATES updates in 2 eval windows: one B1 GAE launch an
    update, env-steps/s, device launches an update. Returns B1's GAE
    launches in the run."""
    from stoix_tpu_torch.systems.ppo.anakin import rec_ppo

    record = _b1_path_run("rec_ppo", rec_ppo, REC_ROOT, [
        f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2", "arch.num_eval_episodes=16",
        "system.multistep_impl=pallas", "logger.use_console=False"], smi, device_launches=True)
    emit({"phase": "rec_train", **record})
    return int(record["b1_gae_launches_per_update"] * record["updates"])


# ---------------------------------------------------- sequence replay: ff_rainbow and rec_r2d2

SEQUENCE_ROOTS = {"ff_rainbow": "default/anakin/default_ff_rainbow.yaml",
                  "rec_r2d2": "default/anakin/default_rec_r2d2.yaml"}
SEQUENCE_PHASE = {"ff_rainbow": "rainbow", "rec_r2d2": "r2d2"}
# The IdentityGame oracles, fixed before any card run of these systems by
# scripts/jax_oracle_thresholds.py on the CPU: the JAX package's ff_rainbow
# returns 10.0 (seeds 42 and 1) and its rec_r2d2 8.9875 and 8.9937 under
# these overrides, where uniform random actions return 2.5 (4 actions, 10
# steps); the threshold is the family's 8.0.
SEQUENCE_IDENTITY = {
    "ff_rainbow": ["env=identity_game", "arch.total_num_envs=16", "arch.num_evaluation=1",
                   "arch.num_eval_episodes=32", "arch.total_timesteps=65536",
                   "system.total_buffer_size=4096", "system.total_batch_size=64",
                   "system.vmin=0.0", "system.vmax=10.0", "logger.use_console=False"],
    "rec_r2d2": ["env=identity_game", "arch.total_num_envs=16", "arch.num_evaluation=1",
                 "arch.num_eval_episodes=32", "arch.total_timesteps=131072",
                 "system.total_buffer_size=4096", "system.total_batch_size=16",
                 "logger.use_console=False"],
}
SEQUENCE_THRESHOLD = 8.0


def _sequence_module(name: str):
    from stoix_tpu_torch.systems.q_learning import ff_rainbow, rec_r2d2

    return {"ff_rainbow": ff_rainbow, "rec_r2d2": rec_r2d2}[name]


def _kernel_counters() -> tuple:
    """Every kernel's launch counter: B1's two entry points, B2's forward and
    backward, B3, and the wide route's three."""
    return (*linear_recurrence.COUNTERS, *flash_attention.COUNTERS, flash_attention_chunk.KERNEL,
            *flash_attention_wide.COUNTERS)


def phase_sequence_learn(name: str) -> None:
    """`name` trains IdentityGame on the card above the threshold."""
    start = time.perf_counter()
    final_return = _sequence_module(name).run_experiment(
        compose(SEQUENCE_IDENTITY[name], SEQUENCE_ROOTS[name]), device="cuda")
    if not final_return > SEQUENCE_THRESHOLD:
        raise AssertionError(f"{name} did not learn IdentityGame on the card: {final_return}")
    emit({"phase": f"{SEQUENCE_PHASE[name]}_learn", "system": name, "env": "identity_game",
          "final_return": final_return, "threshold": SEQUENCE_THRESHOLD,
          "window_seconds": runner.LAST_RUN_STATS["window_seconds"],
          "seconds": time.perf_counter() - start})


def _sequence_setup(name: str, config, device: torch.device, seed: int):
    """(the system's setup, its learner state ready to update) on `device`."""
    setup = _sequence_module(name).learner_setup(envs.make(config)[0], config, device, seed)
    if name == "ff_rainbow":  # (setup, its warmup fill)
        setup, warmup = setup
        return setup, warmup(setup.learner_state)
    return setup, setup.learner_state


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _relative(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got.cpu() - want).abs() / want.abs().clamp_min(1e-30)).max())


def _update_on_card_and_cpu(name: str, config, setup, state) -> dict:
    """One update epoch on a PrioritisedSample drawn on the card, run by the
    card's learner and by the same learner built on the CPU, from the same
    params (Rainbow's three noise draws made on the card and given to both):
    the loss 1e-5 relative, the params 1e-5 absolute, the new priorities
    1e-5 relative."""
    cpu = torch.device("cpu")
    cpu_setup, _ = _sequence_setup(name, config, cpu, int(config.arch.seed))
    sample = setup.learn.buffer.sample(state.buffer_state, state.generator)
    params, opt = state.params, state.opt_states
    updates = {"card": setup.learn.update_from_batch, "cpu": cpu_setup.learn.update_from_batch}
    if name == "ff_rainbow":
        draws = [updates["card"].q_apply.draw_noise(state.generator) for _ in range(3)]
        given = {"card": draws, "cpu": tree_map(lambda x: x.cpu(), draws)}
        for side, update in updates.items():
            queue = list(given[side])
            update.q_apply.draw_noise = lambda generator, queue=queue: queue.pop(0)
    out = {}
    for side, update in updates.items():
        move = (lambda x: x) if side == "card" else (lambda x: x.cpu())
        out[side] = update([tree_map(move, params)], [tree_map(move, opt)],
                           [tree_map(move, sample)], [None])
    (card_params, _, card_info, card_prio), (cpu_params, _, cpu_info, cpu_prio) = (
        out["card"], out["cpu"])
    loss_err = _relative(card_info["q_loss"], cpu_info["q_loss"])
    param_err = max(float((a.cpu() - b).abs().max()) for side in (0, 1)
                    for a, b in zip(card_params[0][side].values(), cpu_params[0][side].values()))
    prio_err = _relative(card_prio[0], cpu_prio[0])
    if not (loss_err <= 1e-5 and param_err <= 1e-5 and prio_err <= 1e-5):
        raise AssertionError(f"{name}'s update on the card is not the CPU's: loss {loss_err}, "
                             f"params {param_err}, priorities {prio_err}")
    return {"loss_relative_err": loss_err, "params_abs_err": param_err,
            "priorities_relative_err": prio_err, "sample_batch": int(sample.indices.shape[0])}


def _set_priorities_on_card(buffer, state, exponent: float) -> dict:
    """`set_priorities` on the card, twice from the same table, on indices with
    duplicates: bitwise equal both times; on the card and on the CPU every
    written entry is, bitwise, that device's (|p| + 1e-6) ** a of the LAST
    occurrence of its index, and the rest of the table is untouched; the two
    devices agree to 1e-6 relative (their `pow` may round an ulp apart)."""
    priorities = state.buffer_state.priorities
    rows, slots = priorities.shape
    gen = torch.Generator().manual_seed(7)
    indices = torch.stack([torch.randint(0, rows, (4096,), generator=gen),
                           torch.randint(0, min(slots, 8), (4096,), generator=gen)], -1)
    values = torch.randn(4096, generator=gen)
    last = {}  # (row, slot) -> the position of its last occurrence
    for position, (row, slot) in enumerate(indices.tolist()):
        last[(row, slot)] = position
    written = torch.tensor(list(last.keys()))
    positions = torch.tensor(list(last.values()))
    results = []
    for device in ("cuda", "cuda", "cpu"):
        table = state.buffer_state._replace(priorities=priorities.clone().to(device))
        out = buffer.set_priorities(table, indices.to(device), values.to(device)).priorities
        # The same elementwise power over the same vector (a CPU `pow` may
        # round a vector lane and a scalar tail apart), then each index's
        # last occurrence.
        powered = torch.pow(values.to(device).abs() + 1e-6, exponent)
        want = priorities.clone().to(device)
        want[written[:, 0], written[:, 1]] = powered[positions.to(device)]
        if not torch.equal(out, want):
            raise AssertionError(f"set_priorities on {device} did not keep the last occurrence")
        results.append(out.cpu())
    if not torch.equal(results[0], results[1]):
        raise AssertionError("set_priorities on the card differs between two runs")
    across = _relative(results[0], results[2])
    if not across <= 1e-6:
        raise AssertionError(f"set_priorities on the card is {across} from the CPU's")
    return {"indices": 4096, "duplicates": duplicate_indices(indices), "bitwise_twice": True,
            "last_wins_on_card_and_cpu": True, "card_vs_cpu_relative_err": across}


def phase_sequence_train(name: str, smi: str) -> dict:
    """`name` at its default config's full width on CartPole, MAIN_UPDATES
    updates in 2 eval windows through `run_experiment`, every kernel counter
    zeroed just before and read just after (no kernel is on this path:
    every count must stay 0); then, on the same config: device launches an
    update (torch.profiler, after a warm-up step), the duplicate indices that
    `set_priorities` collapsed over two more updates, the buffers' device
    bytes, an update on the card against the CPU, and `set_priorities` on
    the card against itself and the CPU."""
    module = _sequence_module(name)
    config = compose([f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
                      "arch.num_eval_episodes=16", "logger.use_console=False"],
                     SEQUENCE_ROOTS[name])
    counters = _kernel_counters()
    for counter in counters:
        counter.launches = 0
    start = time.perf_counter()
    final_return = module.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    launches = _counts(counters)
    stats = copy.deepcopy(runner.LAST_RUN_STATS)
    train = _finite_run(name, final_return)
    if any(launches.values()):
        raise AssertionError(f"{name} launched kernels {launches}; none is on its path")

    config = check_total_timesteps(config, 1)
    setup, state = _sequence_setup(name, config, torch.device("cuda"), int(config.arch.seed))
    state, _ = setup.learn.update_step(state)  # warm-up
    device_launches = _device_launches(setup.learn, state)
    recorded = []
    buffer = setup.learn.buffer

    def recording(buffer_state, indices, priorities):
        recorded.append(indices.clone())
        return buffer.set_priorities(buffer_state, indices, priorities)

    setup.learn.buffer = buffer._replace(set_priorities=recording)
    for _ in range(2):
        state, _ = setup.learn.update_step(state)
    setup.learn.buffer = buffer
    duplicates = [duplicate_indices(i) for i in recorded]
    record = {
        "phase": f"{SEQUENCE_PHASE[name]}_train", "system": name, "env": "cartpole",
        "total_num_envs": int(config.arch.total_num_envs),
        "rollout_length": int(config.system.rollout_length),
        "epochs": int(config.system.epochs), "updates": MAIN_UPDATES,
        "kernel_launches": launches, "final_eval_return": final_return,
        "last_train_metrics": train[-1], "window_seconds": stats["window_seconds"],
        "env_steps_per_second": stats["steps_per_second"], "seconds": seconds,
        "device_launches_per_update": device_launches,
        "buffer_device_bytes": _tree_bytes(state.buffer_state),
        "priority_slots": list(state.buffer_state.priorities.shape),
        "set_priorities_calls": len(recorded), "duplicate_indices_per_call": duplicates,
        "update_on_card_vs_cpu": _update_on_card_and_cpu(name, config, setup, state),
        "set_priorities_on_card": _set_priorities_on_card(
            buffer, state, float(config.system.priority_exponent)),
        "card": smi,
    }
    emit(record)
    return launches


# ---------------------------------------------------- A12: actor-critics, REINFORCE, AWR


def _a12_module(name: str):
    import importlib

    package = {"ff_ddpg": "ddpg", "ff_td3": "ddpg", "ff_d4pg": "ddpg", "ff_sac": "sac",
               "ff_reinforce": "vpg", "ff_reinforce_continuous": "vpg", "ff_awr": "awr",
               "ff_awr_continuous": "awr", **dict.fromkeys(MPO_ROOTS, "mpo"),
               **dict.fromkeys(SEARCH_ROOTS, "search"), **dict.fromkeys(SPO_ROOTS, "spo"),
               "ff_disco103": "disco", "ff_ppo": "ppo.anakin", "ff_ppo_continuous": "ppo.anakin",
               "ff_dqn": "q_learning", "ff_c51": "q_learning"}[name]
    return importlib.import_module(f"stoix_tpu_torch.systems.{package}.{name}")


def _path_run(name: str, root: str, overrides: list, want: dict, phase: str, smi: str,
              device_launches: bool) -> dict:
    """One `run_experiment` of `name`, every kernel counter zeroed just
    before and read just after: each must equal `want` (name -> launches an
    update; the rest 0). With `device_launches`, one more update step of a
    fresh setup is profiled after a warm-up step (and its warm-up fill)."""
    module = _a12_module(name)
    config = compose(overrides, root)
    counters = _kernel_counters()
    for counter in counters:
        counter.launches = 0
    start = time.perf_counter()
    final_return = module.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    launches = _counts(counters)
    stats = copy.deepcopy(runner.LAST_RUN_STATS)
    train = _finite_run(name, final_return)
    config = check_total_timesteps(config, 1)
    updates = int(config.arch.num_updates)
    expected = {c.name: want.get(c.name, 0) * updates for c in counters}
    if launches != expected:
        raise AssertionError(f"{name} launched {launches} in {updates} updates, not {expected}")
    record = {"phase": phase, "system": name, "env": config.env.scenario.name,
              "total_num_envs": int(config.arch.total_num_envs),
              "rollout_length": int(config.system.rollout_length), "updates": updates,
              "kernel_launches": launches, "final_eval_return": final_return,
              "last_train_metrics": train[-1], "window_seconds": stats["window_seconds"],
              "env_steps_per_second": stats["steps_per_second"], "seconds": seconds, "card": smi}
    if device_launches:
        setup = module.learner_setup(envs.make(config)[0], config, torch.device("cuda"),
                                     int(config.arch.seed))
        setup, state = (setup, setup.learner_state) if hasattr(setup, "learner_state") else (
            setup[0], setup[1](setup[0].learner_state))
        state, _ = setup.learn.update_step(state)  # warm-up
        record["device_launches_per_update"] = _device_launches(setup.learn, state)
        if hasattr(state, "buffer_state"):
            record["buffer_device_bytes"] = _tree_bytes(state.buffer_state)
        record["_setup_state"] = (setup, state, config)
    return record


def _max_err(got, want) -> float:
    return max(float((a.cpu() - b).abs().max()) for a, b in zip(tree_leaves(got),
                                                                 tree_leaves(want)))


def _ac_update_on_card_and_cpu(name: str, config, setup, state) -> dict:
    """One `update_from_batch` of an actor-critic on a batch sampled on the
    card, with noise drawn on the card, run by the card's update and by the
    same update built on the CPU, from the same params: losses 1e-5
    relative, params 1e-5 absolute. ff_td3 takes two steps from its count
    (a policy step, then an off step), compared after each."""
    cpu_setup, _ = _a12_module(name).learner_setup(envs.make(config)[0], config,
                                                   torch.device("cpu"), int(config.arch.seed))
    generator = state.generator
    batch = setup.learn.buffer.sample(state.buffer_state, generator).experience
    card_update, cpu_update = setup.learn.update_from_batch, cpu_setup.learn.update_from_batch
    sides = {"card": ([state.params], [state.opt_states]),
             "cpu": ([tree_map(lambda x: x.cpu(), state.params)],
                     [tree_map(lambda x: x.cpu(), state.opt_states)])}
    steps = []
    if name == "ff_td3":
        count, adam = state.opt_states.count, state.opt_states.opt_states.actor_opt_state.count
    for _ in range(2 if name == "ff_td3" else 1):
        noise = card_update.draw_noise(batch, generator)
        out = {}
        for side, update in (("card", card_update), ("cpu", cpu_update)):
            move = (lambda x: x) if side == "card" else (lambda x: x.cpu())
            params, opts = sides[side]
            out[side] = update.step(params, opts, [tree_map(move, batch)],
                                    [tree_map(move, noise)])
            sides[side] = out[side][:2]
        (card_params, card_opts, card_info), (cpu_params, _, cpu_info) = out["card"], out["cpu"]
        loss_err = max(_relative(card_info[k], cpu_info[k]) for k in cpu_info
                       if k.endswith("loss"))
        param_err = _max_err(card_params, cpu_params)
        if not (loss_err <= 1e-5 and param_err <= 1e-5):
            raise AssertionError(f"{name}'s update on the card is not the CPU's: loss {loss_err}, "
                                 f"params {param_err}")
        step = {"loss_relative_err": loss_err, "params_abs_err": param_err}
        if name == "ff_td3":
            # A policy step where count % policy_frequency == 0: the actor's
            # Adam steps there and nowhere else.
            policy = count % int(config.system.policy_frequency) == 0
            new_adam = card_opts[0].opt_states.actor_opt_state.count
            if new_adam != adam + int(policy):
                raise AssertionError(f"ff_td3 at count {count}: actor Adam {adam} -> {new_adam}")
            step.update(count=count, policy_step=policy, actor_adam_count=new_adam)
            count, adam = card_opts[0].count, new_adam
        steps.append(step)
    return {"sample_batch": int(batch.reward.shape[0]), "steps": steps}


def phase_ac_train(smi: str) -> dict:
    """ff_ddpg, ff_td3, ff_d4pg and ff_sac at their default configs' full
    width (64 Pendulum envs, T = 8, 32 warm-up steps, 4 epochs of 512 from
    a 200 000-item buffer, MLPs of 256 x 256), MAIN_UPDATES updates in 2
    windows through `run_experiment`, every kernel counter zeroed just
    before and read just after (no kernel is on these paths); then device
    launches an update, the buffer's device bytes and an update on the card
    against the CPU. Returns each system's kernel launches."""
    launches = {}
    for name, root in AC_ROOTS.items():
        record = _path_run(name, root, [f"arch.num_updates={MAIN_UPDATES}",
                                        "arch.num_evaluation=2", "arch.num_eval_episodes=16",
                                        "logger.use_console=False"], {}, "ac_train", smi, True)
        setup, state, config = record.pop("_setup_state")
        record["update_on_card_vs_cpu"] = _ac_update_on_card_and_cpu(name, config, setup, state)
        emit(record)
        launches[name] = record["kernel_launches"]
    return launches


def phase_sac_learn() -> None:
    """ff_sac on Pendulum above the threshold fixed beforehand."""
    start = time.perf_counter()
    final_return = _a12_module("ff_sac").run_experiment(
        compose(SAC_PENDULUM, AC_ROOTS["ff_sac"]), device="cuda")
    if not final_return > SAC_THRESHOLD:
        raise AssertionError(f"ff_sac returned {final_return}, not above {SAC_THRESHOLD}")
    emit({"phase": "sac_learn", "system": "ff_sac", "env": "pendulum",
          "final_return": final_return, "threshold": SAC_THRESHOLD,
          "window_seconds": runner.LAST_RUN_STATS["window_seconds"],
          "seconds": time.perf_counter() - start})


def phase_pg_learn(name: str, root: str, overrides: list, phase: str,
                   threshold: float = PG_THRESHOLD) -> None:
    """`name` on IdentityGame above `threshold`."""
    start = time.perf_counter()
    final_return = _a12_module(name).run_experiment(compose(overrides, root), device="cuda")
    if not final_return > threshold:
        raise AssertionError(f"{name} returned {final_return}, not above {threshold}")
    emit({"phase": phase, "system": name, "env": "identity_game", "final_return": final_return,
          "threshold": threshold, "window_seconds": runner.LAST_RUN_STATS["window_seconds"],
          "seconds": time.perf_counter() - start})


def phase_pg_train(smi: str, family: str) -> dict:
    """ff_reinforce (1024 CartPole envs, T = 32; one B1 GAE launch an
    update at lambda 1.0) or ff_awr (64 CartPole envs, T = 8, a 100 000-step
    trajectory buffer, 4 epochs of 256 sequences of 8; one B1 generic launch
    an epoch) at its default config's full width, MAIN_UPDATES updates in 2
    windows with `system.multistep_impl=pallas`; then its continuous variant
    (Pendulum) one window. Every kernel counter zeroed just before each run
    and read just after. Returns the main run's launches."""
    lr = linear_recurrence
    if family == "vpg":
        runs = (("ff_reinforce", VPG_ROOT), ("ff_reinforce_continuous",
                                             "default/anakin/default_ff_reinforce_continuous.yaml"))
        want = {lr.GAE_KERNEL.name: 1}
    else:
        runs = (("ff_awr", AWR_ROOT), ("ff_awr_continuous",
                                       "default/anakin/default_ff_awr_continuous.yaml"))
        want = {lr.KERNEL.name: 4}  # system.epochs
    common = ["arch.num_eval_episodes=16", "system.multistep_impl=pallas",
              "logger.use_console=False"]
    main_launches = None
    for index, (name, root) in enumerate(runs):
        windows = ([f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2"] if index == 0
                   else ["arch.num_updates=2", "arch.num_evaluation=1"])
        record = _path_run(name, root, windows + common, want, f"{family}_train", smi,
                           index == 0)
        record.pop("_setup_state", None)
        record["b1_launches_per_update"] = {k: v / record["updates"]
                                            for k, v in record["kernel_launches"].items()
                                            if k in (lr.KERNEL.name, lr.GAE_KERNEL.name)}
        emit(record)
        if main_launches is None:
            main_launches = record["kernel_launches"]
    return main_launches


# ---------------------------------------------------- A12: MPO and V-MPO


def _mpo_b1_want(name: str) -> dict:
    """B1's launches an update on `name`'s default config: one generic
    launch an epoch (Retrace) on MPO, one GAE launch an epoch on V-MPO."""
    lr = linear_recurrence
    return {"ff_mpo": {lr.KERNEL.name: 4}, "ff_mpo_continuous": {lr.KERNEL.name: 32},
            "ff_vmpo": {lr.GAE_KERNEL.name: 16},
            "ff_vmpo_continuous": {lr.GAE_KERNEL.name: 16}}[name]


def _update_peak_bytes(setup, state) -> dict:
    """The device's peak allocated bytes during one update step, and the
    part above what was allocated before it (the state, buffer included)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    setup.learn.update_step(state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_bytes": peak, "above_state_bytes": peak - before}


def _mpo_update_on_card_and_cpu(name: str, config, setup, state) -> dict:
    """One MPO epoch on sequences sampled on the card (its normals drawn on
    the card), or one V-MPO epoch on a rollout made on the card, run by the
    card's learner and by the same learner built on the CPU, from the same
    params: losses 1e-5 relative, params and duals 1e-5 absolute, and B1's
    launches on the card (one generic, or one GAE); V-MPO's top halves
    compared index for index."""
    from stoix_tpu_torch.systems.mpo.ff_vmpo import top_half

    lr = linear_recurrence
    cpu_setup = _a12_module(name).learner_setup(envs.make(config)[0], config,
                                                torch.device("cpu"), int(config.arch.seed))
    move = partial(tree_map, lambda x: x.cpu())
    params, opts = [state.params], [state.opt_states]
    record = {}
    if name.startswith("ff_vmpo"):
        state, traj = setup.learn.rollout(state)
        card_adv = setup.learn.advantages(params, traj)[0]
        cpu_adv = cpu_setup.learn.advantages(move(params), move(traj))[0]
        # The card's critic values round apart from the CPU's by ulps, so
        # near-equal advantages may trade places: count both the positions
        # and the members that differ.
        top = [top_half(a.reshape(-1)) for a in (card_adv.cpu(), cpu_adv)]
        members = set(top[0].tolist()) ^ set(top[1].tolist())
        record["top_half"] = {"k": int(top[0].numel()),
                              "positions_differing": int((top[0] != top[1]).sum()),
                              "members_differing": len(members) // 2}
        before = _counts(lr.COUNTERS)
        card = setup.learn.epoch(params, opts, traj)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _counts(lr.COUNTERS).items()}
        cpu = cpu_setup.learn.epoch(move(params), move(opts), move(traj))
    else:
        update = setup.learn.update_from_batch
        batch = setup.learn.buffer.sample(state.buffer_state, state.generator).experience
        noise = update.draw_noise(batch, state.generator)
        before = _counts(lr.COUNTERS)
        card = update.step(params, opts, [batch], [noise])
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _counts(lr.COUNTERS).items()}
        cpu = cpu_setup.learn.update_from_batch.step(move(params), move(opts), [move(batch)],
                                                     [move(noise)])
        record["sample_batch"] = list(batch["reward"].shape)
    want = {lr.KERNEL.name: int(not name.startswith("ff_vmpo")),
            lr.GAE_KERNEL.name: int(name.startswith("ff_vmpo"))}
    if launched != want:
        raise AssertionError(f"{name}'s epoch on the card launched {launched}, not {want}")
    (card_params, _, card_info), (cpu_params, _, cpu_info) = card, cpu
    loss_err = max(_relative(card_info[k], cpu_info[k]) for k in cpu_info if k.endswith("loss"))
    param_err = _max_err(card_params, cpu_params)
    if not (loss_err <= 1e-5 and param_err <= 1e-5):
        raise AssertionError(f"{name}'s epoch on the card is not the CPU's: loss {loss_err}, "
                             f"params {param_err}")
    return {**record, "b1_launches": launched, "loss_relative_err": loss_err,
            "params_abs_err": param_err}


def phase_mpo_train(smi: str, family: str) -> dict:
    """ff_mpo (64 CartPole envs, T = 8, a 100 000-step trajectory buffer, 4
    epochs of 128 sequences of 8) and ff_mpo_continuous (64 Pendulum envs,
    32 epochs of 256 sequences of 16, 128 action samples, MLPs 4 x 256), or
    ff_vmpo (1024 CartPole envs, T = 32, 16 full-batch epochs) and
    ff_vmpo_continuous (1024 Pendulum envs), at their default configs,
    MAIN_UPDATES updates in 2 windows through `run_experiment` with
    `system.multistep_impl=pallas`, every kernel counter zeroed just before
    and read just after (B1's generic entry once an MPO epoch, its GAE entry
    once a V-MPO epoch, nothing else); then device launches an update, the
    buffer's device bytes, an update's peak device bytes and one epoch on
    the card against the CPU. Returns each system's launches."""
    lr = linear_recurrence
    names = (("ff_mpo", "ff_mpo_continuous") if family == "mpo" else
             ("ff_vmpo", "ff_vmpo_continuous"))
    common = [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
              "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
              "logger.use_console=False"]
    launches = {}
    for name in names:
        record = _path_run(name, MPO_ROOTS[name], common, _mpo_b1_want(name),
                           f"{family}_train", smi, True)
        setup, state, config = record.pop("_setup_state")
        record["b1_launches_per_update"] = {k: v / record["updates"]
                                            for k, v in record["kernel_launches"].items()
                                            if k in (lr.KERNEL.name, lr.GAE_KERNEL.name)}
        record["update_device_bytes"] = _update_peak_bytes(setup, state)
        record["epoch_on_card_vs_cpu"] = _mpo_update_on_card_and_cpu(name, config, setup, state)
        emit(record)
        launches[name] = record["kernel_launches"]
    return launches


# ---------------------------------------------------- A13: batched MCTS and search

SEARCH_ROOTS = {name: f"default/anakin/default_{name}.yaml"
                for name in ("ff_az", "ff_mz", "ff_sampled_az", "ff_sampled_mz")}
# ff_az's and ff_mz's IdentityGame oracles at the sweep's 8 simulations (64
# envs, 16 384 steps; 16 envs, 16 384 steps, a 4 096-step buffer, batches of
# 64 sequences of 3, lr 1e-2, 16 epochs): the JAX package returns 10.0 there
# for seeds 42 and 1 (scripts/jax_oracle_thresholds.py --oracles az mz),
# uniform random actions 2.5; the threshold is 8.0.
AZ_IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=16384",
               "system.num_simulations=8", "arch.num_evaluation=1",
               "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
               "arch.absolute_metric=False", "system.multistep_impl=pallas",
               "logger.use_console=False"]
MZ_IDENTITY = ["env=identity_game", "arch.total_num_envs=16", "arch.total_timesteps=16384",
               "system.total_buffer_size=4096", "system.total_batch_size=64",
               "system.sample_sequence_length=3", "system.lr=1e-2", "system.epochs=16",
               "system.num_simulations=8", "arch.num_evaluation=1",
               "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
               "arch.absolute_metric=False", "system.multistep_impl=pallas",
               "logger.use_console=False"]
SEARCH_THRESHOLD = 8.0
# The search paths: (label, system, overrides, B1 GAE launches an update).
SEARCH_RUNS = (("ff_az", "ff_az", [], 1),
               ("ff_az_gumbel", "ff_az", ["system.search_method=gumbel"], 1),
               ("ff_az_replay", "ff_az", ["system.use_replay_buffer=true"], 4),
               ("ff_mz", "ff_mz", [], 0),
               ("ff_sampled_az", "ff_sampled_az", [], 64),
               ("ff_sampled_mz", "ff_sampled_mz", [], 0))
# One a window; one, not 2, to keep the whole script inside its time with
# the Sebulba phases.
SEARCH_UPDATES = 1
# A sampled path's update takes 15-18 s of host dispatch: one, in one window.
SAMPLED_SEARCH_WINDOWS = ["arch.num_updates=1", "arch.num_evaluation=1"]
MCTS_BATCH, MCTS_ACTIONS, MCTS_SIMULATIONS, MCTS_STATES = 64, 4, 50, 16


def _tabular(device, seed: int = 0):
    """A random tabular MDP (numpy `seed`) and B roots on `device`: (root,
    recurrent_fn)."""
    import numpy as np

    from stoix_tpu_torch.search import mcts

    rng = np.random.default_rng(seed)
    b, a, n = MCTS_BATCH, MCTS_ACTIONS, MCTS_STATES
    table = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in dict(
        T=rng.integers(0, n, (n, a)), R=rng.normal(size=(n, a)).astype(np.float32),
        D=((rng.random((n, a)) > 0.2) * 0.99).astype(np.float32),
        L=rng.normal(size=(n, a)).astype(np.float32),
        V=rng.normal(size=n).astype(np.float32)).items()}
    root = mcts.RootFnOutput(
        torch.from_numpy(rng.normal(size=(b, a)).astype(np.float32)).to(device),
        torch.from_numpy(rng.normal(size=b).astype(np.float32)).to(device),
        torch.from_numpy(rng.integers(0, n, b)).to(device))

    def recurrent_fn(params, noise, action, state):
        nxt = table["T"][state, action]
        return mcts.RecurrentFnOutput(table["R"][state, action], table["D"][state, action],
                                      table["L"][nxt], table["V"][nxt]), nxt

    return root, recurrent_fn


def _tabular_search(device, policy: str, max_depth: int):
    """(the searched tree, the policy's output) on `device`, the noise drawn
    on the CPU from seed 1."""
    from stoix_tpu_torch.search import mcts

    root, recurrent_fn = _tabular(device)
    noise = mcts.draw_noise(torch.Generator().manual_seed(1), MCTS_BATCH, MCTS_ACTIONS, 0.25)
    noise = mcts.SearchNoise(*(x if x is None else x.to(device) for x in noise))
    if policy == "muzero":
        out = mcts.muzero_policy(None, noise, root, recurrent_fn, MCTS_SIMULATIONS,
                                 max_depth=max_depth)
        searched = mcts._root_with_noise(root, noise.dirichlet, 0.25)
    else:
        out = mcts.gumbel_muzero_policy(None, noise, root, recurrent_fn, MCTS_SIMULATIONS,
                                        max_depth=max_depth)
        perturbed = noise.gumbel + root.prior_logits
        threshold = perturbed.sort(-1).values[..., -MCTS_ACTIONS][..., None]
        searched = root._replace(prior_logits=torch.where(perturbed >= threshold,
                                                          root.prior_logits, -math.inf))
    tree = mcts.search(None, searched, recurrent_fn, MCTS_SIMULATIONS, max_depth, 1.25, 19652.0)
    return tree, out, (root, recurrent_fn, noise)


def phase_mcts(smi: str) -> None:
    """The batched MCTS on the card against the same calls on the CPU: a
    random tabular MDP from a numpy seed, B = 64, A = 4, 50 simulations,
    max_depth 50 and 4, muzero_policy and gumbel_muzero_policy; the tree's
    integer arrays and the actions equal, its float arrays and the weights
    and values within 1e-6 (recorded: whether bitwise); then device launches
    a search (torch.profiler) and its time."""
    from stoix_tpu_torch.search import mcts

    for max_depth in (MCTS_SIMULATIONS, 4):
        for policy in ("muzero", "gumbel"):
            cpu_tree, cpu_out, _ = _tabular_search(torch.device("cpu"), policy, max_depth)
            card_tree, card_out, (root, recurrent_fn, noise) = _tabular_search(
                torch.device("cuda"), policy, max_depth)
            torch.cuda.synchronize()
            for name in ("visits", "parent", "action_from_parent", "children", "embeddings"):
                if not torch.equal(getattr(card_tree, name).cpu(), getattr(cpu_tree, name)):
                    raise AssertionError(f"mcts {policy} depth {max_depth}: {name} differs")
            if not torch.equal(card_out.action.cpu(), cpu_out.action):
                raise AssertionError(f"mcts {policy} depth {max_depth}: actions differ")
            floats = {name: (getattr(card_tree, name).cpu(), getattr(cpu_tree, name))
                      for name in ("values", "priors", "rewards", "discounts")}
            floats.update({name: (getattr(card_out, name).cpu(), getattr(cpu_out, name))
                           for name in ("action_weights", "search_value")})
            errors = {name: float((g - w).abs().max()) for name, (g, w) in floats.items()}
            if max(errors.values()) > 1e-6:
                raise AssertionError(f"mcts {policy} depth {max_depth}: {errors}")
            fn = partial(mcts.muzero_policy if policy == "muzero" else mcts.gumbel_muzero_policy,
                         None, noise, root, recurrent_fn, MCTS_SIMULATIONS, max_depth=max_depth)
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            launches = sum(1 for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
            emit({"phase": "mcts", "policy": policy, "batch": MCTS_BATCH,
                  "actions": MCTS_ACTIONS, "simulations": MCTS_SIMULATIONS,
                  "max_depth": max_depth, "integer_arrays_equal": True,
                  "float_max_abs_err": errors,
                  "bitwise": all(torch.equal(g, w) for g, w in floats.values()),
                  "orphans": int(((cpu_tree.visits == 0) & (cpu_tree.parent >= 0)).sum()),
                  "device_launches_per_search": launches, "seconds_per_search": seconds,
                  "card": smi})


def _search_update_parts(setup, state) -> tuple:
    """One searched env step, then the rest of an update on T copies of its
    output (the buffer's add and the epochs, or the on-policy update), each
    counted by torch.profiler (device launches) and their peak device bytes
    read: (record, the state with the steps added, the [T, E] trajectory)."""
    learner = setup.learn

    def count(fn):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA), out

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step, (state, data) = count(lambda: learner.env_step(state))
    traj = tree_stack([data] * learner.rollout_length)
    if hasattr(state, "buffer_state"):
        def rest():
            buffers = learner.add(anakin.per_replica(state.buffer_state, learner.update_batch),
                                  traj)
            added = state._replace(buffer_state=anakin.join_per_replica(buffers))
            return added, learner.update(added)
        update, (state, _) = count(rest)
    else:
        update, _ = count(lambda: learner.update(state.params, state.opt_states, traj,
                                                 state.generator))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    record = {"device_launches": {"env_step": step, "update": update,
                                  "per_update": learner.rollout_length * step + update},
              "update_device_bytes": {"peak_bytes": peak, "above_state_bytes": peak - before}}
    return record, state, traj


def _search_update_on_card_and_cpu(name: str, config, setup, state, traj) -> dict:
    """ff_az's on-policy update (fixed permutations) on `traj`, or one
    replay epoch (the search systems' and SPO's) on sequences sampled on the
    card, run by the card's learner and by the same learner built on the
    CPU, from the same params: losses 1e-5 relative, params (SPO's targets
    and duals too) 1e-5 absolute, and B1's launches on the card (one GAE
    launch on the AZ family and SPO, none on the MuZero family)."""
    lr = linear_recurrence
    cpu_setup = _a12_module(name).learner_setup(envs.make(config)[0], config,
                                                torch.device("cpu"), int(config.arch.seed))
    move = partial(tree_map, lambda x: x.cpu())
    if not hasattr(state, "buffer_state"):
        perms = [torch.randperm(traj.reward.numel(), generator=torch.Generator().manual_seed(e))
                 for e in range(int(config.system.epochs))]
        before = _counts(lr.COUNTERS)
        card = setup.learn.update(state.params, state.opt_states, traj,
                                  permutations=[p.cuda() for p in perms])
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _counts(lr.COUNTERS).items()}
        cpu = cpu_setup.learn.update(move(state.params), move(state.opt_states), move(traj),
                                     permutations=perms)
        card, cpu = (card[0], card[2]), (cpu[0], cpu[2])
        shape = list(traj.reward.shape)
    else:
        batch = setup.learn.buffer.sample(state.buffer_state, state.generator).experience
        before = _counts(lr.COUNTERS)
        out = setup.learn.update_from_batch([state.params], [state.opt_states], [batch])
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _counts(lr.COUNTERS).items()}
        ref = cpu_setup.learn.update_from_batch([move(state.params)], [move(state.opt_states)],
                                                [move(batch)])
        card, cpu = (out[0][0], out[2]), (ref[0][0], ref[2])
        shape = list(batch["reward"].shape)
    gae = name.endswith("az") or name.startswith("ff_spo")
    want = {lr.KERNEL.name: 0, lr.GAE_KERNEL.name: int(gae)}
    if launched != want:
        raise AssertionError(f"{name}'s update on the card launched {launched}, not {want}")
    loss_err = max(_relative(card[1][k], cpu[1][k]) for k in cpu[1] if k.endswith("loss"))
    param_err = _max_err(card[0], cpu[0])
    if not (loss_err <= 1e-5 and param_err <= 1e-5):
        raise AssertionError(f"{name}'s update on the card is not the CPU's: loss {loss_err}, "
                             f"params {param_err}")
    return {"batch_shape": shape, "b1_launches": launched, "loss_relative_err": loss_err,
            "params_abs_err": param_err}


def phase_search_train(smi: str) -> dict:
    """ff_az (64 CartPole envs, T = 8, 16 simulations, MLPs 256 x 256; also
    with `search_method=gumbel` and with `use_replay_buffer=true`), ff_mz (25
    simulations in a world model of 64 with an LSTM and 601 atoms), and
    ff_sampled_az and ff_sampled_mz (64 Pendulum envs, 50 simulations, K = 8)
    at their default configs, SEARCH_UPDATES updates, one a window (the
    sampled paths one in one window), through
    `run_experiment` with `system.multistep_impl=pallas`, every kernel counter
    zeroed just before and read just after: B1's GAE entry 1 / 1 / 4 / 0 /
    64 / 0 launches an update, nothing else; env-steps/s a window, device
    launches an update (a searched step's and the rest's, torch.profiler),
    B1's launches an update, the buffer's device bytes, the peak device
    bytes of a step and the rest of an update, and one update or epoch on
    the card against the CPU. Returns each path's kernel launches."""
    lr = linear_recurrence
    common = ["arch.num_eval_episodes=16", "system.multistep_impl=pallas",
              "logger.use_console=False"]
    launches = {}
    for label, name, extra, gae_launches in SEARCH_RUNS:
        windows = (SAMPLED_SEARCH_WINDOWS if name.startswith("ff_sampled") else
                   [f"arch.num_updates={SEARCH_UPDATES}",
                    f"arch.num_evaluation={SEARCH_UPDATES}"])
        overrides = windows + common + extra
        want = {lr.GAE_KERNEL.name: gae_launches} if gae_launches else {}
        record = _path_run(name, SEARCH_ROOTS[name], overrides, want, "search_train", smi,
                           False)
        record["path"] = label
        config = check_total_timesteps(compose(overrides, SEARCH_ROOTS[name]), 1)
        setup = _a12_module(name).learner_setup(envs.make(config)[0], config,
                                                   torch.device("cuda"), int(config.arch.seed))
        parts, state, traj = _search_update_parts(setup, setup.learner_state)
        record.update(parts)
        record["b1_launches_per_update"] = {k: v / record["updates"]
                                            for k, v in record["kernel_launches"].items()
                                            if k in (lr.KERNEL.name, lr.GAE_KERNEL.name)}
        if hasattr(state, "buffer_state"):
            record["buffer_device_bytes"] = _tree_bytes(state.buffer_state)
        record["update_on_card_vs_cpu"] = _search_update_on_card_and_cpu(name, config, setup,
                                                                         state, traj)
        emit(record)
        launches[label] = record["kernel_launches"]
    return launches


def search_gae_shapes() -> list:
    """B1's GAE entry at the search paths' shapes: ff_az's [8, 64] (a
    rollout) and the replay paths' [7, 32] from a batch-major [32, 8] view
    (the dispatch's contiguous copies included in its call), each a launch
    replayed from a CUDA graph and a call from Python, beside the empty
    kernel on the same grid, the plain version and the bound."""
    lr = linear_recurrence
    shapes = []
    for t_len, batch, view in ((8, 64, False), (7, 32, True)):
        args = gae_inputs(t_len, batch, seed=t_len * batch)
        run = partial(lr.truncated_gae, *args, 0.95)
        moved, flops = 7 * t_len * batch * 4, 9 * t_len * batch
        bound_ms, bound_by = bound(moved, flops)
        record = {"shape": [t_len, batch], "lambda": 0.95, "ms": cuda_ms(run),
                  "device_ms": graph_ms(run),
                  "empty_kernel_device_ms": graph_ms(launch_floor(t_len, batch)),
                  "plain_ms": cuda_ms(partial(lr.plain_truncated_gae, *args, 0.95), repeats=5,
                                      inner=3),
                  "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved}
        if view:
            # Sampled [B, T + 1] sequences, their first T steps as the replay
            # learners slice them (a strided view the dispatch copies once).
            r, discount, v_tm1, v_t, trunc = (
                torch.cat([x.T, x.T[:, -1:]], 1)[:, :-1] for x in args)
            call = partial(truncated_generalized_advantage_estimation, r, discount, 0.95,
                           v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, batch_major=True,
                           impl="pallas")
            got = call()
            want = lr.plain_truncated_gae(*args, 0.95)
            if not all(torch.equal(g.T, w) for g, w in zip(got, want)):
                raise AssertionError("GAE from the batch-major view != the plain version")
            record.update(batch_major_view=[batch, t_len + 1], view_call_ms=cuda_ms(call),
                          view_bitwise=True)
        emit({"phase": "gae_time", "path": "search", **record})
        shapes.append(record)
    return shapes


# ---------------------------------------------------- A13: SPO and Disco-RL

SPO_ROOTS = {name: f"default/anakin/default_{name}.yaml"
             for name in ("ff_spo", "ff_spo_continuous")}
DISCO_ROOT = "default/anakin/default_ff_disco103.yaml"
# ff_spo's and ff_disco103's IdentityGame oracles (64 envs; 16 384 steps at 16
# epochs; 131 072 steps at a policy temperature of 16 over [-20, 20] with 2
# minibatches): the JAX package returns 10.0 there for seeds 42 and 1
# (scripts/jax_oracle_thresholds.py --oracles spo disco), uniform random
# actions 2.5; the threshold is 8.0. At the default temperature of 0.25 the
# JAX ff_disco103 returns 2.69 and 2.5 at this budget (ROADMAP C23).
SPO_IDENTITY = ["env=identity_game", "arch.total_timesteps=16384", "system.epochs=16",
                "arch.num_evaluation=1", "arch.num_eval_episodes=32",
                "arch.evaluation_greedy=True", "arch.absolute_metric=False",
                "system.multistep_impl=pallas", "logger.use_console=False"]
DISCO_IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=131072",
                  "system.vmax=20.0", "system.num_minibatches=2",
                  "system.policy_temperature=16.0", "arch.num_evaluation=1",
                  "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
                  "arch.absolute_metric=False", "logger.use_console=False"]
A13_THRESHOLD = 8.0
# The Pendulum budgets of the continuous SPO, MPO and V-MPO systems: name ->
# (system, root, overrides), each run by scripts/jax_oracle_thresholds.py
# on the CPU (seeds 42 and 1). Where the JAX package learns there, the
# threshold is the midpoint of uniform random actions' -1221.52 and its
# seed-42 return, and the oracle runs on the card (PENDULUM_THRESHOLDS);
# elsewhere the budget and its JAX returns stand in PERF.md section 7.
PENDULUM_EVAL = ["arch.num_evaluation=4", "arch.num_eval_episodes=32",
                 "arch.evaluation_greedy=True", "arch.absolute_metric=False",
                 "system.multistep_impl=pallas", "logger.use_console=False"]
PENDULUM_ORACLES = {
    "spo_continuous": ("ff_spo_continuous", "default/anakin/default_ff_spo_continuous.yaml",
                       ["arch.total_timesteps=393216", "system.epochs=16", *PENDULUM_EVAL]),
    "vmpo_continuous": ("ff_vmpo_continuous", "default/anakin/default_ff_vmpo_continuous.yaml",
                        ["arch.total_num_envs=64", "arch.total_timesteps=1048576",
                         *PENDULUM_EVAL]),
    "mpo_continuous": ("ff_mpo_continuous", "default/anakin/default_ff_mpo_continuous.yaml",
                       ["arch.total_timesteps=8192", *PENDULUM_EVAL]),
}
# The JAX package returns -243.01 (seed 1: -201.04) on ff_spo_continuous
# and -284.57 (seed 1: -160.77) on ff_vmpo_continuous under their budgets.
PENDULUM_THRESHOLDS = {"spo_continuous": -732.2672271728516,
                       "vmpo_continuous": -753.0486450195312}
SPO_UPDATES = 2  # one a window
SPO_GAE = 64  # B1 GAE launches an SPO update: one an epoch (system.epochs)
SPO_GAE_SHAPE = (32, 32)  # [L, B]: sequences of 32, 32 a batch (the default config)


def _spo_search_on_card_and_cpu(name: str, setup, state, cpu_setup) -> dict:
    """One searched step of every env from draws made on the CPU (seed 7),
    on the card and on the CPU from the same params, env states and
    observations: the particles' root actions (Pendulum's floats 1e-6), every
    resampling decision and the chosen particle exact, the weights and the
    advantage sums 1e-5 relative."""
    from stoix_tpu_torch.systems.search import ff_az
    from stoix_tpu_torch.systems.spo import ff_spo

    move = partial(tree_map, lambda x: x.cpu())
    search, cpu_search = setup.learn.acting.search, cpu_setup.learn.acting.search
    observation = state.timestep.observation
    noise = search.draw_noise(torch.Generator().manual_seed(7), observation.agent_view.shape[0])
    outs = []
    for run, device, params, obs in ((search, "cuda", state.params, observation),
                                     (cpu_search, "cpu", move(state.params), move(observation))):
        sim_state = ff_az.simulator_state(state.env_state, 0, 1, None)
        sim_state = move(sim_state) if device == "cpu" else sim_state
        drawn = ff_spo.SPONoise(*(x.to(device) for x in noise))
        out = run(params, drawn, sim_state, obs)
        outs.append((out, ff_spo.choose(out.particle_actions, out.weights, drawn.choice)[1]))
    (card, card_choice), (cpu, cpu_choice) = outs
    torch.cuda.synchronize()
    actions_err = float((card.particle_actions.cpu().float() - cpu.particle_actions.float())
                        .abs().max())
    record = {
        "resampled_equal": bool(torch.equal(card.resampled.cpu(), cpu.resampled)),
        "resampled_share": float(cpu.resampled.float().mean()),
        "choice_equal": bool(torch.equal(card_choice.cpu(), cpu_choice)),
        "actions_abs_err": actions_err,
        "actions_bitwise": bool(torch.equal(card.particle_actions.cpu(), cpu.particle_actions)),
        "weights_abs_err": float((card.weights.cpu() - cpu.weights).abs().max()),
        "advantages_relative_err": _relative(card.raw_advantages, cpu.raw_advantages),
    }
    actions_ok = actions_err <= (1e-6 if search.continuous else 0.0)
    if not (record["resampled_equal"] and record["choice_equal"] and actions_ok
            and record["weights_abs_err"] <= 1e-6 and record["advantages_relative_err"] <= 1e-5):
        raise AssertionError(f"{name}'s search on the card is not the CPU's: {record}")
    return record


def phase_spo_train(smi: str) -> dict:
    """ff_spo (64 CartPole envs, T = 32, 16 particles over a horizon of 4,
    MLPs 256 x 256, 64 epochs of 32 sequences of 32) and ff_spo_continuous
    (64 Pendulum envs) at their default configs, SPO_UPDATES updates in 2
    windows through `run_experiment` with `system.multistep_impl=pallas`,
    every kernel counter zeroed just before and read just after: exactly 64
    launches of B1's GAE entry an update (one an epoch), 0 of every other
    kernel; env-steps/s a window, device launches a searched step and an
    update (torch.profiler), the buffer's device bytes, an update's peak
    device bytes, one epoch and one searched step on the card against the
    CPU. Returns each system's launches."""
    lr = linear_recurrence
    common = [f"arch.num_updates={SPO_UPDATES}", "arch.num_evaluation=2",
              "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
              "logger.use_console=False"]
    launches = {}
    for name, root in SPO_ROOTS.items():
        record = _path_run(name, root, common, {lr.GAE_KERNEL.name: SPO_GAE}, "spo_train", smi,
                           False)
        config = check_total_timesteps(compose(common, root), 1)
        module = _a12_module(name)
        setup = module.learner_setup(envs.make(config)[0], config, torch.device("cuda"),
                                     int(config.arch.seed))
        parts, state, _ = _search_update_parts(setup, setup.learner_state)
        record.update(parts)
        record["b1_launches_per_update"] = {k: v / record["updates"]
                                            for k, v in record["kernel_launches"].items()
                                            if k in (lr.KERNEL.name, lr.GAE_KERNEL.name)}
        record["buffer_device_bytes"] = _tree_bytes(state.buffer_state)
        record["epoch_on_card_vs_cpu"] = _search_update_on_card_and_cpu(name, config, setup,
                                                                        state, None)
        cpu_setup = module.learner_setup(envs.make(config)[0], config, torch.device("cpu"),
                                         int(config.arch.seed))
        record["search_on_card_vs_cpu"] = _spo_search_on_card_and_cpu(name, setup, state,
                                                                      cpu_setup)
        emit(record)
        launches[name] = record["kernel_launches"]
    return launches


def _disco_minibatch_on_card_and_cpu(config, setup, state) -> dict:
    """One ff_disco103 minibatch step (the first E / M envs of a rollout
    made on the card), by the card's learner and by the same learner built
    on the CPU, from the same params and meta-state: the rule's losses 1e-5
    relative, params and the meta-state's EMA params 1e-5 absolute, its
    update count exact, no B1 launch."""
    from stoix_tpu_torch.systems.disco import ff_disco103

    lr = linear_recurrence
    move = partial(tree_map, lambda x: x.cpu())
    cpu_setup = ff_disco103.learner_setup(envs.make(config)[0], config, torch.device("cpu"),
                                          int(config.arch.seed))
    _, traj = setup.learn.rollout(state)
    size = traj.reward.shape[1] // int(config.system.num_minibatches)
    batch = tree_map(lambda x: x[:, :size], traj._replace(info=None))
    args = ([state.params], [state.opt_states], [state.meta_state], [batch])
    before = _counts(lr.COUNTERS)
    card = setup.learn.update_minibatch(*args)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _counts(lr.COUNTERS).items()}
    cpu = cpu_setup.learn.update_minibatch(*move(args))
    if any(launched.values()):
        raise AssertionError(f"ff_disco103's minibatch step launched {launched}")
    loss_err = max(_relative(card[3][k], cpu[3][k]) for k in cpu[3])
    param_err = _max_err(card[0][0], cpu[0][0])
    meta_err = _max_err(card[2][0].target_params, cpu[2][0].target_params)
    if not (loss_err <= 1e-5 and param_err <= 1e-5 and meta_err <= 1e-5
            and int(card[2][0].num_updates) == int(cpu[2][0].num_updates)):
        raise AssertionError(f"ff_disco103's minibatch step on the card is not the CPU's: loss "
                             f"{loss_err}, params {param_err}, meta-state {meta_err}")
    return {"minibatch": list(batch.reward.shape), "loss_relative_err": loss_err,
            "params_abs_err": param_err, "meta_state_abs_err": meta_err}


def phase_disco_train(smi: str) -> dict:
    """ff_disco103 at its default config's full width (1024 CartPole envs,
    T = 16, 2 epochs x 4 env-minibatches, MLP 256 x 256, LSTM 128, 51 bins)
    in `grounded` mode, MAIN_UPDATES updates in 2 windows through
    `run_experiment`, every kernel counter zeroed just before and read just
    after (no kernel is on this path: each count must stay 0); env-steps/s,
    device launches an update (torch.profiler), an update's peak device
    bytes and one minibatch step on the card against the CPU. Then one
    update in `meta` mode from an npz this phase writes with the port's
    `flatten_meta_params` (loaded as pretrained), and its minibatch step on
    the card against the CPU. Returns each mode's launches."""
    import numpy as np

    from stoix_tpu_torch.systems.disco import ff_disco103, update_rule

    common = ["arch.num_eval_episodes=16", "logger.use_console=False"]
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_disco_") as tmp:
        path = os.path.join(tmp, "meta.npz")
        rule = ff_disco103.make_rule(compose([], DISCO_ROOT), 2, "cpu")
        np.savez(path, **update_rule.flatten_meta_params(
            rule.init_params(torch.Generator().manual_seed(5))))
        if not update_rule.load_meta_params(rule, torch.Generator(), path)[1]:
            raise AssertionError("the port's meta-params npz does not load back")
        for mode, windows in (("grounded", [f"arch.num_updates={MAIN_UPDATES}",
                                            "arch.num_evaluation=2"]),
                              ("meta", ["arch.num_updates=1", "arch.num_evaluation=1",
                                        "system.rule_mode=meta",
                                        f"system.meta_params_path={path}"])):
            record = _path_run("ff_disco103", DISCO_ROOT, windows + common, {}, "disco_train",
                               smi, mode == "grounded")
            record["rule_mode"] = mode
            config = check_total_timesteps(compose(windows + common, DISCO_ROOT), 1)
            if mode == "grounded":
                setup, state, _ = record.pop("_setup_state")
                record["update_device_bytes"] = _update_peak_bytes(setup, state)
            else:
                setup = ff_disco103.learner_setup(envs.make(config)[0], config,
                                                  torch.device("cuda"), int(config.arch.seed))
                state = setup.learner_state
            record["minibatch_on_card_vs_cpu"] = _disco_minibatch_on_card_and_cpu(config, setup,
                                                                                  state)
            emit(record)
            launches[f"ff_disco103_{mode}"] = record["kernel_launches"]
    return launches


def spo_gae_shape() -> dict:
    """B1's GAE entry at SPO's [32, 32] (sequences of 32, 32 a batch): a
    launch replayed from a CUDA graph, a call from Python, and a call through
    the dispatch from the batch-major [B, L] sequences (the copies it makes
    included), bitwise the plain version; beside the empty kernel on the same
    grid, the plain version and the bound."""
    lr = linear_recurrence
    t_len, batch = SPO_GAE_SHAPE
    args = gae_inputs(t_len, batch, seed=t_len * batch + 1)
    run = partial(lr.truncated_gae, *args, 0.95)
    moved, flops = 7 * t_len * batch * 4, 9 * t_len * batch
    bound_ms, bound_by = bound(moved, flops)
    sequences = [x.T.contiguous() for x in args]  # [B, L], as sampled
    call = partial(truncated_generalized_advantage_estimation, sequences[0], sequences[1], 0.95,
                   v_tm1=sequences[2], v_t=sequences[3], truncation_t=sequences[4],
                   batch_major=True, impl="pallas")
    got = call()
    want = lr.plain_truncated_gae(*args, 0.95)
    if not all(torch.equal(g.T, w) for g, w in zip(got, want)):
        raise AssertionError("GAE from SPO's batch-major sequences != the plain version")
    record = {"shape": [t_len, batch], "batch_major_view": [batch, t_len], "lambda": 0.95,
              "ms": cuda_ms(run), "device_ms": graph_ms(run),
              "empty_kernel_device_ms": graph_ms(launch_floor(t_len, batch)),
              "view_call_ms": cuda_ms(call), "view_bitwise": True,
              "plain_ms": cuda_ms(partial(lr.plain_truncated_gae, *args, 0.95), repeats=5,
                                  inner=3),
              "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved}
    emit({"phase": "gae_time", "path": "spo", **record})
    return record


# ---------------------------------------------------- vision (A14's first half)

PPO_ROOT = "default/anakin/default_ff_ppo.yaml"
PIXEL = ["env=breakout_pixel_jax", "network=cnn_atari"]
VISION_COMMON = ["arch.num_eval_episodes=16", "system.multistep_impl=pallas",
                 "logger.use_console=False"]
# minatar_train's runs, one window each at the default arch: label ->
# (system, root, overrides, B1 GAE launches an update).
MINATAR_RUNS = {
    **{f"{game}_cnn": ("ff_ppo", PPO_ROOT, [f"env={game}", "network=cnn"], 1)
       for game in ("breakout_jax", "asterix", "freeway", "space_invaders")},
    "breakout_jax_visual_resnet": ("ff_ppo", PPO_ROOT,
                                   ["env=breakout_jax", "network=visual_resnet"], 1),
    "cartpole_mlp_resnet": ("ff_ppo", PPO_ROOT, ["network=mlp_resnet"], 1),
    "breakout_jax_cnn_dqn": ("ff_dqn", "default/anakin/default_ff_dqn.yaml",
                             ["env=breakout_jax", "network=cnn_dqn"], 0),
    "breakout_jax_cnn_c51": ("ff_c51", "default/anakin/default_ff_c51.yaml",
                             ["env=breakout_jax", "network=cnn_c51"], 0),
}
VISION_ENV_STEPS = 50  # steps of each env on the card and on the CPU
VISION_PARITY_ENVS = 32  # the card-against-CPU update's env count
# Catch with ff_ppo + cnn (catch_learn): the budget, and the threshold fixed
# before any card run by scripts/jax_oracle_thresholds.py --oracles catch:
# the midpoint of uniform random actions' return and the JAX package's
# lower return of seeds 42 and 1 under CATCH.
CATCH = ["env=catch", "network=cnn", "arch.total_num_envs=64", "arch.total_timesteps=98304",
         "arch.num_evaluation=1", "arch.num_eval_episodes=256", "arch.evaluation_greedy=True",
         "arch.absolute_metric=False", "logger.use_console=False"]
CATCH_RANDOM_RETURN = -0.58349609375  # 4096 episodes, jax.random key 0
CATCH_JAX_RETURN = 1.0  # seeds 42 and 1 both
CATCH_THRESHOLD = (CATCH_RANDOM_RETURN + CATCH_JAX_RETURN) / 2

# ff_ppo on Snake (6x6, flattened, the MLP networks) for snake_learn: the
# budget, and the threshold fixed before any card run by
# scripts/jax_oracle_thresholds.py --oracles snake: the midpoint of uniform
# random legal actions' return and the JAX package's lower return of seeds
# 42 and 1 under SNAKE.
SNAKE = ["env=snake", "arch.total_num_envs=64", "arch.total_timesteps=262144",
         "arch.num_evaluation=1", "arch.num_eval_episodes=64", "arch.evaluation_greedy=True",
         "arch.absolute_metric=False", "system.multistep_impl=pallas", "logger.use_console=False"]
SNAKE_RANDOM_RETURN = 0.145263671875  # 4096 episodes, jax.random key 0
SNAKE_JAX_RETURN = 12.234375  # seed 42 (seed 1: 13.34375)
SNAKE_THRESHOLD = (SNAKE_RANDOM_RETURN + SNAKE_JAX_RETURN) / 2


def phase_vision_train(smi: str) -> dict:
    """ff_ppo on 84x84x4 pixel Breakout with the Nature CNN (cnn_atari) at
    the default config's full width (1024 envs, T = 16, 4 epochs x 4
    minibatches, [1024, 84, 84, 4] float32 observations), MAIN_UPDATES
    updates in 2 eval windows through `run_experiment`, every kernel counter
    zeroed just before and read just after: exactly one launch of B1's GAE
    entry an update, 0 of every other kernel; env-steps/s a window, device
    launches an env step and an update (torch.profiler), an update's peak
    device bytes, finite losses. Returns the run's launches."""
    lr = linear_recurrence
    overrides = PIXEL + [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
                         *VISION_COMMON]
    record = _path_run("ff_ppo", PPO_ROOT, overrides, {lr.GAE_KERNEL.name: 1}, "vision_train",
                       smi, True)
    setup, state, config = record.pop("_setup_state")
    record["b1_gae_launches_per_update"] = record["kernel_launches"][lr.GAE_KERNEL.name] / \
        record["updates"]
    record["update_device_bytes"] = _update_peak_bytes(setup, state)
    record["device_launches_per_env_step"] = _device_launches_of(
        lambda: setup.learn.env.step(state.env_state, torch.ones(
            (int(config.arch.total_num_envs),), dtype=torch.int64, device="cuda")))
    record["observation_bytes"] = {
        "state_frames": _tree_bytes(state.timestep.observation.agent_view),
        "rollout_obs": int(config.system.rollout_length)
        * _tree_bytes(state.timestep.observation.agent_view)}
    emit(record)
    return record["kernel_launches"]


def phase_minatar_train(smi: str) -> dict:
    """One eval window each, at the default arch, of MINATAR_RUNS: ff_ppo +
    cnn on the four MinAtar games, ff_ppo + visual_resnet on Breakout-minatar,
    ff_ppo + mlp_resnet on CartPole, ff_dqn + cnn_dqn and ff_c51 + cnn_c51 on
    Breakout-minatar; every kernel counter zeroed just before each run and
    read just after (one GAE launch an ff_ppo update, nothing else), finite.
    Returns each run's launches."""
    lr = linear_recurrence
    launches = {}
    for label, (system, root, overrides, gae) in MINATAR_RUNS.items():
        windows = ["arch.num_updates=2", "arch.num_evaluation=1", *VISION_COMMON]
        record = _path_run(system, root, overrides + windows, {lr.GAE_KERNEL.name: gae},
                           "minatar_train", smi, False)
        record["run"] = label
        record["network"] = next(o for o in overrides if o.startswith("network=")).split("=")[1]
        emit(record)
        launches[label] = record["kernel_launches"]
    return launches


def _envs_on_card_and_cpu() -> dict:
    """VISION_ENV_STEPS steps of pixel Breakout and of each MinAtar game on
    the card and on the CPU, from the same reset draws (the CPU's) and the
    same actions, with no auto-reset: every timestep equal."""
    import numpy as np

    from stoix_tpu_torch.envs import breakout_pixel, minatar

    games = {"Breakout-atari": (breakout_pixel.BreakoutPixel(), lambda s: s.serves - 1),
             "Breakout-minatar": (minatar.Breakout(), lambda s: s.ball_c == 0),
             "Asterix-minatar": (minatar.Asterix(), None),
             "Freeway-minatar": (minatar.Freeway(), None),
             "SpaceInvaders-minatar": (minatar.SpaceInvaders(), None)}
    out = {}
    for name, (env, draws_of) in games.items():
        num_envs = 64
        cpu_state, cpu_ts = env.reset(torch.Generator().manual_seed(3), num_envs)
        card_gen = torch.Generator(device="cuda").manual_seed(3)
        card_state, card_ts = (env.reset(card_gen, num_envs) if draws_of is None else
                               env.reset_from_draws(draws_of(cpu_state).cuda(), card_gen))
        rng = np.random.default_rng(3)
        ended = torch.zeros((num_envs,), dtype=torch.bool)
        for step in range(VISION_ENV_STEPS + 1):
            pairs = [(cpu_ts.step_type, card_ts.step_type), (cpu_ts.reward, card_ts.reward),
                     (cpu_ts.discount, card_ts.discount),
                     *zip(cpu_ts.observation, card_ts.observation),
                     (cpu_ts.extras["truncation"], card_ts.extras["truncation"])]
            if not all(torch.equal(a, b.cpu()) for a, b in pairs):
                raise AssertionError(f"{name} on the card differs from the CPU at step {step}")
            ended |= cpu_ts.last()
            if step == VISION_ENV_STEPS:
                break
            action = torch.from_numpy(rng.integers(0, env.num_actions, size=num_envs))
            cpu_state, cpu_ts = env.step(cpu_state, action)
            card_state, card_ts = env.step(card_state, action.cuda())
        # An env that ended goes on stepping past its end (as the evaluator's do).
        out[name] = {"envs": num_envs, "steps": VISION_ENV_STEPS,
                     "envs_ended": int(ended.sum()), "exact": True}
    return out


def _ppo_update_on_card_and_cpu(overrides: list) -> dict:
    """One ff_ppo update at VISION_PARITY_ENVS envs: a rollout on the card,
    then `PPOLearner.update` on it on the card and on the CPU from the same
    params with the same explicit permutations: every minibatch's losses
    within 1e-5 relative with a 1e-6 absolute floor, params 1e-5 absolute.
    The floor is for the clip loss: a mean of ratio x advantage terms of
    order 1 (standardised advantages) that nearly cancel, so its value sits
    near 1e-3 while its rounding follows its terms' scale."""
    config = check_total_timesteps(compose(overrides + [
        f"arch.total_num_envs={VISION_PARITY_ENVS}", *VISION_COMMON], PPO_ROOT), 1)
    seed = int(config.arch.seed)
    setups = {side: ff_ppo.learner_setup(envs.make(config)[0], config, torch.device(side), seed)
              for side in ("cuda", "cpu")}
    card = setups["cuda"]
    state, traj = card.learn.rollout(card.learner_state)
    samples = int(config.system.rollout_length) * VISION_PARITY_ENVS
    permutations = [torch.randperm(samples, generator=torch.Generator().manual_seed(e))
                    for e in range(int(config.system.epochs))]
    results = {}
    for side, setup in setups.items():
        move = (lambda x: x) if side == "cuda" else (lambda x: x.cpu())
        results[side] = setup.learn.update(
            tree_map(move, state.params), tree_map(move, state.opt_states), tree_map(move, traj),
            permutations=[p.to(side) for p in permutations])
    got, want = results["cuda"], results["cpu"]
    diffs = {k: ((got.loss_info[k].cpu() - want.loss_info[k]).abs(), want.loss_info[k].abs())
             for k in ("actor_loss", "value_loss", "entropy")}
    losses_within = all(bool((d <= 1e-5 * w + 1e-6).all()) for d, w in diffs.values())
    param_err = _max_err(got.params, want.params)
    record = {"envs": VISION_PARITY_ENVS, "rollout_length": int(config.system.rollout_length),
              "epochs": int(config.system.epochs),
              "num_minibatches": int(config.system.num_minibatches),
              "loss_relative_err": {k: float((d / w.clamp_min(1e-30)).max())
                                    for k, (d, w) in diffs.items()},
              "loss_abs_err": {k: float(d.max()) for k, (d, _) in diffs.items()},
              "params_abs_err": param_err}
    if not (losses_within and param_err <= 1e-5):
        raise AssertionError(f"the ff_ppo update ({overrides}) on the card is not the CPU's: "
                             f"{record}")
    return record


def phase_vision_parity(smi: str) -> None:
    """The vision path on the card against the CPU, TF32 off for matmuls and
    cuDNN (phase device): the envs exact; one ff_ppo update with
    visual_resnet (Breakout-minatar, 4 epochs x 4 minibatches) and one
    update of one minibatch (one Adam step) with cnn_atari (pixel Breakout),
    each within 1e-5."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on; the card-against-CPU bars assume float32 products")
    start = time.perf_counter()
    emit({"phase": "vision_parity", "envs": _envs_on_card_and_cpu(),
          # The Nature CNN's float32 sums (7744 terms into the dense layer,
          # up to 576 in the convs) round in another order in cuDNN than on
          # the CPU: its gradients part by up to 5.8e-5 of their scale (also
          # with cudnn.deterministic or cuDNN off), and Adam, whose steps
          # near a zero gradient scale a gradient's error by lr / eps = 25,
          # carries that to 2.9e-4 in the params over an update's 16 steps
          # (PERF.md, PR 17). So one Adam step here.
          "cnn_atari_update": _ppo_update_on_card_and_cpu(
              PIXEL + ["system.epochs=1", "system.num_minibatches=1"]),
          "visual_resnet_update": _ppo_update_on_card_and_cpu(
              ["env=breakout_jax", "network=visual_resnet"]),
          "seconds": time.perf_counter() - start, "card": smi})


def phase_catch_learn() -> None:
    """ff_ppo + cnn learns Catch above CATCH_THRESHOLD."""
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(compose(CATCH, PPO_ROOT), device="cuda")
    if not final_return > CATCH_THRESHOLD:
        raise AssertionError(f"ff_ppo + cnn returned {final_return} on Catch, not above "
                             f"{CATCH_THRESHOLD}")
    emit({"phase": "catch_learn", "system": "ff_ppo", "network": "cnn", "env": "catch",
          "final_return": final_return, "threshold": CATCH_THRESHOLD,
          "window_seconds": runner.LAST_RUN_STATS["window_seconds"],
          "seconds": time.perf_counter() - start})


# ------------------------------------------- grid games and locomotion

# The locomotion phases cut an episode to LOCO_MAX_STEPS control steps
# (env.kwargs.max_steps; the JAX package's limit is 1000) and take no
# absolute metric: a control step is 16 substeps, about 2 600 launches on the
# card, so one evaluation window of 1000-step episodes would take about a
# minute of host dispatch (at 50, an Ant evaluation window takes about 4 s;
# 25 makes room for the Sebulba phases). The widths, the truncation path and
# every network stay the default config's.
LOCO_MAX_STEPS = 25
LOCO_COMMON = [f"env.kwargs.max_steps={LOCO_MAX_STEPS}", "arch.absolute_metric=False",
               "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
               "logger.use_console=False"]
ANT = ["env=ant", "system.normalize_observations=true"]
LOCO_ENVS = ("hopper", "walker2d", "halfcheetah")
# grid_train's runs, one window each at the default arch: label -> (system,
# root, overrides, B1 GAE launches an update).
GRID_RUNS = {
    "snake_dqn": ("ff_dqn", "default/anakin/default_ff_dqn.yaml", ["env=snake"], 0),
    "snake_c51": ("ff_c51", "default/anakin/default_ff_c51.yaml", ["env=snake"], 0),
    "snake_cnn_dqn": ("ff_dqn", "default/anakin/default_ff_dqn.yaml",
                      ["env=snake", "network=cnn_dqn", "env.wrapper.flatten_observation=false"],
                      0),
    "snake_ppo": ("ff_ppo", PPO_ROOT, ["env=snake"], 1),
    "game2048_ppo": ("ff_ppo", PPO_ROOT, ["env=game_2048"], 1),
    "doorkey_ppo": ("ff_ppo", PPO_ROOT, ["env=doorkey"], 1),
}
GRID_ENV_STEPS = 50  # steps of each grid game on the card and on the CPU
LOCO_PARITY_STEPS = 12  # control steps of each robot, each from the CPU's state


def phase_loco_train(smi: str) -> dict:
    """ff_ppo_continuous on Ant at the default config's full width (1024
    envs, T = 16, 4 epochs x 4 minibatches, MLPs 256 x 256, 27-dim
    observations normalised, 8 actions), MAIN_UPDATES updates in 2 eval
    windows through `run_experiment`, every kernel counter zeroed just
    before and read just after: exactly one launch of B1's GAE entry an
    update, 0 of every other kernel; env-steps/s a window, device launches
    a control step and an update (torch.profiler), an update's peak device
    bytes, finite losses. Then ff_sac on Ant at its default config (64 envs,
    T = 8, 32 warm-up steps, 4 epochs of 512): no kernel launch, env-steps/s
    a window. Both with LOCO_COMMON. Returns each run's launches."""
    lr = linear_recurrence
    windows = [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2", *LOCO_COMMON]
    record = _path_run("ff_ppo_continuous", CONT_ROOT, ANT + windows, {lr.GAE_KERNEL.name: 1},
                       "loco_train", smi, True)
    setup, state, config = record.pop("_setup_state")
    record["b1_gae_launches_per_update"] = record["kernel_launches"][lr.GAE_KERNEL.name] / \
        record["updates"]
    record["update_device_bytes"] = _update_peak_bytes(setup, state)
    record["device_launches_per_env_step"] = _device_launches_of(
        lambda: setup.learn.env.step(state.env_state, torch.zeros(
            (int(config.arch.total_num_envs), 8), device="cuda")))
    record["episode_limit"] = LOCO_MAX_STEPS
    emit(record)
    sac = _path_run("ff_sac", AC_ROOTS["ff_sac"], ["env=ant", *windows], {}, "loco_train", smi,
                    False)
    sac["episode_limit"] = LOCO_MAX_STEPS
    emit(sac)
    return {"ff_ppo_continuous_ant": record["kernel_launches"],
            "ff_sac_ant": sac["kernel_launches"]}


def _loco_envs_on_card_and_cpu() -> dict:
    """LOCO_PARITY_STEPS control steps of each robot (16 envs, a step limit
    of 8), each from the CPU's state under the same random actions: step
    types, discounts and truncations equal; rewards within 1e-5 relative
    (floor 1e-6 of their scale), observations and bodies within 1e-5
    relative with a floor of 1e-5 of each field's scale, the bar
    tests/test_torch_locomotion.py holds against the JAX package."""
    from stoix_tpu_torch.envs import locomotion

    out = {}
    for name in ("Ant", "Hopper", "Walker2d", "HalfCheetah"):
        env = getattr(locomotion, name)(max_steps=8)
        cpu_state, _ = env.reset(torch.Generator().manual_seed(4), 16)
        gen, worst = torch.Generator().manual_seed(5), 0.0

        def ratio(got, want, floor):
            bound = 1e-5 * want.abs() + floor * want.abs().max()
            return float(((got.cpu() - want).abs() / bound.clamp_min(1e-30)).max())

        for _ in range(LOCO_PARITY_STEPS):
            action = torch.rand((16, env._nj), generator=gen) * 2 - 1
            card_state = cpu_state._replace(generator=torch.Generator(device="cuda"),
                                            body=tree_map(lambda x: x.cuda(), cpu_state.body),
                                            step_count=cpu_state.step_count.cuda())
            cpu_state, cpu_ts = env.step(cpu_state, action)
            card_state, card_ts = env.step(card_state, action.cuda())
            if not all(torch.equal(a, b.cpu()) for a, b in (
                    (cpu_ts.step_type, card_ts.step_type), (cpu_ts.discount, card_ts.discount),
                    (cpu_ts.extras["truncation"], card_ts.extras["truncation"]))):
                raise AssertionError(f"{name}: step types differ on the card")
            worst = max(worst, ratio(card_ts.reward, cpu_ts.reward, 1e-6),
                        ratio(card_ts.observation.agent_view, cpu_ts.observation.agent_view,
                              1e-5),
                        *(ratio(g, w, 1e-5) for g, w in zip(card_state.body, cpu_state.body)))
        if not worst <= 1.0:
            raise AssertionError(f"{name} on the card is {worst}x the bound from the CPU")
        out[name] = {"envs": 16, "control_steps": LOCO_PARITY_STEPS,
                     "worst_error_over_bound": worst}
    return out


def phase_loco_envs(smi: str) -> dict:
    """One eval window each of ff_ppo_continuous on Hopper, Walker2d and
    HalfCheetah at the default config's full width, LOCO_COMMON, one B1 GAE
    launch an update; then the four robots on the card against the CPU.
    Returns each run's launches."""
    lr = linear_recurrence
    launches = {}
    for env_name in LOCO_ENVS:
        windows = ["arch.num_updates=2", "arch.num_evaluation=1", *LOCO_COMMON]
        record = _path_run("ff_ppo_continuous", CONT_ROOT, [f"env={env_name}", *windows],
                           {lr.GAE_KERNEL.name: 1}, "loco_envs", smi, False)
        record["episode_limit"] = LOCO_MAX_STEPS
        emit(record)
        launches[f"ff_ppo_continuous_{env_name}"] = record["kernel_launches"]
    emit({"phase": "loco_envs", "on_card_vs_cpu": _loco_envs_on_card_and_cpu(), "card": smi})
    return launches


def _grid_envs_on_card_and_cpu() -> dict:
    """GRID_ENV_STEPS steps of Snake, 2048 and DoorKey (64 envs) on the card
    and on the CPU from the same reset draws and step draws (made on the
    CPU), with no auto-reset: every timestep, action masks included, equal."""
    from stoix_tpu_torch.envs import doorkey, game2048, snake

    gen, num_envs, out = torch.Generator().manual_seed(9), 64, {}
    games = {
        "Snake-v1": (snake.Snake(6, 6), lambda: (torch.randint(0, 36, (num_envs,), generator=gen),
                                                 snake.gumbel(gen, (num_envs, 36))),
                     lambda: snake.gumbel(gen, (num_envs, 36))),
        "Game2048-v1": (game2048.Game2048(), lambda: game2048.Game2048()._draws(
            gen, (num_envs, 2)), lambda: game2048.Game2048()._draws(gen, (num_envs,))),
        "DoorKey-v0": (doorkey.DoorKey(6), lambda: doorkey.DoorKeyDraws(
            torch.randint(2, 4, (num_envs,), generator=gen),
            torch.randint(1, 5, (num_envs,), generator=gen),
            *(snake.gumbel(gen, (num_envs, 36)) for _ in range(3)),
            torch.randint(0, 4, (num_envs,), generator=gen)), None),
    }
    to_card = partial(tree_map, lambda x: x.cuda())
    for name, (env, reset_draws, step_draws) in games.items():
        draws = reset_draws()
        cpu_state, cpu_ts = env.reset_from_draws(draws, torch.Generator())
        card_state, card_ts = env.reset_from_draws(to_card(draws),
                                                   torch.Generator(device="cuda"))
        ended = torch.zeros((num_envs,), dtype=torch.bool)
        for step in range(GRID_ENV_STEPS + 1):
            pairs = [(cpu_ts.step_type, card_ts.step_type), (cpu_ts.reward, card_ts.reward),
                     (cpu_ts.discount, card_ts.discount),
                     *zip(cpu_ts.observation, card_ts.observation),
                     (cpu_ts.extras["truncation"], card_ts.extras["truncation"])]
            if not all(torch.equal(a, b.cpu()) for a, b in pairs):
                raise AssertionError(f"{name} on the card differs from the CPU at step {step}")
            ended |= cpu_ts.last()
            if step == GRID_ENV_STEPS:
                break
            action = torch.randint(0, env.num_actions, (num_envs,), generator=gen)
            if step_draws is None:
                cpu_state, cpu_ts = env.step(cpu_state, action)
                card_state, card_ts = env.step(card_state, action.cuda())
            else:
                given = step_draws()
                cpu_state, cpu_ts = env.step_from_draws(cpu_state, action, given)
                card_state, card_ts = env.step_from_draws(card_state, action.cuda(),
                                                          to_card(given))
        out[name] = {"envs": num_envs, "steps": GRID_ENV_STEPS,
                     "envs_ended": int(ended.sum()), "exact": True}
    return out


def phase_grid_train(smi: str) -> dict:
    """One eval window each, at the default arch, of GRID_RUNS: ff_dqn and
    ff_c51 with the flattened MLP networks, ff_dqn + cnn_dqn on the 6x6x5
    grid, ff_ppo on Snake, 2048 and DoorKey; every kernel counter zeroed
    just before each run and read just after (one GAE launch an ff_ppo
    update, nothing else), finite. Then the three games on the card against
    the CPU. Returns each run's launches."""
    launches = {}
    for label, (system, root, overrides, gae) in GRID_RUNS.items():
        windows = ["arch.num_updates=2", "arch.num_evaluation=1", "arch.num_eval_episodes=16",
                   "arch.absolute_metric=False", "system.multistep_impl=pallas",
                   "logger.use_console=False"]
        record = _path_run(system, root, overrides + windows,
                           {linear_recurrence.GAE_KERNEL.name: gae}, "grid_train", smi, False)
        record["run"] = label
        emit(record)
        launches[label] = record["kernel_launches"]
    emit({"phase": "grid_train", "on_card_vs_cpu": _grid_envs_on_card_and_cpu(), "card": smi})
    return launches


def phase_snake_learn() -> None:
    """ff_ppo learns Snake above SNAKE_THRESHOLD."""
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(compose(SNAKE, PPO_ROOT), device="cuda")
    if not final_return > SNAKE_THRESHOLD:
        raise AssertionError(f"ff_ppo returned {final_return} on Snake, not above "
                             f"{SNAKE_THRESHOLD}")
    emit({"phase": "snake_learn", "system": "ff_ppo", "env": "snake",
          "final_return": final_return, "threshold": SNAKE_THRESHOLD,
          "window_seconds": runner.LAST_RUN_STATS["window_seconds"],
          "seconds": time.perf_counter() - start})


# ---------------------------------------------------- data parallelism

DP_OVERRIDES = [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
                "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
                "logger.use_console=False",
                "logger.checkpointing.save_model=true",
                "logger.checkpointing.save_args.max_to_keep=~"]
# ff_ppo's runs fold the observation statistics, so they are reduced too.
DP_PPO = ("ff_ppo", ff_ppo, "default/anakin/default_ff_ppo.yaml",
          ["system.normalize_observations=true"])
DP_PQN = ("ff_pqn", ff_pqn, "default/anakin/default_ff_pqn.yaml", [])
DP_RANKS = 2
REPLICATED = ("params/", "opt_states/", "obs_stats/")


def _distributed(store: str, world: int, rank: int) -> list:
    """The overrides that have the runner form the process group itself."""
    return [f"arch.distributed.coordinator_address=file://{store}",
            f"arch.distributed.num_processes={world}", f"arch.distributed.process_id={rank}"]


def _allreduces() -> dict:
    counter = anakin.allreduce_counter()
    return {kind: counter.value({"kind": kind})
            for kind in ("gradients", "statistics", "kl", "metrics")}


def _dp_run(module, root: str, uid: str, extra: list) -> tuple:
    """One `run_experiment` at DP_OVERRIDES; B1's counters zeroed just before
    and read just after. Returns (record, this rank's saved final state)."""
    lr = linear_recurrence
    config = compose(DP_OVERRIDES + [f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                                     *extra], root)
    for counter in lr.COUNTERS:
        counter.launches = 0
    before = _allreduces()
    start = time.perf_counter()
    final_return = module.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    b1 = _counts(lr.COUNTERS)
    reduces = {k: v - before[k] for k, v in _allreduces().items()}
    stats = copy.deepcopy(runner.LAST_RUN_STATS)
    if not math.isfinite(final_return):
        raise AssertionError(f"{uid}: non-finite eval return {final_return}")
    world = stats["mesh"]["data"]
    step = int(config.arch.total_timesteps)
    name = config.system.system_name
    from stoix_tpu_torch.utils import checkpointing

    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join("checkpoints", uid, name, str(step),
                        checkpointing.state_file(rank, world))
    updates = int(config.arch.num_updates)
    total_sps = stats["steps_per_second"]
    record = {"system": name, "ranks": world, "envs_per_rank": stats["num_envs_per_rank"],
              "updates": updates, "b1_launches": b1,
              "allreduces_per_update": {k: v / updates for k, v in reduces.items()},
              "expected_gradient_allreduces_per_update":
                  int(config.system.epochs) * int(config.system.num_minibatches),
              "env_steps_per_second_total": total_sps,
              "env_steps_per_second_per_rank": [v / world for v in total_sps],
              "window_seconds": stats["window_seconds"], "final_eval_return": final_return,
              "seconds": seconds}
    return record, torch.load(path, weights_only=True)


def _assert_same(label: str, got: dict, want: dict) -> int:
    """The replicated leaves of two saved states bitwise equal; returns how many."""
    keys = [k for k in want if k.startswith(REPLICATED)]
    if not keys or set(keys) != {k for k in got if k.startswith(REPLICATED)}:
        raise AssertionError(f"{label}: replicated leaves differ in name: {sorted(keys)[:4]}")
    for key in keys:
        if isinstance(want[key], torch.Tensor):
            same = torch.equal(got[key], want[key])
        else:
            same = got[key] == want[key]
        if not same:
            raise AssertionError(f"{label}: {key} differs")
    return len(keys)


def dp_rank(rank: int, world: int, store: str, backend: str, out: str) -> None:
    """One rank of case (b) (`--data-parallel-rank`): the run, then its record
    to `out`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    extra = _distributed(store, world, rank)
    if backend == "gloo":
        # Both ranks on the one card: NCCL refuses two ranks on one device,
        # so the ranks form a gloo group themselves, which the runner keeps.
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        extra = []
    try:
        _, module, root, knobs = DP_PPO
        record, _ = _dp_run(module, root, "dp_two_ranks", knobs + extra)
        record["backend"] = dist.get_backend()
        record["rank"] = dist.get_rank()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(record, f)


def run_rank_children(flag: str, world: int, extra_args: list, tmp: str,
                      timeout: float = 600) -> list:
    """`world` children of this script (`flag RANK WORLD STORE *extra_args
    OUT`), a `file://` store in `tmp`; returns each rank's OUT path in rank
    order once all exit 0. A failed rank stops the others and raises with
    every rank's log."""
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
    procs = []
    for rank in range(world):
        with open(logs[rank], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, str(rank), str(world),
                 os.path.join(tmp, "store"), *extra_args, outs[rank]],
                stdout=log, stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode for p in procs):
                break  # one rank failed: the others would wait on it forever
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
    if any(p.returncode for p in procs):
        text = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{open(log).read()[-6000:]}"
                         for r, (p, log) in enumerate(zip(procs, logs)))
        raise AssertionError(f"{flag}: a rank failed:\n{text}")
    return outs


def phase_data_parallel(smi: str) -> dict:
    """Case (a) for ff_ppo and ff_pqn, then case (b); returns B1's launches
    in each run, by case."""
    launches = {}
    for name, module, root, knobs in (DP_PPO, DP_PQN):
        plain, plain_state = _dp_run(module, root, f"dp_{name}_no_group", knobs)
        with tempfile.TemporaryDirectory() as tmp:
            try:
                grouped, grouped_state = _dp_run(
                    module, root, f"dp_{name}_one_rank",
                    knobs + _distributed(os.path.join(tmp, "store"), 1, 0))
                backend = dist.get_backend()
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
        compared = _assert_same(f"{name} one-rank group", grouped_state, plain_state)
        entry = "GAE" if name == "ff_ppo" else "generic"
        kernel = linear_recurrence.GAE_KERNEL if name == "ff_ppo" else linear_recurrence.KERNEL
        for run in (plain, grouped):
            if run["b1_launches"][kernel.name] != run["updates"] or sum(
                    run["b1_launches"].values()) != run["updates"]:
                raise AssertionError(f"{name}: B1 launched {run['b1_launches']} in "
                                     f"{run['updates']} updates, not one {entry} launch each")
        if grouped["allreduces_per_update"]["gradients"] != \
                grouped["expected_gradient_allreduces_per_update"]:
            raise AssertionError(f"{name}: {grouped['allreduces_per_update']} all-reduces an "
                                 "update, not one a minibatch")
        launches[f"a_{name}"] = grouped["b1_launches"][kernel.name]
        emit({"phase": "data_parallel", "case": "a", "backend": backend, **grouped,
              "bitwise_equal_leaves": compared,
              "no_group_env_steps_per_second": plain["env_steps_per_second_total"],
              "card": smi})

    backend = "nccl" if torch.cuda.device_count() >= DP_RANKS else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        records = []
        for out in run_rank_children("--data-parallel-rank", DP_RANKS, [backend], tmp):
            with open(out) as f:
                records.append(json.load(f))
    step = MAIN_UPDATES * int(compose(DP_OVERRIDES).system.rollout_length) * 1024
    from stoix_tpu_torch.utils import checkpointing

    states = [torch.load(os.path.join("checkpoints", "dp_two_ranks", "ff_ppo", str(step),
                                      checkpointing.state_file(r, DP_RANKS)), weights_only=True)
              for r in range(DP_RANKS)]
    compared = _assert_same("two ranks", states[1], states[0])
    gae = linear_recurrence.GAE_KERNEL.name
    for record in records:
        if record["b1_launches"] != {gae: record["updates"], linear_recurrence.KERNEL.name: 0}:
            raise AssertionError(f"rank {record['rank']}: B1 launched {record['b1_launches']} "
                                 f"in {record['updates']} updates, not one GAE launch each")
        if record["allreduces_per_update"]["gradients"] != \
                record["expected_gradient_allreduces_per_update"]:
            raise AssertionError(f"rank {record['rank']}: {record['allreduces_per_update']}")
        if record["envs_per_rank"] != 1024 // DP_RANKS or record["ranks"] != DP_RANKS:
            raise AssertionError(f"rank {record['rank']}: not one {DP_RANKS}-shard run: {record}")
    launches["b_per_rank"] = [record["b1_launches"][gae] for record in records]
    emit({"phase": "data_parallel", "case": "b", "backend": records[0]["backend"],
          "ranks": DP_RANKS, "cards": torch.cuda.device_count(),
          "envs_per_rank": records[0]["envs_per_rank"],
          "allreduces_per_update": records[0]["allreduces_per_update"],
          "expected_gradient_allreduces_per_update":
              records[0]["expected_gradient_allreduces_per_update"],
          "env_steps_per_second_total": records[0]["env_steps_per_second_total"],
          "env_steps_per_second_per_rank": records[0]["env_steps_per_second_per_rank"],
          "b1_gae_launches_per_rank": launches["b_per_rank"], "identical_leaves": compared,
          "final_eval_return": records[0]["final_eval_return"],
          "seconds": [record["seconds"] for record in records], "card": smi})
    return launches


def phase_pendulum_learn(name: str) -> None:
    """`PENDULUM_ORACLES[name]`'s system on Pendulum above its threshold,
    fixed before any card run by scripts/jax_oracle_thresholds.py."""
    system, root, overrides = PENDULUM_ORACLES[name]
    threshold = PENDULUM_THRESHOLDS[name]
    start = time.perf_counter()
    final_return = _a12_module(system).run_experiment(compose(overrides, root), device="cuda")
    if not final_return > threshold:
        raise AssertionError(f"{system} returned {final_return}, not above {threshold}")
    emit({"phase": f"{name}_learn", "system": system, "env": "pendulum",
          "final_return": final_return, "threshold": threshold,
          "window_seconds": runner.LAST_RUN_STATS["window_seconds"],
          "seconds": time.perf_counter() - start})


# ------------------------------------------- Sebulba

SEBULBA_ROOTS = {name: f"default/sebulba/default_{name}.yaml"
                 for name in ("ff_ppo", "ff_impala", "ff_impala_shared_torso", "ff_dqn")}
# The host has one card: every Sebulba run shares it between the roles.
ONE_CARD = ["arch.actor.device_ids=[0]", "arch.learner.device_ids=[0]",
            "arch.evaluator_device_id=0"]
# Sebulba ff_ppo and ff_impala on IdentityGame (sebulba_ppo_learn,
# sebulba_impala_learn): the budgets, and the thresholds fixed before any card
# run by scripts/jax_oracle_thresholds.py --oracles sebulba_ppo sebulba_impala:
# 8.0 where the JAX package returns 10.0 for seeds 42 and 1, else the
# midpoint of random actions' 2.5 and its lower return.
SEBULBA_IDENTITY = ["env=identity_game", "arch.total_num_envs=16", "arch.total_timesteps=8192",
                    "arch.num_evaluation=1", "arch.num_eval_episodes=32",
                    "arch.evaluation_greedy=True", "system.rollout_length=8",
                    "logger.use_console=False", *ONE_CARD]
# Sebulba ff_dqn on IdentityGame (sebulba_dqn_learn): a 4 096-item ring of
# uniform replay filled to 128 before the first sample, batches of 64.
SEBULBA_DQN_IDENTITY = [*SEBULBA_IDENTITY, "system.total_buffer_size=4096",
                        "system.total_batch_size=64", "system.replay.min_fill=128"]
SEBULBA_ORACLES = {"sebulba_ppo": ("ff_ppo", SEBULBA_IDENTITY),
                   "sebulba_impala": ("ff_impala", SEBULBA_IDENTITY),
                   "sebulba_dqn": ("ff_dqn", SEBULBA_DQN_IDENTITY),
                   "sebulba_impact": ("ff_ppo", [*SEBULBA_IDENTITY, "system.impact.enabled=true"])}
SEBULBA_THRESHOLD = 8.0  # the JAX package returns 10.0 for seeds 42 and 1 in both
# The Sebulba paths (phases sebulba_train, sebulba_pixel, sebulba_envs): each
# label -> (system, overrides, B1 GAE launches an update, generic launches an
# update). Every role on device 0, the actors' pools on the host.
SEBULBA_UPDATES = 6  # sebulba_train's ff_ppo at the JAX package's tracked shape
SEBULBA_DQN_UPDATES = 4  # sebulba_dqn_train's ff_dqn runs, in 2 windows
SEBULBA_PATHS = {
    # bench.py:1876-1894's shape: 512 cvec CartPole envs in 2 actors, T = 64.
    "ff_ppo_cartpole": ("ff_ppo", ["env=cartpole", "env.backend=cvec", "arch.total_num_envs=512",
                                   "system.rollout_length=64",
                                   f"arch.num_updates={SEBULBA_UPDATES}",
                                   "arch.num_evaluation=2", "system.multistep_impl=pallas"], 1, 0),
    # default_ff_ppo.yaml as it is: 64 CartPole envs on the CPU through the
    # stateful wrapper (env.backend jax), multistep_impl scan.
    "ff_ppo_default": ("ff_ppo", ["arch.num_updates=4", "arch.num_evaluation=1"], 0, 0),
    # bench.py --pixel's shape (bench.py:805-812): 128 envs, T = 32.
    "ff_ppo_pixel": ("ff_ppo", ["env=breakout_pixel", "network=cnn_atari",
                                "arch.total_num_envs=128", "system.rollout_length=32",
                                "arch.num_updates=4", "arch.num_evaluation=2",
                                "system.multistep_impl=pallas"], 1, 0),
    # tests/test_sebulba.py:100-127 at the default arch's 64 envs.
    "ff_ppo_pendulum": ("ff_ppo", ["env=pendulum", "env.backend=cvec", "network=mlp_continuous",
                                   "env.kwargs.max_steps=200", "arch.total_timesteps=2048",
                                   "arch.num_evaluation=1", "system.rollout_length=8",
                                   "system.num_minibatches=2", "system.multistep_impl=pallas"],
                        1, 0),
    # The IMPALAs' defaults: 64 cvec CartPole envs, T = 16, 4 env-minibatches.
    **{system: (system, ["env=cartpole", "env.backend=cvec", "arch.num_updates=4",
                         "arch.num_evaluation=1", "system.multistep_impl=pallas"], 0, 4)
       for system in ("ff_impala", "ff_impala_shared_torso")},
    # IMPACT at the tracked shape: one GAE launch an update, fresh or reused.
    "ff_ppo_impact": ("ff_ppo", ["env=cartpole", "env.backend=cvec", "arch.total_num_envs=512",
                                 "system.rollout_length=64",
                                 f"arch.num_updates={SEBULBA_UPDATES}", "arch.num_evaluation=2",
                                 "system.multistep_impl=pallas", "system.impact.enabled=true"],
                      1, 0),
    # default_ff_dqn.yaml as it is (64 CartPole envs in 2 actors, T = 8, 8
    # epochs of 512 from a 100 000-item ring filled to 1 024 first, MLP 256 x
    # 256), uniform and prioritized: no kernel on the path.
    **{f"ff_dqn_{mode}": ("ff_dqn", [f"arch.num_updates={SEBULBA_DQN_UPDATES}",
                                     "arch.num_evaluation=2",
                                     f"system.replay.prioritized={mode == 'prioritized'}"],
                          0, 0)
       for mode in ("uniform", "prioritized")},
    # Phase sebulba_adapters: the envpool adapter over chip_smoke's
    # AtariDoublePool (no tensor-env twin: the stateful evaluator). Pixels at
    # sebulba_pixel's shape; ff_dqn's default MLP on 128-byte RAM frames.
    "ff_ppo_envpool": ("ff_ppo", ["env.backend=envpool", "env.scenario.name=Breakout-v5",
                                  "network=cnn_atari",
                                  "arch.total_num_envs=128", "system.rollout_length=32",
                                  "arch.num_updates=4", "arch.num_evaluation=2",
                                  "system.multistep_impl=pallas"], 1, 0),
    "ff_dqn_envpool": ("ff_dqn", ["env.backend=envpool", "env.scenario.name=Breakout-ram-v5",
                                  f"arch.num_updates={SEBULBA_DQN_UPDATES // 2}",
                                  "arch.num_evaluation=1"], 0, 0),
}
SEBULBA_COMMON = [*ONE_CARD, "arch.num_eval_episodes=16", "logger.use_console=False"]


def _sebulba_module(system: str):
    from stoix_tpu_torch.systems.impala.sebulba import ff_impala, ff_impala_shared_torso
    from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo as sebulba_ppo
    from stoix_tpu_torch.systems.q_learning.sebulba import ff_dqn as sebulba_dqn

    return {"ff_ppo": sebulba_ppo, "ff_impala": ff_impala,
            "ff_impala_shared_torso": ff_impala_shared_torso, "ff_dqn": sebulba_dqn}[system]


def _sebulba_stats(system: str) -> dict:
    """The last run's stats: ff_dqn's own, the others' those of the runner
    they share (ff_ppo's)."""
    module = _sebulba_module("ff_dqn" if system == "ff_dqn" else "ff_ppo")
    return copy.deepcopy(dict(module.LAST_RUN_STATS))


def _sebulba_run(label: str, phase: str, smi: str) -> dict:
    """One Sebulba `run_experiment` of SEBULBA_PATHS[label] on the card, every
    kernel counter zeroed just before and read just after: B1's launches an
    update as the path says, 0 of every other kernel; exactly `num_updates`
    learn steps; no actor crash, supervisor restart or evaluator error; the
    run's peak device bytes."""
    system, overrides, gae, generic = SEBULBA_PATHS[label]
    module = _sebulba_module(system)
    config = compose(SEBULBA_COMMON + overrides, SEBULBA_ROOTS[system])
    counters = _kernel_counters()
    for counter in counters:
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    final_return = module.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    launches = _counts(counters)
    stats = _sebulba_stats(system)
    updates = int(config.arch.num_updates)
    lr = linear_recurrence
    expected = {c.name: 0 for c in counters}
    expected[lr.GAE_KERNEL.name] = gae * updates
    expected[lr.KERNEL.name] = generic * updates
    if launches != expected:
        raise AssertionError(f"{label} launched {launches} in {updates} updates, not {expected}")
    resilience = stats["resilience"]
    faults = {k: resilience[k] for k in ("actor_crashes", "supervisor_restarts",
                                         "evaluator_errors")}
    if stats["learn_steps"] != updates or any(faults.values()):
        raise AssertionError(f"{label}: {stats['learn_steps']} learn steps of {updates}, "
                             f"faults {faults}")
    train = [rec for rec in stats["history"] if rec["event"] == "trainer"]
    if not math.isfinite(final_return) or not train or not all(
            math.isfinite(v) for rec in train for k, v in rec.items()
            if k not in ("event", "t", "t_eval")):
        raise AssertionError(f"{label}: non-finite return {final_return} or metrics {train}")
    timings = stats["timings"]
    actors = range(stats["num_actors"])
    extra = {}
    if system == "ff_dqn":
        extra = {"replay": stats["replay"], "ring_device_bytes": stats["ring_bytes"],
                 "prioritized": bool(config.system.replay.prioritized),
                 "learner_ingest_mean_s": timings.get("learner_ingest_time")}
    elif stats.get("impact") is not None:
        extra = {"impact": stats["impact"]}
    return {**extra, "phase": phase, "run": label, "system": system,
            "env": config.env.scenario.name,
            "backend": str(config.env.get("backend", "jax")),
            "total_num_envs": int(config.arch.total_num_envs), "num_actors": stats["num_actors"],
            "rollout_length": int(config.system.rollout_length), "updates": updates,
            "learn_steps": stats["learn_steps"], "kernel_launches": launches, "faults": faults,
            "final_eval_return": final_return, "last_train_metrics": train[-1],
            "steps_per_sec_steady": stats.get("steps_per_sec_steady"), "fps": stats.get("fps"),
            "learner_rollout_get_mean_s": timings.get("learner_rollout_get_time"),
            "learner_learn_mean_s": timings.get("learner_learn_time"),
            "actor_inference_mean_s": [timings.get(f"actor{a}_inference_time") for a in actors],
            "actor_env_step_mean_s": [timings.get(f"actor{a}_env_step_time") for a in actors],
            "run_peak_device_bytes": torch.cuda.max_memory_allocated(),
            "seconds": seconds, "card": smi}


def _sebulba_batch(env, t_len: int, num_envs: int, device, seed: int):
    """A [T, E] PPOTransition shaped as `env`'s rollouts give it, from a
    seed: observations N(0, 1), actions uniform, terminations 5%,
    truncations 3%."""
    from stoix_tpu_torch.base_types import PPOTransition
    from stoix_tpu_torch.envs import spaces

    gen = torch.Generator().manual_seed(seed)
    value = env.observation_value()
    shape = (t_len, num_envs)

    def observation():
        return envs.Observation(
            torch.randn(shape + tuple(value.agent_view.shape), generator=gen),
            torch.ones(shape + tuple(value.action_mask.shape)),
            torch.zeros(shape, dtype=torch.int32))

    space = env.action_space()
    if isinstance(space, spaces.Discrete):
        action = torch.randint(0, env.num_actions, shape, generator=gen)
    else:
        action = torch.rand(shape + tuple(space.shape), generator=gen) * 3.8 - 1.9
    done = torch.rand(shape, generator=gen) < 0.05
    batch = PPOTransition(
        done=done, truncated=(torch.rand(shape, generator=gen) < 0.03) & ~done, action=action,
        value=torch.randn(shape, generator=gen), reward=torch.randn(shape, generator=gen),
        log_prob=torch.log(torch.rand(shape, generator=gen) * 0.6 + 0.2),
        obs=observation(), next_obs=observation(), info={})
    return tree_map(lambda x: x.to(device), batch)


def _sebulba_learner(label: str, device: str):
    """(config, learner_setup on `device`, a probe env) of SEBULBA_PATHS[label]."""
    from stoix_tpu_torch.envs.factory import make_factory

    system, overrides, _, _ = SEBULBA_PATHS[label]
    module = _sebulba_module(system)
    config = compose(SEBULBA_COMMON + overrides, SEBULBA_ROOTS[system])
    if config.arch.get("num_updates") in (None, "~"):
        config.arch.num_updates = 4
    probe = make_factory(config)(1)
    if system == "ff_dqn":
        config.system.action_dim = probe.num_actions
        return config, module.learner_setup(config, probe, [torch.device(device)]), probe
    builders = (None, None)  # ff_ppo's: its networks and learn step
    impact = module.impact_settings_from_config(config) if system == "ff_ppo" else None
    if impact is not None:
        builders = (None, partial(module.get_impact_learn_step, rho_clip=impact.rho_clip))
    if system == "ff_impala":
        builders = (None, module.get_impala_learn_step)
    elif system == "ff_impala_shared_torso":
        builders = (module.build_shared_networks, module.get_shared_impala_learn_step)
    setup = _sebulba_module("ff_ppo").learner_setup(config, probe, [torch.device(device)],
                                                      *builders)
    return config, setup, probe


def _sebulba_learn_step_costs(label: str) -> dict:
    """One learn step of SEBULBA_PATHS[label] at its [T, E] on a batch from a
    seed, with no actor thread beside it: device launches (torch.profiler,
    after a warm-up step), host seconds (three steps, each ended by a
    synchronize) and the step's peak device bytes."""
    config, setup, probe = _sebulba_learner(label, "cuda")
    t_len, num_envs = int(config.system.rollout_length), int(config.arch.total_num_envs)
    batch = [_sebulba_batch(probe, t_len, num_envs, "cuda", 0)]
    state, _ = setup.learn_step(setup.state, batch)  # warm-up
    launches = _device_launches_of(lambda: setup.learn_step(state, batch))
    torch.cuda.synchronize()
    alone = []
    for _ in range(3):  # the learn step with no actor thread beside it
        begin = time.perf_counter()
        setup.learn_step(state, batch)
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - begin)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    setup.learn_step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"learn_step_device_launches": launches, "learn_step_shape": [t_len, num_envs],
            "learn_step_alone_s": alone,
            "learn_step_peak_bytes": peak, "learn_step_above_state_bytes": peak - before,
            "batch_bytes": _tree_bytes(batch)}


def phase_sebulba_train(smi: str) -> dict:
    """Sebulba ff_ppo at the JAX package's tracked shape (512 cvec CartPole
    envs in 2 actors, T = 64, MLP 256 x 256, 4 x 4 minibatches, pallas):
    SEBULBA_UPDATES updates in 2 windows, one GAE launch an update at
    [64, 512]; steady env-steps/s and fps, the learner's rollout get-wait,
    the actors' inference and env-step means; a learn step's device launches
    and peak bytes. Then default_ff_ppo.yaml as it is (64 CartPole envs on
    the CPU through the stateful wrapper, the learner on the card), one
    window. Returns each run's launches."""
    launches = {}
    record = _sebulba_run("ff_ppo_cartpole", "sebulba_train", smi)
    record.update(_sebulba_learn_step_costs("ff_ppo_cartpole"))
    emit(record)
    launches["ff_ppo_cartpole"] = record["kernel_launches"]
    record = _sebulba_run("ff_ppo_default", "sebulba_train", smi)
    emit(record)
    launches["ff_ppo_default"] = record["kernel_launches"]
    return launches


def phase_sebulba_pixel(smi: str) -> dict:
    """Sebulba ff_ppo on the pool's 84x84x4 pixel Breakout with the Nature
    CNN at bench.py --pixel's shape (128 envs in 2 actors, T = 32), 4 updates
    in 2 windows, one GAE launch an update; the run's peak device bytes
    (about 0.9 GB of float32 obs and next_obs a rollout)."""
    record = _sebulba_run("ff_ppo_pixel", "sebulba_pixel", smi)
    emit(record)
    return {"ff_ppo_pixel": record["kernel_launches"]}


def phase_sebulba_envs(smi: str) -> dict:
    """Sebulba ff_ppo on the pool's Pendulum (continuous, one window, a
    finite negative return, one GAE launch an update) and ff_impala and
    ff_impala_shared_torso at their defaults on the pool's CartPole (one
    window, exactly 4 generic B1 launches an update at [16, 16], no GAE)."""
    launches = {}
    for label in ("ff_ppo_pendulum", "ff_impala", "ff_impala_shared_torso"):
        record = _sebulba_run(label, "sebulba_envs", smi)
        if label == "ff_ppo_pendulum" and not record["final_eval_return"] < 0.0:
            raise AssertionError(f"Pendulum's return {record['final_eval_return']} is not negative")
        emit(record)
        launches[label] = record["kernel_launches"]
    return launches


def phase_sebulba_parity(smi: str) -> None:
    """A learn step of each Sebulba system on the card against the same step
    on the CPU from the same params and batch (ff_ppo with the same explicit
    permutations): losses 1e-5 relative with a 1e-6 floor, params 1e-5
    absolute; B1's GAE entry at ff_ppo's [64, 512] and its generic entry at
    the IMPALAs' [16, 16], each bitwise against its plain version on the same
    card inputs; and the tree the ParameterServer handed to an actor bitwise
    unchanged after the learner's next two updates."""
    from stoix_tpu_torch.sebulba.core import ParameterServer

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on; the card-against-CPU bars assume float32 products")
    start = time.perf_counter()
    record = {"phase": "sebulba_parity", "card": smi}
    for label in ("ff_ppo_cartpole", "ff_impala", "ff_impala_shared_torso"):
        config, card, probe = _sebulba_learner(label, "cuda")
        _, cpu, _ = _sebulba_learner(label, "cpu")
        t_len, num_envs = int(config.system.rollout_length), int(config.arch.total_num_envs)
        batch = _sebulba_batch(probe, t_len, num_envs, "cpu", 1)
        kwargs = {}
        if label == "ff_ppo_cartpole":
            gen = torch.Generator().manual_seed(2)
            kwargs["permutations"] = [torch.randperm(t_len * num_envs, generator=gen)
                                      for _ in range(int(config.system.epochs))]
        got_state, got = card.learn_step(card.state, [tree_map(lambda x: x.cuda(), batch)],
                                         **kwargs)
        want_state, want = cpu.learn_step(cpu.state, [batch], **kwargs)
        diffs = {k: ((got[k].cpu() - want[k]).abs(), want[k].abs())
                 for k in ("actor_loss", "value_loss", "entropy")}
        within = all(bool((d <= 1e-5 * w + 1e-6).all()) for d, w in diffs.values())
        param_err = _max_err(got_state.params, want_state.params)
        record[label] = {"shape": [t_len, num_envs],
                         "loss_abs_err": {k: float(d.max()) for k, (d, _) in diffs.items()},
                         "loss_relative_err": {k: float((d / w.clamp_min(1e-30)).max())
                                               for k, (d, w) in diffs.items()},
                         "params_abs_err": param_err}
        if not (within and param_err <= 1e-5):
            raise AssertionError(f"{label}'s learn step on the card is not the CPU's: "
                                 f"{record[label]}")
        if label == "ff_ppo_cartpole":
            # The actor's tree after the learner's next two updates.
            server = ParameterServer([torch.device("cuda")], 2)
            server.distribute_params((card.state.params, card.state.obs_stats))
            held = server.get_params(0, timeout=10.0)
            snapshot = tree_map(lambda x: x.clone(), held)
            state = card.state
            for seed in (3, 4):
                state, _ = card.learn_step(state, [_sebulba_batch(probe, t_len, num_envs,
                                                                  "cuda", seed)])
                server.distribute_params((state.params, state.obs_stats))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(tree_leaves(held),
                                                        tree_leaves(snapshot))):
                raise AssertionError("a parameter version held by an actor changed under it")
            record["actor_tree_unchanged"] = True
    lr = linear_recurrence
    args = gae_inputs(64, 512, 5)
    got, want = lr.truncated_gae(*args, 0.95), lr.plain_truncated_gae(*args, 0.95)
    w, d, init = recurrence_inputs(16, 16, torch.float32, True, 6)
    generic = lr.linear_recurrence_reverse(w, d, init)
    bitwise = {"gae_64x512": all(torch.equal(a, b) for a, b in zip(got, want)),
               "generic_16x16": torch.equal(generic,
                                            lr.plain_linear_recurrence_reverse(w, d, init))}
    record["b1_bitwise"] = bitwise
    if not all(bitwise.values()):
        raise AssertionError(f"B1 on the Sebulba shapes is not its plain version: {bitwise}")
    record["seconds"] = time.perf_counter() - start
    emit(record)


# bench.py --replay's shape (bench.py:1149-1200): 64-float observations, a
# ring of 4 096 slots, batches of 512, chunks of 2 048, prioritized, 64 add ->
# sample -> set_priorities cycles a repetition; one shard, on the card.
REPLAY_BENCH = dict(obs_dim=64, capacity=4096, batch=512, chunk=2048, cycles=64, reps=3)


def _replay_rows(size: int, obs_dim: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {"obs": torch.randn((size, obs_dim), generator=gen),
            "action": torch.randint(0, 4, (size,), generator=gen, dtype=torch.int32),
            "reward": torch.randn((size,), generator=gen),
            "done": torch.zeros((size,), dtype=torch.bool),
            "next_obs": torch.randn((size, obs_dim), generator=gen)}


def _cpu_twin(service):
    """A service on the CPU holding a copy of `service`'s rings."""
    from stoix_tpu_torch.replay import ShardedReplayService

    twin = ShardedReplayService(["cpu"] * service.num_shards,
                                tree_map(lambda x: x[0].cpu(), service.state[0].experience),
                                capacity_per_shard=service.capacity_per_shard,
                                sample_batch_size=service.sample_batch_size,
                                prioritized=service.prioritized,
                                priority_exponent=service.core.priority_exponent,
                                min_fill=service.core.min_fill)
    twin.commit([s._replace(experience=tree_map(lambda x: x.cpu().clone(), s.experience),
                            priorities=s.priorities.cpu().clone()) for s in service.state])
    return twin


def _samples_equal(got, want) -> dict:
    """Card samples against CPU samples: indices and rows exact,
    probabilities' largest relative error."""
    indices = all(torch.equal(g.indices.cpu(), w.indices) for g, w in zip(got, want))
    rows = all(torch.equal(a.cpu(), b) for g, w in zip(got, want)
               for a, b in zip(tree_leaves(g.experience), tree_leaves(w.experience)))
    probs = max(_relative(g.probabilities, w.probabilities) for g, w in zip(got, want))
    return {"indices_equal": indices, "rows_equal": rows, "probabilities_rel_err": probs}


def phase_sebulba_replay(smi: str) -> dict:
    """The sharded replay service alone at bench.py --replay's shape, one
    shard on the card: sampled items/s over REPLAY_BENCH's cycles (each rep
    ended by a synchronize), the transport ledger, the ring's device bytes,
    a cycle's device launches (no kernel of the repo on it: every count 0);
    then one sample and one set_priorities on the card against the same ops
    on a CPU copy of the ring from the same uniforms and priorities (indices
    and rows exact, probabilities and priorities 1e-6 relative)."""
    from stoix_tpu_torch.replay import ShardedReplayService

    b = REPLAY_BENCH
    start = time.perf_counter()
    svc = ShardedReplayService([torch.device("cuda", 0)],
                               tree_map(lambda x: x[0].cuda(), _replay_rows(1, b["obs_dim"], 0)),
                               capacity_per_shard=b["capacity"], sample_batch_size=b["batch"],
                               prioritized=True, priority_exponent=0.6)
    base = svc.stats()
    chunk = tree_map(lambda x: x.cuda(), _replay_rows(b["chunk"], b["obs_dim"], 1))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def cycle():
        svc.add([chunk])
        drawn = svc.sample(gen)
        svc.set_priorities([drawn[0].indices], [drawn[0].probabilities.abs() + 0.5])
        return drawn

    cycle()  # warm-up
    counters = _kernel_counters()
    for counter in counters:
        counter.launches = 0
    rates = []
    for _ in range(b["reps"]):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        for _ in range(b["cycles"]):
            cycle()
        torch.cuda.synchronize()
        rates.append(b["cycles"] * b["batch"] / (time.perf_counter() - begin))
    launches = _counts(counters)
    if any(launches.values()):
        raise AssertionError(f"the replay service launched a kernel of the repo: {launches}")
    cycle_launches = _device_launches_of(cycle)
    stats = {k: v - base[k] for k, v in svc.stats().items()}
    if not stats["sampled_bytes_crossed"] < stats["ingested_bytes_total"]:
        raise AssertionError(f"sampled bytes not below ingested bytes: {stats}")

    # The card against the CPU from the same ring.
    twin = _cpu_twin(svc)
    uniforms = torch.rand((b["batch"],), generator=torch.Generator().manual_seed(3))
    sample = _samples_equal(svc.sample(uniforms=uniforms.cuda()), twin.sample(uniforms=uniforms))
    indices = torch.randint(0, b["capacity"], (b["batch"],), generator=torch.Generator()
                            .manual_seed(4), dtype=torch.int32)
    values = torch.rand((b["batch"],), generator=torch.Generator().manual_seed(5)) * 3.0
    svc.set_priorities([indices.cuda()], [values.cuda()])
    twin.set_priorities([indices], [values])
    prio_err = _relative(svc.state[0].priorities, twin.state[0].priorities)
    parity = {**sample, "set_priorities_rel_err": prio_err,
              "set_priorities_bitwise": torch.equal(svc.state[0].priorities.cpu(),
                                                    twin.state[0].priorities)}
    if not (sample["indices_equal"] and sample["rows_equal"]
            and sample["probabilities_rel_err"] <= 1e-6 and prio_err <= 1e-6):
        raise AssertionError(f"the service on the card is not the CPU's: {parity}")
    record = {"phase": "sebulba_replay", "shape": b, "shards": 1,
              "sampled_items_per_s": max(rates), "sampled_items_per_s_reps": rates,
              "ledger": stats, "ring_device_bytes": svc.ring_bytes(),
              "cycle_device_launches": cycle_launches, "kernel_launches": launches,
              "card_vs_cpu": parity, "seconds": time.perf_counter() - start, "card": smi}
    emit(record)
    return launches


def _dqn_learn_step_costs(label: str) -> dict:
    """One Sebulba ff_dqn learn step (default config: 8 epochs of 512) on
    the card from a ring filled with random transitions (min_fill's worth):
    device launches (torch.profiler, after a warm-up), host seconds (three,
    each ended by a synchronize) and its peak device bytes above the state."""
    config, setup, probe = _sebulba_learner(label, "cuda")
    _fill_dqn_ring(setup.service, probe, int(config.system.replay.min_fill), 0)
    state = setup.state
    state, replay, _ = setup.learn_step(state, setup.service.state)  # warm-up
    launches = _device_launches_of(lambda: setup.learn_step(state, setup.service.state))
    alone = []
    for _ in range(3):
        begin = time.perf_counter()
        setup.learn_step(state, setup.service.state)
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - begin)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    setup.learn_step(state, setup.service.state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"learn_step_device_launches": launches, "learn_step_alone_s": alone,
            "learn_step_peak_bytes": peak, "learn_step_above_state_bytes": peak - before,
            "epochs": int(config.system.epochs), "batch": int(config.system.total_batch_size)}


def _fill_dqn_ring(service, probe, items: int, seed: int) -> None:
    """`items` random transitions of `probe`'s shapes added to every shard
    of `service` (observations N(0, 1), valid actions, 10% terminal)."""
    from stoix_tpu_torch.base_types import Transition

    gen = torch.Generator().manual_seed(seed)
    view = probe.observation_value()
    per_shard = items // service.num_shards

    def observation():
        return envs.Observation(
            torch.randn((per_shard,) + tuple(view.agent_view.shape), generator=gen),
            torch.ones((per_shard,) + tuple(view.action_mask.shape)),
            torch.zeros((per_shard,), dtype=torch.int32))

    shards = []
    for device in service.devices:
        batch = Transition(obs=observation(), action=torch.randint(
            0, probe.num_actions, (per_shard,), generator=gen, dtype=torch.int32),
            reward=torch.randn((per_shard,), generator=gen),
            done=torch.rand((per_shard,), generator=gen) < 0.1, next_obs=observation(), info={})
        shards.append(tree_map(lambda x, d=device: x.to(d), batch))
    service.add(shards)


def phase_sebulba_dqn_train(smi: str) -> dict:
    """Sebulba ff_dqn at default_ff_dqn.yaml (64 CartPole envs in 2 actors,
    T = 8, 8 epochs of 512 from a 100 000-item ring, MLP 256 x 256), uniform
    then prioritized, SEBULBA_DQN_UPDATES updates in 2 windows each, every
    kernel counter zeroed just before and read just after (no kernel on the
    path: every count 0); steady env-steps/s and fps, the learner's ingest
    and learn means, the actors' means, the ring's device bytes, the replay
    ledger; a learn step's device launches and peak bytes above the state."""
    launches = {}
    for mode in ("uniform", "prioritized"):
        label = f"ff_dqn_{mode}"
        record = _sebulba_run(label, "sebulba_dqn_train", smi)
        record.update(_dqn_learn_step_costs(label))
        emit(record)
        launches[label] = record["kernel_launches"]
    return launches


def phase_sebulba_impact_train(smi: str) -> dict:
    """Sebulba ff_ppo with IMPACT at the tracked shape (512 cvec CartPole
    envs in 2 actors, T = 64, MLP 256 x 256, 4 x 4 minibatches, pallas),
    SEBULBA_UPDATES updates in 2 windows: exactly one B1 GAE launch an
    update at [64, 512], fresh or reused; the impact stats with at least
    one target refresh; env-steps/s."""
    record = _sebulba_run("ff_ppo_impact", "sebulba_impact_train", smi)
    impact = record["impact"]
    if impact["target_refreshes"] < 1 or impact["updates"] != record["updates"]:
        raise AssertionError(f"IMPACT's stats are off: {impact}")
    emit(record)
    return {"ff_ppo_impact": record["kernel_launches"]}


def _dqn_step_on_card_and_cpu(mode: str) -> dict:
    """One ff_dqn learn step on the card and on the CPU from the same ring
    (4 096 random transitions), params and uniforms: q_loss and mean Q 1e-5
    relative, online and target params 1e-5 absolute, the ring's priorities
    1e-6 relative (1e-6 floor). Prioritized: one epoch, from non-dyadic
    priorities set alike on both rings first (a second epoch would draw from
    priorities that the card's and the CPU's float32 sums part by an ulp)."""
    label = f"ff_dqn_{mode}"
    system, overrides, gae, generic = SEBULBA_PATHS[label]
    if mode == "prioritized":
        SEBULBA_PATHS[label] = (system, [*overrides, "system.epochs=1"], gae, generic)
    try:
        _, card, probe = _sebulba_learner(label, "cuda")
        config, cpu, _ = _sebulba_learner(label, "cpu")
    finally:
        SEBULBA_PATHS[label] = (system, overrides, gae, generic)
    for setup in (card, cpu):
        _fill_dqn_ring(setup.service, probe, 4096, 7)
    if mode == "prioritized":
        gen = torch.Generator().manual_seed(8)
        idx = torch.arange(4096, dtype=torch.int32)
        values = torch.rand((4096,), generator=gen) * 2.0
        for setup in (card, cpu):
            device = setup.service.devices[0]
            setup.service.set_priorities([idx.to(device)], [values.to(device)])
    uniforms = [torch.rand((int(config.system.total_batch_size),),
                           generator=torch.Generator().manual_seed(9 + e))
                for e in range(int(config.system.epochs))]
    got_state, got_replay, got = card.learn_step(card.state, card.service.state,
                                                 uniforms=[u.cuda() for u in uniforms])
    want_state, want_replay, want = cpu.learn_step(cpu.state, cpu.service.state,
                                                   uniforms=uniforms)
    losses = {k: ((got[k].cpu() - want[k]).abs(), want[k].abs()) for k in ("q_loss", "mean_q")}
    within = all(bool((d <= 1e-5 * w + 1e-6).all()) for d, w in losses.values())
    param_err = _max_err(got_state.params, want_state.params)
    prio_diff = (got_replay[0].priorities.cpu() - want_replay[0].priorities).abs()
    prio_ok = bool((prio_diff <= 1e-6 * want_replay[0].priorities.abs() + 1e-6).all())
    out = {"epochs": int(config.system.epochs),
           "loss_relative_err": {k: float((d / w.clamp_min(1e-30)).max())
                                 for k, (d, w) in losses.items()},
           "params_abs_err": param_err, "priorities_abs_err": float(prio_diff.max())}
    if not (within and param_err <= 1e-5 and prio_ok):
        raise AssertionError(f"ff_dqn's {mode} learn step on the card is not the CPU's: {out}")
    return out


def phase_sebulba_offpolicy_parity(smi: str) -> None:
    """TF32 off. One ff_dqn learn step (uniform and prioritized) and one
    IMPACT learn step (from the same batch, permutations and target params)
    on the card against the CPU, losses 1e-5 relative with a 1e-6 floor,
    params 1e-5 absolute; the IMPACT step's one B1 GAE launch, and B1's GAE
    entry bitwise against its plain version on that step's inputs."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on; the card-against-CPU bars assume float32 products")
    start = time.perf_counter()
    record = {"phase": "sebulba_offpolicy_parity", "card": smi}
    for mode in ("uniform", "prioritized"):
        record[f"ff_dqn_{mode}"] = _dqn_step_on_card_and_cpu(mode)
    record["ff_ppo_impact"] = _impact_step_on_card_and_cpu()
    record["seconds"] = time.perf_counter() - start
    emit(record)


def _impact_step_on_card_and_cpu() -> dict:
    """One IMPACT learn step at the tracked shape ([64, 512], 4 x 4
    minibatches) on the card and on the CPU from the same batch,
    permutations and target params (the params after one update): losses
    1e-5 relative (1e-6 floor), params 1e-5 absolute; exactly one B1 GAE
    launch, and B1's GAE entry bitwise against its plain version on the
    step's inputs."""
    config, card, probe = _sebulba_learner("ff_ppo_impact", "cuda")
    _, cpu, _ = _sebulba_learner("ff_ppo_impact", "cpu")
    t_len, num_envs = int(config.system.rollout_length), int(config.arch.total_num_envs)
    batch = _sebulba_batch(probe, t_len, num_envs, "cpu", 11)
    gen = torch.Generator().manual_seed(12)
    permutations = [torch.randperm(t_len * num_envs, generator=gen)
                    for _ in range(int(config.system.epochs))]
    # The target: the params after one plain update, so that it differs from
    # the online params and the behaviour log-probs.
    target_state, _ = cpu.learn_step(cpu.state, cpu.state.params, [batch],
                                     permutations=permutations)
    target = target_state.params
    counters = _kernel_counters()
    for counter in counters:
        counter.launches = 0
    got_state, got = card.learn_step(card.state, tree_map(lambda x: x.cuda(), target),
                                     [tree_map(lambda x: x.cuda(), batch)],
                                     permutations=permutations)
    launches = _counts(counters)
    want_state, want = cpu.learn_step(cpu.state, target, [batch], permutations=permutations)
    expected = {c.name: 0 for c in counters}
    expected[linear_recurrence.GAE_KERNEL.name] = 1
    diffs = {k: ((got[k].cpu() - want[k]).abs(), want[k].abs())
             for k in ("actor_loss", "value_loss", "entropy")}
    param_err = _max_err(got_state.params, want_state.params)
    impact = {"shape": [t_len, num_envs], "kernel_launches": launches,
              "loss_relative_err": {k: float((d / w.clamp_min(1e-30)).max())
                                    for k, (d, w) in diffs.items()},
              "params_abs_err": param_err}
    if launches != expected or not (all(bool((d <= 1e-5 * w + 1e-6).all())
                                        for d, w in diffs.values()) and param_err <= 1e-5):
        raise AssertionError(f"IMPACT's learn step on the card is not the CPU's: {impact}")
    # B1 on this step's GAE inputs (the card's bootstrap values).
    shard = tree_map(lambda x: x.cuda(), batch)
    with torch.no_grad():
        v_t = card.learn_step.critic_apply(card.state.params.critic_params, shard.next_obs)
    lr = linear_recurrence
    args = (shard.reward, 0.99 * (1.0 - shard.done.float()), shard.value, v_t,
            shard.truncated.float())
    got_gae = lr.truncated_gae(*args, float(config.system.gae_lambda))
    want_gae = lr.plain_truncated_gae(*args, float(config.system.gae_lambda))
    impact["b1_gae_bitwise"] = all(torch.equal(a, b) for a, b in zip(got_gae, want_gae))
    if not impact["b1_gae_bitwise"]:
        raise AssertionError("B1's GAE entry on the IMPACT step's inputs is not its plain version")
    return impact


def phase_sebulba_learn(oracle: str) -> None:
    """SEBULBA_ORACLES[oracle] learns IdentityGame above SEBULBA_THRESHOLD on
    the card, with no actor crash."""
    system, overrides = SEBULBA_ORACLES[oracle]
    module = _sebulba_module(system)
    start = time.perf_counter()
    final_return = module.run_experiment(compose(overrides, SEBULBA_ROOTS[system]),
                                         device="cuda")
    stats = _sebulba_stats(system)
    if not final_return > SEBULBA_THRESHOLD or stats["resilience"]["actor_crashes"]:
        raise AssertionError(f"Sebulba {system} returned {final_return} on IdentityGame "
                             f"(threshold {SEBULBA_THRESHOLD}), {stats['resilience']}")
    emit({"phase": f"{oracle}_learn", "system": system, "env": "identity_game",
          "final_return": final_return, "threshold": SEBULBA_THRESHOLD,
          "fps": stats.get("fps"), "seconds": time.perf_counter() - start})




# The learning oracles: phase name -> the phase. Each runs in a child process
# (`chip_smoke.py --learn-phase NAME`) after every timed phase, LEARN_WORKERS
# at a time, the longest first; together they were 70% of the run when they
# ran in turn (PERF.md, Findings).
# ---------------------------------------------------------------- gossip groups,
# the envpool adapter and the stateful evaluator, the ring's gradients

GOSSIP_ROOT = "default/gossip/default_ff_ppo.yaml"
GOSSIP_RANKS = 2  # phase gossip_train (b): two learner groups of one rank each
GOSSIP_OVERRIDES = [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
                    "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
                    "logger.use_console=False"]
GOSSIP_MEAN_TOLERANCE = 1e-6  # of each leaf's largest entry (at least 1)


@contextlib.contextmanager
def recorded_reduces():
    """Every `torch.distributed.all_reduce` inside the block, as the sorted
    global ranks of the group it reduced over."""
    ranks = []
    all_reduce = dist.all_reduce

    def recording(tensor, *args, group=None, **kwargs):
        ranks.append(tuple(sorted(dist.get_process_group_ranks(group or dist.group.WORLD))))
        return all_reduce(tensor, *args, group=group, **kwargs)

    dist.all_reduce = recording
    try:
        yield ranks
    finally:
        dist.all_reduce = all_reduce


def _host_params(params) -> dict:
    """An ActorCriticParams as one {side/name: host tensor} dict."""
    return {f"{side}/{k}": v.detach().cpu().clone() for side, tree in zip(("actor", "critic"), params)
            for k, v in tree.items()}


def _gossip_run(root: str, extra: list) -> dict:
    """One Anakin ff_ppo `run_experiment` on the card from `root` at
    GOSSIP_OVERRIDES, B1's counters zeroed just before and read just after:
    each window's params after the learn step and, where a round ran, after
    it; the ranks of every all-reduce; the runner's stats."""
    lr = linear_recurrence
    config = compose(GOSSIP_OVERRIDES + extra, root)
    learned, mixed = [], []
    setup_fn = ff_ppo.learner_setup

    def recording_setup(*args, **kwargs):
        setup = setup_fn(*args, **kwargs)
        learn = setup.learn

        def recorded_learn(state):
            out = learn(state)
            learned.append(_host_params(out.learner_state.params))
            return out

        plan = setup.gossip
        if plan is not None and plan.step is not None:
            step = plan.step

            def recorded_step(state, round_idx):
                out = step(state, round_idx)
                mixed.append(_host_params(out.params))
                return out

            plan = plan._replace(step=recorded_step)
        return setup._replace(learn=recorded_learn, gossip=plan)

    for counter in lr.COUNTERS:
        counter.launches = 0
    before = _allreduces()
    ff_ppo.learner_setup = recording_setup
    try:
        with recorded_reduces() as reduces:
            start = time.perf_counter()
            final_return = ff_ppo.run_experiment(config, device="cuda")
            seconds = time.perf_counter() - start
    finally:
        ff_ppo.learner_setup = setup_fn
    stats = copy.deepcopy({k: v for k, v in runner.LAST_RUN_STATS.items() if k != "history"})
    if not math.isfinite(final_return):
        raise AssertionError(f"{root} {extra}: non-finite eval return {final_return}")
    updates = int(config.arch.num_updates)
    return {"learned": learned, "mixed": mixed, "b1_launches": _counts(lr.COUNTERS),
            "reduce_ranks": sorted(set(reduces)), "updates": updates, "stats": stats,
            "allreduces_per_update": {k: (v - before[k]) / updates
                                      for k, v in _allreduces().items()},
            "expected_gradient_allreduces_per_update":
                int(config.system.epochs) * int(config.system.num_minibatches),
            "final_eval_return": final_return, "seconds": seconds}


def _check_b1_per_update(label: str, run: dict) -> None:
    lr = linear_recurrence
    want = {lr.GAE_KERNEL.name: run["updates"], lr.KERNEL.name: 0}
    if run["b1_launches"] != want:
        raise AssertionError(f"{label}: B1 launched {run['b1_launches']} in {run['updates']} "
                             "updates, not one GAE launch each")


def gossip_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of phase gossip_train's case (b) (`--gossip-rank`): both
    ranks on the one card in a gloo group (NCCL refuses two ranks on one
    device), one learner group each; its record to `out` (JSON) and its
    params to `out`.pt."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        run = _gossip_run(GOSSIP_ROOT, [f"arch.mesh.group={world}"])
        run["backend"] = dist.get_backend()
        run["rank"] = dist.get_rank()
    finally:
        dist.destroy_process_group()
    torch.save({"learned": run.pop("learned"), "mixed": run.pop("mixed")}, out + ".pt")
    with open(out, "w") as f:
        json.dump(run, f)


def phase_gossip_train(smi: str) -> dict:
    """Gossip-grouped Anakin ff_ppo at default/gossip/default_ff_ppo.yaml's
    full width (CartPole, 1024 envs a group, T = 16, 4 x 4 minibatches, MLP
    256 x 256, pallas), MAIN_UPDATES updates in 2 windows: (a) one group is
    every leaf of every window bitwise the plain run, no round; (b) two
    groups as two ranks on the card, ring, w = 0.5. Returns B1's launches by
    case."""
    plain = _gossip_run(PPO_ROOT, [])
    one = _gossip_run(GOSSIP_ROOT, [])
    for label, run in (("plain", plain), ("group=1", one)):
        _check_b1_per_update(f"gossip_train (a) {label}", run)
    if one["mixed"] or one["stats"]["gossip"]["rounds"] != 0:
        raise AssertionError(f"one group dispatched a round: {one['stats']['gossip']}")
    compared = 0
    for window, (a, b) in enumerate(zip(plain["learned"], one["learned"])):
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"gossip group=1 differs from the plain run at window {window}")
        compared += len(a)
    emit({"phase": "gossip_train", "case": "a", "groups": 1,
          "windows": len(one["learned"]), "bitwise_equal_leaves": compared,
          "b1_launches": one["b1_launches"], "gossip": one["stats"]["gossip"],
          "env_steps_per_second": one["stats"]["steps_per_second"],
          "plain_env_steps_per_second": plain["stats"]["steps_per_second"],
          "seconds": one["seconds"], "card": smi})

    with tempfile.TemporaryDirectory() as tmp:
        outs = run_rank_children("--gossip-rank", GOSSIP_RANKS, [], tmp)
        records, params = [], []
        for out in outs:
            with open(out) as f:
                records.append(json.load(f))
            params.append(torch.load(out + ".pt", weights_only=True))
    windows = len(params[0]["learned"])
    per_update = records[0]["expected_gradient_allreduces_per_update"]
    worst_mean = 0.0
    for record in records:
        rank = record["rank"]
        _check_b1_per_update(f"gossip_train (b) rank {rank}", record)
        gossip = record["stats"]["gossip"]
        if gossip["rounds"] != windows or gossip["num_groups"] != GOSSIP_RANKS:
            raise AssertionError(f"rank {rank}: {gossip} over {windows} windows")
        # Each rank is a group of one: every all-reduce stays on it, the
        # gradients' one a minibatch.
        if record["reduce_ranks"] != [[rank]] or \
                record["allreduces_per_update"]["gradients"] != per_update:
            raise AssertionError(f"rank {rank}: all-reduces over {record['reduce_ranks']}, "
                                 f"{record['allreduces_per_update']} an update, not {per_update} "
                                 "gradient all-reduces on its own group")
    for window in range(windows):
        pre = [p["learned"][window] for p in params]
        post = [p["mixed"][window] for p in params]
        if all(torch.equal(pre[0][k], pre[1][k]) for k in pre[0]):
            raise AssertionError(f"the groups' params are equal before round {window}")
        for k in pre[0]:
            scale = max(1.0, float(pre[0][k].abs().max()), float(pre[1][k].abs().max()))
            err = float(((post[0][k] + post[1][k]) / 2 - (pre[0][k] + pre[1][k]) / 2)
                        .abs().max()) / scale
            worst_mean = max(worst_mean, err)
    if not worst_mean <= GOSSIP_MEAN_TOLERANCE:
        raise AssertionError(f"a round moved the group mean by {worst_mean}")
    sps = [r["stats"]["steps_per_second"] for r in records]
    gossip_s = [r["stats"]["phase_breakdown"]["gossip_s"] for r in records]
    emit({"phase": "gossip_train", "case": "b", "groups": GOSSIP_RANKS, "backend": "gloo",
          "cards": torch.cuda.device_count(), "topology": "ring", "mixing_weight": 0.5,
          "windows": windows, "rounds": [r["stats"]["gossip"]["rounds"] for r in records],
          "b1_gae_launches_per_rank": [r["b1_launches"][linear_recurrence.GAE_KERNEL.name]
                                       for r in records],
          "allreduces_per_update": records[0]["allreduces_per_update"],
          "allreduce_groups_per_rank": [r["reduce_ranks"] for r in records],
          "group_mean_max_relative_change": worst_mean, "tolerance": GOSSIP_MEAN_TOLERANCE,
          "env_steps_per_second_per_group": sps,
          "env_steps_per_second_total": [sum(w) for w in zip(*sps)],
          "gossip_step_ms_per_rank": [1e3 * g / windows for g in gossip_s],
          "window_seconds": [r["stats"]["window_seconds"] for r in records],
          "final_eval_return": records[0]["final_eval_return"],
          "seconds": [r["seconds"] for r in records], "card": smi})
    gae = linear_recurrence.GAE_KERNEL.name
    return {"a_group_1": one["b1_launches"][gae],
            "b_per_rank": [r["b1_launches"][gae] for r in records]}


class AtariDoublePool:
    """A pool with envpool's surface (gymnasium API with
    `gym_reset_return_info`, partial steps by env ids,
    `spec.config.max_episode_steps`, `info["elapsed_step"]`,
    `info["lives"]`), vectorised in numpy: envpool's autoreset (the step
    after a done resets the env and advances nothing), LIVES lives, each
    life ending with probability DEATH a step from a seeded generator,
    elapsed steps counted a life, +1 reward a step. Observations are frames
    of `obs_shape` whose values encode (env, game, step in life)."""

    LIVES, DEATH, MAX_STEPS, ACTIONS = 3, 0.05, 64, 4

    def __init__(self, num_envs: int, obs_shape=(84, 84, 4), seed: int = 0):
        class Spec:
            class config:
                max_episode_steps = AtariDoublePool.MAX_STEPS

        class ActionSpace:
            n = AtariDoublePool.ACTIONS

        self.spec, self.action_space = Spec(), ActionSpace()
        self._n, self._shape = num_envs, tuple(obs_shape)
        self._rng = np.random.default_rng(seed)
        self._game = np.zeros(num_envs, np.int64)
        self._life_step = np.zeros(num_envs, np.int64)
        self._elapsed = np.zeros(num_envs, np.int64)
        self._lives = np.full(num_envs, self.LIVES, np.int64)
        self._needs_reset = np.zeros(num_envs, bool)
        self.steps = 0  # whole-pool steps
        self.truncations = 0  # lives cut at the step limit

    def _obs(self, ids):
        value = (np.arange(self._n)[ids] * 7 + self._game[ids] * 31 + self._life_step[ids]) % 256
        return np.broadcast_to(value[:, None].astype(np.float32),
                               (len(ids), int(np.prod(self._shape)))
                               ).reshape((len(ids),) + self._shape).copy()

    def reset(self):
        self._game[:] = 0
        self._life_step[:] = 0
        self._elapsed[:] = 0
        self._lives[:] = self.LIVES
        self._needs_reset[:] = False
        return self._obs(np.arange(self._n)), {}

    def step(self, action, env_ids=None):
        ids = np.arange(self._n) if env_ids is None else np.asarray(env_ids)
        self.steps += env_ids is None
        resetting = self._needs_reset[ids]
        moving = ids[~resetting]
        restart = ids[resetting]
        self._needs_reset[restart] = False
        self._life_step[restart] = 0
        self._elapsed[restart] = 0
        over = restart[self._lives[restart] <= 0]
        self._lives[over] = self.LIVES
        self._game[over] += 1
        self._life_step[moving] += 1
        self._elapsed[moving] += 1
        reward = np.where(resetting, 0.0, 1.0).astype(np.float32)
        dies = np.zeros(len(ids), bool)
        dies[~resetting] = self._rng.random(len(moving)) < self.DEATH
        self._lives[ids[dies]] -= 1
        self._needs_reset[ids[dies]] = True
        limit = ~dies & ~resetting & (self._elapsed[ids] >= self.MAX_STEPS)
        self._needs_reset[ids[limit]] = True
        self.truncations += int(limit.sum())
        info = {"elapsed_step": self._elapsed[ids].copy(), "lives": self._lives[ids].copy(),
                "reward": reward.copy()}
        return self._obs(ids), reward, dies, np.zeros(len(ids), bool), info

    def close(self):
        pass


@contextlib.contextmanager
def envpool_double(obs_shape):
    """Sebulba's env factory replaced by `EnvPoolAdapter`s over
    AtariDoublePools of `obs_shape`, and its stateful evaluator recorded:
    yields {"pools": every pool made, "evaluations": [(episodes, nan, host
    steps)]}."""
    from stoix_tpu_torch.envs.envpool_adapter import EnvPoolAdapter
    from stoix_tpu_torch.envs.factory import EnvFactory
    from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo as sebulba_ppo
    from stoix_tpu_torch.systems.q_learning.sebulba import ff_dqn as sebulba_dqn

    seen = {"pools": [], "evaluations": []}

    class DoubleFactory(EnvFactory):
        def __call__(self, num_envs: int):
            pool = AtariDoublePool(num_envs, obs_shape, seed=self._next_seed(num_envs))
            seen["pools"].append(pool)
            return EnvPoolAdapter(pool)

    stateful = sebulba_ppo.get_stateful_evaluator_fn

    def recorded_stateful(env_factory, act_fn, config, device="cpu"):
        pools = []

        def factory(num_envs):
            adapter = env_factory(num_envs)
            pools.append(adapter._env)
            return adapter

        evaluate = stateful(factory, act_fn, config, device)

        def evaluator(params, generator):
            before = pools[0].steps
            metrics = evaluate(params, generator)
            returns = metrics["episode_return"]
            seen["evaluations"].append((int(returns.numel()), bool(torch.isnan(returns).any()),
                                        pools[0].steps - before))
            return metrics

        return evaluator

    patched = [(sebulba_ppo, "make_factory"), (sebulba_dqn, "make_factory"),
               (sebulba_ppo, "get_stateful_evaluator_fn")]
    saved = [getattr(module, name) for module, name in patched]
    sebulba_ppo.make_factory = sebulba_dqn.make_factory = lambda config: DoubleFactory(
        "envpool-double", int(config.arch.seed))
    sebulba_ppo.get_stateful_evaluator_fn = recorded_stateful
    try:
        yield seen
    finally:
        for (module, name), value in zip(patched, saved):
            setattr(module, name, value)


def phase_sebulba_adapters(smi: str) -> dict:
    """Sebulba ff_ppo with cnn_atari through `EnvPoolAdapter` on an
    in-script pool with envpool's surface (84x84x4 frames, lives,
    elapsed_step truncation, partial steps by env ids), at
    phase_sebulba_pixel's shape (128 envs in 2 actors, T = 32), 4 updates in
    2 windows: one GAE launch an update; its task id (Breakout-v5) has no
    tensor-env twin, so it evaluates through `get_stateful_evaluator_fn`.
    Then Sebulba ff_dqn (default_ff_dqn.yaml's MLP) on the pool's 128-byte
    RAM observations (Breakout-ram-v5), one window. Returns each run's
    kernel launches."""
    from stoix_tpu_torch.envs.registry import ENV_REGISTRY

    launches = {}
    for label, obs_shape in (("ff_ppo_envpool", (84, 84, 4)), ("ff_dqn_envpool", (128,))):
        scenario = next(o.split("=")[1] for o in SEBULBA_PATHS[label][1]
                        if o.startswith("env.scenario.name="))
        if scenario in ENV_REGISTRY:
            raise AssertionError(f"{scenario} has a tensor-env twin")
        with envpool_double(obs_shape) as seen:
            record = _sebulba_run(label, "sebulba_adapters", smi)
        evaluations = seen["evaluations"]
        episodes = int(compose(SEBULBA_COMMON).arch.num_eval_episodes)
        if not evaluations or any(n != episodes or nan for n, nan, _ in evaluations):
            raise AssertionError(f"{label}: the stateful evaluator gave {evaluations}, not "
                                 f"{episodes} concluded episodes each time")
        emit({**record, "adapter": "EnvPoolAdapter", "obs_shape": list(obs_shape),
              "evaluator": "get_stateful_evaluator_fn",
              "evaluations": [{"episodes": n, "host_steps": steps}
                              for n, _, steps in evaluations],
              "pools": len(seen["pools"]),
              "truncations": sum(p.truncations for p in seen["pools"])})
        launches[label] = record["kernel_launches"]
    return launches


RING_GRAD_TOLERANCE = 1e-5  # of each gradient's largest entry; the output 2e-5


def phase_ring_grad(smi: str, mesh) -> None:
    """C27 on the card: a one-rank NCCL ring's forward and q, k, v gradients
    of sum(out * w) on card-drawn inputs [64, 512, 4, 32] (RING_BATCH, the
    ring phases' window), causal and not, against float64 full attention on
    the host; `use_flash=True` under grad refused (C5); the ring's forward
    and backward timed beside full attention's. Then the tensor-parallel
    block on one model shard (256 -> 1024 -> 256 over 4096 rows) against
    `reference_block`, forward and gradients."""
    from stoix_tpu_torch.parallel import tp

    group = mesh.get_group("data")
    b, s, h, d = RING_BATCH, 512, 4, 32
    gen = torch.Generator(device="cuda").manual_seed(21)
    for causal in (False, True):
        q, k, v, w = (torch.randn((b, s, h, d), generator=gen, device="cuda") for _ in range(4))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = ring_attention(*leaves, group, causal=causal)
        (out * w).sum().backward()
        ref = [x.detach().cpu().double().requires_grad_(True) for x in (q, k, v)]
        want = full_attention(*ref, causal=causal)
        (want * w.cpu().double()).sum().backward()
        out_err = float((out.detach().cpu().double() - want.detach()).abs().max())
        grad_err = {name: float((x.grad.cpu().double() - r.grad).abs().max()
                                / r.grad.abs().max())
                    for name, x, r in zip(("dq", "dk", "dv"), leaves, ref)}
        if not out_err <= 2e-5 or not max(grad_err.values()) <= RING_GRAD_TOLERANCE:
            raise AssertionError(f"ring gradients (causal={causal}): output {out_err}, "
                                 f"{grad_err}")

        def ring_step(fn):
            def run():
                for x in leaves:
                    x.grad = None
                (fn(*leaves) * w).sum().backward()
            return run

        times = {"ring_forward_backward_ms": cuda_ms(ring_step(
                     lambda *x: ring_attention(*x, group, causal=causal)), repeats=5, inner=5),
                 "full_attention_forward_backward_ms": cuda_ms(ring_step(
                     lambda *x: full_attention(*x, causal=causal)), repeats=5, inner=5)}
        emit({"phase": "ring_grad", "shape": [b, s, h, d], "causal": causal, "ranks": 1,
              "backend": "nccl", "output_max_abs_err": out_err,
              "gradient_max_err_relative_to_largest": grad_err,
              "tolerance": RING_GRAD_TOLERANCE, **times, "card": smi})
    try:
        ring_attention(*leaves, group, causal=True, use_flash=True)
        raise AssertionError("use_flash=True under grad was not refused")
    except NotImplementedError as error:
        if "C5" not in str(error):
            raise

    params = tp.init_column_row_params(torch.Generator(device="cuda").manual_seed(3), 256,
                                       1024, 256, num_shards=1)
    x = torch.randn((4096, 256), generator=gen, device="cuda")
    shard = tp.ColumnRowParams(*(p.clone().requires_grad_(True)
                                 for p in tp.shard_params(params, 0)))
    full = tp.ColumnRowParams(*(p.clone().requires_grad_(True) for p in params))
    got = tp.column_row_block(shard, x, group)
    want = tp.reference_block(full, x)
    (got ** 2).mean().backward()
    (want ** 2).mean().backward()
    errs = {"forward": float((got - want).detach().abs().max()),
            **{name: float((a.grad - b.grad).abs().max())
               for name, a, b in zip(tp.ColumnRowParams._fields, shard, full)}}
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"the one-shard block differs from reference_block: {errs}")
    emit({"phase": "ring_grad", "case": "tp_block_one_shard", "shape": [4096, 256, 1024, 256],
          "max_abs_err": errs, "card": smi})


OPS_SWITCHES = ["arch.preflight.enabled=true", "arch.integrity.enabled=true",
                "arch.integrity.determinism_probe_interval=1", "logger.telemetry.enabled=true"]
OPS_COMMON = [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
              "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
              "system.update_guard=skip", "logger.use_console=False",
              "logger.checkpointing.save_model=true",
              "logger.checkpointing.save_args.max_to_keep=~"]
OPS_STEP = int(MAIN_UPDATES // 2) * 16 * 1024  # env steps a window at the default width
OPS_GROUPS = ("params/", "opt_states/", "obs_stats/", "kl_beta")


def _ops_run(uid: str, extra: list) -> dict:
    """ff_ppo at full width (OPS_COMMON) in the working directory; B1's
    counters zeroed just before and read just after."""
    lr = linear_recurrence
    config = compose(OPS_COMMON + [f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                                   f"logger.base_exp_path={os.getcwd()}/results_{uid}",
                                   *extra])
    for counter in lr.COUNTERS:
        counter.launches = 0
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    if not math.isfinite(final_return):
        raise AssertionError(f"{uid}: non-finite eval return {final_return}")
    return {"b1": _counts(lr.COUNTERS), "stats": copy.deepcopy(runner.LAST_RUN_STATS),
            "seconds": seconds, "final_return": final_return}


def _ops_state(uid: str, step: int) -> dict:
    from stoix_tpu_torch.utils import checkpointing

    return torch.load(os.path.join("checkpoints", uid, "ff_ppo", str(step),
                                   checkpointing.STATE_FILE), weights_only=True)


def _differ(got: dict, want: dict) -> list:
    """The keys of two saved states whose values differ (a generator's by its
    state), or the keys one lacks."""
    if got.keys() != want.keys():
        return sorted(set(got) ^ set(want))
    return [key for key, value in want.items() if not (
        torch.equal(value, got[key]) if isinstance(value, torch.Tensor) else
        torch.equal(value["generator_state"], got[key]["generator_state"])
        if isinstance(value, dict) else value == got[key])]


def _fingerprint_on_card_and_cpu(saved: dict) -> dict:
    """The replicated groups of a saved state fingerprinted on the card and
    on the CPU (bitwise equal), and one fingerprint pass timed and its
    launches counted on the card."""
    from stoix_tpu_torch.resilience import integrity

    groups = {}
    for key, value in saved.items():
        if key.startswith(OPS_GROUPS) and isinstance(value, torch.Tensor):
            groups.setdefault(key.split("/")[0], {})[key] = value
    cpu = integrity.Fingerprinter(groups)
    card_state = tree_map(lambda x: x.cuda(), groups)
    card = integrity.Fingerprinter(card_state)
    got, want = card(card_state), cpu(groups)
    if got != want:
        raise AssertionError(f"fingerprints differ: card {got}, CPU {want}")
    torch.cuda.synchronize()
    # None when the profiler sees no device event (not measured), never 0.
    launches = _device_launches_of(lambda: card(card_state)) or None
    times = []
    for _ in range(5):
        start = time.perf_counter()
        card(card_state)
        times.append((time.perf_counter() - start) * 1e3)
    return {"groups": sorted(got), "card_equals_cpu": True,
            "bytes": sum(card.sizes), "launches_a_pass": launches,
            "ms_a_pass": statistics.median(times)}


def phase_ops_train(smi: str) -> dict:
    """A19a on the main path: ff_ppo at the default config's full width,
    MAIN_UPDATES updates in 2 windows, with every switch of the operations
    layer on (preflight with its probe child, the integrity sentinel with the
    determinism probe every window, telemetry, checkpointing, update_guard
    skip) and then with every switch off: the two final states bitwise
    equal, B1's GAE launches one an update (the probe's replay adds its
    window's), `trace.json` and `metrics.prom` valid, the probe clean; the
    fingerprint of the card's state equals the CPU's. Returns B1's launches
    of both runs and what ops_faults reuses."""
    from stoix_tpu_torch.observability import validate_chrome_trace

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ops_")
    with contextlib.chdir(tmp):
        off = _ops_run("ops_off", [])
        on = _ops_run("ops_on", OPS_SWITCHES)
        final = MAIN_UPDATES * 16 * 1024
        differ = _differ(_ops_state("ops_on", final), _ops_state("ops_off", final))
        if differ:
            raise AssertionError(f"switches on and off end in different states at {differ[:5]}")
        stats = on["stats"]
        probe_runs = stats["integrity"]["probe_runs"]
        gae = linear_recurrence.GAE_KERNEL.name
        if off["b1"][gae] != MAIN_UPDATES or on["b1"][gae] != MAIN_UPDATES + probe_runs * (
                MAIN_UPDATES // 2) or probe_runs != 1:
            raise AssertionError(f"B1 GAE launches off {off['b1']}, on {on['b1']} with "
                                 f"{probe_runs} probe replays")
        (telemetry,) = glob.glob(os.path.join(tmp, "results_ops_on", "**", "telemetry"),
                                 recursive=True)
        with open(os.path.join(telemetry, "trace.json")) as f:
            trace = json.load(f)
        problems = validate_chrome_trace(trace)
        prom = open(os.path.join(telemetry, "metrics.prom")).read()
        if problems or "# TYPE stoix_tpu_goodput_seconds_total counter" not in prom or (
                "stoix_tpu_device_memory_bytes{" not in prom):
            raise AssertionError(f"telemetry files: {problems[:3]}, prom {prom[:300]}")
        fingerprint = _fingerprint_on_card_and_cpu(_ops_state("ops_on", final))
        preflight_stats = stats["preflight"]
        checks = stats["integrity"]["fingerprint_checks"]
    record = {
        "phase": "ops_train", "env": "cartpole", "total_num_envs": 1024, "updates": MAIN_UPDATES,
        "switches": OPS_SWITCHES, "states_bitwise_equal": True,
        "b1_gae_launches": {"on": on["b1"][gae], "off": off["b1"][gae]},
        "env_steps_per_second": {"on": stats["steps_per_second"],
                                 "off": off["stats"]["steps_per_second"]},
        "window_seconds": {"on": stats["window_seconds"],
                           "off": off["stats"]["window_seconds"]},
        "run_seconds": {"on": on["seconds"], "off": off["seconds"]},
        "probe_child_seconds": preflight_stats["probe"]["elapsed_s"],
        "probe": preflight_stats["probe"],
        "first_compile_s": preflight_stats["first_compile_s"],
        "integrity": stats["integrity"],
        "fingerprint_ms_per_window": stats["integrity"]["overhead_s"] * 1e3 / max(1, checks),
        "fingerprint": fingerprint,
        "memory_gate": preflight_stats["memory"],
        "goodput": {k: stats["goodput"][k] for k in ("fraction", "stall_s", "recovery_s")},
        "trace_events": len(trace["traceEvents"]), "card": smi}
    emit(record)
    return {"b1": record["b1_gae_launches"], "tmp": tmp, "probe": preflight_stats["probe"]}


def ops_child(kind: str, tmp: str, out: str, rank: int = 0) -> None:
    """One child of ops_faults (`--ops-child KIND TMP OUT [RANK]`), in TMP:
    `sigterm` runs the main path with `sigterm:0` and saves its stats to OUT
    (exit 0); `bitflip` is rank RANK of two gloo ranks on the one card under
    `bitflip:1` (the sentinel's excepthook exits 88)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.chdir(tmp)
    if kind == "sigterm":
        _ops_run("ops_sigterm", ["arch.fault_spec=sigterm:0",
                                 "logger.checkpointing.save_args.save_interval_steps=1000000"])
        with open(out, "w") as f:
            json.dump({"resilience": runner.LAST_RUN_STATS["resilience"]}, f)
        return
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=2, rank=rank)
    _ops_run("ops_bitflip", ["arch.integrity.enabled=true", "arch.num_eval_episodes=4",
                             "arch.fault_spec=bitflip:1"])


def _ops_children(tmp: str) -> dict:
    """The sigterm child and the two bitflip ranks, started together."""
    procs = {}
    for name, args in (("sigterm", ["sigterm", os.path.join(tmp, "sigterm"), "sigterm.json"]),
                       *((f"bitflip{r}", ["bitflip", os.path.join(tmp, "bitflip"),
                                          f"bitflip{r}.json", str(r)]) for r in range(2))):
        os.makedirs(args[1], exist_ok=True)
        log = open(os.path.join(tmp, f"{name}.log"), "w+")
        args[2] = os.path.join(tmp, args[2])
        procs[name] = (subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                         "--ops-child", *args],
                                        stdout=log, stderr=subprocess.STDOUT), log)
    return procs


def _ops_wait(procs: dict, timeout: float = 240.0) -> dict:
    deadline = time.monotonic() + timeout
    codes, logs = {}, {}
    try:
        for name, (proc, log) in procs.items():
            codes[name] = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            log.seek(0)
            logs[name] = log.read()
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            log.close()
    return {"codes": codes, "logs": logs}


def phase_ops_faults(smi: str, ops: dict) -> None:
    """The Anakin faults on the card, each where its path ends: a child
    under `sigterm:0` exits 0 with its emergency checkpoint, and a run
    resumed from it ends bitwise in the unbroken run's state; two gloo ranks
    under `bitflip:1` exit 88 with the quarantine file and no checkpoint of
    the flipped window; in this process `nan_loss` under skip (one skip,
    finite params), `backend_wedge` (BackendUnavailableError within its
    deadline), `slow_compile` (CompileStallError at the first_compile
    watchdog) and `ckpt_corrupt` (the restore falls back past the step, with
    its reason)."""
    from stoix_tpu_torch.resilience import (
        BackendUnavailableError, CompileStallError, faultinject, preflight,
    )
    from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_STATE_CORRUPTION
    from stoix_tpu_torch.utils import checkpointing

    tmp = ops["tmp"]
    start = time.perf_counter()
    procs = _ops_children(tmp)
    record = {"phase": "ops_faults", "card": smi}
    with contextlib.chdir(tmp):
        # nan_loss:1 (the second minibatch step) under skip: one update.
        _ops_run("ops_nan", ["arch.fault_spec=nan_loss:1", f"arch.num_updates={MAIN_UPDATES // 2}",
                             "arch.num_evaluation=1"])
        skipped = runner.LAST_RUN_STATS["resilience"]["skipped_updates"]
        state = _ops_state("ops_nan", OPS_STEP)
        finite = all(bool(torch.isfinite(v).all()) for k, v in state.items()
                     if k.startswith("params/"))
        if skipped != 1.0 or not finite:
            raise AssertionError(f"nan_loss under skip: {skipped} skipped, finite {finite}")
        record["nan_loss"] = {"skipped_updates": skipped, "params_finite": finite}
        # backend_wedge: every probe child sleeps; two attempts of 3 s.
        faultinject.configure("backend_wedge")
        began = time.perf_counter()
        try:
            preflight.probe_backend(timeout_s=3.0, attempts=2, backoff_base_s=0.5)
            raise AssertionError("backend_wedge: the probe answered")
        except BackendUnavailableError as error:
            wedge = {"seconds": time.perf_counter() - began, "attempts": error.attempts}
        finally:
            faultinject.reset()
        if wedge["seconds"] > 3.0 * 2 + 0.5 + 5.0:
            raise AssertionError(f"backend_wedge took {wedge['seconds']} s")
        record["backend_wedge"] = wedge
        # slow_compile:30 against a 1 s first-compile deadline (this run's
        # probe stands in for a second probe child).
        probe_backend = preflight.probe_backend
        preflight.probe_backend = lambda **kwargs: preflight.BackendProbe(**ops["probe"])
        began = time.perf_counter()
        try:
            _ops_run("ops_slow", ["arch.fault_spec=slow_compile:30", "arch.preflight.enabled=true",
                                  "arch.preflight.compile_deadline_s=1.0"])
            raise AssertionError("slow_compile: the run finished")
        except CompileStallError as error:
            record["slow_compile"] = {"seconds": time.perf_counter() - began,
                                      "stage": error.stage}
        finally:
            preflight.probe_backend = probe_backend
        if record["slow_compile"]["seconds"] > 20.0:
            raise AssertionError(f"slow_compile: {record['slow_compile']}")
        # ckpt_corrupt on a card state's newest step.
        saver = checkpointing.Checkpointer("corrupt", rel_dir="checkpoints", checkpoint_uid="c",
                                           max_to_keep=None)
        saver.save(1, {"w": torch.ones(4, device="cuda")})
        faultinject.configure("ckpt_corrupt")
        saver.save(2, {"w": torch.full((4,), 2.0, device="cuda")})
        faultinject.reset()
        restored, step = saver.restore({"w": torch.zeros(4, device="cuda")})
        if step != 1 or not torch.equal(restored["w"], torch.ones(4, device="cuda")):
            raise AssertionError(f"ckpt_corrupt: restored step {step}")
        record["ckpt_corrupt"] = {"restored_step": step, "report": saver.last_restore_report}

        children = _ops_wait(procs)
        codes = children["codes"]
        if codes != {"sigterm": 0, "bitflip0": EXIT_CODE_STATE_CORRUPTION,
                     "bitflip1": EXIT_CODE_STATE_CORRUPTION}:
            raise AssertionError(f"ops children exited {codes}:\n" + "\n".join(
                f"--- {k} ---\n{v[-4000:]}" for k, v in children["logs"].items()))
        with open(os.path.join(tmp, "sigterm.json")) as f:
            sigterm = json.load(f)["resilience"]
        # The resume: one more window from the child's emergency checkpoint.
        with contextlib.chdir(os.path.join(tmp, "sigterm")):
            _ops_run("ops_resumed", [f"arch.num_updates={MAIN_UPDATES // 2}",
                                     "arch.num_evaluation=1",
                                     "logger.checkpointing.load_model=true",
                                     "logger.checkpointing.load_args.checkpoint_uid=ops_sigterm"])
            restored_step = runner.LAST_RUN_STATS["resilience"]["restored_step"]
            resumed = _ops_state("ops_resumed", 2 * OPS_STEP)
        differ = _differ(resumed, _ops_state("ops_off", 2 * OPS_STEP))
        if not sigterm["preempted"] or restored_step != OPS_STEP or differ:
            raise AssertionError(f"sigterm: preempted {sigterm['preempted']}, restored "
                                 f"{restored_step}, differing {differ[:5]}")
        record["sigterm"] = {"child_exit": codes["sigterm"], "preempted": True,
                             "restored_step": restored_step, "resume_bitwise": True}
        bitflip = os.path.join(tmp, "bitflip", "checkpoints")
        with open(os.path.join(bitflip, "quarantine.json")) as f:
            quarantine = json.load(f)
        (entry,) = quarantine["quarantined"]
        steps = sorted(int(d) for d in os.listdir(os.path.join(bitflip, "ops_bitflip", "ff_ppo"))
                       if d.isdigit())
        if (entry["kind"], entry["window"], entry["devices"]) != (
                "replica_mismatch", 1, [0, 1]) or steps != [OPS_STEP] or not os.path.isfile(
                os.path.join(bitflip, "flight_record.json")):
            raise AssertionError(f"bitflip: {entry}, saved steps {steps}")
        record["bitflip"] = {"exit_codes": [codes["bitflip0"], codes["bitflip1"]],
                             "quarantine": {k: entry[k] for k in ("kind", "window", "groups",
                                                                  "devices")},
                             "saved_steps": steps}
    record["seconds"] = time.perf_counter() - start
    emit(record)


FLEET_RANKS = 2
FLEET_COMMON = [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
                "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
                "logger.use_console=False", "logger.checkpointing.save_model=true",
                "logger.checkpointing.save_args.max_to_keep=~"]
# The fleet and the ops plane as the drills run them: beats every 0.5 s, a
# peer deadline no healthy run comes near, the fleet's metrics published every
# 0.5 s so /metrics/fleet shows both ranks within a short run.
FLEET_ON = ["arch.fleet.enabled=true", "arch.fleet.heartbeat_interval_s=0.5",
            "arch.fleet.heartbeat_timeout_s=60", "arch.fleet.monitor_poll_s=0.5",
            "arch.fleet.exit_grace_s=5", "logger.telemetry.http.enabled=true",
            "logger.telemetry.http.aggregate_interval_s=0.5"]
# host_loss's: declared within the timeout and one poll of the freeze, the
# hard exit EXIT_GRACE after.
FLEET_TIMEOUT_S, FLEET_POLL_S, FLEET_GRACE_S = 3.0, 0.5, 2.0
FLEET_DEADLINES = [f"arch.fleet.heartbeat_timeout_s={FLEET_TIMEOUT_S}",
                   f"arch.fleet.monitor_poll_s={FLEET_POLL_S}",
                   f"arch.fleet.exit_grace_s={FLEET_GRACE_S}"]
FLEET_STEP = 16 * 1024  # env steps an update at the default width (both ranks)
FLEET_REPLICATED = ("params", "opt_states", "obs_stats", "kl_beta")


def free_port() -> int:
    with contextlib.closing(socket.socket()) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def port_is_free(port: int) -> bool:
    """Whether no process listens on `port` (connections of the ended run
    that linger in TIME_WAIT do not count)."""
    with contextlib.closing(socket.socket()) as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False


def _fleet_group(address: str, rank: int) -> list:
    """A fresh gloo group of the two ranks on the one card at `address`;
    the overrides naming it, which the fleet's store reads."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=address, world_size=FLEET_RANKS, rank=rank)
    return [f"arch.distributed.coordinator_address={address}",
            f"arch.distributed.num_processes={FLEET_RANKS}", f"arch.distributed.process_id={rank}"]


def _fleet_run(uid: str, extra: list, common: list = FLEET_COMMON) -> dict:
    """ff_ppo at full width in the working directory, B1's counters zeroed
    just before and read just after."""
    lr = linear_recurrence
    config = compose(common + [f"logger.checkpointing.save_args.checkpoint_uid={uid}", *extra])
    for counter in lr.COUNTERS:
        counter.launches = 0
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    if not math.isfinite(final_return):
        raise AssertionError(f"{uid}: non-finite eval return {final_return}")
    return {"b1": _counts(lr.COUNTERS), "stats": copy.deepcopy(runner.LAST_RUN_STATS),
            "seconds": seconds}


def _scrape_fleet(done: threading.Event, seen: dict) -> None:
    """Scrape this rank's /metrics/fleet and /healthz while its run is live."""
    import urllib.error
    import urllib.request

    from stoix_tpu_torch import observability

    while not done.wait(0.2):
        server = observability.get_ops_server()
        if server is None:
            continue
        for path in ("/metrics/fleet", "/healthz"):
            try:
                with urllib.request.urlopen(server.url + path, timeout=5) as response:
                    code, body = response.status, response.read().decode()
            except urllib.error.HTTPError as error:
                code, body = error.code, ""
            except OSError:
                continue
            seen.setdefault(path, []).append(code)
            if path == "/metrics/fleet" and code == 200:
                hosts = sorted(set(re.findall(r'host="(\d+)"', body)))
                if len(hosts) > len(seen.get("hosts", [])):
                    seen["hosts"] = hosts


def _replicated_of(state) -> dict:
    from stoix_tpu_torch.utils.checkpointing import flatten_state

    return {"/".join(p): leaf for p, leaf in flatten_state(state)
            if p[0] in FLEET_REPLICATED and isinstance(leaf, torch.Tensor)}


def _template_state(common: list, extra: list):
    """A fresh learner state of the main path's config on the card, built
    as the runner builds it (the template a restore fills)."""
    config = check_total_timesteps(compose(common + extra), parallel.process_count())
    env, _ = envs.make(config)
    seed = anakin.make_seeds(int(config.arch.seed), 2)[0]
    return ff_ppo.learner_setup(env, config, torch.device("cuda"), seed).learner_state


def _elastic_restore(store: str, uid: str, saved_file: str) -> dict:
    """The store's newest step restored through the checkpointer into this
    process's template (its world may differ from the saver's): the
    replicated leaves against `saved_file`'s, bitwise."""
    from stoix_tpu_torch.utils import checkpointing

    loader = checkpointing.Checkpointer("ff_ppo", rel_dir=store, checkpoint_uid=uid)
    step = max(loader.all_steps())
    saved = torch.load(os.path.join(loader.directory, str(step), saved_file), weights_only=True)
    restored, _ = loader.restore(_template_state(FLEET_COMMON, []))
    got = _replicated_of(restored)
    want = {k: v for k, v in saved.items() if k.split("/")[0] in FLEET_REPLICATED
            and isinstance(v, torch.Tensor)}
    differ = sorted(k for k in want if k not in got or not torch.equal(got[k].cpu(), want[k]))
    report = loader.last_elastic_restore
    if differ or report is None:
        raise AssertionError(f"elastic restore of {uid}: differing {differ[:5]}, report {report}")
    return {"step": step, "saved_world": report["saved_world"], "world": report["world"],
            "matched": report["matched"], "replicated_bitwise": len(want),
            "kept": sorted({e.split(" ")[0].split("/")[0] for e in report["reinitialized"]})}


def fleet_rank(kind: str, rank: int, address: str, tmp: str, out: str) -> None:
    """One rank of phase fleet_train or fleet_faults (`--fleet-rank KIND RANK
    ADDRESS TMP OUT`), both ranks on the one card in a gloo group (NCCL
    refuses two ranks on one device); its record to OUT."""
    from stoix_tpu_torch.observability import get_registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    os.chdir(tmp)
    record = {}
    if kind == "train":
        off = _fleet_run("fleet_off", _fleet_group(f"file://{tmp}/store_off", rank))
        seen: dict = {}
        done = threading.Event()
        scraper = threading.Thread(target=_scrape_fleet, args=(done, seen), daemon=True)
        scraper.start()
        try:
            on = _fleet_run("fleet_on", _fleet_group(address, rank) + FLEET_ON)
        finally:
            done.set()
            scraper.join(timeout=10)
        # Off again: the first run paid the process's first CUDA work, so on
        # is read beside this warm one.
        again = _fleet_run("fleet_off_again", _fleet_group(f"file://{tmp}/store_again", rank))
        record = {"off": {"b1": off["b1"], "sps": off["stats"]["steps_per_second"],
                          "seconds": off["seconds"]},
                  "off_again": {"b1": again["b1"], "sps": again["stats"]["steps_per_second"],
                                "seconds": again["seconds"]},
                  "on": {"b1": on["b1"], "sps": on["stats"]["steps_per_second"],
                         "seconds": on["seconds"], "rescue": on["stats"]["fleet_rescue"],
                         "resilience": on["stats"]["resilience"]},
                  "skew_ratio": get_registry().gauge(
                      "stoix_tpu_fleet_window_skew_ratio").value(),
                  "scrape": seen}
    elif kind == "sigterm":
        fault = ["arch.fault_spec=sigterm:0"] if rank == 1 else []
        run = _fleet_run("fleet_sigterm", _fleet_group(address, rank) + FLEET_ON + fault + [
            "arch.num_updates=3", "arch.num_evaluation=3",
            f"arch.fleet.emergency_dir={tmp}/emergency"])
        record = {"windows": len(run["stats"]["window_seconds"]),
                  "resilience": run["stats"]["resilience"]}
    elif kind == "host_loss":
        fault = ["arch.fault_spec=host_loss:2"] if rank == 1 else []
        _fleet_run("fleet_loss", _fleet_group(address, rank) + FLEET_ON + FLEET_DEADLINES
                   + fault + ["arch.num_updates=4", "arch.num_evaluation=4",
            f"arch.fleet.emergency_dir={tmp}/emergency"])
        raise AssertionError("host_loss:2 returned")
    elif kind == "shrink":
        _fleet_run("fleet_shrink", _fleet_group(address, rank) + FLEET_ON + [
            "arch.fault_spec=shrink:0", f"arch.fleet.emergency_dir={tmp}/emergency/r{rank}"])
        raise AssertionError("shrink:0 returned")
    elif kind == "restore":
        _fleet_group(address, rank)
        record = _elastic_restore(os.path.join(tmp, "checkpoints"), "fleet_relaunched",
                                  "state.pt")
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(record, f)


def _fleet_ranks(kind: str, address: str, tmp: str) -> list:
    """The two ranks of `kind`, started (a log each beside their record),
    each in a session of its own: a rank that host_loss stops must not leave
    a stopped member in this script's process group, which has no parent in
    its session (the script may run under `setsid`), or a kernel that sends
    an orphaned group with stopped members SIGHUP hangs this script up."""
    os.makedirs(tmp, exist_ok=True)
    ranks = []
    for rank in range(FLEET_RANKS):
        log = open(os.path.join(tmp, f"{kind}{rank}.log"), "w+")
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--fleet-rank", kind,
                                 str(rank), address, tmp, os.path.join(tmp, f"{kind}{rank}.json")],
                                stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        ranks.append((proc, log))
    return ranks


def _fleet_wait(ranks: list, timeout: float = 300.0) -> tuple:
    """Each rank's exit code and log; a rank past `timeout` is killed (a
    stopped one too) and reaped."""
    deadline = time.monotonic() + timeout
    codes, logs = [], []
    try:
        for proc, _ in ranks:
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for proc, log in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            codes.append(proc.returncode)
            log.seek(0)
            logs.append(log.read())
            log.close()
    return codes, logs


def _fleet_failed(kind: str, codes: list, logs: list) -> AssertionError:
    return AssertionError(f"{kind} ranks exited {codes}:\n" + "\n".join(
        f"--- rank {r} ---\n{log[-5000:]}" for r, log in enumerate(logs)))


def _process_stopped(pid: int) -> bool:
    with contextlib.suppress(OSError):
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] == "T"
    return False


def _no_fleet_child_left() -> None:
    left = []
    for pid in _children():
        with contextlib.suppress(OSError):
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if b"--fleet-rank" in f.read():
                    left.append(pid)
    if left:
        raise AssertionError(f"fleet children left running: {left}")


def phase_fleet_train(smi: str) -> dict:
    """A19b on the main path: two ranks on the card, fleet and HTTP off then
    on, the final states bitwise equal. Returns B1's launches by rank."""
    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    port = free_port()
    codes, logs = _fleet_wait(_fleet_ranks("train", f"tcp://127.0.0.1:{port}", tmp))
    if codes != [0, 0]:
        raise _fleet_failed("fleet_train", codes, logs)
    ranks = [json.load(open(os.path.join(tmp, f"train{r}.json"))) for r in range(FLEET_RANKS)]
    final = MAIN_UPDATES * FLEET_STEP
    from stoix_tpu_torch.utils import checkpointing

    differ = []
    for rank in range(FLEET_RANKS):
        name = checkpointing.state_file(rank, FLEET_RANKS)
        on, off, again = [torch.load(os.path.join(tmp, "checkpoints", uid, "ff_ppo", str(final),
                                                  name), weights_only=True)
                          for uid in ("fleet_on", "fleet_off", "fleet_off_again")]
        differ += [f"rank {rank}: {key}" for key in _differ(on, off) + _differ(again, off)]
    gae, generic = linear_recurrence.GAE_KERNEL.name, linear_recurrence.KERNEL.name
    runs = ("on", "off", "off_again")
    launches = {run: [r[run]["b1"][gae] for r in ranks] for run in runs}
    scrape = [r["scrape"] for r in ranks]
    if differ or any(n != MAIN_UPDATES for run in launches.values() for n in run) or any(
            r[run]["b1"][generic] for r in ranks for run in runs):
        raise AssertionError(f"fleet_train: differing {differ[:5]}, B1 GAE launches {launches}")
    if any(s.get("hosts") != ["0", "1"] or set(s.get("/healthz", [])) != {200} for s in scrape):
        raise AssertionError(f"fleet_train: the live scrape saw {scrape}")
    if not port_is_free(port):
        raise AssertionError(f"fleet_train: the store's port {port} is still bound")
    record = {
        "phase": "fleet_train", "env": "cartpole", "total_num_envs": 1024, "ranks": FLEET_RANKS,
        "updates": MAIN_UPDATES, "states_bitwise_equal": True, "b1_gae_launches": launches,
        "env_steps_per_second": {run: [r[run]["sps"] for r in ranks] for run in runs},
        "run_seconds": {run: [r[run]["seconds"] for r in ranks] for run in runs},
        "host_copy_ms_per_window": [r["on"]["rescue"]["copy_ms"] for r in ranks],
        "host_copy_bytes": ranks[0]["on"]["rescue"]["bytes"],
        "skew_ratio": [r["skew_ratio"] for r in ranks],
        "scrape": {"hosts": scrape[0]["hosts"], "metrics_fleet_codes": sorted(
            set(scrape[0]["/metrics/fleet"])), "healthz_scrapes": [len(s["/healthz"])
                                                                    for s in scrape]},
        "seconds": time.perf_counter() - start, "card": smi}
    emit(record)
    return {"b1": launches}


def phase_fleet_faults(smi: str) -> dict:
    """The faults across processes on the card, three pairs of ranks at once
    (sigterm, host_loss, shrink), then the relaunch at one process and the
    elastic restores both ways through the checkpointer. Returns B1's
    launches on the relaunch."""
    from stoix_tpu_torch.resilience import elastic, fleet, integrity
    from stoix_tpu_torch.resilience.exit_codes import (
        EXIT_CODE_ELASTIC_RESIZE, EXIT_CODE_FLEET_PARTITION,
    )

    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_faults_")
    loss_port = free_port()
    pairs = {"sigterm": _fleet_ranks("sigterm", f"file://{tmp}/sigterm/store",
                                     os.path.join(tmp, "sigterm")),
             "host_loss": _fleet_ranks("host_loss", f"tcp://127.0.0.1:{loss_port}",
                                       os.path.join(tmp, "host_loss")),
             "shrink": _fleet_ranks("shrink", f"file://{tmp}/shrink/store",
                                    os.path.join(tmp, "shrink"))}
    survivor, victim = pairs["host_loss"][0][0], pairs["host_loss"][1][0]
    frozen_at = None
    deadline = time.monotonic() + 300.0
    while survivor.poll() is None and time.monotonic() < deadline:
        if frozen_at is None and _process_stopped(victim.pid):
            frozen_at = time.time()
        time.sleep(0.02)
    exited_at = time.time()
    # The frozen victim ignores SIGTERM until continued: SIGKILL, and reap.
    loss_codes, loss_logs = _fleet_wait(pairs["host_loss"], timeout=0.1)
    results = {kind: _fleet_wait(pairs[kind]) for kind in ("sigterm", "shrink")}
    record = {"phase": "fleet_faults", "total_num_envs": 1024, "card": smi}

    # SIGTERM to rank 1: both stop at window 1, both exit 0.
    codes, logs = results["sigterm"]
    if codes != [0, 0]:
        raise _fleet_failed("sigterm", codes, logs)
    sig = [json.load(open(os.path.join(tmp, "sigterm", f"sigterm{r}.json"))) for r in range(2)]
    stops = {s["resilience"]["fleet_agreed_stop"] for s in sig}
    if [s["windows"] for s in sig] != [2, 2] or stops != {
            "fleet stop agreed (process 1: preempt)"}:
        raise AssertionError(f"sigterm: {sig}")
    record["sigterm"] = {"exit_codes": codes, "windows": [2, 2], "agreed_stop": stops.pop()}

    # host_loss:2 on rank 1: the survivor exits 87 within its deadlines.
    if loss_codes[0] != EXIT_CODE_FLEET_PARTITION or frozen_at is None or (
            "fleet partition: process 1 silent" not in loss_logs[0]):
        raise _fleet_failed("host_loss", loss_codes, loss_logs)
    emergency = os.path.join(tmp, "host_loss", "emergency")
    flight = json.load(open(os.path.join(emergency, "flight_record.json")))
    declared = [e["unix_time"] for e in flight["events"] if e["kind"] == "fleet_partition"]
    to_declaration, to_exit = declared[0] - frozen_at, exited_at - frozen_at
    if to_exit > FLEET_TIMEOUT_S + FLEET_POLL_S + FLEET_GRACE_S + 3.0:
        raise AssertionError(f"host_loss: the survivor exited {to_exit} s after the freeze")
    # The relaunch at one process restores the survivor's store here.
    manifest = json.load(open(os.path.join(emergency, "p0", fleet.MANIFEST_NAME)))
    restored, step = fleet.restore_emergency(_template_state(FLEET_COMMON, []), emergency)
    params = {k: v for k, v in _replicated_of(restored).items() if k.startswith("params/")}
    bad = [k for k, v in params.items() if integrity.leaf_digest(v) != manifest["digests"][k]]
    kept = sorted({e.split(" ")[0].split("/")[0]
                   for e in fleet.read_restore_report(emergency)["reinitialized"]})
    if bad or not params or step != manifest["step"] or kept != [
            "env_state", "generator", "timestep"]:
        raise AssertionError(f"host_loss relaunch: step {step}, digests differ at {bad[:5]}, "
                             f"kept {kept}")
    with contextlib.chdir(tmp):
        relaunch = _fleet_run("fleet_relaunched", [
            "logger.checkpointing.load_model=true",
            f"logger.checkpointing.load_args.load_path={emergency}"])
    if relaunch["stats"]["resilience"]["restored_step"] != step:
        raise AssertionError(f"host_loss relaunch restored {relaunch['stats']['resilience']}")
    # The resumed run's updates go through B1's GAE entry, one launch each.
    if relaunch["b1"] != {linear_recurrence.KERNEL.name: 0,
                          linear_recurrence.GAE_KERNEL.name: MAIN_UPDATES}:
        raise AssertionError(f"host_loss relaunch: B1 launches {relaunch['b1']}")
    record["host_loss"] = {
        "survivor_exit": loss_codes[0], "victim_exit": loss_codes[1],
        "freeze_to_declaration_s": to_declaration, "freeze_to_exit_s": to_exit,
        "deadlines_s": {"heartbeat_timeout": FLEET_TIMEOUT_S, "monitor_poll": FLEET_POLL_S,
                        "exit_grace": FLEET_GRACE_S},
        "manifest_step": step, "params_digests_equal": len(params),
        "partial": len(manifest["partial"]), "relaunch_b1": relaunch["b1"],
        "relaunch_windows": len(relaunch["stats"]["window_seconds"])}

    # shrink:0: both exit 89 with a request for one device.
    codes, logs = results["shrink"]
    if codes != [EXIT_CODE_ELASTIC_RESIZE] * 2:
        raise _fleet_failed("shrink", codes, logs)
    want = elastic.topology_overrides(compose(FLEET_COMMON), 1)
    requests = [elastic.read_resize_request(os.path.join(tmp, "shrink", "emergency", f"r{r}"))
                for r in range(2)]
    if any((q["from_devices"], q["target_devices"], q["overrides"], q["platform"]) != (
            2, 1, want, "cuda") for q in requests):
        raise AssertionError(f"shrink requests: {requests}")
    record["shrink"] = {"exit_codes": codes, "target_devices": 1, "overrides": want}

    # The elastic restores: the sigterm pair's 2-rank store in this process,
    # and the relaunch's 1-process store over two ranks.
    record["restore_2_to_1"] = _elastic_restore(os.path.join(tmp, "sigterm", "checkpoints"),
                                                "fleet_sigterm", "state.0-of-2.pt")
    codes, logs = _fleet_wait(_fleet_ranks("restore", f"file://{tmp}/restore_store", tmp))
    if codes != [0, 0]:
        raise _fleet_failed("restore", codes, logs)
    record["restore_1_to_2"] = [json.load(open(os.path.join(tmp, f"restore{r}.json")))
                                for r in range(2)]
    for report in (record["restore_2_to_1"], *record["restore_1_to_2"]):
        if report["kept"] != ["env_state", "generator", "timestep"]:
            raise AssertionError(f"elastic restore kept {report}")
    _no_fleet_child_left()
    if not port_is_free(loss_port):
        raise AssertionError(f"fleet_faults: the store's port {loss_port} is still bound")
    record["children_left"] = 0
    record["seconds"] = time.perf_counter() - start
    emit(record)
    return {"b1": relaunch["b1"]}


POPULATION_ROOT = "default/population/default_ff_ppo.yaml"
POPULATION_COMMON = ["arch.num_eval_episodes=16", "system.multistep_impl=pallas",
                     "logger.use_console=False"]
POPULATION_SIZE = 8  # case (b): system.ent_coef lifted to [0.001 ... 0.008]
POPULATION_PBT = {"enabled": True, "interval": 2, "quantile": 0.25, "perturb_scale": 0.2}
POPULATION_WINDOWS = 4  # case (b): 4 windows of one update; PBT fires after 2 and 4
# The population oracle: IdentityGame, 4 members with ent_coef lifted and PBT
# every 2 windows; the fittest member's eval return must pass the threshold
# scripts/jax_oracle_thresholds.py --oracles population fixed on the CPU.
POPULATION_IDENTITY = ["env=identity_game", "arch.total_num_envs=64",
                       "arch.total_timesteps=65536", "arch.num_evaluation=4",
                       "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
                       "arch.absolute_metric=False", "system.rollout_length=16",
                       "system.epochs=4", "logger.use_console=False",
                       "arch.population.size=4",
                       "arch.population.hparams={system.ent_coef: [0.001, 0.003, 0.01, 0.03]}",
                       "arch.population.pbt.enabled=true", "arch.population.pbt.interval=2",
                       "system.multistep_impl=pallas"]
POPULATION_THRESHOLD = 8.0


def _population_module():
    from stoix_tpu_torch.population import runner as population_runner

    return population_runner


def _state_leaves(state) -> dict:
    """Host copies of every leaf of a learner state by tree path, generators
    as their states (None leaves left out)."""
    from stoix_tpu_torch.utils.checkpointing import flatten_state

    out = {}
    for path, leaf in flatten_state(state):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Generator):
            leaf = leaf.get_state()
        out["/".join(path)] = (leaf.detach().cpu().clone() if isinstance(leaf, torch.Tensor)
                               else leaf)
    return out


def _population_run(extra: list, size: int, hparams=None, pbt=None) -> dict:
    """One `run_population_experiment` on the card at the default population
    config's full width plus `extra`: every window's state on the host, the
    last window's live state, B1's launches (counters zeroed just before,
    read just after) and the runner's stats."""
    pop = _population_module()
    lr = linear_recurrence
    config = compose(POPULATION_COMMON + extra, POPULATION_ROOT)
    config_lib._set_dotted(config, "arch.population.size", size)
    if hparams:
        config_lib._set_dotted(config, "arch.population.hparams", hparams)
    if pbt:
        config_lib._set_dotted(config, "arch.population.pbt", pbt)
    windows, last = [], {}
    setup_fn = pop.population_setup

    def recording_setup(*args, **kwargs):
        setup = setup_fn(*args, **kwargs)
        learn = setup.learn

        def recorded(state):
            out = learn(state)
            windows.append(_state_leaves(out.learner_state))
            last["state"] = out.learner_state
            return out

        return setup._replace(learn=recorded)

    for counter in lr.COUNTERS:
        counter.launches = 0
    pop.population_setup = recording_setup
    try:
        start = time.perf_counter()
        final_return = pop.run_population_experiment(config, device="cuda")
        seconds = time.perf_counter() - start
    finally:
        pop.population_setup = setup_fn
    if not math.isfinite(final_return):
        raise AssertionError(f"population of {size}: non-finite eval return {final_return}")
    return {"windows": windows, "state": last["state"], "config": config,
            "b1_launches": _counts(lr.COUNTERS), "updates": int(config.arch.num_updates),
            "stats": copy.deepcopy({k: v for k, v in runner.LAST_RUN_STATS.items()
                                    if k != "history"}),
            "population": dict(pop.LAST_POPULATION_STATS),
            "final_eval_return": final_return, "seconds": seconds}


def _plain_windows(extra: list) -> tuple:
    """The plain Anakin ff_ppo run at the same width: every window's state
    on the host, and its env-steps/s."""
    windows = []
    setup_fn = ff_ppo.learner_setup

    def recording_setup(*args, **kwargs):
        setup = setup_fn(*args, **kwargs)
        learn = setup.learn

        def recorded(state):
            out = learn(state)
            windows.append(_state_leaves(out.learner_state))
            return out

        return setup._replace(learn=recorded)

    ff_ppo.learner_setup = recording_setup
    try:
        ff_ppo.run_experiment(compose(extra, PPO_ROOT), device="cuda")
    finally:
        ff_ppo.learner_setup = setup_fn
    return windows, list(runner.LAST_RUN_STATS["steps_per_second"])


def _clone_pairs(window: dict, size: int) -> list:
    params = [v for k, v in window.items() if k.startswith("members/params/")]
    return [(i, j) for i in range(size) for j in range(i + 1, size)
            if all(torch.equal(v[i], v[j]) for v in params)]


def _population_restores(state, smi: str) -> dict:
    """Case (c): the P = 8 state saved as a fleet emergency store, restored
    at P = 4 and P = 12 through the population's raw transform: leaves kept
    whole at the store's digests, survivors and old members bitwise, the
    clones' hparams at float32(0.8 or 1.2) times their source's."""
    from stoix_tpu_torch.population import elastic as population_elastic
    from stoix_tpu_torch.resilience import fleet

    pop = _population_module()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        settings = fleet.settings_from_config(
            {"arch": {"fleet": {"enabled": True, "emergency_dir": tmp}}})
        coord = fleet.FleetCoordinator(settings, backend=None, process_index=0,
                                       process_count=1, interrupt_on_partition=False)
        coord.stage_candidate(1, state)
        coord.confirm_candidate(1)
        path = coord.emergency_save()
        with open(os.path.join(path, fleet.MANIFEST_NAME)) as f:
            digests = json.load(f)["digests"]
        saved = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                 for k, v in _state_leaves(state).items()}
        fitness = saved["fitness"]
        for size in (4, 12):
            config = compose(POPULATION_COMMON + ["arch.num_updates=1", "arch.num_evaluation=1"],
                             POPULATION_ROOT)
            config_lib._set_dotted(config, "arch.population.size", size)
            config_lib._set_dotted(config, "arch.population.hparams", {
                "system.ent_coef": [0.001] * size})
            config = check_total_timesteps(config, 1)
            env, _ = envs.make(config)
            template = pop.population_setup(env, config, torch.device("cuda"), 0).learner_state
            start = time.perf_counter()
            restored, step = fleet.restore_emergency(
                template, path, raw_transform=population_elastic.raw_resize_transform(config))
            restore_ms = 1e3 * (time.perf_counter() - start)
            report = fleet.read_restore_report(path)
            got = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                   for k, v in _state_leaves(restored).items()}
            if step != 1 or not report["transformed"] or report["reinitialized"] or \
                    sorted(got) != sorted(saved):
                raise AssertionError(f"restore at {size}: step {step}, report {report}")
            kept = population_elastic.select_survivors(fitness, 4)
            src = population_elastic.clone_sources(fitness, 8, 12)
            whole = bitwise = 0
            for key, value in saved.items():
                if not population_elastic.is_population_leaf(key):
                    if key == "pbt_generator" and size == 12:
                        if got[key].tobytes() == value.tobytes():
                            raise AssertionError("the grow left the PBT stream where it was")
                        continue
                    if report["digests"][key] != digests[key] or \
                            got[key].tobytes() != value.tobytes():
                        raise AssertionError(f"restore at {size}: {key} is not the store's")
                    whole += 1
                    continue
                want = value[kept] if size == 4 else value
                if got[key][:len(want)].tobytes() != want.tobytes():
                    raise AssertionError(f"restore at {size}: {key} moved")
                bitwise += 1
                if size == 12 and key.startswith("members/params/"):
                    if got[key][8:].tobytes() != value[src[8:]].tobytes():
                        raise AssertionError(f"a clone's {key} is not its source's")
            clones = {}
            if size == 12:
                for slot in range(8, 12):
                    source = saved["hparams/ent_coef"][src[slot]]
                    value = got["hparams/ent_coef"][slot]
                    if value not in (source * np.float32(0.8), source * np.float32(1.2)):
                        raise AssertionError(f"clone {slot}: ent_coef {value} from {source}")
                    if got["members/generator"][slot].tobytes() == \
                            saved["members/generator"][src[slot]].tobytes():
                        raise AssertionError(f"clone {slot} replays its source's stream")
                clones = {"sources": src[8:].tolist(),
                          "ent_coef": got["hparams/ent_coef"][8:].tolist()}
            out[f"p{size}"] = {"leaves_at_the_stores_digests": whole,
                               "member_leaves_bitwise": bitwise, "restore_ms": restore_ms,
                               "kept_members": kept.tolist() if size == 4 else list(range(8)),
                               **clones}
    emit({"phase": "population", "case": "c", "store_members": 8, **out, "card": smi})
    return out


def phase_population(smi: str) -> dict:
    """Population training (A17b) at default/population/default_ff_ppo.yaml's
    full width (CartPole, 1024 envs a member, T = 16, 4 x 4 minibatches, MLP
    256 x 256, pallas): (a) one member, PBT off, every leaf of every window
    bitwise the plain ff_ppo run; (b) 8 members with ent_coef lifted to
    [0.001 ... 0.008] and PBT every 2 windows over 4 windows of one update:
    clone pairs bitwise at the fire windows, none between, 4 exploited
    members, the hparams at the exact float32 products, 8 B1 GAE launches an
    update; (c) its state's emergency store restored at 4 and 12 members;
    (d) (b) as two ranks of four members (`arch.mesh.pop=2`) on the card
    over gloo, bitwise (b). Returns B1's GAE launches by case."""
    gae = linear_recurrence.GAE_KERNEL.name
    windows = [f"arch.num_updates={MAIN_UPDATES}", f"arch.num_evaluation={MAIN_UPDATES}"]
    plain, plain_sps = _plain_windows(POPULATION_COMMON + windows)
    one = _population_run(windows, 1)
    _check_b1_per_update("population (a)", one)
    compared = 0
    if len(one["windows"]) != MAIN_UPDATES or len(plain) != MAIN_UPDATES:
        raise AssertionError(f"population (a): {len(one['windows'])} and {len(plain)} windows")
    for window, (a, b) in enumerate(zip(plain, one["windows"])):
        if sorted(f"members/{k}" for k in a) != sorted(k for k in b if k.startswith("members/")):
            raise AssertionError(f"population (a): the member's leaves are not the plain run's")
        for key, value in a.items():
            row = b[f"members/{key}"][0]
            same = torch.equal(row, value) if isinstance(value, torch.Tensor) else (
                int(row) == value)
            if not same:
                raise AssertionError(f"population (a): {key} differs at window {window}")
            compared += 1
    emit({"phase": "population", "case": "a", "members": 1, "windows": MAIN_UPDATES,
          "bitwise_equal_leaves": compared, "b1_launches": one["b1_launches"],
          "env_steps_per_second": one["stats"]["steps_per_second"],
          "plain_env_steps_per_second": plain_sps, "seconds": one["seconds"], "card": smi})

    ent = [0.001 * (i + 1) for i in range(POPULATION_SIZE)]
    run = _population_run([f"arch.num_updates={POPULATION_WINDOWS}",
                           f"arch.num_evaluation={POPULATION_WINDOWS}"], POPULATION_SIZE,
                          hparams={"system.ent_coef": ent}, pbt=POPULATION_PBT)
    want = {gae: POPULATION_SIZE * POPULATION_WINDOWS, linear_recurrence.KERNEL.name: 0}
    if run["b1_launches"] != want:
        raise AssertionError(f"population (b): B1 launched {run['b1_launches']}, not {want}")
    pairs = [_clone_pairs(w, POPULATION_SIZE) for w in run["windows"]]
    if len(pairs[1]) < 2 or len(pairs[3]) < 2 or pairs[0] or pairs[2]:
        raise AssertionError(f"population (b): clone pairs by window {pairs}")
    if run["windows"][-1]["exploit_total"] != 4:
        raise AssertionError(f"population (b): {run['windows'][-1]['exploit_total']} exploited")
    for fire in (1, 3):
        prev = run["windows"][fire - 1]["hparams/ent_coef"].numpy()
        new = run["windows"][fire]["hparams/ent_coef"].numpy()
        allowed = set(prev.tolist()) | set((prev * np.float32(0.8)).tolist()) | set(
            (prev * np.float32(1.2)).tolist())
        changed = [float(v) for v, p in zip(new, prev) if v != p]
        if not changed or not all(v in allowed for v in changed):
            raise AssertionError(f"population (b): window {fire + 1} hparams {changed}")
    per_member = run["stats"]["steps_per_second"]
    emit({"phase": "population", "case": "b", "members": POPULATION_SIZE,
          "windows": POPULATION_WINDOWS, "pbt": POPULATION_PBT, "clone_pairs": pairs,
          "exploit_total": run["windows"][-1]["exploit_total"],
          "ent_coef_by_window": [w["hparams/ent_coef"].tolist() for w in run["windows"]],
          "member_fitness": run["population"]["member_fitness"],
          "b1_launches": run["b1_launches"],
          "b1_gae_launches_per_update": run["b1_launches"][gae] // POPULATION_WINDOWS,
          "env_steps_per_second_per_member": per_member,
          "env_steps_per_second_total": [POPULATION_SIZE * s for s in per_member],
          "window_seconds": run["stats"]["window_seconds"],
          "final_eval_return": run["final_eval_return"], "seconds": run["seconds"],
          "card": smi})
    _population_restores(run["state"], smi)
    ranks = _population_over_ranks(run, smi)
    return {"a_one_member": one["b1_launches"][gae], "b_eight_members": run["b1_launches"][gae],
            "b_per_update": run["b1_launches"][gae] // POPULATION_WINDOWS,
            "d_per_rank": ranks}


POPULATION_RANKS = 2  # case (d): arch.mesh.pop = 2, four members a rank


def population_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of phase population's case (d) (`--population-rank`): case
    (b)'s population with `arch.mesh.pop` = world, both ranks on the one card
    in a gloo group; its windows to `out`.pt, its record to `out` (JSON).
    It runs beside the pool, so it takes a pool child's share of the cores."""
    _child_setup()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        run = _population_run([f"arch.num_updates={POPULATION_WINDOWS}",
                               f"arch.num_evaluation={POPULATION_WINDOWS}",
                               f"arch.mesh.pop={world}", "arch.mesh.data=1"], POPULATION_SIZE,
                              hparams={"system.ent_coef": [0.001 * (i + 1)
                                                           for i in range(POPULATION_SIZE)]},
                              pbt=POPULATION_PBT)
    finally:
        dist.destroy_process_group()
    torch.save(run["windows"], out + ".pt")
    with open(out, "w") as f:
        json.dump({"b1_launches": run["b1_launches"], "stats": run["stats"],
                   "population": run["population"], "seconds": run["seconds"],
                   "final_eval_return": run["final_eval_return"]}, f)


def _population_over_ranks(one_rank: dict, smi: str) -> list:
    """Case (d): case (b)'s population as two ranks of four members each on
    the card over gloo, every leaf of every window bitwise case (b)'s rows
    (the whole fitness and hparams on both). Returns each rank's B1 GAE
    launches."""
    gae = linear_recurrence.GAE_KERNEL.name
    p_local = POPULATION_SIZE // POPULATION_RANKS
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_rank_children("--population-rank", POPULATION_RANKS, [], tmp)
        records, windows = [], []
        for out in outs:
            with open(out) as f:
                records.append(json.load(f))
            windows.append(torch.load(out + ".pt", weights_only=False))
    compared = 0
    for rank, (record, mine) in enumerate(zip(records, windows)):
        if record["b1_launches"][gae] != p_local * POPULATION_WINDOWS:
            raise AssertionError(f"population (d) rank {rank}: B1 {record['b1_launches']}")
        if len(mine) != POPULATION_WINDOWS:
            raise AssertionError(f"population (d) rank {rank}: {len(mine)} windows")
        for window, (part, whole) in enumerate(zip(mine, one_rank["windows"])):
            if sorted(part) != sorted(whole):
                raise AssertionError(f"population (d) rank {rank}: other leaves")
            for key, value in whole.items():
                if isinstance(value, torch.Tensor):
                    want = value[rank * p_local:(rank + 1) * p_local] if key.startswith(
                        "members/") else value
                    same = torch.equal(part[key], want)
                else:
                    same = part[key] == value
                if not same:
                    raise AssertionError(f"population (d) rank {rank}: {key} differs from one "
                                         f"rank's at window {window}")
                compared += 1
    sps = [r["stats"]["steps_per_second"] for r in records]
    emit({"phase": "population", "case": "d", "members": POPULATION_SIZE,
          "ranks": POPULATION_RANKS, "backend": "gloo", "cards": torch.cuda.device_count(),
          "bitwise_equal_leaves": compared,
          "b1_gae_launches_per_rank": [r["b1_launches"][gae] for r in records],
          "env_steps_per_second_per_member": sps,
          "env_steps_per_second_total": [POPULATION_SIZE * s for s in sps[0]],
          "window_seconds": [r["stats"]["window_seconds"] for r in records],
          "exploits": [r["population"]["pbt_exploits"] for r in records],
          "seconds": [r["seconds"] for r in records], "card": smi})
    return [r["b1_launches"][gae] for r in records]


def phase_population_learn() -> None:
    """The population oracle: the fittest member's eval return on IdentityGame
    above POPULATION_THRESHOLD."""
    start = time.perf_counter()
    final_return = _population_module().run_population_experiment(
        compose(POPULATION_IDENTITY, POPULATION_ROOT), device="cuda")
    if not final_return > POPULATION_THRESHOLD:
        raise AssertionError(f"the population returned {final_return}, not above "
                             f"{POPULATION_THRESHOLD}")
    emit({"phase": "population_learn", "env": "identity_game", "final_return": final_return,
          "threshold": POPULATION_THRESHOLD,
          "member_fitness": _population_module().LAST_POPULATION_STATS["member_fitness"],
          "seconds": time.perf_counter() - start})


LEARN_PHASES = {  # the longest first, by their seconds on the card
    **{f"{name}_learn": partial(phase_pendulum_learn, name)
       for name in PENDULUM_THRESHOLDS},
    "mz_learn": partial(phase_pg_learn, "ff_mz", SEARCH_ROOTS["ff_mz"], MZ_IDENTITY, "mz_learn",
                        SEARCH_THRESHOLD),
    "cont_learn": phase_cont_learn,
    "r2d2_learn": partial(phase_sequence_learn, "rec_r2d2"),
    "rainbow_learn": partial(phase_sequence_learn, "ff_rainbow"),
    "sac_learn": phase_sac_learn,
    "snake_learn": phase_snake_learn,
    "q_learn": phase_q_learn,
    "rec_learn": phase_rec_learn,
    "catch_learn": phase_catch_learn,
    **{f"{oracle}_learn": partial(phase_sebulba_learn, oracle) for oracle in SEBULBA_ORACLES},
    "trans_learn": phase_trans_learn,
    "az_learn": partial(phase_pg_learn, "ff_az", SEARCH_ROOTS["ff_az"], AZ_IDENTITY, "az_learn",
                        SEARCH_THRESHOLD),
    "knobs_learn": phase_knobs_learn,
    "population_learn": phase_population_learn,
    "mpo_learn": partial(phase_pg_learn, "ff_mpo", MPO_ROOTS["ff_mpo"], MPO_IDENTITY,
                         "mpo_learn", MPO_THRESHOLD),
    "disco_learn": partial(phase_pg_learn, "ff_disco103", DISCO_ROOT, DISCO_IDENTITY,
                           "disco_learn", A13_THRESHOLD),
    "learn": phase_learn,
    "spo_learn": partial(phase_pg_learn, "ff_spo", SPO_ROOTS["ff_spo"], SPO_IDENTITY, "spo_learn",
                         A13_THRESHOLD),
    "vmpo_learn": partial(phase_pg_learn, "ff_vmpo", MPO_ROOTS["ff_vmpo"], VMPO_IDENTITY,
                          "vmpo_learn", MPO_THRESHOLD),
    "awr_learn": partial(phase_pg_learn, "ff_awr", AWR_ROOT, AWR_IDENTITY, "awr_learn"),
    "vpg_learn": partial(phase_pg_learn, "ff_reinforce", VPG_ROOT, VPG_IDENTITY, "vpg_learn"),
}
# The phases whose numbers no kernel timing reads, each in a child of the
# pool beside the oracles (each returns JSON), and the job each goes before.
POOL_PHASES = {
    "search_train": (phase_search_train, "cont_learn"),
    "loco_grid": (lambda smi: {**phase_loco_train(smi), **phase_loco_envs(smi),
                               **phase_grid_train(smi)}, "q_learn"),
    "mcts": (phase_mcts, "q_learn"),
    "mpo_family": (lambda smi: {**phase_mpo_train(smi, "mpo"), **phase_mpo_train(smi, "vmpo")},
                   "q_learn"),
    "spo_disco": (lambda smi: {**phase_spo_train(smi), **phase_disco_train(smi)}, "trans_learn"),
    "rec_train": (phase_rec_train, "trans_learn"),
    "population": (phase_population, "trans_learn"),
}
# The children share the card and the host's cores with the main process:
# one worker a core, between four and eight.
LEARN_WORKERS = max(4, min(8, os.cpu_count() or 8))
LEARN_TIMEOUT_S = 480


def _child_setup() -> None:
    """A pool child: TF32 off, as phase device sets it, and one share of the
    host's cores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 8) // LEARN_WORKERS))


def learn_child(name: str) -> None:
    """One learning oracle (`--learn-phase NAME`); its JSON lines go to stdout."""
    _child_setup()
    LEARN_PHASES[name]()


def pool_phase_child(name: str, smi: str) -> None:
    """One of POOL_PHASES (`--pool-phase NAME SMI`); its JSON lines go to
    stdout, the last one `{"pool_return": NAME, "value": ...}`. The rank
    children a pool phase starts die with it (population's case (d))."""
    _child_setup()
    os.environ[PARENT_ENV] = str(os.getpid())
    value = POOL_PHASES[name][0](smi)
    print(json.dumps({"pool_return": name, "value": value}), flush=True)


def pool_jobs(smi: str) -> list:
    """(name, command) of every job of the pool, the longest first."""
    names = list(LEARN_PHASES)
    for name, (_, before) in POOL_PHASES.items():
        names.insert(names.index(before), name)
    script = os.path.abspath(__file__)
    return [(name, [sys.executable, script, "--pool-phase", name, smi] if name in POOL_PHASES
             else [sys.executable, script, "--learn-phase", name]) for name in names]


class Pool(threading.Thread):
    """The jobs, each a child process, LEARN_WORKERS at a time, beside the
    main process's phases. A child's JSON lines are kept until `finish`,
    which prints them, records the pool and returns what the pool phases
    returned. A failed child, or one past LEARN_TIMEOUT_S, or `stop`, ends
    the rest."""

    def __init__(self, jobs: list):
        super().__init__(name="chip-smoke-pool", daemon=True)
        self.jobs = list(jobs)
        self.lines: list = []
        self.returns: dict = {}
        self.error = None
        self.seconds = None
        self._halt = threading.Event()

    def run(self) -> None:
        pending = list(self.jobs)
        running = {}
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pool_") as tmp:
            try:
                while (pending or running) and not self._halt.is_set():
                    while pending and len(running) < LEARN_WORKERS:
                        name, command = pending.pop(0)
                        log = open(os.path.join(tmp, f"{name}.log"), "w+")
                        proc = subprocess.Popen(command, stdout=log, stderr=subprocess.STDOUT)
                        running[name] = (proc, log, time.monotonic())
                    for name, (proc, log, began) in list(running.items()):
                        if proc.poll() is None:
                            if time.monotonic() - began > LEARN_TIMEOUT_S:
                                raise AssertionError(f"{name} ran past {LEARN_TIMEOUT_S} s")
                            continue
                        del running[name]
                        log.seek(0)
                        text = log.read()
                        log.close()
                        if proc.returncode:
                            raise AssertionError(f"{name} failed (exit {proc.returncode}):\n"
                                                 f"{text[-6000:]}")
                        for line in text.splitlines():
                            if line.startswith('{"pool_return"'):
                                self.returns[name] = json.loads(line)["value"]
                            elif line.startswith("{"):
                                self.lines.append(line)
                    time.sleep(0.2)
                if self._halt.is_set() and (pending or running):
                    raise AssertionError("the pool was stopped before its jobs ended")
                self.seconds = time.perf_counter() - start
            except BaseException as error:  # noqa: BLE001 -- handed to `finish`
                self.error = error
            finally:
                for proc, log, _ in running.values():
                    if proc.poll() is None:
                        proc.kill()
                    proc.wait(timeout=60)
                    log.close()

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=120)

    def finish(self) -> dict:
        self.join()
        if self.error is not None:
            raise AssertionError(f"pool: {self.error}") from self.error
        for line in self.lines:
            print(line, flush=True)
        emit({"phase": "learn_all", "phases": [name for name, _ in self.jobs],
              "pool_phases": list(POOL_PHASES), "workers": LEARN_WORKERS,
              "host_cpus": os.cpu_count(), "seconds": self.seconds})
        return self.returns


def main_phases(smi: str, recurrence: dict, gae: dict, attention: list, chunk: dict,
                wide: list) -> dict:
    """The main process's phases beside the pool; each kernel entry gains its
    launches on each path. Returns what main still needs."""
    kernels = (recurrence, gae, *attention, chunk, *wide)
    phase_knobs(smi)
    # The generic entry point is off both PPO paths (their GAE takes the GAE
    # entry point); ff_pqn's Q(lambda) is its training path (phase q_train),
    # and its launches on GAE's composed path (phase gae) stand under their own key.
    recurrence["launches"] = phase_q_train(smi)
    recurrence["path"] = "ff_pqn's update (Q(lambda)), phase q_train"
    gae["launches_ff_ppo_continuous"] = phase_cont_train(smi)
    # Sequence replay runs no kernel: each entry records its 0 launches there.
    for name in SEQUENCE_ROOTS:
        sequence = phase_sequence_train(name, smi)
        for entry in kernels:
            entry.setdefault("launches_sequence_replay", {})[name] = sequence[entry["name"]]
    # A12's first half: the actor-critics run no kernel; ff_reinforce's update
    # is one GAE launch (lambda 1.0), ff_awr's epoch one generic launch.
    actor_critics = phase_ac_train(smi)
    vpg = phase_pg_train(smi, "vpg")
    awr = phase_pg_train(smi, "awr")
    for entry in kernels:
        entry["launches_actor_critics"] = {name: counts[entry["name"]]
                                           for name, counts in actor_critics.items()}
        entry["launches_ff_reinforce"] = vpg[entry["name"]]
        entry["launches_ff_awr"] = awr[entry["name"]]
    # A14's first half: one GAE launch an ff_ppo update on every vision path,
    # nothing on ff_dqn's and ff_c51's.
    vision = {"vision_train": phase_vision_train(smi), **phase_minatar_train(smi)}
    phase_vision_parity(smi)
    for entry in kernels:
        entry["launches_vision"] = {label: counts[entry["name"]]
                                    for label, counts in vision.items()}
    data_parallel = phase_data_parallel(smi)
    # A15's first part: Sebulba. One GAE launch an update on its ff_ppo paths,
    # 4 generic launches (V-trace, one a minibatch) an update on the IMPALAs.
    sebulba = {**phase_sebulba_train(smi), **phase_sebulba_pixel(smi),
               **phase_sebulba_envs(smi)}
    phase_sebulba_parity(smi)
    for entry in kernels:
        entry["launches_sebulba"] = {label: counts[entry["name"]]
                                     for label, counts in sebulba.items()}
    # A16 and A15b: Sebulba's off-policy half. The replay service and ff_dqn
    # launch no kernel; IMPACT one GAE launch an update.
    offpolicy = {"sebulba_replay": phase_sebulba_replay(smi), **phase_sebulba_dqn_train(smi),
                 **phase_sebulba_impact_train(smi)}
    phase_sebulba_offpolicy_parity(smi)
    for entry in kernels:
        entry["launches_sebulba_offpolicy"] = {label: counts[entry["name"]]
                                               for label, counts in offpolicy.items()}
    # A17a, A15b and C27: gossip groups (one GAE launch an update on each
    # group's rank), Sebulba through the envpool adapter and the stateful
    # evaluator (one an update on ff_ppo, none on ff_dqn), the ring's
    # gradients and the tensor-parallel block (no kernel).
    gae["launches_gossip"] = phase_gossip_train(smi)
    adapters = phase_sebulba_adapters(smi)
    for entry in kernels:
        entry["launches_sebulba_adapters"] = {label: counts[entry["name"]]
                                              for label, counts in adapters.items()}
    with one_rank_mesh() as mesh:
        phase_ring_grad(smi, mesh)
    # A19a: the operations layer of one process on the main path, every
    # switch on against every switch off, then the Anakin faults.
    ops = phase_ops_train(smi)
    gae["launches_ops_train"] = ops["b1"]
    phase_ops_faults(smi, ops)
    # A19b: the operations layer across processes, two ranks on the card.
    gae["launches_fleet_train"] = phase_fleet_train(smi)["b1"]
    gae["launches_fleet_relaunch"] = phase_fleet_faults(smi)["b1"]
    return {"data_parallel": data_parallel}


def main() -> None:
    smi = phase_device()
    phase_build()
    recurrence = phase_kernel()
    attention = phase_attention()
    gae, recurrence["composed_path_launches"], recurrence["estimator_launches"] = phase_gae()
    gae["launches"] = phase_train(smi)
    gae["path"] = "ff_ppo's update, phase train"
    trans = phase_trans_train(smi)
    gae["launches_ff_trans_ppo"] = trans["total"][gae["name"]]
    for entry in attention:
        entry["launches"] = trans["total"][entry["name"]]
        entry["learner_launches"] = trans["learner"][entry["name"]]
        entry["evaluator_launches"] = trans["evaluator"][entry["name"]]
    width = ring_width()
    chunk = phase_ring_kernel(width)
    with one_rank_mesh() as mesh:
        ring = phase_ring(width, smi, mesh)
        phase_c6(mesh, smi)
        phase_c8(smi)
        wide = phase_c8_wide(mesh, smi)
    # Every kernel timing is taken by here, B1's GAE entry at the search and
    # SPO shapes included: the oracles and POOL_PHASES run from now on in
    # the pool's children, beside the main process's phases.
    gae["shapes"] += search_gae_shapes()
    gae["shapes"].append(spo_gae_shape())
    pool = Pool(pool_jobs(smi))
    pool.start()
    try:
        rest = main_phases(smi, recurrence, gae, attention, chunk, wide)
        returned = pool.finish()
    finally:
        pool.stop()
    # The pool's phases: ff_rec_ppo one GAE launch an update; A12's second
    # half (an MPO epoch is one generic launch, Retrace, a V-MPO epoch one
    # GAE launch); A13's (the batched MCTS, then the four search systems:
    # B1's GAE entry is ff_az's, on-policy and replay, and ff_sampled_az's
    # path; an SPO epoch is one GAE launch, 64 an update, and the Disco rule
    # launches none, in either mode); A14b's first part (one GAE launch an
    # update on every PPO path over the locomotion envs and the grid games,
    # nothing on ff_sac's or the Q family's).
    gae["launches_rec_ppo"] = returned["rec_train"]
    # A17b: a population update is one GAE launch a member (8 at P = 8).
    gae["launches_population"] = returned["population"]
    for entry in (recurrence, gae, *attention, chunk, *wide):
        for key, phase in (("launches_mpo_family", "mpo_family"), ("launches_search", "search_train"),
                           ("launches_spo_disco", "spo_disco"), ("launches_loco_grid", "loco_grid")):
            entry[key] = {label: counts[entry["name"]]
                          for label, counts in returned[phase].items()}
    gae["launches_data_parallel"] = {"a_one_rank_ff_ppo": rest["data_parallel"]["a_ff_ppo"],
                                     "b_per_rank": rest["data_parallel"]["b_per_rank"]}
    recurrence["launches_data_parallel"] = {
        "a_one_rank_ff_pqn": rest["data_parallel"]["a_ff_pqn"]}
    chunk["launches"] = ring["launches"]
    chunk["composed_op"] = {"ring_attention_ms": ring["ring_attention_ms"],
                            "sdpa_ms": ring["sdpa_ms"]}
    kernels = [recurrence, gae, *attention, chunk, *wide]
    if any(entry["launches"] == 0 for entry in kernels):
        raise AssertionError("a kernel of the main path was never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] in (["--data-parallel-rank"], ["--gossip-rank"], ["--learn-phase"],
                         ["--pool-phase"], ["--ops-child"], ["--fleet-rank"],
                         ["--population-rank"]):
        die_with_parent()
    if sys.argv[1:2] == ["--data-parallel-rank"]:
        dp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    elif sys.argv[1:2] == ["--gossip-rank"]:
        gossip_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif sys.argv[1:2] == ["--population-rank"]:
        population_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif sys.argv[1:2] == ["--learn-phase"]:
        learn_child(sys.argv[2])
    elif sys.argv[1:2] == ["--pool-phase"]:
        pool_phase_child(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--ops-child"]:
        ops_child(sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]) if sys.argv[5:] else 0)
    elif sys.argv[1:2] == ["--fleet-rank"]:
        fleet_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    else:
        adopt_children()
        try:
            main()
        finally:
            stop_leftovers()
