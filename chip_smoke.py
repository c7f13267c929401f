#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pfrl_tpu_torch``) on one card.

Run it from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``, and exits non-zero, printing no
result, without them. Its phases, each raising on failure:

1. build every hand-written kernel from ``pfrl_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time the kernel, the plain version and a
   one-call PyTorch yardstick. The prefix sampler is timed at the main
   path's C = 131,072 leaves, at C = 524,288 (grasping-dqn-batch-1's
   tree) and at C = 1,048,576 (a 10**6-slot buffer), B = 32, and at
   C = 131,072, B = 64 (Rainbow-CartPole's batch), with the
   occupancy and shared memory of its one cluster;
3. check each configuration on a small input: the same run on the card
   (through the kernel, where it samples by priority) and on the CPU
   (through the plain version), from the same draws and weights, must
   agree. The configurations are prioritized-replay Nature DQN, Rainbow,
   Nature DQN and Double DQN over the uniform ring, and SAC, TD3 and DDPG
   for continuous control;
4. drive prioritized-replay Nature DQN at full width (64 lanes of 84x84x4
   uint8 AtariSim frames, a 100,000-slot ring on the card, batch-32
   updates every 4 transitions from 2,000 on) for 48 scan steps, past
   replay start, counting the kernel's launches;
5. drive Rainbow at full width with the recipe's every width and cadence
   (noisy distributional dueling network, 51 atoms, categorical Double
   DQN, Adam, 3-step prioritized replay; updates from 7,680 on and the
   target sync at 8,192, moved from the recipe's 20,000 and 32,000 for the
   time limit) for 128 scan steps, through the sync, counting the kernel's
   launches, then its greedy evaluation loop (5 lanes, 500 steps);
6. drive Nature DQN and Double DQN over the uniform ring at full width for
   16 scan steps past replay start; this path launches no kernel;
7. drive SAC and TD3 at full width (32 lanes of MujocoSim, obs 17, action
   6, 256 x 256 networks, a 100,000-slot float32 ring that stores
   ``next_obs``, one batch-256 update per transition from 1,000 on): 31
   scan steps of collection, then 12 with 32 updates each, then the
   greedy evaluation loop (5 lanes, 1,000 steps, through the truncation at
   step 1,000); these paths launch no kernel;
8. drive DDPG at full width (16 lanes of the time-limited,
   action-normalized Pendulum, 64 x 64 networks, batch-128 updates every 4
   transitions) through its 1,000 burn-in transitions and on to 205 scan
   steps, so that every lane crosses the 200-step time limit, then
   its evaluation loop (10 lanes, 201 steps); no kernel either;
9. on-policy, through ``OnPolicyRunner.run_iterations``: small card-vs-CPU
   runs of PPO, A2C and TRPO (4 lanes, 3 iterations, the same draws and
   weights), then at full width PPO on MujocoSim as ``bench.py`` runs it (8
   lanes, rollout 256, 320 batch-64 Adam steps per iteration, 4
   iterations: every lane truncated at its step 1,000), PPO and TRPO on
   the time-limited Pendulum (16 lanes, rollout 128, 2 iterations each:
   one truncation per lane, then the evaluation loop, 10 lanes
   x 201 steps) and A2C on the time-limited CartPole (32 lanes, rollout 8, 100
   iterations, then 10 lanes x 501 steps); no kernel on these paths;
10. the discrete value family on the time-limited CartPole
   (``experiments/cartpole_value.py``): small card-vs-CPU runs of the six
   recipes (DQN, C51, Rainbow-CartPole, AL, IQN and the example's DQN), of
   PAL, DoublePAL, DPP and DoubleIQN cores on the AL and IQN recipes, of
   Boltzmann and exponential-decay exploration, and one forward and one
   update of the noisy ``NatureQ`` at 84x84x4; then each recipe at full
   width through 64 scan steps (t = 2,048; the example: 16 steps of 128
   lanes), holding the target to the online net right after the sync,
   counting 264 kernel launches on Rainbow-CartPole's 3-step PER (B = 64)
   and 0 elsewhere, then its evaluation loop;
11. bf16 compute over float32 masters (``compute_dtype=torch.bfloat16``):
   small card-vs-CPU runs at bf16 of Nature DQN and PER DQN on AtariSim
   (the kernel also held against its plain version on the run's
   priorities), C51 and IQN on CartPole, SAC on Pendulum at the recipe's
   widths and PPO, and one forward and update of the noisy ``NatureQ``
   (its head computes in float32), each difference printed in bf16 ulps
   beside its tolerance and every master and moment held to float32 after
   every update; then at full width ``bench.py``'s ``bench_dqn`` A/B (fp32
   and bf16 uniform-ring Nature DQN, 64 lanes, interleaved rounds: both
   env-steps/s, their ratio, the spread and the achieved TFLOP/s by
   ``bench.py``'s 18.67 MFLOP per forward), PER DQN at bf16 (40 scan steps,
   its kernel launches counted), SAC on Pendulum at bf16
   (``run_sac_pendulum_bf16``: 96 scan steps through burn-in and replay
   start, then 10 lanes x 201 steps of evaluation) and PPO on MujocoSim at
   bf16 (``bench_ppo``'s widths, 2 iterations);
12. the recurrent family (``experiments/recurrent.py``): small card-vs-CPU
   runs of DRQN on PO-ABC and DelayedCue, recurrent IQN, DRQN-AtariSim
   (Nature CNN, LSTM 16, burn-in 2), recurrent PPO and TRPO, and
   DRQN-AtariSim at bf16, each difference printed in float32 (bf16) ulps
   beside its tolerance, as phase 11 holds them; then DRQN-AtariSim at full
   width (``train_drqn_ale.py --sim``: 32 lanes of 84x84x1 frames, Nature
   CNN -> LSTM 512 -> 6, the 2,048 x 128 episodic buffer with the carries,
   about 5.9 GB on the card, its bytes printed; 8 batch-32 updates of
   32-step windows per scan step) through replay start and the target
   sync (moved to 4,160 and 4,224), printing env-steps/s, updates/s and the
   device's busy share over profiled scan steps, then 5 x 500 steps of
   evaluation; then the five ``tools/record_curves.py`` recipes at their
   widths (16 lanes, LSTM 32) with their evaluation loops. No path of this
   phase launches the prefix-sample kernel, and each asserts 0;
13. ACER (``experiments/acer.py``) and the Atari on-policy examples on
   ``SmallAtariCNN``: small card-vs-CPU runs of ACER on ABC, on the
   continuous ABC (the SDN head) and on AtariSim at the recipes' network
   widths (4 lanes, 12 rows), in float32 ulps, and of ACER-AtariSim at
   bf16 in bf16 ulps, each held to 4x the larger of what 1 + 2**-23 and
   1 - 2**-23 nudges of the weights move, at least 128 float32 or 8/16
   bf16 ulps; then ACER-AtariSim at full width (``train_acer_ale.py
   --sim``: 16 lanes of 84x84x4 frames, the 2,048 x 50 episodic buffer,
   5.78 GB, with the behaviour's log-probs, its bytes printed; the
   replay start cut to 832, then 40 timed scan steps of one
   batch-16 update each; env-steps/s, updates/s, kernels per scan step and
   the device's busy share over 4 profiled scan steps; evaluation 5 x 500),
   and A2C (16 lanes, rollout 5, 20 iterations) and PPO (8 lanes, rollout
   128, 2 iterations) on AtariSim at the examples' widths, each with its
   kernels per iteration and evaluation 5 x 500. No path of this phase
   launches the prefix-sample kernel, and each asserts 0;
14. the Atari examples at their own settings and the actor-learner
   pipeline. First (right after the build) the native frame ops
   (``pfrl_tpu_torch/runtime``, g++ on the card's host) against their numpy
   versions (1 apart at most, in under 1% of the pixels) and their rates on
   one thread. Then small card-vs-CPU runs: the ``nips``, ``dueling``,
   prioritized and C51 recipes (4 lanes, as phase 3 runs its own); one
   forward and 1 and 3 updates of the ``nips`` ``ConvQ``, ``DuelingDQN``
   and ``C51Q`` cores at 84x84x4, and a burst of 4 pipeline updates, each
   difference in float32 ulps beside its tolerance (4x what ulp nudges of
   the weights move, at least 128); the pipeline's act stage, commit and
   sample exact. Then at full width ``train_dqn_ale.py --sim`` with
   ``--arch nature``, ``nips`` and ``dueling``, with ``--prioritized``
   (the prefix-sample kernel at C = 2**20, B = 32, once per update) and
   ``train_categorical_dqn_ale.py --sim``: 64 lanes, the 10**6-slot ring
   (28.3 GB, its bytes printed), through the replay start (cut to 4,096:
   64 scan steps), 8 timed and 4 profiled scan steps of 16 updates, the
   evaluation loop; each path freed before the next. Last the pipeline
   (``train_dqn_pipeline_ale.py --sim``: 3 spawned actor processes x 96
   lanes of ``SyntheticALE``, the 999,936-plane ring, 7.06 GB, bursts of
   64) through its replay start (cut to 10,000), then 2 s timed and 1 s
   profiled, then on to the burst of the first target sync (its interval
   moved to 2,048 transitions): env-steps/s, updates/s, the act round trip (median and p90,
   apart by whether a burst was in flight), burst and commit times, target
   syncs (at least 1), the workers' start-up, the busy share; then a clean
   stop;
15. the host-env object path: small card-vs-CPU runs, on the same weights
   and draws, of the ``DQN`` shell over a prioritized ring (the kernel once
   per update, C = 2**14) through ``train_agent_with_evaluation``, of the
   ``REINFORCE`` shell at ``train_reinforce_gym.py``'s widths over two and
   more update batches, and of the ``DoubleDQN`` shell through
   ``train_agent_batch_with_evaluation`` over a 4-lane ``SerialVectorEnv``,
   each on the port's CartPole behind ``HostTorchEnv``: actions, counts and
   evaluation rows equal, every learned tensor within 3e-6 or 4x what ulp
   nudges of the weights move it. Then ``dqn-batch-ale-8``
   (``train_dqn_batch_ale.py``'s ``run_batch`` at its settings,
   ``experiments/atari_dqn_batch.py``: the ``DQN`` shell over the
   10**6-slot ring, 28.3 GB, and 8 + 8 spawned ``SyntheticALE`` workers)
   one batch step at a time through its replay start (cut to 2,000) and
   its target sync (moved to 2,048) to t = 2,368, then one evaluation of 3 episodes: env-steps/s
   before the replay start and after it (past the 32 profiled batch steps
   that follow it), updates/s, the median ``batch_act``,
   env round trip, ``batch_observe`` and update ms, the workers' start-up,
   the target syncs, 32 profiled batch steps' kernels and busy share; 0
   kernel launches; the ring freed;
16. the remaining host shells: small card-vs-CPU runs, on the same weights
   and draws, of ``DDPG`` (hard targets), ``TD3`` (two lanes, bursting),
   ``SoftActorCritic`` and ``PPO`` on the 50-step Pendulum, ``TRPO`` on a
   MujocoSim, ``A2C`` on four CartPole lanes and the eight value-family
   shells over PER on CartPole (the kernel once per update): discrete
   actions, counts and evaluation rows equal, continuous actions and every
   learned tensor within 4x what ulp nudges of the weights move them, and
   at least C22's 3e-6 (the value shells' CartPole stepped on the CPU for
   the card's agent too: ROADMAP C.1). Then the paths of
   ``profile_host.HOST_PATHS`` at their scripts' widths and settings, each
   through its ``make_*_agent``, ``HostTorchEnv`` (the env on the CPU) and
   its driver, then one evaluation: SAC, TD3 and DDPG over ``MujocoSim(17, 6)`` through the
   replay start and burn-in (cut to 1,000) to t = 1,200, TD3 also over 4 lanes with
   ``--update-burst``; PPO to t = 2,080 (one update) and TRPO to 5,024
   (one) over ``MujocoSim(11, 3)``; SlimeVolley Rainbow on its CartPole
   backend from a replay start cut to 128 to t = 192 through the target sync moved to 160 (the target equal
   to the online network), its 10**6-transition ring sampled by the
   prefix-sample kernel at C = 2**20 once per update: env-steps/s before
   and after the learning start, updates/s, the median act, env step,
   observe and update ms, kernels per update and the busy share over 32
   profiled batch steps, the launches (0 on every other new path) and the
   ring's bytes;
17. the actor-learner path: the ``DQN`` shell's actor-learner half in
   lockstep on the card and on the CPU, from the same weights and draws
   (one actor's pre-filled transition queue drained by the poller, which
   is then stopped; the server's padded act of 3 rows in 8 slots; 31
   updates of the learner loop), over the uniform ring and over PER
   through ``DoubleDQN`` (C = 2**14, the prefix-sample kernel once per
   update, its draws the plain version's): the ring rows, the sampled ids,
   the actions, the counts equal, the statistics within 1e-4 and every
   learned tensor within 3e-6 or 4x what ulp nudges move it. Then
   ``dqn-actor-learner-ale-8`` (``train_dqn_batch_ale.py --actor-learner``
   at its settings, ``experiments/atari_dqn_batch.run_actor_learner``: 8
   actor threads of one ``SyntheticALE`` lane through one batched
   inference server, the poller and the learner over the 10**6-slot ring,
   28.3 GB, a publication every 8 updates) through its replay start (cut
   to 400) to the learner's 32nd update, with one ``AsyncEvaluator``
   evaluation of 3 episodes (``eval_interval`` cut to 800):
   env-steps/s before the replay start and after it (to the learner's
   32nd update), updates/s, rows per forward, the act round trip (median, p90; apart by
   whether an update ran during it), the poller's add and the learner's
   update ms, publications and target syncs, kernels per update and the
   busy share over the last 16 updates (profiled from the learner's
   thread); 0 kernel launches; the ring freed. Last
   ``a3c-atarisim-16`` (``train_a3c.py --sim``: 16 AtariSim lanes, t_max
   5, 20 timed iterations, kernels and busy share over one, evaluation
   5 x 500).
18. persistence and checkpoints, with no JAX: (1) per-dqn-ale-64's train
   state at the end of phase 14's run ``--save-to``'d (``train_state.pt``,
   its bytes and seconds printed), then ``train_dqn_ale.py --sim
   --prioritized --load --demo`` through ``atari_dqn_ale.run_sim`` on a
   fresh full-width runner: the loaded state equal to the saved one to the
   bit (moments and ``n_updates`` too), the demo's 5 returns equal to an
   evaluation of the state in memory on the same draws; (2) a resume
   through the kernel: the same recipe with the ring cut to 131,072 slots
   (C = 2**17) and the replay start to 1,024, 15 scan steps through it,
   3 with updates, ``save_runner_snapshot`` (a 3.7 GB file), 3 more (run
   A); a fresh runner loads the snapshot (equal to the saved state to the
   bit: ring, cursor, trees, generator state, ``t``) and runs the same 3
   (run B): the first resumed step's kernel draws the same slots in A and
   B, B is held to A to the bit where two uninterrupted runs repeat to the
   bit on the card and within their spread where they do not, and A and B
   each launch the kernel 3 x 16 = 48 times; (3) ``PersistentReplayBuffer``
   at the cut size: one snapshot through ``snapshot_interval``, restored
   into a new buffer, equal to the bit; (4) the 26 ``zoo/`` checkpoints
   read by the port's msgpack reader and converted onto the card: greedy
   or mean actions on 256 seeded observations equal the CPU's away from
   ties (discrete: where the CPU's best two scores lie more than 1e-3
   apart, or 2**-5 of the best for the bf16 entries; continuous: within
   the larger of the zoo tests' 1e-5 (1e-6 for ACER) and 4x what ulp
   nudges of the CPU's weights move its actions, 2**-5 for bf16);
   ``--demo`` of ``dqn/cartpole``,
   ``sac/pendulum``, ``ppo/hopper_real`` and ``drqn/po_abc`` on the card
   and the CPU from the same start states, held as the zoo tests hold them
   (CartPole and PO-ABC lane by lane, the others' means within 0.01);
   (5) the pipeline: saved at the end of phase 14's run, loaded into a
   fresh pipeline, whose act servers' greedy actions on 256 frames equal
   the saved pipeline's;
19. structured observations and NAF: small card-vs-CPU runs of the
   grasping ``DoubleDQN`` shell over PER with ``(image, steps)``
   observations (C = 2**14; the ring rows of both leaves, each call's
   sampled ids against the plain version, the actions and counts equal),
   of NAF on ``train_dqn_gym.py``'s device runner (Pendulum, MountainCar;
   4 lanes) and through its host shell on Pendulum, and of the C51 host
   mode on CartPole; then ``grasping-dqn-batch-1`` (``train_dqn_batch_grasping.py
   --jax-env`` at its settings through ``experiments/grasping_dqn_batch.py``,
   one spawned worker each for training and evaluation; the ring cut to
   400,000 slots, 68.0 GB, C = 2**19, or to 262,144 where the free memory
   forbids it; the replay start to 256; 64 updates, one kernel launch
   each; 20 evaluation episodes; its PER add, update, act and round
   trip, kernels per update and busy share), ``naf-pendulum-32``,
   ``naf-mountaincar-32`` and ``dqn-gym-cartpole-32`` (64 scan steps of
   32 lanes, the target held to the online net at the sync at 2,048, then
   ``EvalLoop``) and ``naf-pendulum-host-32`` and
   ``c51-gym-cartpole-host-1`` (the host modes past their sync at 2,048
   from a replay start cut to 896 to t = 1,088 through the sync moved to 1,024, one evaluation), each of these asserting 0 launches.

20. the five example recipes and the mesh. Small card-vs-CPU runs of
   ``train_iqn.py --sim``'s IQN at its widths (4 lanes, in float32 ulps
   against the nudges), the quickstart's device runner, ``train_ppo.py
   --jax-env pendulum``'s PPO (4 lanes, 3 iterations), and through their
   drivers the PPO shell of ``train_ppo_pendulum.py`` (8 lanes, one update),
   the atlas SAC shell (4 lanes, 104 updates) and the quickstart's host-loop
   DQN shell, their envs stepped on the CPU. Then the mesh: a mesh of one
   NCCL rank on the card against no mesh, Nature DQN over the uniform ring
   and over PER (13 kernel launches each run) and PPO, and every core of
   the mesh's later branches at its small run's sizes (DRQN on PO-ABC,
   recurrent IQN on DelayedCue and ACER on ABC over the episodic buffers,
   continuous ACER, IQN-CartPole, SAC and TD3, Rainbow-CartPole's noisy
   net over PER at B = 64 with 18 kernel launches each run, TRPO,
   recurrent PPO and TRPO), every learned tensor, metric, tree, episodic
   table and carry equal to the bit, and a runner snapshot saved and
   resumed on the mesh equal to the uninterrupted run; two spawned Gloo
   ranks on the host CPU (DQN and IQN on CartPole, DRQN on DelayedCue
   over the episodic buffer) with every learned tensor equal to the bit. Then at full width
   ``iqn-atarisim-64`` (the 10^5-slot ring, 2.83 GB; the replay start cut to
   2,048, the target sync moved to 3,000, the target equal
   to the online net after it; ``EvalLoop`` 5 x 500),
   ``ppo-pendulum-device-64`` (two iterations of 8,192 transitions and 1,280
   Adam steps, the busy share over the second's collect and first epoch;
   ``EvalLoop`` 10 x 200), ``quickstart-dqn-cartpole-32`` (as phase 10's
   recipes), ``ppo-pendulum-host-8`` (to t = 2,304, its first update),
   ``sac-atlas-pendulum-host-4`` (4 spawned workers each for training and
   evaluation, started together; the replay start cut to 512, 132
   updates, 4 evaluation episodes), ``quickstart-dqn-cartpole-host-1`` (to
   t = 800) and
   ``dqn-multihost-ale-8`` (``train_dqn_batch_ale.py --multihost`` at world
   size 1 over NCCL, the 10^6-slot ring sharded over the mesh, 28.3 GB; the
   replay start cut to 400, one chunk of 100 scan steps, 102 updates),
   each printing env-steps/s, updates/s, its phases' ms and the device's
   busy share; none launches the kernel.
21. ``drqn-atarisim-32-mesh``: ``train_drqn_ale.py --sim`` at full width
   (LSTM 512 over single 84x84 frames, 32 lanes, the 5.85 GB episodic
   buffer with its carries stored, 8 batch-32 updates per scan step) on a
   mesh of one NCCL rank on the card against the same recipe without a
   mesh, both with cuDNN's deterministic algorithms, from the same weights
   and draws, one after the other: every learned tensor, metric, the
   carry, the buffer's tables and storage equal to the bit through the
   target sync (moved with phase 12's to 4,224; the replay start cut to 4,160: 24 updates);
   the mesh run's scan step and its busy share under
   ``torch.profiler``. It launches no kernel.
22. ``train_dqn_ale.py``'s host path (``atari_dqn_ale.run_ale``) over the
   ALE stand-in of ``tests/torch_ale_standin.py`` (ALE and its ROMs are not
   installed). Without gymnasium, ``make_atari`` must raise naming it, and
   the runs build ``make_atari``'s chain over the stand-in through its own
   helper. A small card-vs-CPU run of ``--prioritized`` at the example's
   Nature network (the ring cut to 512 slots, 49 updates; the same draws
   and weights): actions, counts and the ring equal, each sample's slots
   equal to the plain version's on the card's own tree, the learned
   tensors within 3e-6 or 4x the nudges, one kernel launch per update; the
   same run without ``--prioritized`` launches none. Then
   ``dqn-ale-host-per-1``: ``--prioritized`` at full width (Nature CNN,
   84x84x4 frames, batch 32, the 10^6-slot PER ring, 28.3 GB, C = 2**20),
   the replay start cut to 200 and the run to 400 steps (51 updates),
   its env-steps/s, updates/s, kernel launches and, over 16 profiled
   steps, the device's busy share and the kernel's device time; the kernel
   held against its plain version on the run's final tree.
23. Siblings and JAX checkpoints (``run_siblings_and_checkpoints``), each
   on the card against the CPU and against the CPU with the weights and
   inputs nudged by 1 +- 2^-23 (every tensor within 4x the larger nudge,
   or 3e-6 where that is more): the batch-norm critics
   ``FCBNLateActionSAQFunction`` and ``FCBNSAQFunction`` at the DDPG
   example's widths (HalfCheetah's 17 observations and 6 actions, 400
   channels, 2 layers, batch 100; ``experiments/bn_critic.py``), 60
   train-mode Adam steps toward a fixed target, then an evaluation forward
   on the running statistics (weights, running statistics, Q-values; ms
   per train step); ``FCLSTMSAQFunction`` at 400 channels, batch 100,
   unrolled 100 steps from ``initial_carry`` (Q-values and carry);
   ``EmpiricalNormalization`` over 50 batches of 2,048 x 17 with ``until``
   100,000, the 50th update frozen (state, ``normalize``, ``inverse``);
   ``RMSpropEpsInsideSqrt`` at the Nature DQN settings, momentum 0 and 0.9,
   40 steps over the Nature CNN's parameters (parameters and state; ms
   per step); and the Nature-CNN DQN core of ``train_dqn_ale.py --sim``
   after 80 Adam updates, written in the JAX package's layout
   (``convert.save_flax_checkpoint``), read back by the port's reader into
   a fresh core and compared to the bit (bytes, write and read seconds).
   No path of it launches the kernel;
24. the command lines of ``examples/``, each through its port module's
   ``run(argv)`` at its example's widths (default lanes, ring and batch)
   with explicit small depth flags (``--steps``, ``--replay-start-size``,
   ``--chunk``, ``--eval-interval``), each checked to stop where its flags
   say with its updates run: ``train_dqn.py --sim`` (then ``--save-to`` and
   ``--load --demo`` in a fresh runner, the weights equal to the bit),
   ``train_rainbow.py`` (the prefix-sample kernel at C = 2**17, B = 32 once
   per update, then held against its plain version on the run's leaves),
   ``train_dqn_batch_ale.py`` in its batch and ``--actor-learner`` modes
   over ``SyntheticALE``, ``train_iqn.py`` without ``--sim``, ``train_a2c_ale.py``
   and ``train_ppo_ale.py --sim``, ``train_acer_ale.py``,
   ``train_categorical_dqn_ale.py`` and ``train_drqn_ale.py --sim``,
   ``train_a3c.py``, ``train_dqn_cartpole.py``, ``train_ppo.py --jax-env
   pendulum``, ``train_reinforce_gym.py`` and
   ``optuna_dqn_cartpole.objective`` with a stand-in trial. Every command
   line but Rainbow's asserts 0 launches;
25. the learning-curve entry point (``experiments/record_curves.py``):
   ``acer_abc`` and ``rppo_delayed_cue`` trained through ``record_curves.run``
   to their successful scores within their own ``steps`` caps, on the seeds
   that solved in the card runs (``CURVE_QUICK``); ``rppo_delayed_cue``
   again, paused after its first evaluation with its snapshot kept (as a
   run cut there ends) and resumed, its rows equal to the uninterrupted
   run's but for ``elapsed``; then ``rainbow_cartpole`` through
   ``curve_loop`` at a cut depth (``RAINBOW_CURVE_*``: the replay start and
   one evaluation interval), the prefix-sample kernel at C = 2**17, B = 64
   once per update, then held against its plain version on the run's
   leaves.

Every phase runs under ``phase``'s watchdog: ``faulthandler`` dumps every
thread's stack to stderr and ends the run with exit code 1 once a phase
passes its limit in ``PHASE_LIMITS`` (max(60 s, 3x its seconds in the
final card run)). Each phase prints ``phase <name>: start`` before it runs
(stderr also gets its limit) and its seconds after, line-buffered, so a run
that is cut shows where it was. The first lines print the card, the host's
CPU model (hosts differ 1.2-2.2x on the same phases) and the versions.

The kernels' launch counts are set to 0 just before each full-width path
and read just after it; the kernels' JSON line gives their sum over the
paths, the record the count of each. The last lines of the output are the
kernels' JSON line, the card's name and power limit, and
``{"ok": true, "device": {...}}``. The full record goes to
``chiprun_out/chip_smoke.json``.
"""

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
OUT_DIR = HERE / "chiprun_out"

# H100 SXM, dense, from NVIDIA's data sheet: HBM rate and fp32 (non-tensor) rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

HOST_TURNS = 6  # host timings alternate direction this many times; median kept

FULL_STEPS_WARM = 32   # t = 2,048 at the end: the first updates run
FULL_STEPS_TIMED = 16  # t = 3,072 at the end (cut from 64 for the time limit; the target sync is Rainbow's to cross)

RAINBOW_STEPS = 128     # t = 8,192 at the end: the target sync on the last step (cut from 500)
# The recipe's target sync every 32,000 and replay start of 20,000, moved to
# 8,192 and 7,680 for the time limit (from 32,000 and 31,040): 9 scan steps
# and 144 updates up to the sync (16 and 256 before).
RAINBOW_SYNC = 8_192
RAINBOW_REPLAY_START = 7_680
RAINBOW_STEPS_WARM = 4  # the first scan steps with updates, before the timed ones
UNIFORM_STEPS_TIMED = 16  # cut from 32 for the time limit

MUJOCO_STEPS_WARM = 4      # the first scan steps with updates (from t = 1,024), before the timed ones
MUJOCO_STEPS_TIMED = 8     # 256 updates (cut from 96, then 24, for the script's time limit)
MUJOCO_EVAL = (5, 1_000)   # lanes, steps: the truncation at step 1,000 is crossed
DDPG_STEPS_WARM = 2
DDPG_STEPS = 205           # every lane is truncated at its step 200 (cut from 405: twice, at 200 and 400)
DDPG_EVAL = (10, 201)
# ppo: cut from 10 (then 8); ppo-pendulum from 10 (then 5) and trpo from 10 to 2, one truncation
# per lane; a2c from 200: for the time limit
ONPOLICY_ITERATIONS = {"ppo": 4, "ppo-pendulum": 2, "trpo": 2, "a2c": 100}
ONPOLICY_EVAL = {"ppo-pendulum": (10, 201), "trpo": (10, 201), "a2c": (10, 501)}
CARTPOLE_STEPS = (32, 32)           # warm, timed: t = 1,024 (first updates), then 2,048 (timed cut from 64)
CARTPOLE_EXAMPLE_STEPS = (8, 8)     # 128 lanes: t = 1,024 (first updates), then 2,048 (timed cut from 16)
CARTPOLE_BATCH = 64                 # Rainbow-CartPole's minibatch: the kernel's B
BF16_ULP = 2.0 ** -8                # bf16 keeps 8 significant bits
BF16_LOSS_ULPS = 8                  # small bf16 runs, card vs CPU: losses and outputs
BF16_CHANGE_ULPS = 16               # ... each network's change over the run (L2)
BF16_SENSITIVITY = 4                # ... or this many times what a 1-ulp nudge of the weights moves on the CPU
BENCH_CHUNK, BENCH_REPS, BENCH_ROUNDS = 8, 2, 2  # bench.py: 200, 2, 3 (chunk cut from 16 for the time limit)
BENCH_WARM_CHUNKS = 4               # 32 scan steps: the first updates on the last (replay start 2,000)
BF16_PER_DQN_STEPS_TIMED = 8        # after FULL_STEPS_WARM (cut from 32 for the time limit)
BF16_PPO_ITERATIONS = 2             # PPO on MujocoSim at bf16 (cut from 4: its truncations are the fp32 run's to show)
SAC_PENDULUM_STEPS = (64, 32)       # warm (t = 1,024: burn-in done, first updates), timed (cut from 96)
FP32_ULP = 2.0 ** -23               # float32 keeps 24 significant bits
FP32_LOSS_ULPS = 128                # small recurrent runs, card vs CPU: each metric (1.5e-5 of its largest)
FP32_CHANGE_ULPS = 128              # ... each network's change over the run (L2); the largest difference read
                                    # so far is 38.22 ulps (drqn-delayedcue's carry; a 1-ulp nudge moves it 7.00)
# DRQN-AtariSim at full width: the replay start and the target interval are
# moved from 10,000 and 10,000 (then 9,024 and 10,000) to 4,160 and 4,224
# transitions for the time limit: 130 scan steps of 32 lanes, just past the
# first rows sealed by filling at 128 steps; the timed chunk runs to
# t = 4,224, the scan step of the target sync, where the target must equal
# the online net.
DRQN_ATARI_REPLAY_START = 4_160
DRQN_ATARI_SYNC = 4_224
DRQN_ATARI_STEPS = (130, 2)         # warm (through replay start), timed (cut from 282, 31)
DRQN_ATARI_PROFILED = 2             # scan steps under torch.profiler: the device's busy time (cut from 4)
RECURRENT_FULL_STEPS = {"drqn-po-abc-16": (10, 54), "drqn-delayedcue-16": (18, 46), "riqn-delayedcue-16": (18, 46),
                        "rppo-delayedcue-16": (1, 9), "rtrpo-delayedcue-16": (1, 9)}  # warm, timed
# ACER-AtariSim at full width, the example's replay start of 10,000 cut to
# 832 for the time limit (the first rows sealed at step 50): 52 scan steps
# of 16 lanes, acting only but for the first update on the last of them,
# then timed scan steps of one batch-16 update each.
ACER_ATARI_REPLAY_START = 832
ACER_ATARI_STEPS = (52, 40)         # warm (through replay start), timed (cut from 625, 100)
ACER_ATARI_PROFILED = 4             # scan steps under torch.profiler: the device's busy time
ACER_NUDGES = (1.0 + 2.0**-23, 1.0 - 2.0**-23)  # the small ACER runs' tolerance: the larger of both nudges
# timed, after one warm iteration (cut from 40 and 4 for the time limit)
ATARI_ONPOLICY_ITERATIONS = {"a2c-atarisim-16": 20, "ppo-atarisim-8": 2}
# The Atari examples at their own settings but the replay start (50,000, cut
# to 20,000 for the script's time limit): 313 scan steps of 64 lanes reach it
# (t = 20,032, the first 16 updates on the last of them), then timed and
# profiled scan steps of 16 updates each.
EXAMPLE_REPLAY_START = 4_096        # cut from the examples' 50,000 (then 20,000) for the time limit
EXAMPLE_ATARI_STEPS = (64, 4, 2)    # warm (cut from 313), timed (cut from 8), profiled (cut from 4)
PIPELINE_SECONDS = (2.0, 1.0)       # the pipeline after its replay start: timed, profiled (cut from 10, 5; 4, 2)
# The pipeline's replay start and target interval, moved from the example's
# 50,000 and 10,000 transitions for the time limit: the first sync comes at
# the 512th update (from the 2,500th), in the burst of 64 that ends at 576.
PIPELINE_REPLAY_START = 10_000
PIPELINE_SYNC = 2_048
PIPELINE_MIN_UPDATES = 576          # on to the burst holding the first target sync (cut from 2,560)


# ------------------------------------------------------------ phases and their watch
# Each phase's limit in seconds: max(60, 3 x its seconds in the last full
# card run of this script that set them, PERF.md section 6); every phase
# must have one. A phase that runs past its limit dumps every thread's stack
# to stderr and ends the run with exit code 1.
PHASE_LIMITS = {
    "build": 60, "frame ops": 60, "kernel checks": 60, "small per-dqn": 60, "small rainbow": 60, "small dqn": 60,
    "small double-dqn": 60, "small sac": 60, "small td3": 60, "small ddpg": 60, "full per-dqn": 60,
    "full rainbow": 60, "full dqn": 60, "full double-dqn": 60, "full sac": 60, "full td3": 60, "full ddpg": 60,
    "small ppo": 60, "small a2c": 60, "small trpo": 60, "full ppo": 60, "full ppo-pendulum": 60, "full trpo": 60,
    "full a2c": 60, "small dqn-cartpole": 60, "small c51-cartpole": 60, "small rainbow-cartpole": 60,
    "small al-cartpole": 60, "small iqn-cartpole": 60, "small dqn-cartpole-example": 60, "small pal": 60,
    "small double-pal": 60, "small dpp": 60, "small double-iqn": 60, "small boltzmann": 60,
    "small exponential-decay": 60, "small noisy NatureQ": 60, "full dqn-cartpole": 60, "full c51-cartpole": 60,
    "full rainbow-cartpole": 60, "full al-cartpole": 60, "full iqn-cartpole": 60, "full dqn-cartpole-example": 60,
    "small dqn-bf16": 60, "small per-dqn-bf16": 60, "small c51-cartpole-bf16": 60, "small iqn-cartpole-bf16": 60,
    "small sac-pendulum-bf16": 60, "small ppo-bf16": 60, "small noisy NatureQ bf16": 60,
    "full dqn-atarisim-64 fp32/bf16 A/B": 60, "full per-dqn bf16": 60, "full sac-pendulum bf16": 60,
    "full ppo bf16": 60, "small drqn-po-abc": 60, "small drqn-delayedcue": 60, "small riqn-delayedcue": 60,
    "small drqn-atarisim": 60, "small rppo-delayedcue": 60, "small rtrpo-delayedcue": 60,
    "small drqn-atarisim-bf16": 60, "full drqn-atarisim-32": 60, "full drqn-po-abc-16": 60,
    "full drqn-delayedcue-16": 60, "full riqn-delayedcue-16": 60, "full rppo-delayedcue-16": 60,
    "full rtrpo-delayedcue-16": 60, "small acer-abc": 60, "small acer-continuous-abc": 60, "small acer-atarisim": 60,
    "small acer-atarisim-bf16": 60, "full acer-atarisim-16": 60, "full a2c-atarisim-16": 60,
    "full ppo-atarisim-8": 60, "small dqn-ale-nips": 60, "small dqn-ale-dueling": 60, "small per-dqn-ale": 60,
    "small c51-atarisim": 60, "small example cores": 60, "small pipeline": 60, "full dqn-ale-nature-64": 60,
    "full dqn-ale-nips-64": 60, "full dqn-ale-dueling-64": 60, "full per-dqn-ale-64": 60, "full c51-atarisim-64": 60,
    "full dqn-pipeline-288": 66, "small host-per-dqn-cartpole": 60, "small host-reinforce-cartpole": 60,
    "small host-double-dqn-batch-4": 60, "full dqn-batch-ale-8": 60, "small host-ddpg-pendulum-hard": 60,
    "small host-td3-pendulum-batch-2-burst": 60, "small host-sac-pendulum": 60, "small host-ppo-pendulum": 60,
    "small host-a2c-cartpole-batch-4": 60, "small host-trpo-mujocosim": 60, "small host-per-al-cartpole": 60,
    "small host-per-pal-cartpole": 60, "small host-per-doublepal-cartpole": 60, "small host-per-dpp-cartpole": 60,
    "small host-per-categoricaldqn-cartpole": 60, "small host-per-categoricaldoubledqn-cartpole": 60,
    "small host-per-iqn-cartpole": 60, "small host-per-doubleiqn-cartpole": 60, "full sac-halfcheetah-host-1": 60,
    "full td3-halfcheetah-host-1": 60, "full ddpg-halfcheetah-host-1": 60, "full td3-halfcheetah-host-4-burst": 60,
    "full ppo-hopper-host-1": 60, "full trpo-hopper-host-1": 60, "full rainbow-slimevolley-cartpole-1": 60,
    "small actor-learner-dqn": 60, "small actor-learner-per-double-dqn": 60, "full dqn-actor-learner-ale-8": 68,
    "full a3c-atarisim-16": 60, "persistence": 100, "small host-grasping-double-dqn": 60,
    "small host-naf-pendulum": 60, "small host-c51-cartpole": 60, "small naf-pendulum": 60,
    "small naf-mountaincar": 60, "full grasping-dqn-batch-1": 60, "full naf-pendulum-32": 60,
    "full naf-mountaincar-32": 60, "full dqn-gym-cartpole-32": 60, "full naf-pendulum-host-32": 60,
    "full c51-gym-cartpole-host-1": 60, "small iqn-atarisim": 60, "small quickstart-dqn-cartpole": 60,
    "small ppo-pendulum-device": 60, "small host-ppo-pendulum-8": 60, "small host-sac-atlas-pendulum-4": 60,
    "small host-quickstart-dqn-cartpole": 60, "mesh": 80, "full iqn-atarisim-64": 60,
    "full ppo-pendulum-device-64": 85, "full quickstart-dqn-cartpole-32": 60, "full ppo-pendulum-host-8": 60,
    "full sac-atlas-pendulum-host-4": 69, "full quickstart-dqn-cartpole-host-1": 60, "full dqn-multihost-ale-8": 60,
    "full drqn-atarisim-32-mesh": 60, "small dqn-ale-host-per": 60, "full dqn-ale-host-per-1": 60,
    "siblings and JAX checkpoints": 60, "cli train_dqn.py --sim": 60, "cli train_rainbow.py": 60,
    "cli train_dqn_batch_ale.py": 60, "cli device loops": 60, "cli reinforce and optuna": 60, "curves": 97,

}
PHASE_TIMES = {}  # name -> seconds, as the phases end


def phase(name, fn, *args, limit=None):
    """``fn(*args)`` as the phase ``name``, under a watchdog of ``limit``
    seconds (default: its entry in ``PHASE_LIMITS``, which must have one):
    past it, ``faulthandler`` dumps every thread's stack to stderr and exits
    with code 1. It prints the phase's start and, once the card is idle, its
    seconds. Nothing is caught: a phase that raises fails the run."""
    import faulthandler

    limit = PHASE_LIMITS[name] if limit is None else limit
    print(f"phase {name}: start")
    print(f"phase {name}: start, limit {limit:.0f} s", file=sys.stderr, flush=True)
    faulthandler.dump_traceback_later(limit, exit=True)
    t0 = time.perf_counter()
    try:
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # the next path allocates a ring of its own
    finally:
        faulthandler.cancel_dump_traceback_later()
    PHASE_TIMES[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_TIMES[name]:.1f} s")
    return out


def host_cpu_model() -> str:
    """The host's CPU model, its CPU count and clock, from ``/proc/cpuinfo``
    (hosts differ 1.2-2.2x on the same phases)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    model = fields.get("model name", "unknown")
    if model == "unknown":  # some sandboxes hide the name: the family and model numbers identify it
        model = f"{fields.get('vendor_id', '?')} family {fields.get('cpu family', '?')} model {fields.get('model', '?')}"
    mhz = f", {fields['cpu mhz']} MHz" if fields.get("cpu mhz") else ""
    return f"{model}, {os.cpu_count()} CPUs{mhz}"


@contextlib.contextmanager
def spawned_workers_skip_this_script():
    """The host envs' spawned workers run the port's functions only: hide
    this script from ``multiprocessing``'s spawn, so
    that a worker does not re-run its top (which imports torch, seconds per
    process) before it starts."""
    main = sys.modules["__main__"]
    path = main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        if path is not None:
            main.__file__ = path


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    A sleep kernel first holds the stream, so the host enqueues all the
    calls before the device reaches them: the events then time the device
    work, not the host's cost of issuing it (see ``host_us``).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # tens of ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call of ``fn``, device work included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


class SeededDraws:
    """Draws from a seeded numpy stream, put on ``device``: two runs on two
    devices with one seed see the very same numbers."""

    def __init__(self, seed: int, device):
        self.rs = np.random.RandomState(seed)
        self.device = torch.device(device)

    def uniform(self, n: int) -> torch.Tensor:
        u = self.rs.randint(0, 1 << 24, n) / float(1 << 24)  # exact in float32
        return torch.from_numpy(u.astype(np.float32)).to(self.device)

    def randint(self, high: int, n: int) -> torch.Tensor:
        return torch.from_numpy(self.rs.randint(0, high, n).astype(np.int32)).to(self.device)

    def normal(self, n: int) -> torch.Tensor:
        return torch.from_numpy(self.rs.standard_normal(n).astype(np.float32)).to(self.device)

    def randint_below(self, high: torch.Tensor, n: int) -> torch.Tensor:
        """``high`` is a 0-d tensor on the device and stays there."""
        bits = torch.from_numpy(self.rs.randint(0, 1 << 62, n, dtype=np.int64)).to(self.device)
        return (bits % high).to(torch.int32)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.from_numpy(self.rs.permutation(n)).to(self.device)


# --------------------------------------------------------------------- phase 1
def build_kernels() -> dict:
    from pfrl_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build()
    seconds = time.perf_counter() - t0
    logs = {}
    for name in paths:
        log = (cuda_build.BUILD_DIR / f"{name}.log")
        logs[name] = log.read_text() if log.exists() else "(cached build)"
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    print(f"build: {len(paths)} kernel(s) in {seconds:.1f} s")
    return {"seconds": seconds, "logs": logs}


# --------------------------------------------------------------------- phase 2
def _integer_case(rs, c, b, device):
    prio = rs.randint(0, 5, c).astype(np.float32)
    prio[-max(c // 7, 1):] = 0.0  # an all-zero tail, counted past
    cs = np.cumsum(prio)
    total = float(cs[-1])
    targets = np.concatenate([
        rs.uniform(0.0, total, max(b - 4, 0)), [cs[c // 3], 0.0, total, total + 3.0]
    ])[:b].astype(np.float32)
    return torch.from_numpy(prio).to(device), torch.from_numpy(targets).to(device)


def _real_case(rs, c, live, b):
    """``live`` real-valued priorities as the PER buffer holds them, then
    zeros; stratified targets over the total."""
    prio = np.zeros(c, np.float32)
    prio[:live] = (rs.uniform(0.0, 1.0, live) + 0.01) ** 0.6
    total = float(prio.astype(np.float64).sum())
    targets = ((np.arange(b) + rs.uniform(size=b)) / b * total).astype(np.float32)
    return prio, targets


def _exact(got, want, what):
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if got.dtype != torch.int32 or got.shape != want.shape or err != 0:
        raise AssertionError(f"prefix_sample {what}: max |kernel - plain| = {err}")
    return err


def _bound_ms(c, b):
    # Least work: read the leaves and targets once, write the counts once;
    # one add per leaf for the prefix and a binary search per target.
    bytes_ms = (4 * c + 4 * b + 4 * b) / HBM_BYTES_PER_S * 1e3
    ops_ms = (c + b * math.ceil(math.log2(c))) / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_shape(device, c, live, batch) -> dict:
    """Device and host time of the kernel, of the plain version and of
    cumsum + searchsorted at one shape, and the kernel's occupancy."""
    from pfrl_tpu_torch.ops import prefix_sample as ps

    prio, targets = _real_case(np.random.RandomState(c), c, live, batch)
    p, t = torch.from_numpy(prio).to(device), torch.from_numpy(targets).to(device)
    kernel_fn = lambda: ps.prefix_sample(p, t)  # noqa: E731
    plain_fn = lambda: ps.prefix_sample_reference(p, t)  # noqa: E731
    library_fn = lambda: torch.searchsorted(torch.cumsum(p, 0), t, right=True)  # noqa: E731
    ms, plain_ms, library_ms = (time_ms(f) for f in (kernel_fn, plain_fn, library_fn))
    # The host's speed drifts within a run: host times are taken in turns,
    # forward and backward, and each is the median of its turns.
    fns = [("kernel", kernel_fn), ("plain", plain_fn), ("library", library_fn)]
    turns = {k: [] for k, _ in fns}
    for r in range(HOST_TURNS):
        for k, f in fns if r % 2 == 0 else fns[::-1]:
            turns[k].append(host_us(f))
    host = {k: statistics.median(v) for k, v in turns.items()}
    bound_ms, bound_by = _bound_ms(c, batch)
    return {
        "shape": {"C": c, "B": batch, "live_leaves": live},
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "host_us_per_call": host,
        "host_us_turns": turns,
        "cluster_info": ps.cluster_info(c),
    }


def check_prefix_sample(device, tree_leaves: int, batch: int, large_leaves: int, grasping_leaves: int) -> dict:
    """The kernel against ``prefix_sample_reference`` on the card, then its
    times at the main path's shape, at ``large_leaves`` and at
    ``grasping_leaves`` (``grasping-dqn-batch-1``'s tree, with the live
    leaves its run ends with).

    Integer-valued priorities sum exactly in any order: the counts must be
    equal. Real-valued ones may differ only where a target lies within
    ``1e-6 * total`` of a cumulative boundary (float64 cumsum as judge).
    """
    from pfrl_tpu_torch.ops import prefix_sample as ps

    rs = np.random.RandomState(0)
    max_err = 0
    # (C, B, leading leaves cut off, so the view starts 4 bytes past 16).
    cases = ((tree_leaves, batch, 0), (large_leaves, batch, 0), (3 * 1024 + 517, 5, 0),
             (200_001, 200, 0), (5, 8, 0), (tree_leaves, 1000, 0), (tree_leaves + 3, batch, 1),
             (tree_leaves, CARTPOLE_BATCH, 0), (grasping_leaves, batch, 0))
    for c, b, cut in cases:
        p, t = _integer_case(rs, c, b, device)
        p = p[cut:]
        want = ps.prefix_sample_reference(p, t)
        err = _exact(ps.prefix_sample(p, t), want, f"C={c - cut} B={b}")
        if (c, b, cut) == (tree_leaves, batch, 0):
            max_err = err

    # The main path's leaves: 100,000 live real-valued priorities, then
    # zeros, at both batches of the paths that sample by priority.
    real_mismatches = 0
    for b in (batch, CARTPOLE_BATCH):
        prio, targets = _real_case(rs, tree_leaves, 100_000, b)
        total = float(prio.astype(np.float64).sum())
        p = torch.from_numpy(prio).to(device)
        t = torch.from_numpy(targets).to(device)
        got = ps.prefix_sample(p, t).cpu().numpy()
        want = ps.prefix_sample_reference(p, t).cpu().numpy()
        cs64 = np.cumsum(prio.astype(np.float64))
        for g, w, tb in zip(got, want, targets):
            if g != w:
                real_mismatches += 1
                lo, hi = sorted((int(g), int(w)))
                if np.max(np.abs(cs64[lo:hi] - tb)) > 1e-6 * total:
                    raise AssertionError(f"prefix_sample real-valued B={b}: {g} vs {w} at target {tb}")

    main = time_shape(device, tree_leaves, 100_000, batch)
    large = time_shape(device, large_leaves, 1_000_000, batch)
    b64 = time_shape(device, tree_leaves, 100_000, CARTPOLE_BATCH)
    grasping = time_shape(device, grasping_leaves, GRASPING_REPLAY_START + GRASPING_UPDATES, batch)
    return {
        "name": "prefix_sample",
        "route": "cuda",
        "source": "pfrl_tpu_torch/csrc/prefix_sample.cu",
        "replaces": "pfrl_tpu/ops/pallas_kernels.py:162",
        "max_abs_err": max_err,
        **main,
        "cluster": ps.CLUSTER,
        "real_valued_mismatches_within_rounding": real_mismatches,
        "large": large,
        "b64": b64,
        "grasping": grasping,
    }


def print_shape(r: dict, card: str) -> None:
    info = r["cluster_info"]
    print(
        f"prefix_sample C={r['shape']['C']} B={r['shape']['B']}: kernel {r['ms'] * 1e3:.2f} us, "
        f"plain {r['plain_ms'] * 1e3:.2f} us, cumsum+searchsorted {r['library_ms'] * 1e3:.2f} us, "
        f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}); one cluster of {info['cluster']} "
        f"blocks, {info['max_active_clusters']} such at once, {info['smem_bytes_per_block']} bytes "
        f"of shared memory per block; "
        f"host us per call {json.dumps(r['host_us_per_call'])} on {card}"
    )


# --------------------------------------------------------------------- phase 3
def _small_configs() -> dict:
    """name -> (function making a 4-lane runner on a device, scan steps, kernel
    launches expected on the card). Updates start at 32 transitions and
    the target syncs at 48."""
    from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner
    from pfrl_tpu_torch.experiments.atari_rainbow import make_rainbow_runner

    small = dict(num_envs=4, replay_start_size=32, target_update_interval=48, minibatch_size=8)
    # The uniform runs take 2 updates per scan step from a ring that wraps,
    # and stop at 17 scan steps: from the 18th on, DQN's losses move by 1e-3
    # under a 1e-7 change of the weights (the target's max switches actions).
    uniform = dict(capacity=48, update_interval=2, **small)
    return {
        "per-dqn": (lambda dev: make_dqn_runner(prioritized=True, capacity=8196, device=dev, **small), 20, 13),
        "rainbow": (lambda dev: make_rainbow_runner(capacity=8196, steps=400, device=dev, **small), 20, 13),
        "dqn": (lambda dev: make_dqn_runner(device=dev, **uniform), 17, 0),
        "double-dqn": (lambda dev: make_dqn_runner(double=True, device=dev, **uniform), 17, 0),
    }


class _Differences:
    """Card-vs-CPU comparisons of one small run: the largest difference
    per quantity, raising where one exceeds its tolerance."""

    def __init__(self, name: str):
        self.name, self.largest, self.tolerance = name, {}, {}

    def close(self, what, a, b, rtol, atol) -> None:
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        self.largest[what] = max(self.largest.get(what, 0.0), float((a - b).abs().max()))
        self.tolerance[what] = f"atol {atol:g} + rtol {rtol:g}"
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"small {self.name}: {what} differs by {self.largest[what]} "
                                 f"(tolerance {self.tolerance[what]})")

    def summary(self) -> str:
        """Each largest difference beside its tolerance."""
        return "; ".join(f"{what} {d:.3g} ({self.tolerance[what]})" for what, d in self.largest.items())


def check_small_slice(name: str, build, steps: int, expect_launches: int, device, obs_atol: float = 0.0,
                      param_atol: float = 1e-6) -> dict:
    """A 4-lane run of one configuration on the card and on the CPU. The
    observations in the ring are equal (AtariSim's integer frames) or, for
    CartPole's float states, within ``obs_atol`` (``sin``/``cos`` round an
    ulp apart); the actions are equal; the parameters within ``param_atol``
    (and rtol 1e-4)."""
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    def run(dev):
        runner = build(dev)
        state = runner.init(0, draws=SeededDraws(0, dev))
        target0 = [p.detach().clone() for p in state.train_state.target_model.parameters()]
        state, metrics = runner.run_chunk(state, steps)
        synced = any(
            not torch.equal(a, b) for a, b in zip(target0, state.train_state.target_model.parameters())
        )
        return runner, state, metrics, synced

    before = prefix_sample.launches
    runner, gpu, gpu_m, gpu_synced = run(device)
    torch.cuda.synchronize()
    launches = prefix_sample.launches - before
    _, cpu, cpu_m, cpu_synced = run("cpu")
    updates = runner.config.updates_per_step * sum(
        1 for k in range(1, steps + 1) if k * runner.config.num_envs >= runner.config.replay_start_size
    )
    if launches != expect_launches or gpu.train_state.n_updates != updates:
        raise AssertionError(
            f"small {name}: {launches} kernel launches, {gpu.train_state.n_updates} updates, "
            f"{expect_launches} and {updates} expected"
        )
    if not (gpu_synced and cpu_synced):
        raise AssertionError(f"small {name}: no target sync")
    ring = lambda s: getattr(s.replay_state, "base", s.replay_state)  # noqa: E731
    if gpu.t != cpu.t or int(ring(gpu).cursor) != int(ring(cpu).cursor):
        raise AssertionError(f"small {name}: step counters differ")
    if not torch.equal(ring(gpu).storage["action"].cpu(), ring(cpu).storage["action"]):
        raise AssertionError(f"small {name}: replay rings differ in action")
    if not torch.allclose(ring(gpu).storage["obs"].cpu(), ring(cpu).storage["obs"], rtol=0.0, atol=obs_atol):
        raise AssertionError(f"small {name}: replay rings differ in obs")
    differences = _Differences(name)
    close, diffs = differences.close, differences.largest
    # fp32 on both sides (no TF32); convolutions reduce in other orders.
    close("loss", gpu_m["loss"], cpu_m["loss"], 1e-3, 1e-5)
    if not runner.buffer.iid_samples:
        close("tree", gpu.replay_state.tree, cpu.replay_state.tree, 1e-4, 1e-5)
    for which in ("model", "target_model"):
        pairs = zip(getattr(gpu.train_state, which).parameters(), getattr(cpu.train_state, which).parameters())
        for a, b in pairs:
            close(f"{which} parameters", a, b, 1e-4, param_atol)
    print(f"small {name}: card vs CPU agree over {steps} scan steps, {updates} updates, "
          f"{launches} kernel launches; largest differences {differences.summary()}")
    return {"steps": steps, "updates": updates, "kernel_launches": launches, "max_abs_diff": diffs}


# --------------------------------------------------------------------- phase 4
def _updates_in(cfg, first_step: int, last_step: int) -> int:
    """Gradient steps the runner takes in scan steps first_step..last_step."""
    return sum(
        cfg.updates_per_step for k in range(first_step, last_step + 1)
        if k * cfg.num_envs >= cfg.replay_start_size
    )


def _expected_beta(buffer, samples: int) -> float:
    """The float32 additions the buffer makes, one per sample."""
    beta, add = np.float32(buffer.beta0), np.float32(buffer.beta_add)
    for _ in range(samples):
        beta = min(np.float32(beta + add), np.float32(1.0))
    return float(beta)


def _raise_on_failed(path: str, checks: dict) -> None:
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{path}: failed checks {failed}")


def _precision(compute_dtype) -> str:
    return "fp32, no TF32" if compute_dtype is None else "bf16 over fp32 masters"


def run_full_slice(card: str, compute_dtype=None, timed_steps: int = FULL_STEPS_TIMED) -> dict:
    from pfrl_tpu_torch.experiments.atari_per_dqn import make_per_dqn_runner
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner = make_per_dqn_runner(compute_dtype=compute_dtype)  # the CUDA device, at full width
    if compute_dtype is not None:
        checked = _float32_after_updates(runner.core)
    cfg = runner.config
    state = runner.init(0)
    torch.cuda.synchronize()
    beta0 = float(state.replay_state.beta)
    target0 = [p.detach().clone() for p in state.train_state.target_model.parameters()]

    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, warm = runner.run_chunk(state, FULL_STEPS_WARM)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, timed = runner.run_chunk(state, timed_steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = prefix_sample.launches

    steps = FULL_STEPS_WARM + timed_steps
    samples = _updates_in(cfg, 1, steps)
    timed_updates = _updates_in(cfg, FULL_STEPS_WARM + 1, steps)
    loss = torch.cat([warm["loss"], timed["loss"]])
    leaves = state.replay_state.tree[runner.buffer.tree_capacity:][: runner.buffer.capacity]
    distinct = int(torch.unique(leaves[leaves > 0]).numel())
    beta = float(state.replay_state.beta)
    synced = any(not torch.equal(a, b) for a, b in zip(target0, state.train_state.target_model.parameters()))
    crossed = state.t // cfg.target_update_interval > 0

    bf16 = {} if compute_dtype is None else {
        "masters and moments float32 after every update": checked[0] == state.train_state.n_updates,
        "the network computes in bf16": _computes_in(runner.core, state, compute_dtype),
    }
    _raise_on_failed("full slice" if compute_dtype is None else "full per-dqn bf16", {
        **bf16,
        "t advanced": state.t == steps * cfg.num_envs,
        "loss finite": bool(torch.isfinite(loss).all()) and float(loss[-1]) > 0,
        "kernel launches == PER samples": launches == samples == state.train_state.n_updates,
        "priorities changed": distinct > 2,
        "beta annealed": beta > beta0 and math.isclose(
            beta, min(1.0, beta0 + samples * runner.buffer.beta_add), rel_tol=1e-4
        ),
        "target synced on crossing": synced == crossed,
    })
    timed_s = t2 - t1
    result = {
        "compute_dtype": str(compute_dtype),
        "steps": steps,
        "t": state.t,
        "kernel_launches": launches,
        "per_samples": samples,
        "launches_per_scan_step": cfg.updates_per_step,
        "env_steps_per_s": timed_steps * cfg.num_envs / timed_s,
        "updates_per_s": timed_updates / timed_s,
        "warm_chunk_s": t1 - t0,
        "timed_chunk_s": timed_s,
        "last_loss": float(loss[-1]),
        "beta": beta,
        "distinct_priorities": distinct,
        "target_synced": synced,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(
        f"{'slice' if compute_dtype is None else 'per-dqn bf16'}: env-steps/s {result['env_steps_per_s']:.1f} "
        f"updates/s {result['updates_per_s']:.1f} over {timed_steps} scan steps; {launches} prefix-sample "
        f"launches (64 lanes, {_precision(compute_dtype)}) on {card}"
    )
    return result


# --------------------------------------------------------------------- phase 5
def run_full_rainbow(card: str) -> dict:
    """Rainbow with the recipe's every value but the replay start
    and the target sync (``RAINBOW_REPLAY_START``, ``RAINBOW_SYNC``), cut to
    128 scan steps: no updates below 7,680 transitions, then 16 per scan
    step, and the target sync when the last step reaches 8,192."""
    from pfrl_tpu_torch.envs.atari_sim import AtariSim
    from pfrl_tpu_torch.experiments.atari_rainbow import make_rainbow_runner
    from pfrl_tpu_torch.experiments.runner import EvalLoop
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner = make_rainbow_runner(replay_start_size=RAINBOW_REPLAY_START, target_update_interval=RAINBOW_SYNC)
    cfg, buffer, core = runner.config, runner.buffer, runner.core
    state = runner.init(0)
    torch.cuda.synchronize()
    train = state.train_state
    target0 = [p.detach().clone() for p in train.target_model.parameters()]
    collect_steps = (cfg.replay_start_size - 1) // cfg.num_envs  # the last step with t < the replay start
    warm_end = collect_steps + RAINBOW_STEPS_WARM

    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, collect = runner.run_chunk(state, collect_steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches_collecting = prefix_sample.launches
    state, warm = runner.run_chunk(state, RAINBOW_STEPS_WARM)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, timed = runner.run_chunk(state, RAINBOW_STEPS - warm_end)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = prefix_sample.launches

    samples = _updates_in(cfg, 1, RAINBOW_STEPS)
    timed_updates = _updates_in(cfg, warm_end + 1, RAINBOW_STEPS)
    loss = torch.cat([warm["loss"], timed["loss"]])
    rs = state.replay_state
    leaves = rs.tree[buffer.tree_capacity:][: buffer.capacity]
    # Every slot enters at the running maximum (1 until the first feedback).
    fed_back = int(((leaves > 0) & (leaves != 1.0)).sum())
    beta = float(rs.beta)

    with torch.no_grad():
        av1 = core.action_value(train.model, state.obs, state.draws)
        av2 = core.action_value(train.model, state.obs, state.draws)
    row_sums = av1.q_dist.sum(-1)
    evaluator = EvalLoop(AtariSim(n_actions=6), core, num_episodes=5, max_steps=500)
    t4 = time.perf_counter()
    returns = evaluator.evaluate(train, state.draws)
    t5 = time.perf_counter()

    _raise_on_failed("rainbow", {
        "t advanced": state.t == RAINBOW_STEPS * cfg.num_envs == cfg.target_update_interval,
        "no update before replay start": launches_collecting == 0 and not bool(collect["loss"].any()),
        "loss finite and positive": bool(torch.isfinite(loss).all()) and bool((loss > 0).all()),
        "kernel launches == PER samples == n_updates": launches == samples == train.n_updates > 0,
        "priorities changed": fed_back > 0 and float(rs.max_priority) > 1.0,
        "beta annealed by beta_add per sample": beta > buffer.beta0
        and abs(beta - _expected_beta(buffer, samples)) <= 1e-7,
        "Adam's count == n_updates": train.opt_state.count == train.n_updates,
        "q_dist rows sum to 1": av1.q_dist.shape == (cfg.num_envs, 6, 51)
        and float((row_sums - 1.0).abs().max()) <= 1e-5,
        "noise differs between two act steps": not torch.equal(av1.q_dist, av2.q_dist),
        "target synced on the last step": all(
            torch.equal(a, b) for a, b in zip(train.model.parameters(), train.target_model.parameters())
        ) and any(not torch.equal(a, b) for a, b in zip(target0, train.target_model.parameters())),
        "5 finite evaluation returns": returns.shape == (5,) and bool(np.isfinite(returns).all()),
    })
    timed_steps, timed_s = RAINBOW_STEPS - warm_end, t3 - t2
    result = {
        "steps": RAINBOW_STEPS,
        "t": state.t,
        "kernel_launches": launches,
        "per_samples": samples,
        "launches_per_scan_step": cfg.updates_per_step,
        "env_steps_per_s": timed_steps * cfg.num_envs / timed_s,
        "updates_per_s": timed_updates / timed_s,
        "collect_only_env_steps_per_s": collect_steps * cfg.num_envs / (t1 - t0),
        "collect_chunk_s": t1 - t0,
        "warm_chunk_s": t2 - t1,
        "timed_chunk_s": timed_s,
        "timed_scan_steps": timed_steps,
        "eval_s": t5 - t4,
        "eval_returns": [float(r) for r in returns],
        "last_loss": float(loss[-1]),
        "beta": beta,
        "slots_off_the_initial_priority": fed_back,
        "max_priority": float(rs.max_priority),
        "adam_count": train.opt_state.count,
        "q_dist_max_row_sum_error": float((row_sums - 1.0).abs().max()),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(
        f"rainbow: env-steps/s {result['env_steps_per_s']:.1f} updates/s "
        f"{result['updates_per_s']:.1f} over {timed_steps} scan steps with updates; "
        f"{result['collect_only_env_steps_per_s']:.1f} env-steps/s over the {collect_steps} before "
        f"replay start; evaluation {result['eval_s']:.1f} s, returns {result['eval_returns']} "
        f"(64 lanes, fp32, no TF32) on {card}"
    )
    return result


# --------------------------------------------------------------------- phase 6
def run_full_uniform(card: str, double: bool) -> dict:
    """Nature DQN or Double DQN over the uniform ring at full width: one
    id draw per scan step, no kernel."""
    from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample
    from pfrl_tpu_torch.utils.draws import Draws

    class CountingDraws(Draws):
        id_draws, ids_drawn = 0, 0

        def randint_below(self, high, n):
            self.id_draws += 1
            self.ids_drawn += n
            return super().randint_below(high, n)

    name = "double-dqn" if double else "dqn"
    runner = make_dqn_runner(double=double)  # the CUDA device, at full width
    cfg = runner.config
    generator = torch.Generator(device=runner.device)
    generator.manual_seed(0)
    draws = CountingDraws(generator)
    state = runner.init(0, draws=draws)
    torch.cuda.synchronize()

    prefix_sample.launches = 0
    state, warm = runner.run_chunk(state, FULL_STEPS_WARM)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, timed = runner.run_chunk(state, UNIFORM_STEPS_TIMED)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    steps = FULL_STEPS_WARM + UNIFORM_STEPS_TIMED
    updates = _updates_in(cfg, 1, steps)
    update_steps = updates // cfg.updates_per_step
    loss = torch.cat([warm["loss"], timed["loss"]])
    _raise_on_failed(name, {
        "t advanced": state.t == steps * cfg.num_envs,
        "loss finite": bool(torch.isfinite(loss).all()) and float(loss[-1]) > 0,
        "n_updates as expected": state.train_state.n_updates == updates > 0,
        "one id draw per scan step": draws.id_draws == update_steps
        and draws.ids_drawn == updates * cfg.minibatch_size,
        "no kernel on this path": prefix_sample.launches == 0,
    })
    timed_s = t2 - t1
    result = {
        "steps": steps,
        "t": state.t,
        "n_updates": updates,
        "id_draws": draws.id_draws,
        "env_steps_per_s": UNIFORM_STEPS_TIMED * cfg.num_envs / timed_s,
        "updates_per_s": _updates_in(cfg, FULL_STEPS_WARM + 1, steps) / timed_s,
        "timed_chunk_s": timed_s,
        "last_loss": float(loss[-1]),
    }
    print(
        f"{name} (uniform ring): env-steps/s {result['env_steps_per_s']:.1f} updates/s "
        f"{result['updates_per_s']:.1f} over {UNIFORM_STEPS_TIMED} scan steps "
        f"(64 lanes, fp32, no TF32) on {card}"
    )
    return result


# ------------------------------------------------------------- phases 3, 7, 8
def _small_actor_critic_configs() -> dict:
    """name -> function making a 4-lane runner on a device: hidden 32,
    batch 16, updates from 32 transitions; episodes cut to 12 steps
    (MujocoSim) and 10 (Pendulum, burn-in 24 transitions) so that lanes are
    truncated and reset inside the run."""
    from pfrl_tpu_torch.envs.mujoco_sim import MujocoSim
    from pfrl_tpu_torch.envs.pendulum import Pendulum
    from pfrl_tpu_torch.envs.wrappers import NormalizeActionSpace, TimeLimit
    from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac

    small = dict(num_envs=4, capacity=96, replay_start_size=32, minibatch_size=16, hidden=32)
    pendulum = lambda dev: NormalizeActionSpace(TimeLimit(Pendulum(device=dev), 10))  # noqa: E731
    return {
        "sac": lambda dev: mac.make_sac_runner(env=MujocoSim(episode_len=12, device=dev), **small),
        "td3": lambda dev: mac.make_td3_runner(env=MujocoSim(episode_len=12, device=dev), **small),
        "ddpg": lambda dev: mac.make_ddpg_runner(env=pendulum(dev), update_interval=2, burnin_steps=24, **small),
    }


def _networks(train_state) -> dict:
    """name -> module, for every network of a train state; ACER's SDN model
    by its three parts (``model.pi``, ``model.vf``, ``model.adv``), which
    are conditioned apart (ROADMAP C48)."""
    nets = {}
    for k, v in vars(train_state).items():
        if isinstance(v, torch.nn.Module):
            parts = ("pi", "vf", "adv") if all(hasattr(v, p) for p in ("pi", "vf", "adv")) else ()
            nets.update({f"{k}.{p}": getattr(v, p) for p in parts} if parts else {k: v})
    return nets


def check_small_actor_critic(name: str, build, steps: int, device) -> dict:
    """A 4-lane run of SAC, TD3 or DDPG on the card and on the CPU from
    the same draws and weights: losses within rtol 1e-3 (floor 1e-5), every
    network's and target's parameters and SAC's temperature within 2e-5
    (fp32 on both sides; ``tanh``, ``exp`` and the dots' order differ)."""
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    def run(dev):
        runner = build(dev)
        state = runner.init(0, draws=SeededDraws(0, dev))
        state, metrics = runner.run_chunk(state, steps)
        return runner, state, metrics

    prefix_sample.launches = 0
    runner, gpu, gpu_m = run(device)
    torch.cuda.synchronize()
    launches = prefix_sample.launches
    _, cpu, cpu_m = run("cpu")
    cfg = runner.config
    updates = _updates_in(cfg, 1, steps)
    differences = _Differences(name)
    close, diffs = differences.close, differences.largest
    close("loss", gpu_m["loss"], cpu_m["loss"], 1e-3, 1e-5)
    close("reward_mean", gpu_m["reward_mean"], cpu_m["reward_mean"], 1e-4, 1e-5)
    for which, module in _networks(gpu.train_state).items():
        for a, b in zip(module.parameters(), getattr(cpu.train_state, which).parameters()):
            close(f"{which} parameters", a, b, 0.0, 2e-5)
    if name == "sac":
        close("temperature", gpu.train_state.log_temperature.exp(), cpu.train_state.log_temperature.exp(), 0.0, 2e-5)
    _raise_on_failed(f"small {name}", {
        "no kernel on this path": launches == 0,
        "n_updates as expected": gpu.train_state.n_updates == cpu.train_state.n_updates == updates > 0,
        "step counters agree": gpu.t == cpu.t == steps * cfg.num_envs
        and int(gpu.replay_state.cursor) == int(cpu.replay_state.cursor) == gpu.t,
        "episodes were truncated and reset": int(gpu_m["done_count"].sum()) == int(cpu_m["done_count"].sum()) > 0,
        "losses positive once updates run": bool((gpu_m["loss"][-1] > 0)),
    })
    print(f"small {name}: card vs CPU agree over {steps} scan steps, {updates} updates, "
          f"{launches} kernel launches; largest differences {differences.summary()}")
    return {"steps": steps, "updates": updates, "kernel_launches": launches, "max_abs_diff": diffs}


def _distance(a, b) -> float:
    return math.sqrt(sum(float(((x.detach() - y.detach()) ** 2).sum()) for x, y in zip(a.parameters(), b.parameters())))


def _targets_follow(train, initial: dict) -> bool:
    """Each target differs from its online net and is closer to it than
    the initial weights are."""
    nets = _networks(train)
    for name, target in nets.items():
        if name.startswith("target_"):
            online = nets[name[len("target_"):]]
            if not 0.0 < _distance(target, online) < _distance(initial[name], online):
                return False
    return True


class _WatchedEnv:
    """An env that counts, on the device, the truncations and terminations
    it hands on."""

    def __init__(self, env):
        self.env = env
        self.observation_space, self.action_space, self.device = env.observation_space, env.action_space, env.device
        self.truncations = torch.zeros((), dtype=torch.int64, device=env.device)
        self.terminations = torch.zeros((), dtype=torch.int64, device=env.device)

    def reset(self, draws, num_envs):
        return self.env.reset(draws, num_envs)

    def step(self, state, actions):
        state, ts = self.env.step(state, actions)
        self.truncations += ts.truncated.sum()
        self.terminations += ts.terminated.sum()
        return state, ts


def _evaluate(runner, train, draws, lanes: int, steps: int):
    from pfrl_tpu_torch.experiments.runner import EvalLoop

    env = _WatchedEnv(runner.env.env)
    loop = EvalLoop(env, runner.core, num_episodes=lanes, max_steps=steps)
    t0 = time.perf_counter()
    returns = loop.evaluate(train, draws)
    return returns, time.perf_counter() - t0, int(env.truncations), int(env.terminations)


def run_full_mujoco(card: str, name: str) -> dict:
    """SAC or TD3 on MujocoSim with ``bench.py``'s every width and cadence,
    cut to 59 scan steps: 31 collecting, then 28 with 32 updates each."""
    import copy

    from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner = (mac.make_sac_runner if name == "sac" else mac.make_td3_runner)()  # the CUDA device, full width
    cfg, core, buffer = runner.config, runner.core, runner.buffer
    state = runner.init(0)
    torch.cuda.synchronize()
    train = state.train_state
    initial = {k: copy.deepcopy(v) for k, v in _networks(train).items()}
    collect_steps = (cfg.replay_start_size - 1) // cfg.num_envs  # the last step with t < 1,000
    warm_end = collect_steps + MUJOCO_STEPS_WARM
    steps = warm_end + MUJOCO_STEPS_TIMED

    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, collect = runner.run_chunk(state, collect_steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, warm = runner.run_chunk(state, MUJOCO_STEPS_WARM)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, timed = runner.run_chunk(state, MUJOCO_STEPS_TIMED)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    updates = _updates_in(cfg, 1, steps)
    timed_updates = _updates_in(cfg, warm_end + 1, steps)
    loss = torch.cat([warm["loss"], timed["loss"]])
    counts = {k: v.count for k, v in vars(train).items() if k.endswith("opt_state")}
    expected = {k: updates for k in counts}
    if name == "td3":
        expected["policy_opt_state"] = -(-updates // 2)  # the actor steps on even updates
    stored = state.replay_state.storage
    rows = min(state.t, buffer.capacity)
    checks = {
        "t advanced": state.t == steps * cfg.num_envs == int(state.replay_state.cursor),
        "no update before replay start": not bool(collect["loss"].any()),
        "losses finite": bool(torch.isfinite(loss).all()) and bool((loss > 0).all()),
        "n_updates as expected": train.n_updates == updates >= MUJOCO_STEPS_TIMED * cfg.num_envs,
        "every Adam count as expected": counts == expected,
        "stored actions in [-1, 1]": float(stored["action"][:rows].abs().max()) <= 1.0,
        "next_obs stored": stored["next_obs"].shape == (buffer.capacity, 17)
        and stored["obs"].dtype == torch.float32 and stored["action"].shape == (buffer.capacity, 6),
        "targets follow their online nets": _targets_follow(train, initial),
        "no kernel on this path": prefix_sample.launches == 0,
    }
    # One more update by hand, to read what the runner's metrics leave out.
    _, aux = core.update(train, buffer.sample(state.replay_state, state.draws, cfg.minibatch_size), state.draws)
    extra = {k: float(v) for k, v in aux.items() if v.dim() == 0}
    checks["every loss in aux finite"] = all(math.isfinite(v) for v in extra.values())
    if name == "sac":
        temperature = float(train.log_temperature.detach().exp())
        checks["temperature = exp(log_temperature), off 1.0"] = (
            abs(extra["temperature"] - temperature) <= 1e-6 * temperature and abs(temperature - 1.0) > 1e-3
        )
        checks["temperature's Adam counted the extra update"] = train.temperature_opt_state.count == updates + 1
    returns, eval_s, truncations, terminations = _evaluate(runner, train, state.draws, *MUJOCO_EVAL)
    checks["evaluation crossed one truncation per lane, no termination"] = (
        truncations == MUJOCO_EVAL[0] and terminations == 0
        and returns.shape == (MUJOCO_EVAL[0],) and bool(np.isfinite(returns).all())
    )
    _raise_on_failed(name, checks)
    timed_s = t3 - t2
    result = {
        "steps": steps,
        "t": state.t,
        "n_updates": updates,
        "adam_counts": counts,
        "env_steps_per_s": MUJOCO_STEPS_TIMED * cfg.num_envs / timed_s,
        "updates_per_s": timed_updates / timed_s,
        "collect_only_env_steps_per_s": collect_steps * cfg.num_envs / (t1 - t0),
        "collect_chunk_s": t1 - t0,
        "warm_chunk_s": t2 - t1,
        "timed_chunk_s": timed_s,
        "timed_scan_steps": MUJOCO_STEPS_TIMED,
        "eval_s": eval_s,
        "eval_returns": [float(r) for r in returns],
        "last_loss": float(loss[-1]),
        "aux_of_one_more_update": extra,
        "recent_return_mean": runner.recent_return_mean(state),
    }
    print(
        f"{name}: env-steps/s {result['env_steps_per_s']:.1f} updates/s {result['updates_per_s']:.1f} over "
        f"{MUJOCO_STEPS_TIMED} scan steps with updates; {result['collect_only_env_steps_per_s']:.1f} env-steps/s "
        f"over the {collect_steps} before replay start; evaluation {eval_s:.1f} s, mean return "
        f"{float(returns.mean()):.2f}; aux {json.dumps(extra)} (32 lanes, fp32, no TF32) on {card}"
    )
    return result


def run_full_ddpg(card: str) -> dict:
    """DDPG on the time-limited Pendulum with ``tools/record_curves.py``'s
    every width and cadence, cut to 205 scan steps: 62 of burn-in and
    collection, then 4 updates per scan step."""
    import copy

    from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner = mac.make_ddpg_runner()  # the CUDA device, full width
    cfg, core = runner.config, runner.core
    state = runner.init(0)
    torch.cuda.synchronize()
    train = state.train_state
    initial = {k: copy.deepcopy(v) for k, v in _networks(train).items()}
    collect_steps = (cfg.replay_start_size - 1) // cfg.num_envs  # the last step with t < 1,000
    warm_end = collect_steps + DDPG_STEPS_WARM

    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, collect = runner.run_chunk(state, collect_steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, warm = runner.run_chunk(state, DDPG_STEPS_WARM)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, timed = runner.run_chunk(state, DDPG_STEPS - warm_end)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    updates = _updates_in(cfg, 1, DDPG_STEPS)
    loss = torch.cat([warm["loss"], timed["loss"]])
    done = torch.cat([collect["done_count"], warm["done_count"], timed["done_count"]])
    window = min(int(state.recent_count), runner.return_window)
    recent = state.recent_returns[:window]
    stored = state.replay_state.storage
    burnin_actions = stored["action"][: core.burnin_steps]
    returns, eval_s, truncations, terminations = _evaluate(runner, train, state.draws, *DDPG_EVAL)
    _raise_on_failed("ddpg", {
        "t advanced": state.t == DDPG_STEPS * cfg.num_envs,
        "no update before replay start": not bool(collect["loss"].any()),
        "losses finite": bool(torch.isfinite(loss).all()) and bool((loss > 0).all()),
        "n_updates and both Adam counts as expected": train.n_updates == updates
        == train.policy_opt_state.count == train.q_opt_state.count > 0,
        "every lane truncated at its step 200, never terminated": int(state.recent_count) == cfg.num_envs
        and done.nonzero().flatten().tolist() == [199] and not bool(stored["terminated"].any()),
        "finished returns finite and <= 0": window == cfg.num_envs
        and bool(torch.isfinite(recent).all()) and bool((recent <= 0).all()),
        "burn-in actions fill [-1, 1)": float(burnin_actions.min()) < -0.9 and float(burnin_actions.max()) > 0.9
        and float(stored["action"][: state.t].abs().max()) <= 1.0,
        "targets follow their online nets": _targets_follow(train, initial),
        "evaluation: one truncation per lane, returns finite and <= 0": truncations == DDPG_EVAL[0]
        and terminations == 0 and returns.shape == (DDPG_EVAL[0],)
        and bool(np.isfinite(returns).all()) and bool((returns <= 0).all()),
        "no kernel on this path": prefix_sample.launches == 0,
    })
    timed_steps, timed_s = DDPG_STEPS - warm_end, t3 - t2
    result = {
        "steps": DDPG_STEPS,
        "t": state.t,
        "n_updates": updates,
        "env_steps_per_s": timed_steps * cfg.num_envs / timed_s,
        "updates_per_s": _updates_in(cfg, warm_end + 1, DDPG_STEPS) / timed_s,
        "collect_only_env_steps_per_s": collect_steps * cfg.num_envs / (t1 - t0),
        "collect_chunk_s": t1 - t0,
        "warm_chunk_s": t2 - t1,
        "timed_chunk_s": timed_s,
        "timed_scan_steps": timed_steps,
        "eval_s": eval_s,
        "eval_returns": [float(r) for r in returns],
        "last_loss": float(loss[-1]),
        "finished_episodes": int(state.recent_count),
        "recent_return_mean": runner.recent_return_mean(state),
    }
    print(
        f"ddpg: env-steps/s {result['env_steps_per_s']:.1f} updates/s {result['updates_per_s']:.1f} over "
        f"{timed_steps} scan steps with updates; {result['collect_only_env_steps_per_s']:.1f} env-steps/s over the "
        f"{collect_steps} before replay start; {result['finished_episodes']} episodes finished, mean return "
        f"{result['recent_return_mean']:.1f}; evaluation {eval_s:.1f} s, mean return {float(returns.mean()):.1f} "
        f"(16 lanes, fp32, no TF32) on {card}"
    )
    return result


# --------------------------------------------------------------------- phase 9
def _small_onpolicy_configs() -> dict:
    """name -> function making a 4-lane runner on a device, the recipes'
    networks: episodes cut to 12 steps (MujocoSim), 20 (CartPole) and 10
    (Pendulum), so that lanes end and reset inside the 3 iterations."""
    from pfrl_tpu_torch.envs import CartPole, MujocoSim, Pendulum, TimeLimit
    from pfrl_tpu_torch.experiments import onpolicy as onp

    return {
        "ppo": lambda dev: onp.make_ppo_runner(
            num_envs=4, rollout_len=16, epochs=2, minibatch_size=16, env=MujocoSim(episode_len=12, device=dev)),
        "a2c": lambda dev: onp.make_a2c_cartpole_runner(
            num_envs=4, rollout_len=8, env=TimeLimit(CartPole(device=dev), 20)),
        "trpo": lambda dev: onp.make_trpo_pendulum_runner(
            num_envs=4, rollout_len=16, vf_epochs=2, vf_batch_size=16, env=TimeLimit(Pendulum(device=dev), 10)),
    }


def check_small_onpolicy(name: str, build, device, iterations: int = 3) -> dict:
    """A 4-lane run of PPO, A2C or TRPO on the card and on the CPU from the
    same draws and weights: every metric of every update within rtol 1e-3
    (floor 1e-5; TRPO's KL 1e-2), the networks within 2e-5, TRPO's policy
    within 5e-4 (ten unconverged float32 CG iterations amplify rounding: on
    the CPU the port and the JAX package differ by up to 2e-3 of the step)."""
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    def run(dev):
        runner = build(dev)
        state = runner.init(0, draws=SeededDraws(0, dev))
        state, aux = runner.run_iterations(state, iterations)
        return runner, state, aux

    prefix_sample.launches = 0
    runner, gpu, gpu_aux = run(device)
    torch.cuda.synchronize()
    launches = prefix_sample.launches
    _, cpu, cpu_aux = run("cpu")
    differences = _Differences(name)
    close, diffs = differences.close, differences.largest
    for key, value in gpu_aux.items():
        close(key, value, cpu_aux[key], 1e-2 if key == "kl" else 1e-3, 1e-5)
    close("obs", gpu.obs, cpu.obs, 1e-4, 1e-5)
    close("recent_returns", gpu.recent_returns, cpu.recent_returns, 1e-4, 1e-4)
    for which, module in _networks(gpu.train_state).items():
        atol = 5e-4 if (name, which) == ("trpo", "policy") else 2e-5
        for a, b in zip(module.parameters(), getattr(cpu.train_state, which).parameters()):
            close(f"{which} parameters", a, b, 0.0, atol)
    _raise_on_failed(f"small {name}", {
        "no kernel on this path": launches == 0,
        "n_updates agree": gpu.train_state.n_updates == cpu.train_state.n_updates > 0,
        "t agrees": gpu.t == cpu.t == iterations * runner.rollout_len * runner.num_envs,
        "episodes ended inside the run": int(gpu.recent_count) == int(cpu.recent_count) > 0,
    })
    print(f"small {name}: card vs CPU agree over {iterations} iterations, {gpu.train_state.n_updates} updates, "
          f"{launches} kernel launches; largest differences {differences.summary()}")
    return {"iterations": iterations, "updates": gpu.train_state.n_updates, "kernel_launches": launches,
            "max_abs_diff": diffs}


def _onpolicy_runner(name: str, compute_dtype=None):
    """The recipe's runner on the card, its env counting truncations and
    terminations."""
    from pfrl_tpu_torch.envs import MujocoSim
    from pfrl_tpu_torch.experiments import onpolicy as onp

    make, env = {
        "ppo": (onp.make_ppo_runner, MujocoSim),
        "ppo-pendulum": (onp.make_ppo_pendulum_runner, onp.time_limited_pendulum),
        "trpo": (onp.make_trpo_pendulum_runner, onp.time_limited_pendulum),
        "a2c": (onp.make_a2c_cartpole_runner, onp.time_limited_cartpole),
    }[name]
    watched = _WatchedEnv(env())
    return make(env=watched, compute_dtype=compute_dtype), watched


def run_full_onpolicy(card: str, name: str, compute_dtype=None, iterations=None) -> dict:
    """One on-policy recipe at full width for ``iterations`` (default
    ``ONPOLICY_ITERATIONS[name]``; the first timed apart), then its
    evaluation loop."""
    from pfrl_tpu_torch.experiments.runner import EvalLoop
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner, env = _onpolicy_runner(name, compute_dtype)
    if compute_dtype is not None:
        checked = _float32_after_updates(runner.core)
    core, lanes, T = runner.core, runner.num_envs, runner.rollout_len
    iterations = iterations or ONPOLICY_ITERATIONS[name]
    state = runner.init(0)
    torch.cuda.synchronize()
    train = state.train_state
    head = (train.policy if name == "trpo" else train.model).head
    log_std0 = float(head.log_std.detach()) if hasattr(head, "log_std") else None

    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, first = runner.run_iterations(state, 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    updates_first = train.n_updates
    vf_first = train.vf_opt_state.count if name == "trpo" else 0
    state, rest = runner.run_iterations(state, iterations - 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = prefix_sample.launches
    aux = {k: torch.cat([first[k], rest[k]]) for k in first}
    train_truncations, train_terminations = int(env.truncations), int(env.terminations)

    finished = int(state.recent_count)
    recent = state.recent_returns[: min(finished, runner.return_window)]
    per_iteration = {"ppo": 320, "ppo-pendulum": 320, "trpo": 1, "a2c": 1}[name]
    scalars = [k for k in aux if k != "errors"]
    checks = {
        "t advanced": state.t == iterations * T * lanes,
        "n_updates as expected": train.n_updates == iterations * per_iteration,
        "every metric finite": all(bool(torch.isfinite(aux[k]).all()) for k in scalars),
        "finished returns finite": bool(torch.isfinite(recent).all()),
        "no kernel on this path": launches == 0,
    }
    if compute_dtype is not None:
        checks["masters and moments float32 after every update"] = checked[0] == iterations
        checks["the network computes in bf16"] = _computes_in(core, state, compute_dtype)
    result = {"compute_dtype": str(compute_dtype), "iterations": iterations, "t": state.t,
              "n_updates": train.n_updates, "kernel_launches": launches}
    if name in ("ppo", "ppo-pendulum"):
        checks["Adam's count == n_updates == 320 per iteration"] = (
            train.opt_state.count == train.n_updates == 320 * iterations)
        checks["log_std moved"] = abs(float(head.log_std.detach()) - log_std0) > 1e-4
    if name == "ppo" and iterations * T >= 1_000:  # MujocoSim truncates at 1,000 steps; 1,024 steps per lane
        per_lane = iterations * T // 1_000
        checks[f"every lane truncated {per_lane} time(s), never terminated"] = (
            finished == train_truncations == per_lane * lanes > 0 and train_terminations == 0)
    if name in ("ppo-pendulum", "trpo"):  # Pendulum truncates at 200: 640 and 1,280 steps per lane
        per_lane = iterations * T // 200
        checks[f"every lane truncated {per_lane} times, never terminated"] = (
            finished == train_truncations == per_lane * lanes > 0 and train_terminations == 0)
        checks["finished returns <= 0"] = bool((recent <= 0).all())
    if name == "trpo":
        accepted = aux["step_accepted"] > 0
        kls = aux["kl"][accepted]
        checks["value function's Adam count == 5 epochs x 32 per iteration"] = train.vf_opt_state.count == iterations * 160
        checks["every accepted step's KL <= max_kl"] = bool((kls <= core.max_kl).all()) and bool((kls > 0).all())
        result["accepted_steps"] = int(accepted.sum())
        result["accepted_kl"] = [float(k) for k in kls]
    if name == "a2c":
        checks["episodes ended, by termination"] = finished == train_truncations + train_terminations > 0 and train_terminations > 0
    result["train_truncations"], result["train_terminations"] = train_truncations, train_terminations
    if name in ONPOLICY_EVAL:
        eval_lanes, eval_steps = ONPOLICY_EVAL[name]
        env.truncations.zero_()
        env.terminations.zero_()
        loop = EvalLoop(env, core, num_episodes=eval_lanes, max_steps=eval_steps)
        t3 = time.perf_counter()
        returns = loop.evaluate(train, state.draws)
        result["eval_s"] = time.perf_counter() - t3
        result["eval_returns"] = [float(r) for r in returns]
        result["eval_truncations"], result["eval_terminations"] = int(env.truncations), int(env.terminations)
        checks["evaluation returns finite"] = returns.shape == (eval_lanes,) and bool(np.isfinite(returns).all())
        if name != "a2c":
            checks["evaluation: one truncation per lane"] = (
                result["eval_truncations"] == eval_lanes and result["eval_terminations"] == 0)
    _raise_on_failed(name, checks)
    timed_s = t2 - t1
    timed_updates = train.n_updates - updates_first
    result.update({
        "env_steps_per_s": (iterations - 1) * T * lanes / timed_s,
        "updates_per_s": timed_updates / timed_s,
        "first_iteration_s": t1 - t0,
        "timed_s": timed_s,
        "iteration_ms": timed_s / (iterations - 1) * 1e3,
        "last": {k: float(aux[k][-1]) for k in scalars},
        "finished_episodes": finished,
        "recent_return_mean": runner.recent_return_mean(state),
    })
    if name == "trpo":
        result["vf_steps_per_s"] = (train.vf_opt_state.count - vf_first) / timed_s
    print(
        f"{name}: env-steps/s {result['env_steps_per_s']:.1f} gradient steps/s {result['updates_per_s']:.1f}"
        + (f" (value-function steps/s {result['vf_steps_per_s']:.1f}; accepted steps {result['accepted_steps']}"
           f" of {iterations}, KL {result['accepted_kl']})" if name == "trpo" else "")
        + f" over {iterations - 1} iterations ({result['iteration_ms']:.1f} ms each; the first "
        f"{result['first_iteration_s']:.2f} s); {finished} episodes finished, mean return "
        f"{result['recent_return_mean']:.1f}; truncations {train_truncations}, terminations {train_terminations}"
        + (f"; evaluation {result['eval_s']:.2f} s, returns {result['eval_returns']}, truncations "
           f"{result['eval_truncations']}, terminations {result['eval_terminations']}" if "eval_s" in result else "")
        + f"; last {json.dumps(result['last'])} ({lanes} lanes, {_precision(compute_dtype)}) on {card}"
    )
    return result


# -------------------------------------------------------------------- phase 10
def _cartpole_recipes() -> dict:
    """name -> the recipe's maker in ``experiments/cartpole_value.py``."""
    from pfrl_tpu_torch.experiments.cartpole_value import RECIPES

    return RECIPES


def _with_core(runner, core_cls, **extra):
    """``runner`` with its core rebuilt as ``core_cls`` around the same model,
    optimizer, explorer and gamma."""
    core = runner.core
    runner.core = core_cls(model=core.model, optimizer=core.optimizer, explorer=core.explorer,
                           gamma=core.gamma, **extra)
    return runner


def _with_explorer(runner, explorer):
    runner.core.explorer = explorer
    return runner


def _small_cartpole_configs() -> dict:
    """name -> (function making a 4-lane runner on a device at the recipe's
    widths, kernel launches expected on the card, the parameters' absolute
    tolerance). A 40-slot ring that wraps, 2 batch-8 updates per scan step
    from 12 transitions, a target sync at 24, CartPole cut to 10 steps; 11
    scan steps, 18 updates."""
    from pfrl_tpu_torch.agents import DoubleIQNCore, DoublePALCore, DPPCore, PALCore
    from pfrl_tpu_torch.envs import CartPole, TimeLimit
    from pfrl_tpu_torch.explorers import Boltzmann, ExponentialDecayEpsilonGreedy

    small = dict(num_envs=4, capacity=40, replay_start_size=12, update_interval=2, target_update_interval=24,
                 minibatch_size=8)
    recipes = _cartpole_recipes()

    def make(name, **extra):
        return lambda dev: recipes[name](env=TimeLimit(CartPole(device=dev), 10), **small, **extra)[0]

    taus = lambda core: dict(quantile_thresholds_N=core.N, quantile_thresholds_N_prime=core.N_prime,  # noqa: E731
                             quantile_thresholds_K=core.K)
    configs = {name: (make(name), 18 if name == "rainbow-cartpole" else 0, 1e-6) for name in recipes}
    # The example's 128-wide net is the sensitive one: on the CPU alone,
    # scaling its initial weights by 1 +- 2**-23 moves its parameters by
    # 3.0e-6 within the first 8 updates (the others': 2.4e-7 to 9.4e-7).
    configs["dqn-cartpole-example"] = (make("dqn-cartpole-example"), 0, 1e-5)
    al, iqn, dqn = make("al-cartpole"), make("iqn-cartpole"), make("dqn-cartpole")
    configs.update({
        "pal": (lambda dev: _with_core(al(dev), PALCore, alpha=0.9), 0, 1e-6),
        "double-pal": (lambda dev: _with_core(al(dev), DoublePALCore, alpha=0.9), 0, 1e-6),
        "dpp": (lambda dev: _with_core(al(dev), DPPCore, eta=1.0), 0, 1e-6),
        "double-iqn": (lambda dev: (lambda r: _with_core(r, DoubleIQNCore, **taus(r.core)))(iqn(dev)), 0, 1e-6),
        "boltzmann": (lambda dev: _with_explorer(dqn(dev), Boltzmann(T=1.0)), 0, 1e-6),
        "exponential-decay": (lambda dev: _with_explorer(dqn(dev), ExponentialDecayEpsilonGreedy(1.0, 0.05, 0.99, 2)),
                              0, 1e-6),
    })
    return configs


def _noisy_nature_q_batch():
    """Two 32-frame batches of 84x84x4 uint8 observations and a transition
    batch over them, from a seeded numpy stream."""
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 256, (2, 32, 84, 84, 4)).astype(np.uint8)
    batch = dict(obs=frames[0], action=rs.randint(0, 6, 32).astype(np.int32),
                 reward=rs.normal(size=32).astype(np.float32), next_obs=frames[1],
                 discount=np.full(32, 0.99, np.float32), is_terminal=rs.uniform(size=32) < 0.1,
                 weight=np.ones(32, np.float32), indices=np.arange(32, dtype=np.int32))
    return frames, batch


def check_small_noisy_nature_q(device) -> dict:
    """``train_dqn_ale.py --noisy-net-sigma 0.5``'s network (``NatureQ`` with
    a factorized noisy head, ``Greedy``) at 84x84x4, 6 actions: one forward
    and one update on the card and on the CPU, from the same weights and
    draws. Q-values within rtol 1e-4 (floor 1e-5), the loss 1e-4, the
    parameters 1e-6 (fp32 convolutions reduce in other orders)."""
    from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner
    from pfrl_tpu_torch.replay import TransitionBatch

    frames, batch = _noisy_nature_q_batch()

    def run(dev):
        core = make_dqn_runner(num_envs=4, capacity=64, noisy_net_sigma=0.5, device=dev).core
        obs = torch.from_numpy(frames[0]).to(dev)
        state = core.init(torch.Generator().manual_seed(0), obs)
        draws = SeededDraws(0, dev)
        with torch.no_grad():
            q = core.action_value(state.model, obs, draws).q_values
        tb = TransitionBatch(**{k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        _, aux = core.update(state, tb, draws)
        return core, q, aux, state

    core, gpu_q, gpu_aux, gpu = run(device)
    _, cpu_q, cpu_aux, cpu = run("cpu")
    differences = _Differences("noisy NatureQ")
    close, diffs = differences.close, differences.largest
    close("q_values", gpu_q, cpu_q, 1e-4, 1e-5)
    close("loss", gpu_aux["loss"], cpu_aux["loss"], 1e-4, 1e-5)
    for a, b in zip(gpu.model.parameters(), cpu.model.parameters()):
        close("parameters", a, b, 0.0, 1e-6)
    _raise_on_failed("small noisy NatureQ", {
        "noisy head, Greedy": type(core.model.head).__name__ == "FactorizedNoisyLinear"
        and type(core.explorer).__name__ == "Greedy",
        "the head's sigmas moved": not torch.equal(gpu.model.head.w_sigma, gpu.target_model.head.w_sigma),
    })
    print(f"small noisy NatureQ: card vs CPU agree over one forward and one update; largest differences "
          f"{differences.summary()}")
    return {"max_abs_diff": diffs}


def run_full_cartpole(card: str, name: str) -> dict:
    """One recipe at full width: 64 scan steps of 32 lanes (the example: 16
    of 128), so that t = 2,048. The timed chunks end on the target syncs,
    where the target must equal the online net; then ``EvalLoop``. The
    runners of ``train_dqn_gym.py`` (phase 19, :func:`_gym_recipes`) run
    the same way: one update per scan step, one sync at 2,048."""
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    gym = name in _gym_recipes() or name in _phase20_recipes()
    runner, evaluator = {**_cartpole_recipes(), **_gym_recipes(), **_phase20_recipes()}[name]()  # the CUDA device
    cfg = runner.config
    example = name == "dqn-cartpole-example"
    warm_steps, timed_steps = CARTPOLE_EXAMPLE_STEPS if example else CARTPOLE_STEPS
    steps = warm_steps + timed_steps
    state = runner.init(0)
    torch.cuda.synchronize()
    train = state.train_state

    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, warm = runner.run_chunk(state, warm_steps)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # Timed in chunks that end where t crosses a sync interval.
    ends = sorted({k for k in range(warm_steps + 1, steps + 1)
                   if (k * cfg.num_envs) // cfg.target_update_interval
                   != ((k - 1) * cfg.num_envs) // cfg.target_update_interval} | {steps})
    timed_s, losses, synced_equal, done = 0.0, [warm["loss"]], [], warm_steps
    for end in ends:
        t1 = time.perf_counter()
        state, chunk = runner.run_chunk(state, end - done)
        torch.cuda.synchronize()
        timed_s += time.perf_counter() - t1
        losses.append(chunk["loss"])
        crossed = (end * cfg.num_envs) // cfg.target_update_interval != ((end - 1) * cfg.num_envs) // cfg.target_update_interval
        if crossed:
            synced_equal.append(all(torch.equal(a, b) for a, b in zip(train.model.parameters(),
                                                                      train.target_model.parameters())))
        done = end
    launches = prefix_sample.launches
    loss = torch.cat(losses)
    updates = _updates_in(cfg, 1, steps)
    timed_updates = _updates_in(cfg, warm_steps + 1, steps)
    per_step = 4 if example else 1 if gym else 8
    expected_launches = updates if name == "rainbow-cartpole" else 0
    t4 = time.perf_counter()
    returns = evaluator.evaluate(train, state.draws)
    eval_s = time.perf_counter() - t4
    checks = {
        "t advanced to 2,048": state.t == steps * cfg.num_envs == 2_048,
        "n_updates == updates per scan step x steps with updates": cfg.updates_per_step == per_step
        and train.n_updates == updates == per_step * sum(1 for k in range(1, steps + 1)
                                                          if k * cfg.num_envs >= cfg.replay_start_size),
        "losses finite, positive once updates run": bool(torch.isfinite(loss).all())
        and bool((loss[warm_steps - 1:] > 0).all()),
        "the target equals the online net right after the sync": len(synced_equal) == 1 and all(synced_equal),
        "prefix-sample launches as expected": launches == expected_launches,
        "evaluation returns finite": bool(np.isfinite(returns).all()) and returns.shape == (evaluator.env.num_envs,),
    }
    if name == "rainbow-cartpole":
        checks["264 launches, one per PER sample of B = 64"] = launches == 264 and cfg.minibatch_size == CARTPOLE_BATCH
    _raise_on_failed(name, checks)
    result = {
        "steps": steps, "t": state.t, "n_updates": updates, "kernel_launches": launches,
        "env_steps_per_s": timed_steps * cfg.num_envs / timed_s,
        "updates_per_s": timed_updates / timed_s,
        "scan_step_ms": timed_s / timed_steps * 1e3,
        "warm_chunk_s": warm_s, "timed_chunk_s": timed_s, "timed_scan_steps": timed_steps,
        "eval_s": eval_s, "eval_returns": [float(r) for r in returns],
        "last_loss": float(loss[-1]), "syncs_checked": len(synced_equal),
        "recent_return_mean": runner.recent_return_mean(state),
    }
    print(
        f"{name}: env-steps/s {result['env_steps_per_s']:.1f} updates/s {result['updates_per_s']:.1f} over "
        f"{timed_steps} scan steps ({result['scan_step_ms']:.2f} ms each); {launches} prefix-sample launches; "
        f"evaluation {eval_s:.2f} s, mean return {float(returns.mean()):.1f}; last loss {result['last_loss']:.4f} "
        f"({cfg.num_envs} lanes, fp32, no TF32) on {card}"
    )
    return result


# -------------------------------------------------------------------- phase 11
def _float32_after_updates(core) -> list:
    """Wraps ``core.update`` (``update_episodic`` of a recurrent
    off-policy core) so that after every call each master parameter and
    every floating tensor of the optimizers' states is held to float32; the
    returned one-element list counts the calls checked."""
    from pfrl_tpu_torch.utils.precision import map_floating

    method = "update_episodic" if hasattr(core, "update_episodic") else "update"
    checked, update = [0], getattr(core, method)

    def checked_update(*args, **kwargs):
        out = update(*args, **kwargs)
        dtypes = set()
        for value in vars(out[0]).values():
            if isinstance(value, torch.nn.Module):
                dtypes |= {p.dtype for p in value.parameters()}
            else:
                map_floating(lambda x: dtypes.add(x.dtype) or x, value)
        if dtypes != {torch.float32}:
            raise AssertionError(f"a master or a moment is not float32 after an update: {dtypes}")
        checked[0] += 1
        return out

    setattr(core, method, checked_update)
    return checked


def _computes_in(core, state, dtype) -> bool:
    """One forward of the acting network on the runner's observations: its
    first layer sees ``dtype`` inputs and weights, and the output is
    float32 (the network ran at the compute dtype, not in float32)."""
    from pfrl_tpu_torch.utils.precision import map_floating

    train = state.train_state
    net = train.model if hasattr(train, "model") else train.policy
    layer = next(m for m in net.modules() if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)))
    seen = []
    hook = layer.register_forward_pre_hook(lambda m, args: seen.append((args[0].dtype, m.weight.dtype)))
    with torch.no_grad():
        if hasattr(core, "action_value"):
            outputs = [core.action_value(net, state.obs, state.draws).q_values]
        elif hasattr(core, "policy_dist"):
            outputs = [core.policy_dist(net, state.obs).loc]
        else:
            outputs = []
            map_floating(lambda x: outputs.append(x) or x, core.forward(net, state.obs))
    hook.remove()
    return bool(seen) and all(s == (dtype, dtype) for s in seen) and all(o.dtype == torch.float32 for o in outputs)


def _small_bf16_configs() -> dict:
    """name -> (function making a small runner on a device at bf16, scan steps
    or iterations, prefix-sample launches expected on the card). AtariSim:
    4 lanes, 8 scan steps, the updates of the last only (from 32
    transitions): PER's first sample draws from equal priorities on both
    sides, where a later one would draw from priorities a bf16 ulp apart
    and may pick another slot; CartPole: the small CartPole runs' sizes;
    Pendulum: 4 lanes cut to 10 steps, the recipe's 256 x 256 networks,
    burn-in 24; PPO: 4 lanes of MujocoSim cut to 12 steps."""
    from pfrl_tpu_torch.envs import CartPole, MujocoSim, NormalizeActionSpace, Pendulum, TimeLimit
    from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
    from pfrl_tpu_torch.experiments import onpolicy as onp
    from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner
    from pfrl_tpu_torch.experiments.cartpole_value import make_c51_cartpole_runner, make_iqn_cartpole_runner

    bf16 = torch.bfloat16
    atari = dict(num_envs=4, replay_start_size=32, target_update_interval=48, minibatch_size=8, compute_dtype=bf16)
    cartpole = dict(num_envs=4, capacity=40, replay_start_size=12, update_interval=2, target_update_interval=24,
                    minibatch_size=8, compute_dtype=bf16)
    return {
        "dqn-bf16": (lambda dev: make_dqn_runner(capacity=48, update_interval=2, device=dev, **atari), 8, 0),
        "per-dqn-bf16": (lambda dev: make_dqn_runner(prioritized=True, capacity=8196, device=dev, **atari), 8, 1),
        "c51-cartpole-bf16": (lambda dev: make_c51_cartpole_runner(
            env=TimeLimit(CartPole(device=dev), 10), **cartpole)[0], 6, 0),
        "iqn-cartpole-bf16": (lambda dev: make_iqn_cartpole_runner(
            env=TimeLimit(CartPole(device=dev), 10), **cartpole)[0], 6, 0),
        "sac-pendulum-bf16": (lambda dev: mac.make_sac_pendulum_bf16_runner(
            num_envs=4, capacity=96, replay_start_size=32, minibatch_size=16, burnin_steps=24,
            env=NormalizeActionSpace(TimeLimit(Pendulum(device=dev), 10))), 12, 0),
        "ppo-bf16": (lambda dev: onp.make_ppo_runner(
            num_envs=4, rollout_len=16, epochs=2, minibatch_size=16, compute_dtype=bf16,
            env=MujocoSim(episode_len=12, device=dev)), 2, 0),
    }


def _ulps(got, want, ulp=BF16_ULP) -> float:
    """The largest difference relative to ``want``'s largest magnitude, in
    ulps of ``ulp`` (bf16: 2**-8)."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max()) / (float(want.abs().max()) * ulp + 1e-30)


def _change_ulps(got, start_got, want, start_want, ulp=BF16_ULP) -> float:
    """How far a network's change over a run on one side lies from its
    change on the other (``want``): the L2 norm of the difference over the
    norm of ``want``'s change, all its tensors together, in ulps."""
    a = torch.cat([(g.detach().cpu().double() - s.cpu().double()).flatten() for g, s in zip(got, start_got)])
    b = torch.cat([(w.detach().cpu().double() - s.cpu().double()).flatten() for w, s in zip(want, start_want)])
    return float((a - b).norm()) / (float(b.norm()) * ulp + 1e-30)


def _bf16_differences(name, a, b, onpolicy: bool, ulp=BF16_ULP) -> dict:
    """``what -> ulps`` (bf16 unless ``ulp`` says otherwise) between two
    small runs ``(state, metrics, start)``: every floating metric (but
    ``errors``), the continuous actions in the ring, and each network's
    change over the run."""
    (sa, ma, starta), (sb, mb, startb) = a, b
    out = {k: _ulps(v, mb[k], ulp) for k, v in ma.items() if k != "errors" and v.is_floating_point()}
    if not onpolicy:
        ring = lambda s: getattr(s.replay_state, "base", s.replay_state)  # noqa: E731
        actions = ring(sa).storage["action"].cpu(), ring(sb).storage["action"].cpu()
        if actions[0].is_floating_point():  # actions in [-1, 1]
            out["ring actions"] = float((actions[0] - actions[1]).abs().max()) / ulp
        for k, v in ring(sa).storage.get("extras", {}).items():
            if isinstance(v, torch.Tensor):  # a behaviour distribution stored with each step (ACER)
                out[f"stored {k}"] = _ulps(v, ring(sb).storage["extras"][k], ulp)
    nets_b = _networks(sb.train_state)
    for which, module in _networks(sa.train_state).items():
        if any(not torch.equal(p, p0) for p, p0 in zip(nets_b[which].parameters(), startb[which])):
            out[f"{which} change"] = _change_ulps(list(module.parameters()), starta[which],
                                                  list(nets_b[which].parameters()), startb[which], ulp)
    return out


def check_small_bf16(name: str, build, steps: int, expect_launches: int, device) -> dict:
    """A small run at ``compute_dtype=torch.bfloat16`` on the card and on the
    CPU from the same draws and weights. cuBLAS/cuDNN and the CPU's kernels
    each round a bf16 product once from a float32 sum, in their own order,
    so outputs differ by single ulps here and there, and the updates carry
    that on, more or less, as the run is more or less chaotic (bf16
    Q-values tie, and the target's max then switches actions). So each
    difference is held to ``BF16_SENSITIVITY`` times the difference the CPU
    run itself shows when its initial weights are scaled by 1 + 2**-23 (one
    float32 ulp), and never less than ``BF16_LOSS_ULPS`` (every metric but
    the errors; the continuous actions stored in the ring, of their range
    of 1) or ``BF16_CHANGE_ULPS`` (each network's change over the run, L2).
    Discrete actions and the step counters are exact; after every update
    every master and moment is float32. On the prioritized path the kernel
    is also held against its plain version on the run's own priorities."""
    from pfrl_tpu_torch.ops import prefix_sample as ps

    onpolicy = name == "ppo-bf16"

    def run(dev, scale=1.0):
        runner = build(dev)
        checked = _float32_after_updates(runner.core)
        state = runner.init(0, draws=SeededDraws(0, dev))
        with torch.no_grad():
            for module in _networks(state.train_state).values():
                for p in module.parameters():
                    p.mul_(scale)
        start = {k: [p.detach().clone() for p in m.parameters()] for k, m in _networks(state.train_state).items()}
        state, metrics = (runner.run_iterations if onpolicy else runner.run_chunk)(state, steps)
        return runner, (state, metrics, start), checked

    ps.prefix_sample.launches = 0
    runner, gpu, gpu_checked = run(device)
    torch.cuda.synchronize()
    launches = ps.prefix_sample.launches
    _, cpu, cpu_checked = run("cpu")
    _, nudged, _ = run("cpu", 1.0 + 2.0**-23)
    worst = _bf16_differences(name, gpu, cpu, onpolicy)
    sensitivity = _bf16_differences(name, nudged, cpu, onpolicy)
    # PPO's policy loss and explained variance sit near 0 by construction
    # (standardized advantages, ratios near 1): they are printed, not held.
    unheld = {"policy_loss", "explained_variance"} if onpolicy else set()
    tolerance = {k: max(BF16_CHANGE_ULPS if k.endswith("change") else BF16_LOSS_ULPS,
                        BF16_SENSITIVITY * sensitivity.get(k, 0.0)) for k in worst if k not in unheld}
    (gs, _, g0), (cs, _, c0) = gpu, cpu
    checks = {
        "the runs started from the same weights": all(
            torch.equal(p.cpu(), q) for k in g0 for p, q in zip(g0[k], c0[k])),
        "kernel launches as expected": launches == expect_launches,
        "n_updates agree": gs.train_state.n_updates == cs.train_state.n_updates > 0,
        "masters and moments float32 after every update": gpu_checked[0] == cpu_checked[0] > 0,
        "step counters agree": gs.t == cs.t,
        "the network computes in bf16 on the card": _computes_in(runner.core, gs, torch.bfloat16),
    }
    if not onpolicy:
        ring = lambda s: getattr(s.replay_state, "base", s.replay_state)  # noqa: E731
        if not ring(gs).storage["action"].is_floating_point():
            checks["ring actions equal"] = torch.equal(ring(gs).storage["action"].cpu(), ring(cs).storage["action"])
    if not onpolicy and not runner.buffer.iid_samples:
        leaves = gs.replay_state.tree[runner.buffer.tree_capacity:]
        targets = torch.rand(64, device=device, generator=torch.Generator(device).manual_seed(0)) * leaves.sum()
        got, want = ps.prefix_sample(leaves, targets), ps.prefix_sample_reference(leaves, targets)
        cs64 = np.cumsum(leaves.double().cpu().numpy())
        total = float(cs64[-1])
        checks["the kernel agrees with its plain version on the run's priorities"] = all(
            g == w or np.max(np.abs(cs64[min(g, w):max(g, w)] - float(t))) <= 1e-6 * total
            for g, w, t in zip(got.tolist(), want.tolist(), targets.tolist()))
    checks.update({f"{k} within {tolerance[k]:.2f} bf16 ulps": worst[k] <= tolerance[k] for k in tolerance})
    print(f"small {name}: card vs CPU at bf16 over {steps} {'iterations' if onpolicy else 'scan steps'}, "
          f"{gs.train_state.n_updates} updates, {launches} kernel launches; worst, in bf16 ulps: "
          + "; ".join(f"{k} {v:.2f} (held to {tolerance[k]:.2f}; a 1-ulp nudge of the weights: "
                      f"{sensitivity.get(k, 0.0):.2f})" if k in tolerance else f"{k} {v:.2f} (not held)"
                      for k, v in worst.items()))
    _raise_on_failed(f"small {name}", checks)
    return {"steps": steps, "updates": gs.train_state.n_updates, "kernel_launches": launches, "worst_ulps": worst,
            "tolerance_ulps": tolerance, "nudged_ulps": sensitivity}


def check_small_noisy_nature_q_bf16(device) -> dict:
    """The noisy ``NatureQ`` at bf16, one forward and one update on the card
    and on the CPU: the torso computes in bf16, the noisy head in float32
    (its noise is float32, so promotion lifts it, as in JAX). Q-values and
    the loss within ``BF16_LOSS_ULPS`` of their largest, the network's
    change within ``BF16_CHANGE_ULPS`` (L2)."""
    from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner
    from pfrl_tpu_torch.replay import TransitionBatch

    frames, batch = _noisy_nature_q_batch()

    def run(dev):
        core = make_dqn_runner(num_envs=4, capacity=64, noisy_net_sigma=0.5, compute_dtype=torch.bfloat16,
                               device=dev).core
        obs = torch.from_numpy(frames[0]).to(dev)
        state = core.init(torch.Generator().manual_seed(0), obs)
        start = [p.detach().clone() for p in state.model.parameters()]
        seen = []
        hooks = [m.register_forward_hook(lambda m, a, out, tag=tag: seen.append((tag, a[0].dtype, out.dtype)))
                 for tag, m in (("conv", state.model.torso.convs[0]), ("head", state.model.head))]
        draws = SeededDraws(0, dev)
        with torch.no_grad():
            q = core.action_value(state.model, obs, draws).q_values
        for h in hooks:
            h.remove()
        tb = TransitionBatch(**{k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        _, aux = core.update(state, tb, draws)
        return q, aux, state, start, seen

    gpu_q, gpu_aux, gpu, gpu_start, seen = run(device)
    cpu_q, cpu_aux, cpu, cpu_start, _ = run("cpu")
    worst = {"q_values": _ulps(gpu_q, cpu_q), "loss": _ulps(gpu_aux["loss"], cpu_aux["loss"])}
    worst["parameters change"] = _change_ulps(list(gpu.model.parameters()), gpu_start,
                                              list(cpu.model.parameters()), cpu_start)
    bf16, f32 = torch.bfloat16, torch.float32
    checks = {
        "the torso's first layer computes in bf16": ("conv", bf16, bf16) in seen,
        "the noisy head takes bf16 features and gives float32": ("head", bf16, f32) in seen,
        "Q-values come back float32": gpu_q.dtype == f32,
        "masters float32": all(p.dtype == f32 for p in gpu.model.parameters()),
        "the head's sigmas moved": not torch.equal(gpu.model.head.w_sigma, gpu.target_model.head.w_sigma),
        f"Q-values and loss within {BF16_LOSS_ULPS} bf16 ulps": max(worst["q_values"], worst["loss"]) <= BF16_LOSS_ULPS,
        f"parameters' change within {BF16_CHANGE_ULPS} bf16 ulps": worst["parameters change"] <= BF16_CHANGE_ULPS,
    }
    print("small noisy NatureQ bf16: card vs CPU over one forward and one update; worst, in bf16 ulps: "
          + "; ".join(f"{k} {v:.2f}" for k, v in worst.items())
          + f" (held to {BF16_LOSS_ULPS}, and {BF16_CHANGE_ULPS} for the change)")
    _raise_on_failed("small noisy NatureQ bf16", checks)
    return {"worst_ulps": worst}


def _nature_flops_per_scan_step(num_envs: int, n_actions: int = 6) -> float:
    """``bench.py:232-253``'s count: the Nature CNN forward, 18.67 MFLOP per
    sample, times (lanes + lanes / 4 updates x 4 forward-equivalents x 32)."""
    fwd = 2 * (20 * 20 * 32 * 8 * 8 * 4 + 9 * 9 * 64 * 4 * 4 * 32 + 7 * 7 * 64 * 3 * 3 * 64
               + 3136 * 512 + 512 * n_actions)
    return num_envs * fwd + (num_envs // 4) * 4 * 32 * fwd


def run_bench_dqn_ab(card: str) -> dict:
    """``bench.py``'s ``bench_dqn`` A/B at full width: an fp32 and a bf16
    runner of the uniform-ring Nature DQN, each warmed by
    ``BENCH_WARM_CHUNKS`` chunks (past replay start), then ``BENCH_ROUNDS`` rounds interleaved, each of
    ``BENCH_REPS`` chunks of ``BENCH_CHUNK`` scan steps per variant
    (``bench.py:211-224``; its chunks are 200 scan steps). Reports each
    variant's best round, the spread (worst / best), the bf16/fp32 ratio
    and the achieved TFLOP/s by ``bench.py``'s count."""
    from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    variants = {}
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        runner = make_dqn_runner(compute_dtype=dtype)  # the CUDA device, full width
        variants[label] = [runner, runner.init(0), []]

    def run(label):
        runner, state, losses = variants[label]
        state, metrics = runner.run_chunk(state, BENCH_CHUNK)
        variants[label][1] = state
        losses.append(metrics["loss"])
        return metrics

    prefix_sample.launches = 0
    for label in variants:
        for _ in range(BENCH_WARM_CHUNKS):
            run(label)
            torch.cuda.synchronize()
    times = {label: [] for label in variants}
    for _ in range(BENCH_ROUNDS):
        for label in variants:
            t0 = time.perf_counter()
            for _ in range(BENCH_REPS):
                run(label)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    launches = prefix_sample.launches
    num_envs = variants["fp32"][0].config.num_envs
    steps = BENCH_CHUNK * (BENCH_WARM_CHUNKS + BENCH_REPS * BENCH_ROUNDS)
    sps = {k: BENCH_REPS * BENCH_CHUNK * num_envs / min(v) for k, v in times.items()}
    flops = _nature_flops_per_scan_step(num_envs)
    result = {
        "chunk_scan_steps": BENCH_CHUNK, "reps": BENCH_REPS, "rounds": BENCH_ROUNDS,
        "round_seconds": times,
        "env_steps_per_s": sps,
        "updates_per_s": {k: v / 4 for k, v in sps.items()},
        "spread": {k: max(v) / min(v) for k, v in times.items()},
        "bf16_over_fp32": sps["bf16"] / sps["fp32"],
        "flop_per_scan_step": flops,
        "achieved_tflops": {k: flops * (v / num_envs) / 1e12 for k, v in sps.items()},
        "kernel_launches": launches,
    }
    checks = {"no kernel on this path": launches == 0}
    for label, (runner, state, losses) in variants.items():
        loss = torch.cat(losses)
        checks[f"{label}: t advanced"] = state.t == steps * num_envs
        checks[f"{label}: losses finite, positive once updates run"] = bool(torch.isfinite(loss).all()) and bool(
            (loss[BENCH_WARM_CHUNKS * BENCH_CHUNK - 1:] > 0).all())
        checks[f"{label}: masters float32"] = all(p.dtype == torch.float32 for p in state.train_state.model.parameters())
    bf16_runner, bf16_state, _ = variants["bf16"]
    checks["bf16: the network computes in bf16"] = _computes_in(bf16_runner.core, bf16_state, torch.bfloat16)
    checks["fp32: the network computes in float32"] = _computes_in(variants["fp32"][0].core, variants["fp32"][1],
                                                                   torch.float32)
    checks["bf16 GEMMs reduce in float32"] = not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    _raise_on_failed("dqn-atarisim-64 A/B", checks)
    print(
        f"dqn-atarisim-64 A/B (bench_dqn, {BENCH_ROUNDS} interleaved rounds of {BENCH_REPS} x {BENCH_CHUNK} scan "
        f"steps): env-steps/s fp32 {sps['fp32']:.1f} (spread {result['spread']['fp32']:.3f}), bf16 "
        f"{sps['bf16']:.1f} (spread {result['spread']['bf16']:.3f}); bf16/fp32 {result['bf16_over_fp32']:.3f}; "
        f"achieved TFLOP/s fp32 {result['achieved_tflops']['fp32']:.3f}, bf16 {result['achieved_tflops']['bf16']:.3f} "
        f"(18.67 MFLOP per forward, bench.py's count) on {card}"
    )
    return result


def run_full_sac_pendulum_bf16(card: str) -> dict:
    """``run_sac_pendulum_bf16`` with the recipe's every width and cadence (16
    lanes, 256 x 256 networks, 1,000 burn-in transitions, batch-128 updates
    every 4 from 1,000 on), cut to ``SAC_PENDULUM_STEPS`` scan steps, then
    its evaluation loop (10 lanes, 201 steps)."""
    import copy

    from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner = mac.make_sac_pendulum_bf16_runner()  # the CUDA device, the recipe's sizes
    checked = _float32_after_updates(runner.core)
    cfg, core = runner.config, runner.core
    state = runner.init(0)
    torch.cuda.synchronize()
    train = state.train_state
    initial = {k: copy.deepcopy(v) for k, v in _networks(train).items()}
    warm, timed_steps = SAC_PENDULUM_STEPS
    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, first = runner.run_chunk(state, warm)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, timed = runner.run_chunk(state, timed_steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    steps = warm + timed_steps
    updates = _updates_in(cfg, 1, steps)
    loss = torch.cat([first["loss"], timed["loss"]])
    stored = state.replay_state.storage
    returns, eval_s, truncations, terminations = _evaluate(runner, train, state.draws, *DDPG_EVAL)
    temperature = float(train.log_temperature.detach().exp())
    _raise_on_failed("sac-pendulum-16-bf16", {
        "t advanced": state.t == steps * cfg.num_envs,
        "n_updates and every Adam count as expected": train.n_updates == updates == train.policy_opt_state.count
        == train.q1_opt_state.count == train.temperature_opt_state.count > 0,
        "masters and moments float32 after every update": checked[0] == updates,
        "the policy computes in bf16": _computes_in(core, state, torch.bfloat16),
        "losses finite, positive once updates run": bool(torch.isfinite(loss).all())
        and bool((loss[(cfg.replay_start_size - 1) // cfg.num_envs:] > 0).all()),
        "burn-in actions fill [-1, 1)": float(stored["action"][: core.burnin_steps].min()) < -0.9
        and float(stored["action"][: state.t].abs().max()) <= 1.0,
        "temperature learned": abs(temperature - 1.0) > 1e-3,
        "targets follow their online nets": _targets_follow(train, initial),
        "evaluation: one truncation per lane, returns finite and <= 0": truncations == DDPG_EVAL[0]
        and terminations == 0 and bool(np.isfinite(returns).all()) and bool((returns <= 0).all()),
        "no kernel on this path": prefix_sample.launches == 0,
    })
    timed_s = t2 - t1
    result = {
        "steps": steps, "t": state.t, "n_updates": updates, "kernel_launches": 0,
        "env_steps_per_s": timed_steps * cfg.num_envs / timed_s,
        "updates_per_s": _updates_in(cfg, warm + 1, steps) / timed_s,
        "scan_step_ms": timed_s / timed_steps * 1e3,
        "warm_chunk_s": t1 - t0, "timed_chunk_s": timed_s,
        "eval_s": eval_s, "eval_returns": [float(r) for r in returns],
        "temperature": temperature, "last_loss": float(loss[-1]),
    }
    print(
        f"sac-pendulum-16-bf16: env-steps/s {result['env_steps_per_s']:.1f} updates/s {result['updates_per_s']:.1f} "
        f"over {timed_steps} scan steps ({result['scan_step_ms']:.2f} ms each); temperature {temperature:.4f}; "
        f"evaluation {eval_s:.1f} s, mean return {float(returns.mean()):.1f} (16 lanes, bf16 over fp32 masters) "
        f"on {card}"
    )
    return result


# -------------------------------------------------------------------- phase 12
def _small_recurrent_configs() -> dict:
    """name -> (function making a small runner on a device, scan steps or
    iterations, on-policy?, ulp, metric floor, change floor). 4 lanes,
    LSTM 16 (IQN: 4 taus): DelayedCue rows of 12 (2 per lane, so each
    lane's ring wraps) and windows of 4, PO-ABC rows of 5, AtariSim rows of
    8 sealed by filling, windows of 4 with a burn-in of 2, one batch-4
    update per scan step from replay start on, target syncs every 32; on
    policy rollout 12 in chunks of 4, 3 iterations. The bf16 AtariSim run
    stops after its first two updates (the float32 runs are not chaotic at
    these sizes, bf16 Q-values tie)."""
    from pfrl_tpu_torch.experiments import recurrent as rec

    cue = dict(num_envs=4, max_episodes=9, max_episode_len=12, subseq_len=4, replay_start_size=52,
               update_interval=4, target_update_interval=32, minibatch_size=4)
    abc = dict(cue, max_episodes=12, max_episode_len=5, subseq_len=None, replay_start_size=16)
    atari = dict(cue, max_episode_len=8, replay_start_size=40, lstm_size=16, final_exploration_frames=100,
                 burn_in=2)
    fp32 = (FP32_ULP, FP32_LOSS_ULPS, FP32_CHANGE_ULPS)
    return {
        "drqn-po-abc": (lambda dev: rec.make_drqn_po_abc_runner(hidden=16, device=dev, **abc)[0], 14, False, *fp32),
        "drqn-delayedcue": (lambda dev: rec.make_drqn_delayed_cue_runner(hidden=16, device=dev, **cue)[0], 26,
                            False, *fp32),
        "riqn-delayedcue": (lambda dev: rec.make_riqn_delayed_cue_runner(hidden=16, n_taus=4, device=dev, **cue)[0],
                            26, False, *fp32),
        "drqn-atarisim": (lambda dev: rec.make_drqn_atarisim_runner(device=dev, **atari)[0], 17, False, *fp32),
        "rppo-delayedcue": (lambda dev: rec.make_rppo_delayed_cue_runner(
            hidden=16, num_envs=4, rollout=12, epochs=2, minibatch_size=4, device=dev)[0], 3, True, *fp32),
        "rtrpo-delayedcue": (lambda dev: rec.make_rtrpo_delayed_cue_runner(
            hidden=16, num_envs=4, rollout=12, vf_epochs=2, vf_batch_size=4, device=dev)[0], 3, True, *fp32),
        "drqn-atarisim-bf16": (lambda dev: rec.make_drqn_atarisim_runner(
            device=dev, compute_dtype=torch.bfloat16, **atari)[0], 11, False,
            BF16_ULP, BF16_LOSS_ULPS, BF16_CHANGE_ULPS),
    }


def _recurrent_sides(core, state, dtype) -> bool:
    """One act step of DRQN-AtariSim's network: the CNN and the LSTM's input
    side see ``dtype``, its hidden side the float32 carry (promoted), and
    the Q-values and the carry come back float32."""
    model = state.train_state.model
    seen = {}
    hooks = [m.register_forward_hook(lambda mod, args, out, name=name: seen.__setitem__(name, (args[0].dtype, out.dtype)))
             for name, m in (("conv", model.torso.convs[0]), ("ih", model.lstm.ih), ("hh", model.lstm.hh))]
    with torch.no_grad():
        av, carry = core.step(model, state.obs, state.act_state)
    for h in hooks:
        h.remove()
    f32 = torch.float32
    return (seen == {"conv": (dtype, dtype), "ih": (dtype, dtype), "hh": (f32, f32)}
            and av.q_values.dtype == f32 and all(c.dtype == f32 for c in carry[0]))


def check_small_in_ulps(name: str, build, steps: int, onpolicy: bool, ulp: float, loss_floor: float,
                        change_floor: float, device, nudges=(1.0 + 2.0**-23,)) -> dict:
    """A small run of one recurrent (or ACER) configuration on the card and
    on the CPU from the same draws and weights, as ``check_small_bf16``
    holds the bf16 runs: every metric and each network's change over the
    run in ulps (float32, or bf16 at bf16), each held to
    ``BF16_SENSITIVITY`` times what scaling the CPU run's initial weights by
    each of ``nudges`` moves (the largest), and never less than its floor,
    and so are the act-time carry and the behaviour statistics stored; the
    discrete actions stored, the episodic buffer's rows and lengths and the
    step counters exact; after every update every master and moment
    float32; no prefix-sample launch."""
    from pfrl_tpu_torch.ops import prefix_sample as ps

    def run(dev, scale=1.0):
        runner = build(dev)
        checked = _float32_after_updates(runner.core)
        state = runner.init(0, draws=SeededDraws(0, dev))
        with torch.no_grad():
            for module in _networks(state.train_state).values():
                for p in module.parameters():
                    p.mul_(scale)
        start = {k: [p.detach().clone() for p in m.parameters()] for k, m in _networks(state.train_state).items()}
        state, metrics = (runner.run_iterations if onpolicy else runner.run_chunk)(state, steps)
        return runner, (state, metrics, start), checked

    ps.prefix_sample.launches = 0
    runner, gpu, gpu_checked = run(device)
    torch.cuda.synchronize()
    launches = ps.prefix_sample.launches
    _, cpu, cpu_checked = run("cpu")
    worst = _bf16_differences(name, gpu, cpu, onpolicy, ulp)
    sensitivity = {}
    for scale in nudges:
        _, nudged, _ = run("cpu", scale)
        for k, v in _bf16_differences(name, nudged, cpu, onpolicy, ulp).items():
            sensitivity[k] = max(v, sensitivity.get(k, 0.0))
        if _leaves(cpu[0].act_state):  # a recurrent core's carry
            carry = max(_ulps(a, b, ulp) for a, b in zip(_leaves(nudged[0].act_state), _leaves(cpu[0].act_state)))
            sensitivity["carry"] = max(carry, sensitivity.get("carry", 0.0))
    if _leaves(cpu[0].act_state):
        worst["carry"] = max(_ulps(a, b, ulp) for a, b in zip(_leaves(gpu[0].act_state), _leaves(cpu[0].act_state)))
    # Standardized advantages put the policy losses (TRPO's loss too) and the
    # explained variance near 0 by construction: printed, not held.
    unheld = {"policy_loss", "explained_variance"} | ({"loss"} if "trpo" in name else set()) if onpolicy else set()
    tolerance = {k: max(change_floor if k.endswith("change") else loss_floor, BF16_SENSITIVITY * sensitivity.get(k, 0.0))
                 for k in worst if k not in unheld}
    (gs, gm, _), (cs, cm, _) = gpu, cpu
    checks = {
        "no prefix-sample launch": launches == 0,
        "n_updates agree": gs.train_state.n_updates == cs.train_state.n_updates > 0,
        "masters and moments float32 after every update": gpu_checked[0] == cpu_checked[0] > 0,
        "step counters agree": gs.t == cs.t,
    }
    if onpolicy:
        checks["episodes ended inside the run"] = int(gs.recent_count) == int(cs.recent_count) > 0
    else:
        g, c = gs.replay_state, cs.replay_state
        if not c.storage["action"].is_floating_point():  # continuous actions are held in ulps
            checks["actions stored equal"] = torch.equal(g.storage["action"].cpu(), c.storage["action"])
        checks["rows, lengths and seals equal"] = all(
            torch.equal(getattr(g, k).cpu(), getattr(c, k)) for k in ("ep_len", "finished", "lane_row", "n_started"))
        if not name.endswith("bf16"):
            checks["every lane's ring wrapped"] = int(g.n_started) - 4 >= runner.buffer.max_episodes // 4 * 4
        checks["windows were sampled"] = int(gs.train_state.n_updates) >= 2
    if name.endswith("bf16") and name.startswith("drqn"):
        checks["the CNN and the LSTM's input side compute in bf16, its hidden side in float32"] = _recurrent_sides(
            runner.core, gs, torch.bfloat16)
    elif name.endswith("bf16"):
        checks["the network computes in bf16 on the card"] = _computes_in(runner.core, gs, torch.bfloat16)
    checks.update({f"{k} within {tolerance[k]:.2f} ulps": worst[k] <= tolerance[k] for k in tolerance})
    unit = "bf16" if ulp == BF16_ULP else "float32"
    print(f"small {name}: card vs CPU over {steps} {'iterations' if onpolicy else 'scan steps'}, "
          f"{gs.train_state.n_updates} updates, {launches} prefix-sample launches; worst, in {unit} ulps: "
          + "; ".join(f"{k} {v:.2f} (held to {tolerance[k]:.2f}; a 1-ulp nudge of the weights: "
                      f"{sensitivity.get(k, 0.0):.2f})" if k in tolerance else f"{k} {v:.2f} (not held)"
                      for k, v in worst.items()))
    _raise_on_failed(f"small {name}", checks)
    return {"steps": steps, "updates": gs.train_state.n_updates, "kernel_launches": launches, "unit": unit,
            "worst_ulps": worst, "tolerance_ulps": tolerance, "nudged_ulps": sensitivity}


def _leaves(carry) -> list:
    from pfrl_tpu_torch.utils.recurrent import tree_leaves

    return tree_leaves(carry)


def _episodic_bytes(replay) -> dict:
    """Bytes of the episodic buffer on the card: frames, carries, the rest."""
    storage = replay.storage
    frames = sum(storage[k].numel() * storage[k].element_size() for k in ("obs", "next_obs"))
    carries = sum(x.numel() * x.element_size() for v in storage["extras"].values() for x in _leaves(v))
    rest = sum(storage[k].numel() * storage[k].element_size() for k in storage if k not in ("obs", "next_obs", "extras"))
    return {"frames": frames, "carries": carries, "rest": rest, "total": frames + carries + rest}


def run_full_drqn_atarisim(card: str) -> dict:
    """``train_drqn_ale.py --sim`` at full width on the card: 32 lanes of
    84x84x1 frames, Nature CNN -> LSTM 512 -> 6, the 2,048 x 128 episodic
    buffer with the carries stored, 8 batch-32 updates per scan step over
    windows of 32. The replay start is cut to
    ``DRQN_ATARI_REPLAY_START``; the timed chunk runs through the
    target sync (``DRQN_ATARI_SYNC``); then ``DRQN_ATARI_PROFILED`` scan
    steps under ``torch.profiler``, whose busy time is taken over those same
    steps' wall time (the profiler slows the host, so this share is lower
    than the unprofiled one), and the evaluation loop (5 lanes x 500
    steps)."""
    from pfrl_tpu_torch.experiments.profile_slice import _profiled
    from pfrl_tpu_torch.experiments.recurrent import make_drqn_atarisim_runner
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner, evaluator = make_drqn_atarisim_runner(replay_start_size=DRQN_ATARI_REPLAY_START,
                                                  target_update_interval=DRQN_ATARI_SYNC)
    cfg, buf = runner.config, runner.buffer
    state = runner.init(0)
    torch.cuda.synchronize()
    nbytes = _episodic_bytes(state.replay_state)
    print(f"drqn-atarisim-32: episodic buffer of {buf.max_episodes} rows x {buf.max_episode_len} steps on the card: "
          f"{nbytes['total'] / 1e9:.3f} GB (frames, obs and next_obs: {nbytes['frames'] / 1e9:.3f} GB; carries "
          f"before and after each step: {nbytes['carries'] / 1e9:.3f} GB; the rest {nbytes['rest'] / 1e6:.1f} MB); "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    train = state.train_state
    warm_steps, timed_steps = DRQN_ATARI_STEPS
    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, warm = runner.run_chunk(state, warm_steps)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sealed = int(state.replay_state.n_finished)
    t1 = time.perf_counter()
    state, timed = runner.run_chunk(state, timed_steps)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t1
    synced = all(torch.equal(a, b) for a, b in zip(train.model.parameters(), train.target_model.parameters()))
    (state, _), profiled_s, kernels, busy_us, top = _profiled(lambda: runner.run_chunk(state, DRQN_ATARI_PROFILED))
    launches = prefix_sample.launches
    steps = warm_steps + timed_steps + DRQN_ATARI_PROFILED
    updates = _updates_in(cfg, 1, steps)
    timed_updates = _updates_in(cfg, warm_steps + 1, warm_steps + timed_steps)
    scan_step_ms = timed_s / timed_steps * 1e3
    busy_ms = busy_us / DRQN_ATARI_PROFILED / 1e3
    profiled_ms = profiled_s / DRQN_ATARI_PROFILED * 1e3
    t2 = time.perf_counter()
    returns = evaluator.evaluate(train, state.draws)
    eval_s = time.perf_counter() - t2
    loss = torch.cat([warm["loss"], timed["loss"]])
    stored = state.replay_state.storage["extras"]["carry"][0][1]  # h before each step
    checks = {
        "the buffer holds 2,048 x 128 frames and carries, 5.9 GB": buf.max_episodes == 2_048
        and buf.max_episode_len == 128 and 5.5e9 < nbytes["total"] < 6.5e9,
        "rows sealed by the end of the warm chunk": sealed >= cfg.num_envs,
        "n_updates as expected": train.n_updates == updates == cfg.updates_per_step * (steps - warm_steps + 1),
        "losses finite, positive once updates run": bool(torch.isfinite(loss).all())
        and bool((timed["loss"] > 0).all()),
        "the target equals the online net right after the sync at 10,000": synced
        and (warm_steps + timed_steps) * cfg.num_envs // cfg.target_update_interval == 1,
        "carries stored": bool(stored.abs().amax() > 0),
        "no prefix-sample launch": launches == 0,
        "evaluation returns finite": bool(np.isfinite(returns).all()) and returns.shape == (5,),
    }
    _raise_on_failed("drqn-atarisim-32", checks)
    result = {
        "steps": steps, "t": state.t, "n_updates": updates, "kernel_launches": launches,
        "buffer_bytes": nbytes, "sealed_rows_at_replay_start": sealed,
        "env_steps_per_s": timed_steps * cfg.num_envs / timed_s,
        "updates_per_s": timed_updates / timed_s,
        "scan_step_ms": scan_step_ms,
        "profiled_scan_step_ms": profiled_ms,
        "device_launches_per_step": kernels / DRQN_ATARI_PROFILED,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / profiled_ms,  # over the profiled steps' own wall time
        "top_device_ops": [{"name": n, "ms_per_step": us / DRQN_ATARI_PROFILED / 1e3,
                            "launches_per_step": k / DRQN_ATARI_PROFILED} for n, (us, k) in top[:8]],
        "warm_chunk_s": warm_s, "timed_chunk_s": timed_s, "timed_scan_steps": timed_steps,
        "eval_s": eval_s, "eval_returns": [float(r) for r in returns], "last_loss": float(loss[-1]),
    }
    print(
        f"drqn-atarisim-32: env-steps/s {result['env_steps_per_s']:.1f} updates/s {result['updates_per_s']:.1f} over "
        f"{timed_steps} scan steps ({scan_step_ms:.2f} ms each, {cfg.updates_per_step} batch-32 window updates per "
        f"scan step); over {DRQN_ATARI_PROFILED} profiled scan steps of {profiled_ms:.2f} ms each, "
        f"device busy {busy_ms:.2f} ms per scan step ({result['device_busy_share'] * 100:.1f}% of those steps' own "
        f"time; {busy_ms / scan_step_ms * 100:.1f}% of the unprofiled timed step, a ratio across the two windows), "
        f"{result['device_launches_per_step']:.1f} kernels per scan step; {launches} prefix-sample launches; "
        f"evaluation {eval_s:.2f} s; last loss {result['last_loss']:.5f} (fp32, no TF32) on {card}"
    )
    return result


def run_full_recurrent(card: str, name: str) -> dict:
    """One of the five ``tools/record_curves.py`` recurrent recipes at its
    widths (16 lanes, LSTM 32): off-policy through replay start and
    ``RECURRENT_FULL_STEPS`` scan steps (several target syncs), on-policy
    through its iterations, then its evaluation loop."""
    from pfrl_tpu_torch.experiments.recurrent import RECIPES
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner, evaluator = RECIPES[name]()
    onpolicy = hasattr(runner, "run_iterations")
    run = runner.run_iterations if onpolicy else runner.run_chunk
    warm_n, timed_n = RECURRENT_FULL_STEPS[name]
    state = runner.init(0)
    train = state.train_state
    prefix_sample.launches = 0
    state, warm = run(state, warm_n)
    torch.cuda.synchronize()
    updates0 = train.n_updates
    t0 = time.perf_counter()
    state, timed = run(state, timed_n)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = prefix_sample.launches
    lanes = runner.num_envs if onpolicy else runner.config.num_envs
    transitions = timed_n * lanes * (runner.rollout_len if onpolicy else 1)
    returns = evaluator.evaluate(train, state.draws)
    loss = timed["loss"]
    checks = {
        "no prefix-sample launch": launches == 0,
        "updates ran": train.n_updates > updates0 > (0 if onpolicy else -1),
        "losses finite": bool(torch.isfinite(loss).all()),
        "episodes ended": int(state.recent_count) > 0,
        "evaluation returns finite": bool(np.isfinite(returns).all()),
    }
    _raise_on_failed(name, checks)
    result = {
        "t": state.t, "n_updates": train.n_updates, "kernel_launches": launches,
        "env_steps_per_s": transitions / timed_s, "updates_per_s": (train.n_updates - updates0) / timed_s,
        "timed_s": timed_s, "timed": timed_n, "eval_returns": [float(r) for r in returns],
        "recent_return_mean": runner.recent_return_mean(state),
    }
    unit = "iterations" if onpolicy else "scan steps"
    print(f"{name}: env-steps/s {result['env_steps_per_s']:.1f} updates/s {result['updates_per_s']:.1f} over "
          f"{timed_n} {unit}; {launches} prefix-sample launches; evaluation mean return {float(returns.mean()):.3f}, "
          f"recent training returns {result['recent_return_mean']:.3f} ({lanes} lanes, fp32, no TF32) on {card}")
    return result


# -------------------------------------------------------------------- phase 13
def _small_acer_configs() -> dict:
    """name -> (function making a small runner on a device, scan steps, ulp,
    metric floor, change floor). The recipes' networks at full width
    (ABC: Dense 64; continuous ABC: the SDN at 32; AtariSim: the example's
    ``SmallAtariCNN`` PiQ) over 4 lanes and 12 rows (3 per lane, every
    lane's ring wraps), one batch-4 update of whole rows per scan step from
    16 transitions on (AtariSim: rows of 8 sealed by filling, from 32 on);
    the bf16 AtariSim run stops after its first three updates."""
    from pfrl_tpu_torch.experiments import acer

    abc = dict(num_envs=4, max_episodes=12, replay_start_size=16, update_interval=4, minibatch_size=4)
    atari = dict(abc, max_episode_len=8, replay_start_size=32)
    fp32 = (FP32_ULP, FP32_LOSS_ULPS, FP32_CHANGE_ULPS)
    return {
        "acer-abc": (lambda dev: acer.make_acer_abc_runner(device=dev, **abc)[0], 14, *fp32),
        "acer-continuous-abc": (lambda dev: acer.make_acer_continuous_abc_runner(device=dev, **abc)[0], 14, *fp32),
        "acer-atarisim": (lambda dev: acer.make_acer_atarisim_runner(device=dev, **atari)[0], 25, *fp32),
        "acer-atarisim-bf16": (lambda dev: acer.make_acer_atarisim_runner(
            device=dev, compute_dtype=torch.bfloat16, **atari)[0], 10, BF16_ULP, BF16_LOSS_ULPS, BF16_CHANGE_ULPS),
    }


def _acer_bytes(replay) -> dict:
    """Bytes of ACER's episodic buffer on the card: frames, the behaviour's
    log-probs, the rest."""
    storage = replay.storage
    size = lambda x: x.numel() * x.element_size()  # noqa: E731
    frames = sum(size(storage[k]) for k in ("obs", "next_obs"))
    mu = sum(size(v) for v in storage["extras"].values())
    rest = sum(size(storage[k]) for k in storage if k not in ("obs", "next_obs", "extras"))
    return {"frames": frames, "mu_logits": mu, "rest": rest, "total": frames + mu + rest}


def run_full_acer_atarisim(card: str) -> dict:
    """``train_acer_ale.py --sim`` at full width on the card: 16 lanes of
    84x84x4 frames (episodes of mean length 50), ``SmallAtariCNN`` PiQ,
    RMSprop, the trust region, the 2,048 x 50 episodic buffer (obs,
    next_obs and the behaviour's log-probs), one batch-16 update of whole
    rows per scan step from the replay start (``ACER_ATARI_REPLAY_START``) on:
    ``ACER_ATARI_STEPS`` scan steps through replay start and on, then
    ``ACER_ATARI_PROFILED`` under ``torch.profiler`` (busy time over those
    steps' own wall time), then the evaluation loop (5 lanes x 500 steps)."""
    from pfrl_tpu_torch.experiments.acer import make_acer_atarisim_runner
    from pfrl_tpu_torch.experiments.profile_slice import _profiled
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner, evaluator = make_acer_atarisim_runner(replay_start_size=ACER_ATARI_REPLAY_START)
    cfg, buf = runner.config, runner.buffer
    state = runner.init(0)
    torch.cuda.synchronize()
    nbytes = _acer_bytes(state.replay_state)
    print(f"acer-atarisim-16: episodic buffer of {buf.max_episodes} rows x {buf.max_episode_len} steps on the card: "
          f"{nbytes['total'] / 1e9:.3f} GB (frames, obs and next_obs: {nbytes['frames'] / 1e9:.3f} GB; mu_logits "
          f"{nbytes['mu_logits'] / 1e6:.3f} MB; the rest {nbytes['rest'] / 1e6:.3f} MB); "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    train = state.train_state
    initial = copy.deepcopy(train.model)
    warm_steps, timed_steps = ACER_ATARI_STEPS
    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, warm = runner.run_chunk(state, warm_steps)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sealed = int(state.replay_state.n_finished)
    t1 = time.perf_counter()
    state, timed = runner.run_chunk(state, timed_steps)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t1
    (state, _), profiled_s, kernels, busy_us, top = _profiled(lambda: runner.run_chunk(state, ACER_ATARI_PROFILED))
    launches = prefix_sample.launches
    steps = warm_steps + timed_steps + ACER_ATARI_PROFILED
    updates = _updates_in(cfg, 1, steps)
    timed_updates = _updates_in(cfg, warm_steps + 1, warm_steps + timed_steps)
    scan_step_ms = timed_s / timed_steps * 1e3
    busy_ms = busy_us / ACER_ATARI_PROFILED / 1e3
    profiled_ms = profiled_s / ACER_ATARI_PROFILED * 1e3
    t2 = time.perf_counter()
    returns = evaluator.evaluate(train, state.draws)
    eval_s = time.perf_counter() - t2
    loss = torch.cat([warm["loss"], timed["loss"]])
    lags, moved = _distance(train.avg_model, train.model), _distance(initial, train.model)
    mu = state.replay_state.storage["extras"]["mu_logits"][state.replay_state.finished]
    checks = {
        "the buffer holds 2,048 x 50 frame pairs, 5.78 GB, and the behaviour's log-probs": buf.max_episodes == 2_048
        and buf.max_episode_len == 50 and 5.7e9 < nbytes["frames"] < 5.9e9
        and nbytes["mu_logits"] == 2_048 * 50 * 6 * 4,
        "rows sealed by replay start": sealed >= cfg.num_envs,
        "the first update on the last warm step, then one per scan step": warm_steps * cfg.num_envs
        == cfg.replay_start_size and train.n_updates == updates == steps - warm_steps + 1,
        "losses finite": bool(torch.isfinite(loss).all()),
        "the average model lags the model": 0.0 < lags < moved,
        "stored behaviour log-probs normalised": bool(torch.allclose(mu[:, 0].exp().sum(-1),
                                                                     torch.ones((), device=mu.device), atol=1e-5)),
        "no prefix-sample launch": launches == 0,
        "evaluation returns finite": bool(np.isfinite(returns).all()) and returns.shape == (5,),
    }
    _raise_on_failed("acer-atarisim-16", checks)
    result = {
        "steps": steps, "t": state.t, "n_updates": updates, "kernel_launches": launches, "buffer_bytes": nbytes,
        "sealed_rows_at_replay_start": sealed,
        "acting_env_steps_per_s": warm_steps * cfg.num_envs / warm_s,
        "env_steps_per_s": timed_steps * cfg.num_envs / timed_s,
        "updates_per_s": timed_updates / timed_s,
        "scan_step_ms": scan_step_ms,
        "profiled_scan_step_ms": profiled_ms,
        "device_launches_per_step": kernels / ACER_ATARI_PROFILED,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / profiled_ms,  # over the profiled steps' own wall time
        "top_device_ops": [{"name": n, "ms_per_step": us / ACER_ATARI_PROFILED / 1e3,
                            "launches_per_step": k / ACER_ATARI_PROFILED} for n, (us, k) in top[:8]],
        "warm_chunk_s": warm_s, "timed_chunk_s": timed_s, "timed_scan_steps": timed_steps,
        "eval_s": eval_s, "eval_returns": [float(r) for r in returns], "last_loss": float(loss[-1]),
    }
    print(
        f"acer-atarisim-16: env-steps/s {result['env_steps_per_s']:.1f} updates/s {result['updates_per_s']:.1f} over "
        f"{timed_steps} scan steps with updates ({scan_step_ms:.2f} ms each, one batch-16 update of whole 50-step "
        f"rows per scan step); through replay start, acting only but for the last step: "
        f"{result['acting_env_steps_per_s']:.1f} env-steps/s over {warm_steps} scan steps; over "
        f"{ACER_ATARI_PROFILED} profiled scan steps of {profiled_ms:.2f} ms each, device busy {busy_ms:.2f} ms per "
        f"scan step ({result['device_busy_share'] * 100:.1f}% of those steps' own time), "
        f"{result['device_launches_per_step']:.1f} kernels per scan step; {launches} prefix-sample launches; "
        f"evaluation {eval_s:.2f} s, returns {result['eval_returns']}; last loss {result['last_loss']:.5f} "
        f"(fp32, no TF32) on {card}"
    )
    return result


def run_full_atari_onpolicy(card: str, name: str) -> dict:
    """``train_a2c_ale.py --sim``, ``train_ppo_ale.py --sim`` or
    ``train_a3c.py --sim`` at full width (``SmallAtariCNN`` PiV on 84x84x4
    AtariSim frames): one warm iteration,
    ``ATARI_ONPOLICY_ITERATIONS[name]`` timed, one under ``torch.profiler``
    (kernels per iteration, busy time over its own wall time), then the
    examples' evaluation loop (5 lanes x 500 steps)."""
    from pfrl_tpu_torch.experiments import atari_a3c
    from pfrl_tpu_torch.experiments import onpolicy as onp
    from pfrl_tpu_torch.experiments.profile_slice import _profiled
    from pfrl_tpu_torch.experiments.runner import EvalLoop
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    make = {"a2c-atarisim-16": onp.make_a2c_atarisim_runner, "ppo-atarisim-8": onp.make_ppo_atarisim_runner,
            "a3c-atarisim-16": atari_a3c.make_a3c_atarisim_runner}[name]
    runner = make()
    core, lanes, T = runner.core, runner.num_envs, runner.rollout_len
    per_iteration = 1 if name.startswith(("a2c", "a3c")) else core.epochs * core.minibatch_shape(lanes * T)[0]
    iterations = {**ATARI_ONPOLICY_ITERATIONS, "a3c-atarisim-16": A3C_ITERATIONS}[name]
    state = runner.init(0)
    train = state.train_state
    prefix_sample.launches = 0
    state, _ = runner.run_iterations(state, 1)  # warm: allocates the rollout
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, aux = runner.run_iterations(state, iterations)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    (state, _), profiled_s, kernels, busy_us, _ = _profiled(lambda: runner.run_iterations(state, 1))
    launches = prefix_sample.launches
    t1 = time.perf_counter()
    returns = EvalLoop(runner.env.env, core, 5, 500, device=runner.device).evaluate(train, state.draws)
    eval_s = time.perf_counter() - t1
    scalars = [k for k in aux if k != "errors"]
    checks = {
        "t advanced": state.t == (iterations + 2) * T * lanes,
        "n_updates as expected": train.n_updates == (iterations + 2) * per_iteration,
        "every metric finite": all(bool(torch.isfinite(aux[k]).all()) for k in scalars),
        "no prefix-sample launch": launches == 0,
        "evaluation returns finite": bool(np.isfinite(returns).all()) and returns.shape == (5,),
    }
    _raise_on_failed(name, checks)
    result = {
        "iterations": iterations, "t": state.t, "n_updates": train.n_updates, "kernel_launches": launches,
        "env_steps_per_s": iterations * T * lanes / timed_s,
        "updates_per_s": iterations * per_iteration / timed_s,
        "iteration_ms": timed_s / iterations * 1e3,
        "profiled_iteration_ms": profiled_s * 1e3,
        "device_launches_per_iteration": kernels,
        "device_busy_ms_per_iteration": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / profiled_s,  # over the profiled iteration's own wall time
        "finished_episodes": int(state.recent_count), "eval_s": eval_s, "eval_returns": [float(r) for r in returns],
        "eval_mean": float(np.mean(returns)),
        "last": {k: float(aux[k][-1]) for k in scalars},
    }
    print(f"{name}: env-steps/s {result['env_steps_per_s']:.1f} updates/s {result['updates_per_s']:.1f} over "
          f"{iterations} iterations ({result['iteration_ms']:.1f} ms each: {lanes} lanes x rollout {T}, "
          f"{per_iteration} gradient steps); {kernels} kernels in one profiled iteration of "
          f"{result['profiled_iteration_ms']:.1f} ms, device busy {result['device_busy_ms_per_iteration']:.2f} ms "
          f"({result['device_busy_share'] * 100:.1f}%); {launches} prefix-sample launches; evaluation {eval_s:.2f} s, "
          f"mean {result['eval_mean']:.3f} over 5 x 500 steps; "
          f"last {json.dumps(result['last'])} (fp32, no TF32) on {card}")
    return result


# -------------------------------------------------------------------- phase 14
def check_frame_ops(card: str) -> dict:
    """The native frame ops, built by g++ on the card's host, against their
    numpy versions with the JAX package's tests' tolerance (1 apart at most,
    in under 1% of the pixels; ``frame_max`` exact), and their rates on one
    thread: frames warped per second, and the env steps per second of one
    ``make_warped`` lane (4 raw frames, a max, a warp per step)."""
    from pfrl_tpu_torch import runtime
    from pfrl_tpu_torch.envs.synthetic_ale import make_warped

    t0 = time.perf_counter()
    path = runtime.build()
    build_s = time.perf_counter() - t0
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 256, (64, 210, 160, 3), dtype=np.uint8)
    diffs = {}
    for kind, batch in (("rgb", frames), ("gray", frames[..., 1])):
        d = np.abs(runtime.warp_frames(batch).astype(int) - runtime.warp_frames(batch, plain=True).astype(int))
        diffs[kind] = {"max": int(d.max()), "share_off_by_one": float((d > 0).mean())}
    max_exact = np.array_equal(runtime.frame_max(frames[:32], frames[32:]), np.maximum(frames[:32], frames[32:]))

    def rate(fn, n, reps):
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return n * reps / (time.perf_counter() - t)

    native_fps = rate(lambda: runtime.warp_frames(frames), 64, 20)
    plain_fps = rate(lambda: runtime.warp_frames(frames, plain=True), 64, 2)
    max_fps = rate(lambda: runtime.frame_max(frames[0], frames[1]), 1, 2_000)
    env = make_warped(0)
    env.reset()

    def lane_steps(n=500):
        for _ in range(n):
            _, _, done, _ = env.step(1)
            if done:
                env.reset()

    lane_sps = rate(lane_steps, 500, 2)
    checks = {
        "warp within 1 of numpy in under 1% of the pixels": all(
            d["max"] <= 1 and d["share_off_by_one"] < 0.01 for d in diffs.values()),
        "frame_max exact": max_exact,
    }
    _raise_on_failed("frame ops", checks)
    result = {"library": path.name, "build_s": build_s, "differences": diffs, "warp_frames_per_s": native_fps,
              "warp_frames_per_s_numpy": plain_fps, "frame_max_per_s": max_fps, "make_warped_lane_steps_per_s": lane_sps}
    print(f"frame ops: {path.name} (g++ {build_s:.1f} s); native against numpy: rgb max {diffs['rgb']['max']} "
          f"({diffs['rgb']['share_off_by_one'] * 100:.3f}% of pixels off by 1), gray max {diffs['gray']['max']} "
          f"({diffs['gray']['share_off_by_one'] * 100:.3f}%), held to 1 in under 1%; frame_max exact; one thread: "
          f"{native_fps:.0f} 210x160x3 frames warped per s (numpy {plain_fps:.0f}), {max_fps:.0f} frame_max per s, "
          f"{lane_sps:.0f} make_warped env steps per s (host of {card})")
    return result


def _fp32_ulps(a, b) -> float:
    """``_ulps`` in float32 ulps, the largest over a list of tensors."""
    if isinstance(a, list):
        return max(_ulps(x, y, FP32_ULP) for x, y in zip(a, b))
    return _ulps(a, b, FP32_ULP)


def _small_example_configs() -> dict:
    """name -> (function making a 4-lane runner of a phase-14 recipe on a
    device, scan steps, kernel launches expected on the card), at phase 3's
    sizes (``_small_configs``): uniform rings of 48 slots that wrap,
    2 updates per scan step from 32 transitions on, 17 scan steps; the
    prioritized ring of 8,196 slots, one update per scan step, 20 scan
    steps; target syncs at 48."""
    from pfrl_tpu_torch.experiments import atari_c51, atari_dqn_ale

    small = dict(num_envs=4, replay_start_size=32, target_update_interval=48, minibatch_size=8,
                 final_exploration_frames=100)
    uniform = dict(capacity=48, **small)
    return {
        "dqn-ale-nips": (lambda dev: atari_dqn_ale.make_dqn_ale_runner(
            "nips", update_interval=2, device=dev, **uniform)[0], 17, 0),
        "dqn-ale-dueling": (lambda dev: atari_dqn_ale.make_dqn_ale_runner(
            "dueling", update_interval=2, device=dev, **uniform)[0], 17, 0),
        "per-dqn-ale": (lambda dev: atari_dqn_ale.make_dqn_ale_runner(
            "nature", prioritized=True, capacity=8196, steps=400, device=dev, **small)[0], 20, 13),
        "c51-atarisim": (lambda dev: atari_c51.make_c51_atarisim_runner(device=dev, **uniform)[0], 17, 0),
    }


def check_small_example_slice(name: str, build, steps: int, expect_launches: int, device) -> dict:
    """A 4-lane run of one phase-14 recipe on the card and on the CPU from
    the same draws and weights: the frames and actions in the ring, the
    counters and the kernel's launches exact; the losses, a prioritized
    ring's trees and each network's change over the run in float32 ulps,
    each held to 4x the larger of what 1 + 2**-23 and 1 - 2**-23 nudges of
    the CPU run's initial weights move it, and never less than
    ``FP32_LOSS_ULPS`` (``FP32_CHANGE_ULPS`` for a change). Adam, which
    these recipes take, divides each gradient by its own root mean square,
    so a near-cancelling gradient's rounding moves a step by up to the
    learning rate (C22, C48), and the PER ring turns each step into the
    next samples' priorities."""
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    def run(dev, scale=1.0):
        runner = build(dev)
        state = runner.init(0, draws=SeededDraws(0, dev))
        train = state.train_state
        with torch.no_grad():
            for p in train.model.parameters():
                p.mul_(scale)
            for t, p in zip(train.target_model.parameters(), train.model.parameters()):
                t.copy_(p)
        start = {k: [p.detach().clone() for p in m.parameters()] for k, m in _networks(train).items()}
        state, metrics = runner.run_chunk(state, steps)
        return runner, state, metrics, start

    def ring(s):
        return getattr(s.replay_state, "base", s.replay_state)

    def differences(a, b):
        (_, sa, ma, start_a), (_, sb, mb, start_b) = a, b
        out = {"loss": _ulps(ma["loss"], mb["loss"], FP32_ULP)}
        if hasattr(sb.replay_state, "tree"):
            out["tree"] = _ulps(sa.replay_state.tree, sb.replay_state.tree, FP32_ULP)
        nets_b = _networks(sb.train_state)
        for which, module in _networks(sa.train_state).items():
            out[f"{which} change"] = _change_ulps(list(module.parameters()), start_a[which],
                                                  list(nets_b[which].parameters()), start_b[which], FP32_ULP)
        return out

    before = prefix_sample.launches
    gpu = run(device)
    torch.cuda.synchronize()
    launches = prefix_sample.launches - before
    cpu = run("cpu")
    worst = differences(gpu, cpu)
    moved = {}
    for scale in ACER_NUDGES:
        for k, v in differences(run("cpu", scale), cpu).items():
            moved[k] = max(v, moved.get(k, 0.0))
    tolerance = {k: max(FP32_CHANGE_ULPS if k.endswith("change") else FP32_LOSS_ULPS, BF16_SENSITIVITY * moved[k])
                 for k in worst}
    runner, gs, cs = gpu[0], gpu[1], cpu[1]
    updates = _updates_in(runner.config, 1, steps)
    checks = {
        f"{expect_launches} kernel launches": launches == expect_launches,
        "n_updates as expected": gs.train_state.n_updates == cs.train_state.n_updates == updates,
        "counters agree": gs.t == cs.t and int(ring(gs).cursor) == int(ring(cs).cursor),
        "frames and actions in the ring exact": torch.equal(ring(gs).storage["obs"].cpu(), ring(cs).storage["obs"])
        and torch.equal(ring(gs).storage["action"].cpu(), ring(cs).storage["action"]),
        **{f"{k} within {tolerance[k]:.2f} ulps": worst[k] <= tolerance[k] for k in worst},
    }
    print(f"small {name}: card vs CPU over {steps} scan steps, {updates} updates, {launches} prefix-sample launches; "
          "worst, in float32 ulps: " + "; ".join(
              f"{k} {worst[k]:.2f} (held to {tolerance[k]:.2f}; nudges move it {moved[k]:.2f})" for k in worst))
    _raise_on_failed(f"small {name}", checks)
    return {"steps": steps, "updates": updates, "kernel_launches": launches, "worst_ulps": worst,
            "tolerance_ulps": tolerance, "nudged_ulps": moved}


def _example_core_makers() -> dict:
    """name -> (function making the recipe's core, the batch's frames as
    the recipe's ring gives them: dequantized float32 or uint8)."""
    from pfrl_tpu_torch.experiments import atari_c51, atari_dqn_ale

    def dqn(arch):
        return lambda: atari_dqn_ale.make_dqn_ale_runner(arch, device="cpu", num_envs=4, capacity=64)[0].core

    return {"convq-nips": (dqn("nips"), True), "dueling": (dqn("dueling"), True),
            "c51q": (lambda: atari_c51.make_c51_core(), False)}


def _example_batch(seed: int, dequantized: bool, device, b: int = 32):
    from pfrl_tpu_torch.replay import TransitionBatch

    rs = np.random.RandomState(seed)

    def frames():
        x = torch.from_numpy(rs.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8))
        return x.to(torch.float32) * (1.0 / 255.0) if dequantized else x

    batch = dict(obs=frames(), action=torch.from_numpy(rs.randint(0, 6, b).astype(np.int32)),
                 reward=torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], b).astype(np.float32)), next_obs=frames(),
                 discount=torch.full((b,), 0.99), is_terminal=torch.arange(b) % 4 == 1,
                 weight=torch.ones(b), indices=torch.arange(b, dtype=torch.int32))
    return TransitionBatch(**{k: v.to(device) for k, v in batch.items()})


def check_small_example_cores(device) -> dict:
    """One forward (a batch of 32 frames) and 1 and 3 updates of the
    ``nips`` ``ConvQ``, ``DuelingDQN`` and ``C51Q`` recipes' cores at
    84x84x4, on the card and on the CPU from the same weights and batches:
    the Q-values, the losses and the parameters after 1 and 3 updates in
    float32 ulps (of each quantity's largest magnitude), each held to 4x the
    larger of what 1 + 2**-23 and 1 - 2**-23 nudges of the CPU's weights
    move it, and never less than ``FP32_LOSS_ULPS``."""
    out = {}
    for name, (make, dequantized) in _example_core_makers().items():
        def run(dev, scale=1.0):
            core = make()
            state = core.init(torch.Generator().manual_seed(0), torch.zeros((1, 84, 84, 4), dtype=torch.uint8,
                                                                            device=dev))
            with torch.no_grad():
                for p in state.model.parameters():
                    p.mul_(scale)
            obs = _example_batch(0, dequantized, dev).obs
            with torch.no_grad():
                q = core.action_value(state.model, obs).q_values.clone()
            got = {"forward q": q}
            for i in range(3):
                _, aux = core.update(state, _example_batch(1 + i, dequantized, dev))
                if i in (0, 2):
                    got[f"loss after {i + 1}"] = aux["loss"].detach().clone()
                    got[f"params after {i + 1}"] = [p.detach().clone() for p in state.model.parameters()]
            return got

        gpu, cpu = run(device), run("cpu")
        nudged = [run("cpu", s) for s in ACER_NUDGES]
        worst = {k: _fp32_ulps(gpu[k], cpu[k]) for k in cpu}
        moved = {k: max(_fp32_ulps(n[k], cpu[k]) for n in nudged) for k in cpu}
        tolerance = {k: max(FP32_LOSS_ULPS, BF16_SENSITIVITY * moved[k]) for k in cpu}
        print(f"small {name}: card vs CPU, worst in float32 ulps: " + "; ".join(
            f"{k} {worst[k]:.2f} (held to {tolerance[k]:.2f}; nudges move it {moved[k]:.2f})" for k in cpu))
        _raise_on_failed(f"small {name}", {f"{k} within {tolerance[k]:.2f} ulps": worst[k] <= tolerance[k]
                                           for k in cpu})
        out[name] = {"worst_ulps": worst, "tolerance_ulps": tolerance, "nudged_ulps": moved}
    return out


def check_small_pipeline(device) -> dict:
    """The pipeline's device functions on the card and on the CPU, the
    recipe's core (NatureQ, RMSprop, a summed loss) from the same weights,
    2 workers x 2 lanes and a ring of 256 rows: 6 rounds of act stages from
    the same draws (actions, the stack and the staged rows exact), 70
    commits across a wrap (exact), a sample from a ring of known contents
    with the same ids (every field exact: uint8 frames, bool terminals),
    and a burst of 4 updates from one state (the loss, the average Q and
    the parameters in float32 ulps, held as ``check_small_example_cores``
    holds them; the syncs equal)."""
    from pfrl_tpu_torch.experiments.atari_pipeline import make_dqn_pipeline

    sizes = dict(env_factory=None, n_workers=2, lanes_per_worker=2, capacity=256, minibatch_size=8,
                 target_update_interval=12, replay_start_size=64, burst=4)

    def build(dev, scale=1.0):
        p = make_dqn_pipeline(device=dev, **sizes)
        p._init_device_state(0)
        with torch.no_grad():
            for x in p.train_state.model.parameters():
                x.mul_(scale)
        p.publish()
        return p

    def act_and_commit(p):
        dev, rs, actions = p.device, np.random.RandomState(1), []
        for step in range(6):
            for worker in range(p.n_workers):
                planes = torch.from_numpy(rs.randint(0, 256, (p.K, 84 * 84)).astype(np.uint8)).to(dev)
                prev_done = torch.from_numpy(rs.uniform(size=p.K) < (1.0 if step == 0 else 0.3)).to(dev)
                actions.append(p.act_stage(p._acting, p.stack, p.ring, planes, prev_done, worker * p.K,
                                           step * p.L + worker * p.K, 600_000 + step * p.L,
                                           SeededDraws(10 * step + worker, dev)).cpu())
        staged = (p.stack.cpu(), p.ring.planes.cpu(), p.ring.action.cpu())
        for _ in range(p.capacity // p.L + 6):
            rew = torch.from_numpy(rs.normal(size=p.L).astype(np.float32)).to(dev)
            term = torch.from_numpy(rs.uniform(size=p.L) < 0.2).to(dev)
            p.commit(p.ring, rew, term, term | torch.from_numpy(rs.uniform(size=p.L) < 0.1).to(dev))
        committed = (p.ring.reward.cpu(), p.ring.terminated.cpu(), p.ring.done.cpu(), p.ring.commit_cursor)
        return torch.stack(actions), staged, committed

    def fill(p):
        rs = np.random.RandomState(7)
        p.ring.planes.copy_(torch.from_numpy(rs.randint(0, 256, p.ring.planes.shape).astype(np.uint8)))
        p.ring.action.copy_(torch.from_numpy(rs.randint(0, 6, p.capacity).astype(np.int32)))
        p.ring.reward.copy_(torch.from_numpy(rs.normal(size=p.capacity).astype(np.float32)))
        done = torch.from_numpy(rs.uniform(size=p.capacity) < 0.1)
        p.ring.done.copy_(done)
        p.ring.terminated.copy_(done & torch.from_numpy(rs.uniform(size=p.capacity) < 0.5))
        p.ring.commit_cursor = 40 * p.L

    gp, cp = build(device), build("cpu")
    g_act, c_act = act_and_commit(gp), act_and_commit(cp)
    checks = {
        "act stage: actions exact": torch.equal(g_act[0], c_act[0]),
        "act stage: stack and staged rows exact": all(torch.equal(a, b) for a, b in zip(g_act[1], c_act[1])),
        "commit exact": all(torch.equal(a, b) for a, b in zip(g_act[2][:3], c_act[2][:3]))
        and g_act[2][3] == c_act[2][3] == (gp.capacity // gp.L + 6) * gp.L,
    }
    fill(gp), fill(cp)
    gb, cb = gp.sample(gp.ring, SeededDraws(3, device)), cp.sample(cp.ring, SeededDraws(3, "cpu"))
    checks["sample exact (uint8 frames, bool terminals)"] = all(
        torch.equal(getattr(gb, k).cpu(), getattr(cb, k)) for k in
        ("obs", "next_obs", "action", "reward", "is_terminal", "discount", "weight", "indices"))
    checks["sample: frames uint8"] = gb.obs.dtype == torch.uint8 and gb.obs.shape == (8, 84, 84, 4)

    def burst(p):
        loss, q, syncs = p.learner_burst(p.train_state, p.ring, SeededDraws(5, p.device), 4)
        return {"loss": loss.detach().cpu(), "average q": q.detach().cpu(),
                "params": [x.detach().cpu() for x in p.train_state.model.parameters()],
                "target params": [x.detach().cpu() for x in p.train_state.target_model.parameters()]}, syncs

    (g, g_syncs), (c, c_syncs) = burst(gp), burst(cp)
    nudged = []
    for s in ACER_NUDGES:
        p = build("cpu", s)
        fill(p)
        nudged.append(burst(p)[0])
    worst = {k: _fp32_ulps(g[k], c[k]) for k in c}
    moved = {k: max(_fp32_ulps(n[k], c[k]) for n in nudged) for k in c}
    tolerance = {k: max(FP32_LOSS_ULPS, BF16_SENSITIVITY * moved[k]) for k in c}
    checks["burst: the same syncs"] = g_syncs == c_syncs == 1
    checks.update({f"burst: {k} within {tolerance[k]:.2f} ulps": worst[k] <= tolerance[k] for k in c})
    print("small pipeline: card vs CPU, act stage (actions, stack, staged rows), commit and sample exact; burst of 4, "
          "worst in float32 ulps: " + "; ".join(
              f"{k} {worst[k]:.2f} (held to {tolerance[k]:.2f}; nudges move it {moved[k]:.2f})" for k in c))
    _raise_on_failed("small pipeline", checks)
    return {"worst_ulps": worst, "tolerance_ulps": tolerance, "nudged_ulps": moved, "syncs": g_syncs}


def _example_configs() -> dict:
    """name -> function making the recipe's ``(runner, eval_loop)`` at
    full width on the card."""
    from pfrl_tpu_torch.experiments import atari_c51, atari_dqn_ale

    cut = {"replay_start_size": EXAMPLE_REPLAY_START}
    return {
        "dqn-ale-nature-64": lambda: atari_dqn_ale.make_dqn_ale_runner("nature", **cut),
        "dqn-ale-nips-64": lambda: atari_dqn_ale.make_dqn_ale_runner("nips", **cut),
        "dqn-ale-dueling-64": lambda: atari_dqn_ale.make_dqn_ale_runner("dueling", **cut),
        "per-dqn-ale-64": lambda: atari_dqn_ale.make_dqn_ale_runner("nature", prioritized=True, **cut),
        "c51-atarisim-64": lambda: atari_c51.make_c51_atarisim_runner(**cut),
    }


def _ring_bytes(buffer, replay) -> dict:
    """Bytes of a ring on the card: frames, the rest, and a PER ring's trees."""
    base = getattr(replay, "base", replay)
    size = lambda x: x.numel() * x.element_size()  # noqa: E731
    frames = sum(size(v) for k, v in base.storage.items() if k in ("obs", "next_obs"))
    rest = sum(size(v) for k, v in base.storage.items() if k not in ("obs", "next_obs"))
    trees = sum(size(getattr(replay, k)) for k in ("tree", "min_tree") if hasattr(replay, k))
    return {"frames": frames, "rest": rest, "trees": trees, "total": frames + rest + trees}


def run_full_example_atari(card: str, name: str) -> dict:
    """``train_dqn_ale.py --sim`` (``--arch nature``, ``nips``, ``dueling``;
    ``--prioritized``) or ``train_categorical_dqn_ale.py --sim`` at the
    example's own settings on the card: 64 lanes, the 10^6-slot ring, the
    replay start cut to ``EXAMPLE_REPLAY_START``: ``EXAMPLE_ATARI_STEPS`` scan steps through it (the
    first 16 updates on the last), timed scan steps of 16 updates each,
    profiled ones (kernels per scan step, the busy share of their own wall
    time), then the evaluation loop (5 x 500). The prioritized path launches
    the prefix-sample kernel once per update at C = 2^20, B = 32; the
    others never. The path is freed before the next is built."""
    from pfrl_tpu_torch.experiments.profile_slice import _profiled
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner, evaluator = _example_configs()[name]()
    cfg, buf = runner.config, runner.buffer
    prioritized = hasattr(buf, "tree_capacity")
    state = runner.init(0)
    torch.cuda.synchronize()
    nbytes = _ring_bytes(buf, state.replay_state)
    row = getattr(state.replay_state, "base", state.replay_state).storage["obs"].shape[-1]
    print(f"{name}: ring of {buf.capacity:,} slots on the card: {nbytes['total'] / 1e9:.3f} GB (frames "
          f"{nbytes['frames'] / 1e9:.3f} GB: 84x84x4 = 28,224 B a slot, padded to {row:,} B as the JAX ring pads "
          f"it; the rest {nbytes['rest'] / 1e6:.3f} MB; trees {nbytes['trees'] / 1e6:.3f} MB); "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    warm_steps, timed_steps, profiled_steps = EXAMPLE_ATARI_STEPS
    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, warm = runner.run_chunk(state, warm_steps)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    state, timed = runner.run_chunk(state, timed_steps)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t1
    (state, _), profiled_s, kernels, busy_us, top = _profiled(lambda: runner.run_chunk(state, profiled_steps))
    launches = prefix_sample.launches
    train = state.train_state
    steps = warm_steps + timed_steps + profiled_steps
    updates = _updates_in(cfg, 1, steps)
    t2 = time.perf_counter()
    returns = evaluator.evaluate(train, state.draws)
    eval_s = time.perf_counter() - t2
    loss = torch.cat([warm["loss"], timed["loss"]])
    checks = {
        "the ring holds 10^6 frame stacks": buf.capacity == 10**6 and nbytes["frames"] > 28.2e9,
        "the first updates on the last warm step": _updates_in(cfg, 1, warm_steps) == cfg.updates_per_step,
        "n_updates as expected": train.n_updates == updates,
        "losses finite": bool(torch.isfinite(loss).all()) and float(loss[-1]) > 0,
        "evaluation returns finite": bool(np.isfinite(returns).all()) and returns.shape == (5,),
    }
    if prioritized:
        checks["one prefix-sample launch per update, at C = 2^20"] = launches == updates and buf.tree_capacity == 2**20
    else:
        checks["no prefix-sample launch"] = launches == 0
    scan_step_ms = timed_s / timed_steps * 1e3
    result = {
        "steps": steps, "t": state.t, "n_updates": updates, "kernel_launches": launches, "ring_bytes": nbytes,
        "acting_env_steps_per_s": warm_steps * cfg.num_envs / warm_s,
        "env_steps_per_s": timed_steps * cfg.num_envs / timed_s,
        "updates_per_s": timed_steps * cfg.updates_per_step / timed_s,
        "scan_step_ms": scan_step_ms,
        "profiled_scan_step_ms": profiled_s / profiled_steps * 1e3,
        "device_launches_per_step": kernels / profiled_steps,
        "device_busy_ms_per_step": busy_us / profiled_steps / 1e3,
        "device_busy_share": busy_us / 1e6 / profiled_s,  # over the profiled steps' own wall time
        "top_device_ops": [{"name": n, "ms_per_step": us / profiled_steps / 1e3,
                            "launches_per_step": k / profiled_steps} for n, (us, k) in top[:8]],
        "warm_chunk_s": warm_s, "timed_chunk_s": timed_s, "eval_s": eval_s,
        "eval_returns": [float(r) for r in returns], "last_loss": float(loss[-1]),
    }
    print(f"{name}: env-steps/s {result['env_steps_per_s']:.1f} updates/s {result['updates_per_s']:.1f} over "
          f"{timed_steps} scan steps with 16 updates each ({scan_step_ms:.2f} ms each); through replay start "
          f"({cfg.replay_start_size:,}, cut) {result['acting_env_steps_per_s']:.1f} env-steps/s over {warm_steps} scan steps; over "
          f"{profiled_steps} profiled scan steps of {result['profiled_scan_step_ms']:.2f} ms each, device busy "
          f"{result['device_busy_ms_per_step']:.2f} ms per scan step ({result['device_busy_share'] * 100:.1f}%), "
          f"{result['device_launches_per_step']:.1f} kernels per scan step; {launches} prefix-sample launches"
          f"{' at C = 2^20, B = 32' if prioritized else ''}; evaluation {eval_s:.2f} s; last loss "
          f"{result['last_loss']:.5f} (fp32, no TF32) on {card}")
    _raise_on_failed(name, checks)
    if name == "per-dqn-ale-64":
        _KEPT[name] = train  # phase 18 saves and reloads it: no second warm-up
    del runner, evaluator, state, train, warm, timed, loss
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return result


def run_full_pipeline(card: str) -> dict:
    """``train_dqn_pipeline_ale.py --sim`` at the example's settings on the
    card: 3 spawned actor processes x 96 lanes of ``SyntheticALE`` through
    the C++ frame ops, the 999,936-plane ring (7.06 GB), bursts of 64
    batch-32 updates paced at one per 4 transitions from 50,000 on, target
    syncs every 10^4: through replay start, then ``PIPELINE_SECONDS`` of
    wall time timed and profiled (``profile_slice.run_pipeline``), then a
    clean stop."""
    from pfrl_tpu_torch.experiments.atari_pipeline import make_dqn_pipeline
    from pfrl_tpu_torch.experiments.profile_slice import run_pipeline
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    pipeline = make_dqn_pipeline(replay_start_size=PIPELINE_REPLAY_START, target_update_interval=PIPELINE_SYNC)
    prefix_sample.launches = 0
    record = run_pipeline(pipeline, *PIPELINE_SECONDS, min_updates=PIPELINE_MIN_UPDATES)
    launches = prefix_sample.launches
    timings, stats = record["timings"], record["statistics"]
    ring_bytes = pipeline.ring.nbytes
    checks = {
        "the ring holds 999,936 planes, 7.06 GB": pipeline.capacity == 999_936
        and pipeline.ring.planes.numel() == 999_936 * 7_056,
        "loss finite": math.isfinite(stats["average_loss"]),
        "the learner never ahead of acted // 4": pipeline.optim_t <= pipeline.acted_steps // 4,
        "at least one target sync": timings["target_syncs"] >= 1,
        "every thread ended": not any(t.is_alive() for t in pipeline._threads),
        "every actor process ended": all(w.exitcode is not None for w in pipeline._workers),
        "acts during bursts and between them": timings["act_round_trip_during_burst"]["n"] > 0,
        "no prefix-sample launch": launches == 0,
    }
    trip = timings["act_round_trip"]
    busy, idle = timings["act_round_trip_during_burst"], timings["act_round_trip_idle_learner"]
    fmt = lambda s: f"{s['median_ms']:.2f} / {s['p90_ms']:.2f} ms (n {s['n']})" if s["n"] else "none"  # noqa: E731
    result = {**{k: v for k, v in record.items() if k != "top_device_ops"}, "kernel_launches": launches,
              "ring_bytes": ring_bytes, "top_device_ops": record.get("top_device_ops", [])[:8]}
    print(f"dqn-pipeline-288: {pipeline.n_workers} actor processes x {pipeline.K} lanes, ring "
          f"{ring_bytes / 1e9:.3f} GB; worker start-up {timings['worker_startup_s']:.2f} s; first burst "
          f"{record['start_to_first_burst_s']:.1f} s after the start; over {record['timed_s']:.1f} s: env-steps/s "
          f"{record['env_steps_per_s']:.1f} updates/s {record['updates_per_s']:.1f}; act round trip median / p90 "
          f"{fmt(trip)} (a burst in flight {fmt(busy)}; none {fmt(idle)}); burst {fmt(timings['burst'])} (gathers "
          f"issued {fmt(timings['burst_gathers'])}, updates {fmt(timings['burst_updates'])}); commit "
          f"{fmt(timings['commit'])}; {timings['target_syncs']} target syncs; over {record['profiled_s']:.1f} s "
          f"profiled: {record['device_launches_per_s']:.0f} kernels per s ({record['device_launches_per_env_step']:.2f} "
          f"per env step), device busy {record['device_busy_share'] * 100:.1f}%; acted {pipeline.acted_steps}, "
          f"{pipeline.optim_t} updates, loss {stats['average_loss']:.5f}; {launches} prefix-sample launches "
          f"(fp32, no TF32) on {card}")
    _raise_on_failed("dqn-pipeline-288", checks)
    # Phase 18 loads this checkpoint into a fresh pipeline.
    frames = np.random.RandomState(18).randint(0, 256, (256, 84, 84, 4)).astype(np.uint8)
    checkpoint_dir = _snapshot_dir("pipeline")
    pipeline.save(checkpoint_dir)
    _KEPT["dqn-pipeline-288"] = (checkpoint_dir, frames, pipeline.greedy_actions(frames), pipeline.train_state.n_updates)
    del pipeline
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return result


# -------------------------------------------------------------------- phase 15
HOST_SMALL_DIR = OUT_DIR / "host_small"
# dqn-batch-ale-8's replay start and target interval, moved from 50,000 and
# 10,000 (then 10,000 and 10,000) for the time limit.
HOST_BATCH_REPLAY_START = 2_000
HOST_BATCH_SYNC = 2_048
HOST_BATCH_STEPS = 2_368           # past the replay start, the target sync at 2,048 and the profiled window
HOST_BATCH_PROFILED = (2_048, 32)  # from t, batch steps under torch.profiler
HOST_BATCH_EVAL = 3                # evaluation episodes (the example's 10, cut for the time limit)


def _small_host_configs() -> dict:
    """name -> (agent(device, draws), env(device, seed), driver):
    the ``DQN`` shell over PER (the prefix-sample kernel once per update),
    the ``REINFORCE`` shell at ``train_reinforce_gym.py``'s widths, and the
    ``DoubleDQN`` shell over 4 lanes of a ``SerialVectorEnv``, each on the
    500-step CartPole behind ``HostTorchEnv`` with its episodes cut at 50
    steps (CartPole grows the card's and the CPU's ulp differences of the
    state once the pole balances)."""
    from pfrl_tpu_torch.agents import DQN, DoubleDQN
    from pfrl_tpu_torch.envs import CartPole, HostTorchEnv, SerialVectorEnv
    from pfrl_tpu_torch.envs.wrappers import TimeLimit
    from pfrl_tpu_torch.experiments import train_agent_batch_with_evaluation, train_agent_with_evaluation
    from pfrl_tpu_torch.experiments.reinforce_gym import make_reinforce_agent
    from pfrl_tpu_torch.explorers import LinearDecayEpsilonGreedy
    from pfrl_tpu_torch.optimizers import Adam
    from pfrl_tpu_torch.q_functions import FCStateQFunctionWithDiscreteAction
    from pfrl_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer

    def cartpole(dev, seed):
        return HostTorchEnv(TimeLimit(CartPole(device=dev), 500), draws=SeededDraws(seed, dev))

    def dqn(cls, buffer, update_interval):
        def make(dev, draws):
            return cls(FCStateQFunctionWithDiscreteAction(4, 2, 2, 64), Adam(1e-3), buffer(dev), 0.99,
                       LinearDecayEpsilonGreedy(1.0, 0.1, 1_000, 2), replay_start_size=100, minibatch_size=32,
                       update_interval=update_interval, target_update_interval=100, device=dev, draws=draws)
        return make

    serial = functools.partial(train_agent_with_evaluation, eval_n_steps=None, eval_n_episodes=2,
                               train_max_episode_len=50)
    return {
        "host-per-dqn-cartpole": (
            dqn(DQN, lambda dev: PrioritizedReplayBuffer(10_000, betasteps=10_000, gamma=0.99, device=dev), 2),
            cartpole, functools.partial(serial, steps=180, eval_interval=90)),  # cut from 300
        "host-reinforce-cartpole": (
            lambda dev, draws: make_reinforce_agent(batchsize=2, device=dev, draws=draws),
            cartpole, functools.partial(serial, steps=120, eval_interval=120)),
        "host-double-dqn-batch-4": (
            dqn(DoubleDQN, lambda dev: ReplayBuffer(10_000, gamma=0.99, device=dev), 4),
            lambda dev, seed: SerialVectorEnv([cartpole(dev, seed + i) for i in range(4)]),
            functools.partial(train_agent_batch_with_evaluation, steps=240, eval_n_steps=None, eval_n_episodes=4,
                              eval_interval=120, max_episode_len=50)),  # cut from 400
    }


def _host_scores(outdir: Path) -> list:
    """``scores.txt``'s rows without ``elapsed``, a wall time."""
    lines = (outdir / "scores.txt").read_text().splitlines()
    header = lines[0].split("\t")
    return [{k: v for k, v in zip(header, line.split("\t")) if k != "elapsed"} for line in lines[1:]]


def run_full_host_batch(card: str) -> dict:
    """``dqn-batch-ale-8`` on the card: ``train_dqn_batch_ale.py``'s
    ``run_batch`` at the example's settings (``experiments/atari_dqn_batch.py``:
    the ``DQN`` shell, the 10^6-slot ring, 8 + 8 spawned workers of
    ``SyntheticALE`` through ``wrap_deepmind``) through its replay start
    (``HOST_BATCH_REPLAY_START``, cut from 50,000) to ``HOST_BATCH_STEPS``,
    one batch step at a time (``profile_host.run_host_batch``), then one
    evaluation of ``HOST_BATCH_EVAL`` episodes. The run's length and its replay start are
    its cuts.
    The ring is freed before the phase ends."""
    from pfrl_tpu_torch.envs import synthetic_ale
    from pfrl_tpu_torch.experiments.atari_dqn_batch import make_dqn_batch_agent, make_vector_envs
    from pfrl_tpu_torch.experiments.profile_host import run_host_batch
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    agent = make_dqn_batch_agent(replay_start_size=HOST_BATCH_REPLAY_START, target_update_interval=HOST_BATCH_SYNC)
    with spawned_workers_skip_this_script():
        env, eval_env = make_vector_envs(8, 0, make_env=synthetic_ale.make_ale_env)
    prefix_sample.launches = 0
    try:
        with tempfile.TemporaryDirectory() as outdir:  # the saved agents: 27 MB each
            record = run_host_batch(agent, env, eval_env, HOST_BATCH_STEPS, HOST_BATCH_STEPS, HOST_BATCH_EVAL, outdir,
                                    profiled=HOST_BATCH_PROFILED)
    finally:
        for e in (env, eval_env):
            if not e.closed:
                e.close()
    launches = prefix_sample.launches
    record["kernel_launches"] = launches
    stats, tm = record["statistics"], record["timings"]
    expected_updates = HOST_BATCH_STEPS // 4 - (agent.replay_start_size - 8) // 4
    checks = {
        "the 10^6-slot ring, 28.288 GB of frames": record["ring_slots"] == 10**6 and record["ring_bytes"] > 28.28e9,
        "t and the updates as the shell's gating has them": record["t"] == HOST_BATCH_STEPS
        and record["n_updates"] == expected_updates,
        "at least one target sync": record["target_syncs"] >= 1,
        "loss finite": math.isfinite(stats["average_loss"]) and math.isfinite(stats["average_q"]),
        f"one evaluation of {HOST_BATCH_EVAL} episodes, finite": len(record["eval"]) == 1
        and math.isfinite(record["eval"][0]["mean"]),
        "every worker ended": all(p.exitcode is not None for e in (env, eval_env) for p in e.ps),
        "no prefix-sample launch": launches == 0,
        "a profiled window": "profiled" in record,
    }
    prof = record.get("profiled", {})
    med = lambda k: tm.get(k, {}).get("median_ms", float("nan"))  # noqa: E731
    after = "ms_per_batch_step_after_replay_start"
    print(f"dqn-batch-ale-8: 8 + 8 spawned workers up in {record['worker_startup_s']['train']:.2f} + "
          f"{record['worker_startup_s']['eval']:.2f} s; ring {record['ring_bytes'] / 1e9:.3f} GB; env-steps/s "
          f"{record['env_steps_per_s_before_replay_start']:.1f} before the replay start ({agent.replay_start_size:,}, cut), "
          f"{record['env_steps_per_s_after_replay_start']:.1f} after it (from t = {record['learning_from_t']:,}, past "
          f"the profiled window), updates/s "
          f"{record['updates_per_s_after_replay_start']:.1f}; median batch_act {med('batch_act'):.3f} ms, env round "
          f"trip {med('env round trip'):.3f} ms, batch_observe {med('batch_observe (ring add)'):.3f} ms (ring add), "
          f"{med('batch_observe with updates'):.3f} ms (with its updates), update {med('update'):.3f} ms; past the "
          f"profiled window {record['batch_step_ms_after_replay_start']:.3f} ms per batch step, of which "
          f"{', '.join(f'{k} {v[after]:.3f}' for k, v in tm.items() if v.get(after) is not None)}; "
          f"{record['n_updates']} updates, {record['target_syncs']} target syncs; over {prof.get('batch_steps')} "
          f"profiled batch steps {prof.get('kernels_per_batch_step', float('nan')):.1f} kernels per batch step, "
          f"device busy {prof.get('device_busy_share', float('nan')) * 100:.1f}%; evaluation mean "
          f"{record['eval'][0]['mean'] if record['eval'] else float('nan')} over {HOST_BATCH_EVAL} episodes; loss "
          f"{stats['average_loss']:.5f}; {launches} prefix-sample launches (fp32, no TF32) on {card}")
    _raise_on_failed("dqn-batch-ale-8", checks)
    agent.replay_state = None
    del agent
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return record


# -------------------------------------------------------------------- phase 16
def _small_shell_configs() -> dict:
    """name -> (agent(device, draws), env(device, seed), driver, observation
    size, action shape[, tolerance overrides]): the ``DDPG`` (hard
    targets), ``TD3`` (two lanes through the batch driver,
    ``update_burst``), ``SoftActorCritic`` and ``PPO`` shells on the
    time-limited Pendulum (50 steps, ``NormalizeActionSpace``), ``TRPO``
    over one update on a 3 x 1 MujocoSim, ``A2C`` on four CartPole lanes,
    and the eight value-family shells over PER (the prefix-sample kernel
    once per update on the card) on CartPole stepped on the CPU, each
    behind ``HostTorchEnv`` with episodes cut at 50 steps, at widths of
    64."""
    from pfrl_tpu_torch import agents, spaces
    from pfrl_tpu_torch.envs import CartPole, HostTorchEnv, MujocoSim, Pendulum, SerialVectorEnv
    from pfrl_tpu_torch.envs.wrappers import TimeLimit
    from pfrl_tpu_torch.experiments import train_agent_batch_with_evaluation, train_agent_with_evaluation
    from pfrl_tpu_torch.experiments.cartpole_value import ReLUMLP
    from pfrl_tpu_torch.experiments.mujoco_actor_critic import MLPPolicy, uniform_burnin
    from pfrl_tpu_torch.experiments.onpolicy import GaussianPiV, GaussianPolicy, SoftmaxPiV
    from pfrl_tpu_torch.explorers import AdditiveGaussian, LinearDecayEpsilonGreedy
    from pfrl_tpu_torch.models import MLP
    from pfrl_tpu_torch.optimizers import Adam, RMSprop
    from pfrl_tpu_torch.policies import DeterministicHead, SquashedGaussianHead
    from pfrl_tpu_torch.q_functions import (
        DistributionalFCStateQFunctionWithDiscreteAction,
        FCStateQFunctionWithDiscreteAction,
        ImplicitQuantileQFunction,
        FCSAQFunction,
    )
    from pfrl_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer
    from pfrl_tpu_torch.wrappers import NormalizeActionSpace

    def pendulum(dev, seed):
        return NormalizeActionSpace(HostTorchEnv(TimeLimit(Pendulum(device=dev), 50), draws=SeededDraws(seed, dev)))

    def cartpole(dev, seed):
        return HostTorchEnv(TimeLimit(CartPole(device=dev), 500), draws=SeededDraws(seed, dev))

    def cartpole_on_cpu(dev, seed):
        """The value shells' env, stepped on the CPU for the card's agent too
        (C.1: stepped on the card, CUDA's ``sin``/``cos`` moved AL's, PAL's
        and Double PAL's weights 20x past the nudges over 31 updates; stepped
        on the CPU, within 2.7x)."""
        return cartpole("cpu", seed)

    def lanes(env, n):
        return lambda dev, seed: SerialVectorEnv([env(dev, seed + i) for i in range(n)])

    serial = functools.partial(train_agent_with_evaluation, eval_n_steps=None, eval_n_episodes=2,
                               train_max_episode_len=50)
    batch = functools.partial(train_agent_batch_with_evaluation, eval_n_steps=None, eval_n_episodes=2,
                              max_episode_len=50)
    box = spaces.box(-1.0, 1.0, (1,))
    det = lambda: MLPPolicy(3, 1, (64, 64), DeterministicHead(), squash=torch.tanh)  # noqa: E731
    qf = lambda: FCSAQFunction(3, 1, 64, 2)  # noqa: E731
    off = dict(action_space=box, replay_start_size=100, minibatch_size=32, burnin_action_func=uniform_burnin(1),
               burnin_steps=100)

    def ring(dev):
        return ReplayBuffer(10_000, gamma=0.99, device=dev)

    configs = {
        "host-ddpg-pendulum-hard": (
            lambda dev, draws: agents.DDPG(det(), qf(), Adam(1e-3), Adam(1e-3), ring(dev), 0.99,
                                           AdditiveGaussian(0.1, low=-1.0, high=1.0), target_update_method="hard",
                                           target_update_interval=50, device=dev, draws=draws, **off),
            pendulum, functools.partial(serial, steps=180, eval_interval=90), 3, (1,)),
        "host-td3-pendulum-batch-2-burst": (
            lambda dev, draws: agents.TD3(det(), qf(), qf(), Adam(3e-4), Adam(3e-4), Adam(3e-4), ring(dev), 0.99,
                                          AdditiveGaussian(0.1, low=-1.0, high=1.0), update_burst=True, device=dev,
                                          draws=draws, **off),
            lanes(pendulum, 2), functools.partial(batch, steps=180, eval_interval=90), 3, (1,)),
        "host-sac-pendulum": (
            lambda dev, draws: agents.SoftActorCritic(
                MLPPolicy(3, 2, (64, 64), SquashedGaussianHead(1)), qf(), qf(), Adam(3e-4), Adam(3e-4), Adam(3e-4),
                ring(dev), 0.99, temperature_optimizer_lr=3e-4, device=dev, draws=draws, **off),
            pendulum, functools.partial(serial, steps=180, eval_interval=90), 3, (1,)),
        "host-ppo-pendulum": (
            lambda dev, draws: agents.PPO(GaussianPiV(3, 1, 64, mean_scale=1e-4), Adam(3e-4), gamma=0.995, lambd=0.97,
                                          update_interval=64, minibatch_size=16, epochs=2, entropy_coef=0.0,
                                          device=dev, draws=draws),
            pendulum, functools.partial(serial, steps=200, eval_interval=100), 3, (1,)),
        "host-a2c-cartpole-batch-4": (
            lambda dev, draws: agents.A2C(SoftmaxPiV(4, 2, 64), RMSprop(7e-4, decay=0.99, eps=1e-5), 0.99, 4,
                                          update_steps=5, max_grad_norm=40.0, device=dev, draws=draws),
            lanes(cartpole, 4), functools.partial(batch, steps=200, eval_interval=100), 4, ()),
        "host-trpo-mujocosim": (
            lambda dev, draws: agents.TRPO(GaussianPolicy(3, 1, 64, mean_scale=1e-2), MLP(3, 1, (64, 64)),
                                           Adam(1e-3), gamma=0.995, lambd=0.97, update_interval=100, vf_epochs=2,
                                           vf_batch_size=32, device=dev, draws=draws),
            lambda dev, seed: HostTorchEnv(MujocoSim(3, 1, episode_len=50, device=dev), draws=SeededDraws(seed, dev)),
            # One update, on the last step: on the 50-step Pendulum, CUDA's
            # and the CPU's sin and cos moved the rollouts an ulp apart,
            # and conjugate gradient (C21) amplified that to 5.3e-4 in the
            # evaluation's actions after one update; MujocoSim contracts.
            functools.partial(serial, steps=100, eval_interval=100), 3, (1,)),
    }
    q_functions = {
        "fc": lambda: FCStateQFunctionWithDiscreteAction(4, 2, 2, 64),
        "categorical": lambda: DistributionalFCStateQFunctionWithDiscreteAction(4, 2, 51, 0.0, 100.0, 2, 64),
        "iqn": lambda: ImplicitQuantileQFunction(ReLUMLP(4, 64, 64), 64, 2, n_basis_functions=64),
    }
    for shell in ("AL", "PAL", "DoublePAL", "DPP", "CategoricalDQN", "CategoricalDoubleDQN", "IQN", "DoubleIQN"):
        kind = "categorical" if shell.startswith("Categorical") else "iqn" if shell.endswith("IQN") else "fc"

        def make(dev, draws, cls=getattr(agents, shell), q=q_functions[kind]):
            return cls(q(), Adam(1e-3), PrioritizedReplayBuffer(10_000, betasteps=10_000, gamma=0.99, device=dev),
                       0.99, LinearDecayEpsilonGreedy(1.0, 0.1, 1_000, 2), replay_start_size=100,
                       minibatch_size=32, update_interval=2, target_update_interval=100, device=dev, draws=draws)

        configs[f"host-per-{shell.lower()}-cartpole"] = (
            make, cartpole_on_cpu, functools.partial(serial, steps=130, eval_interval=65), 4, ())
    return configs


def _learned_tensors(state) -> dict:
    """Every tensor a shell's state learns: each network's parameters, each
    optimizer's moments (Adam's ``mu`` and ``nu``, RMSprop's list of ``nu``)
    and any learned tensor (SAC's ``log_temperature``)."""
    out = {}
    for field, value in vars(state).items():
        if isinstance(value, torch.nn.Module):
            out.update({f"{field} {n}": p for n, p in value.named_parameters()})
        elif isinstance(value, torch.Tensor):
            out[field] = value
        elif isinstance(value, list) and value and isinstance(value[0], torch.Tensor):
            out.update({f"nu {field} {i}": m for i, m in enumerate(value)})
        else:
            for k in ("mu", "nu"):
                out.update({f"{k} {field} {i}": m for i, m in enumerate(getattr(value, k, None) or [])})
    return {k: v.detach().to("cpu", copy=True) for k, v in out.items()}  # a copy on the CPU too


RETURN_COLUMNS = ("mean", "median", "stdev", "max", "min")


def _learned_differences(card_state, cpu_state, nudged_states, floor: float = 0.0) -> dict:
    """name -> (the card's largest difference from the CPU, its bound): 3e-6
    (first moments 3e-6 of their largest where that exceeds 1; second
    moments 1e-5 of their largest), at least ``floor``, or 4x what the
    nudged runs move it where that is more (C22, C48, C54)."""
    worst = {}
    got, want = _learned_tensors(card_state), _learned_tensors(cpu_state)
    nudged_tensors = [_learned_tensors(n) for n in nudged_states]
    for key, x in got.items():
        nudge = max(float((want[key] - n[key]).abs().max()) for n in nudged_tensors)
        scale = float(want[key].abs().max())
        base = 1e-5 * scale if key.startswith("nu ") else 3e-6 * max(1.0, scale) if key.startswith("mu ") else 3e-6
        worst[key] = (float((x - want[key]).abs().max()), max(base, floor, 4 * nudge))
    return worst


def _within_nudges(got: float, want: float, nudged: list, rel: float, floor: float) -> bool:
    """``got`` within ``rel`` of ``want`` (``floor`` absolute), or within 4x
    what the nudged runs move ``want``."""
    nudge = max(abs(n - want) for n in nudged)
    return abs(got - want) <= max(rel * abs(want), floor, 4 * nudge)


def check_small_shell(name: str, make_agent, make_env, drive, obs_size, action_shape, device,
                      extra_checks=None) -> dict:
    """One host shell through its driver on the card and on the CPU, from
    the same weights (a CPU generator's) and draws (``SeededDraws``):
    discrete actions, the step, update and target-sync counts and the
    evaluation rows equal; continuous actions within 1e-5, and the returns
    within 1e-4 relative, or 4x what 1 + 2**-23 and 1 - 2**-23 nudges of
    the weights move them on the CPU; the statistics within 1e-4 relative
    (5e-5 absolute: the baseline makes REINFORCE's loss a near-cancelling
    sum), or 4x what the nudges move them (host NAF's means over 201
    chaotic updates); every learned tensor within 3e-6 (first moments 3e-6 of their
    largest where that exceeds 1: a critic's gradients reach tens; second
    moments 1e-5 of their largest) or 4x what the nudges move it, where
    that is more (C22, C48, C54). A prioritized ring launches the
    prefix-sample kernel once per update on the card. ``obs_size`` is the
    observation's width, or ``example(device)`` giving an example batch of
    a structured observation; ``extra_checks(card_agent, cpu_agent)`` adds
    named checks."""
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    def run(dev, tag, scale=1.0):
        agent = make_agent(dev, SeededDraws(1, dev))
        example = obs_size(dev) if callable(obs_size) else torch.zeros((1, obs_size), device=dev)
        agent.train_state = agent.core.init(torch.Generator().manual_seed(0), example,
                                            torch.zeros((1,) + tuple(action_shape), device=dev))
        with torch.no_grad():
            for module in vars(agent.train_state).values():
                for p in module.parameters() if isinstance(module, torch.nn.Module) else ():
                    p.mul_(scale)
        log = {"actions": [], "syncs": 0}
        act, sync = agent.batch_act, getattr(agent.core, "sync_target", None)

        def batch_act(batch_obs):
            out = act(batch_obs)
            log["actions"].append(np.asarray(out).copy())
            return out

        def sync_target(state):
            log["syncs"] += 1
            return sync(state)

        agent.batch_act = batch_act
        if sync is not None:
            agent.core.sync_target = sync_target
        outdir = HOST_SMALL_DIR / name / tag
        drive(agent, make_env(dev, 10), outdir=str(outdir), eval_env=make_env(dev, 20))
        for saved in [p for p in outdir.iterdir() if p.is_dir()]:  # the saved agents: scores.txt is kept
            shutil.rmtree(saved)
        return agent, log, _host_scores(outdir)

    prefix_sample.launches = 0
    card, card_log, card_scores = run(device, "card")
    torch.cuda.synchronize()
    launches = prefix_sample.launches
    cpu, cpu_log, cpu_scores = run("cpu", "cpu")
    nudged = [run("cpu", f"nudged{i}", s) for i, s in enumerate(ACER_NUDGES)]
    card_actions, cpu_actions = card_log["actions"], cpu_log["actions"]
    continuous = cpu_actions[0].dtype.kind == "f"
    action_diff, action_bound = 0.0, 0.0
    same_count = len(card_actions) == len(cpu_actions) > 0 and all(len(n[1]["actions"]) == len(cpu_actions)
                                                                   for n in nudged)
    if same_count and continuous:
        for i, (a, b) in enumerate(zip(card_actions, cpu_actions)):
            nudge = max(float(np.abs(n[1]["actions"][i] - b).max()) for n in nudged)
            diff, bound = float(np.abs(a - b).max()), max(1e-5, 4 * nudge)
            if diff / bound > action_diff / max(action_bound, 1e-30):
                action_diff, action_bound = diff, bound
    prioritized = hasattr(getattr(card, "buffer", None), "tree_capacity")
    updates = card.train_state.n_updates
    checks = {
        "actions": same_count and (all(np.array_equal(a, b) for a, b in zip(card_actions, cpu_actions))
                                   if not continuous else action_diff <= action_bound),
        "equal step, update and sync counts": card.t == cpu.t and updates == cpu.train_state.n_updates > 0
        and card_log["syncs"] == cpu_log["syncs"],
        # Continuous actions move the returns by what they move the actions.
        "equal evaluation rows": len(card_scores) == len(cpu_scores) >= 1 and all(
            a[k] == b[k] for a, b in zip(card_scores, cpu_scores) for k in a
            if not k.startswith("average_") and not (continuous and k in RETURN_COLUMNS)),
        "evaluation returns within their bounds": not continuous or all(
            _within_nudges(float(a[k]), float(b[k]), [float(n[2][i][k]) for n in nudged], 1e-4, 1e-4)
            for i, (a, b) in enumerate(zip(card_scores, cpu_scores)) for k in RETURN_COLUMNS),
        "statistics within 1e-4, or 4x the nudges": all(
            _within_nudges(float(a), float(b), [float(dict(n[0].get_statistics())[k]) for n in nudged], 1e-4, 5e-5)
            for (k, a), (_, b) in zip(card.get_statistics(), cpu.get_statistics())),
        "prefix-sample launches": launches == (card.optim_t if prioritized else 0),
    }
    worst = _learned_differences(card.train_state, cpu.train_state, [n[0].train_state for n in nudged])
    checks["learned tensors within their bounds"] = all(d <= b for d, b in worst.values())
    if extra_checks is not None:
        checks.update(extra_checks(card, cpu))
    top = max(worst.items(), key=lambda kv: kv[1][0] / kv[1][1])
    actions = (f"largest action difference {action_diff:.3g} <= {action_bound:.3g}" if continuous
               else f"actions {'equal' if checks['actions'] else 'DIFFER'}")
    print(f"small {name}: card vs CPU over {card.t} host steps, {updates} updates, {card_log['syncs']} target syncs, "
          f"{len(card_actions)} acts ({actions}), {launches} prefix-sample launches; largest difference against its "
          f"bound {top[0]} {top[1][0]:.3g} <= {top[1][1]:.3g}; evaluation rows {[r['mean'] for r in card_scores]}")
    _raise_on_failed(f"small {name}", checks)
    return {"host_steps": card.t, "updates": updates, "acts": len(card_actions), "kernel_launches": launches,
            "largest_action_difference": action_diff, "action_bound": action_bound,
            "largest_differences": {k: v[0] for k, v in worst.items()}, "bounds": {k: v[1] for k, v in worst.items()}}


def probe_shell_divergence(name: str, env_device=None, steps=None, make_env=None) -> dict:
    """Where a small shell run's card-vs-CPU gap opens (ROADMAP C.1, C.2);
    not a phase of ``main``: call it alone after ``build_kernels()``.

    Runs the shell ``name`` of ``_small_shell_configs`` or
    ``_small_phase19_shells`` on the card and on the CPU, each also from its
    weights nudged by 1 + 2**-23 and 1 - 2**-23, with the env stepped on
    ``env_device`` (default: the agent's device) for ``steps`` host steps
    (default: the config's), or made by ``make_env(device, seed)`` in
    place of the config's (:func:`cartpole_host_env` steps CartPole where
    it is asked to), and records every learned tensor after every
    update. Prints, for each update, the tensor whose card-vs-CPU gap is
    largest against the CPU's nudges, with the card's own nudges beside it,
    and returns the first update at which the gap exceeds 4x the CPU's
    nudges (and C22's 3e-6)."""
    configs = {**_small_shell_configs(), **_small_phase19_shells()}
    make_agent, config_env, drive, obs_size, action_shape = configs[name][:5]
    make_env = make_env or config_env
    if steps is not None:
        drive = functools.partial(drive, steps=steps, eval_interval=steps)
    cuda = resolve_card()

    def run(dev, tag, scale):
        agent = make_agent(dev, SeededDraws(1, dev))
        example = obs_size(dev) if callable(obs_size) else torch.zeros((1, obs_size), device=dev)
        agent.train_state = agent.core.init(torch.Generator().manual_seed(0), example,
                                            torch.zeros((1,) + tuple(action_shape), device=dev))
        with torch.no_grad():
            for module in vars(agent.train_state).values():
                for p in module.parameters() if isinstance(module, torch.nn.Module) else ():
                    p.mul_(scale)
        trail, update = [], agent._update_once

        def recorded():
            update()
            trail.append(_learned_tensors(agent.train_state))

        agent._update_once = recorded
        env_dev = env_device or dev
        outdir = HOST_SMALL_DIR / "probe" / name / tag
        drive(agent, make_env(env_dev, 10), outdir=str(outdir), eval_env=make_env(env_dev, 20))
        shutil.rmtree(outdir, ignore_errors=True)
        return trail

    card, cpu = run(cuda, "card", 1.0), run("cpu", "cpu", 1.0)
    card_nudged = [run(cuda, f"card{i}", s) for i, s in enumerate(ACER_NUDGES)]
    cpu_nudged = [run("cpu", f"cpu{i}", s) for i, s in enumerate(ACER_NUDGES)]
    updates = min(len(card), len(cpu), *map(len, card_nudged + cpu_nudged))
    rows, opened = [], None
    for k in range(updates):
        worst = None
        for key, want in cpu[k].items():
            gap = float((card[k][key] - want).abs().max())
            cpu_nudge = max(float((n[k][key] - want).abs().max()) for n in cpu_nudged)
            card_nudge = max(float((n[k][key] - card[k][key]).abs().max()) for n in card_nudged)
            ratio = gap / max(cpu_nudge, 1e-30)
            if worst is None or ratio > worst[1]:
                worst = (key, ratio, gap, cpu_nudge, card_nudge)
        rows.append(worst)
        if opened is None and worst[2] > max(4 * worst[3], 3e-6):
            opened = k + 1
    for k, (key, ratio, gap, cpu_nudge, card_nudge) in enumerate(rows):
        if k < 4 or (k + 1) % 10 == 0 or k + 1 == updates or k + 1 == opened:
            print(f"probe {name} (env on {env_device or 'the agent device'}): update {k + 1}: {key} card-vs-CPU "
                  f"{gap:.3g}, CPU nudges {cpu_nudge:.3g}, card nudges {card_nudge:.3g} (ratio {ratio:.3g})")
    print(f"probe {name}: {updates} updates; the gap exceeds 4x the CPU's nudges first at update {opened}")
    return {"updates": updates, "opened": opened,
            "rows": [dict(zip(("key", "ratio", "gap", "cpu_nudge", "card_nudge"), r)) for r in rows]}


def cartpole_host_env(dev, seed):
    """The value shells' CartPole behind ``HostTorchEnv``, stepped on ``dev``."""
    from pfrl_tpu_torch.envs import CartPole, HostTorchEnv, TimeLimit

    return HostTorchEnv(TimeLimit(CartPole(device=dev), 500), draws=SeededDraws(seed, dev))


def resolve_card():
    from pfrl_tpu_torch import resolve_device

    return resolve_device()


# The profiled windows: 32 batch steps from the learning start, or, for the
# on-policy paths, around an update (PPO's first at 2,048, TRPO's first at
# 5,000).
HOST_PATH_PROFILED = {"ppo-hopper-host-1": (2_040, 32), "trpo-hopper-host-1": (4_984, 32),
                      "naf-pendulum-host-32": (896, 4)}  # 32 lanes: 4 batch steps of 32 updates each
# Cut for the script's time limit (HOST_PATHS' own: the replay start and burn-in of 10,000, t = 11,000,
# 2,600, 6,144 and 10,000): the actor-critic paths learn from 1,000 to 1,200 (201 updates, the truncation at
# step 1,000 crossed; was 2,000 to 2,200), Rainbow from 128 to 192 (65 updates, its target sync moved from
# 2,000 to 160 and crossed; was 1,800 to 2,016), PPO to 2,080 (one update) and TRPO to 5,024 (one), each
# past its profiled window.
ACTOR_CRITIC_HOST_PATHS = ("sac-halfcheetah-host-1", "td3-halfcheetah-host-1", "ddpg-halfcheetah-host-1",
                           "td3-halfcheetah-host-4-burst")
HOST_PATH_REPLAY_START = {**{name: 1_000 for name in ACTOR_CRITIC_HOST_PATHS}, "rainbow-slimevolley-cartpole-1": 128,
                          # Phase 19's host modes (cut from 1,536).
                          "naf-pendulum-host-32": 896, "c51-gym-cartpole-host-1": 896}
HOST_PATH_STEPS = {**{name: 1_200 for name in ACTOR_CRITIC_HOST_PATHS}, "rainbow-slimevolley-cartpole-1": 192,
                   "ppo-hopper-host-1": 2_080, "trpo-hopper-host-1": 5_024,
                   # Phase 19's host modes, cut from HOST_PATHS' 3,072 (then 2,112) to the
                   # scan past their sync, moved from 2,048 to 1,024: 224 and 193 updates from 896.
                   "naf-pendulum-host-32": 1_088, "c51-gym-cartpole-host-1": 1_088}
# Keyword arguments a path's agent takes beyond its replay start: the target syncs moved.
HOST_PATH_AGENT_CUTS = {"rainbow-slimevolley-cartpole-1": {"target_update_interval": 160},
                        "naf-pendulum-host-32": {"target_update_interval": 1_024},
                        "c51-gym-cartpole-host-1": {"target_update_interval": 1_024}}
# Evaluation episodes cut below a path's own (sac-atlas-pendulum-host-4: 20 of 200 steps; the one-lane
# MuJoCo paths: 2 of 1,000 steps, each through the truncation).
HOST_PATH_EVAL_EPISODES = {"sac-atlas-pendulum-host-4": 4, "sac-halfcheetah-host-1": 1, "td3-halfcheetah-host-1": 1,
                           "ddpg-halfcheetah-host-1": 1}


def run_full_host_path(card: str, name: str) -> dict:
    """One path of ``profile_host.HOST_PATHS`` on the card at its script's
    widths and settings, through ``make_*_agent``, ``HostTorchEnv`` (the
    env on the CPU, where a host simulator runs) and the script's driver,
    then one evaluation (``profile_host.run_host_batch``). Only the run's
    length is cut, and the evaluation's episodes (2 of MujocoSim's 1,000
    steps, 10 of CartPole). Rainbow's target must equal the online network
    after each hard sync, and its ring is the example's 10^6 transitions,
    2^20 leaves, sampled by the prefix-sample kernel once per update."""
    from pfrl_tpu_torch.experiments.profile_host import HOST_PATHS, learning_start, make_host_path, run_host_batch
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    path = HOST_PATHS[name]
    steps = HOST_PATH_STEPS.get(name, path.steps)
    cut = {"replay_start_size": HOST_PATH_REPLAY_START[name]} if name in HOST_PATH_REPLAY_START else {}
    agent, env, eval_env = make_host_path(name, **cut, **HOST_PATH_AGENT_CUTS.get(name, {}))
    if name in SPAWNED_HOST_PATHS:  # the script's MultiprocessVectorEnv in place of the serial lanes
        from pfrl_tpu_torch.experiments import sac_atlas

        from pfrl_tpu_torch.envs.multiprocess_vector_env import make_together

        args = sac_atlas.parser().parse_args(["--torch-env"])
        with spawned_workers_skip_this_script():
            env, eval_env = make_together(functools.partial(sac_atlas.make_batch_env, args, False),
                                          functools.partial(sac_atlas.make_batch_env, args, True))
    start = learning_start(agent)
    synced_equal = []
    sync_target = getattr(agent.core, "sync_target", None)

    def checked_sync(state):
        out = sync_target(state)
        if agent.core.target_update_method == "hard" and hasattr(state, "target_model"):
            synced_equal.append(all(torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                                       state.target_model.parameters())))
        return out

    if sync_target is not None:
        agent.core.sync_target = checked_sync
    prefix_sample.launches = 0
    try:
        with tempfile.TemporaryDirectory() as outdir:  # the saved agents
            record = run_host_batch(agent, env, eval_env, steps, steps,
                                    HOST_PATH_EVAL_EPISODES.get(name, path.eval_n_episodes), outdir,
                                    profiled=HOST_PATH_PROFILED.get(name, (start, 32)))
    finally:
        if name in SPAWNED_HOST_PATHS:
            for e in (env, eval_env):
                if not e.closed:
                    e.close()
    torch.cuda.synchronize()
    launches = prefix_sample.launches
    record["kernel_launches"] = launches
    record["hard_syncs_equal"] = synced_equal
    onpolicy = not hasattr(agent, "replay_start_size")
    lanes = path.lanes
    if onpolicy:
        expected_updates = steps // agent.update_interval
    else:
        expected_updates = (steps - (start - lanes)) * agent.n_times_update // agent.update_interval
    prioritized = hasattr(agent.buffer, "tree_capacity") if not onpolicy else False
    stats, tm = record["statistics"], record["timings"]
    checks = {
        "t and the updates as the shell's gating has them": record["t"] == steps
        and record["n_updates"] == expected_updates,
        "statistics finite": all(math.isfinite(float(v)) for v in stats.values()),
        "one evaluation, finite": len(record["eval"]) == 1 and math.isfinite(record["eval"][0]["mean"]),
        "prefix-sample launches": launches == (record["n_updates"] if prioritized else 0),
        "a profiled window": "profiled" in record,
    }
    if prioritized:
        checks["the example's 10^6-transition ring, 2^20 leaves"] = agent.buffer.tree_capacity == 2**20
    if prioritized or name in PHASE_19_HOST_PATHS or name == "quickstart-dqn-cartpole-host-1":
        checks["the target equals the online network after each hard sync"] = len(synced_equal) >= 1 and all(
            synced_equal)
    if not onpolicy:
        slots = {**PHASE_19_HOST_PATHS, **PHASE_20_HOST_PATHS}.get(name, 10**6)
        checks[f"the script's {slots:,}-slot ring"] = record["ring_slots"] == slots
    prof = record.get("profiled", {})
    med = lambda k: tm.get(k, {}).get("median_ms", float("nan"))  # noqa: E731
    env_label = "env round trip" if lanes > 1 else "env step"
    print(f"{name}: {lanes} lane(s); ring {record['ring_bytes'] / 1e6:.1f} MB; env-steps/s "
          f"{record['env_steps_per_s_before_replay_start'] or float('nan'):.1f} before the learning start "
          f"({start:,}), {record['env_steps_per_s_after_replay_start'] or float('nan'):.1f} after it (from t = "
          f"{record['learning_from_t']:,}), updates/s {record['updates_per_s_after_replay_start'] or float('nan'):.2f}; "
          f"median batch_act {med('batch_act'):.3f} ms, {env_label} {med(env_label):.3f} ms, batch_observe "
          f"{med('batch_observe (ring add)'):.3f} ms, update {med('update'):.3f} ms; {record['n_updates']} updates, "
          f"{record['target_syncs']} sync_target calls; over {prof.get('batch_steps')} profiled batch steps with "
          f"{prof.get('updates')} updates {prof.get('kernels_per_batch_step', float('nan')):.1f} kernels per batch "
          f"step, {prof.get('kernels_per_update') or float('nan'):.1f} per update, device busy "
          f"{prof.get('device_busy_share', float('nan')) * 100:.1f}%; evaluation mean "
          f"{record['eval'][0]['mean'] if record['eval'] else float('nan'):.3f} over "
          f"{HOST_PATH_EVAL_EPISODES.get(name, path.eval_n_episodes)} episodes; "
          f"{launches} prefix-sample launches (fp32, no TF32) on {card}")
    _raise_on_failed(name, checks)
    agent.replay_state = None
    del agent
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return record

# -------------------------------------------------------------------- phase 17
AL_SMALL_TRANSITIONS = 160  # the one actor's transitions, drained by the poller before the learner runs
AL_SMALL_UPDATES = 31
AL_FULL_REPLAY_START = 400      # cut from the example's 50,000 for the time limit (then 4,000)
AL_FULL_EVAL_INTERVAL = 800     # cut from the example's 10^5 (then 5,000): one evaluation
AL_FULL_EVAL = 3                # its episodes (the example's 10, cut for the time limit)
AL_FULL_UPDATES = 32            # the learner's updates (HOST_PATHS' 640, cut for the time limit; then 128)
AL_FULL_PROFILED = (16, 16)     # the learner's last 16 updates under torch.profiler, after the timed ones
A3C_ITERATIONS = 20             # a3c-atarisim-16: timed, after one warm iteration (cut from 40)


def _al_script(seed: int, n: int) -> list:
    """One actor's transitions, as ``StateQFunctionActor.observe`` queues
    them, with episode ends and time-limit resets."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        done = bool(rs.uniform() < 0.05)
        reset = not done and bool(rs.uniform() < 0.02)
        out.append((0, dict(obs=rs.normal(size=4).astype(np.float32), action=np.int64(rs.randint(2)),
                            reward=np.float32(rs.normal()), next_obs=rs.normal(size=4).astype(np.float32),
                            terminated=done, done=done or reset)))
    return out


def check_small_actor_learner(name: str, cls_name: str, prioritized: bool, device) -> dict:
    """The ``DQN`` shell's actor-learner half in lockstep, on the card and
    on the CPU from the same weights (a CPU generator's) and draws
    (``SeededDraws``: the learner's, and the server's own): one actor's
    pre-filled transition queue drained by ``_poller_loop`` (then stopped),
    the server's padded act of 3 rows into 8 slots, then ``_learner_loop``
    for 31 updates. The ring rows, the sampled ids of every update and the
    actions equal; ``t``, the updates, publications and target syncs equal;
    the statistics within 1e-4; every learned tensor within 3e-6 or 4x what
    1 + 2**-23 and 1 - 2**-23 nudges of the weights move it (C22, C54). Over
    PER (``DoubleDQN``, C = 2**14) the card launches the prefix-sample
    kernel once per update, and its draws are the plain version's."""
    import logging
    import threading

    from pfrl_tpu_torch import agents
    from pfrl_tpu_torch.explorers import LinearDecayEpsilonGreedy
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample
    from pfrl_tpu_torch.optimizers import Adam
    from pfrl_tpu_torch.parallel.inference_server import _Request
    from pfrl_tpu_torch.q_functions import FCStateQFunctionWithDiscreteAction
    from pfrl_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer

    script = _al_script(3, AL_SMALL_TRANSITIONS)

    def run(dev, scale=1.0):
        buffer = (PrioritizedReplayBuffer(10_000, betasteps=10_000, gamma=0.99, device=dev) if prioritized
                  else ReplayBuffer(10_000, gamma=0.99, device=dev))
        agent = getattr(agents, cls_name)(
            FCStateQFunctionWithDiscreteAction(4, 2, 2, 64), Adam(1e-3), buffer, 0.99,
            LinearDecayEpsilonGreedy(1.0, 0.1, 1_000, 2), replay_start_size=100, minibatch_size=32,
            update_interval=1, target_update_interval=8, device=dev, draws=SeededDraws(1, dev))
        agent.train_state = agent.core.init(torch.Generator().manual_seed(0), torch.zeros((1, 4), device=dev))
        with torch.no_grad():
            for module in (agent.train_state.model, agent.train_state.target_model):
                for p in module.parameters():
                    p.mul_(scale)
        make_actor, _, poller, exception_event = agent.setup_actor_learner_training(
            n_actors=1, inference_slots=8, actor_draws=SeededDraws(2, dev))
        transitions = make_actor(0).transition_queue
        for msg in script:
            transitions.put(msg)
        poller.start()
        deadline = time.time() + 60
        while agent._replay_inserted < len(script) and time.time() < deadline and not exception_event.is_set():
            time.sleep(0.01)
        poller.stop()
        poller.join()
        if exception_event.is_set() or agent._replay_inserted != len(script):
            raise AssertionError(f"small {name}: the poller failed ({agent.actor_learner_errors})")
        request = _Request(np.random.RandomState(4).normal(size=(3, 4)).astype(np.float32), 3, True)
        agent._inference._run_batch([request], 3)  # the poller stopped the server thread
        sampled, syncs = [], []
        sample, sync_target = agent.buffer.sample, agent.core.sync_target

        def recording_sample(state, draws, batch_size):
            out = sample(state, draws, batch_size)
            sampled.append((out[0] if isinstance(out, tuple) else out).indices.cpu())
            return out

        def counted_sync(state):
            syncs.append(agent.t)
            return sync_target(state)

        agent.buffer.sample, agent.core.sync_target = recording_sample, counted_sync
        prefix_sample.launches = 0
        agent._learner_loop(threading.Event(), exception_event, AL_SMALL_UPDATES, 8, [], [],
                            logging.getLogger("chip_smoke"))
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        if exception_event.is_set():
            raise AssertionError(f"small {name}: the learner failed ({agent.actor_learner_errors})")
        return agent, {"actions": request.actions, "sampled": sampled, "syncs": syncs,
                       "launches": prefix_sample.launches}

    card, card_log = run(device)
    cpu, cpu_log = run("cpu")
    nudged = [run("cpu", s)[0] for s in ACER_NUDGES]
    card_ring, cpu_ring = (getattr(a.replay_state, "base", a.replay_state) for a in (card, cpu))
    rings_equal = all(torch.equal(x.cpu(), cpu_ring.storage[k]) for k, x in card_ring.storage.items())
    worst = _learned_differences(card.train_state, cpu.train_state, [n.train_state for n in nudged])
    launches = card_log["launches"]
    checks = {
        "the ring rows equal": rings_equal and int(card_ring.cursor) == int(cpu_ring.cursor) == AL_SMALL_TRANSITIONS,
        "the padded act's actions equal": np.array_equal(card_log["actions"], cpu_log["actions"])
        and card_log["actions"].shape == (3,),
        "the sampled ids of every update equal": len(card_log["sampled"]) == AL_SMALL_UPDATES and all(
            torch.equal(a, b) for a, b in zip(card_log["sampled"], cpu_log["sampled"])),
        "t, updates, publications and syncs": card.t == cpu.t == AL_SMALL_UPDATES
        and card.optim_t == cpu.optim_t == card.train_state.n_updates == AL_SMALL_UPDATES
        and card.update_counter.value == cpu.update_counter.value == AL_SMALL_UPDATES // 8
        and card_log["syncs"] == cpu_log["syncs"] == [8, 16, 24],
        "statistics within 1e-4": all(math.isclose(float(a), float(b), rel_tol=1e-4, abs_tol=5e-5)
                                      for (_, a), (_, b) in zip(card.get_statistics(), cpu.get_statistics())),
        "learned tensors within their bounds": all(d <= b for d, b in worst.values()),
        "prefix-sample launches": launches == (AL_SMALL_UPDATES if prioritized else 0),
    }
    top = max(worst.items(), key=lambda kv: kv[1][0] / kv[1][1])
    print(f"small {name}: card vs CPU, one actor's {AL_SMALL_TRANSITIONS} transitions through the poller, the padded "
          f"act of 3 rows in 8 slots {card_log['actions'].tolist()}, {AL_SMALL_UPDATES} learner updates, "
          f"{card.update_counter.value} publications, target syncs at t = {card_log['syncs']}, {launches} "
          f"prefix-sample launches; largest difference against its bound {top[0]} {top[1][0]:.3g} <= "
          f"{top[1][1]:.3g}; statistics {card.get_statistics()}")
    _raise_on_failed(f"small {name}", checks)
    return {"updates": card.optim_t, "kernel_launches": launches, "syncs": card_log["syncs"],
            "largest_differences": {k: v[0] for k, v in worst.items()}, "bounds": {k: v[1] for k, v in worst.items()}}


def run_full_actor_learner(card: str) -> dict:
    """``dqn-actor-learner-ale-8`` on the card: ``train_dqn_batch_ale.py
    --actor-learner`` at the example's settings
    (``atari_dqn_batch.run_actor_learner``: the ``DQN`` shell over the
    10^6-slot ring, 8 actor threads of one ``SyntheticALE`` lane, the
    inference server, the poller and the learner, a publication every 8
    updates) through the replay start (``AL_FULL_REPLAY_START``, cut from
    50,000), until the learner's ``AL_FULL_UPDATES``-th update, with one
    ``AsyncEvaluator`` evaluation of ``AL_FULL_EVAL`` episodes (``eval_interval`` cut to
    ``AL_FULL_EVAL_INTERVAL``). The run's length, its replay start and the
    evaluation interval are its cuts. The ring is freed
    before the phase ends."""
    from pfrl_tpu_torch.experiments.profile_host import HOST_PATHS, run_actor_learner_path
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    path = HOST_PATHS["dqn-actor-learner-ale-8"]
    agent = path.make_agent(replay_start_size=AL_FULL_REPLAY_START)
    prefix_sample.launches = 0
    with tempfile.TemporaryDirectory() as outdir:  # the saved agents: 27 MB each
        record = run_actor_learner_path(agent, path.make_env, path.steps, AL_FULL_EVAL_INTERVAL,
                                        AL_FULL_EVAL, outdir, actors=path.actors, n_updates=AL_FULL_UPDATES,
                                        profiled=AL_FULL_PROFILED)
    torch.cuda.synchronize()
    launches = prefix_sample.launches
    record["kernel_launches"] = launches
    stats, tm, prof = record["statistics"], record["timings"], record.get("profiled", {})
    rows = [line.split("\t") for line in record["scores_txt"]]
    evaluation = dict(zip(rows[0], rows[1])) if len(rows) == 2 else {}
    record["eval_mean"] = float(evaluation.get("mean", "nan"))
    updates_after = (record["learning_to_update"] or 0) - (record["learning_from_update"] or 0)
    checks = {
        "the 10^6-slot ring, 28.288 GB of frames": record["ring_slots"] == 10**6 and record["ring_bytes"] > 28.28e9,
        f"the learner's {AL_FULL_UPDATES} updates, past the replay start": record["n_updates"] == AL_FULL_UPDATES
        and record["t"] >= agent.replay_start_size,
        # 250 of 320 until PR 15 cut the run.
        f"at least {AL_FULL_PROFILED[0] * 3 // 4} timed updates after the replay start":
            updates_after >= AL_FULL_PROFILED[0] * 3 // 4,
        "a sane profiled window": prof.get("kernels_per_update") is not None and prof["kernels_per_update"] > 100,
        "a publication every 8 updates": record["publications"] == AL_FULL_UPDATES // 8,
        "loss finite": math.isfinite(stats["average_loss"]) and math.isfinite(stats["average_q"]),
        f"one evaluation of {AL_FULL_EVAL} episodes, finite": math.isfinite(record["eval_mean"]),
        "no prefix-sample launch": launches == 0,
        "a profiled window": "profiled" in record,
        "every forward at most 8 rows": 1 <= record["rows_per_forward"] <= 8,
    }
    med = lambda k, q="median_ms": tm.get(k, {}).get(q, float("nan"))  # noqa: E731
    trip = "act round trip (all)"
    print(f"dqn-actor-learner-ale-8: 8 actor threads; ring {record['ring_bytes'] / 1e9:.3f} GB; "
          f"{record['t']:,} transitions received; env-steps/s {record['env_steps_per_s_before_replay_start']:.1f} "
          f"before the replay start ({agent.replay_start_size:,}, cut), {record['env_steps_per_s_after_replay_start'] or float('nan'):.1f}"
          f" after it (updates {record['learning_from_update']} to {record['learning_to_update']}, before the "
          f"profiled window), updates/s "
          f"{record['updates_per_s_after_replay_start'] or float('nan'):.1f}; {record['rows_per_forward']:.2f} rows "
          f"per forward over {record['forwards']} forwards; act round trip median {med(trip):.3f} ms, p90 "
          f"{med(trip, 'p90_ms'):.3f} ms ({med('act round trip (before the replay start)'):.3f} ms before the replay "
          f"start; after it {med('act round trip (during an update)'):.3f} ms "
          f"with an update in flight over {tm['act round trip (during an update)'].get('n', 0)} acts, "
          f"{med('act round trip (between updates)'):.3f} ms without, over "
          f"{tm['act round trip (between updates)'].get('n', 0)}); poller add {med('poller add'):.3f} ms, learner "
          f"update {med('learner update'):.3f} ms (medians); {record['n_updates']} updates, {record['publications']} "
          f"publications, {record['target_syncs']} target syncs; over {prof.get('updates')} profiled updates "
          f"{prof.get('kernels_per_update') or float('nan'):.1f} kernels per update and {prof.get('env_steps')} env "
          f"steps (the actors' card calls wait while the profiler runs), device busy "
          f"{prof.get('device_busy_share', float('nan')) * 100:.1f}%; evaluation mean {record['eval_mean']} over 10 "
          f"episodes; loss {stats['average_loss']:.5f}; {launches} prefix-sample launches (fp32, no TF32) on {card}")
    _raise_on_failed("dqn-actor-learner-ale-8", checks)
    agent.replay_state = None
    del agent
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return record


# -------------------------------------------------------------------- phase 18
SNAPSHOT_ROOT = HERE / "pfrl_tpu_torch" / "_build" / "snapshots"  # git-ignored, inside the checkout
RESUME_CAPACITY = 131_072  # the 10^6-slot ring cut to C = 2^17: a 3.7 GB snapshot, not 28.3 GB
RESUME_REPLAY_START = 1_024  # cut from 50,000 (then 4,096)
RESUME_STEPS = (15, 3, 3)  # scan steps: warm (no update; cut from 63), with updates before the save (cut from 8), after it
#                            (A and B; cut from 8)
ZOO_OBS = 256
_KEPT = {}  # what phase 14 hands to phase 18


def _snapshot_dir(name: str) -> str:
    path = SNAPSHOT_ROOT / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def _plain(state) -> dict:
    """Every leaf of ``to_saved(state)`` by its path, tensors cloned."""
    from pfrl_tpu_torch.agent import to_saved

    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = x.detach().clone() if isinstance(x, torch.Tensor) else x

    walk(to_saved(state), "state")
    return out


def _compare(a: dict, b: dict) -> dict:
    """Leaves of two ``_plain`` trees: how many differ, the largest
    absolute difference over the floating ones, and the differing paths."""
    if list(a) != list(b):
        raise AssertionError(f"the trees differ in their leaves: {sorted(set(a) ^ set(b))[:8]}")
    differ, worst = [], 0.0
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            y = y.to(x.device)
            if not (x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)):
                differ.append(k)
                if x.is_floating_point() and x.shape == y.shape:
                    worst = max(worst, float((x.double() - y.double()).abs().max()))
        elif x != y:
            differ.append(k)
    return {"leaves": len(a), "tensors": sum(isinstance(v, torch.Tensor) for v in a.values()),
            "differing": len(differ), "max_abs_diff": worst, "first_differing": differ[:6]}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_save_load_demo(card: str) -> dict:
    """per-dqn-ale-64 at full width: phase 14's train state ``--save-to``,
    then ``train_dqn_ale.py --sim --prioritized --load --demo`` on a fresh
    runner (its 28.3 GB ring allocated again)."""
    from pfrl_tpu_torch.experiments import atari_dqn_ale
    from pfrl_tpu_torch.experiments.demo_cli import (
        demo_returns,
        load_train_state,
        save_train_state_if_requested,
    )

    train = _KEPT.pop("per-dqn-ale-64")
    saved = _plain(train)
    directory = _snapshot_dir("per-dqn-ale-64")
    path, save_s = _timed(lambda: save_train_state_if_requested(train, directory))
    nbytes = os.path.getsize(path)
    out, cli_s = _timed(lambda: atari_dqn_ale.run_sim(["--sim", "--prioritized", "--load", directory, "--demo"]))
    loaded = _compare(_plain(out["state"].train_state), saved)
    _, load_s = _timed(lambda: load_train_state(out["state"].train_state, directory))
    want = demo_returns(out["eval_loop"], train, 0)  # the state in memory, on the demo's draws
    got = out["demo_returns"]
    ring = out["runner"].buffer.capacity
    checks = {
        "the loaded train state equals the saved one to the bit": loaded["differing"] == 0,
        "moments and n_updates came back": out["state"].train_state.n_updates == train.n_updates > 0
        and out["state"].train_state.opt_state.count == train.opt_state.count,
        "the demo's returns equal the in-memory state's": np.array_equal(got, want) and got.shape == (5,),
        "the fresh runner is full width": ring == 10**6,
    }
    result = {"file_bytes": nbytes, "save_s": save_s, "load_s": load_s, "cli_load_demo_s": cli_s,
              "n_updates": train.n_updates, "leaves_compared": loaded["leaves"], "demo_returns": got.tolist(),
              "in_memory_returns": want.tolist()}
    print(f"per-dqn-ale-64 save/load/demo: train_state.pt {nbytes:,} B ({loaded['tensors']} tensors, n_updates "
          f"{train.n_updates}), save {save_s:.3f} s, load {load_s:.3f} s, the CLI's init + load + demo on a fresh "
          f"full-width runner {cli_s:.2f} s; loaded equal to the bit: {loaded['differing'] == 0}; demo returns "
          f"{got.tolist()} (in memory {want.tolist()}) on {card}")
    _raise_on_failed("per-dqn-ale-64 save/load/demo", checks)
    del out, train
    shutil.rmtree(directory, ignore_errors=True)
    return result


def _resume_runner():
    from pfrl_tpu_torch.experiments import atari_dqn_ale

    return atari_dqn_ale.make_dqn_ale_runner("nature", prioritized=True, capacity=RESUME_CAPACITY,
                                             replay_start_size=RESUME_REPLAY_START)[0]


def _first_step_slots(runner, state) -> torch.Tensor:
    """One scan step, the slots of each of its PER samples logged (the
    prefix-sample kernel's draws, clamped to the tree)."""
    buffer, log = runner.buffer, []
    sample = buffer.sample

    def logged(*a, **kw):
        batch, st = sample(*a, **kw)
        log.append(batch.indices.clone())
        return batch, st

    buffer.sample = logged
    try:
        runner.run_chunk(state, 1)
    finally:
        del buffer.sample
    return torch.cat(log)


def check_resume(card: str) -> dict:
    """A runner snapshot through the kernel: per-dqn-ale-64's recipe at the
    cut ring; run A continues in memory after the save, run B resumes from
    the file, run U repeats A's whole run without a save: A and U are the
    card's two uninterrupted runs, and their difference its own spread. cuDNN runs its deterministic algorithms here (a
    convolution's weight gradient may otherwise sum in another order from
    run to run); the setting is restored after."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _check_resume(card)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _check_resume(card: str) -> dict:
    from pfrl_tpu_torch.agents.snapshot import load_runner_snapshot, save_runner_snapshot
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    warm, before, after = RESUME_STEPS
    directory = _snapshot_dir("resume")
    runner = _resume_runner()
    state = runner.init(0)
    runner.run_chunk(state, warm)
    runner.run_chunk(state, before)
    per_step = runner.config.updates_per_step
    assert state.train_state.n_updates == before * per_step
    saved = _plain(state)
    _, save_s = _timed(lambda: save_runner_snapshot(state, directory))
    nbytes = os.path.getsize(os.path.join(directory, "runner_state.pt"))
    prefix_sample.launches = 0
    first_a_slots = _first_step_slots(runner, state)
    runner.run_chunk(state, after - 1)
    torch.cuda.synchronize()
    launches_a = prefix_sample.launches
    after_a = _plain(state)
    del runner, state
    torch.cuda.empty_cache()

    runner_b = _resume_runner()
    template = runner_b.init(1)
    restored, load_s = _timed(lambda: load_runner_snapshot(template, directory))
    restored_vs_saved = _compare(_plain(restored), saved)
    del saved
    prefix_sample.launches = 0
    first_b_slots = _first_step_slots(runner_b, restored)
    runner_b.run_chunk(restored, after - 1)
    torch.cuda.synchronize()
    launches_b = prefix_sample.launches
    b_vs_a = _compare(_plain(restored), after_a)
    del runner_b, restored, template
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()

    runner_u = _resume_runner()
    state_u = runner_u.init(0)
    runner_u.run_chunk(state_u, warm + before + after)
    spreads = [_compare(_plain(state_u), after_a)]
    del runner_u, state_u, after_a
    torch.cuda.empty_cache()

    bitwise_repeats = all(r["differing"] == 0 for r in spreads)
    spread = max(r["max_abs_diff"] for r in spreads)
    checks = {
        "the restored state equals the saved one to the bit": restored_vs_saved["differing"] == 0,
        "the first resumed step draws the same slots": torch.equal(first_a_slots, first_b_slots)
        and first_a_slots.numel() == per_step * 32,
        f"{after} x 16 kernel launches on each side": launches_a == launches_b == after * per_step == after * 16,
        ("B equals A to the bit (the card repeats to the bit)" if bitwise_repeats else
         "B within the card's own spread"): b_vs_a["differing"] == 0 if bitwise_repeats
        else b_vs_a["max_abs_diff"] <= spread,
    }
    result = {"file_bytes": nbytes, "save_s": save_s, "load_s": load_s, "launches_a": launches_a,
              "launches_b": launches_b, "first_step_slots": int(first_a_slots.numel()),
              "restored_vs_saved": restored_vs_saved, "b_vs_a": b_vs_a, "repeats": spreads,
              "bitwise_repeats": bitwise_repeats, "capacity": RESUME_CAPACITY, "replay_start": RESUME_REPLAY_START,
              "steps": list(RESUME_STEPS)}
    spread_text = ", ".join(f"{r['differing']} leaves (max abs {r['max_abs_diff']:.3g})" for r in spreads)
    print(f"resume through the kernel (per-dqn-ale-64's recipe, ring cut to {RESUME_CAPACITY:,} slots, C = 2^17, "
          f"replay start cut to {RESUME_REPLAY_START:,}; cuDNN deterministic): snapshot {nbytes / 1e9:.3f} GB, save "
          f"{save_s:.2f} s, load {load_s:.2f} s; restored vs saved: {restored_vs_saved['differing']} of "
          f"{restored_vs_saved['leaves']} leaves differ; first resumed step's {first_a_slots.numel()} slots equal: "
          f"{torch.equal(first_a_slots, first_b_slots)}; B vs A: {b_vs_a['differing']} leaves differ, max abs "
          f"{b_vs_a['max_abs_diff']:.3g} ({b_vs_a['first_differing'][:3]}); the card's repeat (U vs A) differs in "
          f"{spread_text}; launches A {launches_a}, B {launches_b} on {card}")
    _raise_on_failed("resume", checks)
    return result


def check_persistent_buffer(card: str, device) -> dict:
    """``PersistentReplayBuffer`` with the recipe's ring at the cut size:
    64 adds of 64 lanes, a snapshot at the 64th, restored into a new
    buffer."""
    from pfrl_tpu_torch.replay import PersistentReplayBuffer, Transition

    directory = _snapshot_dir("persistent")
    kw = dict(num_lanes=64, store_next_obs=False, fused_dequant_scale=1.0 / 255.0, gamma=0.99, device=device)
    buf = PersistentReplayBuffer(directory, RESUME_CAPACITY, snapshot_interval=64, **kw)
    gen = torch.Generator(device=device).manual_seed(18)

    def transition():
        frames = torch.randint(0, 256, (64, 84, 84, 4), generator=gen, device=device, dtype=torch.uint8)
        return Transition(obs=frames, action=torch.randint(0, 6, (64,), generator=gen, device=device,
                                                           dtype=torch.int32),
                          reward=torch.rand(64, generator=gen, device=device), next_obs=frames,
                          terminated=torch.rand(64, generator=gen, device=device) < 0.01,
                          done=torch.rand(64, generator=gen, device=device) < 0.02)

    first = transition()
    example = Transition(**{k: getattr(first, k)[0] for k in ("obs", "action", "reward", "next_obs",
                                                               "terminated", "done")})
    state = buf.init(example)
    for i in range(63):
        buf.add(state, first if i == 0 else transition())
    _, save_s = _timed(lambda: buf.add(state, transition()))  # the 64th add writes the snapshot
    path = os.path.join(directory, "replay_state.pt")
    nbytes = os.path.getsize(path)
    buf2 = PersistentReplayBuffer(directory, RESUME_CAPACITY, snapshot_interval=64, **kw)
    restored, load_s = _timed(lambda: buf2.restore(example))
    same = _compare(_plain(restored), _plain(state))
    checks = {"restored equal to the bit": same["differing"] == 0 and int(restored.cursor) == 64 * 64}
    print(f"PersistentReplayBuffer ({RESUME_CAPACITY:,} slots): snapshot {nbytes / 1e9:.3f} GB written by the "
          f"64th add in {save_s:.2f} s, restored in {load_s:.2f} s, {same['differing']} of {same['leaves']} leaves "
          f"differ on {card}")
    _raise_on_failed("persistent buffer", checks)
    del buf, buf2, state, restored
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"file_bytes": nbytes, "save_s": save_s, "load_s": load_s, "compared": same}


ZOO_TIE = 1e-3         # discrete: rows whose best two CPU scores lie closer are ties
ZOO_ATOL = {"acer_continuous/abc": 1e-6}  # continuous: the zoo tests' tolerance, 1e-5 elsewhere
ZOO_BF16 = 2.0**-5     # bf16 entries: 4 bf16 ulps at 1 (relative, for scores; absolute, for actions)


def _nudged(state, factor: float):
    """``state`` with every floating parameter and tensor field scaled by
    ``factor``, in place."""
    with torch.no_grad():
        for f in dataclasses.fields(state):
            value = getattr(state, f.name)
            tensors = value.parameters() if isinstance(value, torch.nn.Module) else [value]
            for t in tensors:
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    t.mul_(factor)
    return state


def check_zoo(card: str, device) -> dict:
    """The 26 ``zoo/`` checkpoints read by the port's reader and converted
    onto the card, against the CPU's; then ``--demo`` of four on both."""
    from pfrl_tpu_torch.experiments import zoo
    from pfrl_tpu_torch.experiments.demo_cli import demo_returns

    root = str(HERE / "zoo")
    rows = {}
    t0 = time.perf_counter()
    for name, entry in zoo.ENTRIES.items():
        (core_c, state_c), load_s = _timed(lambda: zoo.load(name, device=device, root=root))
        core_p, state_p = zoo.load(name, device="cpu", root=root)
        obs = zoo.observations(name, ZOO_OBS, 26)
        got = zoo.greedy_actions(core_c, state_c, torch.from_numpy(obs).to(device), SeededDraws(3, device)).cpu()
        want = zoo.greedy_actions(core_p, state_p, torch.from_numpy(obs), SeededDraws(3, "cpu"))
        row = {"load_s": load_s}
        if entry.discrete:
            scores = zoo.action_scores(core_p, state_p, torch.from_numpy(obs), SeededDraws(3, "cpu")).float()
            top2 = torch.topk(scores, 2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            tie = torch.clamp_min(ZOO_BF16 * top2[:, 0].abs(), ZOO_TIE) if entry.bf16 else ZOO_TIE
            away = margin > tie
            row.update(away=int(away.sum()), differ_away=int((got[away] != want[away]).sum()),
                       differ_all=int((got != want).sum()))
            row["ok"] = row["differ_away"] == 0 and row["away"] >= ZOO_OBS // 2
        else:
            # The larger of the zoo tests' tolerance and 4x what 1 +- 2^-23
            # nudges of the CPU's weights move its actions, as phases 3-17
            # hold card-vs-CPU runs.
            moved = 0.0
            for factor in ACER_NUDGES:
                core_n, state_n = zoo.load(name, device="cpu", root=root)
                nudged = zoo.greedy_actions(core_n, _nudged(state_n, factor), torch.from_numpy(obs),
                                            SeededDraws(3, "cpu"))
                moved = max(moved, float((nudged - want).abs().max()))
            atol = ZOO_BF16 if entry.bf16 else max(ZOO_ATOL.get(name, 1e-5), 4 * moved)
            row.update(max_abs_diff=float((got - want).abs().max()), atol=atol, nudge_moves=moved)
            row["ok"] = row["max_abs_diff"] <= atol and bool(torch.isfinite(got).all())
        rows[name] = row
    zoo_s = time.perf_counter() - t0
    demos = {}
    for name, entry in zoo.ENTRIES.items():
        if entry.eval_loop is None:
            continue
        core_c, state_c = zoo.load(name, device=device, root=root)
        core_p, state_p = zoo.load(name, device="cpu", root=root)
        got = demo_returns(entry.eval_loop(core_c, device), state_c, draws=SeededDraws(11, device))
        want = demo_returns(entry.eval_loop(core_p, "cpu"), state_p, draws=SeededDraws(11, "cpu"))
        lane_by_lane = name in ("dqn/cartpole", "drqn/po_abc")
        if lane_by_lane:
            ok = np.array_equal(got, want) and (name != "dqn/cartpole" or got.mean() >= 300.0)
        else:
            ok = abs(float(got.mean()) - float(want.mean())) <= 0.01 and np.allclose(got, want, rtol=1e-4, atol=0.01)
        demos[name] = {"card_mean": float(got.mean()), "cpu_mean": float(want.mean()), "ok": bool(ok),
                       "largest_lane_diff": float(np.abs(got - want).max())}
        print(f"zoo demo {name}: n_episodes: {len(got)} mean: {got.mean():.1f} median: {np.median(got):.1f} stdev: "
              f"{got.std():.1f} (card); CPU mean {want.mean():.3f}, card mean {got.mean():.3f}, largest lane "
              f"difference {demos[name]['largest_lane_diff']:.4g}")
    bad = [n for n, r in rows.items() if not r["ok"]] + [f"demo {n}" for n, d in demos.items() if not d["ok"]]
    worst = max((r.get("max_abs_diff", 0.0) for r in rows.values()), default=0.0)
    continuous = ", ".join(f"{n} {r['max_abs_diff']:.3g} (atol {r['atol']:.3g})" for n, r in rows.items()
                           if "atol" in r)
    print(f"zoo on the card: {len(rows)} checkpoints read without JAX and converted in {zoo_s:.2f} s with their "
          f"CPU twins; discrete: {sum(r.get('differ_away', 0) for r in rows.values())} actions differ away from "
          f"ties ({sum(r.get('differ_all', 0) for r in rows.values())} in all); continuous: largest difference "
          f"{worst:.3g} ({continuous}); failed: {bad or 'none'} on {card}")
    _raise_on_failed("zoo", {f"{n} on the card": False for n in bad})
    return {"entries": rows, "demos": demos, "seconds": zoo_s}


def check_pipeline_reload(card: str) -> dict:
    """Phase 14's pipeline checkpoint loaded into a fresh (unstarted)
    pipeline: the act path's greedy actions on 256 frames equal the saved
    pipeline's."""
    from pfrl_tpu_torch.experiments.atari_pipeline import make_dqn_pipeline

    directory, frames, want, n_updates = _KEPT.pop("dqn-pipeline-288")
    fresh = make_dqn_pipeline(seed=1)
    _, load_s = _timed(lambda: fresh.load(directory))
    got = fresh.greedy_actions(frames)
    nbytes = os.path.getsize(os.path.join(directory, "train_state.pt"))
    checks = {"the act servers' greedy actions equal the saved pipeline's": np.array_equal(got, want),
              "n_updates came back": fresh.train_state.n_updates == n_updates > 0}
    print(f"dqn-pipeline-288 reload: train_state.pt {nbytes:,} B loaded into a fresh pipeline in {load_s:.3f} s "
          f"(n_updates {n_updates}); greedy actions on 256 frames equal the saved pipeline's: "
          f"{np.array_equal(got, want)} on {card}")
    _raise_on_failed("pipeline reload", checks)
    del fresh
    shutil.rmtree(directory, ignore_errors=True)
    return {"file_bytes": nbytes, "load_s": load_s, "n_updates": n_updates}


def run_persistence(card: str, device) -> dict:
    try:
        return {
            "save_load_demo": check_save_load_demo(card),
            "resume": check_resume(card),
            "persistent_buffer": check_persistent_buffer(card, device),
            "zoo": check_zoo(card, device),
            "pipeline_reload": check_pipeline_reload(card),
        }
    finally:
        shutil.rmtree(SNAPSHOT_ROOT, ignore_errors=True)


# -------------------------------------------------------------------- phase 19
# grasping-dqn-batch-1: the ring is cut from the script's 10^6 slots to
# 400,000 (obs and next_obs images of 84,992 B each: 10^6 slots would take
# 170 GB, 400,000 take 68.0 GB of the 80 GB card; the PER tree's C = 2^19),
# or to 262,144 (44.6 GB, C = 2^18) where the free memory after the earlier
# phases forbids it; the replay start from 5 x 10^4 to 256 for the time
# limit (a batch step before it takes 7-13 ms, most of it the PER add over
# the 19-level trees). 256 updates past it (one per transition), then one
# evaluation of 20 of the script's 100 episodes.
GRASPING_CAPACITY = 400_000
GRASPING_FALLBACK_CAPACITY = 262_144
GRASPING_REPLAY_START = 256
GRASPING_UPDATES = 64  # cut from 256 for the time limit
GRASPING_EVAL = 20     # evaluation episodes (the script's 100, cut for the time limit)
GRASPING_PROFILED = (GRASPING_REPLAY_START, 32)  # from t, batch steps under torch.profiler
GRASPING_SLOT_BYTES = 2 * 21_248 * 4 + 2 * 4 + 4 + 4 + 1 + 1  # both images, both steps, action, reward, flags
GRASPING_MARGIN_BYTES = 4 * 2**30  # the network, its target, Adam's moments, activations, the trees
# Host paths of phase 19 -> their rings' slots (phase 16 runs the others).
PHASE_19_HOST_PATHS = {"naf-pendulum-host-32": 10**5, "c51-gym-cartpole-host-1": 10**5}


def _gym_recipes() -> dict:
    """name -> the device runner of ``train_dqn_gym.py --env`` (``experiments/dqn_gym.py``)."""
    from pfrl_tpu_torch.experiments.dqn_gym import make_dqn_gym_runner

    return {f"{label}-32": functools.partial(make_dqn_gym_runner, env)
            for label, env in (("naf-pendulum", "pendulum"), ("naf-mountaincar", "mountaincar"),
                               ("dqn-gym-cartpole", "cartpole"))}


def _small_naf_configs() -> dict:
    """name -> a 4-lane NAF runner of ``train_dqn_gym.py`` at its widths
    (FC 2 x 100): a 96-slot ring, 2 batch-16 updates per scan step from 32
    transitions, a sync at 48, episodes cut to 10 steps."""
    from pfrl_tpu_torch.envs import MountainCarContinuous, Pendulum, TimeLimit
    from pfrl_tpu_torch.experiments.dqn_gym import make_dqn_gym_runner

    small = dict(num_envs=4, capacity=96, replay_start_size=32, update_interval=2, target_update_interval=48,
                 minibatch_size=16)
    return {
        f"naf-{name}": (lambda dev, env=env: make_dqn_gym_runner(env=TimeLimit(env(device=dev), 10), **small)[0])
        for name, env in (("pendulum", Pendulum), ("mountaincar", MountainCarContinuous))
    }


def _sampled_ids_agree(leaves: torch.Tensor, targets: torch.Tensor, got: torch.Tensor, want: torch.Tensor) -> bool:
    """The kernel's leaves equal the plain version's, or differ only where
    a target lies within 1e-6 of the total from a cumulative boundary
    (float64 as judge), as phase 2 holds real-valued priorities."""
    if torch.equal(got, want):
        return True
    cs64 = np.cumsum(leaves.double().cpu().numpy())
    total = float(cs64[-1])
    for g, w, t in zip(got.tolist(), want.tolist(), targets.tolist()):
        if g != w:
            lo, hi = sorted((g, w))
            if np.max(np.abs(cs64[lo:hi] - t)) > 1e-6 * total:
                return False
    return True


def _small_phase19_shells() -> dict:
    """name -> (agent(device, draws), env(device, seed), driver, example
    observation or width, action shape, extra checks):

    - ``host-grasping-double-dqn``: the grasping recipe's ``DoubleDQN`` at
      its widths over PER with a 2^14-slot ring (the prefix-sample kernel
      once per update on the card, each call's ids held against the plain
      version on the same tree), ``(image, steps)`` observations of one
      ``SyntheticGraspingEnv`` lane through the batch driver: replay start
      64, 31 updates to t = 94, a sync at 80; the ring rows of both leaves
      of ``obs`` and ``next_obs`` equal the CPU's;
    - ``host-naf-pendulum``: ``train_dqn_gym.py``'s NAF shell (FC 2 x 100)
      on the 50-step Pendulum stepped on the CPU for the card's agent too,
      behind ``HostTorchEnv``, cast and normalized as the script wraps it,
      201 updates from 100 (C.2: stepped on the card, CUDA's ``sin``/``cos``
      moved a first moment 13x past the nudges over 201 updates; stepped on
      the CPU, within 1.2x);
    - ``host-c51-cartpole``: ``train_categorical_dqn_gym.py``'s shell (51
      atoms on [0, 500], FC 2 x 100) on CartPole cut at 50 steps, 61
      updates."""
    from pfrl_tpu_torch import spaces
    from pfrl_tpu_torch.envs import CartPole, HostTorchEnv, Pendulum, SerialVectorEnv, TimeLimit
    from pfrl_tpu_torch.envs.synthetic_grasping import SyntheticGraspingEnv
    from pfrl_tpu_torch.experiments import train_agent_batch_with_evaluation, train_agent_with_evaluation
    from pfrl_tpu_torch.experiments.categorical_dqn_gym import make_c51_agent
    from pfrl_tpu_torch.experiments.dqn_gym import make_agent, wrapped_env
    from pfrl_tpu_torch.experiments.grasping_dqn_batch import make_grasping_agent
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample_reference
    from pfrl_tpu_torch.utils.batch_states import leaves
    from pfrl_tpu_torch.wrappers import CastObservationToFloat32

    def grasping_agent(dev, draws):
        agent = make_grasping_agent(capacity=2**14, replay_start_size=64, final_exploration_steps=80,
                                    target_update_interval=80, device=dev, draws=draws)
        agent.kernel_vs_plain = []
        if torch.device(dev).type == "cuda":
            buffer, find = agent.buffer, agent.buffer._find_slots

            def checked(tree, targets):
                got = find(tree, targets)
                cap = buffer.tree_capacity
                want = torch.clamp_max(prefix_sample_reference(tree[cap:], targets), cap - 1)
                agent.kernel_vs_plain.append(_sampled_ids_agree(tree[cap:], targets, got, want))
                return got

            buffer._find_slots = checked
        return agent

    def grasping_checks(card, cpu):
        rings = [a.replay_state.base.storage for a in (card, cpu)]
        pairs = [(a.cpu(), b) for k in ("obs", "next_obs") for a, b in zip(leaves(rings[0][k]), leaves(rings[1][k]))]
        return {
            "the ring rows of both leaves equal the CPU's": len(pairs) == 4
            and all(torch.equal(a, b) for a, b in pairs),
            "the ring's leaves: float32 images of 21,248, int32 steps": [
                (tuple(x.shape[1:]), x.dtype) for x in leaves(rings[1]["obs"])] == [
                ((21_248,), torch.float32), ((), torch.int32)],
            "each sample's ids equal the plain version's": len(card.kernel_vs_plain) == card.optim_t > 0
            and all(card.kernel_vs_plain),
            "a 2^14-leaf tree": card.buffer.tree_capacity == 2**14,
        }

    def grasping_example(dev):
        return (torch.zeros((1, 84, 84, 3), device=dev), torch.zeros((1,), dtype=torch.int32, device=dev))

    def pendulum(dev, seed):
        return wrapped_env(lambda s: HostTorchEnv(TimeLimit(Pendulum(device=dev), 50), draws=SeededDraws(s, dev)),
                           seed)

    def cartpole(dev, seed):
        return CastObservationToFloat32(HostTorchEnv(TimeLimit(CartPole(device=dev), 500),
                                                     draws=SeededDraws(seed, dev)))

    serial = functools.partial(train_agent_with_evaluation, eval_n_steps=None, eval_n_episodes=2,
                               train_max_episode_len=50)
    small = dict(replay_start_size=100, minibatch_size=32, target_update_interval=100)
    return {
        "host-grasping-double-dqn": (
            grasping_agent, lambda dev, seed: SerialVectorEnv([SyntheticGraspingEnv(seed=seed)]),
            functools.partial(train_agent_batch_with_evaluation, steps=94, eval_n_steps=None, eval_n_episodes=2,
                              eval_interval=94),
            grasping_example, (), grasping_checks),
        "host-naf-pendulum": (
            lambda dev, draws: make_agent(3, spaces.box(-2.0, 2.0, (1,)), num_envs=1, buffer_size=10_000,
                                          device=dev, draws=draws, **small),
            lambda dev, seed: pendulum("cpu", seed), functools.partial(serial, steps=180, eval_interval=90), 3,
            (1,), None),
        "host-c51-cartpole": (
            lambda dev, draws: make_c51_agent(4, 2, device=dev, draws=draws, **small),
            cartpole, functools.partial(serial, steps=130, eval_interval=65), 4, (), None),
    }


def run_full_grasping(card: str) -> dict:
    """``grasping-dqn-batch-1`` on the card: ``train_dqn_batch_grasping.py
    --jax-env`` at the script's settings (``experiments/grasping_dqn_batch.py``:
    ``DoubleDQN`` over PER, ``(image, steps)`` observations, one spawned
    worker for training and one for evaluation) but the ring
    (``GRASPING_CAPACITY``, or the fallback, by the free memory) and the
    replay start (``GRASPING_REPLAY_START``), one batch step at a time
    (``profile_host.run_host_batch``) through 256 updates, then one
    evaluation of ``GRASPING_EVAL`` episodes. The kernel runs once per update at the
    tree's C. The ring is freed before the phase ends."""
    from pfrl_tpu_torch.experiments.grasping_dqn_batch import make_grasping_agent, make_vector_envs
    from pfrl_tpu_torch.experiments.profile_host import run_host_batch
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample
    from pfrl_tpu_torch.utils.batch_states import leaves

    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    need = GRASPING_CAPACITY * GRASPING_SLOT_BYTES + GRASPING_MARGIN_BYTES
    capacity = GRASPING_CAPACITY if need <= free else GRASPING_FALLBACK_CAPACITY
    why = ("" if capacity == GRASPING_CAPACITY else
           f" (cut to {capacity:,}: {GRASPING_CAPACITY:,} slots need {need / 1e9:.1f} GB with the margin)")
    print(f"grasping-dqn-batch-1: {free / 1e9:.1f} of {total / 1e9:.1f} GB free before the ring; "
          f"{capacity:,} slots{why}")
    agent = make_grasping_agent(capacity=capacity, replay_start_size=GRASPING_REPLAY_START)
    with spawned_workers_skip_this_script():
        env, eval_env = make_vector_envs(1, 0)
    steps = GRASPING_REPLAY_START + GRASPING_UPDATES - 1
    prefix_sample.launches = 0
    try:
        with tempfile.TemporaryDirectory() as outdir:  # the saved agents: 27 MB each
            record = run_host_batch(agent, env, eval_env, steps, steps, GRASPING_EVAL, outdir, profiled=GRASPING_PROFILED)
    finally:
        for e in (env, eval_env):
            if not e.closed:
                e.close()
    torch.cuda.synchronize()
    launches = prefix_sample.launches
    record["kernel_launches"] = launches
    record["free_bytes_before"] = free
    storage = agent.replay_state.base.storage
    record["leaves"] = {k: [[list(x.shape), str(x.dtype)] for x in leaves(storage[k])] for k in ("obs", "next_obs")}
    record["tree_leaves"] = agent.buffer.tree_capacity
    stats, tm = record["statistics"], record["timings"]
    checks = {
        f"the {capacity:,}-slot ring on the card": record["ring_slots"] == capacity
        and record["ring_bytes"] >= capacity * GRASPING_SLOT_BYTES,
        "a tree of 2^19 (2^18) leaves": agent.buffer.tree_capacity == (2**19 if capacity == GRASPING_CAPACITY
                                                                       else 2**18),
        "both leaves stored per field: float32 images of 21,248, int32 steps":
            all(v == [[[capacity, 21_248], "torch.float32"], [[capacity], "torch.int32"]]
                for v in record["leaves"].values()),
        "t and the updates as the shell's gating has them": record["t"] == steps
        and record["n_updates"] == GRASPING_UPDATES,
        f"{GRASPING_UPDATES} prefix-sample launches, one per update": launches == record["n_updates"]
        == GRASPING_UPDATES,
        "loss finite": math.isfinite(stats["average_loss"]) and math.isfinite(stats["average_q"]),
        f"one evaluation of {GRASPING_EVAL} episodes, finite": len(record["eval"]) == 1
        and math.isfinite(record["eval"][0]["mean"]),
        "every worker ended": all(p.exitcode is not None for e in (env, eval_env) for p in e.ps),
        "a profiled window": "profiled" in record,
    }
    prof = record.get("profiled", {})
    med = lambda k: tm.get(k, {}).get("median_ms", float("nan"))  # noqa: E731
    after = "ms_per_batch_step_after_replay_start"
    print(f"grasping-dqn-batch-1: 1 + 1 spawned workers up in {record['worker_startup_s']['train']:.2f} + "
          f"{record['worker_startup_s']['eval']:.2f} s; ring {record['ring_bytes']:,} B ({capacity:,} slots, "
          f"C = {agent.buffer.tree_capacity:,}); env-steps/s {record['env_steps_per_s_before_replay_start']:.1f} "
          f"before the replay start ({GRASPING_REPLAY_START:,}, cut), "
          f"{record['env_steps_per_s_after_replay_start']:.1f} after it (from t = {record['learning_from_t']:,}), "
          f"updates/s {record['updates_per_s_after_replay_start']:.1f}; median batch_act {med('batch_act'):.3f} ms, "
          f"env step (the worker's round trip) {med('env step'):.3f} ms, PER add (batch_observe) "
          f"{med('batch_observe (ring add)'):.3f} ms, update {med('update'):.3f} ms; past the profiled window "
          f"{record['batch_step_ms_after_replay_start']:.3f} ms per batch step, of which "
          f"{', '.join(f'{k} {v[after]:.3f}' for k, v in tm.items() if v.get(after) is not None)}; "
          f"{record['n_updates']} updates; over {prof.get('batch_steps')} profiled batch steps "
          f"{prof.get('kernels_per_update') or float('nan'):.1f} kernels per update, device busy "
          f"{prof.get('device_busy_share', float('nan')) * 100:.1f}%; evaluation mean "
          f"{record['eval'][0]['mean'] if record['eval'] else float('nan')} over {GRASPING_EVAL} episodes; loss "
          f"{stats['average_loss']:.5f}; {launches} prefix-sample launches (fp32, no TF32) on {card}")
    _raise_on_failed("grasping-dqn-batch-1", checks)
    agent.replay_state = None
    del agent
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return record


# -------------------------------------------------------------------- phase 20
# iqn-atarisim-64: the replay start cut from the script's 50,000 to 9,216, so
# that the first 16 updates run on scan step 144; then 16 timed scan steps
# (through the target sync at 10,000, on step 157) and 2 profiled: 304 updates.
# Both moved for the time limit (were 9,216 and the script's 10^4, 144 warm
# steps): the first updates on scan step 32, the sync at 3,000 on step 47.
IQN_ATARI_REPLAY_START = 2_048
IQN_ATARI_SYNC = 3_000
IQN_ATARI_STEPS = (32, 16, 2)          # warm (its last one updates), timed, profiled
PPO_DEVICE_ITERATIONS = (1, 1)         # ppo-pendulum-device-64: timed, profiled (8,192 transitions each)
MULTIHOST_REPLAY_START = 400           # cut from 50,000 (then 2,000)
MULTIHOST_CHUNK = 100                  # one chunk of 100 scan steps (the example's 500), 102 updates
MULTIHOST_PROFILED = 2                 # scan steps under torch.profiler after the chunk
# Host paths of phase 20 -> their rings' slots (None: on-policy). Cut for the
# time limit: PPO to t = 2,304 (its update at 2,048, then 32 batch steps;
# HOST_PATHS' 6,144), SAC's replay start and burn-in from 10,000 to 1,000 and
# t = 1,200 (204 updates, 4 lanes of the script's spawned workers), the
# quickstart host loop to t = 800 (301 updates, three hard syncs).
PHASE_20_HOST_PATHS = {"ppo-pendulum-host-8": None, "sac-atlas-pendulum-host-4": 10**6,
                       "quickstart-dqn-cartpole-host-1": 10**4}
SPAWNED_HOST_PATHS = ("sac-atlas-pendulum-host-4",)  # through MultiprocessVectorEnv, the script's default
HOST_PATH_STEPS.update({"ppo-pendulum-host-8": 2_304, "sac-atlas-pendulum-host-4": 640,
                        "quickstart-dqn-cartpole-host-1": 800})
# sac-atlas-pendulum-host-4: replay start and t cut further, from 1,000 and 1,200, to 512 and 640.
HOST_PATH_REPLAY_START["sac-atlas-pendulum-host-4"] = 512
HOST_PATH_PROFILED["sac-atlas-pendulum-host-4"] = (512, 8)


def _phase20_recipes() -> dict:
    """name -> the quickstart's device runner at its settings (``run_device``
    of 100,000 steps), for :func:`run_full_cartpole`."""
    from pfrl_tpu_torch.experiments.quickstart import make_device_runner

    return {"quickstart-dqn-cartpole-32": make_device_runner}


def _small_phase20_configs() -> dict:
    """The small card-vs-CPU runs of phase 20, name -> ``check(device)``:

    - ``iqn-atarisim``: ``train_iqn.py --sim``'s recipe at its widths
      (Nature CNN, N = N' = 64, K = 32) over 4 lanes, a 48-slot ring that
      wraps, batch 8, replay start 32, a sync at 48, 17 scan steps (10
      updates), in float32 ulps against the nudges (``check_small_example_slice``);
    - ``quickstart-dqn-cartpole``: the quickstart's device runner at its
      widths over 4 lanes of the 10-step CartPole, as phase 10 holds the
      CartPole recipes (``check_small_slice``, 18 updates);
    - ``ppo-pendulum-device``: ``train_ppo.py --jax-env pendulum``'s core
      over 4 lanes x 16 steps of the 10-step Pendulum, one batch-64
      minibatch and 10 epochs per iteration, 3 iterations
      (``check_small_onpolicy``);
    - the host modes through their drivers (``check_small_shell``), each
      env stepped on the CPU for the card's agent too (ROADMAP C.1, C.2),
      episodes cut at 50 steps: ``train_ppo_pendulum.py``'s PPO shell over 8
      lanes to its first update at 2,048 (320 Adam steps), the atlas SAC
      shell over 4 lanes from a replay start of 100 to t = 132 (36
      updates), and the quickstart's host-loop DQN shell from 100 to 200
      (101 updates, a hard sync at 100) through the serial driver."""
    from pfrl_tpu_torch.envs import CartPole, HostTorchEnv, Pendulum, SerialVectorEnv, TimeLimit
    from pfrl_tpu_torch.experiments import atari_iqn, ppo_pendulum, quickstart, sac_atlas
    from pfrl_tpu_torch.experiments import train_agent_batch_with_evaluation, train_agent_with_evaluation

    def pendulum_lanes(n):
        return lambda dev, seed: SerialVectorEnv([
            HostTorchEnv(TimeLimit(Pendulum(device="cpu"), 50), draws=SeededDraws(seed + i, "cpu")) for i in range(n)])

    def cartpole(dev, seed):
        return HostTorchEnv(TimeLimit(CartPole(device="cpu"), 500), draws=SeededDraws(seed, "cpu"))

    batch = functools.partial(train_agent_batch_with_evaluation, eval_n_steps=None, eval_n_episodes=2,
                              max_episode_len=50)
    serial = functools.partial(train_agent_with_evaluation, eval_n_steps=None, eval_n_episodes=2,
                               train_max_episode_len=50)
    iqn = lambda dev: atari_iqn.make_iqn_atarisim_runner(  # noqa: E731
        device=dev, num_envs=4, capacity=48, replay_start_size=32, target_update_interval=48, minibatch_size=8,
        final_exploration_frames=100)[0]
    qs = lambda dev: quickstart.make_device_runner(  # noqa: E731
        80, device=dev, env=TimeLimit(CartPole(device=dev), 10), num_envs=4, capacity=40, replay_start_size=12,
        update_interval=2, target_update_interval=24, minibatch_size=8)[0]
    ppo = lambda dev: ppo_pendulum.make_ppo_pendulum_device_runner(  # noqa: E731
        4, 16, device=dev, env=TimeLimit(Pendulum(device=dev), 10))[0]
    shells = {
        "host-ppo-pendulum-8": (lambda dev, draws: ppo_pendulum.make_agent(device=dev, draws=draws),
                                pendulum_lanes(8), functools.partial(batch, steps=2_048, eval_interval=2_048), 3,
                                (1,)),
        "host-sac-atlas-pendulum-4": (
            lambda dev, draws: sac_atlas.make_agent(replay_start_size=100, device=dev, draws=draws),
            pendulum_lanes(4), functools.partial(batch, steps=132, eval_interval=132), 3, (1,)),
        "host-quickstart-dqn-cartpole": (
            lambda dev, draws: quickstart.make_hostloop_agent(device=dev, draws=draws, replay_start_size=100),
            cartpole, functools.partial(serial, steps=200, eval_interval=100), 4, ()),
    }
    return {
        "iqn-atarisim": lambda dev: check_small_example_slice("iqn-atarisim", iqn, 17, 0, dev),
        "quickstart-dqn-cartpole": lambda dev: check_small_slice("quickstart-dqn-cartpole", qs, 11, 0, dev, 1e-5,
                                                                 1e-6),
        "ppo-pendulum-device": lambda dev: check_small_onpolicy("ppo-pendulum-device", ppo, dev),
        **{name: functools.partial(lambda dev, name, args: check_small_shell(name, *args, dev), name=name, args=args)
           for name, args in shells.items()},
    }


def _device_profiled(fn):
    """``fn``'s result and host seconds under ``torch.profiler`` tracing the
    device only (the host's ops are not recorded: an iteration of PPO is
    437,000 kernels), its kernels and their busy microseconds."""
    from pfrl_tpu_torch.experiments.profile_host import device_kernels
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    by_name = device_kernels(prof)
    return out, seconds, sum(v[1] for v in by_name.values()), sum(v[0] for v in by_name.values())


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_state(runner, state, metrics) -> dict:
    """Every tensor of a run that a mesh must leave as it is: the learned
    tensors, the metrics, the returns ring, a prioritized ring's trees, an
    episodic buffer's tables (and its tree) and a recurrent core's carry."""
    out = {f"learned {k}": v for k, v in _learned_tensors(state.train_state).items()}
    out.update({f"metric {k}": v for k, v in metrics.items()})
    out.update(recent_returns=state.recent_returns, recent_count=state.recent_count, obs=state.obs)
    replay = getattr(state, "replay_state", None)
    if hasattr(replay, "min_tree"):
        out.update(tree=replay.tree, min_tree=replay.min_tree, beta=replay.beta, max_priority=replay.max_priority)
    if hasattr(replay, "ep_len"):
        out.update(ep_len=replay.ep_len, finished=replay.finished, lane_row=replay.lane_row,
                   n_started=replay.n_started)
        if hasattr(replay, "tree"):
            out.update(tree=replay.tree, max_priority=replay.max_priority)
    out.update({f"carry {i}": leaf for i, leaf in enumerate(_leaves(state.act_state))})
    return {k: v.detach().cpu() for k, v in out.items()}


# The small runs of the mesh check over an episodic buffer: 4 lanes of 3
# rows each (the buffer's rows split into equal blocks per lane).
MESH_CUE = dict(num_envs=4, max_episodes=12, max_episode_len=12, subseq_len=4, replay_start_size=52,
                update_interval=4, target_update_interval=32, minibatch_size=4)
MESH_SNAPSHOT_STEPS = 13  # scan steps before and after the snapshot of the mesh check


def _mesh_configs() -> dict:
    """name -> (function making a small runner on a device with a mesh or
    none, scan steps or iterations, kernel launches on each run): phase 3's
    Nature DQN over the uniform ring and over PER (4 lanes) and phase 9's
    PPO on MujocoSim (4 lanes, 3 iterations); every core of the mesh's
    later branches at the sizes of its phase's small run: DRQN on PO-ABC,
    recurrent IQN on DelayedCue (12 rows) and ACER on ABC over the
    episodic buffers, continuous ACER, IQN-CartPole, SAC and TD3 (their
    updates draw), Rainbow-CartPole (a noisy network over PER) at the
    kernel's B = 64 (a 256-slot ring, 2 updates per scan step from 64
    transitions: 18 updates, 18 launches), TRPO, recurrent PPO and TRPO."""
    from pfrl_tpu_torch.envs import CartPole, TimeLimit
    from pfrl_tpu_torch.experiments import recurrent as rec
    from pfrl_tpu_torch.experiments.profile_slice import on_mesh

    small, onpolicy, recurrent = _small_configs(), _small_onpolicy_configs(), _small_recurrent_configs()
    acer, cartpole, actor_critic = _small_acer_configs(), _small_cartpole_configs(), _small_actor_critic_configs()

    def meshed(build):
        return lambda dev, mesh: build(dev) if mesh is None else on_mesh(build(dev), mesh)

    def rainbow(dev):
        return _cartpole_recipes()["rainbow-cartpole"](
            env=TimeLimit(CartPole(device=dev), 10), num_envs=4, capacity=256, replay_start_size=64,
            update_interval=2, target_update_interval=48, minibatch_size=CARTPOLE_BATCH)[0]

    return {"dqn": (meshed(small["dqn"][0]), small["dqn"][1], 0),
            "per-dqn": (meshed(small["per-dqn"][0]), small["per-dqn"][1], small["per-dqn"][2]),
            "ppo": (meshed(onpolicy["ppo"]), 3, 0),
            "drqn-po-abc": (meshed(recurrent["drqn-po-abc"][0]), 14, 0),
            "riqn-delayedcue": (meshed(lambda dev: rec.make_riqn_delayed_cue_runner(
                hidden=16, n_taus=4, device=dev, **MESH_CUE)[0]), 26, 0),
            "acer-abc": (meshed(acer["acer-abc"][0]), 14, 0),
            "acer-continuous-abc": (meshed(acer["acer-continuous-abc"][0]), 14, 0),
            "iqn-cartpole": (meshed(cartpole["iqn-cartpole"][0]), 11, 0),
            "sac": (meshed(actor_critic["sac"]), 30, 0),
            "td3": (meshed(actor_critic["td3"]), 30, 0),
            "rainbow-cartpole": (meshed(rainbow), 24, 18),
            "trpo": (meshed(onpolicy["trpo"]), 3, 0),
            "rppo-delayedcue": (meshed(recurrent["rppo-delayedcue"][0]), 3, 0),
            "rtrpo-delayedcue": (meshed(recurrent["rtrpo-delayedcue"][0]), 3, 0)}


def _mesh_snapshot(device, mesh) -> dict:
    """DRQN on DelayedCue over the sharded episodic buffer on the mesh, from
    a seeded generator on the card: 26 scan steps uninterrupted, and 13, a
    runner snapshot, a fresh runner built from other seeds loading it, 13
    more; the names of the tensors that differ."""
    from pfrl_tpu_torch.agents.snapshot import load_runner_snapshot, save_runner_snapshot
    from pfrl_tpu_torch.experiments import recurrent as rec
    from pfrl_tpu_torch.experiments.profile_slice import on_mesh
    from pfrl_tpu_torch.utils.draws import Draws

    def fresh(seed):
        runner = on_mesh(rec.make_drqn_delayed_cue_runner(hidden=16, device=device, **MESH_CUE)[0], mesh)
        return runner, runner.init(seed, draws=Draws(torch.Generator(device=device).manual_seed(seed)))

    runner, state = fresh(0)
    state, metrics = runner.run_chunk(state, 2 * MESH_SNAPSHOT_STEPS)
    whole = _run_state(runner, state, {k: v[MESH_SNAPSHOT_STEPS:] for k, v in metrics.items()})
    runner, state = fresh(0)
    state, _ = runner.run_chunk(state, MESH_SNAPSHOT_STEPS)
    tmp = tempfile.mkdtemp()
    try:
        save_runner_snapshot(state, tmp, mesh)
        runner, template = fresh(1)
        state = load_runner_snapshot(template, tmp, mesh)
        files = sorted(os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state, metrics = runner.run_chunk(state, MESH_SNAPSHOT_STEPS)
    resumed = _run_state(runner, state, metrics)
    unequal = [k for k in whole if not torch.equal(whole[k], resumed[k])]
    return {"tensors": len(whole), "unequal": unequal, "files": files,
            "n_updates": state.train_state.n_updates}


def _gloo_rank(rank: int, port: int, out_path: str) -> None:
    """One of two Gloo ranks on the CPU (a spawned process: it never
    touches the card): DQN and IQN on CartPole over the uniform ring at 4
    lanes split 2 + 2 (IQN's taus drawn per row in the update), and DRQN
    on DelayedCue over the episodic buffer with stored carries (12 rows,
    each rank keeping its lanes' 6); saves every learned tensor and the
    episodic buffer's tables."""
    from pfrl_tpu_torch.envs import CartPole, TimeLimit
    from pfrl_tpu_torch.experiments import recurrent as rec
    from pfrl_tpu_torch.experiments.cartpole_value import make_dqn_cartpole_runner, make_iqn_cartpole_runner
    from pfrl_tpu_torch.experiments.profile_slice import on_mesh
    from pfrl_tpu_torch.parallel.mesh import make_mesh
    from pfrl_tpu_torch.parallel.multihost import initialize_multihost
    from pfrl_tpu_torch.parallel.multihost import shutdown

    torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", 2, rank, device="cpu", timeout_s=120)
    try:
        mesh = make_mesh(("dp",))
        small = dict(device="cpu", num_envs=4, capacity=40, replay_start_size=12, update_interval=2,
                     target_update_interval=24, minibatch_size=8)
        runs = {
            "dqn": (make_dqn_cartpole_runner(env=TimeLimit(CartPole(device="cpu"), 10), **small)[0], 11),
            "iqn": (make_iqn_cartpole_runner(env=TimeLimit(CartPole(device="cpu"), 10), hidden=16, feature_size=8,
                                             n_taus=8, decay_steps=40, **small)[0], 11),
            "drqn": (rec.make_drqn_delayed_cue_runner(hidden=16, device="cpu", **MESH_CUE)[0], 26),
        }
        out = {}
        for name, (plain, steps) in runs.items():
            runner = on_mesh(plain, mesh)
            state = runner.init(0, draws=SeededDraws(0, "cpu"))
            state, _ = runner.run_chunk(state, steps)
            out.update({f"{name} {k}": v for k, v in _learned_tensors(state.train_state).items()})
            out[f"{name} updates"] = torch.tensor([state.train_state.n_updates])
        replay = state.replay_state
        out.update({f"drqn {k}": getattr(replay, k) for k in ("ep_len", "finished", "lane_row", "n_started")})
        out["updates"] = torch.tensor([out[f"{name} updates"].item() for name in runs])
        torch.save(out, out_path)
    finally:
        shutdown()


def check_mesh_on_card(card: str, device) -> dict:
    """The mesh on the card and across two CPU ranks.

    (1) A mesh of one rank over NCCL on the card: each configuration of
    :func:`_mesh_configs` runs without a mesh and with one, from the same
    weights and draws, with cuDNN's deterministic algorithms (two runs of
    the Nature CNN without a mesh differ otherwise), and every
    learned tensor, metric, the returns ring, a prioritized ring's
    trees and beta, an episodic buffer's tables and a recurrent core's
    carry must be **equal to the bit**,
    the prefix-sample kernel launched as often on both runs (once per
    update over PER); then a runner snapshot saved and resumed on the
    mesh (:func:`_mesh_snapshot`) must equal the uninterrupted run to the
    bit. (2) Two Gloo ranks on the card's host CPU
    (:func:`_gloo_rank`, spawned before (1) and joined after it, each
    under a 300 s timeout): their learned tensors equal to the bit."""
    import multiprocessing as mp

    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample
    from pfrl_tpu_torch.parallel.mesh import make_mesh
    from pfrl_tpu_torch.parallel.multihost import initialize_multihost
    from pfrl_tpu_torch.parallel.multihost import shutdown

    record, checks = {}, {}
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    paths = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, paths[r])) for r in range(2)]
    for p in procs:  # the two CPU ranks run while the card runs the NCCL checks
        p.start()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # else cuDNN's wgrad differs between two runs without a mesh
    initialize_multihost(f"localhost:{_free_port()}", 1, 0)  # NCCL on the card
    try:
        mesh = make_mesh(("dp",))
        for name, (make, steps, launches) in _mesh_configs().items():
            runs = {}
            for label, m in (("no mesh", None), ("mesh", mesh)):
                runner = make(device, m)
                state = runner.init(0, draws=SeededDraws(0, device))
                before = prefix_sample.launches
                if hasattr(runner, "run_iterations"):
                    state, metrics = runner.run_iterations(state, steps)
                else:
                    state, metrics = runner.run_chunk(state, steps)
                torch.cuda.synchronize()
                runs[label] = (_run_state(runner, state, metrics), prefix_sample.launches - before)
            (plain, plain_launches), (meshed, mesh_launches) = runs["no mesh"], runs["mesh"]
            unequal = [k for k in plain if not torch.equal(plain[k], meshed[k])]
            checks[f"{name}: a mesh of one NCCL rank equals no mesh to the bit"] = not unequal and plain.keys() == meshed.keys()
            checks[f"{name}: {launches} prefix-sample launches on each run"] = plain_launches == mesh_launches == launches
            record[name] = {"tensors": len(plain), "unequal": unequal, "launches": [plain_launches, mesh_launches]}
            print(f"mesh {name}: one NCCL rank on the card against no mesh, {len(plain)} tensors, "
                  f"{len(unequal)} unequal {unequal[:4]}; prefix-sample launches {plain_launches} and {mesh_launches}")
        snap = record["snapshot"] = _mesh_snapshot(device, mesh)
        checks["a runner snapshot resumed on the mesh equals the uninterrupted run to the bit"] = (
            not snap["unequal"] and snap["files"] == ["runner_state.rank0.pt"])
        print(f"mesh snapshot: DRQN-DelayedCue on one NCCL rank resumed after {MESH_SNAPSHOT_STEPS} scan steps "
              f"against the uninterrupted run, {snap['tensors']} tensors, {len(snap['unequal'])} unequal "
              f"{snap['unequal'][:4]}; files {snap['files']}")
    finally:
        shutdown()
        torch.backends.cudnn.deterministic = deterministic
    record["nccl_s"] = time.perf_counter() - t0
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    ranks = [torch.load(path, weights_only=False) for path in paths if os.path.exists(path)]
    shutil.rmtree(tmp, ignore_errors=True)
    ok = codes == [0, 0] and len(ranks) == 2
    unequal = [k for k in ranks[0] if not torch.equal(ranks[0][k], ranks[1][k])] if ok else ["(a rank failed)"]
    checks["two Gloo ranks exit 0"] = codes == [0, 0]
    checks["two Gloo ranks: every learned tensor equal to the bit"] = ok and not unequal
    record["gloo"] = {"exit_codes": codes, "tensors": len(ranks[0]) if ranks else 0, "unequal": unequal,
                      "updates": ranks[0]["updates"].tolist() if ranks else None,
                      "seconds": time.perf_counter() - t0}
    print(f"mesh: two Gloo ranks on the host CPU exited {codes}; {record['gloo']['tensors']} tensors, "
          f"{len(unequal)} unequal; updates {record['gloo']['updates']}; done {record['gloo']['seconds']:.1f} s "
          f"after they started, beside the NCCL checks' {record['nccl_s']:.1f} s on {card}")
    record["kernel_launches"] = sum(sum(record[name]["launches"]) for name in ("per-dqn", "rainbow-cartpole"))
    _raise_on_failed("mesh", checks)
    return record


def run_full_iqn_atari(card: str) -> dict:
    """``iqn-atarisim-64`` on the card: ``train_iqn.py --sim`` at its widths
    and settings (64 lanes, the 10^5-slot ring, 2.83 GB, its bytes printed)
    but the replay start (``IQN_ATARI_REPLAY_START``): 144 scan steps
    through it, 16 timed scan steps of 16 updates through the target sync
    at 10,000 (the target then equal to the online net), 2 profiled; then
    ``EvalLoop`` 5 x 500. No prefix-sample launch."""
    from pfrl_tpu_torch.experiments.atari_iqn import make_iqn_atarisim_runner
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner, evaluator = make_iqn_atarisim_runner(replay_start_size=IQN_ATARI_REPLAY_START,
                                                 target_update_interval=IQN_ATARI_SYNC)
    cfg, buf = runner.config, runner.buffer
    warm_steps, timed_steps, profiled_steps = IQN_ATARI_STEPS
    state = runner.init(0)
    nbytes = _ring_bytes(buf, state.replay_state)
    train = state.train_state
    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, warm = runner.run_chunk(state, warm_steps)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sync_step = cfg.target_update_interval // cfg.num_envs + 1  # the scan step whose t crosses 10,000
    t1 = time.perf_counter()
    state, timed_a = runner.run_chunk(state, sync_step - warm_steps)
    torch.cuda.synchronize()
    synced = all(torch.equal(a, b) for a, b in zip(train.model.parameters(), train.target_model.parameters()))
    state, timed_b = runner.run_chunk(state, warm_steps + timed_steps - sync_step)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t1
    (state, _), profiled_s, kernels, busy_us = _device_profiled(lambda: runner.run_chunk(state, profiled_steps))
    launches = prefix_sample.launches
    steps = warm_steps + timed_steps + profiled_steps
    updates = _updates_in(cfg, 1, steps)
    t2 = time.perf_counter()
    returns = evaluator.evaluate(train, state.draws)
    eval_s = time.perf_counter() - t2
    loss = torch.cat([warm["loss"], timed_a["loss"], timed_b["loss"]])
    checks = {
        "the ring holds 10^5 frame stacks": buf.capacity == 99_968 and nbytes["frames"] >= 99_968 * 28_288,
        "the first updates on the last warm step": _updates_in(cfg, 1, warm_steps) == cfg.updates_per_step,
        "at least 256 updates": train.n_updates == updates >= 256,
        "the target equals the online net right after the sync": synced,
        "losses finite, positive once updates run": bool(torch.isfinite(loss).all()) and bool((loss[warm_steps - 1:] > 0).all()),
        "no prefix-sample launch": launches == 0,
        "evaluation returns finite": bool(np.isfinite(returns).all()) and returns.shape == (5,),
    }
    result = {
        "steps": steps, "t": state.t, "n_updates": updates, "kernel_launches": launches, "ring_bytes": nbytes,
        "acting_env_steps_per_s": warm_steps * cfg.num_envs / warm_s,
        "env_steps_per_s": timed_steps * cfg.num_envs / timed_s,
        "updates_per_s": timed_steps * cfg.updates_per_step / timed_s,
        "scan_step_ms": timed_s / timed_steps * 1e3,
        "profiled_scan_step_ms": profiled_s / profiled_steps * 1e3,
        "device_launches_per_step": kernels / profiled_steps,
        "device_busy_ms_per_step": busy_us / profiled_steps / 1e3,
        "device_busy_share": busy_us / 1e6 / profiled_s,
        "warm_chunk_s": warm_s, "timed_chunk_s": timed_s, "eval_s": eval_s,
        "eval_returns": [float(r) for r in returns], "last_loss": float(loss[-1]),
    }
    print(f"iqn-atarisim-64: ring {nbytes['frames'] / 1e9:.2f} GB of frames; env-steps/s {result['env_steps_per_s']:.1f} "
          f"updates/s {result['updates_per_s']:.1f} over {timed_steps} scan steps of 16 updates "
          f"({result['scan_step_ms']:.2f} ms each) through the sync at 10,000; before the replay start "
          f"({cfg.replay_start_size:,}, cut) {result['acting_env_steps_per_s']:.1f} env-steps/s; over "
          f"{profiled_steps} profiled scan steps of {result['profiled_scan_step_ms']:.2f} ms, device busy "
          f"{result['device_busy_ms_per_step']:.2f} ms per scan step ({result['device_busy_share'] * 100:.1f}%), "
          f"{result['device_launches_per_step']:.1f} kernels per scan step; {updates} updates; evaluation "
          f"{eval_s:.2f} s; last loss {result['last_loss']:.5f} (fp32, no TF32) on {card}")
    _raise_on_failed("iqn-atarisim-64", checks)
    state.replay_state = None
    return result


def run_full_ppo_pendulum_device(card: str) -> dict:
    """``ppo-pendulum-device-64`` on the card: ``train_ppo.py --jax-env
    pendulum`` at its settings (64 lanes x 128 steps, 1,280 Adam steps per
    iteration), one timed iteration, then one whose collect and first of
    ten epochs run under the profiler (an iteration is 437,000 kernels: the
    profile of a tenth of its update is enough, and takes a tenth of the
    time to read), then ``EvalLoop`` 10 x 200. No prefix-sample launch."""
    from pfrl_tpu_torch.experiments.profile_host import device_kernels
    from pfrl_tpu_torch.experiments.ppo_pendulum import make_ppo_pendulum_device_runner
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample
    from torch.profiler import ProfilerActivity, profile

    runner, evaluator = make_ppo_pendulum_device_runner()
    timed_iters, profiled_iters = PPO_DEVICE_ITERATIONS
    state = runner.init(0)
    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, aux = runner.run_iterations(state, timed_iters)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    per_iter = runner.rollout_len * runner.num_envs
    epoch_steps = per_iter // runner.core.minibatch_size
    prof, window, optimizer = profile(activities=[ProfilerActivity.CUDA]), {"steps": 0}, runner.core.optimizer
    step = optimizer.update

    def counted(*args):  # stops the profiler after the first epoch's last Adam step
        out = step(*args)
        window["steps"] += 1
        if window["steps"] == epoch_steps:
            torch.cuda.synchronize()
            window["s"] = time.perf_counter() - window["t0"]
            prof.stop()
        return out

    optimizer.update = counted
    torch.cuda.synchronize()
    window["t0"] = time.perf_counter()
    prof.start()
    t1 = time.perf_counter()
    try:
        state, aux2 = runner.run_iterations(state, profiled_iters)
    finally:
        del optimizer.update
    torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t1
    by_name = device_kernels(prof)
    kernels, busy_us = sum(v[1] for v in by_name.values()), sum(v[0] for v in by_name.values())
    launches = prefix_sample.launches
    t2 = time.perf_counter()
    returns = evaluator.evaluate(state.train_state, state.draws)
    eval_s = time.perf_counter() - t2
    adam_steps = runner.core.epochs * epoch_steps
    checks = {
        "t after two iterations": state.t == (timed_iters + profiled_iters) * per_iter == 16_384,
        "1,280 Adam steps per iteration": state.train_state.n_updates == (timed_iters + profiled_iters) * adam_steps
        and adam_steps == 1_280,
        "losses finite": all(bool(torch.isfinite(a["loss"]).all()) for a in (aux, aux2)),
        "the lanes were truncated at 200": int(state.recent_count) == 64 * (16_384 // (64 * 200)),
        "no prefix-sample launch": launches == 0,
        "evaluation returns finite": bool(np.isfinite(returns).all()) and returns.shape == (10,),
    }
    result = {
        "t": state.t, "n_updates": state.train_state.n_updates, "kernel_launches": launches,
        "env_steps_per_s": timed_iters * per_iter / timed_s, "updates_per_s": timed_iters * adam_steps / timed_s,
        "iteration_ms": timed_s / timed_iters * 1e3, "profiled_iteration_ms": profiled_s / profiled_iters * 1e3,
        "profiled_window_ms": window["s"] * 1e3, "device_launches_in_window": kernels,
        "device_busy_share": busy_us / 1e6 / window["s"], "eval_s": eval_s,
        "eval_returns": [float(r) for r in returns], "recent_return_mean": runner.recent_return_mean(state),
    }
    print(f"ppo-pendulum-device-64: env-steps/s {result['env_steps_per_s']:.1f}, Adam steps/s "
          f"{result['updates_per_s']:.1f} ({result['iteration_ms']:.1f} ms per iteration of {per_iter:,} "
          f"transitions and {adam_steps:,} Adam steps); over the collect and first epoch of the next "
          f"({result['profiled_window_ms']:.1f} ms, {kernels:,} kernels) device busy "
          f"{result['device_busy_share'] * 100:.1f}%; "
          f"evaluation {eval_s:.2f} s, mean return {float(returns.mean()):.1f} (fp32, no TF32) on {card}")
    _raise_on_failed("ppo-pendulum-device-64", checks)
    return result


def run_full_multihost(card: str) -> dict:
    """``train_dqn_batch_ale.py --multihost`` through
    ``atari_dqn_batch.run_multihost`` at world size 1 over NCCL on the card:
    the script's settings (8 lanes, the 10^6-slot ring, 28.3 GB, the
    ``"sum"`` accumulator) but the replay start (``MULTIHOST_REPLAY_START``),
    one chunk of ``MULTIHOST_CHUNK`` scan steps (102 updates), then 2 scan steps under the
    profiler before the job is left. No prefix-sample launch."""
    from pfrl_tpu_torch.experiments.atari_dqn_batch import run_multihost
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample
    from pfrl_tpu_torch.parallel.lane_sharding import LaneShardedBuffer
    from pfrl_tpu_torch.parallel.multihost import shutdown

    prefix_sample.launches = 0
    t0 = time.perf_counter()
    out = run_multihost(["--multihost", f"localhost:{_free_port()}", "--replay-start-size",
                         str(MULTIHOST_REPLAY_START), "--steps", str(MULTIHOST_CHUNK * 8)], keep_job=True,
                        chunk=MULTIHOST_CHUNK)
    try:
        run_s = time.perf_counter() - t0
        runner, state = out["runner"], out["state"]
        (state, _), profiled_s, kernels, busy_us = _device_profiled(lambda: runner.run_chunk(state, MULTIHOST_PROFILED))
    finally:
        shutdown()
    launches = prefix_sample.launches
    cfg, buf = runner.config, runner.buffer
    (t, sps, loss), = out["chunks"]
    updates = _updates_in(cfg, 1, MULTIHOST_CHUNK)
    chunk_s = MULTIHOST_CHUNK * cfg.num_envs / sps
    nbytes = _ring_bytes(buf.ring, state.replay_state.local)
    checks = {
        f"one chunk of {MULTIHOST_CHUNK} scan steps": t == MULTIHOST_CHUNK * cfg.num_envs
        and state.t == t + MULTIHOST_PROFILED * cfg.num_envs,
        "the updates of the chunk and the profiled steps": state.train_state.n_updates == updates
        + MULTIHOST_PROFILED * cfg.updates_per_step and updates == 102,
        "a mesh of one rank over the sharded 10^6-slot ring": isinstance(buf, LaneShardedBuffer)
        and buf.capacity == buf.ring.capacity == 10**6 and out["mesh"].size == 1,
        "the 'sum' accumulator, its gradients summed": runner.core.batch_accumulator == "sum"
        and runner.core.optimizer.op == "sum",
        "loss finite": math.isfinite(loss),
        "no prefix-sample launch": launches == 0,
    }
    result = {
        "t": state.t, "n_updates": state.train_state.n_updates, "kernel_launches": launches, "ring_bytes": nbytes,
        "env_steps_per_s": sps, "updates_per_s": updates / chunk_s, "chunk_s": chunk_s, "run_s": run_s,
        "profiled_scan_step_ms": profiled_s / MULTIHOST_PROFILED * 1e3,
        "device_launches_per_step": kernels / MULTIHOST_PROFILED,
        "device_busy_share": busy_us / 1e6 / profiled_s, "last_loss": loss,
    }
    print(f"dqn-multihost-ale-8 (one NCCL rank): ring {nbytes['frames'] / 1e9:.2f} GB of frames; the chunk of 500 scan "
          f"steps in {chunk_s:.2f} s, env-steps/s {sps:.1f} (through the replay start, cut to {MULTIHOST_REPLAY_START:,}), "
          f"updates/s {result['updates_per_s']:.1f} over the chunk; profiled scan step "
          f"{result['profiled_scan_step_ms']:.2f} ms with 2 updates, {result['device_launches_per_step']:.0f} kernels, "
          f"device busy {result['device_busy_share'] * 100:.1f}%; last loss {loss:.4f} (fp32, no TF32) on {card}")
    _raise_on_failed("dqn-multihost-ale-8", checks)
    state.replay_state = None
    return result


# -------------------------------------------------------------------- phase 21
# drqn-atarisim-32 on a mesh and without one: the replay start cut further than
# phase 12's 9,024, to 9,600, for the time limit (the sync at 10,000 kept):
# 299 scan steps acting, then 14 updating (112 updates) through t = 10,016.
DRQN_MESH_REPLAY_START = DRQN_ATARI_REPLAY_START  # cut from 9,600, the sync moved with phase 12's
DRQN_MESH_STEPS = (130, 2)   # warm (through replay start), timed (cut from 299, 14)
DRQN_MESH_PROFILED = 2  # the mesh run's scan steps under torch.profiler, after the comparison


def _storage_leaves(storage, prefix="storage") -> dict:
    """name -> tensor of an episodic buffer's storage (its carries too)."""
    out = {}
    for name, value in storage.items():
        if isinstance(value, dict):
            out.update(_storage_leaves(value, f"{prefix} {name}"))
        elif isinstance(value, torch.Tensor):
            out[f"{prefix} {name}"] = value
        else:
            out.update({f"{prefix} {name} {i}": leaf for i, leaf in enumerate(_leaves(value))})
    return out


def run_full_drqn_atarisim_mesh(card: str) -> dict:
    """``drqn-atarisim-32-mesh``: ``train_drqn_ale.py --sim`` at full width
    (32 lanes, LSTM 512 over single 84x84 frames, the 5.85 GB episodic
    buffer with its carries stored, 8 batch-32 updates per scan step) on a
    mesh of one NCCL rank on the card, against the same recipe without a
    mesh. Both runs take cuDNN's deterministic algorithms, start from the
    same weights and draws (seed 0) and run one after the other, the
    allocator's cache emptied between them, through the target sync at
    10,000 transitions (the replay start cut to ``DRQN_MESH_REPLAY_START``,
    9,600: 299 + 14 scan steps, 112 updates). Every
    learned tensor, metric, the carry, the buffer's tables and its whole
    storage (frames and stored carries, compared on the card) must be equal
    to the bit. The mesh run's timed chunk gives its scan step and, over
    ``DRQN_MESH_PROFILED`` more scan steps under ``torch.profiler``, its
    device busy share; the run without a mesh's scan step is printed
    beside it (one call, one card)."""
    from pfrl_tpu_torch.experiments.profile_slice import _profiled, on_mesh, one_rank_mesh
    from pfrl_tpu_torch.experiments.recurrent import make_drqn_atarisim_runner
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    warm_steps, timed_steps = DRQN_MESH_STEPS
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    prefix_sample.launches = 0
    try:
        with one_rank_mesh() as mesh:
            for label, m in (("no mesh", None), ("mesh", mesh)):
                runner = make_drqn_atarisim_runner(replay_start_size=DRQN_MESH_REPLAY_START,
                                                   target_update_interval=DRQN_ATARI_SYNC)[0]
                if m is not None:
                    runner = on_mesh(runner, m)
                state = runner.init(0)
                t0 = time.perf_counter()
                state, warm = runner.run_chunk(state, warm_steps)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, timed = runner.run_chunk(state, timed_steps)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                metrics = {k: torch.cat([warm[k], timed[k]]) for k in warm}
                runs[label] = {"runner": runner, "state": state, "metrics": metrics, "warm_s": t1 - t0,
                               "timed_s": t2 - t1}
                torch.cuda.empty_cache()
            plain, meshed = runs["no mesh"], runs["mesh"]
            a = _run_state(plain["runner"], plain["state"], plain["metrics"])
            b = _run_state(meshed["runner"], meshed["state"], meshed["metrics"])
            unequal = [k for k in a if not torch.equal(a[k], b[k])]
            sa, sb = (_storage_leaves(r["state"].replay_state.storage) for r in (plain, meshed))
            unequal += [k for k in sa if not torch.equal(sa[k], sb[k])]
            train = meshed["state"].train_state
            synced = all(torch.equal(x, y) for x, y in zip(train.model.parameters(), train.target_model.parameters()))
            runner, state = meshed["runner"], meshed["state"]
            (state, _), profiled_s, kernels, busy_us, top = _profiled(
                lambda: runner.run_chunk(state, DRQN_MESH_PROFILED))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    cfg = meshed["runner"].config
    updates = _updates_in(cfg, 1, warm_steps + timed_steps)
    launches = prefix_sample.launches
    storage_bytes = sum(x.numel() * x.element_size() for x in sb.values())
    checks = {
        "every learned tensor, metric, carry, buffer table and the storage equal to the bit": not unequal
        and a.keys() == b.keys() and sa.keys() == sb.keys(),
        "n_updates as expected on both runs": plain["state"].train_state.n_updates == train.n_updates - (
            cfg.updates_per_step * DRQN_MESH_PROFILED) == updates,
        "the target equals the online net right after the sync": synced,
        "the buffer of 5.9 GB": 5.5e9 < storage_bytes < 6.5e9,
        "no prefix-sample launch": launches == 0,
    }
    result = {
        "t": plain["state"].t, "n_updates": updates, "tensors_compared": len(a) + len(sa), "unequal": unequal,
        "storage_bytes": storage_bytes, "kernel_launches": launches,
        "scan_step_ms": {k: r["timed_s"] / timed_steps * 1e3 for k, r in runs.items()},
        "warm_chunk_s": {k: r["warm_s"] for k, r in runs.items()},
        "profiled_scan_step_ms": profiled_s / DRQN_MESH_PROFILED * 1e3,
        "device_launches_per_step": kernels / DRQN_MESH_PROFILED,
        "device_busy_ms_per_step": busy_us / DRQN_MESH_PROFILED / 1e3,
        "device_busy_share": busy_us / 1e6 / profiled_s,
        "top_device_ops": [{"name": n, "ms_per_step": us / DRQN_MESH_PROFILED / 1e3,
                            "launches_per_step": k / DRQN_MESH_PROFILED} for n, (us, k) in top[:8]],
    }
    del runs, plain, meshed, runner, state, train, sa, sb
    torch.cuda.empty_cache()
    _raise_on_failed("drqn-atarisim-32-mesh", checks)
    print(
        f"drqn-atarisim-32-mesh: one NCCL rank on the card against no mesh through the sync at 10,000 "
        f"(t = {result['t']}, {updates} updates), {result['tensors_compared']} tensors with the "
        f"{storage_bytes / 1e9:.3f} GB storage, {len(unequal)} unequal {unequal[:4]}; scan step (8 updates) "
        f"{result['scan_step_ms']['mesh']:.2f} ms on the mesh, {result['scan_step_ms']['no mesh']:.2f} ms without "
        f"(cuDNN deterministic); over {DRQN_MESH_PROFILED} profiled scan steps of {result['profiled_scan_step_ms']:.2f} ms, "
        f"device busy {result['device_busy_ms_per_step']:.2f} ms per scan step "
        f"({result['device_busy_share'] * 100:.1f}%), {result['device_launches_per_step']:.1f} kernels per scan step "
        f"on {card}"
    )
    return result


# -------------------------------------------------------------------- phase 22
# dqn-ale-host-per-1: the example's replay start of 50,000 cut to 600 and the
# run to 1,600 steps for the time limit: 251 updates, one kernel launch each
# at C = 2^20. 16 steps from t = 700 (4 updates) run under the profiler (64
# took 10 s: ~1,170 kernels per step); the rates after the replay start are
# taken past that window.
ALE_REPLAY_START = 200          # cut from 600 for the time limit
ALE_STEPS = 400                 # cut from 1,600: 51 updates, one kernel launch each
ALE_PROFILED = (240, 16)
# Host paths of HOST_PATHS that phase 22 runs through run_ale itself.
PHASE_22_HOST_PATHS = ("dqn-ale-host-per-1",)
ALE_SMALL_STEPS = 136    # cut from 240 for the time limit
ALE_SMALL_UPDATES = 23   # one per 4 steps from the replay start of 48 (49 before the cut)
ALE_SMALL_ARGS = ["--replay-capacity", "512", "--replay-start-size", "48", "--steps", str(ALE_SMALL_STEPS),
                  "--target-update-interval", "64", "--max-frames", "400"]


def ale_make_atari():
    """``make_atari`` for phase 22 over the ALE stand-in
    (``profile_host.standin_make_atari``), and whether gymnasium is
    installed. Without it ``make_atari`` itself must raise, naming it."""
    from pfrl_tpu_torch.experiments.profile_host import ALE_STANDIN_ID, standin_make_atari
    from pfrl_tpu_torch.wrappers import atari_wrappers

    make = standin_make_atari()
    gymnasium = make is atari_wrappers.make_atari
    if not gymnasium:
        try:
            atari_wrappers.make_atari(ALE_STANDIN_ID)
        except RuntimeError as e:
            if "gymnasium" not in str(e):
                raise AssertionError(f"make_atari raised without naming gymnasium: {e}") from e
        else:
            raise AssertionError("make_atari built an env where gymnasium is not installed")
    return make, gymnasium


def _run_ale(argv, device, make_atari, draws=None, step_hooks=(), scale=1.0, log=None) -> dict:
    """``atari_dqn_ale.run_ale(argv)`` on ``device``; with ``log``, the
    shell's weights times ``scale`` at their init, and ``log`` gets every
    action, target sync and sampled slot."""
    from pfrl_tpu_torch.experiments import atari_dqn_ale

    if log is None:
        return atari_dqn_ale.run_ale(argv, device=device, make_atari=make_atari, draws=draws, step_hooks=step_hooks)
    base = atari_dqn_ale.DQN

    class Shell(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            sync, find = self.core.sync_target, getattr(self.buffer, "_find_slots", None)

            def sync_target(state):
                log["syncs"] += 1
                return sync(state)

            def find_slots(tree, targets):
                slots = find(tree, targets)
                log["slots"].append(slots.cpu().numpy().copy())
                leaves = tree[self.buffer.tree_capacity:]
                log["samples"].append((leaves.to("cpu", copy=True), targets.to("cpu", copy=True)))
                return slots

            self.core.sync_target = sync_target
            if find is not None:
                self.buffer._find_slots = find_slots

        def _ensure_init(self, obs):
            fresh = self.train_state is None
            super()._ensure_init(obs)
            if fresh:
                with torch.no_grad():
                    for p in [*self.train_state.model.parameters(), *self.train_state.target_model.parameters()]:
                        p.mul_(scale)

        def batch_act(self, batch_obs):
            out = super().batch_act(batch_obs)
            log["actions"].append(np.asarray(out).copy())
            return out

    atari_dqn_ale.DQN = Shell
    try:
        out = atari_dqn_ale.run_ale(argv, device=device, make_atari=make_atari, draws=draws, step_hooks=step_hooks)
    finally:
        atari_dqn_ale.DQN = base
    return out


def check_small_dqn_ale(device) -> dict:
    """``run_ale --prioritized`` small (``ALE_SMALL_ARGS``: the Nature
    network at its widths, the ring cut to 512 slots, 23 updates) on the
    card and on the CPU from the same weights (the shell draws its initial
    weights from a CPU generator seeded ``--seed``) and draws
    (``SeededDraws``): every action, sync and count equal, the ring's frames
    equal, the statistics within 1e-4 or 4x the nudges, every learned
    tensor within 3e-6 (1e-5 of the largest second moment) or 4x what 1 +-
    2**-23 nudges of the weights move it; one kernel launch per update on
    the card. Each sample's slots on the card equal the plain version's on
    the same leaves and targets (on the CPU), but where a target lies within
    rounding of a cumulative boundary; they equal the CPU run's wherever the
    two runs' priorities are equal (the first sample, all at the maximum:
    later priorities come from TD errors an ulp apart, ROADMAP C87). The
    same run without ``--prioritized`` on the card launches none."""
    from pfrl_tpu_torch.experiments.profile_host import ALE_STANDIN_ID
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample, prefix_sample_reference

    make, gymnasium = ale_make_atari()
    argv = ["--env", ALE_STANDIN_ID, "--prioritized", "--eval-interval", str(10**6), *ALE_SMALL_ARGS]

    def run(dev, tag, scale=1.0, prioritized=True):
        log = {"actions": [], "syncs": 0, "slots": [], "samples": []}
        with tempfile.TemporaryDirectory() as outdir:
            args = argv if prioritized else [a for a in argv if a != "--prioritized"]
            agent = _run_ale(args + ["--outdir", outdir], dev, make, SeededDraws(1, dev), scale=scale,
                             log=log)["agent"]
        return agent, log

    prefix_sample.launches = 0
    card, card_log = run(device, "card")
    torch.cuda.synchronize()
    launches = prefix_sample.launches
    cpu, cpu_log = run("cpu", "cpu")
    nudged = [run("cpu", f"nudged{i}", s) for i, s in enumerate(ACER_NUDGES)]
    prefix_sample.launches = 0
    uniform, _ = run(device, "uniform", prioritized=False)
    torch.cuda.synchronize()
    uniform_launches = prefix_sample.launches
    storage = [a.replay_state.base.storage["obs"].cpu() for a in (card, cpu)]
    worst = _learned_differences(card.train_state, cpu.train_state, [n[0].train_state for n in nudged])
    # The card's every sample against the plain version on the CPU, on the
    # card's own leaves and targets; and the card's slots against the CPU
    # run's, whose priorities (from TD errors an ulp apart) may part them.
    plain = [prefix_sample_reference(leaves, targets).numpy() for leaves, targets in card_log["samples"]]
    kernel_vs_plain = [_sampled_ids_agree(leaves, targets, torch.from_numpy(got), torch.from_numpy(want))
                       for (leaves, targets), got, want in zip(card_log["samples"], card_log["slots"], plain)]
    unequal_slots = sum(int((a != b).sum()) for a, b in zip(card_log["slots"], cpu_log["slots"]))
    first_unequal = next((i for i, (a, b) in enumerate(zip(card_log["slots"], cpu_log["slots"]))
                          if not np.array_equal(a, b)), None)
    equal_priorities = [torch.equal(a[0], b[0]) for a, b in zip(card_log["samples"], cpu_log["samples"])]
    steps, updates = ALE_SMALL_STEPS, ALE_SMALL_UPDATES
    checks = {
        "actions": len(card_log["actions"]) == len(cpu_log["actions"]) == steps and all(
            np.array_equal(a, b) for a, b in zip(card_log["actions"], cpu_log["actions"])),
        "every sampled slot of the card's kernel equals the plain version's on its tree":
            len(kernel_vs_plain) == updates and all(kernel_vs_plain)
            and sum(np.array_equal(a, b) for a, b in zip(card_log["slots"], plain)) >= 1,
        "the card's and the CPU's slots equal wherever their priorities are": len(cpu_log["slots"]) == updates and all(
            np.array_equal(a, b) for a, b, same in zip(card_log["slots"], cpu_log["slots"], equal_priorities)
            if same) and equal_priorities[0],
        "equal step, update and sync counts": card.t == cpu.t == steps and card.optim_t == cpu.optim_t == updates
        and card_log["syncs"] == cpu_log["syncs"] >= 2,
        "the ring's frames": torch.equal(*storage),
        "statistics within 1e-4, or 4x the nudges": all(
            _within_nudges(float(a), float(b), [float(dict(n[0].get_statistics())[k]) for n in nudged], 1e-4, 5e-5)
            for (k, a), (_, b) in zip(card.get_statistics(), cpu.get_statistics())),
        "learned tensors within their bounds": all(d <= b for d, b in worst.values()),
        "one prefix-sample launch per update": launches == card.optim_t == updates,
        "no launch without --prioritized": uniform_launches == 0 and uniform.optim_t == updates,
    }
    top = max(worst.items(), key=lambda kv: kv[1][0] / kv[1][1])
    print(f"small dqn-ale-host-per: run_ale over the ALE stand-in ({'gymnasium' if gymnasium else 'no gymnasium: '
          'make_atari raised by name, the chain built through its helper'}), card vs CPU over {card.t} steps, "
          f"{card.optim_t} updates, {card_log['syncs']} syncs, {len(card_log['slots'])} samples of 32 slots "
          f"({sum(kernel_vs_plain)} equal to the plain version's on the card's trees; {unequal_slots} slots unequal "
          f"to the CPU run's, the first in sample {first_unequal}; priorities equal in {sum(equal_priorities)} "
          f"samples), actions "
          f"{'equal' if checks['actions'] else 'DIFFER'}; largest difference against its bound {top[0]} "
          f"{top[1][0]:.3g} <= {top[1][1]:.3g}; {launches} prefix-sample launches, {uniform_launches} without "
          f"--prioritized")
    _raise_on_failed("small dqn-ale-host-per", checks)
    result = {"gymnasium": gymnasium, "host_steps": card.t, "updates": card.optim_t, "kernel_launches": launches,
              "samples_equal_to_plain": sum(kernel_vs_plain), "slots_unequal_to_cpu": unequal_slots,
              "first_sample_unequal_to_cpu": first_unequal, "samples_with_equal_priorities": sum(equal_priorities),
              "uniform_kernel_launches": uniform_launches, "largest_differences": {k: v[0] for k, v in worst.items()},
              "bounds": {k: v[1] for k, v in worst.items()}}
    del card, cpu, nudged, uniform
    return result


def _held_against_plain(tree: torch.Tensor, tree_capacity: int, targets: torch.Tensor) -> dict:
    """The kernel against ``prefix_sample_reference`` on a run's own sum
    tree: equal counts, but where a target lies within ``1e-6 * total`` of
    a cumulative boundary (float64 cumsum as judge; the two add in another
    order); raises otherwise."""
    from pfrl_tpu_torch.ops import prefix_sample as ps

    leaves = tree[tree_capacity:].contiguous()
    got = ps.prefix_sample(leaves, targets).cpu().numpy()
    want = ps.prefix_sample_reference(leaves, targets).cpu().numpy()
    prio = leaves.cpu().numpy().astype(np.float64)
    cs64, total = np.cumsum(prio), float(prio.sum())
    mismatches = 0
    for g, w, tb in zip(got, want, targets.cpu().numpy()):
        if g != w:
            mismatches += 1
            lo, hi = sorted((int(g), int(w)))
            if np.max(np.abs(cs64[lo:hi] - tb)) > 1e-6 * total:
                raise AssertionError(f"prefix_sample on the run's tree: {g} vs {w} at target {tb}")
    return {"max_abs_err": int(np.max(np.abs(got.astype(np.int64) - want.astype(np.int64)))),
            "mismatches_within_rounding": mismatches}


def run_full_dqn_ale(card: str) -> dict:
    """``dqn-ale-host-per-1``: ``train_dqn_ale.py --prioritized``'s host path
    through ``atari_dqn_ale.run_ale`` at the example's widths and settings
    (Nature CNN over 84x84x4 uint8 stacks of the ALE stand-in, batch 32,
    Adam, the 10^6-slot PER ring on the card, 28.3 GB, C = 2^20, the
    kernel once per update; one env stepped per act), but the replay start
    (``ALE_REPLAY_START``) and the run's length (``ALE_STEPS``): 251
    updates, no evaluation. A step hook marks each step's time and update
    count and records ``ALE_PROFILED`` steps under ``torch.profiler``: the
    device's busy share and the kernel's device time per launch. Then the
    kernel is held against its plain version on the run's final tree."""
    from pfrl_tpu_torch.experiments.profile_host import ALE_STANDIN_ID, device_kernels
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample
    from pfrl_tpu_torch.replay import sum_tree

    make, gymnasium = ale_make_atari()
    marks, window = [], {}
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def hook(env, agent, t):
        marks.append((t, time.perf_counter(), agent.optim_t))
        if t == ALE_PROFILED[0] or t == ALE_PROFILED[0] + ALE_PROFILED[1]:
            torch.cuda.synchronize()
            window["start" if t == ALE_PROFILED[0] else "end"] = (time.perf_counter(), agent.optim_t)
            (prof.start if t == ALE_PROFILED[0] else prof.stop)()

    argv = ["--env", ALE_STANDIN_ID, "--prioritized", "--replay-start-size", str(ALE_REPLAY_START),
            "--steps", str(ALE_STEPS), "--eval-interval", str(10**6)]
    prefix_sample.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as outdir:  # the finished agent
        out = _run_ale(argv + ["--outdir", outdir], None, make, step_hooks=[hook])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = prefix_sample.launches
    agent = out["agent"]
    by_name = device_kernels(prof)
    (s0, u0), (s1, u1) = window["start"], window["end"]
    busy_us = sum(v[0] for v in by_name.values())
    kernel = [v for n, v in by_name.items() if "prefix_sample" in n]
    kernel_us, kernel_n = (sum(v[0] for v in kernel), sum(v[1] for v in kernel)) if kernel else (0.0, 0)

    def rate(lo, hi):
        inside = [m for m in marks if lo <= m[0] <= hi]
        (ta, sa, ua), (tb, sb, ub) = inside[0], inside[-1]
        return (tb - ta) / (sb - sa), (ub - ua) / (sb - sa)

    acting, _ = rate(1, ALE_REPLAY_START - 1)
    learning, updates_per_s = rate(ALE_PROFILED[0] + ALE_PROFILED[1] + 1, ALE_STEPS)
    buffer = agent.buffer
    ring_bytes = sum(x.numel() * x.element_size() for x in agent.replay_state.base.storage.values())
    targets = sum_tree.stratified_targets(sum_tree.total(agent.replay_state.tree),
                                          SeededDraws(3, agent.device).uniform(32))
    held = _held_against_plain(agent.replay_state.tree, buffer.tree_capacity, targets)
    stats = dict(agent.get_statistics())
    expected_updates = (ALE_STEPS - ALE_REPLAY_START) // 4 + 1
    checks = {
        "t and the updates as the shell's gating has them": agent.t == ALE_STEPS
        and agent.optim_t == expected_updates,
        "one prefix-sample launch per update, at C = 2^20": launches == expected_updates
        and buffer.tree_capacity == 2**20 and (buffer.capacity, buffer.num_lanes) == (10**6, 1),
        "the 28.3 GB ring": 28.0e9 < ring_bytes < 28.6e9,
        "statistics finite": all(math.isfinite(float(v)) for v in stats.values()),
        "the profiled window launched the kernel": kernel_n == u1 - u0 > 0,
    }
    result = {
        "gymnasium": gymnasium, "t": agent.t, "n_updates": agent.optim_t, "kernel_launches": launches,
        "wall_s": wall_s, "ring_bytes": ring_bytes, "tree_capacity": buffer.tree_capacity,
        "env_steps_per_s_before_replay_start": acting, "env_steps_per_s_after_replay_start": learning,
        "updates_per_s_after_replay_start": updates_per_s,
        "profiled": {"steps": ALE_PROFILED[1], "updates": u1 - u0, "seconds": s1 - s0,
                     "kernels_per_step": sum(v[1] for v in by_name.values()) / ALE_PROFILED[1],
                     "device_busy_ms_per_step": busy_us / 1e3 / ALE_PROFILED[1],
                     "device_busy_share": busy_us / 1e6 / (s1 - s0),
                     "prefix_sample_us_per_launch": kernel_us / kernel_n if kernel_n else None,
                     "top_device_ops": [{"name": n[:120], "ms_per_step": us / 1e3 / ALE_PROFILED[1]}
                                        for n, (us, _) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]]},
        "kernel_on_the_runs_tree": held, "statistics": stats,
    }
    print(f"dqn-ale-host-per-1: run_ale --prioritized over the ALE stand-in, Nature CNN, 84x84x4, batch 32, "
          f"ring {ring_bytes / 1e9:.2f} GB, C = {buffer.tree_capacity:,}; env-steps/s {acting:.1f} before the replay "
          f"start ({ALE_REPLAY_START:,}), {learning:.1f} after it, updates/s {updates_per_s:.2f}; {agent.optim_t} "
          f"updates, {launches} prefix-sample launches; over {ALE_PROFILED[1]} profiled steps ({u1 - u0} updates, "
          f"{(s1 - s0) * 1e3:.1f} ms) {result['profiled']['kernels_per_step']:.1f} kernels per step, device busy "
          f"{result['profiled']['device_busy_share'] * 100:.1f}%, prefix_sample "
          f"{result['profiled']['prefix_sample_us_per_launch'] or float('nan'):.2f} us per launch; the kernel on the "
          f"run's tree: {held}; {wall_s:.1f} s (fp32, no TF32) on {card}")
    _raise_on_failed("dqn-ale-host-per-1", checks)
    agent.replay_state = None
    del agent, out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return result


# -------------------------------------------------------------------- phase 24
# The command lines of ``examples/``, each through its port module's ``run``
# at the example's widths (its default lanes, ring and batch) with explicit
# small depth flags. The recipe behind each is driven at full width by an
# earlier phase; this phase shows that each command line reaches it.
CLI_CHUNK = 4            # scan steps per turn of the loops whose example fixes 500 (or 200 iterations)
CLI_ATARI = ["--steps", "512", "--replay-start-size", "256"]  # 64 lanes: 8 scan steps, 80 updates


def _loop_t(steps: int, per_turn: int) -> int:
    """Where a ``while t < steps`` loop of ``per_turn`` transitions a turn stops."""
    return -(-steps // per_turn) * per_turn


def _cli_checks(name: str, out: dict, want_t: int, want_updates, launches: int, want_launches) -> dict:
    state = out["state"]
    n_updates = state.train_state.n_updates
    checks = {
        f"stopped at t = {want_t}": state.t == want_t,
        f"its {want_updates} updates ran": n_updates == want_updates if isinstance(want_updates, int)
        else n_updates >= 1,
        f"{want_launches} prefix-sample launches": launches == want_launches,
    }
    _raise_on_failed(f"cli {name}", checks)
    return {"t": state.t, "n_updates": n_updates, "kernel_launches": launches}


def _cli_device_loop(name: str, call, want_t: int, want_updates, per_update_launches: int = 0) -> dict:
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    prefix_sample.launches = 0
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    launches = prefix_sample.launches
    n_updates = out["state"].train_state.n_updates
    result = _cli_checks(name, out, want_t, want_updates, launches, per_update_launches * n_updates)
    print(f"cli {name}: t = {out['state'].t} in {out['turns']} turns, {n_updates} updates, {launches} "
          f"prefix-sample launches, {time.perf_counter() - t0:.2f} s")
    return {**result, "out": out}


def cli_flagship(card: str) -> dict:
    """``train_dqn.py --sim`` (``atari_dqn_reproduction.run``): 64 lanes, the
    10^5-slot uniform ring, RMSprop with eps inside the root, the ``"sum"``
    accumulator; 8 scan steps, then ``--save-to`` and, in a fresh runner,
    ``--load --demo`` (``EvalLoop`` 5 x 500) with the weights equal to the
    bit."""
    from pfrl_tpu_torch.experiments import atari_dqn_reproduction

    with tempfile.TemporaryDirectory() as directory:
        r = _cli_device_loop("train_dqn.py --sim", lambda: atari_dqn_reproduction.run(
            ["--sim", *CLI_ATARI, "--save-to", directory], chunk=CLI_CHUNK), 512, 80)
        out = r.pop("out")
        runner, saved = out["runner"], out["state"].train_state
        loaded = atari_dqn_reproduction.run(["--sim", "--load", directory, "--demo"])
    got = dict(loaded["state"].train_state.model.named_parameters())
    checks = {
        "the flagship's recipe": runner.core.batch_accumulator == "sum" and runner.buffer.capacity == 99_968
        and not runner.buffer.store_next_obs and runner.config.num_envs == 64
        and type(runner.core.optimizer).__name__ == "RMSprop",
        "saved train state loaded to the bit": all(torch.equal(p, got[n]) for n, p in saved.model.named_parameters()),
        "the demo's 5 returns, finite": loaded["demo_returns"].shape == (5,)
        and bool(np.isfinite(loaded["demo_returns"]).all()),
    }
    _raise_on_failed("cli train_dqn.py --sim", checks)
    return r


def cli_rainbow(card: str, device) -> dict:
    """``train_rainbow.py`` (``atari_rainbow.run``): 64 lanes, the 10^5-slot
    prioritized ring, so the prefix-sample kernel at C = 2^17, B = 32, once
    per update; then the kernel held against its plain version on the run's
    own leaves."""
    from pfrl_tpu_torch.experiments import atari_rainbow
    from pfrl_tpu_torch.ops import prefix_sample as ps

    r = _cli_device_loop("train_rainbow.py", lambda: atari_rainbow.run(CLI_ATARI, chunk=CLI_CHUNK), 512, 80, 1)
    out = r.pop("out")
    buffer, replay = out["runner"].buffer, out["state"].replay_state
    leaves = replay.tree[buffer.tree_capacity:]
    targets = torch.rand(32, generator=torch.Generator(device=device).manual_seed(24), device=device) * leaves.sum()
    got, want = ps.prefix_sample(leaves, targets), ps.prefix_sample_reference(leaves, targets)
    err = int((got - want).abs().max())
    _raise_on_failed("cli train_rainbow.py", {
        "C = 2^17 leaves, B = 32": leaves.numel() == 131_072 and targets.numel() == 32,
        "the kernel equals its plain version on the run's leaves": err == 0,
    })
    print(f"cli train_rainbow.py: the kernel on the run's {leaves.numel()} leaves, B = 32: max |err| {err}")
    return {**r, "C": leaves.numel(), "max_abs_err": err}


def cli_batch_modes(card: str) -> dict:
    """``train_dqn_batch_ale.py`` (``atari_dqn_batch.run``) over
    ``SyntheticALE`` (no ALE here): the batch mode (8 + 8 spawned workers,
    the 10^6-slot ring) and ``--actor-learner`` (8 actor threads), each
    from a replay start of 128 to t = 256; 0 launches."""
    from pfrl_tpu_torch.envs import synthetic_ale
    from pfrl_tpu_torch.experiments import atari_dqn_batch
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    argv = ["--steps", "256", "--replay-start-size", "128"]
    results = {}
    for mode, extra in (("batch", []), ("actor-learner", ["--actor-learner"])):
        prefix_sample.launches = 0
        with tempfile.TemporaryDirectory() as outdir, spawned_workers_skip_this_script():
            out = atari_dqn_batch.run([*extra, *argv, "--outdir", outdir], make_env=synthetic_ale.make_ale_env)
        agent = out if mode == "actor-learner" else out[0]
        torch.cuda.synchronize()
        launches = prefix_sample.launches
        n_updates = agent.train_state.n_updates
        _raise_on_failed(f"cli train_dqn_batch_ale.py {mode}", {
            "the 10^6-slot ring": agent.buffer.capacity == 10**6,
            "its updates ran": n_updates >= 1,
            "0 prefix-sample launches": launches == 0,
        })
        print(f"cli train_dqn_batch_ale.py {' '.join(extra) or '(batch)'}: {n_updates} updates, {launches} "
              "prefix-sample launches")
        results[f"train_dqn_batch_ale.py {mode}"] = {"n_updates": n_updates, "kernel_launches": launches}
        # Each mode's 26.35 GB ring: the first is freed before the second
        # allocates (once, the two side by side and the cache's fragments
        # passed the card's 79 GB).
        del out, agent
        gc.collect()
        torch.cuda.empty_cache()
    return results


def cli_small_device_loops(card: str) -> dict:
    """The other device command lines, each at its example's lanes, ring and
    batch, a few turns deep: IQN without ``--sim``, A2C and PPO ``--sim``,
    ACER, C51 and DRQN ``--sim``, A3C, DQN-CartPole, PPO ``--jax-env
    pendulum``; 0 launches each."""
    from pfrl_tpu_torch.experiments import (
        acer,
        atari_a3c,
        atari_c51,
        atari_iqn,
        atari_onpolicy_ale,
        cartpole_value,
        mujoco_host,
        recurrent,
    )
    from pfrl_tpu_torch.experiments.recurrent import DRQN_ATARISIM_CUT_REPLAY_START as DRQN_START

    drqn_t = _loop_t(DRQN_START + 1, 32 * 66)
    runs = {
        # 64 lanes, the 10^5-slot ring; F4: no --sim.
        "train_iqn.py": (lambda: atari_iqn.run(CLI_ATARI, chunk=CLI_CHUNK), 512, 80),
        # 16 lanes x 5 steps, 2 iterations; 8 lanes x 128 steps, 1 iteration of 16 Adam steps.
        "train_a2c_ale.py --sim": (lambda: atari_onpolicy_ale.run_a2c_ale(["--sim", "--steps", "1"], chunk=2),
                                   160, 2),
        "train_ppo_ale.py --sim": (lambda: atari_onpolicy_ale.run_ppo_ale(["--sim", "--steps", "1"], chunk=1),
                                   1024, 16),
        # 16 lanes, the 2,048 x 50 episodic buffer: rows sealed by t = 832, then one update per scan step.
        "train_acer_ale.py --sim": (lambda: acer.run(["--sim", "--steps", "960", "--replay-start-size", "832",
                                                      "--chunk", "26"]), 1248, 27),
        # 64 lanes, the 10^6-slot ring.
        "train_categorical_dqn_ale.py --sim": (lambda: atari_c51.run(["--sim", *CLI_ATARI, "--chunk", "4"]),
                                               512, 80),
        # 32 lanes, the 2,048 x 128 episodic buffer: past the first sealed rows, 8 updates a scan step.
        "train_drqn_ale.py --sim": (lambda: recurrent.run(["--sim", "--steps", str(DRQN_START + 1),
                                                           "--replay-start-size", str(DRQN_START), "--chunk", "66"]),
                                    drqn_t, 8 * ((drqn_t - DRQN_START) // 32 + 1)),
        "train_a3c.py": (lambda: atari_a3c.run(["--steps", "1"], chunk=2), 160, 2),
        # 128 lanes; 2 chunks of 8 scan steps, each followed by EvalLoop 16 x 500; updates from 1,000.
        "train_dqn_cartpole.py": (lambda: cartpole_value.run(["--steps", "2048", "--eval-interval", "1024"]),
                                  2048, 36),
        # 64 lanes x 128 steps, 1 iteration of 1,280 Adam steps.
        "train_ppo.py --jax-env pendulum": (lambda: mujoco_host.run_ppo(["--jax-env", "pendulum", "--steps", "1"],
                                                                        chunk=1), 8192, 1280),
    }
    results = {}
    for name, (call, want_t, want_updates) in runs.items():
        results[name] = _cli_device_loop(name, call, want_t, want_updates)
        results[name].pop("out")
    return results


def cli_host_and_objective(card: str) -> dict:
    """``train_reinforce_gym.py`` (the host CartPole, 10 episodes an update)
    and ``optuna_dqn_cartpole.objective`` with a stand-in trial (32 lanes,
    1,280 transitions, 5 reports, updates from 1,024); 0 launches."""
    import types

    from pfrl_tpu_torch.experiments import optuna_dqn_cartpole, reinforce_gym
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    prefix_sample.launches = 0
    with tempfile.TemporaryDirectory() as outdir:
        agent, _ = reinforce_gym.run(["--steps", "400", "--eval-interval", "200", "--eval-n-runs", "2",
                                      "--outdir", outdir])
    reinforce_updates = agent.train_state.n_updates

    class Trial:
        number, reports = 0, []
        values = dict(lr=1e-3, n_hidden_channels=64, n_hidden_layers=2, update_per=32, final_epsilon=0.05,
                      gamma=0.99)

        def suggest_float(self, name, *a, **kw):
            return self.values[name]

        suggest_categorical = suggest_int = suggest_float

        def report(self, value, step):
            self.reports.append((value, step))

        def should_prune(self):
            return False

    trial = Trial()
    score = optuna_dqn_cartpole.objective(trial, types.SimpleNamespace(steps=1280, bf16=False))
    torch.cuda.synchronize()
    launches = prefix_sample.launches
    _raise_on_failed("cli train_reinforce_gym.py and optuna_dqn_cartpole.py", {
        "REINFORCE updated": reinforce_updates >= 1,
        "5 reports at t = 256 ... 1,280, the last the score": [t for _, t in trial.reports] == [256, 512, 768, 1024,
                                                                                                 1280]
        and trial.reports[-1][0] == score and math.isfinite(score),
        "0 prefix-sample launches": launches == 0,
    })
    print(f"cli train_reinforce_gym.py: {reinforce_updates} updates; optuna objective reports "
          f"{[round(v, 1) for v, _ in trial.reports]}, 0 launches")
    return {"reinforce_updates": reinforce_updates, "objective_reports": trial.reports, "kernel_launches": launches}


# -------------------------------------------------------------------- phase 23
SIBLING_NUDGES = (1.0 + 2.0**-23, 1.0 - 2.0**-23)
SIBLING_FLOOR = 3e-6      # C22's floor, where 4x the nudges is less
BN_CRITIC_STEPS = 60      # Adam(1e-3) steps of each batch-norm critic in train mode (cut from 200)
LSTM_Q_UNROLL = 100       # FCLSTMSAQFunction's steps from initial_carry
NORMALIZER = (17, 2_048, 50, 100_000)  # width, batch, updates, until: the 50th update is frozen
RMSPROP_STEPS = 40        # cut from 100
CHECKPOINT_SCAN_STEPS = 20  # the Nature-CNN DQN's runner, 64 lanes, replay start 1,024: 64 updates


def _held(card_t, cpu_t, nudged, what: str, out: dict) -> None:
    """The card's tensor against the CPU's: within ``SIBLING_FLOOR`` or 4x
    the larger of what the CPU's two nudged runs move it."""
    c, w = card_t.detach().cpu().double(), cpu_t.detach().cpu().double()
    diff = float((c - w).abs().max()) if c.numel() else 0.0
    nudge = max(float((n.detach().cpu().double() - w).abs().max()) if w.numel() else 0.0 for n in nudged)
    bound = max(SIBLING_FLOOR, 4 * nudge)
    out[what] = {"diff": diff, "nudge": nudge, "bound": bound}
    if not diff <= bound:
        raise AssertionError(f"phase 23 {what}: card - CPU {diff:.3e} > {bound:.3e} (4x nudges {nudge:.3e})")


def _worst(held: dict) -> dict:
    name = max(held, key=lambda k: held[k]["diff"] / held[k]["bound"])
    return {"tensors": len(held), "worst": name, **held[name]}


def _nudge_(module: torch.nn.Module, factor: float) -> torch.nn.Module:
    with torch.no_grad():
        for p in module.parameters():
            p.mul_(factor)
    return module


def check_bn_critic(kind: str, device, card: str) -> dict:
    """The batch-norm critic ``kind`` at the DDPG example's widths
    (``experiments/bn_critic.py``): ``BN_CRITIC_STEPS`` train-mode Adam steps
    toward a fixed target on the card, on the CPU and on the CPU with the
    weights and inputs nudged by 1 +- 2^-23; then an evaluation forward on
    the running statistics. Every weight, running statistic and Q-value
    held; then the card's ms per train step."""
    from pfrl_tpu_torch.experiments import bn_critic

    arrays = bn_critic.make_batches(BN_CRITIC_STEPS + 1, seed=23)
    runs = {}
    for side, dev, f in (("card", device, 1.0), ("cpu", "cpu", 1.0),
                         ("nudged+", "cpu", SIBLING_NUDGES[0]), ("nudged-", "cpu", SIBLING_NUDGES[1])):
        critic = _nudge_(bn_critic.make_critic(kind, seed=23, device="cpu"), f).to(dev)
        optimizer, opt_state = bn_critic.make_optimizer(critic)
        obs, act, target = (torch.from_numpy(x * (f if i < 2 else 1.0)).to(dev) for i, x in enumerate(arrays))
        for i in range(BN_CRITIC_STEPS):
            bn_critic.train_step(critic, optimizer, opt_state, obs[i], act[i], target[i])
        with torch.no_grad():
            q = critic(obs[-1], act[-1], train=False)
        runs[side] = (critic, q, (optimizer, opt_state, obs[0], act[0], target[0]))
    held = {}
    states = {side: r[0].state_dict() for side, r in runs.items()}
    for name, value in states["cpu"].items():
        _held(states["card"][name], value, [states["nudged+"][name], states["nudged-"][name]], name, held)
    _held(runs["card"][1], runs["cpu"][1], [runs["nudged+"][1], runs["nudged-"][1]], "eval q", held)
    critic, _, (optimizer, opt_state, obs, act, target) = runs["card"]
    ms = time_ms(lambda: bn_critic.train_step(critic, optimizer, opt_state, obs, act, target), iters=100, warmup=5)
    result = {"steps": BN_CRITIC_STEPS, "widths": [bn_critic.OBS, bn_critic.ACT, bn_critic.CHANNELS,
                                                   bn_critic.LAYERS, bn_critic.BATCH],
              "ms_per_step": ms, **_worst(held)}
    print(f"phase 23 bn critic {kind}: {BN_CRITIC_STEPS} steps held ({result['tensors']} tensors, worst "
          f"{result['worst']} {result['diff']:.3e} <= {result['bound']:.3e}); {ms:.3f} ms/train step ({card})")
    return result


def check_lstm_q(device, card: str) -> dict:
    """``FCLSTMSAQFunction`` at 400 channels (2 layers; HalfCheetah's 17
    observations and 6 actions), batch 100, unrolled ``LSTM_Q_UNROLL``
    steps from ``initial_carry`` in its sequence form: the Q-values and the
    final carry held, then the card's ms per unroll."""
    import copy

    from pfrl_tpu_torch.q_functions import FCLSTMSAQFunction

    base = FCLSTMSAQFunction(17, 6, 400, 2)
    base.reset_parameters(torch.Generator().manual_seed(24))
    rs = np.random.RandomState(24)
    obs = (rs.normal(size=(LSTM_Q_UNROLL, 100, 17)) * 2.0).astype(np.float32)
    act = np.tanh(rs.normal(size=(LSTM_Q_UNROLL, 100, 6))).astype(np.float32)
    outs = {}
    with torch.no_grad():
        for side, dev, f in (("card", device, 1.0), ("cpu", "cpu", 1.0),
                             ("nudged+", "cpu", SIBLING_NUDGES[0]), ("nudged-", "cpu", SIBLING_NUDGES[1])):
            m = _nudge_(copy.deepcopy(base), f).to(dev)
            o, a = torch.from_numpy(obs * f).to(dev), torch.from_numpy(act * f).to(dev)
            q, (carry,) = m(o, a, m.initial_carry(100), sequence=True)
            outs[side] = (q, carry, m, o, a)
        held = {}
        nudged = [outs["nudged+"], outs["nudged-"]]
        _held(outs["card"][0], outs["cpu"][0], [n[0] for n in nudged], "q", held)
        for i, leaf in enumerate(("c", "h")):
            _held(outs["card"][1][i], outs["cpu"][1][i], [n[1][i] for n in nudged], f"carry {leaf}", held)
        _, _, m, o, a = outs["card"]
        ms = time_ms(lambda: m(o, a, m.initial_carry(100), sequence=True), iters=10, warmup=2)
    result = {"unroll": LSTM_Q_UNROLL, "ms_per_unroll": ms, **_worst(held)}
    print(f"phase 23 FCLSTMSAQFunction: {LSTM_Q_UNROLL} steps x 100 held (worst {result['worst']} "
          f"{result['diff']:.3e} <= {result['bound']:.3e}); {ms:.3f} ms per unroll ({card})")
    return result


def check_empirical_normalization(device, card: str) -> dict:
    """``EmpiricalNormalization`` over 17-wide batches of 2,048 (the PPO
    example's update interval), 50 updates with ``until`` 100,000: the 50th
    finds the count at 100,352 and leaves the state. The state,
    ``normalize`` (clipped) and ``inverse`` held; the inputs nudged on the
    CPU (the normalizer has no weights)."""
    from pfrl_tpu_torch.models import EmpiricalNormalization

    width, batch, updates, until = NORMALIZER
    rs = np.random.RandomState(26)
    scale, offset = np.exp(rs.normal(size=width)), rs.normal(size=width) * 5
    data = [(rs.normal(size=(batch, width)) * scale + offset).astype(np.float32) for _ in range(updates)]
    en = EmpiricalNormalization((width,), until=until)
    outs = {}
    for side, dev, f in (("card", device, 1.0), ("cpu", "cpu", 1.0),
                         ("nudged+", "cpu", SIBLING_NUDGES[0]), ("nudged-", "cpu", SIBLING_NUDGES[1])):
        state = en.init(dev)
        for b in data:
            state = en.update(state, torch.from_numpy(b * f).to(dev))
        x = torch.from_numpy(data[0] * 2 * f).to(dev)
        y = en.normalize(state, x)
        outs[side] = (state, y, en.inverse(state, y))
    card_state = outs["card"][0]
    if not float(card_state.count) == float(outs["cpu"][0].count) == (updates - 1) * batch:
        raise AssertionError(f"phase 23 EmpiricalNormalization: count {float(card_state.count)}, "
                             f"not {(updates - 1) * batch} (the 50th update frozen)")
    if not float(outs["card"][1].abs().max()) == en.clip_threshold:
        raise AssertionError("phase 23 EmpiricalNormalization: the clip was not reached")
    held = {}
    nudged = [outs["nudged+"], outs["nudged-"]]
    for field in ("mean", "var"):
        _held(getattr(card_state, field), getattr(outs["cpu"][0], field), [getattr(n[0], field) for n in nudged],
              field, held)
    _held(outs["card"][1], outs["cpu"][1], [n[1] for n in nudged], "normalize", held)
    _held(outs["card"][2], outs["cpu"][2], [n[2] for n in nudged], "inverse", held)
    b = torch.from_numpy(data[0]).to(device)
    ms = time_ms(lambda: en.update(en.init(device), b), iters=50, warmup=5)
    result = {"updates": updates, "batch": batch, "count": float(card_state.count), "ms_per_update": ms,
              **_worst(held)}
    print(f"phase 23 EmpiricalNormalization: {updates} updates of {batch} x {width} held (worst {result['worst']} "
          f"{result['diff']:.3e} <= {result['bound']:.3e}); {ms:.3f} ms per update ({card})")
    return result


def check_rmsprop_eps_inside_sqrt(device, card: str) -> dict:
    """``RMSpropEpsInsideSqrt`` at the Nature DQN settings (centered, alpha
    0.95, eps 1e-2, lr 2.5e-4), momentum 0 and 0.9: ``RMSPROP_STEPS`` steps
    over the Nature CNN's parameters (6 actions) from seeded gradients, on
    the card, on the CPU and on the CPU with the parameters and gradients
    nudged; the parameters and every tree of the state held, then the
    card's ms per step."""
    from pfrl_tpu_torch.experiments.atari_dqn_ale import build_model
    from pfrl_tpu_torch.optimizers import RMSpropEpsInsideSqrt

    model = build_model("nature", 6)
    model.reset_parameters(torch.Generator().manual_seed(25))
    base = [p.detach().clone() for p in model.parameters()]
    sides = (("card", device, 1.0), ("cpu", "cpu", 1.0),
             ("nudged+", "cpu", SIBLING_NUDGES[0]), ("nudged-", "cpu", SIBLING_NUDGES[1]))
    runs = {}
    for momentum in (0.0, 0.9):
        opt = RMSpropEpsInsideSqrt(2.5e-4, alpha=0.95, eps=1e-2, momentum=momentum, centered=True)
        for side, dev, f in sides:
            params = [(p * f).to(dev) for p in base]
            runs[(momentum, side)] = (opt, params, opt.init(params))
    factors = {side: f for side, _, f in sides}
    gen = torch.Generator().manual_seed(26)
    for _ in range(RMSPROP_STEPS):
        grads = [torch.randn(p.shape, generator=gen) * 0.01 for p in base]
        for (momentum, side), (opt, params, state) in runs.items():
            f = factors[side]
            opt.update(params, [(g * f).to(params[0].device) for g in grads], state)
    result = {"steps": RMSPROP_STEPS, "parameters": sum(p.numel() for p in base)}
    for momentum in (0.0, 0.9):
        held = {}
        on_card, on_cpu = runs[(momentum, "card")], runs[(momentum, "cpu")]
        nudged = [runs[(momentum, "nudged+")], runs[(momentum, "nudged-")]]
        for i, p in enumerate(on_cpu[1]):
            _held(on_card[1][i], p, [n[1][i] for n in nudged], f"param {i}", held)
        for field in ("square_avg", "momentum_buf", "grad_avg"):
            for i, t in enumerate(getattr(on_cpu[2], field)):
                _held(getattr(on_card[2], field)[i], t, [getattr(n[2], field)[i] for n in nudged], f"{field} {i}",
                      held)
        bitwise = all(h["diff"] == 0.0 for h in held.values())
        opt, params, state = on_card
        grads = [g.to(device) for g in (torch.randn(p.shape, generator=gen) * 0.01 for p in base)]
        ms = time_ms(lambda: opt.update(params, grads, state), iters=50, warmup=5)
        worst = _worst(held)
        result[f"momentum {momentum}"] = {"ms_per_step": ms, "bitwise": bitwise, **worst}
        how = "to the bit" if bitwise else f"worst {worst['worst']} {worst['diff']:.3e} <= {worst['bound']:.3e}"
        print(f"phase 23 RMSpropEpsInsideSqrt momentum {momentum}: {RMSPROP_STEPS} steps over "
              f"{result['parameters']:,} parameters held ({how}); {ms:.3f} ms/step ({card})")
    return result


def check_flax_checkpoint(device, card: str) -> dict:
    """The Nature-CNN DQN core of ``train_dqn_ale.py --sim`` (Adam) after
    ``CHECKPOINT_SCAN_STEPS`` scan steps of 64 lanes (its ring cut to 8,192
    slots, the replay start to 1,024): written with
    ``convert.save_flax_checkpoint`` in the JAX package's layout, read back
    through the port's reader and ``load_flax_checkpoint`` into a fresh
    core's state, every tensor equal to the bit; the file's bytes and the
    write and read seconds."""
    from pfrl_tpu_torch import convert
    from pfrl_tpu_torch.experiments.atari_dqn_ale import make_dqn_ale_runner
    from pfrl_tpu_torch.utils import flax_msgpack

    runner, _ = make_dqn_ale_runner(device=device, capacity=8_192, replay_start_size=1_024)
    state = runner.init(23)
    state, _ = runner.run_chunk(state, CHECKPOINT_SCAN_STEPS)
    ts = state.train_state
    if not ts.n_updates > 0:
        raise AssertionError("phase 23 checkpoint: the core took no update")
    path = os.path.join(_snapshot_dir("flax-checkpoint"), "train_state.msgpack")
    _, write_s = _timed(lambda: convert.save_flax_checkpoint(runner.core, ts, path))
    size = os.path.getsize(path)
    fresh, _ = make_dqn_ale_runner(device=device, capacity=1_024, replay_start_size=1_024)
    loaded, read_s = _timed(lambda: convert.load_flax_checkpoint(fresh.core, path, device=device))
    cmp = _compare(_plain(loaded), _plain(ts))
    with open(path, "rb") as f:
        again = flax_msgpack.msgpack_serialize(convert.state_to_flax(fresh.core, loaded)) == f.read()
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    if cmp["differing"] or not again:
        raise AssertionError(f"phase 23 checkpoint: {cmp}; written again the same: {again}")
    result = {"n_updates": ts.n_updates, "bytes": size, "write_s": write_s, "read_s": read_s, **cmp}
    print(f"phase 23 JAX-layout checkpoint of the Nature-CNN DQN after {ts.n_updates} updates: {size:,} bytes, "
          f"written in {write_s:.3f} s, read and converted in {read_s:.3f} s, {cmp['tensors']} tensors equal "
          f"to the bit ({card})")
    return result


ACTIVATION_BATCH = 32  # frames per forward of the non-ReLU torsos


def check_activations(device, card: str) -> dict:
    """A Nature torso with ``activation=torch.tanh`` and a dueling head
    (6 actions) with ``activation=F.elu``, fp32 without TF32, one forward on
    ``ACTIVATION_BATCH`` frames on the card and on the CPU from the same
    weights: within rtol 1e-4, floor 1e-5, as ``check_small_noisy_nature_q``
    holds the Nature network's Q-values (fp32 convolutions reduce in other
    orders)."""
    import torch.nn.functional as F

    from pfrl_tpu_torch._device import use_full_fp32
    from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN
    from pfrl_tpu_torch.q_functions.dueling_dqn import DuelingDQN

    use_full_fp32()
    x = torch.rand(ACTIVATION_BATCH, 84, 84, 4, generator=torch.Generator().manual_seed(27))
    differences = _Differences("activations")
    for name, make, read in (("nature-torso-tanh", lambda: LargeAtariCNN(activation=torch.tanh), lambda y: y),
                             ("dueling-dqn-elu", lambda: DuelingDQN(6, activation=F.elu), lambda y: y.q_values)):
        model = make()
        model.reset_parameters(torch.Generator().manual_seed(28))
        with torch.no_grad():
            cpu = read(model(x))
            on_card = read(copy.deepcopy(model).to(device)(x.to(device)))
        if name == "nature-torso-tanh" and not float(cpu.min()) < 0.0:
            raise AssertionError("phase 23 nature-torso-tanh: no negative feature; tanh not applied")
        differences.close(name, on_card, cpu, 1e-4, 1e-5)
    print(f"phase 23 non-ReLU activations, card vs CPU: {differences.summary()} ({card})")
    return {"max_abs_diff": differences.largest}


def run_siblings_and_checkpoints(card: str, device) -> dict:
    """Phase 23: the batch-norm critics, the LSTM critic, the normalizer,
    RMSpropEpsInsideSqrt, a JAX-layout checkpoint and the Atari torsos with
    a non-ReLU activation, each on the card against the CPU. No kernel of
    the port lies on them: the prefix-sample kernel's count is set to 0
    before and must read 0 after."""
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    prefix_sample.launches = 0
    record = {
        "bn-late-action-q-halfcheetah-100": check_bn_critic("late-action", device, card),
        "bn-q-halfcheetah-100": check_bn_critic("concat", device, card),
        "lstm-q-400-100": check_lstm_q(device, card),
        "empirical-normalization-17x2048": check_empirical_normalization(device, card),
        "rmsprop-eps-inside-sqrt-nature": check_rmsprop_eps_inside_sqrt(device, card),
        "flax-checkpoint-nature-dqn": check_flax_checkpoint(device, card),
        "activations": check_activations(device, card),
    }
    record["kernel_launches"] = prefix_sample.launches
    if record["kernel_launches"]:
        raise AssertionError(f"phase 23 launched the prefix-sample kernel {record['kernel_launches']} times")
    return record


# -------------------------------------------------------------------- phase 25
# The quick recipes phase 25 trains to their successful scores, each on a
# seed that solved in the builder's card runs of the whole recipe (PERF.md
# section 6): name -> seed. The second is also paused and resumed.
CURVE_QUICK = {"acer_abc": 0, "rppo_delayed_cue": 1}
CURVE_RESUMED = "rppo_delayed_cue"
# rainbow_cartpole through curve_loop, cut in depth only: the replay start
# 1,024 -> 256 and one evaluation interval 10,000 -> 2,048 transitions (64
# scan steps of 32 lanes; 57 of them with 8 batch-64 updates).
RAINBOW_CURVE_REPLAY_START = 256
RAINBOW_CURVE_EVAL_EVERY = 2_048


def _curve_rows(path) -> list:
    """A ``scores.txt``'s rows without ``elapsed``."""
    with open(path) as f:
        return [line.split("\t")[:2] + line.split("\t")[3:] for line in f.read().splitlines()[1:]]


def run_curves(card: str, device) -> dict:
    """Phase 25: the learning-curve entry point on the card."""
    from pfrl_tpu_torch.experiments import record_curves
    from pfrl_tpu_torch.ops import prefix_sample as ps

    out = {}
    with tempfile.TemporaryDirectory() as outdir:
        for name, seed in CURVE_QUICK.items():
            ps.prefix_sample.launches = 0
            r = record_curves.run(name, outdir, device, seed=seed)
            entry = os.path.join(outdir, "zoo", *r["zoo_entry"], "best", "train_state.msgpack")
            _raise_on_failed(f"curves {name}", {
                "reached its successful score": r["solved"] and not r["paused"],
                "within its steps cap": r["t"] <= r["steps"],
                "its best state in the zoo": os.path.exists(entry),
                "0 prefix-sample launches": ps.prefix_sample.launches == 0,
            })
            print(f"curves {name} (seed {seed}): solved at t = {r['t']}, episode {r['episodes']}, {r['rows']} "
                  f"evaluations, best {r['best']}, {r['seconds']:.2f} s")
            out[name] = {k: r[k] for k in ("t", "episodes", "rows", "best", "seconds")}
        whole = _curve_rows(os.path.join(outdir, CURVE_RESUMED, "scores.txt"))
        resumed_dir = os.path.join(outdir, "resumed")
        seed = CURVE_QUICK[CURVE_RESUMED]
        first = record_curves.run(CURVE_RESUMED, resumed_dir, device, seed=seed, pause=lambda n: n >= 1)
        kept = os.path.exists(os.path.join(resumed_dir, CURVE_RESUMED, ".resume", "runner_state.pt"))
        rest = record_curves.run(CURVE_RESUMED, resumed_dir, device, seed=seed)
        resumed = _curve_rows(os.path.join(resumed_dir, CURVE_RESUMED, "scores.txt"))
        _raise_on_failed(f"curves {CURVE_RESUMED} resumed", {
            "paused after its first evaluation, its snapshot kept": first["paused"] and first["rows"] == 1 and kept,
            "the resumed rows equal the uninterrupted run's but for elapsed": resumed == whole and rest["solved"],
        })
        print(f"curves {CURVE_RESUMED}: paused at t = {first['t']}, resumed to t = {rest['t']}; {len(resumed)} rows "
              "equal to the uninterrupted run's but for elapsed")
        out["resume"] = {"paused_at": first["t"], "rows": len(resumed), "equal": True}

        curve = record_curves.RUNS["rainbow_cartpole"](device)
        runner = curve.runner
        runner.config.replay_start_size = RAINBOW_CURVE_REPLAY_START
        states = []
        chunk = runner.run_chunk

        def run_chunk(state, n):
            states.append(chunk(state, n)[0])
            return states[-1], None

        runner.run_chunk = run_chunk
        cfg = runner.config
        updates = sum(cfg.updates_per_step for k in range(1, RAINBOW_CURVE_EVAL_EVERY // cfg.num_envs + 1)
                      if k * cfg.num_envs >= RAINBOW_CURVE_REPLAY_START)
        ps.prefix_sample.launches = 0
        t0 = time.perf_counter()
        r = record_curves.curve_loop(
            "rainbow_cartpole", runner, curve.evaluator, steps=RAINBOW_CURVE_EVAL_EVERY,
            eval_every=RAINBOW_CURVE_EVAL_EVERY, outdir=outdir, zoo_entry=curve.zoo_entry,
            successful_score=curve.successful_score, seed=curve.seed, min_rows=curve.min_rows)
        torch.cuda.synchronize()
        launches = ps.prefix_sample.launches
        seconds = time.perf_counter() - t0
        state = states[-1]
        leaves = state.replay_state.tree[runner.buffer.tree_capacity:]
        targets = torch.rand(64, generator=torch.Generator(device=device).manual_seed(25), device=device) * leaves.sum()
        err = int((ps.prefix_sample(leaves, targets) - ps.prefix_sample_reference(leaves, targets)).abs().max())
        with open(os.path.join(outdir, "rainbow_cartpole", "scores.txt")) as f:
            rows = f.read().splitlines()[1:]
        _raise_on_failed("curves rainbow_cartpole", {
            "one evaluation row written": r["rows"] == 1 and len(rows) == 1 and rows[0].startswith(
                f"{RAINBOW_CURVE_EVAL_EVERY}\t"),
            f"{updates} updates": state.train_state.n_updates == updates,
            "one prefix-sample launch per update": launches == updates,
            "C = 2^17 leaves": leaves.numel() == 131_072,
            "the kernel equals its plain version on the run's leaves": err == 0,
        })
        print(f"curves rainbow_cartpole (cut): t = {r['t']}, {updates} updates, {launches} prefix-sample launches, "
              f"eval mean {r['last']}, {seconds:.2f} s; the kernel on the run's leaves, B = 64: max |err| {err}")
        out["rainbow_cartpole"] = {"t": r["t"], "n_updates": updates, "kernel_launches": launches,
                                   "max_abs_err": err, "eval_mean": r["last"], "seconds": seconds}
    return out


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)  # a run that is cut still shows its last phase
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (HERE / "pfrl_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from pfrl_tpu_torch import resolve_device
    from pfrl_tpu_torch.replay.sum_tree import tree_capacity

    device = resolve_device()
    card, host_cpu = card_line(), host_cpu_model()
    print(f"card: {card}; host CPU: {host_cpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    record = {"card": card, "host_cpu": host_cpu, "phase_seconds": PHASE_TIMES}

    record["build"] = phase("build", build_kernels)
    record["frame_ops"] = phase("frame ops", check_frame_ops, card)
    kernel = phase(
        "kernel checks", check_prefix_sample, device, tree_capacity(100_000), 32, tree_capacity(1_000_000),
        tree_capacity(GRASPING_CAPACITY),
    )
    for shape in (kernel, kernel["large"], kernel["b64"], kernel["grasping"]):
        print_shape(shape, card)
    record["small_slices"] = {
        name: phase(f"small {name}", check_small_slice, name, build, steps, launches, device)
        for name, (build, steps, launches) in _small_configs().items()
    }
    for name, build in _small_actor_critic_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_actor_critic, name, build, 30, device)
    record["full_slice"] = phase("full per-dqn", run_full_slice, card)
    record["full_rainbow"] = phase("full rainbow", run_full_rainbow, card)
    record["full_uniform"] = {
        name: phase(f"full {name}", run_full_uniform, card, double)
        for name, double in (("dqn", False), ("double-dqn", True))
    }
    record["full_actor_critic"] = {
        name: phase(f"full {name}", run_full_mujoco, card, name) for name in ("sac", "td3")
    }
    record["full_actor_critic"]["ddpg"] = phase("full ddpg", run_full_ddpg, card)
    for name, build in _small_onpolicy_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_onpolicy, name, build, device)
    record["full_onpolicy"] = {
        name: phase(f"full {name}", run_full_onpolicy, card, name) for name in ONPOLICY_ITERATIONS
    }
    for name, (build, launches, param_atol) in _small_cartpole_configs().items():
        record["small_slices"][name] = phase(
            f"small {name}", check_small_slice, name, build, 11, launches, device, 1e-5, param_atol)
    record["small_slices"]["noisy-nature-q"] = phase("small noisy NatureQ", check_small_noisy_nature_q, device)
    record["full_cartpole"] = {
        name: phase(f"full {name}", run_full_cartpole, card, name) for name in _cartpole_recipes()
    }
    bf16 = torch.bfloat16
    for name, (build, steps, launches) in _small_bf16_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_bf16, name, build, steps, launches, device)
    record["small_slices"]["noisy-nature-q-bf16"] = phase(
        "small noisy NatureQ bf16", check_small_noisy_nature_q_bf16, device)
    record["bench_dqn_ab"] = phase("full dqn-atarisim-64 fp32/bf16 A/B", run_bench_dqn_ab, card)
    record["full_bf16"] = {
        "per-dqn-atarisim-64-bf16": phase("full per-dqn bf16", run_full_slice, card, bf16, BF16_PER_DQN_STEPS_TIMED),
        "sac-pendulum-16-bf16": phase("full sac-pendulum bf16", run_full_sac_pendulum_bf16, card),
        "ppo-mujocosim-8-bf16": phase("full ppo bf16", run_full_onpolicy, card, "ppo", bf16, BF16_PPO_ITERATIONS),
    }
    for name, (build, steps, onpolicy, ulp, floor, change_floor) in _small_recurrent_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_in_ulps, name, build, steps, onpolicy,
                                             ulp, floor, change_floor, device)
    record["full_recurrent"] = {"drqn-atarisim-32": phase("full drqn-atarisim-32", run_full_drqn_atarisim, card)}
    for name in RECURRENT_FULL_STEPS:
        record["full_recurrent"][name] = phase(f"full {name}", run_full_recurrent, card, name)
    for name, (build, steps, ulp, floor, change_floor) in _small_acer_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_in_ulps, name, build, steps, False,
                                             ulp, floor, change_floor, device, ACER_NUDGES)
    record["full_acer"] = {"acer-atarisim-16": phase("full acer-atarisim-16", run_full_acer_atarisim, card)}
    for name in ATARI_ONPOLICY_ITERATIONS:
        record["full_acer"][name] = phase(f"full {name}", run_full_atari_onpolicy, card, name)
    for name, (build, steps, launches) in _small_example_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_example_slice, name, build, steps, launches,
                                             device)
    record["small_slices"]["example cores"] = phase("small example cores", check_small_example_cores, device)
    record["small_slices"]["pipeline"] = phase("small pipeline", check_small_pipeline, device)
    record["full_examples"] = {name: phase(f"full {name}", run_full_example_atari, card, name)
                               for name in _example_configs()}
    record["full_examples"]["dqn-pipeline-288"] = phase("full dqn-pipeline-288", run_full_pipeline, card)
    for name, (make_agent, make_env, drive) in _small_host_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_shell, name, make_agent, make_env, drive,
                                             4, (), device)
    record["full_host"] = {"dqn-batch-ale-8": phase("full dqn-batch-ale-8", run_full_host_batch, card)}
    for name, (make_agent, make_env, drive, obs_size, action_shape) in _small_shell_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_shell, name, make_agent, make_env, drive,
                                             obs_size, action_shape, device)
    from pfrl_tpu_torch.experiments.profile_host import HOST_PATHS

    record["full_host_shells"] = {name: phase(f"full {name}", run_full_host_path, card, name) for name in HOST_PATHS
                                  if not HOST_PATHS[name].actors and name not in PHASE_19_HOST_PATHS
                                  and name not in PHASE_20_HOST_PATHS and name not in PHASE_22_HOST_PATHS}
    for name, cls_name, prioritized in (("actor-learner-dqn", "DQN", False),
                                        ("actor-learner-per-double-dqn", "DoubleDQN", True)):
        record["small_slices"][name] = phase(f"small {name}", check_small_actor_learner, name, cls_name, prioritized,
                                             device)
    record["full_actor_learner"] = {
        "dqn-actor-learner-ale-8": phase("full dqn-actor-learner-ale-8", run_full_actor_learner, card),
        "a3c-atarisim-16": phase("full a3c-atarisim-16", run_full_atari_onpolicy, card, "a3c-atarisim-16"),
    }
    record["persistence"] = phase("persistence", run_persistence, card, device)
    for name, (make_agent, make_env, drive, example, action_shape, extra) in _small_phase19_shells().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_shell, name, make_agent, make_env, drive,
                                             example, action_shape, device, extra)
    for name, build in _small_naf_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check_small_actor_critic, name, build, 30, device)
    record["full_phase19"] = {"grasping-dqn-batch-1": phase("full grasping-dqn-batch-1", run_full_grasping, card)}
    for name in _gym_recipes():
        record["full_phase19"][name] = phase(f"full {name}", run_full_cartpole, card, name)
    for name in PHASE_19_HOST_PATHS:
        record["full_phase19"][name] = phase(f"full {name}", run_full_host_path, card, name)
    for name, check in _small_phase20_configs().items():
        record["small_slices"][name] = phase(f"small {name}", check, device)
    record["mesh"] = phase("mesh", check_mesh_on_card, card, device)
    record["full_phase20"] = {
        "iqn-atarisim-64": phase("full iqn-atarisim-64", run_full_iqn_atari, card),
        "ppo-pendulum-device-64": phase("full ppo-pendulum-device-64", run_full_ppo_pendulum_device, card),
        "quickstart-dqn-cartpole-32": phase("full quickstart-dqn-cartpole-32", run_full_cartpole, card,
                                            "quickstart-dqn-cartpole-32"),
        **{name: phase(f"full {name}", run_full_host_path, card, name) for name in PHASE_20_HOST_PATHS},
        "dqn-multihost-ale-8": phase("full dqn-multihost-ale-8", run_full_multihost, card),
    }
    record["full_phase21"] = {
        "drqn-atarisim-32-mesh": phase("full drqn-atarisim-32-mesh", run_full_drqn_atarisim_mesh, card)}
    record["small_slices"]["dqn-ale-host-per"] = phase("small dqn-ale-host-per", check_small_dqn_ale, device)
    record["full_phase22"] = {"dqn-ale-host-per-1": phase("full dqn-ale-host-per-1", run_full_dqn_ale, card)}
    record["phase23"] = phase("siblings and JAX checkpoints", run_siblings_and_checkpoints, card, device)
    record["phase24"] = {
        "train_dqn.py --sim": phase("cli train_dqn.py --sim", cli_flagship, card),
        "train_rainbow.py": phase("cli train_rainbow.py", cli_rainbow, card, device),
        **phase("cli train_dqn_batch_ale.py", cli_batch_modes, card),
        **phase("cli device loops", cli_small_device_loops, card),
        "train_reinforce_gym.py and optuna": phase("cli reinforce and optuna", cli_host_and_objective, card),
    }
    record["phase25"] = phase("curves", run_curves, card, device)
    # Counted over each path that samples by priority, from 0 at its start;
    # every other path asserts a count of 0.
    kernel["launches_by_path"] = {
        "per-dqn": record["full_slice"]["kernel_launches"],
        "rainbow": record["full_rainbow"]["kernel_launches"],
        **{name: r["kernel_launches"] for name, r in record["full_onpolicy"].items()},
        **{name: r["kernel_launches"] for name, r in record["full_cartpole"].items()},
        "dqn-atarisim-64 fp32/bf16 A/B": record["bench_dqn_ab"]["kernel_launches"],
        **{name: r["kernel_launches"] for name, r in record["full_bf16"].items()},
        **{name: r["kernel_launches"] for name, r in record["full_recurrent"].items()},
        **{name: r["kernel_launches"] for name, r in record["full_acer"].items()},
        **{name: r["kernel_launches"] for name, r in record["full_examples"].items()},
        # The card's side of the PER shell's card-vs-CPU run: one launch per update.
        "host-per-dqn-cartpole": record["small_slices"]["host-per-dqn-cartpole"]["kernel_launches"],
        **{name: r["kernel_launches"] for name, r in record["full_host"].items()},
        # The card's side of the value shells' card-vs-CPU runs over PER.
        **{name: r["kernel_launches"] for name, r in record["small_slices"].items() if name.startswith("host-per-")
           and name != "host-per-dqn-cartpole"},
        **{name: r["kernel_launches"] for name, r in record["full_host_shells"].items()},
        # The card's side of the PER actor-learner run: one launch per update.
        "actor-learner-per-double-dqn": record["small_slices"]["actor-learner-per-double-dqn"]["kernel_launches"],
        **{name: r["kernel_launches"] for name, r in record["full_actor_learner"].items()},
        # The resumed PER run, C = 2^17: 3 scan steps of 16 updates, before (A) and after (B) the reload.
        "resume-A": record["persistence"]["resume"]["launches_a"],
        "resume-B": record["persistence"]["resume"]["launches_b"],
        # The card's side of the grasping shell's card-vs-CPU run (C = 2^14), then
        # grasping-dqn-batch-1 (C = 2^19): one launch per update; 0 on the other
        # paths of phase 19.
        "host-grasping-double-dqn": record["small_slices"]["host-grasping-double-dqn"]["kernel_launches"],
        **{name: r["kernel_launches"] for name, r in record["full_phase19"].items()},
        # Phase 20: the PER runs on the card without a mesh and with a mesh of one
        # NCCL rank (per-dqn 13 launches each, rainbow-cartpole at B = 64 18
        # each), then the full-width paths (0 each).
        "mesh per-dqn and rainbow-cartpole (both runs each)": record["mesh"]["kernel_launches"],
        **{name: r["kernel_launches"] for name, r in record["full_phase20"].items()},
        **{name: r["kernel_launches"] for name, r in record["full_phase21"].items()},
        # Phase 22: the card's side of run_ale's card-vs-CPU run over PER (C = 512,
        # one launch per update; 0 without --prioritized), then dqn-ale-host-per-1
        # at C = 2^20, one launch per update.
        "small dqn-ale-host-per": record["small_slices"]["dqn-ale-host-per"]["kernel_launches"],
        **{name: r["kernel_launches"] for name, r in record["full_phase22"].items()},
        # Phase 23: the sibling modules and the JAX-layout checkpoint (0).
        "siblings and JAX checkpoints": record["phase23"]["kernel_launches"],
        # Phase 24: the command lines; Rainbow's one launch per update at C = 2^17, B = 32, 0 on the others.
        **{f"cli {name}": r["kernel_launches"] for name, r in record["phase24"].items()},
        # Phase 25: the two quick recipes 0 each; Rainbow-CartPole through
        # curve_loop one launch per update at C = 2^17, B = 64.
        "curves rainbow_cartpole": record["phase25"]["rainbow_cartpole"]["kernel_launches"],
    }
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    record["kernels"] = [kernel]
    print(f"prefix_sample launches by full-width path: {json.dumps(kernel['launches_by_path'])}")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in record["kernels"]]}))
    print(f"host CPU: {host_cpu}; {sum(PHASE_TIMES.values()):.1f} s of phases")
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
