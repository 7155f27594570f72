// Native vectorized environment pool — the first-party EnvPool equivalent.
//
// The reference delegates C++ vectorized simulation to the external EnvPool
// package behind its EnvFactory seam (reference stoix/utils/env_factory.py:48-68);
// this translation unit provides the same capability natively: a batch of
// environments stepped in one C call with auto-reset and episode metrics,
// exposed through a minimal C ABI consumed via ctypes (stoix_tpu/envs/cvec.py).
//
// Games:
//   "CartPole-v1"       — 4-float observation, 2 actions (classic control;
//                         layout matches the Python classic suite so learned
//                         policies transfer across backends).
//   "Breakout-minatar"  — 10x10x4 binary-channel pixel observation, 3 actions
//                         (first-party reimplementation of the published
//                         MinAtar breakout game description: paddle, ball,
//                         trail and brick channels, row bounce/break rules).
//                         This is the Atari-class Sebulba workload: CNN-scale
//                         observations from a C++ pool.
//   "Asterix-minatar"   — 10x10x4 pixel observation, 5 actions: entities
//                         stream across rows, gold +1 / enemies kill, on a
//                         deterministic spawn schedule (lockstep-equal with
//                         the JAX twin).
//   "Breakout-atari"    — 84x84x4 frame-stacked grayscale pixel Breakout:
//                         the full-resolution EnvPool-Atari-shaped workload
//                         (same observation tensor as the reference's
//                         envpool configs) rendered and stepped natively.
//
// Build: g++ -O3 -march=native -shared -fPIC cvec.cpp -o libcvec.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Pool base: shared auto-reset stepping loop + episode metrics.
// ---------------------------------------------------------------------------

struct VecEnv {
  int num_envs;
  int max_steps;
  std::vector<int32_t> step_count;  // [num_envs]
  std::vector<float> ep_return;     // [num_envs]
  std::mt19937 rng;

  VecEnv(int n, int max_steps_, uint64_t seed)
      : num_envs(n), max_steps(max_steps_), step_count(n), ep_return(n),
        rng(seed) {}
  virtual ~VecEnv() = default;

  virtual int obs_dim() const = 0;                 // flattened length
  virtual void obs_shape(int32_t* out3) const = 0; // (a, b, c); (d, 1, 1) = vector
  virtual int num_actions() const = 0;
  // Continuous-control surface: action_dim 0 marks a discrete game; a
  // continuous game overrides action_dim/action_bounds/step_env_cont and the
  // pool is stepped through cvec_step_cont with float actions instead.
  virtual int action_dim() const { return 0; }
  virtual void action_bounds(float* lo, float* hi) const { *lo = -1.0f; *hi = 1.0f; }

  virtual void reset_env(int i) = 0;
  virtual void write_obs(int i, float* out) const = 0;
  // Advances env i; returns reward, sets *terminated.
  virtual float step_env(int i, int32_t action, bool* terminated) = 0;
  virtual float step_env_cont(int i, const float* action, bool* terminated) {
    (void)i; (void)action; (void)terminated;
    // Reaching this means a discrete game was stepped through the continuous
    // entry point: fail loudly instead of training on all-zero rewards.
    std::fprintf(stderr,
                 "cvec: step_env_cont called on a discrete game (dispatch "
                 "mismatch)\n");
    std::abort();
  }

  void reset_all(float* obs_out) {
    for (int i = 0; i < num_envs; ++i) {
      reset_env(i);
      step_count[i] = 0;
      ep_return[i] = 0.0f;
      write_obs(i, obs_out + static_cast<size_t>(i) * obs_dim());
    }
  }

  // Shared post-step bookkeeping for env i (auto-reset + episode metrics);
  // the discrete and continuous stepping loops differ only in how the
  // per-env reward is produced.
  void finish_env(int i, float reward, bool terminated, float* obs_out,
                  float* next_obs_out, float* reward_out, uint8_t* done_out,
                  uint8_t* trunc_out, float* ep_return_out,
                  int32_t* ep_length_out) {
    const size_t dim = obs_dim();
    step_count[i] += 1;
    ep_return[i] += reward;
    const bool truncated = !terminated && step_count[i] >= max_steps;

    reward_out[i] = reward;
    done_out[i] = terminated ? 1 : 0;
    trunc_out[i] = truncated ? 1 : 0;
    write_obs(i, next_obs_out + i * dim);
    ep_return_out[i] = ep_return[i];
    ep_length_out[i] = step_count[i];

    if (terminated || truncated) {
      reset_env(i);
      step_count[i] = 0;
      ep_return[i] = 0.0f;
      write_obs(i, obs_out + i * dim);
    } else {
      // No reset -> the post-step observation IS the successor observation;
      // copy it instead of re-rasterizing (for the 84x84x4 pixel game
      // write_obs is a 28k-float strided transpose — the pool's hot path).
      std::memcpy(obs_out + i * dim, next_obs_out + i * dim,
                  dim * sizeof(float));
    }
  }

  // One synchronous step for every env with auto-reset. Outputs:
  //   obs_out:      post-(auto)reset observation    [num_envs, obs_dim]
  //   next_obs_out: TRUE successor observation      [num_envs, obs_dim]
  //   reward_out / done_out / trunc_out             [num_envs]
  //   ep_return_out / ep_length_out: totals at episode end (else running)
  void step(const int32_t* actions, float* obs_out, float* next_obs_out,
            float* reward_out, uint8_t* done_out, uint8_t* trunc_out,
            float* ep_return_out, int32_t* ep_length_out) {
    for (int i = 0; i < num_envs; ++i) {
      bool terminated = false;
      const float reward = step_env(i, actions[i], &terminated);
      finish_env(i, reward, terminated, obs_out, next_obs_out, reward_out,
                 done_out, trunc_out, ep_return_out, ep_length_out);
    }
  }

  // Continuous twin of step(): actions are [num_envs, action_dim] floats.
  void step_cont(const float* actions, float* obs_out, float* next_obs_out,
                 float* reward_out, uint8_t* done_out, uint8_t* trunc_out,
                 float* ep_return_out, int32_t* ep_length_out) {
    const int adim = action_dim();
    for (int i = 0; i < num_envs; ++i) {
      bool terminated = false;
      const float reward =
          step_env_cont(i, actions + static_cast<size_t>(i) * adim, &terminated);
      finish_env(i, reward, terminated, obs_out, next_obs_out, reward_out,
                 done_out, trunc_out, ep_return_out, ep_length_out);
    }
  }
};

// ---------------------------------------------------------------------------
// CartPole-v1
// ---------------------------------------------------------------------------

constexpr float kGravity = 9.8f;
constexpr float kMassCart = 1.0f;
constexpr float kMassPole = 0.1f;
constexpr float kTotalMass = kMassCart + kMassPole;
constexpr float kLength = 0.5f;
constexpr float kPoleMassLength = kMassPole * kLength;
constexpr float kForceMag = 10.0f;
constexpr float kTau = 0.02f;
constexpr float kThetaThreshold = 12.0f * 2.0f * M_PI / 360.0f;
constexpr float kXThreshold = 2.4f;

struct CartPoleVec : VecEnv {
  std::vector<float> state;  // [num_envs, 4]

  CartPoleVec(int n, int max_steps_, uint64_t seed)
      : VecEnv(n, max_steps_, seed), state(static_cast<size_t>(n) * 4) {}

  int obs_dim() const override { return 4; }
  void obs_shape(int32_t* out3) const override { out3[0] = 4; out3[1] = 1; out3[2] = 1; }
  int num_actions() const override { return 2; }

  void reset_env(int i) override {
    std::uniform_real_distribution<float> dist(-0.05f, 0.05f);
    for (int j = 0; j < 4; ++j) state[i * 4 + j] = dist(rng);
  }

  void write_obs(int i, float* out) const override {
    std::memcpy(out, &state[i * 4], 4 * sizeof(float));
  }

  float step_env(int i, int32_t action, bool* terminated) override {
    float* s = &state[i * 4];
    float x = s[0], x_dot = s[1], theta = s[2], theta_dot = s[3];
    const float force = action == 1 ? kForceMag : -kForceMag;
    const float costheta = std::cos(theta), sintheta = std::sin(theta);
    const float temp =
        (force + kPoleMassLength * theta_dot * theta_dot * sintheta) /
        kTotalMass;
    const float thetaacc =
        (kGravity * sintheta - costheta * temp) /
        (kLength * (4.0f / 3.0f - kMassPole * costheta * costheta / kTotalMass));
    const float xacc = temp - kPoleMassLength * thetaacc * costheta / kTotalMass;
    x += kTau * x_dot;
    x_dot += kTau * xacc;
    theta += kTau * theta_dot;
    theta_dot += kTau * thetaacc;
    s[0] = x; s[1] = x_dot; s[2] = theta; s[3] = theta_dot;
    *terminated =
        std::fabs(x) > kXThreshold || std::fabs(theta) > kThetaThreshold;
    return 1.0f;
  }
};

// ---------------------------------------------------------------------------
// Breakout (MinAtar-class): 10x10 grid, 4 binary channels, 3 actions.
// ---------------------------------------------------------------------------

constexpr int kGrid = 10;
constexpr int kBrickRows = 3;     // rows 1..3 carry bricks
constexpr int kPaddleRow = kGrid - 1;
constexpr int kChannels = 4;      // paddle, ball, trail, brick

struct BreakoutVec : VecEnv {
  struct EnvState {
    int ball_r, ball_c;
    int dr, dc;       // ball direction, each in {-1, +1}
    int last_r, last_c;  // trail
    int paddle;
    uint8_t bricks[kBrickRows * kGrid];
  };
  std::vector<EnvState> envs;

  BreakoutVec(int n, int max_steps_, uint64_t seed)
      : VecEnv(n, max_steps_, seed), envs(n) {}

  int obs_dim() const override { return kGrid * kGrid * kChannels; }
  void obs_shape(int32_t* out3) const override {
    out3[0] = kGrid; out3[1] = kGrid; out3[2] = kChannels;
  }
  int num_actions() const override { return 3; }  // left, stay, right

  void reset_env(int i) override {
    EnvState& e = envs[i];
    std::uniform_int_distribution<int> dir(0, 1);
    // Serve from a top corner BELOW the brick band, moving down and inward
    // (MinAtar-style): the landing column is always reachable from the
    // paddle's start, and bricks are only reachable by earning paddle
    // bounces — the score measures control, not luck.
    e.ball_r = kBrickRows + 1;
    e.dr = 1;
    e.dc = dir(rng) ? 1 : -1;
    e.ball_c = e.dc == 1 ? 0 : kGrid - 1;
    e.last_r = e.ball_r;
    e.last_c = e.ball_c;
    e.paddle = kGrid / 2;
    std::fill(e.bricks, e.bricks + kBrickRows * kGrid, uint8_t{1});
  }

  void write_obs(int i, float* out) const override {
    const EnvState& e = envs[i];
    std::memset(out, 0, sizeof(float) * obs_dim());
    auto at = [&](int r, int c, int ch) -> float& {
      return out[(r * kGrid + c) * kChannels + ch];
    };
    at(kPaddleRow, e.paddle, 0) = 1.0f;
    at(e.ball_r, e.ball_c, 1) = 1.0f;
    at(e.last_r, e.last_c, 2) = 1.0f;
    for (int r = 0; r < kBrickRows; ++r)
      for (int c = 0; c < kGrid; ++c)
        if (e.bricks[r * kGrid + c]) at(r + 1, c, 3) = 1.0f;
  }

  float step_env(int i, int32_t action, bool* terminated) override {
    EnvState& e = envs[i];
    // Paddle: 0 = left, 1 = stay, 2 = right.
    e.paddle = std::clamp(e.paddle + (action - 1), 0, kGrid - 1);

    e.last_r = e.ball_r;
    e.last_c = e.ball_c;
    float reward = 0.0f;
    *terminated = false;

    // Side-wall bounce.
    int nc = e.ball_c + e.dc;
    if (nc < 0 || nc >= kGrid) {
      e.dc = -e.dc;
      nc = e.ball_c + e.dc;
    }
    int nr = e.ball_r + e.dr;
    // Ceiling bounce.
    if (nr < 0) {
      e.dr = 1;
      nr = e.ball_r + e.dr;
    }
    // Brick hit: break it, reflect vertically, score.
    if (nr >= 1 && nr <= kBrickRows && e.bricks[(nr - 1) * kGrid + nc]) {
      e.bricks[(nr - 1) * kGrid + nc] = 0;
      reward = 1.0f;
      e.dr = -e.dr;
      nr = e.ball_r;  // bounce back to the incoming row
      // All bricks cleared -> fresh wall (play continues).
      bool any = false;
      for (int b = 0; b < kBrickRows * kGrid; ++b) any |= (envs[i].bricks[b] != 0);
      if (!any) std::fill(e.bricks, e.bricks + kBrickRows * kGrid, uint8_t{1});
    } else if (nr == kPaddleRow) {
      if (nc == e.paddle) {
        e.dr = -1;
        nr = e.ball_r;  // paddle bounce
      } else {
        *terminated = true;  // ball lost
      }
    }
    e.ball_r = nr;
    e.ball_c = nc;
    return reward;
  }
};

// ---------------------------------------------------------------------------
// Asterix (MinAtar-class): 10x10 grid, 4 channels, 5 actions.
//
// Entities stream across rows 1..8 (one slot per row); gold scores +1 on
// contact, enemies kill. The spawn schedule is DETERMINISTIC (slot/direction/
// kind derived from a running counter) so the pure-JAX twin in
// stoix_tpu/envs/minatar.py stays bit-identical under lockstep — game variety
// comes from the entity pattern interacting with the agent's movement, not
// from per-step RNG.
// ---------------------------------------------------------------------------

constexpr int kAsterixSlots = 8;      // rows 1..8
constexpr int kSpawnPeriod = 5;       // spawn attempt every 5 steps
constexpr int kMovePeriod = 2;        // entities advance every 2 steps

struct AsterixVec : VecEnv {
  struct EnvState {
    int player_r, player_c;
    uint8_t active[kAsterixSlots];
    int col[kAsterixSlots];
    int dir[kAsterixSlots];       // -1 or +1
    uint8_t gold[kAsterixSlots];
    int spawn_count;
    int t;
  };
  std::vector<EnvState> envs;

  AsterixVec(int n, int max_steps_, uint64_t seed)
      : VecEnv(n, max_steps_, seed), envs(n) {}

  int obs_dim() const override { return kGrid * kGrid * 4; }
  void obs_shape(int32_t* out3) const override {
    out3[0] = kGrid; out3[1] = kGrid; out3[2] = 4;
  }
  int num_actions() const override { return 5; }  // stay, left, up, right, down

  void reset_env(int i) override {
    EnvState& e = envs[i];
    e.player_r = kGrid / 2;
    e.player_c = kGrid / 2;
    std::fill(e.active, e.active + kAsterixSlots, uint8_t{0});
    std::fill(e.col, e.col + kAsterixSlots, 0);
    std::fill(e.dir, e.dir + kAsterixSlots, 1);
    std::fill(e.gold, e.gold + kAsterixSlots, uint8_t{0});
    e.spawn_count = 0;
    e.t = 0;
  }

  void write_obs(int i, float* out) const override {
    const EnvState& e = envs[i];
    std::memset(out, 0, sizeof(float) * obs_dim());
    auto at = [&](int r, int c, int ch) -> float& {
      return out[(r * kGrid + c) * 4 + ch];
    };
    at(e.player_r, e.player_c, 0) = 1.0f;
    for (int s = 0; s < kAsterixSlots; ++s) {
      if (!e.active[s]) continue;
      const int r = s + 1;
      at(r, e.col[s], e.gold[s] ? 2 : 1) = 1.0f;
      if (e.dir[s] > 0) at(r, e.col[s], 3) = 1.0f;
    }
  }

  float step_env(int i, int32_t action, bool* terminated) override {
    EnvState& e = envs[i];
    float reward = 0.0f;
    *terminated = false;

    // Player move: 0 stay, 1 left, 2 up, 3 right, 4 down (stays on rows 1..8
    // only by bounds, walls clamp).
    const int drs[5] = {0, 0, -1, 0, 1};
    const int dcs[5] = {0, -1, 0, 1, 0};
    e.player_r = std::clamp(e.player_r + drs[action], 0, kGrid - 1);
    e.player_c = std::clamp(e.player_c + dcs[action], 0, kGrid - 1);

    auto collide = [&]() {
      for (int s = 0; s < kAsterixSlots; ++s) {
        if (!e.active[s]) continue;
        if (e.player_r == s + 1 && e.player_c == e.col[s]) {
          if (e.gold[s]) {
            reward += 1.0f;
            e.active[s] = 0;
          } else {
            *terminated = true;
          }
        }
      }
    };
    collide();  // player stepped onto an entity

    // Entity movement every kMovePeriod steps.
    if (e.t % kMovePeriod == 0) {
      for (int s = 0; s < kAsterixSlots; ++s) {
        if (!e.active[s]) continue;
        e.col[s] += e.dir[s];
        if (e.col[s] < 0 || e.col[s] >= kGrid) e.active[s] = 0;
      }
      collide();  // entity moved onto the player
    }

    // Deterministic spawn schedule.
    if (e.t % kSpawnPeriod == 0) {
      const int s = e.spawn_count % kAsterixSlots;
      if (!e.active[s]) {
        e.active[s] = 1;
        e.dir[s] = ((e.spawn_count / kAsterixSlots + s) % 2 == 0) ? 1 : -1;
        e.col[s] = e.dir[s] > 0 ? 0 : kGrid - 1;
        e.gold[s] = (e.spawn_count % 3 == 0) ? 1 : 0;
        collide();  // spawned under the player
      }
      e.spawn_count += 1;
    }
    e.t += 1;
    return reward;
  }
};

// ---------------------------------------------------------------------------
// Freeway (MinAtar-class): cross 8 lanes of traffic, +1 per crossing.
//
// Fully deterministic (lockstep-equal with the JAX twin): lane s has fixed
// direction (+1 if s even) and fixed period 1 + (s % 3); collisions send the
// chicken back to the start; no termination — episodes are time-limited.
// Channels: 0 player, 1 car, 2 car-moving-right, 3 fast-car. Actions:
// 0 stay, 1 up, 2 down.
// ---------------------------------------------------------------------------

struct FreewayVec : VecEnv {
  struct EnvState {
    int player_r, player_c;
    int car_col[8];
    int t;
  };
  std::vector<EnvState> envs;

  FreewayVec(int n, int max_steps_, uint64_t seed)
      : VecEnv(n, max_steps_, seed), envs(n) {}

  int obs_dim() const override { return kGrid * kGrid * kChannels; }
  void obs_shape(int32_t* out3) const override {
    out3[0] = kGrid; out3[1] = kGrid; out3[2] = kChannels;
  }
  int num_actions() const override { return 3; }

  static int lane_dir(int s) { return (s % 2 == 0) ? 1 : -1; }
  static int lane_period(int s) { return 1 + (s % 3); }

  void reset_env(int i) override {
    EnvState& e = envs[i];
    e.player_r = kGrid - 1;
    e.player_c = kGrid / 2;
    for (int s = 0; s < 8; ++s) e.car_col[s] = (3 * s + 1) % kGrid;
    e.t = 0;
  }

  void write_obs(int i, float* out) const override {
    const EnvState& e = envs[i];
    std::memset(out, 0, sizeof(float) * obs_dim());
    auto at = [&](int r, int c, int ch) -> float& {
      return out[(r * kGrid + c) * kChannels + ch];
    };
    at(e.player_r, e.player_c, 0) = 1.0f;
    for (int s = 0; s < 8; ++s) {
      at(s + 1, e.car_col[s], 1) = 1.0f;
      if (lane_dir(s) > 0) at(s + 1, e.car_col[s], 2) = 1.0f;
      if (lane_period(s) == 1) at(s + 1, e.car_col[s], 3) = 1.0f;
    }
  }

  float step_env(int i, int32_t action, bool* terminated) override {
    EnvState& e = envs[i];
    *terminated = false;
    const int dr = action == 1 ? -1 : (action == 2 ? 1 : 0);
    e.player_r = std::clamp(e.player_r + dr, 0, kGrid - 1);

    for (int s = 0; s < 8; ++s)
      if (e.t % lane_period(s) == 0)
        e.car_col[s] = (e.car_col[s] + lane_dir(s) + kGrid) % kGrid;

    bool hit = false;
    for (int s = 0; s < 8; ++s)
      hit |= (e.player_r == s + 1 && e.player_c == e.car_col[s]);
    if (hit) {
      e.player_r = kGrid - 1;
      e.player_c = kGrid / 2;
    }

    float reward = 0.0f;
    if (e.player_r == 0) {
      reward = 1.0f;
      e.player_r = kGrid - 1;
      e.player_c = kGrid / 2;
    }
    e.t += 1;
    return reward;
  }
};

// ---------------------------------------------------------------------------
// Space Invaders (MinAtar-class): shoot the marching 4x6 alien block.
//
// Fully deterministic (lockstep-equal with the JAX twin): the block marches
// every 4 steps (drop + reverse at the walls); every 6 steps the lowest
// alien in a cycling column fires; one friendly and one enemy bullet in
// flight. +1 per alien; being shot or invaded terminates. Channels:
// 0 player, 1 alien, 2 friendly bullet, 3 enemy bullet. Actions: 0 stay,
// 1 left, 2 right, 3 fire.
// ---------------------------------------------------------------------------

constexpr int kSiRows = 4;
constexpr int kSiCols = 6;
constexpr int kSiAlienPeriod = 4;
constexpr int kSiShootPeriod = 6;

struct SpaceInvadersVec : VecEnv {
  struct EnvState {
    int player_c;
    uint8_t alive[kSiRows * kSiCols];
    int alien_r0, alien_c0, adir;
    int fb_r, fb_c, fb_live;
    int eb_r, eb_c, eb_live;
    int shot_count;
    int t;
  };
  std::vector<EnvState> envs;

  SpaceInvadersVec(int n, int max_steps_, uint64_t seed)
      : VecEnv(n, max_steps_, seed), envs(n) {}

  int obs_dim() const override { return kGrid * kGrid * kChannels; }
  void obs_shape(int32_t* out3) const override {
    out3[0] = kGrid; out3[1] = kGrid; out3[2] = kChannels;
  }
  int num_actions() const override { return 4; }

  static void fresh_wave(EnvState& e) {
    std::fill(e.alive, e.alive + kSiRows * kSiCols, uint8_t{1});
    e.alien_r0 = 1;
    e.alien_c0 = 2;
    e.adir = 1;
  }

  void reset_env(int i) override {
    EnvState& e = envs[i];
    e.player_c = kGrid / 2;
    fresh_wave(e);
    e.fb_r = e.fb_c = e.fb_live = 0;
    e.eb_r = e.eb_c = e.eb_live = 0;
    e.shot_count = 0;
    e.t = 0;
  }

  void write_obs(int i, float* out) const override {
    const EnvState& e = envs[i];
    std::memset(out, 0, sizeof(float) * obs_dim());
    auto at = [&](int r, int c, int ch) -> float& {
      return out[(r * kGrid + c) * kChannels + ch];
    };
    at(kGrid - 1, e.player_c, 0) = 1.0f;
    for (int r = 0; r < kSiRows; ++r)
      for (int c = 0; c < kSiCols; ++c)
        if (e.alive[r * kSiCols + c]) {
          const int rr = std::clamp(e.alien_r0 + r, 0, kGrid - 1);
          const int cc = std::clamp(e.alien_c0 + c, 0, kGrid - 1);
          at(rr, cc, 1) = 1.0f;
        }
    if (e.fb_live)
      at(std::clamp(e.fb_r, 0, kGrid - 1), std::clamp(e.fb_c, 0, kGrid - 1), 2) = 1.0f;
    if (e.eb_live)
      at(std::clamp(e.eb_r, 0, kGrid - 1), std::clamp(e.eb_c, 0, kGrid - 1), 3) = 1.0f;
  }

  float step_env(int i, int32_t action, bool* terminated) override {
    EnvState& e = envs[i];
    *terminated = false;
    float reward = 0.0f;

    // Player move / fire.
    e.player_c = std::clamp(
        e.player_c + (action == 1 ? -1 : (action == 2 ? 1 : 0)), 0, kGrid - 1);
    if (action == 3 && !e.fb_live) {
      e.fb_live = 1;
      e.fb_r = kGrid - 2;
      e.fb_c = e.player_c;
    }

    // Friendly bullet: up one, die off-top, alien hit check.
    if (e.fb_live) {
      e.fb_r -= 1;
      if (e.fb_r < 0) e.fb_live = 0;
    }
    if (e.fb_live) {
      const int rel_r = e.fb_r - e.alien_r0;
      const int rel_c = e.fb_c - e.alien_c0;
      if (rel_r >= 0 && rel_r < kSiRows && rel_c >= 0 && rel_c < kSiCols &&
          e.alive[rel_r * kSiCols + rel_c]) {
        e.alive[rel_r * kSiCols + rel_c] = 0;
        reward += 1.0f;
        e.fb_live = 0;
      }
    }

    // Enemy bullet: down one, die off-bottom, player hit terminates.
    if (e.eb_live) {
      e.eb_r += 1;
      if (e.eb_r >= kGrid) e.eb_live = 0;
    }
    if (e.eb_live && e.eb_r == kGrid - 1 && e.eb_c == e.player_c)
      *terminated = true;

    // Alien march: sideways, or drop + reverse at the walls.
    if (e.t % kSiAlienPeriod == 0) {
      const int nc0 = e.alien_c0 + e.adir;
      if (nc0 < 0 || nc0 + kSiCols > kGrid) {
        e.alien_r0 += 1;
        e.adir = -e.adir;
      } else {
        e.alien_c0 = nc0;
      }
    }
    int lowest = -1;
    for (int r = 0; r < kSiRows; ++r)
      for (int c = 0; c < kSiCols; ++c)
        if (e.alive[r * kSiCols + c]) lowest = std::max(lowest, r);
    if (lowest >= 0 && e.alien_r0 + lowest >= kGrid - 1) *terminated = true;

    // Enemy shot from the lowest living alien in a cycling column.
    if (e.t % kSiShootPeriod == 0) {
      if (!e.eb_live) {
        const int sc = e.shot_count % kSiCols;
        int low_in_col = -1;
        for (int r = 0; r < kSiRows; ++r)
          if (e.alive[r * kSiCols + sc]) low_in_col = std::max(low_in_col, r);
        if (low_in_col >= 0) {
          e.eb_live = 1;
          e.eb_r = e.alien_r0 + low_in_col + 1;
          e.eb_c = e.alien_c0 + sc;
        }
      }
      e.shot_count += 1;
    }

    // Wave cleared -> fresh block.
    bool any = false;
    for (int b = 0; b < kSiRows * kSiCols; ++b) any |= (e.alive[b] != 0);
    if (!any) fresh_wave(e);

    e.t += 1;
    return reward;
  }
};

// ---------------------------------------------------------------------------
// Pendulum-v1 — the continuous-control game (gym classic-control dynamics,
// matching the pure-JAX twin envs/classic.py Pendulum exactly: g=10, m=l=1,
// dt=0.05, torque in [-2, 2], never terminates, 200-step truncation).
// ---------------------------------------------------------------------------

struct PendulumVec : VecEnv {
  std::vector<float> state;  // [num_envs, 2]: theta, theta_dot

  static constexpr float kMaxSpeed = 8.0f;
  static constexpr float kMaxTorque = 2.0f;
  static constexpr float kDt = 0.05f;
  static constexpr float kG = 10.0f;

  PendulumVec(int n, int max_steps_, uint64_t seed)
      : VecEnv(n, max_steps_, seed), state(static_cast<size_t>(n) * 2) {}

  int obs_dim() const override { return 3; }
  void obs_shape(int32_t* out3) const override { out3[0] = 3; out3[1] = 1; out3[2] = 1; }
  // For continuous games num_actions mirrors action_dim (mask width).
  int num_actions() const override { return 1; }
  int action_dim() const override { return 1; }
  void action_bounds(float* lo, float* hi) const override {
    *lo = -kMaxTorque;
    *hi = kMaxTorque;
  }

  void reset_env(int i) override {
    std::uniform_real_distribution<float> th(-static_cast<float>(M_PI),
                                             static_cast<float>(M_PI));
    std::uniform_real_distribution<float> thdot(-1.0f, 1.0f);
    state[i * 2] = th(rng);
    state[i * 2 + 1] = thdot(rng);
  }

  void write_obs(int i, float* out) const override {
    const float theta = state[i * 2], thdot = state[i * 2 + 1];
    out[0] = std::cos(theta);
    out[1] = std::sin(theta);
    out[2] = thdot;
  }

  float step_env(int, int32_t, bool*) override {
    // Continuous-only game stepped through the discrete entry point.
    std::fprintf(stderr,
                 "cvec: discrete step_env called on PendulumVec (dispatch "
                 "mismatch)\n");
    std::abort();
  }

  float step_env_cont(int i, const float* action, bool* terminated) override {
    float theta = state[i * 2], thdot = state[i * 2 + 1];
    const float u = std::fmax(-kMaxTorque, std::fmin(kMaxTorque, action[0]));
    // Normalize theta into [-pi, pi) with python-modulo semantics (the JAX
    // twin uses (theta + pi) % (2 pi) - pi; C++ fmod keeps the sign).
    float wrapped = std::fmod(theta + static_cast<float>(M_PI),
                              2.0f * static_cast<float>(M_PI));
    if (wrapped < 0.0f) wrapped += 2.0f * static_cast<float>(M_PI);
    const float angle_norm = wrapped - static_cast<float>(M_PI);
    const float cost =
        angle_norm * angle_norm + 0.1f * thdot * thdot + 0.001f * u * u;
    thdot += (3.0f * kG / 2.0f * std::sin(theta) + 3.0f * u) * kDt;
    thdot = std::fmax(-kMaxSpeed, std::fmin(kMaxSpeed, thdot));
    theta += thdot * kDt;
    state[i * 2] = theta;
    state[i * 2 + 1] = thdot;
    *terminated = false;
    return -cost;
  }
};

// ---------------------------------------------------------------------------
// Breakout-atari — full-resolution pixel Breakout: 84x84x4 frame-stacked
// grayscale observations, the exact tensor shape the reference's EnvPool
// Atari path trains on (reference stoix/wrappers/envpool.py:8-30 consumes
// EnvPool's (84, 84, stack) image obs; configs/env/envpool/*.yaml). Unlike
// the 10x10 MinAtar-class games above, this is a true pixel workload: the
// agent sees rendered frames (paddle/ball/brick sprites at distinct gray
// levels), not feature planes, and the CNN must learn from an 84x84x4
// stack exactly as it would from ALE frames. Game logic is an original
// pixel-physics breakout, not an ALE port:
//   - 84x84 playfield; paddle 12x2 at row 80, moves +/-3 px/step (3 actions).
//   - 2x2 ball at 2 px/step; direction set by paddle-hit offset (outer third
//     of the paddle sends the ball out at the steep +/-2 horizontal speed,
//     the center third at the shallow +/-1) — control depth comes from aiming.
//   - 6x14 brick wall (each brick 6x3 px, rows 18..35); +1 per brick, wall
//     refreshes when cleared; ball lost below the paddle ends the episode.
//   - Frame stack: ring buffer of the last 4 rendered frames, exposed
//     oldest->newest as channels (the envpool stacked-frame layout).
// ---------------------------------------------------------------------------

constexpr int kPix = 84;                  // frame height/width
constexpr int kStack = 4;                 // stacked frames = obs channels
constexpr int kPadW = 12, kPadH = 2;      // paddle sprite
constexpr int kPadRow = 80;               // paddle top row
constexpr int kPadSpeed = 3;              // px per action step
constexpr int kBallSz = 2;                // 2x2 ball sprite
constexpr int kBrickW = 6, kBrickH = 3;   // brick sprite
constexpr int kBrickCols = kPix / kBrickW;    // 14
constexpr int kBrickRowsPx = 6;               // brick rows
constexpr int kBrickTop = 18;                 // first brick row (px)

struct BreakoutPixelVec : VecEnv {
  struct EnvState {
    int ball_r, ball_c;   // top-left of the 2x2 ball sprite
    int dr, dc;           // velocity, px/step (dr in {-2,+2}, dc in {-2,-1,+1,+2})
    int paddle;           // leftmost column of the paddle
    int serves;           // episodes served — drives the DETERMINISTIC serve
    uint8_t bricks[kBrickRowsPx * kBrickCols];
    uint8_t frames[kStack][kPix * kPix];  // grayscale ring buffer
    int head;                             // index of the OLDEST frame
  };
  std::vector<EnvState> envs;

  BreakoutPixelVec(int n, int max_steps_, uint64_t seed)
      : VecEnv(n, max_steps_, seed), envs(n) {
    // Stagger the deterministic serve walk by env index so a fresh pool's
    // envs start decorrelated (adjacent k values land 37 columns apart).
    for (int i = 0; i < n; ++i) envs[i].serves = i;
  }

  int obs_dim() const override { return kPix * kPix * kStack; }
  void obs_shape(int32_t* out3) const override {
    out3[0] = kPix; out3[1] = kPix; out3[2] = kStack;
  }
  int num_actions() const override { return 3; }  // left, stay, right

  // Rasterize the current state into the newest slot of the frame ring.
  void render(EnvState& e) {
    uint8_t* f = e.frames[(e.head + kStack - 1) % kStack];
    std::memset(f, 0, kPix * kPix);
    // Brick wall: gray level graded by row so depth is visible to the CNN.
    for (int br = 0; br < kBrickRowsPx; ++br)
      for (int bc = 0; bc < kBrickCols; ++bc) {
        if (!e.bricks[br * kBrickCols + bc]) continue;
        const uint8_t shade = static_cast<uint8_t>(110 + 20 * br);
        const int r0 = kBrickTop + br * kBrickH, c0 = bc * kBrickW;
        for (int r = r0; r < r0 + kBrickH; ++r)
          // 1-px gutter on the right edge keeps bricks visually distinct.
          for (int c = c0; c < c0 + kBrickW - 1; ++c) f[r * kPix + c] = shade;
      }
    // Paddle.
    for (int r = kPadRow; r < kPadRow + kPadH; ++r)
      for (int c = e.paddle; c < e.paddle + kPadW; ++c) f[r * kPix + c] = 200;
    // Ball (drawn last, on top).
    for (int r = e.ball_r; r < e.ball_r + kBallSz; ++r)
      for (int c = e.ball_c; c < e.ball_c + kBallSz; ++c)
        if (r >= 0 && r < kPix && c >= 0 && c < kPix) f[r * kPix + c] = 255;
  }

  // Advance the ring and render into the freed slot.
  void push_frame(EnvState& e) {
    e.head = (e.head + 1) % kStack;
    render(e);
  }

  void reset_env(int i) override {
    EnvState& e = envs[i];
    // DETERMINISTIC serve schedule (Asterix precedent): column walks the
    // 67-wide serve range via a coprime stride, direction alternates. Keeps
    // the pure-JAX twin (envs/breakout_pixel.py) bit-identical under
    // lockstep with no shared RNG.
    const int k = e.serves;
    e.ball_r = kBrickTop + kBrickRowsPx * kBrickH + 4;  // below the wall
    e.ball_c = 8 + (k * 37) % (kPix - 16 - kBallSz + 1);
    e.dr = 2;                                           // serve downward
    e.dc = (k % 2 == 0) ? 1 : -1;
    e.serves = k + 1;
    e.paddle = (kPix - kPadW) / 2;
    std::fill(e.bricks, e.bricks + kBrickRowsPx * kBrickCols, uint8_t{1});
    e.head = 0;
    // Fill the whole stack with the serve frame (envpool resets the same way:
    // the first stacked observation repeats the initial frame).
    render(e);
    for (int s = 0; s < kStack - 1; ++s) push_frame(e);
  }

  void write_obs(int i, float* out) const override {
    const EnvState& e = envs[i];
    // HWC layout, channel = stack index oldest->newest, scaled to [0, 1].
    for (int s = 0; s < kStack; ++s) {
      const uint8_t* f = e.frames[(e.head + s) % kStack];
      for (int p = 0; p < kPix * kPix; ++p)
        out[p * kStack + s] = f[p] * (1.0f / 255.0f);
    }
  }

  float step_env(int i, int32_t action, bool* terminated) override {
    EnvState& e = envs[i];
    e.paddle = std::clamp(e.paddle + (action - 1) * kPadSpeed, 0, kPix - kPadW);

    float reward = 0.0f;
    *terminated = false;
    int nr = e.ball_r + e.dr;
    int nc = e.ball_c + e.dc;

    // Side walls.
    if (nc < 0) { nc = -nc; e.dc = -e.dc; }
    if (nc > kPix - kBallSz) { nc = 2 * (kPix - kBallSz) - nc; e.dc = -e.dc; }
    // Ceiling.
    if (nr < 0) { nr = -nr; e.dr = 2; }

    // Brick band: test the ball center cell against the brick grid.
    const int cr = nr + kBallSz / 2, cc = nc + kBallSz / 2;
    if (cr >= kBrickTop && cr < kBrickTop + kBrickRowsPx * kBrickH) {
      const int br = (cr - kBrickTop) / kBrickH;
      const int bc = std::min(cc / kBrickW, kBrickCols - 1);
      if (e.bricks[br * kBrickCols + bc]) {
        e.bricks[br * kBrickCols + bc] = 0;
        reward = 1.0f;
        e.dr = -e.dr;
        nr = e.ball_r;  // reflect back toward the incoming side
        bool any = false;
        for (int b = 0; b < kBrickRowsPx * kBrickCols; ++b)
          any |= (e.bricks[b] != 0);
        if (!any)
          std::fill(e.bricks, e.bricks + kBrickRowsPx * kBrickCols, uint8_t{1});
      }
    } else if (e.dr > 0 && nr + kBallSz > kPadRow && e.ball_r + kBallSz <= kPadRow) {
      // Crossing the paddle plane this step.
      if (cc >= e.paddle && cc < e.paddle + kPadW) {
        e.dr = -2;
        nr = kPadRow - kBallSz;
        // Aim by hit offset: outer thirds send the ball out steeply.
        const int off = cc - e.paddle;
        if (off < kPadW / 3) e.dc = -2;
        else if (off >= 2 * kPadW / 3) e.dc = 2;
        else e.dc = (e.dc >= 0) ? 1 : -1;
      }
    } else if (nr >= kPix - kBallSz) {
      *terminated = true;  // ball lost below the paddle
    }

    e.ball_r = nr;
    e.ball_c = nc;
    push_frame(e);
    return reward;
  }
};

VecEnv* make_game(const char* task, int num_envs, int max_steps, uint64_t seed) {
  const std::string name(task ? task : "");
  if (name == "Breakout-minatar")
    return new BreakoutVec(num_envs, max_steps, seed);
  if (name == "Breakout-atari")
    return new BreakoutPixelVec(num_envs, max_steps, seed);
  if (name == "Asterix-minatar")
    return new AsterixVec(num_envs, max_steps, seed);
  if (name == "Freeway-minatar")
    return new FreewayVec(num_envs, max_steps, seed);
  if (name == "SpaceInvaders-minatar")
    return new SpaceInvadersVec(num_envs, max_steps, seed);
  if (name == "Pendulum-v1")
    return new PendulumVec(num_envs, max_steps, seed);
  if (name == "CartPole-v1" || name.empty())
    return new CartPoleVec(num_envs, max_steps, seed);
  return nullptr;
}

}  // namespace

extern "C" {

void* cvec_create(const char* task, int num_envs, int max_steps, uint64_t seed) {
  return make_game(task, num_envs, max_steps, seed);
}

void cvec_reset(void* handle, float* obs_out) {
  static_cast<VecEnv*>(handle)->reset_all(obs_out);
}

void cvec_step(void* handle, const int32_t* actions, float* obs_out,
               float* next_obs_out, float* reward_out, uint8_t* done_out,
               uint8_t* trunc_out, float* ep_return_out, int32_t* ep_length_out) {
  static_cast<VecEnv*>(handle)->step(actions, obs_out, next_obs_out,
                                     reward_out, done_out, trunc_out,
                                     ep_return_out, ep_length_out);
}

int cvec_obs_dim(void* handle) { return static_cast<VecEnv*>(handle)->obs_dim(); }

void cvec_obs_shape(void* handle, int32_t* out3) {
  static_cast<VecEnv*>(handle)->obs_shape(out3);
}

int cvec_num_actions(void* handle) {
  return static_cast<VecEnv*>(handle)->num_actions();
}

int cvec_action_dim(void* handle) {
  return static_cast<VecEnv*>(handle)->action_dim();
}

void cvec_action_bounds(void* handle, float* lo, float* hi) {
  static_cast<VecEnv*>(handle)->action_bounds(lo, hi);
}

void cvec_step_cont(void* handle, const float* actions, float* obs_out,
                    float* next_obs_out, float* reward_out, uint8_t* done_out,
                    uint8_t* trunc_out, float* ep_return_out,
                    int32_t* ep_length_out) {
  static_cast<VecEnv*>(handle)->step_cont(actions, obs_out, next_obs_out,
                                          reward_out, done_out, trunc_out,
                                          ep_return_out, ep_length_out);
}

void cvec_destroy(void* handle) { delete static_cast<VecEnv*>(handle); }

}  // extern "C"
