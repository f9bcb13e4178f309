// Native vectorized grid engine behind the gym3 venv surface (the port's own
// copy of the JAX package's engine, the same source).
//
// The reference's environments are C++ Procgen forks driven through gym3,
// whose act/observe loops run in native code. This is the equivalent for the
// fake grid dynamics: batch `act` and batch `observe` (threaded RGB render) in
// C++, with the level layout a pure splitmix64 function of (seed, grid) shared
// bit-for-bit with the Python stub (envs/gym3_stub.py::place_entities) —
// parity-tested in tests/test_torch_envs.py. Save-state blobs stay in Python:
// the wrapper (envs/native_engine.py) reads the core state via grid_get_core
// and encodes it with the real state codec, so the wire format is identical to
// FakeProcgenGym3's.
//
// Build: envs/native_engine.py::build_native runs g++ at first use into
// build/arp_tpu_torch/native/ (C ABI, ctypes).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t &state, uint64_t &out) {
  state += 0x9E3779B97F4A7C15ull;
  uint64_t z = state;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  out = z ^ (z >> 31);
  return out;
}

struct Placement {
  int64_t ay, ax, gy, gx;
};

// Must match envs/gym3_stub.py::place_entities exactly.
Placement place_entities(uint64_t seed, int64_t grid) {
  uint64_t s = seed, v;
  Placement p;
  splitmix64(s, v);
  p.ay = (int64_t)(v % (uint64_t)grid);
  splitmix64(s, v);
  p.ax = (int64_t)(v % (uint64_t)grid);
  for (;;) {
    splitmix64(s, v);
    p.gy = (int64_t)(v % (uint64_t)grid);
    splitmix64(s, v);
    p.gx = (int64_t)(v % (uint64_t)grid);
    if (p.gy != p.ay || p.gx != p.ax) return p;
  }
}

struct GridEnv {
  int num, grid, resolution;
  int64_t episode_length, num_levels, start_level;
  int64_t episode_counter;  // advances across auto-resets, like the stub
  std::vector<int64_t> ay, ax, gy, gx, t, seed;
  std::vector<float> rew;
  std::vector<uint8_t> first;

  void new_episode(int i) {
    int64_t s = start_level + (episode_counter % num_levels);
    episode_counter += 1;
    Placement p = place_entities((uint64_t)s, grid);
    ay[i] = p.ay;
    ax[i] = p.ax;
    gy[i] = p.gy;
    gx[i] = p.gx;
    seed[i] = s;
    t[i] = 0;
    first[i] = 1;
  }

  void act(const int32_t *actions) {
    for (int i = 0; i < num; ++i) {
      int a = actions[i];
      int64_t dy = 0, dx = 0;
      switch (a) {  // matches gym3_stub._ACTION_DELTAS; others are no-ops
        case 0: dx = -1; break;
        case 1: dx = 1; break;
        case 2: dy = -1; break;
        case 3: dy = 1; break;
        default: break;
      }
      ay[i] = std::min<int64_t>(std::max<int64_t>(ay[i] + dy, 0), grid - 1);
      ax[i] = std::min<int64_t>(std::max<int64_t>(ax[i] + dx, 0), grid - 1);
      t[i] += 1;
      bool terminal = (ay[i] == gy[i]) && (ax[i] == gx[i]);
      rew[i] = terminal ? 10.0f : 0.0f;
      first[i] = 0;
      if (terminal || t[i] >= episode_length) new_episode(i);
    }
  }

  void render_one(int i, uint8_t *rgb) const {
    const int size = resolution;
    const int cell = std::max(1, size / grid);
    std::memset(rgb, 30, (size_t)size * size * 3);
    auto paint = [&](int64_t cy, int64_t cx, uint8_t r, uint8_t g, uint8_t b) {
      int y0 = (int)(cy * cell), x0 = (int)(cx * cell);
      int y1 = std::min(y0 + cell, size), x1 = std::min(x0 + cell, size);
      for (int y = y0; y < y1; ++y) {
        uint8_t *row = rgb + ((size_t)y * size + x0) * 3;
        for (int x = x0; x < x1; ++x) {
          *row++ = r;
          *row++ = g;
          *row++ = b;
        }
      }
    };
    paint(gy[i], gx[i], 255, 215, 0);   // goal
    paint(ay[i], ax[i], 200, 30, 30);   // agent
  }

  void observe(float *out_rew, uint8_t *out_first, uint8_t *rgb) const {
    std::memcpy(out_rew, rew.data(), sizeof(float) * num);
    std::memcpy(out_first, first.data(), num);
    const size_t frame = (size_t)resolution * resolution * 3;
    unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
    nthreads = std::min<unsigned>(nthreads, (unsigned)num);
    if (nthreads <= 1 || num < 4) {
      for (int i = 0; i < num; ++i) render_one(i, rgb + frame * i);
      return;
    }
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (unsigned w = 0; w < nthreads; ++w) {
      threads.emplace_back([this, w, nthreads, rgb, frame]() {
        for (int i = (int)w; i < num; i += (int)nthreads)
          render_one(i, rgb + frame * i);
      });
    }
    for (auto &th : threads) th.join();
  }
};

}  // namespace

extern "C" {

void *grid_create(int num, int grid, int resolution, int64_t episode_length,
                  int64_t num_levels, int64_t start_level, int64_t rand_seed) {
  if (num <= 0 || grid <= 0 || resolution <= 0) return nullptr;
  auto *env = new GridEnv();
  env->num = num;
  env->grid = grid;
  env->resolution = resolution;
  env->episode_length = episode_length;
  env->num_levels = std::max<int64_t>(1, num_levels);
  env->start_level = start_level;
  env->episode_counter = rand_seed;
  env->ay.assign(num, 0);
  env->ax.assign(num, 0);
  env->gy.assign(num, 0);
  env->gx.assign(num, 0);
  env->t.assign(num, 0);
  env->seed.assign(num, 0);
  env->rew.assign(num, 0.0f);
  env->first.assign(num, 1);
  for (int i = 0; i < num; ++i) env->new_episode(i);
  return env;
}

void grid_destroy(void *h) { delete static_cast<GridEnv *>(h); }

void grid_act(void *h, const int32_t *actions) {
  static_cast<GridEnv *>(h)->act(actions);
}

void grid_observe(void *h, float *rew, uint8_t *first, uint8_t *rgb) {
  static_cast<GridEnv *>(h)->observe(rew, first, rgb);
}

// Per-env core state as int64[6]: ay, ax, gy, gx, t, seed (row-major over envs).
void grid_get_core(void *h, int64_t *out) {
  auto *env = static_cast<GridEnv *>(h);
  for (int i = 0; i < env->num; ++i) {
    int64_t *row = out + (size_t)i * 6;
    row[0] = env->ay[i];
    row[1] = env->ax[i];
    row[2] = env->gy[i];
    row[3] = env->gx[i];
    row[4] = env->t[i];
    row[5] = env->seed[i];
  }
}

// Restore from int64[6] rows; matches FakeProcgenGym3.set_state semantics
// (first=False, rew=0 after a restore).
void grid_set_core(void *h, const int64_t *in) {
  auto *env = static_cast<GridEnv *>(h);
  for (int i = 0; i < env->num; ++i) {
    const int64_t *row = in + (size_t)i * 6;
    env->ay[i] = row[0];
    env->ax[i] = row[1];
    env->gy[i] = row[2];
    env->gx[i] = row[3];
    env->t[i] = row[4];
    env->seed[i] = row[5];
    env->first[i] = 0;
    env->rew[i] = 0.0f;
  }
}

int64_t grid_episode_counter(void *h) {
  return static_cast<GridEnv *>(h)->episode_counter;
}

void grid_set_episode_counter(void *h, int64_t c) {
  static_cast<GridEnv *>(h)->episode_counter = c;
}

}  // extern "C"
