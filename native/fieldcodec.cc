// Host-side boundary codec for mi_fieldcalc_tpu.
//
// The framework's compute path is JAX on the accelerator; the native layer that
// remains host-work is the numpy boundary: decoding sentinel-encoded grids
// (miutil::UNDEF = 1e35, reference FieldDefined.cc:34) into (values, mask)
// pairs, re-encoding results, and computing the tri-state definedness
// summary (checkDefined, FieldDefined.cc:41-70) without shipping the array
// to the accelerator.  These scans are memory-bound; numpy needs 3-4
// passes (isnan, !=, where, sum) where one fused C++ pass suffices.
//
// Threading mirrors the reference's size-adaptive OpenMP harness
// (openmp_tools.cc:38-69): 1 thread under 1e3 points, 2 under 1e4,
// 4 under 1e5, 8 above, capped by std::thread::hardware_concurrency and
// the MF_NATIVE_THREADS env var (the reference honors OMP_NUM_THREADS).
//
// Exposed as a plain C ABI consumed via ctypes (mi_fieldcalc_tpu/native.py);
// no pybind11 dependency.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

int num_threads(int64_t loop_size) {
  // reference thresholds: openmp_tools.cc:58-65
  int n = 8;
  if (loop_size < 1000)
    n = 1;
  else if (loop_size <= 10000)
    n = 2;
  else if (loop_size <= 100000)
    n = 4;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw > 0 && n > static_cast<int>(hw)) n = static_cast<int>(hw);
  if (const char* env = std::getenv("MF_NATIVE_THREADS")) {
    int cap = std::atoi(env);
    if (cap > 0 && n > cap) n = cap;
  }
  return n < 1 ? 1 : n;
}

// Persistent executor (ABI v3): production pipelines stage 12+ fields
// per step, and spawning/joining a fresh std::thread team per field
// (the v2 behavior) costs ~an OS-thread create/destroy per worker per
// call.  A lazily-started pool of size num_threads(inf) parks workers
// on a condition variable between calls; each parallel region hands
// workers a (begin, end) range of the same closure.  Opt out with
// MF_NATIVE_POOL=0 (falls back to spawn-per-call).
class WorkerPool {
 public:
  static WorkerPool* instance() {
    if (const char* env = std::getenv("MF_NATIVE_POOL")) {
      if (std::atoi(env) == 0) return nullptr;
    }
    static WorkerPool pool(num_threads(1 << 30));
    return pool.size() > 1 ? &pool : nullptr;
  }

  int size() const { return static_cast<int>(workers_.size()) + 1; }

  // Run fn(begin, end) over [0, n) on `want` lanes (caller included).
  // Returns false without running anything if another caller holds the
  // pool (ctypes releases the GIL, so e.g. the streaming executor's
  // decode and encode threads hit the codec concurrently) — the caller
  // then falls back to spawn-per-call so concurrent regions OVERLAP
  // instead of serializing behind one pool.
  bool try_run(int want, int64_t n,
               const std::function<void(int64_t, int64_t)>& fn) {
    std::unique_lock<std::mutex> outer(run_m_, std::try_to_lock);
    if (!outer.owns_lock()) return false;
    int lanes = want < size() ? want : size();
    int64_t chunk = (n + lanes - 1) / lanes;
    {
      std::unique_lock<std::mutex> lk(m_);
      fn_ = &fn;
      total_ = n;
      chunk_ = chunk;
      lanes_ = lanes;
      remaining_ = lanes - 1;
      ++epoch_;
    }
    cv_.notify_all();
    fn(0, chunk < n ? chunk : n);  // caller is lane 0
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [this] { return remaining_ == 0; });
    return true;
  }

 private:
  explicit WorkerPool(int nthreads) {
    for (int t = 1; t < nthreads; ++t)
      workers_.emplace_back([this, t] { worker(t); });
  }
  ~WorkerPool() {
    {
      std::unique_lock<std::mutex> lk(m_);
      stop_ = true;
      ++epoch_;
    }
    cv_.notify_all();
    for (auto& th : workers_) th.join();
  }

  void worker(int lane) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int64_t, int64_t)>* fn = nullptr;
      int64_t b = 0, e = 0;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return epoch_ != seen || stop_; });
        if (stop_) return;
        seen = epoch_;
        if (lane < lanes_) {
          b = lane * chunk_;
          e = b + chunk_ < total_ ? b + chunk_ : total_;
          fn = fn_;
        }
      }
      if (fn && b < e) (*fn)(b, e);
      {
        std::unique_lock<std::mutex> lk(m_);
        if (lane < lanes_ && --remaining_ == 0) done_cv_.notify_one();
      }
    }
  }

  std::vector<std::thread> workers_;
  std::mutex m_, run_m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int64_t, int64_t)>* fn_ = nullptr;
  int64_t total_ = 0, chunk_ = 0;
  int lanes_ = 0, remaining_ = 0;
  uint64_t epoch_ = 0;
  bool stop_ = false;
};

// Run fn(begin, end) over [0, n) split across size-adaptive threads —
// on the persistent pool when enabled, else spawn-per-call.
// `work` is the size-adaptive heuristic's input (defaults to n): a
// caller whose tasks are COARSE (e.g. one task per 8-row block over
// all levels) must pass the underlying work-item count, or the
// reference-mirrored thresholds read "tiny loop" and serialize it
// (measured: the levpack codec at 360 block-tasks ran single-threaded,
// 172 ms vs 45 for the equivalent 92k-row pass).
template <typename Fn>
void parallel_for_w(int64_t n, int64_t work, Fn&& fn) {
  int nt = num_threads(work);
  if (nt <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  if (WorkerPool* pool = WorkerPool::instance()) {
    std::function<void(int64_t, int64_t)> f = std::ref(fn);
    if (pool->try_run(nt, n, f)) return;
    // pool busy with another caller's region: spawn so the two overlap
  }
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 1; t < nt; ++t) {
    int64_t b = t * chunk;
    int64_t e = b + chunk < n ? b + chunk : n;
    if (b >= e) break;
    pool.emplace_back([&fn, b, e] { fn(b, e); });
  }
  fn(0, chunk < n ? chunk : n);
  for (auto& th : pool) th.join();
}

template <typename Fn>
void parallel_for(int64_t n, Fn&& fn) {
  parallel_for_w(n, n, std::forward<Fn>(fn));
}

inline bool is_defined(float v, float undef) {
  // fieldcalc::is_defined (FieldCalculations.h:42-45)
  return !std::isnan(v) && v != undef;
}

}  // namespace

extern "C" {

int mf_native_abi_version() { return 6; }

// Decode: out[i] = defined ? v[i] : fill; mask[i] = defined.  `out` may
// alias `v` (in-place sanitize).  Returns the number of defined points.
int64_t mf_decode(const float* v, int64_t n, float undef, float fill,
                  float* out, uint8_t* mask) {
  std::atomic<int64_t> n_def{0};
  parallel_for(n, [&](int64_t b, int64_t e) {
    int64_t local = 0;
    for (int64_t i = b; i < e; ++i) {
      bool d = is_defined(v[i], undef);
      mask[i] = d ? 1 : 0;
      out[i] = d ? v[i] : fill;
      local += d;
    }
    n_def.fetch_add(local, std::memory_order_relaxed);
  });
  return n_def.load();
}

// Encode: out[i] = mask[i] ? v[i] : undef.  `out` may alias `v`.
void mf_encode(const float* v, const uint8_t* mask, int64_t n, float undef,
               float* out) {
  parallel_for(n, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) out[i] = mask[i] ? v[i] : undef;
  });
}

// checkDefined(const float*, n) (FieldDefined.cc:41-57) without touching
// any output: returns the defined count for the tri-state summary.
int64_t mf_count_defined(const float* v, int64_t n, float undef) {
  std::atomic<int64_t> n_def{0};
  parallel_for(n, [&](int64_t b, int64_t e) {
    int64_t local = 0;
    for (int64_t i = b; i < e; ++i) local += is_defined(v[i], undef);
    n_def.fetch_add(local, std::memory_order_relaxed);
  });
  return n_def.load();
}

// Fused decode + canonical padded layout (ABI v2).  Reads a contiguous
// sentinel array [lead, ny, nx] and writes [lead, ny_p, nx_p] values +
// mask in one pass: logical points decode as mf_decode, dead rows/lanes
// get `fill` with mask 0, so the result device_puts straight into the
// tile-aligned production layout (mi_fieldcalc_tpu/layout.py) with no
// separate numpy pad pass.  Returns the defined count over the logical
// points only (the tri-state summary ignores padding).
int64_t mf_decode_pad(const float* v, int64_t lead, int64_t ny, int64_t nx,
                      int64_t ny_p, int64_t nx_p, float undef, float fill,
                      float* out, uint8_t* mask) {
  std::atomic<int64_t> n_def{0};
  parallel_for(lead * ny_p, [&](int64_t b, int64_t e) {
    int64_t local = 0;
    for (int64_t row = b; row < e; ++row) {
      int64_t l = row / ny_p, r = row % ny_p;
      float* ov = out + row * nx_p;
      uint8_t* om = mask + row * nx_p;
      if (r < ny) {
        const float* sv = v + (l * ny + r) * nx;
        for (int64_t i = 0; i < nx; ++i) {
          bool d = is_defined(sv[i], undef);
          om[i] = d ? 1 : 0;
          ov[i] = d ? sv[i] : fill;
          local += d;
        }
        for (int64_t i = nx; i < nx_p; ++i) { om[i] = 0; ov[i] = fill; }
      } else {
        for (int64_t i = 0; i < nx_p; ++i) { om[i] = 0; ov[i] = fill; }
      }
    }
    n_def.fetch_add(local, std::memory_order_relaxed);
  });
  return n_def.load();
}

// Trim + encode dual (ABI v2): padded device results [lead, ny_p, nx_p]
// (values + mask) back to the logical [lead, ny, nx] sentinel array in
// one pass — the host boundary for production pipelines that keep grids
// padded on device and only trim when handing arrays back to callers.
void mf_encode_trim(const float* v, const uint8_t* mask, int64_t lead,
                    int64_t ny, int64_t nx, int64_t ny_p, int64_t nx_p,
                    float undef, float* out) {
  parallel_for(lead * ny, [&](int64_t b, int64_t e) {
    for (int64_t row = b; row < e; ++row) {
      int64_t l = row / ny, r = row % ny;
      const float* sv = v + (l * ny_p + r) * nx_p;
      const uint8_t* sm = mask + (l * ny_p + r) * nx_p;
      float* ov = out + row * nx;
      for (int64_t i = 0; i < nx; ++i) ov[i] = sm[i] ? sv[i] : undef;
    }
  });
}

// Batch staging (ABI v3): decode+pad K same-shape sentinel fields in ONE
// parallel region.  `srcs` holds K pointers to [lead, ny, nx] arrays;
// `out`/`mask` are one contiguous [K, lead, ny_p, nx_p] block (the
// device_put staging buffer); `counts[k]` gets field k's defined count
// over logical points.  One region across all K*lead*ny_p rows instead
// of K thread-team spawns/joins — the staging path of a production step
// moves 4-12 fields per call.
void mf_decode_pad_batch(const float** srcs, int64_t k, int64_t lead,
                         int64_t ny, int64_t nx, int64_t ny_p, int64_t nx_p,
                         float undef, float fill, float* out, uint8_t* mask,
                         int64_t* counts) {
  std::vector<std::atomic<int64_t>> n_def(k);
  for (auto& c : n_def) c.store(0, std::memory_order_relaxed);
  parallel_for(k * lead * ny_p, [&](int64_t b, int64_t e) {
    int64_t local = 0, cur = b < e ? b / (lead * ny_p) : 0;
    for (int64_t row = b; row < e; ++row) {
      int64_t f = row / (lead * ny_p);
      if (f != cur) {
        n_def[cur].fetch_add(local, std::memory_order_relaxed);
        local = 0;
        cur = f;
      }
      int64_t rem = row % (lead * ny_p);
      int64_t l = rem / ny_p, r = rem % ny_p;
      float* ov = out + row * nx_p;
      uint8_t* om = mask + row * nx_p;
      if (r < ny) {
        const float* sv = srcs[f] + (l * ny + r) * nx;
        for (int64_t i = 0; i < nx; ++i) {
          bool d = is_defined(sv[i], undef);
          om[i] = d ? 1 : 0;
          ov[i] = d ? sv[i] : fill;
          local += d;
        }
        for (int64_t i = nx; i < nx_p; ++i) { om[i] = 0; ov[i] = fill; }
      } else {
        for (int64_t i = 0; i < nx_p; ++i) { om[i] = 0; ov[i] = fill; }
      }
    }
    if (b < e) n_def[cur].fetch_add(local, std::memory_order_relaxed);
  });
  for (int64_t f = 0; f < k; ++f) counts[f] = n_def[f].load();
}

// Trim+encode dual of mf_decode_pad_batch: K padded device results
// ([K, lead, ny_p, nx_p] values + masks, one contiguous block each)
// back into K caller-provided [lead, ny, nx] sentinel arrays.
void mf_encode_trim_batch(const float* v, const uint8_t* mask, int64_t k,
                          int64_t lead, int64_t ny, int64_t nx,
                          int64_t ny_p, int64_t nx_p, float undef,
                          float** outs) {
  parallel_for(k * lead * ny, [&](int64_t b, int64_t e) {
    for (int64_t row = b; row < e; ++row) {
      int64_t f = row / (lead * ny);
      int64_t rem = row % (lead * ny);
      int64_t l = rem / ny, r = rem % ny;
      const float* sv = v + ((f * lead + l) * ny_p + r) * nx_p;
      const uint8_t* sm = mask + ((f * lead + l) * ny_p + r) * nx_p;
      float* ov = outs[f] + rem * nx;
      for (int64_t i = 0; i < nx; ++i) ov[i] = sm[i] ? sv[i] : undef;
    }
  });
}

// Mask-mapped trim+encode (ABI v4): like mf_encode_trim_batch but the
// mask block holds `km <= k` planes and `mask_map[f]` names value plane
// f's mask plane (-1 = no mask: plain trim copy).  Serves two device
// layouts without host-side mask expansion: the fused kernel's
// deduplicated 9-plane mask stack (td/duc/dv share rh/the/vo) and the
// ALL_DEFINED fast path's 2-plane stack (10 of 12 outputs constant
// defined).
void mf_encode_trim_batch_map(const float* v, const uint8_t* mask,
                              const int64_t* mask_map, int64_t k,
                              int64_t lead, int64_t ny, int64_t nx,
                              int64_t ny_p, int64_t nx_p, float undef,
                              float** outs) {
  parallel_for(k * lead * ny, [&](int64_t b, int64_t e) {
    for (int64_t row = b; row < e; ++row) {
      int64_t f = row / (lead * ny);
      int64_t rem = row % (lead * ny);
      int64_t l = rem / ny, r = rem % ny;
      const float* sv = v + ((f * lead + l) * ny_p + r) * nx_p;
      float* ov = outs[f] + rem * nx;
      int64_t mf = mask_map[f];
      if (mf < 0) {
        std::memcpy(ov, sv, nx * sizeof(float));
      } else {
        const uint8_t* sm = mask + ((mf * lead + l) * ny_p + r) * nx_p;
        for (int64_t i = 0; i < nx; ++i) ov[i] = sm[i] ? sv[i] : undef;
      }
    }
  });
}

// LEV-packed batch staging (ABI v5): decode+pad K same-shape
// [nlev, ny, nx] sentinel stacks in ONE parallel region, emitting the
// mask bit-planes: `pmask` is one [K, ny_p, nx_p] uint32 block with
// bit L = level L defined (dead rows/lanes all-zero), the order of
// ((m << lev).sum(0)).  The mask payload shipped
// per step is nlev/32 of the uint8 block.  Values block and counts as
// mf_decode_pad_batch.  Requires nlev <= 32.
void mf_decode_pad_levpack_batch(const float** srcs, int64_t k,
                                 int64_t nlev, int64_t ny, int64_t nx,
                                 int64_t ny_p, int64_t nx_p, float undef,
                                 float fill, float* out, uint32_t* pmask,
                                 int64_t* counts) {
  std::vector<std::atomic<int64_t>> n_def(k);
  for (auto& c : n_def) c.store(0, std::memory_order_relaxed);
  // task = (field, 8-row block): the lev loop stays private per block,
  // so the bit-OR accumulation into pmask needs no atomics, and each
  // level-plane visit covers 8 consecutive rows — 8x fewer multi-MB
  // plane jumps than a per-row nest (measured 2.4x wall on the
  // per-row version: TLB/page thrash between the k*nlev planes)
  const int64_t RB = 8;
  int64_t blocks = (ny_p + RB - 1) / RB;
  parallel_for_w(k * blocks, k * nlev * ny_p, [&](int64_t b, int64_t e) {
    for (int64_t task = b; task < e; ++task) {
      int64_t f = task / blocks;
      int64_t r0 = (task % blocks) * RB;
      int64_t r1 = r0 + RB < ny_p ? r0 + RB : ny_p;
      for (int64_t r = r0; r < r1; ++r) {
        uint32_t* pm = pmask + (f * ny_p + r) * nx_p;
        for (int64_t i = 0; i < nx_p; ++i) pm[i] = 0;
      }
      int64_t local = 0;
      for (int64_t lev = 0; lev < nlev; ++lev) {
        for (int64_t r = r0; r < r1; ++r) {
          float* ov = out + ((f * nlev + lev) * ny_p + r) * nx_p;
          if (r < ny) {
            const float* sv = srcs[f] + (lev * ny + r) * nx;
            uint32_t* pm = pmask + (f * ny_p + r) * nx_p;
            uint32_t bit = 1u << lev;
            for (int64_t i = 0; i < nx; ++i) {
              bool d = is_defined(sv[i], undef);
              pm[i] |= d ? bit : 0u;
              ov[i] = d ? sv[i] : fill;
              local += d;
            }
            for (int64_t i = nx; i < nx_p; ++i) ov[i] = fill;
          } else {
            for (int64_t i = 0; i < nx_p; ++i) ov[i] = fill;
          }
        }
      }
      if (local) n_def[f].fetch_add(local, std::memory_order_relaxed);
    }
  });
  for (int64_t f = 0; f < k; ++f) counts[f] = n_def[f].load();
}

// Trim+encode for LEV-packed device masks (ABI v5): value planes
// [k, nlev, ny_p, nx_p] with a packed mask block of `km <= k`
// [ny_p, nx_p] uint32 planes (bit L = level L defined, the fused
// kernel's levpack_masks output layout); `mask_map[f]` names value
// plane f's packed plane (-1 = constant defined: plain trim copy).
void mf_encode_trim_batch_levpack(const float* v, const uint32_t* pmask,
                                  const int64_t* mask_map, int64_t k,
                                  int64_t nlev, int64_t ny, int64_t nx,
                                  int64_t ny_p, int64_t nx_p, float undef,
                                  float** outs) {
  parallel_for(k * nlev * ny, [&](int64_t b, int64_t e) {
    for (int64_t row = b; row < e; ++row) {
      int64_t f = row / (nlev * ny);
      int64_t rem = row % (nlev * ny);
      int64_t l = rem / ny, r = rem % ny;
      const float* sv = v + ((f * nlev + l) * ny_p + r) * nx_p;
      float* ov = outs[f] + rem * nx;
      int64_t mf = mask_map[f];
      if (mf < 0) {
        std::memcpy(ov, sv, nx * sizeof(float));
      } else {
        const uint32_t* pm = pmask + (mf * ny_p + r) * nx_p;
        uint32_t bit = 1u << l;
        for (int64_t i = 0; i < nx; ++i)
          ov[i] = (pm[i] & bit) ? sv[i] : undef;
      }
    }
  });
}

// Aligned-ingest fused pass (ABI v6): decode + MASK-AWARE BILINEAR
// re-grid of K same-shape [lead, ny, nx] sentinel stacks onto the
// tile-aligned [lead, ny_t, nx_t] target in ONE parallel region — the
// native form of ingest.resample_align composed with mf_decode_pad
// (staging align=True / MF_STAGING_ALIGN).  Semantics mirror
// ingest.resample_align exactly: per target point, the 4 bilinear
// corner weights are zeroed on undefined corners (NaN or == undef) and
// renormalized; the point is undefined iff the total defined weight is
// <= 1e-6 (then `fill`, mask 0).  The caller precomputes the axis maps
// (y0/y1/wy per target row, x0/x1/wx per target lane) with
// ingest._axis_coords, so native and numpy paths sample identical
// physical coordinates; values may differ from the numpy reference in
// the last ulp (FP contraction), masks only on measure-zero den ==
// 1e-6 knife edges (tests assert masks equal + values allclose 2e-6).
// counts[f] = defined target points of field f.
void mf_decode_resample_batch(const float** srcs, int64_t k, int64_t lead,
                              int64_t ny, int64_t nx,
                              int64_t ny_t, int64_t nx_t,
                              const int64_t* y0, const int64_t* y1,
                              const float* wy,
                              const int64_t* x0, const int64_t* x1,
                              const float* wx,
                              float undef, float fill,
                              float* out, uint8_t* mask, int64_t* counts) {
  std::vector<std::atomic<int64_t>> n_def(k);
  for (auto& c : n_def) c.store(0, std::memory_order_relaxed);
  parallel_for_w(k * lead * ny_t, k * lead * ny_t * 2, [&](int64_t b,
                                                           int64_t e) {
    int64_t local = 0, cur = b < e ? b / (lead * ny_t) : 0;
    for (int64_t row = b; row < e; ++row) {
      int64_t f = row / (lead * ny_t);
      if (f != cur) {
        n_def[cur].fetch_add(local, std::memory_order_relaxed);
        local = 0;
        cur = f;
      }
      int64_t rem = row % (lead * ny_t);
      int64_t l = rem / ny_t, r = rem % ny_t;
      const float* r0p = srcs[f] + (l * ny + y0[r]) * nx;
      const float* r1p = srcs[f] + (l * ny + y1[r]) * nx;
      float* ov = out + row * nx_t;
      uint8_t* om = mask + row * nx_t;
      float wyv = wy[r], wy0 = 1.0f - wyv;
      for (int64_t i = 0; i < nx_t; ++i) {
        float wxv = wx[i], wx0 = 1.0f - wxv;
        float c00 = r0p[x0[i]], c01 = r0p[x1[i]];
        float c10 = r1p[x0[i]], c11 = r1p[x1[i]];
        // corner weights, zeroed on undefined corners (numpy order)
        float num = 0.0f, den = 0.0f;
        if (is_defined(c00, undef)) { float w = wy0 * wx0; num += w * c00; den += w; }
        if (is_defined(c01, undef)) { float w = wy0 * wxv; num += w * c01; den += w; }
        if (is_defined(c10, undef)) { float w = wyv * wx0; num += w * c10; den += w; }
        if (is_defined(c11, undef)) { float w = wyv * wxv; num += w * c11; den += w; }
        bool d = den > 1e-6f;
        om[i] = d ? 1 : 0;
        ov[i] = d ? num / den : fill;
        local += d;
      }
    }
    if (b < e) n_def[cur].fetch_add(local, std::memory_order_relaxed);
  });
  for (int64_t f = 0; f < k; ++f) counts[f] = n_def[f].load();
}

// Defined count over a mask array (checkDefined(n_undefined, n) dual).
int64_t mf_count_mask(const uint8_t* mask, int64_t n) {
  std::atomic<int64_t> n_def{0};
  parallel_for(n, [&](int64_t b, int64_t e) {
    int64_t local = 0;
    for (int64_t i = b; i < e; ++i) local += mask[i] != 0;
    n_def.fetch_add(local, std::memory_order_relaxed);
  });
  return n_def.load();
}

}  // extern "C"
