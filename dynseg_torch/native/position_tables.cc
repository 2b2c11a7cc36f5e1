// Native position-table builder for class-balanced patch sampling.
//
// Replaces the per-class np.nonzero pass in dynseg/data/sampler.py
// (SURVEY.md C4): for production-size rasters (e.g. Potsdam 6000^2 tiles)
// one fused C++ pass over the label volume builds every per-class
// (tile,row,col) table, instead of num_classes full scans allocating
// temporary index arrays. Exposed via a plain C ABI and loaded with
// ctypes (no pybind11 in this image).
//
// Two-phase contract (caller allocates):
//   1. count_class_pixels(masks, T, H, W, num_classes, out_counts)
//   2. fill_position_tables(masks, T, H, W, num_classes,
//                           table_ptrs[num_classes])  -> each table is
//      (counts[c], 3) int32 row-major, filled in raster order.
//
// A separate epoch-shuffle helper is AVAILABLE for very large tables, but
// the production sampler deliberately shuffles with its checkpointed numpy
// Generator (dynseg/data/sampler.py) — switching streams would break
// resume reproducibility (mt19937_64 ordering differs from numpy's
// Philox/PCG state saved in checkpoints). Wire this in only with its own
// checkpointed seed counter.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// Phase 1: per-class pixel counts. Labels outside [0, num_classes) —
// including IGNORE (255) — are skipped.
// DYNSEG_NATIVE_THREADS overrides the thread count (and the small-input
// single-thread shortcut) so the multi-threaded path is exercisable on
// hosts where hardware_concurrency()==1 (this box) or inputs are small.
void count_class_pixels(const int32_t* masks, int64_t t, int64_t h, int64_t w,
                        int32_t num_classes, int64_t* out_counts) {
  const int64_t n = t * h * w;
  std::memset(out_counts, 0, sizeof(int64_t) * num_classes);

  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw == 0 ? 1 : static_cast<int64_t>(hw);
  if (n_threads > 16) n_threads = 16;
  if (n < (int64_t)1 << 20) n_threads = 1;
  if (const char* env = std::getenv("DYNSEG_NATIVE_THREADS")) {
    const long forced = std::strtol(env, nullptr, 10);
    if (forced >= 1 && forced <= 64) n_threads = forced;
  }
  if (n_threads > n && n > 0) n_threads = n;

  std::vector<std::vector<int64_t>> partial(
      n_threads, std::vector<int64_t>(num_classes, 0));
  std::vector<std::thread> threads;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t ti = 0; ti < n_threads; ++ti) {
    threads.emplace_back([&, ti]() {
      const int64_t lo = ti * chunk;
      const int64_t hi = std::min(n, lo + chunk);
      auto& counts = partial[ti];
      for (int64_t i = lo; i < hi; ++i) {
        const int32_t c = masks[i];
        if (c >= 0 && c < num_classes) ++counts[c];
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int64_t ti = 0; ti < n_threads; ++ti)
    for (int32_t c = 0; c < num_classes; ++c) out_counts[c] += partial[ti][c];
}

// Phase 2: fill per-class (count, 3) tables in raster order.
// table_ptrs[c] must have room for counts[c]*3 int32s.
void fill_position_tables(const int32_t* masks, int64_t t, int64_t h,
                          int64_t w, int32_t num_classes,
                          int32_t** table_ptrs) {
  std::vector<int64_t> cursor(num_classes, 0);
  for (int64_t ti = 0; ti < t; ++ti) {
    const int32_t* tile = masks + ti * h * w;
    for (int64_t r = 0; r < h; ++r) {
      const int32_t* row = tile + r * w;
      for (int64_t cc = 0; cc < w; ++cc) {
        const int32_t cls = row[cc];
        if (cls >= 0 && cls < num_classes) {
          int32_t* dst = table_ptrs[cls] + cursor[cls] * 3;
          dst[0] = static_cast<int32_t>(ti);
          dst[1] = static_cast<int32_t>(r);
          dst[2] = static_cast<int32_t>(cc);
          ++cursor[cls];
        }
      }
    }
  }
}

// Fisher–Yates shuffle of an (n, 3) int32 table (epoch reshuffle).
void shuffle_table(int32_t* table, int64_t n, uint64_t seed) {
  std::mt19937_64 rng(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    const int64_t j = static_cast<int64_t>(rng() % (uint64_t)(i + 1));
    int32_t tmp[3];
    std::memcpy(tmp, table + i * 3, sizeof(tmp));
    std::memcpy(table + i * 3, table + j * 3, sizeof(tmp));
    std::memcpy(table + j * 3, tmp, sizeof(tmp));
  }
}

}  // extern "C"
