// host_engine.cpp — native host-side runtime for the join engine.
//
// Equivalents of the reference's host CPU components:
//   * dataset generator   (reference src/generator_ETHZ.cu:23-348) — same
//     algorithms on the same libc RNG primitives (glibc rand()/nrand48()) so
//     that, given the same seed, produced .bin files are bit-identical to the
//     reference's; written fresh, structured as a reusable library.
//   * host radix pre-partitioner (reference
//     src/partition-primitives.cu:40-232) — OpenMP histogram + prefix
//     offsets + scatter with per-partition software write-combining buffers
//     flushed by AVX2 non-temporal stores. Feeds the host->HBM streaming
//     regime when tables exceed device memory.
//   * skew-aware knapsack batch scheduler (reference
//     src/partition-primitives.cu:259-469) — groups host partitions into
//     device-resident batches by 0/1-knapsack DP on per-partition gains.
//   * threaded staging copy (reference numa_copy_multithread,
//     src/partition-primitives.cu:235-253) — multithreaded streaming memcpy
//     into pinned staging buffers.
//
// Exposed with a plain C ABI for ctypes.
//
// Build: make native   (g++ -O3 -fopenmp -mavx2; see repo Makefile)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// RNG seeding. The generator deliberately uses the C library's rand() so the
// byte streams match reference-generated datasets for a given seed.
// ---------------------------------------------------------------------------

void tj_seed(unsigned int seed) { srand(seed); }

static inline int64_t rand_range(int64_t n) {
  // floor(rand()/ (RAND_MAX+1) * n), the RAND_RANGE macro semantics
  // (reference src/generator_ETHZ.cu:16).
  return (int64_t)((double)rand() / ((double)RAND_MAX + 1.0) * (double)n);
}

static inline int64_t rand_range48(int64_t n, unsigned short st[3]) {
  return (int64_t)((double)nrand48(st) / ((double)RAND_MAX + 1.0) * (double)n);
}

// Uniform non-unique keys in [0, maxid).
void tj_random_gen(int32_t* out, uint64_t n, int64_t maxid) {
  for (uint64_t i = 0; i < n; ++i) out[i] = (int32_t)rand_range(maxid);
}

// In-place Fisher-Yates shuffle driven by rand().
void tj_knuth_shuffle(int32_t* a, uint64_t n) {
  for (int64_t i = (int64_t)n - 1; i > 0; --i) {
    int64_t j = rand_range(i);
    std::swap(a[i], a[j]);
  }
}

// In-place Fisher-Yates shuffle driven by nrand48(state).
void tj_knuth_shuffle48(int32_t* a, uint64_t n, unsigned short* state) {
  for (int64_t i = (int64_t)n - 1; i > 0; --i) {
    int64_t j = rand_range48(i, state);
    std::swap(a[i], a[j]);
  }
}

// Unique keys: cycle 0..maxid then shuffle with an nrand48 stream seeded from
// `seed48` (the reference seeds it from time(NULL); we take it explicitly so
// datasets are reproducible).
void tj_random_unique_gen(int32_t* out, uint64_t n, int64_t maxid,
                          unsigned int seed48) {
  // Fill rule: write the current value, reset to 0 *after* writing maxid,
  // then increment — so the sequence is 0,1,..,maxid,1,2,..,maxid,1,..
  // (keys span 0..maxid; 0 appears only once when n > maxid).
  int64_t fk = 0;
  for (uint64_t i = 0; i < n; ++i) {
    out[i] = (int32_t)fk;
    if (fk == maxid) fk = 0;
    fk++;
  }
  unsigned short st[3] = {0, 0, 0};
  memcpy(st, &seed48, sizeof(seed48));
  tj_knuth_shuffle48(out, n, st);
}

// Foreign keys from a primary-key relation: tile PK to length n, shuffle.
void tj_fk_from_pk(int32_t* out, uint64_t n_fk, const int32_t* pk,
                   uint64_t n_pk) {
  uint64_t full = n_fk / n_pk;
  for (uint64_t i = 0; i < full; ++i)
    memcpy(out + i * n_pk, pk, n_pk * sizeof(int32_t));
  uint64_t rem = n_fk % n_pk;
  if (rem) memcpy(out + full * n_pk, pk, rem * sizeof(int32_t));
  tj_knuth_shuffle(out, n_fk);
}

// Zipf stream over alphabet {1..alphabet_size} (random permutation), CDF
// lookup + binary search per element.
void tj_gen_zipf(int32_t* out, uint64_t n, unsigned int alphabet_size,
                 double z) {
  std::vector<uint32_t> alpha(alphabet_size);
  for (unsigned int i = 0; i < alphabet_size; ++i) alpha[i] = i + 1;
  for (unsigned int i = alphabet_size - 1; i > 0; --i) {
    unsigned int k = (unsigned int)((unsigned long)i * rand() / RAND_MAX);
    std::swap(alpha[i], alpha[k]);
  }

  std::vector<double> cdf(alphabet_size);
  double norm = 0.0;
  for (unsigned int i = 1; i <= alphabet_size; ++i) norm += 1.0 / pow(i, z);
  double acc = 0.0;
  for (unsigned int i = 1; i <= alphabet_size; ++i) {
    acc += 1.0 / pow(i, z);
    cdf[i - 1] = acc / norm;
  }

  // The reference burns 64 rand() calls into a seeds[] array it never uses
  // (src/generator_ETHZ.cu:308-311) — reproduce the draws so the rand()
  // stream stays aligned for byte-parity.
  for (int i = 0; i < 64; ++i) (void)rand();

  for (uint64_t i = 0; i < n; ++i) {
    double r = ((double)rand()) / RAND_MAX;
    unsigned int pos;
    if (cdf[0] >= r) {
      pos = 0;
    } else {
      unsigned int left = 0, right = alphabet_size - 1;
      while (right - left > 1) {
        unsigned int mid = (left + right) / 2;
        if (cdf[mid] < r) left = mid; else right = mid;
      }
      pos = right;
    }
    out[i] = (int32_t)alpha[pos];
  }
}

// ---------------------------------------------------------------------------
// Host radix pre-partitioner (C16 analog).
//
// Deterministic three-step scheme (histogram -> exclusive scan -> scatter),
// parallelized over row ranges; per-thread per-partition write cursors keep
// the output stable *per thread region* and the overall layout CSR:
// partition-major, thread-region-minor. Per-partition software
// write-combining buffers (64 entries) are flushed with streaming stores
// when AVX2 is available.
// ---------------------------------------------------------------------------

static inline uint32_t part_of(int32_t key, int first_bit, uint32_t mask) {
  return (((uint32_t)key) >> first_bit) & mask;
}

void tj_host_partition(const int32_t* keys, const int32_t* pays, uint64_t n,
                       int bits, int first_bit, int num_threads,
                       int32_t* out_keys, int32_t* out_pays,
                       uint64_t* counts /* size 2^bits */,
                       uint64_t* offsets /* size 2^bits + 1 */) {
  const uint32_t parts = 1u << bits;
  const uint32_t mask = parts - 1;
#ifdef _OPENMP
  if (num_threads <= 0) num_threads = omp_get_max_threads();
#else
  num_threads = 1;
#endif
  std::vector<uint64_t> hist((size_t)num_threads * parts, 0);

#ifdef _OPENMP
#pragma omp parallel num_threads(num_threads)
#endif
  {
#ifdef _OPENMP
    int t = omp_get_thread_num();
#else
    int t = 0;
#endif
    uint64_t lo = n * t / num_threads, hi = n * (t + 1) / num_threads;
    uint64_t* h = hist.data() + (size_t)t * parts;
    for (uint64_t i = lo; i < hi; ++i) h[part_of(keys[i], first_bit, mask)]++;
  }

  // Exclusive scan: partition-major, then thread order within partition.
  uint64_t run = 0;
  std::vector<uint64_t> cursor((size_t)num_threads * parts);
  for (uint32_t p = 0; p < parts; ++p) {
    offsets[p] = run;
    uint64_t c = 0;
    for (int t = 0; t < num_threads; ++t) {
      cursor[(size_t)t * parts + p] = run;
      run += hist[(size_t)t * parts + p];
      c += hist[(size_t)t * parts + p];
    }
    counts[p] = c;
  }
  offsets[parts] = run;

#ifdef _OPENMP
#pragma omp parallel num_threads(num_threads)
#endif
  {
#ifdef _OPENMP
    int t = omp_get_thread_num();
#else
    int t = 0;
#endif
    uint64_t lo = n * t / num_threads, hi = n * (t + 1) / num_threads;
    uint64_t* cur = cursor.data() + (size_t)t * parts;
#if defined(__AVX2__)
    // Software write-combining (the reference's trick,
    // src/partition-primitives.cu:88-101): per-partition 64-entry staging
    // buffers; full buffers flush with _mm256_stream_si256 non-temporal
    // stores so scattered partition writes don't thrash the cache. Only
    // engaged for partition counts small enough that the staging arrays
    // stay cache-resident.
    if (parts <= 256) {
      constexpr uint32_t WC = 64;
      std::vector<int32_t> wck((size_t)parts * WC), wcp((size_t)parts * WC);
      std::vector<uint32_t> fill(parts, 0);
      auto flush = [&](uint32_t p, uint32_t cnt) {
        uint64_t dst = cur[p];
        const int32_t* sk_ = wck.data() + (size_t)p * WC;
        const int32_t* sp_ = wcp.data() + (size_t)p * WC;
        uint32_t i = 0;
        // scalar head until the destination is 32B-aligned
        while (i < cnt && (((uintptr_t)(out_keys + dst + i)) & 31u)) {
          out_keys[dst + i] = sk_[i];
          ++i;
        }
        for (; i + 8 <= cnt; i += 8)
          _mm256_stream_si256((__m256i*)(out_keys + dst + i),
                              _mm256_loadu_si256((const __m256i*)(sk_ + i)));
        for (; i < cnt; ++i) out_keys[dst + i] = sk_[i];
        i = 0;
        while (i < cnt && (((uintptr_t)(out_pays + dst + i)) & 31u)) {
          out_pays[dst + i] = sp_[i];
          ++i;
        }
        for (; i + 8 <= cnt; i += 8)
          _mm256_stream_si256((__m256i*)(out_pays + dst + i),
                              _mm256_loadu_si256((const __m256i*)(sp_ + i)));
        for (; i < cnt; ++i) out_pays[dst + i] = sp_[i];
        cur[p] += cnt;
      };
      for (uint64_t i = lo; i < hi; ++i) {
        uint32_t p = part_of(keys[i], first_bit, mask);
        uint32_t f = fill[p];
        wck[(size_t)p * WC + f] = keys[i];
        wcp[(size_t)p * WC + f] = pays[i];
        if (++fill[p] == WC) {
          flush(p, WC);
          fill[p] = 0;
        }
      }
      for (uint32_t p = 0; p < parts; ++p)
        if (fill[p]) flush(p, fill[p]);
      _mm_sfence();
    } else
#endif
    {
      for (uint64_t i = lo; i < hi; ++i) {
        uint32_t p = part_of(keys[i], first_bit, mask);
        uint64_t dst = cur[p]++;
        out_keys[dst] = keys[i];
        out_pays[dst] = pays[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Threaded staging copy (C17 analog). Streaming stores when AVX2 available.
// ---------------------------------------------------------------------------

void tj_staging_copy(void* dst, const void* src, uint64_t bytes,
                     int num_threads) {
#ifdef _OPENMP
  if (num_threads <= 0) num_threads = omp_get_max_threads();
#pragma omp parallel num_threads(num_threads)
  {
    int t = omp_get_thread_num();
    int nt = omp_get_num_threads();
#else
  {
    int t = 0, nt = 1;
#endif
    uint64_t lo = bytes * t / nt, hi = bytes * (t + 1) / nt;
    char* d = (char*)dst + lo;
    const char* s = (const char*)src + lo;
    uint64_t len = hi - lo;
#if defined(__AVX2__)
    uint64_t vec = len & ~((uint64_t)31);
    uint64_t i = 0;
    if (((uintptr_t)d & 31) == 0) {
      for (; i < vec; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(s + i));
        _mm256_stream_si256((__m256i*)(d + i), v);
      }
      _mm_sfence();
    }
    memcpy(d + i, s + i, len - i);
#else
    memcpy(d, s, len);
#endif
  }
}

// ---------------------------------------------------------------------------
// Skew-aware knapsack batch scheduler (C18 analog).
//
// Given per-partition gains (fraction of device-resident build capacity each
// host partition consumes), repeatedly solve 0/1 knapsack (weight =
// ceil(gain), value = gain, capacity slots) and emit batches until every
// partition is scheduled. batch_of[i] receives the batch index of partition
// i. Returns the number of batches.
// ---------------------------------------------------------------------------

int tj_knapsack_batches(const double* gains, int n, int capacity,
                        int* batch_of) {
  std::vector<int> weight(n);
  std::vector<char> done(n, 0);
  for (int i = 0; i < n; ++i) {
    weight[i] = std::max(1, (int)std::ceil(gains[i]));
    batch_of[i] = -1;
  }
  int batch = 0, remaining = n;
  while (remaining > 0) {
    // Items still unscheduled, in index order.
    std::vector<int> items;
    for (int i = 0; i < n; ++i)
      if (!done[i]) items.push_back(i);
    int m = (int)items.size();
    // Full 2D DP table dp[k][c]: best value using the first k items within
    // capacity c — needed for exact reconstruction.
    std::vector<double> dp((size_t)(m + 1) * (capacity + 1), 0.0);
    auto DP = [&](int k, int c) -> double& {
      return dp[(size_t)k * (capacity + 1) + c];
    };
    for (int k = 1; k <= m; ++k) {
      int i = items[k - 1];
      int w = std::min(weight[i], capacity);
      for (int c = 0; c <= capacity; ++c) {
        double skip = DP(k - 1, c);
        double with = (c >= w) ? DP(k - 1, c - w) + gains[i] : -1.0;
        DP(k, c) = (with > skip) ? with : skip;
      }
    }
    int c = capacity;
    bool any = false;
    for (int k = m; k >= 1; --k) {
      int i = items[k - 1];
      if (DP(k, c) != DP(k - 1, c)) {
        batch_of[i] = batch;
        done[i] = 1;
        remaining--;
        any = true;
        c -= std::min(weight[i], capacity);
      }
    }
    if (!any) {
      // Shouldn't happen (every weight is clamped to capacity), but give
      // each straggler its own batch rather than loop forever.
      for (int i = 0; i < n; ++i) {
        if (!done[i]) {
          batch_of[i] = batch++;
          done[i] = 1;
          remaining--;
        }
      }
      return batch;
    }
    batch++;
  }
  return batch;
}

// ---------------------------------------------------------------------------
// Host oracle join aggregate: SUM(Pr * Ps) over all matching (r, s) pairs,
// int32 wraparound — the engine's stand-in for the reference's CPU oracle
// join (joinCpu, reference src/hash_join_clustered_probe.cu:2025-2059, which
// is compiled but never called). Used by the benchmark correctness gate: an
// implementation fully independent of the JAX/device path (no lax.sort, no
// shared code), fast enough to check 2^27-row configs.
//
// Algorithm: single-pass radix partition of both sides by low key bits into
// cache-sized partitions, then a per-partition chained hash table over R
// probed by S. All accumulation in uint32 (wraps mod 2^32, associative, so
// any evaluation order matches the reference's atomic int32 accumulation).
// ---------------------------------------------------------------------------

int32_t tj_oracle_join_aggregate(const int32_t* rk, const int32_t* rp,
                                 uint64_t n_r, const int32_t* sk,
                                 const int32_t* sp, uint64_t n_s) {
  if (n_r == 0 || n_s == 0) return 0;

  // Partition count: target ~2^16 R rows per partition, capped at 2^12.
  int log_p = 0;
  while (log_p < 12 && (n_r >> log_p) > (1ull << 16)) ++log_p;
  const uint32_t P = 1u << log_p;
  const uint32_t pmask = P - 1;

  // Histogram both sides by pid = key & pmask (identity hash, like the
  // reference's hasht), then scatter packed (key, payload) uint64 rows into
  // partition-contiguous buffers.
  std::vector<uint64_t> roff(P + 1, 0), soff(P + 1, 0);
  for (uint64_t i = 0; i < n_r; ++i) roff[((uint32_t)rk[i] & pmask) + 1]++;
  for (uint64_t i = 0; i < n_s; ++i) soff[((uint32_t)sk[i] & pmask) + 1]++;
  for (uint32_t p = 0; p < P; ++p) {
    roff[p + 1] += roff[p];
    soff[p + 1] += soff[p];
  }
  std::vector<uint64_t> rrows(n_r), srows(n_s);
  {
    std::vector<uint64_t> cur(roff.begin(), roff.end() - 1);
    for (uint64_t i = 0; i < n_r; ++i) {
      uint32_t p = (uint32_t)rk[i] & pmask;
      rrows[cur[p]++] = ((uint64_t)(uint32_t)rk[i] << 32) | (uint32_t)rp[i];
    }
    cur.assign(soff.begin(), soff.end() - 1);
    for (uint64_t i = 0; i < n_s; ++i) {
      uint32_t p = (uint32_t)sk[i] & pmask;
      srows[cur[p]++] = ((uint64_t)(uint32_t)sk[i] << 32) | (uint32_t)sp[i];
    }
  }

  // Per-partition chained hash table over R, probed by S. Buffers sized to
  // the largest partition and reused.
  uint64_t max_r = 0;
  for (uint32_t p = 0; p < P; ++p)
    max_r = std::max(max_r, roff[p + 1] - roff[p]);
  uint64_t hsize = 1;
  while (hsize < 2 * max_r) hsize <<= 1;
  std::vector<int64_t> heads(hsize);
  std::vector<int64_t> next(max_r);

  uint32_t total = 0;
  for (uint32_t p = 0; p < P; ++p) {
    const uint64_t r_lo = roff[p], r_hi = roff[p + 1];
    const uint64_t s_lo = soff[p], s_hi = soff[p + 1];
    const uint64_t cnt_r = r_hi - r_lo;
    if (cnt_r == 0 || s_hi == s_lo) continue;
    uint64_t h = 1;
    int log2h = 0;
    while (h < 2 * cnt_r) { h <<= 1; ++log2h; }
    // Fibonacci hash MUST take the TOP bits of the product: keys within a
    // partition share their low log_p bits, so the product's low bits are
    // constant across the partition and masking them would collapse the
    // table to h >> log_p effective slots (measured: 2^27 rows degraded
    // to ~2048-long chains and a >1000x probe blowup).
    const uint32_t hshift = (uint32_t)(32 - log2h);
    std::fill(heads.begin(), heads.begin() + h, (int64_t)-1);
    for (uint64_t i = 0; i < cnt_r; ++i) {
      uint32_t key = (uint32_t)(rrows[r_lo + i] >> 32);
      uint32_t slot = (key * 0x9E3779B1u) >> hshift;
      next[i] = heads[slot];
      heads[slot] = (int64_t)i;
    }
    for (uint64_t j = s_lo; j < s_hi; ++j) {
      uint32_t key = (uint32_t)(srows[j] >> 32);
      uint32_t pay = (uint32_t)srows[j];
      uint32_t slot = (key * 0x9E3779B1u) >> hshift;
      for (int64_t pos = heads[slot]; pos >= 0; pos = next[pos]) {
        uint64_t row = rrows[r_lo + (uint64_t)pos];
        if ((uint32_t)(row >> 32) == key) total += (uint32_t)row * pay;
      }
    }
  }
  return (int32_t)total;
}

}  // extern "C"
