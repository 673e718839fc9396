// Native host-side sampler for quiver_tpu.
//
// Reference parity: the CPU sampler core (srcs/cpp/include/quiver/
// quiver.cpu.hpp:31-104) and CPUQuiver bindings (srcs/cpp/src/quiver/
// quiver.cpp:11-85).  Same contract as the TPU ops: dense [B, k] neighbor
// blocks + masks, dedup/relabel with seeds-first frontier and id-sorted
// remainder, so CPU and TPU backends are interchangeable bit-for-bit in
// structure (sampling randomness differs by backend, as in the reference).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// splitmix64: cheap, seedable, stateless per-seed streams.
static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed) {}
    uint64_t next() { return s = splitmix64(s); }
    // unbiased-enough range sample for sampling use
    int64_t below(int64_t n) { return (int64_t)(next() % (uint64_t)n); }
};

}  // namespace

extern "C" {

// One-hop sampling: up to k distinct neighbors per seed (reservoir, like
// quiver.cpu.hpp:60-104 which uses std::sample).  Parallel over seed chunks.
void qt_sample(const int64_t* indptr, const int32_t* indices,
               const int32_t* seeds, const uint8_t* seed_mask, int64_t B,
               int32_t k, uint64_t rng_seed, int32_t n_threads,
               int32_t* out_nbrs, uint8_t* out_mask, int32_t* out_counts) {
    if (n_threads <= 0) {
        n_threads = (int32_t)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 1;
    }
    auto work = [&](int64_t lo, int64_t hi) {
        std::vector<int64_t> res(k);
        for (int64_t b = lo; b < hi; ++b) {
            int32_t* nb = out_nbrs + b * k;
            uint8_t* mk = out_mask + b * k;
            if (seed_mask && !seed_mask[b]) {
                out_counts[b] = 0;
                std::memset(mk, 0, k);
                std::fill(nb, nb + k, -1);
                continue;
            }
            const int64_t s = seeds[b];
            const int64_t beg = indptr[s], end = indptr[s + 1];
            const int64_t deg = end - beg;
            const int64_t cnt = deg < k ? deg : k;
            out_counts[b] = (int32_t)cnt;
            Rng rng(rng_seed * 0x2545F4914F6CDD1DULL + (uint64_t)b);
            if (deg <= k) {
                for (int64_t j = 0; j < cnt; ++j) nb[j] = indices[beg + j];
            } else {
                // reservoir over positions
                for (int64_t j = 0; j < k; ++j) res[j] = j;
                for (int64_t j = k; j < deg; ++j) {
                    int64_t r = rng.below(j + 1);
                    if (r < k) res[r] = j;
                }
                for (int64_t j = 0; j < k; ++j)
                    nb[j] = indices[beg + res[j]];
            }
            for (int64_t j = 0; j < k; ++j) mk[j] = j < cnt;
            for (int64_t j = cnt; j < k; ++j) nb[j] = -1;
        }
    };
    if (n_threads == 1 || B < 256) {
        work(0, B);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (B + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk, hi = std::min(B, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
}

// Weighted one-hop sampling WITH replacement (parity: the reference's
// weight_sample thrust path, cuda_random.cu.hpp:149-221).  cumw is the
// per-row inclusive cumulative weight array produced by
// quiver_tpu.ops.sample.row_cumsum_weights — the same artifact the TPU
// weighted sampler uses, so CPU/TPU draws share one distribution.
void qt_sample_weighted(const int64_t* indptr, const int32_t* indices,
                        const float* cumw, const int32_t* seeds,
                        const uint8_t* seed_mask, int64_t B, int32_t k,
                        uint64_t rng_seed, int32_t n_threads,
                        int32_t* out_nbrs, uint8_t* out_mask,
                        int32_t* out_counts) {
    if (n_threads <= 0) {
        n_threads = (int32_t)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 1;
    }
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t b = lo; b < hi; ++b) {
            int32_t* nb = out_nbrs + b * k;
            uint8_t* mk = out_mask + b * k;
            if (seed_mask && !seed_mask[b]) {
                out_counts[b] = 0;
                std::memset(mk, 0, k);
                std::fill(nb, nb + k, -1);
                continue;
            }
            const int64_t s = seeds[b];
            const int64_t beg = indptr[s], end = indptr[s + 1];
            const int64_t deg = end - beg;
            const int64_t cnt = deg < k ? deg : k;
            out_counts[b] = (int32_t)cnt;
            Rng rng(rng_seed * 0x2545F4914F6CDD1DULL + (uint64_t)b);
            if (deg <= k) {  // all neighbors once (mask contract parity)
                for (int64_t j = 0; j < cnt; ++j) nb[j] = indices[beg + j];
            } else {
                const float total = cumw[end - 1];
                for (int64_t j = 0; j < k; ++j) {
                    // 53-bit uniform in [0, total)
                    double u = (double)(rng.next() >> 11) * 0x1p-53 * total;
                    const float* p = std::upper_bound(
                        cumw + beg, cumw + end, (float)u);
                    int64_t pos = p - (cumw + beg);
                    if (pos >= deg) pos = deg - 1;
                    nb[j] = indices[beg + pos];
                }
            }
            for (int64_t j = 0; j < k; ++j) mk[j] = j < cnt;
            for (int64_t j = cnt; j < k; ++j) nb[j] = -1;
        }
    };
    if (n_threads == 1 || B < 256) {
        work(0, B);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (B + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk, hi = std::min(B, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
}

// Dedup + relabel, same contract as quiver_tpu.ops.reindex: n_id holds the
// (valid) seeds in their original slots, then the unique non-seed neighbors
// in ascending id order.  Returns the number of valid frontier nodes.
int64_t qt_reindex(const int32_t* seeds, const uint8_t* seed_mask, int64_t B,
                   const int32_t* nbrs, const uint8_t* mask, int32_t k,
                   int32_t* n_id, uint8_t* n_id_mask, int32_t* local_nbrs) {
    std::unordered_map<int32_t, int32_t> table;
    table.reserve((size_t)(B * 2));
    int64_t valid_seeds = 0;
    for (int64_t b = 0; b < B; ++b) {
        bool v = !seed_mask || seed_mask[b];
        n_id[b] = v ? seeds[b] : 0;
        n_id_mask[b] = v;
        if (v) {
            table.emplace(seeds[b], (int32_t)b);
            ++valid_seeds;
        }
    }
    std::vector<int32_t> rest;
    rest.reserve((size_t)(B * k));
    for (int64_t i = 0; i < B * k; ++i) {
        if (!mask[i]) continue;
        if (table.find(nbrs[i]) == table.end()) rest.push_back(nbrs[i]);
    }
    std::sort(rest.begin(), rest.end());
    rest.erase(std::unique(rest.begin(), rest.end()), rest.end());
    for (size_t r = 0; r < rest.size(); ++r) {
        n_id[B + r] = rest[r];
        n_id_mask[B + r] = 1;
        table.emplace(rest[r], (int32_t)(B + r));
    }
    for (int64_t i = rest.size() + B; i < B + B * k; ++i) {
        n_id[i] = 0;
        n_id_mask[i] = 0;
    }
    for (int64_t i = 0; i < B * k; ++i)
        local_nbrs[i] = mask[i] ? table[nbrs[i]] : 0;
    return valid_seeds + (int64_t)rest.size();
}

// COO -> CSR counting sort (parity: sparse.hpp:8-32 / quiver_sample.cu:463).
void qt_coo_to_csr(const int64_t* src, const int64_t* dst, int64_t E,
                   int64_t N, int64_t* indptr, int32_t* indices,
                   int64_t* eid) {
    std::vector<int64_t> cnt((size_t)N + 1, 0);
    for (int64_t e = 0; e < E; ++e) cnt[(size_t)src[e] + 1]++;
    for (int64_t i = 0; i < N; ++i) cnt[(size_t)i + 1] += cnt[(size_t)i];
    std::memcpy(indptr, cnt.data(), sizeof(int64_t) * (size_t)(N + 1));
    std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
    for (int64_t e = 0; e < E; ++e) {
        int64_t p = cur[(size_t)src[e]]++;
        indices[p] = (int32_t)dst[e];
        if (eid) eid[p] = e;
    }
}

// Per-node expanded-neighborhood size (drives serving's request routing;
// parity: generate_neighbour_num.py:10-95).  For each node, run the fanout
// expansion counting *expected* sampled counts: prod over layers of
// min(deg, k) growth, computed exactly by BFS with multiplicities capped.
// Here we do the same thing the reference does: actually sample once.
void qt_neighbour_num(const int64_t* indptr, const int32_t* indices,
                      int64_t N, const int32_t* sizes, int32_t n_layers,
                      uint64_t rng_seed, int32_t n_threads, int64_t* out) {
    if (n_threads <= 0) {
        n_threads = (int32_t)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 1;
    }
    auto work = [&](int64_t lo, int64_t hi) {
        std::vector<int32_t> frontier, next;
        for (int64_t v = lo; v < hi; ++v) {
            frontier.assign(1, (int32_t)v);
            int64_t total = 0;
            Rng rng(rng_seed * 0x9E3779B97F4A7C15ULL + (uint64_t)v);
            for (int32_t l = 0; l < n_layers; ++l) {
                const int32_t k = sizes[l];
                next.clear();
                for (int32_t u : frontier) {
                    int64_t beg = indptr[u], deg = indptr[u + 1] - beg;
                    int64_t cnt = deg < k ? deg : k;
                    if (deg <= k) {
                        for (int64_t j = 0; j < cnt; ++j)
                            next.push_back(indices[beg + j]);
                    } else {
                        for (int64_t j = 0; j < k; ++j)
                            next.push_back(indices[beg + rng.below(deg)]);
                    }
                }
                total += (int64_t)next.size();
                frontier.swap(next);
            }
            out[v] = total;
        }
    };
    std::vector<std::thread> ts;
    int64_t chunk = (N + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk, hi = std::min(N, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
}

}  // extern "C"
