// Native CPU-sampler benchmark (parity: the reference's C++ micro-
// benchmarks under tests/cpp/).  Measures multi-hop sampled-edges/sec at
// ogbn-products scale against the reference's CPU baseline of 1.84M SEPS
// (docs/Introduction_en.md:38-41).
//
// Build/run: g++ -O3 -std=c++17 -pthread -o bench_quiver_cpu \
//                quiver_cpu.cpp bench_quiver_cpu.cpp && ./bench_quiver_cpu [N E]

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <random>
#include <vector>

extern "C" {
void qt_sample(const int64_t*, const int32_t*, const int32_t*,
               const uint8_t*, int64_t, int32_t, uint64_t, int32_t,
               int32_t*, uint8_t*, int32_t*);
}

int main(int argc, char** argv) {
    const int64_t N = argc > 1 ? atoll(argv[1]) : 2'449'029;
    const int64_t E = argc > 2 ? atoll(argv[2]) : 123'718'280;
    const int sizes[3] = {15, 10, 5};
    const int64_t B = 1024;
    const int iters = 10;

    // lognormal-ish degree profile, like utils/synthetic.py
    std::mt19937_64 rng(0);
    std::lognormal_distribution<double> logn(3.0, 1.0);
    std::vector<double> raw(N);
    double tot = 0;
    for (auto& r : raw) tot += (r = logn(rng));
    std::vector<int64_t> indptr(N + 1, 0);
    for (int64_t i = 0; i < N; ++i) {
        int64_t d = (int64_t)(raw[i] / tot * E);
        indptr[i + 1] = indptr[i] + (d < 1 ? 1 : d);
    }
    const int64_t e_real = indptr[N];
    std::vector<int32_t> indices(e_real);
    for (auto& x : indices) x = (int32_t)(rng() % N);
    std::printf("graph: N=%lld E=%lld\n", (long long)N, (long long)e_real);

    // multi-hop, no-dedup positional frontier (mirrors the TPU pipeline)
    auto t0 = std::chrono::steady_clock::now();
    int64_t edges = 0;
    for (int it = 0; it < iters; ++it) {
        std::vector<int32_t> frontier(B);
        std::vector<uint8_t> fmask(B, 1);
        for (auto& s : frontier) s = (int32_t)(rng() % N);
        for (int l = 0; l < 3; ++l) {
            const int32_t k = sizes[l];
            const int64_t F = (int64_t)frontier.size();
            std::vector<int32_t> nbrs(F * k), counts(F);
            std::vector<uint8_t> mask(F * k);
            qt_sample(indptr.data(), indices.data(), frontier.data(),
                      fmask.data(), F, k, 7 + it * 31 + l, 0,
                      nbrs.data(), mask.data(), counts.data());
            for (int64_t i = 0; i < F; ++i) edges += counts[i];
            frontier.reserve(F + F * k);
            fmask.reserve(F + F * k);
            for (int64_t i = 0; i < F * k; ++i) {
                frontier.push_back(mask[i] ? nbrs[i] : 0);
                fmask.push_back(mask[i]);
            }
        }
    }
    double dt = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0
    ).count();
    std::printf(
        "CPU sampling: %d batches of %lld, fanout [15,10,5]: "
        "%.2fM SEPS (%lld edges in %.2fs)\n"
        "reference CPU baseline: 1.84M SEPS\n",
        iters, (long long)B, edges / dt / 1e6, (long long)edges, dt);
    return 0;
}
