// Native self-test for quiver_cpu.cpp (parity: tests/cpp/test_quiver_cpu.cpp
// in the reference — generated-graph fixtures, sample-validity properties).
// Build/run: g++ -O3 -std=c++17 -pthread -o test_quiver_cpu \
//                quiver_cpu.cpp test_quiver_cpu.cpp && ./test_quiver_cpu
// (tests/test_torch_native.py builds it into build/quiver_tpu_torch/).

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <random>
#include <set>
#include <vector>

extern "C" {
void qt_sample(const int64_t*, const int32_t*, const int32_t*,
               const uint8_t*, int64_t, int32_t, uint64_t, int32_t,
               int32_t*, uint8_t*, int32_t*);
int64_t qt_reindex(const int32_t*, const uint8_t*, int64_t, const int32_t*,
                   const uint8_t*, int32_t, int32_t*, uint8_t*, int32_t*);
void qt_coo_to_csr(const int64_t*, const int64_t*, int64_t, int64_t,
                   int64_t*, int32_t*, int64_t*);
void qt_sample_weighted(const int64_t*, const int32_t*, const float*,
                        const int32_t*, const uint8_t*, int64_t, int32_t,
                        uint64_t, int32_t, int32_t*, uint8_t*, int32_t*);
void qt_neighbour_num(const int64_t*, const int32_t*, int64_t,
                      const int32_t*, int32_t, uint64_t, int32_t, int64_t*);
}

int main() {
    // --- random graph fixture
    const int64_t N = 500;
    std::mt19937_64 rng(7);
    std::vector<int64_t> src, dst;
    for (int64_t v = 0; v < N; ++v) {
        int64_t d = rng() % 12;
        for (int64_t j = 0; j < d; ++j) {
            src.push_back(v);
            dst.push_back((int64_t)(rng() % N));
        }
    }
    const int64_t E = (int64_t)src.size();
    std::vector<int64_t> indptr(N + 1), eid(E);
    std::vector<int32_t> indices(E);
    qt_coo_to_csr(src.data(), dst.data(), E, N, indptr.data(),
                  indices.data(), eid.data());
    assert(indptr[0] == 0 && indptr[N] == E);
    for (int64_t i = 0; i < N; ++i) assert(indptr[i] <= indptr[i + 1]);
    // eid maps back: dst[eid[p]] == indices[p]
    for (int64_t p = 0; p < E; ++p) assert(dst[(size_t)eid[p]] == indices[p]);

    // --- sampling properties: subset + counts + distinct positions
    const int32_t k = 5;
    std::vector<int32_t> seeds(N);
    for (int64_t i = 0; i < N; ++i) seeds[i] = (int32_t)i;
    std::vector<int32_t> nbrs(N * k), counts(N);
    std::vector<uint8_t> mask(N * k);
    qt_sample(indptr.data(), indices.data(), seeds.data(), nullptr, N, k,
              123, 4, nbrs.data(), mask.data(), counts.data());
    for (int64_t v = 0; v < N; ++v) {
        int64_t deg = indptr[v + 1] - indptr[v];
        int64_t expect = deg < k ? deg : k;
        assert(counts[v] == expect);
        std::multiset<int32_t> row(indices.begin() + indptr[v],
                                   indices.begin() + indptr[v + 1]);
        for (int32_t j = 0; j < k; ++j) {
            if (j < expect) {
                assert(mask[v * k + j]);
                assert(row.count(nbrs[v * k + j]) > 0);
            } else {
                assert(!mask[v * k + j]);
            }
        }
    }

    // --- reindex: seeds-first, bijection, resolvable locals
    const int64_t B = 32;
    std::vector<int32_t> n_id(B + B * k), local(B * k);
    std::vector<uint8_t> n_mask(B + B * k);
    int64_t num = qt_reindex(seeds.data(), nullptr, B, nbrs.data(),
                             mask.data(), k, n_id.data(), n_mask.data(),
                             local.data());
    std::set<int32_t> uniq;
    for (int64_t i = 0; i < B + B * k; ++i)
        if (n_mask[i]) uniq.insert(n_id[i]);
    assert((int64_t)uniq.size() == num);
    for (int64_t b = 0; b < B; ++b) assert(n_id[b] == seeds[b]);
    for (int64_t i = 0; i < B * k; ++i)
        if (mask[i]) assert(n_id[local[i]] == nbrs[i]);

    // --- weighted sampling: subset + counts, multithreaded
    {
        std::vector<float> cumw(E);
        for (int64_t v = 0; v < N; ++v) {
            float acc = 0.f;
            for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p)
                cumw[p] = (acc += 1.0f + (float)(p % 3));
        }
        std::vector<int32_t> wn(N * k), wc(N);
        std::vector<uint8_t> wm(N * k);
        qt_sample_weighted(indptr.data(), indices.data(), cumw.data(),
                           seeds.data(), nullptr, N, k, 77, 4, wn.data(),
                           wm.data(), wc.data());
        for (int64_t v = 0; v < N; ++v) {
            int64_t deg = indptr[v + 1] - indptr[v];
            assert(wc[v] == (deg < k ? deg : k));
            std::multiset<int32_t> row(indices.begin() + indptr[v],
                                       indices.begin() + indptr[v + 1]);
            for (int32_t j = 0; j < wc[v]; ++j)
                assert(row.count(wn[v * k + j]) > 0);
        }
    }

    // --- neighbour_num: zero-degree rows expand to zero
    std::vector<int64_t> nn(N);
    int32_t sizes[2] = {3, 2};
    qt_neighbour_num(indptr.data(), indices.data(), N, sizes, 2, 9, 4,
                     nn.data());
    for (int64_t v = 0; v < N; ++v)
        if (indptr[v + 1] == indptr[v]) assert(nn[v] == 0);

    std::printf("native self-test OK (N=%lld E=%lld)\n",
                (long long)N, (long long)E);
    return 0;
}
