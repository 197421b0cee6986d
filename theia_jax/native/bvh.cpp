// Threaded-BVH builder (binned SAH with median fallback, skip links).
//
// Replacement for the runtime the reference gets from Vulkan's
// BLAS build (hephaistos GeometryStore): the host builds a flat, stackless
// BVH whose traversal needs only a single node index per lane — the layout
// consumed by theia_jax/ops/bvh_traverse.py.
//
// Nodes are emitted depth-first. Every node carries a "miss" link: the node
// to visit when its AABB is missed (or after a leaf is processed); interior
// hits continue at node+1. Leaves reference a contiguous range of the
// permuted triangle order.
//
// Build: g++ -O3 -shared -fPIC -o libbvh.so bvh.cpp
// (loaded via ctypes; a numpy fallback with identical output lives in
// theia_jax/native/__init__.py)

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

}  // namespace

extern "C" {

// Two-pass API: first call returns node count; second fills the buffers.
// For simplicity the builder runs once per call (scenes are built rarely).
int32_t bvh_node_count(const float* v0, const float* e1, const float* e2,
                       int32_t n_tri, int32_t leaf_size);

int32_t bvh_build(const float* v0, const float* e1, const float* e2,
                  int32_t n_tri, int32_t leaf_size,
                  float* out_bmin, float* out_bmax, int32_t* out_miss,
                  int32_t* out_start, int32_t* out_count, int32_t* out_order);

}  // extern "C"

namespace {

// Full builder with correct miss links: iterative post-processing pass.
struct FlatBuilder {
    const float* v0; const float* e1; const float* e2;
    int leaf_size;
    std::vector<float> cent;
    std::vector<int32_t> order;
    std::vector<float> bmin, bmax;
    std::vector<int32_t> miss, start, count;

    void tri_bounds(int32_t t, float* lo, float* hi) const {
        for (int c = 0; c < 3; ++c) {
            float a = v0[3 * t + c];
            float b = a + e1[3 * t + c];
            float d = a + e2[3 * t + c];
            lo[c] = std::min(a, std::min(b, d));
            hi[c] = std::max(a, std::max(b, d));
        }
    }

    // emit node for range [lo,hi); miss_to = where to go on miss
    void build(int32_t lo, int32_t hi, int32_t miss_to) {
        int32_t node = static_cast<int32_t>(miss.size());
        bmin.insert(bmin.end(), {1e38f, 1e38f, 1e38f});
        bmax.insert(bmax.end(), {-1e38f, -1e38f, -1e38f});
        miss.push_back(miss_to);
        start.push_back(-1);
        count.push_back(0);

        float tl[3], th[3];
        for (int32_t i = lo; i < hi; ++i) {
            tri_bounds(order[i], tl, th);
            for (int c = 0; c < 3; ++c) {
                bmin[3 * node + c] = std::min(bmin[3 * node + c], tl[c]);
                bmax[3 * node + c] = std::max(bmax[3 * node + c], th[c]);
            }
        }

        if (hi - lo <= leaf_size) {
            start[node] = lo;
            count[node] = hi - lo;
            return;
        }

        float clo[3] = {1e38f, 1e38f, 1e38f};
        float chi[3] = {-1e38f, -1e38f, -1e38f};
        for (int32_t i = lo; i < hi; ++i) {
            for (int c = 0; c < 3; ++c) {
                float v = cent[3 * order[i] + c];
                clo[c] = std::min(clo[c], v);
                chi[c] = std::max(chi[c], v);
            }
        }
        int axis = 0;
        float width = chi[0] - clo[0];
        for (int c = 1; c < 3; ++c) {
            if (chi[c] - clo[c] > width) { width = chi[c] - clo[c]; axis = c; }
        }

        // binned SAH over the widest centroid axis; areas/costs in double
        // over exact float32 bounds so the numpy twin makes bit-identical
        // decisions. Median split fallback when SAH cannot separate.
        int32_t mid = -1;
        if (width > 0.0f) {
            constexpr int B = 16;  // _SAH_BINS in native/__init__.py
            const float scale = static_cast<float>(B) / width;
            int32_t nb[B] = {0};
            float blo[B][3], bhi[B][3];
            for (int b = 0; b < B; ++b) {
                for (int c = 0; c < 3; ++c) { blo[b][c] = 1e38f; bhi[b][c] = -1e38f; }
            }
            float tl[3], th[3];
            for (int32_t i = lo; i < hi; ++i) {
                float cc = cent[3 * order[i] + axis];
                int b = static_cast<int>((cc - clo[axis]) * scale);
                b = std::min(b, B - 1);
                ++nb[b];
                tri_bounds(order[i], tl, th);
                for (int c = 0; c < 3; ++c) {
                    blo[b][c] = std::min(blo[b][c], tl[c]);
                    bhi[b][c] = std::max(bhi[b][c], th[c]);
                }
            }
            auto half_area = [](const float* l, const float* h) -> double {
                double dx = double(h[0]) - double(l[0]);
                double dy = double(h[1]) - double(l[1]);
                double dz = double(h[2]) - double(l[2]);
                if (dx < 0 || dy < 0 || dz < 0) return 0.0;
                return dx * dy + dy * dz + dz * dx;
            };
            double best_cost = 1e300;
            int best_k = -1;
            for (int k = 0; k < B - 1; ++k) {
                int32_t n_l = 0, n_r = 0;
                float llo[3] = {1e38f, 1e38f, 1e38f}, lhi[3] = {-1e38f, -1e38f, -1e38f};
                float rlo[3] = {1e38f, 1e38f, 1e38f}, rhi[3] = {-1e38f, -1e38f, -1e38f};
                for (int b = 0; b <= k; ++b) {
                    n_l += nb[b];
                    for (int c = 0; c < 3; ++c) {
                        llo[c] = std::min(llo[c], blo[b][c]);
                        lhi[c] = std::max(lhi[c], bhi[b][c]);
                    }
                }
                for (int b = k + 1; b < B; ++b) {
                    n_r += nb[b];
                    for (int c = 0; c < 3; ++c) {
                        rlo[c] = std::min(rlo[c], blo[b][c]);
                        rhi[c] = std::max(rhi[c], bhi[b][c]);
                    }
                }
                if (n_l == 0 || n_r == 0) continue;
                double cost = half_area(llo, lhi) * n_l + half_area(rlo, rhi) * n_r;
                if (cost < best_cost) { best_cost = cost; best_k = k; }
            }
            if (best_k >= 0) {
                auto it = std::stable_partition(
                    order.begin() + lo, order.begin() + hi,
                    [&](int32_t t) {
                        float cc = cent[3 * t + axis];
                        int b = static_cast<int>((cc - clo[axis]) * scale);
                        return std::min(b, B - 1) <= best_k;
                    });
                mid = static_cast<int32_t>(it - order.begin());
            }
        }
        if (mid < 0) {
            mid = (lo + hi) / 2;
            std::nth_element(
                order.begin() + lo, order.begin() + mid, order.begin() + hi,
                [&](int32_t a, int32_t b) {
                    return cent[3 * a + axis] < cent[3 * b + axis];
                });
        }

        // left child is node+1; on miss of left subtree continue at the
        // right subtree, whose first node index we know only after building
        // the left — build left, then right; right misses to our miss
        int32_t left_first = static_cast<int32_t>(miss.size());
        (void)left_first;
        // reserve: build left with miss -> (index of right subtree)
        // we need the right subtree index first: build left into a scratch?
        // Simplest: build left, remember where right starts, then patch the
        // left subtree's terminal miss links — but every node in the left
        // subtree already points correctly *within* the subtree; only links
        // equal to `miss_to_placeholder` need patching. Use a unique
        // placeholder: -2 - node.
        int32_t placeholder = -2 - node;
        build(lo, mid, placeholder);
        int32_t right_first = static_cast<int32_t>(miss.size());
        for (size_t i = left_first; i < static_cast<size_t>(right_first); ++i) {
            if (miss[i] == placeholder) miss[i] = right_first;
        }
        build(mid, hi, miss_to);
    }

    void run(int32_t n_tri) {
        cent.resize(3 * n_tri);
        for (int32_t t = 0; t < n_tri; ++t) {
            for (int c = 0; c < 3; ++c) {
                cent[3 * t + c] =
                    v0[3 * t + c] + (e1[3 * t + c] + e2[3 * t + c]) / 3.0f;
            }
        }
        order.resize(n_tri);
        std::iota(order.begin(), order.end(), 0);
        build(0, n_tri, -1);
    }
};

}  // namespace

int32_t bvh_node_count(const float* v0, const float* e1, const float* e2,
                       int32_t n_tri, int32_t leaf_size) {
    FlatBuilder b{v0, e1, e2, leaf_size};
    b.run(n_tri);
    return static_cast<int32_t>(b.miss.size());
}

int32_t bvh_build(const float* v0, const float* e1, const float* e2,
                  int32_t n_tri, int32_t leaf_size,
                  float* out_bmin, float* out_bmax, int32_t* out_miss,
                  int32_t* out_start, int32_t* out_count, int32_t* out_order) {
    FlatBuilder b{v0, e1, e2, leaf_size};
    b.run(n_tri);
    const int32_t m = static_cast<int32_t>(b.miss.size());
    std::copy(b.bmin.begin(), b.bmin.end(), out_bmin);
    std::copy(b.bmax.begin(), b.bmax.end(), out_bmax);
    std::copy(b.miss.begin(), b.miss.end(), out_miss);
    std::copy(b.start.begin(), b.start.end(), out_start);
    std::copy(b.count.begin(), b.count.end(), out_count);
    std::copy(b.order.begin(), b.order.end(), out_order);
    return m;
}
