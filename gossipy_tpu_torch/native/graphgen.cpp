// Fast P2P topology generation for large simulated networks.
//
// The reference builds its topologies with networkx on the Python side
// (gossipy main_* scripts; StaticP2PNetwork at gossipy/core.py:364-389).
// networkx's pure-Python generators become the setup bottleneck for
// 10k+-node simulations (the TPU engine itself handles such node counts
// easily), so the heavy generators live here: dense bool adjacency written
// straight into a numpy-owned buffer through ctypes, seeded mt19937_64 for
// reproducibility. Graph *semantics* match the classic models (G(n,p),
// pairing-model random regular with retries, Barabasi-Albert preferential
// attachment via the repeated-endpoints trick); exact edge sets differ from
// networkx's RNG stream, so a topology is reproducible per (backend, seed).
//
// Build: see gossipy_tpu/native/__init__.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// G(n, p): every undirected edge present independently with prob p.
void gen_erdos_renyi(int32_t n, double p, uint64_t seed, uint8_t* adj) {
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> u(0.0, 1.0);
    std::memset(adj, 0, (size_t)n * n);
    for (int32_t i = 0; i < n; ++i) {
        for (int32_t j = i + 1; j < n; ++j) {
            if (u(rng) < p) {
                adj[(size_t)i * n + j] = 1;
                adj[(size_t)j * n + i] = 1;
            }
        }
    }
}

// k-regular random graph via the pairing (configuration) model with
// edge-swap repair: shuffle k copies of every vertex, pair adjacent stubs,
// then fix self-loops/multi-edges by double-edge swaps against random good
// edges (whole-graph rejection has acceptance ~e^{-k^2/4} — hopeless for
// k=20; local swaps preserve the degree sequence and a near-uniform draw).
// Returns 0 on success, -1 if n*k is odd or k >= n, -2 if repair failed.
int32_t gen_random_regular(int32_t n, int32_t k, uint64_t seed, uint8_t* adj) {
    if (k >= n || ((int64_t)n * k) % 2 != 0) return -1;
    std::mt19937_64 rng(seed);
    std::vector<int32_t> stubs((size_t)n * k);
    for (int32_t v = 0; v < n; ++v)
        for (int32_t c = 0; c < k; ++c) stubs[(size_t)v * k + c] = v;

    for (int attempt = 0; attempt < 20; ++attempt) {
        std::shuffle(stubs.begin(), stubs.end(), rng);
        std::memset(adj, 0, (size_t)n * n);
        // Accept all pairs; remember the conflicting ones for repair.
        std::vector<std::pair<int32_t, int32_t>> edges;   // good edges
        std::vector<std::pair<int32_t, int32_t>> bad;     // loops/dups
        edges.reserve(stubs.size() / 2);
        for (size_t s = 0; s + 1 < stubs.size(); s += 2) {
            int32_t a = stubs[s], b = stubs[s + 1];
            if (a == b || adj[(size_t)a * n + b]) {
                bad.emplace_back(a, b);
            } else {
                adj[(size_t)a * n + b] = 1;
                adj[(size_t)b * n + a] = 1;
                edges.emplace_back(a, b);
            }
        }
        // Repair: swap each bad pair (a,b) with a random good edge (c,d):
        // (a,b),(c,d) -> (a,c),(b,d). Valid iff both new edges are simple.
        bool ok = true;
        if (edges.empty() && !bad.empty()) ok = false;  // nothing to swap with
        for (auto& ab : bad) {
            if (!ok) break;
            int32_t a = ab.first, b = ab.second;
            bool fixed = false;
            for (int tries = 0; tries < 2000 && !fixed; ++tries) {
                std::uniform_int_distribution<size_t> d(0, edges.size() - 1);
                size_t ei = d(rng);
                int32_t c = edges[ei].first, e = edges[ei].second;
                // Randomize orientation of the picked edge.
                if (rng() & 1) std::swap(c, e);
                if (a == c || a == e || b == c || b == e) continue;
                if (adj[(size_t)a * n + c] || adj[(size_t)b * n + e]) continue;
                adj[(size_t)c * n + e] = 0;
                adj[(size_t)e * n + c] = 0;
                adj[(size_t)a * n + c] = 1;
                adj[(size_t)c * n + a] = 1;
                adj[(size_t)b * n + e] = 1;
                adj[(size_t)e * n + b] = 1;
                edges[ei] = {a, c};
                edges.emplace_back(b, e);
                fixed = true;
            }
            if (!fixed) { ok = false; break; }
        }
        if (ok) return 0;
    }
    return -2;
}

// Barabasi-Albert preferential attachment: start from m connected seeds,
// attach each new node to m distinct targets drawn from the
// repeated-endpoints list (degree-proportional).
void gen_barabasi_albert(int32_t n, int32_t m, uint64_t seed, uint8_t* adj) {
    std::mt19937_64 rng(seed);
    std::memset(adj, 0, (size_t)n * n);
    if (m < 1 || n <= m) return;
    std::vector<int32_t> endpoints;  // every edge contributes both endpoints
    endpoints.reserve((size_t)2 * m * n);
    // Seed: star over the first m+1 nodes (connected, every node has degree>=1).
    for (int32_t v = 1; v <= m; ++v) {
        adj[(size_t)0 * n + v] = 1;
        adj[(size_t)v * n + 0] = 1;
        endpoints.push_back(0);
        endpoints.push_back(v);
    }
    std::vector<int32_t> targets(m);
    for (int32_t v = m + 1; v < n; ++v) {
        int32_t picked = 0;
        while (picked < m) {
            std::uniform_int_distribution<size_t> d(0, endpoints.size() - 1);
            int32_t t = endpoints[d(rng)];
            bool dup = (t == v) || adj[(size_t)v * n + t];
            for (int32_t q = 0; q < picked && !dup; ++q)
                if (targets[q] == t) dup = true;
            if (!dup) targets[picked++] = t;
        }
        for (int32_t q = 0; q < m; ++q) {
            int32_t t = targets[q];
            adj[(size_t)v * n + t] = 1;
            adj[(size_t)t * n + v] = 1;
            endpoints.push_back(v);
            endpoints.push_back(t);
        }
    }
}

// ---------------------------------------------------------------------------
// Edge-list generators for large n.
//
// A dense [n, n] adjacency is ~2.5 GB of host RAM at n = 50k — the scale
// wall of both the reference (gossipy/core.py StaticP2PNetwork keeps a dense
// matrix) and the dense generators above. These emit an undirected edge list
// (int32 pairs, each edge once) that Python folds into a CSR neighbor table;
// membership checks run against per-node neighbor vectors (degree is small,
// a linear scan beats hashing at these sizes).
// ---------------------------------------------------------------------------

static bool nbr_has(const std::vector<std::vector<int32_t>>& nbrs,
                    int32_t a, int32_t b) {
    const auto& v = nbrs[(size_t)a];
    return std::find(v.begin(), v.end(), b) != v.end();
}

static void nbr_add(std::vector<std::vector<int32_t>>& nbrs,
                    int32_t a, int32_t b) {
    nbrs[(size_t)a].push_back(b);
    nbrs[(size_t)b].push_back(a);
}

static void nbr_del(std::vector<std::vector<int32_t>>& nbrs,
                    int32_t a, int32_t b) {
    auto& va = nbrs[(size_t)a];
    va.erase(std::find(va.begin(), va.end(), b));
    auto& vb = nbrs[(size_t)b];
    vb.erase(std::find(vb.begin(), vb.end(), a));
}

// k-regular pairing model, edge-list output (same algorithm as
// gen_random_regular above, neighbor vectors instead of a dense matrix).
// Writes n*k/2 (a, b) pairs into out; returns the edge count, -1 on invalid
// (n*k odd or k >= n), -2 if repair failed.
int64_t gen_random_regular_edges(int32_t n, int32_t k, uint64_t seed,
                                 int32_t* out) {
    if (k >= n || ((int64_t)n * k) % 2 != 0) return -1;
    std::mt19937_64 rng(seed);
    std::vector<int32_t> stubs((size_t)n * k);
    for (int32_t v = 0; v < n; ++v)
        for (int32_t c = 0; c < k; ++c) stubs[(size_t)v * k + c] = v;

    for (int attempt = 0; attempt < 20; ++attempt) {
        std::shuffle(stubs.begin(), stubs.end(), rng);
        std::vector<std::vector<int32_t>> nbrs(n);
        for (auto& v : nbrs) v.reserve(k);
        std::vector<std::pair<int32_t, int32_t>> edges, bad;
        edges.reserve(stubs.size() / 2);
        for (size_t s = 0; s + 1 < stubs.size(); s += 2) {
            int32_t a = stubs[s], b = stubs[s + 1];
            if (a == b || nbr_has(nbrs, a, b)) {
                bad.emplace_back(a, b);
            } else {
                nbr_add(nbrs, a, b);
                edges.emplace_back(a, b);
            }
        }
        bool ok = true;
        if (edges.empty() && !bad.empty()) ok = false;
        for (auto& ab : bad) {
            if (!ok) break;
            int32_t a = ab.first, b = ab.second;
            bool fixed = false;
            for (int tries = 0; tries < 2000 && !fixed; ++tries) {
                std::uniform_int_distribution<size_t> d(0, edges.size() - 1);
                size_t ei = d(rng);
                int32_t c = edges[ei].first, e = edges[ei].second;
                if (rng() & 1) std::swap(c, e);
                if (a == c || a == e || b == c || b == e) continue;
                if (nbr_has(nbrs, a, c) || nbr_has(nbrs, b, e)) continue;
                nbr_del(nbrs, c, e);
                nbr_add(nbrs, a, c);
                nbr_add(nbrs, b, e);
                edges[ei] = {a, c};
                edges.emplace_back(b, e);
                fixed = true;
            }
            if (!fixed) { ok = false; break; }
        }
        if (ok) {
            int64_t m = (int64_t)edges.size();
            for (int64_t i = 0; i < m; ++i) {
                out[2 * i] = edges[(size_t)i].first;
                out[2 * i + 1] = edges[(size_t)i].second;
            }
            return m;
        }
    }
    return -2;
}

// G(n, p) via geometric skip-sampling over the upper triangle: O(E + n)
// instead of O(n^2) Bernoulli draws. Writes up to cap edges; returns the
// total edge count (callers retry with a bigger buffer if count > cap).
int64_t gen_erdos_renyi_edges(int32_t n, double p, uint64_t seed,
                              int32_t* out, int64_t cap) {
    if (p <= 0.0 || n < 2) return 0;
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> u(0.0, 1.0);
    const double log1mp = std::log(1.0 - p);
    int64_t count = 0;
    int32_t i = 0, j = 0;  // j walks the row's remaining slots (i+1..n-1)
    // Positions advance by 1 + Geom(p) over the flattened upper triangle.
    int64_t pos = -1;
    const int64_t total = (int64_t)n * (n - 1) / 2;
    while (true) {
        double r = u(rng);
        int64_t skip = (p >= 1.0) ? 1
            : 1 + (int64_t)(std::log(1.0 - r) / log1mp);
        pos += skip;
        if (pos >= total) break;
        // Map linear pos -> (i, j) by walking rows (amortized O(n) overall).
        while (true) {
            int64_t row_len = n - 1 - i;
            int64_t row_start = (int64_t)i * (2 * n - i - 1) / 2;
            if (pos < row_start + row_len) { j = (int32_t)(i + 1 + (pos - row_start)); break; }
            ++i;
        }
        if (count < cap) {
            out[2 * count] = i;
            out[2 * count + 1] = j;
        }
        ++count;
    }
    return count;
}

// Barabasi-Albert, edge-list output (same repeated-endpoints model as
// gen_barabasi_albert above). Edge count is exactly m * (n - m - 1) + m.
int64_t gen_barabasi_albert_edges(int32_t n, int32_t m, uint64_t seed,
                                  int32_t* out) {
    if (m < 1 || n <= m) return 0;
    std::mt19937_64 rng(seed);
    std::vector<std::vector<int32_t>> nbrs(n);
    std::vector<int32_t> endpoints;
    endpoints.reserve((size_t)2 * m * n);
    int64_t count = 0;
    for (int32_t v = 1; v <= m; ++v) {
        nbr_add(nbrs, 0, v);
        endpoints.push_back(0);
        endpoints.push_back(v);
        out[2 * count] = 0;
        out[2 * count + 1] = v;
        ++count;
    }
    std::vector<int32_t> targets(m);
    for (int32_t v = m + 1; v < n; ++v) {
        int32_t picked = 0;
        while (picked < m) {
            std::uniform_int_distribution<size_t> d(0, endpoints.size() - 1);
            int32_t t = endpoints[d(rng)];
            bool dup = (t == v) || nbr_has(nbrs, v, t);
            for (int32_t q = 0; q < picked && !dup; ++q)
                if (targets[q] == t) dup = true;
            if (!dup) targets[picked++] = t;
        }
        for (int32_t q = 0; q < m; ++q) {
            int32_t t = targets[q];
            nbr_add(nbrs, v, t);
            endpoints.push_back(v);
            endpoints.push_back(t);
            out[2 * count] = v;
            out[2 * count + 1] = t;
            ++count;
        }
    }
    return count;
}

// Ring lattice: each node linked to its k nearest neighbors per side.
void gen_ring(int32_t n, int32_t k, uint8_t* adj) {
    std::memset(adj, 0, (size_t)n * n);
    for (int32_t i = 0; i < n; ++i) {
        for (int32_t d = 1; d <= k; ++d) {
            int32_t a = (i + d) % n, b = ((i - d) % n + n) % n;
            adj[(size_t)i * n + a] = 1;
            adj[(size_t)i * n + b] = 1;
        }
    }
}

}  // extern "C"
