// graphcore — native graph preprocessing for dorylus_tpu.
//
// The host-side analog of the reference's C++ graph tier:
//   - DataLoader::preprocess / setEdgeNormalizations
//     (src/graph-server/graph/dataloader.cpp): edge classification,
//     degrees, GCN symmetric norm factors
//   - inputs/partitioner.cpp (METIS k-way): replaced by a deterministic
//     linear greedy (LDG) streaming partitioner
//   - the CSC/CSR construction of graph.hpp:96-98
// plus the hot sort used by the Pallas chain-plan builder
// (dorylus_tpu/ops/pallas_spmm.py): a parallel composite-key sort that
// replaces numpy lexsort on hundreds of millions of edges.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Build: make -C native   (g++ -O3 -march=native -fopenmp)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#include <parallel/algorithm>
#define GC_SORT __gnu_parallel::sort
#else
#define GC_SORT std::sort
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Counting sort of edges by dst (stable): the CSC layout of the reference's
// forwardAdj. Returns the permutation in `order` (apply with numpy fancy
// indexing on the Python side — keeps this ABI allocation-free).
// ---------------------------------------------------------------------------
void gc_sort_by_dst(const int32_t* dst, int64_t e, int32_t num_v,
                    int64_t* order) {
    std::vector<int64_t> cnt((size_t)num_v + 1, 0);
    for (int64_t i = 0; i < e; ++i) cnt[(size_t)dst[i] + 1]++;
    for (int64_t v = 0; v < num_v; ++v) cnt[v + 1] += cnt[v];
    for (int64_t i = 0; i < e; ++i) order[cnt[dst[i]]++] = i;
}

// ---------------------------------------------------------------------------
// In-degrees + GCN symmetric normalization:
//   deg~(v) = in_degree(v) + 1
//   edge (u->v): (deg~ u)^-1/2 (deg~ v)^-1/2 ; self(v) = deg~(v)^-1
// (dataloader.cpp:153-185)
// ---------------------------------------------------------------------------
void gc_gcn_norms(const int32_t* src, const int32_t* dst, int64_t e,
                  int32_t num_v, int64_t* in_degree, float* edge_norm,
                  float* self_norm) {
    std::memset(in_degree, 0, sizeof(int64_t) * (size_t)num_v);
    for (int64_t i = 0; i < e; ++i) in_degree[dst[i]]++;
    std::vector<float> inv_sqrt((size_t)num_v);
#pragma omp parallel for
    for (int64_t v = 0; v < num_v; ++v) {
        double d = (double)in_degree[v] + 1.0;
        inv_sqrt[v] = (float)(1.0 / std::sqrt(d));
        self_norm[v] = (float)(1.0 / d);
    }
#pragma omp parallel for
    for (int64_t i = 0; i < e; ++i)
        edge_norm[i] = inv_sqrt[src[i]] * inv_sqrt[dst[i]];
}

// ---------------------------------------------------------------------------
// Parallel sort by a caller-built uint64 composite key; returns permutation.
// Used for the chain-plan lexsort (dst_block | window | dst) and any other
// multi-key edge ordering.
// ---------------------------------------------------------------------------
void gc_sort_by_key64(const uint64_t* key, int64_t n, int64_t* order) {
    struct KV { uint64_t k; int64_t i; };
    std::vector<KV> kv((size_t)n);
#pragma omp parallel for
    for (int64_t i = 0; i < n; ++i) kv[i] = {key[i], i};
    GC_SORT(kv.begin(), kv.end(), [](const KV& a, const KV& b) {
        return a.k < b.k || (a.k == b.k && a.i < b.i);  // stable
    });
#pragma omp parallel for
    for (int64_t i = 0; i < n; ++i) order[i] = kv[i].i;
}

// ---------------------------------------------------------------------------
// Linear deterministic greedy (LDG) streaming vertex partitioner — the
// METIS stand-in (inputs/partitioner.cpp). Vertices arrive in id order;
// each goes to the part with the most already-placed neighbors, penalized
// by fullness: score = |N(v) ∩ P_i| * (1 - |P_i|/capacity).
// Needs CSR-ish access: edges sorted by dst (gc_sort_by_dst) with row
// pointers, plus the reverse direction for undirected affinity.
// ---------------------------------------------------------------------------
void gc_ldg_partition(const int64_t* row_ptr, const int32_t* col,
                      int32_t num_v, int32_t k, int32_t* parts) {
    std::vector<int64_t> size((size_t)k, 0);
    std::vector<double> score((size_t)k);
    const double cap = (double)num_v / k + 1.0;
    std::fill(parts, parts + num_v, -1);
    for (int32_t v = 0; v < num_v; ++v) {
        std::fill(score.begin(), score.end(), 0.0);
        for (int64_t j = row_ptr[v]; j < row_ptr[v + 1]; ++j) {
            int32_t u = col[j];
            if (u < num_v && parts[u] >= 0) score[parts[u]] += 1.0;
        }
        int32_t best = 0;
        double best_s = -1.0;
        for (int32_t p = 0; p < k; ++p) {
            double s = (score[p] + 1e-9) * (1.0 - (double)size[p] / cap);
            if (s > best_s) { best_s = s; best = p; }
        }
        parts[v] = best;
        size[best]++;
    }
}

// ---------------------------------------------------------------------------
// Restreaming refinement over an existing assignment (Fennel/label-prop
// style): each pass streams vertices in id order and moves a vertex to its
// highest-affinity part when that strictly reduces its cut edges and the
// target part has room (capacity = num_v/k * (1 + slack)). Immediate
// updates (not batch) both converge faster and cannot oscillate. On the
// clustered 20k-vertex test graph this takes the single-pass LDG cut from
// 0.49 to ~0.15 in 8 passes.
// ---------------------------------------------------------------------------
void gc_refine_partition(const int64_t* row_ptr, const int32_t* col,
                         int32_t num_v, int32_t k, int32_t iters,
                         double slack, int32_t* parts) {
    std::vector<int64_t> size((size_t)k, 0);
    for (int32_t v = 0; v < num_v; ++v) size[parts[v]]++;
    const int64_t cap = (int64_t)((double)num_v / k * (1.0 + slack)) + 1;
    std::vector<int64_t> score((size_t)k);
    for (int32_t it = 0; it < iters; ++it) {
        int64_t moved = 0;
        for (int32_t v = 0; v < num_v; ++v) {
            std::fill(score.begin(), score.end(), 0);
            for (int64_t j = row_ptr[v]; j < row_ptr[v + 1]; ++j) {
                int32_t u = col[j];
                if (u < num_v) score[parts[u]]++;
            }
            const int32_t cur = parts[v];
            int32_t best = cur;
            int64_t best_s = score[cur];
            for (int32_t p = 0; p < k; ++p)
                if (score[p] > best_s && size[p] < cap) { best_s = score[p]; best = p; }
            if (best != cur) {
                size[cur]--; size[best]++; parts[v] = best; moved++;
            }
        }
        if (moved == 0) break;
    }
}

// ---------------------------------------------------------------------------
// Text snap edge-list parser (inputs/graphToBinary.cpp readFile role):
// skip '#'/'%' comment lines, take the first two integer columns, drop
// self loops and malformed lines. Two parallel passes over newline-aligned
// chunks (count, then fill at prefix offsets) keep file order without
// temporaries — the pure-python line loop this replaces runs ~3 MB/s;
// this runs at memory bandwidth across cores.
// ---------------------------------------------------------------------------
static const char* gc_next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

static int64_t gc_parse_chunk(const char* p, const char* end,
                              int32_t* src, int32_t* dst) {
    int64_t n = 0;
    while (p < end) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p >= end) break;
        const char c = *p;
        if (c == '#' || c == '%' || c == '\n') {
            p = gc_next_line(p, end);
            continue;
        }
        uint64_t a = 0, b = 0;
        bool ok1 = false, ok2 = false;
        // Saturating accumulation: a digit run past int32 range must be
        // DROPPED, never wrapped into a negative id (a wrapped id later
        // indexes counting sorts out of bounds). Saturate above 2^32 so
        // even 20+-digit runs cannot wrap uint64 back under the limit.
        while (p < end && *p >= '0' && *p <= '9') {
            a = a * 10 + (uint64_t)(*p - '0');
            if (a > (1ull << 32)) a = (1ull << 32);
            ++p; ok1 = true;
        }
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        while (p < end && *p >= '0' && *p <= '9') {
            b = b * 10 + (uint64_t)(*p - '0');
            if (b > (1ull << 32)) b = (1ull << 32);
            ++p; ok2 = true;
        }
        p = gc_next_line(p, end);
        if (ok1 && ok2 && a != b
            && a < (1ull << 31) && b < (1ull << 31)) {
            if (src) { src[n] = (int32_t)a; dst[n] = (int32_t)b; }
            ++n;
        }
    }
    return n;
}

int64_t gc_parse_edges(const char* buf, int64_t len,
                       int32_t* src, int32_t* dst) {
    int nt = 1;
#ifdef _OPENMP
    nt = omp_get_max_threads();
#endif
    // Chunk boundaries snapped forward to line starts.
    std::vector<const char*> starts((size_t)nt + 1);
    const char* end = buf + len;
    starts[0] = buf;
    for (int t = 1; t < nt; ++t) {
        const char* p = buf + len * t / nt;
        starts[t] = gc_next_line(p, end);
    }
    starts[nt] = end;
    std::vector<int64_t> cnt((size_t)nt, 0);
#pragma omp parallel for
    for (int t = 0; t < nt; ++t)
        cnt[t] = gc_parse_chunk(starts[t], starts[t + 1], nullptr, nullptr);
    std::vector<int64_t> off((size_t)nt + 1, 0);
    for (int t = 0; t < nt; ++t) off[t + 1] = off[t] + cnt[t];
#pragma omp parallel for
    for (int t = 0; t < nt; ++t)
        gc_parse_chunk(starts[t], starts[t + 1], src + off[t], dst + off[t]);
    return off[nt];
}

// ---------------------------------------------------------------------------
// Pair-reuse mining, one pass (the native twin of graph/reuse.py _mine_one;
// see that module's docstring for the algorithm and the exactness argument).
// HAG-style common neighbor-PAIR extraction:
//   1. sort edges by (dst, src); consecutive same-dst positions are
//      candidate pairs (src[i], src[i+1]);
//   2. count candidates per pair key; select keys with count >= min_uses
//      (top max_pairs by count when over budget);
//   3. greedy non-overlapping take (two taken pairs may not share an edge);
//   4. drop pairs whose TAKEN count falls below max(min_uses, 3) — the
//      profitability floor (2-row build cost);
//   5. rewrite: each taken candidate's two edges are replaced by one edge
//      from the pair's table id (>= table_size); output sorted by dst.
// Outputs: pair_a/pair_b (caller buffers, >= e/3+1), src2/dst2 (>= e),
// out[0] = rewritten edge count, out[1] = taken uses, out[2] = candidates.
// Returns the number of pairs kept. numpy lexsort passes run ~70-80 s at
// 24 M edges; this runs the same passes in parallel C++.
// ---------------------------------------------------------------------------
int64_t gc_mine_pairs(const int32_t* src, const int32_t* dst, int64_t e,
                      int64_t table_size, int32_t min_uses, int64_t max_pairs,
                      int32_t* pair_a, int32_t* pair_b,
                      int32_t* src2, int32_t* dst2, int64_t* out) {
    out[0] = e; out[1] = 0; out[2] = 0;
    if (e < 2) {
        std::memcpy(src2, src, sizeof(int32_t) * (size_t)e);
        std::memcpy(dst2, dst, sizeof(int32_t) * (size_t)e);
        return 0;
    }
    // 1. (dst, src) sort — indices carried for stability.
    struct KV { uint64_t k; int64_t i; };
    std::vector<KV> kv((size_t)e);
#pragma omp parallel for
    for (int64_t i = 0; i < e; ++i)
        kv[i] = {((uint64_t)(uint32_t)dst[i] << 32) | (uint32_t)src[i], i};
    GC_SORT(kv.begin(), kv.end(), [](const KV& a, const KV& b) {
        return a.k < b.k || (a.k == b.k && a.i < b.i);
    });
    std::vector<int32_t> s((size_t)e), d((size_t)e);
#pragma omp parallel for
    for (int64_t i = 0; i < e; ++i) {
        s[i] = (int32_t)(kv[i].k & 0xffffffffu);
        d[i] = (int32_t)(kv[i].k >> 32);
    }
    kv.clear(); kv.shrink_to_fit();

    // 2. candidate keys, grouped by a second sort (position carried).
    std::vector<KV> cands;
    cands.reserve((size_t)e / 2);
    for (int64_t i = 0; i + 1 < e; ++i)
        if (d[i] == d[i + 1])
            cands.push_back({((uint64_t)(uint32_t)s[i] << 32)
                             | (uint32_t)s[i + 1], i});
    out[2] = (int64_t)cands.size();
    if (cands.empty()) {
        std::memcpy(src2, s.data(), sizeof(int32_t) * (size_t)e);
        std::memcpy(dst2, d.data(), sizeof(int32_t) * (size_t)e);
        return 0;
    }
    GC_SORT(cands.begin(), cands.end(), [](const KV& a, const KV& b) {
        return a.k < b.k || (a.k == b.k && a.i < b.i);
    });
    // Run-length groups over sorted candidate keys.
    int64_t nc = (int64_t)cands.size();
    std::vector<int64_t> grp_start;   // first index of each group
    grp_start.reserve((size_t)nc / 2 + 1);
    for (int64_t i = 0; i < nc; ++i)
        if (i == 0 || cands[i].k != cands[i - 1].k) grp_start.push_back(i);
    grp_start.push_back(nc);
    int64_t ng = (int64_t)grp_start.size() - 1;

    // Selection: count >= min_uses; over budget, keep the top max_pairs
    // by count (ties at the threshold broken by group order, so the
    // budget is strict).
    std::vector<int64_t> cnt_of_grp((size_t)ng);
    for (int64_t g = 0; g < ng; ++g)
        cnt_of_grp[g] = grp_start[g + 1] - grp_start[g];
    std::vector<char> sel((size_t)ng, 0);
    {
        int64_t n_sel = 0;
        for (int64_t g = 0; g < ng; ++g)
            if (cnt_of_grp[g] >= min_uses) { sel[g] = 1; n_sel++; }
        if (max_pairs > 0 && n_sel > max_pairs) {
            std::vector<int64_t> counts;
            counts.reserve((size_t)n_sel);
            for (int64_t g = 0; g < ng; ++g)
                if (sel[g]) counts.push_back(cnt_of_grp[g]);
            std::nth_element(counts.begin(),
                             counts.begin() + (counts.size() - max_pairs),
                             counts.end());
            int64_t thresh = counts[counts.size() - max_pairs];
            int64_t above = 0;
            for (int64_t g = 0; g < ng; ++g)
                if (sel[g] && cnt_of_grp[g] > thresh) above++;
            int64_t at_allowed = max_pairs - above;
            for (int64_t g = 0; g < ng; ++g) {
                if (!sel[g]) continue;
                if (cnt_of_grp[g] < thresh) sel[g] = 0;
                else if (cnt_of_grp[g] == thresh) {
                    if (at_allowed > 0) at_allowed--;
                    else sel[g] = 0;
                }
            }
        }
    }

    // 3. greedy non-overlap take over candidate positions (ascending i):
    // equivalent to the alternate-within-run rule (taking i consumes
    // edges i and i+1, blocking candidate i+1 and freeing i+2).
    std::vector<int64_t> grp_at_pos((size_t)e, -1);
    for (int64_t g = 0; g < ng; ++g)
        if (sel[g])
            for (int64_t i = grp_start[g]; i < grp_start[g + 1]; ++i)
                grp_at_pos[cands[i].i] = g;
    std::vector<char> consumed((size_t)e, 0);
    std::vector<int64_t> taken_pos;
    taken_pos.reserve((size_t)nc / 2);
    std::vector<int64_t> tcnt((size_t)ng, 0);
    for (int64_t i = 0; i + 1 < e; ++i) {
        int64_t g = grp_at_pos[i];
        if (g < 0 || consumed[i] || consumed[i + 1]) continue;
        consumed[i] = consumed[i + 1] = 1;
        taken_pos.push_back(i);
        tcnt[g]++;
    }

    // 4. profitability floor on TAKEN counts (>= max(min_uses, 3)).
    int64_t pf = (std::max<int64_t>)(min_uses, 3);
    std::vector<int64_t> pair_id((size_t)ng, -1);
    int64_t np = 0;
    for (int64_t g = 0; g < ng; ++g)
        if (tcnt[g] >= pf) {
            uint64_t k = cands[grp_start[g]].k;
            pair_a[np] = (int32_t)(k >> 32);
            pair_b[np] = (int32_t)(k & 0xffffffffu);
            pair_id[g] = np++;
        }
    // Un-take positions of dropped pairs (their edges stay in the output).
    std::vector<int64_t> final_take;
    final_take.reserve(taken_pos.size());
    for (int64_t i : taken_pos)
        if (pair_id[grp_at_pos[i]] >= 0) final_take.push_back(i);
        else consumed[i] = consumed[i + 1] = 0;
    out[1] = (int64_t)final_take.size();

    // 5. rewrite + stable counting sort by dst (original edges of a dst
    // precede its pair edges, matching the numpy concat order).
    int64_t e2 = 0;
    std::vector<int32_t> rs, rd;
    rs.reserve((size_t)e); rd.reserve((size_t)e);
    for (int64_t i = 0; i < e; ++i)
        if (!consumed[i]) { rs.push_back(s[i]); rd.push_back(d[i]); }
    for (int64_t i : final_take) {
        rs.push_back((int32_t)(table_size + pair_id[grp_at_pos[i]]));
        rd.push_back(d[i]);
    }
    e2 = (int64_t)rs.size();
    out[0] = e2;
    // Counting sort by dst. dst may EXCEED table_size: in the sharded
    // backward direction the outputs are gather-table rows (local +
    // ghosts) while table_size is the smaller cotangent-table size where
    // pair ids start (ops/reuse_sharded.py) — size the counters by the
    // actual max.
    int64_t dmax = table_size;
    for (int64_t i = 0; i < e2; ++i)
        if ((int64_t)rd[i] >= dmax) dmax = (int64_t)rd[i] + 1;
    std::vector<int64_t> cnt((size_t)dmax + 1, 0);
    for (int64_t i = 0; i < e2; ++i) cnt[(size_t)rd[i] + 1]++;
    for (int64_t v = 0; v < dmax; ++v) cnt[v + 1] += cnt[v];
    for (int64_t i = 0; i < e2; ++i) {
        int64_t at = cnt[rd[i]]++;
        src2[at] = rs[i];
        dst2[at] = rd[i];
    }
    return np;
}

int32_t gc_version() { return 4; }

}  // extern "C"
