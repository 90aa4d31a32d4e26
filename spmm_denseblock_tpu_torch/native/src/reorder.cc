// Native reorder engine of spmm_denseblock_tpu_torch: the port's own
// copy of spmm_denseblock_tpu/native/src/reorder.cc. It differs from
// that file in two places only: the Gorder hub-cut floor and the Rabbit
// community-map cap are arguments of sdb_gorder and sdb_rabbit, where
// the JAX package reads them from SDB_GORDER_FLOOR and SDB_RABBIT_CAP.
// The parity tests (tests/test_torch_reorder.py) hold every strategy of
// the two engines bit for bit, so the copies cannot drift apart.
//
// C++ versions of the host-side reordering strategies (the reference
// vendors C++ for the same role: Gorder/, rabbit_order/,
// reorder_strategy.cc; algorithms re-derived, code original). The Python
// bodies in reorder/ carry the specification; every function here
// matches their deterministic tie-breaking, bit for bit where the
// algorithm is order-deterministic.
//
// ABI: plain C, int32 CSR (indptr, indices), int64 output permutation
// old2new (old index -> new index). Loaded via ctypes (native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <queue>
#include <unordered_map>
#include <vector>

using i32 = int32_t;
using i64 = int64_t;

namespace {

// FIFO BFS numbering with lowest-unvisited restarts; adjacency visited in
// the order given by (indptr, indices).
void bfs_core(i64 n, const i32* indptr, const i32* indices, i64* old2new) {
  std::fill(old2new, old2new + n, (i64)-1);
  std::vector<i64> frontier, next;
  i64 cnt = 0, pos = 0;
  while (cnt < n) {
    while (pos < n && old2new[pos] != -1) ++pos;
    if (pos == n) break;
    old2new[pos] = cnt++;
    frontier.assign(1, pos);
    while (!frontier.empty()) {
      next.clear();
      for (i64 u : frontier) {
        for (i32 k = indptr[u]; k < indptr[u + 1]; ++k) {
          i64 v = indices[k];
          if (old2new[v] == -1) {
            old2new[v] = cnt++;
            next.push_back(v);
          }
        }
      }
      frontier.swap(next);
    }
  }
}

std::vector<i64> degrees(i64 n, const i32* indptr) {
  std::vector<i64> deg(n);
  for (i64 i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];
  return deg;
}

}  // namespace

extern "C" {

// Vertices by descending degree, ties by ascending id (stable).
void sdb_degree_sort(i64 n, const i32* indptr, const i32* indices,
                     i64* old2new) {
  (void)indices;
  auto deg = degrees(n, indptr);
  std::vector<i64> order(n);
  for (i64 i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](i64 a, i64 b) { return deg[a] > deg[b]; });
  for (i64 i = 0; i < n; ++i) old2new[order[i]] = i;
}

void sdb_bfs(i64 n, const i32* indptr, const i32* indices, i64* old2new) {
  bfs_core(n, indptr, indices, old2new);
}

// The repo-variant RCM: per-row adjacency re-sorted by (descending
// neighbor degree, ascending id), then FIFO BFS.
void sdb_rcm_variant(i64 n, const i32* indptr, const i32* indices,
                     i64* old2new) {
  auto deg = degrees(n, indptr);
  i64 nnz = indptr[n];
  std::vector<i32> sorted(indices, indices + nnz);
  for (i64 i = 0; i < n; ++i) {
    std::stable_sort(sorted.begin() + indptr[i], sorted.begin() + indptr[i + 1],
                     [&](i32 a, i32 b) {
                       if (deg[a] != deg[b]) return deg[a] > deg[b];
                       return a < b;
                     });
  }
  bfs_core(n, indptr, sorted.data(), old2new);
}

// Gorder (window-locality greedy, SIGMOD'16 algorithm): next vertex
// maximizes sum over the last-w window of (adjacency + common-neighbor)
// score. Keys change by +-1 only, so the priority structure is a
// bucket-list unit queue — a doubly-linked list per key value with
// head-insertion, O(1) key moves and O(1) amortized extract-max (the
// max-bucket cursor only scans down what increments pushed up). This is
// the role the reference's bucketed UnitHeap plays
// (the reference's Gorder/UnitHeap.h:50-117, used by Graph.cpp:423);
// structure re-derived, not ported. A lazy binary heap made the pass
// superlinear.
// Per-propagate deltas are batched (net +-d per touched vertex, one
// list move each). Hubs (deg > sqrt(n)) skip the expensive
// common-neighbor propagation, as the reference does. Tie-break among
// equal keys: most recently moved wins (bucket head) — deterministic,
// mirrored exactly by reorder/gorder.py (bit-equality tests).
// Touch-volume budget for the hub cut: the propagation volume is
// 2*(nnz + sum_{w: deg_w <= cut} deg_w^2) queue events; 1e9 events
// bounds the pass on products-scale graphs. Must match reorder/gorder.py
// exactly (bit-equality tests).
static const i64 kGorderTouchBudget = 1000000000LL;

// floor_v: the least hub cut, whatever the budget (64 by default).
void sdb_gorder(i64 n, const i32* indptr, const i32* indices, i64 window,
                double floor_v, i64* old2new) {
  if (n == 0) return;
  auto deg64 = degrees(n, indptr);
  std::vector<i32> deg(n);
  for (i64 i = 0; i < n; ++i) deg[i] = (i32)deg64[i];
  double hub_cut = 1.0;
  if ((double)n > 1.0) hub_cut = std::max(1.0, std::sqrt((double)n));
  i64 nnz = indptr[n];
  {
    // volume-budgeted cap: largest degree value whose cumulative
    // sum(deg^2) keeps the total under budget, floored at 64 (keep the
    // common-neighbor signal on degree-dense graphs even if it
    // overshoots), capped at sqrt(n) (the reference's hub rule).
    std::vector<i64> sorted(deg64);
    std::sort(sorted.begin(), sorted.end());
    i64 cum = 0, cut_b = 0;
    for (i64 i = 0; i < n; ++i) {
      i64 d = sorted[i];
      if ((double)d > hub_cut) break;
      cum += d * d;
      if (2 * (nnz + cum) <= kGorderTouchBudget)
        cut_b = d;
      else
        break;
    }
    hub_cut = std::min(hub_cut, std::max(floor_v, (double)cut_b));
  }

  std::vector<i32> key(n, 0), prv(n, -1), nxt_(n, -1);
  std::vector<char> placed(n, 0);
  std::vector<i32> bhead(1, -1);  // bucket k -> first vertex (-1 empty)
  i32 maxkey = 0;

  auto unlink = [&](i32 u) {
    if (prv[u] >= 0)
      nxt_[prv[u]] = nxt_[u];
    else
      bhead[key[u]] = nxt_[u];
    if (nxt_[u] >= 0) prv[nxt_[u]] = prv[u];
  };
  auto push_front = [&](i32 u, i32 k) {
    if ((i32)bhead.size() <= k) bhead.resize((size_t)k + 1, -1);
    prv[u] = -1;
    nxt_[u] = bhead[k];
    if (nxt_[u] >= 0) prv[nxt_[u]] = u;
    bhead[k] = u;
    key[u] = k;
    if (k > maxkey) maxkey = k;
  };
  // all vertices start at key 0; ids inserted descending so the initial
  // bucket-0 head is the lowest id (matches the lowest-unvisited-id
  // restart rule before any scores exist)
  for (i64 u = n - 1; u >= 0; --u) push_front((i32)u, 0);

  // delta doubles as the placed flag (kPlacedDelta sentinel): the
  // propagate inner loop is latency-bound random access, and a separate
  // placed[] byte array was a second random stream per touched vertex.
  // One i32 load decides skip/first-touch/accumulate. Software
  // prefetch hides part of the remaining latency: indices[] is a
  // streamy read, so upcoming delta addresses are known ~8 iterations
  // ahead.
  const i32 kPlacedDelta = std::numeric_limits<i32>::min() / 2;
  std::vector<i32> delta(n, 0), touched;
  touched.reserve(1024);
  i32 hub_cut_i = (i32)hub_cut;
  // software prefetch: the propagate loop is latency-bound past the
  // last-level cache and indices[] is streamy, so upcoming delta
  // addresses are known cheaply ahead of use.
  const bool kPrefetch = true;
  auto propagate = [&](i32 ve, i32 d) {
    // single scan of ve's adjacency: the S_n term for each neighbor w,
    // then (non-hub w) the S_s common-neighbor term through w — one
    // deg[w] access pattern instead of two full scans.
    // Touch order = adjacency-interleaved (mirrored in gorder.py).
    touched.clear();
    for (i32 k = indptr[ve]; k < indptr[ve + 1]; ++k) {
      i32 w = indices[k];
      if (kPrefetch && k + 4 < indptr[ve + 1]) {
        i32 wn = indices[k + 4];
        __builtin_prefetch(&delta[wn]);
        __builtin_prefetch(&deg[wn]);
        __builtin_prefetch(&indptr[wn]);
        // (prefetching w's adjacency segment start as well gained
        // nothing: the hardware prefetcher covers it once indptr[w]
        // arrives)
      }
      i32 dw = delta[w];
      if (dw != kPlacedDelta) {  // S_n adjacency term
        if (dw == 0) touched.push_back(w);
        delta[w] = dw + d;
      }
      if (deg[w] > hub_cut_i) continue;  // hub skip
      i32 jend = indptr[w + 1];
      if (kPrefetch) {
        for (i32 j = indptr[w]; j < jend; ++j) {
          if (j + 8 < jend) __builtin_prefetch(&delta[indices[j + 8]]);
          i32 u = indices[j];  // S_s common-neighbor term via w
          i32 du = delta[u];
          if (du != kPlacedDelta) {
            if (du == 0) touched.push_back(u);
            delta[u] = du + d;
          }
        }
      } else {
        for (i32 j = indptr[w]; j < jend; ++j) {
          i32 u = indices[j];
          i32 du = delta[u];
          if (du != kPlacedDelta) {
            if (du == 0) touched.push_back(u);
            delta[u] = du + d;
          }
        }
      }
    }
    // flush: one O(1) list move per touched vertex — ~6 random
    // accesses each (key/prv/nxt_ reads + writes); touched is dense,
    // so prefetch the move targets a few entries ahead
    size_t tn = touched.size();
    for (size_t t = 0; t < tn; ++t) {
      if (t + 4 < tn) {
        i32 un = touched[t + 4];
        __builtin_prefetch(&key[un]);
        __builtin_prefetch(&prv[un]);
        __builtin_prefetch(&nxt_[un]);
      }
      i32 u = touched[t];
      i32 nk = key[u] + delta[u];
      delta[u] = 0;
      unlink(u);
      push_front(u, nk);
    }
  };

  // start at the first max-degree vertex
  i64 v = 0;
  for (i64 i = 1; i < n; ++i)
    if (deg[i] > deg[v]) v = i;

  std::vector<i64> win;
  i64 scan = 0;
  for (i64 i = 0; i < n; ++i) {
    unlink((i32)v);  // DeleteElement: v leaves the queue on placement
    placed[v] = 1;
    delta[v] = kPlacedDelta;  // delta doubles as the placed flag
    old2new[v] = i;
    win.push_back(v);
    propagate((i32)v, +1);
    if ((i64)win.size() > window) {
      i64 out = win.front();
      win.erase(win.begin());
      propagate((i32)out, -1);
    }
    if (i == n - 1) break;
    // ExtractMax: highest non-empty bucket with key >= 1; a key-0
    // candidate carries no window affinity, so fall through to the
    // lowest-unvisited-id restart (same rule as the old lazy heap).
    while (maxkey > 0 && bhead[maxkey] < 0) --maxkey;
    i64 nx = (maxkey > 0) ? bhead[maxkey] : -1;
    if (nx < 0) {  // disconnected remainder: lowest unvisited id
      while (scan < n && placed[scan]) ++scan;
      nx = scan;
    }
    v = nx;
  }
}

// Rabbit Order (IPDPS'16 algorithm, sequential): merge vertices in
// ascending-degree order into the neighbor community with the best
// modularity gain; DFS the merge forest for the permutation. Community
// adjacencies are insertion-ordered maps so tie-breaking ("first best in
// iteration order wins under strict >") matches reorder/rabbit.py.
namespace rabbit_detail {
struct OMap {  // insertion-ordered community -> weight map
  std::unordered_map<i64, size_t> pos;
  std::vector<std::pair<i64, double>> items;
  void add(i64 k, double w) {
    auto it = pos.find(k);
    if (it == pos.end()) {
      pos.emplace(k, items.size());
      items.push_back({k, w});
    } else {
      items[it->second].second += w;
    }
  }
  void erase(i64 k) {
    // swap-remove: O(1). Perturbs insertion order at the erased slot,
    // which only shifts tie-breaking among equal-gain candidates — the
    // original O(size) reindexing erase made products-scale merges
    // quadratic (every merge erases from the absorber's map).
    auto it = pos.find(k);
    if (it == pos.end()) return;
    size_t idx = it->second;
    pos.erase(it);
    if (idx + 1 != items.size()) {
      items[idx] = items.back();
      pos[items[idx].first] = idx;
    }
    items.pop_back();
  }
  void prune_to(size_t cap) {
    // keep the cap heaviest entries (community merges accumulate huge
    // neighbor maps on hub-rich graphs; the tail carries negligible
    // modularity gain). Amortized: callers prune at 2*cap.
    if (items.size() <= cap) return;
    std::nth_element(
        items.begin(), items.begin() + cap, items.end(),
        [](const std::pair<i64, double>& a, const std::pair<i64, double>& b) {
          return a.second > b.second;
        });
    items.resize(cap);
    pos.clear();
    for (size_t i = 0; i < items.size(); ++i) pos.emplace(items[i].first, i);
  }
};
}  // namespace rabbit_detail

// cap: the community-map cap of the rabbit fast path (see prune_to),
// which bounds the total aggregation work to O(n * cap + nnz); 0 or less
// is unlimited. It perturbs merge choices on hub-rich graphs; the JAX
// package measured 1024 (the default) quality-neutral against unlimited
// (its benchmarks/reorder_quality_r3.jsonl).
void sdb_rabbit(i64 n, const i32* indptr, const i32* indices, i64 cap,
                i64* old2new) {
  using rabbit_detail::OMap;
  const size_t kRabbitCap = cap <= 0 ? (size_t)-1 / 4 : (size_t)cap;
  auto deg = degrees(n, indptr);
  double two_m = (double)indptr[n];
  if (two_m == 0) {
    for (i64 i = 0; i < n; ++i) old2new[i] = i;
    return;
  }
  std::vector<double> strength(n);
  for (i64 i = 0; i < n; ++i) strength[i] = (double)deg[i];
  std::vector<i64> parent(n, -1), comm(n);
  std::vector<char> alive(n, 1), have(n, 0);
  std::vector<OMap> nbrs(n);
  std::vector<std::vector<i64>> children(n);
  for (i64 i = 0; i < n; ++i) comm[i] = i;

  auto find = [&](i64 x) {
    i64 root = x;
    while (comm[root] != root) root = comm[root];
    while (comm[x] != root) {
      i64 nx = comm[x];
      comm[x] = root;
      x = nx;
    }
    return root;
  };
  auto get_nbrs = [&](i64 u) -> OMap& {
    if (!have[u]) {
      OMap m;
      for (i32 k = indptr[u]; k < indptr[u + 1]; ++k) {
        i64 v = indices[k];
        if (v != u) m.add(v, 1.0);
      }
      nbrs[u] = std::move(m);
      have[u] = 1;
    }
    return nbrs[u];
  };

  std::vector<i64> order(n);
  for (i64 i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](i64 a, i64 b) { return deg[a] < deg[b]; });

  for (i64 u : order) {
    if (!alive[u]) continue;
    OMap& du = get_nbrs(u);
    OMap combined;
    for (auto& [v, w] : du.items) {
      i64 r = find(v);
      if (r != u) combined.add(r, w);
    }
    i64 best_v = -1;
    double best_gain = 0.0;
    for (auto& [r, w] : combined.items) {
      double gain = w / two_m - strength[u] * strength[r] / (two_m * two_m);
      if (gain > best_gain) {
        best_gain = gain;
        best_v = r;
      }
    }
    if (best_v < 0) {
      nbrs[u] = std::move(combined);
      continue;
    }
    i64 v = best_v;
    parent[u] = v;
    children[v].push_back(u);
    alive[u] = 0;
    comm[u] = v;
    OMap& dv = get_nbrs(v);
    for (auto& [r, w] : combined.items)
      if (r != v) dv.add(r, w);
    dv.erase(u);
    // cap the absorber's community map (top-weight entries): bounds
    // per-merge work to O(cap) so the full products-scale graph
    // aggregates in linear time; the reference instead parallelized
    // (rabbit_order.hpp:267-310) — this is the sequential fast path.
    if (dv.items.size() > 2 * kRabbitCap) dv.prune_to(kRabbitCap);
    strength[v] += strength[u];
    nbrs[u] = OMap();  // free
  }

  i64 cnt = 0;
  std::vector<i64> stack;
  for (i64 root = 0; root < n; ++root) {
    if (parent[root] != -1) continue;
    stack.assign(1, root);
    while (!stack.empty()) {
      i64 x = stack.back();
      stack.pop_back();
      old2new[x] = cnt++;
      for (auto it = children[x].rbegin(); it != children[x].rend(); ++it)
        stack.push_back(*it);
    }
  }
}

// Greedy max-shared-neighbor chain ("closest"): next vertex maximizes
// |N(x) ∩ N(v)| (out-neighbor intersection, = (A A^T)[x] like the Python
// spec's SpMV); candidates enumerated through the transpose adjacency,
// counts reset in O(touched). First max (lowest id) wins; fallback =
// lowest unvisited id.
void sdb_greedy_closest(i64 n, const i32* indptr, const i32* indices,
                        i64 start, i64* old2new) {
  // build transpose (CSC) so "which v have w in N(v)" is a direct scan
  i64 nnz = indptr[n];
  std::vector<i32> t_ptr(n + 1, 0), t_idx(nnz);
  for (i64 k = 0; k < nnz; ++k) ++t_ptr[indices[k] + 1];
  for (i64 i = 0; i < n; ++i) t_ptr[i + 1] += t_ptr[i];
  {
    std::vector<i32> cur(t_ptr.begin(), t_ptr.end() - 1);
    for (i64 u = 0; u < n; ++u)
      for (i32 k = indptr[u]; k < indptr[u + 1]; ++k)
        t_idx[cur[indices[k]]++] = (i32)u;
  }
  std::vector<i64> counts(n, 0);
  std::vector<char> visited(n, 0);
  std::vector<i64> touched;
  std::fill(old2new, old2new + n, (i64)-1);
  i64 x = start, scan = 0;
  for (i64 i = 0; i < n; ++i) {
    old2new[x] = i;
    visited[x] = 1;
    if (i == n - 1) break;
    touched.clear();
    for (i32 k = indptr[x]; k < indptr[x + 1]; ++k) {
      i64 w = indices[k];
      for (i32 j = t_ptr[w]; j < t_ptr[w + 1]; ++j) {
        i64 v = t_idx[j];
        if (counts[v] == 0) touched.push_back(v);
        ++counts[v];
      }
    }
    i64 best = -1, best_c = 0;
    std::sort(touched.begin(), touched.end());
    for (i64 v : touched) {
      if (!visited[v] && counts[v] > best_c) {
        best_c = counts[v];
        best = v;
      }
    }
    for (i64 v : touched) counts[v] = 0;
    if (best < 0) {
      while (scan < n && visited[scan]) ++scan;
      best = scan;
    }
    x = best;
  }
}

// Apply a square-matrix vertex permutation: new CSR with row i ->
// old2new[i] and neighbor ids relabeled + per-row sorted. O(nnz) layout
// pass + tiny per-row sorts (avg-degree-sized) instead of a global
// comparison sort over nnz — ~10x the numpy fused-key argsort at
// products scale (123M nnz), and trivially parallel over rows.
// `order` receives, for every slot of the NEW indices array, the index
// of the source element in the OLD indices array, so callers permute a
// values array with one numpy gather (data_new = data[order]).
void sdb_permutate(i64 n, const i32* indptr, const i32* indices,
                   const i64* old2new, i32* out_indptr, i32* out_indices,
                   i64* order) {
  std::vector<i64> new2old(n);
  for (i64 r = 0; r < n; ++r) new2old[old2new[r]] = r;
  out_indptr[0] = 0;
  for (i64 nr = 0; nr < n; ++nr) {
    i64 r = new2old[nr];
    out_indptr[nr + 1] = out_indptr[nr] + (indptr[r + 1] - indptr[r]);
  }
#pragma omp parallel
  {
    std::vector<std::pair<i32, i64>> row;  // (new col, old element idx)
#pragma omp for schedule(dynamic, 256)
    for (i64 nr = 0; nr < n; ++nr) {
      i64 r = new2old[nr];
      i32 s = indptr[r], e = indptr[r + 1];
      row.clear();
      for (i32 k = s; k < e; ++k)
        row.emplace_back((i32)old2new[indices[k]], (i64)k);
      std::sort(row.begin(), row.end());
      i64 o = out_indptr[nr];
      for (size_t j = 0; j < row.size(); ++j) {
        out_indices[o + (i64)j] = row[j].first;
        order[o + (i64)j] = row[j].second;
      }
    }
  }
}

// Sorted-unique + inverse over a bounded-value int32 stream — the hot
// host pass of the ELL two-level compaction layout builder (the JAX
// package's ops/csr_spmm_ell._compact_spans, and the port's twin of it):
// np.unique(seg, return_inverse=1)
// is a comparison sort, O(n log n) over up to CHUNK_SLOTS per span;
// values here are column ids < n_vals, so a dense mark array gives the
// sorted unique set and ranks in O(n + n_vals). uniq_out needs
// capacity min(n, n_vals); returns the unique count. Matches
// np.unique's (sorted values, first-occurrence-free inverse) exactly.
i64 sdb_unique_inverse(i64 n, const i32* seg, i64 n_vals, i32* uniq_out,
                       i32* inv_out) {
  std::vector<i32> mark(n_vals, 0);
  for (i64 i = 0; i < n; ++i) mark[seg[i]] = 1;
  i64 u = 0;
  for (i64 v = 0; v < n_vals; ++v) {
    if (mark[v]) {
      uniq_out[u] = (i32)v;
      mark[v] = (i32)(u + 1);  // rank + 1 (0 = absent)
      ++u;
    }
  }
#pragma omp parallel for schedule(static)
  for (i64 i = 0; i < n; ++i) inv_out[i] = mark[seg[i]] - 1;
  return u;
}

}  // extern "C"
