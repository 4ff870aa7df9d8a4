// Native host-side graph preprocessing for scgib_tpu_torch: the port's own
// copy of native/scgib_native.cc, the JAX package's library.
//
// The reference's preprocessing runs one dgl.khop_in_subgraph BFS per node
// per graph in Python (exp_pcqm4mv2.py:422-426).  This library implements
// the same extraction (k-hop in-neighborhood ego-nets with induced edges,
// center-first node lists, original-edge-order edge lists, matching
// graph/egonet.py) as a two-phase C++ routine threaded across graphs, the
// row gather, and the flat batch packer (data/flat.py).
//
// Built by scgib_tpu_torch/native.py with g++ at first use into
// scgib_tpu_torch/_build/ and bound with ctypes.
//
// Layout conventions (all int32 unless noted):
//   graphs are concatenated; graph g owns nodes
//   [node_off[g], node_off[g+1]) and edges [edge_off[g], edge_off[g+1])
//   (int64 offsets).  senders/receivers hold *local* node ids.
//   Ego-nets are emitted per center in (graph, node) order.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct GraphView {
  const int32_t* senders;
  const int32_t* receivers;
  int32_t n_nodes;
  int64_t n_edges;
};

// Per-thread BFS scratch, reused across graphs.
struct Scratch {
  std::vector<int32_t> visited_at;  // center id that last visited node v
  std::vector<int32_t> frontier;
  std::vector<int32_t> next;
  std::vector<int32_t> members;     // ego members in discovery order
  std::vector<int32_t> local_id;    // node -> local index within ego-net
  std::vector<int32_t> indptr;      // CSR of in-edges (by receiver)
  std::vector<int32_t> nbr;         // CSR column = sender
};

// Build in-neighbor CSR (receiver -> senders), then per-center BFS up to k
// hops.  Members are recorded center-first then ascending id (matching
// egonet.py: center then sorted remainder) by collecting a visited bitmap
// and scanning ids in order.
void build_csr(const GraphView& g, Scratch& s) {
  s.indptr.assign(g.n_nodes + 1, 0);
  for (int64_t e = 0; e < g.n_edges; ++e) s.indptr[g.receivers[e] + 1]++;
  for (int32_t v = 0; v < g.n_nodes; ++v) s.indptr[v + 1] += s.indptr[v];
  s.nbr.resize(g.n_edges);
  std::vector<int32_t> cursor(s.indptr.begin(), s.indptr.end() - 1);
  for (int64_t e = 0; e < g.n_edges; ++e)
    s.nbr[cursor[g.receivers[e]]++] = g.senders[e];
}

// Phase 1+2 combined per graph: for each center, find members, then count
// or emit induced edges in original edge order.
//
// mode 0 (sizes): writes node/edge counts per center.
// mode 1 (fill): writes member lists and local-indexed edge lists at the
//   provided per-center offsets.
void process_graph(const GraphView& g, int k, int mode,
                   int32_t* node_counts, int32_t* edge_counts,
                   const int64_t* node_out_off, const int64_t* edge_out_off,
                   int32_t* out_nodes, int32_t* out_src, int32_t* out_dst,
                   Scratch& s) {
  const int32_t n = g.n_nodes;
  build_csr(g, s);
  s.visited_at.assign(n, -1);
  s.local_id.assign(n, -1);
  s.frontier.reserve(n);
  s.next.reserve(n);
  s.members.reserve(n);

  for (int32_t c = 0; c < n; ++c) {
    // BFS from center following in-edges (graphs are symmetrized upstream)
    s.frontier.clear();
    s.members.clear();
    s.visited_at[c] = c;
    s.frontier.push_back(c);
    for (int hop = 0; hop < k && !s.frontier.empty(); ++hop) {
      s.next.clear();
      for (int32_t v : s.frontier) {
        for (int32_t i = s.indptr[v]; i < s.indptr[v + 1]; ++i) {
          int32_t u = s.nbr[i];
          if (s.visited_at[u] != c) {
            s.visited_at[u] = c;
            s.next.push_back(u);
          }
        }
      }
      s.frontier.swap(s.next);
    }
    // member list: center first, then ascending ids (egonet.py order).
    // visited_at == c marks membership; collect by scanning a compact
    // candidate set: center + BFS-discovered nodes.  To honor ascending
    // order without an O(n) scan per center, gather then sort.
    s.members.push_back(c);
    // re-walk: collect all v != c with visited_at == c.  BFS discovery
    // touched exactly those; rebuild via a second scan over the discovered
    // list is gone (frontier was swapped), so scan neighbors again cheaply
    // for k==1, else fall back to a full scan for k>1.
    if (k == 1) {
      for (int32_t i = s.indptr[c]; i < s.indptr[c + 1]; ++i) {
        int32_t u = s.nbr[i];
        if (u != c && s.visited_at[u] == c && s.local_id[u] == -1) {
          s.local_id[u] = 0;  // mark to dedup multi-edges
          s.members.push_back(u);
        }
      }
      for (size_t i = 1; i < s.members.size(); ++i)
        s.local_id[s.members[i]] = -1;
      std::sort(s.members.begin() + 1, s.members.end());
    } else {
      for (int32_t v = 0; v < n; ++v)
        if (v != c && s.visited_at[v] == c) s.members.push_back(v);
    }

    const int32_t m = static_cast<int32_t>(s.members.size());
    for (int32_t i = 0; i < m; ++i) s.local_id[s.members[i]] = i;

    // induced edges in original order
    int32_t e_count = 0;
    if (mode == 0) {
      for (int64_t e = 0; e < g.n_edges; ++e) {
        if (s.local_id[g.senders[e]] >= 0 &&
            s.local_id[g.receivers[e]] >= 0 &&
            s.visited_at[g.senders[e]] == c &&
            s.visited_at[g.receivers[e]] == c)
          ++e_count;
      }
      node_counts[c] = m;
      edge_counts[c] = e_count;
    } else {
      int64_t noff = node_out_off[c];
      for (int32_t i = 0; i < m; ++i) out_nodes[noff + i] = s.members[i];
      int64_t eoff = edge_out_off[c];
      for (int64_t e = 0; e < g.n_edges; ++e) {
        int32_t ls = s.local_id[g.senders[e]];
        int32_t lr = s.local_id[g.receivers[e]];
        if (ls >= 0 && lr >= 0 && s.visited_at[g.senders[e]] == c &&
            s.visited_at[g.receivers[e]] == c) {
          out_src[eoff] = ls;
          out_dst[eoff] = lr;
          ++eoff;
        }
      }
    }
    // reset local ids for next center
    for (int32_t i = 0; i < m; ++i) s.local_id[s.members[i]] = -1;
  }
}

void run_threaded(int n_graphs, const int64_t* node_off,
                  const int64_t* edge_off, const int32_t* senders,
                  const int32_t* receivers, int k, int mode,
                  int32_t* node_counts, int32_t* edge_counts,
                  const int64_t* node_out_off, const int64_t* edge_out_off,
                  int32_t* out_nodes, int32_t* out_src, int32_t* out_dst,
                  int n_threads) {
  std::atomic<int> next_graph{0};
  auto worker = [&]() {
    Scratch s;
    int g;
    while ((g = next_graph.fetch_add(1)) < n_graphs) {
      GraphView view{senders + edge_off[g], receivers + edge_off[g],
                     static_cast<int32_t>(node_off[g + 1] - node_off[g]),
                     edge_off[g + 1] - edge_off[g]};
      int64_t base = node_off[g];
      process_graph(view, k, mode,
                    node_counts ? node_counts + base : nullptr,
                    edge_counts ? edge_counts + base : nullptr,
                    node_out_off ? node_out_off + base : nullptr,
                    edge_out_off ? edge_out_off + base : nullptr,
                    out_nodes, out_src, out_dst, s);
    }
  };
  if (n_threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Phase 1: per-center ego-net sizes.  node_counts/edge_counts are sized to
// the total node count (= node_off[n_graphs]).
void scgib_egonet_sizes(int32_t n_graphs, const int64_t* node_off,
                        const int64_t* edge_off, const int32_t* senders,
                        const int32_t* receivers, int32_t k,
                        int32_t* node_counts, int32_t* edge_counts,
                        int32_t n_threads) {
  run_threaded(n_graphs, node_off, edge_off, senders, receivers, k, 0,
               node_counts, edge_counts, nullptr, nullptr, nullptr, nullptr,
               nullptr, n_threads);
}

// Phase 2: fill member/edge arrays at per-center offsets (int64 prefix
// sums of the phase-1 counts, one per center, total nodes + 1 entries not
// required — exactly node_off[n_graphs] entries).
void scgib_egonet_fill(int32_t n_graphs, const int64_t* node_off,
                       const int64_t* edge_off, const int32_t* senders,
                       const int32_t* receivers, int32_t k,
                       const int64_t* node_out_off,
                       const int64_t* edge_out_off, int32_t* out_nodes,
                       int32_t* out_src, int32_t* out_dst,
                       int32_t n_threads) {
  run_threaded(n_graphs, node_off, edge_off, senders, receivers, k, 1,
               nullptr, nullptr, node_out_off, edge_out_off, out_nodes,
               out_src, out_dst, n_threads);
}

// Gather rows: out[i, :] = feat[idx[i], :] — the subgraph-batch feature
// replication copy, memcpy per row.
void scgib_gather_rows(const float* feat, int32_t feat_dim,
                       const int32_t* idx, int64_t n_idx, float* out) {
  for (int64_t i = 0; i < n_idx; ++i)
    std::memcpy(out + i * feat_dim, feat + int64_t(idx[i]) * feat_dim,
                sizeof(float) * feat_dim);
}

// Batch packer over a FlatDataset (data/flat.py): for each
// selected graph, copy its node-feature rows, edge lists, and flattened
// ego-net arrays into the padded batch buffers with base offsets applied.
// Per-graph edge lists are pre-sorted receiver-major and graphs occupy
// disjoint ascending ranges, so outputs are globally sorted without any
// batch-time sort.  Threaded across selected graphs (disjoint output
// ranges -> no synchronization).  `used` returns
// [nodes, edges, sub_nodes, sub_edges] real counts; padding-edge
// self-loops and label handling stay in Python (cheap).
void scgib_pack_batch(
    int32_t n_sel, const int64_t* sel,
    const int64_t* node_off, const int64_t* edge_off,
    const int64_t* ego_node_off, const int64_t* ego_edge_off,
    const float* feat, int32_t feat_dim,
    const int32_t* senders, const int32_t* receivers,
    const int32_t* ego_nodes, const int32_t* ego_center,
    const int32_t* ego_senders, const int32_t* ego_receivers,
    float* out_feat, int32_t* out_graph, int8_t* out_node_mask,
    int32_t* out_send, int32_t* out_recv, int8_t* out_edge_mask,
    int32_t* out_center, int32_t* out_orig, int8_t* out_sub_node_mask,
    int32_t* out_sub_send, int32_t* out_sub_recv, int8_t* out_sub_edge_mask,
    int64_t* used, int32_t n_threads) {
  // per-selection output bases (prefix sums)
  std::vector<int64_t> nb(n_sel + 1, 0), eb(n_sel + 1, 0),
      sb(n_sel + 1, 0), qb(n_sel + 1, 0);
  for (int32_t b = 0; b < n_sel; ++b) {
    int64_t g = sel[b];
    nb[b + 1] = nb[b] + (node_off[g + 1] - node_off[g]);
    eb[b + 1] = eb[b] + (edge_off[g + 1] - edge_off[g]);
    sb[b + 1] = sb[b] + (ego_node_off[g + 1] - ego_node_off[g]);
    qb[b + 1] = qb[b] + (ego_edge_off[g + 1] - ego_edge_off[g]);
  }
  used[0] = nb[n_sel];
  used[1] = eb[n_sel];
  used[2] = sb[n_sel];
  used[3] = qb[n_sel];

  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    int32_t b;
    while ((b = next.fetch_add(1)) < n_sel) {
      const int64_t g = sel[b];
      const int64_t n0 = node_off[g], n = node_off[g + 1] - n0;
      const int64_t e0 = edge_off[g], e = edge_off[g + 1] - e0;
      const int64_t s0 = ego_node_off[g], s = ego_node_off[g + 1] - s0;
      const int64_t q0 = ego_edge_off[g], q = ego_edge_off[g + 1] - q0;
      const int64_t nbase = nb[b], ebase = eb[b], sbase = sb[b],
                    qbase = qb[b];
      std::memcpy(out_feat + nbase * feat_dim, feat + n0 * feat_dim,
                  sizeof(float) * n * feat_dim);
      for (int64_t i = 0; i < n; ++i) out_graph[nbase + i] = b;
      std::memset(out_node_mask + nbase, 1, n);
      for (int64_t i = 0; i < e; ++i) {
        out_send[ebase + i] = senders[e0 + i] + nbase;
        out_recv[ebase + i] = receivers[e0 + i] + nbase;
      }
      std::memset(out_edge_mask + ebase, 1, e);
      for (int64_t i = 0; i < s; ++i) {
        out_center[sbase + i] = ego_center[s0 + i] + nbase;
        out_orig[sbase + i] = ego_nodes[s0 + i] + nbase;
      }
      std::memset(out_sub_node_mask + sbase, 1, s);
      for (int64_t i = 0; i < q; ++i) {
        out_sub_send[qbase + i] = ego_senders[q0 + i] + sbase;
        out_sub_recv[qbase + i] = ego_receivers[q0 + i] + sbase;
      }
      std::memset(out_sub_edge_mask + qbase, 1, q);
    }
  };
  if (n_threads <= 1 || n_sel < 8) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
}

int32_t scgib_version() { return 2; }

}  // extern "C"
