// Native host weaver: O(n) causal-tree linearization.
//
// The third weave backend ("native", next to "pure" and "torch"): a C++
// implementation of the same derived-tree construction the device
// weaver uses (cause_tpu_torch/weaver/torchw.py), for host-side full
// reweaves and merges where the O(n^2) sequential replay (reference:
// src/causal/collections/list.cljc:20-34) is too slow and a device
// round-trip is not worth it. A copy of cause_tpu/native/weaver.cpp.
//
// Contract (shared with the device kernel, fuzz-verified against the
// pure weaver):
//   - lanes arrive in ascending id order, lane 0 is the root sentinel,
//     so the lane index IS the id rank: sibling "descending id" order
//     equals descending lane index;
//   - a special node's parent is its cause; a non-special's parent is
//     its host — the first non-special on its cause chain;
//   - children order under a parent: specials first, then descending
//     id; among specials also descending id;
//   - the weave is the preorder DFS of that tree.
//
// Map trees are a forest of per-key mini-weaves (reference:
// src/causal/collections/map.cljc:21-45): key-caused lanes hang off a
// per-key virtual root and the DFS emits each key's weave as one
// contiguous run; id-caused lanes resolve their key through the parent
// chain.
//
// All arrays are int32 and caller-allocated; the entry points return 0
// on success. No exceptions, no allocation failures other than
// std::bad_alloc aborting.

#include <cstdint>
#include <vector>

namespace {

// Build child buckets (specials-first, descending lane) and run a
// preorder DFS from the given roots. parent[i] < i for every non-root
// lane (causes precede effects in id order). rank_out gets the weave
// position of each lane; roots themselves are emitted too.
void preorder(int32_t n, const int32_t* parent, const uint8_t* special,
              const std::vector<int32_t>& roots, int32_t* rank_out) {
  // counting sort children by parent, ascending lane
  std::vector<int32_t> head_special(n, -1), head_normal(n, -1);
  std::vector<int32_t> next_lane(n, -1);
  // iterate descending lane so singly-linked lists come out ascending;
  // DFS pushes ascending onto a stack, popping descending — the
  // sibling order we need — with specials popped before normals.
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = parent[i];
    if (p < 0 || p >= n) continue;
    if (special[i]) {
      next_lane[i] = head_special[p];
      head_special[p] = i;
    } else {
      next_lane[i] = head_normal[p];
      head_normal[p] = i;
    }
  }
  // head_* lists are now descending-lane? No: built by pushing lanes in
  // ascending order, each prepended, so heads hold the LARGEST lane and
  // lists run descending — exactly sibling order. DFS with an explicit
  // stack: push normals first, then specials, both in reverse sibling
  // order, so specials pop first and siblings pop descending.
  std::vector<int32_t> stack;
  stack.reserve(64);
  int32_t pos = 0;
  std::vector<int32_t> tmp;
  for (int32_t r : roots) {
    stack.push_back(r);
    while (!stack.empty()) {
      int32_t v = stack.back();
      stack.pop_back();
      rank_out[v] = pos++;
      // children in reverse sibling order: normals ascending, then
      // specials ascending (so that popping yields specials desc first)
      tmp.clear();
      for (int32_t c = head_normal[v]; c >= 0; c = next_lane[c]) tmp.push_back(c);
      for (int32_t j = (int32_t)tmp.size() - 1; j >= 0; --j) stack.push_back(tmp[j]);
      tmp.clear();
      for (int32_t c = head_special[v]; c >= 0; c = next_lane[c]) tmp.push_back(c);
      for (int32_t j = (int32_t)tmp.size() - 1; j >= 0; --j) stack.push_back(tmp[j]);
    }
  }
}

}  // namespace

extern "C" {

// List weave. Lanes 0..n-1 in ascending id order, lane 0 = root
// sentinel (cause_idx[0] < 0). vclass: 0 normal, 1 hide, 2 h.hide,
// 3 h.show. Outputs rank_out[n] (weave position); rendering/visibility
// stays host-side on the weave list (hide?, list.cljc:48-55).
int32_t ct_weave_list(int32_t n, const int32_t* cause_idx,
                      const int32_t* vclass, int32_t* rank_out) {
  if (n <= 0) return 1;
  std::vector<uint8_t> special(n);
  std::vector<int32_t> parent(n);
  std::vector<int32_t> host(n);  // host[x] = first non-special at-or-above x
  for (int32_t i = 0; i < n; ++i) special[i] = vclass[i] > 0 ? 1 : 0;
  host[0] = 0;
  parent[0] = -1;
  for (int32_t i = 1; i < n; ++i) {
    int32_t c = cause_idx[i];
    if (c < 0 || c >= i) return 2;  // causes must precede effects
    host[i] = special[i] ? host[c] : i;
    parent[i] = special[i] ? c : host[c];
  }
  preorder(n, parent.data(), special.data(), {0}, rank_out);
  return 0;
}

// Map weave. key_rank[i] >= 0 for key-caused lanes (the key's interned
// ordinal), -1 for id-caused lanes (cause_idx[i] then names the target
// lane). n_keys = number of distinct keys. Outputs rank_out[n] — a
// forest preorder in which each key's lanes are one contiguous run, in
// that key's weave order (the per-key s/weave-node order of
// map.cljc:21-45) — and key_out[n], each lane's resolved key ordinal.
//
// Every key's mini-weave is an ordinary list weave whose root is a
// per-key virtual lane (the ROOT sentinel of map.cljc:80): key-caused
// lanes are caused by their key's root; id-caused lanes by the target.
int32_t ct_weave_map(int32_t n, int32_t n_keys, const int32_t* cause_idx,
                     const int32_t* key_rank, const int32_t* vclass,
                     int32_t* rank_out, int32_t* key_out) {
  if (n < 0 || n_keys < 0) return 1;
  if (n == 0) return 0;
  // lane n+k is the virtual root of key k (non-special, hosts itself)
  int32_t m = n + n_keys;
  std::vector<uint8_t> special(m, 0);
  std::vector<int32_t> parent(m, -1);
  std::vector<int32_t> host(m);  // host[x] = first non-special at-or-above x
  for (int32_t i = 0; i < n; ++i) special[i] = vclass[i] > 0 ? 1 : 0;
  for (int32_t k = 0; k < n_keys; ++k) host[n + k] = n + k;
  for (int32_t i = 0; i < n; ++i) {
    int32_t c;  // the cause lane inside the forest
    if (key_rank[i] >= 0) {
      if (key_rank[i] >= n_keys) return 3;
      key_out[i] = key_rank[i];
      c = n + key_rank[i];
    } else {
      c = cause_idx[i];
      if (c < 0 || c >= i) return 2;  // causes must precede effects
      key_out[i] = key_out[c];
    }
    host[i] = special[i] ? host[c] : i;
    parent[i] = special[i] ? c : host[c];
  }
  std::vector<int32_t> roots;
  roots.reserve(n_keys);
  for (int32_t k = 0; k < n_keys; ++k) roots.push_back(n + k);
  std::vector<int32_t> rank_all(m);
  preorder(m, parent.data(), special.data(), roots, rank_all.data());
  // compress out the virtual roots: ranks renumbered in global order
  std::vector<int32_t> at(m, -1);
  for (int32_t i = 0; i < m; ++i) at[rank_all[i]] = i;
  int32_t pos = 0;
  for (int32_t r = 0; r < m; ++r) {
    int32_t lane = at[r];
    if (lane >= 0 && lane < n) rank_out[lane] = pos++;
  }
  return 0;
}

}  // extern "C"
