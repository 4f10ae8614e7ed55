// K8f, the step half: the BFS era's gate and step commit, on the card;
// with a lane axis, K14f's (the multiplexed lanes' era, under jax.vmap).
//
// Replaces, in stateright_tpu/engines/tpu_bfs.py:361 `_build_loop.loop`,
// the `lax.while_loop` predicate `cond` (:403-426), the take (:449-455),
// the commit rules at the end of `body` (:585-621, :627-685: overflow,
// head, count, unique, generated, steps, take_cap, the error count, the
// coverage counts and the scalar discovery bits) and the era and
// dispatch prologues of `run_era` (:730-760) and of the fused outer loop
// (:884-937). One launch a step, after it: it commits the step and
// decides the next one, so the era needs no host round trip.
//
// Modes (one block a lane):
//   START   once a dispatch: zero the dispatch's outputs (generated,
//           steps, max depth, the coverage tail, the fusion lanes), clamp
//           fuse_lim, zero the sample slab, and open the outer (fusion)
//           loop;
//   BEGIN   once an era: zero the era's step and generated counts, keep
//           its input discovery bits and unique count, clamp take_cap to
//           [1, chunk], then the gate;
//   COMMIT  once a step: if the gate was open, commit the step (a partial
//           step on overflow), raise the visited-insert epoch, then the
//           gate for the next step.
// The gate (`cond`): open while 0 < count <= high_water, unique <=
// grow_limit, steps < max_steps, no error, the finish masks unmet and
// (sampling on) slab occupancy <= s_high; the take is min(count, chunk,
// take_cap) and, while the sample threshold is still (MAX, MAX), at most
// s_take; 0 when the gate is closed, so a closed step changes nothing.
//
// Lanes (engines/multiplex.py): the state is [lanes, stride], one JAX
// params row (then the X_* words) a lane, and the step operands are per
// lane (n_val[N], n_d[N], unresolved / c_new [N, n], generated[N],
// hs[P, N], pa[N, A]). Block l commits and gates lane l alone; a lane
// whose gate closed keeps every word, as vmap's select does in the JAX
// lane program. The loop runs while ANY lane is open: the last block to
// finish (a ticket taken with atomicAdd after a __threadfence) ORs the
// lanes' gates, sets the conditional once, raises the epoch once and
// resets the ticket. Lanes have no sample slab and no fusion tail.
//
// A conditional-node handle other than 0 receives the gate (BEGIN,
// COMMIT; with lanes, the OR of the lanes' gates) or 1 (START): that is
// what ends the era's CUDA-graph WHILE loop on the card (engines/graph.py).
// This source also holds the host functions that build that graph
// (srt_graph_*).
//
// Bound on the card: latency. The work is a few dozen scalar words a
// lane and two sums over each lane's insert masks; one block a lane does
// it, and the launch itself is the cost.

#include "era.cuh"

namespace {

using namespace era;

constexpr int kThreads = 256;
constexpr int MODE_START = 0, MODE_BEGIN = 1, MODE_COMMIT = 2;

struct StepIn {
  const long long* n_val;      // [N] valid candidates
  const long long* n_d;        // [N] distinct candidates
  const bool* unresolved;      // [N, n] insert left unresolved
  const bool* c_new;           // [N, n] newly inserted
  long long n;
  const long long* generated;  // [N] valid successors of the active rows
  const long long* hs;         // [P, N] rows that hit each property
  const long long* pa;         // [N, A] valid candidates of each action (coverage)
  long long* slab[4];          // the sample slab's lanes (scap + 1 rows; one lane only)
  long long* slab_counts;      // [occupied, dropped]
  long long* epoch;            // the visited insert's epoch
  long long lanes;             // N
  long long stride;            // words of one lane's state row
  unsigned long long* ticket;  // the last-block ticket (N > 1)
};

__device__ void gate(const Cfg& c, long long* s, const long long* slab_counts) {
  long long* x = s + c.x;
  const long long count = s[P_COUNT];
  bool open = count > 0 && count <= s[P_HIGH_WATER] && s[P_UNIQUE] <= s[P_GROW_LIMIT] &&
              x[X_ESTEPS] < s[P_MAX_STEPS] && s[P_ERR] == 0 && !fin_hit(s, s[P_REC]);
  if (c.s_base >= 0) open = open && slab_counts[0] <= c.s_high;
  long long take = 0;
  if (open) {
    take = min(min(count, c.chunk), s[P_TAKE_CAP]);
    if (c.s_base >= 0 && s[c.s_base] == M32 && s[c.s_base + 1] == M32)
      take = min(take, c.s_take);  // the loose-threshold clamp (tpu_bfs.py:449-455)
  }
  x[X_OPEN] = open;
  x[X_TAKE] = take;
  x[X_TAIL] = (s[P_HEAD] + count) & c.qmask;
}

__device__ long long block_count(const bool* v, long long n, long long* red) {
  int cnt = 0;
  for (long long i = threadIdx.x; i < n; i += kThreads) cnt += v[i];
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = cnt;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Lane l's commit (thread 0, after the block's two sums).
__device__ void commit(const Cfg& c, long long* s, const StepIn& in, long long l,
                       long long unres, long long new_count) {
  long long* x = s + c.x;
  const long long take = x[X_TAKE];
  if (take <= 1) s[P_ERR] = (s[P_ERR] + unres) & M32;
  const bool ovf = in.n_val[l] > c.vcap || in.n_d[l] > c.rcap || unres > 0;
  const long long consumed = ovf ? 0 : take;
  s[P_HEAD] = (s[P_HEAD] + consumed) & c.qmask;
  s[P_COUNT] = (s[P_COUNT] - consumed + new_count) & M32;
  s[P_UNIQUE] = (s[P_UNIQUE] + new_count) & M32;
  if (!ovf) {
    const long long gen = in.generated[l];
    x[X_EGEN] = (x[X_EGEN] + gen) & M32;
    s[P_GEN] = (s[P_GEN] + gen) & M32;
    x[X_ESTEPS] += 1;
    s[P_STEPS] = (s[P_STEPS] + 1) & M32;
    s[P_TAKE_CAP] = min(s[P_TAKE_CAP] + c.regrow, c.chunk);
  } else {
    s[P_TAKE_CAP] = max(take >> 1, 1ll);
  }
  if (c.cov_base >= 0) {
    long long* cv = s + c.cov_base;
    if (!ovf) {
      for (long long a = 0; a < c.A; ++a) cv[a] = (cv[a] + in.pa[l * c.A + a]) & M32;
      for (long long i = 0; i < c.P; ++i)
        cv[c.A + i] = (cv[c.A + i] + in.hs[i * in.lanes + l]) & M32;
    }
    cv[c.A + c.P] = (cv[c.A + c.P] + consumed) & M32;
  }
  for (long long i = 0; i < c.P; ++i)
    if (in.hs[i * in.lanes + l] > 0) s[P_REC] |= 1ll << i;
  x[X_ITER] += 1;
  x[X_PARTIAL] += ovf;
}

__global__ void __launch_bounds__(kThreads)
    era_step_kernel(int mode, const Cfg c, long long* s0, const __grid_constant__ StepIn in,
                    cudaGraphConditionalHandle h) {
  __shared__ long long red[kThreads / 32];
  __shared__ bool last;
  const long long l = blockIdx.x;
  long long* s = s0 + l * in.stride;
  long long* x = s + c.x;
  const int t = threadIdx.x;
  if (mode == MODE_START) {
    if (c.cov_base >= 0)
      for (long long i = t; i < c.n_cov; i += kThreads) s[c.cov_base + i] = 0;
    if (c.f_base >= 0)
      for (long long i = t; i < 4 * c.fuse; i += kThreads) s[c.f_base + 2 + i] = 0;
    if (c.s_base >= 0) {
      for (int k = 0; k < 4; ++k)
        for (long long i = t; i <= c.scap; i += kThreads) in.slab[k][i] = 0;
      if (t < 2) in.slab_counts[t] = 0;
    }
    if (t == 0) {
      s[P_GEN] = s[P_STEPS] = s[P_MAXD] = 0;
      x[X_ITER] = x[X_PARTIAL] = x[X_K] = 0;
      if (c.f_base >= 0) {
        s[c.f_base] = min(max(s[c.f_base], 1ll), c.fuse);
        s[c.f_base + 1] = 0;
      }
      if (h) cudaGraphSetConditional(h, 1u);
    }
    return;
  }
  if (mode == MODE_BEGIN) {
    if (t == 0) {
      x[X_ESTEPS] = x[X_EGEN] = 0;
      x[X_REC0] = s[P_REC];
      x[X_UNIQ_IN] = s[P_UNIQUE];
      s[P_TAKE_CAP] = min(max(s[P_TAKE_CAP], 1ll), c.chunk);
      gate(c, s, in.slab_counts);
    }
  } else if (x[X_OPEN]) {
    // COMMIT of an open lane: every thread of the block read the same
    // open flag, so the sums are reached by the whole block or by none.
    const long long unres = block_count(in.unresolved + l * in.n, in.n, red);
    const long long new_count = block_count(in.c_new + l * in.n, in.n, red);
    if (t == 0) {
      commit(c, s, in, l, unres, new_count);
      if (in.lanes == 1) *in.epoch += 1;
      gate(c, s, in.slab_counts);
    }
  }
  if (in.lanes == 1) {
    if (t == 0 && h) cudaGraphSetConditional(h, x[X_OPEN] ? 1u : 0u);
    return;
  }
  // Lanes: the last block to get here ORs every lane's gate.
  if (t == 0) {
    __threadfence();
    last = atomicAdd(in.ticket, 1ull) == (unsigned long long)(in.lanes - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int any = 0;
  const volatile long long* vs = s0;
  for (long long j = t; j < in.lanes; j += kThreads) any |= vs[j * in.stride + c.x + X_OPEN] != 0;
  any = __syncthreads_or(any);
  if (t == 0) {
    if (h) cudaGraphSetConditional(h, any ? 1u : 0u);
    if (mode == MODE_COMMIT && in.epoch) *in.epoch += 1;
    *in.ticket = 0;
  }
}

}  // namespace

// mode: 0 START, 1 BEGIN, 2 COMMIT. cfg: the host's config vector
// (era.cuh Cfg). state: [lanes, stride] int64 (one lane: stride unused).
// The step operands are read by COMMIT only, per lane (n: the width of
// one lane's insert masks); the slab (null without sampling; one lane
// only) by START and the gate. ticket: one zeroed uint64 on the card
// when lanes > 1 (BEGIN, COMMIT). handle: a conditional node's handle,
// or 0 (START: one lane only).
extern "C" int srt_era_step(int mode, const void* cfg, void* state, long long lanes,
                            long long stride, const void* n_val, const void* n_d,
                            const void* unresolved, const void* c_new, long long n,
                            const void* generated, const void* hs, const void* pa, void* sfp1,
                            void* sfp2, void* sdep, void* sact, void* slab_counts, void* epoch,
                            void* ticket, unsigned long long handle, void* stream) {
  if (mode < MODE_START || mode > MODE_COMMIT || lanes < 1) return (int)cudaErrorInvalidValue;
  const Cfg c = load_cfg((const long long*)cfg);
  if (lanes > 1 && (c.s_base >= 0 || c.f_base >= 0 ||
                    (mode == MODE_START ? handle != 0 : ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  StepIn in{};
  in.n_val = (const long long*)n_val;
  in.n_d = (const long long*)n_d;
  in.unresolved = (const bool*)unresolved;
  in.c_new = (const bool*)c_new;
  in.n = n;
  in.generated = (const long long*)generated;
  in.hs = (const long long*)hs;
  in.pa = (const long long*)pa;
  in.slab[0] = (long long*)sfp1;
  in.slab[1] = (long long*)sfp2;
  in.slab[2] = (long long*)sdep;
  in.slab[3] = (long long*)sact;
  in.slab_counts = (long long*)slab_counts;
  in.epoch = (long long*)epoch;
  in.lanes = lanes;
  in.stride = stride;
  in.ticket = (unsigned long long*)ticket;
  era_step_kernel<<<(unsigned)lanes, kThreads, 0, (cudaStream_t)stream>>>(
      mode, c, (long long*)state, in, (cudaGraphConditionalHandle)handle);
  return (int)cudaGetLastError();
}

// The device-program graphs (engines/graph.py): conditional WHILE nodes whose bodies
// hold the torch-captured segments as child graphs. Every function
// returns a cudaError_t as int.
namespace {

int depend(cudaGraph_t g, void* after, cudaGraphNode_t node) {
  if (after == nullptr) return 0;
  cudaGraphNode_t from = (cudaGraphNode_t)after;
  return (int)cudaGraphAddDependencies(g, &from, &node, 1);
}

}  // namespace

extern "C" int srt_graph_create(void** graph) {
  return (int)cudaGraphCreate((cudaGraph_t*)graph, 0);
}

// A conditional handle of `graph`, 0 at every launch until a kernel sets it.
extern "C" int srt_graph_handle(void* graph, unsigned long long* handle) {
  return (int)cudaGraphConditionalHandleCreate((cudaGraphConditionalHandle*)handle,
                                               (cudaGraph_t)graph, 0,
                                               cudaGraphCondAssignDefault);
}

// A WHILE node on `handle` after node `after` (or a root), and its body.
extern "C" int srt_graph_while(void* graph, void* after, unsigned long long handle, void** node,
                               void** body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  int e = (int)cudaGraphAddNode((cudaGraphNode_t*)node, (cudaGraph_t)graph, nullptr, 0, &p);
  if (e) return e;
  *body = p.conditional.phGraph_out[0];
  return depend((cudaGraph_t)graph, after, (cudaGraphNode_t)*node);
}

// A child-graph node (a copy of `child`) after node `after` (or a root).
extern "C" int srt_graph_child(void* graph, void* after, void* child, void** node) {
  int e = (int)cudaGraphAddChildGraphNode((cudaGraphNode_t*)node, (cudaGraph_t)graph, nullptr,
                                          0, (cudaGraph_t)child);
  if (e) return e;
  return depend((cudaGraph_t)graph, after, (cudaGraphNode_t)*node);
}

extern "C" int srt_graph_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate((cudaGraphExec_t*)exec, (cudaGraph_t)graph, 0);
}

extern "C" int srt_graph_launch(void* exec, void* stream) {
  cudaError_t e = cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The nodes of `graph` by type: counts[0] kernels, [1] memsets, [2] all
// (a captured call's launches, counted on the card; child graphs are not
// entered).
extern "C" int srt_graph_nodes(void* graph, long long* counts) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  if (e != cudaSuccess) return (int)e;
  counts[0] = counts[1] = 0;
  counts[2] = (long long)n;
  if (n == 0) return 0;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes((cudaGraph_t)graph, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t = cudaGraphNodeTypeEmpty;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (t == cudaGraphNodeTypeKernel) ++counts[0];
    if (t == cudaGraphNodeTypeMemset) ++counts[1];
  }
  delete[] nodes;
  return (int)e;
}

extern "C" int srt_graph_destroy(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph && e == cudaSuccess) e = cudaGraphDestroy((cudaGraph_t)graph);
  return (int)e;
}
