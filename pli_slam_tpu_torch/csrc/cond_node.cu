// CUDA-graph conditional IF nodes for stream capture: the fused steps' keyframe
// branch (ops/kernels/conditional.py binds this file with ctypes).
//
// Replaces the reference's `jax.lax.cond(need_kf, ...)` and
// `lax.cond(n_kf2 >= 3, ...)` (pli_slam_tpu/frontend/tracker.py:1187, :1102,
// and :1394, :1292 for the stereo-inertial step), which XLA lowers to a
// device-side branch of the one jitted frame program. It replaces no Pallas
// kernel. On the card the branch is a conditional node of the captured frame
// graph (CUDA >= 12.4): its body is a child graph that the device runs or skips
// at each replay, by a handle that a kernel of the same graph sets from a 0-d
// bool tensor, so the host never reads the decision.
//
// What bounds it: `set_conditional_kernel` reads one byte and writes the
// node's handle -- one thread, launch latency only; the node itself costs the
// device a graph-internal launch of the body when the predicate holds.
//
// The capture, as PyTorch's own CUDAGraph::begin_capture_to_if_node does it
// (PyTorch 2.11, on the card, has no Python route to that method):
//   cond_if_begin: on the parent stream (capturing): create a handle in the
//     graph being captured, capture the kernel that sets it, add the IF node
//     after the stream's current dependencies, make the node the stream's only
//     dependency, and begin capturing `body_stream` into the node's body graph;
//   cond_if_end: end the body's capture.
// The caller routes the body's allocations into the capture's memory pool
// (the body stream is not the capturing stream PyTorch's pool filter knows).
// The body stream is the port's own (`cond_stream_create`), not one of
// PyTorch's pooled streams: `torch.cuda.Stream()` hands those out round-robin,
// so a later capture's stream could be the body stream, and a body capture
// begun on the stream that captures its parent is refused
// (cudaErrorIllegalState). Every entry returns 0 or a cudaError.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Load the kernel (and start this library's runtime) outside any capture:
// a module loaded lazily at its first launch inside a capture is refused.
extern "C" int cond_init() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, set_conditional_kernel));
}

// A stream of the caller's own, non-blocking as PyTorch's pooled streams are;
// it lives as long as the process.
extern "C" int cond_stream_create(void** out) {
  cudaStream_t s = nullptr;
  const cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return static_cast<int>(e);
}

extern "C" int cond_if_begin(void* parent_stream, const void* pred, void* body_stream) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(parent, &status, &id, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_conditional_kernel<<<1, 1, 0, parent>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the dependencies now end at the kernel just captured
  e = cudaStreamGetCaptureInfo(parent, &status, &id, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  e = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), body, nullptr,
                                                        nullptr, 0, cudaStreamCaptureModeThreadLocal));
}

namespace {
int census[16] = {};  // the last body's nodes by cudaGraphNodeType (index 15: memcpys that touch host memory)

bool on_host(const void* p) {
  cudaPointerAttributes a;
  return cudaPointerGetAttributes(&a, p) == cudaSuccess && a.type != cudaMemoryTypeDevice;
}

void count_nodes(cudaGraph_t body) {
  for (int& c : census) c = 0;
  size_t n = 0;
  if (cudaGraphGetNodes(body, nullptr, &n) != cudaSuccess || n == 0) return;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  if (cudaGraphGetNodes(body, nodes, &n) == cudaSuccess) {
    for (size_t i = 0; i < n; ++i) {
      cudaGraphNodeType t;
      if (cudaGraphNodeGetType(nodes[i], &t) != cudaSuccess) continue;
      if (static_cast<int>(t) >= 0 && static_cast<int>(t) < 15) census[static_cast<int>(t)] += 1;
      cudaMemcpy3DParms m;
      if (t == cudaGraphNodeTypeMemcpy && cudaGraphMemcpyNodeGetParams(nodes[i], &m) == cudaSuccess &&
          (on_host(m.srcPtr.ptr) || on_host(m.dstPtr.ptr)))
        census[15] += 1;
    }
  }
  delete[] nodes;
}
}  // namespace

extern "C" int cond_if_end(void* body_stream) {
  cudaGraph_t body = nullptr;  // the node's own body graph: the node keeps it
  const cudaError_t e = cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
  if (e == cudaSuccess && body != nullptr) count_nodes(body);
  return static_cast<int>(e);
}

// The nodes of the body `cond_if_end` ended last, by cudaGraphNodeType
// (kernel 0, memcpy 1, memset 2, host 3, child graph 4, empty 5, event wait
// 6, event record 7, ..., conditional 13), and in out[15] the memcpys that
// touch host memory: what a conditional body may hold is restricted.
extern "C" void cond_body_census(int* out) {
  for (int i = 0; i < 16; ++i) out[i] = census[i];
}
