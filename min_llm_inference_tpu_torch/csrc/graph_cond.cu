// Conditional nodes for a CUDA graph under stream capture: the device form
// of an `if` whose predicate lives in device memory.
//
// The JAX burst keeps its data-dependent steps on the device as lax.cond
// (the burst's liveness gate) and lax.switch (its prefill bucket). On this
// card the burst is one captured CUDA graph, and such a step becomes an IF
// node (CUDA 12.4+): a kernel sets the node's handle from a bool in device
// memory at replay, and the node runs its body graph or skips it. Nothing
// is read by the host.
//
// mli_if_begin, called while `parent` is being captured, ends the parent's
// current dependencies in
//   set_handle kernel -> IF node
// and starts capturing `child` into the IF node's body graph: the caller
// issues the body's work on `child` and then calls mli_if_end(child), after
// which work issued on `parent` follows the IF node. Nesting is allowed (a
// body may hold IF nodes of its own, each on a stream of its own).
//
// mli_phase_stamp, called while a stream is captured, records a device
// span's stamp: a one-thread kernel that reads the global timer. The start
// stamp keeps the time in its phase's row; the end stamp adds the elapsed
// nanoseconds and one call to the row (utils/profiling.phase, with tracing
// on).
//
// Plain C interface, loaded with ctypes (ops/_build.py builds it).
// runtime/graph.py drives it.

#include <cuda_runtime.h>

// CUDA 13 folded the edge-data forms of these calls into the plain names
#if CUDART_VERSION >= 13000
#define CAPTURE_INFO(s, st, g, d, n) \
  cudaStreamGetCaptureInfo(s, st, nullptr, g, d, nullptr, n)
#define ADD_NODE(node, g, d, n, p) cudaGraphAddNode(node, g, d, nullptr, n, p)
#define SET_DEPS(s, d, n) \
  cudaStreamUpdateCaptureDependencies(s, d, nullptr, n, \
                                      cudaStreamSetCaptureDependencies)
#else
#define CAPTURE_INFO(s, st, g, d, n) \
  cudaStreamGetCaptureInfo(s, st, nullptr, g, d, n)
#define ADD_NODE(node, g, d, n, p) cudaGraphAddNode(node, g, d, n, p)
#define SET_DEPS(s, d, n) \
  cudaStreamUpdateCaptureDependencies(s, d, n, cudaStreamSetCaptureDependencies)
#endif

namespace {

__global__ void set_handle_kernel(cudaGraphConditionalHandle handle,
                                  const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// row: [start ns, summed ns, calls] of one phase
__global__ void phase_stamp_kernel(long long* row, int end) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (end) {
    row[1] += static_cast<long long>(now) - row[0];
    row[2] += 1;
  } else {
    row[0] = static_cast<long long>(now);
  }
}

}  // namespace

extern "C" {

// 0, or the CUDA error code (cudaErrorStreamCaptureImplicit when `parent`
// is not being captured).
int mli_if_begin(cudaStream_t parent, const bool* pred, cudaStream_t child) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = CAPTURE_INFO(parent, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_handle_kernel<<<1, 1, 0, parent>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dependencies now end in the kernel just captured
  err = CAPTURE_INFO(parent, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = ADD_NODE(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = SET_DEPS(parent, &node, 1);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(child, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

int mli_if_end(cudaStream_t child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(child, &body);
}

// 0, or the CUDA error code of the launch.
int mli_phase_stamp(cudaStream_t stream, long long* row, int end) {
  phase_stamp_kernel<<<1, 1, 0, stream>>>(row, end);
  return cudaGetLastError();
}

// A stream of its own for a capture or an IF body (nullptr on failure):
// torch's pooled streams are handed out round-robin, so two of them can be
// one stream, and a stream cannot be captured into two graphs at once.
void* mli_stream_create() {
  cudaStream_t stream = nullptr;
  if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) != cudaSuccess)
    return nullptr;
  return stream;
}

// Write a captured graph in Graphviz form (its conditional bodies too).
int mli_graph_dot(cudaGraph_t graph, const char* path) {
  return cudaGraphDebugDotPrint(graph, path, 0);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
