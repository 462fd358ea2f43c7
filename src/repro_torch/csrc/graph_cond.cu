// Device control flow inside a captured CUDA graph (sm_90a, CUDA >= 12.4):
// the conditional nodes that carry the port's while_loop and cond
// (src/repro_torch/core/device_loop.py) when a stream segment is captured.
// Bound to PyTorch through a plain C interface (ctypes); every entry point
// returns a cudaError_t as an int, 0 on success.
//
// Replaces no TPU kernel: the reference runs a stream segment as one
// jitted lax.scan, and the data-dependent loops inside it (a fixed point,
// a parent chase, a wedge walk) as lax.while_loop and lax.cond.  Here a
// segment is one captured torch.cuda.CUDAGraph and each such loop is a
// WHILE node (each branch an IF node) whose body graph is captured from a
// side stream:
//
//   repro_cond_handle    a handle on the graph that `stream` is capturing
//                        (reset to 0 at every launch of the graph)
//   repro_cond_set       launches one thread on `stream` that reads a
//                        device bool (negated when asked) and sets the
//                        handle: before a WHILE node for its first test,
//                        at the end of its body for the next one
//   repro_cond_node      adds a WHILE (kind 1) or IF (kind 0) node after
//                        the capture's current dependencies and returns
//                        the body graph to capture into
//   repro_cond_body_begin / repro_cond_body_end
//                        capture `body_stream` into that body graph
//   repro_cond_node_end  makes the node the capture's one dependency, so
//                        what `stream` captures next runs after the body
//
// The set kernel is a single thread reading one byte; what bounds a loop
// is its body.  The cost of a node is the device's own scheduling of the
// body graph, with no trip to the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle,
                                const bool* __restrict__ pred, int negate) {
  unsigned int v = *pred ? 1u : 0u;
  cudaGraphSetConditional(handle, negate ? v ^ 1u : v);
}

}  // namespace

extern "C" int repro_cond_handle(void* stream, void* handle_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr,
      nullptr);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  return (int)cudaGraphConditionalHandleCreate(
      static_cast<cudaGraphConditionalHandle*>(handle_out), graph, 0,
      cudaGraphCondAssignDefault);
}

extern "C" int repro_cond_set(unsigned long long handle, const void* pred,
                              int negate, void* stream) {
  set_cond_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      (cudaGraphConditionalHandle)handle, (const bool*)pred, negate);
  return (int)cudaGetLastError();
}

extern "C" int repro_cond_node(void* stream, unsigned long long handle,
                               int kind, void* body_out, void* node_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, nullptr, &graph, &deps,
      &num_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = kind ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (err != cudaSuccess) return (int)err;
  *static_cast<cudaGraph_t*>(body_out) = params.conditional.phGraph_out[0];
  *static_cast<cudaGraphNode_t*>(node_out) = node;
  return 0;
}

extern "C" int repro_cond_body_begin(void* body_stream, void* body) {
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), static_cast<cudaGraph_t>(body),
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int repro_cond_body_end(void* body_stream) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                   &graph);
}

extern "C" int repro_cond_node_end(void* stream, void* node) {
  cudaGraphNode_t n = static_cast<cudaGraphNode_t>(node);
  return (int)cudaStreamUpdateCaptureDependencies(
      static_cast<cudaStream_t>(stream), &n, 1,
      cudaStreamSetCaptureDependencies);
}
