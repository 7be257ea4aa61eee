// Graph control for `utils/compiled.py`'s `while_loop`: a conditional WHILE
// node inside the CUDA graph that a stream is capturing, so a loop whose
// trip count depends on the data runs on the card with no read by the host
// (the counterpart of XLA's while loop inside a jitted program).
//
// Inside a capture on `stream` the caller:
//   1. makes the node's handle (gme_while_handle);
//   2. launches gme_while_set with the loop's first condition, in the graph
//      before the node (0 iterations are possible);
//   3. adds the node and begins capturing `body_stream` into its body graph
//      (gme_while_begin); the outer capture continues after the node;
//   4. captures the body on `body_stream`, ending with gme_while_set, which
//      sets the handle from the next condition;
//   5. ends the body's capture (gme_while_end).
// The node runs its body while the handle is nonzero.  Nothing here is a
// port of a TPU kernel: gme_while_set is one thread of bookkeeping.
#include "gme_kernels.cuh"

__global__ void gme_while_set_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

GME_API int gme_while_handle(cudaStream_t stream, unsigned long long* handle_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  *handle_out = handle;
  return err;
}

GME_API int gme_while_set(unsigned long long handle, const void* flag, cudaStream_t stream) {
  gme_while_set_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(flag));
  return cudaGetLastError();
}

GME_API int gme_while_begin(cudaStream_t stream, cudaStream_t body_stream,
                            unsigned long long handle) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body_stream, params.conditional.phGraph_out[0], nullptr,
                                       nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

GME_API int gme_while_end(cudaStream_t body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(body_stream, &body);
}
