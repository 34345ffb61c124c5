// Conditional (IF) nodes in a CUDA graph that PyTorch is capturing.
//
// The reference keeps its control flow on the device: lax.cond runs a
// branch only where its predicate holds.  A stream capture records every
// launch, so a replayed graph would run a dead branch's whole body.  A
// conditional node (CUDA 12.4 on) runs its body graph only where a handle
// that a kernel sets on the device is nonzero.  spasm_graph_if_begin
// appends to the graph that parent is capturing a one-thread kernel that
// copies the predicate (a one-byte device flag) into a new handle, then an
// IF node on that handle, and starts capturing body into the IF node's body
// graph; everything launched on body until spasm_graph_if_end is recorded
// there.  The parent's capture continues after the IF node.  A body holds
// kernels, copies and memsets only.  All bodies are captured on one stream
// (spasm_stream_create).  A body's capture has a capture id of its own, so
// PyTorch's allocator does not count its allocations as the graph's: the
// caller sends them to a pool that lives as long as the graph
// (ops/_cuda.py, graph_if).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const unsigned char* __restrict__ pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// a stream of its own for the IF bodies (non-blocking, never destroyed);
// made in relaxed capture mode, so that a capture on another stream of
// this thread does not refuse it
int spasm_stream_create(void** out) {
    cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
    cudaError_t e = cudaThreadExchangeStreamCaptureMode(&mode);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaStream_t s = nullptr;
    e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    cudaThreadExchangeStreamCaptureMode(&mode);
    *out = s;
    return static_cast<int>(e);
}

int spasm_graph_if_begin(void* parent, void* body, const void* pred) {
    auto ps = static_cast<cudaStream_t>(parent);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t ndeps;
    cudaError_t e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph,
                                             &deps, &ndeps);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (status != cudaStreamCaptureStatusActive)
        return static_cast<int>(cudaErrorStreamCaptureImplicit);
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    set_condition<<<1, 1, 0, ps>>>(
        handle, static_cast<const unsigned char*>(pred));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    // the IF node depends on the kernel just captured
    e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps,
                                 &ndeps);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                            cudaStreamSetCaptureDependencies);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
        nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal));
}

int spasm_graph_if_end(void* body) {
    cudaGraph_t graph;   // the IF node's body graph, owned by the node
    return static_cast<int>(
        cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}

}  // extern "C"
