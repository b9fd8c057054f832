// CUDA graphs whose parts run under conditions that the device decides.
//
// The counterpart of a bounded loop that XLA keeps on the device (JAX's
// lax.while_loop, lax.cond): parts captured by PyTorch as CUDA graphs are
// chained into one graph, and a part with a condition becomes a kernel that
// reads a bool on the device and sets a conditional handle, followed by a
// CUDA IF node (CUDA 12.4 and later) whose body is that part.  Where the
// bool is false the body launches nothing; the host reads nothing.
#include <cuda_runtime.h>

#define CHECK(call)                                \
  do {                                             \
    cudaError_t rc_ = (call);                      \
    if (rc_ != cudaSuccess) return (int)rc_;       \
  } while (0)

__global__ void gpitch_set_condition_kernel(cudaGraphConditionalHandle handle,
                                            const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The number of nodes at the top level of ``graph``.
extern "C" int gpitch_graph_nodes(void* graph, long long* count) {
  size_t n = 0;
  CHECK(cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n));
  *count = static_cast<long long>(n);
  return 0;
}

// A new graph that runs parts[0], ..., parts[n - 1] one after another, and
// its executable.  Part k is a child-graph node of parts[k] (the graph is
// cloned) or, where preds[k] is not null, a one-thread kernel that sets a
// conditional handle from the bool *preds[k] (read when that kernel runs,
// after part k - 1) and an IF node whose body is that child graph.
extern "C" int gpitch_graph_chain(int n, void** parts, void** preds, void** graph_out,
                                  void** exec_out) {
  cudaGraph_t graph;
  CHECK(cudaGraphCreate(&graph, 0));
  cudaGraphNode_t prev = nullptr;
  for (int k = 0; k < n; ++k) {
    const cudaGraphNode_t* deps = prev ? &prev : nullptr;
    size_t ndeps = prev ? 1 : 0;
    cudaGraph_t part = static_cast<cudaGraph_t>(parts[k]);
    cudaGraphNode_t node;
    if (preds[k] == nullptr) {
      CHECK(cudaGraphAddChildGraphNode(&node, graph, deps, ndeps, part));
    } else {
      cudaGraphConditionalHandle handle;
      CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault));
      const bool* pred = static_cast<const bool*>(preds[k]);
      void* args[] = {&handle, &pred};
      cudaKernelNodeParams kp = {};
      kp.func = reinterpret_cast<void*>(gpitch_set_condition_kernel);
      kp.gridDim = dim3(1);
      kp.blockDim = dim3(1);
      kp.kernelParams = args;
      cudaGraphNode_t set;
      CHECK(cudaGraphAddKernelNode(&set, graph, deps, ndeps, &kp));
      cudaGraphNodeParams cp = {};
      cp.type = cudaGraphNodeTypeConditional;
      cp.conditional.handle = handle;
      cp.conditional.type = cudaGraphCondTypeIf;
      cp.conditional.size = 1;
      CHECK(cudaGraphAddNode(&node, graph, &set, 1, &cp));
      cudaGraphNode_t body;
      CHECK(cudaGraphAddChildGraphNode(&body, cp.conditional.phGraph_out[0], nullptr, 0, part));
    }
    prev = node;
  }
  cudaGraphExec_t exec;
  CHECK(cudaGraphInstantiate(&exec, graph, 0));
  *graph_out = graph;
  *exec_out = exec;
  return 0;
}

extern "C" int gpitch_graph_launch(void* exec, void* stream) {
  CHECK(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
  return 0;
}

extern "C" int gpitch_graph_free(void* graph, void* exec) {
  CHECK(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
  CHECK(cudaGraphDestroy(static_cast<cudaGraph_t>(graph)));
  return 0;
}
