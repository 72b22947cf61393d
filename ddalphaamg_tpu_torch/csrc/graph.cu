// CUDA graphs with conditional nodes, captured on one stream: the device
// program of the coarsest GCR (solvers/cuda_graph.py, mg/coarsest.py).
//
// It replaces no Pallas kernel.  The JAX package traces the coarsest solve
// into one XLA program (ddalphaamg_tpu/mg/hierarchy.py:659,
// _coarsest_solve_traced): its GCR is a lax.while_loop with an early exit
// (ddalphaamg_tpu/solvers/device_gmres.py:138-148) inside a lax.scan over
// restarts (:155), so no iteration goes back to the host.  Here the restarts
// are a WHILE node and each iteration j of a restart is the body of an IF
// node whose predicate ("some lane still goes") the previous body computes
// on the device; the IF of iteration j + 1 sits inside the body of j, so one
// false predicate skips the rest of the restart.
//
// What bounds a call: the bytes of its K4 applies (the blocks, read once an
// apply) and of its Gram-Schmidt (the basis rows, read twice an iteration);
// driven from the host, the launch rate bounded it instead (~22 launches of
// 10-43 us host time an iteration, far above their device time).  One
// replay issues them all with no host in between; a false predicate skips
// the nested rest of the restart at the cost of one IF node.
//
// Why not torch.cuda.CUDAGraph.begin_capture_to_if_node: torch 2.11 has
// none, and where it exists it captures every conditional body on a stream
// of its own, and the caching allocator keeps its blocks, as cuBLAS its
// workspace, per stream, so a graph with hundreds
// of bodies would hold hundreds of copies of the temporaries.  Here every
// body is captured on the capture stream itself: opening a node ends the
// stream's capture into the enclosing graph, adds the conditional node to
// that graph after what was captured, and resumes the stream's capture into
// the node's body graph (cudaStreamBeginCaptureToGraph); closing it resumes
// the enclosing graph after the node.  Temporaries freed in one body are
// then reused by the next, in stream order.
//
// A predicate is set by a one-thread kernel from a bool on the device
// (cudaGraphSetConditional); a loop's count lives in an int on the device
// that the captured program zeroes before the WHILE node.  Every function
// returns the CUDA error code (0: success).

#include <cuda_runtime.h>

#include <vector>

namespace {

constexpr cudaStreamCaptureMode MODE = cudaStreamCaptureModeThreadLocal;

struct Open {
  cudaGraph_t graph;      // the enclosing graph
  cudaGraphNode_t node;   // the conditional node whose body is captured
  cudaGraphConditionalHandle handle;
  bool loop;
};

struct Build {
  cudaGraph_t root = nullptr;
  cudaGraph_t current = nullptr;  // the graph the stream captures into
  cudaGraphExec_t exec = nullptr;
  std::vector<Open> open;
};

__global__ void set_if_kernel(cudaGraphConditionalHandle h, const unsigned char* pred) {
  cudaGraphSetConditional(h, *pred ? 1u : 0u);
}

__global__ void loop_again_kernel(cudaGraphConditionalHandle h, int* count, int n) {
  *count += 1;
  cudaGraphSetConditional(h, *count < n ? 1u : 0u);
}

#define TRY(call)                                \
  do {                                           \
    cudaError_t err_ = (call);                   \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

// ends the stream's capture into b->current, adds a conditional node of the
// handle after everything captured so far, and captures into its body
int open_node(Build* b, cudaStream_t s, cudaGraphConditionalHandle h,
              cudaGraphConditionalNodeType type, bool loop) {
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  TRY(cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr, &deps, &ndeps));
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureInvalidated;
  std::vector<cudaGraphNode_t> after(deps, deps + ndeps);
  cudaGraph_t ended;
  TRY(cudaStreamEndCapture(s, &ended));
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  TRY(cudaGraphAddNode(&node, b->current, after.data(), after.size(), &p));
  b->open.push_back({b->current, node, h, loop});
  b->current = p.conditional.phGraph_out[0];
  return (int)cudaStreamBeginCaptureToGraph(s, b->current, nullptr, nullptr, 0, MODE);
}

}  // namespace

extern "C" {

// starts capturing the stream into a new graph; *out receives its handle
int ddaamg_graph_begin(void** out, void* stream) {
  Build* b = new Build();
  cudaError_t e = cudaGraphCreate(&b->root, 0);
  if (e == cudaSuccess) {
    b->current = b->root;
    e = cudaStreamBeginCaptureToGraph((cudaStream_t)stream, b->root, nullptr, nullptr, 0, MODE);
  }
  if (e != cudaSuccess) {
    if (b->root) cudaGraphDestroy(b->root);
    delete b;
    return (int)e;
  }
  *out = b;
  return 0;
}

// opens an IF node: its body runs where the bool *pred is true when the
// graph reaches the node
int ddaamg_graph_if(void* graph, const void* pred, void* stream) {
  auto* b = (Build*)graph;
  auto s = (cudaStream_t)stream;
  cudaGraphConditionalHandle h;
  TRY(cudaGraphConditionalHandleCreate(&h, b->current, 0, cudaGraphCondAssignDefault));
  set_if_kernel<<<1, 1, 0, s>>>(h, (const unsigned char*)pred);
  TRY(cudaGetLastError());
  return open_node(b, s, h, cudaGraphCondTypeIf, false);
}

// opens a WHILE node whose body runs at least once (ddaamg_graph_close
// sets how often)
int ddaamg_graph_while(void* graph, void* stream) {
  auto* b = (Build*)graph;
  cudaGraphConditionalHandle h;
  TRY(cudaGraphConditionalHandleCreate(&h, b->current, 1, cudaGraphCondAssignDefault));
  return open_node(b, (cudaStream_t)stream, h, cudaGraphCondTypeWhile, true);
}

// closes the innermost open node; a WHILE node's body ends by counting its
// passes in *count (zeroed by the program before the node) and runs again
// while the count is below n
int ddaamg_graph_close(void* graph, void* stream, void* count, int n) {
  auto* b = (Build*)graph;
  auto s = (cudaStream_t)stream;
  if (b->open.empty()) return (int)cudaErrorInvalidValue;
  const Open o = b->open.back();
  if (o.loop) {
    loop_again_kernel<<<1, 1, 0, s>>>(o.handle, (int*)count, n);
    TRY(cudaGetLastError());
  }
  cudaGraph_t ended;
  TRY(cudaStreamEndCapture(s, &ended));
  b->open.pop_back();
  b->current = o.graph;
  return (int)cudaStreamBeginCaptureToGraph(s, o.graph, &o.node, nullptr, 1, MODE);
}

// ends the capture and instantiates the graph
int ddaamg_graph_end(void* graph, void* stream) {
  auto* b = (Build*)graph;
  if (!b->open.empty()) return (int)cudaErrorInvalidValue;
  cudaGraph_t ended;
  TRY(cudaStreamEndCapture((cudaStream_t)stream, &ended));
  return (int)cudaGraphInstantiate(&b->exec, b->root, 0);
}

int ddaamg_graph_launch(void* graph, void* stream) {
  auto* b = (Build*)graph;
  if (!b->exec) return (int)cudaErrorInvalidValue;
  return (int)cudaGraphLaunch(b->exec, (cudaStream_t)stream);
}

// frees the graph; ends a capture still under way on the stream (a failed
// build), whose error is then dropped
int ddaamg_graph_destroy(void* graph, void* stream) {
  auto* b = (Build*)graph;
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  if (stream && cudaStreamIsCapturing((cudaStream_t)stream, &status) == cudaSuccess &&
      status != cudaStreamCaptureStatusNone) {
    cudaGraph_t ended;
    cudaStreamEndCapture((cudaStream_t)stream, &ended);
    cudaGetLastError();
  }
  cudaError_t e = cudaSuccess;
  if (b->exec) e = cudaGraphExecDestroy(b->exec);
  if (b->root) {
    cudaError_t e2 = cudaGraphDestroy(b->root);
    if (e == cudaSuccess) e = e2;
  }
  delete b;
  return (int)e;
}

}  // extern "C"
