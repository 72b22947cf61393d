// CUDA graphs with device-side loops, captured on one stream: the device
// programs of the GCR solves (solvers/cuda_graph.py; the coarsest solve,
// mg/coarsest.py, the inner restart and the cycle, mg/programs.py).
//
// It replaces no Pallas kernel.  The JAX package traces a whole inner
// restart into one XLA program (ddalphaamg_tpu/mg/hierarchy.py:806-836):
// each GCR in it, the fine one, the K-cycle's and the coarsest, is a
// lax.while_loop with one body and a traced iteration index j
// (ddalphaamg_tpu/solvers/device_gmres.py:138-148), restarts a lax.scan, so
// no iteration goes back to the host.  Here every such loop is one WHILE
// node with one body: a one-thread kernel before the node sets j = 0 and
// the node's condition, a one-thread kernel at the end of the body adds one
// to j and to the loop's trip counter and sets the condition again, from
// j < m and a device predicate (any byte of a bool array true: "some lane
// still goes"; none for a loop of fixed length).  Loops nest (fine GCR ->
// K-cycle restarts -> K-cycle iterations -> coarsest restarts -> coarsest
// iterations), each body captured once, whatever its number of passes.
//
// What bounds a replay: the device work of its kernels.  Driven from the
// host, the launch rate bounded it instead (~22 launches of 10-43 us host
// time a GCR iteration, far above their device time); a replay issues them
// with no host in between, at the cost of two one-thread kernels and a
// conditional node a pass.
//
// Why not torch.cuda.CUDAGraph.begin_capture_to_if_node: torch 2.11 has
// none, and where it exists it captures every conditional body on a stream
// of its own, and the caching allocator keeps its blocks, as cuBLAS its
// workspace, per stream.  Here every body is captured on the capture
// stream itself: opening a loop ends the stream's capture into the
// enclosing graph, adds the WHILE node to that graph after what was
// captured, and resumes the stream's capture into the node's body graph
// (cudaStreamBeginCaptureToGraph); closing it resumes the enclosing graph
// after the node.  Temporaries freed in one body are then reused by the
// next, in stream order.  Every function returns the CUDA error code
// (0: success).

#include <cuda_runtime.h>

#include <vector>

namespace {

constexpr cudaStreamCaptureMode MODE = cudaStreamCaptureModeThreadLocal;

struct Open {
  cudaGraph_t graph;      // the enclosing graph
  cudaGraphNode_t node;   // the WHILE node whose body is captured
  cudaGraphConditionalHandle handle;
};

struct Build {
  cudaGraph_t root = nullptr;
  cudaGraph_t current = nullptr;  // the graph the stream captures into
  cudaGraphExec_t exec = nullptr;
  std::vector<Open> open;
};

// some byte of go[0, n) is nonzero; no array: true
__device__ __forceinline__ bool any_true(const unsigned char* go, int n) {
  if (go == nullptr) return true;
  for (int i = 0; i < n; ++i)
    if (go[i]) return true;
  return false;
}

__global__ void loop_start_kernel(cudaGraphConditionalHandle h, long long* j,
                                  const unsigned char* go, int ngo, int m) {
  *j = 0;
  cudaGraphSetConditional(h, (m > 0 && any_true(go, ngo)) ? 1u : 0u);
}

__global__ void loop_next_kernel(cudaGraphConditionalHandle h, long long* j, long long* trips,
                                 const unsigned char* go, int ngo, int m) {
  const long long next = *j + 1;
  *j = next;
  *trips += 1;
  cudaGraphSetConditional(h, (next < m && any_true(go, ngo)) ? 1u : 0u);
}

#define TRY(call)                                \
  do {                                           \
    cudaError_t err_ = (call);                   \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

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

// opens a loop: sets *j = 0 and runs the body captured next while
// *j < m and some byte of go[0, ngo) is true (go null: while *j < m);
// ddaamg_graph_loop_end closes it
int ddaamg_graph_loop(void* graph, void* j, const void* go, int ngo, int m, void* stream) {
  auto* b = (Build*)graph;
  auto s = (cudaStream_t)stream;
  cudaGraphConditionalHandle h;
  TRY(cudaGraphConditionalHandleCreate(&h, b->current, 0, cudaGraphCondAssignDefault));
  loop_start_kernel<<<1, 1, 0, s>>>(h, (long long*)j, (const unsigned char*)go, ngo, m);
  TRY(cudaGetLastError());
  // end the capture into the enclosing graph, add the WHILE node after
  // what was captured, and capture into its body
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
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  TRY(cudaGraphAddNode(&node, b->current, after.data(), after.size(), &p));
  b->open.push_back({b->current, node, h});
  b->current = p.conditional.phGraph_out[0];
  return (int)cudaStreamBeginCaptureToGraph(s, b->current, nullptr, nullptr, 0, MODE);
}

// closes the innermost loop: its body ends by adding one to *j and to
// *trips and goes on while *j < m and some byte of go[0, ngo) is true
int ddaamg_graph_loop_end(void* graph, void* j, void* trips, const void* go, int ngo, int m,
                          void* stream) {
  auto* b = (Build*)graph;
  auto s = (cudaStream_t)stream;
  if (b->open.empty()) return (int)cudaErrorInvalidValue;
  const Open o = b->open.back();
  loop_next_kernel<<<1, 1, 0, s>>>(o.handle, (long long*)j, (long long*)trips,
                                   (const unsigned char*)go, ngo, m);
  TRY(cudaGetLastError());
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
