// The cycle kernel on a thread-block cluster (included by cca_cycle.cu).
//
// The H x W cell grid is cut into n_ctas row bands of H / n_ctas rows, one
// band a CTA of one cluster, one thread a cell.  At launch start each CTA
// copies its band of every per-cell leaf (a contiguous range of each [H, W,
// ...] leaf) from device memory into shared memory, runs the K cycles there
// and writes the band back in place at the end; the slot-indexed leaves,
// the vicinity table and the IO streams stay in device memory, touched only
// by their own cell's actions, and so does the park ring (pk, pk_head; its
// count pk_n is in the band): only its own cell's thread touches it, and
// only after a lane was full, while it would take 644 of a cell's 4,424
// bytes at chan_cap 32 and lanes 2.
//
// Why this shape.  The one-block kernel runs every cell on one SM with its
// per-cell leaves in device memory: each of the ~10 phases of a cycle walks
// dependent loads of 250-600 clocks through one SM's load path.  Here the
// per-cell leaves answer from shared memory (~30 clocks) and the cells are
// spread over up to 16 SMs.  Only the hop stage reads another cell's
// leaves (hop_read the receiver's aq_n / ch_n, hop_write the sender's grant
// and outbox), and W and E neighbours share a row, so only the N and S
// rounds and the quiescence test cross bands.  They meet at cluster
// barriers (barrier.cluster arrive.release / wait.acquire), and read the
// neighbour band through distributed shared memory; everything else meets
// at CTA barriers.  A cycle: the quiescence test (a CTA OR, each CTA's flag
// written to every CTA, a cluster barrier), N read | N write | S read
// (cluster barriers), S write, W read, W write, E read (CTA barriers), E
// write, exec.  outbox and grant hold one buffer per direction, so a round
// never overwrites what a neighbour band may still read.
//
// Every CTA takes the same exit decision, from the same cluster-wide OR and
// the same cycle count, or the cluster would hang at its next barrier.  A
// traced launch's trace rows get every CTA's band sums, a warp's at a time
// (`run_cycles`).
// Each CTA's counter sums go to CTA 0 through distributed shared memory
// after the loop; CTA 0 adds them to the state's counters and writes the
// launch record, as the one-block kernel does.

namespace {

enum {
  ERR_GEOMETRY = -1,    // n_ctas is not 1..16, does not divide H, or the
                        // band lacks the IO cells or outgrows the SM
  ERR_SMEM = -2,        // the wrapper's byte count differs from the layout
  ERR_NO_CLUSTER = -3,  // the card fits no cluster of this geometry
};
constexpr int CLUSTER_THREADS = 512;   // a CTA's threads at most
constexpr int SMEM_LIMIT = 232448;     // opt-in shared memory a CTA, sm_90

// A CTA's shared memory: int word offsets of each per-cell leaf (its band's
// rows, in the leaf's own layout), the scratch, the IO cursors and the
// cluster's flag and counter words; then cvalid's bytes.
struct ClusterLayout {
  int nb;   // cells a band
  int aq, aq_n, aq_head, ch, ch_n, ch_head, ch_rr, pk_n, cmsg, cphase, cT,
      cemit, cout, cdrain, arot, nfree;
  int qwork, outbox, grant, io_n, io_pos, qflag, cnt;
  int cvalid;   // byte offset
  int bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(const Dims& D) {
  ClusterLayout L;
  const int nb = D.H / D.n_ctas * D.W;
  int o = 0;
  L.nb = nb;
  L.aq = o; o += nb * D.Q * MSGW;
  L.aq_n = o; o += nb;
  L.aq_head = o; o += nb;
  L.ch = o; o += nb * 4 * D.L * D.LC * MSGW;
  L.ch_n = o; o += nb * 4 * D.L;
  L.ch_head = o; o += nb * 4 * D.L;
  L.ch_rr = o; o += nb * 4;
  L.pk_n = o; o += nb;
  L.cmsg = o; o += nb * MSGW;
  L.cphase = o; o += nb;
  L.cT = o; o += nb;
  L.cemit = o; o += nb;
  L.cout = o; o += nb * MSGW;
  L.cdrain = o; o += nb;
  L.arot = o; o += nb;
  L.nfree = o; o += nb;
  L.qwork = o; o += nb;
  L.outbox = o; o += 4 * nb * MSGW;
  L.grant = o; o += 4 * nb;
  L.io_n = o; o += D.IO;
  L.io_pos = o; o += D.IO;
  L.qflag = o; o += MAX_CTAS;
  L.cnt = o; o += MAX_CTAS * 4;
  L.cvalid = 4 * o;
  L.bytes = 4 * o + nb;
  return L;
}

inline bool cluster_geometry_ok(const Dims& D) {
  if (D.n_ctas < 1 || D.n_ctas > MAX_CTAS || D.H % D.n_ctas) return false;
  ClusterLayout L = cluster_layout(D);
  return D.IO <= L.nb && L.bytes <= SMEM_LIMIT;
}

inline const char* cluster_error_string(int err) {
  switch (err) {
    case ERR_GEOMETRY:
      return "cluster geometry refused: n_ctas must be 1..16 and divide "
             "the height, the first band must hold the IO cells, and a "
             "band must fit 232448 bytes of shared memory";
    case ERR_SMEM:
      return "the wrapper's shared-memory byte count differs from the "
             "cluster kernel's layout";
    case ERR_NO_CLUSTER:
      return "cudaOccupancyMaxActiveClusters: the card fits no cluster of "
             "this geometry";
  }
  return "unknown cca_cycle error";
}

// Copy n words between device memory and shared memory, either way, with
// all the CTA's threads; 16 bytes a thread where both sides allow it.
__device__ void move_words(int* smem, int* gmem, int n, bool in) {
  if (((reinterpret_cast<uintptr_t>(smem) |
        reinterpret_cast<uintptr_t>(gmem)) & 15) == 0 && n % 4 == 0) {
    int4* s = reinterpret_cast<int4*>(smem);
    int4* g = reinterpret_cast<int4*>(gmem);
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      if (in) s[i] = g[i]; else g[i] = s[i];
    }
    return;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (in) smem[i] = gmem[i]; else gmem[i] = smem[i];
  }
}

// This CTA's band of every per-cell leaf, into shared memory (in) or back
// to device memory.  io_n / io_pos (the IO cells, all in band 0) too.
template <class C>
__device__ void move_band(const Dims& D, const Leaves& P, const C& X,
                          bool in) {
  const size_t c0 = X.c0;
  const int nb = X.nb;
  move_words(X.aq, P.aq + c0 * D.Q * MSGW, nb * D.Q * MSGW, in);
  move_words(X.aq_n, P.aq_n + c0, nb, in);
  move_words(X.aq_head, P.aq_head + c0, nb, in);
  const size_t nch = 4 * D.L;   // rings a cell
  move_words(X.ch, P.ch + c0 * nch * D.LC * MSGW, nb * nch * D.LC * MSGW,
             in);
  move_words(X.ch_n, P.ch_n + c0 * nch, nb * nch, in);
  move_words(X.ch_head, P.ch_head + c0 * nch, nb * nch, in);
  move_words(X.ch_rr, P.ch_rr + c0 * 4, nb * 4, in);
  move_words(X.pk_n, P.pk_n + c0, nb, in);
  move_words(X.cmsg, P.cmsg + c0 * MSGW, nb * MSGW, in);
  move_words(X.cphase, P.cphase + c0, nb, in);
  move_words(X.cT, P.cT + c0, nb, in);
  move_words(reinterpret_cast<int*>(X.cemit),
             reinterpret_cast<int*>(P.cemit) + c0, nb, in);
  move_words(X.cout, P.cout + c0 * MSGW, nb * MSGW, in);
  move_words(X.cdrain, P.cdrain + c0, nb, in);
  move_words(X.arot, P.arot + c0, nb, in);
  move_words(X.nfree, P.nfree + c0, nb, in);
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    if (in) X.cvalid[i] = P.cvalid[c0 + i];
    else P.cvalid[c0 + i] = X.cvalid[i];
  }
  if (X.rank == 0) {
    if (in) move_words(X.io_n, P.io_n, D.IO, true);
    move_words(X.io_pos, P.io_pos, D.IO, in);
  }
}

template <bool kTm, bool kFlt>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
cca_cycle_cluster_kernel(const Dims D, const Leaves P) {
  PhaseClock clk;
  clk.start();
  extern __shared__ __align__(16) int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterLayout L = cluster_layout(D);
  const int rank = cluster.block_rank(), tid = threadIdx.x;
  Cells<true, kTm, kFlt> X;
  X.aq = smem + L.aq; X.aq_n = smem + L.aq_n; X.aq_head = smem + L.aq_head;
  X.ch = smem + L.ch; X.ch_n = smem + L.ch_n; X.ch_head = smem + L.ch_head;
  X.ch_rr = smem + L.ch_rr; X.pk_n = smem + L.pk_n; X.cmsg = smem + L.cmsg;
  X.cvalid = reinterpret_cast<bool*>(smem) + L.cvalid;
  X.cphase = smem + L.cphase; X.cT = smem + L.cT;
  X.cemit = reinterpret_cast<float*>(smem + L.cemit);
  X.cout = smem + L.cout; X.cdrain = smem + L.cdrain; X.arot = smem + L.arot;
  X.nfree = smem + L.nfree; X.io_n = smem + L.io_n; X.io_pos = smem + L.io_pos;
  X.qwork = smem + L.qwork; X.outbox = smem + L.outbox;
  X.grant = smem + L.grant;
  X.tm_cell = P.tm_cell; X.tm_lane = P.tm_lane; X.tm_hiw = P.tm_hiw;
  X.c0 = rank * L.nb; X.nb = L.nb; X.box_dir = L.nb * MSGW;
  X.grant_dir = L.nb; X.rank = rank; X.n_ctas = D.n_ctas;
  X.qflag = smem + L.qflag;

  move_band(D, P, X, true);
  for (int c = X.c0 + tid; c < X.c0 + X.nb; c += blockDim.x)
    init_qwork(D, P, X, c);
  // the trace rows start at 0, before any CTA adds its band's sums
  if (P.trace && rank == 0)
    for (int i = tid; i < 2 * D.n_cycles; i += blockDim.x) P.trace[i] = 0;
  cluster.sync();   // every CTA running and loaded before any DSMEM access
  clk.stamp(10);

  Counts n = {0, 0, 0, 0, 0, 0, 0, 0};
  int quiet;
  int ran = run_cycles(D, P, X, n, quiet, clk);

  move_band(D, P, X, false);
  int* sum = smem + L.cnt + 4 * rank;   // this CTA's row, here and in CTA 0
  add_flt<kFlt>(P, sum, n);   // the row in CTA 0 is read only after this
  if (tid < 4) sum[tid] = 0;
  __syncthreads();
  atomicAdd(&sum[0], n.hops);
  atomicAdd(&sum[1], n.exec);
  atomicAdd(&sum[2], n.stall);
  atomicAdd(&sum[3], n.allocs);
  __syncthreads();
  if (tid < 4) *cluster.map_shared_rank(sum + tid, 0) = sum[tid];
  cluster.sync();
  if (rank == 0 && tid == 0) {
    int tot[4] = {0, 0, 0, 0};
    for (int r = 0; r < D.n_ctas; ++r)
      for (int k = 0; k < 4; ++k) tot[k] += smem[L.cnt + 4 * r + k];
    *P.cycle += ran;
    *P.stat_hops += tot[0];
    *P.stat_exec += tot[1];
    *P.stat_stall += tot[2];
    *P.stat_allocs += tot[3];
    P.rec[0] = *P.cycle;
    P.rec[1] = *P.stat_hops;
    P.rec[2] = *P.stat_exec;
    P.rec[3] = *P.stat_stall;
    P.rec[4] = *P.stat_allocs;
    P.rec[5] = quiet;
    P.rec[6] = ran;
    P.rec[7] = 0;
  }
  clk.stamp(11);
  clk.flush(rank);
}

// Launch the cluster kernel for D's geometry on `stream` (its telemetry
// instance where D.telemetry, its fault instance where D.faults): n_ctas
// CTAs of one cluster, up to
// CLUSTER_THREADS threads each, D.smem_bytes of dynamic shared memory each.
// The first launch of a geometry and instance on a device checks that the
// card can place such a cluster at all.  Returns 0, a CUDA error code or
// an ERR_* code; never launches anything else.
int cluster_launch(const Dims& D, const Leaves& P, cudaStream_t stream) {
  if (!cluster_geometry_ok(D)) return ERR_GEOMETRY;
  const ClusterLayout L = cluster_layout(D);
  if (L.bytes != D.smem_bytes) return ERR_SMEM;
  int threads = (L.nb + 31) / 32 * 32;
  if (threads > CLUSTER_THREADS) threads = CLUSTER_THREADS;
  void (*kernel)(const Dims, const Leaves) =
      D.telemetry ? (D.faults ? cca_cycle_cluster_kernel<true, true>
                              : cca_cycle_cluster_kernel<true, false>)
                  : (D.faults ? cca_cycle_cluster_kernel<false, true>
                              : cca_cycle_cluster_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e) return e;
  if (D.n_ctas > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = D.n_ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D.n_ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // device, n_ctas, threads, bytes, instance (2 x telemetry + faults)
  const int instance = 2 * D.telemetry + D.faults;
  static int checked[5] = {-1, 0, 0, 0, 0};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e) return e;
  if (checked[0] != dev || checked[1] != D.n_ctas || checked[2] != threads ||
      checked[3] != L.bytes || checked[4] != instance) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e) return e;
    if (clusters < 1) return ERR_NO_CLUSTER;
    checked[0] = dev; checked[1] = D.n_ctas; checked[2] = threads;
    checked[3] = L.bytes; checked[4] = instance;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, D, P);
  if (e) return e;
  return cudaGetLastError();
}

}  // namespace
