// The SkyServe scenario engine's request-level data plane for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces the XLA program of src/repro/serving/jaxengine/kernel.py
// (_build_kernel's `lane`, one lax.scan over the sub-step grid, vmapped
// across the cells of a scenario matrix): for every lane (one cell: a
// request tape, a control-plane schedule and its serving knobs) it replays
// the request-model serving loop over G sub-steps and writes each request's
// status, end-to-end latency and, with trace_on, its span timeline.  Each
// step runs the reference's stages in order: kill events due at this grid
// index (in-flight work re-pends in start order, then the slot's queue in
// FIFO order), arrivals, dispatch (least-loaded: the lexicographic
// (load, rtt, slot) minimum over ready slots; or round-robin) with the
// immediate-start test, completions compacted in start order, RTT-inclusive
// queue expiry, and the queues' drain into freed capacity.
//
// Translation.  vmap needed fixed shapes, so the reference runs masked
// fixed-length scans sized by AMAX / ATYP with while-loop remainders, and
// select-copies its whole carry per lane on every while iteration.  Here a
// lane is one thread block of one warp that simply loops while work
// remains, so none of that exists.  The warp's 32 threads run the control
// flow in lockstep with every scalar (ring head and count, arrival pointer,
// sequence counter, round-robin cursor, kill pointer) held identically in
// each thread's registers; the per-step searches are warp reductions with
// shuffles: the least-loaded argmin over R slots, the FIFO head (smallest
// sequence number) of a slot's Q queue cells, the first free cell (a
// ballot), the queue's minimum effective age, the arrivals up to t (a
// ballot over the sorted tape).  Thread 0 writes the shared state a pop or
// a push changes, and __syncwarp orders it before the next read.  Each
// thread owns slots tid, tid + 32, ... for the completion stage, which
// compacts a slot's running row in place.
//
// State.  A lane's small state lives in shared memory: the running table
// run_fin / run_idx [R, C], the queue pools q_idx / q_age / q_seq / q_valid
// [R, Q], run_n, q_cnt, qmin [R] and, with trace_on, run_disp / run_start
// [R, C] and q_disp [R, Q] (about 65 KB at R = 10, C = 4, Q = 256; above
// 48 KB it is dynamic shared memory, allowed with cudaFuncSetAttribute).
// The pending ring [N] and the O(N) outputs live in device memory.
//
// Numbers.  Every float is float64 and is rounded one operation at a time
// as the NumPy oracle rounds it (t + svc * (1.0 + 0.15 * n), (fin - arr) +
// rtt, t - arr > timeout, arr - rtt): the expressions use __dmul_rn /
// __dadd_rn / __dsub_rn, which nvcc never contracts into an FMA, so a last
// bit cannot flip a deadline test.
//
// What bounds it.  The work is a sequential recurrence of G steps a lane,
// each a chain of dependent shared-memory reads and warp shuffles; a lane
// reads its tape and writes its outputs once, a few tens of MB for a whole
// matrix, so the bytes over the HBM rate (the bound stated beside its time)
// are a loose bound: the latency of one step times G is what it costs.
// Lanes run in parallel, one block each (96 lanes fill 96 of 132 SMs).
//
// Overflow keeps the reference's two causes: a sub-step with more than
// amax arrivals, or a queue pool with no free cell.  The lane then stops,
// writes its counters and raises its overflow flag; the caller discards it.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;

struct Args {
  const double* arr;           // [L, N]
  const double* svc;           // [L, N]
  const int* rcode;            // [L, N]
  const double* rtt;           // [L, R, NREG]
  const unsigned char* ready;  // [L, W, R]
  const int* kill_slot;        // [L, E]
  const int* kill_g;           // [L, E]
  const double* timeout;       // [L]
  const double* ts;            // [G]
  const int* gs;               // [G]
  const int* wins;             // [G]
  int* pend;                   // [L, N] scratch: the pending rings
  signed char* status;         // [L, N]
  double* e2e;                 // [L, N]
  long long* a_ptr;            // [L]
  long long* run_n;            // [L, R]
  long long* q_cnt;            // [L, R]
  long long* n_retried;        // [L]
  unsigned char* overflow;     // [L]
  double* disp_t;              // [L, N] (trace_on)
  double* start_t;             // [L, N]
  double* fin_t;               // [L, N]
  long long* rep;              // [L, N]
  int L, N, R, NREG, W, E, G, Q, C, amax;
  bool lb_rr, expire_on;
};

__host__ __device__ inline long long smem_bytes(long long R, long long C,
                                                long long Q, bool trace) {
  const long long doubles = R * C + R * Q + R + (trace ? 2 * R * C + R * Q : 0);
  const long long ints = R * C + 2 * R * Q + 2 * R;
  return 8 * doubles + 4 * ints + R * Q + 2 * R;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1)
    v = fmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Lexicographic minimum of (key, idx) over the warp.
__device__ __forceinline__ void warp_argmin(int& key, int& idx) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) {
    const int k = __shfl_xor_sync(FULL, key, o);
    const int i = __shfl_xor_sync(FULL, idx, o);
    if (k < key || (k == key && i < idx)) { key = k; idx = i; }
  }
}

// A lane's shared-memory state and its scalars (identical in every thread).
template <bool TRACE>
struct Lane {
  double *run_fin, *q_age, *qmin, *run_disp, *run_start, *q_disp;
  int *run_idx, *q_idx, *q_seq, *run_n, *q_cnt;
  unsigned char *q_valid, *rdy, *due;
  const double *arr, *svc, *rtt;
  const int* rcode;
  int* pend;
  int R, C, Q, N, NREG, tid;
  long long p_head, p_cnt, rr_cur, n_retried;
  int a_ptr, seq_ctr;

  __device__ void push(int v) {      // uniform: every thread calls it
    if (tid == 0) pend[(p_head + p_cnt) % N] = v;
    ++p_cnt;
  }

  // The valid queue cell of `slot` with the smallest sequence number.
  __device__ int fifo_head(int slot) const {
    int key = INT_MAX, idx = INT_MAX;
    for (int j = tid; j < Q; j += WARP) {
      const int c = slot * Q + j;
      if (q_valid[c] && q_seq[c] < key) { key = q_seq[c]; idx = j; }
    }
    warp_argmin(key, idx);
    return idx;
  }

  // The first queue cell of `slot` that is free, or -1.
  __device__ int first_free(int slot) const {
    for (int base = 0; base < Q; base += WARP) {
      const int j = base + tid;
      const unsigned b = __ballot_sync(FULL, j < Q && !q_valid[slot * Q + j]);
      if (b) return base + __ffs(b) - 1;
    }
    return -1;
  }

  // Minimum effective age over the valid cells of `slot` (inf if none).
  __device__ double min_age(int slot) const {
    double m = __longlong_as_double(0x7ff0000000000000LL);
    for (int j = tid; j < Q; j += WARP)
      if (q_valid[slot * Q + j]) m = fmin(m, q_age[slot * Q + j]);
    return warp_min(m);
  }

  // Start request i on `slot` at t: finish t + svc * (1.0 + 0.15 * n).
  __device__ void start(int slot, int i, double t, double disp) {
    const int rn = run_n[slot];
    const double fin = __dadd_rn(
        t, __dmul_rn(svc[i], __dadd_rn(1.0, __dmul_rn(0.15, (double)rn))));
    __syncwarp();                    // every thread has read run_n[slot]
    if (tid == 0) {
      run_fin[slot * C + rn] = fin;
      run_idx[slot * C + rn] = i;
      if (TRACE) {
        run_disp[slot * C + rn] = disp;
        run_start[slot * C + rn] = t;
      }
      run_n[slot] = rn + 1;
    }
  }

  // Remove queue cell j of `slot` and refresh its cached minimum age.
  __device__ void q_pop(int slot, int j) {
    if (tid == 0) {
      q_valid[slot * Q + j] = 0;
      q_cnt[slot] -= 1;
    }
    __syncwarp();
    const double m = min_age(slot);
    if (tid == 0) qmin[slot] = m;
    __syncwarp();
  }
};

template <bool TRACE>
__global__ void __launch_bounds__(WARP) scenario_scan_kernel(Args a) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int R = a.R, C = a.C, Q = a.Q, N = a.N, NREG = a.NREG;
  const double INF = __longlong_as_double(0x7ff0000000000000LL);

  extern __shared__ __align__(16) unsigned char smem[];
  Lane<TRACE> s;
  s.run_fin = reinterpret_cast<double*>(smem);
  s.q_age = s.run_fin + R * C;
  s.qmin = s.q_age + R * Q;
  s.run_disp = s.qmin + R;
  s.run_start = s.run_disp + (TRACE ? R * C : 0);
  s.q_disp = s.run_start + (TRACE ? R * C : 0);
  s.run_idx = reinterpret_cast<int*>(s.q_disp + (TRACE ? R * Q : 0));
  s.q_idx = s.run_idx + R * C;
  s.q_seq = s.q_idx + R * Q;
  s.run_n = s.q_seq + R * Q;
  s.q_cnt = s.run_n + R;
  s.q_valid = reinterpret_cast<unsigned char*>(s.q_cnt + R);
  s.rdy = s.q_valid + R * Q;
  s.due = s.rdy + R;

  const long long lN = (long long)lane * N;
  s.arr = a.arr + lN;
  s.svc = a.svc + lN;
  s.rcode = a.rcode + lN;
  s.rtt = a.rtt + (long long)lane * R * NREG;
  s.pend = a.pend + lN;
  s.R = R; s.C = C; s.Q = Q; s.N = N; s.NREG = NREG; s.tid = tid;
  s.p_head = 0; s.p_cnt = 0; s.rr_cur = 0; s.n_retried = 0;
  s.a_ptr = 0; s.seq_ctr = 0;
  const unsigned char* ready = a.ready + (long long)lane * a.W * R;
  const int* kill_slot = a.kill_slot + (long long)lane * a.E;
  const int* kill_g = a.kill_g + (long long)lane * a.E;
  const double timeout = a.timeout[lane];
  signed char* status = a.status + lN;
  double* e2e = a.e2e + lN;

  for (int e = tid; e < R * C; e += WARP) {
    s.run_fin[e] = INF;
    s.run_idx[e] = 0;
  }
  for (int e = tid; e < R * Q; e += WARP) {
    s.q_valid[e] = 0;
    s.q_age[e] = 0.0;
    s.q_seq[e] = 0;
    s.q_idx[e] = 0;
  }
  for (int r = tid; r < R; r += WARP) {
    s.run_n[r] = 0;
    s.q_cnt[r] = 0;
    s.qmin[r] = INF;
  }
  __syncwarp();

  int kill_ptr = 0;
  bool overflow = false;
  for (int k = 0; k < a.G && !overflow; ++k) {
    const double t = a.ts[k];
    const int g = a.gs[k];
    const int win = a.wins[k];

    // -- 1) kill events due before this sub-step -------------------------
    while (kill_ptr < a.E && kill_g[kill_ptr] <= g) {
      const int slot = kill_slot[kill_ptr];
      const int rn = s.run_n[slot];
      s.n_retried += rn + s.q_cnt[slot];
      for (int c = tid; c < rn; c += WARP)          // in-flight, start order
        s.pend[(s.p_head + s.p_cnt + c) % N] = s.run_idx[slot * C + c];
      s.p_cnt += rn;
      __syncwarp();
      for (int m = s.q_cnt[slot]; m > 0; --m) {     // then the queue, FIFO
        const int j = s.fifo_head(slot);
        s.push(s.q_idx[slot * Q + j]);
        if (tid == 0) s.q_valid[slot * Q + j] = 0;
        __syncwarp();
      }
      for (int c = tid; c < C; c += WARP) s.run_fin[slot * C + c] = INF;
      if (tid == 0) {
        s.q_cnt[slot] = 0;
        s.qmin[slot] = INF;
        s.run_n[slot] = 0;
      }
      __syncwarp();
      ++kill_ptr;
    }

    // -- 2) arrivals: the sorted tape's entries <= t ----------------------
    int cnt = 0;
    for (;;) {
      const int i = s.a_ptr + cnt + tid;
      const unsigned b = __ballot_sync(FULL, i < N && s.arr[i] <= t);
      const int run = (b == FULL) ? WARP : __ffs(~b) - 1;
      cnt += run;
      if (run < WARP) break;
    }
    if (cnt > a.amax) {
      overflow = true;
      break;
    }
    for (int q = tid; q < cnt; q += WARP)
      s.pend[(s.p_head + s.p_cnt + q) % N] = s.a_ptr + q;
    s.p_cnt += cnt;
    s.a_ptr += cnt;

    // -- 3) ready roster, due flags, dispatch -----------------------------
    int nr = 0;
    for (int r = tid; r < R; r += WARP) {
      const unsigned char rd = ready[(long long)win * R + r];
      bool d = false;
      for (int c = 0; c < C; ++c) d |= s.run_fin[r * C + c] <= t;
      s.rdy[r] = rd;
      s.due[r] = d;
      nr += rd ? 1 : 0;
    }
    const int nready = warp_sum(nr);
    __syncwarp();
    while (s.p_cnt > 0 && nready > 0) {
      const int i = s.pend[s.p_head];
      s.p_head = (s.p_head + 1) % N;
      --s.p_cnt;
      const double ai = s.arr[i];
      const bool expired = __dsub_rn(t, ai) > timeout;
      const int rc = s.rcode[i];
      int slot;
      if (a.lb_rr) {
        const long long j = s.rr_cur % nready;       // the (j+1)-th ready slot
        long long seen = -1;
        slot = 0;
        for (int r = 0; r < R; ++r)
          if (s.rdy[r] && ++seen == j) { slot = r; break; }
        if (!expired) ++s.rr_cur;
      } else {
        // lexicographic (load, rtt, slot) minimum over the ready slots
        int bl = INT_MAX, br = INT_MAX;
        double bt = INF;
        for (int r = tid; r < R; r += WARP) {
          if (!s.rdy[r]) continue;
          const int ld = s.run_n[r] + s.q_cnt[r];
          const double rt = s.rtt[r * NREG + rc];
          if (ld < bl || (ld == bl && rt < bt)) { bl = ld; bt = rt; br = r; }
        }
#pragma unroll
        for (int o = WARP / 2; o > 0; o >>= 1) {
          const int l2 = __shfl_xor_sync(FULL, bl, o);
          const double t2 = __shfl_xor_sync(FULL, bt, o);
          const int r2 = __shfl_xor_sync(FULL, br, o);
          if (l2 < bl || (l2 == bl && (t2 < bt || (t2 == bt && r2 < br)))) {
            bl = l2; bt = t2; br = r2;
          }
        }
        slot = br;
      }
      if (!expired) {
        const bool imm = s.q_cnt[slot] == 0 && s.run_n[slot] < C && !s.due[slot];
        if (imm) {
          s.start(slot, i, t, t);
        } else {
          // queue with effective age arrival - rtt: the expiry sweep is
          // then RTT-inclusive
          const double age = __dsub_rn(ai, s.rtt[slot * NREG + rc]);
          const int f = s.first_free(slot);
          if (f < 0) {
            overflow = true;
            break;
          }
          __syncwarp();              // every thread has read q_cnt[slot]
          if (tid == 0) {
            const int c = slot * Q + f;
            s.q_idx[c] = i;
            s.q_age[c] = age;
            s.q_seq[c] = s.seq_ctr;
            s.q_valid[c] = 1;
            if (TRACE) s.q_disp[c] = t;
            s.q_cnt[slot] += 1;
            s.qmin[slot] = fmin(s.qmin[slot], age);
          }
          ++s.seq_ctr;
        }
      }
      // an expired request is dropped: its status stays 0 and the drain
      // counts it failed
      __syncwarp();
    }
    if (overflow) break;

    // -- 4) completions: each thread compacts its slots' running rows ------
    for (int r = tid; r < R; r += WARP) {
      const int n = s.run_n[r];
      int kept = 0;
      for (int c = 0; c < n; ++c) {
        const int e = r * C + c;
        const double fin = s.run_fin[e];
        const int idx = s.run_idx[e];
        if (fin <= t) {
          const double lat = __dadd_rn(__dsub_rn(fin, s.arr[idx]),
                                       s.rtt[r * NREG + s.rcode[idx]]);
          status[idx] = lat > timeout ? 2 : 1;
          e2e[idx] = lat;
          if (TRACE) {
            // a retried request overwrites its earlier attempt: these
            // record the final, completing one
            a.disp_t[lN + idx] = s.run_disp[e];
            a.start_t[lN + idx] = s.run_start[e];
            a.fin_t[lN + idx] = fin;
            a.rep[lN + idx] = r;
          }
        } else {
          if (kept != c) {
            const int d = r * C + kept;
            s.run_fin[d] = fin;
            s.run_idx[d] = idx;
            if (TRACE) {
              s.run_disp[d] = s.run_disp[e];
              s.run_start[d] = s.run_start[e];
            }
          }
          ++kept;
        }
      }
      for (int c = kept; c < n; ++c) s.run_fin[r * C + c] = INF;
      s.run_n[r] = kept;
    }
    __syncwarp();

    // -- 5) queue expiry (RTT-inclusive), slot by slot ---------------------
    if (a.expire_on) {
      for (int r = 0; r < R; ++r) {
        if (!(s.q_cnt[r] > 0 && __dsub_rn(t, s.qmin[r]) > timeout)) continue;
        int kept = 0;
        double m = INF;
        for (int j = tid; j < Q; j += WARP) {
          const int c = r * Q + j;
          if (!s.q_valid[c]) continue;
          if (__dsub_rn(t, s.q_age[c]) > timeout) {
            s.q_valid[c] = 0;
          } else {
            ++kept;
            m = fmin(m, s.q_age[c]);
          }
        }
        kept = warp_sum(kept);
        m = warp_min(m);
        if (tid == 0) {
          s.q_cnt[r] = kept;
          s.qmin[r] = m;
        }
        __syncwarp();
      }
    }

    // -- 6) starts: queues drain into freed capacity, slot by slot, FIFO --
    for (int r = 0; r < R; ++r) {
      while (s.rdy[r] && s.run_n[r] < C && s.q_cnt[r] > 0) {
        const int j = s.fifo_head(r);
        s.start(r, s.q_idx[r * Q + j], t, TRACE ? s.q_disp[r * Q + j] : 0.0);
        s.q_pop(r, j);
      }
    }
  }

  if (tid == 0) {
    a.a_ptr[lane] = s.a_ptr;
    a.n_retried[lane] = s.n_retried;
    a.overflow[lane] = overflow ? 1 : 0;
  }
  for (int r = tid; r < R; r += WARP) {
    a.run_n[(long long)lane * R + r] = s.run_n[r];
    a.q_cnt[(long long)lane * R + r] = s.q_cnt[r];
  }
}

template <bool TRACE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long smem = smem_bytes(a.R, a.C, a.Q, TRACE);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scenario_scan_kernel<TRACE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  scenario_scan_kernel<TRACE><<<a.L, WARP, (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ptrs: arr, svc, rcode, rtt, ready, kill_slot, kill_g, timeout, ts, gs,
// wins, pend, status, e2e, a_ptr, run_n, q_cnt, n_retried, overflow,
// disp_t, start_t, fin_t, rep (the last four null without trace_on).
// dims: L, N, R, NREG, W, E, G, Q, C, amax, lb_rr, expire_on, trace_on.
// The Python wrapper checks the shapes and the shared memory a block needs.
// Returns a cudaError_t (0 = launched).
extern "C" int scenario_scan_fwd(const void* const* ptrs,
                                 const long long* dims, void* stream) {
  Args a;
  a.arr = static_cast<const double*>(ptrs[0]);
  a.svc = static_cast<const double*>(ptrs[1]);
  a.rcode = static_cast<const int*>(ptrs[2]);
  a.rtt = static_cast<const double*>(ptrs[3]);
  a.ready = static_cast<const unsigned char*>(ptrs[4]);
  a.kill_slot = static_cast<const int*>(ptrs[5]);
  a.kill_g = static_cast<const int*>(ptrs[6]);
  a.timeout = static_cast<const double*>(ptrs[7]);
  a.ts = static_cast<const double*>(ptrs[8]);
  a.gs = static_cast<const int*>(ptrs[9]);
  a.wins = static_cast<const int*>(ptrs[10]);
  a.pend = static_cast<int*>(const_cast<void*>(ptrs[11]));
  a.status = static_cast<signed char*>(const_cast<void*>(ptrs[12]));
  a.e2e = static_cast<double*>(const_cast<void*>(ptrs[13]));
  a.a_ptr = static_cast<long long*>(const_cast<void*>(ptrs[14]));
  a.run_n = static_cast<long long*>(const_cast<void*>(ptrs[15]));
  a.q_cnt = static_cast<long long*>(const_cast<void*>(ptrs[16]));
  a.n_retried = static_cast<long long*>(const_cast<void*>(ptrs[17]));
  a.overflow = static_cast<unsigned char*>(const_cast<void*>(ptrs[18]));
  a.disp_t = static_cast<double*>(const_cast<void*>(ptrs[19]));
  a.start_t = static_cast<double*>(const_cast<void*>(ptrs[20]));
  a.fin_t = static_cast<double*>(const_cast<void*>(ptrs[21]));
  a.rep = static_cast<long long*>(const_cast<void*>(ptrs[22]));
  a.L = (int)dims[0];
  a.N = (int)dims[1];
  a.R = (int)dims[2];
  a.NREG = (int)dims[3];
  a.W = (int)dims[4];
  a.E = (int)dims[5];
  a.G = (int)dims[6];
  a.Q = (int)dims[7];
  a.C = (int)dims[8];
  a.amax = (int)dims[9];
  a.lb_rr = dims[10] != 0;
  a.expire_on = dims[11] != 0;
  const bool trace = dims[12] != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(trace ? launch<true>(a, s) : launch<false>(a, s));
}
