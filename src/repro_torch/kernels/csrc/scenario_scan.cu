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
// lane is one thread block of one warp that loops while work remains.
//
// What bounds it.  The work is a sequential recurrence of G sub-steps a
// lane; a lane reads its tape and writes its outputs once, a few tens of MB
// for a whole matrix, so the bytes over the HBM rate are a loose bound: the
// latency of one sub-step's dependent chain times G is what it costs, and
// lanes run side by side, one block each (96 lanes fill 96 of 132 SMs).
// The design shortens that chain:
//
// - Nothing on it reads device memory.  The grid (ts, gs, wins) sits in
//   registers, thread j holding sub-step kb + j of the current batch of 32
//   and the next batch loaded 32 sub-steps ahead; a sub-step's values are
//   shuffles.  The tape streams through a shared-memory window of TW
//   entries (arr, svc, rcode) in chunks of TW / 4 copied with cp.async one
//   chunk ahead of the arrivals.  The rtt table [NREG, R] and, for
//   least-loaded dispatch, each slot's rank by (rtt, slot) per region are
//   copied at block start.  The ready flags of the next control window and
//   the next kill event are loaded into registers one window / one event
//   ahead.  The pending ring keeps its first PC entries in shared memory.
// - A request carries what it needs: a running entry holds its arrival and
//   RTT beside its finish time, so a completion reads no tape; a dispatch
//   or a drain reads the tape window, or device memory for a request older
//   than the window (a retried request, or a backlog longer than the
//   window), which is off the common path.
// - Slots work in parallel.  Thread r owns slots r, r + 32, ...: only it
//   reads or writes a slot's state (running row, queue, counters), so
//   completions, expiry and the drain run for every slot at once, with no
//   barrier.  A thread keeps its first slot's counters in registers (the
//   kernel is built apart for R > 32, where the others live in shared
//   memory).  Least-loaded dispatch is one redux.sync minimum of the key
//   load * R + rank over the ready slots, and the winning slot's owner does
//   the start or the push; round-robin reads the (j+1)-th entry of the
//   window's ready list.
// - A slot's queue is a ring in push order: the head is O(1) amortized
//   (expired cells become holes that the head skips), the cached minimum
//   age is recomputed only when the cell that held it leaves, and a ring
//   whose span reaches Q with holes in it compacts in place.
//
// Numbers.  Every float is float64 and is rounded one operation at a time
// as the NumPy oracle rounds it (t + svc * (1.0 + 0.15 * n), (fin - arr) +
// rtt, t - arr > timeout, arr - rtt): the expressions use __dmul_rn /
// __dadd_rn / __dsub_rn, which nvcc never contracts into an FMA, so a last
// bit cannot flip a deadline test.
//
// Overflow keeps the reference's two causes: a sub-step with more than
// amax arrivals, or a push into a slot that holds Q queued requests.  The
// lane then stops at the end of that sub-step, writes its counters and
// raises its overflow flag; the caller discards it.  The pending ring has
// no third cause: entries past the PC that shared memory holds go to a
// device-memory ring of NP >= N entries, a power of two (a request is
// pending at most once).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int TAPE_CHUNKS = 4;          // the tape window holds 4 chunks
constexpr long long NO_SPILL = LLONG_MAX;

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
  int* pend;                   // [L, NP] scratch: the pending rings' spill
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
  int L, N, R, NREG, W, E, G, Q, C, amax, PC, TW, NP;
  bool lb_rr, expire_on;
};

// A slot's counters (running entries, queue count, the queue ring's head
// and span, the minimum queued age and finish time, ready and due flags).
struct Slot {
  int run_n, q_cnt, q_head, q_span;
  double qmin, fin_min;
  bool rdy, due;
};
static_assert(sizeof(Slot) == 40, "kernels/scenario_scan.py counts 40 bytes");

// A lane's shared memory: the slots past the first 32, then float64
// arrays, then int32 arrays.
struct Smem {
  Slot* far;
  double *q_age, *q_disp, *run_fin, *run_arr, *run_rtt, *run_disp, *run_start;
  double *rtt, *t_arr, *t_svc;
  int *q_idx, *run_idx, *rlist, *rank, *pend, *t_rc;
};

// Carves `base` into the arrays of Smem and returns the bytes they take
// (with base null it only counts).  kernels/scenario_scan.py smem_bytes
// counts the same.
__host__ __device__ inline long long carve(Smem& s, unsigned char* base,
                                           long long R, long long C,
                                           long long Q, long long NREG,
                                           long long PC, long long TW,
                                           bool trace) {
  long long off = 0;
#define SCN_TAKE(ptr, T, n)                                        \
  do {                                                             \
    s.ptr = base ? reinterpret_cast<T*>(base + off) : nullptr;     \
    off += (long long)sizeof(T) * (n);                             \
  } while (0)
  SCN_TAKE(far, Slot, R > WARP ? R - WARP : 0);
  SCN_TAKE(q_age, double, R * Q);
  SCN_TAKE(q_disp, double, trace ? R * Q : 0);
  SCN_TAKE(run_fin, double, R * C);
  SCN_TAKE(run_arr, double, R * C);
  SCN_TAKE(run_rtt, double, R * C);
  SCN_TAKE(run_disp, double, trace ? R * C : 0);
  SCN_TAKE(run_start, double, trace ? R * C : 0);
  SCN_TAKE(rtt, double, NREG * R);
  SCN_TAKE(t_arr, double, TW);
  SCN_TAKE(t_svc, double, TW);
  SCN_TAKE(q_idx, int, R * Q);
  SCN_TAKE(run_idx, int, R * C);
  SCN_TAKE(rlist, int, R);
  SCN_TAKE(rank, int, NREG * R);
  SCN_TAKE(pend, int, PC);
  SCN_TAKE(t_rc, int, TW);
#undef SCN_TAKE
  return off;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

template <bool TRACE, bool WIDE>
struct Lane : Smem {
  // this lane's inputs and outputs in device memory
  const double *arr, *svc;
  const int* rcode;
  int* pend_g;
  signed char* status;
  double *e2e, *disp_t, *start_t, *fin_t;
  long long* rep;
  int R, C, Q, N, PC, TW, CH, NP, tid;
  double timeout;
  // warp-uniform scalars
  long long p_head, p_cnt, spill;   // pending ring; positions >= spill live
                                    // in device memory
  int t_lo, t_hi, t_fly;            // tape window: [t_lo, t_hi) resident,
                                    // [t_hi, t_fly) in flight
  bool ovf;                         // this thread saw a queue overflow
  Slot mine;                        // slot tid's counters

  // -- the tape window ----------------------------------------------------

  // Copy the next chunk [t_fly, t_fly + CH) into the window, dropping the
  // oldest chunk if the window is full.  Uniform.
  __device__ void issue() {
    __syncwarp();                    // reads of a dropped chunk are done
    if (t_fly + CH - t_lo > TW) t_lo += CH;
    for (int j = tid; j < CH; j += WARP) {
      const int i = t_fly + j;
      const int c = i & (TW - 1);
      if (i < N) {
        cp_async(t_arr + c, arr + i, 8);
        cp_async(t_svc + c, svc + i, 8);
        cp_async(t_rc + c, rcode + i, 4);
      } else {                       // past the tape: never arrives
        t_arr[c] = __longlong_as_double(0x7ff0000000000000LL);
        t_svc[c] = 1.0;
        t_rc[c] = 0;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    t_fly += CH;
  }

  // Make tape entries [.., upto) resident, then keep one chunk in flight.
  // Uniform.
  __device__ void need(int upto) {
    while (t_hi < upto) {
      if (t_fly == t_hi) issue();
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      t_hi = t_fly;
      if (t_fly < N) issue();
    }
  }

  // A request's arrival, service time and region: from the window, or
  // from device memory for an entry older than it.
  __device__ void fetch(int i, double& a, double& v, int& rc) const {
    if (i >= t_lo) {
      const int c = i & (TW - 1);
      a = t_arr[c];
      v = t_svc[c];
      rc = t_rc[c];
    } else {
      a = arr[i];
      v = svc[i];
      rc = rcode[i];
    }
  }

  // -- the pending ring (uniform state, entries written by any thread) -----

  // The spill mark after pushing n entries at the tail: entries beyond the
  // PC that shared memory holds go to device memory until the ring drains.
  __device__ long long spill_after(long long n) const {
    return (spill == NO_SPILL && p_cnt + n > PC) ? p_head + PC : spill;
  }

  // Store entry v at ring position p (spill already updated).  The spill
  // ring's length is a power of two: with `p % N` nvcc laid the kernel out
  // otherwise and the matrix, which never spills, took 7 % longer.
  __device__ void put(long long p, int v) const {
    if (p < spill)
      pend[p & (PC - 1)] = v;
    else
      pend_g[p & (NP - 1)] = v;
  }

  __device__ int pop() {
    const long long p = p_head;
    const int v = p < spill ? pend[p & (PC - 1)] : pend_g[p & (NP - 1)];
    ++p_head;
    if (--p_cnt == 0) spill = NO_SPILL;
    return v;
  }

  // -- a slot's state (owner thread only) ----------------------------------

  // Runs f(r) for each slot r this thread owns: tid, tid + 32, ... (with
  // at most 32 slots, straight-line code for slot tid).
  template <class F>
  __device__ __forceinline__ void each_slot(F&& f) const {
    if (WIDE) {
      for (int r = tid; r < R; r += WARP) f(r);
    } else if (tid < R) {
      f(tid);
    }
  }

  // A slot's counters: in registers for the thread's first slot, in shared
  // memory for slots 32 and up.  The owner loads them, works on the copy
  // and stores it back.
  __device__ Slot load(int slot) const {
    return !WIDE || slot < WARP ? mine : far[slot - WARP];
  }
  __device__ void store(int slot, const Slot& v) {
    if (!WIDE || slot < WARP)
      mine = v;
    else
      far[slot - WARP] = v;
  }

  // Start request i on `slot` at t: finish t + svc * (1.0 + 0.15 * n).
  __device__ void start(int slot, Slot& v, int i, double t, double sv,
                        double a, double rt, double disp) {
    const double fin = __dadd_rn(
        t, __dmul_rn(sv, __dadd_rn(1.0, __dmul_rn(0.15, (double)v.run_n))));
    const int e = slot * C + v.run_n;
    run_fin[e] = fin;
    run_arr[e] = a;
    run_rtt[e] = rt;
    run_idx[e] = i;
    if (TRACE) {
      run_disp[e] = disp;
      run_start[e] = t;
    }
    v.run_n += 1;
    v.fin_min = fmin(v.fin_min, fin);
  }

  // Move the valid cells of `slot`'s ring to its first q_cnt positions
  // from the head, in order (the ring's span reached Q with holes in it).
  __device__ void compact(int slot, Slot& v) {
    int* qi = q_idx + slot * Q;
    double* qa = q_age + slot * Q;
    double* qd = TRACE ? q_disp + slot * Q : nullptr;
    int w = v.q_head;
#pragma unroll 1
    for (int j = 0, c = v.q_head; j < v.q_span;
         ++j, c = (c + 1 == Q ? 0 : c + 1)) {
      if (qi[c] < 0) continue;
      if (w != c) {
        qi[w] = qi[c];
        qa[w] = qa[c];
        if (TRACE) qd[w] = qd[c];
      }
      w = (w + 1 == Q ? 0 : w + 1);
    }
    v.q_span = v.q_cnt;
  }

  // Queue request i on `slot` (its effective age arr - rtt); false if the
  // slot already holds Q queued requests.
  __device__ bool push_queue(int slot, Slot& v, int i, double age, double t) {
    if (v.q_cnt == Q) return false;
    if (v.q_span == Q) compact(slot, v);
    int c = v.q_head + v.q_span;
    if (c >= Q) c -= Q;
    q_idx[slot * Q + c] = i;
    q_age[slot * Q + c] = age;
    if (TRACE) q_disp[slot * Q + c] = t;
    v.q_span += 1;
    v.q_cnt += 1;
    v.qmin = fmin(v.qmin, age);
    return true;
  }

  // Advance the head of `slot` past holes; reset an empty ring.
  __device__ void skip_holes(int slot, Slot& v) const {
    while (v.q_span > 0 && q_idx[slot * Q + v.q_head] < 0) {
      v.q_head = (v.q_head + 1 == Q ? 0 : v.q_head + 1);
      --v.q_span;
    }
    if (v.q_span == 0) v.q_head = 0;
  }

  // Minimum age over the valid cells of `slot` (inf if none).
  __device__ double min_age(int slot, const Slot& v) const {
    double m = __longlong_as_double(0x7ff0000000000000LL);
#pragma unroll 1
    for (int j = 0, c = v.q_head; j < v.q_span;
         ++j, c = (c + 1 == Q ? 0 : c + 1))
      if (q_idx[slot * Q + c] >= 0) m = fmin(m, q_age[slot * Q + c]);
    return m;
  }

  // Stage 4: resolve the running entries of `slot` that finish by t and
  // compact the rest in start order.
  __device__ void complete(int slot, Slot& v, double t) {
    if (!(v.fin_min <= t)) return;
    double m = __longlong_as_double(0x7ff0000000000000LL);
    int kept = 0;
#pragma unroll 1
    for (int c = 0; c < v.run_n; ++c) {
      const int e = slot * C + c;
      const double fin = run_fin[e];
      if (fin <= t) {
        const int idx = run_idx[e];
        const double lat = __dadd_rn(__dsub_rn(fin, run_arr[e]), run_rtt[e]);
        status[idx] = lat > timeout ? 2 : 1;
        e2e[idx] = lat;
        if (TRACE) {
          // a retried request overwrites its earlier attempt: these record
          // the final, completing one
          disp_t[idx] = run_disp[e];
          start_t[idx] = run_start[e];
          fin_t[idx] = fin;
          rep[idx] = slot;
        }
      } else {
        if (kept != c) {
          const int d = slot * C + kept;
          run_fin[d] = fin;
          run_arr[d] = run_arr[e];
          run_rtt[d] = run_rtt[e];
          run_idx[d] = run_idx[e];
          if (TRACE) {
            run_disp[d] = run_disp[e];
            run_start[d] = run_start[e];
          }
        }
        m = fmin(m, fin);
        ++kept;
      }
    }
    v.run_n = kept;
    v.fin_min = m;
  }

  // Stage 5: drop the queued requests of `slot` whose RTT-inclusive age
  // passed the timeout.
  __device__ void expire(int slot, Slot& v, double t) {
    if (!(v.q_cnt > 0 && __dsub_rn(t, v.qmin) > timeout)) return;
    double m = __longlong_as_double(0x7ff0000000000000LL);
    int kept = 0;
#pragma unroll 1
    for (int j = 0, c = v.q_head; j < v.q_span;
         ++j, c = (c + 1 == Q ? 0 : c + 1)) {
      const int e = slot * Q + c;
      if (q_idx[e] < 0) continue;
      if (__dsub_rn(t, q_age[e]) > timeout) {
        q_idx[e] = -1;
      } else {
        m = fmin(m, q_age[e]);
        ++kept;
      }
    }
    v.q_cnt = kept;
    v.qmin = m;
    skip_holes(slot, v);
  }

  // Stage 6: the queue of `slot` drains into freed capacity, FIFO.
  __device__ void drain(int slot, Slot& v, double t) {
    if (!v.rdy) return;
    while (v.run_n < C && v.q_cnt > 0) {
      const int e = slot * Q + v.q_head;         // valid: holes are skipped
      const int i = q_idx[e];
      const double age = q_age[e];
      const double disp = TRACE ? q_disp[e] : 0.0;
      q_idx[e] = -1;
      v.q_cnt -= 1;
      skip_holes(slot, v);
      if (v.q_cnt == 0)
        v.qmin = __longlong_as_double(0x7ff0000000000000LL);
      else if (age == v.qmin)
        v.qmin = min_age(slot, v);
      double a, sv;
      int rc;
      fetch(i, a, sv, rc);
      start(slot, v, i, t, sv, a, rtt[rc * R + slot], disp);
    }
  }
};

template <bool TRACE, bool WIDE>
__global__ void __launch_bounds__(WARP) scenario_scan_kernel(Args a) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int R = a.R, N = a.N, NREG = a.NREG, G = a.G;
  const double INF = __longlong_as_double(0x7ff0000000000000LL);

  extern __shared__ __align__(16) unsigned char smem[];
  Lane<TRACE, WIDE> s;
  carve(s, smem, R, a.C, a.Q, NREG, a.PC, a.TW, TRACE);
  const long long lN = (long long)lane * N;
  s.arr = a.arr + lN;
  s.svc = a.svc + lN;
  s.rcode = a.rcode + lN;
  s.pend_g = a.pend + (long long)lane * a.NP;
  s.status = a.status + lN;
  s.e2e = a.e2e + lN;
  s.disp_t = TRACE ? a.disp_t + lN : nullptr;
  s.start_t = TRACE ? a.start_t + lN : nullptr;
  s.fin_t = TRACE ? a.fin_t + lN : nullptr;
  s.rep = TRACE ? a.rep + lN : nullptr;
  s.R = R; s.C = a.C; s.Q = a.Q; s.N = N; s.PC = a.PC; s.TW = a.TW;
  s.NP = a.NP;
  s.CH = a.TW / TAPE_CHUNKS; s.tid = tid;
  s.timeout = a.timeout[lane];
  s.p_head = 0; s.p_cnt = 0; s.spill = NO_SPILL;
  s.t_lo = 0; s.t_hi = 0; s.t_fly = 0;
  s.ovf = false;
  const unsigned char* ready = a.ready + (long long)lane * a.W * R;
  const int* kill_slot = a.kill_slot + (long long)lane * a.E;
  const int* kill_g = a.kill_g + (long long)lane * a.E;
  const double* rtt = a.rtt + (long long)lane * R * NREG;

  s.issue();                         // the tape's first chunk
  const Slot empty = {0, 0, 0, 0, INF, INF, false, false};
  s.each_slot([&](int r) { s.store(r, empty); });
  for (int e = tid; e < R * NREG; e += WARP)    // [R, NREG] -> [NREG, R]
    s.rtt[(e % NREG) * R + e / NREG] = rtt[e];
  __syncwarp();
  if (!a.lb_rr) {
    // each slot's rank by (rtt, slot) among all slots, per region
    for (int e = tid; e < R * NREG; e += WARP) {
      const int rc = e / R, r = e % R;
      const double* row = s.rtt + rc * R;
      const double v = row[r];
      int k = 0;
#pragma unroll 1
      for (int q = 0; q < R; ++q) k += (row[q] < v || (row[q] == v && q < r));
      s.rank[e] = k;
    }
    __syncwarp();
  }

  // the grid, in registers: sub-step kb + tid now, kb + 32 + tid next
  double g_ts = tid < G ? a.ts[tid] : 0.0;
  int g_gs = tid < G ? a.gs[tid] : 0;
  int g_wn = tid < G ? a.wins[tid] : 0;
  double n_ts = WARP + tid < G ? a.ts[WARP + tid] : 0.0;
  int n_gs = WARP + tid < G ? a.gs[WARP + tid] : 0;
  int n_wn = WARP + tid < G ? a.wins[WARP + tid] : 0;
  // the next kill event, and slot tid's flag in the next window
  int kill_ptr = 0;
  int kg = a.E > 0 ? kill_g[0] : INT_MAX;
  int ks = a.E > 0 ? kill_slot[0] : 0;
  int cur_win = -1, pre_win = -1, nready = 0;
  unsigned char pre_rdy = 0;
  int a_ptr = 0;
  // the round-robin cursor, int64 as the reference's.  Its 64-bit modulo
  // costs about 1 % on a least-loaded matrix and 3 % on round-robin lanes;
  // a 32-bit path while the high word is zero, or the cursor kept as two
  // 32-bit words, measured no faster (the kernel's time moves with its
  // register layout)
  unsigned long long rr_cur = 0;
  long long n_retried = 0;
  bool overflow = false;

  for (int k = 0; k < G; ++k) {
    const int kl = k & (WARP - 1);
    if (kl == 0 && k > 0) {
      g_ts = n_ts; g_gs = n_gs; g_wn = n_wn;
      const int nk = k + WARP + tid;
      if (nk < G) {
        n_ts = a.ts[nk];
        n_gs = a.gs[nk];
        n_wn = a.wins[nk];
      }
    }
    const double t = __shfl_sync(FULL, g_ts, kl);
    const int g = __shfl_sync(FULL, g_gs, kl);
    const int win = __shfl_sync(FULL, g_wn, kl);

    // -- a new control window: the ready roster -------------------------
    if (win != cur_win) {
      s.each_slot([&](int r) {
        Slot v = s.load(r);
        v.rdy = (r == tid && win == pre_win)
                    ? pre_rdy : ready[(long long)win * R + r];
        s.store(r, v);
      });
      int n = 0;
      for (int r0 = 0; r0 < (WIDE ? R : 1); r0 += WARP) {
        const int r = r0 + tid;
        const bool on = r < R && s.load(r).rdy;
        const unsigned m = __ballot_sync(FULL, on);
        if (on) s.rlist[n + __popc(m & ((1u << tid) - 1u))] = r;
        n += __popc(m);
      }
      nready = n;
      cur_win = win;
      pre_win = win + 1;
      pre_rdy = (tid < R && pre_win < a.W)
                    ? ready[(long long)pre_win * R + tid] : (unsigned char)0;
      __syncwarp();
    }

    // -- 1) kill events due before this sub-step -------------------------
    while (kg <= g) {
      const int slot = ks, owner = slot & (WARP - 1);
      const Slot v = tid == owner ? s.load(slot) : empty;
      const int moved = __shfl_sync(FULL, v.run_n + v.q_cnt, owner);
      s.spill = s.spill_after(moved);
      if (tid == owner) {
        long long p = s.p_head + s.p_cnt;
#pragma unroll 1
        for (int c = 0; c < v.run_n; ++c)          // in-flight, start order
          s.put(p++, s.run_idx[slot * a.C + c]);
#pragma unroll 1
        for (int j = 0, c = v.q_head; j < v.q_span;   // then the queue, FIFO
             ++j, c = (c + 1 == a.Q ? 0 : c + 1))
          if (s.q_idx[slot * a.Q + c] >= 0) s.put(p++, s.q_idx[slot * a.Q + c]);
        Slot killed = empty;
        killed.rdy = v.rdy;
        s.store(slot, killed);
      }
      s.p_cnt += moved;
      n_retried += moved;
      ++kill_ptr;
      kg = kill_ptr < a.E ? kill_g[kill_ptr] : INT_MAX;
      ks = kill_ptr < a.E ? kill_slot[kill_ptr] : 0;
      __syncwarp();
    }

    // -- 2) arrivals: the sorted tape's entries <= t ----------------------
    int cnt = 0;
    for (;;) {
      const int base = a_ptr + cnt;
      s.need(min(base + WARP, N));
      const int i = base + tid;
      const bool in = i < N && s.t_arr[i & (a.TW - 1)] <= t;
      const unsigned b = __ballot_sync(FULL, in);
      const int run = (b == FULL) ? WARP : __ffs(~b) - 1;
      cnt += run;
      if (run < WARP || cnt > a.amax) break;
    }
    if (cnt > a.amax) {
      overflow = true;
      break;
    }
    // They join the pending ring behind what it holds.  With a slot ready
    // the whole ring is placed this sub-step, so the arrivals are placed
    // after it straight from the tape window; only a sub-step with no
    // ready slot stores them in the ring.
    const int first = a_ptr, fresh = nready > 0 ? cnt : 0;
    if (cnt > 0 && nready == 0) {
      s.spill = s.spill_after(cnt);
#pragma unroll 1
      for (int q = tid; q < cnt; q += WARP)
        s.put(s.p_head + s.p_cnt + q, a_ptr + q);
      s.p_cnt += cnt;
      __syncwarp();
    }
    a_ptr += cnt;

    // -- 3) due flags, dispatch -------------------------------------------
    s.each_slot([&](int r) {
      Slot v = s.load(r);
      v.due = v.fin_min <= t;
      s.store(r, v);
    });
    // Place pending request i on a slot, or drop it.
    auto place = [&](int i) {
      double ai, sv;
      int rc;
      s.fetch(i, ai, sv, rc);
      // an expired request is dropped: its status stays 0 and the drain
      // counts it failed
      if (__dsub_rn(t, ai) > s.timeout) return;
      int slot = -1;
      if (a.lb_rr) {
        const int j = (int)(rr_cur % (unsigned)nready);   // (j+1)-th ready
        ++rr_cur;
        const int w = s.rlist[j];
        if (tid == (w & (WARP - 1))) slot = w;
      } else {
        // lexicographic (load, rtt, slot) minimum over the ready slots:
        // the key load * R + rank is unique per slot
        unsigned best = UINT_MAX;
        int best_r = -1;
        s.each_slot([&](int r) {
          const Slot v = s.load(r);
          if (!v.rdy) return;
          const unsigned key = (unsigned)(v.run_n + v.q_cnt) * (unsigned)R +
                               (unsigned)s.rank[rc * R + r];
          if (key < best) { best = key; best_r = r; }
        });
        if (__reduce_min_sync(FULL, best) == best && best != UINT_MAX)
          slot = best_r;
      }
      if (slot >= 0) {                  // this thread owns the chosen slot
        const double rt = s.rtt[rc * R + slot];
        Slot v = s.load(slot);
        if (v.q_cnt == 0 && v.run_n < a.C && !v.due) {
          s.start(slot, v, i, t, sv, ai, rt, t);
        } else if (!s.push_queue(slot, v, i, __dsub_rn(ai, rt), t)) {
          // (queued with effective age arrival - rtt: the expiry sweep is
          // then RTT-inclusive)
          s.ovf = true;                 // the slot already holds Q
        }
        s.store(slot, v);
      }
    };
    while (s.p_cnt > 0 && nready > 0) place(s.pop());
#pragma unroll 1
    for (int q = 0; q < fresh; ++q) place(first + q);

    // -- 4-6) completions, queue expiry, the drain: each slot by its owner
    s.each_slot([&](int r) {
      Slot v = s.load(r);
      s.complete(r, v, t);
      if (a.expire_on) s.expire(r, v, t);
      s.drain(r, v, t);
      s.store(r, v);
    });
    if (__any_sync(FULL, s.ovf)) {
      overflow = true;
      break;
    }
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (tid == 0) {
    a.a_ptr[lane] = a_ptr;
    a.n_retried[lane] = n_retried;
    a.overflow[lane] = overflow ? 1 : 0;
  }
  s.each_slot([&](int r) {
    const Slot v = s.load(r);
    a.run_n[(long long)lane * R + r] = v.run_n;
    a.q_cnt[(long long)lane * R + r] = v.q_cnt;
  });
}

template <bool TRACE, bool WIDE>
cudaError_t launch(const Args& a, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scenario_scan_kernel<TRACE, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  scenario_scan_kernel<TRACE, WIDE><<<a.L, WARP, (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ptrs: arr, svc, rcode, rtt, ready, kill_slot, kill_g, timeout, ts, gs,
// wins, pend [L, NP], status, e2e, a_ptr, run_n, q_cnt, n_retried, overflow,
// disp_t, start_t, fin_t, rep (the last four null without trace_on).
// dims: L, N, R, NREG, W, E, G, Q, C, amax, lb_rr, expire_on, trace_on,
// PC, TW, the shared memory a block needs as the wrapper counted it, and
// NP, the spill ring's length (a power of two >= N).
// The Python wrapper checks the shapes and plans PC and TW; a count that
// differs from carve()'s is refused here.  Returns a cudaError_t
// (0 = launched).
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
  a.PC = (int)dims[13];
  a.TW = (int)dims[14];
  a.NP = (int)dims[16];
  Smem none;
  const long long smem = carve(none, nullptr, a.R, a.C, a.Q, a.NREG, a.PC,
                               a.TW, trace);
  if (smem != dims[15] || (a.PC & (a.PC - 1)) || (a.TW & (a.TW - 1)) ||
      (a.NP & (a.NP - 1)) || a.NP < a.N ||
      a.TW < TAPE_CHUNKS * WARP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = a.R > WARP;     // a thread owns more than one slot
  return static_cast<int>(
      trace ? (wide ? launch<true, true>(a, smem, s) : launch<true, false>(a, smem, s))
            : (wide ? launch<false, true>(a, smem, s) : launch<false, false>(a, smem, s)));
}
