// step_batch.cu — one Raft protocol step for every lane, by hand for Hopper.
//
// Replaces dragonboat_tpu/ops/kernel.py:step_batch (the jitted jnp program
// that XLA fuses on the TPU; in eager PyTorch it would be thousands of tiny
// launches per step). The plain PyTorch version is
// dragonboat_tpu_torch/ops/kernel.py:step_batch_reference; this kernel
// gives the same result bit for bit on every state field and output plane.
//
// Design: one thread per lane. The step is integer and branchy per lane and
// has no matrix product, so it is CUDA C++. A thread reads its lane's
// scalars and its P-, R- and K-sized rows into registers / local arrays
// (P <= 8, R <= 4 at compile time), runs quiesce -> tick -> K inbox slots ->
// quorum commit -> replication fan-out -> ReadIndex pop -> output assembly
// in the reference's order, and writes the lane back. The log ring
// (log_term / log_is_cc of the lane) is read and written in place in global
// memory; the thread owns that row, so the in-place update is race-free.
//
// Bound: memory traffic. The step reads the inbox and the state once,
// writes the state and the outputs once, and touches only the ring slots it
// appends to or looks up. With one thread per lane the per-lane rows are
// strided by the row width across a warp, so ring and [G,P] accesses are
// not coalesced; that is accepted for this first version and is the first
// thing to redesign (lane-per-warp or a shared-memory transpose).
//
// Operation-saving rewrites that keep the result equal to the reference:
//   - ring-slot scatters write only indices lo..hi (the reference does an
//     O(W) gather + select per message);
//   - the uncommitted / to-apply config-change scans loop over the live
//     window only;
//   - the quorum order statistic is an insertion sort of <= 8 values with
//     INT_MAX fill;
//   - popcount is __popc of the u32 bit pattern.
// JAX semantics kept by hand: floor modulo, u32 wraparound with logical
// shifts, INT_MIN for an out-of-range gather, all-False out-of-range
// one_hot rows, 1 << n == 0 for n outside [0, 31], clip(x, lo, hi) ==
// min(max(x, lo), hi), and bool planes stored as exactly 0 or 1.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DB_DEV __device__ __forceinline__
#else
#define DB_DEV static inline
#endif

#define PMAX 8
#define RMAX 4
#define DB_INT_MAX 2147483647
#define DB_INT_MIN (-2147483647 - 1)

enum { F_FOLLOWER = 0, F_CANDIDATE = 1, F_LEADER = 2, F_OBSERVER = 3,
       F_WITNESS = 4, F_PRE_CANDIDATE = 5 };
enum { RS_RETRY = 0, RS_WAIT = 1, RS_REPLICATE = 2, RS_SNAPSHOT = 3 };
enum { M_NONE = -1, M_ELECTION = 1, M_NOOP = 4, M_PROPOSE = 7,
       M_SNAPSHOT_STATUS = 8, M_UNREACHABLE = 9, M_REPLICATE = 12,
       M_REPLICATE_RESP = 13, M_REQUEST_VOTE = 14, M_REQUEST_VOTE_RESP = 15,
       M_INSTALL_SNAPSHOT = 16, M_HEARTBEAT = 17, M_HEARTBEAT_RESP = 18,
       M_READ_INDEX = 19, M_READ_INDEX_RESP = 20, M_LEADER_TRANSFER = 23,
       M_TIMEOUT_NOW = 24, M_REQUEST_PREVOTE = 26,
       M_REQUEST_PREVOTE_RESP = 27 };
enum { S_REPLICATE = 1, S_HEARTBEAT = 2, S_VOTE_REQ = 4, S_TIMEOUT_NOW = 8,
       S_NEED_SNAPSHOT = 16 };

// Every tensor of one step, passed by value as the kernel's parameter
// (~940 bytes, under the 4 KB limit). ops/cuda.py fills a ctypes.Structure
// with the same fields in the same order.
struct StepParams {
  // RaftTensors, in the field order of ops/state.py (updated in place)
  uint8_t* active;
  int32_t* self_slot;
  uint8_t* member;
  uint8_t* voting;
  uint8_t* observer;
  uint8_t* witness;
  int32_t* term;
  int32_t* vote;
  int32_t* role;
  int32_t* leader;
  int32_t* tick_count;
  int32_t* election_tick;
  int32_t* heartbeat_tick;
  int32_t* rand_timeout;
  int32_t* election_timeout;
  int32_t* heartbeat_timeout;
  uint8_t* check_quorum;
  uint8_t* prevote_on;
  uint8_t* lease_on;
  int32_t* lease_margin;
  int32_t* lease_until;
  int32_t* hb_round_tick;
  int32_t* hb_ack_bits;
  uint8_t* clock_ok;
  int32_t* first_index;
  int32_t* marker_term;
  int32_t* last_index;
  int32_t* committed;
  int32_t* processed;
  int32_t* applied;
  int32_t* unsaved_from;
  int32_t* log_term;
  uint8_t* log_is_cc;
  int32_t* match;
  int32_t* next;
  int32_t* rstate;
  uint8_t* ract;
  int32_t* snap_sent;
  uint8_t* vresp;
  uint8_t* vgrant;
  int32_t* transfer_to;
  uint8_t* transfer_flag;
  uint8_t* pending_cc;
  uint8_t* quiesce_on;
  int32_t* quiesce_threshold;
  uint8_t* quiesced;
  int32_t* idle_ticks;
  int32_t* ri_ctx;
  int32_t* ri_ctx2;
  int32_t* ri_index;
  int32_t* ri_acks;
  int32_t* ri_count;
  uint32_t* seed;
  // Inbox, then ticks
  const int32_t* in_mtype;
  const int32_t* in_from_slot;
  const int32_t* in_term;
  const int32_t* in_log_index;
  const int32_t* in_log_term;
  const int32_t* in_commit;
  const uint8_t* in_reject;
  const int32_t* in_hint;
  const int32_t* in_hint_high;
  const int32_t* in_n_entries;
  const int32_t* in_entry_terms;
  const uint8_t* in_entry_cc;
  const int32_t* ticks;
  // StepOutput
  int32_t* o_send_flags;
  int32_t* o_send_prev_index;
  int32_t* o_send_prev_term;
  int32_t* o_send_n_entries;
  int32_t* o_send_commit;
  int32_t* o_send_hb_commit;
  int32_t* o_send_hint;
  int32_t* o_send_hint2;
  int32_t* o_vote_last_index;
  int32_t* o_vote_last_term;
  int32_t* o_resp_type;
  int32_t* o_resp_to;
  int32_t* o_resp_term;
  int32_t* o_resp_log_index;
  uint8_t* o_resp_reject;
  int32_t* o_resp_hint;
  int32_t* o_resp_hint2;
  int32_t* o_save_from;
  int32_t* o_save_to;
  int32_t* o_apply_from;
  int32_t* o_apply_to;
  int32_t* o_commit_index;
  uint8_t* o_hard_changed;
  int32_t* o_ready_ctx;
  int32_t* o_ready_ctx2;
  int32_t* o_ready_index;
  int32_t* o_ready_count;
  int32_t* o_dropped_propose;
  uint8_t* o_dropped_cc;
  int32_t* o_fwd_leader;
  int32_t* o_noop_appended;
  int32_t* o_noop_term;
  uint8_t* o_log_full;
  int32_t* o_prop_base;
  int32_t* o_rep_base;
  int32_t* o_leader;
  int32_t* o_term;
  int32_t* o_vote;
  int32_t* o_role;
  int32_t* o_match;
  int32_t* o_rstate;
  int32_t* o_last_index;
  uint8_t* o_quiesced;
  int32_t* o_lease_round;
  int32_t* o_lease_served;
  int32_t* o_lease_fallback;
  uint8_t* o_lease_ok;
  uint32_t* o_counters;
  int32_t G, P, W, K, E, R;
};

DB_DEV int fmod_i(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}
DB_DEV int imax(int a, int b) { return a > b ? a : b; }
DB_DEV int imin(int a, int b) { return a < b ? a : b; }
DB_DEV int clip(int x, int lo, int hi) { return imin(imax(x, lo), hi); }
DB_DEV int shl1(int n) { return (n >= 0 && n < 32) ? (int)(1u << n) : 0; }
DB_DEV int popc32(int x) {
#ifdef __CUDA_ARCH__
  return __popc((unsigned)x);
#else
  return __builtin_popcount((unsigned)x);
#endif
}

DB_DEV uint32_t mix32(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t x = (a * 2654435761u) ^ (b * 40503u) ^ (c * 2246822519u);
  x ^= x >> 15;
  x *= 2246822519u;
  x ^= x >> 13;
  return x;
}

DB_DEV int rand_timeout(uint32_t seed, int term, int slot, int et) {
  uint32_t x = mix32(seed, (uint32_t)term, (uint32_t)slot);
  uint32_t etu = (uint32_t)et;
  uint32_t r = etu ? x % etu : 0u;  // XLA: a u32 remainder by 0 is 0
  return (int)((uint32_t)et + r);
}

// One lane's state, held by its thread for the whole step.
struct Lane {
  int P, R, W, E;
  int* ring;         // log_term row of the lane (global memory)
  uint8_t* ring_cc;  // log_is_cc row
  bool active, check_quorum, prevote_on, lease_on, clock_ok, transfer_flag,
      pending_cc, quiesce_on, quiesced;
  int self_slot, term, vote, role, leader, tick_count, election_tick,
      heartbeat_tick, rand_timeout, election_timeout, heartbeat_timeout,
      lease_margin, lease_until, hb_round_tick, hb_ack_bits, first_index,
      marker_term, last_index, committed, processed, applied, unsaved_from,
      transfer_to, quiesce_threshold, idle_ticks, ri_count;
  uint32_t seed;
  bool member[PMAX], voting[PMAX], observer[PMAX], witness[PMAX], ract[PMAX],
      vresp[PMAX], vgrant[PMAX];
  int match[PMAX], next[PMAX], rstate[PMAX], snap_sent[PMAX];
  int ri_ctx[RMAX], ri_ctx2[RMAX], ri_index[RMAX], ri_acks[RMAX];
};

// Per-step accumulators of the output planes (the reference's `out` dict).
struct Acc {
  int send_flags[PMAX], send_hint[PMAX], send_hint2[PMAX];
  bool force_probe[PMAX];
  int noop_appended, noop_term, dropped_propose, lease_served,
      lease_fallback, fwd_leader;
  bool dropped_cc, log_full;
  int ctr_started, ctr_won, ctr_hb, ctr_rejects;
};

// One inbox slot of the lane.
struct Msg {
  int mtype, from, term, log_index, log_term, commit, hint, hint_high, nent;
  bool reject;
  const int32_t* eterms;  // E entry terms
  const uint8_t* ecc;     // E entry cc flags
};

DB_DEV bool is_self(const Lane& L, int p) { return p == L.self_slot; }

DB_DEV int num_voting(const Lane& L) {
  int n = 0;
  for (int p = 0; p < L.P; ++p) n += L.voting[p];
  return n;
}
DB_DEV int quorum(const Lane& L) { return num_voting(L) / 2 + 1; }

// term of entry idx: ring lookup, marker, or 0 out of the window
DB_DEV int term_at(const Lane& L, int idx) {
  if (idx >= L.first_index && idx <= L.last_index && idx >= 1)
    return L.ring[fmod_i(idx, L.W)];
  return idx == L.first_index - 1 ? L.marker_term : 0;
}

// any config-change entry in (committed, last_index]
DB_DEV bool has_uncommitted_cc(const Lane& L) {
  int lo = imax(imax(L.committed + 1, L.first_index), L.last_index - L.W + 1);
  for (int i = lo; i <= L.last_index; ++i)
    if (L.ring_cc[fmod_i(i, L.W)]) return true;
  return false;
}

// any config-change entry in (applied, committed]
DB_DEV bool has_cc_to_apply(const Lane& L) {
  int lo = imax(imax(L.applied + 1, L.first_index), L.last_index - L.W + 1);
  int hi = imin(L.committed, L.last_index);
  for (int i = lo; i <= hi; ++i)
    if (L.ring_cc[fmod_i(i, L.W)]) return true;
  return false;
}

// the shared reset on any role change
DB_DEV void reset(Lane& L, int new_term) {
  if (new_term != L.term) L.vote = 0;
  L.term = new_term;
  L.election_tick = 0;
  L.heartbeat_tick = 0;
  L.rand_timeout = rand_timeout(L.seed, new_term, L.self_slot, L.election_timeout);
  L.transfer_to = 0;
  L.pending_cc = false;
  L.ri_count = 0;
  L.lease_until = 0;
  L.hb_round_tick = 0;
  L.hb_ack_bits = 0;
  for (int r = 0; r < L.R; ++r)
    L.ri_ctx[r] = L.ri_ctx2[r] = L.ri_index[r] = L.ri_acks[r] = 0;
  for (int p = 0; p < L.P; ++p) {
    L.vresp[p] = L.vgrant[p] = false;
    L.match[p] = is_self(L, p) ? L.last_index : 0;
    L.next[p] = L.last_index + 1;
    L.rstate[p] = 0;
    L.snap_sent[p] = 0;
  }
}

DB_DEV void become_follower(Lane& L, int new_term, int leader) {
  int role = (L.role == F_OBSERVER || L.role == F_WITNESS) ? L.role : F_FOLLOWER;
  reset(L, new_term);
  L.role = role;
  L.leader = leader;
}

DB_DEV void append_one(Lane& L, bool is_cc) {
  int idx = L.last_index + 1;
  int w = fmod_i(idx, L.W);
  L.ring[w] = L.term;
  L.ring_cc[w] = is_cc;
  L.last_index = idx;
  if (L.self_slot >= 0 && L.self_slot < L.P) L.match[L.self_slot] = idx;
}

DB_DEV void become_leader(Lane& L) {
  bool hcc = has_uncommitted_cc(L);
  reset(L, L.term);
  L.role = F_LEADER;
  L.leader = L.self_slot + 1;
  L.pending_cc = hcc;
  append_one(L, false);
}

// start an election (or a pre-vote poll) on this lane if `mask`
DB_DEV void campaign(Lane& L, Acc& A, bool mask, bool transfer_hint,
                     bool force_real) {
  if (!mask) return;
  bool self_voting =
      L.self_slot >= 0 && L.self_slot < L.P && L.voting[L.self_slot];
  bool can = L.active && L.role != F_LEADER && L.role != F_OBSERVER &&
             L.role != F_WITNESS && !has_cc_to_apply(L) && self_voting;
  bool single_now = num_voting(L) == 1;
  bool pre = can && L.prevote_on && !transfer_hint && !single_now && !force_real;
  bool real = can && !pre;
  if (pre) {
    L.role = F_PRE_CANDIDATE;
    L.leader = 0;
    for (int p = 0; p < L.P; ++p) L.vresp[p] = L.vgrant[p] = is_self(L, p);
  }
  bool single = false;
  int noop_at = 0;
  if (real) {
    reset(L, L.term + 1);
    L.role = F_CANDIDATE;
    L.leader = 0;
    L.vote = L.self_slot + 1;
    for (int p = 0; p < L.P; ++p) L.vresp[p] = L.vgrant[p] = is_self(L, p);
    single = num_voting(L) == 1;
    if (single) {
      noop_at = L.last_index + 1;
      become_leader(L);
    }
  }
  A.ctr_started += real;
  A.ctr_won += single;
  bool vote_req = (real && !single) || pre;
  bool hint = real && !single && transfer_hint;
  for (int p = 0; p < L.P; ++p) {
    if (!(L.voting[p] && !is_self(L, p))) continue;
    if (vote_req) A.send_flags[p] |= S_VOTE_REQ;
    if (hint) A.send_hint[p] = L.self_slot + 1;
  }
  A.noop_appended = imax(A.noop_appended, noop_at);
  A.noop_term = imax(A.noop_term, single ? L.term : 0);
}

DB_DEV bool is_leader_msg(int t) {
  return t == M_REPLICATE || t == M_INSTALL_SNAPSHOT || t == M_HEARTBEAT ||
         t == M_TIMEOUT_NOW || t == M_READ_INDEX_RESP;
}

// the lane's value at peer slot `from`, 0 when the slot is out of range
// (the reference's sum over a one_hot row)
DB_DEV int at_from(const int* a, int from, int P) {
  return (from >= 0 && from < P) ? a[from] : 0;
}

// the response-plane entries one inbox slot produces
struct Resp {
  int type, to, term, log_index, hint, hint2, prop_base, rep_base;
  bool reject;
};

// push a ReadIndex queue entry at position `pos` (a one_hot write: nothing
// is written for a position outside [0, R))
DB_DEV void ri_put(Lane& L, int pos, int ctx, int ctx2, int index, int acks) {
  if (pos < 0 || pos >= L.R) return;
  L.ri_ctx[pos] = ctx;
  L.ri_ctx2[pos] = ctx2;
  L.ri_index[pos] = index;
  L.ri_acks[pos] = acks;
}

DB_DEV bool log_up_to_date(const Lane& L, const Msg& m) {
  int lt = term_at(L, L.last_index);
  return m.log_term > lt || (m.log_term == lt && m.log_index >= L.last_index);
}

// Apply one inbox slot: the term preamble, then the handler for its type.
// Every handler of the reference is masked by one message type, so a
// switch on the type runs exactly the handler whose mask can be true.
DB_DEV void handle_message(Lane& L, Acc& A, const Msg& m, Resp& o) {
  const int P = L.P, W = L.W, E = L.E, R = L.R;
  const int f = m.from;

  // ---- term preamble ----
  bool present = m.mtype != M_NONE;
  bool local = m.term == 0;
  bool higher = present && !local && m.term > L.term;
  bool lower = present && !local && m.term < L.term;
  bool is_pv = m.mtype == M_REQUEST_PREVOTE;
  bool is_pvr = m.mtype == M_REQUEST_PREVOTE_RESP;
  bool drop_rv = higher && (m.mtype == M_REQUEST_VOTE || is_pv) &&
                 L.check_quorum && m.hint != f + 1 && L.leader != 0 &&
                 L.election_tick < L.election_timeout;
  bool step_down = higher && !drop_rv && !is_pv && !(is_pvr && !m.reject);
  if (step_down) become_follower(L, m.term, is_leader_msg(m.mtype) ? f + 1 : 0);
  bool noop_resp = lower && is_leader_msg(m.mtype) && L.check_quorum;
  bool pv_stale = lower && is_pv;
  bool act = present && !(lower || drop_rv);

  const bool is_leader = L.role == F_LEADER;
  const bool is_cand = L.role == F_CANDIDATE;
  const bool is_precand = L.role == F_PRE_CANDIDATE;
  const bool is_obs = L.role == F_OBSERVER;
  const bool is_wit = L.role == F_WITNESS;
  const bool is_fol = L.role == F_FOLLOWER;
  const bool voter_role = is_fol || is_cand || is_precand || is_leader || is_wit;
  const bool follow_role = is_fol || is_obs || is_wit || is_cand || is_precand;

  int resp_type = noop_resp ? M_NOOP : M_NONE;
  if (pv_stale) resp_type = M_REQUEST_PREVOTE_RESP;
  int resp_log_index = 0, resp_hint = 0, resp_hint2 = 0, pv_resp_term = 0;
  bool resp_reject = pv_stale;
  int prop_base = 0, rep_base = 0;
  const bool known_from = f >= 0 && f < P && L.member[f];

  if (act) switch (m.mtype) {
    case M_REQUEST_VOTE:
      if (voter_role) {
        bool grant = (L.vote == 0 || L.vote == f + 1) && log_up_to_date(L, m);
        if (grant) {
          L.vote = f + 1;
          L.election_tick = 0;
        }
        resp_type = M_REQUEST_VOTE_RESP;
        resp_reject = !grant;
      }
      break;

    case M_REQUEST_PREVOTE:
      if (voter_role) {
        bool grant = m.term > L.term && log_up_to_date(L, m);
        resp_type = M_REQUEST_PREVOTE_RESP;
        resp_reject = !grant;
        if (grant) pv_resp_term = m.term;
      }
      break;

    case M_REQUEST_VOTE_RESP:
    case M_REQUEST_PREVOTE_RESP: {
      bool real = m.mtype == M_REQUEST_VOTE_RESP;
      if (!((real ? is_cand : is_precand) && known_from)) break;
      if (!L.vresp[f]) {
        L.vresp[f] = true;
        L.vgrant[f] = !m.reject;
      }
      int granted = 0, rejected = 0;
      for (int p = 0; p < P; ++p) {
        granted += L.vgrant[p] && L.voting[p];
        rejected += L.vresp[p] && !L.vgrant[p] && L.voting[p];
      }
      int q = quorum(L);
      bool win = granted >= q;
      bool lose = !win && rejected >= q;
      if (real && win) {
        int noop_at = L.last_index + 1;
        become_leader(L);
        A.ctr_won += 1;
        A.noop_appended = imax(A.noop_appended, noop_at);
        A.noop_term = imax(A.noop_term, L.term);
      }
      if (!real) campaign(L, A, win, false, win);
      if (lose) become_follower(L, L.term, 0);
      break;
    }

    case M_ELECTION:
      campaign(L, A, true, false, false);
      break;

    case M_TIMEOUT_NOW:
      campaign(L, A, is_fol, is_fol, false);
      break;

    case M_REPLICATE: {
      if (!follow_role) break;
      if (is_cand || is_precand) become_follower(L, L.term, f + 1);
      L.leader = f + 1;
      L.election_tick = 0;
      int prev = m.log_index, nent = m.nent;
      bool stale = prev < L.committed;
      bool match_prev = term_at(L, prev) == m.log_term;
      bool in_window = prev >= L.first_index - 1 && prev <= L.last_index;
      bool ok = !stale && match_prev && in_window;
      bool rej = !stale && !ok;
      A.ctr_rejects += rej;
      if (ok && E > 0) {
        int first_conf = DB_INT_MAX;
        for (int e = 0; e < E; ++e) {
          int ei = prev + 1 + e;
          bool conflict = e < nent &&
              (ei > L.last_index || L.ring[fmod_i(ei, W)] != m.eterms[e]);
          if (conflict) {
            first_conf = ei;
            break;
          }
        }
        if (first_conf != DB_INT_MAX) {
          // the indexes the reference's (G, W) select writes: lo..hi, at
          // most one per ring slot
          int hi = imin(prev + nent, first_conf + (W - 1));
          for (int i = first_conf; i <= hi; ++i) {
            int w = fmod_i(i, W);
            int ep = clip(i - (prev + 1), 0, E - 1);
            L.ring[w] = m.eterms[ep];
            L.ring_cc[w] = m.ecc[ep] != 0;
          }
          L.last_index = prev + nent;
          L.unsaved_from = imin(L.unsaved_from, first_conf);
        }
      }
      int ack_to = prev + nent;
      if (ok) {
        L.committed = clip(imin(ack_to, m.commit), L.committed, L.last_index);
        rep_base = prev + 1;
      }
      resp_type = M_REPLICATE_RESP;
      if (stale) resp_log_index = L.committed;
      else if (ok) resp_log_index = ack_to;
      else if (rej) resp_log_index = prev;
      if (rej) {
        resp_reject = true;
        resp_hint = L.last_index;
      }
      break;
    }

    case M_HEARTBEAT:
      if (!follow_role) break;
      if (is_cand || is_precand) become_follower(L, L.term, f + 1);
      L.leader = f + 1;
      L.election_tick = 0;
      L.committed = clip(m.commit, L.committed, L.last_index);
      resp_type = M_HEARTBEAT_RESP;
      resp_log_index = m.log_index;
      resp_hint = m.hint;
      resp_hint2 = m.hint_high;
      break;

    case M_REPLICATE_RESP: {
      if (!(is_leader && known_from)) break;
      int li = m.log_index;
      int prev_rs = L.rstate[f];
      bool racc = !m.reject;
      bool moved = racc && li > L.match[f];
      L.ract[f] = true;
      if (racc) {
        L.match[f] = imax(L.match[f], li);
        L.next[f] = imax(L.next[f], li + 1);
      }
      int st = L.rstate[f];
      if (moved && st == RS_WAIT) st = RS_RETRY;
      if (moved && st == RS_RETRY) st = RS_REPLICATE;
      if (moved && st == RS_SNAPSHOT && L.match[f] >= L.snap_sent[f]) st = RS_RETRY;
      L.rstate[f] = st;
      bool in_repl = prev_rs == RS_REPLICATE;
      bool valid_repl = m.reject && in_repl && li > L.match[f];
      bool valid_probe = m.reject && !in_repl && L.next[f] - 1 == li;
      if (valid_repl || valid_probe) {
        L.next[f] = valid_repl ? L.match[f] + 1 : imax(1, imin(li, m.hint + 1));
        L.rstate[f] = RS_RETRY;
      }
      if (racc && L.transfer_to != 0 && f + 1 == L.transfer_to &&
          L.match[f] == L.last_index)
        A.send_flags[f] |= S_TIMEOUT_NOW;
      break;
    }

    case M_HEARTBEAT_RESP: {
      if (!(is_leader && known_from)) break;
      int li = m.log_index;
      L.ract[f] = true;
      if (L.rstate[f] == RS_WAIT) L.rstate[f] = RS_RETRY;
      if (L.match[f] < L.last_index) A.force_probe[f] = true;
      int fb = shl1(f);
      for (int r = 0; r < R; ++r)
        if (L.ri_ctx[r] == m.hint && L.ri_ctx2[r] == m.hint_high && L.ri_ctx[r] != 0)
          L.ri_acks[r] |= fb;
      bool tag = L.lease_on && li != 0 && li == L.hb_round_tick && L.voting[f];
      int bits = tag ? (L.hb_ack_bits | fb) : L.hb_ack_bits;
      bool grant = L.lease_on && L.clock_ok && L.hb_round_tick != 0 &&
                   popc32(bits) + 1 >= quorum(L);
      L.hb_ack_bits = bits;
      if (grant)
        L.lease_until = imax(L.lease_until,
                             L.hb_round_tick + L.election_timeout - L.lease_margin);
      break;
    }

    case M_READ_INDEX: {
      if (!is_leader) break;
      bool single = num_voting(L) == 1;
      bool ok_ri = single || term_at(L, L.committed) == L.term;
      bool slot_free = L.ri_count < R;
      bool lease_valid = L.lease_on && L.clock_ok && L.tick_count < L.lease_until &&
                         L.transfer_to == 0;
      bool imm_lease = ok_ri && !single && lease_valid && slot_free;
      bool enq = ok_ri && !single && !lease_valid && slot_free;
      if (enq) {
        ri_put(L, L.ri_count, m.hint, m.hint_high, L.committed, 0);
        L.ri_count += 1;
        for (int p = 0; p < P; ++p) {
          if (!(L.voting[p] && !is_self(L, p))) continue;
          A.send_flags[p] |= S_HEARTBEAT;
          A.ctr_hb += 1;
          A.send_hint[p] = m.hint;
          A.send_hint2[p] = m.hint_high;
        }
      }
      if ((ok_ri && single) || imm_lease) {
        ri_put(L, L.ri_count, m.hint, m.hint_high, L.committed, -1);
        L.ri_count += 1;
      }
      A.lease_served += imm_lease;
      A.lease_fallback += enq && L.lease_on;
      break;
    }

    case M_PROPOSE: {
      int nent = m.nent;
      bool pok = L.role == F_LEADER && L.transfer_to == 0;
      bool has_cc = false;
      for (int e = 0; e < E; ++e) has_cc |= e < nent && m.ecc[e];
      bool cc_allowed = pok && has_cc && !L.pending_cc;
      if (pok && has_cc && L.pending_cc) A.dropped_cc = true;
      if (cc_allowed) L.pending_cc = true;
      bool room = L.last_index - L.first_index + 1 + nent <= W;
      bool can_append = pok && room;
      if (can_append) prop_base = L.last_index + 1;
      if (can_append && E > 0) {
        int lo = L.last_index + 1;
        int hi = imin(L.last_index + nent, lo + (W - 1));
        for (int i = lo; i <= hi; ++i) {
          int w = fmod_i(i, W);
          L.ring[w] = L.term;
          L.ring_cc[w] = cc_allowed && m.ecc[clip(i - lo, 0, E - 1)];
        }
        L.last_index += nent;
        if (L.self_slot >= 0 && L.self_slot < P) L.match[L.self_slot] = L.last_index;
      }
      if (!can_append) A.dropped_propose += nent;
      if (!pok) A.fwd_leader = L.leader;
      if (pok && !room) A.log_full = true;
      break;
    }

    case M_READ_INDEX_RESP:
      if (!(is_fol || is_obs)) break;
      L.leader = f + 1;
      L.election_tick = 0;
      if (L.ri_count < R) {
        ri_put(L, L.ri_count, m.hint, m.hint_high, m.log_index, -1);
        L.ri_count += 1;
      }
      break;

    case M_LEADER_TRANSFER: {
      if (!is_leader) break;
      int target = m.hint;
      bool lt_ok = L.transfer_to == 0 && target != L.self_slot + 1 && target != 0;
      if (lt_ok) {
        L.transfer_to = target;
        L.election_tick = 0;
      }
      int t = imax(target - 1, 0);
      if (lt_ok && t < P && L.match[t] == L.last_index) A.send_flags[t] |= S_TIMEOUT_NOW;
      break;
    }

    case M_UNREACHABLE:
      if (is_leader && known_from && L.rstate[f] == RS_REPLICATE) L.rstate[f] = RS_RETRY;
      break;

    case M_SNAPSHOT_STATUS:
      if (is_leader && known_from && L.rstate[f] == RS_SNAPSHOT) {
        int old_sent = L.snap_sent[f];
        if (m.reject) L.snap_sent[f] = 0;
        L.next[f] = imax(L.match[f] + 1, old_sent + 1);
        L.rstate[f] = RS_WAIT;
      }
      break;

    default:
      break;
  }

  o.type = (act || noop_resp || pv_stale) ? resp_type : M_NONE;
  o.to = f;
  o.term = pv_resp_term > 0 ? pv_resp_term : L.term;
  o.log_index = resp_log_index;
  o.reject = resp_reject;
  o.hint = resp_hint;
  o.hint2 = resp_hint2;
  o.prop_base = prop_base;
  o.rep_base = rep_base;
}

// advance logical clocks (quiesce freeze first), elections, check-quorum,
// heartbeats and the lease round
DB_DEV void tick_phase(Lane& L, Acc& A, const StepParams& S, int g, int ticks) {
  const int P = L.P, K = S.K;
  // ---- quiesce ----
  bool activity = false;
  for (int k = 0; k < K; ++k) {
    int t = S.in_mtype[(size_t)g * K + k];
    activity |= t != M_NONE && t != M_HEARTBEAT && t != M_HEARTBEAT_RESP;
  }
  int idle = (activity || !L.quiesce_on) ? 0 : L.idle_ticks + imax(ticks, 0);
  bool entering = L.quiesce_on && L.active && !L.quiesced && idle >= L.quiesce_threshold;
  bool exiting = L.quiesced && activity;
  L.idle_ticks = idle;
  L.quiesced = (L.quiesced || entering) && !activity;
  if (exiting) L.election_tick = 0;

  // ---- tick ----
  bool do_tick = L.active && ticks > 0 && !L.quiesced;
  if (do_tick) {
    L.tick_count += ticks;
    L.election_tick += ticks;
  }
  bool was_leader = L.role == F_LEADER;
  bool can_campaign = do_tick && !was_leader && L.role != F_OBSERVER &&
                      L.role != F_WITNESS && L.election_tick >= L.rand_timeout;
  if (can_campaign) L.election_tick = 0;
  campaign(L, A, can_campaign, false, false);
  bool cq_due = do_tick && was_leader && L.election_tick >= L.election_timeout;
  if (cq_due) {
    L.election_tick = 0;
    L.transfer_to = 0;
    int active_cnt = 0;
    for (int p = 0; p < P; ++p) active_cnt += (L.ract[p] || is_self(L, p)) && L.voting[p];
    bool down = L.check_quorum && active_cnt < quorum(L);
    for (int p = 0; p < P; ++p) L.ract[p] = false;
    if (down) become_follower(L, L.term, 0);
  }
  bool leader = L.role == F_LEADER;
  if (do_tick && leader) L.heartbeat_tick += ticks;
  bool hb_due = do_tick && leader && L.heartbeat_tick >= L.heartbeat_timeout;
  if (!hb_due) return;
  L.heartbeat_tick = 0;
  if (L.lease_on) {
    L.hb_round_tick = L.tick_count;
    L.hb_ack_bits = 0;
  }
  bool pending = L.ri_count > 0;
  int hint = 0, hint2 = 0;
  if (pending) {
    // take_along_axis at max(ri_count - 1, 0): INT_MIN past the queue end
    int pos = imax(L.ri_count - 1, 0);
    hint = pos < L.R ? L.ri_ctx[pos] : DB_INT_MIN;
    hint2 = pos < L.R ? L.ri_ctx2[pos] : DB_INT_MIN;
  }
  for (int p = 0; p < P; ++p) {
    bool others_v = L.voting[p] && !is_self(L, p);
    bool tgt = pending ? others_v : (others_v || L.observer[p]);
    if (!tgt) continue;
    A.send_flags[p] |= S_HEARTBEAT;
    A.ctr_hb += 1;
    A.send_hint[p] = hint;
    A.send_hint2[p] = hint2;
  }
}

DB_DEV void step_lane(const StepParams& S, int g) {
  const int P = S.P, W = S.W, K = S.K, E = S.E, R = S.R;
  const size_t gp = (size_t)g * P, gr = (size_t)g * R, gk = (size_t)g * K;
  Lane L;
  L.P = P; L.R = R; L.W = W; L.E = E;
  L.ring = S.log_term + (size_t)g * W;
  L.ring_cc = S.log_is_cc + (size_t)g * W;
#define LOAD(f) L.f = S.f[g]
#define LOADB(f) L.f = S.f[g] != 0
  LOADB(active); LOAD(self_slot); LOAD(term); LOAD(vote); LOAD(role);
  LOAD(leader); LOAD(tick_count); LOAD(election_tick); LOAD(heartbeat_tick);
  LOAD(rand_timeout); LOAD(election_timeout); LOAD(heartbeat_timeout);
  LOADB(check_quorum); LOADB(prevote_on); LOADB(lease_on); LOAD(lease_margin);
  LOAD(lease_until); LOAD(hb_round_tick); LOAD(hb_ack_bits); LOADB(clock_ok);
  LOAD(first_index); LOAD(marker_term); LOAD(last_index); LOAD(committed);
  LOAD(processed); LOAD(applied); LOAD(unsaved_from); LOAD(transfer_to);
  LOADB(transfer_flag); LOADB(pending_cc); LOADB(quiesce_on);
  LOAD(quiesce_threshold); LOADB(quiesced); LOAD(idle_ticks); LOAD(ri_count);
  LOAD(seed);
  for (int p = 0; p < P; ++p) {
    L.member[p] = S.member[gp + p] != 0;
    L.voting[p] = S.voting[gp + p] != 0;
    L.observer[p] = S.observer[gp + p] != 0;
    L.witness[p] = S.witness[gp + p] != 0;
    L.ract[p] = S.ract[gp + p] != 0;
    L.vresp[p] = S.vresp[gp + p] != 0;
    L.vgrant[p] = S.vgrant[gp + p] != 0;
    L.match[p] = S.match[gp + p];
    L.next[p] = S.next[gp + p];
    L.rstate[p] = S.rstate[gp + p];
    L.snap_sent[p] = S.snap_sent[gp + p];
  }
  for (int r = 0; r < R; ++r) {
    L.ri_ctx[r] = S.ri_ctx[gr + r];
    L.ri_ctx2[r] = S.ri_ctx2[gr + r];
    L.ri_index[r] = S.ri_index[gr + r];
    L.ri_acks[r] = S.ri_acks[gr + r];
  }
  const int prev_term = L.term, prev_vote = L.vote, prev_commit = L.committed;
  const int save_base_floor = L.unsaved_from;

  Acc A;
  for (int p = 0; p < P; ++p) {
    A.send_flags[p] = A.send_hint[p] = A.send_hint2[p] = 0;
    A.force_probe[p] = false;
  }
  A.noop_appended = A.noop_term = A.dropped_propose = 0;
  A.lease_served = A.lease_fallback = A.fwd_leader = 0;
  A.dropped_cc = A.log_full = false;
  A.ctr_started = A.ctr_won = A.ctr_hb = A.ctr_rejects = 0;

  tick_phase(L, A, S, g, S.ticks[g]);

  // ---- inbox scan ----
  for (int k = 0; k < K; ++k) {
    const size_t i = gk + k;
    Msg m;
    m.mtype = S.in_mtype[i];
    m.from = S.in_from_slot[i];
    m.term = S.in_term[i];
    m.log_index = S.in_log_index[i];
    m.log_term = S.in_log_term[i];
    m.commit = S.in_commit[i];
    m.reject = S.in_reject[i] != 0;
    m.hint = S.in_hint[i];
    m.hint_high = S.in_hint_high[i];
    m.nent = S.in_n_entries[i];
    m.eterms = S.in_entry_terms + i * E;
    m.ecc = S.in_entry_cc + i * E;
    Resp o;
    handle_message(L, A, m, o);
    S.o_resp_type[i] = o.type;
    S.o_resp_to[i] = o.to;
    S.o_resp_term[i] = o.term;
    S.o_resp_log_index[i] = o.log_index;
    S.o_resp_reject[i] = o.reject;
    S.o_resp_hint[i] = o.hint;
    S.o_resp_hint2[i] = o.hint2;
    S.o_prop_base[i] = o.prop_base;
    S.o_rep_base[i] = o.rep_base;
  }

  // ---- quorum commit: k-th order statistic of the voting match ----
  const bool is_leader = L.role == F_LEADER;
  const int nv = num_voting(L);
  const int q = nv / 2 + 1;
  {
    int sorted[PMAX];
    for (int p = 0; p < P; ++p) {
      int v = L.voting[p] ? L.match[p] : DB_INT_MAX;
      int j = p;
      while (j > 0 && sorted[j - 1] > v) {
        sorted[j] = sorted[j - 1];
        --j;
      }
      sorted[j] = v;
    }
    int qidx = sorted[clip(nv - q, 0, P - 1)];
    if (is_leader && nv > 0 && qidx > L.committed && term_at(L, qidx) == L.term)
      L.committed = qidx;
  }

  // ---- replication fan-out ----
  const bool commit_moved = L.committed != prev_commit;
  for (int p = 0; p < P; ++p) {
    if (L.rstate[p] == RS_SNAPSHOT && L.match[p] >= L.snap_sent[p]) L.rstate[p] = RS_RETRY;
    bool peer_tgt = L.member[p] && !is_self(L, p);
    bool lag = L.next[p] <= L.last_index;
    bool paused = L.rstate[p] == RS_WAIT || L.rstate[p] == RS_SNAPSHOT;
    bool compacted = L.next[p] < L.first_index;
    bool send = is_leader && peer_tgt && (lag || commit_moved || A.force_probe[p]) &&
                !paused && !compacted;
    bool need_snap = is_leader && peer_tgt && lag && !paused && compacted && L.ract[p];
    int n_send = clip(L.last_index - L.next[p] + 1, 0, E);
    int prev_idx = L.next[p] - 1;
    if (send) A.send_flags[p] |= S_REPLICATE;
    if (need_snap) {
      A.send_flags[p] |= S_NEED_SNAPSHOT;
      L.snap_sent[p] = L.last_index;
      L.rstate[p] = RS_SNAPSHOT;
    }
    S.o_send_prev_index[gp + p] = send ? prev_idx : 0;
    S.o_send_prev_term[gp + p] =
        !send ? 0 : prev_idx == L.first_index - 1 ? L.marker_term
                                                   : L.ring[fmod_i(prev_idx, W)];
    S.o_send_n_entries[gp + p] = send ? n_send : 0;
    S.o_send_commit[gp + p] = send ? L.committed : 0;
    if (send && n_send > 0 && L.rstate[p] == RS_REPLICATE) L.next[p] += n_send;
    else if (send && n_send > 0 && L.rstate[p] == RS_RETRY) L.rstate[p] = RS_WAIT;
  }

  // ---- ReadIndex ready-queue pop ----
  int last_conf = 0, conf_idx = 0;
  for (int r = 0; r < R; ++r) {
    int acks = L.ri_acks[r];
    bool confirmed = (popc32(acks) + 1 >= q || acks == -1) && r < L.ri_count &&
                     L.ri_ctx[r] != 0;
    if (confirmed) {
      last_conf = r + 1;
      conf_idx = imax(conf_idx, L.ri_index[r]);
    }
  }
  for (int r = 0; r < R; ++r) {
    bool pop = r < last_conf;
    S.o_ready_ctx[gr + r] = pop ? L.ri_ctx[r] : 0;
    S.o_ready_ctx2[gr + r] = pop ? L.ri_ctx2[r] : 0;
    S.o_ready_index[gr + r] = pop ? imin(L.ri_index[r], conf_idx) : 0;
  }
  {
    const int keep = L.ri_count - last_conf;
    int c[RMAX], c2[RMAX], ix[RMAX], ak[RMAX];
    for (int r = 0; r < R; ++r) {
      int t = clip(r + last_conf, 0, R - 1);
      bool kept = r < keep;
      c[r] = kept ? L.ri_ctx[t] : 0;
      c2[r] = kept ? L.ri_ctx2[t] : 0;
      ix[r] = kept ? L.ri_index[t] : 0;
      ak[r] = kept ? L.ri_acks[t] : 0;
    }
    for (int r = 0; r < R; ++r) {
      L.ri_ctx[r] = c[r];
      L.ri_ctx2[r] = c2[r];
      L.ri_index[r] = ix[r];
      L.ri_acks[r] = ak[r];
    }
    L.ri_count = keep;
  }
  const int ready_count = last_conf;

  // ---- engine directives ----
  const int save_from = imin(save_base_floor, L.unsaved_from);
  const bool has_save = L.last_index >= save_from && L.active;
  S.o_save_from[g] = has_save ? save_from : 0;
  S.o_save_to[g] = has_save ? L.last_index : 0;
  L.unsaved_from = L.last_index + 1;
  const int apply_from = L.processed + 1;
  const bool has_apply = L.committed >= apply_from && L.active;
  const int apply_to = has_apply ? L.committed : 0;
  S.o_apply_from[g] = has_apply ? apply_from : 0;
  S.o_apply_to[g] = apply_to;
  L.processed = imax(L.processed, L.committed);
  L.applied = imax(L.applied, apply_to);

  const bool end_leader = L.role == F_LEADER;
  const bool end_cand = L.role == F_CANDIDATE || L.role == F_PRE_CANDIDATE;
  const int leader_bits = S_REPLICATE | S_HEARTBEAT | S_TIMEOUT_NOW | S_NEED_SNAPSHOT;
  for (int p = 0; p < P; ++p) {
    int fl = A.send_flags[p];
    if (!end_leader) fl &= ~leader_bits;
    if (!end_cand) fl &= ~S_VOTE_REQ;
    S.o_send_flags[gp + p] = L.active ? fl : 0;
    S.o_send_hb_commit[gp + p] = imin(L.match[p], L.committed);
    S.o_send_hint[gp + p] = A.send_hint[p];
    S.o_send_hint2[gp + p] = A.send_hint2[p];
    S.o_match[gp + p] = L.match[p];
    S.o_rstate[gp + p] = L.rstate[p];
  }
  S.o_vote_last_index[g] = L.last_index;
  S.o_vote_last_term[g] = term_at(L, L.last_index);
  S.o_commit_index[g] = L.committed;
  S.o_hard_changed[g] = (L.term != prev_term || L.vote != prev_vote ||
                         L.committed != prev_commit) && L.active;
  S.o_ready_count[g] = L.active ? ready_count : 0;
  S.o_dropped_propose[g] = A.dropped_propose;
  S.o_dropped_cc[g] = A.dropped_cc;
  S.o_fwd_leader[g] = A.fwd_leader;
  S.o_noop_appended[g] = A.noop_appended;
  S.o_noop_term[g] = A.noop_term;
  S.o_log_full[g] = A.log_full;
  S.o_leader[g] = L.leader;
  S.o_term[g] = L.term;
  S.o_vote[g] = L.vote;
  S.o_role[g] = L.role;
  S.o_last_index[g] = L.last_index;
  S.o_quiesced[g] = L.quiesced;
  S.o_lease_round[g] = (L.lease_on && end_leader) ? L.hb_round_tick : 0;
  S.o_lease_served[g] = A.lease_served;
  S.o_lease_fallback[g] = A.lease_fallback;
  S.o_lease_ok[g] = L.lease_on && L.clock_ok && end_leader &&
                    L.tick_count < L.lease_until && L.transfer_to == 0;
  uint32_t* ctr = S.o_counters + (size_t)g * 8;
  ctr[0] = (uint32_t)A.ctr_started;
  ctr[1] = (uint32_t)A.ctr_won;
  ctr[2] = (uint32_t)A.ctr_hb;
  ctr[3] = (uint32_t)A.ctr_rejects;
  ctr[4] = (uint32_t)L.committed - (uint32_t)prev_commit;
  ctr[5] = (uint32_t)A.lease_served;
  ctr[6] = (uint32_t)A.lease_fallback;
  ctr[7] = (uint32_t)(L.active ? ready_count : 0);

  // ---- write the lane back (in place) ----
#define STORE(f) S.f[g] = L.f
  STORE(active); STORE(self_slot); STORE(term); STORE(vote); STORE(role);
  STORE(leader); STORE(tick_count); STORE(election_tick); STORE(heartbeat_tick);
  STORE(rand_timeout); STORE(election_timeout); STORE(heartbeat_timeout);
  STORE(check_quorum); STORE(prevote_on); STORE(lease_on); STORE(lease_margin);
  STORE(lease_until); STORE(hb_round_tick); STORE(hb_ack_bits); STORE(clock_ok);
  STORE(first_index); STORE(marker_term); STORE(last_index); STORE(committed);
  STORE(processed); STORE(applied); STORE(unsaved_from); STORE(transfer_to);
  STORE(transfer_flag); STORE(pending_cc); STORE(quiesce_on);
  STORE(quiesce_threshold); STORE(quiesced); STORE(idle_ticks); STORE(ri_count);
  for (int p = 0; p < P; ++p) {
    S.ract[gp + p] = L.ract[p];
    S.vresp[gp + p] = L.vresp[p];
    S.vgrant[gp + p] = L.vgrant[p];
    S.match[gp + p] = L.match[p];
    S.next[gp + p] = L.next[p];
    S.rstate[gp + p] = L.rstate[p];
    S.snap_sent[gp + p] = L.snap_sent[p];
  }
  for (int r = 0; r < R; ++r) {
    S.ri_ctx[gr + r] = L.ri_ctx[r];
    S.ri_ctx2[gr + r] = L.ri_ctx2[r];
    S.ri_index[gr + r] = L.ri_index[r];
    S.ri_acks[gr + r] = L.ri_acks[r];
  }
#undef LOAD
#undef LOADB
#undef STORE
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128) step_batch_kernel(const StepParams S) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < S.G) step_lane(S, g);
}

// Launch one step on `stream`. Returns cudaGetLastError() (0 = launched).
extern "C" int step_batch_launch(const StepParams* params, void* stream) {
  if (params->G <= 0) return 0;
  const int threads = 128;
  const int blocks = (params->G + threads - 1) / threads;
  step_batch_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

extern "C" int step_batch_params_size() { return (int)sizeof(StepParams); }
#endif
