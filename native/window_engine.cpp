// Native columnar window engine: the C++ batch assembler of the device
// window path (SURVEY.md §7 step 4: "batch assembler (pinned host
// buffers -> PJRT device buffers)" belongs in the native runtime).
//
// Covers the hot standalone case of Win_Seq_TPU (role SEQ, identity
// WinOperatorConfig, int64 keys, builtin combines): ingest columnar
// batches, detect fired windows, and stage pane-partial flat buffers +
// extents for one XLA launch.  The Python engine
// (operators/tpu/win_seq_tpu.py) delegates here when the workload
// matches and falls back otherwise (roles, custom functors, string
// keys).
//
// The state model is the Pane decomposition (Li et al., SIGMOD 2005;
// reference wf/pane_farm.hpp:33-35) applied at INGEST time: because the
// engine only runs builtin associative combines, it never stores the
// tuple stream at all.  Each key holds a small ring of pane
// accumulators (pane = gcd(win, slide), so every window is an exact
// pane range) and each tuple is folded into its pane on arrival -- one
// load+combine+store on a hot cache line, instead of the scatter-copy
// of the full value series that a CUDA staging design implies
// (win_seq_gpu.hpp:552-596 archives tuples per key and re-reads them
// per batch; on a TPU host that second pass is pure memory-bandwidth
// waste).  Late tuples within the retained pane range fold in exactly
// like the archive insert would; tuples behind the fired frontier are
// dropped, matching the scalar path's acceptance rule
// (win_seq.hpp:417-428).
//
// Event-time firing (wfn_engine_watermark): a stream that carries
// watermarks fires windows by event time instead of by each key's own
// later tuples.  From the first watermark on, every key with an open
// window waits in the bucket of its next window (windows are aligned,
// so one bucket a slide); a watermark fires the due buckets in order of
// (window, key), and a key whose windows have all fired and been staged
// is freed, its probe-table slot with it.  A later tuple of a freed key
// starts the key afresh, never below the watermark's fired frontier.
// Without watermarks none of this runs.
//
// GIL-free: every entry point only touches caller-provided arrays and
// internal state; Python calls via ctypes release the GIL.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <map>
#include <numeric>
#include <vector>

namespace {

using i64 = long long;

constexpr double INF = std::numeric_limits<double>::infinity();

struct KeyState {
    // pane-partial ring: pacc[j] is the combine partial of absolute
    // pane (pane_base + j); pcnt[j] its tuple count.  plid/plts track
    // the max tuple id seen per pane and its timestamp -- the CB
    // result-timestamp lane (result ts = ts of the last tuple in the
    // window extent, matching the host engine); empty for TB windows,
    // whose result ts is pure window arithmetic.
    std::vector<double> pacc;
    std::vector<i64> pcnt;
    std::vector<i64> plid, plts;
    i64 pane_base = 0;        // absolute pane index of pacc[0]
    i64 next_fire = 0;        // next window (lwid) to fire
    i64 anchor = 0;           // first window that can ever fire for this
                              // key (set from the first tuple; windows
                              // before it are never emitted, matching
                              // the on-demand window creation of the
                              // scalar path, win_seq.hpp:417-428)
    i64 opened_max = -1;
    i64 max_id = -1;
    i64 arrivals = 0;         // renumber lane: running arrival count
                              // (ids implicit, persists across eviction)
    i64 key = 0;              // this state's key
    bool live = false;        // holds a key (else on the free list)
    i64 queued = 0;           // fired windows not yet staged
    bool in_bucket = false;   // waits in the watermark bucket next_fire
    // flush scratch: the span of this key's windows in one staging call
    i64 fl_stamp = -1, fl_lo = 0, fl_hi = 0, fl_off = 0, fl_poff = 0;
};

struct Desc {
    i64 key, lwid, start, end;
    KeyState* st;
};

// floor division (numpy's //): a negative numerator lands in its
// containing pane or window, not in the one above it
static inline i64 floordiv(i64 a, i64 b) {
    i64 q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

enum class Kind : int { SUM = 0, COUNT = 1, MAX = 2, MIN = 3, MEAN = 4 };

struct Engine {
    i64 win, slide, delay;
    bool is_tb;
    bool renumber;            // ids are implicit per-key arrival order
                              // (TS_RENUMBERING analogue): the id input
                              // is ignored
    Kind kind;
    i64 pane;                 // gcd(win, slide)
    int pshift;               // log2(pane) when pane is a power of two
    double neutral;
    // the keys' states: a slab of stable slots, freed ones reused (with
    // their rings' capacity) before the slab grows; the scatter table
    // below indexes every live one
    std::deque<KeyState> slab;
    std::vector<KeyState*> free_states;
    i64 n_live = 0;
    std::vector<Desc> ready;  // fired, unstaged: ready[ready_head:]
    std::size_t ready_head = 0;
    i64 ignored = 0;          // tuples dropped behind the fired frontier
    // event-time firing (entered at the first watermark): the keys
    // waiting by their next window, and the first window not yet fired
    // for every key (a fresh key never fires a window below it)
    bool wm_mode = false;
    i64 wm_next = INT64_MIN;
    std::map<i64, std::vector<KeyState*>> buckets;
    std::vector<KeyState*> to_evict;  // keys left with nothing to fire
    i64 n_watermarks = 0, fired_wm = 0, evicted = 0;
    // flush scratch: per-key count prefixes and the keys staged
    i64 flush_id = 0;
    std::vector<i64> st_prefix;
    std::vector<KeyState*> touched;
    // staging buffers (valid until the next flush)
    std::vector<double> st_vals, st_cnts;
    std::vector<i64> st_starts, st_ends, st_keys, st_gwids, st_rts;
    // scatter-ingest machinery: an open-addressing table maps every
    // live key -> (KeyState*, per-call dense index).  Pass 1 does ONE
    // table probe per tuple and gathers per-key min/max; pass 2 folds
    // each tuple into its pane through the cached state pointer.
    struct Slot {
        i64 key = EMPTY;
        KeyState* st = nullptr;   // occupancy: non-null (a real key may
                                  // equal the EMPTY sentinel)
        i64 stamp = -1;           // the ingest call that last touched it
        int32_t dense = 0;        // its dense index in that call
    };
    std::vector<Slot> tab;
    i64 call_id = 0;
    // per-call dense arrays (index = order of first touch this call)
    std::vector<KeyState*> d_state;
    std::vector<i64> d_key, d_count, d_min, d_max, d_accept;
    std::vector<int32_t> slot_of;  // per-tuple dense index
    static constexpr i64 EMPTY = INT64_MIN;

    Engine(i64 w, i64 s, bool tb, i64 d, bool renum, Kind k)
        : win(w), slide(s), delay(tb ? d : 0), is_tb(tb), renumber(renum),
          kind(k), pane(std::gcd(w, s)) {
        pshift = (pane & (pane - 1)) == 0 ? __builtin_ctzll(pane) : -1;
        neutral = kind == Kind::MAX ? -INF : kind == Kind::MIN ? INF : 0.0;
        tab.assign(1024, Slot());
    }

    inline i64 pane_of(i64 id) const {
        return pshift >= 0 ? id >> pshift : id / pane;
    }

    // a key's home slot: consecutive keys 17 slots apart, so that a
    // stretch of live consecutive keys (NEXMark's auctions) interleaves
    // with empty slots -- short probe runs, which keeps deletion cheap
    // -- while a batch's neighbouring keys still probe in strided order
    static inline std::size_t home(i64 key, std::size_t mask) {
        return (std::size_t)((uint64_t)key * 17u) & mask;
    }

    void grow_table() {
        std::vector<Slot> nt(tab.size() * 4);
        std::size_t mask = nt.size() - 1;
        for (const Slot& sl : tab) {
            if (sl.st == nullptr) continue;
            std::size_t h = home(sl.key, mask);
            while (nt[h].st != nullptr) h = (h + 1) & mask;
            nt[h] = sl;
        }
        tab.swap(nt);
    }

    // a state for ``key`` from the free list, else a new slab slot
    KeyState* new_state(i64 key) {
        KeyState* st;
        if (free_states.empty()) {
            st = &slab.emplace_back();
        } else {
            st = free_states.back();
            free_states.pop_back();
        }
        st->key = key;
        st->live = true;
        ++n_live;
        return st;
    }

    // the table slot holding ``key``, or the empty slot where it goes
    inline std::size_t slot_of_key(i64 key) const {
        std::size_t mask = tab.size() - 1;
        std::size_t h = home(key, mask);
        while (tab[h].st != nullptr && tab[h].key != key)
            h = (h + 1) & mask;
        return h;
    }

    KeyState* find_state(i64 key) const {
        return tab[slot_of_key(key)].st;
    }

    // ``key``'s state, made (and indexed) on first use
    KeyState& state_of(i64 key) {
        std::size_t h = slot_of_key(key);
        if (tab[h].st != nullptr) return *tab[h].st;
        if (n_live * 4 >= (i64)tab.size()) {
            grow_table();
            h = slot_of_key(key);
        }
        tab[h] = Slot{key, new_state(key), -1, 0};
        return *tab[h].st;
    }

    inline int32_t dense_of(i64 key) {
        std::size_t h = slot_of_key(key);
        if (tab[h].st == nullptr) {
            state_of(key);
            h = slot_of_key(key);
        }
        Slot& sl = tab[h];
        if (sl.stamp != call_id) {
            sl.stamp = call_id;
            sl.dense = (int32_t)d_key.size();
            d_key.push_back(sl.key);
            d_state.push_back(sl.st);
            d_count.push_back(0);
        }
        return sl.dense;
    }

    // drop ``key``'s table slot (backward-shift deletion: every later
    // entry of the probe run moves up to the freed slot unless its home
    // lies after it)
    void table_erase(i64 key) {
        std::size_t mask = tab.size() - 1;
        std::size_t i = slot_of_key(key);
        if (tab[i].st == nullptr) return;
        std::size_t j = i;
        while (true) {
            j = (j + 1) & mask;
            if (tab[j].st == nullptr) break;
            std::size_t h = home(tab[j].key, mask);
            bool stays = i <= j ? (i < h && h <= j) : (i < h || h <= j);
            if (stays) continue;
            tab[i] = tab[j];
            i = j;
        }
        tab[i] = Slot();
    }

    // free a key's state: its slot leaves the table, the state (its
    // rings emptied, their capacity kept) goes to the free list
    void evict(KeyState* st) {
        table_erase(st->key);
        std::vector<double> pacc = std::move(st->pacc);
        std::vector<i64> pcnt = std::move(st->pcnt);
        std::vector<i64> plid = std::move(st->plid);
        std::vector<i64> plts = std::move(st->plts);
        *st = KeyState();
        pacc.clear();
        pcnt.clear();
        plid.clear();
        plts.clear();
        st->pacc = std::move(pacc);
        st->pcnt = std::move(pcnt);
        st->plid = std::move(plid);
        st->plts = std::move(plts);
        free_states.push_back(st);
        --n_live;
        ++evicted;
    }

    void clear_keys() {
        slab.clear();
        free_states.clear();
        n_live = 0;
        std::fill(tab.begin(), tab.end(), Slot());
    }

    inline i64 n_ready() const { return (i64)(ready.size() - ready_head); }

    inline void fire(KeyState& st, i64 key, i64 w) {
        ready.push_back(Desc{key, w, w * slide, w * slide + win, &st});
        ++st.queued;
    }

    // first data of a key: anchor its frontier at the first window that
    // holds the earliest tuple -- firing from 0 on an epoch-scale first
    // id/ts would emit ~id/slide empty windows (flood/OOM) -- and never
    // below the windows a watermark has already fired
    inline void anchor_at(KeyState& st, i64 first) {
        st.anchor = first < win ? 0 : (first - win) / slide + 1;
        st.next_fire = std::max(st.anchor, wm_next);
        st.pane_base = pane_of(st.next_fire * slide);
    }

    // after a key's tuples folded: the windows they opened, then either
    // per-key firing (a window fires once the key's own tuples pass its
    // end + delay) or, under watermarks, the key's bucket
    void settle(KeyState& st, i64 key, bool hopping) {
        if (!hopping && st.max_id >= 0) {
            i64 last_w = (st.max_id + 1 + slide - 1) / slide - 1;
            if (last_w > st.opened_max) st.opened_max = last_w;
        }
        if (wm_mode) {
            if (st.in_bucket) return;
            if (st.next_fire <= st.opened_max) {
                buckets[st.next_fire].push_back(&st);
                st.in_bucket = true;
            } else if (st.queued == 0) {
                to_evict.push_back(&st);  // only late tuples: nothing open
            }
            return;
        }
        while (true) {
            i64 end = st.next_fire * slide + win;
            if (st.max_id < end + delay || st.next_fire > st.opened_max)
                break;
            fire(st, key, st.next_fire);
            ++st.next_fire;
        }
    }

    void evict_pending() {
        for (KeyState* st : to_evict) evict(st);
        to_evict.clear();
    }

    // Fire, in order of (window, key), every window whose end is at or
    // below the watermark ``wm``.  Returns the windows fired.
    i64 watermark(i64 wm) {
        if (!wm_mode) {
            // from now on windows fire by event time: every key with an
            // open window joins the bucket of its next one
            wm_mode = true;
            for (KeyState& st : slab) {
                if (!st.live) continue;
                if (st.next_fire <= st.opened_max) {
                    buckets[st.next_fire].push_back(&st);
                    st.in_bucket = true;
                } else if (st.queued == 0) {
                    to_evict.push_back(&st);
                }
            }
            evict_pending();
        }
        ++n_watermarks;
        if (wm < INT64_MIN / 2) return 0;
        const i64 due = floordiv(wm - win, slide);  // last window due
        if (due + 1 > wm_next) wm_next = due + 1;
        i64 fired = 0;
        while (!buckets.empty() && buckets.begin()->first <= due) {
            const i64 w = buckets.begin()->first;
            std::vector<KeyState*> wait = std::move(buckets.begin()->second);
            buckets.erase(buckets.begin());
            for (KeyState* st : wait) {
                fire(*st, st->key, w);
                st->next_fire = w + 1;
                if (st->next_fire <= st->opened_max) {
                    buckets[w + 1].push_back(st);
                } else {
                    st->in_bucket = false;  // freed once staged (flush)
                }
            }
            fired += (i64)wait.size();
        }
        fired_wm += fired;
        return fired;
    }

    // grow the pane ring so relative pane p_rel is addressable
    inline void ensure_pane(KeyState& st, i64 p_rel) {
        if (p_rel < (i64)st.pacc.size()) return;
        // geometric headroom: rings grow a few panes per batch; the
        // +8 keeps amortized growth O(1) without doubling a large ring
        i64 n = p_rel + 1 + std::min<i64>(p_rel / 2 + 8, 4096);
        st.pacc.resize(n, neutral);
        st.pcnt.resize(n, 0);
        if (!is_tb) {
            st.plid.resize(n, INT64_MIN);
            st.plts.resize(n, 0);
        }
    }

    inline void fold(KeyState& st, i64 p_rel, double v) {
        switch (kind) {
            case Kind::COUNT: st.pacc[p_rel] += 1.0; break;
            case Kind::MAX:
                if (v > st.pacc[p_rel]) st.pacc[p_rel] = v;
                break;
            case Kind::MIN:
                if (v < st.pacc[p_rel]) st.pacc[p_rel] = v;
                break;
            case Kind::SUM:
            case Kind::MEAN:
            default: st.pacc[p_rel] += v; break;
        }
        ++st.pcnt[p_rel];
    }

    // TV = double or float: f32 sources fold without a host-side
    // widening copy (values widen at the accumulate)
    template <typename TV>
    void ingest_batch(const i64* bkeys, const i64* ids, const i64* tss,
                      const TV* vals, i64 n) {
        ++call_id;
        d_key.clear();
        d_state.clear();
        d_count.clear();
        if ((i64)slot_of.size() < n) slot_of.resize(n);
        if (renumber) {
            for (i64 j = 0; j < n; ++j) {
                int32_t d = dense_of(bkeys[j]);
                ++d_count[d];
                slot_of[j] = d;
            }
        } else {
            for (i64 j = 0; j < n; ++j) {
                int32_t d = dense_of(bkeys[j]);
                ++d_count[d];
                slot_of[j] = d;
                i64 id = ids[j];
                if ((std::size_t)d >= d_min.size()) {
                    d_min.resize(d + 1, INT64_MAX);
                    d_max.resize(d + 1, INT64_MIN);
                }
                if (id < d_min[d]) d_min[d] = id;
                if (id > d_max[d]) d_max[d] = id;
            }
        }
        std::size_t nd = d_key.size();
        if (d_min.size() < nd) d_min.resize(nd);
        if (d_max.size() < nd) d_max.resize(nd);
        d_accept.resize(nd);
        for (std::size_t d = 0; d < nd; ++d) {
            KeyState& st = *d_state[d];
            if (renumber) {
                // implicit arrival-order ids: this batch appends ids
                // [arrivals, arrivals + count)
                d_min[d] = st.arrivals;
                d_max[d] = st.arrivals + d_count[d] - 1;
            }
            if (st.max_id < 0) anchor_at(st, d_min[d]);
            d_accept[d] = st.next_fire > st.anchor
                ? (st.next_fire - 1) * slide + win : st.anchor * slide;
            // pre-grow the ring to this batch's frontier so the fold
            // loop never reallocates
            i64 hi_rel = pane_of(d_max[d]) - st.pane_base;
            if (hi_rel >= 0) ensure_pane(st, hi_rel);
        }
        // hopping windows (win < slide): whether an id opens a window
        // depends on its position inside the slide period, so the
        // opened-window frontier must be tracked per accepted tuple --
        // the batch's final max_id alone misses windows opened by
        // mid-batch ids when the batch ends in a gap
        const bool hopping = win < slide;
        if (renumber) {
            for (i64 j = 0; j < n; ++j) {
                int32_t d = slot_of[j];
                KeyState& st = *d_state[d];
                i64 id = st.arrivals++;
                i64 p = pane_of(id) - st.pane_base;
                if (p < 0) continue;  // hopping-gap arrival below the ring
                if (hopping) {
                    i64 nn = id / slide;
                    if (id >= nn * slide + win) continue;  // gap arrival
                    if (nn > st.opened_max) st.opened_max = nn;
                }
                fold(st, p, (double)vals[j]);
                if (!is_tb && id >= st.plid[p]) {
                    st.plid[p] = id;
                    st.plts[p] = tss[j];
                }
            }
        } else if (is_tb) {
            for (i64 j = 0; j < n; ++j) {
                int32_t d = slot_of[j];
                i64 id = ids[j];
                if (id < d_accept[d]) {
                    ++ignored;
                    continue;
                }
                KeyState& st = *d_state[d];
                i64 p = pane_of(id) - st.pane_base;
                if (p < 0) continue;  // hopping-gap tuple below the ring
                if (hopping) {
                    i64 nn = id / slide;
                    if (id >= nn * slide + win) continue;  // gap tuple
                    if (nn > st.opened_max) st.opened_max = nn;
                }
                fold(st, p, (double)vals[j]);
            }
        } else {
            for (i64 j = 0; j < n; ++j) {
                int32_t d = slot_of[j];
                i64 id = ids[j];
                if (id < d_accept[d]) {
                    ++ignored;
                    continue;
                }
                KeyState& st = *d_state[d];
                i64 p = pane_of(id) - st.pane_base;
                if (p < 0) continue;
                if (hopping) {
                    i64 nn = id / slide;
                    if (id >= nn * slide + win) continue;  // gap tuple
                    if (nn > st.opened_max) st.opened_max = nn;
                }
                fold(st, p, (double)vals[j]);
                if (id >= st.plid[p]) {
                    st.plid[p] = id;
                    st.plts[p] = tss[j];
                }
            }
        }
        for (std::size_t d = 0; d < nd; ++d) {
            KeyState& st = *d_state[d];
            if (d_max[d] > st.max_id) st.max_id = d_max[d];
            settle(st, d_key[d], hopping);
            d_min[d] = INT64_MAX;
            d_max[d] = INT64_MIN;
        }
        evict_pending();
    }

    // Fused synthesis + ingest: generate events [start, start+n) of the
    // declared synthetic law (key = e % K, id = ts = e / K,
    // value = (e % vmod) * vscale + voff -- operators/synth.py) and
    // fold them directly into the pane rings.  Grouping by key turns
    // the per-tuple hash probe into one map lookup per key, and the
    // generated columns never materialize in memory: the host feed for
    // a declared synthetic stream costs the fold alone, the columnar
    // twin of the record plane's set_synth lane.
    // ``mask``: optional residue filter (uint8[vmod]; entry 0 drops) --
    // a declared value-predicate filter folds to it, since the
    // synthetic value of event e depends only on e % vmod.  A dropped
    // event behaves exactly as if a Filter removed it before the
    // window op: it does not fold, does not advance max_id/arrivals,
    // and cannot open or trigger windows (the record plane's EOS fires
    // only up to the last SURVIVING tuple).  ``vtab``: optional
    // per-residue value table (double[vmod]) computed by applying the
    // declared map chain sequentially -- bit-identical floats to the
    // per-event path, where composing the affines into one (vscale,
    // voff) could differ by ULPs at filter boundaries.
    void synth_ingest(i64 start, i64 n, i64 K, i64 vmod,
                      double vscale, double voff,
                      const unsigned char* mask = nullptr,
                      const double* vtab = nullptr) {
        const i64 endE = start + n;
        const bool hopping = win < slide;
        if (vmod <= 0) vmod = 1;
        const i64 kmod = K % vmod;
        for (i64 k = 0; k < K; ++k) {
            // first event e >= start with e % K == k
            i64 e0 = start + (((k - start % K) % K) + K) % K;
            if (e0 >= endE) continue;
            KeyState& st = state_of(k);
            const i64 id0 = e0 / K;
            const i64 cnt = (endE - e0 + K - 1) / K;
            if (st.max_id < 0 && !mask) {
                anchor_at(st, id0);
            } else if (st.max_id < 0 && mask) {
                // anchor on the first SURVIVING id (a masked prefix
                // must not open windows the record plane never sees)
                i64 vm0 = e0 % vmod;
                i64 first = -1;
                for (i64 j = 0; j < cnt; ++j) {
                    if (mask[vm0]) { first = id0 + j; break; }
                    vm0 += kmod;
                    if (vm0 >= vmod) vm0 -= vmod;
                }
                if (first < 0) continue;  // whole chunk filtered out
                anchor_at(st, first);
            }
            i64 hi_rel = pane_of(id0 + cnt - 1) - st.pane_base;
            if (hi_rel >= 0) ensure_pane(st, hi_rel);
            const i64 accept = st.next_fire > st.anchor
                ? (st.next_fire - 1) * slide + win : st.anchor * slide;
            i64 vm = e0 % vmod;  // value index, advanced mod-free
            if (!mask) {
                // headline lane: every event survives, so arrivals and
                // max_id hoist out of the per-event loop
                for (i64 j = 0; j < cnt; ++j) {
                    const i64 id = id0 + j;
                    const double v = vtab ? vtab[vm]
                                          : (double)vm * vscale + voff;
                    vm += kmod;
                    if (vm >= vmod) vm -= vmod;
                    if (id < accept) {
                        ++ignored;
                        continue;
                    }
                    const i64 p = pane_of(id) - st.pane_base;
                    if (p < 0) continue;
                    if (hopping) {
                        const i64 nn = id / slide;
                        if (id >= nn * slide + win) continue;  // gap
                        if (nn > st.opened_max) st.opened_max = nn;
                    }
                    fold(st, p, v);
                    if (!is_tb && id >= st.plid[p]) {
                        st.plid[p] = id;
                        st.plts[p] = id;  // the law sets ts = id
                    }
                }
                st.arrivals += cnt;
                if (id0 + cnt - 1 > st.max_id) st.max_id = id0 + cnt - 1;
            } else {
                i64 last_ok = st.max_id;  // max SURVIVING id
                for (i64 j = 0; j < cnt; ++j) {
                    const i64 id = id0 + j;
                    const double v = vtab ? vtab[vm]
                                          : (double)vm * vscale + voff;
                    const bool dropped = !mask[vm];
                    vm += kmod;
                    if (vm >= vmod) vm -= vmod;
                    if (dropped) continue;  // filtered pre-window
                    ++st.arrivals;  // renumber lane: survivors only
                    if (id > last_ok) last_ok = id;
                    if (id < accept) {
                        ++ignored;
                        continue;
                    }
                    const i64 p = pane_of(id) - st.pane_base;
                    if (p < 0) continue;
                    if (hopping) {
                        const i64 nn = id / slide;
                        if (id >= nn * slide + win) continue;  // gap
                        if (nn > st.opened_max) st.opened_max = nn;
                    }
                    fold(st, p, v);
                    if (!is_tb && id >= st.plid[p]) {
                        st.plid[p] = id;
                        st.plts[p] = id;  // the law sets ts = id
                    }
                }
                if (last_ok > st.max_id) st.max_id = last_ok;
            }
            settle(st, k, hopping);
        }
        evict_pending();
    }

    // pane accessors tolerant of extents beyond the retained ring
    // (panes outside it hold no tuples by construction)
    inline double pane_at(const KeyState& st, i64 p_abs) const {
        i64 r = p_abs - st.pane_base;
        return (r >= 0 && r < (i64)st.pacc.size()) ? st.pacc[r] : neutral;
    }
    inline i64 cnt_at(const KeyState& st, i64 p_abs) const {
        i64 r = p_abs - st.pane_base;
        return (r >= 0 && r < (i64)st.pcnt.size()) ? st.pcnt[r] : 0;
    }

    // Stage up to max_windows ready windows as pane partials.
    // Returns the number staged.
    i64 flush(i64 max_windows) {
        st_vals.clear();
        st_cnts.clear();
        st_starts.clear();
        st_ends.clear();
        st_keys.clear();
        st_gwids.clear();
        st_rts.clear();
        if (n_ready() == 0) return 0;
        const i64 take = std::min<i64>(max_windows, n_ready());
        const Desc* rd = ready.data() + ready_head;
        // the span of each key's taken windows (a key's windows were
        // fired in order, but keys interleave)
        ++flush_id;
        touched.clear();
        for (i64 d = 0; d < take; ++d) {
            KeyState& st = *rd[d].st;
            if (st.fl_stamp != flush_id) {
                st.fl_stamp = flush_id;
                st.fl_lo = rd[d].start;
                st.fl_hi = rd[d].end;
                touched.push_back(&st);
            } else {
                st.fl_lo = std::min(st.fl_lo, rd[d].start);
                st.fl_hi = std::max(st.fl_hi, rd[d].end);
            }
        }
        st_prefix.clear();
        for (KeyState* stp : touched) {
            KeyState& st = *stp;
            i64 p0 = pane_of(st.fl_lo);
            i64 n_panes = (st.fl_hi - st.fl_lo) / pane;
            st.fl_off = (i64)st_vals.size();
            st.fl_poff = (i64)st_prefix.size();
            st_prefix.push_back(0);  // prefix tuple counts over the span
            for (i64 p = 0; p < n_panes; ++p) {
                st_vals.push_back(pane_at(st, p0 + p));
                st_prefix.push_back(st_prefix.back() + cnt_at(st, p0 + p));
                if (kind == Kind::MEAN)
                    st_cnts.push_back((double)cnt_at(st, p0 + p));
            }
        }
        for (i64 d = 0; d < take; ++d) {
            const Desc& ds = rd[d];
            KeyState& st = *ds.st;
            const i64* pf = st_prefix.data() + st.fl_poff;
            st_keys.push_back(ds.key);
            st_gwids.push_back(ds.lwid);
            i64 ps = (ds.start - st.fl_lo) / pane;
            i64 pe = (ds.end - st.fl_lo) / pane;
            // a fired window whose extent holds no tuples (gapped id
            // space) stages an EMPTY pane range (start==end) so the
            // device combine emits the masked neutral 0, exactly like
            // the Python/XLA path (window_compute.py `jnp.where`) --
            // otherwise max/min kinds would emit the +-inf pane fill
            bool empty = pf[pe] == pf[ps];
            st_starts.push_back(st.fl_off + (empty ? 0 : ps));
            st_ends.push_back(st.fl_off + (empty ? 0 : pe));
            if (is_tb) {
                st_rts.push_back(ds.lwid * slide + win - 1);
            } else if (empty) {
                st_rts.push_back(0);
            } else {
                // CB: result ts = ts of the max-id tuple in the extent,
                // which lives in the last non-empty pane of the range
                // (binary search on the span's count prefix)
                i64 q = std::lower_bound(pf + ps, pf + pe + 1, pf[pe]) - pf;
                i64 p_abs = pane_of(st.fl_lo) + (q - 1);
                i64 r = p_abs - st.pane_base;
                st_rts.push_back(
                    (r >= 0 && r < (i64)st.plts.size()) ? st.plts[r] : 0);
            }
            --st.queued;
        }
        ready_head += take;
        if (ready_head == ready.size()) {
            ready.clear();
            ready_head = 0;
        } else if (ready_head >= 4096 && 2 * ready_head >= ready.size()) {
            ready.erase(ready.begin(), ready.begin() + ready_head);
            ready_head = 0;
        }
        // evict consumed pane prefixes -- but never past the earliest
        // window still queued for the key (a partial take leaves
        // fired-but-unstaged windows whose extents must stay resident;
        // a key's windows are fired in order, so the first of them
        // starts a slide after the last one staged)
        for (KeyState* stp : touched) {
            KeyState& st = *stp;
            i64 keep_from = st.next_fire * slide;
            if (st.queued > 0)
                keep_from = std::min(keep_from, st.fl_hi - win + slide);
            i64 cut = pane_of(keep_from) - st.pane_base;
            i64 sz = (i64)st.pacc.size();
            if (cut <= 0) continue;
            if (cut > sz) cut = sz;
            st.pacc.erase(st.pacc.begin(), st.pacc.begin() + cut);
            st.pcnt.erase(st.pcnt.begin(), st.pcnt.begin() + cut);
            if (!is_tb) {
                st.plid.erase(st.plid.begin(), st.plid.begin() + cut);
                st.plts.erase(st.plts.begin(), st.plts.begin() + cut);
            }
            st.pane_base += cut;
        }
        // under watermarks, a key with every window fired and staged
        // holds nothing more: free it
        if (wm_mode) {
            for (KeyState* stp : touched)
                if (stp->queued == 0 && !stp->in_bucket)
                    to_evict.push_back(stp);
            evict_pending();
        }
        return take;
    }

    void eos() {
        if (wm_mode) {
            watermark(INT64_MAX);
            return;
        }
        for (KeyState& st : slab) {
            if (!st.live) continue;
            while (st.next_fire <= st.opened_max) {
                fire(st, st.key, st.next_fire);
                ++st.next_fire;
            }
        }
    }

    // -- checkpoint / resume ------------------------------------------
    // Versioned binary snapshot of all mutable state (per-key pane
    // rings + fired-but-unstaged descriptors).  The reference has no
    // checkpointing at all (SURVEY.md §5); this feeds the policy layer
    // in utils/checkpoint.py through the Python state_dict hooks.
    static constexpr i64 SNAP_MAGIC = 0x33'4E'46'57;  // "WFN3"
    static constexpr i64 WM_MAGIC = 0x4D'57'4E'46'57;  // "WFNWM"

    template <typename T>
    static void put(std::vector<unsigned char>& b, const T& v) {
        const unsigned char* p = reinterpret_cast<const unsigned char*>(&v);
        b.insert(b.end(), p, p + sizeof(T));
    }
    template <typename T>
    static void put_vec(std::vector<unsigned char>& b,
                        const std::vector<T>& v) {
        put<i64>(b, (i64)v.size());
        const unsigned char* p =
            reinterpret_cast<const unsigned char*>(v.data());
        b.insert(b.end(), p, p + v.size() * sizeof(T));
    }
    template <typename T>
    static bool get(const unsigned char*& p, const unsigned char* end,
                    T& v) {
        if (p + sizeof(T) > end) return false;
        std::memcpy(&v, p, sizeof(T));
        p += sizeof(T);
        return true;
    }
    template <typename T>
    static bool get_vec(const unsigned char*& p, const unsigned char* end,
                        std::vector<T>& v) {
        i64 n;
        if (!get(p, end, n) || n < 0) return false;
        // division-based check: p + n*sizeof(T) would overflow for a
        // corrupted length field (blob comes from on-disk files)
        if (n > (end - p) / (i64)sizeof(T)) return false;
        v.resize(n);
        std::memcpy(v.data(), p, n * sizeof(T));
        p += n * sizeof(T);
        return true;
    }

    std::vector<unsigned char> serialize() const {
        std::vector<unsigned char> b;
        put(b, SNAP_MAGIC);
        put(b, win); put(b, slide); put(b, delay);
        put(b, (i64)(is_tb ? 1 : 0));
        put(b, (i64)(renumber ? 1 : 0));
        put(b, (i64)kind);
        put(b, n_live);
        // in key order, so that a restored engine snapshots to the
        // same bytes
        std::vector<const KeyState*> order;
        order.reserve(n_live);
        for (const KeyState& st : slab)
            if (st.live) order.push_back(&st);
        std::sort(order.begin(), order.end(),
                  [](auto* x, auto* y) { return x->key < y->key; });
        for (const KeyState* stp : order) {
            const KeyState& st = *stp;
            put(b, st.key);
            put(b, st.next_fire); put(b, st.anchor);
            put(b, st.opened_max); put(b, st.max_id);
            put(b, st.pane_base); put(b, st.arrivals);
            put_vec(b, st.pacc);
            put_vec(b, st.pcnt);
            put_vec(b, st.plid);
            put_vec(b, st.plts);
        }
        put(b, (i64)n_ready());
        for (std::size_t i = ready_head; i < ready.size(); ++i) {
            const Desc& d = ready[i];
            put(b, d.key); put(b, d.lwid); put(b, d.start); put(b, d.end);
        }
        if (wm_mode) {
            // event-time section, present once a watermark has come:
            // the fired frontier and each bucket's keys in firing order
            put(b, WM_MAGIC);
            put(b, wm_next);
            put(b, (i64)buckets.size());
            for (const auto& [w, wait] : buckets) {
                put(b, w);
                put(b, (i64)wait.size());
                for (const KeyState* st : wait) put(b, st->key);
            }
        }
        return b;
    }

    bool deserialize(const unsigned char* p, i64 len) {
        const unsigned char* end = p + len;
        i64 magic, w, s, d, tb, rn, kd, nk;
        if (!get(p, end, magic) || magic != SNAP_MAGIC) return false;
        if (!get(p, end, w) || !get(p, end, s) || !get(p, end, d)
            || !get(p, end, tb) || !get(p, end, rn) || !get(p, end, kd))
            return false;
        // snapshot must match this engine's static configuration
        if (w != win || s != slide || d != delay
            || (tb != 0) != is_tb || (rn != 0) != renumber
            || kd != (i64)kind)
            return false;
        if (!get(p, end, nk) || nk < 0) return false;
        clear_keys();
        ready.clear();
        ready_head = 0;
        buckets.clear();
        to_evict.clear();
        wm_mode = false;
        wm_next = INT64_MIN;
        for (i64 i = 0; i < nk; ++i) {
            i64 key;
            if (!get(p, end, key) || find_state(key) != nullptr)
                return false;
            KeyState& st = state_of(key);
            if (!get(p, end, st.next_fire)
                || !get(p, end, st.anchor)
                || !get(p, end, st.opened_max) || !get(p, end, st.max_id)
                || !get(p, end, st.pane_base) || !get(p, end, st.arrivals)
                || !get_vec(p, end, st.pacc) || !get_vec(p, end, st.pcnt)
                || !get_vec(p, end, st.plid) || !get_vec(p, end, st.plts))
                return false;
            if (st.pcnt.size() != st.pacc.size()
                || st.plid.size() != st.plts.size())
                return false;
            // CB engines index plid/plts in lockstep with pacc on every
            // ingest; a snapshot with short ts-lane vectors would pass
            // the pairwise checks above and then write out of bounds
            if (!is_tb && st.plid.size() != st.pacc.size())
                return false;
        }
        i64 nr;
        if (!get(p, end, nr) || nr < 0) return false;
        for (i64 i = 0; i < nr; ++i) {
            Desc ds;
            if (!get(p, end, ds.key) || !get(p, end, ds.lwid)
                || !get(p, end, ds.start) || !get(p, end, ds.end))
                return false;
            ds.st = &state_of(ds.key);
            ++ds.st->queued;
            ready.push_back(ds);
        }
        if (p != end) {
            i64 wmm, nb;
            if (!get(p, end, wmm) || wmm != WM_MAGIC
                || !get(p, end, wm_next) || !get(p, end, nb) || nb < 0)
                return false;
            wm_mode = true;
            for (i64 i = 0; i < nb; ++i) {
                i64 w, n;
                if (!get(p, end, w) || !get(p, end, n) || n < 0)
                    return false;
                std::vector<KeyState*>& wait = buckets[w];
                for (i64 j = 0; j < n; ++j) {
                    i64 key;
                    if (!get(p, end, key)) return false;
                    KeyState* st = find_state(key);
                    if (st == nullptr || st->in_bucket || st->next_fire != w)
                        return false;
                    st->in_bucket = true;
                    wait.push_back(st);
                }
            }
        }
        return p == end;
    }
};

}  // namespace

extern "C" {

void* wfn_engine_new(i64 win, i64 slide, int is_tb, i64 delay,
                     int renumber, int kind) {
    return new Engine(win, slide, is_tb != 0, delay, renumber != 0,
                      static_cast<Kind>(kind));
}

void wfn_engine_free(void* e) { delete static_cast<Engine*>(e); }

// Ingest a columnar batch (keys need not be grouped); returns the
// number of ready (fired, unstaged) windows afterwards.
i64 wfn_engine_ingest(void* ep, const i64* keys, const i64* ids,
                      const i64* tss, const double* vals, i64 n) {
    Engine& e = *static_cast<Engine*>(ep);
    e.ingest_batch(keys, ids, tss, vals, n);
    return e.n_ready();
}

// f32 value column variant (no widening copy on the host side).
i64 wfn_engine_ingest_f32(void* ep, const i64* keys, const i64* ids,
                          const i64* tss, const float* vals, i64 n) {
    Engine& e = *static_cast<Engine*>(ep);
    e.ingest_batch(keys, ids, tss, vals, n);
    return e.n_ready();
}

// Fused synthesis + ingest of the declared synthetic law; returns the
// number of ready (fired, unstaged) windows afterwards.
i64 wfn_engine_synth_ingest(void* ep, i64 start, i64 n, i64 n_keys,
                            i64 vmod, double vscale, double voff) {
    Engine& e = *static_cast<Engine*>(ep);
    e.synth_ingest(start, n, n_keys, vmod, vscale, voff);
    return e.n_ready();
}

// Masked/tabled variant: mask is uint8[vmod] (entry 0 drops the event
// before the window op -- the folded form of a declared value-predicate
// Filter); vtab is an optional double[vmod] per-residue value table
// (sequentially-applied map chain).  Either may be null.
i64 wfn_engine_synth_ingest_masked(void* ep, i64 start, i64 n,
                                   i64 n_keys, i64 vmod, double vscale,
                                   double voff,
                                   const unsigned char* mask,
                                   const double* vtab) {
    Engine& e = *static_cast<Engine*>(ep);
    e.synth_ingest(start, n, n_keys, vmod, vscale, voff, mask, vtab);
    return e.n_ready();
}

i64 wfn_engine_ready(void* ep) {
    return static_cast<Engine*>(ep)->n_ready();
}

// Fire every window whose end is at or below the watermark ``wm`` (the
// first call switches the engine to event-time firing); returns the
// number of ready (fired, unstaged) windows afterwards.
i64 wfn_engine_watermark(void* ep, i64 wm) {
    Engine& e = *static_cast<Engine*>(ep);
    e.watermark(wm);
    return e.n_ready();
}

// Event-time counters: out = [watermarks, windows fired by them, keys
// evicted, keys live].
void wfn_engine_counters(void* ep, i64* out) {
    Engine& e = *static_cast<Engine*>(ep);
    out[0] = e.n_watermarks;
    out[1] = e.fired_wm;
    out[2] = e.evicted;
    out[3] = e.n_live;
}

i64 wfn_engine_ignored(void* ep) {
    return static_cast<Engine*>(ep)->ignored;
}

void wfn_engine_eos(void* ep) { static_cast<Engine*>(ep)->eos(); }

// Stage up to max_windows; returns B staged.  Pointers are valid until
// the next flush call.  `cnts` carries per-pane tuple counts (same
// layout as vals) for the MEAN kind and is empty otherwise.
i64 wfn_engine_flush(void* ep, i64 max_windows, double** vals, i64* n_vals,
                     double** cnts, i64* n_cnts,
                     i64** starts, i64** ends, i64** keys, i64** gwids,
                     i64** rts) {
    Engine& e = *static_cast<Engine*>(ep);
    i64 b = e.flush(max_windows);
    *vals = e.st_vals.data();
    *n_vals = (i64)e.st_vals.size();
    *cnts = e.st_cnts.data();
    *n_cnts = (i64)e.st_cnts.size();
    *starts = e.st_starts.data();
    *ends = e.st_ends.data();
    *keys = e.st_keys.data();
    *gwids = e.st_gwids.data();
    *rts = e.st_rts.data();
    return b;
}

// Snapshot the engine's mutable state.  First call with buf=nullptr to
// get the size; second call fills the caller's buffer.  Returns the
// blob size, or -1 when the provided buffer is too small.
i64 wfn_engine_serialize(void* ep, unsigned char* buf, i64 cap) {
    Engine& e = *static_cast<Engine*>(ep);
    std::vector<unsigned char> b = e.serialize();
    if (buf == nullptr) return (i64)b.size();
    if (cap < (i64)b.size()) return -1;
    std::memcpy(buf, b.data(), b.size());
    return (i64)b.size();
}

// Restore a snapshot; returns 1 on success, 0 on a malformed blob or a
// configuration mismatch (the engine is left cleared in that case).
int wfn_engine_deserialize(void* ep, const unsigned char* buf, i64 len) {
    Engine& e = *static_cast<Engine*>(ep);
    bool ok = e.deserialize(buf, len);
    if (!ok) {  // never leave partially-restored state behind
        e.buckets.clear();
        e.clear_keys();
        e.ready.clear();
        e.ready_head = 0;
        e.wm_mode = false;
        e.wm_next = INT64_MIN;
    }
    return ok ? 1 : 0;
}

}  // extern "C"

namespace {

// Ingest-plane pane pre-reduction (windflow_tpu/ingest/coalesce.py):
// collapse one columnar chunk to per-(key, pane) sum partials over a
// dense grid, fused min/max scan + accumulate in two passes.  Values
// fold in arrival order, exactly like the engine's own pane ring.
// floor division (floordiv, above): the Python fallback floors, and a
// negative timestamp must land in its containing pane, not pane 0

template <typename V>
i64 pane_prereduce_impl(const i64* keys, const i64* tss, const V* vals,
                        i64 n, i64 pane, i64 cap, i64* out_keys,
                        i64* out_panes, double* out_sums) {
    if (n <= 0) return 0;
    i64 kmin = keys[0], kmax = keys[0], bmin = tss[0], bmax = tss[0];
    for (i64 i = 1; i < n; ++i) {
        const i64 k = keys[i], t = tss[i];
        if (k < kmin) kmin = k; else if (k > kmax) kmax = k;
        if (t < bmin) bmin = t; else if (t > bmax) bmax = t;
    }
    bmin = floordiv(bmin, pane);
    bmax = floordiv(bmax, pane);
    // range spans in UNSIGNED arithmetic: wire-fed key/ts columns can
    // legitimately span most of int64 (codec frames are unvalidated),
    // and (kmax - kmin + 1) in signed math would be UB the optimizer
    // may exploit to delete the guards below
    const uint64_t ukr = (uint64_t)kmax - (uint64_t)kmin;
    const uint64_t ubr = (uint64_t)bmax - (uint64_t)bmin;
    // sparse key/pane domain: a dense grid would be allocation-bound.
    // Comparisons are span-based (no +1, no product) so nothing wraps.
    if (ukr >= (uint64_t)(n + 1024)) return -1;
    const i64 krange = (i64)ukr + 1;
    if (ubr >= (uint64_t)((4 * n + 4096) / krange)) return -1;
    const i64 brange = (i64)ubr + 1;
    const i64 grid = krange * brange;
    std::vector<double> sums((size_t)grid, 0.0);
    std::vector<i64> counts((size_t)grid, 0);
    for (i64 i = 0; i < n; ++i) {
        const i64 idx = (floordiv(tss[i], pane) - bmin) * krange
                        + (keys[i] - kmin);
        sums[(size_t)idx] += (double)vals[i];
        counts[(size_t)idx] += 1;
    }
    i64 m = 0;
    for (i64 idx = 0; idx < grid; ++idx) {  // pane-major ascending order
        if (counts[(size_t)idx] == 0) continue;
        if (m >= cap) return -2;            // caller retries with more room
        out_keys[m] = idx % krange + kmin;
        out_panes[m] = (idx / krange + bmin) * pane;
        out_sums[m] = sums[(size_t)idx];
        ++m;
    }
    return m;
}

}  // namespace

extern "C" {

// Returns the number of partials written, -1 when the key/pane domain
// is too sparse for the dense grid (caller falls back), or -2 when
// `cap` is too small (caller retries with a larger buffer).
i64 wfn_pane_prereduce(const i64* keys, const i64* tss, const double* vals,
                       i64 n, i64 pane, i64 cap, i64* out_keys,
                       i64* out_panes, double* out_sums) {
    return pane_prereduce_impl(keys, tss, vals, n, pane, cap, out_keys,
                               out_panes, out_sums);
}

i64 wfn_pane_prereduce_f32(const i64* keys, const i64* tss,
                           const float* vals, i64 n, i64 pane, i64 cap,
                           i64* out_keys, i64* out_panes,
                           double* out_sums) {
    return pane_prereduce_impl(keys, tss, vals, n, pane, cap, out_keys,
                               out_panes, out_sums);
}

}  // extern "C"
