// The benchmark's frozen copy of the NEXMark and YSB event generators
// (flock_tpu_torch/native/flockgen.cpp, itself a copy of the reference
// engine's generator), kept here so that later changes to the program cannot
// change the benchmark's input.
//
// The RNG, the configuration and the per-event draws below are the copy's,
// unchanged: every NEXMark event is a pure function of its event id
// (Xoshiro256++ seeded per event id through SplitMix64, Lemire range
// sampling, f32 timestamp and price math).  Two things differ, and
// flockbench/configs/*.json list them under "assumed":
//
// * A run's seed enters every event's RNG seed: the seed of event `id` is
//   `id ^ splitmix64(seed)` (seed 0 keeps the copy's own stream).  Event
//   kinds, ids and timestamps follow from the event number alone, so every
//   seed gives the same sizes and arrivals and only the draws (hot or cold
//   auction, bidder, price) change.
// * One call generates one epoch (one second of event time) of one generator
//   partition, from the event-number range that the copy's loop gives that
//   epoch, so that epochs generate in parallel.
//
// YSB: each epoch holds exactly `events_per_second` ad events, event j of
// epoch e at e*1000 + j*1000/eps ms, drawn (ad, ad type, event type) as the
// copy draws them from an RNG that is seeded per epoch from the run's seed
// and the epoch (the copy reseeds every epoch with 0xDEAD).
//
// Build: g++ -O3 -shared -fPIC -o libfbgen.so flockgen.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Xoshiro256pp {
  uint64_t s[4];

  explicit Xoshiro256pp(uint64_t seed) {
    // rand 0.8.3 seed_from_u64: SplitMix64 expansion.
    uint64_t state = seed;
    for (int i = 0; i < 4; i++) {
      state += 0x9e3779b97f4a7c15ULL;
      uint64_t z = state;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }

  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  inline uint64_t next_u64() {
    uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  inline uint32_t next_u32() { return (uint32_t)(next_u64() >> 32); }

  // rand 0.8.3 UniformInt::sample_single_inclusive, 64-bit flavor (usize).
  inline uint64_t gen_range_u64(uint64_t n) {
    uint64_t zone = (n << __builtin_clzll(n)) - 1;
    for (;;) {
      uint64_t v = next_u64();
      __uint128_t m = (__uint128_t)v * (__uint128_t)n;
      uint64_t lo = (uint64_t)m;
      if (lo <= zone) return (uint64_t)(m >> 64);
    }
  }

  // 32-bit flavor (i32/u32 ranges and SliceRandom::choose via gen_index).
  inline uint32_t gen_range_u32(uint32_t n) {
    uint32_t zone = (n << __builtin_clz(n)) - 1;
    for (;;) {
      uint32_t v = next_u32();
      uint64_t m = (uint64_t)v * (uint64_t)n;
      uint32_t lo = (uint32_t)m;
      if (lo <= zone) return (uint32_t)(m >> 32);
    }
  }

  // Standard distribution for f32: 24 high bits of next_u32 scaled by 2^-24.
  inline float gen_f32() {
    return (float)(next_u32() >> 8) * (1.0f / 16777216.0f);
  }
};

struct Config {
  int64_t active_people;
  int64_t in_flight_auctions;
  int64_t out_of_order_group_size;
  int64_t hot_seller_ratio;
  int64_t hot_auction_ratio;
  int64_t hot_bidder_ratio;
  int64_t first_event_id;
  int64_t first_event_number;
  int64_t base_time;
  int64_t num_categories;
  int64_t auction_id_lead;
  int64_t hot_seller_ratio_2;
  int64_t hot_auction_ratio_2;
  int64_t hot_bidder_ratio_2;
  int64_t person_proportion;
  int64_t auction_proportion;
  int64_t bid_proportion;
  int64_t first_auction_id;
  int64_t first_person_id;
  int64_t first_category_id;
  int64_t person_id_lead;
  int64_t num_event_generators;
  int64_t events_per_second;

  int64_t denom() const {
    return person_proportion + auction_proportion + bid_proportion;
  }
  float delay() const {
    // config.rs:171-192, single-rate path: all math in f32.
    return (1000000.0f / (float)events_per_second) * (float)num_event_generators;
  }
  int64_t event_timestamp(int64_t event_number) const {
    // config.rs:248-252 (single-rate).
    float off = ((float)event_number * delay()) / 1000.0f;
    return base_time + (int64_t)roundf(off);
  }
  int64_t next_adjusted_event(int64_t events_so_far) const {
    int64_t n = out_of_order_group_size;
    int64_t e = first_event_number + events_so_far;
    return (e / n) * n + (e * 953) % n;
  }
};

inline int64_t person_last_id(int64_t id, const Config& c) {
  int64_t epoch = id / c.denom();
  int64_t offset = id % c.denom();
  if (c.person_proportion <= offset) offset = c.person_proportion - 1;
  return epoch * c.person_proportion + offset;
}

inline int64_t person_next_id(int64_t id, Xoshiro256pp& rng, const Config& c) {
  int64_t people = person_last_id(id, c) + 1;
  int64_t active = std::min(people, c.active_people);
  return people - active +
         (int64_t)rng.gen_range_u64((uint64_t)(active + c.person_id_lead));
}

inline int64_t auction_last_id(int64_t id, const Config& c) {
  int64_t epoch = id / c.denom();
  int64_t offset = id % c.denom();
  if (offset < c.person_proportion) {
    epoch -= 1;
    offset = c.auction_proportion - 1;
  } else if (c.person_proportion + c.auction_proportion <= offset) {
    offset = c.auction_proportion - 1;
  } else {
    offset -= c.person_proportion;
  }
  return epoch * c.auction_proportion + offset;
}

inline int64_t auction_next_id(int64_t id, Xoshiro256pp& rng, const Config& c) {
  int64_t max_a = auction_last_id(id, c);
  int64_t min_a = max_a < c.in_flight_auctions ? 0 : max_a - c.in_flight_auctions;
  return min_a + (int64_t)rng.gen_range_u64(
                     (uint64_t)(max_a - min_a + 1 + c.auction_id_lead));
}

// event.rs:34-51 — consume the RNG draws of gen_string; optionally write the
// trimmed string (append '\0') into out/out_len.
inline void gen_string(Xoshiro256pp& rng, uint64_t max, char* out, int* out_len) {
  uint64_t len = 3 + rng.gen_range_u64(max - 3);
  int n = 0;
  for (uint64_t i = 0; i < len; i++) {
    if (rng.gen_range_u32(13) == 0) {
      if (out) out[n] = ' ';
      n++;
    } else {
      uint32_t ch = rng.gen_range_u32(26);
      if (out) out[n] = (char)('a' + ch);
      n++;
    }
  }
  if (out) {
    // trim leading/trailing spaces (Rust str::trim on ASCII space)
    int start = 0, end = n;
    while (start < end && out[start] == ' ') start++;
    while (end > start && out[end - 1] == ' ') end--;
    if (start > 0) memmove(out, out + start, end - start);
    *out_len = end - start;
  }
}

inline int64_t gen_price(Xoshiro256pp& rng) {
  // event.rs:53-56 in f32; powf/roundf match Rust's lowering on linux-gnu.
  float u = rng.gen_f32();
  return (int64_t)roundf(powf(10.0f, u * 6.0f) * 100.0f);
}

}  // namespace

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// The copy's loop epoch of the partition's `events`-th event.
inline int64_t loop_epoch(const Config& c, int64_t events) {
  return (c.event_timestamp(events + c.first_event_id) - c.base_time) / 1000;
}

}  // namespace

extern "C" {

// The first event number (of one generator partition's own count) whose loop
// epoch is `epoch` or later.  Epochs are non-decreasing in the event number.
int64_t fb_nexmark_epoch_start(const int64_t* cfg_arr, int64_t epoch) {
  Config c;
  memcpy(&c, cfg_arr, sizeof(Config));
  int64_t lo = 0, hi = 1;
  while (loop_epoch(c, hi) < epoch) hi *= 2;
  while (lo < hi) {
    int64_t mid = lo + (hi - lo) / 2;
    if (loop_epoch(c, mid) < epoch) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The events numbered [ev_lo, ev_hi) of generator `partition`, with the
// run's `seed` mixed into every event's RNG seed.  Bodies as the copy's
// fg_nexmark_generate, without the epoch tags.  Returns 0, or -1 when a
// capacity is too small (the counts are written regardless).
int fb_nexmark_range(
    const int64_t* cfg_arr, uint64_t seed, int64_t partition,
    int64_t ev_lo, int64_t ev_hi,
    int32_t* p_id, int32_t* p_name, int32_t* p_city, int32_t* p_state,
    int64_t* p_ts, int64_t p_cap, int64_t* p_n,
    int32_t* a_id, int32_t* a_ib, int32_t* a_res, int64_t* a_ts, int64_t* a_exp,
    int32_t* a_seller, int32_t* a_cat, int64_t a_cap, int64_t* a_n,
    int32_t* b_auc, int32_t* b_bid, int32_t* b_price, int64_t* b_ts,
    int64_t b_cap, int64_t* b_n) {
  Config c;
  memcpy(&c, cfg_arr, sizeof(Config));

  const int64_t denom = c.denom();
  const int64_t id_offset = (100000 / c.num_event_generators) * partition;
  const int64_t n_first = 11, n_last = 9, n_cities = 10, n_states = 6;
  const uint64_t mix = seed ? splitmix64(seed) : 0;

  int64_t np = 0, na = 0, nb = 0;
  int overflow = 0;

  for (int64_t events = ev_lo; events < ev_hi; events++) {
    int64_t adj = c.next_adjusted_event(events);
    int64_t rem = adj % denom;
    int64_t ts = c.event_timestamp(adj);
    int64_t id = c.first_event_id + adj + id_offset;
    Xoshiro256pp rng((uint64_t)id ^ mix);

    if (rem < c.person_proportion) {
      uint32_t first = rng.gen_range_u32((uint32_t)n_first);
      uint32_t last = rng.gen_range_u32((uint32_t)n_last);
      gen_string(rng, 7, nullptr, nullptr);
      gen_string(rng, 5, nullptr, nullptr);
      for (int i = 0; i < 4; i++) rng.gen_range_u32(10000);
      uint32_t city = rng.gen_range_u32((uint32_t)n_cities);
      uint32_t state = rng.gen_range_u32((uint32_t)n_states);
      if (np < p_cap) {
        p_id[np] = (int32_t)(person_last_id(id, c) + c.first_person_id);
        p_name[np] = (int32_t)(first * n_last + last);
        p_city[np] = (int32_t)city;
        p_state[np] = (int32_t)state;
        p_ts[np] = ts;
      } else {
        overflow = 1;
      }
      np++;
    } else if (rem < c.person_proportion + c.auction_proportion) {
      int64_t initial_bid = gen_price(rng);
      int64_t seller;
      if (rng.gen_range_u64((uint64_t)c.hot_seller_ratio) > 0) {
        seller = (person_last_id(id, c) / c.hot_seller_ratio_2) * c.hot_seller_ratio_2;
      } else {
        seller = person_next_id(id, rng, c);
      }
      gen_string(rng, 20, nullptr, nullptr);
      gen_string(rng, 100, nullptr, nullptr);
      int64_t reserve = initial_bid + gen_price(rng);
      int64_t current = c.next_adjusted_event(events);
      int64_t events_for_auctions =
          (c.in_flight_auctions * denom) / c.auction_proportion;
      int64_t horizon = c.event_timestamp(current + events_for_auctions) - ts;
      int64_t length =
          1 + (int64_t)rng.gen_range_u64((uint64_t)std::max<int64_t>(horizon * 2, 1));
      int64_t category =
          c.first_category_id + (int64_t)rng.gen_range_u64((uint64_t)c.num_categories);
      if (na < a_cap) {
        a_id[na] = (int32_t)(auction_last_id(id, c) + c.first_auction_id);
        a_ib[na] = (int32_t)initial_bid;
        a_res[na] = (int32_t)reserve;
        a_ts[na] = ts;
        a_exp[na] = ts + length;
        a_seller[na] = (int32_t)(seller + c.first_person_id);
        a_cat[na] = (int32_t)category;
      } else {
        overflow = 1;
      }
      na++;
    } else {
      int64_t auction;
      if (rng.gen_range_u64((uint64_t)c.hot_auction_ratio) > 0) {
        auction = (auction_last_id(id, c) / c.hot_auction_ratio_2) * c.hot_auction_ratio_2;
      } else {
        auction = auction_next_id(id, rng, c);
      }
      int64_t bidder;
      if (rng.gen_range_u64((uint64_t)c.hot_bidder_ratio) > 0) {
        bidder = (person_last_id(id, c) / c.hot_bidder_ratio_2) * c.hot_bidder_ratio_2 + 1;
      } else {
        bidder = person_next_id(id, rng, c);
      }
      int64_t price = gen_price(rng);
      if (nb < b_cap) {
        b_auc[nb] = (int32_t)(auction + c.first_auction_id);
        b_bid[nb] = (int32_t)(bidder + c.first_person_id);
        b_price[nb] = (int32_t)price;
        b_ts[nb] = ts;
      } else {
        overflow = 1;
      }
      nb++;
    }
  }

  *p_n = np;
  *a_n = na;
  *b_n = nb;
  return overflow ? -1 : 0;
}

// One YSB epoch: exactly `events_per_second` ad events.
void fb_ysb_epoch(uint64_t seed, int64_t epoch, int64_t events_per_second,
                  int64_t campaigns, int64_t ads, int32_t* ad_id,
                  int32_t* ad_type, int32_t* event_type, int64_t* event_time) {
  const uint64_t map_len = (uint64_t)(campaigns * ads);
  Xoshiro256pp rng(splitmix64(seed) ^ splitmix64(0xDEADULL + (uint64_t)epoch));
  for (int64_t j = 0; j < events_per_second; j++) {
    ad_id[j] = (int32_t)rng.gen_range_u64(map_len);
    ad_type[j] = (int32_t)rng.gen_range_u32(5);
    event_type[j] = (int32_t)rng.gen_range_u32(3);
    event_time[j] = epoch * 1000 + (j * 1000) / events_per_second;
  }
}

}  // extern "C"
