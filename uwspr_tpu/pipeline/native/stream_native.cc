// Native multichannel streaming windower — the host runtime around the
// XLA compute path.
//
// The reference's runtime is GNU Radio's C++ scheduler: per-block threads
// moving samples through ring buffers, with the window builder block
// keeping a boost::circular_buffer of capacity C*fl and emitting a
// 45000-sample window every 9 s hop
// (lib/sliding_window_stream_to_pdu_impl.cc:65,97-138).
//
// Equivalent here: one preallocated planar ring buffer per channel
// (float32 I/Q planes — the host<->device ABI), lazy window extraction that copies ring -> batched (W, 2, fl)
// device-feed buffer with no intermediate window objects, and OpenMP
// across channels for both ingest and extraction. The "scheduler" above
// this (uwspr_tpu.pipeline.native_stream.BatchedStreamDecoder) forms
// fixed-width window batches for the compiled XLA program instead of
// handing windows to block threads.
//
// Semantics match pipeline.stream.SlidingWindow exactly (tested):
//   push:  append samples; if buffered > capacity drop the oldest
//          (circular-buffer overflow);
//   ready: (avail - fl)/hop + 1 windows once avail >= fl;
//   pop:   copy [head, head+fl), advance head by hop.
//
// Build: g++ -O3 -fopenmp -shared -fPIC (see native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Channel {
    std::vector<float> re;     // ring plane, capacity cap
    std::vector<float> im;
    int64_t head = 0;          // ring index of oldest buffered sample
    int64_t avail = 0;         // buffered sample count (<= cap)
    int64_t dropped = 0;       // samples lost to overflow (observability)
};

struct Stream {
    int n_channels;
    int64_t fl;                // window length, samples
    int64_t hop;               // window advance, samples
    int64_t cap;               // ring capacity, samples (C * fl)
    std::vector<Channel> ch;
};

inline int64_t ready_count(const Stream* s, int c) {
    int64_t a = s->ch[c].avail;
    return a >= s->fl ? (a - s->fl) / s->hop + 1 : 0;
}

// copy n samples from the ring starting at ring index `from` into dst
// (contiguous), splitting at the wrap point.
inline void ring_copy(const std::vector<float>& plane, int64_t cap,
                      int64_t from, int64_t n, float* dst) {
    int64_t start = from % cap;
    int64_t first = std::min(n, cap - start);
    std::memcpy(dst, plane.data() + start, first * sizeof(float));
    if (n > first)
        std::memcpy(dst + first, plane.data(), (n - first) * sizeof(float));
}

}  // namespace

extern "C" {

void* uwspr_stream_create(int n_channels, int64_t fl, int64_t hop,
                          int capacity_windows) {
    auto* s = new Stream;
    s->n_channels = n_channels;
    s->fl = fl;
    s->hop = hop;
    s->cap = static_cast<int64_t>(capacity_windows) * fl;
    s->ch.resize(n_channels);
    for (auto& c : s->ch) {
        c.re.assign(s->cap, 0.0f);
        c.im.assign(s->cap, 0.0f);
    }
    return s;
}

void uwspr_stream_destroy(void* h) { delete static_cast<Stream*>(h); }

// Append n samples per channel. iq is planar (n_channels, 2, n) float32.
// Overflow drops the oldest samples (reference circular-buffer semantics).
void uwspr_stream_push(void* h, const float* iq, int64_t n) {
    auto* s = static_cast<Stream*>(h);
    const int64_t cap = s->cap;
#pragma omp parallel for schedule(static)
    for (int c = 0; c < s->n_channels; ++c) {
        Channel& ch = s->ch[c];
        const float* src_re = iq + static_cast<int64_t>(c) * 2 * n;
        const float* src_im = src_re + n;
        int64_t from = 0;
        if (n > cap) {                       // push alone overflows the ring
            ch.dropped += ch.avail + (n - cap);
            from = n - cap;
            ch.head = 0;
            ch.avail = 0;
        }
        int64_t m = n - from;                // samples actually kept
        int64_t tail = (ch.head + ch.avail) % cap;
        int64_t first = std::min(m, cap - tail);
        std::memcpy(ch.re.data() + tail, src_re + from,
                    first * sizeof(float));
        std::memcpy(ch.im.data() + tail, src_im + from,
                    first * sizeof(float));
        if (m > first) {
            std::memcpy(ch.re.data(), src_re + from + first,
                        (m - first) * sizeof(float));
            std::memcpy(ch.im.data(), src_im + from + first,
                        (m - first) * sizeof(float));
        }
        ch.avail += m;
        if (ch.avail > cap) {                // drop oldest buffered samples
            int64_t over = ch.avail - cap;
            ch.dropped += over;
            ch.head = (ch.head + over) % cap;
            ch.avail = cap;
        }
    }
}

int64_t uwspr_stream_ready(void* h) {
    auto* s = static_cast<Stream*>(h);
    int64_t total = 0;
    for (int c = 0; c < s->n_channels; ++c) total += ready_count(s, c);
    return total;
}

int64_t uwspr_stream_dropped(void* h) {
    auto* s = static_cast<Stream*>(h);
    int64_t total = 0;
    for (const auto& c : s->ch) total += c.dropped;
    return total;
}

int64_t uwspr_stream_buffered(void* h, int channel) {
    return static_cast<Stream*>(h)->ch[channel].avail;
}

// Extract up to max_windows ready windows, round-robin across channels in
// channel order (all of channel 0's ready windows, then channel 1's, ...),
// directly into the batched device-feed buffer out (max_windows, 2, fl)
// float32. out_channels[w] records the source channel of row w. Returns
// the number of windows written.
int64_t uwspr_stream_pop_batch(void* h, float* out, int32_t* out_channels,
                               int64_t max_windows) {
    auto* s = static_cast<Stream*>(h);
    const int64_t fl = s->fl, hop = s->hop, cap = s->cap;
    // plan: (channel, window-ordinal) per output row, so the copies can
    // run fully parallel afterwards
    struct Job { int c; int64_t start; };
    std::vector<Job> jobs;
    jobs.reserve(static_cast<size_t>(std::min<int64_t>(max_windows, 1024)));
    for (int c = 0; c < s->n_channels
         && static_cast<int64_t>(jobs.size()) < max_windows; ++c) {
        Channel& ch = s->ch[c];
        int64_t take = std::min(ready_count(s, c),
                                max_windows - static_cast<int64_t>(jobs.size()));
        for (int64_t w = 0; w < take; ++w)
            jobs.push_back({c, ch.head + w * hop});
        ch.head = (ch.head + take * hop) % cap;
        ch.avail -= take * hop;
    }
    const int64_t n = static_cast<int64_t>(jobs.size());
#pragma omp parallel for schedule(static)
    for (int64_t w = 0; w < n; ++w) {
        const Job& j = jobs[w];
        float* dst = out + w * 2 * fl;
        ring_copy(s->ch[j.c].re, cap, j.start, fl, dst);
        ring_copy(s->ch[j.c].im, cap, j.start, fl, dst + fl);
        out_channels[w] = j.c;
    }
    return n;
}

int uwspr_stream_num_threads(void) {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
