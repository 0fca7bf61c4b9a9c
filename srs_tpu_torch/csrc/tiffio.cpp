// The port's native IO: striped TIFF writer + fast content hash. The
// writer streams the canvas to disk in row strips with zlib (Adobe
// Deflate, TIFF compression tag 8), 8- and 16-bit RGB.
//
// native/tiffio.cpp, the JAX package's writer, less its one-call
// srs_write_tiff and with counters added: the same strips, the same
// deflate pool and byte-identical files, plus one entry point that reports
// what the writer spent its time on. The port builds this file into its
// own build directory (srs_tpu_torch/io/native.py, utils/build.py);
// native/ stays the JAX package's.
//
// Exposed C ABI (ctypes, see srs_tpu_torch/io/native.py):
//   uint64_t srs_hash64(const uint8_t* data, int64_t len);
//   void*   srs_tiff_begin(...); srs_tiff_write_rows(...); srs_tiff_end(...);
//   int64_t srs_tiff_end_stats(void* handle, double* out, int64_t n);
//
// srs_tiff_end_stats ends the stream as srs_tiff_end does and fills up to
// n of the writer's counters into out, in this order: deflate CPU seconds
// summed over the strips' threads, seconds blocked in write_rows' join-all
// barrier, seconds in end's join, seconds assembling and writing the
// file, strips, raw bytes, deflated (stored) bytes, and the pool size
// (max_workers). srs_tiff_end is srs_tiff_end_stats with no counters.
//
// Error codes: -1 bad shape, -2 bad depth, -3 deflate failure,
// -4 open failure, -5 short write, -6 layout exceeds 4 GB (classic TIFF
// offsets are uint32; emit smaller strips/bands or add BigTIFF upstream).
//
// Build: g++ -O3 -fPIC -std=c++17 -pthread -shared -o libsrs_tiff.so tiffio.cpp -lz

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

// Little-endian scalar write helpers.
template <typename T>
void put(std::vector<uint8_t>& buf, T v) {
  for (size_t i = 0; i < sizeof(T); ++i) buf.push_back((v >> (8 * i)) & 0xff);
}

struct IfdEntry {
  uint16_t tag;
  uint16_t type;  // 3 = SHORT, 4 = LONG
  uint32_t count;
  uint32_t value;
};

void put_entry(std::vector<uint8_t>& buf, const IfdEntry& e) {
  put<uint16_t>(buf, e.tag);
  put<uint16_t>(buf, e.type);
  put<uint32_t>(buf, e.count);
  if (e.type == 3 && e.count == 1) {
    put<uint16_t>(buf, static_cast<uint16_t>(e.value));
    put<uint16_t>(buf, 0);
  } else {
    put<uint32_t>(buf, e.value);
  }
}

bool deflate_level(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                   int level) {
  uLongf bound = compressBound(n);
  out.resize(bound);
  if (compress2(out.data(), &bound, src, n, level) != Z_OK) return false;
  out.resize(bound);
  return true;
}

// Assemble header + external arrays + strip data + IFD and write the file.
// Shared by the batch and streaming writers. Cursor math is int64 with an
// explicit classic-TIFF 4 GB limit check (offsets are uint32 on disk).
int64_t assemble_and_write(const std::string& path,
                           const std::vector<std::vector<uint8_t>>& strips,
                           int64_t h, int64_t w, int64_t channels,
                           int64_t bit_depth, bool compressed,
                           int64_t rows_per_strip) {
  const int64_t num_strips = static_cast<int64_t>(strips.size());
  std::vector<uint32_t> strip_sizes(num_strips);
  for (int64_t s = 0; s < num_strips; ++s)
    strip_sizes[s] = static_cast<uint32_t>(strips[s].size());

  std::vector<uint8_t> head;
  head.push_back('I');
  head.push_back('I');
  put<uint16_t>(head, 42);
  const size_t ifd_off_pos = head.size();
  put<uint32_t>(head, 0);  // IFD offset placeholder

  // External arrays after the 8-byte header:
  // [bits array][strip offsets][strip sizes][strip data...][IFD].
  // TIFF inline rule: entry data of <= 4 bytes lives IN the value field,
  // so two SHORTs (channels == 2) pack inline as bit_depth | bit_depth<<16
  // and only channels >= 3 need the external bits array.
  int64_t cursor = 8;
  const int64_t bits_off = cursor;
  const bool needs_bits_array = channels > 2;
  if (needs_bits_array) cursor += 2 * channels;
  const int64_t offsets_off = cursor;
  const bool arrays_external = num_strips > 1;
  if (arrays_external) cursor += 4 * num_strips;
  const int64_t sizes_off = cursor;
  if (arrays_external) cursor += 4 * num_strips;
  const int64_t data_off = cursor;

  std::vector<uint32_t> strip_offsets(num_strips);
  {
    int64_t o = data_off;
    for (int64_t s = 0; s < num_strips; ++s) {
      strip_offsets[s] = static_cast<uint32_t>(o);
      o += strip_sizes[s];
    }
    cursor = o;
  }
  const int64_t ifd_off = cursor;
  const int64_t ifd_bytes = 2 + 12 * 11 + 4;  // upper bound on entry count
  if (ifd_off + ifd_bytes > 0xFFFFFFFFLL) return -6;  // classic TIFF limit

  head[ifd_off_pos + 0] = ifd_off & 0xff;
  head[ifd_off_pos + 1] = (ifd_off >> 8) & 0xff;
  head[ifd_off_pos + 2] = (ifd_off >> 16) & 0xff;
  head[ifd_off_pos + 3] = (ifd_off >> 24) & 0xff;

  std::vector<uint8_t> arrays;
  if (needs_bits_array)
    for (int64_t c = 0; c < channels; ++c)
      put<uint16_t>(arrays, static_cast<uint16_t>(bit_depth));
  if (arrays_external) {
    for (int64_t s = 0; s < num_strips; ++s) put<uint32_t>(arrays, strip_offsets[s]);
    for (int64_t s = 0; s < num_strips; ++s) put<uint32_t>(arrays, strip_sizes[s]);
  }

  std::vector<IfdEntry> entries = {
      {256, 4, 1, static_cast<uint32_t>(w)},                      // ImageWidth
      {257, 4, 1, static_cast<uint32_t>(h)},                      // ImageLength
      {258, 3, static_cast<uint32_t>(channels),
       needs_bits_array
           ? static_cast<uint32_t>(bits_off)
           : (channels == 2
                  ? static_cast<uint32_t>(bit_depth | (bit_depth << 16))
                  : static_cast<uint32_t>(bit_depth))},           // BitsPerSample
      {259, 3, 1, compressed ? 8u : 1u},                          // Compression
      {262, 3, 1, channels >= 3 ? 2u : 1u},                       // Photometric
      {273, 4, static_cast<uint32_t>(num_strips),
       arrays_external ? static_cast<uint32_t>(offsets_off)
                       : strip_offsets[0]},                       // StripOffsets
      {277, 3, 1, static_cast<uint32_t>(channels)},               // SamplesPerPixel
      {278, 4, 1, static_cast<uint32_t>(rows_per_strip)},         // RowsPerStrip
      {279, 4, static_cast<uint32_t>(num_strips),
       arrays_external ? static_cast<uint32_t>(sizes_off)
                       : strip_sizes[0]},                         // StripByteCounts
      {284, 3, 1, 1},                                             // PlanarConfig
  };
  // LA / RGBA carry one extra (unassociated alpha) sample — required by
  // readers (PIL refuses 2/4-channel TIFFs without ExtraSamples).
  if (channels == 2 || channels == 4)
    entries.push_back({338, 3, 1, 2});                            // ExtraSamples
  std::vector<uint8_t> ifd;
  put<uint16_t>(ifd, static_cast<uint16_t>(entries.size()));
  for (const auto& e : entries) put_entry(ifd, e);
  put<uint32_t>(ifd, 0);  // next IFD

  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return -4;
  int64_t total = 0;
  auto write_all = [&](const uint8_t* p, size_t n) -> bool {
    if (n == 0) return true;
    if (std::fwrite(p, 1, n, f) != n) return false;
    total += static_cast<int64_t>(n);
    return true;
  };
  bool ok = write_all(head.data(), head.size()) &&
            write_all(arrays.data(), arrays.size());
  for (int64_t s = 0; ok && s < num_strips; ++s)
    ok = write_all(strips[s].data(), strips[s].size());
  if (ok) ok = write_all(ifd.data(), ifd.size());
  std::fclose(f);
  return ok ? total : -5;
}

int64_t strip_rows(int64_t h, int64_t row_bytes) {
  int64_t rows = (1 << 20) / row_bytes;  // ~1 MB strips
  if (rows < 1) rows = 1;
  if (rows > h) rows = h;
  return rows;
}

}  // namespace

extern "C" {

// FNV-1a 64-bit — content addressing for the tile store (replaces md5 file
// hashing, reference tiling:506-520, where cryptographic strength is
// unnecessary).
uint64_t srs_hash64(const uint8_t* data, int64_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (int64_t i = 0; i < len; ++i) {
    h ^= data[i];
    h *= 1099511628211ULL;
  }
  return h;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming writer: rows arrive incrementally (e.g. banded device fetches);
// strips compress on a thread pool so deflate hides under the transfer.
// ---------------------------------------------------------------------------

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <ctime>
#include <mutex>
#include <thread>

namespace {

int64_t steady_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// CPU time of the calling thread: a deflate thread's busy time, which does
// not grow when more threads than cores share the host.
int64_t thread_cpu_ns() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

size_t max_workers() {
  return std::max(2u, std::thread::hardware_concurrency());
}

struct StreamCtx {
  std::string path;
  int64_t h, w, channels, bit_depth, compress, level;
  int64_t rows_per_strip = 0;
  int64_t num_strips = 0;
  int64_t rows_received = 0;
  std::vector<uint8_t> pending;  // partial strip buffer
  std::vector<std::vector<uint8_t>> strips;
  std::vector<std::thread> workers;
  std::atomic<int> errors{0};
  // Counters read by srs_tiff_end_stats.
  std::atomic<int64_t> deflate_ns{0};
  int64_t barrier_ns = 0, strips_done = 0, raw_bytes = 0;

  int64_t row_bytes() const { return w * channels * bit_depth / 8; }
};

}  // namespace

extern "C" {

void* srs_tiff_begin(const char* path, int64_t h, int64_t w, int64_t channels,
                     int64_t bit_depth, int64_t compress, int64_t level) {
  if (h <= 0 || w <= 0 || channels < 1 || channels > 4) return nullptr;
  if (bit_depth != 8 && bit_depth != 16) return nullptr;
  auto* ctx = new StreamCtx();
  ctx->path = path;
  ctx->h = h;
  ctx->w = w;
  ctx->channels = channels;
  ctx->bit_depth = bit_depth;
  ctx->compress = compress;
  ctx->level = level > 0 ? level : 1;
  ctx->rows_per_strip = strip_rows(h, ctx->row_bytes());
  ctx->num_strips = (h + ctx->rows_per_strip - 1) / ctx->rows_per_strip;
  ctx->strips.resize(ctx->num_strips);
  return ctx;
}

int64_t srs_tiff_write_rows(void* handle, const uint8_t* data, int64_t nrows) {
  auto* ctx = static_cast<StreamCtx*>(handle);
  if (!ctx || ctx->rows_received + nrows > ctx->h) return -1;
  const int64_t rb = ctx->row_bytes();
  ctx->pending.insert(ctx->pending.end(), data, data + nrows * rb);
  ctx->rows_received += nrows;
  const int64_t strip_bytes = ctx->rows_per_strip * rb;
  while (static_cast<int64_t>(ctx->pending.size()) >= strip_bytes ||
         (ctx->rows_received == ctx->h && !ctx->pending.empty())) {
    const size_t take = std::min<size_t>(ctx->pending.size(), strip_bytes);
    const int64_t strip_idx =
        (ctx->rows_received * rb - static_cast<int64_t>(ctx->pending.size())) /
        strip_bytes;
    std::vector<uint8_t> raw(ctx->pending.begin(), ctx->pending.begin() + take);
    ctx->pending.erase(ctx->pending.begin(), ctx->pending.begin() + take);
    ctx->strips_done += 1;
    ctx->raw_bytes += static_cast<int64_t>(take);
    if (ctx->compress) {
      // Bound concurrent compressors (join-all barrier is crude but the
      // strips are uniform so no thread outlives the batch by much).
      if (ctx->workers.size() >= 2 * max_workers()) {
        const int64_t t0 = steady_ns();
        for (auto& t : ctx->workers) t.join();
        ctx->workers.clear();
        ctx->barrier_ns += steady_ns() - t0;
      }
      auto* c = ctx;
      ctx->workers.emplace_back([c, strip_idx, raw = std::move(raw)]() {
        const int64_t t0 = thread_cpu_ns();
        if (!deflate_level(raw.data(), raw.size(), c->strips[strip_idx],
                           static_cast<int>(c->level)))
          c->errors.fetch_add(1);
        c->deflate_ns.fetch_add(thread_cpu_ns() - t0);
      });
    } else {
      ctx->strips[strip_idx] = std::move(raw);
    }
  }
  return ctx->rows_received;
}

int64_t srs_tiff_end_stats(void* handle, double* out, int64_t n) {
  auto* ctx = static_cast<StreamCtx*>(handle);
  if (!ctx) return -1;
  const int64_t t_join = steady_ns();
  for (auto& t : ctx->workers) t.join();
  ctx->workers.clear();
  const int64_t join_ns = steady_ns() - t_join;
  int64_t result = -2, file_ns = 0;
  if (ctx->rows_received == ctx->h && ctx->errors.load() == 0) {
    const int64_t t_file = steady_ns();
    result = assemble_and_write(ctx->path, ctx->strips, ctx->h, ctx->w,
                                ctx->channels, ctx->bit_depth,
                                ctx->compress != 0, ctx->rows_per_strip);
    file_ns = steady_ns() - t_file;
  }
  if (out) {
    int64_t out_bytes = 0;
    for (const auto& strip : ctx->strips)
      out_bytes += static_cast<int64_t>(strip.size());
    const double stats[] = {ctx->deflate_ns.load() * 1e-9,
                            ctx->barrier_ns * 1e-9,
                            join_ns * 1e-9,
                            file_ns * 1e-9,
                            static_cast<double>(ctx->strips_done),
                            static_cast<double>(ctx->raw_bytes),
                            static_cast<double>(out_bytes),
                            static_cast<double>(max_workers())};
    const int64_t count = static_cast<int64_t>(sizeof(stats) / sizeof(stats[0]));
    for (int64_t i = 0; i < n && i < count; ++i) out[i] = stats[i];
  }
  delete ctx;
  return result;
}

int64_t srs_tiff_end(void* handle) {
  return srs_tiff_end_stats(handle, nullptr, 0);
}

}  // extern "C"
