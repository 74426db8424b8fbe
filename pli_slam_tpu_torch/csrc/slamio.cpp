// PNG decoding and an asynchronous stereo prefetcher for pli_slam_tpu_torch.
//
// The port's own copy of native/dataloader.cpp, with the same C ABI
// (loader_create / loader_next / loader_size / loader_destroy /
// decode_png / png_dims) plus png_info / png_read_raw, which hand Python
// the file's samples as they are (what pillow's np.asarray gives).
//
// It needs nothing but a C++17 compiler and pthreads: the PNG is parsed
// here, its zlib stream inflated by the decoder below (stored, fixed and
// dynamic Huffman blocks, RFC 1951) and its rows unfiltered (the five
// filter types of the PNG specification). Supported: non-interlaced
// 8-bit gray, gray+alpha, RGB and RGBA, and 16-bit gray and RGB(A).
//
// decode_png / the prefetcher give 8-bit gray as floats, as the reference's
// libpng path does: a 16-bit sample keeps its high byte, alpha is dropped,
// and colour becomes gray by libpng's default fixed-point weights, truncated:
// (6968 R + 23434 G + 2366 B) >> 15 (equal channels give the channel).
//
// Built by pli_slam_tpu_torch/utils/native_loader.py:
//   g++ -O3 -std=c++17 -shared -fPIC -o libslamio.so slamio.cpp -lpthread

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Inflate (RFC 1950 / 1951)
// ---------------------------------------------------------------------------

struct Huffman {
  int16_t count[16];   // codes of each length
  int16_t symbol[320];  // symbols ordered by code
};

class Inflater {
 public:
  Inflater(const uint8_t* in, size_t n, std::vector<uint8_t>* out) : in_(in), n_(n), out_(out) {}

  void Run() {
    if (n_ < 2 || (in_[0] & 0x0f) != 8 || ((in_[0] << 8) | in_[1]) % 31 != 0 || (in_[1] & 0x20))
      throw std::runtime_error("bad zlib header");
    pos_ = 2;
    int last;
    do {
      last = Bits(1);
      int type = Bits(2);
      if (type == 0) {
        Stored();
      } else if (type == 1) {
        Fixed();
      } else if (type == 2) {
        Dynamic();
      } else {
        throw std::runtime_error("bad deflate block type");
      }
    } while (!last);
  }

 private:
  int Bits(int need) {
    uint32_t val = bitbuf_;
    while (bitcnt_ < need) {
      if (pos_ >= n_) throw std::runtime_error("deflate stream ends early");
      val |= static_cast<uint32_t>(in_[pos_++]) << bitcnt_;
      bitcnt_ += 8;
    }
    bitbuf_ = val >> need;
    bitcnt_ -= need;
    return static_cast<int>(val & ((1u << need) - 1));
  }

  void Stored() {
    bitbuf_ = 0;
    bitcnt_ = 0;
    if (pos_ + 4 > n_) throw std::runtime_error("stored block ends early");
    unsigned len = in_[pos_] | (in_[pos_ + 1] << 8);
    unsigned nlen = in_[pos_ + 2] | (in_[pos_ + 3] << 8);
    pos_ += 4;
    if (len != (~nlen & 0xffffu)) throw std::runtime_error("stored block length check");
    if (pos_ + len > n_) throw std::runtime_error("stored block ends early");
    out_->insert(out_->end(), in_ + pos_, in_ + pos_ + len);
    pos_ += len;
  }

  int Decode(const Huffman& h) {
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; ++len) {
      code |= Bits(1);
      int count = h.count[len];
      if (code - count < first) return h.symbol[index + (code - first)];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    throw std::runtime_error("bad Huffman code");
  }

  // Returns 0 for a complete code, > 0 for an incomplete one; throws if over-subscribed.
  static int Construct(Huffman* h, const int16_t* length, int n) {
    for (int len = 0; len < 16; ++len) h->count[len] = 0;
    for (int s = 0; s < n; ++s) h->count[length[s]]++;
    if (h->count[0] == n) return 0;
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left <<= 1;
      left -= h->count[len];
      if (left < 0) throw std::runtime_error("over-subscribed Huffman code");
    }
    int16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h->count[len];
    for (int s = 0; s < n; ++s)
      if (length[s] != 0) h->symbol[offs[length[s]]++] = static_cast<int16_t>(s);
    return left;
  }

  void Codes(const Huffman& lencode, const Huffman& distcode) {
    static const int16_t kLBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
                                       35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const int16_t kLExt[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
                                      3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const int16_t kDBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                                       193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                                       6145, 8193, 12289, 16385, 24577};
    static const int16_t kDExt[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                      6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    for (;;) {
      int symbol = Decode(lencode);
      if (symbol < 256) {
        out_->push_back(static_cast<uint8_t>(symbol));
      } else if (symbol == 256) {
        return;
      } else {
        symbol -= 257;
        if (symbol >= 29) throw std::runtime_error("bad length symbol");
        int len = kLBase[symbol] + Bits(kLExt[symbol]);
        int dsym = Decode(distcode);
        if (dsym >= 30) throw std::runtime_error("bad distance symbol");
        size_t dist = static_cast<size_t>(kDBase[dsym]) + Bits(kDExt[dsym]);
        if (dist > out_->size()) throw std::runtime_error("distance too far back");
        size_t from = out_->size() - dist;
        for (int k = 0; k < len; ++k) {
          const uint8_t v = (*out_)[from + k];
          out_->push_back(v);
        }
      }
    }
  }

  void Fixed() {
    static Huffman lencode, distcode;
    static std::once_flag once;
    std::call_once(once, [] {
      int16_t lengths[288];
      int s = 0;
      for (; s < 144; ++s) lengths[s] = 8;
      for (; s < 256; ++s) lengths[s] = 9;
      for (; s < 280; ++s) lengths[s] = 7;
      for (; s < 288; ++s) lengths[s] = 8;
      Construct(&lencode, lengths, 288);
      for (s = 0; s < 30; ++s) lengths[s] = 5;
      Construct(&distcode, lengths, 30);
    });
    Codes(lencode, distcode);
  }

  void Dynamic() {
    static const int16_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
    int nlen = Bits(5) + 257, ndist = Bits(5) + 1, ncode = Bits(4) + 4;
    if (nlen > 286 || ndist > 30) throw std::runtime_error("bad dynamic block counts");
    int16_t lengths[320];
    int index = 0;
    for (; index < ncode; ++index) lengths[kOrder[index]] = static_cast<int16_t>(Bits(3));
    for (; index < 19; ++index) lengths[kOrder[index]] = 0;
    Huffman lencode, distcode;
    if (Construct(&lencode, lengths, 19) != 0) throw std::runtime_error("incomplete code-length code");
    index = 0;
    while (index < nlen + ndist) {
      int symbol = Decode(lencode);
      if (symbol < 16) {
        lengths[index++] = static_cast<int16_t>(symbol);
      } else {
        int16_t len = 0;
        int repeat;
        if (symbol == 16) {
          if (index == 0) throw std::runtime_error("repeat with no previous length");
          len = lengths[index - 1];
          repeat = 3 + Bits(2);
        } else if (symbol == 17) {
          repeat = 3 + Bits(3);
        } else {
          repeat = 11 + Bits(7);
        }
        if (index + repeat > nlen + ndist) throw std::runtime_error("too many lengths");
        while (repeat--) lengths[index++] = len;
      }
    }
    if (lengths[256] == 0) throw std::runtime_error("no end-of-block code");
    int err = Construct(&lencode, lengths, nlen);
    if (err < 0 || (err > 0 && nlen - lencode.count[0] != 1)) throw std::runtime_error("incomplete literal code");
    err = Construct(&distcode, lengths + nlen, ndist);
    if (err < 0 || (err > 0 && ndist - distcode.count[0] != 1)) throw std::runtime_error("incomplete distance code");
    Codes(lencode, distcode);
  }

  const uint8_t* in_;
  size_t n_;
  size_t pos_ = 0;
  uint32_t bitbuf_ = 0;
  int bitcnt_ = 0;
  std::vector<uint8_t>* out_;
};

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

struct Png {
  int width = 0, height = 0, channels = 0, depth = 0;
  std::vector<uint8_t> rows;  // unfiltered samples, big-endian for 16 bits
};

uint32_t Be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

bool ReadFile(const char* path, std::vector<uint8_t>* data) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  data->resize(size > 0 ? size : 0);
  bool ok = size > 0 && std::fread(data->data(), 1, data->size(), fp) == data->size();
  std::fclose(fp);
  return ok;
}

// Parses the header only (header_only) or the whole image. Returns 0, -2 on an
// unreadable or corrupt file, -4 on a format this decoder does not take.
int ParsePng(const char* path, Png* png, bool header_only) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  std::vector<uint8_t> file;
  if (!ReadFile(path, &file) || file.size() < 33 || std::memcmp(file.data(), kSig, 8) != 0) return -2;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  bool have_header = false;
  while (pos + 8 <= file.size()) {
    uint32_t len = Be32(&file[pos]);
    const uint8_t* type = &file[pos + 4];
    if (pos + 12 + static_cast<size_t>(len) > file.size()) return -2;
    const uint8_t* body = &file[pos + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13) return -2;
      png->width = static_cast<int>(Be32(body));
      png->height = static_cast<int>(Be32(body + 4));
      png->depth = body[8];
      int color = body[9];
      if (body[10] != 0 || body[11] != 0) return -2;
      if (body[12] != 0) return -4;  // interlaced
      switch (color) {
        case 0: png->channels = 1; break;
        case 2: png->channels = 3; break;
        case 4: png->channels = 2; break;
        case 6: png->channels = 4; break;
        default: return -4;  // palette
      }
      if (png->depth != 8 && png->depth != 16) return -4;
      if (png->depth == 16 && png->channels == 2) return -4;
      if (png->width <= 0 || png->height <= 0) return -2;
      have_header = true;
      if (header_only) return 0;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + static_cast<size_t>(len);
  }
  if (!have_header) return -2;
  const size_t bpp = static_cast<size_t>(png->channels) * (png->depth / 8);
  const size_t stride = bpp * png->width;
  std::vector<uint8_t> raw;
  raw.reserve((stride + 1) * png->height);
  try {
    Inflater(idat.data(), idat.size(), &raw).Run();
  } catch (const std::exception&) {
    return -2;
  }
  if (raw.size() < (stride + 1) * png->height) return -2;
  png->rows.assign(stride * png->height, 0);
  for (int y = 0; y < png->height; ++y) {
    const uint8_t* src = &raw[(stride + 1) * y];
    const int filter = src[0];
    ++src;
    uint8_t* dst = &png->rows[stride * y];
    const uint8_t* up = y > 0 ? dst - stride : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? dst[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int pred;
      switch (filter) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -2;
      }
      dst[x] = static_cast<uint8_t>(src[x] + pred);
    }
  }
  return 0;
}

struct Image {
  int width = 0;
  int height = 0;
  std::vector<float> pixels;  // grayscale, 0..255
  bool ok = false;
};

Image DecodeGray(const char* path) {
  Image out;
  Png png;
  if (ParsePng(path, &png, false) != 0) return out;
  const size_t n = static_cast<size_t>(png.width) * png.height;
  const int step = png.depth / 8;
  out.width = png.width;
  out.height = png.height;
  out.pixels.resize(n);
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* px = &png.rows[i * png.channels * step];
    // a 16-bit sample keeps its high (first) byte
    const uint32_t v0 = px[0];
    if (png.channels <= 2) {
      out.pixels[i] = static_cast<float>(v0);
    } else {
      const uint32_t g = px[step], b = px[2 * step];
      out.pixels[i] = static_cast<float>((6968u * v0 + 23434u * g + 2366u * b) >> 15);
    }
  }
  out.ok = true;
  return out;
}

struct FramePair {
  int64_t index = -1;
  Image left, right;
};

class Prefetcher {
 public:
  Prefetcher(std::vector<std::string> left, std::vector<std::string> right, int n_workers, int ring_capacity)
      : left_(std::move(left)), right_(std::move(right)), capacity_(ring_capacity) {
    done_.resize(left_.size());
    for (int i = 0; i < n_workers; ++i) workers_.emplace_back([this] { this->WorkerLoop(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_emit_.notify_all();
    for (auto& w : workers_) w.join();
  }

  // Blocks until the next frame is decoded and copies it into the caller's
  // buffers. Returns 0, -1 at the end, -2 on a decode failure, -3 on a size mismatch.
  int Next(float* out_l, float* out_r, int expect_w, int expect_h) {
    std::unique_lock<std::mutex> lk(mu_);
    const int64_t want = next_to_emit_;
    if (want >= static_cast<int64_t>(left_.size())) return -1;
    cv_emit_.wait(lk, [&] { return stop_ || done_[want].index == want; });
    if (stop_) return -1;
    FramePair fp = std::move(done_[want]);
    done_[want] = FramePair{};
    ++next_to_emit_;
    lk.unlock();
    cv_work_.notify_all();
    if (!fp.left.ok || !fp.right.ok) return -2;
    if (fp.left.width != expect_w || fp.left.height != expect_h || fp.right.width != expect_w ||
        fp.right.height != expect_h)
      return -3;
    std::memcpy(out_l, fp.left.pixels.data(), sizeof(float) * expect_w * expect_h);
    std::memcpy(out_r, fp.right.pixels.data(), sizeof(float) * expect_w * expect_h);
    return 0;
  }

  int64_t size() const { return static_cast<int64_t>(left_.size()); }

 private:
  void WorkerLoop() {
    for (;;) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [&] {
          return stop_ || (next_to_schedule_ < static_cast<int64_t>(left_.size()) &&
                           next_to_schedule_ - next_to_emit_ < capacity_);
        });
        if (stop_) return;
        idx = next_to_schedule_++;
      }
      FramePair fp;
      fp.index = idx;
      fp.left = DecodeGray(left_[idx].c_str());
      fp.right = DecodeGray(right_[idx].c_str());
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[idx] = std::move(fp);
      }
      cv_emit_.notify_all();
    }
  }

  std::vector<std::string> left_, right_;
  const int64_t capacity_;
  int64_t next_to_schedule_ = 0;
  int64_t next_to_emit_ = 0;
  bool stop_ = false;
  std::vector<FramePair> done_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_emit_;
};

std::vector<std::string> SplitLines(const char* s) {
  std::vector<std::string> out;
  std::string cur;
  for (const char* p = s; *p; ++p) {
    if (*p == '\n') {
      if (!cur.empty()) out.push_back(cur);
      cur.clear();
    } else {
      cur.push_back(*p);
    }
  }
  if (!cur.empty()) out.push_back(cur);
  return out;
}

}  // namespace

extern "C" {

// A prefetcher over two newline-separated path lists of equal, non-zero length (else null).
void* loader_create(const char* left_paths, const char* right_paths, int n_workers, int ring_capacity) {
  auto l = SplitLines(left_paths);
  auto r = SplitLines(right_paths);
  if (l.size() != r.size() || l.empty() || n_workers < 1 || ring_capacity < 1) return nullptr;
  return new Prefetcher(std::move(l), std::move(r), n_workers, ring_capacity);
}

int loader_next(void* handle, float* out_l, float* out_r, int w, int h) {
  return static_cast<Prefetcher*>(handle)->Next(out_l, out_r, w, h);
}

long long loader_size(void* handle) { return static_cast<Prefetcher*>(handle)->size(); }

void loader_destroy(void* handle) { delete static_cast<Prefetcher*>(handle); }

// One image as 8-bit gray floats (see the top of this file). 0, -2 unreadable, -3 size mismatch.
int decode_png(const char* path, float* out, int w, int h) {
  Image img = DecodeGray(path);
  if (!img.ok) return -2;
  if (img.width != w || img.height != h) return -3;
  std::memcpy(out, img.pixels.data(), sizeof(float) * w * h);
  return 0;
}

int png_dims(const char* path, int* w, int* h) {
  Png png;
  int rc = ParsePng(path, &png, true);
  if (rc != 0) return rc;
  *w = png.width;
  *h = png.height;
  return 0;
}

// Width, height, samples per pixel and bits per sample. 0, -2 unreadable, -4 unsupported.
int png_info(const char* path, int* w, int* h, int* channels, int* depth) {
  Png png;
  int rc = ParsePng(path, &png, true);
  if (rc != 0) return rc;
  *w = png.width;
  *h = png.height;
  *channels = png.channels;
  *depth = png.depth;
  return 0;
}

// The image's samples as stored, row-major, 16-bit ones in host order, into
// `out` of `nbytes` bytes. 0, -2 unreadable, -3 wrong size, -4 unsupported.
int png_read_raw(const char* path, void* out, long long nbytes) {
  Png png;
  int rc = ParsePng(path, &png, false);
  if (rc != 0) return rc;
  if (static_cast<long long>(png.rows.size()) != nbytes) return -3;
  if (png.depth == 8) {
    std::memcpy(out, png.rows.data(), png.rows.size());
  } else {
    uint16_t* dst = static_cast<uint16_t*>(out);
    for (size_t i = 0; i < png.rows.size() / 2; ++i)
      dst[i] = static_cast<uint16_t>((png.rows[2 * i] << 8) | png.rows[2 * i + 1]);
  }
  return 0;
}

}  // extern "C"
