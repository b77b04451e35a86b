// Parallel byte-range gather for MDS shard files: the port's own copy of the JAX
// package's datasets/_native/mds_gather.cpp, the same C ABI.
//
// The training loader's hot path is assembling a batch of fp16 latent blobs from shard
// files on disk (~67MB per global step at 256px, ~270MB at 512px; SURVEY.md #7). Slicing
// memory maps serializes page faults + memcpys behind the GIL; this native core gathers
// all ranges with a thread pool of pread() calls directly into the caller's
// preallocated batch buffer.
//
// C ABI (ctypes, no Python headers):
//   mds_gather(paths, file_offsets, lengths, out_offsets, n, out, num_threads) -> long
//     paths:        array of n C strings (shard file path per sample)
//     file_offsets: byte offset of each range within its file
//     lengths:      byte length of each range
//     out_offsets:  destination offset of each range within `out`
//     returns total bytes read, or -errno on the first failure.
//
// Host C++, no CUDA: built with g++ -O3 -shared -fPIC -pthread -std=c++17 at first use
// (datasets/native.py).

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// Small per-gather fd cache: batches typically touch a handful of shard files.
class FdCache {
 public:
  int get(const char* path) {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = fds_.find(path);
    if (it != fds_.end()) return it->second;
    int fd = open(path, O_RDONLY);
    if (fd >= 0) fds_[path] = fd;
    return fd;
  }
  ~FdCache() {
    for (auto& kv : fds_) close(kv.second);
  }

 private:
  std::mutex mu_;
  std::map<std::string, int> fds_;
};

long pread_full(int fd, char* dst, long len, long off) {
  long done = 0;
  while (done < len) {
    ssize_t r = pread(fd, dst + done, len - done, off + done);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (r == 0) return -EIO;  // short file
    done += r;
  }
  return done;
}

}  // namespace

extern "C" long mds_gather(const char* const* paths, const long* file_offsets,
                           const long* lengths, const long* out_offsets, long n,
                           char* out, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  FdCache cache;
  std::atomic<long> next(0);
  std::atomic<long> total(0);
  std::atomic<long> err(0);

  auto worker = [&]() {
    while (true) {
      long i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      int fd = cache.get(paths[i]);
      if (fd < 0) {
        err.store(errno ? -errno : -EBADF);
        return;
      }
      long r = pread_full(fd, out + out_offsets[i], lengths[i], file_offsets[i]);
      if (r < 0) {
        err.store(r);
        return;
      }
      total.fetch_add(r);
    }
  };

  std::vector<std::thread> threads;
  int t = static_cast<int>(std::min<long>(num_threads, n));
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();

  long e = err.load();
  return e != 0 ? e : total.load();
}
