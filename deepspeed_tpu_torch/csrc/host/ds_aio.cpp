// Async host file I/O engine for NVMe offload (ZeRO-Infinity spill).
// The port's own copy of the JAX package's csrc/aio/ds_aio.cpp, the same code
// and C ABI (aio_handle_create2, aio_pwrite_async, aio_pread_async, aio_wait,
// aio_direct_fallbacks, aio_write_sync, aio_read_sync): a thread-pool handle
// with submit/wait semantics. The data path can bypass the page cache:
// O_DIRECT transfers through a posix_memalign'd bounce buffer in aligned
// chunks, with the unaligned tail finished on a buffered descriptor + fsync.
// Where the filesystem refuses O_DIRECT (tmpfs) an op runs buffered and
// aio_direct_fallbacks counts it. deepspeed_tpu_torch/ops/op_builder.py
// builds it with g++ and loads it with ctypes.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct AioHandle {
    std::vector<std::thread> workers;
    std::queue<std::function<void()>> tasks;
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    std::atomic<int64_t> inflight{0};
    std::atomic<int64_t> errors{0};
    std::atomic<int64_t> direct_fallbacks{0};  // direct-requested ops that ran buffered
    bool stop = false;
    bool direct = false;  // O_DIRECT data path (page-cache bypass)

    explicit AioHandle(int n_threads) {
        for (int i = 0; i < n_threads; ++i) {
            workers.emplace_back([this] {
                for (;;) {
                    std::function<void()> task;
                    {
                        std::unique_lock<std::mutex> lk(mu);
                        cv.wait(lk, [this] { return stop || !tasks.empty(); });
                        if (stop && tasks.empty()) return;
                        task = std::move(tasks.front());
                        tasks.pop();
                    }
                    task();
                    if (--inflight == 0) {
                        std::lock_guard<std::mutex> lk(mu);
                        done_cv.notify_all();
                    }
                }
            });
        }
    }

    ~AioHandle() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& w : workers) w.join();
    }

    void submit(std::function<void()> fn) {
        ++inflight;
        {
            std::lock_guard<std::mutex> lk(mu);
            tasks.push(std::move(fn));
        }
        cv.notify_one();
    }

    int wait() {
        std::unique_lock<std::mutex> lk(mu);
        done_cv.wait(lk, [this] { return inflight.load() == 0; });
        return (int)errors.exchange(0);
    }
};

constexpr int64_t kAlign = 4096;           // O_DIRECT sector alignment
constexpr int64_t kBounce = 8 * 1024 * 1024;  // bounce-buffer chunk

bool write_all_buffered(int fd, const char* src, int64_t nbytes, off_t base) {
    int64_t left = nbytes;
    off_t off = 0;
    while (left > 0) {
        ssize_t w = ::pwrite(fd, src + off, (size_t)left, base + off);
        if (w <= 0) return false;
        left -= w;
        off += w;
    }
    return true;
}

bool read_all_buffered(int fd, char* dst, int64_t nbytes, off_t base) {
    int64_t left = nbytes;
    off_t off = 0;
    while (left > 0) {
        ssize_t r = ::pread(fd, dst + off, (size_t)left, base + off);
        if (r <= 0) return false;
        left -= r;
        off += r;
    }
    return true;
}

bool write_all(const char* path, const void* buf, int64_t nbytes, bool use_direct,
               bool* fell_back = nullptr) {
    const char* src = (const char*)buf;
#ifdef O_DIRECT
    if (use_direct && nbytes < kAlign && fell_back) *fell_back = true;  // sub-sector: buffered
    if (use_direct && nbytes >= kAlign) {
        int dfd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_DIRECT, 0644);
        if (dfd >= 0) {
            void* bounce = nullptr;
            if (posix_memalign(&bounce, (size_t)kAlign, (size_t)kBounce) != 0) {
                ::close(dfd);
                return false;
            }
            int64_t aligned = (nbytes / kAlign) * kAlign;
            bool ok = true;
            off_t off = 0;
            while (ok && off < aligned) {
                int64_t n = std::min<int64_t>(kBounce, aligned - off);
                std::memcpy(bounce, src + off, (size_t)n);
                // short direct writes are legal POSIX; retry while the next
                // offset stays sector-aligned, else finish buffered below
                int64_t done = 0;
                while (done < n) {
                    ssize_t w = ::pwrite(dfd, (char*)bounce + done, (size_t)(n - done), off + done);
                    if (w <= 0) { ok = false; break; }
                    done += w;
                    if (done < n && (done % kAlign) != 0) break;  // unaligned resume
                }
                off += done;
                if (ok && done < n) break;  // aligned prefix written; tail goes buffered
            }
            ::close(dfd);
            free(bounce);
            if (!ok) return false;
            if (off < nbytes) {  // remainder (unaligned tail or short-write rest)
                int fd = ::open(path, O_WRONLY, 0644);
                if (fd < 0) return false;
                bool tail_ok = write_all_buffered(fd, src + off, nbytes - off, off);
                if (tail_ok) ::fsync(fd);
                ::close(fd);
                return tail_ok;
            }
            return true;
        }
        // open with O_DIRECT failed (e.g. tmpfs): buffered fallback below
        if (fell_back) *fell_back = true;
    }
#else
    (void)use_direct;
    if (fell_back) *fell_back = use_direct;
#endif
    int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return false;
    bool ok = write_all_buffered(fd, src, nbytes, 0);
    ::close(fd);
    return ok;
}

bool read_all(const char* path, void* buf, int64_t nbytes, bool use_direct,
              bool* fell_back = nullptr) {
    char* dst = (char*)buf;
#ifdef O_DIRECT
    if (use_direct && nbytes < kAlign && fell_back) *fell_back = true;  // sub-sector: buffered
    if (use_direct && nbytes >= kAlign) {
        int dfd = ::open(path, O_RDONLY | O_DIRECT);
        if (dfd >= 0) {
            void* bounce = nullptr;
            if (posix_memalign(&bounce, (size_t)kAlign, (size_t)kBounce) != 0) {
                ::close(dfd);
                return false;
            }
            int64_t aligned = (nbytes / kAlign) * kAlign;
            bool ok = true;
            off_t off = 0;
            while (ok && off < aligned) {
                int64_t n = std::min<int64_t>(kBounce, aligned - off);
                int64_t done = 0;
                while (done < n) {  // short direct reads are legal; retry aligned
                    ssize_t r = ::pread(dfd, (char*)bounce + done, (size_t)(n - done), off + done);
                    if (r <= 0) { ok = false; break; }
                    done += r;
                    if (done < n && (done % kAlign) != 0) break;
                }
                if (done > 0) std::memcpy(dst + off, bounce, (size_t)done);
                off += done;
                if (ok && done < n) break;  // rest goes buffered
            }
            ::close(dfd);
            free(bounce);
            if (!ok) return false;
            if (off < nbytes) {  // remainder via buffered descriptor
                int fd = ::open(path, O_RDONLY);
                if (fd < 0) return false;
                bool tail_ok = read_all_buffered(fd, dst + off, nbytes - off, off);
                ::close(fd);
                return tail_ok;
            }
            return true;
        }
        // open with O_DIRECT failed (e.g. tmpfs): buffered fallback below
        if (fell_back) *fell_back = true;
    }
#else
    (void)use_direct;
    if (fell_back) *fell_back = use_direct;
#endif
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    bool ok = read_all_buffered(fd, dst, nbytes, 0);
    ::close(fd);
    return ok;
}

}  // namespace

extern "C" {

void* aio_handle_create(int n_threads) {
    if (n_threads < 1) n_threads = 1;
    return new AioHandle(n_threads);
}

// reference aio_config single_submit/overlap_events knobs are owned by the
// pool; use_direct selects the page-cache-bypassing path
void* aio_handle_create2(int n_threads, int use_direct) {
    if (n_threads < 1) n_threads = 1;
    auto* h = new AioHandle(n_threads);
    h->direct = use_direct != 0;
    return h;
}

void aio_handle_destroy(void* h) { delete (AioHandle*)h; }

// async write of nbytes from buf to path (buf must stay alive until wait)
void aio_pwrite_async(void* h, const char* path, const void* buf, int64_t nbytes) {
    auto* handle = (AioHandle*)h;
    std::string p(path);
    handle->submit([handle, p, buf, nbytes] {
        bool fb = false;
        if (!write_all(p.c_str(), buf, nbytes, handle->direct, &fb)) ++handle->errors;
        if (fb) ++handle->direct_fallbacks;
    });
}

// async read of nbytes from path into buf (buf must stay alive until wait)
void aio_pread_async(void* h, const char* path, void* buf, int64_t nbytes) {
    auto* handle = (AioHandle*)h;
    std::string p(path);
    handle->submit([handle, p, buf, nbytes] {
        bool fb = false;
        if (!read_all(p.c_str(), buf, nbytes, handle->direct, &fb)) ++handle->errors;
        if (fb) ++handle->direct_fallbacks;
    });
}

// block until every submitted op completes; returns the number of failed ops
// since the last wait
int aio_wait(void* h) { return ((AioHandle*)h)->wait(); }

// direct-requested ops that silently ran buffered (tmpfs etc.) since create
int64_t aio_direct_fallbacks(void* h) { return ((AioHandle*)h)->direct_fallbacks.load(); }

// synchronous helpers (reference deepspeed_py_aio.cpp sync paths)
int aio_write_sync(const char* path, const void* buf, int64_t nbytes) {
    return write_all(path, buf, nbytes, false) ? 0 : -1;
}

int aio_read_sync(const char* path, void* buf, int64_t nbytes) {
    return read_all(path, buf, nbytes, false) ? 0 : -1;
}

}  // extern "C"
