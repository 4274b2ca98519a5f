// Real-time I/Q ring buffer with a background consumer thread.
//
// Native transport layer of the Galileo simulator: decouples the
// bursty device-drain producer from a rate-steady consumer (file
// descriptor, UDP socket, or SDR driver), the same role the reference
// plays with its pthread FIFO + tx_task (reference: src/fifo.cpp,
// src/main.cpp:55-127, include/structures.h:194-199) — redesigned as a
// self-contained SPSC ring with proper RAII, EOF semantics, and a C ABI
// for ctypes.
//
// Units: one "sample" is an interleaved I/Q pair = 2 * int16.
//
// Build: g++ -O2 -shared -fPIC -pthread -o libiqring.so iqring.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

class IqRing {
 public:
  explicit IqRing(size_t capacity_samples)
      : buf_(capacity_samples * 2), capacity_(capacity_samples) {}

  ~IqRing() { Stop(); }

  // Blocking write; returns samples written (< n only after Close()).
  size_t Write(const int16_t* data, size_t n) {
    size_t written = 0;
    std::unique_lock<std::mutex> lk(mu_);
    while (written < n) {
      can_write_.wait(lk, [&] { return closed_ || size_ < capacity_; });
      if (closed_) break;
      size_t chunk = std::min(n - written, capacity_ - size_);
      chunk = std::min(chunk, capacity_ - head_);  // contiguous span
      std::memcpy(&buf_[head_ * 2], data + written * 2,
                  chunk * 2 * sizeof(int16_t));
      head_ = (head_ + chunk) % capacity_;
      size_ += chunk;
      written += chunk;
      can_read_.notify_one();
    }
    return written;
  }

  // Blocking read; returns 0 only at EOF (closed and drained).
  size_t Read(int16_t* out, size_t max_n) {
    std::unique_lock<std::mutex> lk(mu_);
    can_read_.wait(lk, [&] { return size_ > 0 || closed_; });
    size_t n = std::min(max_n, size_);
    size_t read = 0;
    while (read < n) {
      size_t chunk = std::min(n - read, capacity_ - tail_);
      std::memcpy(out + read * 2, &buf_[tail_ * 2],
                  chunk * 2 * sizeof(int16_t));
      tail_ = (tail_ + chunk) % capacity_;
      size_ -= chunk;
      read += chunk;
    }
    if (read) can_write_.notify_one();
    return read;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    can_read_.notify_all();
    can_write_.notify_all();
  }

  size_t Available() {
    std::lock_guard<std::mutex> lk(mu_);
    return size_;
  }

  size_t Free() {
    std::lock_guard<std::mutex> lk(mu_);
    return capacity_ - size_;
  }

  // ---- background consumers (the tx_task role) ----

  bool StartFileConsumer(const char* path, size_t chunk_samples) {
    FILE* fp = (std::strcmp(path, "-") == 0) ? stdout : std::fopen(path, "wb");
    if (!fp) return false;
    consumer_ = std::thread([this, fp, chunk_samples] {
      std::vector<int16_t> tmp(chunk_samples * 2);
      size_t n;
      while ((n = Read(tmp.data(), chunk_samples)) > 0) {
        std::fwrite(tmp.data(), sizeof(int16_t), n * 2, fp);
        consumed_ += n;
      }
      std::fflush(fp);
      if (fp != stdout) std::fclose(fp);
    });
    return true;
  }

  bool StartUdpConsumer(const char* host, int port, size_t chunk_samples) {
    int sock = ::socket(AF_INET, SOCK_DGRAM, 0);
    if (sock < 0) return false;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    addr.sin_addr.s_addr = ::inet_addr(host);
    consumer_ = std::thread([this, sock, addr, chunk_samples] {
      std::vector<int16_t> tmp(chunk_samples * 2);
      size_t n;
      while ((n = Read(tmp.data(), chunk_samples)) > 0) {
        ::sendto(sock, tmp.data(), n * 2 * sizeof(int16_t), 0,
                 reinterpret_cast<const sockaddr*>(&addr), sizeof(addr));
        consumed_ += n;
      }
      ::close(sock);
    });
    return true;
  }

  void Stop() {
    Close();
    if (consumer_.joinable()) consumer_.join();
  }

  uint64_t Consumed() const { return consumed_; }

 private:
  std::vector<int16_t> buf_;
  const size_t capacity_;
  size_t head_ = 0, tail_ = 0, size_ = 0;
  bool closed_ = false;
  std::mutex mu_;
  std::condition_variable can_read_, can_write_;
  std::thread consumer_;
  std::atomic<uint64_t> consumed_{0};
};

}  // namespace

extern "C" {

void* iqring_create(size_t capacity_samples) {
  return new IqRing(capacity_samples);
}

void iqring_destroy(void* ring) { delete static_cast<IqRing*>(ring); }

size_t iqring_write(void* ring, const int16_t* data, size_t nsamples) {
  return static_cast<IqRing*>(ring)->Write(data, nsamples);
}

size_t iqring_read(void* ring, int16_t* out, size_t max_samples) {
  return static_cast<IqRing*>(ring)->Read(out, max_samples);
}

void iqring_close(void* ring) { static_cast<IqRing*>(ring)->Close(); }

size_t iqring_available(void* ring) {
  return static_cast<IqRing*>(ring)->Available();
}

size_t iqring_free_space(void* ring) {
  return static_cast<IqRing*>(ring)->Free();
}

int iqring_start_file_consumer(void* ring, const char* path,
                               size_t chunk_samples) {
  return static_cast<IqRing*>(ring)->StartFileConsumer(path, chunk_samples)
             ? 0
             : -1;
}

int iqring_start_udp_consumer(void* ring, const char* host, int port,
                              size_t chunk_samples) {
  return static_cast<IqRing*>(ring)->StartUdpConsumer(host, port,
                                                      chunk_samples)
             ? 0
             : -1;
}

void iqring_stop(void* ring) { static_cast<IqRing*>(ring)->Stop(); }

uint64_t iqring_consumed(void* ring) {
  return static_cast<IqRing*>(ring)->Consumed();
}

}  // extern "C"
