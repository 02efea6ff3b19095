// Native iFacialMocap UDP receiver: a dedicated drain thread + a seqlocked
// latest-packet slot (the same source and C ABI as the JAX package's
// tha4_tpu/native/mocap_receiver.cpp).
//
// The reference drains a nonblocking socket on the RENDER thread
// (src/tha4/app/character_model_ifacialmocap_puppeteer.py:109-121), so the
// pose it renders is whatever sat in the kernel buffer since the previous
// frame, and the drain competes with Python-side work under the GIL.  This
// receiver drains continuously off-thread (GIL-free), so each frame reads the
// packet closest to its own render time; protocol PARSING stays in Python
// (tha4_tpu_torch/mocap/ifacialmocap.py) so the v1/v2 grammar lives in one place.
//
// Plain C ABI consumed via ctypes, built by
// tha4_tpu_torch/native/loader.py with -pthread.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>

namespace {

constexpr int kMaxPacket = 8192;

struct Receiver {
    int fd = -1;
    std::atomic<bool> stop{false};
    std::thread thread;
    std::mutex mu;
    std::string latest;          // last packet's bytes
    unsigned long long seq = 0;  // bumps on every received packet

    void run() {
        char buf[kMaxPacket];
        while (!stop.load(std::memory_order_relaxed)) {
            ssize_t n = recv(fd, buf, kMaxPacket, 0);
            if (n <= 0) continue;  // timeout or transient error: poll stop
            std::lock_guard<std::mutex> lock(mu);
            latest.assign(buf, static_cast<size_t>(n));
            ++seq;
        }
    }
};

}  // namespace

extern "C" {

// Bind port, optionally send the iFacialMocap start handshake to
// capture_address, spawn the drain thread.  Returns nullptr on failure.
void* tha4_mocap_rx_start(int port, const char* capture_address,
                          const char* start_bytes, int start_len) {
    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return nullptr;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    timeval tv{0, 100000};  // 100 ms: the drain thread polls `stop`
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
        close(fd);
        return nullptr;
    }
    if (capture_address != nullptr && start_bytes != nullptr && start_len > 0) {
        sockaddr_in dst{};
        dst.sin_family = AF_INET;
        dst.sin_port = htons(static_cast<uint16_t>(port));
        if (inet_pton(AF_INET, capture_address, &dst.sin_addr) == 1) {
            sendto(fd, start_bytes, static_cast<size_t>(start_len), 0,
                   reinterpret_cast<sockaddr*>(&dst), sizeof(dst));
        }
    }
    auto* rx = new Receiver();
    rx->fd = fd;
    rx->thread = std::thread([rx] { rx->run(); });
    return rx;
}

// Copy the latest packet into buf (cap bytes).  Returns its length (0 if
// nothing received yet; -1 if it no longer fits) and writes the packet
// sequence number to *seq_out so callers can skip stale reads.
long long tha4_mocap_rx_read(void* handle, char* buf, long long cap,
                             unsigned long long* seq_out) {
    auto* rx = static_cast<Receiver*>(handle);
    std::lock_guard<std::mutex> lock(rx->mu);
    if (seq_out != nullptr) *seq_out = rx->seq;
    if (rx->latest.empty()) return 0;
    if (static_cast<long long>(rx->latest.size()) > cap) return -1;
    std::memcpy(buf, rx->latest.data(), rx->latest.size());
    return static_cast<long long>(rx->latest.size());
}

void tha4_mocap_rx_stop(void* handle) {
    auto* rx = static_cast<Receiver*>(handle);
    rx->stop.store(true, std::memory_order_relaxed);
    if (rx->thread.joinable()) rx->thread.join();
    close(rx->fd);
    delete rx;
}

}  // extern "C"
