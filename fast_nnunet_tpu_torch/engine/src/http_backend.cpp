// HTTP backend: POSTs the preprocessed volume to the fast-inference serving
// daemon (fast_nnunet_tpu_torch.fast_inference.rest_api /predict_array, or
// the JAX package's server, which speaks the same protocol) that owns the
// device and runs the sliding window. Raw float32 little-endian body,
// geometry in headers — no JSON/base64 overhead on the hot path. A copy of
// engine/src/http_backend.cpp.
#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstring>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "fast_nnunet/engine.h"

namespace fast_nnunet {

namespace {

class SocketGuard {
  public:
    explicit SocketGuard(int fd) : fd_(fd) {}
    ~SocketGuard() {
        if (fd_ >= 0) close(fd_);
    }
    int fd() const { return fd_; }

  private:
    int fd_;
};

int connect_to(const std::string& host, int port) {
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints, &res) != 0)
        throw std::runtime_error("cannot resolve " + host);
    int fd = -1;
    for (addrinfo* p = res; p; p = p->ai_next) {
        fd = socket(p->ai_family, p->ai_socktype, p->ai_protocol);
        if (fd < 0) continue;
        if (connect(fd, p->ai_addr, p->ai_addrlen) == 0) break;
        close(fd);
        fd = -1;
    }
    freeaddrinfo(res);
    if (fd < 0)
        throw std::runtime_error("cannot connect to " + host + ":" +
                                 std::to_string(port));
    return fd;
}

void send_all(int fd, const void* data, size_t n) {
    const char* p = static_cast<const char*>(data);
    while (n > 0) {
        ssize_t w = send(fd, p, n, 0);
        if (w <= 0) throw std::runtime_error("socket send failed");
        p += w;
        n -= static_cast<size_t>(w);
    }
}

std::vector<char> recv_all(int fd) {
    std::vector<char> out;
    char buf[1 << 16];
    ssize_t r;
    while ((r = recv(fd, buf, sizeof(buf), 0)) > 0) out.insert(out.end(), buf, buf + r);
    return out;
}

}  // namespace

class HttpBackend : public Backend {
  public:
    HttpBackend(std::string host, int port)
        : host_(std::move(host)), port_(port) {}

    Logits infer_volume(const std::vector<float>& pre,
                        const std::array<int64_t, 3>& shape,
                        const EngineConfig& cfg) override {
        size_t body_len = pre.size() * sizeof(float);
        std::ostringstream head;
        head << "POST /predict_array HTTP/1.1\r\n"
             << "Host: " << host_ << ":" << port_ << "\r\n"
             << "Content-Type: application/octet-stream\r\n"
             << "Content-Length: " << body_len << "\r\n"
             << "X-Shape: " << shape[0] << "," << shape[1] << "," << shape[2]
             << "\r\n"
             << "X-Num-Class: " << cfg.num_class << "\r\n"
             << "Connection: close\r\n\r\n";

        SocketGuard sock(connect_to(host_, port_));
        std::string h = head.str();
        send_all(sock.fd(), h.data(), h.size());
        send_all(sock.fd(), pre.data(), body_len);
        std::vector<char> resp = recv_all(sock.fd());

        // split headers / body
        const char* sep = "\r\n\r\n";
        auto it = std::search(resp.begin(), resp.end(), sep, sep + 4);
        if (it == resp.end()) throw std::runtime_error("malformed HTTP response");
        std::string headers(resp.begin(), it);
        if (headers.find("200") == std::string::npos)
            throw std::runtime_error("serving daemon error: " + headers.substr(0, 200));
        size_t body_off = static_cast<size_t>(it - resp.begin()) + 4;

        Logits l;
        l.shape = shape;
        l.num_class = cfg.num_class;
        size_t expect = static_cast<size_t>(cfg.num_class) * shape[0] * shape[1] *
                        shape[2] * sizeof(float);
        if (resp.size() - body_off != expect)
            throw std::runtime_error("logits payload size mismatch: got " +
                                     std::to_string(resp.size() - body_off) +
                                     " expected " + std::to_string(expect));
        l.data.resize(expect / sizeof(float));
        std::memcpy(l.data.data(), resp.data() + body_off, expect);
        return l;
    }

  private:
    std::string host_;
    int port_;
};

std::unique_ptr<Backend> make_http_backend(const std::string& host, int port) {
    return std::make_unique<HttpBackend>(host, port);
}

}  // namespace fast_nnunet
