// legoio — native scan IO + prefetching replay runtime.
//
// The reference's data path is ROS middleware C++: rosbag playback feeding
// TCPROS subscribers (reference: README.md:90-102, the four nodes'
// subscribers).  This is its TPU-native equivalent: a small C++ runtime that
// reads scan files (KITTI .bin / PCD / raw packed), filters and pads them to
// the fixed-size array layout the jitted pipeline consumes, and prefetches
// ahead of the host loop on background threads so device dispatch never waits
// on IO.
//
// Exposed as a plain C ABI consumed via ctypes (legoloam_tpu/utils/io.py).
//
// Formats:
//   .bin  — KITTI velodyne: float32 x,y,z,intensity records
//   .pcd  — PCL: ASCII or binary, FIELDS x y z [intensity] [ring]
//   .lpk  — "lego packed": header {magic 'LPK1', uint32 n} then n records of
//           float32 x,y,z + uint16 ring (the dump format of utils/io.py)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>
#include <cmath>

namespace {

struct Scan {
  std::vector<float> xyz;      // point_cap * 3
  std::vector<uint8_t> valid;  // point_cap
  std::vector<int32_t> ring;   // point_cap
  int64_t index = -1;
  bool ok = false;
};

struct SensorGeom {
  int n_scan = 16;
  float ang_bottom_deg = 15.1f;
  float ang_res_y_deg = 2.0f;
};

int infer_ring(float x, float y, float z, const SensorGeom& g) {
  float vert = std::atan2(z, std::sqrt(x * x + y * y)) * 57.29577951308232f;
  int r = (int)std::floor((vert + g.ang_bottom_deg) / g.ang_res_y_deg);
  if (r < 0 || r >= g.n_scan) return -1;
  return r;
}

bool ends_with(const std::string& s, const char* suf) {
  size_t n = std::strlen(suf);
  return s.size() >= n && s.compare(s.size() - n, n, suf) == 0;
}

bool load_bin(const std::string& path, size_t cap, const SensorGeom& g,
              Scan* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  f.seekg(0, std::ios::end);
  size_t bytes = (size_t)f.tellg();
  f.seekg(0);
  size_t n = bytes / (4 * sizeof(float));
  std::vector<float> rec(n * 4);
  f.read(reinterpret_cast<char*>(rec.data()), n * 4 * sizeof(float));
  size_t m = n < cap ? n : cap;
  for (size_t i = 0; i < m; i++) {
    float x = rec[i * 4], y = rec[i * 4 + 1], z = rec[i * 4 + 2];
    bool v = std::isfinite(x) && std::isfinite(y) && std::isfinite(z) &&
             (x != 0.f || y != 0.f || z != 0.f);
    int r = v ? infer_ring(x, y, z, g) : -1;
    out->xyz[i * 3] = x;
    out->xyz[i * 3 + 1] = y;
    out->xyz[i * 3 + 2] = z;
    out->valid[i] = (v && r >= 0) ? 1 : 0;
    out->ring[i] = r >= 0 ? r : 0;
  }
  return true;
}

bool load_lpk(const std::string& path, size_t cap, Scan* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char magic[4];
  uint32_t n = 0;
  f.read(magic, 4);
  if (std::memcmp(magic, "LPK1", 4) != 0) return false;
  f.read(reinterpret_cast<char*>(&n), 4);
  size_t m = n < cap ? n : cap;
  struct Rec { float x, y, z; uint16_t ring; } __attribute__((packed));
  std::vector<Rec> recs(m);
  f.read(reinterpret_cast<char*>(recs.data()), m * sizeof(Rec));
  for (size_t i = 0; i < m; i++) {
    out->xyz[i * 3] = recs[i].x;
    out->xyz[i * 3 + 1] = recs[i].y;
    out->xyz[i * 3 + 2] = recs[i].z;
    bool v = std::isfinite(recs[i].x) && std::isfinite(recs[i].y) &&
             std::isfinite(recs[i].z);
    out->valid[i] = v ? 1 : 0;
    out->ring[i] = recs[i].ring;
  }
  return true;
}

bool load_pcd(const std::string& path, size_t cap, const SensorGeom& g,
              Scan* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::string line;
  std::vector<std::string> fields;
  std::vector<int> sizes;
  size_t n_points = 0;
  bool binary = false;
  while (std::getline(f, line)) {
    std::istringstream is(line);
    std::string key;
    is >> key;
    if (key == "FIELDS") {
      std::string s;
      while (is >> s) fields.push_back(s);
    } else if (key == "SIZE") {
      int v;
      while (is >> v) sizes.push_back(v);
    } else if (key == "POINTS") {
      is >> n_points;
    } else if (key == "DATA") {
      std::string mode;
      is >> mode;
      binary = (mode == "binary");
      break;
    }
  }
  int xi = -1, yi = -1, zi = -1, ri = -1;
  size_t stride = 0;
  std::vector<size_t> offs(fields.size());
  for (size_t i = 0; i < fields.size(); i++) {
    offs[i] = stride;
    stride += (i < sizes.size() ? sizes[i] : 4);
    if (fields[i] == "x") xi = (int)i;
    if (fields[i] == "y") yi = (int)i;
    if (fields[i] == "z") zi = (int)i;
    if (fields[i] == "ring") ri = (int)i;
  }
  if (xi < 0 || yi < 0 || zi < 0) return false;
  size_t m = n_points < cap ? n_points : cap;
  if (binary) {
    std::vector<char> rec(stride);
    for (size_t i = 0; i < m; i++) {
      f.read(rec.data(), stride);
      float x, y, z;
      std::memcpy(&x, rec.data() + offs[xi], 4);
      std::memcpy(&y, rec.data() + offs[yi], 4);
      std::memcpy(&z, rec.data() + offs[zi], 4);
      int r = -1;
      if (ri >= 0) {
        uint16_t rv;
        std::memcpy(&rv, rec.data() + offs[ri], 2);
        r = rv;
      }
      bool v = std::isfinite(x) && std::isfinite(y) && std::isfinite(z);
      if (v && r < 0) r = infer_ring(x, y, z, g);
      out->xyz[i * 3] = x;
      out->xyz[i * 3 + 1] = y;
      out->xyz[i * 3 + 2] = z;
      out->valid[i] = (v && r >= 0) ? 1 : 0;
      out->ring[i] = r >= 0 ? r : 0;
    }
  } else {
    for (size_t i = 0; i < m && std::getline(f, line); i++) {
      std::istringstream is(line);
      std::vector<float> vals;
      float v;
      while (is >> v) vals.push_back(v);
      if ((int)vals.size() <= zi) {
        out->valid[i] = 0;
        continue;
      }
      float x = vals[xi], y = vals[yi], z = vals[zi];
      int r = ri >= 0 && ri < (int)vals.size() ? (int)vals[ri]
                                               : infer_ring(x, y, z, g);
      bool ok = std::isfinite(x) && std::isfinite(y) && std::isfinite(z);
      out->xyz[i * 3] = x;
      out->xyz[i * 3 + 1] = y;
      out->xyz[i * 3 + 2] = z;
      out->valid[i] = (ok && r >= 0) ? 1 : 0;
      out->ring[i] = r >= 0 ? r : 0;
    }
  }
  return true;
}

struct Loader {
  std::vector<std::string> paths;
  size_t point_cap;
  SensorGeom geom;
  size_t n_threads;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::deque<Scan> ready;           // prefetched scans, ordered by index
  std::atomic<int64_t> next_to_read{0};
  int64_t next_to_emit = 0;
  size_t capacity;
  int64_t emitted = 0;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::deque<Scan> out_of_order;    // completed but not yet in emit order

  void worker() {
    while (!stop.load()) {
      int64_t idx = next_to_read.fetch_add(1);
      if (idx >= (int64_t)paths.size()) return;
      Scan s;
      s.xyz.assign(point_cap * 3, 0.f);
      s.valid.assign(point_cap, 0);
      s.ring.assign(point_cap, 0);
      s.index = idx;
      const std::string& p = paths[idx];
      if (ends_with(p, ".bin"))
        s.ok = load_bin(p, point_cap, geom, &s);
      else if (ends_with(p, ".lpk"))
        s.ok = load_lpk(p, point_cap, &s);
      else if (ends_with(p, ".pcd"))
        s.ok = load_pcd(p, point_cap, geom, &s);
      std::unique_lock<std::mutex> lk(mu);
      // out_of_order is bounded by n_threads; only the ready queue is capped.
      cv_space.wait(lk, [&] { return stop.load() || ready.size() < capacity; });
      if (stop.load()) return;
      out_of_order.push_back(std::move(s));
      // Move any in-order scans to the ready queue.
      bool moved = true;
      while (moved) {
        moved = false;
        for (auto it = out_of_order.begin(); it != out_of_order.end(); ++it) {
          if (it->index == next_to_emit) {
            ready.push_back(std::move(*it));
            out_of_order.erase(it);
            next_to_emit++;
            moved = true;
            break;
          }
        }
      }
      cv_ready.notify_all();
    }
    cv_ready.notify_all();  // wake any reader waiting at end-of-sequence
  }
};

}  // namespace

extern "C" {

void* legoio_loader_create(const char** paths, int n_paths, int point_cap,
                           int n_scan, float ang_bottom_deg, float ang_res_y_deg,
                           int n_threads, int prefetch) {
  auto* L = new Loader();
  for (int i = 0; i < n_paths; i++) L->paths.emplace_back(paths[i]);
  L->point_cap = (size_t)point_cap;
  L->geom = SensorGeom{n_scan, ang_bottom_deg, ang_res_y_deg};
  L->capacity = (size_t)(prefetch > 0 ? prefetch : 4);
  L->n_threads = (size_t)(n_threads > 0 ? n_threads : 2);
  for (size_t i = 0; i < L->n_threads; i++)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Returns 1 on success, 0 at end of sequence, -1 on read error for this scan.
int legoio_loader_next(void* handle, float* xyz, uint8_t* valid,
                       int32_t* ring) {
  auto* L = reinterpret_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    return !L->ready.empty() || L->stop.load() ||
           (L->emitted >= (int64_t)L->paths.size());
  });
  if (L->ready.empty()) return 0;
  L->emitted++;
  Scan s = std::move(L->ready.front());
  L->ready.pop_front();
  L->cv_space.notify_all();
  lk.unlock();
  std::memcpy(xyz, s.xyz.data(), s.xyz.size() * sizeof(float));
  std::memcpy(valid, s.valid.data(), s.valid.size());
  std::memcpy(ring, s.ring.data(), s.ring.size() * sizeof(int32_t));
  return s.ok ? 1 : -1;
}

void legoio_loader_destroy(void* handle) {
  auto* L = reinterpret_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// One-shot single-file read (no threads): for tools/tests.
int legoio_read_scan(const char* path, int point_cap, int n_scan,
                     float ang_bottom_deg, float ang_res_y_deg, float* xyz,
                     uint8_t* valid, int32_t* ring) {
  Scan s;
  s.xyz.assign((size_t)point_cap * 3, 0.f);
  s.valid.assign((size_t)point_cap, 0);
  s.ring.assign((size_t)point_cap, 0);
  SensorGeom g{n_scan, ang_bottom_deg, ang_res_y_deg};
  std::string p(path);
  bool ok = false;
  if (ends_with(p, ".bin")) ok = load_bin(p, point_cap, g, &s);
  else if (ends_with(p, ".lpk")) ok = load_lpk(p, point_cap, &s);
  else if (ends_with(p, ".pcd")) ok = load_pcd(p, point_cap, g, &s);
  if (!ok) return -1;
  std::memcpy(xyz, s.xyz.data(), s.xyz.size() * sizeof(float));
  std::memcpy(valid, s.valid.data(), s.valid.size());
  std::memcpy(ring, s.ring.data(), s.ring.size() * sizeof(int32_t));
  return 1;
}

}  // extern "C"
