// grace_jax native IO: Gadget-2 snapshot reader, PLY triangle-mesh reader,
// BMP image writer.
//
// Native (C ABI, ctypes-loaded) equivalents of the reference's native data
// loaders: tests/helper/read_gadget.cuh (Gadget-2 type-1 reader),
// tests/helper/ply.c (Stanford PLY reader, 3k LoC vendored) and
// tests/helper/images.hpp (24-bit BMP writer). The hot path is bulk
// fread + in-place stride copy — the Python layer wraps the raw buffers as
// numpy arrays without further copies.
//
// Build: g++ -O3 -shared -fPIC -o libgrace_io.so grace_io.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Gadget-2 (format 1) snapshot reader
// ---------------------------------------------------------------------------

struct GadgetHeader {
  int32_t npart[6];
  double mass[6];
  char fill[256 - 6 * 4 - 6 * 8];
};

static bool skip_bytes(FILE* f, long n) { return std::fseek(f, n, SEEK_CUR) == 0; }

static bool skip_marker(FILE* f) { return skip_bytes(f, 4); }

// Reads the header. Returns 0 on success, negative error code otherwise.
int grace_gadget_header(const char* path, int32_t* npart6, double* mass6) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  GadgetHeader h;
  if (!skip_marker(f) || std::fread(&h, sizeof(h), 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  std::memcpy(npart6, h.npart, sizeof(h.npart));
  std::memcpy(mass6, h.mass, sizeof(h.mass));
  return 0;
}

// Reads gas particle positions + smoothing lengths into out[4 * N_gas]
// (x, y, z, h interleaved — the float4 layout of the reference reader).
// Returns N_gas on success, negative error code otherwise.
int grace_gadget_read_gas(const char* path, float* out, int64_t capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  GadgetHeader h;
  if (!skip_marker(f) || std::fread(&h, sizeof(h), 1, f) != 1 || !skip_marker(f)) {
    std::fclose(f);
    return -2;
  }
  const int64_t n_gas = h.npart[0];
  int64_t n_total = 0, n_withmass = 0;
  for (int i = 0; i < 6; ++i) {
    n_total += h.npart[i];
    if (h.mass[i] == 0) n_withmass += h.npart[i];
  }
  if (n_gas == 0) {
    std::fclose(f);
    return -3;  // no gas particles (ref read_gadget.cuh throws here)
  }
  if (n_gas > capacity) {
    std::fclose(f);
    return -4;
  }

  // Positions: bulk-read the gas block, skip the rest.
  std::vector<float> pos(3 * n_gas);
  bool ok = skip_marker(f) && std::fread(pos.data(), sizeof(float), 3 * n_gas, f) ==
                                  static_cast<size_t>(3 * n_gas) &&
            skip_bytes(f, 12L * (n_total - n_gas)) && skip_marker(f);
  // Velocities, IDs.
  ok = ok && skip_marker(f) && skip_bytes(f, 12L * n_total) && skip_marker(f);
  ok = ok && skip_marker(f) && skip_bytes(f, 4L * n_total) && skip_marker(f);
  // Optional masses (only for species with header mass == 0).
  if (ok && n_withmass > 0)
    ok = skip_marker(f) && skip_bytes(f, 4L * n_withmass) && skip_marker(f);
  // Gas-only blocks: internal energy, density, smoothing length.
  ok = ok && skip_marker(f) && skip_bytes(f, 4L * n_gas) && skip_marker(f);
  ok = ok && skip_marker(f) && skip_bytes(f, 4L * n_gas) && skip_marker(f);
  std::vector<float> hsml(n_gas);
  ok = ok && skip_marker(f) &&
       std::fread(hsml.data(), sizeof(float), n_gas, f) == static_cast<size_t>(n_gas);
  std::fclose(f);
  if (!ok) return -5;

  for (int64_t i = 0; i < n_gas; ++i) {
    out[4 * i + 0] = pos[3 * i + 0];
    out[4 * i + 1] = pos[3 * i + 1];
    out[4 * i + 2] = pos[3 * i + 2];
    out[4 * i + 3] = hsml[i];
  }
  return static_cast<int>(n_gas);
}

// Writes a Gadget-2 format-1 snapshot containing only gas particles with the
// given positions and smoothing lengths (used to fabricate test fixtures;
// velocities/IDs/u/rho are zero-filled).
int grace_gadget_write_gas(const char* path, const float* xyzh, int64_t n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  GadgetHeader h;
  std::memset(&h, 0, sizeof(h));
  h.npart[0] = static_cast<int32_t>(n);
  // mass[0] == 0 => per-particle mass block present.
  auto write_block = [&](const void* data, uint32_t bytes) {
    return std::fwrite(&bytes, 4, 1, f) == 1 &&
           (bytes == 0 || std::fwrite(data, 1, bytes, f) == bytes) &&
           std::fwrite(&bytes, 4, 1, f) == 1;
  };
  bool ok = write_block(&h, sizeof(h));
  std::vector<float> tmp(3 * n);
  for (int64_t i = 0; i < n; ++i) {
    tmp[3 * i] = xyzh[4 * i];
    tmp[3 * i + 1] = xyzh[4 * i + 1];
    tmp[3 * i + 2] = xyzh[4 * i + 2];
  }
  ok = ok && write_block(tmp.data(), 12 * n);           // positions
  std::memset(tmp.data(), 0, tmp.size() * sizeof(float));
  ok = ok && write_block(tmp.data(), 12 * n);           // velocities
  std::vector<uint32_t> ids(n);
  for (int64_t i = 0; i < n; ++i) ids[i] = static_cast<uint32_t>(i);
  ok = ok && write_block(ids.data(), 4 * n);            // IDs
  std::vector<float> scalar(n, 1.0f);
  ok = ok && write_block(scalar.data(), 4 * n);         // masses
  std::memset(scalar.data(), 0, n * sizeof(float));
  ok = ok && write_block(scalar.data(), 4 * n);         // u
  ok = ok && write_block(scalar.data(), 4 * n);         // rho
  for (int64_t i = 0; i < n; ++i) scalar[i] = xyzh[4 * i + 3];
  ok = ok && write_block(scalar.data(), 4 * n);         // hsml
  std::fclose(f);
  return ok ? 0 : -2;
}

// ---------------------------------------------------------------------------
// Minimal PLY triangle-mesh reader (ascii / binary_little_endian)
// ---------------------------------------------------------------------------

struct PlyInfo {
  long n_verts;
  long n_faces;
  int fmt;            // 0 = ascii, 1 = binary_little_endian
  long data_offset;   // byte offset where element data starts
  int vert_props;     // number of scalar properties per vertex
  int vert_prop_bytes;// bytes per vertex record (binary)
  int face_index_bytes;  // bytes per index (binary)
  int face_count_bytes;  // bytes of the list-count field (binary)
};

static int prop_size(const std::string& t) {
  if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
  if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
  if (t == "int" || t == "uint" || t == "int32" || t == "uint32" || t == "float" ||
      t == "float32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  return -1;
}

static bool parse_ply_header(FILE* f, PlyInfo* info) {
  char line[512];
  if (!std::fgets(line, sizeof(line), f) || std::strncmp(line, "ply", 3) != 0)
    return false;
  info->n_verts = info->n_faces = 0;
  info->fmt = -1;
  info->vert_props = 0;
  info->vert_prop_bytes = 0;
  info->face_index_bytes = 4;
  info->face_count_bytes = 1;
  int cur_element = -1;  // 0 = vertex, 1 = face, 2 = other
  while (std::fgets(line, sizeof(line), f)) {
    std::string s(line);
    if (s.rfind("format", 0) == 0) {
      if (s.find("ascii") != std::string::npos) info->fmt = 0;
      else if (s.find("binary_little_endian") != std::string::npos) info->fmt = 1;
      else return false;
    } else if (s.rfind("element vertex", 0) == 0) {
      info->n_verts = std::strtol(s.c_str() + 14, nullptr, 10);
      cur_element = 0;
    } else if (s.rfind("element face", 0) == 0) {
      info->n_faces = std::strtol(s.c_str() + 12, nullptr, 10);
      cur_element = 1;
    } else if (s.rfind("element", 0) == 0) {
      cur_element = 2;
    } else if (s.rfind("property", 0) == 0) {
      if (cur_element == 0) {
        char t[64];
        if (std::sscanf(s.c_str(), "property %63s", t) == 1) {
          int sz = prop_size(t);
          if (sz < 0) return false;
          info->vert_props += 1;
          info->vert_prop_bytes += sz;
        }
      } else if (cur_element == 1) {
        char kw[64], ct[64], it[64];
        if (std::sscanf(s.c_str(), "property %63s %63s %63s", kw, ct, it) == 3 &&
            std::strcmp(kw, "list") == 0) {
          info->face_count_bytes = prop_size(ct);
          info->face_index_bytes = prop_size(it);
        }
      }
    } else if (s.rfind("end_header", 0) == 0) {
      info->data_offset = std::ftell(f);
      return info->fmt >= 0 && info->n_verts > 0;
    }
  }
  return false;
}

int grace_ply_counts(const char* path, long* n_verts, long* n_faces) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  PlyInfo info;
  bool ok = parse_ply_header(f, &info);
  std::fclose(f);
  if (!ok) return -2;
  *n_verts = info.n_verts;
  *n_faces = info.n_faces;
  return 0;
}

// Reads vertices (x, y, z from the first 3 properties) and triangle indices.
// verts: float[3 * n_verts]; tris: int32[3 * n_faces]. Faces with more than 3
// vertices are fan-triangulated only if they are quads; higher arity fails.
// Returns number of triangles written, or negative error code.
int grace_ply_read(const char* path, float* verts, int32_t* tris, int64_t max_tris) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  PlyInfo info;
  if (!parse_ply_header(f, &info)) {
    std::fclose(f);
    return -2;
  }
  long n_tris = 0;
  if (info.fmt == 0) {
    for (long i = 0; i < info.n_verts; ++i) {
      double p[3] = {0, 0, 0};
      for (int k = 0; k < info.vert_props; ++k) {
        double v;
        if (std::fscanf(f, "%lf", &v) != 1) { std::fclose(f); return -3; }
        if (k < 3) p[k] = v;
      }
      verts[3 * i] = (float)p[0];
      verts[3 * i + 1] = (float)p[1];
      verts[3 * i + 2] = (float)p[2];
    }
    for (long i = 0; i < info.n_faces; ++i) {
      long cnt, idx[4];
      if (std::fscanf(f, "%ld", &cnt) != 1 || cnt < 3 || cnt > 4) {
        std::fclose(f);
        return -4;
      }
      for (long k = 0; k < cnt; ++k)
        if (std::fscanf(f, "%ld", &idx[k]) != 1) { std::fclose(f); return -3; }
      for (long k = 2; k < cnt; ++k) {
        if (n_tris >= max_tris) { std::fclose(f); return -5; }
        tris[3 * n_tris] = (int32_t)idx[0];
        tris[3 * n_tris + 1] = (int32_t)idx[k - 1];
        tris[3 * n_tris + 2] = (int32_t)idx[k];
        ++n_tris;
      }
    }
  } else {
    std::fseek(f, info.data_offset, SEEK_SET);
    std::vector<unsigned char> rec(info.vert_prop_bytes);
    for (long i = 0; i < info.n_verts; ++i) {
      if (std::fread(rec.data(), 1, rec.size(), f) != rec.size()) {
        std::fclose(f);
        return -3;
      }
      // First three properties are x, y, z floats in every PLY we care about.
      std::memcpy(&verts[3 * i], rec.data(), 3 * sizeof(float));
    }
    for (long i = 0; i < info.n_faces; ++i) {
      long cnt = 0;
      unsigned char cb[8] = {0};
      if (std::fread(cb, 1, info.face_count_bytes, f) !=
          (size_t)info.face_count_bytes) {
        std::fclose(f);
        return -3;
      }
      std::memcpy(&cnt, cb, info.face_count_bytes);
      if (cnt < 3 || cnt > 4) { std::fclose(f); return -4; }
      int32_t idx[4] = {0, 0, 0, 0};
      for (long k = 0; k < cnt; ++k) {
        unsigned char ib[8] = {0};
        if (std::fread(ib, 1, info.face_index_bytes, f) !=
            (size_t)info.face_index_bytes) {
          std::fclose(f);
          return -3;
        }
        std::memcpy(&idx[k], ib, info.face_index_bytes);
      }
      for (long k = 2; k < cnt; ++k) {
        if (n_tris >= max_tris) { std::fclose(f); return -5; }
        tris[3 * n_tris] = idx[0];
        tris[3 * n_tris + 1] = idx[k - 1];
        tris[3 * n_tris + 2] = idx[k];
        ++n_tris;
      }
    }
  }
  std::fclose(f);
  return (int)n_tris;
}

// ---------------------------------------------------------------------------
// 24-bit BMP writer (ref: tests/helper/images.hpp:13-99)
// ---------------------------------------------------------------------------

int grace_write_bmp(const char* path, const unsigned char* rgb, int w, int h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const int row_bytes = (3 * w + 3) & ~3;
  const uint32_t data_size = row_bytes * h;
  const uint32_t file_size = 54 + data_size;
  unsigned char hdr[54] = {0};
  hdr[0] = 'B'; hdr[1] = 'M';
  std::memcpy(hdr + 2, &file_size, 4);
  uint32_t off = 54; std::memcpy(hdr + 10, &off, 4);
  uint32_t ihs = 40; std::memcpy(hdr + 14, &ihs, 4);
  std::memcpy(hdr + 18, &w, 4);
  std::memcpy(hdr + 22, &h, 4);
  uint16_t planes = 1, bpp = 24;
  std::memcpy(hdr + 26, &planes, 2);
  std::memcpy(hdr + 28, &bpp, 2);
  std::memcpy(hdr + 34, &data_size, 4);
  bool ok = std::fwrite(hdr, 1, 54, f) == 54;
  std::vector<unsigned char> row(row_bytes, 0);
  // BMP rows are bottom-up, pixels BGR.
  for (int y = h - 1; ok && y >= 0; --y) {
    for (int x = 0; x < w; ++x) {
      row[3 * x] = rgb[3 * (y * w + x) + 2];
      row[3 * x + 1] = rgb[3 * (y * w + x) + 1];
      row[3 * x + 2] = rgb[3 * (y * w + x)];
    }
    ok = std::fwrite(row.data(), 1, row_bytes, f) == (size_t)row_bytes;
  }
  std::fclose(f);
  return ok ? 0 : -2;
}

}  // extern "C"
