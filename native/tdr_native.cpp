// tdr native host library: SVG vector-map parsing + even-odd
// polygon rasterization.
//
// Host-native counterpart of the reference's map-loading path: vendored
// nanosvg + TopDownMap::loadSvg/getClasses
// (/root/reference/src/top_down_map.cpp:66-114, 328-365).  Written from
// scratch for the subset the framework consumes: <svg> dimensions;
// <path>/<polygon>/<polyline>/<rect> outlines with solid fills; path
// data M/L/H/V/C/S/Q/T/A/Z (on-curve endpoints only - the reference
// likewise keeps every 3rd bezier point); even-odd fill rule with
// per-class polygon lists.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Poly {
  std::vector<float> xy;  // x0 y0 x1 y1 ...
  uint32_t fill = 0xFFFFFFFF;  // 0xRRGGBB, 0xFFFFFFFF = none
};

struct SvgDoc {
  float width = 0, height = 0;
  std::vector<Poly> polys;
};

// ---------------------------------------------------------------- utils
bool is_num_start(char c) {
  return std::isdigit((unsigned char)c) || c == '-' || c == '+' ||
         c == '.';
}

double parse_num(const std::string& s, size_t& i) {
  while (i < s.size() &&
         (std::isspace((unsigned char)s[i]) || s[i] == ','))
    ++i;
  size_t start = i;
  if (i < s.size() && (s[i] == '-' || s[i] == '+')) ++i;
  while (i < s.size() &&
         (std::isdigit((unsigned char)s[i]) || s[i] == '.'))
    ++i;
  if (i < s.size() && (s[i] == 'e' || s[i] == 'E')) {
    ++i;
    if (i < s.size() && (s[i] == '-' || s[i] == '+')) ++i;
    while (i < s.size() && std::isdigit((unsigned char)s[i])) ++i;
  }
  return std::strtod(s.c_str() + start, nullptr);
}

uint32_t parse_color(const std::string& v) {
  if (v.empty() || v == "none" || v == "transparent") return 0xFFFFFFFF;
  if (v[0] == '#') {
    std::string h = v.substr(1);
    if (h.size() == 3) {
      std::string e;
      for (char c : h) {
        e += c;
        e += c;
      }
      h = e;
    }
    if (h.size() < 6) return 0xFFFFFFFF;
    return (uint32_t)std::strtoul(h.substr(0, 6).c_str(), nullptr, 16);
  }
  if (v.rfind("rgb", 0) == 0) {
    int r, g, b;
    if (std::sscanf(v.c_str(), "rgb(%d,%d,%d)", &r, &g, &b) == 3 ||
        std::sscanf(v.c_str(), "rgb( %d , %d , %d )", &r, &g, &b) == 3)
      return ((uint32_t)r << 16) | ((uint32_t)g << 8) | (uint32_t)b;
  }
  return 0xFFFFFFFF;
}

// very small XML tag scanner: yields (tag_name, attrs-substring)
struct Tag {
  std::string name;
  std::string attrs;
};

std::string get_attr(const std::string& attrs, const std::string& key) {
  size_t i = 0;
  while (true) {
    i = attrs.find(key, i);
    if (i == std::string::npos) return "";
    // require word boundary before and '=' after (possibly spaced)
    if (i > 0 && (std::isalnum((unsigned char)attrs[i - 1]) ||
                  attrs[i - 1] == '-' || attrs[i - 1] == ':')) {
      i += key.size();
      continue;
    }
    size_t j = i + key.size();
    while (j < attrs.size() && std::isspace((unsigned char)attrs[j])) ++j;
    if (j >= attrs.size() || attrs[j] != '=') {
      i = j;
      continue;
    }
    ++j;
    while (j < attrs.size() && std::isspace((unsigned char)attrs[j])) ++j;
    if (j >= attrs.size()) return "";
    char q = attrs[j];
    if (q != '"' && q != '\'') return "";
    size_t end = attrs.find(q, j + 1);
    if (end == std::string::npos) return "";
    return attrs.substr(j + 1, end - j - 1);
  }
}

float parse_length(const std::string& s) {
  if (s.empty()) return 0;
  size_t i = 0;
  return (float)parse_num(s, i);
}

uint32_t element_fill(const std::string& attrs) {
  std::string fill = get_attr(attrs, "fill");
  if (fill.empty()) {
    std::string style = get_attr(attrs, "style");
    size_t p = style.find("fill:");
    if (p != std::string::npos) {
      size_t e = style.find(';', p);
      fill = style.substr(p + 5, e == std::string::npos
                                     ? std::string::npos
                                     : e - p - 5);
      // trim
      while (!fill.empty() && std::isspace((unsigned char)fill.front()))
        fill.erase(fill.begin());
      while (!fill.empty() && std::isspace((unsigned char)fill.back()))
        fill.pop_back();
    }
  }
  return parse_color(fill);
}

// SVG path data -> subpath vertex lists (on-curve points only)
void parse_path_d(const std::string& d, uint32_t fill,
                  std::vector<Poly>& out) {
  size_t i = 0;
  char cmd = 0;
  double x = 0, y = 0, sx = 0, sy = 0;
  Poly cur;
  cur.fill = fill;
  auto flush = [&]() {
    if (cur.xy.size() >= 6) out.push_back(cur);
    cur.xy.clear();
    cur.fill = fill;
  };
  while (i < d.size()) {
    char c = d[i];
    if (std::isspace((unsigned char)c) || c == ',') {
      ++i;
      continue;
    }
    if (std::isalpha((unsigned char)c)) {
      cmd = c;
      ++i;
      if (cmd == 'Z' || cmd == 'z') {
        flush();
        x = sx;
        y = sy;
        continue;
      }
    } else if (!cmd) {
      break;
    }
    bool rel = std::islower((unsigned char)cmd);
    char C = (char)std::toupper((unsigned char)cmd);
    switch (C) {
      case 'M': {
        double nx = parse_num(d, i), ny = parse_num(d, i);
        if (rel) {
          nx += x;
          ny += y;
        }
        flush();
        x = sx = nx;
        y = sy = ny;
        cur.xy.push_back((float)x);
        cur.xy.push_back((float)y);
        cmd = rel ? 'l' : 'L';
        break;
      }
      case 'L': {
        double nx = parse_num(d, i), ny = parse_num(d, i);
        if (rel) {
          nx += x;
          ny += y;
        }
        x = nx;
        y = ny;
        cur.xy.push_back((float)x);
        cur.xy.push_back((float)y);
        break;
      }
      case 'H': {
        double nx = parse_num(d, i);
        if (rel) nx += x;
        x = nx;
        cur.xy.push_back((float)x);
        cur.xy.push_back((float)y);
        break;
      }
      case 'V': {
        double ny = parse_num(d, i);
        if (rel) ny += y;
        y = ny;
        cur.xy.push_back((float)x);
        cur.xy.push_back((float)y);
        break;
      }
      case 'C': {
        parse_num(d, i);
        parse_num(d, i);
        parse_num(d, i);
        parse_num(d, i);
        double nx = parse_num(d, i), ny = parse_num(d, i);
        if (rel) {
          nx += x;
          ny += y;
        }
        x = nx;
        y = ny;
        cur.xy.push_back((float)x);
        cur.xy.push_back((float)y);
        break;
      }
      case 'S':
      case 'Q': {
        parse_num(d, i);
        parse_num(d, i);
        double nx = parse_num(d, i), ny = parse_num(d, i);
        if (rel) {
          nx += x;
          ny += y;
        }
        x = nx;
        y = ny;
        cur.xy.push_back((float)x);
        cur.xy.push_back((float)y);
        break;
      }
      case 'T': {
        double nx = parse_num(d, i), ny = parse_num(d, i);
        if (rel) {
          nx += x;
          ny += y;
        }
        x = nx;
        y = ny;
        cur.xy.push_back((float)x);
        cur.xy.push_back((float)y);
        break;
      }
      case 'A': {
        parse_num(d, i);
        parse_num(d, i);
        parse_num(d, i);
        parse_num(d, i);
        parse_num(d, i);
        double nx = parse_num(d, i), ny = parse_num(d, i);
        if (rel) {
          nx += x;
          ny += y;
        }
        x = nx;
        y = ny;
        cur.xy.push_back((float)x);
        cur.xy.push_back((float)y);
        break;
      }
      default:
        ++i;
        break;
    }
  }
  flush();
}

SvgDoc* parse_svg(const char* path) {
  std::ifstream f(path);
  if (!f) return nullptr;
  std::stringstream ss;
  ss << f.rdbuf();
  std::string s = ss.str();

  auto* doc = new SvgDoc();
  size_t i = 0;
  while (true) {
    size_t lt = s.find('<', i);
    if (lt == std::string::npos) break;
    size_t gt = s.find('>', lt);
    if (gt == std::string::npos) break;
    std::string tag = s.substr(lt + 1, gt - lt - 1);
    i = gt + 1;
    if (tag.empty() || tag[0] == '!' || tag[0] == '?' || tag[0] == '/')
      continue;
    size_t sp = 0;
    while (sp < tag.size() && !std::isspace((unsigned char)tag[sp])) ++sp;
    std::string name = tag.substr(0, sp);
    std::string attrs = tag.substr(sp);
    // strip namespace
    size_t colon = name.find(':');
    if (colon != std::string::npos) name = name.substr(colon + 1);

    if (name == "svg") {
      doc->width = parse_length(get_attr(attrs, "width"));
      doc->height = parse_length(get_attr(attrs, "height"));
      if (doc->width == 0 || doc->height == 0) {
        std::string vb = get_attr(attrs, "viewBox");
        if (!vb.empty()) {
          size_t k = 0;
          parse_num(vb, k);
          parse_num(vb, k);
          doc->width = (float)parse_num(vb, k);
          doc->height = (float)parse_num(vb, k);
        }
      }
    } else if (name == "path") {
      uint32_t fill = element_fill(attrs);
      if (fill != 0xFFFFFFFF)
        parse_path_d(get_attr(attrs, "d"), fill, doc->polys);
    } else if (name == "polygon" || name == "polyline") {
      uint32_t fill = element_fill(attrs);
      if (fill != 0xFFFFFFFF) {
        std::string pts = get_attr(attrs, "points");
        Poly p;
        p.fill = fill;
        size_t k = 0;
        while (k < pts.size()) {
          while (k < pts.size() && !is_num_start(pts[k])) ++k;
          if (k >= pts.size()) break;
          p.xy.push_back((float)parse_num(pts, k));
          while (k < pts.size() && !is_num_start(pts[k])) ++k;
          if (k >= pts.size()) break;
          p.xy.push_back((float)parse_num(pts, k));
        }
        if (p.xy.size() >= 6) doc->polys.push_back(p);
      }
    } else if (name == "rect") {
      uint32_t fill = element_fill(attrs);
      if (fill != 0xFFFFFFFF) {
        float x = parse_length(get_attr(attrs, "x"));
        float y = parse_length(get_attr(attrs, "y"));
        float w = parse_length(get_attr(attrs, "width"));
        float h = parse_length(get_attr(attrs, "height"));
        Poly p;
        p.fill = fill;
        float xy[8] = {x, y, x + w, y, x + w, y + h, x, y + h};
        p.xy.assign(xy, xy + 8);
        doc->polys.push_back(p);
      }
    }
  }
  return doc;
}

}  // namespace

extern "C" {

// ---- SVG API (ctypes) ----
void* tdr_svg_parse(const char* path) { return parse_svg(path); }

void tdr_svg_free(void* h) { delete (SvgDoc*)h; }

void tdr_svg_dims(void* h, float* w, float* hgt) {
  auto* d = (SvgDoc*)h;
  *w = d->width;
  *hgt = d->height;
}

int32_t tdr_svg_num_polys(void* h) {
  return (int32_t)((SvgDoc*)h)->polys.size();
}

int32_t tdr_svg_total_verts(void* h) {
  auto* d = (SvgDoc*)h;
  size_t n = 0;
  for (auto& p : d->polys) n += p.xy.size() / 2;
  return (int32_t)n;
}

// fills: verts (total*2 f32), counts (n_polys i32), fills (n_polys u32)
void tdr_svg_copy(void* h, float* verts, int32_t* counts,
                  uint32_t* fills) {
  auto* d = (SvgDoc*)h;
  size_t vi = 0;
  for (size_t p = 0; p < d->polys.size(); ++p) {
    auto& poly = d->polys[p];
    counts[p] = (int32_t)(poly.xy.size() / 2);
    fills[p] = poly.fill;
    std::memcpy(verts + vi, poly.xy.data(),
                poly.xy.size() * sizeof(float));
    vi += poly.xy.size();
  }
}

// ---- even-odd rasterizer ----
// Fill `out` (h*w u8, row-major, row 0 = bottom) with 1 where inside any
// polygon of the list by the even-odd rule, sampling pixel centers at
// py = cy - res*(h-1)/2 + res*row, px likewise (the reference's
// samplePts grid, top_down_map.cpp:367-389).
void tdr_rasterize(const float* verts, const int32_t* counts,
                   int32_t n_polys, int32_t hh, int32_t ww, float cx,
                   float cy, float res, uint8_t* out) {
  std::memset(out, 0, (size_t)hh * ww);
  std::vector<double> xs;
  const float* v = verts;
  for (int32_t p = 0; p < n_polys; ++p) {
    int32_t n = counts[p];
    for (int32_t row = 0; row < hh; ++row) {
      double py = cy - res * (hh - 1) / 2.0 + res * row;
      xs.clear();
      for (int32_t e = 0; e < n; ++e) {
        int32_t j = (e + n - 1) % n;
        double yi = v[e * 2 + 1], yj = v[j * 2 + 1];
        double xi = v[e * 2], xj = v[j * 2];
        if ((py < yi) != (py < yj)) {
          xs.push_back(xi + (xj - xi) * (py - yi) / (yj - yi));
        }
      }
      if (xs.size() < 2) continue;
      std::sort(xs.begin(), xs.end());
      // even-odd inside spans are (xs[0], xs[1]), (xs[2], xs[3]), ...;
      // a pixel center is inside iff the crossings strictly to its
      // right are odd (the reference's px < xint test).  Spans within
      // one polygon are disjoint, and the class map is the UNION over
      // its polygons (top_down_map.cpp:339-349: per-poly buf + max).
      double px0 = cx - res * (ww - 1) / 2.0;
      for (size_t k = 0; k + 1 < xs.size(); k += 2) {
        int32_t c0 = (int32_t)std::floor((xs[k] - px0) / res) + 1;
        int32_t c1 = (int32_t)std::ceil((xs[k + 1] - px0) / res) - 1;
        if (c0 < 0) c0 = 0;
        if (c1 >= ww) c1 = ww - 1;
        for (int32_t cpx = c0; cpx <= c1; ++cpx)
          out[(size_t)row * ww + cpx] |= 1;
      }
    }
    v += n * 2;
  }
}

}  // extern "C"
