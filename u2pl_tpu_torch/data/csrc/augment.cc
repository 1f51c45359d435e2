// Host data plane of u2pl_tpu_torch: the per-sample geometric pipeline of
// the reference transform stack (normalize -> random scale resize -> hflip
// -> crop-with-pad; reference u2pl/dataset/augmentation.py) fused into one
// gather pass, a copy of the JAX package's u2pl_tpu/native/augment.cc.  For
// every output pixel: crop coords -> padded coords -> scaled coords ->
// source coords, sampled once, with no intermediate buffers; the GIL is
// released through ctypes.  Bilinear with half-pixel centres on the image
// (torch align_corners=False == cv2 INTER_LINEAR), floor-index nearest on
// the label (torch mode="nearest"); normalization commutes with bilinear
// resampling, so it is applied at the sample site.
//
// The Python side (data/transforms.py:FusedNativeTransform) draws every
// random number with the reference's `random` calls; this library only
// does the arithmetic.  Built with g++ at first use (data/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline float sample_bilinear_u8(const uint8_t* img, int h, int w, int c,
                                int ch, float sy, float sx) {
  // half-pixel source coords, clamped like cv2/torch
  float fy = sy;
  float fx = sx;
  if (fy < 0) fy = 0;
  if (fx < 0) fx = 0;
  int y0 = static_cast<int>(fy);
  int x0 = static_cast<int>(fx);
  if (y0 > h - 1) y0 = h - 1;
  if (x0 > w - 1) x0 = w - 1;
  int y1 = std::min(y0 + 1, h - 1);
  int x1 = std::min(x0 + 1, w - 1);
  float dy = fy - y0;
  float dx = fx - x0;
  const float v00 = img[(y0 * w + x0) * c + ch];
  const float v01 = img[(y0 * w + x1) * c + ch];
  const float v10 = img[(y1 * w + x0) * c + ch];
  const float v11 = img[(y1 * w + x1) * c + ch];
  return v00 * (1 - dy) * (1 - dx) + v01 * (1 - dy) * dx +
         v10 * dy * (1 - dx) + v11 * dy * dx;
}

}  // namespace

extern "C" {

// One fused sample: decode buffers in, augmented crop out.
//   img:    (h, w, 3) uint8 RGB
//   label:  (h, w) uint8
//   new_h/new_w: scaled size (host computed: int(h*scale_h), int(w*scale_w))
//   flip:   mirror horizontally (applied in scaled space, pre-crop)
//   off_y/off_x: crop origin in PADDED scaled space; padding is centered
//       (pad_h_half = (crop - new)/2 when new < crop), image pad value 0,
//       label pad value pad_label (reference quirk: 0, augmentation.py:242)
//   out_img: (crop_h, crop_w, 3) float32 normalized; out_label int32
void u2pl_augment_sample(const uint8_t* img, int h, int w,
                         const uint8_t* label,
                         const float* mean, const float* stdv,
                         const float* pad_rgb,
                         int new_h, int new_w, int flip,
                         int crop_h, int crop_w, int off_y, int off_x,
                         int pad_label,
                         float* out_img, int32_t* out_label) {
  const int pad_h = std::max(crop_h - new_h, 0);
  const int pad_w = std::max(crop_w - new_w, 0);
  const int ph0 = pad_h / 2;
  const int pw0 = pad_w / 2;
  const double ry = static_cast<double>(h) / new_h;
  const double rx = static_cast<double>(w) / new_w;

  for (int oy = 0; oy < crop_h; ++oy) {
    const int py = oy + off_y;        // padded scaled-space row
    const int syi = py - ph0;         // scaled-space row
    const bool row_in = syi >= 0 && syi < new_h;
    for (int ox = 0; ox < crop_w; ++ox) {
      const int px = ox + off_x;
      int sxi = px - pw0;
      float* op = out_img + (oy * crop_w + ox) * 3;
      int32_t* lp = out_label + oy * crop_w + ox;
      if (!row_in || sxi < 0 || sxi >= new_w) {
        // reference pads the already-normalized image with 0 (Normalize
        // runs before Crop) -> pad_rgb is 0 in normalized mode and
        // round(mean) raw bytes in uint8 mode
        op[0] = pad_rgb[0];
        op[1] = pad_rgb[1];
        op[2] = pad_rgb[2];
        *lp = pad_label;
        continue;
      }
      if (flip) sxi = new_w - 1 - sxi;
      // bilinear image sample at half-pixel centers
      const float sy = static_cast<float>((syi + 0.5) * ry - 0.5);
      const float sx = static_cast<float>((sxi + 0.5) * rx - 0.5);
      for (int ch = 0; ch < 3; ++ch) {
        const float v = sample_bilinear_u8(img, h, w, 3, ch, sy, sx);
        op[ch] = (v - mean[ch]) / stdv[ch];
      }
      // nearest label: floor index mapping (torch mode="nearest")
      int ly = static_cast<int>(syi * ry);
      int lx = static_cast<int>(sxi * rx);
      if (ly > h - 1) ly = h - 1;
      if (lx > w - 1) lx = w - 1;
      *lp = label[ly * w + lx];
    }
  }
}

}  // extern "C"
