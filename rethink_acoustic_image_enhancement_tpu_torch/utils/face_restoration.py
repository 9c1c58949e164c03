"""Face-restoration helper: align -> restore -> paste-back geometry.

Port of the reference's face pipeline (Train/basicsr/utils/face_util.py:
16-217, FaceRestorationHelper): 5-landmark similarity alignment onto the
FFHQ template, warp-crop to a square face, and seamless inverse paste with
border erosion + soft-mask feathering.

Differences from the reference, by design:
  * Landmark *detection* (dlib CNN detector + shape predictors,
    face_util.py:41-50) needs pretrained dlib models, downloaded out of
    band; detection is an optional dlib-gated path
    (`detect_landmarks_dlib`), while landmarks can always be supplied
    explicitly (`add_landmarks`) — from any detector the user runs.
  * The 2-D similarity estimation is a self-contained Umeyama
    least-squares solve (no skimage dependency).
  * Inverse affines are numpy arrays; the warps are cv2's ``warpAffine``
    (a numpy nearest-neighbour fallback in ``warp_affine`` without cv2),
    not ``ops/warp.py::flow_warp``.
"""

from __future__ import annotations

import numpy as np

# standard 5 landmarks for FFHQ faces at 1024x1024 (face_util.py:23-28)
FFHQ_TEMPLATE_1024 = np.array([
    [686.77227723, 488.62376238],
    [586.77227723, 493.59405941],
    [337.91089109, 488.38613861],
    [437.95049505, 493.51485149],
    [513.58415842, 678.50495050],
])


def estimate_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares 2-D similarity transform (rotation+scale+translation)
    mapping src -> dst points; returns a 2x3 affine matrix.

    Umeyama (1991) closed form, the math behind skimage's
    SimilarityTransform.estimate used at face_util.py:141-143.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.diag([1.0, d])
    var_s = (sc ** 2).sum() / len(src)
    scale = np.trace(np.diag(s) @ diag) / var_s
    rot = u @ diag @ vt
    t = mu_d - scale * rot @ mu_s
    out = np.zeros((2, 3))
    out[:, :2] = scale * rot
    out[:, 2] = t
    return out


def warp_affine(img: np.ndarray, matrix: np.ndarray,
                out_hw: tuple[int, int]) -> np.ndarray:
    """cv2.warpAffine with a numpy nearest-neighbor fallback."""
    try:
        import cv2

        return cv2.warpAffine(img, matrix.astype(np.float32),
                              (out_hw[1], out_hw[0]))
    except ImportError:
        inv = invert_affine(matrix)
        yy, xx = np.mgrid[0:out_hw[0], 0:out_hw[1]]
        sx = inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2]
        sy = inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2]
        sxi = np.clip(np.round(sx).astype(int), 0, img.shape[1] - 1)
        syi = np.clip(np.round(sy).astype(int), 0, img.shape[0] - 1)
        out = img[syi, sxi]
        valid = ((sx >= 0) & (sx < img.shape[1])
                 & (sy >= 0) & (sy < img.shape[0]))
        return np.where(valid[..., None] if out.ndim == 3 else valid,
                        out, 0).astype(img.dtype)


def invert_affine(matrix: np.ndarray) -> np.ndarray:
    m = np.vstack([matrix, [0, 0, 1]])
    return np.linalg.inv(m)[:2, :]


class FaceRestorationHelper:
    """Geometry pipeline: landmarks -> aligned crops -> pasted result.

    Usage (face_util.py call order):
        helper = FaceRestorationHelper(upscale_factor=2, face_size=512)
        helper.read_image(img)                 # HWC RGB float/uint8
        helper.add_landmarks(lm5)              # one (5, 2) array per face
        crops = helper.warp_crop_faces()
        for c in crops: helper.add_restored_face(restore(c))
        out = helper.paste_faces_to_image()
    """

    def __init__(self, upscale_factor: int = 1, face_size: int = 512):
        self.upscale_factor = upscale_factor
        self.face_size = (face_size, face_size)
        # template scaling trick preserved (face_util.py:29 uses integer
        # division of 1024 by face_size)
        self.face_template = FFHQ_TEMPLATE_1024 / (1024 // face_size)
        self.clean_all()

    def clean_all(self) -> None:
        self.input_img = None
        self.all_landmarks_5: list[np.ndarray] = []
        self.affine_matrices: list[np.ndarray] = []
        self.inverse_affine_matrices: list[np.ndarray] = []
        self.cropped_faces: list[np.ndarray] = []
        self.restored_faces: list[np.ndarray] = []

    def read_image(self, img: np.ndarray) -> None:
        self.input_img = np.asarray(img)

    def add_landmarks(self, landmarks5: np.ndarray) -> None:
        lm = np.asarray(landmarks5, np.float64)
        if lm.shape != (5, 2):
            raise ValueError(f"expected (5, 2) landmarks, got {lm.shape}")
        self.all_landmarks_5.append(lm)

    def detect_landmarks_dlib(self, detection_path: str, landmark5_path: str,
                              upsample_num_times: int = 1,
                              only_keep_largest: bool = False) -> int:
        """Optional dlib detection path (face_util.py:41-93); requires the
        pretrained dlib models the reference downloads out-of-band."""
        import dlib  # gated: not installed in minimal envs

        detector = dlib.cnn_face_detection_model_v1(detection_path)
        predictor = dlib.shape_predictor(landmark5_path)
        dets = detector(self.input_img, upsample_num_times)
        if only_keep_largest and len(dets) > 1:
            areas = [(d.rect.right() - d.rect.left())
                     * (d.rect.bottom() - d.rect.top()) for d in dets]
            dets = [dets[int(np.argmax(areas))]]
        for det in dets:
            shape = predictor(self.input_img, det.rect)
            self.add_landmarks([[p.x, p.y] for p in shape.parts()])
        return len(dets)

    def warp_crop_faces(self) -> list[np.ndarray]:
        """Affine-align each face to the template crop; records forward and
        inverse (upscaled) matrices (face_util.py:133-166)."""
        for landmark in self.all_landmarks_5:
            affine = estimate_similarity(landmark, self.face_template)
            self.affine_matrices.append(affine)
            self.cropped_faces.append(
                warp_affine(self.input_img, affine, self.face_size))
            inverse = estimate_similarity(
                self.face_template, landmark * self.upscale_factor)
            self.inverse_affine_matrices.append(inverse)
        return self.cropped_faces

    def add_restored_face(self, face: np.ndarray) -> None:
        self.restored_faces.append(np.asarray(face))

    def paste_faces_to_image(self) -> np.ndarray:
        """Inverse-warp restored faces onto the upscaled background with
        border erosion + gaussian soft mask (face_util.py:171-208)."""
        import cv2

        h, w = self.input_img.shape[:2]
        h_up, w_up = h * self.upscale_factor, w * self.upscale_factor
        upsample_img = cv2.resize(self.input_img.astype(np.float32),
                                  (w_up, h_up))
        if len(self.restored_faces) != len(self.inverse_affine_matrices):
            raise ValueError("restored_faces and affine matrices differ in "
                             "length")
        for restored, inverse in zip(self.restored_faces,
                                     self.inverse_affine_matrices):
            inv_restored = cv2.warpAffine(restored.astype(np.float32),
                                          inverse.astype(np.float32),
                                          (w_up, h_up))
            mask = np.ones((*self.face_size, 3), np.float32)
            inv_mask = cv2.warpAffine(mask, inverse.astype(np.float32),
                                      (w_up, h_up))
            k = 2 * self.upscale_factor
            inv_mask_erosion = cv2.erode(inv_mask, np.ones((k, k), np.uint8))
            inv_restored *= inv_mask_erosion
            total_face_area = np.sum(inv_mask_erosion) // 3
            w_edge = int(total_face_area ** 0.5) // 20
            if w_edge > 0:
                r = w_edge * 2
                inv_mask_center = cv2.erode(inv_mask_erosion,
                                            np.ones((r, r), np.uint8))
                inv_soft_mask = cv2.GaussianBlur(inv_mask_center,
                                                 (r + 1, r + 1), 0)
            else:
                inv_soft_mask = inv_mask_erosion
            upsample_img = (inv_soft_mask * inv_restored
                            + (1 - inv_soft_mask) * upsample_img)
        return upsample_img
