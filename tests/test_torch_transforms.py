"""paddle.vision's data side on the port against the JAX package's, on
the CPU: every transform and functional at one seeded uint8 image, the
image backends, and every dataset over synthetic data or local files.

The random transforms draw from Python's global `random` stream in both
packages, so each comparison seeds it alike and expects the same crop,
flip, jitter and angle. Everything but `resize` is the same numpy in
both, held equal within 1e-6 (float32). `resize` is torch here and
jax.image.resize there, with the same weights: it is held within 5e-4
absolute on 0..255 pixels, 2e-6 of full scale and ~30 float32 ulps at
255 (the port contracts the rows, then the columns; XLA's einsum picks
its own order over both weight matrices), at down- and up-scales,
bilinear, bicubic and nearest.
"""
import os
import random

import numpy as np
import pytest

import paddle_tpu.vision as jvision
import paddle_tpu_torch.vision as tvision

IMG = np.random.RandomState(0).randint(0, 256, (24, 32, 3)).astype(np.uint8)
RESIZE_ATOL = 5e-4


def _both(fn, seed=0):
    out = []
    for V in (tvision, jvision):
        random.seed(seed)
        np.random.seed(seed)
        out.append(np.asarray(fn(V)))
    return out


@pytest.mark.parametrize("size", [(12, 20), (48, 40), 16, (7, 45)])
@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
def test_resize_matches_jax_image_resize(size, interp):
    got, want = _both(lambda V: V.transforms.functional.resize(
        IMG, size, interp))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


F_CASES = {
    "crop": lambda F: F.crop(IMG, 3, 5, 10, 12),
    "center_crop": lambda F: F.center_crop(IMG, 10),
    "hflip": lambda F: F.hflip(IMG),
    "vflip": lambda F: F.vflip(IMG),
    "pad_constant": lambda F: F.pad(IMG, (1, 2, 3, 4), fill=7),
    "pad_reflect": lambda F: F.pad(IMG, 2, padding_mode="reflect"),
    "adjust_brightness": lambda F: F.adjust_brightness(IMG, 1.3),
    "adjust_contrast": lambda F: F.adjust_contrast(IMG, 0.7),
    "adjust_saturation": lambda F: F.adjust_saturation(IMG, 1.4),
    "to_grayscale": lambda F: F.to_grayscale(IMG, 3),
    "rotate": lambda F: F.rotate(IMG, 33.0, fill=5),
    "normalize_chw": lambda F: F.normalize(IMG, [120, 110, 100],
                                           [50, 60, 70]),
    "normalize_hwc": lambda F: F.normalize(IMG, [120, 110, 100],
                                           [50, 60, 70], "HWC"),
    "to_tensor": lambda F: F.to_tensor(IMG),
    "to_hwc_of_chw": lambda F: F.to_hwc(np.transpose(IMG, (2, 0, 1))),
}


@pytest.mark.parametrize("case", sorted(F_CASES))
def test_functional_matches(case):
    got, want = _both(lambda V: F_CASES[case](V.transforms.functional))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), atol=1e-6, rtol=0)


T_CASES = {
    "ToTensor": lambda T: T.ToTensor(),
    "Normalize": lambda T: T.Normalize(127.5, 64.0, data_format="HWC"),
    "Resize": lambda T: T.Resize((16, 20)),
    "CenterCrop": lambda T: T.CenterCrop(12),
    "RandomCrop": lambda T: T.RandomCrop(20, padding=2),
    "RandomCrop_pad_if_needed": lambda T: T.RandomCrop(
        30, pad_if_needed=True),
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(16),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(0.5),
    "RandomVerticalFlip": lambda T: T.RandomVerticalFlip(0.5),
    "Pad": lambda T: T.Pad(3, padding_mode="edge"),
    "Transpose": lambda T: T.Transpose(),
    "BrightnessTransform": lambda T: T.BrightnessTransform(0.4),
    "ContrastTransform": lambda T: T.ContrastTransform(0.4),
    "SaturationTransform": lambda T: T.SaturationTransform(0.4),
    "ColorJitter": lambda T: T.ColorJitter(0.3, 0.3, 0.3),
    "RandomRotation": lambda T: T.RandomRotation(20),
    "Grayscale": lambda T: T.Grayscale(1),
    "Compose": lambda T: T.Compose([
        T.RandomResizedCrop(20), T.RandomHorizontalFlip(), T.Transpose(),
        T.Normalize([127.5] * 3, [127.5] * 3)]),
}


@pytest.mark.parametrize("case", sorted(T_CASES))
def test_transform_matches(case):
    """Five draws of each transform under one seed: the same random
    choices and the same pixels (resize inside at its tolerance)."""
    def run(V):
        t = T_CASES[case](V.transforms)
        return np.stack([np.asarray(t(IMG), np.float32) for _ in range(5)])

    got, want = _both(run, seed=9)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def test_image_backends(tmp_path):
    npy = str(tmp_path / "a.npy")
    np.save(npy, IMG)
    ppm = str(tmp_path / "a.ppm")
    with open(ppm, "wb") as f:
        f.write(b"P6\n# c\n32 24\n255\n" + IMG.tobytes())
    for V in (tvision, jvision):
        V.set_image_backend("numpy")
        assert V.get_image_backend() == "numpy"
        for p in (npy, ppm):
            np.testing.assert_array_equal(V.image_load(p), IMG)
        with pytest.raises(ValueError):
            V.set_image_backend("gif")
    tvision.image._BACKEND = jvision.image._BACKEND = None
    assert tvision.get_image_backend() == jvision.get_image_backend()


@pytest.mark.parametrize("name,kw", [
    ("MNIST", {"mode": "test"}), ("FashionMNIST", {"mode": "test"}),
    ("Cifar10", {"mode": "test"}), ("Cifar100", {"mode": "test"}),
    ("Flowers", {"mode": "test"}), ("VOC2012", {"mode": "test"})])
def test_synthetic_datasets_match(name, kw):
    got = getattr(tvision.datasets, name)(**kw)
    want = getattr(jvision.datasets, name)(**kw)
    assert len(got) == len(want)
    for i in (0, 1, len(want) - 1):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mnist_idx_files_and_transform(tmp_path):
    imgs = IMG[:, :, 0][None].repeat(3, 0)
    img_p, lab_p = str(tmp_path / "i.idx"), str(tmp_path / "l.idx")
    with open(img_p, "wb") as f:
        f.write(np.asarray([2051, 3, 24, 32], ">u4").tobytes()
                + imgs.tobytes())
    with open(lab_p, "wb") as f:
        f.write(np.asarray([2049, 3], ">u4").tobytes()
                + np.asarray([4, 1, 7], np.uint8).tobytes())
    out = []
    for V in (tvision, jvision):
        ds = V.datasets.MNIST(img_p, lab_p,
                              transform=V.transforms.Normalize(
                                  127.5, 127.5, data_format="HWC"))
        out.append([(np.asarray(x), int(y)) for x, y in
                    (ds[i] for i in range(3))])
    for (gx, gy), (wx, wy) in zip(*out):
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy
    assert [y for _, y in out[0]] == [4, 1, 7]


def test_dataset_folder_and_image_folder(tmp_path):
    rng = np.random.RandomState(1)
    for cls in ("b", "a"):
        os.makedirs(tmp_path / cls)
        for i in range(3):
            np.save(tmp_path / cls / f"{i}.npy",
                    rng.randint(0, 256, (8, 8, 3)).astype(np.uint8))
    (tmp_path / "a" / "skip.txt").write_text("x")
    out = []
    for V in (tvision, jvision):
        df = V.datasets.DatasetFolder(str(tmp_path),
                                      transform=V.transforms.Transpose())
        imf = V.datasets.ImageFolder(str(tmp_path))
        out.append((df.classes, [s[1] for s in df.samples],
                    [np.asarray(df[i][0]) for i in range(len(df))],
                    [np.asarray(imf[i][0]) for i in range(len(imf))]))
    assert out[0][:2] == out[1][:2] == (["a", "b"], [0, 0, 0, 1, 1, 1])
    for g, w in zip(out[0][2] + out[0][3], out[1][2] + out[1][3]):
        np.testing.assert_array_equal(g, w)
