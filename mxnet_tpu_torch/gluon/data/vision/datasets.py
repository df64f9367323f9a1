"""Vision datasets of the port (mirrors
``mxnet_tpu/gluon/data/vision/datasets.py``): MNIST, FashionMNIST,
CIFAR10 and CIFAR100 read the reference's file formats (MNIST idx files,
CIFAR binary batches) from ``root`` when they are there, and otherwise
(or under ``MXNET_SYNTHETIC_DATA=1``) give the reference's synthetic
surrogate, bit for bit: one fixed template a class plus noise, from
numpy generators of the reference's seeds. Nothing is downloaded and
nothing is written. Samples are CPU NDArrays (HWC uint8) with int32
labels."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np
import torch

from ....ndarray.ndarray import NDArray
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _host(a):
    return NDArray(torch.from_numpy(np.array(a)))


def _synthetic(n, shape, num_classes, seed, template_seed):
    """Class-separable surrogate data: each class a fixed random template
    (shared by the train and test splits) plus noise."""
    trng = np.random.RandomState(template_seed)
    templates = trng.uniform(0, 255, size=(num_classes,) + shape)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    noise = rng.normal(0, 32, size=(n,) + shape)
    data = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return data, labels


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(_host(self._data[idx]), self._label[idx])
        return _host(self._data[idx]), self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST: ``train-images-idx3-ubyte[.gz]`` and the rest under
    ``root``, else 8192 (train) / 2048 (test) synthetic 28x28x1
    samples."""

    _shape = (28, 28, 1)
    _num_classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = "train-images-idx3-ubyte"
        self._train_label = "train-labels-idx1-ubyte"
        self._test_data = "t10k-images-idx3-ubyte"
        self._test_label = "t10k-labels-idx1-ubyte"
        super().__init__(root, transform)

    @staticmethod
    def _read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            ndim = struct.unpack(">I", f.read(4))[0] & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)

    def _find(self, base):
        for cand in (base, base + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        return None

    def _get_data(self):
        dbase = self._train_data if self._train else self._test_data
        lbase = self._train_label if self._train else self._test_label
        dpath, lpath = self._find(dbase), self._find(lbase)
        if dpath and lpath and not os.environ.get("MXNET_SYNTHETIC_DATA"):
            self._data = self._read_idx(dpath).reshape((-1,) + self._shape)
            self._label = self._read_idx(lpath).astype(np.int32)
        else:
            n = 8192 if self._train else 2048
            self._data, self._label = _synthetic(
                n, self._shape, self._num_classes,
                seed=42 if self._train else 43, template_seed=7)


class FashionMNIST(MNIST):
    """FashionMNIST: MNIST's formats under its own ``root``."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10: ``data_batch_{1..5}.bin`` / ``test_batch.bin`` under
    ``root``, else synthetic 32x32x3 samples."""

    _shape = (32, 32, 3)
    _num_classes = 10
    _train_files = [f"data_batch_{i}.bin" for i in range(1, 6)]
    _test_files = ["test_batch.bin"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        data = raw.reshape(-1, 1 + 3 * 32 * 32)
        return (data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                data[:, 0].astype(np.int32))

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.exists(p) for p in paths) and \
                not os.environ.get("MXNET_SYNTHETIC_DATA"):
            parts = [self._read_batch(p) for p in paths]
            self._data = np.concatenate([p[0] for p in parts])
            self._label = np.concatenate([p[1] for p in parts])
        else:
            n = 8192 if self._train else 2048
            self._data, self._label = _synthetic(
                n, self._shape, self._num_classes,
                seed=44 if self._train else 45, template_seed=9)


class CIFAR100(CIFAR10):
    """CIFAR100: ``train.bin`` / ``test.bin``, coarse labels unless
    ``fine_label``."""

    _num_classes = 100
    _train_files = ["train.bin"]
    _test_files = ["test.bin"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root=root, train=train, transform=transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        data = raw.reshape(-1, 2 + 3 * 32 * 32)
        return (data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                data[:, 1 if self._fine_label else 0].astype(np.int32))


class ImageRecordDataset(Dataset):
    """Images in a RecordIO file: needs ``recordio`` and ``image``
    ported (ROADMAP.md §1 item 14)."""

    def __init__(self, filename, flag=1, transform=None):
        raise NotImplementedError(
            "ImageRecordDataset reads RecordIO images, which needs "
            "mxnet_tpu.recordio and mxnet_tpu.image ported (ROADMAP.md §1 "
            "item 14)")


class ImageFolderDataset(Dataset):
    """A folder of class folders (the classes in sorted order, in
    ``synsets``). ``.npy`` images load; decoding ``.jpg``/``.png`` needs
    ``image`` ported (ROADMAP.md §1 item 14) and raises until then."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if not path.endswith(".npy"):
            raise NotImplementedError(
                f"decoding {os.path.basename(path)} needs mxnet_tpu.image "
                "ported (ROADMAP.md §1 item 14); .npy images load")
        img = _host(np.load(path))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
