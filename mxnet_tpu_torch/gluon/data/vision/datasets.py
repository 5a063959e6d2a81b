"""Vision datasets (port of ``mxnet_tpu/gluon/data/vision/datasets.py``;
parity: python/mxnet/gluon/data/vision/datasets.py: MNIST, FashionMNIST,
CIFAR10/100, ImageFolderDataset).

Nothing is downloaded: the files are read where they are, else a
synthetic set is drawn from ``mxnet_tpu``'s ``RandomState`` seeds, bit for
bit its set (``MXNET_TPU_TORCH_SYNTH_DATA``, default on; "0" turns it off
and a missing file raises). The images live on ``cpu()`` as uint8
NDArrays; a DataLoader moves batches to the card. ``ImageRecordDataset``
waits for ``recordio`` (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .. import dataset
from ....context import cpu
from .... import ndarray as nd

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset"]


def _synth_ok():
    return os.environ.get("MXNET_TPU_TORCH_SYNTH_DATA", "1") != "0"


def _host_u8(data):
    return nd.array(np.ascontiguousarray(data), ctx=cpu(), dtype=np.uint8)


class _DownloadedDataset(dataset.Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST handwritten digits (gluon/data/vision/datasets.py:36)."""

    _n = 60000
    _shape = (28, 28, 1)
    _nclass = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz",)
        self._train_label = ("train-labels-idx1-ubyte.gz",)
        self._test_data = ("t10k-images-idx3-ubyte.gz",)
        self._test_label = ("t10k-labels-idx1-ubyte.gz",)
        super().__init__(root, transform)

    def _get_data(self):
        files = (self._train_data[0], self._train_label[0]) if self._train \
            else (self._test_data[0], self._test_label[0])
        data_file = os.path.join(self._root, files[0])
        label_file = os.path.join(self._root, files[1])
        if os.path.exists(data_file) and os.path.exists(label_file):
            with gzip.open(label_file, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(data_file, "rb") as fin:
                struct.unpack(">IIII", fin.read(16))
                data = np.frombuffer(fin.read(), dtype=np.uint8)
                data = data.reshape(len(label), 28, 28, 1)
        elif _synth_ok():
            n = 2048 if self._train else 512
            rng = np.random.RandomState(42 if self._train else 43)
            label = rng.randint(0, self._nclass, n).astype(np.int32)
            # class-dependent blobs so models can actually learn
            data = (rng.rand(n, *self._shape) * 64).astype(np.uint8)
            for i, l in enumerate(label):
                data[i, 2 + l * 2:6 + l * 2, 4:24, 0] = 255
        else:
            raise RuntimeError(
                f"MNIST files not found under {self._root} and synthetic "
                "fallback disabled (MXNET_TPU_TORCH_SYNTH_DATA=0)")
        self._label = label
        self._data = _host_u8(data)


class FashionMNIST(MNIST):
    """FashionMNIST clothing dataset (same format as MNIST)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 image classification (gluon/data/vision/datasets.py:126)."""

    _nclass = 10
    _pickle_names = None

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(-1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        if self._train:
            files = [os.path.join(self._root, f"data_batch_{i}.bin")
                     for i in range(1, 6)]
        else:
            files = [os.path.join(self._root, "test_batch.bin")]
        if all(os.path.exists(f) for f in files):
            data, label = zip(*[self._read_batch(f) for f in files])
            data = np.concatenate(data)
            label = np.concatenate(label)
        elif _synth_ok():
            n = 2048 if self._train else 512
            rng = np.random.RandomState(7 if self._train else 8)
            label = rng.randint(0, self._nclass, n).astype(np.int32)
            data = (rng.rand(n, 32, 32, 3) * 64).astype(np.uint8)
            for i, l in enumerate(label):
                data[i, :, l * 3:l * 3 + 3, :] = 200
        else:
            raise RuntimeError(
                f"CIFAR10 files not found under {self._root} and synthetic "
                "fallback disabled")
        self._data = _host_u8(data)
        self._label = label


class CIFAR100(CIFAR10):
    """CIFAR100 (gluon/data/vision/datasets.py:171)."""

    _nclass = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(-1, 3072 + 2)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 + self._fine_label].astype(np.int32)

    def _get_data(self):
        name = "train.bin" if self._train else "test.bin"
        f = os.path.join(self._root, name)
        if os.path.exists(f):
            self._data_np, self._label = self._read_batch(f)
            self._data = _host_u8(self._data_np)
            return
        super()._get_data()


class ImageFolderDataset(dataset.Dataset):
    """A dataset loading image files from a folder hierarchy
    (gluon/data/vision/datasets.py:257): root/category/image.ext"""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from ....image import imread
        img = imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
