"""Dataset base (counterpart of ``tadataka_tpu/dataset/base.py``):
integer and slice indexing over ``load``."""


class BaseDataset:
    def __getitem__(self, index):
        if isinstance(index, int):
            if index < 0:
                index += len(self)
            return self.load(index)
        start, stop, step = index.indices(len(self))
        return [self.load(i) for i in range(start, stop, step)]

    def load(self, index):
        raise NotImplementedError()

    def __len__(self):
        return self.length
