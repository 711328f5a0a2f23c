"""Feature detection, description, matching and match filtering
(counterpart of ``tadataka_tpu/features``; ORB and VITAMIN-E's curvature
extrema are not ported yet)."""

from tadataka_torch.features.detector import (
    detect_fast, detect_harris, Features)
from tadataka_torch.features.brief import brief_descriptors, extract_features
from tadataka_torch.features.matching import (
    match_descriptors, Matches, Matcher)
from tadataka_torch.features.ransac import ransac_fundamental, ransac_affine
from tadataka_torch.features.filters import symmetric_transfer_filter
