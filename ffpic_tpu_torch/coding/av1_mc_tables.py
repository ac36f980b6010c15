"""AV1 motion-compensation constant tables (GENERATED by
tools/extract_av1_mc_tables.py - do not edit).

Normative spec constants (subpel filters 7.11.3.4, warp filters
7.11.3.5, OBMC masks 7.11.3.10, wedge master rows 7.11.3.11,
interintra weights 7.11.3.13, warp division LUT 7.11.3.7),
machine-extracted from libaom and cross-validated against dav1d.

Copied from ``ffpic_tpu/coding/av1_mc_tables.py`` for the PyTorch port
unchanged (``av1_refs`` imports it).
"""

import base64
import zlib

import numpy as np

_META = {'subpel_filters': ((6, 16, 8), '<i2'), 'warped_filters': ((193, 8), '<i2'), 'obmc_mask': ((5, 32), '|u1'), 'wedge_master_rows': ((3, 64), '|u1'), 'wedge_codebook': ((3, 16, 3), '|i1'), 'quant_dist_lookup': ((4, 2), '<i2'), 'quant_dist_weight': ((4, 2), '<i2'), 'div_mult': ((32,), '<i4'), 'ii_weights_1d': ((32,), '|u1'), 'div_lut': ((257,), '<u2')}

_ORDER = ['div_lut', 'div_mult', 'ii_weights_1d', 'obmc_mask', 'quant_dist_lookup', 'quant_dist_weight', 'subpel_filters', 'warped_filters', 'wedge_codebook', 'wedge_master_rows']

_BLOB = (
    "eNrtmH1slVcdx3997nNvu75A10EZpav3/bX39r61vb29bS8dYGG8SUAouIqMVGwYjAZogdEy"
    "Z5Y4FbMxE/9xicGpQbMFYxZn9sficM4Eo4saI5n/6HANfaUvt6WUHr/n9nnOc57p6mKyv+RH"
    "TuHT8/475/t9TqDsW23PtLW3qW3vtH69dWtreeufWr7b8niLs2Uo82rmVCaTUTPXm19qfrzZ"
    "2zyefiP9tfT29Nr0zaarTeebNjdVNn2QupoaTG1LVaeGG3/Z+Hzj/sZg492G6w3fazjekG14"
    "qOFm/S/qv1HfVR+vt9XfSL6WfDa5LxlJWpJ/TbyWeC7xhUQiUZz4e/yN+Avxnnh7fF18Ova7"
    "2A9jF2KdsWRsRWwo+nb05eiZ6J5oNFoaHaq7Vvf9uvN1++sa61bXTUb+EHk18s1IT6Qj4ovY"
    "IjfD18KXw8+Gnwi3h11hS/gftddqX6l9rvbLtR21gdqS2tHQ70NXQ5dCp0L7Qs2hmlBB6IPg"
    "b4I/CV4M9gY/H0wHa4KW4IeB64Grge8EzgYOBjYGgoHyQM7/vv9X/h/7L/pP+g/41/v9/pX+"
    "nO9vvmu+n/ou+c75Dvm2+OK+Kp/iG/b+0fum9wfeb3lPe7/o7fDGvFVe1Tvq+YvnLc8Vz0ue"
    "Ac8Rzy5Pi8fnedCz4P7Q/Z77TfeP3C+6z7u/4t7tbnOH3GvcinvMdcP1jutnrpddz7v6XE+4"
    "drgyroBrtUtxjTvfd/7W+brzsvMF54DzqLPT+Vln0ul0ljsXHSOOG453Ha87XnFccjzjeMrR"
    "5djmyDiCjrWOIses/Z/2P9t/bf+5/bL9kv2r9l77l+yfs6+3R+12e7md7MQji4J/7VmNv8uJ"
    "rpcSXSkmcj8ALiKqLiTqthG9Z0UblBGV6EWUDSiE8raF6CJKF0oCpRRlSCF6F+UKyrdRTqN0"
    "oWxGSaI4UcpRMsmwz1lTVfnQgyvLSoqLCm02q6paLAqigEc4S8uGL968bAt3MFrf1JL92DZO"
    "jz8UiSUbUukMWv17O4fL7fUHQrXhumg8kaxvTDWlmzOZltasFg9QIZWQlUqRiDKykJIvVpRC"
    "KqDPaKNckEZUaJ4NIK2LTOccO0sVtCB4mp2kappjisaT7Bh50crgboqilc4TrIvSEk+y3dRu"
    "4q20FT8VMX477TZxmrowisFR6pbqc8xLxySeY9V0UoxPWHkFnRXrI+ysiAawS0Xs2bz/amol"
    "Jxm1VWA3v0haVIL9Eq+iDAXJJrgCu63lF1OLckpRhIrF7OXUgPyUCl5BSfxZITJeitoG9NK5"
    "GL1T/OJrUYTR05hFDxtmz2AVeqhYXStWabAbXCXt0Amupv+0/0VmnL+SZxsy+TRmn2cqiOdu"
    "jPVjtBxqFtkCK6ZbuA9e5N/go9jBGCvSeIgdxvpGJN5Pm9CqOM+l4J20Ez9LcVKL+f6baD+4"
    "OM9F6JmhwxKP4fyP5vtztmFmL87b4Byron5t/kWseh4Zfxq7sOUzqkjnr2f4wkdU1S+dHo+n"
    "pOzzOEIPm/igZlR67MMJyLET+ZCjA+cpR5bMwk6hhRxRjCCHHzPIYccK5HgYK5SjHDuQowg7"
    "lMO8/wWT/gl6kvVPyC/X/7zg6bz+5yTm+s8JnszrPyfVc/3LzPU/LY3P9S8z1/+kxFz/09L6"
    "uP4Nns/r3xh/Sf/G+pbO39jPR/df86nqn6B0Wf9c71z/MnP9rxD86ei/RvAgvgRGMDYo7b2A"
    "7oFV/FZnfju4kgo0vpu/LfcEz7Pz+OIsCL4D9ygTzN35HK1EL51n87drXnCOncFeDJ6B21Ri"
    "FMP9+2it+PpYaIqdonUmPkmPYFSdJ1kv9JFjFo1vsxPkEl8DzsfJg1n0+gn2JPIn81Hkd1pj"
    "lcZZD4Uxi8FHqM7E3RTHrAYfxukaPMYOUSNmVQUfxGneluq7cJoTUv0BajNxJ6038V7agFkM"
    "3gN3lXkXbTbxTnrMxNtpO36qYr2PwW1k3ky7TLyJ9ph4A+2VeIKtp04Tt9EBE2egZp15/tNw"
    "L6P+NmukQ1L9JEvC/ccljkP9Bk+xOridzGHqkXiaBfG1mBDnOcP89KSJPXRc5J/fPxedEGwB"
    "26lXnB+/r4/AXaYEz7F1dMrEa6lPet3cYZVw2xmNuT5W0Rlx/zhzd5oVfJetpHPiPnO9leHr"
    "dUfoaYGV0HmhD65P7mZ3BfMv4IDQG9ezCoXfYwWS/geFnj+5A8iKH5QcQH8vLM3AGN/xQN4B"
    "FBBDXubgCGXopXNOe09Y8qwiN+fgAHcET8MRVkk8BUdYg1E4LzIrzqIfDjDL1Hy9FWfVBwfI"
    "CZ5gp+FuM3nm2RiHIzgwqlVwLxzA4DE4ghezLHEhjcIRAtp7ZomPUQiz6DwCR4iYuIdimFXn"
    "YThCAlwouBt+Pq5xEfgw/HxM8C04QrOJD8KfRyXuwvtA5gP0qPaeWuJO2mjivXg/DAsexvd2"
    "i8S34AjbTPU7aIeJt0HxtyTegu+xXN8BxRv1I2wjFC/zo1C8zjx/WShe5lYo3uAx1gzFy5yC"
    "4ocFj7MGKH5Y5HOCJaB4nW3gGBQ/Ivg2i0DxMofwPhgVPMkCUPwS8/syhffDCcxq03gaDtCL"
    "WQ12QPE68/taQ6cxq1W7nzk4QB9m0XkWDtCPWaz59vz+r4Hip7T7acHNXgXFT0tcAcXPCF56"
    "r+a0+69AOWVQ/Jxg7gAD+S8iV7HuAPPCMfgeB02O8N8coABM998A998A998A/6dvAJ0VVbWo"
    "PKyqWqCoBfhpU0lVFVVRVJtVVayqzaKoFhv/lWpT5fakKqTaeC/bJ2+v8i4fP/5y/3dWoNgq"
    "PPWZtuwysWx/tWRdJN36P/cnpXB1qKl1ue7ZfwFTliTY"
)


def _load():
    raw = zlib.decompress(base64.b64decode(_BLOB))
    off = 0
    tabs = {}
    for name in _ORDER:
        shp, dt = _META[name]
        a = np.frombuffer(raw, dt, count=int(np.prod(shp)),
                          offset=off)
        tabs[name] = a.reshape(shp).copy()
        off += a.nbytes
    return tabs


TABLES = _load()
