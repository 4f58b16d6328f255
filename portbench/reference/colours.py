"""The Blues colour table of the vof view: 256 RGB entries, little-endian
float32, base64. Entry i is matplotlib's ``cm.Blues(i / 255)[:3]``; a
frozen copy, so the reference draws a frame without the program."""
from __future__ import annotations

import base64

import numpy as np

__all__ = ["blues"]

_BLUES = (
    "+Pd3P/z7ez8AAIA/Zi53P/p6ez9/v38/02R2P/n5ej/+fn8/QZt1P/d4ej9+Pn8/r9F0P/b3eT/9"
    "/X4/HAh0P/R2eT98vX4/ij5zP/P1eD/7fH4/93RyP/F0eD97PH4/ZatxP/Dzdz/6+30/0+FwP+5y"
    "dz95u30/QBhwP+3xdj/4en0/rk5vP+twdj94On0/HIVuP+rvdT/3+Xw/ibttP+hudT92uXw/9/Fs"
    "P+ftdD/1eHw/ZShsP+VsdD91OHw/0l5rP+Trcz/093s/QJVqP+Jqcz9zt3s/rstpP+Hpcj/ydns/"
    "GwJpP99ocj9yNns/iThoP97ncT/x9Xo/9m5nP9xmcT9wtXo/ZKVmP9vlcD/vdHo/0ttlP9lkcD9v"
    "NHo/PxJlP9jjbz/u83k/rUhkP9Zibz9ts3k/G39jP9Xhbj/scnk/iLViP9Ngbj9sMnk/9uthP9Lf"
    "bT/r8Xg/ZCJhP9BebT9qsXg/0VhgP8/dbD/pcHg/P49fP81cbD9pMHg/r8ZeP8zbaz/o73c/LAVe"
    "P8paaz9nr3c/qkNdP8nZaj/mbnc/KIJcP8dYaj9mLnc/psBbP8bXaT/l7XY/I/9aP8RWaT9krXY/"
    "oT1aP8PVaD/jbHY/H3xZP8FUaD9jLHY/nLpYP8DTZz/i63U/GvlXP75SZz9hq3U/mDdXP73RZj/g"
    "anU/FnZWP7tQZj9gKnU/k7RVP7rPZT/f6XQ/EfNUP7hOZT9eqXQ/jzFUP7fNZD/daHQ/DXBTP7VM"
    "ZD9dKHQ/iq5SP7TLYz/c53M/CO1RP7JKYz9bp3M/hitRP7HJYj/aZnM/BGpQP69IYj9aJnM/gahP"
    "P67HYT/Z5XI//+ZOP6xGYT9YpXI/fSVOP6vFYD/XZHI/+2NNP6lEYD9XJHI/eKJMP6jDXz/W43E/"
    "9uBLP6ZCXz9Vo3E/dB9LP6XBXj/UYnE/8l1KP6NAXj9UInE/b5xJP6K/XT/T4XA/7dpIP6A+XT9S"
    "oXA/axlIP569XD/RYHA/6FdHP508XD9RIHA/JnZGP5e5Wz+4028/ojNFP4YwWz/WYm8/HvFDP3Sn"
    "Wj/18W4/m65CP2MeWj8UgW4/F2xBP1GVWT8yEG4/kylAPz8MWT9Rn20/D+c+Py6DWD9wLm0/i6Q9"
    "Pxz6Vz+OvWw/CGI8PwtxVz+tTGw/hB87P/nnVj/M22s/AN05P+deVj/qams/fJo4P9bVVT8J+mo/"
    "+Vc3P8RMVT8oiWo/dRU2P7PDVD9GGGo/8dI0P6E6VD9lp2k/bZAzP4+xUz+ENmk/6k0yP34oUz+i"
    "xWg/ZgsxP2yfUj/BVGg/4sgvP1sWUj/g42c/XoYuP0mNUT//cmc/2kMtPzcEUT8dAmc/VwEsPyZ7"
    "UD88kWY/074qPxTyTz9bIGY/T3wpPwNpTz95r2U/yzkoP/HfTj+YPmU/SPcmP99WTj+3zWQ/xLQl"
    "P87NTT/VXGQ/QHIkP7xETT/062M/vC8jP6u7TD8Te2M/Oe0hP5kyTD8xCmM/taogP4epSz9QmWI/"
    "MWgfP3YgSz9vKGI/awQePyJ2Sj+fwGE/NmkcP1+UST/uZ2E/Ac4aP52ySD89D2E/zDIZP9rQRz+M"
    "tmA/mJcXPxfvRj/bXWA/Y/wVP1UNRj8qBWA/LmEUP5IrRT95rF8/+cUSP89JRD/IU18/xCoRPw1o"
    "Qz8X+14/kI8PP0qGQj9mol4/W/QNP4ekQT+1SV4/JlkMP8XCQD8E8V0/8b0KPwLhPz9TmF0/vCIJ"
    "Pz//Pj+iP10/iIcHP30dPj/x5lw/U+wFP7o7PT9Ajlw/HlEEP/hZPD+PNVw/6bUCPzV4Oz/e3Fs/"
    "tBoBP3KWOj8thFs///7+PrC0OT98K1s/lcj7Pu3SOD/L0lo/LJL4PirxNz8aelo/wlv1PmgPNz9p"
    "IVo/WSXyPqUtNj+4yFk/7+7uPuJLNT8HcFk/hbjrPiBqND9WF1k/HILoPl2IMz+lvlg/skvlPpum"
    "Mj/0ZVg/SBXiPtjEMT9CDVg/397ePhXjMD+RtFc/dajbPlMBMD/gW1c/DHLYPpAfLz8vA1c/Q4zV"
    "Ps09Lj9WllY/G/fSPgtcLT9VFVY/9GHQPkh6LD9TlFU/zMzNPoWYKz9SE1U/pDfLPsO2Kj9QklQ/"
    "fKLIPgDVKT9PEVQ/VQ3GPj7zKD9NkFM/LXjDPnsRKD9MD1M/BePAPrgvJz9KjlI/3U2+PvZNJj9J"
    "DVI/tri7PjNsJT9HjFE/jiO5PnCKJD9FC1E/Zo62Pq6oIz9EilA/P/mzPuvGIj9CCVA/F2SxPijl"
    "IT9BiE8/786uPmYDIT8/B08/xzmsPqMhID8+hk4/oKSpPuE/Hz88BU4/eA+nPh5eHj87hE0/UHqk"
    "Plt8HT85A00/KOWhPpmaHD84gkw/AVCfPta4Gz82AUw/2bqcPhPXGj81gEs/sSWaPlH1GT8z/0o/"
    "ipCXPo4TGT8yfko/YvuUPssxGD8w/Uk/OmaSPglQFz8vfEk/EtGPPkZuFj8t+0g/6zuNPoOMFT8s"
    "ekg/w6aKPsGqFD8q+Uc/mxGIPv7IEz8peEc/c3yFPjznEj8n90Y/7TeDPkfsET8ccUY/xiOBPjTi"
    "ED8K6EU/QB9+PiDYDz/5XkU/9PZ5Pg3ODj/n1UQ/qM51PvrDDT/VTEQ/W6ZxPue5DD/Ew0M/D35t"
    "PtSvCz+yOkM/wlVpPsGlCj+hsUI/di1lPq6bCT+PKEI/KQVhPpuRCD99n0E/3dxcPoiHBz9sFkE/"
    "kLRYPnR9Bj9ajUA/RIxUPmFzBT9JBEA/+GNQPk5pBD83ez8/qztMPjtfAz8l8j4/XxNIPihVAj8U"
    "aT4/EutDPhVLAT8C4D0/xsI/PgJBAD/xVj0/eZo7Pt1t/j7fzTw/LXI3PrdZ/D7NRDw/4EkzPpFF"
    "+j68uzs/lCEvPmsx+D6qMjs/SPkqPkQd9j6ZqTo/+9AmPh4J9D6HIDo/r6giPvj08T51lzk/YoAe"
    "PtLg7z5kDjk/FlgaPqzM7T5ShTg/yS8WPoW46z5B/Dc/fQcSPl+k6T4vczc/Md8NPjmQ5z4d6jY/"
    "5LYJPhN85T4MYTY/mI4FPuxn4z761zU/zScCPt5f4T6IHjU/CAP+Pdhb3z72VDQ/dbb3PdJX3T5j"
    "izM/4mnxPcxT2z7RwTI/UB3rPcZP2T4/+DE/vdDkPcBL1z6sLjE/KoTePbpH1T4aZTA/lzfYPbRD"
    "0z6Hmy8/BOvRPa4/0T710S4/cZ7LPag7zz5jCC4/3lHFPaI3zT7QPi0/TAW/PZwzyz4+dSw/ubi4"
    "PZYvyT6sqys/JmyyPZArxz4Z4io/kx+sPYonxT6HGCo/ANOlPYQjwz71Tik/bYafPX4fwT5ihSg/"
    "2jmZPXgbvz7Quyc/SO2SPXIXvT4+8iY/taCMPWwTuz6rKCY/IlSGPWYPuT4ZXyU/jweAPWALtz6G"
    "lSQ/+HVzPVoHtT70yyM/09xmPVQDsz5iAiM/rUNaPU7/sD7POCI/h6pNPUj7rj49byE/YhFBPUL3"
    "rD6rpSA/PHg0PTzzqj4Y3B8/Ft8nPTXvqD6GEh8/8UUbPS/rpj70SB4/y6wOPSnnpD5hfx0/pRMC"
    "PSPjoj7PtRw/gYAAPQHRoD7rQhs/gYAAPdu8nj7Wtxk/gYAAPbWonD7BLBg/gYAAPY+Umj6toRY/"
    "gYAAPWiAmD6YFhU/gYAAPUJslj6DixM/gYAAPRxYlD5vABI/gYAAPfZDkj5adRA/gYAAPc8vkD5G"
    "6g4/gYAAPakbjj4xXw0/gYAAPYMHjD4c1As/gYAAPV3ziT4ISQo/gYAAPTffhz7zvQg/gYAAPRDL"
    "hT7fMgc/gYAAPeq2gz7KpwU/gYAAPcSigT61HAQ/gYAAPTsdfz6hkQI/gYAAPe/0ej6MBgE/gYAA"
    "PaLMdj7v9v4+gYAAPVakcj7G4Ps+gYAAPQp8bj6cyvg+gYAAPb1Taj5ztPU+gYAAPXErZj5KnvI+"
    "gYAAPSQDYj4hiO8+gYAAPdjaXT73cew+gYAAPYuyWT7OW+k+gYAAPT+KVT6lReY+gYAAPfNhUT58"
    "L+M+gYAAPaY5TT5TGeA+gYAAPVoRST4pA90+gYAAPQ3pRD4A7dk+gYAAPcHAQD7X1tY+"
)


def blues() -> np.ndarray:
    """The (256, 3) float32 table."""
    return np.frombuffer(base64.b64decode(_BLUES), dtype="<f4").reshape(256, 3).copy()
